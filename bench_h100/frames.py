"""The benchmark's inputs: the demo scenes and the frame states a traffic
mix asks for, made on the device from the seed.

The scene arithmetic is a frozen copy of the program's ``scenes.beam`` and
``scenes.buckling`` (float64 fields, cast to the configuration's dtype),
written in torch so that a 192^3 scene is made on the card.  A state is
the velocity that a FLIP pipeline's step (advect, then gravity: the
program's ``models.flip``) hands to the viscosity solve some frames into
the shot.  Advecting a scene's velocity, which is constant along its own
direction, leaves it as it is, so the step reduces to gravity: the
scene's velocity plus ``gravity * dt * t`` along y at ``t`` frames in.
The liquid is held where the mix puts it.  A traffic mix is a JSON file of
parameters (``traffic/<name>.json``) that :func:`make_states` reads:

- ``states``: length of the cycle of frame states the closed loop replays,
  one frame apart, in time order;
- ``gravity``: the acceleration along y, m/s^2, that the step adds;
- ``start``: ``[lo, hi]``: the cycle's first state is ``lo + u (hi - lo)``
  frames into the shot, with ``u`` drawn from the run's seed, so that every
  seed gets states of its own and about the same CG work;
- ``rotate`` (optional): ``{"pivot": [x, y], "degrees": [first, last]}``
  turns the liquid about the z axis through the pivot, downward, in equal
  steps from the first angle to the last over the cycle;
- ``warmup_frames``: frames of the cycle run in set-up.
"""

from __future__ import annotations

import math
import random
from typing import Dict, List

import torch

F64 = torch.float64
DTYPES = {"float32": torch.float32, "float64": torch.float64}


def _centers(n: int, device) -> torch.Tensor:
    return (torch.arange(n, dtype=F64, device=device) + 0.5) / n


def _grid(n: int, device, stagger: int = -1):
    """Coordinates of a cell grid (``stagger`` -1) or of the faces normal
    to axis ``stagger`` (at i / n along it)."""
    axes = []
    for d in range(3):
        if d == stagger:
            axes.append(torch.arange(n + 1, dtype=F64, device=device) / n)
        else:
            axes.append(_centers(n, device))
    return torch.meshgrid(*axes, indexing="ij")


def _box_sdf(X, Y, Z, lo, hi):
    dxs = torch.maximum(lo[0] - X, X - hi[0])
    dys = torch.maximum(lo[1] - Y, Y - hi[1])
    dzs = torch.maximum(lo[2] - Z, Z - hi[2])
    outside = torch.sqrt(dxs.clamp_min(0) ** 2 + dys.clamp_min(0) ** 2 + dzs.clamp_min(0) ** 2)
    inside = torch.maximum(torch.maximum(dxs, dys), dzs).clamp_max(0.0)
    return outside + inside


def _turn(X, Y, pivot, degrees):
    """Coordinates at which the unturned scene is read for a scene turned
    by ``degrees`` downward (clockwise in the x-y plane) about ``pivot``."""
    if not degrees:
        return X, Y
    a = math.radians(degrees)
    px, py = pivot
    rx, ry = X - px, Y - py
    # the inverse of a clockwise turn by a is a counter-clockwise turn by a
    return px + math.cos(a) * rx - math.sin(a) * ry, py + math.sin(a) * rx + math.cos(a) * ry


def beam(n, device, pivot=(0.0, 0.0), degrees=0.0):
    """A viscous beam anchored to a side wall, sagging under initial
    downward motion at its free end (viscousBeam)."""
    X, Y, Z = _grid(n, device)
    tx, ty = _turn(X, Y, pivot, degrees)
    liquid = _box_sdf(tx, ty, Z, (0.05, 0.55, 0.35), (0.65, 0.75, 0.65))
    solid = X - 0.08
    vel = [torch.zeros(_face_shape(n, a), dtype=F64, device=device) for a in range(3)]
    ramp = ((_centers(n, device) - 0.1) / 0.5).clamp(0.0, 1.0)
    vel[1] = (-0.8 * ramp).reshape(n, 1, 1).expand(_face_shape(n, 1)).clone()
    return liquid, solid, vel


def buckling(n, device, pivot=(0.0, 0.0), degrees=0.0):
    """A viscous column falling onto a floor (viscousBuckling)."""
    X, Y, Z = _grid(n, device)
    tx, ty = _turn(X, Y, pivot, degrees)
    r = torch.sqrt((tx - 0.5) ** 2 + (Z - 0.5) ** 2)
    column = torch.maximum(r - 0.1, torch.maximum(0.25 - ty, ty - 0.95))
    pool = _box_sdf(tx, ty, Z, (0.1, 0.1, 0.1), (0.9, 0.22, 0.9))
    liquid = torch.minimum(column, pool)
    solid = Y - 0.1
    vel = [torch.zeros(_face_shape(n, a), dtype=F64, device=device) for a in range(3)]
    vel[1] = torch.full(_face_shape(n, 1), -1.5, dtype=F64, device=device)
    return liquid, solid, vel


SCENES = {"beam": beam, "buckling": buckling}


def _face_shape(n: int, axis: int):
    return tuple(n + (1 if d == axis else 0) for d in range(3))


def start_frame(traffic: Dict, seed: int) -> float:
    """Frames into the shot of the cycle's first state, for run seed
    ``seed`` (any whole number)."""
    lo, hi = traffic["start"]
    return lo + random.Random(int(seed)).random() * (hi - lo)


def make_states(config: Dict, traffic: Dict, seed: int, device) -> List[Dict[str, object]]:
    """The traffic's cycle of frame states for run seed ``seed``, in time
    order: dicts of the program's ``FluidState`` fields
    (``liquid_sdf``, ``solid_sdf``, ``velocity``, ``solid_velocity``,
    ``viscosity``, ``density``, ``dx``) in the configuration's dtype on
    ``device``.  States share the tensors that do not change between
    them."""
    n = int(config["n"])
    dtype = DTYPES[config["dtype"]]
    scene = SCENES[config["scene"]]
    count = int(traffic["states"])
    rot = traffic.get("rotate")
    if rot:
        lo, hi = rot["degrees"]
        angles = [lo + (hi - lo) * i / max(1, count - 1) for i in range(count)]
        pivot = tuple(rot["pivot"])
    else:
        angles, pivot = [0.0] * count, (0.0, 0.0)
    shared = {
        "viscosity": torch.full((n, n, n), float(config["viscosity"]), dtype=dtype, device=device),
        "density": torch.full((n, n, n), float(config["density"]), dtype=dtype, device=device),
        "solid_velocity": tuple(torch.zeros(_face_shape(n, a), dtype=dtype, device=device)
                                for a in range(3)),
        "dx": 1.0 / n,
    }
    # the step the program gets (a float32 dt, for a float32 configuration)
    dt = float(torch.tensor(float(config["dt"]), dtype=dtype))
    t0 = start_frame(traffic, seed)
    states, geometry = [], {}
    for i, deg in enumerate(angles):
        if deg not in geometry:
            liquid, solid, vel = scene(n, device, pivot, deg)
            geometry[deg] = (liquid.to(dtype), solid.to(dtype), vel)
        liquid, solid, vel = geometry[deg]
        fall = float(traffic["gravity"]) * dt * (t0 + i)
        velocity = tuple((v + fall if a == 1 else v).to(dtype) for a, v in enumerate(vel))
        states.append(dict(shared, liquid_sdf=liquid, solid_sdf=solid, velocity=velocity))
    return states
