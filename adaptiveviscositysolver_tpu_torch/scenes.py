"""Canonical demo/benchmark scenes (port of ``scenes.py``).

Programmatic analogs of the reference's viscousBeam.hip / viscousBuckling.hip
(README.md:25-33).  The fields are built in float64 numpy exactly as the JAX
package builds them and only then cast, so both packages start from
bit-identical inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from .convert import fluid_state_from_numpy


def _grids(n):
    dx = 1.0 / n
    x = (np.arange(n, dtype=np.float64) + 0.5) * dx
    X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
    return dx, X, Y, Z


def _box_sdf(X, Y, Z, lo, hi):
    dxs = np.maximum(lo[0] - X, X - hi[0])
    dys = np.maximum(lo[1] - Y, Y - hi[1])
    dzs = np.maximum(lo[2] - Z, Z - hi[2])
    outside = np.sqrt(
        np.maximum(dxs, 0) ** 2 + np.maximum(dys, 0) ** 2 + np.maximum(dzs, 0) ** 2
    )
    inside = np.minimum(np.maximum(np.maximum(dxs, dys), dzs), 0.0)
    return outside + inside


def _face_shapes(n):
    return [tuple(n + (1 if d == a else 0) for d in range(3)) for a in range(3)]


def _state(n, liquid, solid, velocity, viscosity_value, density_value, dtype, device):
    return fluid_state_from_numpy(
        liquid_sdf=liquid, solid_sdf=solid, velocity=velocity,
        solid_velocity=[np.zeros(s) for s in _face_shapes(n)],
        viscosity=np.full(liquid.shape, viscosity_value),
        density=np.full(liquid.shape, density_value),
        dx=1.0 / n, device=device, dtype=dtype,
    )


def beam(n=64, viscosity=5.0, density=1.0, dtype=torch.float32, device="cuda"):
    """A viscous beam anchored to a side wall, sagging under initial
    downward motion at its free end (the viscousBeam stretching test)."""
    dx, X, Y, Z = _grids(n)
    liquid = _box_sdf(X, Y, Z, (0.05, 0.55, 0.35), (0.65, 0.75, 0.65))
    solid = X - 0.08
    fshapes = _face_shapes(n)
    vel = [np.zeros(s) for s in fshapes]
    ramp = np.clip(((np.arange(n) + 0.5) * dx - 0.1) / 0.5, 0.0, 1.0)
    vel[1] = -0.8 * ramp.reshape(n, 1, 1) * np.ones(fshapes[1])
    return _state(n, liquid, solid, vel, viscosity, density, dtype, device)


def buckling(n=64, viscosity=20.0, density=1.0, dtype=torch.float32, device="cuda"):
    """A viscous column falling onto a floor: the coiling/buckling rope test
    (deep adaptivity: tall thin liquid column over a solid floor)."""
    dx, X, Y, Z = _grids(n)
    r = np.sqrt((X - 0.5) ** 2 + (Z - 0.5) ** 2)
    column = np.maximum(r - 0.1, np.maximum(0.25 - Y, Y - 0.95))
    pool = _box_sdf(X, Y, Z, (0.1, 0.1, 0.1), (0.9, 0.22, 0.9))
    liquid = np.minimum(column, pool)
    solid = Y - 0.1
    fshapes = _face_shapes(n)
    vel = [np.zeros(s) for s in fshapes]
    vel[1] = -1.5 * np.ones(fshapes[1])
    return _state(n, liquid, solid, vel, viscosity, density, dtype, device)
