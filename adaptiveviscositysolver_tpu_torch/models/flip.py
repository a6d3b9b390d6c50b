"""Minimal grid-based liquid loop around the viscosity solve (port of
``models/flip.py``).

The reference is a drop-in microsolver for Houdini's FLIP loop
(reference README.md:25-33): the host advects, applies forces, solves
viscosity, then projects pressure.  This loop makes the package runnable on
its own: semi-Lagrangian advection of the SDF and the velocity, gravity,
and the adaptive viscosity solve.  Particle transport and pressure
projection are the caller's, as they are Houdini's in the reference.
Positions are float32, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ..config import SolverConfig
from ..solver import FluidState, solve_viscosity


def _face_positions(shape, axis, dx, device):
    coords = []
    for d in range(3):
        c = torch.arange(shape[d], dtype=torch.float32, device=device)
        coords.append(c * dx if d == axis else (c + 0.5) * dx)
    return torch.meshgrid(*coords, indexing="ij")


def _cell_positions(shape, dx, device):
    coords = [(torch.arange(n, dtype=torch.float32, device=device) + 0.5) * dx for n in shape]
    return torch.meshgrid(*coords, indexing="ij")


def _sample_trilinear(field, pos, dx, offset):
    """Clamped trilinear sample of a staggered or cell field at world points."""
    idx = [pos[d] / dx - offset[d] for d in range(3)]
    base = [torch.floor(i).clamp(0, field.shape[d] - 2).to(torch.int64)
            for d, i in enumerate(idx)]
    frac = [(idx[d] - base[d]).clamp(0.0, 1.0) for d in range(3)]
    out = 0.0
    for b0 in (0, 1):
        for b1 in (0, 1):
            for b2 in (0, 1):
                w = ((frac[0] if b0 else 1 - frac[0])
                     * (frac[1] if b1 else 1 - frac[1])
                     * (frac[2] if b2 else 1 - frac[2]))
                out = out + w * field[base[0] + b0, base[1] + b1, base[2] + b2]
    return out


def _velocity_at(velocity, pos, dx):
    """MAC velocity interpolated at world points (per component)."""
    comps = []
    for a in range(3):
        off = [0.5 if d != a else 0.0 for d in range(3)]
        comps.append(_sample_trilinear(velocity[a], pos, dx, off))
    return comps


def advect_state(state: FluidState, dt) -> FluidState:
    """Semi-Lagrangian advection of the SDF and the MAC velocity."""
    dx = state.dx
    res = tuple(state.liquid_sdf.shape)
    dev = state.liquid_sdf.device

    pos = _cell_positions(res, dx, dev)
    vel = _velocity_at(state.velocity, pos, dx)
    back = [pos[d] - dt * vel[d] for d in range(3)]
    new_sdf = _sample_trilinear(state.liquid_sdf, back, dx, (0.5, 0.5, 0.5))

    new_vel = []
    for a in range(3):
        fpos = _face_positions(tuple(state.velocity[a].shape), a, dx, dev)
        fvel = _velocity_at(state.velocity, fpos, dx)
        fback = [fpos[d] - dt * fvel[d] for d in range(3)]
        off = [0.5 if d != a else 0.0 for d in range(3)]
        new_vel.append(_sample_trilinear(state.velocity[a], fback, dx, off))

    return dataclasses.replace(state, liquid_sdf=new_sdf, velocity=tuple(new_vel))


def apply_gravity(state: FluidState, dt, g=-9.8) -> FluidState:
    vel = list(state.velocity)
    vel[1] = vel[1] + dt * g
    return dataclasses.replace(state, velocity=tuple(vel))


def step(state: FluidState, dt, config: SolverConfig = SolverConfig(),
         gravity: float = -9.8, device="cuda"):
    """One frame: advect, gravity, viscosity solve on ``device``.  Returns
    (state, stats)."""
    state = advect_state(state, dt)
    state = apply_gravity(state, dt, gravity)
    result = solve_viscosity(state, dt, config, device=device)
    state = dataclasses.replace(state.to(device=device), velocity=result.velocity)
    return state, result.stats


def simulate(state: FluidState, frames: int, dt, config: SolverConfig = SolverConfig(),
             on_frame: Optional[Callable] = None, device="cuda"):
    """Run ``frames`` steps; ``on_frame(i, state, stats)`` after each.
    Returns (state, [stats per frame])."""
    stats = []
    for i in range(frames):
        state, st = step(state, dt, config, device=device)
        stats.append(st)
        if on_frame is not None:
            on_frame(i, state, st)
    return state, stats
