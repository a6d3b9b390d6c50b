"""Carry a frame and a configuration across from the JAX package's inputs.

This system has no weights: its parameters are the frame state (SDFs,
velocities, material fields) and the solver configuration.  Both functions
take plain numpy arrays / Python values, so the two packages can compute
from the same arrays without this package importing JAX.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .config import SolverConfig

_APPLY_IMPL = {"auto": "auto", "pallas": "cuda", "v1": "v1", "v1-fused": "v1-fused"}


def fluid_state_from_numpy(liquid_sdf, solid_sdf, velocity: Sequence, solid_velocity: Sequence,
                           viscosity, density, dx: float, device="cuda", dtype=None):
    """A :class:`solver.FluidState` on ``device`` from numpy arrays.  Values
    keep their numpy dtype unless ``dtype`` is given (numpy float64 ->
    float32 rounds exactly as ``jnp.asarray(x, float32)`` does)."""
    from .solver import FluidState

    def t(x):
        arr = torch.as_tensor(np.asarray(x))
        return arr.to(device=device, dtype=dtype or arr.dtype)

    return FluidState(
        liquid_sdf=t(liquid_sdf), solid_sdf=t(solid_sdf),
        velocity=tuple(t(v) for v in velocity),
        solid_velocity=tuple(t(v) for v in solid_velocity),
        viscosity=t(viscosity), density=t(density), dx=float(dx),
    )


def config_from_jax_fields(**fields) -> SolverConfig:
    """A port :class:`SolverConfig` from the JAX ``SolverConfig``'s fields
    (``dataclasses.asdict`` of it).  ``dtype`` may be a numpy/JAX dtype or
    its name; ``apply_impl`` maps "pallas" to "cuda"."""
    fields = dict(fields)
    dt = fields.get("dtype")
    if dt is not None:
        fields["dtype"] = getattr(torch, np.dtype(dt).name)
    if "apply_impl" in fields:
        fields["apply_impl"] = _APPLY_IMPL[fields["apply_impl"]]
    return SolverConfig(**fields)
