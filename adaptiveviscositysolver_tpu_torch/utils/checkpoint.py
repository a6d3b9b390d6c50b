"""Checkpoint and resume of simulation-loop state (port of
``utils/checkpoint.py``).

The solver keeps no state between frames; a loop's state is one
:class:`~adaptiveviscositysolver_tpu_torch.solver.FluidState`, saved to a
``.npz`` with the same keys as the JAX package's, so a file written by
either package loads in the other.
"""

from __future__ import annotations

import numpy as np
import torch

from ..solver import FluidState

_FIELDS = ["liquid_sdf", "solid_sdf", "viscosity", "density"]


def _path(path: str) -> str:
    path = str(path)
    return path if path.endswith(".npz") else path + ".npz"


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def save(path: str, state: FluidState, step: int = 0) -> None:
    data = {f: _np(getattr(state, f)) for f in _FIELDS}
    for a in range(3):
        data[f"velocity_{a}"] = _np(state.velocity[a])
        data[f"solid_velocity_{a}"] = _np(state.solid_velocity[a])
    np.savez(_path(path), dx=state.dx, step=step, **data)


def load(path: str, device="cuda"):
    """Returns (FluidState on ``device``, step)."""
    with np.load(_path(path)) as z:
        def t(key):
            return torch.as_tensor(z[key]).to(device)

        state = FluidState(
            liquid_sdf=t("liquid_sdf"), solid_sdf=t("solid_sdf"),
            velocity=tuple(t(f"velocity_{a}") for a in range(3)),
            solid_velocity=tuple(t(f"solid_velocity_{a}") for a in range(3)),
            viscosity=t("viscosity"), density=t("density"), dx=float(z["dx"]),
        )
        return state, int(z["step"])
