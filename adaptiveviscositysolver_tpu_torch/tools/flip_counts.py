"""The port's CG iterations over a few FLIP frames of the buckling scene,
at one or more time steps (the counterpart of the JAX package's
``tools/jax_flip_counts.py``, which prints the same keys).

    python -m adaptiveviscositysolver_tpu_torch.tools.flip_counts [n] [frames] [--v1]

The loop and solver are those of ``examples.run_buckling`` (the frames of
``models.flip.step`` on ``scenes.buckling(n)``, float32,
``SolverConfig(octree_levels=4, tolerance=1e-4)``); dt 1/48 is the
example's step and dt 1/24 bench.py's.  The scene's own first state is
also solved once at each step through ``make_solver``.  ``--v1`` solves
each frame's state a second time in float64 on the whole-array ``v1``
operator and reports its iterations and the frame's velocity difference
from it (relative to its max).  One JSON line per step.  ``--device cpu``
runs the kernels' plain versions (tests only).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

from .. import scenes
from ..config import SolverConfig
from ..models import flip
from ..solver import make_solver, solve_viscosity
from . import check_device

STEPS = {"1/24": 1.0 / 24.0, "1/48": 1.0 / 48.0}
CONFIG = SolverConfig(octree_levels=4, tolerance=1e-4)


def frame_counts(state, frames: int, dt, config: SolverConfig = CONFIG, v1: bool = False,
                 device="cuda") -> dict:
    """``frames`` frames of ``models.flip.step`` from ``state``: each
    frame's iterations, residual and octree DOFs, and with ``v1`` the
    float64 ``v1`` solve of each frame's state beside it."""
    state = state.to(device=device)
    stats, v1_stats = [], []
    for _ in range(frames):     # models.flip.step, with the state before the solve kept
        state = flip.apply_gravity(flip.advect_state(state, dt), dt)
        out = solve_viscosity(state, dt, config, device=device)
        stats.append(out.stats)
        if v1:
            ref = solve_viscosity(state, dt, dataclasses.replace(config, dtype=torch.float64),
                                  device=device)
            scale = max(float(v.abs().max()) for v in ref.velocity)
            diff = max(float((a.double() - b).abs().max())
                       for a, b in zip(out.velocity, ref.velocity))
            v1_stats.append((ref.stats.solve_path, ref.stats.iterations, diff / scale))
        state = dataclasses.replace(state, velocity=out.velocity)
    rec = {"frame_iterations": [int(s.iterations) for s in stats],
           "frame_residuals": [float(s.residual) for s in stats],
           "octree_dofs": [int(s.octree_dofs) for s in stats],
           "solve_path": stats[0].solve_path}
    if v1:
        rec.update(v1_path=v1_stats[0][0], v1_iterations=[s[1] for s in v1_stats],
                   velocity_vs_v1_rel=[s[2] for s in v1_stats])
    return rec


def counts(n: int, frames: int, dt_name: str, v1: bool = False, device="cuda") -> dict:
    dt = STEPS[dt_name]
    t = time.perf_counter()
    first = make_solver(CONFIG, device=device)(scenes.buckling(n=n, device=device), dt).stats
    rec = frame_counts(scenes.buckling(n=n, device=device), frames, dt, CONFIG, v1, device)
    return {"n": n, "dt": dt_name, "first_state_iterations": int(first.iterations), **rec,
            "wall_s": time.perf_counter() - t}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", nargs="?", type=int, default=64)
    ap.add_argument("frames", nargs="?", type=int, default=5)
    ap.add_argument("--v1", action="store_true", help="each frame also as a float64 v1 solve")
    ap.add_argument("--device", default="cuda", help="cuda (default); cpu for the tests")
    a = ap.parse_args(argv)
    check_device(a.device)
    for name in STEPS:
        print(json.dumps(counts(a.n, a.frames, name, a.v1, a.device)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
