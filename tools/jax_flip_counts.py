"""The JAX package's CG iterations over a few FLIP frames of the buckling
scene, at one or more time steps, on the CPU.

The loop and solver are those of ``examples/run_buckling.py``
(``models.flip.simulate`` on ``scenes.buckling(n)``, float32 by default,
``SolverConfig(octree_levels=4, tolerance=1e-4)``); dt 1/48 is the
example's step and dt 1/24 bench.py's.  Besides the frames, the scene's
own first state (no advection, no gravity) is solved once at each step, so
that the step's effect on the count shows apart from the frames' states.
chip_smoke.py's FLIP frames (dt 1/24) and the example's (dt 1/48) on the
card are read against these counts, and so is the port's
``adaptiveviscositysolver_tpu_torch.tools.flip_counts``.

    PYTHONPATH=. JAX_PLATFORMS=cpu python tools/jax_flip_counts.py [n] [frames] [float64]

prints one JSON line per step: n, dt, dtype, the first state's iterations
and each frame's iterations, residuals and octree DOFs, and the wall
seconds.  ``float64`` builds the scene in float64 (x64 enabled), which
the solve then runs in.
"""

import json
import sys
import time

import jax
import jax.numpy as jnp

from adaptiveviscositysolver_tpu import scenes
from adaptiveviscositysolver_tpu.config import SolverConfig
from adaptiveviscositysolver_tpu.models import flip
from adaptiveviscositysolver_tpu.solver import make_solver

STEPS = {"1/24": 1.0 / 24.0, "1/48": 1.0 / 48.0}


def counts(n: int, frames: int, dt_name: str, dtype=jnp.float32) -> dict:
    config = SolverConfig(octree_levels=4, tolerance=1e-4)
    dt = STEPS[dt_name]
    t = time.perf_counter()
    first = make_solver(config)(scenes.buckling(n=n, dtype=dtype), jnp.float32(dt)).stats
    _, stats = flip.simulate(scenes.buckling(n=n, dtype=dtype), frames, dt, config)
    return {"n": n, "dt": dt_name, "dtype": jnp.dtype(dtype).name,
            "first_state_iterations": int(first.iterations),
            "frame_iterations": [int(s.iterations) for s in stats],
            "frame_residuals": [float(s.residual) for s in stats],
            "octree_dofs": [int(s.octree_dofs) for s in stats],
            "wall_s": time.perf_counter() - t}


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 32
    frames = int(sys.argv[2]) if len(sys.argv) > 2 else 5
    dtype = jnp.float32
    if len(sys.argv) > 3 and sys.argv[3] == "float64":
        jax.config.update("jax_enable_x64", True)
        dtype = jnp.float64
    for name in STEPS:
        print(json.dumps(counts(n, frames, name, dtype)), flush=True)
