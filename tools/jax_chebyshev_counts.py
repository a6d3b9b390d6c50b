"""The JAX package's counts of one buckling frame under the degree-3
Chebyshev preconditioner, on the CPU.

The scene and solver are bench.py's (``scenes.buckling(n)``, float32,
``SolverConfig(octree_levels=4, tolerance=1e-4)``, dt = float32(1/24),
through ``make_solver``), with ``cheb_degree=3``; off a TPU the JAX
package runs its whole-array ``v1-fused`` operator.  chip_smoke.py holds
the PyTorch port's Chebyshev frames on the card to these counts.

    PYTHONPATH=. JAX_PLATFORMS=cpu python tools/jax_chebyshev_counts.py 96 192

prints one JSON line per size: levels, octree / regular DOFs, outer CG
iterations, residual, solve path and the frame's wall seconds.
"""

import json
import sys
import time

import jax
import jax.numpy as jnp

from adaptiveviscositysolver_tpu import scenes
from adaptiveviscositysolver_tpu.config import SolverConfig
from adaptiveviscositysolver_tpu.solver import make_solver


def counts(n: int, degree: int = 3) -> dict:
    state = scenes.buckling(n=n)
    solve = make_solver(SolverConfig(octree_levels=4, tolerance=1e-4, cheb_degree=degree))
    t = time.perf_counter()
    out = solve(state, jnp.float32(1.0 / 24.0))
    st = out.stats
    return {"n": n, "cheb_degree": degree, "levels": int(len(st.active_cells)),
            "octree_dofs": int(st.octree_dofs), "regular_dofs": int(st.regular_dofs),
            "iterations": int(st.iterations), "residual": float(st.residual),
            "solve_path": st.solve_path, "backend": jax.default_backend(),
            "wall_s": time.perf_counter() - t}


if __name__ == "__main__":
    for arg in sys.argv[1:] or ["96"]:
        print(json.dumps(counts(int(arg))), flush=True)
