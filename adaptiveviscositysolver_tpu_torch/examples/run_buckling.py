"""Run the coiling/buckling scene for a few frames on the card and export
each frame's adaptive octree as a PLY point cloud (port of
``examples/run_buckling.py``).

    python -m adaptiveviscositysolver_tpu_torch.examples.run_buckling [frames] [n]

Files land in ./out_buckling_torch/: frame_XXX.ply (ACTIVE cell centers
with pscale and octree_level attributes, the analog of the reference's
outputOctreeGeometry debug geometry), and a stats line per frame goes to
standard output.  The command line runs on the card; ``run`` also takes
``device="cpu"``, which runs the kernels' plain versions.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Callable, List, Optional, Sequence

import torch

from .. import native, octree, scenes
from ..config import SolverConfig, capped_levels
from ..models import flip
from ..solver import FluidState

OUTDIR = "out_buckling_torch"
CONFIG = SolverConfig(octree_levels=4, tolerance=1e-4)
DT = 1.0 / 48.0


def frame_labels(state: FluidState, config: SolverConfig, levels: int) -> List[torch.Tensor]:
    """The octree whose ACTIVE cells a frame's PLY holds (the refinement
    bands of the JAX example: outer 3 dx, inner 2 dx)."""
    dx = state.dx
    mask = octree.build_refinement_mask(state.liquid_sdf, state.solid_sdf, dx,
                                        config.extrapolation * dx, 3 * dx, 2 * dx)
    return octree.build_octree(mask, levels)


def stats_line(rec: dict) -> str:
    return (f"frame {rec['frame']:3d}: iters={rec['iterations']:4d} "
            f"residual={rec['residual']:.2e} "
            f"octree_dofs={rec['octree_dofs']} "
            f"active_cells={rec['active_cells']} "
            f"ply={rec['ply_points']}pts -> {rec['path']}")


def run(state: FluidState, frames: int, dt, config: SolverConfig, outdir, device="cuda",
        on_frame: Optional[Callable[[dict], None]] = None) -> List[dict]:
    """``frames`` FLIP steps of ``state`` on ``device``, each frame's octree
    written to ``outdir/frame_XXX.ply``.  Returns one record per frame:
    frame, iterations, residual, octree_dofs, active_cells (the solve's
    ACTIVE cells per level), ply_points, path; ``on_frame(record)`` after
    each."""
    os.makedirs(outdir, exist_ok=True)
    levels = capped_levels(tuple(state.liquid_sdf.shape), config.octree_levels)
    records = []

    def frame_done(i, st, stats):
        path = os.path.join(outdir, f"frame_{i:03d}.ply")
        points = native.export_octree_ply(frame_labels(st, config, levels), st.dx, path)
        rec = dict(frame=i, iterations=int(stats.iterations), residual=float(stats.residual),
                   octree_dofs=int(stats.octree_dofs),
                   active_cells=[int(c) for c in stats.active_cells],
                   ply_points=int(points), path=path)
        records.append(rec)
        if on_frame is not None:
            on_frame(rec)

    flip.simulate(state.to(device=device), frames, dt, config, on_frame=frame_done,
                  device=device)
    return records


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("frames", nargs="?", type=int, default=5)
    ap.add_argument("n", nargs="?", type=int, default=64)
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> int:
    a = parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the example runs on the card")
    state = scenes.buckling(n=a.n, device="cuda")
    t0 = time.perf_counter()
    run(state, a.frames, DT, CONFIG, OUTDIR, device="cuda",
        on_frame=lambda rec: print(stats_line(rec), flush=True))
    print(f"total: {a.frames} frames in {time.perf_counter() - t0:.1f}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
