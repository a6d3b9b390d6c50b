#!/usr/bin/env python3
"""Readings that the limits of ``correct`` are set from, several seeds in
one process (the benchmark's own runs never run this):

    python3 bench_h100/control.py --workload <name> --seeds <n> [<n> ...] --seconds <s> \
        [--mode program|control|both]

``program``: a run of the cell per seed (set-up, a window of ``--seconds``,
the check), the lower readings.  ``control``: the plain reference put in
the program's place, its stages in the configuration's dtype and its
operator and CG one precision below it (``CONTROL_DTYPES``): bfloat16 under
float32 (the nearest step down for work with no matrix product, so no
TF32), float32 under float64 (what a float64 configuration must tell from
its own answer, refined or not).  No warm-up; its frames are held to the
float64 reference as a run's are: the upper readings.  One JSON line per
seed and mode.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import types

import run  # noqa: E402  (puts the checkout on sys.path)

import torch  # noqa: E402

from reference.solve import reference_frame  # noqa: E402


# the configuration's dtype -> the precision its control solves in
CONTROL_DTYPES = {"float32": torch.bfloat16, "float64": torch.float32}


def control_dtype(config) -> torch.dtype:
    """The precision one step below the configuration's dtype."""
    return CONTROL_DTYPES[config["dtype"]]


def control_solver(config):
    """A stand-in for ``make_solver``: each frame is the reference's, in the
    configuration's dtype with its system and CG in :func:`control_dtype`."""
    solve_dtype = control_dtype(config)

    def factory(_cfg, device=None):
        ref_cfg = run.reference_config(config)

        def solve(state, dt, stage_times=None):
            inp = {"liquid_sdf": state.liquid_sdf, "solid_sdf": state.solid_sdf,
                   "velocity": state.velocity, "solid_velocity": state.solid_velocity,
                   "viscosity": state.viscosity, "density": state.density, "dx": state.dx}
            out = reference_frame(inp, dt, ref_cfg, dtype=state.liquid_sdf.dtype,
                                  solve_dtype=solve_dtype)
            stats = types.SimpleNamespace(
                iterations=out["iterations"], residual=out["residual"],
                octree_dofs=out["octree_dofs"], regular_dofs=out["regular_dofs"],
                active_cells=out["active_cells"])
            return types.SimpleNamespace(velocity=out["velocity"], stats=stats)

        return solve

    return factory


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--mode", choices=("program", "control", "both"), default="both")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    bench = run.load_json(run.ROOT / "BENCHMARK.json")
    cell, config, traffic = run.find_cell(bench, args.workload)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    modes = ("program", "control") if args.mode == "both" else (args.mode,)
    for seed in args.seeds:
        for mode in modes:
            t0 = time.perf_counter()
            if mode == "program":
                res = run.run_cell(cell, config, traffic, seed, args.seconds, False, args.device)
            else:
                # no warm-up: the control is no closure to warm
                res = run.run_cell(cell, config, dict(traffic, warmup_frames=0), seed,
                                   args.seconds, False, args.device,
                                   make_solver=control_solver(config))
            print(json.dumps({"workload": args.workload, "seed": seed, "mode": mode,
                              "correct": res["correct"], "attempted": res["attempted"],
                              "seconds": time.perf_counter() - t0,
                              "checks": {k: v["value"] for k, v in res["checks"].items()}}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
