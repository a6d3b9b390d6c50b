"""One apply of the port taken apart (port of the JAX package's
``tools/profile_levels.py``): the whole apply, each level's kernels alone,
a copy-only floor of level 0 and a one-op floor, per apply.

    python -m adaptiveviscositysolver_tpu_torch.tools.profile_levels [n] [K]

On ``scenes.buckling(n)`` (default 96) with ``SolverConfig(octree_levels=4)``
(the fused apply, ``apply_impl="cuda"``),
the system make_solver builds on a first frame (trimmed levels, the probe's
crop windows, the card's routes), and u = 1 on every fluid face:

* ``full apply``: the operator, glue and cross-level adds included;
* ``level l kernels only``: the level's kernels on its route ("fused": the
  all-level pair on this level alone; "split"/brick: ``tau_level`` and
  ``dt_level`` over each x-row range);
* ``level 0 stream floor``: ``ops.probes.stream_floor`` (T2) over level 0's
  inputs and window rows: what moving the level's bytes alone costs;
* ``floor (1 tiny op)``: one small device op, the launch cost.

Each variant is timed over K calls (CUDA events, L2 flushed before each
call; ``tools.call_ms``), in 3 interleaved rounds, best of 3.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import torch

from .. import scenes, solver
from ..config import SolverConfig
from ..ops import fused_apply as fa
from ..ops import probes
from . import call_ms, check_device, device_name

DT = 1.0 / 24.0


def level_kernels(apply_A, args, canons, modes, l: int):
    """A callable running level ``l``'s kernels on its route, alone."""
    meta, canon = apply_A.metas[l], canons[l]
    dev = args[l]["u0"].device
    if modes[l] == "fused":
        taus = fa._tau_buffers([meta], dev)
        outs = [fa.dt_outputs(meta, dev)]
        return lambda: fa.fused_dt([args[l]], fa.fused_tau([args[l]], [meta], True, out=taus),
                                   [meta], True, out=outs)
    ranges = [(rows, fa.tau_rows(rows, meta.shape[0])) for rows in canon.row_ranges()]
    taus = [{n: torch.empty((t1 - t0,) + meta.shape[1:], device=dev) for n in fa.TAU_NAMES}
            for _, (t0, t1) in ranges]
    out = fa.dt_outputs(meta, dev)

    def run():
        for (rows, t), tau in zip(ranges, taus):
            fa.tau_level(args[l], meta, True, t, tau)
            fa.dt_level(args[l], tau, t[0], meta, True, rows, out)
    return run


def build(n: int = 96, device="cuda"):
    """(system, u) of a first frame of buckling-n, as make_solver builds it."""
    cfg = SolverConfig(octree_levels=4, apply_impl="cuda")
    state = scenes.buckling(n=n, device=device)
    lv, windows = solver.probe_topology(state, cfg, device=device)
    sys_ = solver.build_system(state, DT, dataclasses.replace(cfg, octree_levels=lv),
                               device=device, bboxes=windows, pad_levels=cfg.octree_levels)
    one = torch.ones((), dtype=torch.float32, device=device)
    u = sys_.embed_tree({k: torch.where(m, one, 0 * one) for k, m in sys_.active.items()})
    return sys_, u


def run(n: int = 96, K: int = 100, device="cuda") -> dict:
    """Milliseconds per apply of each variant, with the system's shapes."""
    device = check_device(device)
    sys_, u = build(n, device)
    apply_A, canons, modes = sys_.apply_A, sys_.canons, sys_.modes
    args = apply_A.level_args(u)
    floor_in = probes.floor_inputs(args[0], apply_A.metas[0])
    rows = probes.window_rows(canons[0])
    top = (len(canons) - 1, 0)
    variants = {"full apply": lambda: apply_A(u)}
    for l in range(len(canons)):
        variants[f"level {l} kernels only ({modes[l]})"] = level_kernels(apply_A, args, canons,
                                                                         modes, l)
    variants["level 0 stream floor"] = lambda: probes.stream_floor(floor_in, rows)
    variants["floor (1 tiny op)"] = lambda: u[top] + 1.0
    best = {name: float("inf") for name in variants}
    for _ in range(3):
        for name, fn in variants.items():
            best[name] = min(best[name], call_ms(fn, K, device))
    return {"device": device_name(device), "n": n, "K": K, "routes": [str(m) for m in modes],
            "boxes": [list(c.shape) for c in canons], "floor_rows": list(rows),
            "floor_bytes": probes.probe_bytes(floor_in, 3, rows), "ms": best}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", nargs="?", type=int, default=96)
    ap.add_argument("K", nargs="?", type=int, default=100)
    ap.add_argument("--device", default="cuda", help="cuda (default); cpu for the tests")
    a = ap.parse_args(argv)
    r = run(a.n, a.K, a.device)
    print(f"[{r['device']}] buckling-{r['n']}: routes {r['routes']}, boxes {r['boxes']}; "
          f"level 0 floor moves {r['floor_bytes'] / 1e6:.1f} MB")
    for name, ms in r["ms"].items():
        print(f"{name:34s}: {ms:8.4f} ms/apply")
    print(json.dumps(r))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
