"""Each matvec kernel's time per apply at the main path's shapes.

    python -m adaptiveviscositysolver_tpu_torch.tools.time_kernels

On ``scenes.buckling(n)`` for n in 96, 192 and 256 (the main path's scenes), with
``SolverConfig(octree_levels=4)``, the system make_solver builds on a first
frame (trimmed levels, the probe's crop windows, the card's routes) and a
seeded random u on the fluid faces: ``fused_tau`` / ``fused_dt`` over the
fused group, and ``tau_level`` / ``dt_level`` summed over every x-row range
of the split and bricked levels, in milliseconds per apply from CUDA events
around each launch, back to back as in the CG loop (L2 warm; the launches
are queued behind a spin of the device, so the events time the device, not
the host's Python between launches), over REPS applies; beside each, the
device-memory bytes its pass must move (``fused_apply.kernel_bytes``, the
bound's numerator).  Prints one JSON line.

The timers use only wrappers the package has had since the level kernels
came in, so one run on the card can time two checkouts: run this file by its path
with the other checkout first on ``PYTHONPATH``.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List

import torch

from adaptiveviscositysolver_tpu_torch import scenes, solver
from adaptiveviscositysolver_tpu_torch.config import SolverConfig
from adaptiveviscositysolver_tpu_torch.ops import fused_apply as fa
from adaptiveviscositysolver_tpu_torch.tools import SPIN_CYCLES_PER_CALL

DT = 1.0 / 24.0
SCENES = (96, 192, 256)
REPS = 20


def time_level_pair(args, meta, canon, enh, reps, plain=False):
    """Milliseconds per apply of one routed level's tau_level and dt_level
    launches (every x-row range, in the apply's order), from CUDA events
    around each launch; ``plain``: the plain versions."""
    dev = args["u0"].device
    ranges = canon.row_ranges()
    taus = [{n: torch.empty((t1 - t0,) + tuple(meta.shape[1:]), device=dev)
             for n in fa.TAU_NAMES}
            for t0, t1 in (fa.tau_rows(r, meta.shape[0]) for r in ranges)]
    out = fa.dt_outputs(meta, dev)
    tau_fn, dt_fn = ((fa.plain_tau_level, fa.plain_dt_level) if plain
                     else (fa.tau_level, fa.dt_level))

    def one(ev=None):
        for i, rows in enumerate(ranges):
            t = fa.tau_rows(rows, meta.shape[0])
            ev and ev[i][0].record()
            tau_fn(args, meta, enh, t, taus[i])
            ev and ev[i][1].record()
            dt_fn(args, taus[i], t[0], meta, enh, rows, out)
            ev and ev[i][2].record()

    one()
    evs = [[[torch.cuda.Event(enable_timing=True) for _ in range(3)] for _ in ranges]
           for _ in range(reps)]
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES_PER_CALL * 2 * len(ranges) * reps)
    for ev in evs:
        one(ev)
    torch.cuda.synchronize()
    return (sum(e[0].elapsed_time(e[1]) for ev in evs for e in ev) / reps,
            sum(e[1].elapsed_time(e[2]) for ev in evs for e in ev) / reps)


def time_fused_levels(args, metas, enh, reps):
    """Milliseconds per apply of fused_tau and fused_dt over these levels."""
    taus = fa.fused_tau(args, metas, enh)
    outs = fa.fused_dt(args, taus, metas, enh)
    ev = [[torch.cuda.Event(enable_timing=True) for _ in range(3)] for _ in range(reps)]
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES_PER_CALL * 2 * reps)
    for e in ev:
        e[0].record()
        fa.fused_tau(args, metas, enh, out=taus)
        e[1].record()
        fa.fused_dt(args, taus, metas, enh, out=outs)
        e[2].record()
    torch.cuda.synchronize()
    return (sum(e[0].elapsed_time(e[1]) for e in ev) / reps,
            sum(e[1].elapsed_time(e[2]) for e in ev) / reps)


def scene_system(n: int, device="cuda"):
    """buckling-n's system as make_solver builds it on a first frame."""
    state = scenes.buckling(n=n, device=device)
    cfg = SolverConfig(octree_levels=4, tolerance=1e-4)
    lv, windows = solver.probe_topology(state, cfg, device=device)
    return solver.build_system(state, DT, dataclasses.replace(cfg, octree_levels=lv),
                               device=device, bboxes=windows, pad_levels=4)


def time_scene(n: int, reps: int, device="cuda") -> Dict[str, object]:
    sys_ = scene_system(n, device)
    gen = torch.Generator(device="cpu").manual_seed(n)
    u = sys_.embed_tree({k: torch.randn(m.shape, generator=gen).to(device) * m
                         for k, m in sys_.active.items()})
    args, metas = sys_.apply_A.level_args(u), sys_.apply_A.metas
    res: Dict[str, object] = {"routes": [str(m) for m in sys_.modes],
                              "boxes": [list(m.shape) for m in metas]}
    fused: List[int] = [l for l, m in enumerate(sys_.modes) if m == "fused"]
    if fused:
        res["fused_tau"], res["fused_dt"] = time_fused_levels(
            [args[l] for l in fused], [metas[l] for l in fused], True, reps)
        res["fused_bytes"] = fa.kernel_bytes([metas[l] for l in fused])
    for l, m in enumerate(sys_.modes):
        if m != "fused":
            res[f"level{l}"] = dict(zip(("tau_level", "dt_level"), time_level_pair(
                args[l], metas[l], sys_.canons[l], True, reps)),
                bytes=fa.kernel_bytes([metas[l]]))
    return res


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("time_kernels: no CUDA device; it times the card")
    out = {"device": torch.cuda.get_device_name(0), "reps": REPS,
           "ms_per_apply": {str(n): time_scene(n, REPS) for n in SCENES}}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
