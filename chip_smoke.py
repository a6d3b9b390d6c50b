#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (adaptiveviscositysolver_tpu_torch) on
one NVIDIA GPU: the quickest proof that the port builds, that its
hand-written kernels agree with their plain PyTorch versions, and that the
main path solves a real frame through them.

    python3 chip_smoke.py

Phases (one line each, elapsed seconds first):
  0 device   -- card name and power limit (nvidia-smi), torch version; no
                CUDA device is a failure, never a CPU run
  1 build    -- nvcc builds csrc/ into build/torch_kernels/, one nvcc per
                source, all started together (budget 60 s)
  2 kernels  -- on buckling-96's real frame data, every kernel against its
                plain version on the card (3e-5 * max per level and output),
                and the whole fused apply against its plain version and the
                whole-array operator; kernel / plain times with CUDA events;
                the library yardstick: the assembled CSR system (export.py)
                times A @ x on the card, checked against the apply
  2b routes  -- every route on the same frame: split, bricked (>= 3 bricks
                on level 0) and fused levels mixed, and every level bricked;
                tau_level / dt_level against their plain versions per level,
                brick and output, the whole routed apply against the plain
                apply and the whole-array operator, exact-zero pads
  3 solve    -- make_solver(SolverConfig(octree_levels=4, tolerance=1e-4))
                on scenes.buckling(96): one cold and three warm frames,
                through the kernels (launch counts read around the cold
                frame), checked against the JAX package's
                hardware-independent counts (3 levels, 186836 octree DOFs,
                284564 regular DOFs, 203 +- 2 CG iterations); a small frame
                is checked against the whole-array float64 solve
  4 trace    -- torch.profiler trace of one more warm frame: device idle
                share of the frame and of each stage (the stages are
                record_function spans), device time per op in the CG
  5 192      -- the large-grid path: make_solver on scenes.buckling(192),
                one cold and two warm frames through the routes the card's L2
                budget picks (launch counts read around the cold frame: each
                kernel once per apply and x-row range of its levels),
                checked against the JAX package's counts (4 levels, 820288 /
                2209612 DOFs, 337 +- 2 iterations, residual <= 1e-4); every
                kernel of those routes (the routed levels' bricks, the fused
                group) against its plain version at these shapes; A/B of the
                default routes against every level fused
  6 256      -- scenes.buckling(256): one frame on the default routes (brick
                and split) against one with every level fused (an unbounded
                budget): launch counts against each frame's routes, same
                DOFs, iterations +- 2, velocity within rel 5e-4; every kernel
                of the default routes (level 0's bricks, level 1 split, the
                fused group) against its plain version; peak device memory

The last lines are a ``{"kernels": [...]}`` JSON line, the nvidia-smi line,
and ``{"ok": true, "device": {...}}``.  Every failed check raises; the whole
run is bounded by an in-process deadline.  It imports nothing of JAX.
"""

import dataclasses
import json
import math
import os
import signal
import statistics
import subprocess
import sys
import time

DEADLINE_S = 480        # whole run, build included
BUILD_BUDGET_S = 60.0
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (data sheet)
FP32_FLOPS_PER_S = 67e12    # H100 SXM float32 outside the tensor cores
TOL = 3e-5                  # kernel vs plain: atol = TOL * max|plain|
N = 96
EXPECT = dict(levels=3, octree_dofs=186836, regular_dofs=284564, iterations=203)
# the JAX package's record of buckling-192 (BENCH_r05.json, scale_point)
EXPECT_192 = dict(levels=4, octree_dofs=820288, regular_dofs=2209612, iterations=337)
_PA = "adaptiveviscositysolver_tpu/ops/pallas_apply.py"
_FUSED = f"{_PA}:1359 (_make_fused_kernel, level 0) + :1447 (_make_merged_kernel, levels >= 1)"
REPLACES = {
    "fused_tau": _FUSED, "fused_dt": _FUSED,
    "tau_level": f"{_PA}:846 (_make_tau_kernel) + :751-843 (_level_kernel, bricked branch)",
    "dt_level": f"{_PA}:913 (_make_dt_kernel) + :751-843 (_level_kernel, bricked branch)",
}
SOURCE = {"fused_tau": "fused_apply.cu", "fused_dt": "fused_apply.cu",
          "tau_level": "level_apply.cu", "dt_level": "level_apply.cu"}

T0 = time.perf_counter()


def log(phase, msg):
    print(f"[{time.perf_counter() - T0:8.2f}s] {phase}: {msg}", flush=True)


def _deadline(signum, frame):
    raise TimeoutError(f"chip_smoke.py passed its {DEADLINE_S} s deadline")


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Mean milliseconds per call, CUDA events around ``reps`` calls after
    one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def busy_us(intervals, lo, hi):
    """Microseconds of [lo, hi) covered by at least one (start, end)."""
    busy, end = 0.0, lo
    for s, e in sorted(intervals):
        s, e = max(s, end), min(e, hi)
        if e > s:
            busy += e - s
        end = max(end, e)
    return busy


def trace_frame(solve, state, dt, path):
    """One frame under torch.profiler; returns (result, {span name: (start,
    end)} of the host-side record_function spans, [(start, end, name)] of
    the device's kernels, copies and fills), in trace microseconds."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("frame"):
            res = solve(state, dt)
            torch.cuda.synchronize()
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    spans = {e["name"]: (e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("cat") == "user_annotation" and "dur" in e}
    device_events = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                     if e.get("cat") in DEVICE_CATS and "dur" in e]
    return res, spans, device_events


def max_rel_err(pairs):
    """(max abs error, worst error / max|want|) over (got, want) pairs,
    asserting each pair within TOL * max|want|."""
    worst_abs = worst_rel = 0.0
    for name, got, want in pairs:
        err = float((got - want).abs().max())
        scale = max(float(want.abs().max()), 1e-30)
        assert err <= TOL * scale, f"{name}: max abs diff {err} > {TOL} * {scale}"
        worst_abs = max(worst_abs, err)
        worst_rel = max(worst_rel, err / scale)
    return worst_abs, worst_rel


def bound(nbytes, nflops):
    """(least ms, what bounds it): bytes over the memory rate or operations
    over the float32 rate, whichever takes longer."""
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    f_ms = nflops / FP32_FLOPS_PER_S * 1e3
    return (max(b_ms, f_ms), "bytes" if b_ms >= f_ms else "operations")


def pads_zero(out, res_per_level, canons, what):
    """Every canonical pad of an apply's output is exactly zero (the CG's
    flat vector spans the whole box)."""
    import torch
    from adaptiveviscositysolver_tpu_torch.ops import fused_apply as fa
    from adaptiveviscositysolver_tpu_torch.ops.arrayops import face_shape

    for (l, f), arr in out.items():
        win = fa.embed(torch.ones(face_shape(res_per_level[l], f), dtype=torch.bool,
                                  device=arr.device), canons[l], False)
        assert not bool(arr[~win].any()), f"{what}: level {l} axis {f}: a pad is not zero"


def _tau_bufs(meta, rows, dev):
    import torch
    from adaptiveviscositysolver_tpu_torch.ops import fused_apply as fa

    return {n: torch.empty((rows[1] - rows[0],) + tuple(meta.shape[1:]), device=dev)
            for n in fa.TAU_NAMES}


def level_pair_errors(args, meta, canon, enh):
    """tau_level and dt_level on the card against their plain versions on
    every x-row range of one routed level (both D^T passes fed the plain
    weighted stresses), per range and output: the worst (abs, rel) of
    each kernel."""
    from adaptiveviscositysolver_tpu_torch.ops import fused_apply as fa

    dev = args["u0"].device
    tau_pairs = []
    out_k, out_p = fa.dt_outputs(meta, dev), fa.dt_outputs(meta, dev)
    for rows in canon.row_ranges():
        t = fa.tau_rows(rows, meta.shape[0])
        tk = fa.tau_level(args, meta, enh, t, _tau_bufs(meta, t, dev))
        tp = fa.plain_tau_level(args, meta, enh, t, _tau_bufs(meta, t, dev))
        tau_pairs += [(f"level {meta.level} rows {t} {n}", tk[n], tp[n]) for n in fa.TAU_NAMES]
        fa.dt_level(args, tp, t[0], meta, enh, rows, out_k)
        fa.plain_dt_level(args, tp, t[0], meta, enh, rows, out_p)
    dt_pairs = [(f"level {meta.level} {n}", out_k[n], out_p[n]) for n in out_p]
    return max_rel_err(tau_pairs), max_rel_err(dt_pairs)


def fused_pair_errors(args, metas, enh, what):
    """fused_tau and fused_dt on the card against their plain versions over
    one group of levels (D^T fed the plain weighted stresses), per level
    and output: the worst (abs, rel) of each kernel, and the plain
    weighted stresses."""
    from adaptiveviscositysolver_tpu_torch.ops import fused_apply as fa

    taus_k = fa.fused_tau(args, metas, enh)
    taus_p = fa._plain_tau(args, metas, enh)
    outs_k = fa.fused_dt(args, taus_p, metas, enh)
    outs_p = fa._plain_dt(args, taus_p, metas, enh)
    tau = max_rel_err((f"{what} level {m.level} {n}", k[n], p[n])
                      for k, p, m in zip(taus_k, taus_p, metas) for n in p)
    dt = max_rel_err((f"{what} level {m.level} {n}", k[n], p[n])
                     for k, p, m in zip(outs_k, outs_p, metas) for n in p)
    return tau, dt, taus_p


def routed_errors(args, metas, canons, modes, enh, what):
    """Every kernel of one frame's routes against its plain version: the
    level pair on every x-row range of each split or bricked level, the
    fused pair on the fused group.  {kernel: worst (abs, rel)}."""
    err = {k: (0.0, 0.0) for k in ("fused_tau", "fused_dt", "tau_level", "dt_level")}
    for l, m in enumerate(modes):
        if m != "fused":
            e_tau, e_dt = level_pair_errors(args[l], metas[l], canons[l], enh)
            err["tau_level"] = worst(err["tau_level"], e_tau)
            err["dt_level"] = worst(err["dt_level"], e_dt)
    fused = [l for l, m in enumerate(modes) if m == "fused"]
    if fused:
        e_tau, e_dt, _ = fused_pair_errors([args[l] for l in fused], [metas[l] for l in fused],
                                           enh, what)
        err["fused_tau"], err["fused_dt"] = e_tau, e_dt
    return err


def check_launches(counts, applies, canons, modes, what):
    """One frame's launch counts against its routes: the fused pair once per
    apply if a level is fused, the level pair once per apply and x-row
    range of every split or bricked level."""
    from adaptiveviscositysolver_tpu_torch.ops import fused_apply as fa

    fused = int("fused" in modes)
    ranges = sum(len(c.row_ranges()) for c, m in zip(fa.route_canons(canons, modes), modes)
                 if m != "fused")
    want = {"fused_tau": applies * fused, "fused_dt": applies * fused,
            "tau_level": applies * ranges, "dt_level": applies * ranges}
    assert counts == want, f"{what}: launches {counts}, want {want} ({applies} applies, {modes})"


def worst(*errs):
    """The worst (abs, rel) of several."""
    return (max(e[0] for e in errs), max(e[1] for e in errs))


def time_level_pair(args, meta, canon, enh, reps, plain=False):
    """Milliseconds per apply of one routed level's tau_level and dt_level
    launches (every x-row range, in the apply's order), from CUDA events
    around each launch; ``plain``: the plain versions."""
    import torch
    from adaptiveviscositysolver_tpu_torch.ops import fused_apply as fa

    dev = args["u0"].device
    ranges = canon.row_ranges()
    taus = [_tau_bufs(meta, fa.tau_rows(r, meta.shape[0]), dev) for r in ranges]
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
    torch.cuda.synchronize()
    tau_ms = dt_ms = 0.0
    for _ in range(reps):
        ev = [[torch.cuda.Event(enable_timing=True) for _ in range(3)] for _ in ranges]
        one(ev)
        torch.cuda.synchronize()
        tau_ms += sum(e[0].elapsed_time(e[1]) for e in ev)
        dt_ms += sum(e[1].elapsed_time(e[2]) for e in ev)
    return tau_ms / reps, dt_ms / reps


def time_fused_levels(args, metas, enh, reps):
    """Milliseconds per apply of fused_tau and fused_dt over these levels."""
    import torch
    from adaptiveviscositysolver_tpu_torch.ops import fused_apply as fa

    taus = fa.fused_tau(args, metas, enh)
    fa.fused_dt(args, taus, metas, enh)
    torch.cuda.synchronize()
    ev = [[torch.cuda.Event(enable_timing=True) for _ in range(3)] for _ in range(reps)]
    for e in ev:
        e[0].record()
        fa.fused_tau(args, metas, enh, out=taus)
        e[1].record()
        fa.fused_dt(args, taus, metas, enh)
        e[2].record()
    torch.cuda.synchronize()
    return (sum(e[0].elapsed_time(e[1]) for e in ev) / reps,
            sum(e[1].elapsed_time(e[2]) for e in ev) / reps)


def csr_yardstick(sys_, u_log, levels, reps):
    """The library call: the assembled system of the stress blocks of
    ``levels`` (mass of those levels only), exported on the host
    (export.py, float64) and put on the card as a float32 CSR tensor, times
    ``A @ x`` on the DOF vector of ``u_log`` (cuSPARSE).  Returns (ms,
    A @ x as per-(level, axis) grids, export seconds, nonzeros)."""
    import numpy as np
    import torch
    from adaptiveviscositysolver_tpu_torch import export

    t = time.perf_counter()
    blocks = [b for b in sys_.blocks if b.level in levels]
    mass = {k: v if k[0] in levels else torch.zeros_like(v) for k, v in sys_.mass.items()}
    A, _, vel_idx, n = export.export_sparse_system(blocks, mass, sys_.vel_kinds, sys_.guess,
                                                   sys_.res_per_level)
    export_s = time.perf_counter() - t
    dev = u_log[(0, 0)].device
    A_t = torch.sparse_csr_tensor(torch.from_numpy(A.indptr.astype(np.int32)),
                                  torch.from_numpy(A.indices.astype(np.int32)),
                                  torch.from_numpy(A.data.astype(np.float32)), (n, n)).to(dev)
    x = np.zeros(n, np.float32)
    for (l, a), idx in ((k, vel_idx[k[0]][k[1]]) for k in u_log):
        sel = idx >= 0
        x[idx[sel]] = u_log[(l, a)].cpu().numpy()[sel]
    x = torch.from_numpy(x).to(dev)
    ms = cuda_ms(lambda: A_t @ x, reps)
    y = (A_t @ x).cpu().numpy()
    grids = {}
    for (l, a) in u_log:
        idx = vel_idx[l][a]
        grids[(l, a)] = torch.from_numpy(np.where(idx >= 0, y[np.clip(idx, 0, None)], 0.0)
                                         .astype(np.float32)).to(dev)
    return ms, grids, export_s, int(A.nnz)


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; the port's smoke run needs one", file=sys.stderr)
        return 2
    signal.signal(signal.SIGALRM, _deadline)
    signal.alarm(DEADLINE_S)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from adaptiveviscositysolver_tpu_torch import scenes, solver
    from adaptiveviscositysolver_tpu_torch.config import SolverConfig
    from adaptiveviscositysolver_tpu_torch.ops import _build
    from adaptiveviscositysolver_tpu_torch.ops import fused_apply as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    dt = float(np.float32(1.0 / 24.0))  # the bench.py step, as a float32

    # ---- 0 device
    smi = nvidia_smi_line()
    log("device", f"{smi} | torch {torch.__version__} cuda {torch.version.cuda} | "
                  f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    # ---- 1 build
    t = time.perf_counter()
    builds = _build.build()
    build_s = time.perf_counter() - t
    for stem, info in builds.items():
        regs = [ln.strip() for ln in info["log"].splitlines() if "registers" in ln or "spill" in ln]
        log("build", f"{stem}: nvcc {info['seconds']:.2f} s (cached={info['cached']}); "
                     + " | ".join(regs))
    log("build", f"total {build_s:.2f} s into {_build.BUILD_DIR}")
    assert build_s <= BUILD_BUDGET_S, f"build took {build_s:.1f} s > {BUILD_BUDGET_S} s"
    for stem in _build.SOURCES:
        fa._library(stem)     # load, bind, check the descriptor layout

    # ---- 2 kernels against their plain versions, on buckling-96's frame
    cfg = SolverConfig(octree_levels=4, tolerance=1e-4)
    state = scenes.buckling(n=N, device=dev)
    lv, windows = solver.probe_topology(state, cfg, device=dev)
    cfg_lv = SolverConfig(octree_levels=lv, tolerance=1e-4)
    sys_ = solver.build_system(state, dt, cfg_lv, device=dev, bboxes=windows, pad_levels=4)
    assert sys_.impl == "cuda", sys_.impl
    assert sys_.modes == ["fused"] * lv, sys_.modes
    enh = cfg.use_enhanced_gradients
    apply_k = sys_.apply_A
    apply_p, _, _ = fa.make_fused_operator(sys_.frame, sys_.canons, sys_.active,
                                           sys_.res_per_level, state.dx, enh, plain=True)
    metas = apply_k.metas
    log("kernels", f"{lv} levels, windows {windows}, canonical boxes "
                   f"{[m.shape for m in metas]}, routes {sys_.modes}")
    gen = torch.Generator(device="cpu").manual_seed(0)
    u_log = {k: torch.randn(m.shape, generator=gen).to(dev) * m for k, m in sys_.active.items()}
    u = sys_.embed_tree(u_log)
    args = apply_k.level_args(u)
    (tau_abs, tau_rel), (dt_abs, dt_rel), taus_p = fused_pair_errors(args, metas, enh, "96")
    err = {"fused_tau": (tau_abs, tau_rel), "fused_dt": (dt_abs, dt_rel)}
    got = apply_k(u)
    want = want_p = apply_p(u)
    v1 = sys_.apply_v1(u_log)
    torch.cuda.synchronize()
    app_abs, app_rel = max_rel_err((f"apply {k}", got[k], want[k]) for k in want)
    cropped = sys_.crop_tree(got)
    v1_abs, v1_rel = max_rel_err((f"apply vs v1 {k}", cropped[k], v1[k]) for k in v1)
    log("kernels", f"fused_tau vs plain max abs {tau_abs:.3e} (rel {tau_rel:.2e}); fused_dt vs "
                   f"plain {dt_abs:.3e} (rel {dt_rel:.2e}); whole apply vs plain {app_abs:.3e} "
                   f"(rel {app_rel:.2e}), vs whole-array v1 {v1_abs:.3e} (rel {v1_rel:.2e})")

    reps = 50
    tau_ms = cuda_ms(lambda: fa.fused_tau(args, metas, enh), reps)
    dt_ms = cuda_ms(lambda: fa.fused_dt(args, taus_p, metas, enh), reps)
    tau_plain_ms = cuda_ms(lambda: fa._plain_tau(args, metas, enh), 5)
    dt_plain_ms = cuda_ms(lambda: fa._plain_dt(args, taus_p, metas, enh), 5)
    apply_ms = cuda_ms(lambda: apply_k(u), 20)
    apply_plain_ms = cuda_ms(lambda: apply_p(u), 5)
    nbytes = fa.kernel_bytes(metas)
    flops = fa.kernel_flops(metas, enh)
    bounds = {"fused_tau": bound(nbytes["tau"], flops["tau"]),
              "fused_dt": bound(nbytes["dt"], flops["dt"])}
    log("kernels", f"per apply: fused_tau {tau_ms:.4f} ms (plain {tau_plain_ms:.3f} ms, bound "
                   f"{bounds['fused_tau'][0]:.4f} ms = {nbytes['tau'] / 1e6:.1f} MB), "
                   f"fused_dt {dt_ms:.4f} ms (plain {dt_plain_ms:.3f} ms, bound "
                   f"{bounds['fused_dt'][0]:.4f} ms = {nbytes['dt'] / 1e6:.1f} MB); whole "
                   f"apply with glue {apply_ms:.4f} ms (plain {apply_plain_ms:.3f} ms) | {smi}")

    # the library yardstick: one cuSPARSE CSR product computes the apply
    lib_ms, lib_y, export_s, nnz = csr_yardstick(sys_, u_log, range(lv), reps)
    lib_abs, lib_rel = max_rel_err((f"CSR A @ x vs apply {k}", cropped[k], lib_y[k])
                                   for k in lib_y)
    log("kernels", f"library: CSR A @ x {lib_ms:.4f} ms per apply ({nnz} nonzeros, export "
                   f"{export_s:.2f} s on the host), vs the kernels' apply max abs {lib_abs:.3e} "
                   f"(rel {lib_rel:.2e}) | {smi}")
    del got, want, cropped, lib_y

    # ---- 2b every route on the same frame
    cx = [c.shape[0] for c in sys_.canons]
    third = [max(2, (n // 3) & ~1) for n in cx]    # >= 3 bricks per level
    route_sets = {
        "brick/split/fused": [("brick", third[0]), "split", "fused"],
        "split/brick/fused": ["split", ("brick", third[1]), "fused"],
        "all brick": [("brick", t) for t in third],
    }
    route_err = {"tau_level": (0.0, 0.0), "dt_level": (0.0, 0.0)}
    for name, modes in route_sets.items():
        canons = fa.route_canons(sys_.canons, modes)
        for c, m in zip(canons, modes):
            assert m in ("fused", "split") or len(c.row_ranges()) >= 3, (name, m, c)
        apply_r, _, _ = fa.make_fused_operator(sys_.frame, canons, sys_.active,
                                               sys_.res_per_level, state.dx, enh, modes=modes)
        args_r = apply_r.level_args(u)
        times = []
        for l, m in enumerate(modes):
            if m == "fused":
                continue
            e_tau, e_dt = level_pair_errors(args_r[l], metas[l], canons[l], enh)
            route_err["tau_level"] = worst(route_err["tau_level"], e_tau)
            route_err["dt_level"] = worst(route_err["dt_level"], e_dt)
            t_ms, d_ms = time_level_pair(args_r[l], metas[l], canons[l], enh, 10)
            times.append(f"level {l} {m}: {len(canons[l].row_ranges())} ranges, tau_level "
                         f"{t_ms:.4f} ms, dt_level {d_ms:.4f} ms per apply")
        got_r = apply_r(u)
        pads_zero(got_r, sys_.res_per_level, canons, name)
        r_abs, r_rel = max_rel_err((f"{name} apply vs plain {k}", got_r[k], want_p[k])
                                   for k in want_p)
        cr = sys_.crop_tree(got_r)
        v_abs, v_rel = max_rel_err((f"{name} apply vs v1 {k}", cr[k], v1[k]) for k in v1)
        log("routes", f"{name} {modes}: apply vs plain {r_abs:.3e} (rel {r_rel:.2e}), vs "
                      f"whole-array v1 {v_abs:.3e} (rel {v_rel:.2e}), pads exactly 0 | "
                      + "; ".join(times))
    log("routes", f"level kernels vs plain over every route: tau_level max abs "
                  f"{route_err['tau_level'][0]:.3e} (rel {route_err['tau_level'][1]:.2e}), "
                  f"dt_level {route_err['dt_level'][0]:.3e} (rel {route_err['dt_level'][1]:.2e})")
    err.update(route_err)
    del taus_p, v1, args, u, u_log, want_p, sys_, apply_k, apply_p

    # ---- 3 solve: the main path, through make_solver
    solve = solver.make_solver(cfg, device=dev)
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    t = time.perf_counter()
    res = solve(state, dt)
    for v in res.velocity:
        v.sum().item()
    cold_s = time.perf_counter() - t
    launches = dict(fa.launch_counts)
    st = res.stats
    log("solve", f"cold frame {cold_s:.3f} s: {st} | launches {launches}")
    assert st.solve_path == "cuda", st.solve_path
    assert len(st.active_cells) == EXPECT["levels"], st.active_cells
    assert st.octree_dofs == EXPECT["octree_dofs"], st.octree_dofs
    assert st.regular_dofs == EXPECT["regular_dofs"], st.regular_dofs
    assert abs(st.iterations - EXPECT["iterations"]) <= 2, st.iterations
    assert st.residual <= 1e-4, st.residual
    for name in ("fused_tau", "fused_dt"):
        assert launches[name] >= st.applies >= st.iterations + 1, (name, launches, st.applies)
    # buckling-96's weighted stresses fit the L2 budget: every level fused
    assert launches["tau_level"] == launches["dt_level"] == 0, launches
    for a, v in enumerate(res.velocity):
        assert tuple(v.shape) == tuple(N + (1 if d == a else 0) for d in range(3)), v.shape
        assert bool(torch.isfinite(v).all()), f"velocity {a} not finite"

    warm = []
    for _ in range(3):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        r = solve(state, dt)
        stop.record()
        torch.cuda.synchronize()
        warm.append(start.elapsed_time(stop))
        assert r.stats.iterations == st.iterations
    stages = {}
    solve(state, dt, stage_times=stages)
    log("solve", f"warm frames {['%.2f' % w for w in warm]} ms, median "
                 f"{statistics.median(warm):.2f} ms | stages (synchronized) "
                 + ", ".join(f"{k} {v * 1e3:.2f} ms" for k, v in stages.items())
                 + f" | CG {st.iterations} iterations, {st.applies} applies | {smi}")

    # ---- 4 trace of one warm frame: where the device waits
    from pathlib import Path

    trace_path = Path(_build.BUILD_DIR).parent / "torch_trace" / "warm_frame.json"
    r, spans, events = trace_frame(solve, state, dt, trace_path)
    assert r.stats.iterations == st.iterations
    # the profiler slows the host about 2x, so idle shares under it overstate
    # the unprofiled run's; the *_unprofiled shares divide the traced device
    # time by the unprofiled walls (warm-frame median, synchronized CG stage)
    trace = {"frame_wall_ms": None, "frame_device_ms": None, "frame_idle_share": None,
             "frame_idle_share_unprofiled": None, "cg_idle_share_unprofiled": None,
             "stages": {}, "cg_top_ops": []}
    if not events:
        log("trace", "the trace holds no device events: device idle share not measured")
    else:
        lo, hi = spans["frame"]
        busy = busy_us([(a, b) for a, b, _ in events], lo, hi)
        trace.update(frame_wall_ms=(hi - lo) / 1e3, frame_device_ms=busy / 1e3,
                     frame_idle_share=1.0 - busy / (hi - lo))
        for name in stages:
            slo, shi = spans[name]
            sb = busy_us([(a, b) for a, b, _ in events], slo, shi)
            trace["stages"][name] = {"wall_ms": (shi - slo) / 1e3, "device_ms": sb / 1e3,
                                     "idle_share": 1.0 - sb / max(shi - slo, 1e-9),
                                     "device_ops": sum(1 for a, _, _ in events if slo <= a < shi)}
        slo, shi = spans["solve"]
        per_op = {}
        for a, b, name in events:
            if slo <= a < shi:
                key = name if len(name) <= 60 else name[:57] + "..."
                n, t_us = per_op.get(key, (0, 0.0))
                per_op[key] = (n + 1, t_us + (b - a))
        trace["cg_top_ops"] = [
            {"op": k, "launches": n, "device_ms": t_us / 1e3}
            for k, (n, t_us) in sorted(per_op.items(), key=lambda kv: -kv[1][1])[:10]]
        cg = trace["stages"]["solve"]
        trace["frame_idle_share_unprofiled"] = 1.0 - busy / 1e3 / statistics.median(warm)
        trace["cg_idle_share_unprofiled"] = 1.0 - cg["device_ms"] / (stages["solve"] * 1e3)
        log("trace", f"frame {trace['frame_wall_ms']:.2f} ms wall under the profiler, device busy "
                     f"{trace['frame_device_ms']:.2f} ms, idle share {trace['frame_idle_share']:.3f} "
                     f"| CG stage {cg['wall_ms']:.2f} ms wall, {cg['device_ms']:.2f} ms device, "
                     f"idle share {cg['idle_share']:.3f}, {cg['device_ops'] / st.iterations:.1f} "
                     f"device ops per iteration | against the unprofiled walls: frame idle share "
                     f"{trace['frame_idle_share_unprofiled']:.3f}, CG "
                     f"{trace['cg_idle_share_unprofiled']:.3f} | {smi}")
        for name, v in trace["stages"].items():
            log("trace", f"stage {name}: wall {v['wall_ms']:.3f} ms, device {v['device_ms']:.3f} "
                         f"ms, idle share {v['idle_share']:.3f}, {v['device_ops']} device ops")
        for op in trace["cg_top_ops"]:
            log("trace", f"CG op {op['op']}: {op['launches']} launches, "
                         f"{op['device_ms']:.3f} ms device")
    print(json.dumps({"trace": trace}), flush=True)

    # small frame: the kernel path against the whole-array float64 solve
    small = scenes.buckling(n=32, device=dev)
    cfg_s = SolverConfig(octree_levels=4, tolerance=1e-5)
    got_s = solver.make_solver(cfg_s, device=dev)(small, dt)
    want_s = solver.solve_viscosity(small, dt, SolverConfig(octree_levels=4, tolerance=1e-5,
                                                            dtype=torch.float64), device=dev)
    scale = max(float(v.abs().max()) for v in want_s.velocity)
    diff = max(float((g.double() - w).abs().max()) for g, w in zip(got_s.velocity,
                                                                     want_s.velocity))
    log("solve", f"buckling-32: cuda {got_s.stats.iterations} it vs float64 v1 "
                 f"{want_s.stats.iterations} it, max velocity diff / scale {diff / scale:.2e}")
    assert got_s.stats.solve_path == "cuda" and want_s.stats.solve_path == "v1"
    assert abs(got_s.stats.iterations - want_s.stats.iterations) <= 2
    assert diff / scale < 5e-4

    # ---- 5 buckling-192: the large-grid path through make_solver
    n2 = 192
    st2 = scenes.buckling(n=n2, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    t = time.perf_counter()
    res2 = solve(st2, dt)
    for v in res2.velocity:
        v.sum().item()
    cold2_s = time.perf_counter() - t
    launches2 = dict(fa.launch_counts)
    peak2 = torch.cuda.max_memory_allocated()
    st_2 = res2.stats
    lv2, win2 = solver.probe_topology(st2, cfg, device=dev)
    sys2 = solver.build_system(st2, dt, SolverConfig(octree_levels=lv2, tolerance=1e-4),
                               device=dev, bboxes=win2, pad_levels=4)
    modes2 = sys2.modes
    budget = fa.route_budget(dev)
    log("192", f"cold frame {cold2_s:.3f} s (peak {peak2 / 2**30:.2f} GiB): {st_2} | launches "
               f"{launches2} | routes {modes2} "
               f"(budget {budget / 2**20:.1f} MiB of weighted stress = {fa.L2_SHARE} x L2 "
               f"{torch.cuda.get_device_properties(dev).L2_cache_size / 2**20:.1f} MiB), "
               f"windows {win2}, canonical boxes {[c.shape for c in sys2.canons]}, weighted "
               f"stress per level {[round(fa.tau_bytes(c) / 2**20, 1) for c in sys2.canons]} MiB")
    assert st_2.solve_path == "cuda", st_2.solve_path
    assert len(st_2.active_cells) == EXPECT_192["levels"], st_2.active_cells
    assert st_2.octree_dofs == EXPECT_192["octree_dofs"], st_2.octree_dofs
    assert st_2.regular_dofs == EXPECT_192["regular_dofs"], st_2.regular_dofs
    assert abs(st_2.iterations - EXPECT_192["iterations"]) <= 2, st_2.iterations
    assert st_2.residual <= 1e-4, st_2.residual
    assert launches2["tau_level"] > 0 and launches2["dt_level"] > 0, launches2
    check_launches(launches2, st_2.applies, sys2.canons, modes2, "192")
    for a, v in enumerate(res2.velocity):
        assert tuple(v.shape) == tuple(n2 + (1 if d == a else 0) for d in range(3)), v.shape
        assert bool(torch.isfinite(v).all()), f"192: velocity {a} not finite"
    warm2 = []
    for _ in range(2):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        r = solve(st2, dt)
        stop.record()
        torch.cuda.synchronize()
        warm2.append(start.elapsed_time(stop))
        assert r.stats.iterations == st_2.iterations
    stages2 = {}
    solve(st2, dt, stage_times=stages2)
    log("192", f"warm frames {['%.2f' % w for w in warm2]} ms | stages (synchronized) "
               + ", ".join(f"{k} {v * 1e3:.2f} ms" for k, v in stages2.items())
               + f" | CG {st_2.iterations} iterations, {st_2.applies} applies | {smi}")

    # every kernel against its plain version at the main path's shapes: the
    # routed levels' tau_level/dt_level, the fused group's fused_tau/fused_dt
    metas2 = sys2.apply_A.metas
    routed2 = [l for l, m in enumerate(modes2) if m != "fused"]
    gen = torch.Generator(device="cpu").manual_seed(2)
    u2_log = {k: torch.randn(m.shape, generator=gen).to(dev) * m for k, m in sys2.active.items()}
    u2 = sys2.embed_tree(u2_log)
    args2 = sys2.apply_A.level_args(u2)
    e2 = routed_errors(args2, metas2, sys2.canons, modes2, enh, "192")
    err = {k: worst(err[k], e2[k]) for k in err}
    lvl_ms = {"tau_level": 0.0, "dt_level": 0.0}
    lvl_plain_ms = {"tau_level": 0.0, "dt_level": 0.0}
    for l in routed2:
        t_ms, d_ms = time_level_pair(args2[l], metas2[l], sys2.canons[l], enh, 20)
        # the plain version once per apply: over the whole level (the split
        # route's one range), not once per brick
        tp_ms, dp_ms = time_level_pair(args2[l], metas2[l],
                                       dataclasses.replace(sys2.canons[l], brick=None), enh, 1,
                                       plain=True)
        lvl_ms["tau_level"] += t_ms
        lvl_ms["dt_level"] += d_ms
        lvl_plain_ms["tau_level"] += tp_ms
        lvl_plain_ms["dt_level"] += dp_ms
    # the library yardstick of the level pair: the system of the routed
    # levels' stress blocks (and their mass), one CSR product
    lib2_ms, _, export2_s, nnz2 = csr_yardstick(sys2, u2_log, routed2, 20)
    nb2 = fa.kernel_bytes([metas2[l] for l in routed2])
    nf2 = fa.kernel_flops([metas2[l] for l in routed2], enh)
    bounds["tau_level"] = bound(nb2["tau"], nf2["tau"])
    bounds["dt_level"] = bound(nb2["dt"], nf2["dt"])
    log("192", "kernels vs plain: "
               + ", ".join(f"{k} max abs {v[0]:.3e} (rel {v[1]:.2e})" for k, v in e2.items())
               + f"; per apply on levels {routed2}: "
               f"tau_level {lvl_ms['tau_level']:.4f} ms (plain {lvl_plain_ms['tau_level']:.2f} "
               f"ms, bound {bounds['tau_level'][0]:.4f} ms = {nb2['tau'] / 1e6:.1f} MB), "
               f"dt_level {lvl_ms['dt_level']:.4f} ms (plain {lvl_plain_ms['dt_level']:.2f} ms, "
               f"bound {bounds['dt_level'][0]:.4f} ms = {nb2['dt'] / 1e6:.1f} MB); library: CSR "
               f"A @ x of those levels' blocks {lib2_ms:.4f} ms ({nnz2} nonzeros, export "
               f"{export2_s:.2f} s on the host) | {smi}")

    # A/B on the same frame: the default routes against every level fused
    fused_modes = ["fused"] * lv2
    apply_f, _, _ = fa.make_fused_operator(sys2.frame, fa.route_canons(sys2.canons, fused_modes),
                                           sys2.active, sys2.res_per_level, st2.dx, enh,
                                           modes=fused_modes)
    got_d, got_f = sys2.apply_A(u2), apply_f(u2)
    pads_zero(got_d, sys2.res_per_level, sys2.canons, "192 default routes")
    ab_abs, ab_rel = max_rel_err((f"192 routes vs fused {k}", got_d[k], got_f[k]) for k in got_f)
    del got_d, got_f
    ab = {"default": [], "fused": []}
    for name in ("default", "fused", "fused", "default"):
        fn = sys2.apply_A if name == "default" else apply_f
        ab[name].append(cuda_ms(lambda: fn(u2), 10))
    # level 0 alone on three routes: its weighted stresses through device
    # memory in the all-level kernels (fused) and in the level kernels
    # (split), and through the L2-sized scratch (the default bricks)
    l0_fused = time_fused_levels(args2[:1], metas2[:1], enh, 20)
    l0_split = time_level_pair(args2[0], metas2[0],
                               dataclasses.replace(sys2.canons[0], brick=None), enh, 20)
    l0_routed = time_level_pair(args2[0], metas2[0], sys2.canons[0], enh, 20)
    log("192", f"A/B, routes {modes2} vs every level fused: applies agree to {ab_abs:.3e} "
               f"(rel {ab_rel:.2e}); whole apply default {ab['default']} ms, fused "
               f"{ab['fused']} ms; level 0 alone, per apply: {modes2[0]} tau_level "
               f"{l0_routed[0]:.4f} + dt_level {l0_routed[1]:.4f} ms, split tau_level "
               f"{l0_split[0]:.4f} + dt_level {l0_split[1]:.4f} ms, fused_tau {l0_fused[0]:.4f} "
               f"+ fused_dt {l0_fused[1]:.4f} ms | {smi}")
    del sys2, apply_f, args2, u2, u2_log, res2, r

    # ---- 6 buckling-256: default routes against every level fused
    n3 = 256
    st3 = scenes.buckling(n=n3, device=dev)
    frames3 = {}
    route_budget = fa.route_budget
    for name in ("default", "fused"):
        if name == "fused":
            fa.route_budget = lambda device: math.inf
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            fa.reset_launch_counts()
            stages3 = {}
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            r3 = solve(st3, dt, stage_times=stages3)
            stop.record()
            torch.cuda.synchronize()
            frames3[name] = (r3, start.elapsed_time(stop), dict(fa.launch_counts),
                             torch.cuda.max_memory_allocated())
            log("256", f"{name} routes, stages (synchronized) "
                       + ", ".join(f"{k} {v * 1e3:.2f} ms" for k, v in stages3.items()))
        finally:
            fa.route_budget = route_budget
    (rd, msd, lcd, memd), (rf, msf, lcf, memf) = frames3["default"], frames3["fused"]
    # the default frame's system, as make_solver builds it
    lv3, win3 = solver.probe_topology(st3, cfg, device=dev)
    sys3 = solver.build_system(st3, dt, SolverConfig(octree_levels=lv3, tolerance=1e-4),
                               device=dev, bboxes=win3, pad_levels=4)
    modes3 = sys3.modes
    log("256", f"routes {modes3}, windows {win3}, weighted stress per level "
               f"{[round(fa.tau_bytes(c) / 2**20, 1) for c in sys3.canons]} MiB | "
               f"default: {msd:.1f} ms frame, {rd.stats}, launches {lcd}, peak "
               f"{memd / 2**30:.2f} GiB | every level fused: {msf:.1f} ms, {rf.stats}, launches "
               f"{lcf}, peak {memf / 2**30:.2f} GiB | {smi}")
    assert "split" in modes3 and any(isinstance(m, tuple) for m in modes3), modes3
    assert lcd["tau_level"] > 0 and lcd["dt_level"] > 0, lcd
    check_launches(lcd, rd.stats.applies, sys3.canons, modes3, "256 default")
    check_launches(lcf, rf.stats.applies, sys3.canons, ["fused"] * lv3, "256 fused")
    assert rd.stats.solve_path == rf.stats.solve_path == "cuda"
    assert (rd.stats.octree_dofs, rd.stats.regular_dofs) == (rf.stats.octree_dofs,
                                                             rf.stats.regular_dofs)
    assert abs(rd.stats.iterations - rf.stats.iterations) <= 2
    assert rd.stats.residual <= 1e-4 and rf.stats.residual <= 1e-4
    scale3 = max(float(v.abs().max()) for v in rf.velocity)
    diff3 = max(float((a - b).abs().max()) for a, b in zip(rd.velocity, rf.velocity))
    assert bool(all(torch.isfinite(v).all() for v in rd.velocity))
    assert diff3 / scale3 < 5e-4, diff3 / scale3
    sd, sf = rd.stats, rf.stats
    del rd, rf, frames3, r3
    # every kernel of the default routes against its plain version here
    gen = torch.Generator(device="cpu").manual_seed(3)
    u3 = sys3.embed_tree({k: torch.randn(m.shape, generator=gen).to(dev) * m
                          for k, m in sys3.active.items()})
    e3 = routed_errors(sys3.apply_A.level_args(u3), sys3.apply_A.metas, sys3.canons, modes3,
                       enh, "256")
    err = {k: worst(err[k], e3[k]) for k in err}
    log("256", f"default routes vs every level fused: velocity max diff / scale "
               f"{diff3 / scale3:.2e}, iterations {sd.iterations} vs {sf.iterations} | kernels vs plain: "
               + ", ".join(f"{k} max abs {v[0]:.3e} (rel {v[1]:.2e})" for k, v in e3.items()))
    del sys3, u3

    measured = {
        "fused_tau": (launches["fused_tau"], err["fused_tau"][0], tau_ms, tau_plain_ms, lib_ms),
        "fused_dt": (launches["fused_dt"], err["fused_dt"][0], dt_ms, dt_plain_ms, lib_ms),
        "tau_level": (launches2["tau_level"], err["tau_level"][0], lvl_ms["tau_level"],
                      lvl_plain_ms["tau_level"], lib2_ms),
        "dt_level": (launches2["dt_level"], err["dt_level"][0], lvl_ms["dt_level"],
                     lvl_plain_ms["dt_level"], lib2_ms),
    }
    kernels = []
    for name, (n_launch, err, ms, plain_ms, library_ms) in measured.items():
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"adaptiveviscositysolver_tpu_torch/csrc/{SOURCE[name]}",
            "replaces": REPLACES[name], "launches": n_launch, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bounds[name][0],
            "bound_by": bounds[name][1], "library_ms": library_ms,
        })
    print(json.dumps({"result": {
        "warm_frame_ms_median": statistics.median(warm), "cold_frame_s": cold_s,
        "build_s": build_s, "cg_iterations": st.iterations, "octree_dofs": st.octree_dofs,
        "regular_dofs": st.regular_dofs, "levels": len(st.active_cells),
        "apply_ms": apply_ms, "apply_plain_ms": apply_plain_ms, "library_apply_ms": lib_ms,
        "export_s": export_s,
        "b192": {"routes": [str(m) for m in modes2], "cold_frame_s": cold2_s,
                 "warm_frame_ms": warm2, "cg_iterations": st_2.iterations,
                 "peak_gib": peak2 / 2**30,
                 "octree_dofs": st_2.octree_dofs, "regular_dofs": st_2.regular_dofs,
                 "apply_ms_default": ab["default"], "apply_ms_fused": ab["fused"],
                 "library_level_ms": lib2_ms, "export_s": export2_s,
                 "level0_ms": {"routed": l0_routed, "split": l0_split, "fused": l0_fused}},
        "b256": {"routes": [str(m) for m in modes3], "frame_ms": {"default": msd, "fused": msf},
                 "cg_iterations": [sd.iterations, sf.iterations],
                 "peak_gib": {"default": memd / 2**30, "fused": memf / 2**30}},
        "wall_s": time.perf_counter() - T0}}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    signal.alarm(0)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
