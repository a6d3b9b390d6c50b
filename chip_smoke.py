#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (adaptiveviscositysolver_tpu_torch) on
one NVIDIA GPU: the quickest proof that the port builds, that its
hand-written kernels agree with their plain PyTorch versions, and that the
main path solves a real frame through them.

    python3 chip_smoke.py

Phases (one line each, elapsed seconds first):
  0 device   -- card name and power limit (nvidia-smi), torch version; no
                CUDA device is a failure, never a CPU run
  1 build    -- nvcc builds csrc/ into build/torch_kernels/ (budget 60 s)
  2 kernels  -- on buckling-96's real frame data, every kernel against its
                plain version on the card (3e-5 * max per level and output),
                and the whole fused apply against its plain version and the
                whole-array operator; kernel / plain times with CUDA events
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

The last lines are a ``{"kernels": [...]}`` JSON line, the nvidia-smi line,
and ``{"ok": true, "device": {...}}``.  Every failed check raises; the whole
run is bounded by an in-process deadline.  It imports nothing of JAX.
"""

import json
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
REPLACES = ("adaptiveviscositysolver_tpu/ops/pallas_apply.py:1359 (_make_fused_kernel, "
            "level 0) + :1447 (_make_merged_kernel, levels >= 1)")

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
    builds = {stem: _build.build(stem) for stem in _build.SOURCES}
    build_s = time.perf_counter() - t
    for stem, info in builds.items():
        regs = [ln.strip() for ln in info["log"].splitlines() if "registers" in ln or "spill" in ln]
        log("build", f"{stem}: nvcc {info['seconds']:.2f} s (cached={info['cached']}); "
                     + " | ".join(regs))
    log("build", f"total {build_s:.2f} s into {_build.BUILD_DIR}")
    assert build_s <= BUILD_BUDGET_S, f"build took {build_s:.1f} s > {BUILD_BUDGET_S} s"
    _build.load()

    # ---- 2 kernels against their plain versions, on buckling-96's frame
    cfg = SolverConfig(octree_levels=4, tolerance=1e-4)
    state = scenes.buckling(n=N, device=dev)
    lv, windows = solver.probe_topology(state, cfg, device=dev)
    cfg_lv = SolverConfig(octree_levels=lv, tolerance=1e-4)
    sys_ = solver.build_system(state, dt, cfg_lv, device=dev, bboxes=windows, pad_levels=4)
    assert sys_.impl == "cuda", sys_.impl
    enh = cfg.use_enhanced_gradients
    apply_k = sys_.apply_A
    apply_p, _, _ = fa.make_fused_operator(sys_.frame, sys_.canons, sys_.active,
                                           sys_.res_per_level, state.dx, enh, plain=True)
    metas = apply_k.metas
    log("kernels", f"{lv} levels, windows {windows}, canonical boxes "
                   f"{[m.shape for m in metas]}")
    gen = torch.Generator(device="cpu").manual_seed(0)
    u_log = {k: torch.randn(m.shape, generator=gen).to(dev) * m for k, m in sys_.active.items()}
    u = sys_.embed_tree(u_log)
    args = apply_k.level_args(u)
    taus_k = fa.fused_tau(args, metas, enh)
    taus_p = fa._plain_tau(args, metas, enh)
    outs_k = fa.fused_dt(args, taus_p, metas, enh)
    outs_p = fa._plain_dt(args, taus_p, metas, enh)
    torch.cuda.synchronize()
    tau_abs, tau_rel = max_rel_err(
        (f"level {l} {n}", taus_k[l][n], taus_p[l][n]) for l in range(lv) for n in taus_p[l])
    dt_abs, dt_rel = max_rel_err(
        (f"level {l} {n}", outs_k[l][n], outs_p[l][n]) for l in range(lv) for n in outs_p[l])
    got = apply_k(u)
    want = apply_p(u)
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
    bounds = {}
    for name in ("fused_tau", "fused_dt"):
        b_ms = nbytes[name] / HBM_BYTES_PER_S * 1e3
        f_ms = flops[name] / FP32_FLOPS_PER_S * 1e3
        bounds[name] = (max(b_ms, f_ms), "bytes" if b_ms >= f_ms else "operations")
    log("kernels", f"per apply: fused_tau {tau_ms:.4f} ms (plain {tau_plain_ms:.3f} ms, bound "
                   f"{bounds['fused_tau'][0]:.4f} ms = {nbytes['fused_tau'] / 1e6:.1f} MB), "
                   f"fused_dt {dt_ms:.4f} ms (plain {dt_plain_ms:.3f} ms, bound "
                   f"{bounds['fused_dt'][0]:.4f} ms = {nbytes['fused_dt'] / 1e6:.1f} MB); whole "
                   f"apply with glue {apply_ms:.4f} ms (plain {apply_plain_ms:.3f} ms) | {smi}")
    del taus_k, taus_p, outs_k, outs_p, got, want, v1, cropped, args, u, sys_, apply_k, apply_p

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
    for name, n in launches.items():
        assert n >= st.applies >= st.iterations + 1, (name, n, st.applies)
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

    kernels = []
    for name, src_err, ms, plain_ms in (("fused_tau", tau_abs, tau_ms, tau_plain_ms),
                                        ("fused_dt", dt_abs, dt_ms, dt_plain_ms)):
        kernels.append({
            "name": name, "route": "cuda",
            "source": "adaptiveviscositysolver_tpu_torch/csrc/fused_apply.cu",
            "replaces": REPLACES, "launches": launches[name], "max_abs_err": src_err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bounds[name][0],
            "bound_by": bounds[name][1], "library_ms": None,
        })
    print(json.dumps({"result": {
        "warm_frame_ms_median": statistics.median(warm), "cold_frame_s": cold_s,
        "build_s": build_s, "cg_iterations": st.iterations, "octree_dofs": st.octree_dofs,
        "regular_dofs": st.regular_dofs, "levels": len(st.active_cells),
        "apply_ms": apply_ms, "apply_plain_ms": apply_plain_ms,
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
