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
                source, all started together (budget 60 s); the four matvec
                kernels' registers, spills and shared memory (ptxas) and
                resident blocks per SM
  2 kernels  -- on buckling-96's real frame data, every kernel against its
                plain version on the card (3e-5 * max per level and output),
                and the whole fused apply against its plain version and the
                whole-array operator; kernel / plain times with CUDA events;
                the library yardsticks: the assembled CSR system (export.py)
                times A @ x on the card, checked against the apply, and its
                stacked weighted gradient rows W D times the tau function
                alone, (W D) @ x; each kernel's share of its bound and its
                time over its CSR call's (tau kernels: W D, D^T kernels: A)
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
                group) against its plain version at these shapes, with its
                share of its bound and its time over its CSR call's (the
                routed levels' A and W D); A/B of the default routes against
                every level fused
  5b cg      -- the Jacobi CG's vector-update kernels (cg_update, cg_jacobi,
                cg_direction) once each on card vectors of buckling-192's
                CG length (its canonical grids, flat) against their plain
                versions on the same inputs: vectors within 2 ulp, rr and
                rz' within 1e-6 relative of a float64 sum of the kernels' r
                and z; each kernel's and its plain version's time per
                iteration with CUDA events, and its bound (its passes over
                the vector at the memory rate; with the dot of p and Ap, 14
                passes an iteration); the loop of PyTorch ops they replaced
  6 256      -- scenes.buckling(256): one frame on the default routes (brick
                and split) against one with every level fused (an unbounded
                budget), each through a make_solver of its own: launch counts
                against each frame's routes, same
                DOFs, iterations +- 2, velocity within rel 5e-4; every kernel
                of the default routes (level 0's bricks, level 1 split, the
                fused group) against its plain version, and its time per
                apply; peak device memory
  7 beam     -- scenes.beam(64) through make_solver, the scene that fills ~7 %
                of its domain: the JAX package's counts (BENCH_r04.json: 262
                +- 2 iterations, 22064 / 32336 DOFs, 3 levels), residual <=
                1e-4, the kernels' path; its routes and windows; three
                cached frames (a host-bound frame: one reading is noise)
  8 policy   -- make_solver's host policy on test_recompile's ball at 96^3 (5
                iterations a frame): 7 translated frames through an async and
                a sync solver (at most 3 cached topologies each, the same
                iterations, velocity within 1e-6 of max), then a drain from r
                0.30 to 0.15 (the window re-tightens within SHRINK_AFTER + 2
                frames to under 0.7 of its peak volume)
  9 probes   -- the probe tools' path (tools.calibrate_bandwidth and
                tools.profile_levels at buckling-96, launch counts read around
                it); banded_apply (T1) on the 104 x 112 x 128 box with 15
                planes and stream_floor (T2) on buckling-96's level-0 box
                against their plain versions (3e-5 * max; the floor also with
                its int8 bytes counted); each kernel's time with the L2 flushed,
                bytes, bound, share of bound, and copy_ of the same bytes
  10 cheb    -- SolverConfig(octree_levels=4, tolerance=1e-4, cheb_degree=3)
                through make_solver and the kernels on buckling-96 (cold + 3
                warm frames) and buckling-192 (cold + 2): exact levels and
                DOFs, residual <= 1e-4, applies = 13 + 1 + 2 + 3 per
                iteration, launch counts around the cold frame against them,
                the 96^3 iterations within +-2 of the JAX package's count
                (EXPECT_CHEB) and its velocity within rel 5e-4 of phase 3's
                float64 v1 solve, the 192^3 velocity within rel 5e-4 of
                phase 5's Jacobi frame; warm median and spread, solve stage
                ms, iterations and applies beside the Jacobi frames
  11 refined -- scenes.buckling(N_REFINED) in float64 with
                use_iterative_refinement (tolerance 1e-9): the "refined"
                path, every inner apply float32 and through the kernels
                (launch counts against the inner applies; the float64
                residuals run v1), residual <= 1e-9, velocity within rel
                1e-5 of the float64 v1 solve; a v1-fused float32 frame of
                buckling-32 against the v1 frame (same iterations, velocity
                within 1e-6 * max); the whole phase's seconds
  12 tail    -- models.flip.simulate on buckling-64 (float32, 3 frames, the
                kernels' route, launch counts against the frames' applies);
                a buckling-96 frame with cancel_poll_iters=16 and the flag
                set stops at 16 iterations, then converges; a checkpoint of
                the FLIP state saved and loaded on the card; the native
                octree checks on the 96^3 octree and its PLY; interp_at at
                the 96^3 solution's UNASSIGNED level-0 faces against the
                writeback interpolation (1e-6 * max)
  13 shard   -- the sharded CG (B6: the kernels on each rank's halo-filled
                local boxes) on 2 gloo ranks sharing the card:
                buckling-96 through parallel.mesh.make_sharded_solver, a
                cold and a warm frame on the default routes and on a budget
                that puts level 0 of a local box in bricks, each against
                the single-device solve_viscosity of the same config
                (186836 / 284564 DOFs, iterations +- 2, residual <= 1e-4,
                velocity rel 5e-4, "cuda-sharded" on each rank, each rank's
                launches = applies x its x-row ranges, its exchanges,
                all-reduces and gathers as designed); on rank 0's local
                boxes every kernel of both routes against its plain version,
                its time and bound, the CSR A @ x of rank 0's owned rows
                (held to the gathered sharded apply); the dry-run analog
                (parallel.mesh.dryrun_multichip) on 8 ranks; each frame's
                seconds and each rank's share of it in collectives (2 ranks
                on one card measure no scale-out)
  14 example -- the buckling example's command line at its defaults (5
                FLIP frames at 64^3), in a subprocess with its own timeout,
                in a temporary directory: the module run as ``python -m``
                runs it (runpy), its solves stamped and frame 0's state
                and velocity kept, followed by its launch counts; exit
                code 0, 5 stats lines with residual <= 1e-4, 5 PLY files
                whose header vertex counts equal the lines' and are > 0,
                launches against the frames' applies; in-process, on
                frame 0's state: fused_tau and fused_dt against their
                plain versions at the example's boxes (3e-5 * max), the
                example's velocity against the float64 v1 solve of the same
                state (rel 5e-4, iterations +- 2), and the scene's first
                state solved at dt 1/24 and 1/48 against the JAX package's
                counts (EXPECT_FIRST_64, +- 2); native.available() and the
                package's top-level make_solver / solve_viscosity

Phases 3, 5, 7, 11 and 12 also read the CG kernels' launch counts around
their first frame: each kernel once per iteration of a float32 Jacobi CG
(phase 11: of its inner CGs); phase 10's Chebyshev frames launch none.

Phase 3 also runs the make_solver cache: a fresh solver's 3 frames of
buckling-96 (only the first probes; one cached topology; the cold and cached
build_system times) and the cuda frame against the float64 whole-array
solve of the same frame (velocity within rel 5e-4, iterations +- 2).

The last lines are a ``{"kernels": [...]}`` JSON line (the four matvec
kernels also carry their registers, spill bytes, shared memory per block
and resident blocks per SM, and their phase-13 numbers on a rank's local
boxes under "sharded"; the CG kernels' rows are phase 5b's; "paths"
names the paths each runs on), the
nvidia-smi line, and ``{"ok": true,
"device": {...}}``.  Every failed check raises; the whole
run is bounded by an in-process deadline.  It imports nothing of JAX.
"""

import dataclasses
import json
import math
import os
import re
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
# the JAX package's record of beam-64 (BENCH_r04.json)
EXPECT_BEAM = dict(levels=3, octree_dofs=22064, regular_dofs=32336, iterations=262)
# the JAX package's outer CG iterations of the buckling-96 frame under the
# degree-3 Chebyshev preconditioner (its v1-fused operator on a CPU, float32,
# SolverConfig(octree_levels=4, tolerance=1e-4, cheb_degree=3), dt =
# float32(1/24), make_solver), from
#     PYTHONPATH=. JAX_PLATFORMS=cpu python tools/jax_chebyshev_counts.py 96
# buckling-192 has no such count (the CPU run is too large); its Chebyshev
# frame is held to the DOFs, the residual and phase 5's Jacobi velocity
CHEB_DEGREE = 3
EXPECT_CHEB = {96: 87}
N_REFINED = 64
_PA = "adaptiveviscositysolver_tpu/ops/pallas_apply.py"
_FUSED = f"{_PA}:1359 (_make_fused_kernel, level 0) + :1447 (_make_merged_kernel, levels >= 1)"
REPLACES = {
    "fused_tau": _FUSED, "fused_dt": _FUSED,
    "tau_level": f"{_PA}:846 (_make_tau_kernel) + :751-843 (_level_kernel, bricked branch)",
    "dt_level": f"{_PA}:913 (_make_dt_kernel) + :751-843 (_level_kernel, bricked branch)",
    "banded_apply": "tools/calibrate_bandwidth.py:30 (banded_kernel; pallas_call at :63)",
    "stream_floor": "tools/profile_levels.py:128 (dma_kernel; pallas_call at :163)",
    # the JAX CG's vector ops, which XLA fuses: no Pallas kernel
    "cg_update": "adaptiveviscositysolver_tpu/operator.py:284-287 (_flat_pcg's loop body)",
    "cg_jacobi": "adaptiveviscositysolver_tpu/operator.py:288-289 (_flat_pcg's loop body)",
    "cg_direction": "adaptiveviscositysolver_tpu/operator.py:290 (_flat_pcg's loop body)",
}
# the paths each kernel runs on (phases 3-14); "sharded": B6, the kernels on
# a rank's halo-filled local boxes (phase 13); "example": the buckling
# example's command line (phase 14)
_FUSED_PATHS = ["single-device", "chebyshev", "refined", "flip", "sharded", "example"]
_LEVEL_PATHS = ["single-device", "chebyshev", "sharded"]
PATHS = {"fused_tau": _FUSED_PATHS, "fused_dt": _FUSED_PATHS, "tau_level": _LEVEL_PATHS,
         "dt_level": _LEVEL_PATHS, "banded_apply": ["probe tools"],
         "stream_floor": ["probe tools"],
         **dict.fromkeys(("cg_update", "cg_jacobi", "cg_direction"),
                         ["single-device", "refined", "flip"])}
SOURCE = {"fused_tau": "fused_apply.cu", "fused_dt": "fused_apply.cu",
          "tau_level": "level_apply.cu", "dt_level": "level_apply.cu",
          "banded_apply": "probe_kernels.cu", "stream_floor": "probe_kernels.cu",
          "cg_update": "cg_update.cu", "cg_jacobi": "cg_update.cu", "cg_direction": "cg_update.cu"}
# each CG kernel's passes over the flat vector (each vector read or written
# once) and float32 operations per sample; with the dot of p and Ap (2
# passes) an iteration makes 14
CG_PASSES = {"cg_update": (6, 6), "cg_jacobi": (3, 3), "cg_direction": (3, 2)}

EXAMPLE = "adaptiveviscositysolver_tpu_torch.examples.run_buckling"
EXAMPLE_FRAMES = 5          # the example's defaults: 5 frames at 64^3
EXAMPLE_TIMEOUT_S = 120
# runs the example as ``python -m`` does (runpy), stamping each frame's solve
# and keeping frame 0's state and solved velocity in the working directory;
# then prints the kernels' launch counts and the stamps
_EXAMPLE_RUNNER = f"""
import json, runpy, sys, time
import torch
from adaptiveviscositysolver_tpu_torch.models import flip
from adaptiveviscositysolver_tpu_torch.ops import fused_apply as fa
from adaptiveviscositysolver_tpu_torch.utils import checkpoint

solve, kept, stamps = flip.solve_viscosity, [], []
def solve_and_keep(state, dt, config, device):
    out = solve(state, dt, config, device=device)
    torch.cuda.synchronize()
    stamps.append(time.perf_counter())
    if not kept:
        kept.extend([state, out.velocity])
    return out
flip.solve_viscosity = solve_and_keep
fa.reset_launch_counts()
sys.argv = [{EXAMPLE!r}]
code = 0
try:
    runpy.run_module({EXAMPLE!r}, run_name="__main__", alter_sys=True)
except SystemExit as e:
    code = e.code or 0
launches = dict(fa.launch_counts)
if kept:
    checkpoint.save("frame0_state", kept[0])
    torch.save([v.cpu() for v in kept[1]], "frame0_velocity.pt")
print("runner " + json.dumps({{"launches": launches, "solve_end_s": stamps}}), flush=True)
sys.exit(code)
"""
# the JAX package's CG iterations of scenes.buckling(64)'s own first state
# (SolverConfig(octree_levels=4, tolerance=1e-4), float32, make_solver) at
# the FLIP-64 step and the example's, from
#     PYTHONPATH=. JAX_PLATFORMS=cpu python tools/jax_flip_counts.py 64 5
EXPECT_FIRST_64 = {"1/24": 136, "1/48": 129}
_FRAME_LINE = re.compile(r"frame +(\d+): iters= *(\d+) residual=(\S+) octree_dofs=(\d+) "
                         r"active_cells=\[([\d, ]*)\] ply=(\d+)pts -> (\S+)$")

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


def trace_summary(spans, events, stages, warm_ms):
    """A traced frame's device busy time and idle share, per stage too, and
    the CG stage's ten costliest device ops; the *_unprofiled shares divide
    the traced device time by the unprofiled walls (the warm-frame median
    ``warm_ms``, the synchronized ``stages``).  None where the trace holds
    no device events."""
    trace = {"frame_wall_ms": None, "frame_device_ms": None, "frame_idle_share": None,
             "frame_idle_share_unprofiled": None, "cg_idle_share_unprofiled": None,
             "stages": {}, "cg_top_ops": []}
    if not events:
        return trace
    intervals = [(a, b) for a, b, _ in events]
    lo, hi = spans["frame"]
    busy = busy_us(intervals, lo, hi)
    trace.update(frame_wall_ms=(hi - lo) / 1e3, frame_device_ms=busy / 1e3,
                 frame_idle_share=1.0 - busy / (hi - lo))
    for name in stages:
        slo, shi = spans[name]
        sb = busy_us(intervals, slo, shi)
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
    trace["frame_idle_share_unprofiled"] = 1.0 - busy / 1e3 / warm_ms
    trace["cg_idle_share_unprofiled"] = (1.0 - trace["stages"]["solve"]["device_ms"]
                                         / (stages["solve"] * 1e3))
    return trace


def ptxas_info(log, kernel):
    """Registers, spill bytes (stores + loads) and static shared memory of
    one kernel from nvcc's ``-Xptxas -v`` log; None where the library came
    from the cache (no log)."""
    # a kernel template's enhanced build (ILb1E) stands for it
    m = re.search(rf"Compiling entry function '[^']*{kernel}(?:ILb1E)?E[^']*'"
                  r"(.*?Used \d+ registers[^\n]*)", log, re.S)
    if not m:
        return None
    body = m.group(1)
    smem = re.search(r"(\d+) bytes smem", body)
    return {"registers": int(re.search(r"Used (\d+) registers", body).group(1)),
            "spill_bytes": sum(int(x) for x in re.findall(r"(\d+) bytes spill", body)),
            "static_smem_bytes": int(smem.group(1)) if smem else 0}


def vs_bound_and_library(name, ms, bound_ms, library_ms):
    """Log text: a kernel's share of its bound and its time over the
    library call's."""
    return (f"{name} share of bound {bound_ms / ms:.4f}, {ms / library_ms:.1f}x the CSR call "
            f"({ms:.4f} / {library_ms:.4f} ms)")


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


def ulps(got, want):
    """The largest |got - want| in units in the last place of float32
    ``want``."""
    import torch

    a = want.abs()
    spacing = torch.nextafter(a, torch.full_like(a, math.inf)) - a
    return float(((got - want).abs() / spacing.clamp_min(torch.finfo(torch.float32).tiny)).max())


def cg_kernel_errors(n, dev, seed):
    """Each CG kernel once on card vectors of ``n`` samples against its
    plain version on the same inputs, in the CG's order: per kernel the
    largest absolute and ulp difference of the vectors it writes (at most
    2 ulp); then rr and rz' against a float64 sum of the kernels' r and z
    (within 1e-6 relative)."""
    import torch
    from adaptiveviscositysolver_tpu_torch.ops import cg_update as cgk

    gen = torch.Generator(device="cpu").manual_seed(seed)
    x, r, p, ap = (torch.randn(n, generator=gen).to(dev) for _ in range(4))
    invd = (torch.rand(n, generator=gen) + 0.5).to(dev)
    rz, pap, rr, rz_new, rr_p, rz_p = torch.tensor([0.75, 1.5, 0, 0, 0, 0], device=dev).unbind()
    part = cgk.partials(n, dev)
    part_z = torch.empty_like(part)
    one, one_z = torch.zeros(2, 1, dtype=torch.float64, device=dev).unbind()
    z, zp, xp, rp = torch.empty_like(r), torch.empty_like(r), x.clone(), r.clone()
    cgk.plain_cg_update(xp, rp, p, ap, rz, pap, one)
    cgk.cg_update(x, r, p, ap, rz, pap, part)
    cgk.plain_cg_jacobi(r, invd, zp, one_z)
    cgk.cg_jacobi(r, invd, z, part_z)
    pp = p.clone()
    cgk.plain_cg_direction(z, pp, part, part_z, rz, rr_p, rz_p)
    cgk.cg_direction(z, p, part, part_z, rz, rr, rz_new)
    errs = {}
    for name, pairs in (("cg_update", ((x, xp), (r, rp))), ("cg_jacobi", ((z, zp),)),
                        ("cg_direction", ((p, pp),))):
        worst_ulp = max(ulps(g, w) for g, w in pairs)
        assert worst_ulp <= 2.0, f"{name}: {worst_ulp} ulp from its plain version"
        errs[name] = (max(float((g - w).abs().max()) for g, w in pairs), worst_ulp)
    r64, z64 = r.double(), z.double()
    sums = {}
    for name, got, want in (("rr", rr, r64 @ r64), ("rz", rz_new, r64 @ z64)):
        sums[name] = abs(float(got) - float(want)) / abs(float(want))
        assert sums[name] <= 1e-6, f"{name}: {float(got)} vs float64 {float(want)}"
    return errs, sums


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


def worst_by_kernel(*errs):
    """The worst (abs, rel) of each kernel over several routed_errors."""
    return {k: worst(*(e[k] for e in errs)) for k in errs[0]}


def worst(*errs):
    """The worst (abs, rel) of several."""
    return (max(e[0] for e in errs), max(e[1] for e in errs))


def _csr_on(M, dev):
    """A scipy CSR matrix as a float32 CSR tensor on ``dev``."""
    import numpy as np
    import torch

    return torch.sparse_csr_tensor(torch.from_numpy(M.indptr.astype(np.int32)),
                                   torch.from_numpy(M.indices.astype(np.int32)),
                                   torch.from_numpy(M.data.astype(np.float32)),
                                   M.shape).to(dev)


def csr_yardstick(sys_, u_log, levels, reps):
    """The library calls: the assembled system of the stress blocks of
    ``levels`` (mass of those levels only), exported on the host
    (export.py, float64) and put on the card as float32 CSR tensors, timed
    on the DOF vector x of ``u_log`` (cuSPARSE): ``A @ x``, the whole apply,
    and ``(W D) @ x`` over the stacked weighted gradient rows the export
    forms A from, the tau function alone (tests/test_torch_level_apply.py
    holds those rows to the plain tau).  Returns (A @ x ms, (W D) @ x ms,
    A @ x as per-(level, axis) grids, export seconds, nonzeros of A and of
    W D)."""
    import numpy as np
    import scipy.sparse as sp
    import torch
    from adaptiveviscositysolver_tpu_torch import export

    t = time.perf_counter()
    blocks = [b for b in sys_.blocks if b.level in levels]
    mass = {k: v if k[0] in levels else torch.zeros_like(v) for k, v in sys_.mass.items()}
    A, _, vel_idx, n, D, w = export._assemble(blocks, mass, sys_.vel_kinds, sys_.guess,
                                              sys_.res_per_level)
    WD = (sp.diags(w) @ D).tocsr()
    export_s = time.perf_counter() - t
    dev = u_log[(0, 0)].device
    A_t, WD_t = _csr_on(A, dev), _csr_on(WD, dev)
    x = np.zeros(n, np.float32)
    for (l, a), idx in ((k, vel_idx[k[0]][k[1]]) for k in u_log):
        sel = idx >= 0
        x[idx[sel]] = u_log[(l, a)].cpu().numpy()[sel]
    x = torch.from_numpy(x).to(dev)
    ms = cuda_ms(lambda: A_t @ x, reps)
    tau_ms = cuda_ms(lambda: WD_t @ x, reps)
    y = (A_t @ x).cpu().numpy()
    grids = {}
    for (l, a) in u_log:
        idx = vel_idx[l][a]
        grids[(l, a)] = torch.from_numpy(np.where(idx >= 0, y[np.clip(idx, 0, None)], 0.0)
                                         .astype(np.float32)).to(dev)
    return ms, tau_ms, grids, export_s, (int(A.nnz), int(WD.nnz))


def run_example(workdir):
    """The example's command line in ``workdir`` (a subprocess, killed at its
    timeout): (exit code, its output lines, the runner's record)."""
    env = dict(os.environ)
    root = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = os.pathsep.join(p for p in (root, env.get("PYTHONPATH")) if p)
    proc = subprocess.run([sys.executable, "-c", _EXAMPLE_RUNNER], cwd=workdir, env=env,
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                          timeout=EXAMPLE_TIMEOUT_S)
    lines = proc.stdout.splitlines()
    record = next((json.loads(ln[len("runner "):]) for ln in lines if ln.startswith("runner ")),
                  None)
    return proc.returncode, [ln for ln in lines if not ln.startswith("runner ")], record


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
    from adaptiveviscositysolver_tpu_torch.ops import _build, probes
    from adaptiveviscositysolver_tpu_torch.ops import cg_update as cgk
    from adaptiveviscositysolver_tpu_torch.ops import fused_apply as fa
    from adaptiveviscositysolver_tpu_torch.tools import calibrate_bandwidth, call_ms, profile_levels
    from adaptiveviscositysolver_tpu_torch.tools.time_kernels import (time_cg,
                                                                      time_fused_levels,
                                                                      time_level_pair)

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
    design = {}
    for stem, name, kernel, k in (("fused_apply", "fused_tau", "avs_tau_kernel", "tau"),
                                  ("fused_apply", "fused_dt", "avs_dt_kernel", "dt"),
                                  ("level_apply", "tau_level", "avs_tau_level_kernel", "tau"),
                                  ("level_apply", "dt_level", "avs_dt_level_kernel", "dt")):
        lib = fa._library(stem)     # load, bind, check the descriptor layout
        info = ptxas_info(builds[stem]["log"], kernel) or {}
        info.update(smem_bytes=getattr(lib, f"avs_{k}_smem_bytes")()
                    + info.pop("static_smem_bytes", 0),
                    blocks_per_sm=getattr(lib, f"avs_{k}_blocks_per_sm")())
        design[name] = info
        log("build", f"{name} ({kernel}): {info}")
    probes._library()
    cgk._library()

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
    # each launch timed on the device (queued behind a spin): the D^T
    # kernel takes less time on the card than its wrapper on the host
    tau_ms, dt_ms = time_fused_levels(args, metas, enh, reps)
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

    # the library yardsticks: one cuSPARSE CSR product computes the apply,
    # another the weighted stresses alone
    lib_ms, lib_tau_ms, lib_y, export_s, nnz = csr_yardstick(sys_, u_log, range(lv), reps)
    lib_abs, lib_rel = max_rel_err((f"CSR A @ x vs apply {k}", cropped[k], lib_y[k])
                                   for k in lib_y)
    log("kernels", f"library: CSR A @ x {lib_ms:.4f} ms per apply ({nnz[0]} nonzeros), "
                   f"(W D) @ x {lib_tau_ms:.4f} ms ({nnz[1]} nonzeros), export {export_s:.2f} s "
                   f"on the host; A @ x vs the kernels' apply max abs {lib_abs:.3e} "
                   f"(rel {lib_rel:.2e}) | {smi}")
    log("kernels", "; ".join(vs_bound_and_library(k, m, bounds[k][0], lm) for k, m, lm in
                             (("fused_tau", tau_ms, lib_tau_ms), ("fused_dt", dt_ms, lib_ms))))
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
    cgk.reset_launch_counts()
    t = time.perf_counter()
    res = solve(state, dt)
    for v in res.velocity:
        v.sum().item()
    cold_s = time.perf_counter() - t
    launches = dict(fa.launch_counts)
    cg_launches = dict(cgk.launch_counts)
    st = res.stats
    log("solve", f"cold frame {cold_s:.3f} s: {st} | launches {launches} {cg_launches}")
    assert cg_launches == dict.fromkeys(cg_launches, st.iterations), (cg_launches, st.iterations)
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
    # warm frames take the cached topology and the last frame's probe
    assert "probe" not in stages and solve.cache_info()["programs"] == 1, (
        sorted(stages), solve.cache_info())
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
    trace = trace_summary(spans, events, stages, statistics.median(warm))
    if not events:
        log("trace", "the trace holds no device events: device idle share not measured")
    else:
        cg = trace["stages"]["solve"]
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

    # the make_solver cache: a fresh solver's 3 frames of buckling-96
    solve_c = solver.make_solver(cfg, device=dev)
    cache_stages = []
    for i in range(3):
        stc = {}
        rc = solve_c(state, dt, stage_times=stc)
        cache_stages.append(stc)
        assert ("probe" in stc) == (i == 0), (i, sorted(stc))
        assert solve_c.cache_info()["programs"] == 1, solve_c.cache_info()
        assert rc.stats.solve_path == "cuda", rc.stats.solve_path
        assert (rc.stats.octree_dofs, rc.stats.regular_dofs) == (EXPECT["octree_dofs"],
                                                                 EXPECT["regular_dofs"])
        assert abs(rc.stats.iterations - EXPECT["iterations"]) <= 2, rc.stats.iterations
    build_ms = [c["build_system"] * 1e3 for c in cache_stages]
    log("cache", f"3 frames through one make_solver: probe {cache_stages[0]['probe'] * 1e3:.2f} "
                 f"ms on the first only; {solve_c.cache_info()}; build_system "
                 f"{build_ms[0]:.2f} ms cold, {build_ms[1]:.2f} and {build_ms[2]:.2f} ms "
                 f"cached; topology_probe in the solve "
                 f"{[round(c['topology_probe'] * 1e3, 2) for c in cache_stages]} ms | {smi}")
    del solve_c, rc

    # the cuda frame of phase 3 against the float64 whole-array solve
    t = time.perf_counter()
    want96 = solver.solve_viscosity(state, dt, dataclasses.replace(cfg, dtype=torch.float64),
                                    device=dev)
    v1_96_s = time.perf_counter() - t
    scale96 = max(float(v.abs().max()) for v in want96.velocity)
    diff96 = max(float((g.double() - w).abs().max()) for g, w in zip(res.velocity,
                                                                     want96.velocity))
    log("solve", f"buckling-96: cuda {st.iterations} it vs float64 v1 {want96.stats.iterations} "
                 f"it ({v1_96_s:.2f} s), max velocity diff / scale {diff96 / scale96:.2e}")
    assert st.solve_path == "cuda" and want96.stats.solve_path == "v1"
    assert abs(st.iterations - want96.stats.iterations) <= 2
    assert diff96 / scale96 < 5e-4
    v96_f64 = want96.velocity
    del want96

    # ---- 5 buckling-192: the large-grid path through make_solver
    n2 = 192
    st2 = scenes.buckling(n=n2, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    cgk.reset_launch_counts()
    t = time.perf_counter()
    res2 = solve(st2, dt)
    for v in res2.velocity:
        v.sum().item()
    cold2_s = time.perf_counter() - t
    launches2 = dict(fa.launch_counts)
    cg_launches2 = dict(cgk.launch_counts)
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
    assert cg_launches2 == dict.fromkeys(cg_launches2, st_2.iterations), (cg_launches2,
                                                                          st_2.iterations)
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
    # a new grid starts its own window history: the cold frame probed, the
    # warm ones take its cached topology (the solver holds 96's and 192's)
    assert "probe" not in stages2 and solve.cache_info()["programs"] == 2, (
        sorted(stages2), solve.cache_info())
    log("192", f"warm frames {['%.2f' % w for w in warm2]} ms | stages (synchronized) "
               + ", ".join(f"{k} {v * 1e3:.2f} ms" for k, v in stages2.items())
               + f" | cached build_system {stages2['build_system'] * 1e3:.2f} ms"
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
    # the library yardsticks of the level pair: the system of the routed
    # levels' stress blocks (and their mass) and its W D, one CSR product each
    lib2_ms, lib2_tau_ms, _, export2_s, nnz2 = csr_yardstick(sys2, u2_log, routed2, 20)
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
               f"A @ x of those levels' blocks {lib2_ms:.4f} ms ({nnz2[0]} nonzeros), (W D) @ x "
               f"{lib2_tau_ms:.4f} ms ({nnz2[1]} nonzeros), export {export2_s:.2f} s on the "
               f"host | {smi}")
    log("192", "; ".join(vs_bound_and_library(k, lvl_ms[k], bounds[k][0], lm) for k, lm in
                         (("tau_level", lib2_tau_ms), ("dt_level", lib2_ms))))

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

    # ---- 5b the CG kernels at the main path's CG length: the canonical grids, flat
    n_cg = sum(v.numel() for v in u2.values())
    cg_err, cg_sums = cg_kernel_errors(n_cg, dev, 5)
    cg_t = time_cg(n_cg, 20)
    for name, (passes, ops) in CG_PASSES.items():
        bounds[name] = bound(passes * 4 * n_cg, ops * n_cg)
    log("cg", f"{n_cg} samples, {cgk.grid_blocks(n_cg, dev)} blocks; vs plain: "
              + ", ".join(f"{k} max abs {a:.3e} ({u:.1f} ulp)" for k, (a, u) in cg_err.items())
              + f"; rr rel {cg_sums['rr']:.2e}, rz rel {cg_sums['rz']:.2e} of a float64 sum; "
              + "per iteration: " + ", ".join(
                  f"{k} {cg_t[k]:.4f} ms (plain {cg_t['plain'][k]:.4f} ms, bound "
                  f"{bounds[k][0]:.4f} ms)" for k in CG_PASSES)
              + f", dot(p, Ap) {cg_t['dot']:.4f} ms; iteration {cg_t['iteration']:.4f} ms "
              f"against 14 passes {cg_t['bound_ms'][0]:.4f} ms; the loop of PyTorch ops "
              f"{cg_t['torch_loop']:.4f} ms | {smi}")
    v192_jacobi = res2.velocity
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
            # a solver of its own: the patched budget routes another topology
            # under the same key, which a shared cache would hand back
            r3 = solver.make_solver(cfg, device=dev)(st3, dt, stage_times=stages3)
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
    # each kernel of the default routes per apply (back to back, L2 warm)
    args3, metas3 = sys3.apply_A.level_args(u3), sys3.apply_A.metas
    fused3 = [l for l, m in enumerate(modes3) if m == "fused"]
    k3 = dict(zip(("fused_tau", "fused_dt"), time_fused_levels(
        [args3[l] for l in fused3], [metas3[l] for l in fused3], enh, 20)))
    for l, m in enumerate(modes3):
        if m != "fused":
            k3[f"level {l} {m}"] = time_level_pair(args3[l], metas3[l], sys3.canons[l], enh, 20)
    log("256", f"per apply: fused group {fused3}: fused_tau {k3['fused_tau']:.4f}, fused_dt "
               f"{k3['fused_dt']:.4f} ms; "
               + "; ".join(f"{k}: tau_level {v[0]:.4f}, dt_level {v[1]:.4f} ms"
                           for k, v in k3.items() if k.startswith("level")) + f" | {smi}")
    del sys3, u3, args3

    # ---- 7 beam-64 through make_solver: the crop windows' scene
    beam = scenes.beam(n=64, device=dev)
    solve_b = solver.make_solver(cfg, device=dev)
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    cgk.reset_launch_counts()
    t = time.perf_counter()
    rb = solve_b(beam, dt)
    for v in rb.velocity:
        v.sum().item()
    beam_cold_s = time.perf_counter() - t
    launches_b = dict(fa.launch_counts)
    cg_launches_b = dict(cgk.launch_counts)
    ((lv_b, win_b),) = solve_b.cache_info()["windows"].items()
    canons_b = fa.level_canons([tuple(64 >> l for _ in range(3)) for l in range(lv_b)], win_b)
    modes_b = fa.level_modes(canons_b, fa.route_budget(dev))
    sb = rb.stats
    assert cg_launches_b == dict.fromkeys(cg_launches_b, sb.iterations), (cg_launches_b, sb)
    beam_warm = []
    for _ in range(3):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        rb2 = solve_b(beam, dt)
        stop.record()
        torch.cuda.synchronize()
        beam_warm.append(start.elapsed_time(stop))
        assert rb2.stats.iterations == sb.iterations
    beam_warm_ms = statistics.median(beam_warm)
    log("beam", f"beam-64 cold frame {beam_cold_s:.3f} s, cached frames "
                f"{['%.2f' % w for w in beam_warm]} ms, median {beam_warm_ms:.2f} ms: "
                f"{sb} | launches {launches_b} | routes {modes_b}, windows {win_b}, canonical "
                f"boxes {[c.shape for c in canons_b]} | {smi}")
    assert sb.solve_path == "cuda", sb.solve_path
    assert len(sb.active_cells) == lv_b == EXPECT_BEAM["levels"], (sb.active_cells, lv_b)
    assert sb.octree_dofs == EXPECT_BEAM["octree_dofs"], sb.octree_dofs
    assert sb.regular_dofs == EXPECT_BEAM["regular_dofs"], sb.regular_dofs
    assert abs(sb.iterations - EXPECT_BEAM["iterations"]) <= 2, sb.iterations
    assert sb.residual <= 1e-4, sb.residual
    check_launches(launches_b, sb.applies, canons_b, modes_b, "beam")
    for a, v in enumerate(rb.velocity):
        assert tuple(v.shape) == tuple(64 + (1 if d == a else 0) for d in range(3)), v.shape
        assert bool(torch.isfinite(v).all()), f"beam: velocity {a} not finite"
    del beam, solve_b, rb, rb2

    # ---- 8 the host policy on test_recompile's ball at 96^3
    from adaptiveviscositysolver_tpu_torch import convert

    def ball(n, center_y, r=0.17):
        h = 1.0 / n
        x = (np.arange(n) + 0.5) * h
        X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
        liquid = np.sqrt((X - 0.5) ** 2 + (Y - center_y) ** 2 + (Z - 0.5) ** 2) - r
        fshapes = [tuple(n + (1 if d == a else 0) for d in range(3)) for a in range(3)]
        vel = [np.zeros(fs) for fs in fshapes]
        vel[1] = -0.5 * np.ones(fshapes[1])
        return convert.fluid_state_from_numpy(
            liquid, np.full_like(liquid, 1e3), vel, [np.zeros(fs) for fs in fshapes],
            np.full(liquid.shape, 2.0), np.ones(liquid.shape), h, device=dev,
            dtype=torch.float32)

    cfg_ball = SolverConfig(octree_levels=3, tolerance=1e-3, max_iterations=5)
    asyn = solver.make_solver(cfg_ball, device=dev)
    sync = solver.make_solver(cfg_ball, async_probe=False, device=dev)
    t = time.perf_counter()
    ball_rel = 0.0
    for i in range(7):
        state_i = ball(N, 0.30 + 0.06 * i)
        a_i, s_i = asyn(state_i, 0.01), sync(state_i, 0.01)
        assert a_i.stats.solve_path == s_i.stats.solve_path == "cuda"
        assert (a_i.stats.iterations, a_i.stats.octree_dofs) == (s_i.stats.iterations,
                                                                 s_i.stats.octree_dofs), i
        scale_i = max(float(v.abs().max()) for v in s_i.velocity)
        rel_i = max(float((p - q).abs().max()) for p, q in zip(a_i.velocity, s_i.velocity))
        rel_i /= scale_i
        assert rel_i <= 1e-6, (i, rel_i)
        ball_rel = max(ball_rel, rel_i)
    translate_s = time.perf_counter() - t
    info_a, info_s = asyn.cache_info(), sync.cache_info()
    assert info_a["programs"] <= 3 and info_s["programs"] <= 3, (info_a, info_s)
    drain = solver.make_solver(cfg_ball, device=dev)
    drain(ball(N, 0.5, r=0.30), 0.01)
    ((lv_d, w_peak),) = drain.cache_info()["windows"].items()
    peak = solver._windows_volume(w_peak)
    small = ball(N, 0.5, r=0.15)
    vols = []
    for _ in range(solver.SHRINK_AFTER + 2):
        drain(small, 0.01)
        w = drain.cache_info()["windows"]
        assert lv_d in w, w
        vols.append(solver._windows_volume(w[lv_d]))
    log("policy", f"ball at {N}^3 translated 7 frames in {translate_s:.2f} s: async "
                  f"{info_a['programs']} and sync {info_s['programs']} cached topologies, "
                  f"velocity async vs sync within {ball_rel:.2e} of max; drained r 0.30 -> 0.15: "
                  f"window volume {peak} then {vols}, {drain.cache_info()['programs']} "
                  f"topologies")
    assert vols[0] == peak, (vols, peak)
    assert vols[-1] < 0.7 * peak, (vols, peak)
    del asyn, sync, drain, small, state_i, a_i, s_i

    # ---- 9 the probe tools' path, and T1/T2 against their plain versions
    torch.cuda.synchronize()
    probes.reset_launch_counts()
    t = time.perf_counter()
    cal = calibrate_bandwidth.run(15, 20, device=dev)
    prof = profile_levels.run(N, 20, device=dev)
    tools_s = time.perf_counter() - t
    probe_launches = dict(probes.launch_counts)
    assert probe_launches["banded_apply"] > 0 and probe_launches["stream_floor"] > 0, \
        probe_launches
    log("probes", f"tools ({tools_s:.2f} s): calibrate_bandwidth {json.dumps(cal)} | "
                  f"profile_levels {json.dumps(prof)} | launches {probe_launches} | {smi}")
    u_t1, c_t1 = calibrate_bandwidth.make_inputs(15, device=dev)
    err["banded_apply"] = max_rel_err([("banded_apply", probes.banded_apply(u_t1, c_t1),
                                        probes.plain_banded_apply(u_t1, c_t1))])
    t1_plain_ms = call_ms(lambda: probes.plain_banded_apply(u_t1, c_t1), 5, dev)
    t1_bytes = probes.probe_bytes([u_t1, *c_t1], outputs=1)
    bounds["banded_apply"] = bound(t1_bytes, (2 * len(c_t1) - 1) * u_t1.numel())
    sys96, _ = profile_levels.build(N, dev)
    gen = torch.Generator(device="cpu").manual_seed(9)
    u96 = sys96.embed_tree({k: torch.randn(m.shape, generator=gen).to(dev) * m
                            for k, m in sys96.active.items()})
    fl_in = probes.floor_inputs(sys96.apply_A.level_args(u96)[0], sys96.apply_A.metas[0])
    fl_rows = probes.window_rows(sys96.canons[0])
    pairs = []
    for w8 in (0.0, 1.0):
        got_f = probes.stream_floor(fl_in, fl_rows, w8)
        want_f = probes.plain_stream_floor(fl_in, fl_rows, w8)
        for k in range(3):
            assert not bool(got_f[k][:fl_rows[0]].any()) and not bool(got_f[k][fl_rows[1]:].any())
            pairs.append((f"stream_floor i8 weight {w8} output {k}", got_f[k], want_f[k]))
    err["stream_floor"] = max_rel_err(pairs)
    t2_ms = call_ms(lambda: probes.stream_floor(fl_in, fl_rows), 20, dev)
    t2_plain_ms = call_ms(lambda: probes.plain_stream_floor(fl_in, fl_rows), 5, dev)
    t2_bytes = probes.probe_bytes(fl_in, 3, fl_rows)
    n_f32 = sum(1 for x in fl_in if x.dtype == torch.float32)
    bounds["stream_floor"] = bound(t2_bytes, n_f32 * (fl_rows[1] - fl_rows[0]) * fl_in[0][0].numel())
    src = torch.randn(t2_bytes // 8, device=dev)
    dst = torch.empty_like(src)
    t2_copy_ms = call_ms(lambda: dst.copy_(src), 20, dev)
    probe_rows = {
        "banded_apply": dict(shape=list(u_t1.shape), bytes=t1_bytes, ms=cal["ms"],
                             bound_ms=bounds["banded_apply"][0], copy_ms=cal["copy_ms"],
                             plain_ms=t1_plain_ms),
        "stream_floor": dict(shape=list(fl_in[0].shape), rows=list(fl_rows), bytes=t2_bytes,
                             ms=t2_ms, bound_ms=bounds["stream_floor"][0], copy_ms=t2_copy_ms,
                             plain_ms=t2_plain_ms),
    }
    for name, r in probe_rows.items():
        # a time under the byte bound would mean bytes were not moved
        assert r["ms"] >= r["bound_ms"], (name, r)
        log("probes", f"{name} on {r['shape']}: {r['ms']:.4f} ms for {r['bytes'] / 1e6:.1f} MB "
                      f"({r['bytes'] / r['ms'] / 1e6:.0f} GB/s), bound {r['bound_ms']:.4f} ms, "
                      f"share of bound {r['bound_ms'] / r['ms']:.3f}; copy_ of the same bytes "
                      f"{r['copy_ms']:.4f} ms ({r['bytes'] / r['copy_ms'] / 1e6:.0f} GB/s); "
                      f"plain {r['plain_ms']:.3f} ms; vs plain max abs "
                      f"{err[name][0]:.3e} (rel {err[name][1]:.2e}) | {smi}")
    del sys96, u96, fl_in, u_t1, c_t1, src, dst

    # ---- 10 Chebyshev (degree 3) through the kernels, beside the Jacobi frames
    from adaptiveviscositysolver_tpu_torch import operator as port_operator

    cfg_cheb = SolverConfig(octree_levels=4, tolerance=1e-4, cheb_degree=CHEB_DEGREE)
    k = CHEB_DEGREE
    cheb = {}
    for n_c, st_c, expect, n_warm, v_ref, (jac_warm, jac_solve, jac) in (
            (N, state, EXPECT, 3, v96_f64, (warm, stages["solve"], st)),
            (n2, st2, EXPECT_192, 2, v192_jacobi, (warm2, stages2["solve"], st_2))):
        solve_k = solver.make_solver(cfg_cheb, device=dev)
        torch.cuda.synchronize()
        fa.reset_launch_counts()
        cgk.reset_launch_counts()
        t = time.perf_counter()
        rk = solve_k(st_c, dt)
        for v in rk.velocity:
            v.sum().item()
        cold_k = time.perf_counter() - t
        launches_k = dict(fa.launch_counts)
        sk = rk.stats
        ((lv_k, win_k),) = solve_k.cache_info()["windows"].items()
        pshape_k = solver.padded_shape(tuple(st_c.liquid_sdf.shape), 4)
        canons_k = fa.level_canons([tuple(s >> l for s in pshape_k) for l in range(lv_k)], win_k)
        modes_k = fa.level_modes(canons_k, fa.route_budget(dev))
        log("cheb", f"{n_c}^3 cold frame {cold_k:.3f} s: {sk} | launches {launches_k} | routes "
                    f"{modes_k}")
        assert sk.solve_path == "cuda", sk.solve_path
        assert len(sk.active_cells) == expect["levels"], sk.active_cells
        assert (sk.octree_dofs, sk.regular_dofs) == (expect["octree_dofs"],
                                                     expect["regular_dofs"]), sk
        assert sk.residual <= 1e-4, sk.residual
        assert sk.applies == 13 + 1 + (k - 1) + k * sk.iterations, (sk.applies, sk.iterations)
        check_launches(launches_k, sk.applies, canons_k, modes_k, f"cheb {n_c}")
        # Chebyshev keeps the CG loop of PyTorch ops
        assert not any(cgk.launch_counts.values()), cgk.launch_counts
        if n_c in EXPECT_CHEB:
            assert abs(sk.iterations - EXPECT_CHEB[n_c]) <= 2, (sk.iterations, EXPECT_CHEB[n_c])
        scale_k = max(float(v.abs().max()) for v in v_ref)
        rel_k = max(float((g.double() - w.double()).abs().max())
                    for g, w in zip(rk.velocity, v_ref)) / scale_k
        for a, v in enumerate(rk.velocity):
            assert tuple(v.shape) == tuple(n_c + (1 if d == a else 0) for d in range(3)), v.shape
            assert bool(torch.isfinite(v).all()), f"cheb {n_c}: velocity {a} not finite"
        assert rel_k < 5e-4, (n_c, rel_k)
        warm_k = []
        for _ in range(n_warm):
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            r = solve_k(st_c, dt)
            stop.record()
            torch.cuda.synchronize()
            warm_k.append(start.elapsed_time(stop))
            assert r.stats.iterations == sk.iterations
        stages_k = {}
        solve_k(st_c, dt, stage_times=stages_k)
        trace_k = None
        if n_c == N:
            # one more warm frame under the profiler, as phase 4 traces Jacobi's
            r, spans, events = trace_frame(solve_k, st_c, dt,
                                           trace_path.with_name("cheb_warm_frame.json"))
            assert r.stats.iterations == sk.iterations
            trace_k = trace_summary(spans, events, stages_k, statistics.median(warm_k))
            if events:
                cg_k = trace_k["stages"]["solve"]
                log("cheb", f"{n_c}^3 traced frame: {trace_k['frame_wall_ms']:.2f} ms wall under "
                            f"the profiler, device busy {trace_k['frame_device_ms']:.2f} ms | CG "
                            f"stage {cg_k['wall_ms']:.2f} ms wall, {cg_k['device_ms']:.2f} ms "
                            f"device, {cg_k['device_ops'] / sk.iterations:.1f} device ops per "
                            f"iteration, {cg_k['device_ops'] / sk.applies:.1f} per apply | "
                            f"against the unprofiled walls: frame idle share "
                            f"{trace_k['frame_idle_share_unprofiled']:.3f}, CG "
                            f"{trace_k['cg_idle_share_unprofiled']:.3f} | top CG ops "
                            + "; ".join(f"{o['op']} {o['launches']} x {o['device_ms']:.2f} ms"
                                        for o in trace_k["cg_top_ops"][:5]))
            else:
                log("cheb", "the trace holds no device events: device idle share not measured")
        lam = None
        if n_c == n2:
            # the lam_max estimate behind the preconditioner: 12 power
            # iterations from b (the solve's) against 60, on the default
            # routes and with every level fused
            sys_d = solver.build_system(st_c, dt, SolverConfig(octree_levels=lv_k, tolerance=1e-4),
                                        device=dev, bboxes=win_k, pad_levels=4)
            b_t = sys_d.embed_tree(sys_d.rhs)
            pack, unpack = port_operator.make_packer({kk: tuple(v.shape) for kk, v in b_t.items()})
            b_f = pack(b_t)
            invd = 1.0 / pack(sys_d.embed_tree(sys_d.diag, fill=1.0))
            fused_d = ["fused"] * lv_k
            apply_fd, _, _ = fa.make_fused_operator(
                sys_d.frame, fa.route_canons(sys_d.canons, fused_d), sys_d.active,
                sys_d.res_per_level, st_c.dx, enh, modes=fused_d)
            lam = {}
            for name_d, op_d, iters_d in (("routes_12", sys_d.apply_A, 12),
                                          ("fused_12", apply_fd, 12),
                                          ("routes_60", sys_d.apply_A, 60)):
                lam[name_d] = float(port_operator.estimate_lambda_max(
                    lambda f, op_d=op_d: pack(op_d(unpack(f))), invd, b_f, iters=iters_d))
            log("cheb", f"{n_c}^3 lam_max estimate from b: 12 power iterations "
                        f"{lam['routes_12']:.6f} (every level fused {lam['fused_12']:.6f}), "
                        f"60 iterations "
                        f"{lam['routes_60']:.6f}")
            del sys_d, b_t, b_f, invd, apply_fd
        cheb[n_c] = {"trace": trace_k, "lam_max": lam, "cold_frame_s": cold_k,
                     "warm_frame_ms": warm_k,
                     "warm_frame_ms_median": statistics.median(warm_k),
                     "solve_stage_ms": stages_k["solve"] * 1e3, "cg_iterations": sk.iterations,
                     "applies": sk.applies, "residual": sk.residual, "velocity_rel": rel_k,
                     "jacobi": {"warm_frame_ms": jac_warm,
                                "warm_frame_ms_median": statistics.median(jac_warm),
                                "solve_stage_ms": jac_solve * 1e3,
                                "cg_iterations": jac.iterations, "applies": jac.applies}}
        log("cheb", f"{n_c}^3 Jacobi: warm {['%.2f' % w for w in jac_warm]} ms (median "
                    f"{statistics.median(jac_warm):.2f}, spread {min(jac_warm):.2f}-"
                    f"{max(jac_warm):.2f}), solve stage {jac_solve * 1e3:.2f} ms, "
                    f"{jac.iterations} iterations, {jac.applies} applies | Chebyshev degree {k}: "
                    f"warm {['%.2f' % w for w in warm_k]} ms (median "
                    f"{statistics.median(warm_k):.2f}, spread {min(warm_k):.2f}-"
                    f"{max(warm_k):.2f}), solve stage {stages_k['solve'] * 1e3:.2f} ms, "
                    f"{sk.iterations} iterations (JAX {EXPECT_CHEB.get(n_c, 'not run')}), "
                    f"{sk.applies} applies; velocity vs "
                    f"{'float64 v1' if n_c == N else 'the Jacobi frame'} {rel_k:.2e} | {smi}")
        del solve_k, rk, r
    del v192_jacobi

    # ---- 11 iterative refinement (float64), and the v1-fused operator
    t_phase = time.perf_counter()
    st_r = scenes.buckling(n=N_REFINED, dtype=torch.float64, device=dev)
    cfg_r = SolverConfig(octree_levels=4, tolerance=1e-9)
    inner = []   # the dtypes of each inner (float32) apply
    pcg_refined = port_operator.pcg_refined

    def pcg_refined_checked(hi, lo, *a, **kw):
        def lo_checked(u):
            inner.append(frozenset(v.dtype for v in u.values()))
            return lo(u)
        return pcg_refined(hi, lo_checked, *a, **kw)

    canons_r = fa.level_canons([tuple(N_REFINED >> l for _ in range(3)) for l in range(4)])
    modes_r = fa.level_modes(canons_r, fa.route_budget(dev))
    port_operator.pcg_refined = pcg_refined_checked
    try:
        torch.cuda.synchronize()
        fa.reset_launch_counts()
        cgk.reset_launch_counts()
        t = time.perf_counter()
        rr = solver.solve_viscosity(st_r, dt, dataclasses.replace(
            cfg_r, use_iterative_refinement=True), device=dev)
        torch.cuda.synchronize()
        refined_s = time.perf_counter() - t
        launches_r = dict(fa.launch_counts)
        cg_launches_r = dict(cgk.launch_counts)
    finally:
        port_operator.pcg_refined = pcg_refined
    t = time.perf_counter()
    rv = solver.solve_viscosity(st_r, dt, cfg_r, device=dev)
    v1_r_s = time.perf_counter() - t
    scale_r = max(float(v.abs().max()) for v in rv.velocity)
    rel_r = max(float((a - b).abs().max()) for a, b in zip(rr.velocity, rv.velocity)) / scale_r
    log("refined", f"buckling-{N_REFINED} float64: refined {refined_s:.2f} s, {rr.stats}, "
                   f"{len(inner)} inner applies, launches {launches_r} | v1 {v1_r_s:.2f} s, "
                   f"{rv.stats.iterations} iterations, residual {rv.stats.residual:.3e} | inner "
                   f"apply dtypes {sorted(map(str, set().union(*inner)))}; velocity refined vs "
                   f"v1 {rel_r:.2e} of max | {smi}")
    assert rr.stats.solve_path == "refined" and rv.stats.solve_path == "v1"
    assert inner and set(inner) == {frozenset({torch.float32})}, set(inner)
    # every inner apply runs the kernels; the float64 residuals run v1
    check_launches(launches_r, len(inner), canons_r, modes_r, "refined inner applies")
    # the inner CGs run the CG kernels: once each per inner iteration
    assert cg_launches_r == dict.fromkeys(cg_launches_r, rr.stats.iterations), (
        cg_launches_r, rr.stats.iterations)
    assert rr.stats.applies > len(inner) > rr.stats.iterations
    assert rr.stats.residual <= 1e-9 and rv.stats.residual <= 1e-9
    assert rel_r < 1e-5, rel_r
    del st_r, rr, rv
    st32 = scenes.buckling(n=32, device=dev)
    cfg_f = SolverConfig(octree_levels=4, tolerance=1e-4, apply_impl="v1-fused")
    t = time.perf_counter()
    rfu = solver.solve_viscosity(st32, dt, cfg_f, device=dev)
    fused_s = time.perf_counter() - t
    t = time.perf_counter()
    rv1 = solver.solve_viscosity(st32, dt, dataclasses.replace(cfg_f, apply_impl="v1"),
                                 device=dev)
    v1_s = time.perf_counter() - t
    scale_f = max(float(v.abs().max()) for v in rv1.velocity)
    diff_f = max(float((a - b).abs().max()) for a, b in zip(rfu.velocity, rv1.velocity))
    log("refined", f"buckling-32 float32: v1-fused {fused_s:.2f} s, {rfu.stats.iterations} "
                   f"iterations; v1 {v1_s:.2f} s, {rv1.stats.iterations} iterations; velocity "
                   f"diff {diff_f / scale_f:.2e} of max")
    assert rfu.stats.solve_path == "v1-fused" and rv1.stats.solve_path == "v1"
    assert rfu.stats.iterations == rv1.stats.iterations
    assert diff_f <= 1e-6 * scale_f, diff_f / scale_f
    del st32, rfu, rv1
    refined_phase_s = time.perf_counter() - t_phase
    log("refined", f"phase 11 took {refined_phase_s:.2f} s (buckling-{N_REFINED} refined and "
                   f"float64 v1, buckling-32 v1-fused and v1)")

    # ---- 12 the tail: FLIP loop, cancellation, checkpoint, native checks, interp_at
    from adaptiveviscositysolver_tpu_torch import interpolator, native, octree
    from adaptiveviscositysolver_tpu_torch.classify import UNASSIGNED
    from adaptiveviscositysolver_tpu_torch.models import flip
    from adaptiveviscositysolver_tpu_torch.utils import cancel, checkpoint

    n_f = 64
    cfg_flip = SolverConfig(octree_levels=4, tolerance=1e-4)
    canons_f = fa.level_canons([tuple(n_f >> l for _ in range(3)) for l in range(4)])
    modes_f = fa.level_modes(canons_f, fa.route_budget(dev))
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    cgk.reset_launch_counts()
    t = time.perf_counter()
    flip_out, flip_stats = flip.simulate(scenes.buckling(n=n_f, device=dev), 3, dt, cfg_flip,
                                         device=dev)
    torch.cuda.synchronize()
    flip_s = time.perf_counter() - t
    launches_f = dict(fa.launch_counts)
    vy = float(flip_out.velocity[1].mean())
    log("tail", f"FLIP buckling-{n_f}, 3 frames in {flip_s:.2f} s: "
                + "; ".join(f"{s.solve_path} {s.iterations} it residual {s.residual:.2e} "
                            f"{s.octree_dofs} DOFs" for s in flip_stats)
                + f" | launches {launches_f} | mean vertical velocity {vy:.4f}")
    for s_f in flip_stats:
        assert s_f.solve_path == "cuda" and s_f.residual <= 1e-4, s_f
    assert all(bool(torch.isfinite(v).all()) for v in flip_out.velocity)
    assert vy < 0.0, vy
    check_launches(launches_f, sum(s_f.applies for s_f in flip_stats), canons_f, modes_f, "flip")
    flip_iters = sum(s_f.iterations for s_f in flip_stats)
    assert cgk.launch_counts == dict.fromkeys(cgk.launch_counts, flip_iters), (
        cgk.launch_counts, flip_iters)

    solve_x = solver.make_solver(dataclasses.replace(cfg, cancel_poll_iters=16), device=dev)
    cancel.request()
    try:
        rx = solve_x(state, dt)
    finally:
        cancel.clear()
    rx2 = solve_x(state, dt)
    log("tail", f"cancel: flag set {rx.stats.iterations} iterations, residual "
                f"{rx.stats.residual:.3e}; cleared {rx2.stats.iterations} iterations, residual "
                f"{rx2.stats.residual:.3e}")
    assert rx.stats.iterations == 16 and rx.stats.residual > 1e-4, rx.stats
    assert rx2.stats.residual <= 1e-4 and abs(rx2.stats.iterations - st.iterations) <= 2
    del solve_x, rx, rx2

    tail_dir = Path(_build.BUILD_DIR).parent / "tail"
    tail_dir.mkdir(parents=True, exist_ok=True)
    checkpoint.save(str(tail_dir / "flip_state"), flip_out, step=3)
    loaded, step = checkpoint.load(str(tail_dir / "flip_state"), device=dev)
    assert step == 3 and loaded.dx == flip_out.dx
    for f in ("liquid_sdf", "solid_sdf", "viscosity", "density"):
        assert torch.equal(getattr(loaded, f), getattr(flip_out, f)), f
    for a in range(3):
        assert torch.equal(loaded.velocity[a], flip_out.velocity[a])
        assert torch.equal(loaded.solid_velocity[a], flip_out.solid_velocity[a])
    del flip_out, loaded

    dx96 = state.dx
    mask96 = octree.build_refinement_mask(state.liquid_sdf, state.solid_sdf, dx96,
                                          cfg.extrapolation * dx96, 3.0 * dx96,
                                          dx96 * max(2.0, float(cfg.fine_bandwidth)))
    labels96 = octree.build_octree(mask96, 4)
    t = time.perf_counter()
    fails = native.check_octree_invariants(labels96)
    native_s = time.perf_counter() - t
    ply = tail_dir / "buckling96_octree.ply"
    pos96, _, _ = solver.octree_geometry_for_state(state, cfg, str(ply), device=dev)
    n_active = int(octree.active_cell_counts(labels96).sum())
    log("tail", f"native: invariants of the {N}^3 octree {fails} ({native_s:.2f} s, build "
                f"included); PLY {ply.stat().st_size} B, {len(pos96)} points")
    assert fails == [], fails
    assert len(pos96) == n_active > 0
    assert f"element vertex {n_active}\n".encode() in ply.read_bytes()[:200]

    sys96 = solver.build_system(state, dt, cfg_lv, device=dev, bboxes=windows, pad_levels=4)
    sol_c, _, _, _ = port_operator.pcg_flat(
        sys96.apply_A, sys96.embed_tree(sys96.rhs), sys96.embed_tree(sys96.guess),
        sys96.embed_tree(sys96.diag, fill=1.0), cfg.tolerance, cfg.max_iterations)
    u96 = sys96.crop_tree(sol_c)
    dense = interpolator.interpolate_writeback_fields(sys96.labels, u96, sys96.vel_kinds,
                                                      sys96.levels)
    query = interpolator.make_point_interpolator(sys96.labels, u96, sys96.vel_kinds)
    interp_rel, n_pts, interp_ms = 0.0, 0, 0.0
    for a in range(3):
        sel = sys96.vel_kinds[0][a] == UNASSIGNED
        pts = torch.nonzero(sel).float() + torch.tensor([0.0 if d == a else 0.5 for d in range(3)],
                                                        device=dev)
        got_i = query(pts, a)
        scale_i = max(float(dense[a].abs().max()), 1e-30)
        interp_rel = max(interp_rel, float((got_i - dense[a][sel]).abs().max()) / scale_i)
        n_pts += len(pts)
        interp_ms += cuda_ms(lambda: query(pts, a), 3)
    log("tail", f"interp_at at {n_pts} UNASSIGNED level-0 faces of the {N}^3 solution: "
                f"{interp_rel:.2e} of max from the writeback interpolation, {interp_ms:.2f} ms "
                f"for the three axes | {smi}")
    assert n_pts > 0 and interp_rel <= 1e-6, (n_pts, interp_rel)
    del sys96, u96, dense, sol_c

    # ---- 13 shard: the sharded CG on 2 gloo ranks sharing the card (B6: the
    # kernels on halo-filled local boxes), and the dry-run analog on 8 ranks
    from adaptiveviscositysolver_tpu_torch import export
    from adaptiveviscositysolver_tpu_torch.parallel import mesh as pmesh
    from adaptiveviscositysolver_tpu_torch.parallel import shard_fused

    t_phase = time.perf_counter()
    n_ranks = 2
    cfg_sh = SolverConfig(octree_levels=4, tolerance=1e-4)
    single_sh = solver.solve_viscosity(state, dt, cfg_sh, device=dev)
    sys_sh = solver.build_system(state, dt, cfg_sh, device=dev)
    rpl_sh = sys_sh.res_per_level
    assert solver.padded_shape((N,) * 3, len(rpl_sh), n_ranks) == (N,) * 3
    # a budget under the weighted stresses of a rank's level-0 box: level 0
    # runs in bricks (B3-B5 on halo-filled boxes)
    lc0 = shard_fused.local_canons([(r[0] // n_ranks, r[1], r[2]) for r in rpl_sh])[0]
    brick_budget = fa.tau_bytes(lc0) / 3
    runs = pmesh.launch(n_ranks, pmesh.solve_on_ranks, ("buckling", N), dt, [cfg_sh, cfg_sh], 2,
                        False, [None, brick_budget], timeout=200, device=dev)
    scale_sh = max(float(v.abs().max()) for v in single_sh.velocity)
    share = {}
    sharded_warm = {}
    for i, route in enumerate(("default", "bricked")):
        per_rank = [r[i] for r in runs]
        st_sh = per_rank[0]["stats"]
        assert all(r["stats"] == st_sh for r in per_rank), [r["stats"] for r in per_rank]
        assert st_sh["solve_path"] == "cuda-sharded", st_sh
        assert (st_sh["octree_dofs"], st_sh["regular_dofs"]) == (EXPECT["octree_dofs"],
                                                                 EXPECT["regular_dofs"]), st_sh
        assert abs(st_sh["iterations"] - single_sh.stats.iterations) <= 2, st_sh
        assert st_sh["residual"] <= 1e-4, st_sh
        rel_sh = max(float(np.abs(g - w.cpu().numpy()).max())
                     for g, w in zip(per_rank[0]["velocity"], single_sh.velocity)) / scale_sh
        assert rel_sh < 5e-4, (route, rel_sh)
        want_x = shard_fused.expected_exchanges(rpl_sh, n_ranks, st_sh["applies"])
        for r in per_rank:
            applies = st_sh["applies"]
            want_l = {"fused_tau": applies * r["fused"], "fused_dt": applies * r["fused"],
                      "tau_level": applies * r["row_ranges"], "dt_level": applies * r["row_ranges"]}
            assert r["launches"] == want_l, (route, r["rank"], r["launches"], want_l)
            assert r["collectives"] == {"exchanges": want_x["frame"] + want_x["apply"],
                                        "allreduces": 3 + 3 * st_sh["iterations"],
                                        "gathers": 2}, (route, r["rank"], r["collectives"])
            if route == "bricked":
                assert r["modes"][0].startswith("('brick'"), r["modes"]
        share[route] = [{k: v / r["seconds"][-1] for k, v in r["collective_seconds"].items()}
                        for r in per_rank]
        sharded_warm[route] = per_rank[0]["seconds"]
        log("shard", f"buckling-{N} on {n_ranks} gloo ranks sharing one card, {route} routes "
                     f"{per_rank[0]['modes']}: {st_sh['iterations']} it (single-device "
                     f"{single_sh.stats.iterations}), residual {st_sh['residual']:.3e}, velocity "
                     f"{rel_sh:.2e} of max from the single-device solve; frames "
                     f"{['%.3f' % s for s in per_rank[0]['seconds']]} s (cold, warm); per rank "
                     f"launches {[r['launches'] for r in per_rank]}, collectives "
                     f"{per_rank[0]['collectives']}; share of the warm frame per rank in "
                     f"exchanges / all-reduces / gathers "
                     + "; ".join(" / ".join("%.3f" % x[k] for k in ("exchanges", "allreduces",
                                                                    "gathers"))
                                 for x in share[route])
                     + f" (2 ranks sharing one card: no scale-out is measured) | {smi}")

    # rank 0's halo-filled local boxes: each kernel of both routes against its
    # plain version, its time and bound there, and the CSR of its owned rows
    app = pmesh.launch(n_ranks, pmesh.apply_on_ranks, ("buckling", N), dt, cfg_sh, 0, False, True,
                       timeout=120, device=dev)
    loc = app[0]["local"]
    args_sh = [{k: torch.from_numpy(v).to(dev) for k, v in a.items()} for a in loc["args"]]
    canons_sh, modes_sh = loc["canons"], loc["modes"]
    metas_sh = fa.level_metas(canons_sh, state.dx)
    modes_bk = fa.level_modes([dataclasses.replace(c, brick=None) for c in canons_sh],
                              brick_budget)
    canons_bk = fa.route_canons(canons_sh, modes_bk)
    err_sh = worst_by_kernel(routed_errors(args_sh, metas_sh, canons_sh, modes_sh, enh, "shard"),
                             routed_errors(args_sh, metas_sh, canons_bk, modes_bk, enh,
                                           "shard bricked"))
    fused_l = [l for l, m in enumerate(modes_sh) if m == "fused"]
    sh_ms = dict(zip(("fused_tau", "fused_dt"), time_fused_levels(
        [args_sh[l] for l in fused_l], [metas_sh[l] for l in fused_l], enh, reps)))
    sh_plain = {"fused_tau": cuda_ms(lambda: fa._plain_tau(args_sh, metas_sh, enh), 3)}
    taus_sh = fa._plain_tau(args_sh, metas_sh, enh)
    sh_plain["fused_dt"] = cuda_ms(lambda: fa._plain_dt(args_sh, taus_sh, metas_sh, enh), 3)
    sh_ms["tau_level"] = sh_ms["dt_level"] = 0.0
    sh_plain["tau_level"] = sh_plain["dt_level"] = 0.0
    for l, m in enumerate(modes_bk):
        if m != "fused":
            t_ms, d_ms = time_level_pair(args_sh[l], metas_sh[l], canons_bk[l], enh, 10)
            tp_ms, dp_ms = time_level_pair(args_sh[l], metas_sh[l], canons_bk[l], enh, 1,
                                           plain=True)
            sh_ms["tau_level"] += t_ms
            sh_ms["dt_level"] += d_ms
            sh_plain["tau_level"] += tp_ms
            sh_plain["dt_level"] += dp_ms
    routed_b = [l for l, m in enumerate(modes_bk) if m != "fused"]
    nb_f = fa.kernel_bytes([metas_sh[l] for l in fused_l])
    nf_f = fa.kernel_flops([metas_sh[l] for l in fused_l], enh)
    nb_b = fa.kernel_bytes([metas_sh[l] for l in routed_b])
    nf_b = fa.kernel_flops([metas_sh[l] for l in routed_b], enh)
    sh_bounds = {"fused_tau": bound(nb_f["tau"], nf_f["tau"]),
                 "fused_dt": bound(nb_f["dt"], nf_f["dt"]),
                 "tau_level": bound(nb_b["tau"], nf_b["tau"]),
                 "dt_level": bound(nb_b["dt"], nf_b["dt"])}
    # the CSR system of the whole grid, restricted to rank 0's owned rows,
    # timed on the DOF vector of the same random u, and held to the
    # gathered sharded apply there
    t = time.perf_counter()
    A_sh, _, idx_sh, n_sh, _, _ = export._assemble(sys_sh.blocks, sys_sh.mass, sys_sh.vel_kinds,
                                                   sys_sh.guess, rpl_sh)
    export_sh_s = time.perf_counter() - t
    u_sh = pmesh.random_faces(sys_sh.active, 0)
    x_sh = np.zeros(n_sh, np.float32)
    own_rows = []
    for (l, a), g in u_sh.items():
        idx = idx_sh[l][a]
        sel = idx >= 0
        x_sh[idx[sel]] = g.cpu().numpy()[sel]
        w_l = rpl_sh[l][0] // n_ranks
        own_rows.append(idx[:w_l][idx[:w_l] >= 0])
    own_rows = np.sort(np.concatenate(own_rows))
    A_own = _csr_on(A_sh[own_rows], dev)
    xt = torch.from_numpy(x_sh).to(dev)
    csr_own_ms = cuda_ms(lambda: A_own @ xt, reps)
    y_own = (A_own @ xt).cpu().numpy()
    out_sh = app[0]["out"]
    got_own = np.zeros(n_sh, np.float32)
    for (l, a), g in out_sh.items():
        idx = idx_sh[l][a]
        sel = idx >= 0
        got_own[idx[sel]] = g[sel]
    csr_err = float(np.abs(got_own[own_rows] - y_own).max())
    csr_scale = max(float(np.abs(y_own).max()), 1e-30)
    assert csr_err <= TOL * csr_scale, (csr_err, csr_scale)
    log("shard", f"rank 0's local boxes {[c.shape for c in canons_sh]} (x pad {canons_sh[0].pad_x}"
                 f"), routes {modes_sh} and {modes_bk}: kernels vs plain "
                 + ", ".join(f"{k} {e[0]:.3e} (rel {e[1]:.2e})" for k, e in err_sh.items())
                 + "; per apply " + ", ".join(
                     f"{k} {sh_ms[k]:.4f} ms (plain {sh_plain[k]:.2f} ms, bound "
                     f"{sh_bounds[k][0]:.4f} ms)" for k in sh_ms)
                 + f"; CSR A @ x of rank 0's {len(own_rows)} owned rows {csr_own_ms:.4f} ms "
                   f"({A_own.values().numel()} nonzeros; export {export_sh_s:.2f} s), the "
                   f"gathered sharded apply within {csr_err / csr_scale:.2e} of it; launches "
                   f"of the apply per rank {[r['launches'] for r in app]} | {smi}")
    del args_sh, taus_sh, A_sh, A_own, sys_sh, app

    t = time.perf_counter()
    dry = pmesh.dryrun_multichip(8, device=dev, timeout=150)
    dry_s = time.perf_counter() - t
    log("shard", f"dry-run analog on 8 gloo ranks sharing one card: {dry} in {dry_s:.2f} s")
    shard_phase_s = time.perf_counter() - t_phase
    log("shard", f"phase 13 took {shard_phase_s:.2f} s | {smi}")

    # ---- 14 example: the buckling example's command line, as a user runs it
    import tempfile

    from adaptiveviscositysolver_tpu_torch import make_solver, solve_viscosity
    from adaptiveviscositysolver_tpu_torch.examples import run_buckling

    t_phase = time.perf_counter()
    assert make_solver is solver.make_solver and solve_viscosity is solver.solve_viscosity
    assert native.available()
    with tempfile.TemporaryDirectory(prefix="avs_example_") as work:
        rc_ex, lines_ex, rec_ex = run_example(work)
        for line in lines_ex:
            log("example", line)
        assert rc_ex == 0 and rec_ex, f"the example exited {rc_ex}"
        frames_ex = [_FRAME_LINE.match(line) for line in lines_ex if line.startswith("frame ")]
        assert all(frames_ex), lines_ex
        assert [int(m.group(1)) for m in frames_ex] == list(range(EXAMPLE_FRAMES)), lines_ex
        ply_ex = []
        for m in frames_ex:
            assert float(m.group(3)) <= 1e-4, m.group(0)
            ply = Path(work) / m.group(7)
            head = ply.read_bytes()[:200]
            n_ply = int(head.split(b"element vertex ")[1].split(b"\n")[0])
            assert n_ply == int(m.group(6)) > 0, (ply, n_ply, m.group(0))
            ply_ex.append(n_ply)
        plys = sorted(p.name for p in (Path(work) / "out_buckling_torch").iterdir())
        assert plys == [f"frame_{i:03d}.ply" for i in range(EXAMPLE_FRAMES)], plys
        state_ex, _ = checkpoint.load(str(Path(work) / "frame0_state"), device=dev)
        vel_ex = [v.to(dev) for v in torch.load(Path(work) / "frame0_velocity.pt")]
    launches_ex = rec_ex["launches"]
    iters_ex = [int(m.group(2)) for m in frames_ex]
    check_launches(launches_ex, sum(i + 1 for i in iters_ex), canons_f, modes_f, "example")
    stamps = rec_ex["solve_end_s"]
    frame_ex_s = [b - a for a, b in zip(stamps, stamps[1:])]
    totals = [re.match(r"total: (\d+) frames in ([\d.]+)s$", line) for line in lines_ex]
    total_ex = next((m for m in totals if m), None)
    assert total_ex and int(total_ex.group(1)) == EXAMPLE_FRAMES, lines_ex

    # the kernels at the example's boxes, on the system of its frame 0
    sys_ex = solver.build_system(state_ex, run_buckling.DT, run_buckling.CONFIG, device=dev)
    assert sys_ex.canons == canons_f and sys_ex.modes == modes_f == ["fused"] * 4, sys_ex.modes
    gen = torch.Generator(device="cpu").manual_seed(14)
    u_ex = sys_ex.embed_tree({k: torch.randn(m.shape, generator=gen).to(dev) * m
                              for k, m in sys_ex.active.items()})
    e_ex = routed_errors(sys_ex.apply_A.level_args(u_ex), sys_ex.apply_A.metas, sys_ex.canons,
                         sys_ex.modes, enh, "example")
    err = {k: worst(err[k], e_ex[k]) if k in e_ex else err[k] for k in err}
    del sys_ex, u_ex
    # the example's frame-0 velocity against the float64 whole-array solve of its state
    want_ex = solver.solve_viscosity(state_ex, run_buckling.DT,
                                     dataclasses.replace(run_buckling.CONFIG, dtype=torch.float64),
                                     device=dev)
    scale_ex = max(float(v.abs().max()) for v in want_ex.velocity)
    rel_ex = max(float((g.double() - w).abs().max()) for g, w in zip(vel_ex, want_ex.velocity))
    rel_ex /= scale_ex
    log("example", f"frame 0 at the example's boxes "
                   f"{[c.shape for c in canons_f]}: fused_tau vs plain max abs "
                   f"{e_ex['fused_tau'][0]:.3e} (rel {e_ex['fused_tau'][1]:.2e}), fused_dt "
                   f"{e_ex['fused_dt'][0]:.3e} (rel {e_ex['fused_dt'][1]:.2e}); velocity vs "
                   f"float64 v1 ({want_ex.stats.iterations} it) {rel_ex:.2e} of max")
    assert want_ex.stats.solve_path == "v1" and want_ex.stats.residual <= 1e-4
    assert abs(iters_ex[0] - want_ex.stats.iterations) <= 2, (iters_ex, want_ex.stats)
    assert rel_ex < 5e-4, rel_ex
    del want_ex, vel_ex, state_ex
    # the step's own effect on the count: the scene's first state at both steps
    solve_first = make_solver(run_buckling.CONFIG, device=dev)
    first_ex = {name: solve_first(scenes.buckling(n=n_f, device=dev), step).stats.iterations
                for name, step in (("1/24", 1.0 / 24.0), ("1/48", run_buckling.DT))}
    example_phase_s = time.perf_counter() - t_phase
    log("example", f"buckling-{n_f}'s first state: {first_ex} iterations at dt 1/24 and 1/48 "
                   f"(JAX {EXPECT_FIRST_64})")
    for name, want_it in EXPECT_FIRST_64.items():
        assert abs(first_ex[name] - want_it) <= 2, (first_ex, EXPECT_FIRST_64)
    log("example", f"{EXAMPLE_FRAMES} frames at {n_f}^3: iterations {iters_ex}, frames 1-4 "
                   f"{[round(x, 3) for x in frame_ex_s]} s apart (solve ends), script total "
                   f"{total_ex.group(2)} s, launches {launches_ex}; phase 14 took "
                   f"{example_phase_s:.2f} s | {smi}")

    measured = {
        "fused_tau": (launches["fused_tau"], err["fused_tau"][0], tau_ms, tau_plain_ms,
                      lib_tau_ms),
        "fused_dt": (launches["fused_dt"], err["fused_dt"][0], dt_ms, dt_plain_ms, lib_ms),
        "tau_level": (launches2["tau_level"], err["tau_level"][0], lvl_ms["tau_level"],
                      lvl_plain_ms["tau_level"], lib2_tau_ms),
        "dt_level": (launches2["dt_level"], err["dt_level"][0], lvl_ms["dt_level"],
                     lvl_plain_ms["dt_level"], lib2_ms),
        # no one PyTorch call computes either probe's function
        "banded_apply": (probe_launches["banded_apply"], err["banded_apply"][0], cal["ms"],
                         t1_plain_ms, None),
        "stream_floor": (probe_launches["stream_floor"], err["stream_floor"][0], t2_ms,
                         t2_plain_ms, None),
        # phase 5b's, beside the launches of phase 5's cold frame; no one
        # library call computes any of them
        **{name: (cg_launches2[name], cg_err[name][0], cg_t[name], cg_t["plain"][name], None)
           for name in CG_PASSES},
    }
    kernels = []
    for name, (n_launch, err, ms, plain_ms, library_ms) in measured.items():
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"adaptiveviscositysolver_tpu_torch/csrc/{SOURCE[name]}",
            "replaces": REPLACES[name], "launches": n_launch, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bounds[name][0],
            "bound_by": bounds[name][1], "library_ms": library_ms, **design.get(name, {}),
            "paths": PATHS[name],
        })
        if name in sh_ms:   # B6: on rank 0's halo-filled local boxes (phase 13)
            kernels[-1]["sharded"] = {
                "launches_per_rank": [r[0 if name.startswith("fused") else 1]["launches"][name]
                                      for r in runs],
                "max_abs_err": err_sh[name][0], "ms": sh_ms[name], "plain_ms": sh_plain[name],
                "bound_ms": sh_bounds[name][0], "bound_by": sh_bounds[name][1],
                "library_ms": csr_own_ms}
    print(json.dumps({"result": {
        "warm_frame_ms_median": statistics.median(warm), "cold_frame_s": cold_s,
        "build_s": build_s, "cg_iterations": st.iterations, "octree_dofs": st.octree_dofs,
        "regular_dofs": st.regular_dofs, "levels": len(st.active_cells),
        "apply_ms": apply_ms, "apply_plain_ms": apply_plain_ms, "library_apply_ms": lib_ms,
        "library_tau_ms": lib_tau_ms, "export_s": export_s,
        "b192": {"routes": [str(m) for m in modes2], "cold_frame_s": cold2_s,
                 "warm_frame_ms": warm2, "cg_iterations": st_2.iterations,
                 "peak_gib": peak2 / 2**30,
                 "octree_dofs": st_2.octree_dofs, "regular_dofs": st_2.regular_dofs,
                 "apply_ms_default": ab["default"], "apply_ms_fused": ab["fused"],
                 "library_level_ms": lib2_ms, "library_level_tau_ms": lib2_tau_ms,
                 "export_s": export2_s,
                 "level0_ms": {"routed": l0_routed, "split": l0_split, "fused": l0_fused}},
        "b256": {"routes": [str(m) for m in modes3], "frame_ms": {"default": msd, "fused": msf},
                 "cg_iterations": [sd.iterations, sf.iterations],
                 "peak_gib": {"default": memd / 2**30, "fused": memf / 2**30},
                 "kernel_ms": k3},
        "cg": {"n": n_cg, "max_ulp": {k: u for k, (_, u) in cg_err.items()}, "sums_rel": cg_sums,
               "dot_ms": cg_t["dot"], "iteration_ms": cg_t["iteration"],
               "iteration_bound_ms": cg_t["bound_ms"][0], "torch_loop_ms": cg_t["torch_loop"]},
        "b96_cache": {"build_system_ms": build_ms, "probe_ms": cache_stages[0]["probe"] * 1e3,
                      "build_system_ms_192_cached": stages2["build_system"] * 1e3},
        "b96_vs_v1": {"rel": diff96 / scale96, "v1_s": v1_96_s},
        "beam64": {"cg_iterations": sb.iterations, "octree_dofs": sb.octree_dofs,
                   "regular_dofs": sb.regular_dofs, "levels": len(sb.active_cells),
                   "residual": sb.residual, "routes": [str(m) for m in modes_b],
                   "windows": win_b, "cold_frame_s": beam_cold_s, "warm_frame_ms": beam_warm_ms,
                   "warm_frames_ms": beam_warm},
        "policy": {"programs": [info_a["programs"], info_s["programs"]],
                   "async_vs_sync_rel": ball_rel, "drain_volumes": [peak] + vols},
        "probes": probe_rows,
        "cheb": cheb,
        "refined": {"n": N_REFINED, "refined_s": refined_s, "v1_s": v1_r_s, "rel": rel_r,
                    "inner_applies": len(inner), "launches": launches_r,
                    "v1_fused_s": fused_s, "v1_s_32": v1_s, "phase_s": refined_phase_s},
        "tail": {"flip_s": flip_s, "flip_iterations": [s_f.iterations for s_f in flip_stats],
                 "interp_rel": interp_rel, "interp_points": n_pts, "interp_ms": interp_ms},
        "shard": {"ranks": n_ranks, "warm_frame_s": sharded_warm, "collective_share": share,
                  "csr_owned_ms": csr_own_ms, "dryrun": dry,
                  "dryrun_s": dry_s, "phase_s": shard_phase_s},
        "example": {"n": n_f, "frame_s": frame_ex_s, "total_s": float(total_ex.group(2)),
                    "iterations": iters_ex, "ply_points": ply_ex, "launches": launches_ex,
                    "velocity_vs_v1_rel": rel_ex, "first_state_iterations": first_ex,
                    "phase_s": example_phase_s},
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
