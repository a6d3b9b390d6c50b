#!/usr/bin/env python3
"""Benchmark of ``adaptiveviscositysolver_tpu_torch`` on one NVIDIA H100:
frame after frame through ``make_solver``'s closure, as a FLIP pipeline
calls it.

    python3 bench_h100/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The workload names a cell of ``BENCHMARK.json``: a configuration
(``configs/<config>.json``: the scene, its size and dtype, and the solver
settings of ``SETTINGS``)
under a traffic mix (``traffic/<traffic>.json``, read by
``frames.make_states``).  Set-up makes the cycle of frame states on the
card from the seed, hands each over as the program's ``FluidState``, and
runs the traffic's warm-up frames (the first one builds the kernels in a
fresh checkout and probes the grid).  The window is a closed loop with one
caller: each frame is handed over when the last one has returned and the
device is synchronized, for ``--seconds``.  Then a sample of the window's
frames, drawn from the seed, is held to the plain reference
(``reference/``), and the last line of standard output is the result.

``--trace 1`` passes ``stage_times`` to every frame (synchronized stage
walls, and a count of each stage's entries), runs ``torch.profiler`` over
the window's first frames (about ``TRACE_SECONDS``), and reports the
per-layer metrics, each read by ``metrics/<name>.py``.

Without a CUDA device, or with fewer than the cell asks for, it prints no
result and exits 2.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import collections  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Callable, Dict, NamedTuple, Optional  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# the program's and the profiler's caches stay inside the checkout, at fixed paths
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ.setdefault(var, str(ROOT / "build" / sub))
for p in (str(HERE), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

import check  # noqa: E402
import devtrace  # noqa: E402
import frames  # noqa: E402
from reference.config import SolverConfig as RefConfig  # noqa: E402
from reference.solve import reference_frame  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "adaptiveviscositysolver_tpu")
TRACE_SECONDS = 6.0
# CPU threads of the run's process: a frame's host work is Python and kernel
# launches, and idle pool threads only take cores from it
HOST_THREADS = 1


def load_json(path: Path):
    with open(path) as fh:
        return json.load(fh)


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(f"bench_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def find_cell(bench: Dict, workload: str):
    """(cell, configuration, traffic) of a workload of ``BENCHMARK.json``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[workload]
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = load_json(ROOT / conf["file"])
    traffic = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    return cell, config, traffic


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def dt_of(config: Dict) -> float:
    """The configuration's step, rounded to its dtype as the program gets it."""
    return float(torch.tensor(float(config["dt"]), dtype=frames.DTYPES[config["dtype"]]))


class Setting(NamedTuple):
    """A solver setting a configuration file may state: its ``key`` sets
    the program's ``SolverConfig`` field ``field``, of type ``kind``, and
    the reference's too where ``reference``."""
    key: str
    field: str
    kind: type
    reference: bool


# The solver settings a configuration file may state; a key it leaves out
# takes the field's default.  The fields' dtype (the configuration's
# ``dtype``, which ``frames`` reads) is the solve's, so ``SolverConfig.dtype``
# stays None.  Refinement is the program's route to the reference's stopping
# rule, not another answer: the reference stays a float64 Jacobi CG.
SETTINGS = (
    Setting("octree_levels", "octree_levels", int, True),
    Setting("tolerance", "tolerance", float, True),
    Setting("max_iterations", "max_iterations", int, True),
    Setting("cheb_degree", "cheb_degree", int, False),
    Setting("use_iterative_refinement", "use_iterative_refinement", bool, False),
)


def _typed(key: str, kind: type, value):
    # a JSON true is an int to Python: no count is a switch, and no switch a count
    accepts = {bool: bool, int: int, float: (int, float)}[kind]
    if isinstance(value, bool) != (kind is bool) or not isinstance(value, accepts):
        raise ValueError(f"configuration key {key!r}: {value!r} is not a {kind.__name__}")
    return kind(value)


def settings(config: Dict, reference: bool = False) -> Dict[str, object]:
    """field -> value of each setting in ``SETTINGS`` that the
    configuration states (the reference's only, with ``reference``)."""
    return {s.field: _typed(s.key, s.kind, config[s.key]) for s in SETTINGS
            if s.key in config and (s.reference or not reference)}


def solver_config(config: Dict):
    """The program's ``SolverConfig`` of a configuration.  Refuses, naming
    the key, what a run would silently ignore: a ``SolverConfig`` field
    that ``SETTINGS`` does not pass on, a Chebyshev degree under
    refinement (the program ignores it there), and refinement of a float32
    configuration (its residual would be formed in float32)."""
    from adaptiveviscositysolver_tpu_torch import SolverConfig

    passed = {s.key for s in SETTINGS} | {"dtype"}
    for f in dataclasses.fields(SolverConfig):
        if f.name in config and f.name not in passed:
            raise ValueError(f"configuration key {f.name!r} is a SolverConfig field the "
                             f"benchmark does not pass to the program")
    kw = settings(config)
    if kw.get("use_iterative_refinement"):
        if kw.get("cheb_degree", 1) > 1:
            raise ValueError("configuration key 'cheb_degree' > 1 with "
                             "'use_iterative_refinement': refinement ignores the degree")
        if config["dtype"] == "float32":
            raise ValueError("configuration key 'use_iterative_refinement' on a float32 "
                             "configuration: refinement needs a wider dtype")
    return SolverConfig(**kw)


def reference_config(config: Dict) -> RefConfig:
    return RefConfig(**settings(config, reference=True))


def fluid_state(s: Dict[str, object]):
    from adaptiveviscositysolver_tpu_torch import FluidState

    return FluidState(liquid_sdf=s["liquid_sdf"], solid_sdf=s["solid_sdf"],
                      velocity=s["velocity"], solid_velocity=s["solid_velocity"],
                      viscosity=s["viscosity"], density=s["density"], dx=s["dx"])


class StageLog(dict):
    """The ``stage_times`` dict handed to the program: stage -> seconds,
    and ``entries``: how often each stage was timed (a ``solve`` entry per
    dispatch)."""

    def __init__(self):
        super().__init__()
        self.entries = collections.Counter()

    def __setitem__(self, key, value):
        self.entries[key] += 1
        super().__setitem__(key, value)


def quiet_host() -> None:
    """One process with few threads: torch's intra-op and inter-op CPU
    pools cut to ``HOST_THREADS`` before any CUDA work."""
    torch.set_num_threads(HOST_THREADS)
    try:
        torch.set_num_interop_threads(HOST_THREADS)
    except RuntimeError:  # the pool has started already (tests, the control)
        pass


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


def quantile(values, q: float) -> float:
    """The q-quantile of ``values`` (linear between order statistics)."""
    v = sorted(values)
    if len(v) == 1:
        return v[0]
    return statistics.quantiles(v, n=100, method="inclusive")[round(q * 100) - 1]


def run_cell(cell: Dict, config: Dict, traffic: Dict, seed: int, seconds: float, trace: bool,
             device, make_solver: Optional[Callable] = None, trace_dir: Optional[Path] = None,
             per_layer=()) -> Dict[str, object]:
    """One run of a cell; returns the result line's fields, with ``checks``
    last.  ``make_solver``: the program's factory by default (tests and the
    control hand in another).  ``per_layer``: the ``per_layer`` entries of
    the cell, read when ``trace``."""
    dev = torch.device(device)
    cfg = solver_config(config)   # refuses a setting the run would ignore, before set-up
    if make_solver is None:
        from adaptiveviscositysolver_tpu_torch import make_solver
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    states = frames.make_states(config, traffic, seed, dev)
    handed = [fluid_state(s) for s in states]
    dt = dt_of(config)
    solve = make_solver(cfg, device=dev)
    cycle = len(handed)
    pos = 0
    for _ in range(int(traffic["warmup_frames"])):
        solve(handed[pos % cycle], dt)
        pos += 1
    sync(dev)

    # the window
    rng = random.Random(int(seed))
    keep = int(config["check_frames"])
    held = []
    records = []
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        prof = profile(activities=acts)
    if prof is not None:
        prof.__enter__()
    profiling = prof is not None
    # set-up's objects leave the collector's generations, and no collection
    # pauses a frame: the window allocates little that a cycle holds
    gc.collect()
    gc.freeze()
    gc.disable()
    setup_s = time.perf_counter() - T_START
    t0 = time.perf_counter()
    t_end = t0
    while True:
        start = time.perf_counter()
        if records and start - t0 >= seconds:
            break
        idx = pos % cycle
        log = StageLog() if trace else None
        if profiling:
            with torch.profiler.record_function(devtrace.FRAME_SPAN):
                out = solve(handed[idx], dt, stage_times=log)
                sync(dev)
        else:
            out = solve(handed[idx], dt, stage_times=log)
            sync(dev)
        t_end = time.perf_counter()
        n = len(records)
        st = out.stats
        rec = {"wall_s": t_end - start, "state": idx, "iterations": int(st.iterations),
               "levels": len(st.active_cells), "path": getattr(st, "solve_path", None),
               "profiled": profiling}
        if trace:
            rec["stage_s"] = dict(log)
            rec["entries"] = dict(log.entries)
            info = getattr(solve, "cache_info", None)
            rec["windows"] = info()["windows"].get(rec["levels"]) if info else None
        records.append(rec)
        item = {"frame": n, "state": idx, "velocity": out.velocity,
                "stats": {"iterations": st.iterations, "residual": st.residual,
                          "octree_dofs": st.octree_dofs, "regular_dofs": st.regular_dofs,
                          "active_cells": list(st.active_cells)}}
        if len(held) < keep:
            held.append(item)
        else:
            j = rng.randrange(n + 1)
            if j < keep:
                held[j] = item
        del out, item
        pos += 1
        if profiling and t_end - t0 >= TRACE_SECONDS:
            prof.__exit__(None, None, None)
            profiling = False
    gc.enable()
    gc.unfreeze()
    if profiling:
        prof.__exit__(None, None, None)
    window_s = t_end - t0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    walls_ms = [r["wall_s"] * 1e3 for r in records]
    e2e = {"setup_s": (setup_s, "s"),
           "frame_ms": (window_s * 1e3 / max(1, len(records)), "ms"),
           "frame_p90_ms": (quantile(walls_ms, 0.9), "ms") if walls_ms else None,
           "peak_mem_gib": (peak / 2**30, "GiB")}
    result: Dict[str, object] = {"attempted": len(records)}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": int(cell.get("chips", 1)), "memory_peak_bytes": int(peak)}
    breakdown = None
    if trace:
        summary = {"frames": [], "busy_s": None, "window_s": None, "breakdown": None}
        if prof is not None:
            trace_dir = trace_dir or ROOT / "build" / "bench_trace"
            trace_dir.mkdir(parents=True, exist_ok=True)
            path = trace_dir / "trace.json"
            prof.export_chrome_trace(str(path))
            del prof
            try:
                summary = devtrace.summarize(*devtrace.load(path))
            finally:
                path.unlink(missing_ok=True)
        unprofiled = [r for r in records if not r["profiled"]]
        run = {"frames": records, "timing_frames": unprofiled or records, "trace": summary,
               "profiled_frames": [r for r in records if r["profiled"]]}
        metrics = {}
        for m in per_layer:
            value = load_module(HERE / "metrics" / f"{m['name']}.py").read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if summary["busy_s"] is not None:
            device_info.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        breakdown = summary["breakdown"]
    else:
        metrics = {k: {"value": v[0], "unit": v[1]} for k, v in e2e.items() if v is not None}
    if dev.type == "cuda":
        device_info["power"] = power_limit()

    # the check, once the program's state is freed
    del solve, handed
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref_cfg = reference_config(config)
    readings = []
    t_ref = time.perf_counter()
    for item in held:
        ref = reference_frame(states[item["state"]], dt, ref_cfg)
        readings.append(check.compare(item["velocity"], item["stats"], ref))
        del ref
    limits = {k: float(v) for k, v in config["limits"].items()}
    worst = check.worst(readings) if readings else {n: math.nan for n in check.NAMES}
    failed = sum(1 for r in readings if not check.passes(r, limits))
    result.update(correct=bool(readings) and failed == 0, failed=failed, metrics=metrics,
                  device=device_info)
    if breakdown is not None:
        result["breakdown"] = breakdown
    print(f"frame walls ms {[round(w, 1) for w in walls_ms]}; iterations "
          f"{[r['iterations'] for r in records]}; solve paths "
          f"{sorted({str(r['path']) for r in records})}; checked frames "
          f"{[item['frame'] for item in held]}; reference {time.perf_counter() - t_ref:.2f} s",
          file=sys.stderr)
    result["checks"] = {n: {"value": worst[n] if math.isfinite(worst[n]) else str(worst[n]),
                            "limit": limits[n]} for n in check.NAMES}
    return result


def cell_metrics(bench: Dict, workload: str, kind: str):
    """The cell's entries of ``end_to_end`` or ``per_layer``."""
    return [m for m in bench[kind] if workload in m.get("workloads", [workload])]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = load_json(ROOT / "BENCHMARK.json")
    cell, config, traffic = find_cell(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"correct: false (the cell needs {cell['chips']} CUDA device(s), found {have}; "
              "the benchmark does not run on the CPU)", file=sys.stderr)
        return 2
    quiet_host()
    per_layer = cell_metrics(bench, args.workload, "per_layer") if args.trace else ()
    result = run_cell(cell, config, traffic, args.seed, args.seconds, bool(args.trace), "cuda",
                      per_layer=per_layer)
    if not args.trace:
        wanted = {m["name"] for m in cell_metrics(bench, args.workload, "end_to_end")}
        result["metrics"] = {k: v for k, v in result["metrics"].items() if k in wanted}
    found = forbidden_modules()
    if found:
        print(f"loaded modules of JAX or the JAX package: {found}", file=sys.stderr)
        return 3
    if result["device"].get("power"):
        print(f"card: {result['device']['power']}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
