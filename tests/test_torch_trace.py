"""The port's spans (``utils/trace.py``) on the CPU: what the CG, the fused
apply and make_solver's closure write to a caller's ``stage_times``, what
reaches a profiler, and that with neither nothing is entered and the
solve is unchanged.  16^3 scenes, ``cuda-plain`` (the fused apply's plain
version) and ``v1``."""

import collections
import dataclasses
import json

import numpy as np
import pytest
import torch

from adaptiveviscositysolver_tpu_torch import convert, scenes, solver
from adaptiveviscositysolver_tpu_torch.config import SolverConfig
from adaptiveviscositysolver_tpu_torch.utils import trace

CG_SPANS = ("cg.apply", "cg.vector", "cg.precond", "cg.converged")
APPLY_SPANS = ("apply.views", "apply.kernels", "apply.join")
# the card's graphed apply (operator.ApplyGraph): never on CPU tensors
GRAPH_SPANS = ("apply.capture", "apply.replay")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The suite runs in parallel processes: one thread each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class Counting(dict):
    """A ``stage_times`` dict that counts its writes, as the benchmark's."""

    def __init__(self):
        super().__init__()
        self.entries = collections.Counter()

    def __setitem__(self, key, value):
        self.entries[key] += 1
        super().__setitem__(key, value)


def _cfg(impl, cheb=1):
    return SolverConfig(octree_levels=3, tolerance=1e-5, max_iterations=400,
                        dtype=torch.float32, apply_impl=impl, cheb_degree=cheb)


@pytest.fixture(scope="module")
def beam16():
    return scenes.beam(n=16, device="cpu")


@pytest.mark.parametrize("impl,path", [("cuda", "cuda-plain"), ("auto", "v1")])
@pytest.mark.parametrize("cheb", [1, 3], ids=["jacobi", "cheb3"])
def test_span_entries_count_the_work(beam16, impl, path, cheb):
    log = Counting()
    out = solver.solve_viscosity(beam16, 0.02, _cfg(impl, cheb), device="cpu",
                                 stage_times=log)
    st, n = out.stats, log.entries
    assert st.solve_path == path
    assert n["cg.apply"] == st.applies > st.iterations > 16
    assert n["cg.converged"] == st.iterations + 1
    assert n["cg.vector"] == 2 * st.iterations and n["cg.precond"] == st.iterations
    assert n["solve"] == 1
    assert not any(s in n for s in GRAPH_SPANS), n
    if path == "cuda-plain":
        assert all(n[s] == n["cg.apply"] for s in APPLY_SPANS), n
        assert n["topology.build"] == 1
    else:
        assert not any(s in n for s in APPLY_SPANS + ("topology.build",)), n
    # the sink holds summed seconds; the CG's child spans make up its stage
    assert all(log[s] > 0 for s in CG_SPANS)
    if cheb == 1:
        assert sum(log[s] for s in CG_SPANS) <= log["solve"]


def test_off_enters_no_record_function_and_changes_nothing(beam16, monkeypatch):
    def boom(self):
        raise RuntimeError("record_function entered")

    monkeypatch.setattr(torch.autograd.profiler.record_function, "__enter__", boom)
    assert trace.span("cg.apply") is trace.span("apply.join") is trace.stage("solve")
    cfg = _cfg("cuda")
    plain = solver.make_solver(cfg, device="cpu")(beam16, 0.02)
    log = Counting()
    logged = solver.make_solver(cfg, device="cpu")(beam16, 0.02, stage_times=log)
    assert log.entries["cg.apply"] == logged.stats.applies
    assert plain.stats.iterations == logged.stats.iterations
    for a in range(3):
        assert torch.equal(plain.velocity[a], logged.velocity[a]), a
    # the patch is live: a profiler does enter record_function
    with pytest.raises(RuntimeError, match="record_function entered"):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            with trace.span("cg.apply"):
                pass


def _annotations(prof, tmp_path):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = collections.defaultdict(list)
    for e in events:
        if e.get("cat") == "user_annotation" and "dur" in e:
            spans[e["name"]].append((e["ts"], e["ts"] + e["dur"]))
    return {k: sorted(v) for k, v in spans.items()}


def test_profiler_sees_every_sixteenth_iteration(beam16, tmp_path):
    log = Counting()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = solver.solve_viscosity(beam16, 0.02, _cfg("cuda"), device="cpu",
                                     stage_times=log)
    spans = _annotations(prof, tmp_path)
    iters = out.stats.iterations
    sampled = len(range(0, iters, trace.PROFILE_EVERY))
    assert iters > 2 * trace.PROFILE_EVERY
    # the apply before the loop, then iterations 0, 16, 32, ...
    assert len(spans["cg.apply"]) == len(spans["apply.kernels"]) == 1 + sampled
    assert len(spans["cg.vector"]) == 2 * sampled and len(spans["cg.precond"]) == sampled
    assert len(spans["cg.converged"]) == len(range(0, iters + 1, trace.PROFILE_EVERY))
    # the sink still sees every iteration
    assert log.entries["cg.apply"] == out.stats.applies == iters + 1
    ((s0, s1),) = spans["solve"]
    for a, b in spans["cg.apply"] + spans["cg.converged"]:
        assert s0 <= a <= b <= s1
    for a, b in spans["apply.kernels"]:
        assert any(c <= a <= b <= d for c, d in spans["cg.apply"])
    # a sampled iteration's stop test comes before its apply
    starts = [a for a, _ in spans["cg.apply"][1:]]
    tests = [a for a, _ in spans["cg.converged"]]
    assert all(t < s for t, s in zip(tests, starts))
    assert all(s < t for s, t in zip(starts, tests[1:]))


def _beam_state(n, dy):
    """The beam scene's box moved by ``dy`` along y."""
    dx = 1.0 / n
    x = (np.arange(n) + 0.5) * dx
    X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
    lo, hi = np.array([0.05, 0.55 + dy, 0.35]), np.array([0.65, 0.75 + dy, 0.65])
    d = np.maximum(lo - np.stack([X, Y, Z], -1), np.stack([X, Y, Z], -1) - hi)
    liquid = np.sqrt((np.maximum(d, 0) ** 2).sum(-1)) + np.minimum(d.max(-1), 0.0)
    fshapes = [tuple(n + (1 if k == a else 0) for k in range(3)) for a in range(3)]
    vel = [np.zeros(s) for s in fshapes]
    vel[1] = -0.8 * np.clip((x - 0.1) / 0.5, 0.0, 1.0).reshape(n, 1, 1) * np.ones(fshapes[1])
    return convert.fluid_state_from_numpy(
        liquid, X - 0.08, vel, [np.zeros(s) for s in fshapes], np.full(liquid.shape, 5.0),
        np.ones(liquid.shape), dx, device="cpu", dtype=torch.float32)


def test_make_solver_counts_resolves_and_builds():
    """The beam drops 4 cells: the second frame escapes the windows carried
    from the first and is solved again on a new topology; the third, at
    rest, reuses it."""
    cfg = dataclasses.replace(_cfg("cuda"), tolerance=1e-3)
    solve = solver.make_solver(cfg, device="cpu")
    resolves, builds = [], []
    for i, dy in enumerate((0.0, -0.25, -0.25)):
        before = solve.cache_info()["programs"]
        log = Counting()
        solve(_beam_state(16, dy), 0.02, stage_times=log)
        n = log.entries
        assert n["resolve"] == n["solve"] - 1, (i, n)
        assert n["topology.build"] == solve.cache_info()["programs"] - before, (i, n)
        assert ("probe" in log) == (i == 0)
        resolves.append(n["resolve"])
        builds.append(n["topology.build"])
    assert resolves == [0, 1, 0] and builds == [1, 1, 0], (resolves, builds)
