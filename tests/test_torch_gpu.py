"""The port's per-level kernels on a CUDA card (tau_level, dt_level), the
all-level kernels (fused_tau, fused_dt) and its probe kernels (banded_apply,
stream_floor) against their plain versions, a
routed solve, a Chebyshev solve and two FLIP frames on the card against the
same on the CPU, refined float64 solves against the float64 v1 solve,
make_solver's cached topology on the card against fresh solves, the
sharded solve on 2 gloo ranks sharing the card (buckling-32 on both routes,
buckling-192) against the single-device card solve, and the Jacobi CG's
vector-update kernels (cg_update, cg_jacobi, cg_direction) against their
plain versions and, in make_solver's solves, against the CG loop of
PyTorch ops.

Nothing here imports JAX, so this file also runs on a machine that has a
card and no JAX; there the suite's conftest (which sets JAX up) is left out:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py

Without a card every test skips.  The inputs are the port's own
buckling-32 frame, and beam-48 on make_solver's crop windows, whose boxes
the tau and D^T tiles divide on no axis; routes are forced per level
(``fused_apply.route_canons`` and ``make_fused_operator(modes=)``, or
``fused_apply.route_budget`` patched for a whole solve).  Bar: 3e-5 *
max|plain| per level, brick and output (float32, sums in another order),
as in chip_smoke.py.
"""

import dataclasses
import re
from pathlib import Path

import pytest
import torch

from adaptiveviscositysolver_tpu_torch import operator, scenes, solver
from adaptiveviscositysolver_tpu_torch.config import SolverConfig
from adaptiveviscositysolver_tpu_torch.ops import cg_update as cg
from adaptiveviscositysolver_tpu_torch.ops import fused_apply as fa
from adaptiveviscositysolver_tpu_torch.ops import probes

TOL = 3e-5
DT = 1.0 / 24.0
ROUTES = {"brick-split-fused": [("brick", 6), "split", "fused"],
          "split-brick-brick": ["split", ("brick", 4), ("brick", 2)]}


def _close(got, want, what):
    for n in want:
        scale = max(float(want[n].abs().max()), 1e-30)
        err = float((got[n] - want[n]).abs().max())
        assert err <= TOL * scale, (what, n, err, scale)


@pytest.fixture(scope="module")
def card_frame():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    state = scenes.buckling(n=32, device="cuda")
    sys_ = solver.build_system(state, DT, SolverConfig(octree_levels=3), device="cuda")
    g = torch.Generator(device="cpu").manual_seed(0)
    u_log = {k: torch.randn(m.shape, generator=g).to("cuda") * m for k, m in sys_.active.items()}
    return sys_, u_log, state.dx


def _routed(card_frame, route):
    sys_, u_log, dx = card_frame
    modes = ROUTES[route]
    canons = fa.route_canons(sys_.canons, modes)
    apply_A, _, _ = fa.make_fused_operator(sys_.frame, canons, sys_.active, sys_.res_per_level,
                                           dx, True, modes=modes)
    args = apply_A.level_args(sys_.embed_tree(u_log))
    return [(l, args[l], apply_A.metas[l], canons[l]) for l, m in enumerate(modes)
            if m != "fused"]


def _tau(meta, rows):
    """Weighted-stress buffers of x rows ``rows``, NaN: an element the
    kernel does not write fails the comparison."""
    return {n: torch.full((rows[1] - rows[0],) + tuple(meta.shape[1:]), float("nan"),
                          device="cuda") for n in fa.TAU_NAMES}


def _tiles():
    """The tau and D^T kernels' tile extents (csrc's defaults)."""
    csrc = Path(fa.__file__).resolve().parent.parent / "csrc"
    return [tuple(int(re.search(rf"#define AVS_{k}_T{ax} (\d+)", (csrc / src).read_text())
                      .group(1)) for ax in "XYZ")
            for k, src in (("TAU", "tau_tile.cuh"), ("DT", "dt_tile.cuh"))]


@pytest.fixture(scope="module")
def cropped_frame():
    """beam-48 through make_solver's probe and crop windows (2 levels): every
    level's box has a tile edge inside it on every axis."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    state = scenes.beam(n=48, device="cuda")
    lv, windows = solver.probe_topology(state, SolverConfig(octree_levels=3), device="cuda")
    sys_ = solver.build_system(state, DT, SolverConfig(octree_levels=lv), device="cuda",
                               bboxes=windows, pad_levels=3)
    assert lv == 2 and all(c.shape[d] % t[d] for t in _tiles() for c in sys_.canons
                           for d in range(3)), [c.shape for c in sys_.canons]
    g = torch.Generator(device="cpu").manual_seed(4)
    u_log = {k: torch.randn(m.shape, generator=g).to("cuda") * m for k, m in sys_.active.items()}
    return sys_, u_log, state.dx


def _nan_outputs(meta):
    return {n: torch.full(meta.shape, float("nan"), device="cuda")
            for n in fa._dt_output_names(meta)}


def _out_masked(got, args, meta, what):
    """out is exactly 0 off the FLUID faces (pads included)."""
    for f in range(3):
        fluid = fa._code(args, f"vk{f}", meta.has_parent) == 0
        assert not bool(got[f"out{f}"][~fluid].any()), (what, f)


def _level_routes(frame, route):
    if route in ROUTES:
        return _routed(frame, route)
    # the cropped frame: each level whole, and in 6-row bricks (tile edges
    # inside every brick)
    sys_, u_log, _ = frame
    args = sys_.apply_A.level_args(sys_.embed_tree(u_log))
    return [(l, args[l], sys_.apply_A.metas[l], dataclasses.replace(c, brick=brick))
            for l, c in enumerate(sys_.canons) for brick in (None, 6)]


@pytest.mark.gpu
@pytest.mark.parametrize("route", sorted(ROUTES) + ["cropped"])
def test_tau_level_matches_plain_on_card(card_frame, cropped_frame, route):
    """tau_level against plain_tau_level on every x-row range (the rows
    tau_rows gives each), buffers prefilled with NaN (every element of the
    rows is written)."""
    frame = cropped_frame if route == "cropped" else card_frame
    for l, args, meta, canon in _level_routes(frame, route):
        for rows in canon.row_ranges():
            t = fa.tau_rows(rows, meta.shape[0])
            before = fa.launch_counts["tau_level"]
            got = fa.tau_level(args, meta, True, t, _tau(meta, t))
            assert fa.launch_counts["tau_level"] == before + 1
            _close(got, fa.plain_tau_level(args, meta, True, t, _tau(meta, t)),
                   (route, l, canon.brick, t))


@pytest.mark.gpu
@pytest.mark.parametrize("route", sorted(ROUTES) + ["cropped"])
def test_dt_level_matches_plain_on_card(card_frame, cropped_frame, route):
    """dt_level against plain_dt_level on every x-row range, outputs
    prefilled with NaN (every element of the rows is written), out exactly
    0 off the FLUID faces (pads included)."""
    frame = cropped_frame if route == "cropped" else card_frame
    for l, args, meta, canon in _level_routes(frame, route):
        got, want = _nan_outputs(meta), fa.dt_outputs(meta, "cuda")
        for rows in canon.row_ranges():
            t = fa.tau_rows(rows, meta.shape[0])
            tau = fa.plain_tau_level(args, meta, True, t, _tau(meta, t))
            before = fa.launch_counts["dt_level"]
            fa.dt_level(args, tau, t[0], meta, True, rows, got)
            assert fa.launch_counts["dt_level"] == before + 1
            fa.plain_dt_level(args, tau, t[0], meta, True, rows, want)
        _close(got, want, (route, l, canon.brick))
        _out_masked(got, args, meta, (route, l, canon.brick))


@pytest.mark.gpu
@pytest.mark.parametrize("frame", ["buckling-32", "cropped"])
def test_fused_tau_matches_plain_on_card(card_frame, cropped_frame, frame):
    """fused_tau over every level in one launch against _plain_tau, buffers
    prefilled with NaN."""
    sys_, u_log, dx = cropped_frame if frame == "cropped" else card_frame
    apply_A = sys_.apply_A
    args = apply_A.level_args(sys_.embed_tree(u_log))
    metas = apply_A.metas
    before = fa.launch_counts["fused_tau"]
    got = fa.fused_tau(args, metas, True, out=[_tau(m, (0, m.shape[0])) for m in metas])
    assert fa.launch_counts["fused_tau"] == before + 1
    for l, (g, w) in enumerate(zip(got, fa._plain_tau(args, metas, True))):
        _close(g, w, (frame, l))


@pytest.mark.gpu
@pytest.mark.parametrize("frame", ["buckling-32", "cropped"])
def test_fused_dt_matches_plain_on_card(card_frame, cropped_frame, frame):
    """fused_dt over every level in one launch against _plain_dt on the same
    weighted stresses, outputs prefilled with NaN."""
    sys_, u_log, dx = cropped_frame if frame == "cropped" else card_frame
    apply_A = sys_.apply_A
    args = apply_A.level_args(sys_.embed_tree(u_log))
    metas = apply_A.metas
    taus = fa._plain_tau(args, metas, True)
    before = fa.launch_counts["fused_dt"]
    got = fa.fused_dt(args, taus, metas, True, out=[_nan_outputs(m) for m in metas])
    assert fa.launch_counts["fused_dt"] == before + 1
    for l, (g, w) in enumerate(zip(got, fa._plain_dt(args, taus, metas, True))):
        _close(g, w, (frame, l))
        _out_masked(g, args[l], metas[l], (frame, l))


@pytest.mark.gpu
def test_routed_solve_on_card_matches_cpu(monkeypatch):
    """A buckling-32 solve whose budget bricks level 0 and splits level 1,
    on the card (the level kernels launched), against the solve on the CPU
    (every level fused, the plain versions): iterations within +-2,
    velocity within rel 5e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    state = scenes.buckling(n=32, device="cpu")
    cfg = SolverConfig(octree_levels=3, tolerance=1e-5, apply_impl="cuda")
    canons = solver.build_system(state, DT, cfg, device="cpu").canons
    budget = fa.tau_bytes(canons[1])
    modes = fa.level_modes(canons, budget)
    assert modes[0][0] == "brick" and modes[1] == "split", modes
    monkeypatch.setattr(fa, "route_budget", lambda device: budget)
    fa.reset_launch_counts()
    got = solver.solve_viscosity(state, DT, cfg, device="cuda")
    ranges = len(fa.route_canons(canons, modes)[0].row_ranges()) + 1
    assert fa.launch_counts["tau_level"] == fa.launch_counts["dt_level"] == \
        got.stats.applies * ranges
    monkeypatch.undo()
    want = solver.solve_viscosity(state, DT, cfg, device="cpu")
    assert got.stats.solve_path == "cuda" and want.stats.solve_path == "cuda-plain"
    assert abs(got.stats.iterations - want.stats.iterations) <= 2
    scale = max(float(v.abs().max()) for v in want.velocity)
    for a in range(3):
        assert float((got.velocity[a].cpu() - want.velocity[a]).abs().max()) / scale < 5e-4


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
@pytest.mark.parametrize("shape,nb", [((104, 112, 128), 15), ((3, 10, 8), 5), ((2, 1, 4), 3),
                                      ((2, 2, 4), 1)])
def test_banded_apply_matches_plain_on_card(shape, nb):
    """T1 on the tool's box and on boxes whose y extent is not a multiple of
    the shifts (the roll wraps), against torch.roll's plain version."""
    _need_card()
    g = torch.Generator().manual_seed(nb)
    u = torch.randn(shape, generator=g).cuda()
    coeffs = [torch.randn(shape, generator=g).cuda() for _ in range(nb)]
    before = probes.launch_counts["banded_apply"]
    got = probes.banded_apply(u, coeffs)
    assert probes.launch_counts["banded_apply"] == before + 1
    _close({"out": got}, {"out": probes.plain_banded_apply(u, coeffs)}, (shape, nb))


@pytest.mark.gpu
@pytest.mark.parametrize("i8_weight", [0.0, 1.0])
def test_stream_floor_matches_plain_on_card(card_frame, i8_weight):
    """T2 over level 0 of buckling-32: the float32 inputs summed on the
    window rows (with the int8 bytes' sum when the weight is 1), pad rows
    exactly 0."""
    sys_, u_log, _ = card_frame
    args = sys_.apply_A.level_args(sys_.embed_tree(u_log))
    inputs = probes.floor_inputs(args[0], sys_.apply_A.metas[0])
    rows = probes.window_rows(sys_.canons[0])
    got = probes.stream_floor(inputs, rows, i8_weight)
    want = probes.plain_stream_floor(inputs, rows, i8_weight)
    for k in range(3):
        _close({"out": got[k]}, {"out": want[k]}, (i8_weight, k))
        assert not bool(got[k][:rows[0]].any()) and not bool(got[k][rows[1]:].any())


@pytest.mark.gpu
def test_cached_make_solver_on_card_matches_fresh_solves():
    """Two frames of the same topology and other data through one
    make_solver (the second reuses the cached boxes, routes and buffers)
    equal each frame solved by a fresh make_solver."""
    _need_card()
    cfg = SolverConfig(octree_levels=3, tolerance=1e-5)
    first = scenes.buckling(n=32, device="cuda")
    second = scenes.buckling(n=32, viscosity=35.0, device="cuda")
    second = dataclasses.replace(second, velocity=tuple(0.5 * v for v in second.velocity))
    solve = solver.make_solver(cfg, device="cuda")
    got = [solve(first, DT), solve(second, DT)]
    assert solve.cache_info()["programs"] == 1
    for res, state in zip(got, (first, second)):
        want = solver.make_solver(cfg, device="cuda")(state, DT)
        assert res.stats.solve_path == want.stats.solve_path == "cuda"
        assert res.stats.iterations == want.stats.iterations
        scale = max(float(v.abs().max()) for v in want.velocity)
        for a in range(3):
            assert float((res.velocity[a] - want.velocity[a]).abs().max()) <= 1e-6 * scale


@pytest.mark.gpu
def test_chebyshev_solve_on_card_matches_cpu():
    """cheb_degree=3 through the kernels on buckling-32 against the same
    solve through their plain version on the CPU: the fused pair launched
    once per apply (13 + 1 + 2 + 3 per iteration), iterations within +-2,
    velocity within rel 5e-4."""
    _need_card()
    state = scenes.buckling(n=32, device="cpu")
    cfg = SolverConfig(octree_levels=3, tolerance=1e-5, apply_impl="cuda", cheb_degree=3)
    fa.reset_launch_counts()
    got = solver.solve_viscosity(state, DT, cfg, device="cuda")
    assert got.stats.solve_path == "cuda"
    assert got.stats.applies == 13 + 1 + 2 + 3 * got.stats.iterations
    assert fa.launch_counts["fused_tau"] == fa.launch_counts["fused_dt"] == got.stats.applies
    want = solver.solve_viscosity(state, DT, cfg, device="cpu")
    assert abs(got.stats.iterations - want.stats.iterations) <= 2
    assert got.stats.residual <= 1e-5
    scale = max(float(v.abs().max()) for v in want.velocity)
    for a in range(3):
        assert float((got.velocity[a].cpu() - want.velocity[a]).abs().max()) / scale < 5e-4


@pytest.mark.gpu
def test_refined_solve_on_card_runs_the_kernels():
    """A float64 refined solve of buckling-32 on the card: the inner
    float32 applies launch the fused pair (the float64 residuals run v1),
    and the velocity lands within rel 1e-5 of the float64 v1 solve."""
    _need_card()
    state = scenes.buckling(n=32, dtype=torch.float64, device="cpu")
    cfg = SolverConfig(octree_levels=3, tolerance=1e-9)
    fa.reset_launch_counts()
    got = solver.solve_viscosity(state, DT, dataclasses.replace(
        cfg, use_iterative_refinement=True), device="cuda")
    assert got.stats.solve_path == "refined" and got.stats.residual <= 1e-9
    inner = fa.launch_counts["fused_tau"]
    assert fa.launch_counts["fused_dt"] == inner and got.stats.applies > inner > 0
    want = solver.solve_viscosity(state, DT, cfg, device="cuda")
    assert want.stats.solve_path == "v1"
    scale = max(float(v.abs().max()) for v in want.velocity)
    for a in range(3):
        assert float((got.velocity[a] - want.velocity[a]).abs().max()) / scale < 1e-5


@pytest.mark.gpu
def test_refined_solve_on_card_replays_the_inner_apply():
    """A float64 refined solve of buckling-32 on the card: its inner CGs
    run on the canonical grids and replay one graph (one capture, every
    inner apply after the first replayed), and the velocity lands within
    rel 1e-10 of the float64 v1 solve."""
    _need_card()
    state = scenes.buckling(n=32, dtype=torch.float64, device="cpu")
    cfg = SolverConfig(octree_levels=3, tolerance=1e-9)
    log = _Counting()
    got = solver.solve_viscosity(state, DT, dataclasses.replace(
        cfg, use_iterative_refinement=True), device="cuda", stage_times=log)
    st, n = got.stats, log.entries
    assert st.solve_path == "refined" and st.residual <= 1e-9
    assert n["apply.capture"] == 1 and 0 < n["apply.replay"] == n["cg.apply"] - 1
    assert n["cg.apply"] + n["refine.residual"] == st.applies
    want = solver.solve_viscosity(state, DT, cfg, device="cuda")
    assert want.stats.solve_path == "v1"
    scale = max(float(v.abs().max()) for v in want.velocity)
    for a in range(3):
        assert float((got.velocity[a] - want.velocity[a]).abs().max()) / scale <= 1e-10


@pytest.mark.gpu
def test_flip_loop_on_card_matches_cpu():
    """Two FLIP frames of buckling-32 on the card (the kernels' route)
    against the same frames on the CPU: every frame "cuda", iterations
    within +-2, velocity within rel 5e-4, the column falling."""
    from adaptiveviscositysolver_tpu_torch.models import flip

    _need_card()
    cfg = SolverConfig(octree_levels=3, tolerance=1e-5)
    got, stats = flip.simulate(scenes.buckling(n=32, device="cuda"), 2, DT, cfg, device="cuda")
    want, want_stats = flip.simulate(scenes.buckling(n=32, device="cpu"), 2, DT,
                                     dataclasses.replace(cfg, apply_impl="cuda"), device="cpu")
    for st, ws in zip(stats, want_stats):
        assert st.solve_path == "cuda" and st.residual <= 1e-5
        assert abs(st.iterations - ws.iterations) <= 2
    scale = max(float(v.abs().max()) for v in want.velocity)
    for a in range(3):
        assert got.velocity[a].is_cuda
        assert float((got.velocity[a].cpu() - want.velocity[a]).abs().max()) / scale < 5e-4
    assert float(got.velocity[1].mean()) < 0.0


def _per_apply_launches(canons, modes):
    """The launches of one apply: the fused pair if a level is fused, the
    level pair per x-row range of every split or bricked level."""
    fused = int("fused" in modes)
    ranges = sum(len(c.row_ranges()) for c, m in zip(fa.route_canons(canons, modes), modes)
                 if m != "fused")
    return {"fused_tau": fused, "fused_dt": fused, "tau_level": ranges, "dt_level": ranges}


@pytest.mark.gpu
@pytest.mark.parametrize("frame", ["bricked", "beam"])
def test_graphed_apply_matches_eager_on_card(card_frame, cropped_frame, frame):
    """The flat apply through operator.ApplyGraph (eager, then captured and
    replayed) equals the eager apply bit for bit on 6 different inputs:
    buckling-32 with level 0 in bricks and levels 1-2 fused (buckling-192's
    route), and the all-fused beam-48 on its crop windows; each call adds
    one apply's launches to the counts."""
    from adaptiveviscositysolver_tpu_torch import operator

    if frame == "bricked":
        sys_, _, dx = card_frame
        modes = [("brick", 6), "fused", "fused"]
        canons = fa.route_canons(sys_.canons, modes)
        apply_A, _, _ = fa.make_fused_operator(sys_.frame, canons, sys_.active,
                                               sys_.res_per_level, dx, True, modes=modes)
    else:
        sys_, _, _ = cropped_frame
        apply_A, canons, modes = sys_.apply_A, sys_.canons, sys_.modes
        assert set(modes) == {"fused"}, modes
    assert apply_A.capturable and apply_A.launch_counts is fa.launch_counts
    pack, unpack = operator.make_packer({k: tuple(v.shape)
                                         for k, v in sys_.embed_tree(sys_.rhs).items()})

    def flat(x):
        return pack(apply_A(unpack(x)))

    g = torch.Generator(device="cpu").manual_seed(11)
    xs = [pack(sys_.embed_tree({k: torch.randn(m.shape, generator=g).to("cuda") * m
                                for k, m in sys_.active.items()})) for _ in range(6)]
    want = [flat(x) for x in xs]
    per_apply = _per_apply_launches(canons, modes)
    graph = operator.ApplyGraph(flat, fa.launch_counts)
    try:
        for i, x in enumerate(xs):
            before = dict(fa.launch_counts)
            got = graph(x)
            assert {k: fa.launch_counts[k] - before[k] for k in before} == per_apply, i
            assert torch.equal(got, want[i]), (frame, i, float((got - want[i]).abs().max()))
        assert graph.graph is not None and got is graph.static_out
    finally:
        graph.release()


class _Counting(dict):
    """A ``stage_times`` dict that counts its writes, as the benchmark's."""

    def __init__(self):
        super().__init__()
        self.entries = {}

    def __setitem__(self, key, value):
        self.entries[key] = self.entries.get(key, 0) + 1
        super().__setitem__(key, value)


@pytest.mark.gpu
def test_solve_on_card_replays_the_apply(monkeypatch):
    """A buckling-32 solve on the card with level 0 bricked and level 1
    split: one capture, every apply after the first replayed (the spans'
    entries), launches = applies x launches of one apply, and the same
    iterations and velocity, bit for bit, as the solve with every apply
    eager."""
    _need_card()
    state = scenes.buckling(n=32, device="cuda")
    cfg = SolverConfig(octree_levels=3, tolerance=1e-5)
    canons = solver.build_system(scenes.buckling(n=32, device="cpu"), DT,
                                 dataclasses.replace(cfg, apply_impl="cuda"), device="cpu").canons
    budget = fa.tau_bytes(canons[1])
    modes = fa.level_modes(canons, budget)
    assert modes[0][0] == "brick" and modes[1] == "split", modes
    monkeypatch.setattr(fa, "route_budget", lambda device: budget)
    fa.reset_launch_counts()
    log = _Counting()
    got = solver.solve_viscosity(state, DT, cfg, device="cuda", stage_times=log)
    st, n = got.stats, log.entries
    assert st.solve_path == "cuda" and st.residual <= 1e-5
    assert n["cg.apply"] == st.applies == st.iterations + 1
    assert n["apply.capture"] == 1 and n["apply.replay"] == st.applies - 1
    assert n["apply.kernels"] == n["apply.views"] == n["apply.join"] == 2
    per_apply = _per_apply_launches(canons, modes)
    assert fa.launch_counts == {k: st.applies * v for k, v in per_apply.items()}

    make = fa.make_fused_operator

    def eager(*a, **kw):
        apply_A, embed_tree, crop_tree = make(*a, **kw)
        apply_A.capturable = False
        return apply_A, embed_tree, crop_tree

    monkeypatch.setattr(solver.fused_apply, "make_fused_operator", eager)
    log = _Counting()
    want = solver.solve_viscosity(state, DT, cfg, device="cuda", stage_times=log)
    assert "apply.capture" not in log.entries and "apply.replay" not in log.entries
    assert want.stats.iterations == st.iterations
    for a in range(3):
        assert torch.equal(got.velocity[a], want.velocity[a]), a


@pytest.mark.gpu
def test_repeated_solves_on_card_reserve_no_more_memory():
    """Frame after frame through one make_solver, each dispatch capturing
    its apply anew: from the third frame on the allocator reserves no more
    memory (each capture reuses the pool of the device's last one)."""
    _need_card()
    state = scenes.buckling(n=32, device="cuda")
    solve = solver.make_solver(SolverConfig(octree_levels=3, tolerance=1e-5), device="cuda")
    reserved = []
    for _ in range(6):
        log = _Counting()
        solve(state, DT, stage_times=log)
        assert log.entries["apply.capture"] == 1
        torch.cuda.synchronize()
        reserved.append(torch.cuda.memory_reserved())
    assert len(set(reserved[2:])) == 1, reserved


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["default", "bricked"])
def test_sharded_solve_on_card_matches_single_device(route):
    """buckling-32 on 2 gloo ranks sharing the card (the kernels on each
    rank's halo-filled local boxes; "bricked": a budget that puts level 0
    of a local box in bricks) against the single-device card solve:
    iterations within +-2, velocity within rel 5e-4, each rank's launches
    its applies times its x-row ranges."""
    from adaptiveviscositysolver_tpu_torch.ops import _build
    from adaptiveviscositysolver_tpu_torch.parallel import mesh, shard_fused

    _need_card()
    _build.build()   # once here, not in each rank
    cfg = SolverConfig(octree_levels=3, tolerance=1e-5)
    want = solver.solve_viscosity(scenes.buckling(n=32, device="cuda"), DT, cfg)
    budget = None
    if route == "bricked":
        budget = fa.tau_bytes(shard_fused.local_canons([(16, 32, 32)])[0]) / 3
    ranks = [r[0] for r in mesh.launch(2, mesh.solve_on_ranks, ("buckling", 32), DT, [cfg], 1,
                                       False, [budget], timeout=240)]
    st = ranks[0]["stats"]
    assert all(r["stats"] == st for r in ranks)
    assert st["solve_path"] == "cuda-sharded" and st["residual"] <= 1e-5
    assert abs(st["iterations"] - want.stats.iterations) <= 2
    for r in ranks:
        assert (route == "bricked") == r["modes"][0].startswith("('brick'"), r["modes"]
        n = st["applies"]
        assert r["launches"] == {"fused_tau": n * r["fused"], "fused_dt": n * r["fused"],
                                 "tau_level": n * r["row_ranges"],
                                 "dt_level": n * r["row_ranges"]}, r
    scale = max(float(v.abs().max()) for v in want.velocity)
    for a in range(3):
        got = ranks[0]["velocity"][a]
        assert float((torch.from_numpy(got) - want.velocity[a].cpu()).abs().max()) / scale < 5e-4


@pytest.mark.gpu
def test_sharded_192_frame_on_card_matches_single_device():
    """buckling-192, one frame on 2 gloo ranks sharing the card against the
    single-device frame: 4 levels, 820,288 / 2,209,612 DOFs, iterations
    within +-2, velocity within rel 5e-4 (the full-size case that does not
    fit chip_smoke.py's deadline; its seconds are printed)."""
    import time

    from adaptiveviscositysolver_tpu_torch.ops import _build
    from adaptiveviscositysolver_tpu_torch.parallel import mesh

    _need_card()
    _build.build()
    cfg = SolverConfig(octree_levels=4, tolerance=1e-4)
    t0 = time.perf_counter()
    want = solver.solve_viscosity(scenes.buckling(n=192, device="cuda"), DT, cfg)
    single_s = time.perf_counter() - t0
    ranks = [r[0] for r in mesh.launch(2, mesh.solve_on_ranks, ("buckling", 192), DT, [cfg],
                                       timeout=600)]
    st = ranks[0]["stats"]
    print(f"buckling-192: single-device frame {single_s:.2f} s (cold), 2 ranks sharing one "
          f"card {ranks[0]['seconds']} s, share in collectives "
          f"{[sum(r['collective_seconds'].values()) / r['seconds'][-1] for r in ranks]}, "
          f"{st['iterations']} it vs {want.stats.iterations}, routes {ranks[0]['modes']}")
    assert all(r["stats"] == st for r in ranks)
    assert st["solve_path"] == "cuda-sharded" and len(st["active_cells"]) == 4
    assert (st["octree_dofs"], st["regular_dofs"]) == (820288, 2209612)
    assert abs(st["iterations"] - want.stats.iterations) <= 2 and st["residual"] <= 1e-4
    scale = max(float(v.abs().max()) for v in want.velocity)
    for a in range(3):
        got = torch.from_numpy(ranks[0]["velocity"][a])
        assert float((got - want.velocity[a].cpu()).abs().max()) / scale < 5e-4


def _ulps(got, want):
    """|got - want| in units in the last place of float32 ``want``."""
    spacing = torch.nextafter(want.abs(), torch.tensor(float("inf"), device=want.device)) \
        - want.abs()
    return (got - want).abs() / spacing.clamp_min(torch.finfo(torch.float32).tiny)


def _cg_iteration(vec, rz, pap, blocks):
    """One iteration of the three CG kernels on copies of ``vec`` (x, r,
    p, ap, invd): the vectors, the partials and the scalars they leave."""
    x, r, p, ap, invd = (v.clone() for v in vec)
    z = torch.empty_like(r)
    rr_part = torch.full((blocks,), float("nan"), dtype=torch.float64, device="cuda")
    rz_part = rr_part.clone()
    rr, rz_new = torch.full((2,), float("nan"), device="cuda").unbind()
    cg.cg_update(x, r, p, ap, rz, pap, rr_part)
    cg.cg_jacobi(r, invd, z, rz_part)
    cg.cg_direction(z, p, rr_part, rz_part, rz, rr, rz_new)
    return {"x": x, "r": r, "z": z, "p": p, "rr_part": rr_part, "rz_part": rz_part,
            "rr": rr, "rz": rz_new}


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 4097, 20_000_003])
def test_cg_kernels_match_plain_on_card(n):
    """One iteration of cg_update, cg_jacobi and cg_direction against their
    plain versions on the same card tensors, at lengths that are not
    multiples of 4 (the tail): x, r, z and p within 2 ulp, rr and rz within
    1e-6 relative of a float64 sum of the kernels' own r and z, one launch
    each, and a second run equal bit for bit (partials included)."""
    _need_card()
    g = torch.Generator().manual_seed(n % 1000)
    vec = [torch.randn(n, generator=g).cuda() for _ in range(4)]
    vec.append((torch.rand(n, generator=g) + 0.5).cuda())
    rz, pap = torch.tensor([0.75, 1.5], device="cuda").unbind()
    blocks = cg.grid_blocks(n, "cuda")
    assert cg.partials(n, "cuda").numel() == blocks
    assert blocks == min(8 * torch.cuda.get_device_properties(0).multi_processor_count,
                         -(-n // 1024))
    before = dict(cg.launch_counts)
    got = _cg_iteration(vec, rz, pap, blocks)
    assert {k: cg.launch_counts[k] - before[k] for k in before} == dict.fromkeys(before, 1)
    x, r, p, ap, invd = (v.clone() for v in vec)
    z = torch.empty_like(r)
    part, part_z = (torch.zeros(1, dtype=torch.float64, device="cuda") for _ in range(2))
    rr, rz_new = torch.zeros(2, device="cuda").unbind()
    cg.plain_cg_update(x, r, p, ap, rz, pap, part)
    cg.plain_cg_jacobi(r, invd, z, part_z)
    cg.plain_cg_direction(z, p, part, part_z, rz, rr, rz_new)
    for name, want in (("x", x), ("r", r), ("z", z), ("p", p)):
        assert float(_ulps(got[name], want).max()) <= 2.0, name
    r64, z64 = got["r"].double(), got["z"].double()
    for name, want in (("rr", r64 @ r64), ("rz", r64 @ z64)):
        assert abs(float(got[name]) - float(want)) <= 1e-6 * abs(float(want)), name
    again = _cg_iteration(vec, rz, pap, blocks)
    for name in got:
        assert torch.equal(got[name], again[name]), name


@pytest.mark.gpu
@pytest.mark.parametrize("scene,n", [("buckling", 96), ("beam", 64)])
def test_fused_cg_on_card_matches_todays_loop(monkeypatch, scene, n):
    """A make_solver frame whose CG runs the three kernels against the same
    frame with the CG loop of PyTorch ops (``operator._fuses`` refusing
    every solve): each kernel launched once an iteration, ``cg.update`` once an
    iteration, iterations within +-1, velocity within rel 5e-4."""
    _need_card()
    state = getattr(scenes, scene)(n=n, device="cuda")
    cfg = SolverConfig(octree_levels=4 if scene == "buckling" else 3, tolerance=1e-4)
    cg.reset_launch_counts()
    log = _Counting()
    got = solver.make_solver(cfg, device="cuda")(state, DT, stage_times=log)
    it = got.stats.iterations
    assert got.stats.solve_path == "cuda" and got.stats.residual <= 1e-4
    assert cg.launch_counts == dict.fromkeys(cg.launch_counts, it)
    assert log.entries["cg.update"] == log.entries["cg.precond"] == it
    monkeypatch.setattr(operator, "_fuses", lambda b, precond, dot: False)
    log = _Counting()
    want = solver.make_solver(cfg, device="cuda")(state, DT, stage_times=log)
    assert "cg.update" not in log.entries
    assert cg.launch_counts == dict.fromkeys(cg.launch_counts, it)
    assert abs(it - want.stats.iterations) <= 1, (it, want.stats.iterations)
    scale = max(float(v.abs().max()) for v in want.velocity)
    for a in range(3):
        assert float((got.velocity[a] - want.velocity[a]).abs().max()) / scale < 5e-4
