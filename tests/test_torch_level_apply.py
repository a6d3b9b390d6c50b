"""The port's per-level routes (ops/fused_apply.py) vs the JAX package.

A level runs "fused" (in the all-level fused_tau/fused_dt group), "split"
(tau_level then dt_level over the whole level) or ``("brick", T)`` (the
pair once per brick of T x rows, over a weighted-stress scratch holding the
brick plus its halo).  On the CPU the wrappers run their plain versions,
restricted to the rows; the CUDA kernels are held to those plain versions
by the ``gpu``-marked tests in tests/test_torch_gpu.py and by
chip_smoke.py, and their per-point addressing by the host build in
tests/test_torch_fused_apply.py.

The bar is the one tests/test_pallas_apply.py holds the Pallas split and
bricked kernels to (``test_pallas_apply_matches_v1`` split column,
``test_pallas_apply_mixed_modes_matches_v1``, ``ky1``/``ky2`` of
``test_pallas_apply_brick_matches_v1``): the routed operator equals the
JAX v1 operator within ``atol 3e-5 * max|want|`` per (level, axis), and
every canonical pad of the output is exactly zero.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adaptiveviscositysolver_tpu import export as jexport
from adaptiveviscositysolver_tpu import restriction as jrestriction
from adaptiveviscositysolver_tpu.config import SolverConfig as JConfig
from adaptiveviscositysolver_tpu.solver import solve_viscosity as jsolve
from adaptiveviscositysolver_tpu_torch import convert, export, solver, stencils
from adaptiveviscositysolver_tpu_torch.config import SolverConfig
from adaptiveviscositysolver_tpu_torch.ops import fused_apply as fa
from adaptiveviscositysolver_tpu_torch.ops.arrayops import face_shape
from tests.test_operator import build_case
from tests.test_solver import state_from_case
from tests.test_torch_fused_apply import (_f32, _jax_system, _jit_v1_apply, _port_system,
                                          _to_f32)
from tests.test_torch_stages import N, T, port_test_env  # noqa: F401

F32 = torch.float32
TOL = 3e-5

CASES = {
    "adaptive": dict(),
    "uniform": dict(uniform=True),
    "nosolid": dict(with_solid=False),
    "noenh": dict(enhanced=False),
    "bbox": dict(),
    "n40": dict(n=40),
}


@pytest.fixture(scope="module")
def routed_case(request):
    """The port's float32 stencils and mass on a build_case fixture, and the
    JAX v1 operator applied to one random u on the same case."""
    kind = request.param
    case = build_case(**CASES[kind])
    s = _port_system(case)
    bboxes = None
    if kind == "bbox":
        from adaptiveviscositysolver_tpu_torch import octree

        bboxes = solver._tight_windows([N(b) for b in octree.occupied_bboxes(s["labels"])],
                                       s["rpl"])
    blocks32 = [stencils.StressBlock(b.kind, b.level, b.axis, _f32(b.weight),
                                     [stencils.StressTerm(t.lift, t.face_axis, t.src_level,
                                                          t.offset, _f32(t.coeff))
                                      for t in b.terms], _f32(b.boundary))
                for b in s["blocks"]]
    mass32 = {k: v.to(F32) for k, v in s["mass"].items()}
    jblocks, jmass = _jax_system(case)
    rng = np.random.default_rng(11)
    u = {k: np.where(N(m), rng.normal(size=m.shape), 0.0).astype(np.float32)
         for k, m in s["active"].items()}
    want = _jit_v1_apply(_to_f32(jblocks), _to_f32(jmass),
                         {k: jnp.asarray(N(v)) for k, v in s["active"].items()},
                         {k: jnp.asarray(v) for k, v in u.items()}, tuple(s["rpl"]))
    return dict(kind=kind, case=case, sys=s, bboxes=bboxes, blocks32=blocks32, mass32=mass32,
                u=u, want={k: np.asarray(v) for k, v in want.items()})


def route_modes(route, levels):
    """The per-level modes of a named routing (the JAX fixtures' names)."""
    if route == "split":                   # test_pallas_apply_matches_v1, split column
        return ["split"] * levels
    if route == "mixed":                   # ..._mixed_modes_matches_v1
        return ["split" if l % 2 == 0 else "fused" for l in range(levels)]
    if route == "ky1":                     # every level bricked, one brick each
        return [("brick", 32)] * levels
    if route == "ky2":                     # level 0 in >= 2 bricks, the rest fused
        return [("brick", 32)] + ["fused"] * (levels - 1)
    if route == "rows2":                   # 2-row bricks: every brick is mostly halo
        return [("brick", 2), "split"] + ["fused"] * (levels - 2)
    raise ValueError(route)


@pytest.mark.parametrize("routed_case,route", [
    ("adaptive", "split"), ("uniform", "split"), ("nosolid", "split"), ("noenh", "split"),
    ("bbox", "split"), ("adaptive", "mixed"), ("adaptive", "ky1"), ("n40", "ky2"),
    ("adaptive", "rows2"), ("bbox", "rows2"),
], indirect=["routed_case"])
def test_routed_apply_matches_jax_v1(routed_case, route):
    c, s = routed_case, routed_case["sys"]
    levels = len(s["rpl"])
    modes = route_modes(route, levels)
    frame, canons = fa.build_frame_data(s["labels"], s["vk"], s["ek"], s["ck"], c["blocks32"],
                                        c["mass32"], s["rpl"], bboxes=c["bboxes"], modes=modes)
    bricks = [len(cn.row_ranges()) for cn in canons]
    if route == "ky1":
        assert bricks == [1] * levels and all(cn.brick == 32 for cn in canons)
    if route == "ky2":
        assert bricks[0] >= 2, canons[0]
    if route == "rows2":
        assert bricks[0] == canons[0].shape[0] // 2
    apply_A, embed_tree, crop_tree = fa.make_fused_operator(
        frame, canons, s["active"], s["rpl"], c["case"]["dx"],
        c["case"]["cfg"].use_enhanced_gradients, modes=modes)
    before = dict(fa.launch_counts)
    got_c = apply_A(embed_tree({k: torch.from_numpy(v) for k, v in c["u"].items()}))
    assert fa.launch_counts == before   # CPU tensors: the plain versions, no launch
    for (l, f), arr in got_c.items():
        # every canonical pad of the output is exactly zero (the CG's flat
        # vector spans the whole box)
        window = fa.embed(torch.ones(face_shape(s["rpl"][l], f), dtype=torch.bool), canons[l],
                          False)
        assert not arr[~window].any(), (l, f, modes[l])
    got = crop_tree(got_c)
    for k in sorted(c["want"]):
        w, g = c["want"][k], N(got[k])
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL * max(np.abs(w).max(), 1e-30),
                                   err_msg=f"level/axis {k} ({c['kind']}, {modes})")


def test_brick_rows_cover_the_box_once():
    """Bricks start at even rows, cover every x row of the box exactly
    once, and each scratch holds its brick plus the halo, inside the box."""
    for cx, brick in ((22, 2), (22, 4), (46, 32), (14, 64), (30, 6)):
        c = dataclasses.replace(fa.make_canon((cx - 6, 8, 8)), brick=brick)
        assert c.shape[0] == cx
        ranges = c.row_ranges()
        assert [r for x0, x1 in ranges for r in range(x0, x1)] == list(range(cx))
        assert all(x0 % 2 == 0 for x0, _ in ranges)
        for x0, x1 in ranges:
            t0, t1 = fa.tau_rows((x0, x1), cx)
            assert (t0, t1) == (max(0, x0 - fa.TAU_HALO), min(cx, x1 + fa.TAU_HALO))
    with pytest.raises(ValueError):
        fa.make_canon((8, 8, 8), brick=3)
    with pytest.raises(ValueError):
        fa.route_canons([fa.make_canon((8, 8, 8))], [("brick", 0)])


def _canons(shapes):
    return [fa.Canon(tuple(s), tuple(s), tuple(s)) for s in shapes]


MiB = 1 << 20
H100_BUDGET = fa.L2_SHARE * 50 * MiB   # route_budget on an H100 (L2_cache_size 50 MiB)
# make_solver's crop windows on scenes.buckling(n), SolverConfig(octree_levels=4)
# (solver.probe_topology on the card), the weighted stress per level
# (MiB) and the routes the H100's budget gives them
SCENES = {
    96: ((((4, 92), (4, 96), (4, 92)), ((0, 48),) * 3, ((0, 24),) * 3),
         [19.8, 3.6, 0.6], ["fused"] * 3),
    192: ((((14, 178), (14, 188), (14, 178)), ((6, 90), (6, 96), (6, 90)),
           ((2, 46), (2, 48), (2, 46)), ((0, 24),) * 3),
          [119.1, 17.8, 3.0, 0.6], [("brick", 60), "fused", "fused", "fused"]),
    256: ((((20, 236), (20, 248), (20, 236)), ((8, 120), (8, 126), (8, 120)),
           ((2, 62), (2, 64), (2, 62)), ((0, 32),) * 3),
          [264.0, 39.5, 6.8, 1.3], [("brick", 32), "split", "fused", "fused"]),
}


@pytest.mark.parametrize("n", sorted(SCENES))
def test_level_modes_at_the_bench_scenes(n):
    windows, mib, want = SCENES[n]
    canons = fa.level_canons([(n >> l,) * 3 for l in range(len(windows))], windows)
    assert [round(fa.tau_bytes(c) / MiB, 1) for c in canons] == mib
    modes = fa.level_modes(canons, H100_BUDGET)
    assert modes == want
    for c, m in zip(fa.route_canons(canons, modes), modes):
        if m != "fused":
            assert max(fa.tau_bytes(c, t1 - t0) for t0, t1 in
                       (fa.tau_rows(r, c.shape[0]) for r in c.row_ranges())) <= H100_BUDGET


def test_level_modes_policy():
    """Fused from the coarsest up while the group fits; then split if the
    level fits alone; else the largest even brick whose scratch fits."""
    canons = _canons([(64, 32, 32), (36, 20, 20), (20, 12, 12), (12, 8, 8)])
    tb = [fa.tau_bytes(c) for c in canons]
    plane0 = fa.tau_bytes(canons[0], 1)
    assert fa.level_modes(canons, float("inf")) == ["fused"] * 4
    assert fa.level_modes(canons, sum(tb)) == ["fused"] * 4
    assert fa.level_modes(canons, tb[0]) == ["split", "fused", "fused", "fused"]
    assert fa.level_modes(canons, sum(tb[1:]))[1:] == ["fused"] * 3
    budget = tb[1]       # level 1 fits alone, not beside levels 2-3
    modes = fa.level_modes(canons, budget)
    t = modes[0][1]
    assert modes[1:] == ["split", "fused", "fused"] and modes[0][0] == "brick"
    assert t % 2 == 0 and (t + 2 * fa.TAU_HALO) * plane0 <= budget
    assert (t + 2 + 2 * fa.TAU_HALO) * plane0 > budget
    # a budget below one 2-row brick still routes every level
    assert fa.level_modes(canons, 1) == [("brick", 2)] * 4
    assert fa.route_budget("cpu") == float("inf")


def test_solve_with_forced_routes_matches_jax(monkeypatch):
    """solve_viscosity on the CPU with a budget that bricks level 0 (>= 2
    bricks) and splits level 1 (level 2 fused), vs the JAX solve:
    velocity within rel 5e-4, DOF counts exact, CG iterations within +-2."""
    case = build_case()
    state = convert.fluid_state_from_numpy(
        case["liquid"], case["solid"], case["regular_vel"], case["solid_vel"],
        case["viscosity"], case["density"], case["dx"], device="cpu", dtype=torch.float32)
    canons = fa.level_canons([(case["n"] >> l,) * 3 for l in range(case["levels"])])
    budget = fa.tau_bytes(canons[1])            # level 1 alone, not beside level 2
    modes = fa.level_modes(canons, budget)
    assert modes[1:] == ["split", "fused"] and modes[0][0] == "brick"
    assert len(fa.route_canons(canons, modes)[0].row_ranges()) >= 2
    monkeypatch.setattr(fa, "route_budget", lambda device: budget)
    cfg = SolverConfig(octree_levels=case["levels"], tolerance=1e-5, apply_impl="cuda")
    got = solver.solve_viscosity(state, case["dt"], cfg, device="cpu")
    assert solver.build_system(state, case["dt"], cfg, device="cpu").modes == modes
    jcfg = JConfig(octree_levels=case["levels"], tolerance=1e-5, apply_impl="v1-fused")
    want = jax.jit(lambda st, t: jsolve(st, t, jcfg),
                   compiler_options={"xla_backend_optimization_level": 0})(
        state_from_case(case), case["dt"])
    assert got.stats.solve_path == "cuda-plain"
    assert got.stats.octree_dofs == int(want.stats.octree_dofs)
    assert got.stats.regular_dofs == int(want.stats.regular_dofs)
    assert abs(got.stats.iterations - int(want.stats.iterations)) <= 2
    assert got.stats.residual <= 1e-5
    scale = max(float(np.abs(np.asarray(v)).max()) for v in want.velocity)
    for a in range(3):
        assert np.abs(N(got.velocity[a]).astype(np.float64)
                      - np.asarray(want.velocity[a])).max() / scale < 5e-4, a


def test_export_matches_jax_export():
    """The port's export_sparse_system on its own stencils equals the JAX
    package's on the JAX stencils (build_case): same sparsity, values to
    rtol 1e-12, same rhs and DOF numbering."""
    case = build_case()
    s = _port_system(case)
    rpl = s["rpl"]
    jblocks, jmass = _jax_system(case)
    jguess = jrestriction.restrict_velocity_pyramid(
        [jnp.asarray(v) for v in case["regular_vel"]], case["levels"])
    jguess = {k: jnp.where(N(m), jguess[k], 0.0) for k, m in s["active"].items()}
    want_A, want_rhs, want_idx, want_n = jexport.export_sparse_system(
        jblocks, jmass, case["jvk"], jguess, rpl)
    guess = {k: T(np.asarray(v)) for k, v in jguess.items()}
    A, rhs, idx, n = export.export_sparse_system(s["blocks"], s["mass"], s["vk"], guess, s["rpl"])
    assert n == want_n
    for l in range(len(rpl)):
        for a in range(3):
            np.testing.assert_array_equal(idx[l][a], want_idx[l][a])
    A.sort_indices()
    want_A = want_A.tocsr()
    want_A.sort_indices()
    np.testing.assert_array_equal(A.indptr, want_A.indptr)
    np.testing.assert_array_equal(A.indices, want_A.indices)
    np.testing.assert_allclose(A.data, want_A.data, rtol=1e-12,
                               atol=1e-12 * np.abs(want_A.data).max())
    np.testing.assert_allclose(rhs, want_rhs, rtol=1e-12, atol=1e-12 * np.abs(want_rhs).max())
