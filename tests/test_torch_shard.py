"""The port's multi-device solve (parallel/mesh.py, parallel/shard_fused.py)
vs the JAX package's sharding helpers, its solve, and the port's own
single-device apply and solve.

Ranks are gloo processes on the CPU, spawned by the port's launcher
(``mesh.launch``) around the port's rank bodies (``mesh.solve_on_ranks``,
``mesh.apply_on_ranks``), so no rank imports JAX; each launch has its own
time limit (it stops its ranks on an overrun) and rendezvouses through a
file under ``tmp_path``.  On the CPU the kernel wrappers run their plain
versions ("cuda-plain-sharded").  Bars: an apply gathered from the ranks
within 3e-5 * max of the single-device apply per (level, axis) (the fp32
bar of tests/test_pallas_apply.py); solves as in tests/test_torch_solve.py
(DOFs exact, iterations +- 2, velocity rel 5e-4), the fixed-iteration
solve at 1e-5 of max with equal iterations (tests/test_sharding.py).  The
collective counts are pinned as tests/test_sharding_fast.py pins JAX's.
"""

import ast
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from adaptiveviscositysolver_tpu import solver as jsolver
from adaptiveviscositysolver_tpu.parallel import shard_pallas as jsp
from adaptiveviscositysolver_tpu_torch import convert, scenes, solver
from adaptiveviscositysolver_tpu_torch.config import SolverConfig
from adaptiveviscositysolver_tpu_torch.ops import fused_apply as fa
from adaptiveviscositysolver_tpu_torch.parallel import mesh, shard_fused
from tests.test_operator import build_case
from tests.test_torch_fused_apply import _host_matches_plain, host_kernels  # noqa: F401
from tests.test_torch_solve import jax_solution  # noqa: F401
from tests.test_torch_stages import N, port_test_env  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
LAUNCH_S = 120          # each launch's limit (it stops its ranks past it)
N_LIST = [1, 2, 4, 8]
LEVEL_GRID = [(r, lv) for r in (8, 12, 16, 24, 32, 48, 64) for lv in (1, 2, 3, 4)]


def _pyramid(r, lv):
    return [(r >> l, r >> l, r >> l) for l in range(lv) if r >> l >= 1]


@pytest.mark.parametrize("n", N_LIST)
def test_shardable_levels_match_jax(n):
    for r, lv in LEVEL_GRID:
        rpl = _pyramid(r, lv)
        assert shard_fused.shardable_levels(rpl, n) == jsp.shardable_levels(rpl, n), (r, lv, n)
        # odd widths are refused below the top only
        rpl2 = [(r + 2 * n >> l, 8, 8) for l in range(lv)]
        assert shard_fused.shardable_levels(rpl2, n) == jsp.shardable_levels(rpl2, n)


@pytest.mark.parametrize("n", N_LIST)
def test_block_x_matches_jax_and_round_trips(n):
    rng = np.random.default_rng(n)
    for nx in (8, 16, 24):
        if nx % n:
            continue
        for shape in ((nx + 1, 5, 3), (nx, 4, 6)):
            arr = rng.standard_normal(shape).astype(np.float32)
            want = np.asarray(jsp.block_x(jnp.asarray(arr), nx, n))
            got = shard_fused.block_x(arr, nx, n)
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(N(shard_fused.block_x(torch.from_numpy(arr), nx, n)),
                                          want)
            np.testing.assert_array_equal(shard_fused.unblock_x(got, nx, n), arr)
            np.testing.assert_array_equal(
                np.asarray(jsp.unblock_x(jnp.asarray(want), nx, n)), arr)
            for d in range(n):   # each rank's block is block_x's block d
                w = nx // n
                blk = shard_fused.local_block(torch.from_numpy(arr), nx, d, n)
                np.testing.assert_array_equal(N(blk), want[d * (w + 1): d * (w + 1) + w + 1]
                                              if shape[0] == nx + 1 else arr[d * w:(d + 1) * w])


@pytest.mark.parametrize("n", N_LIST)
def test_padded_shape_matches_jax(n):
    for shape in ((24, 24, 24), (17, 30, 9), (96, 96, 96), (5, 64, 33)):
        for lv in (1, 2, 3, 4):
            got = solver.padded_shape(shape, lv, n)
            assert got == jsolver.padded_shape(shape, lv, n), (shape, lv, n)
            rpl = [tuple(s >> l for s in got) for l in range(lv)]
            assert shard_fused.shardable_levels(rpl, n), (shape, lv, n, got)


def test_halo_covers_the_pinned_reach():
    """The local boxes' x pad comes from the reaches the reach tests pin
    (tests/test_torch_fused_apply.py: TAU_READS on even-bounded tau ranges,
    one weighted-stress row past an even-bounded D^T range): 4 rows."""
    from tests.test_torch_fused_apply import TAU_READS

    assert fa.TAU_REACH == TAU_READS["u"] and fa.DT_REACH == (1, 1)
    assert fa.HALO_X == 4 == shard_fused.HALO
    c = fa.make_canon((6, 8, 8), pad_x=fa.HALO_X)
    assert c.off == (4, 2, 2) and c.shape == (16, 14, 14) and c.cap[0] >= 7
    m = fa.level_metas([c], 1.0)[0]
    assert fa.kernel_bytes([m], (0, 4)) == {"tau": 0, "dt": 0}
    assert fa.kernel_bytes([m], (4, 16)) == fa.kernel_bytes([m])
    with pytest.raises(ValueError):
        fa.make_canon((6, 8, 8), pad_x=3)


def _poisoned(args, lo, hi):
    """A level's kernel inputs with every x row outside [lo, hi) poisoned:
    floats NaN (any read shows), kind bytes every slot FLUID."""
    out = {}
    for name, t in args.items():
        t = t.clone()
        bad = float("nan") if t.is_floating_point() else 0
        t[:max(0, lo)] = bad
        t[hi:] = bad
        out[name] = t
    return out


def test_owned_rows_read_two_rows_past_the_slab(apply_case):
    """The halo a slab needs, sample by sample, on the plain level pass of
    the 16^3 adaptive frame: the outputs (out, zp, zc) of every 4-row slab
    (even bounds, as every slab below the top has) of every level are
    unchanged when every input row more than 2 rows past the slab is
    poisoned, and some change at 1.  (An odd sample's tau reads u one row
    below, an even one's two; an odd row's D^T one row above, an even
    one's two: the parity of the slab's ends keeps the chain at 2.  The top
    level, whose slabs may be odd, has no T5 terms.)  HALO_X, from the
    range reaches, holds that with 2 rows to spare."""
    _, cfg, _, sys_, _ = apply_case
    run = fa.make_level_pass(sys_.frame, sys_.canons, sys_.state.dx, cfg.use_enhanced_gradients,
                             plain=True)
    u = sys_.embed_tree(mesh.random_faces(sys_.active, 5))
    args = sys_.apply_A.level_args(u)
    base = run(args)
    changed = {1: False, 2: False}
    for l, c in enumerate(sys_.canons):
        for a0 in range(c.off[0], c.off[0] + c.win[0], 4):
            rows = slice(a0, a0 + 4)
            for h in changed:
                got = run([_poisoned(a, a0 - h, a0 + 4 + h) if k == l else a
                           for k, a in enumerate(args)])
                same = all(torch.equal(got[l][n][rows], base[l][n][rows]) for n in base[l])
                changed[h] |= not same
    assert changed == {1: True, 2: False}, changed
    assert fa.HALO_X >= 2


def _case_arrays(case):
    """build_case's frame as convert.fluid_state_from_numpy's arguments
    (what a rank rebuilds its state from)."""
    return dict(liquid_sdf=case["liquid"], solid_sdf=case["solid"],
                velocity=case["regular_vel"], solid_velocity=case["solid_vel"],
                viscosity=case["viscosity"], density=case["density"], dx=case["dx"],
                dtype=torch.float32)


def _close(got, want, atol_rel, what):
    for k in want:
        w = N(want[k]).astype(np.float64)
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(np.asarray(got[k], np.float64) - w).max())
        assert err <= atol_rel * scale, (what, k, err, scale)


@pytest.fixture(scope="module")
def apply_case():
    case = build_case(n=16, levels=3)
    cfg = SolverConfig(octree_levels=3, apply_impl="cuda", dtype=torch.float32)
    arrays = _case_arrays(case)
    st = convert.fluid_state_from_numpy(**arrays, device="cpu")
    sys_ = solver.build_system(st, case["dt"], cfg, device="cpu")
    u = mesh.random_faces(sys_.active, 3)
    want = sys_.crop_tree(sys_.apply_A(sys_.embed_tree(u)))
    return case, cfg, arrays, sys_, want


@pytest.fixture(scope="module")
def sharded_applies(apply_case, tmp_path_factory):
    case, cfg, arrays, _, _ = apply_case
    d = tmp_path_factory.mktemp("ranks_apply")
    return {n: mesh.launch(n, mesh.apply_on_ranks, arrays, case["dt"], cfg, 3, n == 2, n == 4,
                           device="cpu", timeout=LAUNCH_S, init_file=str(d / f"rdv{n}"))
            for n in (2, 4)}


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_apply_matches_single_device(apply_case, sharded_applies, n):
    """One apply on the ranks' halo-filled local boxes, gathered, equals the
    single-device fused apply (plain versions; 3e-5 * max): on 2 ranks
    (widths 8, 4, 2) and 4 ranks (4, 2, 1: the top slab one cell wide, the
    halo from three ranks each side)."""
    _, _, _, sys_, want = apply_case
    ranks = sharded_applies[n]
    assert [r["rank"] for r in ranks] == list(range(n))
    assert all(r["modes"] == ["fused"] * 3 for r in ranks)
    assert not any(r["capturable"] for r in ranks)   # gloo collectives: never captured
    assert all(set(r["launches"].values()) == {0} for r in ranks)  # the plain versions
    _close(ranks[0]["out"], want, 3e-5, f"{n} ranks")
    assert sum(int(m.sum()) for (l, _), m in sys_.active.items() if l > 0) > 0


def test_host_kernels_on_a_ranks_halo_filled_boxes(apply_case, sharded_applies, host_kernels):
    """B6 on the CPU: the kernels' tiled routines, built with the host g++
    (tests/test_torch_fused_apply.py's host loop), on rank 1 of 4's local
    boxes (x pad HALO_X, both halos filled from the neighbours, the top
    slab one cell wide), all levels at once and level by level, whole and
    in 4-row bricks: equal to the plain versions (3e-5 * max), every
    output element written, and no read outside a tile's staged region
    (the reach counter unchanged).  Their extents come from the
    descriptor, so nothing in them knows the wider pad."""
    local = sharded_applies[4][1]["local"]
    canons = local["canons"]
    assert all(c.pad_x == fa.HALO_X for c in canons) and canons[2].win[0] == 1
    args = [{k: torch.from_numpy(v) for k, v in a.items()} for a in local["args"]]
    assert float(args[0]["u0"][:fa.HALO_X].abs().sum()) > 0     # a filled halo
    metas = fa.level_metas(canons, apply_case[0]["dx"])
    # outputs in the filled pads are live (masked by ownership later)
    everywhere = [[torch.ones(m.shape, dtype=torch.bool)] * 3 for m in metas]
    _host_matches_plain(host_kernels, args, metas, canons, True, everywhere, "rank 1 of 4")


def test_ghost_rows_of_the_apply_input_are_not_read(sharded_applies):
    """Garbage (1e30) in the ghost rows of the iterate's x faces leaves the
    apply unchanged: the apply refreshes them from their owner."""
    r0 = sharded_applies[2][0]
    for k, v in r0["out"].items():
        np.testing.assert_array_equal(r0["out_ghost_garbage"][k], v, err_msg=str(k))


@pytest.mark.parametrize("n", [2, 4])
def test_apply_collective_counts_pinned(apply_case, sharded_applies, n):
    """Frame prep and one apply make the designed transfers on every rank:
    2 (3 L + 6 (L - 1)) per apply with one hop (JAX's count), more hops for
    slabs narrower than the halo; frame prep halo-fills the packed kind
    bytes (3 or 4 per level) and the 4 weights, not JAX's 7 or 10 kind
    grids; one gather, no all-reduce."""
    _, _, _, sys_, _ = apply_case
    want = shard_fused.expected_exchanges(sys_.res_per_level, n)
    L = len(sys_.res_per_level)
    if n == 2:
        assert want == {"frame": 2 * (8 + 8 + 7), "apply": 2 * (3 * L + 6 * (L - 1))}
    else:   # widths 4, 2, 1: hops 1, 2, 3
        assert want == {"frame": 2 * (1 * 8 + 2 * 8 + 3 * 7),
                        "apply": 2 * (1 * 6 + 2 * 9 + 3 * 6)}
    for r in sharded_applies[n]:
        assert r["collectives"] == {"exchanges": want["frame"] + want["apply"],
                                    "allreduces": 0, "gathers": 1}, (n, r["rank"])


@pytest.fixture(scope="module")
def two_rank_solves(jax_solution, tmp_path_factory):
    """2 ranks on test_torch_solve's JAX case (n=8, 2 levels), one launch:
    the sharded Jacobi and degree-3 Chebyshev solves, v1 and refinement
    under the mesh, then the Jacobi solve again from slabs with garbage
    ghost rows."""
    case, jcfg, want = jax_solution
    cfg = dataclasses.replace(convert.config_from_jax_fields(**dataclasses.asdict(jcfg)),
                              apply_impl="cuda", dtype=torch.float32)
    configs = {"cuda": cfg, "cheb": dataclasses.replace(cfg, cheb_degree=3),
               "v1": dataclasses.replace(cfg, apply_impl="v1", dtype=None),
               "refined": dataclasses.replace(cfg, apply_impl="auto", dtype=None,
                                              use_iterative_refinement=True, tolerance=1e-8)}
    arrays = {**_case_arrays(case), "dtype": None}
    d = tmp_path_factory.mktemp("ranks_solve")
    runs = mesh.launch(2, mesh.solve_on_ranks, arrays, case["dt"], list(configs.values()), 1,
                       True, device="cpu", timeout=LAUNCH_S, init_file=str(d / "rdv"))
    st = convert.fluid_state_from_numpy(**arrays, device="cpu")
    single = {k: solver.solve_viscosity(st, case["dt"], c, device="cpu")
              for k, c in configs.items() if k != "cuda"}
    return dict(case=case, want=want, configs=configs, single=single,
                **{k: [r[i] for r in runs] for i, k in enumerate(list(configs) + ["garbage"])})


def test_sharded_solve_matches_jax(two_rank_solves):
    """The 2-rank sharded solve against the JAX package's solve: DOFs
    exact, iterations +- 2, velocity rel 5e-4; every rank returns the same
    stats, and each rank's launches of the kernels' plain versions: none."""
    s, want = two_rank_solves, two_rank_solves["want"]
    r0, r1 = s["cuda"]
    st = r0["stats"]
    assert st == r1["stats"]
    assert st["solve_path"] == "cuda-plain-sharded"
    assert st["octree_dofs"] == int(want.stats.octree_dofs)
    assert st["regular_dofs"] == int(want.stats.regular_dofs)
    assert abs(st["iterations"] - int(want.stats.iterations)) <= 2
    assert st["residual"] <= 1e-5 and st["applies"] == st["iterations"] + 1
    scale = max(float(np.abs(np.asarray(v)).max()) for v in want.velocity)
    for a in range(3):
        w = np.asarray(want.velocity[a])
        assert r0["velocity"][a].shape == w.shape
        assert np.abs(r0["velocity"][a].astype(np.float64) - w).max() / scale < 5e-4, a


def test_solve_collective_counts_pinned(two_rank_solves):
    """A Jacobi solve all-reduces 3 + 3 per iteration (JAX's psum count),
    exchanges the frame once and 2 (3 L + 6 (L - 1)) per apply, and gathers
    twice (the state's slabs, the solution); Chebyshev adds its lam_max
    estimate's 15 dots."""
    s = two_rank_solves
    rpl = [(8, 8, 8), (4, 4, 4)]
    for key, extra in (("cuda", 0), ("cheb", 15)):
        for r in s[key]:
            st = r["stats"]
            want = shard_fused.expected_exchanges(rpl, 2, st["applies"])
            assert want["apply"] == 2 * (3 * 2 + 6) * st["applies"]
            assert r["collectives"] == {
                "exchanges": want["frame"] + want["apply"],
                "allreduces": 3 + 3 * st["iterations"] + extra, "gathers": 2}, (key, r["rank"])


@pytest.mark.parametrize("key", ["cuda", "cheb"])
def test_sharded_cg_opens_cg_apply_per_apply(two_rank_solves, key):
    """The sharded CG runs through operator.pcg_flat's flat operator: on
    each rank one ``cg.apply`` span per apply (the lam_max estimate's
    included), one ``solve`` stage, and the CG's loop spans."""
    for r in two_rank_solves[key]:
        st, spans = r["stats"], r["spans"]
        assert spans["cg.apply"] == st["applies"], (key, r["rank"], spans)
        assert spans["solve"] == 1 and spans["cg.precond"] == st["iterations"]
        assert spans["cg.converged"] == st["iterations"] + 1


def test_chebyshev_on_two_ranks_matches_single_device(two_rank_solves):
    s = two_rank_solves
    got, want = s["cheb"][0], s["single"]["cheb"]
    assert got["stats"]["solve_path"] == "cuda-plain-sharded"
    assert want.stats.solve_path == "cuda-plain"
    assert abs(got["stats"]["iterations"] - want.stats.iterations) <= 2
    assert got["stats"]["applies"] == 13 + 1 + 2 + 3 * got["stats"]["iterations"]
    assert got["stats"]["residual"] <= 1e-5
    scale = max(float(v.abs().max()) for v in want.velocity)
    for a in range(3):
        assert np.abs(got["velocity"][a] - N(want.velocity[a])).max() / scale < 5e-4, a


@pytest.mark.parametrize("key", ["v1", "refined"])
def test_whole_array_options_under_a_mesh_run_the_single_device_solve(two_rank_solves, key):
    """v1 and refinement under a mesh run each rank's single-device solve of
    the option: its numbers exactly, its solve_path, no collective but the
    state's gather."""
    s = two_rank_solves
    want = s["single"][key]
    assert want.stats.solve_path == key
    for r in s[key]:
        assert r["stats"] == dataclasses.asdict(want.stats)
        assert r["collectives"] == {"exchanges": 0, "allreduces": 0, "gathers": 1}
    for a in range(3):
        np.testing.assert_array_equal(s[key][0]["velocity"][a], N(want.velocity[a]))


def test_garbage_in_slab_ghost_rows_leaves_the_solution_unchanged(two_rank_solves):
    s = two_rank_solves
    got, clean = s["garbage"][0], s["cuda"][0]
    assert got["stats"] == clean["stats"]
    for a in range(3):
        np.testing.assert_array_equal(got["velocity"][a], clean["velocity"][a])


def test_four_ranks_fixed_iterations_match_single_device(tmp_path):
    """JAX's test_sharded_pallas_solve_matches_single_device on 4 ranks:
    buckling-24 at 3 levels does not split into 4 x-slabs (4 << 2 = 16
    does not divide 24), so the solve pads x to 32 and still runs sharded;
    K = 4 fixed iterations against the single-device solve of the unpadded
    grid at 1e-5 of max, iterations equal."""
    K = 4
    cfg = SolverConfig(octree_levels=3, max_iterations=K, tolerance=1e-30, apply_impl="cuda",
                       dtype=torch.float32)
    assert solver.padded_shape((24, 24, 24), 3, 4) == (32, 24, 24)
    single = solver.solve_viscosity(scenes.buckling(n=24, device="cpu"), 1.0 / 24.0, cfg,
                                    device="cpu")
    assert single.stats.solve_path == "cuda-plain"
    ranks = mesh.launch(4, mesh.solve_on_ranks, ("buckling", 24), 1.0 / 24.0, [cfg],
                        device="cpu", timeout=LAUNCH_S, init_file=str(tmp_path / "rdv"))
    got = ranks[0][0]
    assert [r[0]["stats"] for r in ranks] == [got["stats"]] * 4
    assert got["stats"]["solve_path"] == "cuda-plain-sharded"
    assert got["stats"]["iterations"] == single.stats.iterations == K
    assert got["stats"]["octree_dofs"] == single.stats.octree_dofs
    scale = max(float(v.abs().max()) for v in single.velocity)
    for a in range(3):
        assert got["velocity"][a].shape == tuple(single.velocity[a].shape)
        assert np.abs(got["velocity"][a] - N(single.velocity[a])).max() / scale < 1e-5, a


def test_unshardable_grid_raises():
    """A pyramid that does not split raises before any collective; so does
    a state whose x cells do not split into equal slabs."""
    fake = mesh.Mesh(0, 2, "x", torch.device("cpu"), "gloo")
    rpl = [(6, 8, 8), (3, 4, 4)]      # width 3 below the top
    assert not shard_fused.shardable_levels(rpl, 2)
    with pytest.raises(ValueError, match="do not split"):
        shard_fused.sharded_operator(fake, None, None, None, {}, [], {}, {}, rpl, 1.0, True)
    with pytest.raises(ValueError, match="equal slabs"):
        mesh.state_sharding(fake, (7, 8, 8))
    st = scenes.buckling(n=8, device="cpu")
    with pytest.raises(ValueError, match="axis"):
        solver.solve_viscosity(st, 0.01, SolverConfig(octree_levels=2), mesh=fake,
                               mesh_axis="y")


def test_launch_stops_its_ranks_past_the_limit(tmp_path):
    """Ranks that meet at a barrier return by rank; a rank that never
    finishes: the launch raises at its limit and stops every rank; a rank
    that raises: its traceback comes back."""
    assert mesh.launch(2, mesh.barrier_on_ranks, device="cpu", timeout=LAUNCH_S,
                       init_file=str(tmp_path / "rdv_barrier")) == [0, 1]
    with pytest.raises(TimeoutError):
        mesh.launch(2, mesh.barrier_on_ranks, 60.0, device="cpu", timeout=3,
                    init_file=str(tmp_path / "rdv_sleep"))
    with pytest.raises(RuntimeError, match="ValueError"):
        mesh.launch(2, mesh.solve_on_ranks, ("buckling", 7), 0.01, [SolverConfig()],
                    device="cpu", timeout=LAUNCH_S, init_file=str(tmp_path / "rdv_fail"))


def _imports_of(path: Path):
    """Every module chip_smoke.py imports, at any depth of the file."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
            names.update(f"{node.module}.{a.name}" for a in node.names)
    return sorted(names)


def test_port_imports_no_jax():
    """Every module of the port, and every import chip_smoke.py makes (its
    own not run), leave jax and the JAX package out of sys.modules (in a
    fresh interpreter)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import adaptiveviscositysolver_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        f"mods += {_imports_of(REPO / 'chip_smoke.py')!r}\n"
        "for m in mods:\n"
        "    try:\n"
        "        importlib.import_module(m)\n"
        "    except ModuleNotFoundError:\n"
        "        if '.' not in m or m.rsplit('.', 1)[0] not in sys.modules:\n"
        "            raise\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib',\n"
        "             'adaptiveviscositysolver_tpu'))\n"
        "assert not bad, bad\n"
        "print(len(mods), 'modules')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert int(out.stdout.split()[0]) > 30, out.stdout
