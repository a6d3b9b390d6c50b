"""The port's host tail vs the JAX package: checkpoint files, the FLIP
demo loop and the buckling example around it, the point interpolator, the
octree's refine and geometry export, and the native checks.

The same numpy inputs go through the JAX function and the port's, on the
CPU in float64.  Bars: checkpoint arrays equal across the two packages
both ways; advection and gravity to rtol 1e-12; one FLIP step (2 levels,
tests/test_misc.py's configuration) with iterations +-1 and velocity within
1e-6 * max; the example's frames on the same loop with iterations +-1,
DOFs, ACTIVE cells and PLY vertex counts exact and frame 0's PLY byte for
byte the JAX example's; interp_at to rtol 1e-12 on tests/test_interpolator.py's
fixtures; the octree's refinement, geometry and the native checks and PLY
exactly.  The jitted JAX calls are the ones those JAX tests make, so their
compiles are shared.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adaptiveviscositysolver_tpu import interpolator as jinterp
from adaptiveviscositysolver_tpu import native as jnative
from adaptiveviscositysolver_tpu import octree as joctree
from adaptiveviscositysolver_tpu import scenes as jscenes
from adaptiveviscositysolver_tpu import solver as jsolver
from adaptiveviscositysolver_tpu.config import SolverConfig as JConfig
from adaptiveviscositysolver_tpu.models import flip as jflip
from adaptiveviscositysolver_tpu.utils import checkpoint as jcheckpoint
from adaptiveviscositysolver_tpu_torch import convert, interpolator, native, octree, solver
from adaptiveviscositysolver_tpu_torch.config import SolverConfig, capped_levels
from adaptiveviscositysolver_tpu_torch.examples import run_buckling
from adaptiveviscositysolver_tpu_torch.models import flip
from adaptiveviscositysolver_tpu_torch.tools import flip_counts
from adaptiveviscositysolver_tpu_torch.utils import checkpoint
from tests.oracle import reference_oracle as oracle
from tests.test_operator import build_case
from tests.test_torch_stages import N, T, close, exact, port_test_env  # noqa: F401

FIELDS = ("liquid_sdf", "solid_sdf", "viscosity", "density")


def port_from_jax(state):
    """The port's FluidState (CPU) holding a JAX state's arrays."""
    return convert.fluid_state_from_numpy(
        np.asarray(state.liquid_sdf), np.asarray(state.solid_sdf),
        [np.asarray(v) for v in state.velocity], [np.asarray(v) for v in state.solid_velocity],
        np.asarray(state.viscosity), np.asarray(state.density), state.dx, device="cpu")


def assert_states_equal(got, want):
    for f in FIELDS:
        exact(getattr(got, f), getattr(want, f), f)
    for a in range(3):
        exact(got.velocity[a], want.velocity[a], f"velocity {a}")
        exact(got.solid_velocity[a], want.solid_velocity[a], f"solid velocity {a}")
    assert got.dx == want.dx


# --- checkpoint --------------------------------------------------------------


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_crosses_packages(tmp_path, writer):
    """A file written by either package loads in the other (and in itself)
    with equal arrays and step."""
    jstate = jscenes.beam(n=8, dtype=jnp.float64)
    pstate = port_from_jax(jstate)
    path = str(tmp_path / "ckpt")
    if writer == "jax":
        jcheckpoint.save(path, jstate, step=7)
    else:
        checkpoint.save(path, pstate, step=7)
    got, step = checkpoint.load(path, device="cpu")
    jgot, jstep = jcheckpoint.load(path)
    assert step == jstep == 7
    assert isinstance(got, solver.FluidState) and got.liquid_sdf.dtype == torch.float64
    assert_states_equal(got, pstate)
    assert_states_equal(got, jgot)


# --- the FLIP demo loop ------------------------------------------------------


@pytest.fixture(scope="module")
def flip_state():
    return jscenes.buckling(n=16, dtype=jnp.float64)


def test_advect_and_gravity_match_jax(flip_state):
    dt = 1 / 48.0
    got = flip.apply_gravity(flip.advect_state(port_from_jax(flip_state), dt), dt)
    want = jflip.apply_gravity(jflip.advect_state(flip_state, dt), dt)
    close(got.liquid_sdf, want.liquid_sdf, "sdf")
    for a in range(3):
        close(got.velocity[a], want.velocity[a], f"velocity {a}")
    for f in ("solid_sdf", "viscosity", "density"):
        exact(getattr(got, f), getattr(want, f), f)


FLIP_CFG = JConfig(octree_levels=2, max_iterations=40, tolerance=1e-5)


@pytest.fixture(scope="module")
def jax_flip(flip_state):
    """tests/test_misc.py's loop (2 levels, dt 1/48, 2 frames) through the
    JAX package, once per module: (final state, stats per frame, state after
    each frame)."""
    frames = []
    want, jstats = jflip.simulate(flip_state, frames=2, dt=1 / 48.0, config=FLIP_CFG,
                                  on_frame=lambda i, s, st: frames.append(s))
    return want, jstats, frames


def test_flip_step_matches_jax(flip_state, jax_flip):
    """tests/test_misc.py's loop (2 levels, dt 1/48, 2 frames): each frame's
    iterations within +-1, velocity within 1e-6 * max, the column falling."""
    cfg = FLIP_CFG
    want, jstats, _ = jax_flip
    seen = []
    got, stats = flip.simulate(port_from_jax(flip_state), 2, 1 / 48.0,
                               convert.config_from_jax_fields(**dataclasses.asdict(cfg)),
                               on_frame=lambda i, s, st: seen.append(i), device="cpu")
    assert seen == [0, 1] and len(stats) == 2
    for st, jst in zip(stats, jstats):
        assert st.solve_path == "v1" and abs(st.iterations - int(jst.iterations)) <= 1
    scale = max(float(np.abs(np.asarray(v)).max()) for v in want.velocity)
    for a in range(3):
        assert np.abs(N(got.velocity[a]) - np.asarray(want.velocity[a])).max() <= 1e-6 * scale
    close(got.liquid_sdf, want.liquid_sdf, "sdf", rtol=1e-9)
    assert float(got.velocity[1].mean()) < 0.0


def _ply_vertices(path) -> int:
    head = path.read_bytes()[:200]
    return int(head.split(b"element vertex ")[1].split(b"\n")[0])


def _jax_example_labels(state, levels):
    """examples/run_buckling.py's labels of a JAX state."""
    dx = state.dx
    return [np.asarray(l) for l in joctree.build_octree(joctree.build_refinement_mask(
        state.liquid_sdf, state.solid_sdf, dx, FLIP_CFG.extrapolation * dx, 3 * dx, 2 * dx),
        levels)]


def test_run_buckling_matches_jax(flip_state, jax_flip, tmp_path):
    """The example's run() on the FLIP fixture: iterations within +-1 of the
    JAX loop's, its DOFs and ACTIVE cells per level equal, each PLY's
    vertex count that of the ACTIVE cells of the JAX example's labels of
    the frame, and frame 0's PLY byte for byte the JAX example's."""
    _, jstats, jframes = jax_flip
    recs = run_buckling.run(port_from_jax(flip_state), 2, 1 / 48.0,
                            convert.config_from_jax_fields(**dataclasses.asdict(FLIP_CFG)),
                            tmp_path / "out", device="cpu")
    assert [r["frame"] for r in recs] == [0, 1]
    levels = capped_levels(tuple(flip_state.liquid_sdf.shape), FLIP_CFG.octree_levels)
    for rec, jst, jstate in zip(recs, jstats, jframes):
        assert abs(rec["iterations"] - int(jst.iterations)) <= 1, (rec, jst)
        assert rec["octree_dofs"] == int(jst.octree_dofs)
        assert rec["active_cells"] == [int(c) for c in np.asarray(jst.active_cells)]
        jlabels = _jax_example_labels(jstate, levels)
        n_active = sum(int((l == oracle.ACTIVE).sum()) for l in jlabels)
        path = Path(rec["path"])
        assert path.parent == tmp_path / "out" and path.name == f"frame_{rec['frame']:03d}.ply"
        assert _ply_vertices(path) == rec["ply_points"] == n_active > 0
    jpath = tmp_path / "jax_frame_000.ply"
    jnative.export_octree_ply(_jax_example_labels(jframes[0], levels), flip_state.dx, str(jpath))
    assert Path(recs[0]["path"]).read_bytes() == jpath.read_bytes()


def test_run_buckling_command_line(monkeypatch):
    """main()'s arguments (the JAX script's: frames, n; 5 and 64 by
    default) and its refusal to run without a card, before any solve."""
    a = run_buckling.parse_args(["2", "16"])
    assert (a.frames, a.n) == (2, 16)
    a = run_buckling.parse_args([])
    assert (a.frames, a.n) == (5, 64)
    assert run_buckling.OUTDIR == "out_buckling_torch" and run_buckling.DT == 1 / 48.0
    assert (run_buckling.CONFIG.octree_levels, run_buckling.CONFIG.tolerance) == (4, 1e-4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(run_buckling, "run", lambda *a, **k: pytest.fail("solved"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_buckling.main(["2", "16"])


def test_flip_counts_frames_match_jax(flip_state, jax_flip):
    """tools.flip_counts' frames (models.flip.step with each frame's state
    kept for a second, float64 v1 solve) on the FLIP fixture: iterations
    within +-1 of the JAX loop's, DOFs equal, each frame's velocity within
    1e-6 * max of its v1 solve."""
    _, jstats, _ = jax_flip
    rec = flip_counts.frame_counts(port_from_jax(flip_state), 2, 1 / 48.0,
                                   convert.config_from_jax_fields(**dataclasses.asdict(FLIP_CFG)),
                                   v1=True, device="cpu")
    assert rec["solve_path"] == rec["v1_path"] == "v1"
    for it, dofs, jst in zip(rec["frame_iterations"], rec["octree_dofs"], jstats):
        assert abs(it - int(jst.iterations)) <= 1 and dofs == int(jst.octree_dofs), (rec, jst)
    assert len(rec["velocity_vs_v1_rel"]) == 2 and max(rec["velocity_vs_v1_rel"]) <= 1e-6


def test_flip_counts_command_line(monkeypatch, capsys):
    """The tool's defaults (the example's 64^3 and 5 frames at both steps)
    and its refusal to run without a card, before any solve."""
    assert flip_counts.STEPS == {"1/24": 1 / 24.0, "1/48": run_buckling.DT}
    assert flip_counts.CONFIG == run_buckling.CONFIG
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(flip_counts, "counts", lambda *a, **k: pytest.fail("solved"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        flip_counts.main(["16", "2"])
    monkeypatch.setattr(flip_counts, "counts", lambda *a: {"args": list(a)})
    assert flip_counts.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines == ['{"args": [64, 5, "1/24", false, "cpu"]}',
                     '{"args": [64, 5, "1/48", false, "cpu"]}']


def test_flip_positions_are_float32():
    pos = flip._cell_positions((4, 5, 6), 0.25, "cpu")
    assert all(p.dtype == torch.float32 for p in pos)
    fpos = flip._face_positions((5, 5, 6), 0, 0.25, "cpu")
    exact(fpos[0], np.asarray(jflip._face_positions((5, 5, 6), 0, 0.25)[0]))


# --- the point interpolator --------------------------------------------------


@pytest.fixture(scope="module", params=["adaptive", "adaptive_nosolid", "uniform"])
def icase(request):
    """tests/test_interpolator.py's fixtures: the case, a random FLUID
    field u and 400 points in columns that own an ACTIVE cell."""
    kwargs = {"adaptive": {}, "adaptive_nosolid": dict(with_solid=False),
              "uniform": dict(uniform=True)}[request.param]
    case = build_case(**kwargs)
    rng = np.random.default_rng(7)
    u = {}
    for l in range(case["levels"]):
        for a in range(3):
            kind = case["vk"][l][a]
            u[(l, a)] = np.where(kind == oracle.FLUID, rng.normal(size=kind.shape), 0.0)
    covered = np.zeros(case["labels"][0].shape, bool)
    for l in range(case["levels"]):
        act = case["labels"][l] == oracle.ACTIVE
        for d in range(3):
            act = np.repeat(act, 1 << l, axis=d)
        covered |= act[:case["n"], :case["n"], :case["n"]]
    cells = np.argwhere(covered)
    rng = np.random.default_rng(11)
    pts = cells[rng.integers(0, len(cells), 400)] + rng.uniform(0.02, 0.98, size=(400, 3))
    return case, u, pts


def test_interp_at_matches_jax(icase):
    case, u, pts = icase
    ju = {k: jnp.asarray(v) for k, v in u.items()}
    jnv, _ = jax.jit(jinterp.build_node_velocities)(case["jlabels"], ju, case["jvk"])
    jfn = jax.jit(jinterp.interp_at, static_argnums=(5,))
    labels = [T(l) for l in case["labels"]]
    vk = [[T(k) for k in per] for per in case["vk"]]
    tu = {k: T(v) for k, v in u.items()}
    nv, _ = interpolator.build_node_velocities(labels, tu, vk)
    query = interpolator.make_point_interpolator(labels, tu, vk)
    # points outside every column read 0 on both sides
    far = np.concatenate([pts, [[-3.0, 1.5, 2.5], [1.5, 99.0, 2.5]]])
    for axis in range(3):
        want = jfn(case["jlabels"], ju, case["jvk"], jnv, jnp.asarray(far), axis)
        got = interpolator.interp_at(labels, tu, vk, nv, T(far), axis)
        close(got, want, f"axis {axis}")
        exact(query(T(far), axis), got)
        assert float(got[-1]) == float(got[-2]) == 0.0


@pytest.mark.parametrize("icase", ["adaptive", "adaptive_nosolid"], indirect=True)
def test_interp_at_equals_the_writeback_interpolation(icase):
    """At the level-0 faces whose values the writeback takes from the
    interpolator (UNASSIGNED), the point query equals the dense pass."""
    case, u, _ = icase
    labels = [T(l) for l in case["labels"]]
    vk = [[T(k) for k in per] for per in case["vk"]]
    tu = {k: T(v) for k, v in u.items()}
    dense = interpolator.interpolate_writeback_fields(labels, tu, vk, case["levels"])
    query = interpolator.make_point_interpolator(labels, tu, vk)
    checked = 0
    for a in range(3):
        sel = vk[0][a] == oracle.UNASSIGNED
        pts = torch.nonzero(sel).double() + torch.tensor([0.0 if d == a else 0.5
                                                          for d in range(3)], dtype=torch.float64)
        close(query(pts, a), dense[a][sel], f"axis {a}")
        checked += len(pts)
    assert checked > 30


# --- the octree: refinement, geometry, native checks -------------------------


def _mask_octree():
    """tests/test_misc.py's octree: the upper half of an 8^3 box INACTIVE,
    2 levels."""
    mask = np.zeros((8, 8, 8), np.int8)
    mask[:4] = 1
    return mask, joctree.build_octree(jnp.asarray(mask), 2)


def test_refine_grid_and_geometry_match_jax():
    case = build_case()
    labels = [T(l) for l in case["labels"]]
    for got, want in zip(octree.refine_grid(labels), joctree.refine_grid(case["jlabels"])):
        exact(got, want)
    for origin in ((0.0, 0.0, 0.0), (0.5, -1.0, 2.0)):
        got = octree.octree_geometry(labels, case["dx"], origin)
        want = joctree.octree_geometry(case["labels"], case["dx"], origin)
        for g, w in zip(got, want):
            exact(g, w)
    empty = octree.octree_geometry([torch.zeros((2, 2, 2), dtype=torch.int8)], 0.5)
    assert [e.shape for e in empty] == [(0, 3), (0,), (0,)]


def test_octree_geometry_for_state_matches_jax(tmp_path):
    jstate = jscenes.buckling(n=16, dtype=jnp.float64)
    cfg = SolverConfig(octree_levels=3)
    path = tmp_path / "state.ply"
    got = solver.octree_geometry_for_state(port_from_jax(jstate), cfg, str(path), device="cpu")
    want = jsolver.octree_geometry_for_state(jstate, JConfig(octree_levels=3))
    for g, w in zip(got, want):
        exact(g, w)
    assert f"element vertex {len(got[0])}\n".encode() in path.read_bytes()[:200]


def test_native_checks_and_ply_match_jax(tmp_path):
    mask, jlabels = _mask_octree()
    labels = octree.build_octree(T(mask), 2)
    for l, jl in zip(labels, jlabels):
        exact(l, jl)
    out, jout = tmp_path / "port.ply", tmp_path / "jax.ply"
    n = native.export_octree_ply(labels, 0.125, str(out))
    jn = jnative.export_octree_ply([np.asarray(l) for l in jlabels], 0.125, str(jout))
    assert n == jn > 0
    data = out.read_bytes()
    assert data.startswith(b"ply\nformat binary_little_endian") and \
        f"element vertex {n}\n".encode() in data[:200]
    if jnative.available():
        assert data == jout.read_bytes()
    assert native.check_octree_invariants(labels) == []
    assert native.check_octree_invariants(labels) == \
        jnative.check_octree_invariants([np.asarray(l) for l in jlabels])
    # a broken pyramid: a lone UP cell among ACTIVE siblings
    broken = [l.clone() for l in labels]
    broken[0][6, 6, 6] = octree.UP
    fails = native.check_octree_invariants(broken)
    assert fails and fails == jnative.check_octree_invariants([N(l) for l in broken])


def test_native_builds_outside_the_package():
    """The extension is built under build/native with a hash of its
    source in its name, never beside the source."""
    path = native.build()
    assert path.parent == native.BUILD_DIR and path.exists()
    assert native.SOURCE.parent not in path.parents
