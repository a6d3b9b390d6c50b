"""The port's host tail vs the JAX package: checkpoint files, the FLIP
demo loop, the point interpolator, the octree's refine and geometry
export, and the native checks.

The same numpy inputs go through the JAX function and the port's, on the
CPU in float64.  Bars: checkpoint arrays equal across the two packages
both ways; advection and gravity to rtol 1e-12; one FLIP step (2 levels,
tests/test_misc.py's configuration) with iterations +-1 and velocity within
1e-6 * max; interp_at to rtol 1e-12 on tests/test_interpolator.py's
fixtures; the octree's refinement, geometry and the native checks and PLY
exactly.  The jitted JAX calls are the ones those JAX tests make, so their
compiles are shared.
"""

import dataclasses

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
from adaptiveviscositysolver_tpu_torch.config import SolverConfig
from adaptiveviscositysolver_tpu_torch.models import flip
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


def test_flip_step_matches_jax(flip_state):
    """tests/test_misc.py's loop (2 levels, dt 1/48, 2 frames): each frame's
    iterations within +-1, velocity within 1e-6 * max, the column falling."""
    cfg = JConfig(octree_levels=2, max_iterations=40, tolerance=1e-5)
    want, jstats = jflip.simulate(flip_state, frames=2, dt=1 / 48.0, config=cfg)
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
