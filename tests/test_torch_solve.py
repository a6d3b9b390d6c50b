"""The port's whole slice, solve_viscosity and make_solver, vs the JAX
package's solve.

On the CPU the port runs either the whole-array operator ("v1", float64)
or the canonical-box fused apply through the kernels' plain version
("cuda" on CPU tensors, float32).  Bars: velocity within rel 5e-4 of the
JAX solve (the fp32 bar of tests/test_pallas_apply.py), identical DOF
counts, CG iterations within +-2.  The JAX solve is the jitted call
tests/test_pallas_apply.py already makes, so its compile is shared.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from adaptiveviscositysolver_tpu.config import SolverConfig as JConfig
from adaptiveviscositysolver_tpu.solver import solve_viscosity as jsolve
from adaptiveviscositysolver_tpu_torch import convert, scenes, solver
from adaptiveviscositysolver_tpu_torch.config import SolverConfig
from adaptiveviscositysolver_tpu_torch.ops import fused_apply as fa
from tests.test_operator import build_case
from tests.test_solver import rigid_rotation_faces, state_from_case
from tests.test_torch_stages import N, port_test_env  # noqa: F401


def port_state(case, velocity=None, dtype=None):
    return convert.fluid_state_from_numpy(
        case["liquid"], case["solid"], case["regular_vel"] if velocity is None else velocity,
        case["solid_vel"], case["viscosity"], case["density"], case["dx"], device="cpu",
        dtype=dtype)


@pytest.fixture(scope="module")
def jax_solution():
    case = build_case(n=8, levels=2)
    cfg = JConfig(octree_levels=case["levels"], tolerance=1e-5, apply_impl="v1-fused")
    want = jax.jit(lambda s, t: jsolve(s, t, cfg))(state_from_case(case), case["dt"])
    return case, cfg, want


@pytest.mark.parametrize("impl", ["v1", "cuda"])
def test_solve_matches_jax(jax_solution, impl):
    case, jcfg, want = jax_solution
    cfg = convert.config_from_jax_fields(**dataclasses.asdict(jcfg))
    dtype = torch.float32 if impl == "cuda" else None
    cfg = dataclasses.replace(cfg, apply_impl=impl, dtype=dtype)
    got = solver.solve_viscosity(port_state(case), case["dt"], cfg, device="cpu")
    assert got.stats.solve_path == ("cuda-plain" if impl == "cuda" else "v1")
    assert got.stats.octree_dofs == int(want.stats.octree_dofs)
    assert got.stats.regular_dofs == int(want.stats.regular_dofs)
    assert abs(got.stats.iterations - int(want.stats.iterations)) <= 2
    assert got.stats.residual <= 1e-5
    assert got.stats.applies == got.stats.iterations + 1
    scale = max(float(np.abs(np.asarray(v)).max()) for v in want.velocity)
    for a in range(3):
        g = N(got.velocity[a]).astype(np.float64)
        w = np.asarray(want.velocity[a])
        assert g.shape == w.shape
        assert np.abs(g - w).max() / scale < 5e-4, a


@pytest.mark.parametrize("impl", ["v1", "cuda"])
def test_rigid_rotation_is_exact_solution(impl):
    """Rigid motion has zero strain rate: 0 CG iterations, and writeback
    reproduces the input at every written face (tests/test_solver.py)."""
    case = build_case(n=8, levels=2, with_solid=False)
    rigid = rigid_rotation_faces(case["n"], case["dx"])
    dtype = torch.float32 if impl == "cuda" else None
    cfg = SolverConfig(octree_levels=case["levels"], tolerance=1e-6, apply_impl=impl, dtype=dtype)
    res = solver.solve_viscosity(port_state(case, rigid), 0.01, cfg, device="cpu")
    assert res.stats.iterations == 0
    sys_ = solver.build_system(port_state(case, rigid), 0.01, cfg, device="cpu")
    tol = dict(rtol=1e-5, atol=1e-6) if impl == "cuda" else dict(rtol=1e-7, atol=1e-9)
    for a in range(3):
        written = N(sys_.regular_kinds[a]) == 0
        assert written.any()
        np.testing.assert_allclose(N(res.velocity[a]).astype(np.float64)[written],
                                   rigid[a][written], **tol, err_msg=f"axis {a}")


def test_make_solver_trims_and_crops():
    """make_solver: empty top levels trimmed, the fused apply cropped to the
    occupied windows, same answer as the uncropped whole-array solve."""
    state = scenes.beam(n=32, dtype=torch.float32, device="cpu")
    cfg = SolverConfig(octree_levels=4, tolerance=1e-5)
    lv, windows = solver.probe_topology(state, cfg, device="cpu")
    # two of four levels hold ACTIVE cells; the beam fills a corner of the
    # domain, so the windows are cropped away from the origin
    assert lv == 2 and len(windows) == lv
    assert any(w[d][0] > 0 for w in windows for d in range(3))
    before = dict(fa.launch_counts)
    got = solver.make_solver(dataclasses.replace(cfg, apply_impl="cuda"), device="cpu")(
        state, 0.02)
    assert fa.launch_counts == before
    want = solver.solve_viscosity(state, 0.02, dataclasses.replace(cfg, apply_impl="v1"),
                                  device="cpu")
    assert got.stats.solve_path == "cuda-plain"
    assert len(got.stats.active_cells) == lv
    assert (got.stats.octree_dofs, got.stats.regular_dofs) == \
        (want.stats.octree_dofs, want.stats.regular_dofs)
    assert abs(got.stats.iterations - want.stats.iterations) <= 2
    scale = max(float(v.abs().max()) for v in want.velocity)
    for a in range(3):
        assert float((got.velocity[a] - want.velocity[a]).abs().max()) / scale < 5e-4


def trimmed_cropped_case(n=24):
    """A beam-like slab anchored to a wall: a 4-level solve trims to 2
    levels, and both levels' windows start away from the origin."""
    from adaptiveviscositysolver_tpu.scenes import _box_sdf

    rng = np.random.default_rng(0)
    dx = 1.0 / n
    x = (np.arange(n) + 0.5) * dx
    X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
    fs = [tuple(n + (d == a) for d in range(3)) for a in range(3)]
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return dict(n=n, dx=dx, dt=0.01,
                liquid=f32(_box_sdf(X, Y, Z, (0.05, 0.5, 0.25), (0.7, 0.95, 0.75))),
                solid=f32(X - 0.08), viscosity=f32(1.0 + 0.5 * X), density=f32(1.0 + 0.3 * Z),
                regular_vel=[f32(rng.normal(size=s)) for s in fs],
                solid_vel=[np.zeros(s, np.float32) for s in fs])


def test_make_solver_matches_jax_make_solver():
    """The port's make_solver (level trim, pad to the configured level
    count, crop windows, fused apply through the kernels' plain version)
    vs the JAX make_solver's first frame on the same float32 inputs."""
    from adaptiveviscositysolver_tpu.solver import make_solver as jmake_solver
    from adaptiveviscositysolver_tpu.solver import probe_topology as jprobe

    case = trimmed_cropped_case()
    jcfg = JConfig(octree_levels=4, tolerance=1e-5, dtype=jax.numpy.float32)
    cfg = SolverConfig(octree_levels=4, tolerance=1e-5, dtype=torch.float32, apply_impl="cuda")
    lv, windows = solver.probe_topology(port_state(case), cfg, device="cpu")
    assert (lv, windows) == jprobe(state_from_case(case), jcfg)
    assert lv == 2 and all(w[1][0] > 0 for w in windows)
    want = jmake_solver(jcfg, async_probe=False)(state_from_case(case), case["dt"])
    got = solver.make_solver(cfg, device="cpu")(port_state(case), case["dt"])
    assert got.stats.solve_path == "cuda-plain"
    assert list(got.stats.active_cells) == [int(c) for c in want.stats.active_cells]
    assert got.stats.octree_dofs == int(want.stats.octree_dofs)
    assert got.stats.regular_dofs == int(want.stats.regular_dofs)
    assert abs(got.stats.iterations - int(want.stats.iterations)) <= 2
    assert got.stats.residual <= 1e-5
    scale = max(float(np.abs(np.asarray(v)).max()) for v in want.velocity)
    for a in range(3):
        g = N(got.velocity[a]).astype(np.float64)
        w = np.asarray(want.velocity[a], np.float64)
        assert g.shape == w.shape
        assert np.abs(g - w).max() / scale < 5e-4, a


@pytest.mark.gpu
def test_solve_on_card_matches_cpu():
    """The slice on the card (hand-written kernels) vs the same solve on the
    CPU (their plain version)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    state = scenes.buckling(n=32, device="cpu")
    cfg = SolverConfig(octree_levels=4, tolerance=1e-5, apply_impl="cuda")
    fa.reset_launch_counts()
    got = solver.make_solver(cfg, device="cuda")(state, 0.02)
    assert got.stats.solve_path == "cuda"
    assert fa.launch_counts["fused_tau"] == got.stats.applies
    assert fa.launch_counts["fused_dt"] == got.stats.applies
    want = solver.make_solver(cfg, device="cpu")(state, 0.02)
    assert abs(got.stats.iterations - want.stats.iterations) <= 2
    scale = max(float(v.abs().max()) for v in want.velocity)
    for a in range(3):
        assert float((got.velocity[a].cpu() - want.velocity[a]).abs().max()) / scale < 5e-4
