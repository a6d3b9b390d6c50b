"""The port's iterative refinement and host face weights vs the JAX
package.

Bars: tests/test_refinement.py's two on the port's functions (the float32
inner apply, the float64 residual to 1e-10; the refined solve within 1e-5
relative of the float64 solve), and the port's refined solve within 1e-5
relative of the JAX package's; a solve handed the JAX package's face
weights equals the port's solve without them (1e-12 relative) and the JAX
solve with them (1e-8 relative, float64).  The JAX refined solve is the
jitted call tests/test_refinement.py makes, so its compile is shared; the
face-weight solve is compiled at backend optimization level 0 (it runs
once).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from adaptiveviscositysolver_tpu import fields as jfields
from adaptiveviscositysolver_tpu.config import SolverConfig as JConfig
from adaptiveviscositysolver_tpu.solver import solve_viscosity as jsolve
from adaptiveviscositysolver_tpu_torch import classify, fields, operator, solver, stencils
from adaptiveviscositysolver_tpu_torch.config import SolverConfig
from tests.test_operator import build_case
from tests.test_solver import state_from_case
from tests.test_torch_solve import port_state
from tests.test_torch_solve_options import _jit
from tests.test_torch_stages import (  # noqa: F401
    N,
    T,
    _port_blocks,
    case,
    close,
    port,
    port_test_env,
)


@pytest.fixture(scope="module")
def small_case():
    return build_case(n=8, levels=2)


@pytest.fixture(scope="module")
def case_system(case, port):
    """build_case()'s operator on the port's side (float64) and a seeded rhs
    on its FLUID faces."""
    levels = case["levels"]
    rpl = [tuple(l.shape) for l in case["labels"]]
    blocks = _port_blocks(case, port)
    mass = stencils.build_mass(port["labels"], port["vk"], port["fw"], T(case["density"]))
    active = {(l, a): port["vk"][l][a] == classify.FLUID for l in range(levels)
              for a in range(3)}
    apply_A, diag = operator.make_operator(blocks, mass, active, rpl)
    rng = np.random.default_rng(7)
    rhs = {k: torch.where(active[k], torch.tensor(rng.normal(size=v.shape)), 0.0)
           for k, v in mass.items()}
    return dict(blocks=blocks, mass=mass, active=active, apply_A=apply_A, diag=diag, rpl=rpl,
                rhs=rhs)


def test_pcg_refined_reaches_beyond_fp32_accuracy(case_system):
    s = case_system
    f32 = torch.float32
    apply_A32, _ = operator.make_operator(solver._cast_blocks(s["blocks"], f32),
                                          {k: v.to(f32) for k, v in s["mass"].items()},
                                          s["active"], s["rpl"])
    inner_dtypes = set()

    def apply_lo_checked(u):
        inner_dtypes.update(v.dtype for v in u.values())
        return apply_A32(u)

    rhs = s["rhs"]
    x0 = {k: torch.zeros_like(v) for k, v in rhs.items()}
    x, iters, rel, _ = operator.pcg_refined(s["apply_A"], apply_lo_checked, rhs, x0, s["diag"],
                                            1e-10, 4000)
    assert inner_dtypes == {f32}, inner_dtypes
    assert iters > 0 and float(rel) <= 1e-10
    r = {k: rhs[k] - v for k, v in s["apply_A"](x).items()}
    num = np.sqrt(sum(float(torch.sum(r[k] * r[k])) for k in r))
    den = np.sqrt(sum(float(torch.sum(rhs[k] * rhs[k])) for k in rhs))
    assert num / den <= 1.5e-10


@pytest.fixture(scope="module")
def refined_solves():
    """build_case()'s frame: the port's float64 v1 and refined solves, and
    the JAX package's refined solve (test_refinement.py's configuration)."""
    case = build_case()
    cfg = SolverConfig(octree_levels=case["levels"], tolerance=1e-9, max_iterations=4000)
    cfg_ref = dataclasses.replace(cfg, use_iterative_refinement=True)
    r64 = solver.solve_viscosity(port_state(case), case["dt"], cfg, device="cpu")
    rref = solver.solve_viscosity(port_state(case), case["dt"], cfg_ref, device="cpu")
    # the very call tests/test_refinement.py makes, so its compile is shared
    jcfg = JConfig(octree_levels=case["levels"], tolerance=1e-9, max_iterations=4000)
    jcfg_ref = dataclasses.replace(jcfg, use_iterative_refinement=True)
    jref = jax.jit(lambda s, t: jsolve(s, t, jcfg_ref))(state_from_case(case), case["dt"])
    return r64, rref, jref


def test_solver_refined_matches_fp64_solve(refined_solves):
    r64, rref, _ = refined_solves
    assert rref.stats.solve_path == "refined" and r64.stats.solve_path == "v1"
    assert rref.stats.residual <= 1e-9
    scale = max(float(v.abs().max()) for v in r64.velocity)
    for a in range(3):
        diff = float((rref.velocity[a] - r64.velocity[a]).abs().max())
        assert diff / scale < 1e-5, (a, diff, scale)


def test_solver_refined_matches_jax_refined(refined_solves):
    _, rref, jref = refined_solves
    assert jref.stats.solve_path == "refined"
    assert rref.stats.octree_dofs == int(jref.stats.octree_dofs)
    scale = max(float(np.abs(np.asarray(v)).max()) for v in jref.velocity)
    for a in range(3):
        diff = np.abs(N(rref.velocity[a]) - np.asarray(jref.velocity[a])).max()
        assert diff / scale < 1e-5, (a, diff, scale)


def test_refinement_routes_to_v1_fused(small_case):
    """Under refinement every impl keeps its route: "cuda" runs the float32
    inner CG through the canonical-box fused apply (so float64 is refused
    for "cuda" only without refinement), "v1-fused" the "v1" operator, and
    "auto" resolves to "v1" off the card."""
    case = small_case
    for impl in ("cuda", "v1-fused", "auto", "v1"):
        cfg = SolverConfig(octree_levels=2, apply_impl=impl, use_iterative_refinement=True)
        sys_ = solver.build_system(port_state(case), case["dt"], cfg, device="cpu")
        assert sys_.impl == ("v1" if impl == "auto" else impl), impl
        assert (sys_.embed_tree is not None) == (impl == "cuda"), impl
        assert sys_.apply_v1 is not None
    with pytest.raises(ValueError, match="float32"):
        solver.build_system(port_state(case), case["dt"],
                            SolverConfig(octree_levels=2, apply_impl="cuda"), device="cpu")


def test_refined_inner_through_fused_apply_matches_jax(refined_solves, monkeypatch):
    """apply_impl="cuda" under refinement: the float32 inner applies go
    through the canonical-box fused apply (its plain version here), the
    residual through float64 "v1"; the solve meets the tolerance and lands
    within 1e-5 relative of the float64 solve and of JAX's refined one."""
    r64, _, jref = refined_solves
    case = build_case()
    cfg = SolverConfig(octree_levels=case["levels"], tolerance=1e-9, max_iterations=4000,
                       use_iterative_refinement=True, apply_impl="cuda")
    inner = []
    make = solver.fused_apply.make_fused_operator

    def make_checked(*a, **kw):
        apply_c, embed_tree, crop_tree = make(*a, **kw)

        def apply_checked(u):
            inner.append({v.dtype for v in u.values()})
            return apply_c(u)
        return apply_checked, embed_tree, crop_tree

    monkeypatch.setattr(solver.fused_apply, "make_fused_operator", make_checked)
    got = solver.solve_viscosity(port_state(case), case["dt"], cfg, device="cpu")
    assert got.stats.solve_path == "refined" and got.stats.residual <= 1e-9
    assert inner and all(d == {torch.float32} for d in inner)
    # the inner applies are the fused ones; the rest are float64 residuals
    assert got.stats.applies > len(inner) > got.stats.iterations
    for want in (r64.velocity, jref.velocity):
        scale = max(float(np.abs(N(v)).max()) for v in want)
        for a in range(3):
            diff = np.abs(N(got.velocity[a]) - N(want[a])).max()
            assert diff / scale < 1e-5, (a, diff, scale)


def test_face_weights_match_internal_and_jax(small_case):
    """The JAX package's fields.face_weights handed in: the port's solve
    equals its solve without them and the JAX solve with them."""
    case = small_case
    jst = state_from_case(case)
    fw = jfields.face_weights(jst.liquid_sdf, jst.solid_sdf, 3, case["extrap"], False)
    cfg = SolverConfig(octree_levels=2, tolerance=1e-8)
    got = solver.solve_viscosity(port_state(case), case["dt"], cfg,
                                 [T(np.asarray(w)) for w in fw], device="cpu")
    plain = solver.solve_viscosity(port_state(case), case["dt"], cfg, device="cpu")
    jcfg = JConfig(octree_levels=2, tolerance=1e-8, apply_impl="v1")
    want = _jit(lambda s, t, w: jsolve(s, t, jcfg, face_weights=w), jst, case["dt"], list(fw))
    assert got.stats.iterations == plain.stats.iterations
    assert abs(got.stats.iterations - int(want.stats.iterations)) <= 1
    scale = max(float(np.abs(np.asarray(v)).max()) for v in want.velocity)
    for a in range(3):
        assert float((got.velocity[a] - plain.velocity[a]).abs().max()) <= 1e-12 * scale
        assert np.abs(N(got.velocity[a]) - np.asarray(want.velocity[a])).max() <= 1e-8 * scale


def test_face_weights_pad_with_the_domain():
    """On a grid the octree pads (13^3 -> 16^3 for 3 levels) the weights
    are zero-padded with it, and make_solver threads them through."""
    state = port_state(build_case(n=16, levels=3))
    cut = dataclasses.replace(
        state, liquid_sdf=state.liquid_sdf[:13, :13, :13], solid_sdf=state.solid_sdf[:13, :13, :13],
        viscosity=state.viscosity[:13, :13, :13], density=state.density[:13, :13, :13],
        velocity=tuple(v[:13 + (a == 0), :13 + (a == 1), :13 + (a == 2)]
                       for a, v in enumerate(state.velocity)),
        solid_velocity=tuple(v[:13 + (a == 0), :13 + (a == 1), :13 + (a == 2)]
                             for a, v in enumerate(state.solid_velocity)))
    cfg = SolverConfig(octree_levels=3, tolerance=1e-8)
    fw = fields.face_weights(cut.liquid_sdf, cut.solid_sdf, 3, 0.5 * cut.dx, False)
    sys_ = solver.build_system(cut, 0.01, cfg, device="cpu", face_weights=fw)
    assert tuple(sys_.state.liquid_sdf.shape) == (16, 16, 16)
    got = solver.make_solver(cfg, device="cpu")(cut, 0.01, fw)
    want = solver.solve_viscosity(cut, 0.01, cfg, fw, device="cpu")
    assert got.stats.iterations == want.stats.iterations
    for a in range(3):
        assert tuple(got.velocity[a].shape) == tuple(cut.velocity[a].shape)
        close(got.velocity[a], want.velocity[a], rtol=1e-10)


