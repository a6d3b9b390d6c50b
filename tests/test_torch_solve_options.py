"""The port's SolverConfig options past the main path vs the JAX package:
the Chebyshev preconditioner, cancellation, the "v1-fused" operator and the
reference-compat boundary component, with the configuration they go
through (refinement and host face weights:
tests/test_torch_refined.py).

The same numpy inputs (made from seeds) go through the JAX function and the
port's, on the CPU in float64 unless a test says otherwise.  Bars: those of
tests/test_precond.py and tests/test_cancel.py on the port's functions;
against JAX, Chebyshev iterations equal on the dense SPD system and within
+-1 on build_case(), solutions within 1e-8 * max|x|; stencil arrays to
rtol 1e-12; a float32 route within 5e-4 relative of float64.  JAX programs
are compiled at backend optimization level 0: each runs once.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adaptiveviscositysolver_tpu import operator as joperator
from adaptiveviscositysolver_tpu import scenes as jscenes
from adaptiveviscositysolver_tpu import stencils as jstencils
from adaptiveviscositysolver_tpu.config import SolverConfig as JConfig
from adaptiveviscositysolver_tpu_torch import (
    classify,
    convert,
    fields,
    octree,
    operator,
    solver,
    stencils,
)
from adaptiveviscositysolver_tpu_torch.config import SolverConfig
from adaptiveviscositysolver_tpu_torch.utils import cancel
from tests.test_operator import build_case
from tests.test_precond import _spd_system
from tests.test_torch_solve import port_state
from tests.test_torch_stages import (  # noqa: F401
    N,
    T,
    _port_blocks,
    case,
    close,
    port,
    port_test_env,
)

O0 = {"xla_backend_optimization_level": 0}


def _jit(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=O0)(*args)


def _dense(a_np):
    """(port apply on grid dicts, JAX apply on pytrees) of a dense matrix."""
    a_t, a_j = torch.tensor(a_np), jnp.asarray(a_np)
    return (lambda t: {(0, 0): a_t @ t[(0, 0)]}), (lambda t: {(0, 0): a_j @ t[(0, 0)]})


def _dense_problem(a_np, b_np):
    port_in = ({(0, 0): torch.tensor(b_np)}, {(0, 0): torch.zeros(len(b_np), dtype=torch.float64)},
               {(0, 0): torch.tensor(np.diag(a_np))})
    jax_in = ({(0, 0): jnp.asarray(b_np)}, {(0, 0): jnp.zeros(len(b_np))},
              {(0, 0): jnp.asarray(np.diag(a_np))})
    return port_in, jax_in


@pytest.fixture(autouse=True)
def _rearm():
    cancel.clear()
    yield
    cancel.clear()


# --- the four tests/test_precond.py bars on the port's functions ---------


def test_chebyshev_matches_jacobi_and_cuts_iterations():
    a_np, b_np = _spd_system()
    apply_a, _ = _dense(a_np)
    (rhs, x0, diag), _ = _dense_problem(a_np, b_np)
    tol = 1e-8
    x_j, it_j, rel_j, applies_j = operator.pcg_flat(apply_a, rhs, x0, diag, tol, 10000)
    x_c, it_c, rel_c, applies_c = operator.pcg_flat(apply_a, rhs, x0, diag, tol, 10000,
                                                    cheb_degree=5)
    assert float(rel_j) <= tol and float(rel_c) <= tol
    want = np.linalg.solve(a_np, b_np)
    atol = 1e-5 * float(np.linalg.norm(want))
    np.testing.assert_allclose(N(x_j[(0, 0)]), want, rtol=1e-4, atol=atol)
    np.testing.assert_allclose(N(x_c[(0, 0)]), want, rtol=1e-4, atol=atol)
    assert it_c * 2.5 < it_j, (it_c, it_j)
    # the applies the code makes: 1 + iterations (Jacobi); the lam_max
    # estimate's 13, the first residual and precond, k per iteration
    assert applies_j == 1 + it_j
    assert applies_c == 13 + 1 + 4 + 5 * it_c


def test_chebyshev_precond_is_spd():
    a_np, _ = _spd_system(n=120, cond=1e3, seed=1)
    a = torch.tensor(a_np)
    invd = torch.tensor(1.0 / np.diag(a_np))
    lam = operator.estimate_lambda_max(lambda v: a @ v, invd,
                                       torch.ones(a_np.shape[0], dtype=torch.float64))
    precond = operator.make_chebyshev_precond(lambda v: a @ v, invd, lam, 4)
    rng = np.random.RandomState(2)
    for _ in range(3):
        u = torch.tensor(rng.randn(a_np.shape[0]))
        v = torch.tensor(rng.randn(a_np.shape[0]))
        lhs, rhs_ = float(torch.dot(u, precond(v))), float(torch.dot(precond(u), v))
        assert abs(lhs - rhs_) <= 1e-8 * max(abs(lhs), 1.0)
        assert float(torch.dot(u, precond(u))) > 0.0


def test_even_degree_is_safe_under_lambda_underestimate():
    a_np, b_np = _spd_system(n=200, cond=1e3, seed=3)
    a = torch.tensor(a_np)
    invd = torch.tensor(1.0 / np.diag(a_np))
    lam_true = float(np.max(np.abs(np.linalg.eigvalsh(a_np / np.diag(a_np)[:, None]))))
    precond = operator.make_chebyshev_precond(lambda v: a @ v, invd,
                                              torch.tensor(0.7 * lam_true), 2)
    rng = np.random.RandomState(4)
    for _ in range(3):
        u = torch.tensor(rng.randn(a_np.shape[0]))
        assert float(torch.dot(u, precond(u))) > 0.0
    apply_a, _ = _dense(a_np)
    (rhs, x0, diag), _ = _dense_problem(a_np, b_np)
    _, it, rel, _ = operator.pcg_flat(apply_a, rhs, x0, diag, 1e-8, 10000, cheb_degree=2)
    assert float(rel) <= 1e-8
    assert it < 10000


def test_config_rejects_even_cheb_degree():
    with pytest.raises(ValueError, match="odd"):
        SolverConfig(cheb_degree=2)
    SolverConfig(cheb_degree=3)
    with pytest.raises(ValueError, match="odd"):
        JConfig(cheb_degree=2)


# --- the port against JAX --------------------------------------------------


@pytest.mark.parametrize("degree", [3, 5])
def test_pcg_flat_matches_jax_on_dense_system(degree):
    """Chebyshev on tests/test_precond.py's system, float64: the same
    iterations, x within 1e-8 * max|x|, and the same lam_max estimate
    (rtol 1e-12).  (Jacobi's count on this system hangs on the last bits
    of the matvec: JAX's own changes with XLA's optimization level,
    tools/dense_cg_counts.py.)"""
    a_np, b_np = _spd_system()
    apply_t, apply_j = _dense(a_np)
    port_in, jax_in = _dense_problem(a_np, b_np)
    x, it, rel, _ = operator.pcg_flat(apply_t, *port_in, 1e-8, 10000, cheb_degree=degree)
    jx, jit_, jrel = _jit(lambda r, x0, d: joperator.pcg_flat(apply_j, r, x0, d, 1e-8, 10000,
                                                              cheb_degree=degree), *jax_in)
    assert it == int(jit_)
    want = np.asarray(jx[(0, 0)])
    assert np.abs(N(x[(0, 0)]) - want).max() <= 1e-8 * np.abs(want).max()
    np.testing.assert_allclose(float(rel), float(jrel), rtol=1e-6)
    invd = 1.0 / np.diag(a_np)
    lam = operator.estimate_lambda_max(lambda v: torch.tensor(a_np) @ v, torch.tensor(invd),
                                       torch.tensor(b_np))
    jlam = joperator.estimate_lambda_max(lambda v: jnp.asarray(a_np) @ v, jnp.asarray(invd),
                                         jnp.asarray(b_np))
    np.testing.assert_allclose(float(lam), float(jlam), rtol=1e-12)


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
    rhs = {k: np.where(case["vk"][k[0]][k[1]] == classify.FLUID, rng.normal(size=v.shape), 0.0)
           for k, v in mass.items()}
    return dict(blocks=blocks, mass=mass, active=active, apply_A=apply_A, diag=diag, rpl=rpl,
                rhs=rhs)


def test_chebyshev_matches_jax_on_build_case(case, case_system):
    """Degree 3 on the adaptive fixture's operator: iterations within +-1,
    x within 1e-8 * max|x| of JAX's (stencils, operator and CG in one
    jitted JAX program)."""
    s = case_system
    rhs = {k: T(v) for k, v in s["rhs"].items()}
    zeros = {k: torch.zeros_like(v) for k, v in rhs.items()}
    x, it, rel, applies = operator.pcg_flat(s["apply_A"], rhs, zeros, s["diag"], 1e-8, 4000,
                                            cheb_degree=3)
    levels, rpl = case["levels"], s["rpl"]

    def jax_solve(vk, ek, ck, ew, cw, fw, visc, dens, sv, r):
        blocks = jstencils.build_edge_stress_blocks(
            case["jlabels"], vk, ek, ew, visc, sv, case["dt"], case["dx"], case["cfg"],
        ) + jstencils.build_center_stress_blocks(
            case["jlabels"], vk, ck, cw, visc, sv, case["dt"], case["dx"], case["cfg"],
        )
        mass = jstencils.build_mass(case["jlabels"], vk, fw, dens)
        active = {(l, a): vk[l][a] == classify.FLUID for l in range(levels) for a in range(3)}
        apply_A, diag = joperator.make_operator(blocks, mass, active, rpl)
        return joperator.pcg_flat(apply_A, r, {k: jnp.zeros_like(v) for k, v in r.items()},
                                  diag, 1e-8, 4000, cheb_degree=3)

    jx, jit_, jrel = _jit(jax_solve, case["jvk"], case["jek"], case["jck"], case["jew"],
                          case["jcw"], case["jfw"], jnp.asarray(case["viscosity"]),
                          jnp.asarray(case["density"]),
                          [jnp.asarray(v) for v in case["solid_vel"]],
                          {k: jnp.asarray(v) for k, v in s["rhs"].items()})
    assert abs(it - int(jit_)) <= 1, (it, int(jit_))
    assert float(rel) <= 1e-8 and applies == 13 + 1 + 2 + 3 * it
    scale = max(float(np.abs(np.asarray(v)).max()) for v in jx.values())
    for k in x:
        assert np.abs(N(x[k]) - np.asarray(jx[k])).max() <= 1e-8 * scale, k


# --- the two tests/test_cancel.py bars --------------------------------------


def test_cancel_stops_at_next_poll():
    a_np, b_np = _spd_system(n=300, cond=1e4, seed=7)
    apply_a, _ = _dense(a_np)
    (rhs, x0, diag), _ = _dense_problem(a_np, b_np)
    x_ref, it_ref, _, _ = operator.pcg_flat(apply_a, rhs, x0, diag, 1e-8, 10000)
    x_p, it_p, _, _ = operator.pcg_flat(apply_a, rhs, x0, diag, 1e-8, 10000, cancel_poll=16)
    assert it_p == it_ref
    assert torch.equal(x_p[(0, 0)], x_ref[(0, 0)])
    assert it_ref > 64
    cancel.request()
    _, it_c, rel_c, _ = operator.pcg_flat(apply_a, rhs, x0, diag, 1e-8, 10000, cancel_poll=16)
    assert it_c == 16 and float(rel_c) > 1e-8
    cancel.clear()
    _, it_again, rel_again, _ = operator.pcg_flat(apply_a, rhs, x0, diag, 1e-8, 10000,
                                                  cancel_poll=16)
    assert it_again == it_ref and float(rel_again) <= 1e-8


def test_cancel_config_knob():
    with pytest.raises(ValueError, match="cancel_poll_iters"):
        SolverConfig(cancel_poll_iters=-1)
    SolverConfig(cancel_poll_iters=50)


def test_cancelled_solve_returns_the_partial_iterate():
    """Through solve_viscosity: a set flag stops the CG at the first poll;
    the residual shows it unconverged."""
    state = port_state(build_case(n=8, levels=2))
    cfg = SolverConfig(octree_levels=2, tolerance=1e-10, cancel_poll_iters=4)
    cancel.request()
    got = solver.solve_viscosity(state, 0.01, cfg, device="cpu")
    assert got.stats.iterations == 4 and got.stats.residual > 1e-10
    cancel.clear()
    again = solver.solve_viscosity(state, 0.01, cfg, device="cpu")
    assert again.stats.iterations > 4 and again.stats.residual <= 1e-10


# --- the compat boundary on test_misc.py's moving solid ---------------------


def test_compat_boundary_matches_jax():
    """build_edge_stress_blocks with compat_edge_boundary_component: the
    boundary arrays against JAX's (rtol 1e-12) on tests/test_misc.py's
    moving-solid buckling-16, and they differ from the default's."""
    st = jscenes.buckling(n=16, dtype=jnp.float64)
    rng = np.random.default_rng(7)
    sv = [0.5 + 0.3 * a + 0.1 * rng.normal(size=v.shape) for a, v in enumerate(st.solid_velocity)]
    dx, levels = st.dx, 2
    extrap = 0.5 * dx
    liquid, solid = T(np.asarray(st.liquid_sdf)), T(np.asarray(st.solid_sdf))
    visc = T(np.asarray(st.viscosity))
    mask = octree.build_refinement_mask(liquid, solid, dx, extrap, 3 * dx, 2 * dx)
    labels = octree.build_octree(mask, levels)
    cw, ew = fields.integration_weights(liquid, solid, 3, extrap, False)
    vk = classify.classify_octree_velocity(labels, cw, ew, solid, extrap)
    ek = classify.classify_edge_stress(labels, ew)
    out = {}
    for compat in (False, True):
        cfg = SolverConfig(octree_levels=levels, compat_edge_boundary_component=compat)
        jcfg = JConfig(octree_levels=levels, compat_edge_boundary_component=compat)
        got = stencils.build_edge_stress_blocks(labels, vk, ek, ew, visc, [T(v) for v in sv],
                                                0.01, dx, cfg)
        want = _jit(lambda lab, vk_, ek_, ew_, vs, sv_: jstencils.build_edge_stress_blocks(
            lab, vk_, ek_, ew_, vs, sv_, 0.01, dx, jcfg),
            [jnp.asarray(N(l)) for l in labels], [[jnp.asarray(N(k)) for k in p] for p in vk],
            [[jnp.asarray(N(k)) for k in p] for p in ek], [jnp.asarray(N(e)) for e in ew],
            jnp.asarray(N(visc)), [jnp.asarray(v) for v in sv])
        for b, jb in zip(got, want):
            if jb.boundary is None:
                assert b.boundary is None
            else:
                close(b.boundary, jb.boundary, f"{compat} {b.level} {b.axis}")
        out[compat] = [b.boundary for b in got if b.boundary is not None]
    assert max(float((p - q).abs().max()) for p, q in zip(out[False], out[True])) > 1e-6


# --- host face weights, v1-fused, Chebyshev through the canonical boxes ----


@pytest.fixture(scope="module")
def small_case():
    return build_case(n=8, levels=2)


def test_v1_fused_matches_v1(small_case):
    case = small_case
    cfg = SolverConfig(octree_levels=2, tolerance=1e-8, apply_impl="v1")
    want = solver.solve_viscosity(port_state(case), case["dt"], cfg, device="cpu")
    got = solver.solve_viscosity(port_state(case), case["dt"],
                                 dataclasses.replace(cfg, apply_impl="v1-fused"), device="cpu")
    assert got.stats.solve_path == "v1-fused" and want.stats.solve_path == "v1"
    assert SolverConfig(apply_impl="v1-fused").fused_apply and not cfg.fused_apply
    assert got.stats.iterations == want.stats.iterations
    for a in range(3):
        close(got.velocity[a], want.velocity[a], rtol=1e-12)


def test_chebyshev_on_canonical_boxes_matches_v1(small_case):
    """cheb_degree=3 on the cuda route (the kernels' plain version, float32,
    on the canonical-box embeddings) against v1 with cheb_degree=3
    (float64): iterations +-2, velocity within 5e-4 relative; the pads of
    every vector stay zero through the preconditioner."""
    case = build_case(n=16, levels=3)
    cfg = SolverConfig(octree_levels=3, tolerance=1e-5, cheb_degree=3)
    want = solver.solve_viscosity(port_state(case), case["dt"],
                                  dataclasses.replace(cfg, apply_impl="v1"), device="cpu")
    f32 = dataclasses.replace(cfg, apply_impl="cuda", dtype=torch.float32)
    got = solver.solve_viscosity(port_state(case), case["dt"], f32, device="cpu")
    assert got.stats.solve_path == "cuda-plain" and want.stats.solve_path == "v1"
    assert abs(got.stats.iterations - want.stats.iterations) <= 2
    assert got.stats.applies == 13 + 1 + 2 + 3 * got.stats.iterations
    assert got.stats.residual <= 1e-5
    scale = max(float(v.abs().max()) for v in want.velocity)
    for a in range(3):
        assert float((got.velocity[a].double() - want.velocity[a]).abs().max()) / scale < 5e-4
    # the preconditioner leaves the canonical pads at zero
    sys_ = solver.build_system(port_state(case), case["dt"], f32, device="cpu")
    shapes = {k: tuple(v.shape) for k, v in sys_.embed_tree(sys_.rhs).items()}
    pack, unpack = operator.make_packer(shapes)

    def A(flat):
        return pack(sys_.apply_A(unpack(flat)))

    b = pack(sys_.embed_tree(sys_.rhs))
    invd = 1.0 / pack(sys_.embed_tree(sys_.diag, fill=1.0))
    lam = operator.estimate_lambda_max(A, invd, b)
    z = unpack(operator.make_chebyshev_precond(A, invd, lam, 3)(b))
    inside = unpack(pack(sys_.embed_tree({k: torch.ones_like(v, dtype=torch.float32)
                                          for k, v in sys_.rhs.items()})))
    for k, v in z.items():
        assert not bool(v[inside[k] == 0].any()), k
    assert float(lam) > 0


def test_config_from_jax_fields_takes_every_field():
    """Every field of the JAX SolverConfig, each off its default, carries
    across: dtype as a torch dtype, "pallas" -> "cuda", "v1-fused" kept."""
    jfields_ = {f.name for f in dataclasses.fields(JConfig)}
    assert jfields_ == {f.name for f in dataclasses.fields(SolverConfig)}
    jcfg = JConfig(octree_levels=3, fine_bandwidth=3, extrapolation=0.75, num_supersamples=2,
                   apply_solid_weights=True, use_enhanced_gradients=False,
                   compat_edge_boundary_component=True, tolerance=1e-6, max_iterations=77,
                   cheb_degree=5, cancel_poll_iters=8, dtype=jnp.float64, apply_impl="v1-fused",
                   use_iterative_refinement=True)
    cfg = convert.config_from_jax_fields(**dataclasses.asdict(jcfg))
    for name in jfields_ - {"dtype"}:
        assert getattr(cfg, name) == getattr(jcfg, name), name
    assert cfg.dtype == torch.float64 and cfg.fused_apply
    assert convert.config_from_jax_fields(
        **dataclasses.asdict(JConfig(apply_impl="pallas"))).apply_impl == "cuda"
