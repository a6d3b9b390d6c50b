"""PyTorch port vs the JAX package, one ported module at a time.

The same inputs (numpy arrays from the shared ``build_case`` fixture, made
from a seed) go through each JAX function and its counterpart in
``adaptiveviscositysolver_tpu_torch``, both on the CPU in float64.
Integer grids (labels, kinds, DOF indices and counts) must be exactly
equal; float stages agree to rtol 1e-12 (the two frameworks may order or
fuse float operations differently, nothing more).

The JAX side runs eagerly or through jitted calls that existing tests
already make; persistent compile-cache writes are switched off while these
tests run, so they add nothing to the committed cache directory.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adaptiveviscositysolver_tpu import (
    classify as jclassify,
    fields as jfields,
    interpolator as jinterp,
    octree as joctree,
    operator as joperator,
    restriction as jrestriction,
    scenes as jscenes,
    stencils as jstencils,
    topology as jtopology,
    writeback as jwriteback,
)
from adaptiveviscositysolver_tpu import solver as jsolver
from adaptiveviscositysolver_tpu.config import SolverConfig as JConfig, capped_levels as jcapped
from adaptiveviscositysolver_tpu.ops import arrayops as jops
from adaptiveviscositysolver_tpu_torch import (
    classify,
    convert,
    fields,
    interpolator,
    octree,
    operator,
    restriction,
    scenes,
    solver,
    stencils,
    topology,
    writeback,
)
from adaptiveviscositysolver_tpu_torch.config import SolverConfig, capped_levels
from adaptiveviscositysolver_tpu_torch.ops import arrayops as tops
from tests.test_operator import build_case

RTOL = 1e-12


@pytest.fixture(autouse=True, scope="module")
def port_test_env():
    """Keep JAX compiles made here out of the persistent cache directory,
    and run PyTorch on one thread: the suite runs in parallel processes,
    and per-op thread pools on these small tensors only contend."""
    old = jax.config.jax_persistent_cache_min_compile_time_secs
    threads = torch.get_num_threads()
    jax.config.update("jax_persistent_cache_min_compile_time_secs", float("inf"))
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", old)


def T(x):
    """numpy / JAX array -> CPU torch tensor (same dtype)."""
    return torch.as_tensor(np.array(x))


def N(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def exact(got, want, msg=""):
    got, want = N(got), N(want)
    assert got.shape == want.shape, (msg, got.shape, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=msg)


def close(got, want, msg="", rtol=RTOL):
    got, want = N(got), N(want)
    assert got.shape == want.shape, (msg, got.shape, want.shape)
    assert got.dtype == want.dtype, (msg, got.dtype, want.dtype)
    scale = max(float(np.abs(want).max()), 1e-300) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale, err_msg=msg)


@pytest.fixture(scope="module")
def case():
    return build_case()


@pytest.fixture(scope="module")
def port(case):
    """The port's stage outputs on the case's inputs (float64, CPU)."""
    dx, extrap, levels = case["dx"], case["extrap"], case["levels"]
    liquid, solid = T(case["liquid"]), T(case["solid"])
    mask = octree.build_refinement_mask(liquid, solid, dx, extrap, 3 * dx, 2 * dx)
    labels = octree.build_octree(mask, levels)
    # the weights both sides consume downstream are the fixture's (JAX's
    # jitted build may turn the /27 into a multiply by its reciprocal);
    # the weights themselves are compared in test_fields_match_jax
    cw, ew, fw = T(case["cw"]), [T(e) for e in case["ew"]], [T(f) for f in case["fw"]]
    vk = classify.classify_octree_velocity(labels, cw, ew, solid, extrap)
    ek = classify.classify_edge_stress(labels, ew)
    ck = classify.classify_center_stress(labels, cw)
    return dict(mask=mask, labels=labels, cw=cw, ew=ew, fw=fw, vk=vk, ek=ek, ck=ck)


def test_config_and_convert_match_jax():
    for shape, lv in (((16, 16, 16), 4), ((12, 20, 9), 5), ((96, 96, 96), 4), ((1, 8, 8), 3)):
        assert capped_levels(shape, lv) == jcapped(shape, lv)
    jcfg = JConfig(octree_levels=3, tolerance=1e-5, apply_impl="pallas", dtype=jnp.float32)
    cfg = convert.config_from_jax_fields(**dataclasses.asdict(jcfg))
    assert cfg.apply_impl == "cuda" and cfg.dtype == torch.float32
    for f in dataclasses.fields(SolverConfig):
        if f.name not in ("apply_impl", "dtype"):
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert convert.config_from_jax_fields(**dataclasses.asdict(JConfig(cheb_degree=3))) \
        .cheb_degree == 3
    with pytest.raises(ValueError):
        SolverConfig(apply_impl="pallas")


@pytest.mark.parametrize("name", ["beam", "buckling"])
def test_scenes_match_jax(name):
    want = getattr(jscenes, name)(n=16)
    got = getattr(scenes, name)(n=16, device="cpu")
    assert got.dx == want.dx
    for f in ("liquid_sdf", "solid_sdf", "viscosity", "density"):
        exact(getattr(got, f), getattr(want, f), f)
        assert getattr(got, f).dtype == torch.float32
    for a in range(3):
        exact(got.velocity[a], want.velocity[a], f"velocity {a}")
        exact(got.solid_velocity[a], want.solid_velocity[a], f"solid_velocity {a}")


def test_topology_maps_match_jax():
    rng = np.random.default_rng(0)
    for p in rng.integers(2, 30, size=(12, 3)):
        jp, tp = jnp.asarray(p, jnp.int32), torch.as_tensor(p, dtype=torch.int32)
        for axis in range(3):
            for d in (0, 1):
                for fn in ("cell_to_cell", "cell_to_face", "face_to_cell"):
                    exact(getattr(topology, fn)(tp, axis, d),
                          getattr(jtopology, fn)(jp, axis, d), fn)
            for i in range(4):
                for fn in ("cell_to_edge", "edge_to_cell", "face_to_node", "node_to_face",
                           "child_face"):
                    exact(getattr(topology, fn)(tp, axis, i),
                          getattr(jtopology, fn)(jp, axis, i), fn)
            exact(topology.child_edge(tp, axis, 1), jtopology.child_edge(jp, axis, 1))
            for ea in range(3):
                if ea != axis:
                    for d in (0, 1):
                        exact(topology.face_to_edge(tp, axis, ea, d),
                              jtopology.face_to_edge(jp, axis, ea, d))
                        exact(topology.edge_to_face(tp, ea, axis, d),
                              jtopology.edge_to_face(jp, ea, axis, d))
                        exact(topology.child_edge_in_face(tp, axis, ea, d),
                              jtopology.child_edge_in_face(jp, axis, ea, d))
        for i in range(8):
            for fn in ("cell_to_node", "node_to_cell", "child_cell"):
                exact(getattr(topology, fn)(tp, i), getattr(jtopology, fn)(jp, i), fn)
        exact(topology.parent(tp), jtopology.parent(jp))
        exact(topology.child_node(tp), jtopology.child_node(jp))


def test_arrayops_match_jax():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(8, 6, 10))
    jx, tx = jnp.asarray(x), T(x)
    for axis in range(3):
        for off in (-2, -1, 1, 3):
            exact(tops.shift(tx, axis, off, fill=1.5), jops.shift(jx, axis, off, fill=1.5))
        exact(tops.grow(tx, axis, 1, 2, fill=-1.0), jops.grow(jx, axis, 1, 2, fill=-1.0))
        exact(tops.strided_even(tx, axis), jops.strided_even(jx, axis))
        exact(tops.scatter_even(tx, axis, 2 * x.shape[axis] - 1),
              jops.scatter_even(jx, axis, 2 * x.shape[axis] - 1))
        exact(tops.even_snap(tx, axis), jops.even_snap(jx, axis))
        exact(tops.transverse_blocksum(tx, axis), jops.transverse_blocksum(jx, axis))
        fine_shape = tuple(s + (1 if d == axis else 0) for d, s in enumerate(x.shape))
        coarse_shape = jops.face_shape(tuple(s // 2 for s in x.shape), axis)
        f = rng.normal(size=fine_shape)
        c = rng.normal(size=coarse_shape)
        for fn in ("face_child_sum", "face_child_mean"):
            close(getattr(tops, fn)(T(f), axis, coarse_shape),
                  getattr(jops, fn)(jnp.asarray(f), axis, coarse_shape), fn)
            close(getattr(tops, fn + "_adjoint")(T(c), axis, fine_shape),
                  getattr(jops, fn + "_adjoint")(jnp.asarray(c), axis, fine_shape), fn)
    exact(tops.upread(tx, (15, 12, 19)), jops.upread(jx, (15, 12, 19)))
    exact(tops.upread_k(tx, (30, 22, 40), 2), jops.upread_k(jx, (30, 22, 40), 2))
    y = rng.normal(size=(15, 11, 19))
    close(tops.upread_adjoint(T(y), (8, 6, 10)), jops.upread_adjoint(jnp.asarray(y), (8, 6, 10)))
    for op in ("any", "all", "max", "sum"):
        src = x > 0 if op in ("any", "all") else x
        got = tops.down_reduce_cells(T(src), op)
        want = jops.down_reduce_cells(jnp.asarray(src), op)
        close(got, want, op) if op == "sum" else exact(got, want, op)
    for off in ((1, -2, 0), (-3, 0, 2)):
        exact(tops.gather_offset(tx, (9, 5, 12), off, fill=2.0),
              jops.gather_offset(jx, (9, 5, 12), off, fill=2.0))
        exact(tops.scatter_offset(tx, (9, 5, 12), off), jops.scatter_offset(jx, (9, 5, 12), off))


@pytest.mark.parametrize("solid_weights", [False, True])
def test_fields_match_jax(case, solid_weights):
    args = (3, case["extrap"], solid_weights)
    jliquid, jsolid = jnp.asarray(case["liquid"]), jnp.asarray(case["solid"])
    jcw, jew = jfields.integration_weights(jliquid, jsolid, *args)
    cw, ew = fields.integration_weights(T(case["liquid"]), T(case["solid"]), *args)
    close(cw, jcw, "center")
    for a in range(3):
        close(ew[a], jew[a], f"edge {a}")
    jfw = jfields.face_weights(jnp.asarray(case["liquid"]), jnp.asarray(case["solid"]), *args)
    fw = fields.face_weights(T(case["liquid"]), T(case["solid"]), *args)
    for a in range(3):
        close(fw[a], jfw[a], f"face {a}")


def test_octree_matches_jax(case, port):
    dx, extrap = case["dx"], case["extrap"]
    jmask = joctree.build_refinement_mask(jnp.asarray(case["liquid"]), jnp.asarray(case["solid"]),
                                          dx, extrap, 3 * dx, 2 * dx)
    exact(port["mask"], jmask)
    for l in range(case["levels"]):
        exact(port["labels"][l], case["labels"][l], f"labels {l}")
    exact(octree.active_cell_counts(port["labels"]), joctree.active_cell_counts(case["jlabels"]))
    for got, want in zip(octree.occupied_bboxes(port["labels"]),
                         joctree.occupied_bboxes(case["jlabels"])):
        exact(got, want)


def test_classify_matches_jax(case, port):
    for l in range(case["levels"]):
        exact(port["ck"][l], case["ck"][l], f"center {l}")
        for a in range(3):
            exact(port["vk"][l][a], case["vk"][l][a], f"velocity {l} {a}")
            exact(port["ek"][l][a], case["ek"][l][a], f"edge {l} {a}")
    for a in range(3):
        exact(classify.classify_regular_velocity(port["cw"], port["ew"], T(case["solid"]), case["extrap"], a),
              jclassify.classify_regular_velocity(case["jcw"], case["jew"], jnp.asarray(case["solid"]),
                                                  case["extrap"], a), f"regular {a}")
    grids = [k for per in port["vk"] for k in per]
    idx, total = classify.assign_indices(grids)
    jidx, jtotal = jclassify.assign_indices([k for per in case["jvk"] for k in per])
    assert int(total) == int(jtotal)
    for g, w in zip(idx, jidx):
        exact(g, w)


def _port_blocks(case, port, with_weights=True):
    sv = [T(v) for v in case["solid_vel"]]
    visc = T(case["viscosity"])
    return stencils.build_edge_stress_blocks(
        port["labels"], port["vk"], port["ek"], port["ew"], visc, sv, case["dt"], case["dx"],
        case["cfg"], with_weights=with_weights,
    ) + stencils.build_center_stress_blocks(
        port["labels"], port["vk"], port["ck"], port["cw"], visc, sv, case["dt"], case["dx"],
        case["cfg"], with_weights=with_weights,
    )


def _random_u(case, seed):
    rng = np.random.default_rng(seed)
    return {(l, a): np.where(case["vk"][l][a] == jclassify.FLUID,
                             rng.normal(size=case["vk"][l][a].shape), 0.0)
            for l in range(case["levels"]) for a in range(3)}


@pytest.fixture(scope="module")
def jax_system(case):
    """The JAX stencils, mass, Jacobi diagonal, one apply, the boundary rhs
    and the restriction, in ONE jitted program (eager JAX would compile
    every primitive separately, which costs far more here)."""
    rpl = [tuple(l.shape) for l in case["labels"]]
    levels = case["levels"]

    def system(labels, vk, ek, ck, ew, cw, fw, visc, dens, sv, u, guess, vel):
        blocks = jstencils.build_edge_stress_blocks(
            labels, vk, ek, ew, visc, sv, case["dt"], case["dx"], case["cfg"],
        ) + jstencils.build_center_stress_blocks(
            labels, vk, ck, cw, visc, sv, case["dt"], case["dx"], case["cfg"],
        )
        mass = jstencils.build_mass(labels, vk, fw, dens)
        active = {(l, a): vk[l][a] == jclassify.FLUID for l in range(levels) for a in range(3)}
        apply_A, diag = joperator.make_operator(blocks, mass, active, rpl)
        rhs = joperator.boundary_rhs(blocks, mass, guess, active, rpl)
        restricted = jrestriction.restrict_velocity_pyramid(vel, levels)
        return blocks, mass, diag, apply_A(u), rhs, restricted

    u, guess = _random_u(case, 3), _random_u(case, 4)
    args = (case["jlabels"], case["jvk"], case["jek"], case["jck"], case["jew"], case["jcw"],
            case["jfw"], jnp.asarray(case["viscosity"]), jnp.asarray(case["density"]),
            [jnp.asarray(v) for v in case["solid_vel"]],
            {k: jnp.asarray(v) for k, v in u.items()},
            {k: jnp.asarray(v) for k, v in guess.items()},
            [jnp.asarray(v) for v in case["regular_vel"]])
    # backend optimization level 0: the program runs once, and XLA:CPU's
    # optimizing codegen would cost more than it saves
    out = jax.jit(system).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})(*args)
    return dict(zip(("blocks", "mass", "diag", "apply", "rhs", "restricted"), out),
                u=u, guess=guess, rpl=rpl)


@pytest.mark.parametrize("with_weights", [True, False])
def test_stencils_match_jax(case, port, jax_system, with_weights):
    jblocks = jax_system["blocks"]
    blocks = _port_blocks(case, port, with_weights)
    assert len(blocks) == len(jblocks)
    for b, jb in zip(blocks, jblocks):
        assert (b.kind, b.level, b.axis, len(b.terms)) == \
            (jb.kind, jb.level, jb.axis, len(jb.terms))
        for t, jt in zip(b.terms, jb.terms):
            assert (t.lift, t.face_axis, t.src_level, t.offset) == \
                (jt.lift, jt.face_axis, jt.src_level, jt.offset)
            close(t.coeff, jt.coeff, f"{b.kind} {b.level} {b.axis} {t.lift}")
        for name in ("weight", "boundary"):
            got, want = getattr(b, name), getattr(jb, name)
            if not with_weights:
                assert got is None, name
            elif got is None:
                assert want is None, name
            else:
                close(got, want, f"{name} {b.kind} {b.level} {b.axis}")
    if with_weights:
        mass = stencils.build_mass(port["labels"], port["vk"], port["fw"], T(case["density"]))
        for k, v in jax_system["mass"].items():
            close(mass[k], v, f"mass {k}")


def test_restriction_matches_jax(case, jax_system):
    got = restriction.restrict_velocity_pyramid([T(v) for v in case["regular_vel"]], case["levels"])
    for k, want in jax_system["restricted"].items():
        close(got[k], want, f"guess {k}")


def test_operator_matches_jax(case, port, jax_system):
    blocks = _port_blocks(case, port)
    mass = stencils.build_mass(port["labels"], port["vk"], port["fw"], T(case["density"]))
    active = {(l, a): port["vk"][l][a] == classify.FLUID
              for l in range(case["levels"]) for a in range(3)}
    rpl = jax_system["rpl"]
    apply_A, diag = operator.make_operator(blocks, mass, active, rpl)
    for k, want in jax_system["diag"].items():
        close(diag[k], want, f"diag {k}")
    got = apply_A({k: T(v) for k, v in jax_system["u"].items()})
    for k, want in jax_system["apply"].items():
        close(got[k], want, f"apply {k}", rtol=1e-11)
    rhs = operator.boundary_rhs(blocks, mass, {k: T(v) for k, v in jax_system["guess"].items()},
                                active, rpl)
    for k, want in jax_system["rhs"].items():
        close(rhs[k], want, f"rhs {k}", rtol=1e-11)
    # flat packing round trip
    pack, unpack = operator.make_packer({k: tuple(v.shape) for k, v in rhs.items()})
    back = unpack(pack(rhs))
    for k in rhs:
        exact(back[k], rhs[k])


def test_writeback_and_interpolator_match_jax(case, port):
    # the jitted JAX calls are the ones tests/test_interpolator.py makes
    u = _random_u(case, 7)
    tu = {k: T(v) for k, v in u.items()}
    ju = {k: jnp.asarray(v) for k, v in u.items()}
    nv, nl = interpolator.build_node_velocities(port["labels"], tu, port["vk"])
    jnv, jnl = jax.jit(jinterp.build_node_velocities)(case["jlabels"], ju, case["jvk"])
    for l in range(case["levels"]):
        exact(nl[l], jnl[l], f"node labels {l}")
        for f in range(3):
            close(nv[l][f], jnv[l][f], f"node values {l} {f}")
    got = interpolator.interpolate_writeback_fields(port["labels"], tu, port["vk"], case["levels"])
    jfaces = jax.jit(jinterp.interpolate_level0_faces, static_argnums=(4,))
    want = [jfaces(case["jlabels"], ju, case["jvk"], jnv, a) for a in range(3)]
    for a in range(3):
        close(got[a], want[a], f"interpolated {a}")
    rk = [classify.classify_regular_velocity(port["cw"], port["ew"], T(case["solid"]), case["extrap"], a)
          for a in range(3)]
    vel = [T(v) for v in case["regular_vel"]]
    sv = [T(v) for v in case["solid_vel"]]
    out = writeback.apply_to_regular_grid(vel, tu, port["labels"], port["vk"], rk, sv,
                                          case["levels"], got)
    jout = jwriteback.apply_to_regular_grid(
        [jnp.asarray(v) for v in case["regular_vel"]], ju, case["jlabels"], case["jvk"],
        [jnp.asarray(N(k)) for k in rk], [jnp.asarray(v) for v in case["solid_vel"]],
        case["levels"], want)
    for a in range(3):
        close(out[a], jout[a], f"writeback {a}")


def test_solver_host_helpers_match_jax(case):
    st = solver.FluidState(T(case["liquid"]), T(case["solid"]),
                           tuple(T(v) for v in case["regular_vel"]),
                           tuple(T(v) for v in case["solid_vel"]),
                           T(case["viscosity"]), T(case["density"]), case["dx"])
    solver._validate_state(st)
    bad = dataclasses.replace(st, velocity=st.velocity[:2])
    with pytest.raises(ValueError):
        solver._validate_state(bad)
    for shape, lv in (((16, 16, 16), 3), ((13, 20, 9), 4)):
        assert solver.padded_shape(shape, lv) == jsolver.padded_shape(shape, lv)
    small = dataclasses.replace(
        st, liquid_sdf=st.liquid_sdf[:13, :14], solid_sdf=st.solid_sdf[:13, :14],
        viscosity=st.viscosity[:13, :14], density=st.density[:13, :14],
        velocity=tuple(v[:13 + (a == 0), :14 + (a == 1)] for a, v in enumerate(st.velocity)),
        solid_velocity=tuple(v[:13 + (a == 0), :14 + (a == 1)]
                             for a, v in enumerate(st.solid_velocity)))
    target = solver.padded_shape(small.liquid_sdf.shape, 3)
    got = solver._pad_state(small, target)
    jsmall = jsolver.FluidState(
        *(jnp.asarray(N(getattr(small, f))) for f in ("liquid_sdf", "solid_sdf")),
        tuple(jnp.asarray(N(v)) for v in small.velocity),
        tuple(jnp.asarray(N(v)) for v in small.solid_velocity),
        jnp.asarray(N(small.viscosity)), jnp.asarray(N(small.density)), small.dx)
    want = jsolver._pad_state(jsmall, target)
    for f in ("liquid_sdf", "solid_sdf", "viscosity", "density"):
        close(getattr(got, f), getattr(want, f), f)
    for a in range(3):
        close(got.velocity[a], want.velocity[a])
    raw = [np.asarray(b) for b in joctree.occupied_bboxes(case["jlabels"])]
    rpl = [tuple(l.shape) for l in case["labels"]]
    assert solver._tight_windows(raw, rpl) == jsolver._tight_windows(raw, rpl)
    counts = np.asarray(joctree.active_cell_counts(case["jlabels"]))
    for c in (counts, np.array([counts[0], counts[1], 0])):
        assert solver._trim_and_window(c, np.stack(raw), (16, 16, 16)) == \
            jsolver._trim_and_window(c, np.stack(raw), (16, 16, 16))
