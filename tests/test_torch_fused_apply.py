"""The port's fused canonical-box apply (ops/fused_apply.py) vs the JAX
package's whole-array v1 operator.

On the CPU the kernel wrappers run their plain PyTorch version; the CUDA
kernels themselves are held to that plain version on the card by the
``gpu``-marked test here and by chip_smoke.py.  The bar is the one
tests/test_pallas_apply.py holds the Pallas kernel to: float32,
``atol 3e-5 * max|want|`` per (level, axis).

The reference is the JAX package's own chain on each fixture: its stencil
builders (jitted once per configuration) and its v1 operator (jitted, the
coefficients passed as arguments), exactly the operator
tests/test_pallas_apply.py holds the Pallas kernels to.  The port's
stencils are also held to the JAX ones here, on every fixture (rtol 1e-12).
"""

import ctypes
import dataclasses
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adaptiveviscositysolver_tpu import operator as joperator
from adaptiveviscositysolver_tpu import stencils as jstencils
from adaptiveviscositysolver_tpu.ops import pallas_apply as jpa
from adaptiveviscositysolver_tpu.solver import _tight_windows as jtight
from adaptiveviscositysolver_tpu_torch import classify, octree, solver, stencils
from adaptiveviscositysolver_tpu_torch.ops import arrayops as tops
from adaptiveviscositysolver_tpu_torch.ops import fused_apply as fa
from tests.test_operator import build_case
from tests.test_torch_stages import N, T, port_test_env  # noqa: F401

F32 = torch.float32


def _port_system(case):
    """Port stencils/mass/kinds on the case's (JAX-built) weights, f64."""
    liquid, solid = T(case["liquid"]), T(case["solid"])
    dx, extrap, levels = case["dx"], case["extrap"], case["levels"]
    if case["cfg"].octree_levels == 1:
        mask = torch.zeros(liquid.shape, dtype=torch.int8)
    else:
        mask = octree.build_refinement_mask(liquid, solid, dx, extrap, 3 * dx, 2 * dx)
    labels = octree.build_octree(mask, levels)
    cw, ew, fw = T(case["cw"]), [T(e) for e in case["ew"]], [T(f) for f in case["fw"]]
    vk = classify.classify_octree_velocity(labels, cw, ew, solid, extrap)
    ek = classify.classify_edge_stress(labels, ew)
    ck = classify.classify_center_stress(labels, cw)
    sv = [T(v) for v in case["solid_vel"]]
    visc = T(case["viscosity"])
    blocks = stencils.build_edge_stress_blocks(
        labels, vk, ek, ew, visc, sv, case["dt"], dx, case["cfg"],
    ) + stencils.build_center_stress_blocks(
        labels, vk, ck, cw, visc, sv, case["dt"], dx, case["cfg"],
    )
    mass = stencils.build_mass(labels, vk, fw, T(case["density"]))
    active = {(l, a): vk[l][a] == classify.FLUID for l in range(levels) for a in range(3)}
    return dict(labels=labels, vk=vk, ek=ek, ck=ck, blocks=blocks, mass=mass, active=active,
                rpl=[tuple(l.shape) for l in labels])


def _f32(x):
    return x.to(F32) if x is not None and x.is_floating_point() else x


def _jax_blocks(blocks):
    """The port's stencil terms as JAX package StressBlocks (float32)."""
    def j(x):
        return None if x is None else jnp.asarray(N(_f32(x)))

    return [jstencils.StressBlock(
        b.kind, b.level, b.axis, j(b.weight),
        [jstencils.StressTerm(t.lift, t.face_axis, t.src_level, t.offset, j(t.coeff))
         for t in b.terms],
        j(b.boundary)) for b in blocks]


def _v1_apply(blocks, mass, active, u, rpl):
    apply_A, _ = joperator.make_operator(blocks, mass, active, [tuple(r) for r in rpl])
    return apply_A(u)


def _stencils(labels, vk, ek, ck, ew, cw, fw, visc, dens, sv, dt, dx, cfg):
    blocks = jstencils.build_edge_stress_blocks(
        labels, vk, ek, ew, visc, sv, dt, dx, cfg,
    ) + jstencils.build_center_stress_blocks(labels, vk, ck, cw, visc, sv, dt, dx, cfg)
    return blocks, jstencils.build_mass(labels, vk, fw, dens)


# backend optimization level 0: each program runs a few times, and
# XLA:CPU's optimizing codegen would cost more than it saves
_O0 = {"xla_backend_optimization_level": 0}
_jit_v1_apply = jax.jit(_v1_apply, static_argnums=(4,), compiler_options=_O0)
_jit_stencils = jax.jit(_stencils, static_argnums=(10, 11, 12), compiler_options=_O0)


def _jax_system(case):
    """The JAX package's stencils and mass on the case (float64)."""
    return _jit_stencils(
        case["jlabels"], case["jvk"], case["jek"], case["jck"], case["jew"], case["jcw"],
        case["jfw"], jnp.asarray(case["viscosity"]), jnp.asarray(case["density"]),
        [jnp.asarray(v) for v in case["solid_vel"]], case["dt"], case["dx"], case["cfg"])


def _to_f32(tree):
    return jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32) if jnp.issubdtype(a.dtype, jnp.floating) else a, tree)

KINDS = ["adaptive", "uniform", "nosolid", "noenh", "bbox"]


@pytest.fixture(scope="module", params=KINDS)
def fused_case(request):
    kind = request.param
    case = build_case(uniform=(kind == "uniform"), with_solid=(kind != "nosolid"),
                      enhanced=(kind != "noenh"))
    sys_ = _port_system(case)
    bboxes = None
    if kind == "bbox":
        raw = [N(b) for b in octree.occupied_bboxes(sys_["labels"])]
        bboxes = solver._tight_windows(raw, sys_["rpl"])
        assert bboxes == jtight(raw, sys_["rpl"])
    blocks32 = [stencils.StressBlock(b.kind, b.level, b.axis, _f32(b.weight),
                                     [stencils.StressTerm(t.lift, t.face_axis, t.src_level,
                                                          t.offset, _f32(t.coeff))
                                      for t in b.terms], _f32(b.boundary))
                for b in sys_["blocks"]]
    mass32 = {k: v.to(F32) for k, v in sys_["mass"].items()}
    frame, canons = fa.build_frame_data(sys_["labels"], sys_["vk"], sys_["ek"], sys_["ck"],
                                        blocks32, mass32, sys_["rpl"], bboxes=bboxes)
    jblocks, jmass = _jax_system(case)
    return dict(kind=kind, case=case, sys=sys_, blocks32=blocks32, mass32=mass32,
                frame=frame, canons=canons, bboxes=bboxes, jblocks=jblocks, jmass=jmass)


def test_stencils_match_jax_on_every_fixture(fused_case):
    c, s = fused_case, fused_case["sys"]
    assert len(s["blocks"]) == len(c["jblocks"])
    for b, jb in zip(s["blocks"], c["jblocks"]):
        assert (b.kind, b.level, b.axis, len(b.terms)) == (jb.kind, jb.level, jb.axis,
                                                          len(jb.terms))
        pairs = [(t.coeff, jt.coeff) for t, jt in zip(b.terms, jb.terms)]
        pairs += [(b.weight, jb.weight)]
        if jb.boundary is not None:
            pairs += [(b.boundary, jb.boundary)]
        for got, want in pairs:
            want = np.asarray(want)
            np.testing.assert_allclose(N(got), want, rtol=1e-12,
                                       atol=1e-12 * max(np.abs(want).max(), 1e-300),
                                       err_msg=f"{c['kind']} {b.kind} {b.level} {b.axis}")
    for k, v in c["jmass"].items():
        np.testing.assert_allclose(N(s["mass"][k]), np.asarray(v), rtol=1e-12, atol=0)


def test_fused_apply_matches_jax_v1(fused_case):
    c, s = fused_case, fused_case["sys"]
    apply_A, embed_tree, crop_tree = fa.make_fused_operator(
        c["frame"], c["canons"], s["active"], s["rpl"], c["case"]["dx"],
        c["case"]["cfg"].use_enhanced_gradients)
    rng = np.random.default_rng(11)
    u = {k: np.where(N(m), rng.normal(size=m.shape), 0.0).astype(np.float32)
         for k, m in s["active"].items()}
    before = dict(fa.launch_counts)
    got = crop_tree(apply_A(embed_tree({k: torch.from_numpy(v) for k, v in u.items()})))
    assert fa.launch_counts == before  # CPU tensors: the plain version, no launch
    want = _jit_v1_apply(_to_f32(c["jblocks"]), _to_f32(c["jmass"]),
                         {k: jnp.asarray(N(v)) for k, v in s["active"].items()},
                         {k: jnp.asarray(v) for k, v in u.items()},
                         tuple(s["rpl"]))
    for k in sorted(want):
        w, g = np.asarray(want[k]), N(got[k])
        assert g.dtype == np.float32
        scale = max(np.abs(w).max(), 1e-30)
        np.testing.assert_allclose(g, w, rtol=0, atol=3e-5 * scale,
                                   err_msg=f"level/axis {k} ({c['kind']})")


@pytest.mark.parametrize("fused_case", ["adaptive", "bbox"], indirect=True)
def test_frame_data_matches_jax(fused_case):
    """Packed kind bytes, mass and weight boxes equal the JAX package's
    build_frame_data on every logical cell of the window (the box layouts
    differ; the contents may not), and the pads read OUTSIDE."""
    c, s = fused_case, fused_case["sys"]
    jframe, jcanons = jpa.build_frame_data(
        [jnp.asarray(N(l)) for l in s["labels"]],
        [[jnp.asarray(N(k)) for k in per] for per in s["vk"]],
        [[jnp.asarray(N(k)) for k in per] for per in s["ek"]],
        [jnp.asarray(N(k)) for k in s["ck"]],
        _jax_blocks(c["blocks32"]), {k: jnp.asarray(N(v)) for k, v in c["mass32"].items()},
        s["rpl"], bboxes=c["bboxes"])
    assert set(jframe) == set(c["frame"])
    for name, arr in c["frame"].items():
        l = int(name.rsplit("_", 1)[1])
        node = tuple(r + 1 for r in s["rpl"][l])
        got = N(fa.crop(arr, c["canons"][l], node))
        want = np.asarray(jpa.crop(jframe[name], jcanons[l], node))
        np.testing.assert_array_equal(got, want, err_msg=name)
        if name.startswith("kp"):
            assert int(arr[0, 0, 0]) == fa.PACK_FILL and int(arr[-1, -1, -1]) == fa.PACK_FILL


# A host loop over the kernels' per-point math (csrc/fused_apply.cuh is
# __host__ __device__): the same arithmetic and thread-to-sample mapping the
# CUDA kernels run, one thread after another, so the algebra and the level
# and brick addressing are checked here without a card.
HOST_LOOP = r"""
#include "fused_apply.cuh"
extern "C" {
long long host_frame_bytes() { return (long long)sizeof(AvsFrame); }
long long host_level_bytes() { return (long long)sizeof(AvsLevel); }
void host_tau(const AvsFrame* F) {
  for (long long g = 0; g < F->total; ++g) {
    int p[3]; int l = avs::locate(*F, g, p); avs::tau_point(F->lv[l], p, F->enhanced != 0);
  }
}
void host_dt(const AvsFrame* F) {
  for (long long g = 0; g < F->total; ++g) {
    int p[3]; int l = avs::locate(*F, g, p); avs::dt_point(F->lv[l], p, F->enhanced != 0);
  }
}
void host_tau_level(const AvsLevel* L, int enhanced) {
  for (long long t = 0; t < L->count; ++t) {
    int p[3]; avs::sample_of(*L, t, p); avs::tau_point<false>(*L, p, enhanced != 0);
  }
}
void host_dt_level(const AvsLevel* L, int enhanced) {
  for (long long t = 0; t < L->count; ++t) {
    int p[3]; avs::sample_of(*L, t, p); avs::dt_point<false>(*L, p, enhanced != 0);
  }
}
}
"""


@pytest.fixture(scope="module")
def host_kernels(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    assert cxx, "a host C++ compiler is needed to check the kernel math on the CPU"
    d = tmp_path_factory.mktemp("host_kernels")
    (d / "host_loop.cpp").write_text(HOST_LOOP)
    csrc = Path(fa.__file__).resolve().parent.parent / "csrc"
    subprocess.run([cxx, "-O1", "-std=c++17", "-shared", "-fPIC", f"-I{csrc}", "-o",
                    str(d / "libhost.so"), str(d / "host_loop.cpp")], check=True,
                   capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(d / "libhost.so"))
    lib.host_frame_bytes.restype = lib.host_level_bytes.restype = ctypes.c_longlong
    lib.host_tau.argtypes = lib.host_dt.argtypes = [ctypes.c_void_p]
    lib.host_tau_level.argtypes = lib.host_dt_level.argtypes = [ctypes.c_void_p, ctypes.c_int]
    assert lib.host_frame_bytes() == (fa.MAX_LEVELS * fa._LEVEL_WORDS + 3) * 8
    assert lib.host_level_bytes() == fa._LEVEL_WORDS * 8
    return lib


def _close(got, want, what):
    assert set(got) == set(want)
    for n in want:
        scale = max(want[n].abs().max().item(), 1e-30)
        err = (got[n] - want[n]).abs().max().item()
        assert err <= 3e-5 * scale, (what, n, err, scale)


def test_kernel_math_on_host_matches_plain(fused_case, host_kernels):
    """csrc's tau_point / dt_point, compiled for the CPU and fed the same
    descriptor words the CUDA launches get, equal tau_plain / dt_plain: the
    all-level launches, and the level launches over a whole level
    ("split") and brick by brick (4-row bricks; the scratch of each holds
    the brick plus the halo, from its own first row)."""
    c, s = fused_case, fused_case["sys"]
    enh = c["case"]["cfg"].use_enhanced_gradients
    apply_A, embed_tree, _ = fa.make_fused_operator(c["frame"], c["canons"], s["active"],
                                                    s["rpl"], c["case"]["dx"], enh)
    g = torch.Generator().manual_seed(1)
    u = embed_tree({k: torch.randn(m.shape, generator=g) * m for k, m in s["active"].items()})
    args, metas = apply_A.level_args(u), apply_A.metas
    taus = [{n: torch.empty(m.shape) for n in ("wte0", "wte1", "wte2", "wtc0", "wtc1", "wtc2")}
            for m in metas]
    words, _ = fa._frame([{**a, **t} for a, t in zip(args, taus)], metas, enh)
    host_kernels.host_tau(words.ctypes.data)
    outs = [{n: torch.empty(m.shape) for n in
             [f"out{f}" for f in range(3)]
             + ([f"zp{f}" for f in range(3)] if m.has_parent else [])
             + ([f"zc{f}" for f in range(3)] if m.has_child else [])} for m in metas]
    words, _ = fa._frame([{**a, **t, **o} for a, t, o in zip(args, taus, outs)], metas, enh)
    host_kernels.host_dt(words.ctypes.data)
    want_t = fa._plain_tau(args, metas, enh)
    want_o = fa._plain_dt(args, taus, metas, enh)
    for l in range(len(metas)):
        _close(taus[l], want_t[l], (c["kind"], l))
        _close(outs[l], want_o[l], (c["kind"], l))
    for l, (a, meta, canon) in enumerate(zip(args, metas, c["canons"])):
        for brick in (None, 4):
            out = fa.dt_outputs(meta, "cpu")
            for rows in dataclasses.replace(canon, brick=brick).row_ranges():
                t0, t1 = fa.tau_rows(rows, meta.shape[0])
                tau = {n: torch.empty((t1 - t0,) + meta.shape[1:]) for n in fa.TAU_NAMES}
                words = fa._level_words({**a, **tau}, meta, rows=(t0, t1), tau_x0=t0,
                                        tau_nx=t1 - t0)
                host_kernels.host_tau_level(words.ctypes.data, int(enh))
                _close(tau, {n: want_t[l][n][t0:t1] for n in fa.TAU_NAMES},
                       (c["kind"], l, brick, rows))
                words = fa._level_words({**a, **tau, **out}, meta, rows=rows, tau_x0=t0,
                                        tau_nx=t1 - t0)
                host_kernels.host_dt_level(words.ctypes.data, int(enh))
            _close(out, want_o[l], (c["kind"], l, brick))


@pytest.mark.parametrize("f", [0, 1, 2])
def test_glue_matches_logical_maps(f):
    """Canonical-to-canonical views equal the logical upread / child sum on
    the receiving window, and the adjoints are exact adjoints."""
    resf = (24, 16, 16)
    resc = tuple(r // 2 for r in resf)
    for bbf, bbc in ((None, None), (((0, 20), (0, 16), (2, 14)), ((2, 10), (0, 8), (2, 6)))):
        cf, cc = fa.make_canon(resf, bbf), fa.make_canon(resc, bbc)
        fsf, fsc = tops.face_shape(resf, f), tops.face_shape(resc, f)
        rng = np.random.default_rng(3 + f)
        winf = fa.embed(torch.ones(fsf), cf, 0.0)
        winc = fa.embed(torch.ones(fsc), cc, 0.0)
        uc = torch.from_numpy(rng.normal(size=cc.shape)) * winc
        uf = torch.from_numpy(rng.normal(size=cf.shape)) * winf
        up = fa.up_view(uc, cc, cf)
        want = fa.embed(tops.upread(fa.crop(uc, cc, fsc), fsf), cf, 0.0)
        torch.testing.assert_close(up * winf, want, rtol=1e-12, atol=1e-12)
        cs = fa.cs_view(uf, cf, cc, f)
        want = fa.embed(tops.face_child_sum(fa.crop(uf, cf, fsf), f, fsc), cc, 0.0)
        torch.testing.assert_close(cs * winc, want, rtol=1e-12, atol=1e-12)
        zf = torch.from_numpy(rng.normal(size=cf.shape))
        zc = torch.from_numpy(rng.normal(size=cc.shape))
        lhs = (fa.up_view(zc, cc, cf) * zf).sum()
        rhs = (zc * fa.up_adjoint(zf, cf, cc)).sum()
        torch.testing.assert_close(lhs, rhs, rtol=1e-12, atol=1e-12)
        lhs = (fa.cs_view(zf, cf, cc, f) * zc).sum()
        rhs = (zf * fa.cs_adjoint(zc, cc, cf, f)).sum()
        torch.testing.assert_close(lhs, rhs, rtol=1e-12, atol=1e-12)


def test_wrappers_take_the_plain_version_only_on_cpu():
    meta = fa.LevelMeta(0, (4, 4, 4), 0.5, False, False, (3, 3, 3))
    args = {n: torch.zeros(meta.shape, dtype=torch.int8 if n.startswith("kp") else F32,
                           device="meta") for n in fa.level_input_names(meta)}
    with pytest.raises(ValueError):
        fa.fused_tau([args], [meta], True)


def test_kernel_bytes_count_the_logical_window():
    """The byte bound counts each level's window (cells + closing face
    row), whatever the canonical pad: one uncropped 4^3 level by hand, a
    cropped two-level pair below the same pair uncropped, and a level's
    bricks summing to the level (the halo rows are not the work's)."""
    (meta,) = fa.level_metas([fa.make_canon((4, 4, 4))], 0.5)
    assert meta.win == (4, 4, 4) and meta.shape != meta.win
    face, edge, cell, node = 3 * 5 * 16, 3 * 4 * 25, 64, 125
    assert fa.kernel_bytes([meta]) == {
        "tau": 4 * face + 4 * (edge + cell) + 3 * node + 4 * (edge + 3 * cell),
        "dt": 4 * (edge + 3 * cell) + 8 * face + 3 * node + 4 * face}
    canons = [fa.make_canon((16, 16, 16), ((2, 12), (4, 16), (0, 10))),
              fa.make_canon((8, 8, 8), ((0, 6), (2, 8), (0, 6)))]
    metas = fa.level_metas(canons, 0.5)
    assert [m.win for m in metas] == [(10, 12, 10), (6, 6, 6)]
    both = fa.kernel_bytes(metas)
    assert all(both[k] < fa.kernel_bytes([dataclasses.replace(m, win=(16 >> m.level,) * 3)
                                          for m in metas])[k] for k in both)
    for brick in (2, 4, 6):
        ranges = dataclasses.replace(canons[0], brick=brick).row_ranges()
        for count in (fa.kernel_bytes, lambda ms, rows=None: fa.kernel_flops(ms, True, rows)):
            parts = [count(metas[:1], rows) for rows in ranges]
            assert {k: sum(p[k] for p in parts) for k in ("tau", "dt")} == count(metas[:1])
    assert fa.kernel_bytes(metas[:1], (0, fa.PAD)) == {"tau": 0, "dt": 0}


def test_descriptor_layout_matches_header():
    """The int64 words fa._frame writes line up with csrc's AvsLevel."""
    src = (Path(fa.__file__).resolve().parent.parent / "csrc" / "fused_apply.cuh").read_text()
    body = re.search(r"struct AvsLevel \{(.*?)\};", src, re.S).group(1)
    words = []
    for decl in re.findall(r"^\s*([^/\n][^;]*);", body, re.M):
        for var in decl.split(","):
            m = re.search(r"(\w+)(?:\[(\d+)\])?\s*$", var.strip())
            name, count = m.group(1), int(m.group(2) or 1)
            words += [f"{name}{i}" if count > 1 else name for i in range(count)]
    ptrs = words[:len(fa._PTR_FIELDS)]
    # header names: u0.. up0.. cs0.. kp0.. we0.. wc m0.. wte0.. wtc0.. out0.. zp0.. zc0..
    assert ptrs == fa._PTR_FIELDS
    assert words[35:] == ["cx", "cy", "cz", "start", "count", "has_parent", "has_child",
                          "inv_dxw", "row0", "tau_x0", "tau_nx"]
    assert len(words) == fa._LEVEL_WORDS
    assert re.search(r"#define AVS_MAX_LEVELS (\d+)", src).group(1) == str(fa.MAX_LEVELS)


@pytest.mark.gpu
def test_kernels_match_plain_on_card():
    """fused_tau / fused_dt on the card equal their plain version on the
    same inputs (3e-5 * max per level and output)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    case = build_case(n=16, levels=3)
    s = _port_system(case)
    blocks32 = [stencils.StressBlock(b.kind, b.level, b.axis, _f32(b.weight),
                                     [stencils.StressTerm(t.lift, t.face_axis, t.src_level,
                                                          t.offset, _f32(t.coeff))
                                      for t in b.terms], _f32(b.boundary))
                for b in s["blocks"]]
    mass32 = {k: v.to(F32) for k, v in s["mass"].items()}
    frame, canons = fa.build_frame_data(s["labels"], s["vk"], s["ek"], s["ck"], blocks32,
                                        mass32, s["rpl"])
    dev = torch.device("cuda")
    frame = {k: v.to(dev) for k, v in frame.items()}
    active = {k: v.to(dev) for k, v in s["active"].items()}
    apply_A, embed_tree, _ = fa.make_fused_operator(frame, canons, active, s["rpl"],
                                                    case["dx"], True)
    g = torch.Generator(device="cpu").manual_seed(0)
    u = embed_tree({k: torch.randn(m.shape, generator=g).to(dev) * m for k, m in active.items()})
    args = apply_A.level_args(u)
    metas = apply_A.metas
    taus = fa.fused_tau(args, metas, True)
    outs = fa.fused_dt(args, taus, metas, True)
    for l, (a, m) in enumerate(zip(args, metas)):
        wte, wtc = fa.tau_plain(a, m, True)
        for i in range(3):
            for got, want in ((taus[l][f"wte{i}"], wte[i]), (taus[l][f"wtc{i}"], wtc[i])):
                scale = max(want.abs().max().item(), 1e-30)
                assert (got - want).abs().max().item() <= 3e-5 * scale
        out, zp, zc = fa.dt_plain(a, [taus[l][f"wte{i}"] for i in range(3)],
                                  [taus[l][f"wtc{i}"] for i in range(3)], m, True)
        for name, ref in (("out", out), ("zp", zp), ("zc", zc)):
            if ref is None:
                continue
            for i in range(3):
                scale = max(ref[i].abs().max().item(), 1e-30)
                assert (outs[l][f"{name}{i}"] - ref[i]).abs().max().item() <= 3e-5 * scale
