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
from adaptiveviscositysolver_tpu_torch import classify, octree, scenes, solver, stencils
from adaptiveviscositysolver_tpu_torch.config import SolverConfig
from adaptiveviscositysolver_tpu_torch.ops import arrayops as tops
from adaptiveviscositysolver_tpu_torch.ops import fused_apply as fa
from adaptiveviscositysolver_tpu_torch.ops.arrayops import face_shape
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


# A host loop over the kernels' math (csrc/tau_tile.cuh, csrc/dt_tile.cuh
# and their plumbing are __host__ __device__): each tiled routine block after
# block, run as one thread on a host buffer for its shared memory, staging
# included, so the algebra, the level and brick addressing and the tile
# reach are checked here without a card.  The tile extents (TAU_TILE,
# DT_TILE) leave partial tiles at the fixtures' box ends.
TAU_TILE = (4, 6, 8)
DT_TILE = (6, 4, 10)
HOST_LOOP = r"""
#include "dt_tile.cuh"
#include "tau_tile.cuh"
static float tau_smem[avs::kTauSmemBytes / 4];
static float dt_smem[avs::kDtSmemBytes / 4];
extern "C" {
long long host_frame_bytes() { return (long long)sizeof(AvsFrame); }
long long host_level_bytes() { return (long long)sizeof(AvsLevel); }
long long host_reach_faults() { return avs::avs_host_reach_faults; }
void host_tau(const AvsFrame* F) {
  for (long long b = 0; b < avs::frame_tiles<avs::TauShape>(*F); ++b) {
    int o[3]; const int l = avs::locate_tile<avs::TauShape>(*F, b, o);
    if (F->enhanced) avs::tau_tile_block<true>(F->lv[l], o, tau_smem, 0, 1);
    else avs::tau_tile_block<false>(F->lv[l], o, tau_smem, 0, 1);
  }
}
void host_tau_level(const AvsLevel* L, int enhanced) {
  for (long long b = 0; b < avs::tile_count<avs::TauShape>(*L); ++b) {
    int o[3]; avs::tile_origin<avs::TauShape>(*L, b, o);
    if (enhanced) avs::tau_tile_block<true>(*L, o, tau_smem, 0, 1);
    else avs::tau_tile_block<false>(*L, o, tau_smem, 0, 1);
  }
}
void host_dt(const AvsFrame* F) {
  for (long long b = 0; b < avs::frame_tiles<avs::DtShape>(*F); ++b) {
    int o[3]; const int l = avs::locate_tile<avs::DtShape>(*F, b, o);
    avs::dt_tile_block(F->lv[l], o, F->enhanced != 0, dt_smem, 0, 1);
  }
}
void host_dt_level(const AvsLevel* L, int enhanced) {
  for (long long b = 0; b < avs::tile_count<avs::DtShape>(*L); ++b) {
    int o[3]; avs::tile_origin<avs::DtShape>(*L, b, o);
    avs::dt_tile_block(*L, o, enhanced != 0, dt_smem, 0, 1);
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
    tile = [f"-DAVS_{k}_T{ax}={n}" for k, ext in (("TAU", TAU_TILE), ("DT", DT_TILE))
            for ax, n in zip("XYZ", ext)]
    subprocess.run([cxx, "-O1", "-std=c++17", "-shared", "-fPIC", f"-I{csrc}", *tile, "-o",
                    str(d / "libhost.so"), str(d / "host_loop.cpp")], check=True,
                   capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(d / "libhost.so"))
    lib.host_frame_bytes.restype = lib.host_level_bytes.restype = ctypes.c_longlong
    lib.host_reach_faults.restype = ctypes.c_longlong
    lib.host_tau.argtypes = lib.host_dt.argtypes = [ctypes.c_void_p]
    lib.host_tau_level.argtypes = lib.host_dt_level.argtypes = [ctypes.c_void_p, ctypes.c_int]
    assert lib.host_frame_bytes() == (fa.MAX_LEVELS * fa._LEVEL_WORDS + 2) * 8
    assert lib.host_level_bytes() == fa._LEVEL_WORDS * 8
    return lib


def _nan_outputs(meta):
    """D^T output buffers filled with NaN: an element the routine does not
    write fails the comparison."""
    return {n: torch.full(meta.shape, float("nan")) for n in fa._dt_output_names(meta)}


def _nan_tau(meta, rows=None):
    """Weighted-stress buffers of x rows ``rows`` (all by default), NaN."""
    nx = meta.shape[0] if rows is None else rows[1] - rows[0]
    return {n: torch.full((nx,) + tuple(meta.shape[1:]), float("nan")) for n in fa.TAU_NAMES}


def _window(s, canons, l, f):
    return fa.embed(torch.ones(face_shape(s["rpl"][l], f), dtype=torch.bool), canons[l], False)


def _close(got, want, what):
    assert set(got) == set(want)
    for n in want:
        scale = max(want[n].abs().max().item(), 1e-30)
        err = (got[n] - want[n]).abs().max().item()
        assert err <= 3e-5 * scale, (what, n, err, scale)


def _host_matches_plain(host, args, metas, canons, enh, windows, what):
    """csrc's tiled tau and D^T routines on the host, fed the same
    descriptor words the CUDA launches get, against tau_plain / dt_plain:
    the all-level launches, and the level launches over a whole level
    ("split") and brick by brick (4-row bricks; the scratch of each holds
    the brick plus the halo, from its own first row).  Every output starts
    as NaN, so every element of the launch's rows is written; out is
    exactly 0 off the windows (``windows[l][f]``, the pads); no read leaves
    a tile's staged region."""
    taus = [_nan_tau(m) for m in metas]
    words = fa._frame([{**a, **t} for a, t in zip(args, taus)], metas, enh)
    faults = host.host_reach_faults()
    host.host_tau(words.ctypes.data)
    outs = [_nan_outputs(m) for m in metas]
    words = fa._frame([{**a, **t, **o} for a, t, o in zip(args, taus, outs)], metas, enh)
    host.host_dt(words.ctypes.data)
    want_t = fa._plain_tau(args, metas, enh)
    want_o = fa._plain_dt(args, taus, metas, enh)
    for l in range(len(metas)):
        _close(taus[l], want_t[l], (what, l))
        _close(outs[l], want_o[l], (what, l))
        for f in range(3):
            assert not outs[l][f"out{f}"][~windows[l][f]].any(), (what, l, f)
    for l, (a, meta, canon) in enumerate(zip(args, metas, canons)):
        for brick in (None, 4):
            out = _nan_outputs(meta)
            for rows in dataclasses.replace(canon, brick=brick).row_ranges():
                t0, t1 = fa.tau_rows(rows, meta.shape[0])
                tau = _nan_tau(meta, (t0, t1))
                words = fa._level_words({**a, **tau}, meta, rows=(t0, t1), tau_x0=t0,
                                        tau_nx=t1 - t0)
                host.host_tau_level(words.ctypes.data, int(enh))
                _close(tau, {n: want_t[l][n][t0:t1] for n in fa.TAU_NAMES},
                       (what, l, brick, rows))
                words = fa._level_words({**a, **tau, **out}, meta, rows=rows, tau_x0=t0,
                                        tau_nx=t1 - t0)
                host.host_dt_level(words.ctypes.data, int(enh))
            _close(out, want_o[l], (what, l, brick))
    assert host.host_reach_faults() == faults, what


def test_kernel_math_on_host_matches_plain(fused_case, host_kernels):
    """The host build of the kernels' math against the plain versions on
    every fixture (see _host_matches_plain), with tile extents that leave a
    partial tile on some axis of some level."""
    c, s = fused_case, fused_case["sys"]
    enh = c["case"]["cfg"].use_enhanced_gradients
    apply_A, embed_tree, _ = fa.make_fused_operator(c["frame"], c["canons"], s["active"],
                                                    s["rpl"], c["case"]["dx"], enh)
    g = torch.Generator().manual_seed(1)
    u = embed_tree({k: torch.randn(m.shape, generator=g) * m for k, m in s["active"].items()})
    metas = apply_A.metas
    for tile in (TAU_TILE, DT_TILE):
        assert any(m.shape[d] % tile[d] for m in metas for d in range(3))
    windows = [[_window(s, c["canons"], l, f) for f in range(3)] for l in range(len(metas))]
    _host_matches_plain(host_kernels, apply_A.level_args(u), metas, c["canons"], enh, windows,
                        c["kind"])


# ---------------------------------------------------------------------------
# C3: the reach of the D^T pass past a brick, and a window without margin
# ---------------------------------------------------------------------------


def _dt_rows(host, args, meta, tau_full, t0, t1, rows, enh, plain):
    """out/zp/zc of one level's rows from the weighted stresses rows [t0,
    t1) of ``tau_full``, by the host tile routine or the plain version."""
    tau = {n: tau_full[n][t0:t1].clone() for n in fa.TAU_NAMES}
    out = _nan_outputs(meta)
    if plain:
        fa.plain_dt_level(args, tau, t0, meta, enh, rows, out)
    else:
        words = fa._level_words({**args, **tau, **out}, meta, rows=rows, tau_x0=t0,
                                tau_nx=t1 - t0)
        host.host_dt_level(words.ctypes.data, int(enh))
    return {n: o[rows[0]:rows[1]] for n, o in out.items()}


def _reach_past_bricks(host, args, meta, enh, brick, what):
    """D^T on a brick of x rows [r0, r1) (even origin and extent) reads the
    weighted stresses of rows r0 - 1 to r1 and no others: with every other
    row of a wider scratch NaN, the brick's outputs are unchanged (host tile
    routine and plain version), and ``tau_rows`` holds that reach.  Returns
    whether zeroing row r0 - 1, or row r1, changed some output (the rows
    are read by a live term)."""
    cx = meta.shape[0]
    full = fa._plain_tau([args], [meta], enh)[0]
    needed = [False, False]
    for r0 in range(0, cx, brick):
        rows = (r0, min(cx, r0 + brick))
        t0, t1 = max(0, r0 - 2), min(cx, rows[1] + 2)
        lo, hi = max(0, r0 - 1), min(cx, rows[1] + 1)
        h0, h1 = fa.tau_rows(rows, cx)
        assert h0 <= lo and h1 >= hi, (what, rows, fa.TAU_HALO)
        poisoned = {n: t.clone() for n, t in full.items()}
        for t in poisoned.values():
            t[:lo] = float("nan")
            t[hi:] = float("nan")
        for plain in (False, True):
            base = _dt_rows(host, args, meta, full, t0, t1, rows, enh, plain)
            got = _dt_rows(host, args, meta, poisoned, t0, t1, rows, enh, plain)
            for n in base:
                assert torch.equal(got[n], base[n]), (what, rows, plain, n)
        base = _dt_rows(host, args, meta, full, t0, t1, rows, enh, False)
        for side, row in enumerate((r0 - 1, rows[1])):
            if 0 <= row < cx:
                cut = {n: t.clone() for n, t in full.items()}
                for t in cut.values():
                    t[row] = 0.0
                got = _dt_rows(host, args, meta, cut, t0, t1, rows, enh, False)
                needed[side] |= any(not torch.equal(got[n], base[n]) for n in base)
    return needed


@pytest.mark.parametrize("fused_case", ["adaptive", "noenh"], indirect=True)
def test_dt_reads_one_row_past_each_brick(fused_case, host_kernels):
    """C3: the D^T pass over 2- and 4-row bricks reads exactly one row of
    weighted stress past each side of the brick, and both rows matter on
    this fixture: a halo of 0 is wrong, and TAU_HALO covers the reach.
    (A T5 partner two rows up, v + 2, comes only from an even v, whose
    block partner v + 1 lies in the same even-aligned brick: halo 1 is
    enough, and no fixture can make it fail.)"""
    c, s = fused_case, fused_case["sys"]
    enh = c["case"]["cfg"].use_enhanced_gradients
    apply_A, embed_tree, _ = fa.make_fused_operator(c["frame"], c["canons"], s["active"],
                                                    s["rpl"], c["case"]["dx"], enh)
    g = torch.Generator().manual_seed(5)
    u = embed_tree({k: torch.randn(m.shape, generator=g) * m for k, m in s["active"].items()})
    args = apply_A.level_args(u)
    needed = [False, False]
    for l, meta in enumerate(apply_A.metas):
        for brick in (2, 4):
            got = _reach_past_bricks(host_kernels, args[l], meta, enh, brick, (c["kind"], l))
            needed = [a or b for a, b in zip(needed, got)]
    assert needed == [True, True], needed


def _tau_rows_of(host, args, meta, rows, enh, plain):
    """wte/wtc of one level's x rows ``rows`` (even bounds) by the host tile
    routine or the plain version, into NaN-prefilled buffers."""
    tau = _nan_tau(meta, rows)
    if plain:
        return fa.plain_tau_level(args, meta, enh, rows, tau)
    words = fa._level_words({**args, **tau}, meta, rows=rows, tau_x0=rows[0],
                            tau_nx=rows[1] - rows[0])
    host.host_tau_level(words.ctypes.data, int(enh))
    return tau


# x rows each input of the tau pass reads past a launch's rows [r0, r1):
# (below r0, at or above r1), from csrc/tau_tile.cuh's reach
TAU_READS = {"u": (2, 1), "up": (1, 1), "cs": (0, 1)}


@pytest.mark.parametrize("fused_case", ["adaptive", "noenh"], indirect=True)
def test_tau_reads_within_its_reach(fused_case, host_kernels):
    """The tau pass over x rows [r0, r1) (2- and 4-row ranges, even bounds)
    reads u0-2 on rows r0 - 2 to r1, up0-2 on r0 - 1 to r1 and cs0-2 on r0
    to r1, and no others: with every other row of those inputs NaN, the
    weighted stresses of the rows are unchanged (host tile routine and
    plain version).  The lowest u row matters on this fixture: zeroing row
    r0 - 2 of u0-2 changes them (the T5 block sum of an even sample with
    slot d = 0 along x), so a reach of one row below is wrong."""
    c, s = fused_case, fused_case["sys"]
    enh = c["case"]["cfg"].use_enhanced_gradients
    apply_A, embed_tree, _ = fa.make_fused_operator(c["frame"], c["canons"], s["active"],
                                                    s["rpl"], c["case"]["dx"], enh)
    g = torch.Generator().manual_seed(7)
    u = embed_tree({k: torch.randn(m.shape, generator=g) * m for k, m in s["active"].items()})
    needed = False
    for l, (args, meta) in enumerate(zip(apply_A.level_args(u), apply_A.metas)):
        cx = meta.shape[0]
        for brick in (2, 4):
            for r0 in range(0, cx, brick):
                rows = (r0, min(cx, r0 + brick))
                poisoned = dict(args)
                for name in [n for n in args if n.rstrip("012") in TAU_READS]:
                    lo, hi = TAU_READS[name.rstrip("012")]
                    t = args[name].clone()
                    t[:max(0, r0 - lo)] = float("nan")
                    t[rows[1] + hi:] = float("nan")
                    poisoned[name] = t
                for plain in (False, True):
                    base = _tau_rows_of(host_kernels, args, meta, rows, enh, plain)
                    got = _tau_rows_of(host_kernels, poisoned, meta, rows, enh, plain)
                    for n in base:
                        assert torch.equal(got[n], base[n]), (c["kind"], l, rows, plain, n)
                if r0 >= 2:
                    cut = dict(args)
                    for f in range(3):
                        cut[f"u{f}"] = args[f"u{f}"].clone()
                        cut[f"u{f}"][r0 - 2] = 0.0
                    got = _tau_rows_of(host_kernels, cut, meta, rows, enh, False)
                    needed |= any(not torch.equal(got[n], base[n]) for n in base)
    assert needed, c["kind"]


@pytest.fixture(scope="module")
def edge_frame():
    """beam-32 (2 levels) on crop windows cut to the occupied boxes with no
    margin: level 0's window is (0, 24) x (14, 28) x (8, 24), on the domain
    edge at x = 0 and against the fluid on every other side."""
    state = scenes.beam(n=32, device="cpu")
    lv, _ = solver.probe_topology(state, SolverConfig(octree_levels=3), device="cpu")
    cfg = SolverConfig(octree_levels=lv, apply_impl="cuda")
    whole = solver.build_system(state, 1.0 / 24.0, cfg, device="cpu")
    raw = [N(b) for b in octree.occupied_bboxes(whole.labels)]
    windows = solver._tight_windows(raw, whole.res_per_level, margin=0)
    sys_ = solver.build_system(state, 1.0 / 24.0, cfg, device="cpu", bboxes=windows,
                               pad_levels=lv)
    g = torch.Generator().manual_seed(6)
    u_log = {k: torch.randn(m.shape, generator=g) * m for k, m in whole.active.items()}
    return dict(whole=whole, sys=sys_, windows=windows, u_log=u_log)


def test_window_without_margin_matches_v1(edge_frame, host_kernels):
    """C3: the canonical apply on windows with no margin, one on the domain
    edge, equals the whole-array v1 operator (3e-5 * max per level and
    axis; the port's v1 is held to JAX in tests/test_torch_solve.py), and
    the host build of the kernels equals the plain versions there, with the
    reach checks of the bricks."""
    e = edge_frame
    sys_, whole, u_log = e["sys"], e["whole"], e["u_log"]
    assert e["windows"][0] == ((0, 24), (14, 28), (8, 24)), e["windows"]
    assert len(sys_.canons) == 2 and all(c.win != c.res for c in sys_.canons)
    want = whole.apply_v1(u_log)
    got = sys_.crop_tree(sys_.apply_A(sys_.embed_tree(u_log)))
    for k in want:
        scale = max(float(want[k].abs().max()), 1e-30)
        assert float((got[k] - want[k]).abs().max()) <= 3e-5 * scale, k
    u = sys_.embed_tree(u_log)
    args, metas = sys_.apply_A.level_args(u), sys_.apply_A.metas
    windows = [[fa.embed(torch.ones(face_shape(sys_.res_per_level[l], f), dtype=torch.bool),
                         sys_.canons[l], False) for f in range(3)] for l in range(len(metas))]
    _host_matches_plain(host_kernels, args, metas, sys_.canons, True, windows, "edge")
    for l, meta in enumerate(metas):
        _reach_past_bricks(host_kernels, args[l], meta, True, 4, ("edge", l))


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


@pytest.mark.parametrize("rows", [(1, 4), (0, 3), (1, 3)])
def test_dt_level_refuses_odd_row_bounds(rows):
    """dt_level runs on x rows with even bounds only, on any device: its
    tiles rest on even origins, and TAU_HALO = 1 covers the reach of a
    range with even bounds only (test_dt_reads_one_row_past_each_brick)."""
    meta = fa.LevelMeta(0, (4, 4, 4), 0.5, False, False, (3, 3, 3))
    with pytest.raises(ValueError, match="even bounds"):
        fa.dt_level({}, {}, 0, meta, True, rows, {})


@pytest.mark.parametrize("rows", [(1, 4), (0, 3), (1, 3)])
def test_tau_level_refuses_odd_row_bounds(rows):
    """tau_level runs on x rows with even bounds only, on any device: its
    tiles rest on even origins (tau_rows gives even bounds)."""
    meta = fa.LevelMeta(0, (4, 4, 4), 0.5, False, False, (3, 3, 3))
    with pytest.raises(ValueError, match="even bounds"):
        fa.tau_level({}, meta, True, rows, {})


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
    assert words[35:] == ["cx", "cy", "cz", "count", "has_parent", "has_child", "inv_dxw",
                          "row0", "tau_x0", "tau_nx"]
    assert words.index("count") == fa._COUNT_WORD
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
