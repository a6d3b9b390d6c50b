"""The fused per-level matvec ``A u = M u + D^T W D u`` on canonical boxes
(port of ``ops/pallas_apply.py:78-425, 1738-2026`` and of its kernels).

Layout, the "canonical embedding": every per-level grid (face, edge or cell
sampled, any axis) is embedded in one shared box per level,

    canonical[x + PAD, y + PAD, z + PAD] = logical[org + (x, y, z)]

with even pads and even crop origins, so logical parity equals canonical
parity and the parity-dependent stencil cases (enhanced siblings, dangling
edges; cpp:1811-1895) read straight off the canonical index.  Pad cells
hold zeros and OUTSIDE kinds, so reads past a window behave like reads past
the domain.  CG runs entirely in canonical space.

Kernels (``csrc/fused_apply.cu``), replacing the Pallas TPU kernels
``_make_fused_kernel`` (pallas_apply.py:1359, level 0) and
``_make_merged_kernel`` (:1447, levels >= 1), both with body
``_make_fused_body`` (:1044):

* ``fused_tau`` -- one launch for a group of levels, one thread per stress
  sample: the 3 edge and 3 center weighted stresses ``wte``/``wtc``.
* ``fused_dt``  -- one launch for the same group, one thread per face
  sample: ``out = [FLUID] * (D^T wtau + m u)``, ``zp`` (to level l+1) and
  ``zc`` (to level l-1), unmasked.

and (``csrc/level_apply.cu``), replacing ``_make_tau_kernel`` (:846),
``_make_dt_kernel`` (:913) and the bricked branch of ``_level_kernel``
(:751-843):

* ``tau_level`` -- the weighted stresses of one level over a range of x
  rows, into a scratch whose first row is the range's.
* ``dt_level``  -- the D^T pass of one level over a range of x rows,
  reading such a scratch.

Routing (``level_modes``): the three routes are the counterparts of the
JAX package's (B1/B2 fused, B3/B4 split, B5 bricked), picked as its
``level_modes`` picks them, with the card's L2 cache in place of the TPU's
VMEM limit.  The levels whose weighted stresses fit the budget together
run "fused"; a finer level that fits alone runs "split" (the level pair
over the whole level); one that does not runs ``("brick", T)``: for each
brick of T x rows, ``tau_level`` over the brick plus a ``TAU_HALO`` row
halo, then ``dt_level`` on the brick.  The budget showed no measured
benefit on the H100: level 0 of buckling-192 runs as fast split, its
weighted stresses through device memory, as bricked within the L2
(PERF.md section 6).  What is faster than the fused pair is the level
kernels' form, not the cache.

All four are bound by device-memory bytes (see ``kernel_bytes``).  Each
wrapper runs its kernel on CUDA tensors and the plain PyTorch version of
the same function (``tau_plain``/``dt_plain``, restricted to the rows) on
CPU tensors; any other device raises.  Cross-level terms are joined
outside the kernels by the glue (``up_view``/``cs_view`` and their
adjoints, plain PyTorch), as in the JAX package.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .arrayops import (edge_shape, face_shape, gather_offset, node_shape, transverse_blocksum,
                       upread)

F32 = torch.float32
KIND_DT = torch.int8
# Low-side pad of every canonical axis.  Every read is bounds-checked (kinds
# read OUTSIDE, values 0 past the box), so the pad only has to hold what the
# apply WRITES past the window that still matters: the unmasked zp/zc of a
# face one row below a stress sample (D^T terms at s - off, |off| <= 1 per
# axis); `out` there is masked to 0 anyway.  Reach 1, rounded up to even so
# that canonical parity stays logical parity.  The high side gets the same
# pad past the closing face row.
PAD = 2
PACK_FILL = 63   # OUTSIDE (code 3) in every 2-bit slot
TAU_NAMES = ("wte0", "wte1", "wte2", "wtc0", "wtc1", "wtc2")
# x rows of weighted stress that D^T reads around a face row v: v - 1 (the
# center slot d = 1, T4/T5 with so = +1) to v + 2 (a T5 block partner one
# row up, read through the slot offset e_g), so a brick's scratch holds the
# brick plus 2 rows each side (rounded up to even, as the JAX package's
# D^T halo is)
TAU_HALO = 2
# share of the L2 cache the routing lets one tau round trip fill (the JAX
# level_modes keeps the same margin against its VMEM limit); the routing's
# stand-in for the VMEM limit, not a measured optimum
L2_SHARE = 0.9

UField = Dict[Tuple[int, int], torch.Tensor]
Mode = Union[str, Tuple[str, int]]


# ---------------------------------------------------------------------------
# canonical embedding
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Canon:
    """Per-level canonical box shared by every grid kind of the level.

    ``org`` crops the box to a window of the level: canonical position
    ``off`` maps to logical cell ``org``.  Every component is even."""

    res: Tuple[int, int, int]    # cell resolution of the level (full grid)
    shape: Tuple[int, int, int]  # canonical array shape (even extents)
    win: Tuple[int, int, int]    # cell extents of the window (res if uncropped)
    org: Tuple[int, int, int] = (0, 0, 0)
    brick: Optional[int] = None  # x rows per brick on the "brick" route (even)

    @property
    def off(self) -> Tuple[int, int, int]:
        return (PAD, PAD, PAD)

    @property
    def cap(self) -> Tuple[int, int, int]:
        """Logical rows the box holds per axis."""
        return tuple(s - 2 * PAD for s in self.shape)

    def row_ranges(self) -> List[Tuple[int, int]]:
        """x-row ranges the level pair runs over: the bricks (every origin
        even, the last one possibly shorter), or the whole box."""
        cx = self.shape[0]
        step = self.brick or cx
        return [(x, min(cx, x + step)) for x in range(0, cx, step)]


def _brick(rows) -> int:
    if int(rows) != rows or rows < 2 or rows % 2:
        raise ValueError(f"a brick is an even number of x rows >= 2, got {rows}")
    return int(rows)


def tau_rows(rows: Tuple[int, int], cx: int) -> Tuple[int, int]:
    """x rows of weighted stress the D^T pass over ``rows`` reads: the
    rows plus ``TAU_HALO`` each side, inside the box."""
    return max(0, rows[0] - TAU_HALO), min(cx, rows[1] + TAU_HALO)


def make_canon(res: Sequence[int], bbox=None, brick: Optional[int] = None) -> Canon:
    """Box for a level of resolution ``res``, optionally cropped to ``bbox``
    (((x0, x1), (y0, y1), (z0, z1)) cell ranges, each lo even).  The box
    covers the window's cells plus the staggered closing row, a pad of
    ``PAD`` on each side, rounded up to even extents.  ``brick``: x rows
    per brick of the "brick" route (even, so brick origins keep parity)."""
    brick = None if brick is None else _brick(brick)
    if bbox is not None:
        org = tuple(int(b[0]) for b in bbox)
        for d, b in enumerate(bbox):
            if b[0] % 2 != 0:
                raise ValueError(f"bbox lo must be even, got {bbox}")
            if not (0 <= b[0] < b[1] <= res[d]):
                raise ValueError(f"bad bbox {bbox} for res {res}")
        ext = [int(b[1]) - int(b[0]) for b in bbox]
    else:
        org = (0, 0, 0)
        ext = list(res)
    shape = tuple(-(-(n + 1 + 2 * PAD) // 2) * 2 for n in ext)
    return Canon(tuple(int(r) for r in res), shape, tuple(ext), org, brick)


# ---------------------------------------------------------------------------
# routing by the card's L2 budget
# ---------------------------------------------------------------------------


def tau_bytes(canon: Canon, rows: Optional[int] = None) -> int:
    """Bytes of the six float32 weighted-stress planes over ``rows`` x rows
    of the level's box (all of them by default)."""
    cx, cy, cz = canon.shape
    return 4 * len(TAU_NAMES) * (cx if rows is None else rows) * cy * cz


def level_modes(canons: Sequence[Canon], budget_bytes: float) -> List[Mode]:
    """Per-level route (the port of pallas_apply.level_modes, with the L2
    budget for the VMEM limit): levels join the "fused" group from the
    coarsest up while the group's weighted stresses fit ``budget_bytes``
    together; each finer level runs "split" if its own fit, else
    ``("brick", T)`` with T the largest even row count whose scratch (T
    plus the halo rows) fits.  Every level gets a route: a brick of 2 rows
    always runs.

    The routes exist to port B3-B5; the budget that picks them is the JAX
    policy's analogue and bought nothing measurable on the H100 (split ties
    the bricks, PERF.md section 6)."""
    levels = len(canons)
    modes: List[Mode] = [""] * levels
    group, l = 0, levels
    while l > 0 and group + tau_bytes(canons[l - 1]) <= budget_bytes:
        l -= 1
        group += tau_bytes(canons[l])
        modes[l] = "fused"
    for k in range(l):
        if tau_bytes(canons[k]) <= budget_bytes:
            modes[k] = "split"
        else:
            rows = int(budget_bytes // tau_bytes(canons[k], 1)) - 2 * TAU_HALO
            modes[k] = ("brick", max(2, rows // 2 * 2))
    return modes


def route_budget(device) -> float:
    """Bytes of weighted stress one route may round-trip: ``L2_SHARE`` of
    the card's L2 cache (the analogue of the JAX routing's VMEM limit; see
    :func:`level_modes`).  The plain versions on the CPU have no cache to
    fit: unbounded, so every level runs fused (pass a budget to
    :func:`level_modes` to force another route)."""
    device = torch.device(device)
    if device.type != "cuda":
        return math.inf
    return L2_SHARE * torch.cuda.get_device_properties(device).L2_cache_size


def route_canons(canons: Sequence[Canon], modes: Sequence[Mode]) -> List[Canon]:
    """``canons`` with each level's brick set from its route."""
    if len(modes) != len(canons):
        raise ValueError(f"{len(modes)} modes for {len(canons)} levels")
    out = []
    for c, m in zip(canons, modes):
        if isinstance(m, tuple):
            if m[0] != "brick":
                raise ValueError(f"unknown route {m!r}")
            out.append(dataclasses.replace(c, brick=_brick(m[1])))
        elif m in ("fused", "split"):
            out.append(dataclasses.replace(c, brick=None))
        else:
            raise ValueError(f"unknown route {m!r}")
    return out


def embed(arr: torch.Tensor, canon: Canon, fill=0) -> torch.Tensor:
    """Logical grid -> canonical box (cropped to the window)."""
    ox, oy, oz = canon.off
    gx, gy, gz = canon.org
    kx, ky, kz = canon.cap
    arr = arr[gx:gx + kx, gy:gy + ky, gz:gz + kz]
    out = torch.full(canon.shape, fill, dtype=arr.dtype, device=arr.device)
    sx, sy, sz = arr.shape
    out[ox:ox + sx, oy:oy + sy, oz:oz + sz] = arr
    return out


def crop(arr: torch.Tensor, canon: Canon, shape: Sequence[int]) -> torch.Tensor:
    """Canonical box -> full logical grid (zero outside the window)."""
    ox, oy, oz = canon.off
    gx, gy, gz = canon.org
    sx, sy, sz = shape
    wx = min(canon.cap[0], sx - gx)
    wy = min(canon.cap[1], sy - gy)
    wz = min(canon.cap[2], sz - gz)
    w = arr[ox:ox + wx, oy:oy + wy, oz:oz + wz]
    if (wx, wy, wz) == tuple(shape):
        return w
    out = torch.zeros(tuple(shape), dtype=arr.dtype, device=arr.device)
    out[gx:gx + wx, gy:gy + wy, gz:gz + wz] = w
    return out


# ---------------------------------------------------------------------------
# cross-level glue, canonical box to canonical box (plain PyTorch)
# ---------------------------------------------------------------------------


def _c2c_A(cf: Canon, cc: Canon):
    """Fine canonical v reads coarse canonical (v >> 1) + A."""
    return tuple(oc - gc + (gf - of) // 2
                 for of, oc, gf, gc in zip(cf.off, cc.off, cf.org, cc.org))


def _c2c_B(cf: Canon, cc: Canon):
    """Coarse canonical v owns fine children 2 v + B + d."""
    return tuple(of - gf + 2 * gc - 2 * oc
                 for of, oc, gf, gc in zip(cf.off, cc.off, cf.org, cc.org))


def _interleave2(x: torch.Tensor, zero_axis: Optional[int] = None) -> torch.Tensor:
    """out[2i+p, 2j+q, 2k+r] = x[i, j, k]; along ``zero_axis`` only the even
    slot holds x and the odd slot is zero."""
    X, Y, Z = x.shape
    b = x[:, None, :, None, :, None].expand(X, 2, Y, 2, Z, 2)
    if zero_axis is not None:
        b = b.clone()
        idx = [slice(None)] * 6
        idx[2 * zero_axis + 1] = 1
        b[tuple(idx)] = 0
    return b.reshape(2 * X, 2 * Y, 2 * Z)


def up_view(uc: torch.Tensor, cc: Canon, cf: Canon) -> torch.Tensor:
    """Fine-canonical view of a coarse-canonical face grid,
    out[v] = uc[(v >> 1) + A]: embed(upread(crop(uc))) on the fine window."""
    A = _c2c_A(cf, cc)
    half = tuple(s // 2 for s in cf.shape)
    return _interleave2(gather_offset(uc, half, A, fill=0))


def up_adjoint(zf: torch.Tensor, cf: Canon, cc: Canon) -> torch.Tensor:
    """Adjoint of :func:`up_view`: out[vc] = sum_d zf[2 (vc - A) + d]."""
    A = _c2c_A(cf, cc)
    X, Y, Z = zf.shape
    w = zf.reshape(X // 2, 2, Y // 2, 2, Z // 2, 2).sum(dim=(1, 3, 5))
    return gather_offset(w, cc.shape, tuple(-a for a in A), fill=0)


def cs_view(uf: torch.Tensor, cf: Canon, cc: Canon, axis: int) -> torch.Tensor:
    """Coarse-canonical child sum of a fine-canonical face grid:
    embed(face_child_sum(crop(uf))) without the logical round trip."""
    B = _c2c_B(cf, cc)
    Xc, Yc, Zc = cc.shape
    w = gather_offset(uf, (2 * Xc, 2 * Yc, 2 * Zc), B, fill=0)
    r = w.reshape(Xc, 2, Yc, 2, Zc, 2).select(2 * axis + 1, 0)
    pair_dims = tuple(2 * t + 1 - (1 if t > axis else 0) for t in range(3) if t != axis)
    return r.sum(dim=pair_dims)


def cs_adjoint(zc: torch.Tensor, cc: Canon, cf: Canon, axis: int) -> torch.Tensor:
    """Adjoint of :func:`cs_view`: each coarse value to its 4 children."""
    B = _c2c_B(cf, cc)
    w = _interleave2(zc, zero_axis=axis)
    return gather_offset(w, cf.shape, tuple(-b for b in B), fill=0)


# ---------------------------------------------------------------------------
# per-frame data
# ---------------------------------------------------------------------------


def pack_groups(level: int, levels: int) -> List[List[str]]:
    """Kind grids bit-packed three per int8 (2-bit codes = -kind)."""
    fields = [f"vk{f}" for f in range(3)] + [f"ek{a}" for a in range(3)] + ["ck"]
    if level + 1 < levels:
        fields += [f"pk{f}" for f in range(3)]
    return [fields[i:i + 3] for i in range(0, len(fields), 3)]


def level_canons(res_per_level, bboxes=None) -> List[Canon]:
    return [make_canon(res, None if bboxes is None else bboxes[l])
            for l, res in enumerate(res_per_level)]


def build_frame_data(labels, vel_kinds, edge_kinds, center_kinds, blocks, mass: UField,
                     res_per_level, bboxes=None, modes: Optional[Sequence[Mode]] = None):
    """Embed the per-frame loop-invariant arrays into canonical boxes.
    Kind grids go in bit-packed (unused slots read OUTSIDE); ``bboxes``
    crops each box to the occupied window; ``modes`` sets the bricks of
    the bricked levels (the arrays are the same on every route).  Returns
    (data, canons)."""
    levels = len(res_per_level)
    canons = level_canons(res_per_level, bboxes)
    if modes is not None:
        canons = route_canons(canons, modes)
    data: Dict[str, torch.Tensor] = {}
    for l in range(levels):
        c = canons[l]
        kinds: Dict[str, torch.Tensor] = {}
        for f in range(3):
            kinds[f"vk{f}"] = vel_kinds[l][f]
            data[f"m{f}_{l}"] = embed(mass[(l, f)].to(F32), c, 0.0)
        for a in range(3):
            kinds[f"ek{a}"] = edge_kinds[l][a]
        kinds["ck"] = center_kinds[l]
        if l + 1 < levels:
            for f in range(3):
                kinds[f"pk{f}"] = upread(vel_kinds[l + 1][f], face_shape(res_per_level[l], f))
        for g, group in enumerate(pack_groups(l, levels)):
            packed = None
            for slot, name in enumerate(group):
                code = embed((-kinds[name]).to(torch.int32), c, 3)
                term = code << (2 * slot)
                packed = term if packed is None else packed | term
            for slot in range(len(group), 3):
                packed = packed | (3 << (2 * slot))
            data[f"kp{g}_{l}"] = packed.to(KIND_DT)
    for b in blocks:
        if b.kind == "edge":
            data[f"we{b.axis}_{b.level}"] = embed(b.weight.to(F32), canons[b.level], 0.0)
        elif f"wc_{b.level}" not in data:
            data[f"wc_{b.level}"] = embed(b.weight.to(F32), canons[b.level], 0.0)
    return data, canons


# ---------------------------------------------------------------------------
# the plain PyTorch version of the kernels
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LevelMeta:
    level: int
    shape: Tuple[int, int, int]
    dxw: float
    has_parent: bool
    has_child: bool
    win: Tuple[int, int, int]    # cell extents of the level's window


def _sh(x: torch.Tensor, off, fill=0.0) -> torch.Tensor:
    """out[p] = x[p + off]; reads outside the box give ``fill``."""
    if not any(off):
        return x
    return gather_offset(x, x.shape, off, fill=fill)


def _unit(axis, sign=1):
    off = [0, 0, 0]
    off[axis] = sign
    return tuple(off)


def _add(a, b):
    return tuple(x + y for x, y in zip(a, b))


def _neg(a):
    return tuple(-x for x in a)


def _code(args, name: str, levels_has_parent: bool) -> torch.Tensor:
    groups = pack_groups(0, 2 if levels_has_parent else 1)
    for g, group in enumerate(groups):
        if name in group:
            raw = args[f"kp{g}"].to(torch.int32) & 0xFF
            return (raw >> (2 * group.index(name))) & 3
    raise KeyError(name)


def _masks(args, meta: LevelMeta, enhanced: bool):
    """0/1 float planes of the decoded kinds (out-of-box reads as OUTSIDE,
    for which every plane is 0, so shifted reads fill with 0)."""
    hp = meta.has_parent
    M = {}
    for f in range(3):
        c = _code(args, f"vk{f}", hp)
        M[f"FLU{f}"] = (c == 0).to(F32)
        M[f"UNA{f}"] = (c == 1).to(F32)
        if enhanced:
            M[f"NOUT{f}"] = (c <= 1).to(F32)
        if hp:
            p = _code(args, f"pk{f}", hp)
            M[f"PFLU{f}"] = (p == 0).to(F32)
            M[f"PUNA{f}"] = (p == 1).to(F32)
    for a in range(3):
        M[f"AE{a}"] = (_code(args, f"ek{a}", hp) == 0).to(F32)
    M["ACTC"] = (_code(args, "ck", hp) == 0).to(F32)
    dev = args["u0"].device
    for ax in range(3):
        n = meta.shape[ax]
        idx = torch.arange(n, device=dev).reshape([n if d == ax else 1 for d in range(3)])
        M[f"EVEN{ax}"] = (idx % 2 == 0).to(F32).expand(meta.shape)
    return M


def _edge_terms(M, a: int, meta: LevelMeta, enhanced: bool):
    """Every edge-stress term of edge axis ``a`` as (coeff, off, mode, f):
    the tau gathers coeff * value_mode,f[s + off] and D^T scatters back
    (_edge_terms / the fused body's planes, T1-T5)."""
    inv = 1.0 / meta.dxw
    ae = M[f"AE{a}"]
    terms = []
    for f in [f for f in range(3) if f != a]:
        g = 3 - a - f
        og = _unit(g, -1)
        una0, una1 = _sh(M[f"UNA{f}"], og), M[f"UNA{f}"]
        binv = inv * (1.0 - (una0 + una1) * (1.0 / 3.0) + (una0 * una1) * (1.0 / 6.0))
        if enhanced:
            enh = (una0 + una1 - una0 * una1) * _sh(M[f"NOUT{f}"], og) * M[f"NOUT{f}"]
        for d in (0, 1):
            off = og if d == 0 else (0, 0, 0)
            sign = -1.0 if d == 0 else 1.0
            act = (_sh(M[f"FLU{f}"], og) if d == 0 else M[f"FLU{f}"]) * ae
            una = una0 if d == 0 else una1
            base = sign * binv
            q = act * base
            un = una * ae * base
            if enhanced:
                e = act * enh * base
                terms.append((0.5 * q - 0.25 * e, off, "same", f))
                pe = M[f"EVEN{a}"]
                terms.append((0.25 * e * pe, _add(off, _unit(a, 1)), "same", f))
                terms.append((0.25 * e * (1.0 - pe), _add(off, _unit(a, -1)), "same", f))
            else:
                terms.append((0.5 * q, off, "same", f))
            if meta.has_parent:
                dang = 1.0 - M[f"EVEN{f}"]
                terms.append((0.5 * un * (1.0 - dang), off, "parent", f))
                for so in (-1, 1):
                    offo = _add(off, _unit(f, so))
                    terms.append((un * dang * 0.25 * _sh(M[f"PFLU{f}"], offo), offo, "parent", f))
                    terms.append((un * dang * 0.0625 * _sh(M[f"PUNA{f}"], offo), offo,
                                  "blocksum", f))
    return terms


def _center_terms(M, x: int, meta: LevelMeta):
    """Center-stress terms of component ``x`` (C1, C2) as (coeff, off, mode)."""
    terms = []
    for d in (0, 1):
        off = (0, 0, 0) if d == 0 else _unit(x, 1)
        sign = -1.0 if d == 0 else 1.0
        terms.append((_sh(M[f"FLU{x}"], off) * M["ACTC"] * (sign / meta.dxw), off, "same"))
        if meta.has_child:
            terms.append((_sh(M[f"UNA{x}"], off) * M["ACTC"] * (0.25 * sign / meta.dxw), off,
                          "child"))
    return terms


def tau_plain(args: Dict[str, torch.Tensor], meta: LevelMeta, enhanced: bool):
    """Plain version of the tau kernel for one level: (wte[3], wtc[3])."""
    M = _masks(args, meta, enhanced)
    wte = []
    for a in range(3):
        tau = torch.zeros(meta.shape, dtype=F32, device=args["u0"].device)
        for c, off, mode, f in _edge_terms(M, a, meta, enhanced):
            if mode == "same":
                v = _sh(args[f"u{f}"], off)
            elif mode == "parent":
                v = _sh(args[f"up{f}"], off)
            else:
                v = _sh(transverse_blocksum(args[f"u{f}"], f), off)
            tau = tau + c * v
        wte.append(args[f"we{a}"] * tau)
    wtc = []
    for x in range(3):
        tau = torch.zeros(meta.shape, dtype=F32, device=args["u0"].device)
        for c, off, mode in _center_terms(M, x, meta):
            v = _sh(args[f"u{x}"] if mode == "same" else args[f"cs{x}"], off)
            tau = tau + c * v
        wtc.append(args["wc"] * tau)
    return wte, wtc


def dt_plain(args: Dict[str, torch.Tensor], wte, wtc, meta: LevelMeta, enhanced: bool):
    """Plain version of the D^T kernel for one level: (out[3], zp[3] or
    None, zc[3] or None)."""
    M = _masks(args, meta, enhanced)
    dev = args["u0"].device
    zeros = lambda: torch.zeros(meta.shape, dtype=F32, device=dev)  # noqa: E731
    out = [zeros() for _ in range(3)]
    zp = [zeros() for _ in range(3)] if meta.has_parent else None
    zc = [zeros() for _ in range(3)] if meta.has_child else None
    for a in range(3):
        for c, off, mode, f in _edge_terms(M, a, meta, enhanced):
            prod = _sh(c * wte[a], _neg(off))
            if mode == "same":
                out[f] = out[f] + prod
            elif mode == "parent":
                zp[f] = zp[f] + prod
            else:
                out[f] = out[f] + transverse_blocksum(prod, f)
    for x in range(3):
        for c, off, mode in _center_terms(M, x, meta):
            prod = _sh(c * wtc[x], _neg(off))
            if mode == "same":
                out[x] = out[x] + prod
            else:
                zc[x] = zc[x] + prod
    out = [M[f"FLU{f}"] * (out[f] + args[f"m{f}"] * args[f"u{f}"]) for f in range(3)]
    return out, zp, zc


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

# kernel name -> number of launches (counted where the kernel is launched)
launch_counts = {"fused_tau": 0, "fused_dt": 0, "tau_level": 0, "dt_level": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


_PTR_FIELDS = (["u0", "u1", "u2", "up0", "up1", "up2", "cs0", "cs1", "cs2",
                "kp0", "kp1", "kp2", "kp3", "we0", "we1", "we2", "wc", "m0", "m1", "m2",
                "wte0", "wte1", "wte2", "wtc0", "wtc1", "wtc2",
                "out0", "out1", "out2", "zp0", "zp1", "zp2", "zc0", "zc1", "zc2"])
_LEVEL_WORDS = 46
MAX_LEVELS = 8


def level_input_names(meta: LevelMeta) -> List[str]:
    names = [f"u{f}" for f in range(3)]
    if meta.has_parent:
        names += [f"up{f}" for f in range(3)]
    if meta.has_child:
        names += [f"cs{f}" for f in range(3)]
    names += [f"kp{g}" for g in range(4 if meta.has_parent else 3)]
    return names + [f"we{a}" for a in range(3)] + ["wc"] + [f"m{f}" for f in range(3)]


def _device_of(levels: Sequence[Dict[str, torch.Tensor]]) -> torch.device:
    dev = levels[0]["u0"].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"fused apply runs on cpu or cuda tensors, got {dev}")
    return dev


def _check(levels, metas, names_fn) -> None:
    if len(levels) > MAX_LEVELS:
        raise ValueError(f"at most {MAX_LEVELS} levels, got {len(levels)}")
    dev = levels[0][names_fn(metas[0])[0]].device
    for args, meta in zip(levels, metas):
        for name in names_fn(meta):
            t = args[name]
            want = KIND_DT if name.startswith("kp") else F32
            if t.device != dev or t.dtype != want or tuple(t.shape) != meta.shape \
                    or not t.is_contiguous():
                raise ValueError(
                    f"level {meta.level} {name}: need a contiguous {want} tensor of shape "
                    f"{meta.shape} on {dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def _level_words(args, meta: LevelMeta, start: int = 0, rows: Optional[Tuple[int, int]] = None,
                 tau_x0: int = 0, tau_nx: Optional[int] = None) -> np.ndarray:
    """int64 words of csrc's AvsLevel: the threads of x rows ``rows`` (all
    by default) from thread ``start`` on; wte/wtc hold rows from
    ``tau_x0`` (``tau_nx`` of them, all by default)."""
    words = np.zeros(_LEVEL_WORDS, np.int64)
    for j, name in enumerate(_PTR_FIELDS):
        t = args.get(name)
        if t is not None:
            words[j] = t.data_ptr()
    cx, cy, cz = meta.shape
    r0, r1 = (0, cx) if rows is None else rows
    words[35:42] = [cx, cy, cz, start, (r1 - r0) * cy * cz, int(meta.has_parent),
                    int(meta.has_child)]
    words[42] = np.array([1.0 / meta.dxw], np.float64).view(np.int64)[0]
    words[43:46] = [r0, tau_x0, cx if tau_nx is None else tau_nx]
    return words


def _frame(levels, metas, enhanced: bool):
    """Host descriptor (int64 words of csrc AvsFrame) and total threads."""
    words = np.zeros(MAX_LEVELS * _LEVEL_WORDS + 3, np.int64)
    start = 0
    for l, (args, meta) in enumerate(zip(levels, metas)):
        words[l * _LEVEL_WORDS:(l + 1) * _LEVEL_WORDS] = _level_words(args, meta, start)
        start += int(np.prod(meta.shape))
    words[-3:] = [len(levels), start, int(enhanced)]
    return words, start


@functools.lru_cache(maxsize=None)
def _library(stem: str) -> ctypes.CDLL:
    """``csrc/<stem>.cu``'s library, built at first use, with the argument
    types of its entry points set and its descriptor layout checked
    against this module's.  ``fused_apply``: ``avs_tau_launch`` /
    ``avs_dt_launch`` (device descriptor, threads, stream);
    ``level_apply``: ``avs_tau_level_launch`` / ``avs_dt_level_launch``
    (host descriptor, threads, enhanced, stream)."""
    from . import _build

    lib = _build.load(stem)
    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    if stem == "fused_apply":
        probe, want = lib.avs_frame_bytes, (MAX_LEVELS * _LEVEL_WORDS + 3) * 8
        entries, argtypes = ("avs_tau_launch", "avs_dt_launch"), [vp, ll, vp]
    else:
        probe, want = lib.avs_level_bytes, _LEVEL_WORDS * 8
        entries = ("avs_tau_level_launch", "avs_dt_level_launch")
        argtypes = [vp, ll, ctypes.c_int, vp]
    probe.argtypes, probe.restype = [], ll
    if probe() != want:
        raise RuntimeError(f"descriptor layout mismatch between csrc/{stem}.cu and Python")
    for name in entries:
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return lib


def _launch(entry: str, levels, metas, enhanced: bool) -> None:
    lib = _library("fused_apply")
    words, total = _frame(levels, metas, enhanced)
    dev = levels[0]["u0"].device
    # an asynchronous copy on the current stream: from pageable memory it
    # returns once the words are staged, without waiting for the device, so
    # the host keeps queueing work ahead of the card
    desc = torch.from_numpy(words).to(dev, non_blocking=True)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = getattr(lib, entry)(desc.data_ptr(), total, stream)
    if err != 0:
        raise RuntimeError(f"{entry} failed: cudaError {err}")


def _launch_level(entry: str, words: np.ndarray, enhanced: bool, dev: torch.device) -> None:
    lib = _library("level_apply")
    # the launch copies the descriptor into the kernel's parameters: no
    # device copy, and ``words`` may go once the call returns
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = getattr(lib, entry)(words.ctypes.data, int(words[39]), int(enhanced), stream)
    if err != 0:
        raise RuntimeError(f"{entry} failed: cudaError {err}")


def _tau_buffers(metas: Sequence[LevelMeta], dev) -> List[Dict[str, torch.Tensor]]:
    return [{n: torch.empty(meta.shape, dtype=F32, device=dev) for n in TAU_NAMES}
            for meta in metas]


def _check_rows(rows: Tuple[int, int], meta: LevelMeta) -> None:
    if not 0 <= rows[0] < rows[1] <= meta.shape[0]:
        raise ValueError(f"x rows {rows} are not a range of level {meta.level}'s "
                         f"{meta.shape[0]} rows")


def _check_tau(tau: Dict[str, torch.Tensor], meta: LevelMeta, rows: int, dev) -> None:
    want = (rows,) + tuple(meta.shape[1:])
    for n in TAU_NAMES:
        t = tau[n]
        if t.device != dev or t.dtype != F32 or tuple(t.shape) != want or not t.is_contiguous():
            raise ValueError(f"level {meta.level} {n}: need a contiguous float32 tensor of shape "
                             f"{want} on {dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def fused_tau(levels: Sequence[Dict[str, torch.Tensor]], metas: Sequence[LevelMeta],
              enhanced: bool, out: Optional[List[Dict[str, torch.Tensor]]] = None
              ) -> List[Dict[str, torch.Tensor]]:
    """Weighted stresses ``wte0-2``/``wtc0-2`` of every level, into ``out``
    (per level, six tensors of the box's shape) if given.

    CUDA tensors: one launch of the tau kernel over all levels.  CPU
    tensors: :func:`tau_plain` per level."""
    dev = _device_of(levels)
    if dev.type == "cpu":
        res = _plain_tau(levels, metas, enhanced)
        if out is None:
            return res
        for o, r in zip(out, res):
            for n in TAU_NAMES:
                o[n].copy_(r[n])
        return out
    _check(levels, metas, level_input_names)
    res = _tau_buffers(metas, dev) if out is None else out
    for r, meta in zip(res, metas):
        _check_tau(r, meta, meta.shape[0], dev)
    _launch("avs_tau_launch", [{**a, **r} for a, r in zip(levels, res)], metas, enhanced)
    launch_counts["fused_tau"] += 1
    return res


def _dt_names(meta: LevelMeta) -> List[str]:
    names = [f"wte{a}" for a in range(3)] + [f"wtc{x}" for x in range(3)]
    names += [f"kp{g}" for g in range(4 if meta.has_parent else 3)]
    return names + [f"u{f}" for f in range(3)] + [f"m{f}" for f in range(3)]


def _dt_output_names(meta: LevelMeta) -> List[str]:
    names = [f"out{f}" for f in range(3)]
    if meta.has_parent:
        names += [f"zp{f}" for f in range(3)]
    if meta.has_child:
        names += [f"zc{f}" for f in range(3)]
    return names


def dt_outputs(meta: LevelMeta, dev) -> Dict[str, torch.Tensor]:
    """Uninitialised output tensors of one level's D^T pass."""
    return {n: torch.empty(meta.shape, dtype=F32, device=dev) for n in _dt_output_names(meta)}


def fused_dt(levels: Sequence[Dict[str, torch.Tensor]], taus: Sequence[Dict[str, torch.Tensor]],
             metas: Sequence[LevelMeta], enhanced: bool) -> List[Dict[str, torch.Tensor]]:
    """``out0-2`` (masked, mass added), ``zp0-2`` (levels with a parent) and
    ``zc0-2`` (levels with a child) of every level.

    CUDA tensors: one launch of the D^T kernel over all levels.  CPU
    tensors: :func:`dt_plain` per level."""
    dev = _device_of(levels)
    if dev.type == "cpu":
        return _plain_dt(levels, taus, metas, enhanced)
    merged = [{**a, **t} for a, t in zip(levels, taus)]
    _check(merged, metas, _dt_names)
    res = [dt_outputs(meta, dev) for meta in metas]
    _launch("avs_dt_launch", [{**m, **r} for m, r in zip(merged, res)], metas, enhanced)
    launch_counts["fused_dt"] += 1
    return res


def tau_level(args: Dict[str, torch.Tensor], meta: LevelMeta, enhanced: bool,
              rows: Tuple[int, int], tau: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Weighted stresses of one level's x rows ``rows`` = (r0, r1) into
    ``tau`` (``wte0-2``/``wtc0-2``, each of shape (r1 - r0, CY, CZ), first
    row r0).

    CUDA tensors: one launch of the level tau kernel.  CPU tensors:
    :func:`tau_plain`'s rows."""
    _check_rows(rows, meta)
    dev = _device_of([args])
    if dev.type == "cpu":
        return plain_tau_level(args, meta, enhanced, rows, tau)
    _check([args], [meta], level_input_names)
    _check_tau(tau, meta, rows[1] - rows[0], dev)
    words = _level_words({**args, **tau}, meta, rows=rows, tau_x0=rows[0],
                         tau_nx=rows[1] - rows[0])
    _launch_level("avs_tau_level_launch", words, enhanced, dev)
    launch_counts["tau_level"] += 1
    return tau


def dt_level(args: Dict[str, torch.Tensor], tau: Dict[str, torch.Tensor], tau_x0: int,
             meta: LevelMeta, enhanced: bool, rows: Tuple[int, int],
             out: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """D^T pass of one level on x rows ``rows``: writes those rows of
    ``out`` (the level's ``out``/``zp``/``zc``, box-shaped), reading the
    weighted stresses ``tau``, whose first row is ``tau_x0``; they must
    hold :func:`tau_rows` of ``rows``.

    CUDA tensors: one launch of the level D^T kernel.  CPU tensors:
    :func:`dt_plain`'s rows."""
    _check_rows(rows, meta)
    dev = _device_of([args])
    nx = tau["wte0"].shape[0]
    t0, t1 = tau_rows(rows, meta.shape[0])
    if not 0 <= tau_x0 <= t0 or t1 > tau_x0 + nx or tau_x0 + nx > meta.shape[0]:
        raise ValueError(f"weighted stresses of rows [{tau_x0}, {tau_x0 + nx}) do not hold "
                         f"the rows [{t0}, {t1}) that D^T reads on rows {rows}, inside the "
                         f"box's {meta.shape[0]} rows")
    if dev.type == "cpu":
        return plain_dt_level(args, tau, tau_x0, meta, enhanced, rows, out)
    _check([args], [meta], lambda m: _dt_names(m)[6:])
    _check([out], [meta], _dt_output_names)
    _check_tau(tau, meta, nx, dev)
    words = _level_words({**args, **tau, **out}, meta, rows=rows, tau_x0=tau_x0, tau_nx=nx)
    _launch_level("avs_dt_level_launch", words, enhanced, dev)
    launch_counts["dt_level"] += 1
    return out


def plain_tau_level(args, meta: LevelMeta, enhanced: bool, rows, tau):
    """Plain version of :func:`tau_level`: the level's :func:`tau_plain`,
    restricted to the rows."""
    full = _plain_tau([args], [meta], enhanced)[0]
    for n in TAU_NAMES:
        tau[n].copy_(full[n][rows[0]:rows[1]])
    return tau


def plain_dt_level(args, tau, tau_x0: int, meta: LevelMeta, enhanced: bool, rows, out):
    """Plain version of :func:`dt_level`: the level's :func:`dt_plain` on
    the weighted stresses held (zero on every other row), restricted to
    the rows."""
    full = {}
    for n in TAU_NAMES:
        t = torch.zeros(meta.shape, dtype=F32, device=tau[n].device)
        t[tau_x0:tau_x0 + tau[n].shape[0]] = tau[n]
        full[n] = t
    res = _plain_dt([args], [full], [meta], enhanced)[0]
    for n, o in out.items():
        o[rows[0]:rows[1]] = res[n][rows[0]:rows[1]]
    return out


def _window_counts(m: LevelMeta, rows: Optional[Tuple[int, int]] = None):
    """Logical samples of one level's window, on canonical x rows ``rows``
    only if given: (face, edge, cell, node) counts, face and edge summed
    over the three axes."""
    w = m.win

    def count(shape):
        nx = shape[0]
        if rows is not None:   # the window's x rows are canonical [PAD, PAD + nx)
            nx = max(0, min(rows[1], PAD + nx) - max(rows[0], PAD))
        return nx * int(shape[1]) * int(shape[2])

    face = sum(count(face_shape(w, f)) for f in range(3))
    edge = sum(count(edge_shape(w, a)) for a in range(3))
    return face, edge, count(tuple(w)), count(node_shape(w))


def kernel_bytes(metas: Sequence[LevelMeta], rows: Optional[Tuple[int, int]] = None
                 ) -> Dict[str, int]:
    """Device-memory bytes the tau and D^T passes must move at these
    windows (on the canonical x rows ``rows`` of each level, if given):
    every input read once and every output written once, over each level's
    logical window (its cells plus the closing face row), not the padded
    canonical box, whose pad cells hold only zeros and OUTSIDE kinds that
    the kernels also get from their bounds checks.  Each packed kind byte
    covers the window's node box (face, edge and cell grids together).  The
    same counts bound both routes: the bricks' halo rows, recomputed and
    read again, are the brick design's cost, not the work's."""
    tau_b = dt_b = 0
    for m in metas:
        face, edge, cell, node = _window_counts(m, rows)
        kinds = (4 if m.has_parent else 3) * node
        views = int(m.has_parent) + int(m.has_child)     # up, cs inputs
        # tau: u (+ up, cs), we, wc, kinds in; wte, wtc out
        tau_b += 4 * face * (1 + views) + 4 * (edge + cell) + kinds + 4 * (edge + 3 * cell)
        # D^T: wte, wtc, u, m, kinds in; out (+ zp, zc) out
        dt_b += 4 * (edge + 3 * cell) + 4 * 2 * face + kinds + 4 * face * (1 + views)
    return {"tau": tau_b, "dt": dt_b}


def kernel_flops(metas: Sequence[LevelMeta], enhanced: bool,
                 rows: Optional[Tuple[int, int]] = None) -> Dict[str, int]:
    """Floating-point operations of the term algebra over the same windows:
    one multiply-add per stencil term and stress sample in each pass (the
    coefficient rebuild from the kinds is not counted)."""
    tau_f = 0
    for m in metas:
        _, edge, cell, _ = _window_counts(m, rows)
        per_slot = 1 + (2 if enhanced else 0) + (5 if m.has_parent else 0)
        # edge axis a: 2 face axes x 2 slots per sample; center: 3 components x 2 slots
        tau_f += 2 * (edge * 2 * 2 * per_slot + cell * 3 * 2 * (2 if m.has_child else 1))
    return {"tau": tau_f, "dt": tau_f}


# ---------------------------------------------------------------------------
# the operator
# ---------------------------------------------------------------------------


def level_metas(canons: Sequence[Canon], dx: float) -> List[LevelMeta]:
    levels = len(canons)
    return [LevelMeta(l, tuple(canons[l].shape), dx * (1 << l), l + 1 < levels, l > 0,
                      canons[l].win) for l in range(levels)]


def _plain_tau(levels, metas, enhanced):
    return [dict(zip(("wte0", "wte1", "wte2", "wtc0", "wtc1", "wtc2"),
                     [*w[0], *w[1]])) for w in (tau_plain(a, m, enhanced)
                                                for a, m in zip(levels, metas))]


def _plain_dt(levels, taus, metas, enhanced):
    res = []
    for args, t, meta in zip(levels, taus, metas):
        out, zp, zc = dt_plain(args, [t[f"wte{a}"] for a in range(3)],
                               [t[f"wtc{x}"] for x in range(3)], meta, enhanced)
        r = {f"out{f}": out[f] for f in range(3)}
        r.update({f"zp{f}": zp[f] for f in range(3)} if zp is not None else {})
        r.update({f"zc{f}": zc[f] for f in range(3)} if zc is not None else {})
        res.append(r)
    return res


def make_fused_operator(frame: Dict[str, torch.Tensor], canons: Sequence[Canon],
                        active: UField, res_per_level, dx: float, enhanced: bool,
                        plain: bool = False, modes: Optional[Sequence[Mode]] = None):
    """Return (apply_A, embed_tree, crop_tree) in canonical space (the port
    of make_pallas_operator): per apply, the glue builds the cross-level
    views; the "fused" levels run ``fused_tau`` and ``fused_dt`` once each
    for the whole group; each "split" or bricked level runs
    ``tau_level``/``dt_level`` once per x-row range of its canon
    (:meth:`Canon.row_ranges`) over one weighted-stress scratch, allocated
    here once and shared by those levels; then the zp/zc adjoints are added
    masked to the receiving level.

    ``modes``: the route of each level (default all "fused"); a bricked
    level's canon carries its brick (:func:`route_canons`).
    ``plain=True`` calls the kernels' plain versions on any device (the
    yardstick a kernel is held to on the card; never the solver's path)."""
    levels = len(res_per_level)
    modes = ["fused"] * levels if modes is None else list(modes)
    if [c.brick for c in route_canons(canons, modes)] != [c.brick for c in canons]:
        raise ValueError(f"routes {modes} disagree with the canons' bricks "
                         f"{[c.brick for c in canons]}: build the canons with route_canons")
    metas = level_metas(canons, dx)
    dev = frame["kp0_0"].device
    active_c = {(l, f): embed(active[(l, f)], canons[l], False)
                for l in range(levels) for f in range(3)}
    static = [{n: frame[f"{n}_{l}"] for n in level_input_names(metas[l])
               if not n.startswith(("u", "up", "cs"))} for l in range(levels)]
    fused = [l for l in range(levels) if modes[l] == "fused"]
    routed = [l for l in range(levels) if modes[l] != "fused"]
    fused_scratch = _tau_buffers([metas[l] for l in fused], dev)
    scratch_len = max([int(np.prod(canons[l].shape[1:])) * (t1 - t0) for l in routed
                       for t0, t1 in (tau_rows(r, canons[l].shape[0])
                                      for r in canons[l].row_ranges())], default=0)
    scratch = torch.empty(len(TAU_NAMES) * scratch_len, dtype=F32, device=dev)

    def tau_view(l: int, rows: int) -> Dict[str, torch.Tensor]:
        n = rows * int(np.prod(canons[l].shape[1:]))
        return {name: scratch[k * n:(k + 1) * n].view(rows, *canons[l].shape[1:])
                for k, name in enumerate(TAU_NAMES)}

    def embed_tree(u: UField, fill=0.0) -> UField:
        return {(l, f): embed(u[(l, f)].to(F32), canons[l], fill) for (l, f) in u}

    def crop_tree(u: UField) -> UField:
        return {(l, f): crop(u[(l, f)], canons[l], face_shape(res_per_level[l], f))
                for (l, f) in u}

    def level_args(u: UField) -> List[Dict[str, torch.Tensor]]:
        args = []
        for l in range(levels):
            d = dict(static[l])
            for f in range(3):
                d[f"u{f}"] = u[(l, f)].contiguous()
                if l + 1 < levels:
                    d[f"up{f}"] = up_view(u[(l + 1, f)], canons[l + 1], canons[l]).contiguous()
                if l > 0:
                    d[f"cs{f}"] = cs_view(u[(l - 1, f)], canons[l - 1], canons[l], f).contiguous()
            args.append(d)
        return args

    def level_pair(l: int, args: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One split or bricked level: the pair once per x-row range."""
        meta = metas[l]
        tau_fn, dt_fn = (plain_tau_level, plain_dt_level) if plain else (tau_level, dt_level)
        out = dt_outputs(meta, dev)
        for rows in canons[l].row_ranges():
            t0, t1 = tau_rows(rows, meta.shape[0])
            tau = tau_fn(args, meta, enhanced, (t0, t1), tau_view(l, t1 - t0))
            dt_fn(args, tau, t0, meta, enhanced, rows, out)
        return out

    def apply_A(u: UField) -> UField:
        args = level_args(u)
        res: List[Optional[Dict[str, torch.Tensor]]] = [None] * levels
        if fused:
            fa_, fm = [args[l] for l in fused], [metas[l] for l in fused]
            if plain:
                fres = _plain_dt(fa_, _plain_tau(fa_, fm, enhanced), fm, enhanced)
            else:
                fres = fused_dt(fa_, fused_tau(fa_, fm, enhanced, out=fused_scratch), fm,
                                enhanced)
            for l, r in zip(fused, fres):
                res[l] = r
        for l in routed:
            res[l] = level_pair(l, args[l])
        outs = {(l, f): res[l][f"out{f}"] for l in range(levels) for f in range(3)}
        zero = torch.zeros((), dtype=F32, device=u[(0, 0)].device)
        for l in range(levels - 1):
            for f in range(3):
                adj = up_adjoint(res[l][f"zp{f}"], canons[l], canons[l + 1])
                outs[(l + 1, f)] = outs[(l + 1, f)] + torch.where(active_c[(l + 1, f)], adj, zero)
        for l in range(1, levels):
            for f in range(3):
                adj = cs_adjoint(res[l][f"zc{f}"], canons[l], canons[l - 1], f)
                outs[(l - 1, f)] = outs[(l - 1, f)] + torch.where(active_c[(l - 1, f)], adj, zero)
        return outs

    apply_A.metas = metas
    apply_A.level_args = level_args
    return apply_A, embed_tree, crop_tree
