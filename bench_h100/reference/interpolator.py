"""T-junction-consistent octree velocity interpolation (port of
``interpolator.py``).

Dense form of HDK_OctreeVectorFieldInterpolator
(reference Source/HDK_OctreeVectorFieldInterpolator.{h,cpp}): per-level
node velocities that agree across T-junctions (phases 1-6 of the
constructor, h:30-138), then interpSPGrid (cpp:660-845) evaluated at every
level-0 face center at once for the writeback, or at arbitrary points
(:func:`interp_at`, all points at once as tensor ops).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from . import classify, octree
from .ops.arrayops import (
    even_snap,
    face_child_mean,
    face_shape,
    gather_offset,
    iota,
    node_shape,
    upread,
    upread_k,
)

FLUID = classify.FLUID
UNASSIGNED = classify.UNASSIGNED
SOLIDBOUNDARY = classify.SOLIDBOUNDARY
OUTSIDE = classify.OUTSIDE

INACTIVE_NODE = 0
ACTIVE_NODE = 1
DEPENDENT_NODE = 2


def _node_face_slots(f):
    """The 4 faces adjacent to a node for face axis ``f`` (HDKnodeToFace)."""
    t1, t2 = (f + 1) % 3, (f + 2) % 3
    slots = []
    for fi in range(4):
        off = [0, 0, 0]
        if not (fi & 1):
            off[t1] -= 1
        if not (fi & 2):
            off[t2] -= 1
        slots.append((fi, tuple(off)))
    return slots


def _zero(dtype, device):
    return torch.zeros((), dtype=dtype, device=device)


def build_node_velocities(labels: Sequence[torch.Tensor],
                          u: Dict[Tuple[int, int], torch.Tensor], vel_kinds):
    """Phases 1-6; returns (node_values[level][axis], node_labels[level])."""
    levels = len(labels)
    dtype = u[(0, 0)].dtype
    dev = u[(0, 0)].device
    z0 = _zero(dtype, dev)
    nshapes = [node_shape(tuple(l.shape)) for l in labels]
    i8 = lambda v: torch.tensor(v, dtype=torch.int8, device=dev)  # noqa: E731

    node_label: List[torch.Tensor] = []
    node_vals: List[List[torch.Tensor]] = []
    node_wts: List[List[torch.Tensor]] = []
    flags: List[torch.Tensor] = []

    # phases 1 + 2 (cpp:118-286)
    for level in range(levels):
        ns = nshapes[level]
        w = float(1 << (levels - level - 1))
        any_active = torch.zeros(ns, dtype=torch.bool, device=dev)
        any_blocked = torch.zeros(ns, dtype=torch.bool, device=dev)
        vals = [torch.zeros(ns, dtype=dtype, device=dev) for _ in range(3)]
        wts = [torch.zeros(ns, dtype=dtype, device=dev) for _ in range(3)]
        flg = torch.zeros(ns, dtype=torch.int32, device=dev)
        for f in range(3):
            for fi, off in _node_face_slots(f):
                k = gather_offset(vel_kinds[level][f], ns, off, fill=OUTSIDE)
                uf = gather_offset(u[(level, f)], ns, off)
                is_fluid = k == FLUID
                is_closed = (k == SOLIDBOUNDARY) | (k == OUTSIDE)
                any_active |= is_fluid
                any_blocked |= is_closed
                vals[f] = vals[f] + torch.where(is_fluid, w * uf, z0)
                wts[f] = wts[f] + torch.where(is_fluid | is_closed,
                                              torch.full((), w, dtype=dtype, device=dev), z0)
                flg = flg + (is_fluid | is_closed).to(torch.int32) * (1 << (f * 4 + fi))
        lab = torch.where(any_active & ~any_blocked, i8(ACTIVE_NODE), i8(INACTIVE_NODE))
        node_label.append(lab)
        node_vals.append(vals)
        node_wts.append(wts)
        flags.append(flg)

    # phase 3: bubble co-located values upward (cpp:288-355)
    for level in range(levels - 1):
        child_lab = node_label[level]
        child_even = child_lab[::2, ::2, ::2]
        parent_lab = node_label[level + 1]
        merge = (child_even == ACTIVE_NODE) & (parent_lab == ACTIVE_NODE)
        flags[level + 1] = flags[level + 1] + torch.where(
            merge, flags[level][::2, ::2, ::2], torch.zeros((), dtype=torch.int32, device=dev))
        for f in range(3):
            node_vals[level + 1][f] = node_vals[level + 1][f] + torch.where(
                merge, node_vals[level][f][::2, ::2, ::2], z0)
            node_wts[level + 1][f] = node_wts[level + 1][f] + torch.where(
                merge, node_wts[level][f][::2, ::2, ::2], z0)
        merge_fine = torch.zeros(child_lab.shape, dtype=torch.bool, device=dev)
        merge_fine[::2, ::2, ::2] = merge
        node_label[level] = torch.where(merge_fine, i8(DEPENDENT_NODE), child_lab)

    # composite face fields for the climb: FLUID face value, else the mean
    # of its 4 children (cpp:503-535)
    comp = {}
    for level in range(levels):
        for f in range(3):
            fs = face_shape(tuple(labels[level].shape), f)
            val = torch.where(vel_kinds[level][f] == FLUID, u[(level, f)], z0)
            if level > 0:
                child_mean = face_child_mean(u[(level - 1, f)], f, fs)
                val = torch.where(vel_kinds[level][f] == UNASSIGNED, child_mean, val)
            comp[(level, f)] = val

    # active-ancestor level per cell
    BIG = 127
    first_active: List[torch.Tensor] = []
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)  # noqa: E731
    cur = torch.where(labels[levels - 1] == octree.ACTIVE, i32(levels - 1), i32(BIG))
    first_active.insert(0, cur)
    for level in range(levels - 2, -1, -1):
        par = upread(first_active[0], tuple(labels[level].shape))
        cur = torch.where(labels[level] == octree.ACTIVE, i32(level), par)
        first_active.insert(0, cur)

    # phase 4: finish incomplete nodes (cpp:357-567), ascending levels
    for level in range(levels - 1):
        ns = nshapes[level]
        w = float(1 << (levels - level - 1))
        wt = torch.full((), w, dtype=dtype, device=dev)
        incomplete = (node_label[level] == ACTIVE_NODE) & (flags[level] != 0xFFF)
        for f in range(3):
            fshape_l = face_shape(tuple(labels[level].shape), f)
            even_f = iota(ns, f, dev) % 2 == 0
            pk_full = upread(vel_kinds[level + 1][f], fshape_l)
            pu_full = upread(u[(level + 1, f)], fshape_l)
            for fi, off in _node_face_slots(f):
                bit = 1 << (f * 4 + fi)
                missing = incomplete & ((flags[level] & bit) == 0)

                # case A: node even along f -> parent face may be live
                pk = gather_offset(pk_full, ns, off, fill=OUTSIDE)
                pu = gather_offset(pu_full, ns, off)
                case_a = missing & even_f & (pk == FLUID)
                node_vals[level][f] = node_vals[level][f] + torch.where(case_a, w * pu, z0)
                node_wts[level][f] = node_wts[level][f] + torch.where(case_a, wt, z0)

                # case B: climb to the containing active cell, lerp its two
                # f-faces (cpp:469-552)
                case_b = missing & ~even_f
                al = gather_offset(first_active[level], ns, off, fill=BIG)
                ghost = torch.zeros(ns, dtype=dtype, device=dev)
                for sl in range(level + 1, levels):
                    d = sl - level
                    sel = case_b & (al == sl)
                    t = (iota(ns, f, dev) % (1 << d)).to(dtype) / float(1 << d)
                    lifted = upread_k(comp[(sl, f)], fshape_l, d)
                    v0 = gather_offset(lifted, ns, off)
                    v1 = gather_offset(lifted, ns, tuple(o + (1 << d) if ax == f else o
                                                         for ax, o in enumerate(off)))
                    gv = (1.0 - t) * v0 + t * v1
                    ghost = torch.where(sel, gv, ghost)
                node_vals[level][f] = node_vals[level][f] + torch.where(case_b, w * ghost, z0)
                node_wts[level][f] = node_wts[level][f] + torch.where(case_b, wt, z0)

    # phase 5: normalize (cpp:569-613)
    for level in range(levels):
        act = node_label[level] == ACTIVE_NODE
        for f in range(3):
            node_vals[level][f] = torch.where(
                act, node_vals[level][f] / node_wts[level][f].clamp_min(1e-30),
                node_vals[level][f])

    # phase 6: distribute down (cpp:615-658), descending
    for level in range(levels - 2, -1, -1):
        dep = node_label[level] == DEPENDENT_NODE
        for f in range(3):
            pv = upread(node_vals[level + 1][f], nshapes[level])
            node_vals[level][f] = torch.where(dep, pv, node_vals[level][f])
        node_label[level] = torch.where(dep, i8(ACTIVE_NODE), node_label[level])

    return node_vals, node_label


def interpolate_level0_faces(labels, u, vel_kinds, node_vals, axis: int) -> torch.Tensor:
    """interpSPGrid (cpp:660-845) at every level-0 face center of ``axis``:
    descend to the first ACTIVE containing cell; trilinear over the 8
    surrounding faces when all are assigned, else the node bilinear +
    pyramid-bump path with child-face selection."""
    levels = len(labels)
    res0 = tuple(labels[0].shape)
    fs0 = face_shape(res0, axis)
    dtype = u[(0, 0)].dtype
    dev = u[(0, 0)].device
    t_axes = [d for d in range(3) if d != axis]

    result = torch.zeros(fs0, dtype=dtype, device=dev)
    found = torch.zeros(fs0, dtype=torch.bool, device=dev)
    FA = iota(fs0, axis, dev)
    FT = {t: iota(fs0, t, dev) for t in t_axes}
    nshape0 = tuple(s + 1 for s in res0)

    for l in range(levels):
        h = 1 << l
        h2 = h // 2

        cl = upread_k(labels[l], res0, l)
        is_active = gather_offset(cl, fs0, (0, 0, 0), fill=octree.INACTIVE) == octree.ACTIVE

        # fast path: all 8 surrounding faces assigned (cpp:683-728)
        ku = upread_k(vel_kinds[l][axis], fs0, l)
        uu = upread_k(u[(l, axis)], fs0, l)
        fa = (FA % h).to(dtype) / h
        ft = {t: (((FT[t] - h2) % h).to(dtype) + 0.5) / h for t in t_axes}
        fast_val = torch.zeros(fs0, dtype=dtype, device=dev)
        at_transition = torch.zeros(fs0, dtype=torch.bool, device=dev)
        for b0 in (0, 1):
            for b1 in (0, 1):
                for b2 in (0, 1):
                    bb = {axis: b0, t_axes[0]: b1, t_axes[1]: b2}
                    off = tuple((bb[d] * h) if d == axis else (-h2 + bb[d] * h)
                                for d in range(3))
                    kk = gather_offset(ku, fs0, off, fill=OUTSIDE)
                    vv = gather_offset(uu, fs0, off)
                    at_transition |= kk == UNASSIGNED
                    w = fa if b0 else (1.0 - fa)
                    for t in t_axes:
                        w = w * (ft[t] if bb[t] else (1.0 - ft[t]))
                    fast_val = fast_val + w * vv

        # node path (cpp:729-837)
        def node_interp(fl, snapped, off_in):
            hh = 1 << fl
            nv = node_vals[fl][axis]
            if snapped:
                nv = even_snap(nv, axis)
            nvu = upread_k(nv, nshape0, fl)
            fw = {t: (((FT[t] % hh).to(dtype)) + 0.5) / hh for t in t_axes}
            bil = torch.zeros(fs0, dtype=dtype, device=dev)
            avg = torch.zeros(fs0, dtype=dtype, device=dev)
            for b1 in (0, 1):
                for b2 in (0, 1):
                    bb = {t_axes[0]: b1, t_axes[1]: b2}
                    off = tuple(off_in if d == axis else bb[d] * hh for d in range(3))
                    nn = gather_offset(nvu, fs0, off)
                    w = torch.ones(fs0, dtype=dtype, device=dev)
                    for t in t_axes:
                        w = w * (fw[t] if bb[t] else (1.0 - fw[t]))
                    bil = bil + w * nn
                    avg = avg + nn
            bump_w = torch.minimum(
                torch.minimum(fw[t_axes[0]], 1.0 - fw[t_axes[0]]),
                torch.minimum(fw[t_axes[1]], 1.0 - fw[t_axes[1]]),
            )
            return bil, avg, bump_w

        t_cell = fa
        dir_vals = []
        for direction in (0, 1):
            off_in = direction * h
            ax_off = tuple(off_in if d == axis else 0 for d in range(3))
            k_dir = gather_offset(ku, fs0, ax_off, fill=OUTSIDE)
            big_u = gather_offset(uu, fs0, ax_off)
            if l > 0:
                use_child = k_dir == UNASSIGNED
                cu = upread_k(even_snap(u[(l - 1, axis)], axis), fs0, l - 1)
                child_u = gather_offset(cu, fs0, ax_off)
                face_u = torch.where(use_child, child_u, big_u)
            else:
                face_u = big_u
            bil_b, avg_b, bw_b = node_interp(l, False, off_in)
            if l > 0:
                bil_c, avg_c, bw_c = node_interp(l - 1, True, off_in)
                bil = torch.where(use_child, bil_c, bil_b)
                avg = torch.where(use_child, avg_c, avg_b)
                bw = torch.where(use_child, bw_c, bw_b)
            else:
                bil, avg, bw = bil_b, avg_b, bw_b
            dir_vals.append(bil + 2.0 * (face_u - 0.25 * avg) * bw)

        node_val = (1.0 - t_cell) * dir_vals[0] + t_cell * dir_vals[1]
        value = torch.where(at_transition, node_val, fast_val)
        result = torch.where(found | ~is_active, result, value)
        found = found | is_active

    return result


def interpolate_writeback_fields(labels, u, vel_kinds, levels):
    """Node pipeline + per-axis dense interpSPGrid: the values writeback
    consumes at UNASSIGNED level-0 faces."""
    node_vals, _ = build_node_velocities(labels, u, vel_kinds)
    return [interpolate_level0_faces(labels, u, vel_kinds, node_vals, a) for a in range(3)]
