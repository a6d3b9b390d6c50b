"""Variational stress stencils as dense per-level term bundles (port of
``stencils.py``).

Each stress grid carries a list of :class:`StressTerm` (lift, face axis,
source level, offset, coefficient tensor) such that

    tau = sum_t  coeff_t * gather(lift_t(u), offset_t)

reproduces the reference's gradient rows D (getEdgeStressFaces /
getCenterStressFaces, reference Source/HDK_AdaptiveViscosity.cpp:
1717-1963); the same list yields D^T and the Jacobi diagonal.  Case labels
(T1-T5 edge, C1-C2 center) follow the JAX module's docstring.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import torch

from . import classify, octree
from .config import SolverConfig
from .fields import _axis_lerp, cell_to_face_avg
from .ops.arrayops import edge_shape, face_shape, fill_where, gather_offset, iota, pad_edge, upread

FLUID = classify.FLUID
UNASSIGNED = classify.UNASSIGNED
SOLIDBOUNDARY = classify.SOLIDBOUNDARY
OUTSIDE = classify.OUTSIDE


@dataclasses.dataclass
class StressTerm:
    """One dense contribution ``tau += coeff * gather(lift(u_src), offset)``."""

    lift: str            # 'same' | 'parent' | 'childsum' | 'blocksum'
    face_axis: int
    src_level: int
    offset: Tuple[int, int, int]
    coeff: torch.Tensor  # stress-grid shaped; zero where the case is inactive


@dataclasses.dataclass
class StressBlock:
    """All terms + integration weight for one stress grid."""

    kind: str            # 'edge' | 'center'
    level: int
    axis: int
    weight: Optional[torch.Tensor]
    terms: List[StressTerm]
    boundary: Optional[torch.Tensor]  # raw b_s (solid-velocity terms), level 0


def sample_cell_field_at(field: torch.Tensor, level: int, kind: str, axis: int | None = None):
    """Trilinear sample of a finest-level cell field at level-``level``
    center/edge/face positions (the reference's world-space getValue)."""
    s = 1 << level
    n = field.shape
    if kind == "center":
        c = [s * 0.5 - 0.5] * 3
        m = [d // s for d in n]
    elif kind == "edge":
        c = [s * 0.5 - 0.5 if d == axis else -0.5 for d in range(3)]
        m = [n[d] // s + (0 if d == axis else 1) for d in range(3)]
    elif kind == "face":
        c = [-0.5 if d == axis else s * 0.5 - 0.5 for d in range(3)]
        m = [n[d] // s + (1 if d == axis else 0) for d in range(3)]
    else:
        raise ValueError(kind)
    out = field
    for d in range(3):
        pads = [(0, 0)] * 3
        pads[d] = (1, 1)
        g = pad_edge(out, pads)
        cc = c[d] + 1.0
        b = math.floor(cc)
        h = _axis_lerp(g, d, cc - b)
        idx = [slice(None)] * 3
        idx[d] = slice(b, b + s * (m[d] - 1) + 1, s)
        out = h[tuple(idx)]
    return out


def _face_avg_component(solid_velocity, comp_axis, face_axis, eshape, off):
    """Solid-velocity component ``comp_axis`` at the centers of
    ``face_axis`` faces (the MAC field averaged to cell centers along
    ``comp_axis``, then to the faces), gathered onto the edge grid; only
    the compat boundary reads it."""
    sv = solid_velocity[comp_axis]
    lo = tuple(slice(0, -1) if d == comp_axis else slice(None) for d in range(3))
    hi = tuple(slice(1, None) if d == comp_axis else slice(None) for d in range(3))
    x = 0.5 * (sv[lo] + sv[hi])
    return gather_offset(cell_to_face_avg(x, face_axis), eshape, off)


def _parity(shape, axis, even: bool, device):
    idx = iota(shape, axis, device)
    return (idx % 2 == 0) if even else (idx % 2 == 1)


def _unit(axis, sign=1):
    off = [0, 0, 0]
    off[axis] = sign
    return tuple(off)


def _add(a, b):
    return tuple(x + y for x, y in zip(a, b))


def _where0(cond, value):
    return torch.where(cond, value, torch.zeros((), dtype=value.dtype, device=value.device))


def build_edge_stress_blocks(labels, vel_kinds, edge_kinds, edge_w0, viscosity,
                             solid_velocity, dt, dx: float, config: SolverConfig,
                             with_weights: bool = True) -> List[StressBlock]:
    """Edge (shear) stress term bundles per level/axis
    (buildEdgeStressStencilsPartial, cpp:2059-2160)."""
    levels = len(labels)
    dev = viscosity.device
    fdtype = viscosity.dtype
    blocks = []
    for level in range(levels):
        res = tuple(labels[level].shape)
        dxw = dx * (1 << level)
        dxi = float(1 << level)
        for a in range(3):
            eshape = edge_shape(res, a)
            active_edge = edge_kinds[level][a] == FLUID
            f_axes = [f for f in range(3) if f != a]

            slot_kind = {}
            for f in f_axes:
                g = 3 - a - f
                for d in (0, 1):
                    off = _unit(g, d - 1) if d == 0 else (0, 0, 0)
                    slot_kind[(f, d)] = gather_offset(vel_kinds[level][f], eshape, off,
                                                      fill=OUTSIDE)
            gdx, is_trans, is_out, n_unassigned = {}, {}, {}, {}
            for f in f_axes:
                g = 3 - a - f
                k0, k1 = slot_kind[(f, 0)], slot_kind[(f, 1)]
                u = (k0 == UNASSIGNED).to(fdtype) + (k1 == UNASSIGNED).to(fdtype)
                n_unassigned[g] = u
                gdx[g] = dxw * (1.0 + 0.5 * u)
                is_trans[g] = (((k0 == UNASSIGNED) | (k1 == UNASSIGNED))
                               if config.use_enhanced_gradients
                               else torch.zeros(eshape, dtype=torch.bool, device=dev))
                is_out[g] = ((k0 == OUTSIDE) | (k0 == SOLIDBOUNDARY)
                             | (k1 == OUTSIDE) | (k1 == SOLIDBOUNDARY))

            terms: List[StressTerm] = []
            boundary = None
            for f in f_axes:
                g = 3 - a - f
                base_inv = 1.0 / gdx[g]
                enh = is_trans[g] & ~is_out[g]
                for d in (0, 1):
                    off = _unit(g, d - 1) if d == 0 else (0, 0, 0)
                    sign = -1.0 if d == 0 else 1.0
                    k = slot_kind[(f, d)]
                    act = (k == FLUID) & active_edge
                    base = sign * base_inv

                    # T1: the face itself
                    c1 = _where0(act, torch.where(enh, 0.25 * base, 0.5 * base))
                    terms.append(StressTerm("same", f, level, off, c1))
                    # T2: enhanced-gradient sibling (cpp:1813-1824)
                    for even, so in ((True, 1), (False, -1)):
                        c2 = _where0(act & enh & _parity(eshape, a, even, dev), 0.25 * base)
                        terms.append(StressTerm("same", f, level, _add(off, _unit(a, so)), c2))

                    una = (k == UNASSIGNED) & active_edge
                    dangling = _parity(eshape, f, False, dev)
                    if level + 1 < levels:
                        # T3: non-dangling coarse transition -> parent face
                        c3 = _where0(una & ~dangling, 0.5 * base)
                        terms.append(StressTerm("parent", f, level + 1, off, c3))
                        # T4/T5: dangling edge (cpp:1829-1895)
                        parent_face_kind = upread(vel_kinds[level + 1][f], face_shape(res, f))
                        for so in (-1, 1):
                            offo = _add(off, _unit(f, so))
                            kp = gather_offset(parent_face_kind, eshape, offo, fill=OUTSIDE)
                            c4 = _where0(una & dangling & (kp == FLUID), 0.25 * base)
                            terms.append(StressTerm("parent", f, level + 1, offo, c4))
                            c5 = _where0(una & dangling & (kp == UNASSIGNED), 0.0625 * base)
                            terms.append(StressTerm("blocksum", f, level, offo, c5))

                    if level == 0:
                        sb = (k == SOLIDBOUNDARY) & active_edge
                        if config.compat_edge_boundary_component:
                            # the reference's edge-axis component at the
                            # face center (cpp:1901)
                            svc = _face_avg_component(solid_velocity, a, f, eshape, off)
                        else:
                            svc = gather_offset(solid_velocity[f], eshape, off)
                        contrib = _where0(sb, 0.5 * base * svc)
                        boundary = contrib if boundary is None else boundary + contrib

            if with_weights:
                # integration weight (cpp:2124-2155): stretched index-unit volume
                vol = dxi
                for f in f_axes:
                    g = 3 - a - f
                    vol = vol * dxi * (1.0 + 0.5 * n_unassigned[g])
                if level == 0:
                    w0 = edge_w0[a].to(fdtype)
                    vol = torch.where(w0 == 1.0, vol, w0)
                visc = sample_cell_field_at(viscosity, level, "edge", a)
                weight = _where0(active_edge, 4.0 * dt * vol * visc)
            else:
                weight = None
                boundary = None
            blocks.append(StressBlock("edge", level, a, weight, terms, boundary))
    return blocks


def build_center_stress_blocks(labels, vel_kinds, center_kinds, center_w0, viscosity,
                               solid_velocity, dt, dx: float, config: SolverConfig,
                               with_weights: bool = True) -> List[StressBlock]:
    """Center (normal) stress term bundles per level and component axis
    (buildCenterStressStencilsPartial + weights, cpp:2162-2289)."""
    levels = len(labels)
    fdtype = viscosity.dtype
    blocks = []
    for level in range(levels):
        res = tuple(labels[level].shape)
        dxw = dx * (1 << level)
        dxi = float(1 << level)
        active_c = center_kinds[level] == FLUID
        if with_weights:
            if level == 0:
                vol = center_w0.to(fdtype)
            else:
                vol = torch.full(res, dxi ** 3, dtype=fdtype, device=viscosity.device)
            visc = sample_cell_field_at(viscosity, level, "center")
            weight = _where0(active_c, 2.0 * dt * vol * visc)
        else:
            weight = None

        for axis in range(3):
            terms: List[StressTerm] = []
            boundary = None
            for d in (0, 1):
                off = (0, 0, 0) if d == 0 else _unit(axis, 1)
                sign = -1.0 if d == 0 else 1.0
                k = gather_offset(vel_kinds[level][axis], res, off, fill=OUTSIDE)
                act = (k == FLUID) & active_c
                terms.append(StressTerm("same", axis, level, off,
                                        fill_where(act, sign / dxw, 0.0, fdtype)))
                if level > 0:
                    una = (k == UNASSIGNED) & active_c
                    terms.append(StressTerm("childsum", axis, level - 1, off,
                                            fill_where(una, 0.25 * sign / dxw, 0.0, fdtype)))
                if level == 0:
                    sb = (k == SOLIDBOUNDARY) & active_c
                    sv = gather_offset(solid_velocity[axis], res, off)
                    contrib = _where0(sb, sign / dxw * sv)
                    boundary = contrib if boundary is None else boundary + contrib
            blocks.append(StressBlock("center", level, axis, weight, terms,
                                      boundary if with_weights else None))
    return blocks


def build_mass(labels, vel_kinds, face_w0, density) -> Dict[Tuple[int, int], torch.Tensor]:
    """Lumped mass per velocity DOF: density * stretched face control volume
    (faceOctreeVolumes, cpp:1965-2002 + level-0 face weights, cpp:2746-2766)."""
    mass = {}
    fdtype = density.dtype
    for level, lab in enumerate(labels):
        res = tuple(lab.shape)
        dxi = float(1 << level)
        for a in range(3):
            fshape = face_shape(res, a)
            active = vel_kinds[level][a] == FLUID
            gdx = torch.zeros(fshape, dtype=fdtype, device=density.device)
            for d in (0, 1):
                off = _unit(a, d - 1) if d == 0 else (0, 0, 0)
                lk = gather_offset(lab, fshape, off, fill=octree.INACTIVE)
                gdx = gdx + fill_where(lk == octree.UP, dxi, 0.5 * dxi, fdtype)
            vol = dxi * dxi * gdx
            if level == 0:
                w0 = face_w0[a].to(fdtype)
                vol = torch.where(w0 == 1.0, vol, w0)
            rho = sample_cell_field_at(density, level, "face", a)
            mass[(level, a)] = _where0(active, vol * rho)
    return mass
