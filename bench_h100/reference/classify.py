"""DOF classification on the octree pyramid (port of ``classify.py``).

Every grid point gets a kind (HDK_Utilities.h:18-21): FLUID (0, an
unknown), UNASSIGNED (-1), SOLIDBOUNDARY (-2), OUTSIDE (-3), as int8
tensors.  Label passes follow the reference's classifiers
(reference Source/HDK_AdaptiveViscosity.cpp:1087-1443).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from . import octree
from .fields import cell_to_face_avg
from .ops.arrayops import edge_shape, face_shape, grow, iota

FLUID = 0
UNASSIGNED = -1
SOLIDBOUNDARY = -2
OUTSIDE = -3

KIND_DTYPE = torch.int8

ACTIVE = octree.ACTIVE
INACTIVE = octree.INACTIVE
UP = octree.UP
DOWN = octree.DOWN


def _k(v: int, device) -> torch.Tensor:
    return torch.tensor(v, dtype=KIND_DTYPE, device=device)


def _face_cell_labels(labels: torch.Tensor, axis: int):
    """Per-face (backward, forward) cell labels + the out-of-bounds mask."""
    n = labels.shape[axis]
    back = grow(labels, axis, lo=1, fill=INACTIVE)
    fwd = grow(labels, axis, hi=1, fill=INACTIVE)
    idx = iota(face_shape(labels.shape, axis), axis, labels.device)
    oob = (idx == 0) | (idx == n)
    return back, fwd, oob


def _face_weight_activity(center_w, edge_w: Sequence[torch.Tensor], axis: int):
    """A face is near the surface iff an adjacent center weight or one of
    its 4 surrounding edge weights is positive (cpp:1127-1150)."""
    back_w = grow(center_w, axis, lo=1, fill=0.0)
    fwd_w = grow(center_w, axis, hi=1, fill=0.0)
    act = (back_w > 0) | (fwd_w > 0)
    for edge_axis in range(3):
        if edge_axis == axis:
            continue
        offset_axis = 3 - axis - edge_axis
        ew = edge_w[edge_axis]
        n_off = ew.shape[offset_axis]
        lo = [slice(None)] * 3
        hi = [slice(None)] * 3
        lo[offset_axis] = slice(0, n_off - 1)
        hi[offset_axis] = slice(1, n_off)
        act = act | (ew[tuple(lo)] > 0) | (ew[tuple(hi)] > 0)
    return act


def classify_regular_velocity(center_w, edge_w, solid_sdf, extrapolation: float,
                              axis: int) -> torch.Tensor:
    """Uniform-grid face classification (cpp:1087-1165)."""
    dev = center_w.device
    idx = iota(face_shape(center_w.shape, axis), axis, dev)
    oob = (idx == 0) | (idx == center_w.shape[axis])
    active = _face_weight_activity(center_w, edge_w, axis)
    in_solid = cell_to_face_avg(solid_sdf, axis) < extrapolation
    return torch.where(
        (~oob) & active,
        torch.where(in_solid, _k(SOLIDBOUNDARY, dev), _k(FLUID, dev)),
        _k(UNASSIGNED, dev),
    )


def classify_octree_velocity(labels, center_w, edge_w, solid_sdf,
                             extrapolation: float) -> List[List[torch.Tensor]]:
    """Octree face classification per level/axis (cpp:1167-1323)."""
    dev = center_w.device
    kinds: List[List[torch.Tensor]] = []
    for level, lab in enumerate(labels):
        per_axis = []
        for axis in range(3):
            back, fwd, oob = _face_cell_labels(lab, axis)
            both_active = (back == ACTIVE) & (fwd == ACTIVE)
            any_inactive = (back == INACTIVE) | (fwd == INACTIVE)
            act_up = ((back == UP) & (fwd == ACTIVE)) | ((back == ACTIVE) & (fwd == UP))
            if level == 0:
                active = _face_weight_activity(center_w, edge_w, axis)
                in_solid = cell_to_face_avg(solid_sdf, axis) < extrapolation
                surface_kind = torch.where(
                    active,
                    torch.where(in_solid, _k(SOLIDBOUNDARY, dev), _k(FLUID, dev)),
                    _k(OUTSIDE, dev),
                )
                kind = torch.where(
                    oob, _k(OUTSIDE, dev),
                    torch.where(
                        both_active, surface_kind,
                        torch.where(
                            any_inactive, _k(OUTSIDE, dev),
                            torch.where(act_up, _k(FLUID, dev), _k(UNASSIGNED, dev)),
                        ),
                    ),
                )
            else:
                kind = torch.where((~oob) & (both_active | act_up),
                                   _k(FLUID, dev), _k(UNASSIGNED, dev))
            per_axis.append(kind)
        kinds.append(per_axis)
    return kinds


def classify_edge_stress(labels, edge_w) -> List[List[torch.Tensor]]:
    """Edge (shear) stress classification (cpp:1325-1405): the four
    surrounding cells in cellIndex order with early exits, as a state
    machine over dense masks (0 pending, 1 outside, 2 unassigned/DOWN)."""
    kinds: List[List[torch.Tensor]] = []
    for level, lab in enumerate(labels):
        dev = lab.device
        res = tuple(lab.shape)
        per_axis = []
        for axis in range(3):
            eshape = edge_shape(res, axis)
            t1, t2 = (axis + 1) % 3, (axis + 2) % 3
            status = torch.zeros(eshape, dtype=torch.int8, device=dev)
            any_active = torch.zeros(eshape, dtype=torch.bool, device=dev)
            idx1 = iota(eshape, t1, dev)
            idx2 = iota(eshape, t2, dev)
            for cell_index in range(4):
                d1 = 0 if (cell_index & 1) else -1
                d2 = 0 if (cell_index & 2) else -1
                arr = lab
                for t, d in ((t1, d1), (t2, d2)):
                    if d == 0:
                        arr = grow(arr, t, hi=1, fill=INACTIVE)
                    else:
                        arr = grow(arr, t, lo=1, fill=INACTIVE)
                cl = arr
                ob = ((idx1 + d1 < 0) | (idx1 + d1 >= res[t1])
                      | (idx2 + d2 < 0) | (idx2 + d2 >= res[t2]))
                status = torch.where((status == 0) & ob, _k(1, dev), status)
                status = torch.where((status == 0) & (cl == DOWN), _k(2, dev), status)
                any_active = any_active | ((status == 0) & (cl == ACTIVE))
            if level == 0:
                fluid_kind = torch.where(edge_w[axis] > 0, _k(FLUID, dev), _k(OUTSIDE, dev))
            else:
                fluid_kind = _k(FLUID, dev)
            kind = torch.where(
                status == 1, _k(OUTSIDE, dev),
                torch.where((status == 0) & any_active, fluid_kind, _k(UNASSIGNED, dev)),
            )
            per_axis.append(kind)
        kinds.append(per_axis)
    return kinds


def classify_center_stress(labels, center_w) -> List[torch.Tensor]:
    """One normal-stress DOF per ACTIVE cell; level 0 also needs a positive
    center weight (cpp:1407-1443)."""
    kinds = []
    for level, lab in enumerate(labels):
        active = lab == ACTIVE
        if level == 0:
            active = active & (center_w > 0)
        kinds.append(torch.where(active, _k(FLUID, lab.device), _k(UNASSIGNED, lab.device)))
    return kinds
