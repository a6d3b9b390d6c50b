"""A second count of a frame's topology, written apart from ``octree`` and
``classify`` in NumPy: the ACTIVE cells per level, the octree DOFs (FLUID
faces on every level) and the regular DOFs (FLUID faces of the uniform
grid), from the SDFs and the integration weights.

It follows the same rules (HDK_OctreeGrid::init's three passes with face
grading; the face classifiers of HDK_AdaptiveViscosity.cpp:1087-1323) and
shares none of their code, so a slip in the copied label passes or their
array helpers shows as a gap between the two counts.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

INACTIVE, ACTIVE, UP, DOWN = 0, 1, 2, 3


def _group_any(b: np.ndarray) -> np.ndarray:
    """Any of each 2x2x2 group of cells, on the parent grid."""
    x, y, z = (s // 2 for s in b.shape)
    return b.reshape(x, 2, y, 2, z, 2).any(axis=(1, 3, 5))


def _spread(parent: np.ndarray) -> np.ndarray:
    """Each parent cell's value on its eight children."""
    return parent.repeat(2, 0).repeat(2, 1).repeat(2, 2)


def _next_to(b: np.ndarray) -> np.ndarray:
    """Cells with a face neighbour in ``b``."""
    out = np.zeros_like(b)
    out[1:] |= b[:-1]
    out[:-1] |= b[1:]
    out[:, 1:] |= b[:, :-1]
    out[:, :-1] |= b[:, 1:]
    out[:, :, 1:] |= b[:, :, :-1]
    out[:, :, :-1] |= b[:, :, 1:]
    return out


def labels(liquid: np.ndarray, solid: np.ndarray, dx: float, extrapolation: float,
           fine_bandwidth: float, levels: int) -> List[np.ndarray]:
    """The graded label pyramid, finest first."""
    inner = dx * max(2.0, float(fine_bandwidth))
    outside = liquid >= 3.0 * dx
    deep = (liquid <= -inner) & (solid >= inner + extrapolation)
    pyramid = [np.where(outside, INACTIVE, np.where(deep, UP, ACTIVE)).astype(np.int8)]
    for level in range(1, levels):
        pyramid.append(np.zeros(tuple(s >> level for s in liquid.shape), dtype=np.int8))
    for level in range(levels - 1):
        lab, parent = pyramid[level], pyramid[level + 1]
        # an UP cell that shares its group with an ACTIVE one becomes ACTIVE
        lab = np.where((lab == UP) & _spread(_group_any(lab == ACTIVE)), ACTIVE, lab)
        parent = np.where(_group_any(lab == ACTIVE), DOWN, parent)
        parent = np.where(_group_any(lab == DOWN), DOWN, parent)
        # grading: a group with an UP cell next to an ACTIVE one is a leaf above
        parent = np.where(_group_any((lab == UP) & _next_to(lab == ACTIVE)), ACTIVE, parent)
        parent = np.where((parent == INACTIVE) & _group_any(lab == UP), UP, parent)
        pyramid[level], pyramid[level + 1] = lab.astype(np.int8), parent.astype(np.int8)
    pyramid[-1] = np.where(pyramid[-1] == UP, ACTIVE, pyramid[-1]).astype(np.int8)
    return pyramid


def _sides(lab: np.ndarray, axis: int):
    """The labels behind and ahead of every face normal to ``axis``
    (INACTIVE beyond the domain), and the faces on the domain's boundary."""
    pad = [(0, 0)] * 3
    pad[axis] = (1, 1)
    p = np.pad(lab, pad, constant_values=INACTIVE)
    n = lab.shape[axis]
    back = np.take(p, np.arange(0, n + 1), axis=axis)
    ahead = np.take(p, np.arange(1, n + 2), axis=axis)
    shape = [1, 1, 1]
    shape[axis] = n + 1
    idx = np.arange(n + 1).reshape(shape)
    return back, ahead, np.broadcast_to((idx == 0) | (idx == n), back.shape)


def _near_surface(center_w: np.ndarray, edge_w: Sequence[np.ndarray], axis: int) -> np.ndarray:
    """Faces with a positive weight in a cell beside them or on one of the
    four edges around them."""
    pad = [(0, 0)] * 3
    pad[axis] = (1, 1)
    p = np.pad(center_w > 0, pad)
    n = center_w.shape[axis]
    near = np.take(p, np.arange(0, n + 1), axis=axis) | np.take(p, np.arange(1, n + 2), axis=axis)
    for along in range(3):
        if along == axis:
            continue
        across = 3 - axis - along
        w = edge_w[along] > 0
        m = w.shape[across]
        near = near | np.take(w, np.arange(0, m - 1), axis=across) \
            | np.take(w, np.arange(1, m), axis=across)
    return near


def _in_solid(solid: np.ndarray, extrapolation: float, axis: int) -> np.ndarray:
    """Faces whose two cells' mean solid SDF (edge cells repeated) is
    under the extrapolation distance."""
    pad = [(0, 0)] * 3
    pad[axis] = (1, 1)
    p = np.pad(solid, pad, mode="edge")
    n = solid.shape[axis]
    mean = 0.5 * (np.take(p, np.arange(0, n + 1), axis=axis)
                  + np.take(p, np.arange(1, n + 2), axis=axis))
    return mean < extrapolation


def census(liquid: np.ndarray, solid: np.ndarray, center_w: np.ndarray,
           edge_w: Sequence[np.ndarray], dx: float, extrapolation: float,
           fine_bandwidth: float, levels: int) -> Dict[str, object]:
    """``active_cells`` (per level, empty top levels dropped),
    ``octree_dofs`` and ``regular_dofs`` of the padded fields."""
    pyramid = labels(liquid, solid, dx, extrapolation, fine_bandwidth, levels)
    octree_dofs = regular_dofs = 0
    for axis in range(3):
        surface = _near_surface(center_w, edge_w, axis) & ~_in_solid(solid, extrapolation, axis)
        _, _, edge = _sides(pyramid[0], axis)
        regular_dofs += int((surface & ~edge).sum())
        for level, lab in enumerate(pyramid):
            back, ahead, edge = _sides(lab, axis)
            both = (back == ACTIVE) & (ahead == ACTIVE)
            mixed = ((back == UP) & (ahead == ACTIVE)) | ((back == ACTIVE) & (ahead == UP))
            fluid = (both & surface) if level == 0 else both
            octree_dofs += int(((fluid | mixed) & ~edge).sum())
    counts = [int((lab == ACTIVE).sum()) for lab in pyramid]
    while len(counts) > 1 and counts[-1] == 0:
        counts.pop()
    return {"active_cells": counts, "octree_dofs": octree_dofs, "regular_dofs": regular_dofs}
