"""Octree label pyramid with 2:1 face grading (port of ``octree.py``).

Semantics of HDK_OctreeGrid (reference Source/HDK_OctreeGrid.{h,cpp})
as whole-tensor passes over a level-major pyramid of dense int8 labels:
INACTIVE (0), ACTIVE (1, leaf), UP (2, below a leaf), DOWN (3, above).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from .ops.arrayops import down_reduce_cells, shift, upread

INACTIVE = 0
ACTIVE = 1
UP = 2
DOWN = 3

LABEL_DTYPE = torch.int8


def _i8(v: int, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=LABEL_DTYPE, device=like.device)


def mask_to_base_labels(mask: torch.Tensor) -> torch.Tensor:
    """mask > 0 -> INACTIVE, mask == 0 -> ACTIVE, mask < 0 -> UP."""
    return torch.where(mask == 0, _i8(ACTIVE, mask),
                       torch.where(mask < 0, _i8(UP, mask), _i8(INACTIVE, mask)))


def build_octree(mask: torch.Tensor, levels: int) -> List[torch.Tensor]:
    """Graded label pyramid (HDK_OctreeGrid::init, cpp:4-243), finest first."""
    res = tuple(mask.shape)
    for n in res:
        if n % (1 << (levels - 1)) != 0:
            raise ValueError(
                f"resolution {res} not divisible by 2^{levels - 1}; pad the domain first"
            )
    labels: List[torch.Tensor] = [mask_to_base_labels(mask)]
    for level in range(1, levels):
        shape = tuple(n >> level for n in res)
        labels.append(torch.full(shape, INACTIVE, dtype=LABEL_DTYPE, device=mask.device))

    act, down, up = _i8(ACTIVE, mask), _i8(DOWN, mask), _i8(UP, mask)
    for level in range(levels - 1):
        lab = labels[level]
        parent = labels[level + 1]

        # pass 1 (cpp:395-565)
        group_has_active = down_reduce_cells(lab == ACTIVE, "any")
        lab = torch.where((lab == UP) & upread(group_has_active, lab.shape), act, lab)
        parent = torch.where(down_reduce_cells(lab == ACTIVE, "any"), down, parent)

        # pass 2, face grading (cpp:656-754)
        is_active = lab == ACTIVE
        is_up = lab == UP
        up_near_active = torch.zeros(lab.shape, dtype=torch.bool, device=lab.device)
        for axis in range(3):
            for offset in (-1, 1):
                up_near_active |= is_up & shift(is_active, axis, offset, fill=False)
        parent = torch.where(down_reduce_cells(lab == DOWN, "any"), down, parent)
        parent = torch.where(down_reduce_cells(up_near_active, "any"), act, parent)

        # pass 3 (cpp:756-840)
        parent = torch.where(
            (parent == INACTIVE) & down_reduce_cells(lab == UP, "any"), up, parent)

        labels[level] = lab
        labels[level + 1] = parent

    # top level clean-up (cpp:843-875)
    labels[-1] = torch.where(labels[-1] == UP, act, labels[-1])
    return labels


def refine_grid(labels: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Every level at twice its resolution (HDK_OctreeGrid::refineGrid,
    cpp:1306-1362): each new cell copies its parent's label."""
    return [upread(lab, tuple(2 * n for n in lab.shape)) for lab in labels]


def active_cell_counts(labels: Sequence[torch.Tensor]) -> torch.Tensor:
    """Number of ACTIVE cells per level."""
    return torch.stack([(lab == ACTIVE).sum() for lab in labels])


def occupied_bboxes(labels: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Per level, the (3, 2) [lo, hi) cell box of the non-INACTIVE region;
    (0, 0) rows when empty."""
    out = []
    for lab in labels:
        present = lab != INACTIVE
        rows = []
        for d in range(3):
            axes = tuple(a for a in range(3) if a != d)
            line = present.any(dim=axes[1]).any(dim=axes[0])
            n = line.shape[0]
            idx = torch.arange(n, device=lab.device)
            lo = torch.where(line, idx, n).min()
            hi = torch.where(line, idx, -1).max() + 1
            empty = ~line.any()
            zero = torch.zeros((), dtype=idx.dtype, device=lab.device)
            rows.append(torch.stack([torch.where(empty, zero, lo),
                                     torch.where(empty, zero, hi)]))
        out.append(torch.stack(rows))
    return out


def octree_geometry(labels: Sequence[torch.Tensor], dx: float, origin=(0.0, 0.0, 0.0)):
    """ACTIVE cell centers with per-point scale and level, the analog of
    outputOctreeGeometry (HDK_OctreeGrid.cpp:245-308).  A host helper:
    returns numpy arrays positions (N, 3), pscale (N,), level (N,)."""
    positions, pscales, levs = [], [], []
    for level, lab in enumerate(labels):
        lab = lab.cpu().numpy() if isinstance(lab, torch.Tensor) else np.asarray(lab)
        level_dx = dx * (1 << level)
        idx = np.argwhere(lab == ACTIVE)
        if idx.size == 0:
            continue
        positions.append((idx + 0.5) * level_dx + np.asarray(origin))
        pscales.append(np.full(len(idx), level_dx))
        levs.append(np.full(len(idx), level, np.int32))
    if not positions:
        return np.zeros((0, 3)), np.zeros(0), np.zeros(0, np.int32)
    return np.concatenate(positions), np.concatenate(pscales), np.concatenate(levs)


def build_refinement_mask(liquid_sdf, solid_sdf, dx: float, extrapolation: float,
                          outer_band: float, inner_band: float) -> torch.Tensor:
    """Ternary refinement mask (buildOctree mask functor, cpp:815-870):
    fine band 0, deep interior -1 (UP), far outside +1 (INACTIVE)."""
    sdf = liquid_sdf
    deep_inside = (sdf <= -inner_band) & (solid_sdf >= (inner_band + extrapolation))
    outside = sdf >= outer_band
    one, minus, zero = (torch.tensor(v, dtype=torch.int8, device=sdf.device)
                        for v in (1, -1, 0))
    return torch.where(outside, one, torch.where(deep_inside, minus, zero))
