"""Octree label pyramid with 2:1 face grading (port of ``octree.py``).

Semantics of HDK_OctreeGrid (reference Source/HDK_OctreeGrid.{h,cpp})
as whole-tensor passes over a level-major pyramid of dense int8 labels:
INACTIVE (0), ACTIVE (1, leaf), UP (2, below a leaf), DOWN (3, above).
"""

from __future__ import annotations

from typing import List, Sequence

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


def active_cell_counts(labels: Sequence[torch.Tensor]) -> torch.Tensor:
    """Number of ACTIVE cells per level."""
    return torch.stack([(lab == ACTIVE).sum() for lab in labels])


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
