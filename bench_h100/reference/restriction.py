"""Full-weighting restriction of the fine-grid velocity onto the octree
(port of ``restriction.py``; buildVelocityMappingPartial,
reference Source/HDK_AdaptiveViscosity.cpp:2291-2402, as the L-fold
composition of one level-to-level restriction)."""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from .ops.arrayops import block2_sum, shift, strided_even


def restrict_face_field(u: torch.Tensor, axis: int) -> torch.Tensor:
    """Smooth [1/4, 1/2, 1/4] along the face axis, take even faces, average
    the 2x2 transverse block."""
    smooth = 0.25 * shift(u, axis, -1) + 0.5 * u + 0.25 * shift(u, axis, 1)
    coarse = strided_even(smooth, axis)
    t_axes = [d for d in range(3) if d != axis]
    return block2_sum(coarse, t_axes) * 0.25


def restrict_velocity_pyramid(regular_velocity: Sequence[torch.Tensor],
                              levels: int) -> Dict[Tuple[int, int], torch.Tensor]:
    """Restricted velocity at every (level, axis) face grid; level 0 is the
    fine field itself."""
    out: Dict[Tuple[int, int], torch.Tensor] = {}
    current: List[torch.Tensor] = list(regular_velocity)
    for level in range(levels):
        for axis in range(3):
            out[(level, axis)] = current[axis]
        if level + 1 < levels:
            current = [restrict_face_field(current[a], a) for a in range(3)]
    return out
