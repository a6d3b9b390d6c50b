"""Write the octree solution back onto the uniform grid (port of
``writeback.py``; applyVelocitiesToRegularGridPartial,
reference Source/HDK_AdaptiveViscosity.cpp:2815-2894)."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from . import classify


def apply_to_regular_grid(velocity: Sequence[torch.Tensor],
                          solution: Dict[Tuple[int, int], torch.Tensor],
                          labels, vel_kinds, regular_kinds: Sequence[torch.Tensor],
                          solid_velocity: Sequence[torch.Tensor], levels: int,
                          interpolated: Optional[Sequence[torch.Tensor]] = None
                          ) -> List[torch.Tensor]:
    """Per regular FLUID face: the level-0 octree DOF, the solid velocity at
    SOLIDBOUNDARY octree faces, the T-junction interpolated value at
    UNASSIGNED octree faces; regular SOLIDBOUNDARY faces take the solid
    velocity; untouched faces keep the input velocity."""
    out = []
    for a in range(3):
        u = velocity[a]
        okind = vel_kinds[0][a]
        rkind = regular_kinds[a]
        regular_fluid = rkind == classify.FLUID
        sol = solution[(0, a)]
        v = u.to(sol.dtype)
        v = torch.where(regular_fluid & (okind == classify.FLUID), sol, v)
        sv = solid_velocity[a].to(sol.dtype)
        v = torch.where(regular_fluid & (okind == classify.SOLIDBOUNDARY), sv, v)
        if interpolated is not None:
            v = torch.where(regular_fluid & (okind == classify.UNASSIGNED),
                            interpolated[a].to(sol.dtype), v)
        v = torch.where(rkind == classify.SOLIDBOUNDARY, sv, v)
        out.append(v.to(u.dtype))
    return out
