"""The solver settings the reference reads (the fields of the program's
``SolverConfig`` that the whole-array path uses, with its defaults)."""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    octree_levels: int = 4
    fine_bandwidth: int = 2
    extrapolation: float = 0.5          # in units of dx
    num_supersamples: int = 3
    apply_solid_weights: bool = False
    use_enhanced_gradients: bool = True
    compat_edge_boundary_component: bool = False
    tolerance: float = 1e-3
    max_iterations: int = 2500


def capped_levels(shape: Tuple[int, int, int], desired_levels: int) -> int:
    """Cap the level count like HDK_OctreeGrid::init (HDK_OctreeGrid.cpp:27-40):
    pad each axis to the next power of two, cap at log2 of the smallest."""
    levels = desired_levels
    for n in shape:
        padded = 1 << max(0, math.ceil(math.log2(n)) if n > 1 else 0)
        levels = min(levels, max(1, int(math.log2(padded))))
    return levels
