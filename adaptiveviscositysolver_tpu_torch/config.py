"""Solver configuration (port of ``adaptiveviscositysolver_tpu/config.py``).

The knobs mirror the reference's DOP parameter sheet
(reference Source/HDK_AdaptiveViscosity.cpp:36-124) exactly as the JAX
package does; the precision switch is a ``torch.dtype``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Static configuration for one adaptive viscosity solve."""

    octree_levels: int = 4
    fine_bandwidth: int = 2

    extrapolation: float = 0.5          # in units of dx
    num_supersamples: int = 3
    apply_solid_weights: bool = False

    use_enhanced_gradients: bool = True

    # CG: Jacobi-preconditioned, Eigen's stopping rule (cpp:62-66, 611-631).
    # The JAX package's Chebyshev preconditioner, iterative refinement,
    # cancellation polling and reference-compat solid-boundary component
    # are not ported yet (convert.config_from_jax_fields refuses them).
    tolerance: float = 1e-3
    max_iterations: int = 2500

    # None inherits the input fields' dtype
    dtype: Optional[torch.dtype] = None

    # Matvec implementation:
    #   "auto" -- "cuda" for float32 fields on a CUDA device, else "v1"
    #   "cuda" -- the canonical-box fused apply (ops/fused_apply.py): the
    #             hand-written CUDA kernels on a CUDA device, their plain
    #             PyTorch version on CPU tensors.  float32 only.
    #   "v1"   -- whole-array PyTorch operator with materialized
    #             coefficients (operator.make_operator), any dtype
    apply_impl: str = "auto"

    def __post_init__(self):
        if self.octree_levels < 1:
            raise ValueError("octree_levels must be >= 1")
        if self.num_supersamples < 1:
            raise ValueError("num_supersamples must be >= 1")
        allowed = {"auto", "cuda", "v1"}
        if self.apply_impl not in allowed:
            raise ValueError(f"apply_impl must be one of {sorted(allowed)}")


def capped_levels(shape: Tuple[int, int, int], desired_levels: int) -> int:
    """Cap the level count like HDK_OctreeGrid::init (HDK_OctreeGrid.cpp:27-40):
    pad each axis to the next power of two, cap at log2 of the smallest."""
    levels = desired_levels
    for n in shape:
        padded = 1 << max(0, math.ceil(math.log2(n)) if n > 1 else 0)
        levels = min(levels, max(1, int(math.log2(padded))))
    return levels
