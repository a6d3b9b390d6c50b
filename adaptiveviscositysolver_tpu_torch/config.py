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

    # True samples the edge-axis component of the solid velocity for
    # solid-boundary faces in the shear-stress rhs, as the reference does
    # (cpp:1901); False (default) the face-axis component the replaced face
    # carries.
    compat_edge_boundary_component: bool = False

    # CG: Eigen's stopping rule (cpp:62-66, 611-631).
    tolerance: float = 1e-3
    max_iterations: int = 2500

    # Preconditioner: 1 = Jacobi (the reference's); k > 1 (odd) = a fixed
    # degree-k Chebyshev polynomial in the Jacobi-scaled operator
    # (operator.make_chebyshev_precond): about k-fold fewer CG iterations
    # at k applies each.  Even degrees go indefinite on eigenvalues above
    # the power-iteration estimate of lam_max, so they are refused.
    # Ignored under iterative refinement.
    cheb_degree: int = 1

    # Cooperative cancellation: every this-many CG iterations the solve
    # reads the process-wide flag of utils/cancel.py and stops when it is
    # set, returning the partial iterate.  0 = never.
    cancel_poll_iters: int = 0

    # None inherits the input fields' dtype
    dtype: Optional[torch.dtype] = None

    # Matvec implementation:
    #   "auto" -- "cuda" for float32 fields (or under refinement) on a
    #             CUDA device, else "v1"
    #   "cuda" -- the canonical-box fused apply (ops/fused_apply.py): the
    #             hand-written CUDA kernels on a CUDA device, their plain
    #             PyTorch version on CPU tensors.  float32 only, or the
    #             float32 inner apply of a refined solve.
    #   "v1"   -- whole-array PyTorch operator with materialized
    #             coefficients (operator.make_operator), any dtype
    #   "v1-fused" -- accepted for the JAX package's configurations; runs
    #             the "v1" operator (the same numbers) and reports "v1-fused"
    apply_impl: str = "auto"

    # Mixed precision: a float32 inner CG inside an iterative-refinement
    # loop whose residual is formed in the input dtype by the "v1" operator
    # (operator.pcg_refined); the inner apply is "cuda"'s when the impl
    # resolves to "cuda", else "v1"'s in float32.
    use_iterative_refinement: bool = False

    @property
    def fused_apply(self) -> bool:
        return self.apply_impl.endswith("-fused")

    def __post_init__(self):
        if self.octree_levels < 1:
            raise ValueError("octree_levels must be >= 1")
        if self.num_supersamples < 1:
            raise ValueError("num_supersamples must be >= 1")
        if self.cheb_degree < 1:
            raise ValueError("cheb_degree must be >= 1")
        if self.cancel_poll_iters < 0:
            raise ValueError("cancel_poll_iters must be >= 0")
        if self.cheb_degree > 1 and self.cheb_degree % 2 == 0:
            raise ValueError(
                "cheb_degree must be odd: even-degree Chebyshev is indefinite on "
                f"eigenvalues above the estimated lam_max (got {self.cheb_degree}; "
                f"use {self.cheb_degree + 1})")
        allowed = {"auto", "cuda", "v1", "v1-fused"}
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
