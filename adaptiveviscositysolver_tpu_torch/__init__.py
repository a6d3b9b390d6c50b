"""PyTorch + CUDA port of the adaptive octree viscosity solver.

A second package beside ``adaptiveviscositysolver_tpu`` (the JAX reference,
left unchanged).  Module names mirror the JAX package so each counterpart
is easy to find; the hot matvec runs through hand-written CUDA kernels for
Hopper (``csrc/fused_apply.cu``, built with ``nvcc`` at first use and bound
with ``ctypes``), everything else is plain PyTorch.

Entry points take an explicit ``device=`` and default to ``"cuda"``; pass
``device="cpu"`` to run the plain-PyTorch versions of the kernels.  The
top-level names are the JAX package's; importing them builds nothing.
"""

from .config import SolverConfig
from .solver import FluidState, SolveResult, SolveStats, make_solver, solve_viscosity

__all__ = [
    "SolverConfig",
    "FluidState",
    "SolveResult",
    "SolveStats",
    "make_solver",
    "solve_viscosity",
]

__version__ = "0.1.0"
