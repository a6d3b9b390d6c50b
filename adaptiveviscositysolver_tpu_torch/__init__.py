"""PyTorch + CUDA port of the adaptive octree viscosity solver.

A second package beside ``adaptiveviscositysolver_tpu`` (the JAX reference,
left unchanged).  Module names mirror the JAX package so each counterpart
is easy to find; the hot matvec runs through hand-written CUDA kernels for
Hopper (``csrc/fused_apply.cu``, built with ``nvcc`` at first use and bound
with ``ctypes``), everything else is plain PyTorch.

Entry points take an explicit ``device=`` and default to ``"cuda"``; pass
``device="cpu"`` to run the plain-PyTorch versions of the kernels.
"""

from .config import SolverConfig  # noqa: F401
