"""The benchmark's plain reference of one viscosity frame.

A frozen copy of the whole-array modules of
``adaptiveviscositysolver_tpu_torch`` (fields, octree, classify, stencils,
restriction, the ``v1`` operator and its Jacobi CG, interpolator,
writeback), in plain PyTorch, with no crop windows, routes, kernels or
cache.  It is kept here so that the yardstick stays fixed while the program
changes, and it imports nothing of the program: ``solve.reference_frame``
rebuilds every derived quantity from the same input tensors the program is
given.
"""
