"""Scale-out of the solve over ranks of a ``torch.distributed`` group
(port of the JAX package's ``parallel/``): ``mesh`` (the group, slabs of
the state, the sharded solver, the rank launcher) and ``shard_fused`` (the
sharded CG with the port's kernels on halo-filled local boxes)."""
