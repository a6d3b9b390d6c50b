"""The port's examples (counterparts of the repository's ``examples/``),
run as ``python -m adaptiveviscositysolver_tpu_torch.examples.<name>``:

* ``run_buckling`` -- FLIP frames of the buckling scene on the card, each
  frame's octree written as a PLY point cloud, with a stats line per frame.
"""
