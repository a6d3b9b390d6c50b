"""The second count of the topology (``reference/census.py``) equals the
reference's label passes on the benchmark's scenes, still and turned, and
``correct`` sees a DOF count that the program and the copied passes
share."""

import pytest
import torch

from _h100 import run, small_cell
import check
import frames
from reference.config import SolverConfig as RefConfig
from reference.solve import reference_frame

TURNED = {"pivot": [0.08, 0.65], "degrees": [0.0, 20.0]}


@pytest.mark.parametrize("scene, n, rotate", [("beam", 32, None), ("beam", 32, TURNED),
                                              ("buckling", 64, None), ("buckling", 48, None),
                                              ("beam", 64, TURNED)],
                         ids=["beam-32", "beam-32-turned", "buckling-64", "buckling-48",
                              "beam-64-turned"])
def test_census_equals_the_label_passes(scene, n, rotate):
    config = {"scene": scene, "n": n, "dtype": "float32", "density": 1.0, "dt": 1 / 24,
              "viscosity": 5.0 if scene == "beam" else 20.0}
    traffic = {"states": 3 if rotate else 1, "gravity": -9.8, "start": [0.0, 2.0]}
    if rotate:
        traffic["rotate"] = rotate
    dt = float(torch.tensor(1 / 24, dtype=torch.float32))
    for state in frames.make_states(config, traffic, 1, "cpu"):
        ref = reference_frame(state, dt, RefConfig(octree_levels=4, tolerance=1e-4),
                              solve=False)
        assert ref["census"] == {k: ref[k] for k in ("active_cells", "octree_dofs",
                                                     "regular_dofs")}
        assert ref["octree_dofs"] > 0 and len(ref["active_cells"]) > 1


def test_a_wrong_dof_count_is_not_correct():
    cell, config, traffic = small_cell("beam-64.steady", n=16, states=1)
    (state,) = frames.make_states(config, traffic, 3, "cpu")
    ref = reference_frame(state, run.dt_of(config), run.reference_config(config))
    stats = {k: ref[k] for k in ("iterations", "residual", "octree_dofs", "regular_dofs",
                                 "active_cells")}
    limits = {k: float(v) for k, v in config["limits"].items()}
    assert check.passes(check.compare(ref["velocity"], stats, ref), limits)
    # a slip that the program and the copied label passes share: the two
    # agree with each other, and the census does not
    for key, change in (("octree_dofs", 1), ("regular_dofs", -1)):
        shared = dict(ref, **{key: ref[key] + change})
        reading = check.compare(ref["velocity"], dict(stats, **{key: shared[key]}), shared)
        assert reading["topology_gap"] == 1
        assert not check.passes(reading, limits)
