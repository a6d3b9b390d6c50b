"""The frozen reference computes what the program's whole-array float64
path computes, bit for bit, on the benchmark's own states at 16^3."""

import pytest
import torch

from _h100 import run
import frames
from reference.config import SolverConfig as RefConfig
from reference.solve import reference_frame


@pytest.mark.parametrize("scene, viscosity", [("beam", 5.0), ("buckling", 20.0)])
def test_reference_equals_the_programs_v1_float64_solve(scene, viscosity):
    from adaptiveviscositysolver_tpu_torch import SolverConfig, solver

    config = {"scene": scene, "n": 16, "dtype": "float32", "viscosity": viscosity,
              "density": 1.0, "dt": 1 / 24}
    traffic = {"states": 1, "gravity": -9.8, "start": [1.0, 2.0]}
    (state,) = frames.make_states(config, traffic, 1, "cpu")
    dt = float(torch.tensor(1 / 24, dtype=torch.float32))
    want = solver.solve_viscosity(
        run.fluid_state(state), dt,
        SolverConfig(octree_levels=4, tolerance=1e-4, dtype=torch.float64, apply_impl="v1"),
        device="cpu")
    got = reference_frame(state, dt, RefConfig(octree_levels=4, tolerance=1e-4))
    for g, w in zip(got["velocity"], want.velocity):
        assert torch.equal(g, w)
    assert got["iterations"] == want.stats.iterations
    assert (got["octree_dofs"], got["regular_dofs"]) == (want.stats.octree_dofs,
                                                         want.stats.regular_dofs)
    # the reference drops empty top levels, as make_solver's trim does
    kept = len(got["active_cells"])
    assert got["active_cells"] == want.stats.active_cells[:kept]
    assert not any(want.stats.active_cells[kept:])
