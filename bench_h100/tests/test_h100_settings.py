"""The solver settings a configuration file states reach the program and
the reference as ``run.SETTINGS`` says: the committed configurations map to
the settings they have always run, a refined float64 configuration runs
the program's refinement and is ``correct`` where its float32 control is
not, and a setting a run would ignore is refused before set-up."""

import dataclasses

import pytest
import torch

from _h100 import run, small_cell
import control

# every field, so that an edit of a configuration, of the table or of a
# default shows
PROGRAM = {"octree_levels": 4, "fine_bandwidth": 2, "extrapolation": 0.5, "num_supersamples": 3,
           "apply_solid_weights": False, "use_enhanced_gradients": True,
           "compat_edge_boundary_component": False, "tolerance": 1e-4, "max_iterations": 2500,
           "cheb_degree": 1, "cancel_poll_iters": 0, "dtype": None, "apply_impl": "auto",
           "use_iterative_refinement": False}
REFERENCE = {"octree_levels": 4, "fine_bandwidth": 2, "extrapolation": 0.5, "num_supersamples": 3,
             "apply_solid_weights": False, "use_enhanced_gradients": True,
             "compat_edge_boundary_component": False, "tolerance": 1e-4, "max_iterations": 2500}
COMMITTED = ["buckling-192.steady", "beam-64.steady"]

# buckling in float64, refined to 1e-9, and the number by which its float32
# control fails.  Limits from CPU runs (seeds 2^31 + 77 and 5).  At 16^3 the
# program read vel_rel 6.1e-7-1.8e-6, vel_l2 2.7e-8-7.5e-8 (the reference's
# own CG, stopped at 9.6e-10, is that far off), iters_gap 99-116, residual
# 2.3e-10-3.2e-10; its control's CG stalls near 6e-7, then diverges, and
# reads a residual of 55 or more at max_iterations.  At 32^3 the program
# read vel_rel 9.5e-12, vel_l2 8.4e-13, iters_gap 45, residual 4.0e-10; the
# control converges (residual 9.2e-10-9.4e-10, iters_gap 1), so only the
# velocity numbers tell it apart: vel_rel 7.8e-7-1.6e-6, vel_l2
# 5.4e-8-7.5e-8, as on the card at 64^3 and 192^3.
REFINED = {"dtype": "float64", "use_iterative_refinement": True, "tolerance": 1e-9,
           "max_iterations": 300,
           "limits": {"vel_rel": 3e-5, "vel_l2": 1e-6, "iters_gap": 250, "topology_gap": 0,
                      "residual": 1e-9}}
REFINED_32 = dict(REFINED, max_iterations=600,
                  limits={"vel_rel": 1e-9, "vel_l2": 1e-10, "iters_gap": 250,
                          "topology_gap": 0, "residual": 1e-9})
SEED = 2**31 + 77


def _refined(n=16, changes=REFINED):
    cell, config, traffic = small_cell("buckling-192.steady", n=n, states=1)
    return cell, dict(config, **changes), traffic


@pytest.mark.parametrize("workload", COMMITTED)
def test_committed_configurations_run_the_settings_they_always_ran(workload):
    _, config, _ = small_cell(workload)
    assert dataclasses.asdict(run.solver_config(config)) == PROGRAM
    assert dataclasses.asdict(run.reference_config(config)) == REFERENCE
    assert control.control_dtype(config) is torch.bfloat16


def test_refined_settings_reach_both_sides():
    _, config, _ = _refined()
    cfg = run.solver_config(config)
    assert cfg.use_iterative_refinement is True and cfg.dtype is None
    assert (cfg.tolerance, cfg.max_iterations) == (1e-9, 300)
    ref = run.reference_config(config)
    assert (ref.tolerance, ref.max_iterations) == (1e-9, 300)
    assert control.control_dtype(config) is torch.float32


@pytest.mark.parametrize("n, changes, fails", [(16, REFINED, "residual"),
                                                (32, REFINED_32, "vel_rel")],
                         ids=["16", "32"])
def test_refined_float64_is_correct_and_its_float32_control_is_not(n, changes, fails):
    from adaptiveviscositysolver_tpu_torch import make_solver

    cell, config, traffic = _refined(n, changes)
    seen, paths = [], []

    def factory(cfg, device=None):
        seen.append(cfg)
        solve = make_solver(cfg, device=device)

        def recorded(state, dt, stage_times=None):
            out = solve(state, dt, stage_times=stage_times)
            paths.append(out.stats.solve_path)
            return out

        return recorded

    res = run.run_cell(cell, config, dict(traffic, warmup_frames=1), SEED, 0.0, False, "cpu",
                       make_solver=factory)
    assert res["correct"] is True, res["checks"]
    assert [c.use_iterative_refinement for c in seen] == [True]
    assert paths and set(paths) == {"refined"}

    res = run.run_cell(cell, config, dict(traffic, warmup_frames=0), SEED, 0.0, False, "cpu",
                       make_solver=control.control_solver(config))
    assert res["attempted"] == 1
    assert res["correct"] is False
    reading = res["checks"][fails]
    assert not reading["value"] <= reading["limit"], res["checks"]


@pytest.mark.parametrize("key, changes", [
    ("apply_impl", {"apply_impl": "v1"}),
    ("cancel_poll_iters", {"cancel_poll_iters": 8}),
    ("cheb_degree", dict(REFINED, cheb_degree=3)),
    ("use_iterative_refinement", {"use_iterative_refinement": True}),
    ("use_iterative_refinement", dict(REFINED, use_iterative_refinement="yes")),
    ("max_iterations", {"max_iterations": 2.5}),
    ("octree_levels", {"octree_levels": True}),
], ids=["unread-field", "unread-poll", "cheb-under-refinement", "refined-float32",
        "switch-not-bool", "count-not-int", "count-is-bool"])
def test_a_setting_the_run_would_ignore_is_refused_before_set_up(key, changes, monkeypatch):
    cell, config, traffic = small_cell("buckling-192.steady", n=16, states=1)

    def set_up(*args, **kwargs):
        raise AssertionError("set-up reached")

    monkeypatch.setattr(run.frames, "make_states", set_up)
    with pytest.raises(ValueError, match=key):
        run.run_cell(cell, dict(config, **changes), traffic, SEED, 0.0, False, "cpu",
                     make_solver=set_up)
