"""The refined float64 configuration (``configs/buckling-192-refined.json``)
and the readers of its layer (``metrics/refine_*.py``): the file maps to
the program's refinement and the reference's tolerance and cap, its
control is float32, a copy cut to 24^3 is ``correct`` on the CPU, and each
reader reads hand-made runs, or nothing where its spans are absent.

24^3, not 16^3: at 16^3 the program and the reference part by about 1e-6
of the largest speed (vel_rel 1.3e-6 on this seed), far above this
configuration's velocity limits, as any two solves of that small frame to
1e-9 do (directions its system leaves all but free); at 24^3 they read
vel_rel 1.1e-10, under the limit of 1e-9."""

import pytest
import torch

from _h100 import run, small_cell
import control
import roofline

WORKLOAD = "buckling-192-refined.steady"
SEED = 2**31 + 1009


def reader(name):
    return run.load_module(run.HERE / "metrics" / f"{name}.py").read


def test_configuration_maps_to_refinement_and_the_reference_stopping_rule():
    from adaptiveviscositysolver_tpu_torch import SolverConfig

    cell, config, traffic = small_cell(WORKLOAD, n=192)
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("buckling-192-refined",
                                                                "steady", 1)
    assert config["dtype"] == "float64" and config["reduced"] == []
    assert run.solver_config(config) == SolverConfig(
        use_iterative_refinement=True, tolerance=1e-9, max_iterations=2500, octree_levels=4,
        cheb_degree=1, dtype=None)
    ref = run.reference_config(config)
    assert (ref.tolerance, ref.max_iterations, ref.octree_levels) == (1e-9, 2500, 4)
    assert control.control_dtype(config) is torch.float32


def test_cut_copy_is_correct_on_the_cpu():
    from adaptiveviscositysolver_tpu_torch import make_solver

    cell, config, traffic = small_cell(WORKLOAD, n=24, states=1)
    paths = []

    def factory(cfg, device=None):
        solve = make_solver(cfg, device=device)

        def recorded(state, dt, stage_times=None):
            out = solve(state, dt, stage_times=stage_times)
            paths.append(out.stats.solve_path)
            return out

        return recorded

    res = run.run_cell(cell, config, traffic, SEED, 0.0, False, "cpu", make_solver=factory)
    assert res["correct"] is True, res["checks"]
    assert paths and set(paths) == {"refined"}


def frame(iterations, dispatches=1, profiled=False, windows=None, **spans):
    """A traced frame's record: ``spans`` name -> (seconds, entries)."""
    stage_s = {"solve": 2.0}
    entries = {"solve": dispatches}
    for key, (s, n) in spans.items():
        name = key.replace("_", ".")
        stage_s[name], entries[name] = s, n
    return {"iterations": iterations, "stage_s": stage_s, "entries": entries,
            "profiled": profiled, "levels": 1 if windows is None else len(windows),
            "windows": windows}


def run_of(frames, busy_us=()):
    timing = [f for f in frames if not f["profiled"]]
    profiled = [f for f in frames if f["profiled"]]
    traced = [{"solve_busy_us": [b]} for b in busy_us]
    return {"frames": frames, "timing_frames": timing or frames, "profiled_frames": profiled,
            "trace": {"frames": traced}}


WINDOWS = (((0, 64), (0, 96), (0, 64)), ((0, 32), (0, 48), (0, 32)))


def refined_frames():
    return [
        # profiled: in the counts and the roofline, out of the stage wall
        frame(800, profiled=True, windows=WINDOWS, refine_inner=(1.0, 4),
              refine_residual=(0.1, 5), cg_apply=(1.0, 804), apply_capture=(0.01, 1),
              apply_replay=(0.5, 803)),
        frame(800, refine_inner=(1.0, 4), refine_residual=(0.1, 5), cg_apply=(1.0, 804),
              apply_capture=(0.01, 1), apply_replay=(0.5, 803)),
        frame(600, refine_inner=(1.0, 2), refine_residual=(0.1, 3), cg_apply=(1.0, 602),
              apply_capture=(0.01, 1), apply_replay=(0.5, 601)),
        # solved twice: left out of every reading
        frame(50, dispatches=2, refine_inner=(1.0, 9), refine_residual=(0.1, 11),
              cg_apply=(1.0, 70), apply_capture=(0.01, 2), apply_replay=(0.5, 68)),
    ]


def test_refine_readers_over_frames_that_dispatched_once():
    r = run_of(refined_frames(), busy_us=[1.5e6])
    assert reader("refine_passes")(r) == pytest.approx((4 + 4 + 2) / 3)
    assert reader("refine_replay_share")(r) == pytest.approx((803 + 803 + 601) / (804 + 804 + 602))
    assert reader("refine_ms_per_inner_iter")(r) == pytest.approx(1e3 * 4.0 / 1400)
    want = roofline.solve_bytes(WINDOWS, 800) / roofline.HBM_BYTES_PER_S / 1.5
    assert reader("refine_roofline")(r) == pytest.approx(100.0 * want)


def test_eager_inner_applies_read_a_zero_replay_share():
    """The parent's refined route: every apply eager, no graph spans."""
    frames = [frame(800, cg_apply=(1.0, 809)) for _ in range(2)]
    assert reader("refine_replay_share")(run_of(frames)) == 0.0


@pytest.mark.parametrize("name", ["refine_passes", "refine_replay_share",
                                  "refine_ms_per_inner_iter", "refine_roofline"])
def test_refine_reader_without_its_spans_reads_none(name):
    """A stage other than ``solve`` only, and no profiled frame: nothing to
    read."""
    frames = [{"iterations": 0, "stage_s": {"build_system": 0.1},
               "entries": {"build_system": 1}, "profiled": False} for _ in range(2)]
    assert reader(name)(run_of(frames)) is None
    assert reader(name)(run_of([])) is None
