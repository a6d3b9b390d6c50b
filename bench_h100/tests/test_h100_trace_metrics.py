"""The readers of the program's spans inside the CG, the apply and the
frame closure (``metrics/apply_host_ms.py`` ... ``topology_builds_per_frame.py``)
held to hand-made runs."""

import pytest

from _h100 import run

NAMES = ("apply_host_ms", "apply_launch_ms", "cg_vector_ms_per_iter", "cg_readback_ms_per_iter",
         "topology_builds_per_frame")


def reader(name):
    return run.load_module(run.HERE / "metrics" / f"{name}.py").read


def frame(iterations, dispatches=1, profiled=False, **spans):
    """A traced frame's record: ``spans`` name -> (seconds, entries)."""
    stage_s = {"solve": 1.0}
    entries = {"solve": dispatches}
    for key, (s, n) in spans.items():
        name = key.replace("_", ".")
        stage_s[name], entries[name] = s, n
    return {"iterations": iterations, "stage_s": stage_s, "entries": entries,
            "profiled": profiled}


def run_of(frames):
    timing = [f for f in frames if not f["profiled"]]
    return {"frames": frames, "timing_frames": timing or frames}


def test_readers_over_unprofiled_frames_that_dispatched_once():
    frames = [
        # profiled: left out of the span walls
        frame(100, profiled=True, cg_apply=(9.0, 101), apply_kernels=(9.0, 101),
              cg_vector=(9.0, 200), cg_converged=(9.0, 101)),
        frame(100, cg_apply=(0.202, 101), apply_kernels=(0.0505, 101),
              cg_vector=(0.05, 200), cg_converged=(0.02, 101), topology_build=(0.01, 1)),
        frame(300, cg_apply=(0.598, 299), apply_kernels=(0.1495, 299),
              cg_vector=(0.15, 600), cg_converged=(0.06, 301)),
        # solved twice: out of the per-apply and per-iteration means
        frame(50, dispatches=2, cg_apply=(5.0, 102), apply_kernels=(5.0, 102),
              cg_vector=(5.0, 100), cg_converged=(5.0, 102), topology_build=(0.01, 1),
              resolve=(1.0, 1)),
    ]
    r = run_of(frames)
    assert reader("apply_host_ms")(r) == pytest.approx(1e3 * 0.8 / 400)
    assert reader("apply_launch_ms")(r) == pytest.approx(1e3 * 0.2 / 400)
    assert reader("cg_vector_ms_per_iter")(r) == pytest.approx(1e3 * 0.2 / 400)
    assert reader("cg_readback_ms_per_iter")(r) == pytest.approx(1e3 * 0.08 / 400)
    # builds count over every frame, as dispatches do
    assert reader("topology_builds_per_frame")(r) == pytest.approx(2 / 4)


def test_no_build_reads_zero():
    r = run_of([frame(10, cg_apply=(0.1, 11), cg_converged=(0.1, 11)) for _ in range(3)])
    assert reader("topology_builds_per_frame")(r) == 0.0


def test_v1_path_has_no_kernel_span():
    r = run_of([frame(10, cg_apply=(0.1, 11), cg_vector=(0.01, 20), cg_converged=(0.1, 11))])
    assert reader("apply_launch_ms")(r) is None
    assert reader("apply_host_ms")(r) == pytest.approx(1e3 * 0.1 / 11)


@pytest.mark.parametrize("name", NAMES)
def test_a_program_without_the_spans_reads_none(name):
    """The parent's frames: stages only."""
    frames = [frame(100), frame(120, profiled=True)]
    for f in frames:
        f["stage_s"]["build_system"] = 0.1
        f["entries"]["build_system"] = 1
    assert reader(name)(run_of(frames)) is None
    assert reader(name)(run_of([])) is None
