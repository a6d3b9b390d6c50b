"""The reader of the CG's fused-update span (``metrics/cg_fused_share.py``)
held to hand-made runs."""

import pytest

from _h100 import run


def reader():
    return run.load_module(run.HERE / "metrics" / "cg_fused_share.py").read


def frame(iterations, fused, dispatches=1, profiled=False):
    """A traced frame's record: ``iterations`` CG iterations, ``fused`` of
    them through the fused update."""
    entries = {"solve": dispatches, "cg.precond": iterations, "cg.vector": 2 * iterations}
    if fused:
        entries["cg.update"] = fused
    return {"iterations": iterations, "entries": entries, "profiled": profiled,
            "stage_s": {"solve": 1.0}}


def run_of(frames):
    return {"frames": frames, "timing_frames": [f for f in frames if not f["profiled"]] or frames}


def test_every_iteration_fused_reads_one():
    """Profiled frames and frames solved twice count too: the spans' entries
    do not depend on the profiler."""
    frames = [frame(337, 337, profiled=True), frame(337, 337), frame(600, 600, dispatches=2)]
    assert reader()(run_of(frames)) == 1.0


def test_share_over_all_iterations():
    frames = [frame(100, 100), frame(300, 0)]
    assert reader()(run_of(frames)) == pytest.approx(100 / 400)


def test_the_parent_reads_zero_and_no_cg_reads_none():
    """The parent's CG has ``cg.precond`` and no ``cg.update``; a run
    without CG spans (or without frames) reads nothing."""
    assert reader()(run_of([frame(337, 0), frame(337, 0)])) == 0.0
    stages = {"iterations": 0, "entries": {"solve": 1}, "profiled": False,
              "stage_s": {"solve": 1.0}}
    assert reader()(run_of([stages])) is None
    assert reader()(run_of([])) is None
