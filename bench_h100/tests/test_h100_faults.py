"""``correct`` comes out false when the timed path is broken underneath a
run (the chip's look skipped, everything else as a run does it): a solve
that hands back its input unchanged, an answer altered where it is made,
and the control (the reference, its system and CG in bfloat16, in the
program's place).  A sound run at the same size comes out true.  On a card
the sound run is made at the cell's own size."""

import dataclasses

import pytest
import torch

from _h100 import run, small_cell
import control


def _run(make_solver=None, workload="buckling-192.steady", n=16, device="cpu", seconds=0.5,
         **traffic):
    cell, config, tr = small_cell(workload, n=n, **traffic)
    return run.run_cell(cell, config, tr, 2**31 + 77, seconds, False, device,
                        make_solver=make_solver)


def _broken(change):
    from adaptiveviscositysolver_tpu_torch import make_solver

    def factory(cfg, device=None):
        solve = make_solver(cfg, device=device)

        def broken(state, dt, stage_times=None):
            return change(state, solve(state, dt, stage_times=stage_times))

        return broken

    return factory


def unchanged(state, out):
    return dataclasses.replace(out, velocity=tuple(v.clone() for v in state.velocity))


def altered(state, out):
    v = [x.clone() for x in out.velocity]
    scale = max(float(x.abs().max()) for x in v)
    i = int(v[1].abs().argmax())
    v[1].view(-1)[i] += 0.1 * scale
    return dataclasses.replace(out, velocity=tuple(v))


def test_sound_run_is_correct():
    res = _run(states=2, warmup_frames=1)
    assert res["correct"] is True, res["checks"]


@pytest.mark.parametrize("change", [unchanged, altered], ids=["state-unchanged", "answer-altered"])
def test_broken_solve_is_not_correct(change):
    res = _run(_broken(change), states=2, warmup_frames=1)
    assert res["correct"] is False
    assert res["failed"] >= 1
    assert res["checks"]["vel_rel"]["value"] > res["checks"]["vel_rel"]["limit"]


def test_control_is_not_correct():
    cell, config, _ = small_cell("buckling-192.steady")
    res = _run(control.control_solver(config), states=1, warmup_frames=0, seconds=0.0)
    assert res["attempted"] == 1
    assert res["correct"] is False
    assert res["checks"]["vel_rel"]["value"] > res["checks"]["vel_rel"]["limit"]


@pytest.mark.gpu
def test_cell_on_the_card_is_correct():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cell runs the program's kernels")
    res = _run(workload="beam-64.steady", n=64, device="cuda", seconds=2.0)
    assert res["correct"] is True, res["checks"]
