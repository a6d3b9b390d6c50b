"""Iterative refinement on the fused apply's canonical grids
(``operator.pcg_refined`` handed ``embed_tree``/``crop_tree``): a float64
solve with ``apply_impl="cuda"`` on CPU tensors (the fused apply's plain
version), against the float64 ``v1`` solve, which tests/test_torch_refined.py
holds to the JAX package.

Per pass the residual is embedded once and the correction cropped once,
the inner applies see float32 canonical grids, and an apply marked
``capturable`` runs as one graph for the whole solve: here a stand-in that
replays into one reused buffer (tests/test_torch_apply_graph.py's), since a
CUDA graph needs a card (tests/test_torch_gpu.py).  24^3 buckling and beam,
3 levels, tolerance 1e-9: at 16^3 both scenes hold FLUID faces of zero mass,
directions the system leaves all but free, along which any two solves to
1e-9 part by about 1e-6 of the largest speed (the ``v1`` refined route's
too); at 24^3 the routes agree to about 1e-11."""

import collections
import dataclasses

import pytest
import torch

from adaptiveviscositysolver_tpu_torch import operator, scenes, solver
from adaptiveviscositysolver_tpu_torch.config import SolverConfig
from tests.test_torch_apply_graph import Counting, ReusedBuffer

DT = 1.0 / 24.0
CFG = SolverConfig(octree_levels=3, tolerance=1e-9, max_iterations=4000, apply_impl="cuda",
                   use_iterative_refinement=True)
SCENES = {"buckling": scenes.buckling, "beam": scenes.beam}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _refined_solve(state, marked: bool):
    """The refined solve with its fused apply watched: the dtypes and
    shapes each inner apply sees, the calls of ``embed_tree`` and
    ``crop_tree``, and the passes (inner CGs).  ``marked``: the apply is
    marked ``capturable`` and ``ApplyGraph`` is the reused-buffer stand-in."""
    seen = collections.Counter()
    inner = []
    canon_shapes = {}
    make = solver.fused_apply.make_fused_operator
    flat_pcg = operator._flat_pcg

    def make_watched(*a, **kw):
        apply_A, embed_tree, crop_tree = make(*a, **kw)

        def apply_w(u):
            inner.append({k: (v.dtype, tuple(v.shape)) for k, v in u.items()})
            return apply_A(u)

        def embed_w(u, fill=0.0):
            seen["embed"] += 1
            out = embed_tree(u, fill)
            canon_shapes.update({k: tuple(v.shape) for k, v in out.items()})
            return out

        def crop_w(u):
            seen["crop"] += 1
            return crop_tree(u)

        apply_w.capturable, apply_w.launch_counts = marked, apply_A.launch_counts
        return apply_w, embed_w, crop_w

    def flat_pcg_counted(*a, **kw):
        seen["passes"] += 1
        return flat_pcg(*a, **kw)

    log = Counting()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(solver.fused_apply, "make_fused_operator", make_watched)
        mp.setattr(operator, "_flat_pcg", flat_pcg_counted)
        if marked:
            mp.setattr(operator, "ApplyGraph", ReusedBuffer)
        out = solver.solve_viscosity(state, DT, CFG, device="cpu", stage_times=log)
    return dict(out=out, seen=seen, inner=inner, canon_shapes=canon_shapes, n=log.entries)


@pytest.fixture(scope="module", params=sorted(SCENES))
def solves(request):
    state = SCENES[request.param](n=24, dtype=torch.float64, device="cpu")
    v1 = solver.solve_viscosity(state, DT, dataclasses.replace(
        CFG, apply_impl="v1", use_iterative_refinement=False), device="cpu")
    return dict(v1=v1, eager=_refined_solve(state, False), marked=_refined_solve(state, True))


def test_canonical_refined_reaches_the_tolerance(solves):
    st = solves["eager"]["out"].stats
    assert st.solve_path == "refined" and st.residual <= 1e-9
    assert solves["v1"].stats.solve_path == "v1"
    assert solves["eager"]["seen"]["passes"] >= 2


def test_canonical_refined_matches_float64_v1_solve(solves):
    got, want = solves["eager"]["out"].velocity, solves["v1"].velocity
    scale = max(float(v.abs().max()) for v in want)
    for a in range(3):
        diff = float((got[a] - want[a]).abs().max())
        assert diff / scale <= 1e-10, (a, diff, scale)


def test_inner_applies_see_float32_canonical_grids(solves):
    run = solves["eager"]
    want = {k: (torch.float32, s) for k, s in run["canon_shapes"].items()}
    assert run["inner"] and all(u == want for u in run["inner"])
    st = run["out"].stats
    # one apply per inner iteration and one per pass's initial residual
    assert len(run["inner"]) == st.iterations + run["seen"]["passes"]


def test_embed_and_crop_once_per_pass(solves):
    """One embed for the diagonal and one per pass's residual, one crop per
    pass's correction: none per apply (the solution stays on the logical
    grids in float64)."""
    seen = solves["eager"]["seen"]
    assert seen["embed"] == seen["passes"] + 1
    assert seen["crop"] == seen["passes"]
    assert len(solves["eager"]["inner"]) > 2 * seen["passes"]


def test_marked_apply_replays_one_graph(solves):
    """The apply marked capturable: one capture for the solve, every inner
    apply after the first replayed, through every pass; the velocity bit
    for bit the unmarked run's."""
    eager, marked = solves["eager"], solves["marked"]
    n = marked["n"]
    assert n["apply.capture"] == 1 and n["apply.replay"] == n["cg.apply"] - 1
    assert n["solve"] == 1 and marked["seen"]["passes"] >= 2
    assert "apply.capture" not in eager["n"] and "apply.replay" not in eager["n"]
    assert marked["out"].stats.iterations == eager["out"].stats.iterations
    for a in range(3):
        assert torch.equal(marked["out"].velocity[a], eager["out"].velocity[a]), a


@pytest.mark.parametrize("run", ["eager", "marked"])
def test_refine_spans_count_passes(solves, run):
    """``refine.inner`` once per pass, ``refine.residual`` once more; only
    the inner applies open ``cg.apply``, and the stats count both kinds."""
    r = solves[run]
    n, passes, st = r["n"], r["seen"]["passes"], r["out"].stats
    assert n["refine.inner"] == passes and n["refine.residual"] == passes + 1
    assert n["cg.apply"] == len(r["inner"]) == st.applies - n["refine.residual"]
