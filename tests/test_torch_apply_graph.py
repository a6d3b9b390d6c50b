"""The CG's graphed apply (``operator.ApplyGraph``) on the CPU: which
operators are marked ``capturable``, and the contract that lets a replay
return one reused output vector: no caller of ``pcg_flat``'s apply keeps
its result across the next apply.  A CUDA graph needs a card, so here a
stand-in replays the apply by writing its result into one reused output
buffer, as a replay does (the card's tests are in test_torch_gpu.py).
16^3 beam, ``cuda-plain`` (the fused apply's plain version), and its
refined float64 solve, whose inner CGs replay one graph."""

import collections
import dataclasses
import types

import pytest
import torch

from adaptiveviscositysolver_tpu_torch import operator, scenes, solver
from adaptiveviscositysolver_tpu_torch.config import SolverConfig
from adaptiveviscositysolver_tpu_torch.ops import fused_apply as fa
from adaptiveviscositysolver_tpu_torch.utils import trace

GRAPH_SPANS = ("apply.capture", "apply.replay")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class Counting(dict):
    """A ``stage_times`` dict that counts its writes, as the benchmark's."""

    def __init__(self):
        super().__init__()
        self.entries = collections.Counter()

    def __setitem__(self, key, value):
        self.entries[key] += 1
        super().__setitem__(key, value)


class ReusedBuffer(operator.ApplyGraph):
    """ApplyGraph with the CUDA capture replaced: the "replay" runs the
    apply on the static input and writes its result into one output
    buffer, which every replay returns."""

    def _capture(self, flat):
        self.static_in = torch.empty_like(flat)
        self.static_out = torch.empty_like(flat)
        fn, si, so = self.fn, self.static_in, self.static_out
        self.graph = types.SimpleNamespace(replay=lambda: so.copy_(fn(si)))


def _cfg(**kw):
    return SolverConfig(octree_levels=3, tolerance=1e-5, max_iterations=400,
                        dtype=torch.float32, apply_impl="cuda", **kw)


@pytest.fixture(scope="module")
def beam16_system():
    state = scenes.beam(n=16, device="cpu")
    return state, solver.build_system(state, 0.02, _cfg(), device="cpu")


def _solve(sys_, apply_A, cheb):
    return operator.pcg_flat(apply_A, sys_.embed_tree(sys_.rhs), sys_.embed_tree(sys_.guess),
                             sys_.embed_tree(sys_.diag, fill=1.0), 1e-5, 400, cheb_degree=cheb)


@pytest.mark.parametrize("cheb", [1, 3], ids=["jacobi", "cheb3"])
def test_reused_apply_output_changes_no_solve(beam16_system, monkeypatch, cheb):
    """pcg_flat over an apply whose every result after the first is one
    reused buffer (a replay's static output) gives the same x, iterations
    and applies as over the same apply returning fresh vectors: the CG,
    the Chebyshev preconditioner and the lam_max estimate (degree 3) use
    each result before the next apply.  The replays did run: one capture,
    every apply after the first replayed."""
    _, sys_ = beam16_system
    assert not sys_.apply_A.capturable
    x_f, it_f, rel_f, applies_f = _solve(sys_, sys_.apply_A, cheb)

    def marked(u):
        return sys_.apply_A(u)

    marked.capturable, marked.launch_counts = True, {}
    monkeypatch.setattr(operator, "ApplyGraph", ReusedBuffer)
    log = Counting()
    with trace.tracing(log, "cpu"):
        x_r, it_r, rel_r, applies_r = _solve(sys_, marked, cheb)
    assert (it_r, applies_r) == (it_f, applies_f)
    assert applies_f == (1 + it_f if cheb == 1 else 13 + 1 + 2 + 3 * it_f)
    assert torch.equal(rel_r, rel_f)
    for k in x_f:
        assert torch.equal(x_r[k], x_f[k]), k
    n = log.entries
    assert n["cg.apply"] == applies_r
    assert n["apply.capture"] == 1 and n["apply.replay"] == applies_r - 1


def test_only_the_card_kernels_are_marked_capturable(beam16_system):
    """The fused apply on CPU tensors, and its plain version, are not
    marked; the whole-array v1 operator carries no mark."""
    state, sys_ = beam16_system
    assert sys_.apply_A.capturable is False and sys_.apply_A.launch_counts is fa.launch_counts
    plain, _, _ = fa.make_fused_operator(sys_.frame, sys_.canons, sys_.active,
                                         sys_.res_per_level, state.dx, True, plain=True,
                                         modes=sys_.modes)
    assert plain.capturable is False
    v1 = solver.build_system(state, 0.02, dataclasses.replace(_cfg(), apply_impl="v1",
                                                             dtype=None), device="cpu")
    assert not getattr(v1.apply_A, "capturable", False)


def test_refined_inner_replays_one_graph(monkeypatch):
    """Iterative refinement runs its float32 inner CGs on the canonical
    grids through the fused apply: an operator marked capturable, as on
    the card, is captured once for the solve and replayed by every inner
    apply after the first, through every pass; the float64 residuals
    (``refine.residual``) stay eager and open no ``cg.apply``."""
    make = fa.make_fused_operator

    def marked(*a, **kw):
        apply_A, embed_tree, crop_tree = make(*a, **kw)
        apply_A.capturable = True
        return apply_A, embed_tree, crop_tree

    monkeypatch.setattr(solver.fused_apply, "make_fused_operator", marked)
    monkeypatch.setattr(operator, "ApplyGraph", ReusedBuffer)
    state = scenes.beam(n=16, dtype=torch.float64, device="cpu")
    log = Counting()
    out = solver.solve_viscosity(state, 0.02, SolverConfig(
        octree_levels=3, tolerance=1e-9, apply_impl="cuda", use_iterative_refinement=True),
        device="cpu", stage_times=log)
    assert out.stats.solve_path == "refined" and out.stats.residual <= 1e-9
    n = log.entries
    assert n["refine.inner"] >= 2 and n["refine.residual"] == n["refine.inner"] + 1
    assert n["cg.apply"] + n["refine.residual"] == out.stats.applies
    assert n["apply.capture"] == 1 and n["apply.replay"] == n["cg.apply"] - 1
