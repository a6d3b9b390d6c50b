"""The port's per-level kernels on a CUDA card (tau_level, dt_level) against
their plain versions, and a routed solve on the card against the same solve
on the CPU.

Nothing here imports JAX, so this file also runs on a machine that has a
card and no JAX; there the suite's conftest (which sets JAX up) is left out:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py

Without a card every test skips.  The inputs are the port's own
buckling-32 frame; routes are forced per level (``fused_apply.route_canons``
and ``make_fused_operator(modes=)``, or ``fused_apply.route_budget``
patched for a whole solve).  Bar: 3e-5 * max|plain| per level, brick and
output (float32, sums in another order), as in chip_smoke.py.
"""

import pytest
import torch

from adaptiveviscositysolver_tpu_torch import scenes, solver
from adaptiveviscositysolver_tpu_torch.config import SolverConfig
from adaptiveviscositysolver_tpu_torch.ops import fused_apply as fa

TOL = 3e-5
DT = 1.0 / 24.0
ROUTES = {"brick-split-fused": [("brick", 6), "split", "fused"],
          "split-brick-brick": ["split", ("brick", 4), ("brick", 2)]}


def _close(got, want, what):
    for n in want:
        scale = max(float(want[n].abs().max()), 1e-30)
        err = float((got[n] - want[n]).abs().max())
        assert err <= TOL * scale, (what, n, err, scale)


@pytest.fixture(scope="module")
def card_frame():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    state = scenes.buckling(n=32, device="cuda")
    sys_ = solver.build_system(state, DT, SolverConfig(octree_levels=3), device="cuda")
    g = torch.Generator(device="cpu").manual_seed(0)
    u_log = {k: torch.randn(m.shape, generator=g).to("cuda") * m for k, m in sys_.active.items()}
    return sys_, u_log, state.dx


def _routed(card_frame, route):
    sys_, u_log, dx = card_frame
    modes = ROUTES[route]
    canons = fa.route_canons(sys_.canons, modes)
    apply_A, _, _ = fa.make_fused_operator(sys_.frame, canons, sys_.active, sys_.res_per_level,
                                           dx, True, modes=modes)
    args = apply_A.level_args(sys_.embed_tree(u_log))
    return [(l, args[l], apply_A.metas[l], canons[l]) for l, m in enumerate(modes)
            if m != "fused"]


def _tau(meta, rows):
    return {n: torch.empty((rows[1] - rows[0],) + tuple(meta.shape[1:]), device="cuda")
            for n in fa.TAU_NAMES}


@pytest.mark.gpu
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_tau_level_matches_plain_on_card(card_frame, route):
    for l, args, meta, canon in _routed(card_frame, route):
        for rows in canon.row_ranges():
            t = fa.tau_rows(rows, meta.shape[0])
            before = fa.launch_counts["tau_level"]
            got = fa.tau_level(args, meta, True, t, _tau(meta, t))
            assert fa.launch_counts["tau_level"] == before + 1
            _close(got, fa.plain_tau_level(args, meta, True, t, _tau(meta, t)), (route, l, t))


@pytest.mark.gpu
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_dt_level_matches_plain_on_card(card_frame, route):
    for l, args, meta, canon in _routed(card_frame, route):
        got, want = fa.dt_outputs(meta, "cuda"), fa.dt_outputs(meta, "cuda")
        for rows in canon.row_ranges():
            t = fa.tau_rows(rows, meta.shape[0])
            tau = fa.plain_tau_level(args, meta, True, t, _tau(meta, t))
            fa.dt_level(args, tau, t[0], meta, True, rows, got)
            fa.plain_dt_level(args, tau, t[0], meta, True, rows, want)
        _close(got, want, (route, l))


@pytest.mark.gpu
def test_routed_solve_on_card_matches_cpu(monkeypatch):
    """A buckling-32 solve whose budget bricks level 0 and splits level 1,
    on the card (the level kernels launched), against the solve on the CPU
    (every level fused, the plain versions): iterations within +-2,
    velocity within rel 5e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    state = scenes.buckling(n=32, device="cpu")
    cfg = SolverConfig(octree_levels=3, tolerance=1e-5, apply_impl="cuda")
    canons = solver.build_system(state, DT, cfg, device="cpu").canons
    budget = fa.tau_bytes(canons[1])
    modes = fa.level_modes(canons, budget)
    assert modes[0][0] == "brick" and modes[1] == "split", modes
    monkeypatch.setattr(fa, "route_budget", lambda device: budget)
    fa.reset_launch_counts()
    got = solver.solve_viscosity(state, DT, cfg, device="cuda")
    ranges = len(fa.route_canons(canons, modes)[0].row_ranges()) + 1
    assert fa.launch_counts["tau_level"] == fa.launch_counts["dt_level"] == \
        got.stats.applies * ranges
    monkeypatch.undo()
    want = solver.solve_viscosity(state, DT, cfg, device="cpu")
    assert got.stats.solve_path == "cuda" and want.stats.solve_path == "cuda-plain"
    assert abs(got.stats.iterations - want.stats.iterations) <= 2
    scale = max(float(v.abs().max()) for v in want.velocity)
    for a in range(3):
        assert float((got.velocity[a].cpu() - want.velocity[a]).abs().max()) / scale < 5e-4
