"""The port's make_solver host policy (solver.py) against the JAX package's.

* The host window functions and the probe decode equal the JAX functions
  on windows and packed probes made from a numpy seed; ``effective_levels``
  equals JAX's on the beam and buckling scenes.
* The intent of tests/test_recompile.py (a translating fluid keeps at most
  3 cached topologies; a draining fluid re-tightens its windows), of
  test_solver.py's async == sync test (n = 16, across a topology change)
  and of test_padding.py's off-multiple probe (n = 18), run on the port on
  the CPU.  The draining test holds the port to the intended shrink policy,
  which the JAX make_solver misses (ROADMAP C1).  The async/sync and
  padding tests also run the fused apply's plain version ("cuda-plain"), so
  the cached boxes and routes are exercised.
* Frames of the same topology through one cached entry equal fresh builds
  exactly, pads included.
"""

import dataclasses

import numpy as np
import pytest
import torch

from adaptiveviscositysolver_tpu import scenes as jscenes
from adaptiveviscositysolver_tpu import solver as jsolver
from adaptiveviscositysolver_tpu.config import SolverConfig as JConfig
from adaptiveviscositysolver_tpu_torch import convert, scenes, solver
from adaptiveviscositysolver_tpu_torch.config import SolverConfig
from adaptiveviscositysolver_tpu_torch.ops import fused_apply as fa
from tests.test_torch_stages import N, port_test_env  # noqa: F401


def _random_windows(rng, res_per_level):
    out = []
    for res in res_per_level:
        rows = []
        for r in res:
            lo = int(rng.integers(0, max(1, r - 2))) // 2 * 2
            rows.append((lo, int(rng.integers(lo + 1, r + 1))))
        out.append(tuple(rows))
    return tuple(out)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_window_functions_match_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(20):
        base = tuple(int(v) for v in rng.integers(2, 9, size=3) * 16)
        levels = int(rng.integers(1, 4))
        res_per_level = [tuple(s >> l for s in base) for l in range(levels)]
        raw = rng.integers(-1, 70, size=(levels, 3, 2))
        tight = solver._tight_windows(raw.tolist(), res_per_level)
        assert tight == jsolver._tight_windows(raw, res_per_level)
        cached = _random_windows(rng, res_per_level)
        assert solver._merge_windows(cached, tight, res_per_level) == \
            jsolver._merge_windows(cached, tight, res_per_level)
        assert solver._merge_windows(None, tight, res_per_level) == tight
        assert solver._shrink_target(tight, res_per_level) == \
            jsolver._shrink_target(tight, res_per_level)
        for w in (tight, cached):
            assert solver._windows_volume(w) == jsolver._windows_volume(w)
    assert (solver.WINDOW_QUANTUM, solver.SHRINK_AFTER, solver.SHRINK_RATIO) == \
        (jsolver.WINDOW_QUANTUM, jsolver.SHRINK_AFTER, jsolver.SHRINK_RATIO)


@pytest.mark.parametrize("shape,full", [((64, 64, 64), 4), ((18, 20, 24), 3), ((32, 16, 48), 2)])
def test_decode_topology_probe_matches_jax(shape, full):
    rng = np.random.default_rng(sum(shape))
    for trailing in range(full):
        counts = rng.integers(1, 500, size=full)
        counts[full - trailing:] = 0
        boxes = rng.integers(0, min(shape), size=(full, 3, 2))
        head = [float(rng.integers(1, 300)), float(np.float32(rng.random())),
                float(rng.integers(1, 10 ** 6)), float(rng.integers(1, 10 ** 6))]
        packed = np.concatenate([head, counts, boxes.reshape(-1)]).astype(np.float32)
        got = solver.decode_topology_probe(packed.tolist(), shape, full)
        want = jsolver.decode_topology_probe(packed, shape, full)
        assert got[1:] == want[1:]
        assert got[0] == {k: v.item() for k, v in want[0].items()}


@pytest.mark.parametrize("scene", ["beam", "buckling"])
def test_effective_levels_matches_jax(scene):
    state = getattr(scenes, scene)(n=16, device="cpu")
    jstate = getattr(jscenes, scene)(n=16)
    for levels in (2, 3, 4):
        got = solver.effective_levels(state, SolverConfig(octree_levels=levels), device="cpu")
        assert got == jsolver.effective_levels(jstate, JConfig(octree_levels=levels))


def _ball_state(n, center_y, r=0.17):
    """tests/test_recompile.py's ball, on the port."""
    dx = 1.0 / n
    x = (np.arange(n) + 0.5) * dx
    X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
    liquid = np.sqrt((X - 0.5) ** 2 + (Y - center_y) ** 2 + (Z - 0.5) ** 2) - r
    fshapes = [tuple(n + (1 if d == a else 0) for d in range(3)) for a in range(3)]
    vel = [np.zeros(s) for s in fshapes]
    vel[1] = -0.5 * np.ones(fshapes[1])
    return convert.fluid_state_from_numpy(
        liquid, np.full_like(liquid, 1e3), vel, [np.zeros(s) for s in fshapes],
        np.full(liquid.shape, 2.0), np.ones(liquid.shape), dx, device="cpu",
        dtype=torch.float32)


def test_translating_fluid_keeps_at_most_three_topologies():
    cfg = SolverConfig(octree_levels=3, tolerance=1e-3, max_iterations=5)
    solve = solver.make_solver(cfg, async_probe=False, device="cpu")
    for i in range(7):
        out = solve(_ball_state(64, 0.30 + 0.06 * i), 0.01)
        assert out.stats.octree_dofs > 0, i
        if i == 0:
            assert solve.cache_info()["programs"] == 1
    info = solve.cache_info()
    assert info["programs"] <= 3, info


def test_draining_fluid_retightens_windows():
    """C1's intended policy: after SHRINK_AFTER frames whose cached windows
    sweep over SHRINK_RATIO x the tight windows' volume, re-tighten."""
    cfg = SolverConfig(octree_levels=3, tolerance=1e-3, max_iterations=3)
    solve = solver.make_solver(cfg, async_probe=False, device="cpu")
    solve(_ball_state(64, 0.5, r=0.30), 0.01)
    info = solve.cache_info()
    (lv,) = info["windows"].keys()
    vol_big = solver._windows_volume(info["windows"][lv])
    seen = []
    for _ in range(solver.SHRINK_AFTER + 2):
        assert solve(_ball_state(64, 0.5, r=0.15), 0.01).stats.octree_dofs > 0
        info = solve.cache_info()
        assert lv in info["windows"], info["windows"].keys()
        seen.append(solver._windows_volume(info["windows"][lv]))
    assert seen[0] == vol_big, "hysteresis must hold the window at first"
    assert seen[-1] < 0.7 * vol_big, (seen, vol_big)
    assert solve.cache_info()["programs"] <= solver.MAX_PROGRAMS


@pytest.mark.parametrize("impl", ["auto", "cuda"])
def test_async_probe_solver_matches_sync(impl):
    cfg = SolverConfig(octree_levels=3, tolerance=1e-6, max_iterations=200,
                       dtype=torch.float32, apply_impl=impl)
    frames = [scenes.beam(n=16, device="cpu"), scenes.buckling(n=16, device="cpu"),
              scenes.buckling(n=16, device="cpu")]
    sync = solver.make_solver(cfg, async_probe=False, device="cpu")
    asyn = solver.make_solver(cfg, async_probe=True, device="cpu")
    for i, state in enumerate(frames):
        want = sync(state, 0.01)
        stages = {}
        got = asyn(state, 0.01, stage_times=stages)
        assert ("probe" in stages) == (i == 0), (i, sorted(stages))
        assert got.stats.solve_path == want.stats.solve_path == \
            ("cuda-plain" if impl == "cuda" else "v1")
        assert got.stats.iterations == want.stats.iterations, i
        assert abs(got.stats.residual - want.stats.residual) <= 1e-5 * max(want.stats.residual,
                                                                          1e-30)
        assert got.stats.octree_dofs == want.stats.octree_dofs, i
        for a in range(3):
            np.testing.assert_allclose(N(got.velocity[a]), N(want.velocity[a]), rtol=0,
                                       atol=1e-6, err_msg=f"frame {i} axis {a}")
    assert asyn.cache_info()["programs"] == sync.cache_info()["programs"] == 2


@pytest.mark.parametrize("impl", ["auto", "cuda"])
def test_make_solver_autopad_probe(impl):
    cfg = SolverConfig(octree_levels=3, tolerance=1e-5, max_iterations=100,
                       dtype=torch.float32, apply_impl=impl)
    state = scenes.beam(n=18, device="cpu")
    solve = solver.make_solver(cfg, device="cpu")
    out = solve(state, 0.01)
    assert tuple(out.velocity[0].shape) == (19, 18, 18)
    assert out.stats.octree_dofs > 0
    again = solve(state, 0.01)
    assert solve.cache_info()["programs"] == 1
    assert again.stats.iterations == out.stats.iterations


def _second_frame(state):
    """Other data, same topology: viscosity, density and velocity change,
    the SDFs do not."""
    return dataclasses.replace(state, viscosity=1.7 * state.viscosity,
                               density=1.3 * state.density,
                               velocity=tuple(-0.6 * v for v in state.velocity))


def test_cached_topology_builds_equal_fresh_builds(monkeypatch):
    """Two frames of one topology through one Topology (level 0 bricked,
    level 1 split, level 2 fused, so every buffer is shared) apply exactly
    as two fresh builds, every element of every box, pads included; and the
    first frame's operator still does after the second was applied."""
    cfg = SolverConfig(octree_levels=3, apply_impl="cuda")
    first = scenes.buckling(n=24, device="cpu")
    frames = [first, _second_frame(first)]
    canons = solver.build_system(first, 0.02, cfg, device="cpu").canons
    monkeypatch.setattr(fa, "route_budget", lambda device: fa.tau_bytes(canons[1]))
    topo = solver.Topology()
    cached = [solver.build_system(s, 0.02, cfg, device="cpu", topology=topo) for s in frames]
    assert topo.modes[0][0] == "brick" and topo.modes[1:] == ["split", "fused"], topo.modes
    assert all(s.canons is topo.canons for s in cached)
    g = torch.Generator().manual_seed(7)
    u = cached[0].embed_tree({k: torch.randn(m.shape, generator=g) * m
                              for k, m in cached[0].active.items()})
    got = [{k: v.clone() for k, v in s.apply_A(u).items()} for s in cached]
    for s, g_out in zip(frames, got):
        fresh = solver.build_system(s, 0.02, cfg, device="cpu")
        assert fresh.modes == topo.modes and fresh.canons == topo.canons
        want = fresh.apply_A(u)
        for k in want:
            assert torch.equal(g_out[k], want[k]), k
    again = cached[0].apply_A(u)
    for k in again:
        assert torch.equal(again[k], got[0][k]), k
    with pytest.raises(ValueError):
        solver.build_system(first, 0.02, cfg, device="cpu", topology=topo,
                            bboxes=(((0, 8), (0, 8), (0, 8)),) * 3)


def test_make_solver_reuses_one_entry_for_one_topology():
    cfg = SolverConfig(octree_levels=3, tolerance=1e-5, apply_impl="cuda")
    first = scenes.buckling(n=16, device="cpu")
    frames = [first, _second_frame(first)]
    solve = solver.make_solver(cfg, device="cpu")
    got = [solve(s, 0.02) for s in frames]
    assert solve.cache_info()["programs"] == 1
    for res, s in zip(got, frames):
        want = solver.make_solver(cfg, device="cpu")(s, 0.02)
        assert res.stats.iterations == want.stats.iterations
        assert res.stats.topology_probe == want.stats.topology_probe
        for a in range(3):
            assert torch.equal(res.velocity[a], want.velocity[a]), a


class _Frame:
    """A stand-in state for the host policy alone: its shape and dx."""

    def __init__(self, n):
        self.liquid_sdf = torch.empty((n, n, n), device="meta")
        self.dx = 1.0 / n


def _policy(monkeypatch, tights, n=256, async_probe=False):
    """Run make_solver's window policy over probe results ``tights`` (one
    (levels, windows) per frame) with the solve stubbed out: the windows
    each frame was dispatched with, and the solver."""
    probes = iter(tights)
    used = []
    monkeypatch.setattr(solver, "probe_topology", lambda state, config, device: next(probes))
    monkeypatch.setattr(solver, "solve_viscosity",
                        lambda state, dt, cfg, **kw: used.append(kw["bboxes"]))
    solve = solver.make_solver(SolverConfig(octree_levels=1), async_probe=async_probe,
                               device="cpu")
    for _ in tights:
        solve(_Frame(n), 0.01)
    return used, solve


@pytest.mark.parametrize("small,want", [
    # a small fluid in a large window: the quantum-grown target shrinks by
    # SHRINK_RATIO, so the window re-tightens onto the shared 16-cell grid
    (((96, 112), (96, 112), (96, 112)), ((80, 128), (80, 128), (80, 128))),
    # C1's case: the grown target is no such shrink, so the tight window
    (((40, 104), (40, 104), (40, 104)), ((40, 104), (40, 104), (40, 104))),
])
def test_shrink_retightens_after_shrink_after_frames(monkeypatch, small, want):
    big = ((0, 128), (0, 128), (0, 128))
    tights = [(1, (big,))] + [(1, (small,))] * (solver.SHRINK_AFTER + 1)
    used, solve = _policy(monkeypatch, tights)
    assert [u[0] for u in used[:solver.SHRINK_AFTER]] == [big] * solver.SHRINK_AFTER
    assert used[solver.SHRINK_AFTER] == (want,)
    assert used[-1] == (want,)
    assert solve.cache_info()["programs"] == 2


def test_lru_caps_cached_topologies(monkeypatch):
    """A window that grows every frame makes a new topology every frame;
    the cache keeps the MAX_PROGRAMS most recent."""
    tights = [(1, (((0, 16), (0, 16), (0, 32 * (i + 1))),)) for i in range(solver.MAX_PROGRAMS + 2)]
    used, solve = _policy(monkeypatch, tights, n=512)
    assert len(set(used)) == len(tights)
    assert solve.cache_info()["programs"] == solver.MAX_PROGRAMS


def test_make_solver_without_trim_solves_every_level():
    cfg = SolverConfig(octree_levels=3, tolerance=1e-5, apply_impl="cuda")
    state = scenes.buckling(n=16, device="cpu")
    solve = solver.make_solver(cfg, auto_trim_levels=False, device="cpu")
    got = [solve(state, 0.02) for _ in range(2)]
    want = solver.solve_viscosity(state, 0.02, cfg, device="cpu")
    assert solve.cache_info() == {"programs": 1, "windows": {}}
    for res in got:
        assert res.stats.active_cells == want.stats.active_cells and len(res.stats.active_cells) == 3
        assert res.stats.topology_probe is None
        for a in range(3):
            assert torch.equal(res.velocity[a], want.velocity[a]), a
