"""Multi-device scale-out of the viscosity solve over ``torch.distributed``
(port of ``parallel/mesh.py``).

A :class:`Mesh` is one rank's view of an initialised 1-D process group:
the ranks split every level's x axis into slabs (``shard_fused``).  The
JAX package shards the whole frame under GSPMD; PyTorch has no
partitioner, so here every rank runs the pre-CG stages (octree, labels,
stencils, rhs) on the whole grid, and only the CG, the hot loop, is
distributed (``solver.solve_viscosity(mesh=)``): the numbers are the same.

Ranks are processes.  :func:`launch` spawns ``n`` of them around a
function of this package, each in a gloo group rendezvousing through a
file, and bounds them with a time limit.  Several ranks may share one card
(gloo, host-staged transfers); with one card per rank an NCCL group works
the same way (unverified: no such machine has run it).
"""

from __future__ import annotations

import collections
import dataclasses
import datetime
import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..config import SolverConfig
from ..solver import FluidState, SolveResult, solve_viscosity
from . import shard_fused


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of the default process group, a 1-D mesh: its rank
    and size, the axis name, the rank's device, the group's backend, and
    ``budget``: the route budget of the rank's local boxes in bytes (None:
    the card's ``fused_apply.route_budget``; a number forces routes, as
    patching ``route_budget`` does in one process)."""

    rank: int
    size: int
    axis_name: str
    device: torch.device
    backend: str
    budget: Optional[float] = None

    @property
    def staged(self) -> bool:
        """Transfers go through host memory: gloo takes no CUDA tensors
        for send/recv."""
        return self.backend == "gloo" and self.device.type == "cuda"


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "x", device="cuda") -> Mesh:
    """This rank's mesh over the initialised default group, which must have
    ``n_devices`` ranks if given.  ``device="cuda"`` takes card ``rank %
    cards``: several ranks share a card when there are fewer cards than
    ranks."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised torch.distributed process group "
                           "(see launch)")
    n = dist.get_world_size()
    if n_devices is not None and n_devices != n:
        raise ValueError(f"a mesh spans the whole group: {n} ranks, not {n_devices}")
    rank = dist.get_rank()
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)   # NCCL's collectives run on the current card
    return Mesh(rank, n, axis_name, device, dist.get_backend())


def state_sharding(mesh: Mesh, shape: Sequence[int]) -> List[Tuple[int, int]]:
    """The cell rows ``[lo, hi)`` each rank holds of a state of cell shape
    ``shape`` (equal x-slabs; a rank's x-face slab also holds its ghost
    row ``hi``)."""
    nx = int(shape[0])
    if nx % mesh.size:
        raise ValueError(f"{nx} x cells do not split into {mesh.size} equal slabs")
    w = nx // mesh.size
    return [(r * w, r * w + w) for r in range(mesh.size)]


def shard_state(state: FluidState, mesh: Mesh) -> FluidState:
    """This rank's x-slab of ``state`` on its device: cell grids and y/z
    faces rows ``[lo, hi)``, x faces ``[lo, hi]`` (ghost-blocked)."""
    lo, hi = state_sharding(mesh, state.liquid_sdf.shape)[mesh.rank]

    def cells(x):
        return x[lo:hi].to(mesh.device)

    def faces(v):
        return tuple(x[lo:hi + (a == 0)].to(mesh.device) for a, x in enumerate(v))

    return FluidState(cells(state.liquid_sdf), cells(state.solid_sdf), faces(state.velocity),
                      faces(state.solid_velocity), cells(state.viscosity), cells(state.density),
                      state.dx)


def gather_state(slab: FluidState, mesh: Mesh) -> FluidState:
    """The whole state from every rank's :func:`shard_state` slab, on every
    rank (one all-gather)."""
    cells = [slab.liquid_sdf, slab.solid_sdf, slab.viscosity, slab.density]
    faces = list(slab.velocity) + list(slab.solid_velocity)
    every = shard_fused.all_gather_rows(mesh, [t.to(mesh.device) for t in cells + faces])
    whole = []
    for i in range(len(cells) + len(faces)):
        parts = [every[r][i] for r in range(mesh.size)]
        if i >= len(cells) and (i - len(cells)) % 3 == 0:    # x faces: drop inner ghosts
            parts = [p[:-1] for p in parts[:-1]] + parts[-1:]
        whole.append(torch.cat(parts))
    liquid, solid, visc, dens = whole[:4]
    return FluidState(liquid, solid, tuple(whole[4:7]), tuple(whole[7:10]), visc, dens, slab.dx)


def make_sharded_solver(mesh: Mesh, config: SolverConfig = SolverConfig()):
    """``solve(slab, dt, stage_times=None) -> SolveResult``, called by every
    rank of ``mesh`` together on its :func:`shard_state` slab: the slabs are
    all-gathered, the pre-CG stages run on the whole grid on every rank,
    the CG runs sharded (``apply_impl`` "cuda"/"auto" in float32, else each
    rank runs the single-device solve of its option), and every rank
    returns the whole velocity and the global stats."""

    def solve(slab: FluidState, dt, stage_times=None) -> SolveResult:
        state = gather_state(slab, mesh)
        return solve_viscosity(state, dt, config, mesh=mesh, mesh_axis=mesh.axis_name,
                               stage_times=stage_times)

    return solve


# ---------------------------------------------------------------------------
# ranks as processes
# ---------------------------------------------------------------------------


def _rank_main(rank: int, n: int, init_file: str, fn, args, device: str, backend: str,
               timeout: float, results) -> None:
    """One rank: join the group through ``init_file``, run ``fn(mesh,
    *args)`` and put its result (or the traceback) on ``results``."""
    try:
        torch.set_num_threads(1)
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")   # the ranks share one host
        dist.init_process_group(backend, init_method=f"file://{init_file}", rank=rank,
                                world_size=n, timeout=datetime.timedelta(seconds=timeout))
        try:
            out = fn(make_mesh(device=device), *args)
        finally:
            dist.destroy_process_group()
        results.put(("ok", rank, out))
    except Exception:   # reported to the parent, which stops the other ranks
        results.put(("error", rank, traceback.format_exc()))


def launch(n: int, fn: Callable, *args, timeout: float = 120.0, device="cuda",
           backend: str = "gloo", init_file: Optional[str] = None) -> list:
    """Run ``fn(mesh, *args)`` on ``n`` spawned ranks of a new group and
    return their results by rank.  ``fn`` is a function of this package
    (the ranks import it, nothing else of the caller's).  The whole launch
    is bounded by ``timeout`` seconds, which is also the group's timeout: on
    an overrun, a rank's failure or a rank's death every rank is stopped
    and the call raises.  ``init_file``: the rendezvous file (default: one
    in a new temporary directory)."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    tmp = None
    if init_file is None:
        tmp = tempfile.mkdtemp(prefix="avs_ranks_")
        init_file = os.path.join(tmp, "rendezvous")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, n, init_file, fn, args, str(device), backend, timeout,
                               results)) for r in range(n)]
    deadline = time.monotonic() + timeout
    out: List[object] = [None] * n
    try:
        for p in procs:
            p.start()
        pending = set(range(n))
        while pending:
            if time.monotonic() > deadline:
                raise TimeoutError(f"{len(pending)} of {n} ranks of {fn.__name__} did not "
                                   f"finish in {timeout} s")
            try:
                kind, rank, payload = results.get(timeout=0.5)
            except queue.Empty:
                dead = [r for r in pending if procs[r].exitcode is not None]
                if dead:
                    time.sleep(1.0)    # a result may still be in the pipe
                    if results.empty():
                        raise RuntimeError(f"rank {dead[0]} of {fn.__name__} died with exit "
                                           f"code {procs[dead[0]].exitcode}")
                continue
            if kind == "error":
                raise RuntimeError(f"rank {rank} of {fn.__name__} failed:\n{payload}")
            out[rank] = payload
            pending.discard(rank)
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            if p.pid is not None:
                p.join(5.0)
                if p.is_alive():
                    p.kill()
                    p.join()
        results.close()
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# rank bodies
# ---------------------------------------------------------------------------


def barrier_on_ranks(mesh: Mesh, seconds: float = 0.0) -> int:
    """Rank body that waits ``seconds``, then meets the other ranks at a
    barrier: a group's smallest round trip (and, with a wait past the
    launch's limit, its overrun)."""
    time.sleep(seconds)
    dist.barrier()
    return mesh.rank


def _state_on(spec, device) -> FluidState:
    """A state from ``("buckling" | "beam", n)`` (built on the rank) or a
    dict of numpy arrays (``convert.fluid_state_from_numpy``'s
    arguments)."""
    from .. import convert, scenes

    if isinstance(spec, tuple):
        return getattr(scenes, spec[0])(n=spec[1], device=device)
    return convert.fluid_state_from_numpy(**spec, device=device)


class _CountingSink(dict):
    """A ``stage_times`` dict that also counts its writes: one per interval
    (``utils/trace.py``)."""

    def __init__(self):
        super().__init__()
        self.entries = collections.Counter()

    def __setitem__(self, key, value):
        self.entries[key] += 1
        super().__setitem__(key, value)


def _velocity_np(res: SolveResult) -> List[np.ndarray]:
    return [v.detach().cpu().numpy() for v in res.velocity]


def solve_on_ranks(mesh: Mesh, state, dt, configs: Sequence[SolverConfig], frames: int = 1,
                   slab_garbage: bool = False, budgets: Optional[Sequence] = None
                   ) -> List[dict]:
    """Rank body of sharded solves (tests, ``chip_smoke.py``,
    :func:`dryrun_multichip`): the rank's slab of ``state`` (see
    :func:`_state_on`) through a :func:`make_sharded_solver` of each of
    ``configs`` (under ``budgets[i]`` if given: see :class:`Mesh`),
    ``frames`` times; per config the last frame's stats, velocity (rank 0),
    the rank's routes and x-row ranges, launch and collective counts with
    their seconds, the entries of each stage and span (``spans``: every
    frame runs with a ``stage_times`` sink, so its stages synchronize the
    device), and each frame's seconds.  ``slab_garbage``: then
    ``configs[0]`` once more, from a slab with 1e30 in its x faces' ghost
    rows (the owner's values must win)."""
    from ..config import capped_levels
    from ..ops import fused_apply as fa
    from ..solver import padded_shape

    slab = shard_state(_state_on(state, mesh.device), mesh)
    budgets = [mesh.budget] * len(configs) if budgets is None else list(budgets)
    runs = [(c, b, slab, frames) for c, b in zip(configs, budgets)]
    if slab_garbage:
        bad = dataclasses.replace(slab, velocity=tuple(v.clone() for v in slab.velocity),
                                  solid_velocity=tuple(v.clone() for v in slab.solid_velocity))
        if mesh.rank != mesh.size - 1:
            bad.velocity[0][-1] = bad.solid_velocity[0][-1] = 1e30
        runs.append((configs[0], budgets[0], bad, 1))
    shape = (slab.liquid_sdf.shape[0] * mesh.size,) + tuple(slab.liquid_sdf.shape[1:])
    out = []
    for config, budget, sl, n_frames in runs:
        m = dataclasses.replace(mesh, budget=budget)
        solve = make_sharded_solver(m, config)
        seconds = []
        for _ in range(n_frames):
            fa.reset_launch_counts()
            shard_fused.reset_collective_counts()
            if mesh.device.type == "cuda":
                torch.cuda.synchronize(mesh.device)
            sink = _CountingSink()
            t0 = time.perf_counter()
            res = solve(sl, dt, stage_times=sink)
            for v in res.velocity:
                v.sum().item()
            seconds.append(time.perf_counter() - t0)
        levels = capped_levels(shape, config.octree_levels)
        pshape = padded_shape(shape, levels, mesh.size)
        canons, modes = shard_fused.local_routes(
            [tuple(s >> l for s in pshape) for l in range(levels)], m)
        out.append({"rank": mesh.rank, "stats": dataclasses.asdict(res.stats),
                    "velocity": _velocity_np(res) if mesh.rank == 0 else None,
                    "modes": [str(x) for x in modes],
                    "row_ranges": sum(len(c.row_ranges()) for c, x in zip(canons, modes)
                                      if x != "fused"),
                    "fused": "fused" in modes,
                    "launches": dict(fa.launch_counts),
                    "collectives": dict(shard_fused.collective_counts),
                    "collective_seconds": dict(shard_fused.collective_seconds),
                    "spans": dict(sink.entries), "seconds": seconds,
                    "device": str(mesh.device)})
    return out


def random_faces(active, seed: int):
    """Random float32 face grids from ``seed`` (numpy's generator, so every
    rank and the caller draw the same), zero off the FLUID faces."""
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(rng.standard_normal(tuple(m.shape)).astype(np.float32)
                                ).to(m.device) * m for k, m in sorted(active.items())}


def apply_on_ranks(mesh: Mesh, state, dt, config: SolverConfig, seed: int = 0,
                   ghost_garbage: bool = False, local_args: bool = False) -> dict:
    """Rank body of one sharded apply (tests): the whole system of
    ``state`` (see :func:`_state_on`) built on every rank, then
    ``shard_fused.sharded_operator``'s apply of :func:`random_faces`
    (``seed``) on this rank's local boxes, gathered: the global result
    (rank 0), the routes, launch and collective counts of the frame and
    the apply, and whether the apply is marked ``capturable`` (the
    sharded CG runs it eagerly: no graph captures a collective).
    ``ghost_garbage``: apply again with 1e30 in the x faces' ghost rows of
    the input (the apply refreshes them from the owner).  ``local_args``:
    also the rank's kernel inputs of that apply on its halo-filled local
    boxes (numpy: a tensor on the queue would need its rank alive), its
    routed boxes and routes (``chip_smoke.py``
    holds each kernel to its plain version there)."""
    from ..ops import fused_apply as fa
    from ..solver import build_system

    st = _state_on(state, mesh.device)
    sys_ = build_system(st, dt, dataclasses.replace(config, apply_impl="cuda"),
                        device=mesh.device, mesh_n=mesh.size)
    we, wc = shard_fused.stress_weights(sys_.blocks, sys_.levels)
    fa.reset_launch_counts()
    shard_fused.reset_collective_counts()
    apply_A, embed_tree, gather_tree = shard_fused.sharded_operator(
        mesh, sys_.vel_kinds, sys_.edge_kinds, sys_.center_kinds, we, wc, sys_.mass,
        sys_.active, sys_.res_per_level, st.dx, config.use_enhanced_gradients)
    u = embed_tree(random_faces(sys_.active, seed))
    out = gather_tree(apply_A(u))
    launches, collectives = dict(fa.launch_counts), dict(shard_fused.collective_counts)
    garbage = None
    if ghost_garbage:
        if mesh.rank != mesh.size - 1:
            for (l, f), v in u.items():
                if f == 0:   # the ghost row: the right neighbour's first face
                    v[apply_A.canons[l].off[0] + sys_.res_per_level[l][0] // mesh.size] = 1e30
        garbage = gather_tree(apply_A(u))

    local = None
    if local_args:
        local = {"args": [{k: v.cpu().numpy() for k, v in a.items()}
                          for a in apply_A.level_args(u)],
                 "canons": apply_A.canons, "modes": apply_A.modes}

    def host(tree):
        return {k: v.cpu().numpy() for k, v in tree.items()} if mesh.rank == 0 else None

    return {"rank": mesh.rank, "modes": [str(m) for m in apply_A.modes],
            "capturable": bool(getattr(apply_A, "capturable", False)),
            "out": host(out), "out_ghost_garbage": None if garbage is None else host(garbage),
            "launches": launches, "collectives": collectives, "local": local}


def dryrun_multichip(n_devices: int, device="cuda", timeout: float = 300.0) -> dict:
    """The port's counterpart of ``__graft_entry__.dryrun_multichip``: the
    same scene and configuration (buckling-16, 2 levels, a fixed 60 CG
    iterations: tolerance 1e-30), solved on ``n_devices`` spawned ranks
    (gloo; on ``device``) through the sharded CG, against the single-device
    whole-array solve of the same configuration here (``v1-fused``).  The
    same bars: 60 iterations, residual <= 1e-3, velocity within 5e-4 of
    max.  Returns the summary it prints."""
    from .. import scenes

    config = SolverConfig(octree_levels=2, max_iterations=60, tolerance=1e-30,
                          apply_impl="cuda")
    dt = float(np.float32(1.0 / 24.0))
    single = solve_viscosity(scenes.buckling(n=16, device=device), dt,
                             dataclasses.replace(config, apply_impl="v1-fused"), device=device)
    assert single.stats.solve_path == "v1-fused", single.stats.solve_path
    ranks = [r[0] for r in launch(n_devices, solve_on_ranks, ("buckling", 16), dt, [config],
                                  timeout=timeout, device=device)]
    st = ranks[0]["stats"]
    max_rel = 0.0
    for got, want in zip(ranks[0]["velocity"], _velocity_np(single)):
        scale = max(float(np.abs(want).max()), 1e-30)
        max_rel = max(max_rel, float(np.abs(got - want).max()) / scale)
    summary = {"devices": n_devices, "solve_path": st["solve_path"],
               "iterations": st["iterations"], "residual": st["residual"],
               "octree_dofs": st["octree_dofs"], "ranks_agree": all(
                   r["stats"] == st for r in ranks),
               "max_rel_diff_vs_single_device": max_rel}
    print("dryrun_multichip ok:", summary)
    want_path = "cuda-sharded" if torch.device(device).type == "cuda" else "cuda-plain-sharded"
    assert st["solve_path"] == want_path, st["solve_path"]
    assert st["iterations"] == 60, st["iterations"]
    assert summary["ranks_agree"], [r["stats"] for r in ranks]
    assert st["residual"] <= 1e-3, f"dryrun solve did not converge: {st['residual']}"
    assert max_rel < 5e-4, f"sharded solve diverged from reference: {max_rel}"
    return summary
