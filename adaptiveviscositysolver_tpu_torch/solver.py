"""Top-level per-frame adaptive viscosity solve (port of ``solver.py``).

The equivalent of HDK_AdaptiveViscosity::solveGasSubclass
(reference Source/HDK_AdaptiveViscosity.cpp:126-710): from the liquid
and solid SDFs, the MAC velocity, solid velocity, viscosity and density,
build the octree, classify the DOFs, build the stress stencils, solve the
SPD system with preconditioned CG and write the result back to the uniform
grid.

Stage names follow the reference's perf-monitor events (cpp:306-880), as in
the JAX package.  PyTorch runs eagerly: the stages are plain function calls
on device tensors, and the CG loop is a Python loop.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from . import classify, fields, interpolator, octree, operator, restriction, stencils, writeback
from .config import SolverConfig, capped_levels
from .ops import fused_apply
from .ops.arrayops import pad_const
from .utils import trace


@dataclasses.dataclass
class FluidState:
    """Per-frame inputs on the finest grid (the reference's seven DOP field
    bindings, cpp:138-231).  Solid SDF is negative inside the solid."""

    liquid_sdf: torch.Tensor                 # (nx, ny, nz) cell-sampled
    solid_sdf: torch.Tensor
    velocity: Tuple[torch.Tensor, ...]       # 3 face-sampled (MAC)
    solid_velocity: Tuple[torch.Tensor, ...]
    viscosity: torch.Tensor
    density: torch.Tensor
    dx: float

    def to(self, device=None, dtype=None) -> "FluidState":
        def t(x):
            return x.to(device=device, dtype=dtype or x.dtype)

        return FluidState(t(self.liquid_sdf), t(self.solid_sdf),
                          tuple(t(v) for v in self.velocity),
                          tuple(t(v) for v in self.solid_velocity),
                          t(self.viscosity), t(self.density), self.dx)


@dataclasses.dataclass
class SolveStats:
    iterations: int
    residual: float
    octree_dofs: int
    regular_dofs: int
    active_cells: List[int]   # per level
    # which CG path ran (``_route``): "cuda" (the hand-written kernels),
    # "cuda-plain" (the same canonical-box apply through the kernels' plain
    # PyTorch version, on CPU tensors), either with "-sharded" (the CG over
    # a mesh's ranks), "v1" / "v1-fused" (the whole-array operator) or
    # "refined" (mixed-precision iterative refinement)
    solve_path: str = ""
    applies: int = 0          # operator applies made by the solve (both
    # precisions under refinement; the lam_max estimate included).  Under
    # refinement only the float32 ones open ``cg.apply``: applies =
    # ``cg.apply`` + ``refine.residual`` entries (utils/trace.py)
    # [iterations, residual, octree_dofs, regular_dofs, counts..., boxes...]
    # of THIS frame's full-height octree occupancy (the JAX layout), fetched
    # with the stats when solve_viscosity gets ``probe_levels``, so that
    # make_solver's async probe costs no transfer of its own; else None
    topology_probe: Optional[List[float]] = None


@dataclasses.dataclass
class SolveResult:
    velocity: Tuple[torch.Tensor, ...]
    stats: SolveStats


def _validate_state(state: FluidState) -> None:
    """Structural checks of the seven input fields (cpp:152-231)."""
    res = tuple(state.liquid_sdf.shape)
    if len(res) != 3:
        raise ValueError(f"liquid_sdf must be 3-D, got {res}")
    for name in ("solid_sdf", "viscosity", "density"):
        f = getattr(state, name)
        if tuple(f.shape) != res:
            raise ValueError(f"{name} must align with liquid_sdf: {tuple(f.shape)} != {res}")
    for group, vel in (("velocity", state.velocity), ("solid_velocity", state.solid_velocity)):
        if len(vel) != 3:
            raise ValueError(f"{group} must have 3 staggered components")
        for a in range(3):
            want = tuple(r + (1 if d == a else 0) for d, r in enumerate(res))
            if tuple(vel[a].shape) != want:
                raise ValueError(
                    f"{group}[{a}] must be face-sampled (MAC): {tuple(vel[a].shape)} != {want}")
    if state.dx <= 0:
        raise ValueError("dx must be positive")


def padded_shape(shape: Sequence[int], levels: int, mesh_n: int = 1) -> Tuple[int, int, int]:
    """Smallest extents >= ``shape`` divisible by ``2^(levels-1)`` (the
    reference stretches to a power of two, HDK_OctreeGrid.cpp:10-24); a
    solve sharded over ``mesh_n`` ranks also needs ``mesh_n | nx_l`` with
    even local widths below the top, i.e. ``(mesh_n << (levels-1)) | nx``
    (parallel/shard_fused.shardable_levels)."""
    m = 1 << max(0, levels - 1)
    mults = (m * max(1, mesh_n), m, m)
    return tuple(-(-int(s) // q) * q for s, q in zip(shape, mults))


def _pad_state(state: FluidState, target: Sequence[int]) -> FluidState:
    """Pad every field to cell resolution ``target`` on the high side: SDFs
    with a far positive value (INACTIVE), velocities with zero, viscosity
    and density with their edge values."""
    from .ops.arrayops import pad_edge

    res = tuple(state.liquid_sdf.shape)
    pads = tuple(int(t) - int(s) for s, t in zip(res, target))
    if not any(pads):
        return state
    cell_pad = tuple((0, p) for p in pads)
    far = 4.0 * state.dx * max(target)
    return dataclasses.replace(
        state,
        liquid_sdf=pad_const(state.liquid_sdf, cell_pad, far),
        solid_sdf=pad_const(state.solid_sdf, cell_pad, far),
        velocity=tuple(pad_const(v, cell_pad, 0) for v in state.velocity),
        solid_velocity=tuple(pad_const(v, cell_pad, 0) for v in state.solid_velocity),
        viscosity=pad_edge(state.viscosity, cell_pad),
        density=pad_edge(state.density, cell_pad),
    )


@dataclasses.dataclass
class System:
    """Everything solve_viscosity builds before the CG (see build_system)."""

    state: FluidState
    orig_res: Tuple[int, int, int]
    levels: int
    impl: str
    labels: List[torch.Tensor]
    vel_kinds: List[List[torch.Tensor]]
    regular_kinds: List[torch.Tensor]
    res_per_level: List[Tuple[int, int, int]]
    active: Dict[Tuple[int, int], torch.Tensor]
    apply_A: object           # the CG's operator (fused apply for "cuda"; None when sharded)
    apply_v1: object          # the whole-array operator on logical grids
    rhs: Dict[Tuple[int, int], torch.Tensor]
    guess: Dict[Tuple[int, int], torch.Tensor]
    diag: Dict[Tuple[int, int], torch.Tensor]
    blocks: list = dataclasses.field(default_factory=list)   # stencils.StressBlock
    mass: Optional[Dict[Tuple[int, int], torch.Tensor]] = None
    embed_tree: object = None
    crop_tree: object = None
    frame: Optional[Dict[str, torch.Tensor]] = None
    canons: Optional[list] = None
    modes: Optional[list] = None       # per-level route of the fused apply
    mask: Optional[torch.Tensor] = None   # the refinement mask the octree was built from
    edge_kinds: Optional[list] = None
    center_kinds: Optional[list] = None


@dataclasses.dataclass
class Topology:
    """The part of a fused-apply system that depends only on the topology
    key (level resolutions and crop windows), not on the frame's data: the
    routed canonical boxes, their routes (from the card's L2 budget) and
    the operator's buffers (``fused_apply.operator_buffers``).  Empty until
    the first :func:`build_system` that is handed it fills it; later ones
    reuse it.  ``make_solver`` keeps one per cache entry."""

    res_per_level: Optional[List[Tuple[int, int, int]]] = None
    windows: Optional[tuple] = None
    canons: Optional[list] = None
    modes: Optional[list] = None
    buffers: Optional[dict] = None

    def fill(self, res_per_level, windows, device) -> None:
        if self.canons is None:
            with trace.span("topology.build"):
                canons = fused_apply.level_canons(res_per_level, windows)
                self.modes = fused_apply.level_modes(canons, fused_apply.route_budget(device))
                self.canons = fused_apply.route_canons(canons, self.modes)
                self.buffers = fused_apply.operator_buffers(self.canons, self.modes, device)
                self.res_per_level, self.windows = list(res_per_level), windows
        elif (self.res_per_level, self.windows) != (list(res_per_level), windows):
            raise ValueError(f"this topology was built for levels {self.res_per_level} and "
                             f"windows {self.windows}, not {res_per_level} and {windows}")


def _cast_blocks(blocks, dtype) -> list:
    """Stress blocks with every float tensor cast to ``dtype``."""
    def c(x):
        return None if x is None else x.to(dtype)

    return [dataclasses.replace(
        b, weight=c(b.weight), boundary=c(b.boundary),
        terms=[dataclasses.replace(t, coeff=c(t.coeff)) for t in b.terms]) for b in blocks]


class _Route(NamedTuple):
    impl: str       # the operator: "cuda" (the fused apply), "v1" or "v1-fused"
    refined: bool   # mixed-precision iterative refinement
    sharded: bool   # the CG over the ranks (parallel/shard_fused.py)
    path: str       # SolveStats.solve_path


def _route(config: SolverConfig, dtype: torch.dtype, device: torch.device,
           ranks: int) -> _Route:
    """The solve's route from the config, the solve's dtype, the device and
    the rank count: "auto" takes the fused apply on the card in float32
    (or under refinement) and whenever the CG is sharded, which it is over
    more than one rank for "cuda"/"auto" in float32 without refinement.
    Refuses "cuda" in float64 without refinement."""
    refined = config.use_iterative_refinement
    sharded = (ranks > 1 and config.apply_impl in ("cuda", "auto") and dtype == torch.float32
               and not refined)
    impl = config.apply_impl
    if impl == "auto":
        on_card = device.type == "cuda" and (dtype == torch.float32 or refined)
        impl = "cuda" if on_card or sharded else "v1"
    if impl == "cuda" and dtype != torch.float32 and not refined:
        raise ValueError("apply_impl='cuda' computes in float32; for a float64 solve "
                         "use use_iterative_refinement=True (float32 inner CG through "
                         "the fused apply, float64 residual) or apply_impl='v1'")
    if refined:
        path = "refined"
    elif impl == "cuda":
        path = "cuda" if device.type == "cuda" else "cuda-plain"
        path += "-sharded" if sharded else ""
    else:
        path = impl
    return _Route(impl, refined, sharded, path)


def build_system(state: FluidState, dt, config: SolverConfig = SolverConfig(), *,
                 device="cuda", face_weights: Optional[Sequence[torch.Tensor]] = None,
                 bboxes=None, pad_levels=None,
                 stage_times: Optional[Dict[str, float]] = None,
                 topology: Optional[Topology] = None, mesh_n: int = 1) -> System:
    """Every stage of :func:`solve_viscosity` up to the CG: surface weights,
    octree, labels, stencils, restriction, and the system (operator, rhs,
    Jacobi diagonal).  ``face_weights``: see :func:`solve_viscosity`.
    ``bboxes`` are per-level crop windows for the fused
    apply (from :func:`probe_topology`).  The fused apply routes each level
    by the card's L2 budget (``fused_apply.level_modes`` with
    ``fused_apply.route_budget(device)``).  ``topology``: a
    :class:`Topology` to take the boxes, routes and buffers from (filled
    here if empty); it must have been built for these levels and windows.
    ``mesh_n > 1``: pad x for that many ranks; where :func:`_route` shards
    the CG over them, leave the fused operator to it (``apply_A`` None)."""
    device = torch.device(device)
    with trace.tracing(stage_times, device):
        _validate_state(state)
        state = state.to(device=device, dtype=config.dtype)
        route = _route(config, state.viscosity.dtype, device, mesh_n)
        dx = state.dx
        extrapolation = config.extrapolation * dx
        orig_res = tuple(state.liquid_sdf.shape)
        levels = capped_levels(orig_res, config.octree_levels)
        lv_pad = levels if pad_levels is None else max(levels, capped_levels(orig_res, pad_levels))
        target = padded_shape(orig_res, lv_pad, mesh_n)
        if face_weights is not None:
            face_weights = [torch.as_tensor(w, device=device) for w in face_weights]
        if target != orig_res:
            state = _pad_state(state, target)
            if face_weights is not None:
                pads = tuple((0, int(t) - int(s)) for s, t in zip(orig_res, target))
                face_weights = [pad_const(w, pads, 0) for w in face_weights]
        liquid, solid = state.liquid_sdf, state.solid_sdf
        if bboxes is not None and len(bboxes) != levels:
            raise ValueError(f"bboxes has {len(bboxes)} levels, solve has {levels}; "
                             "pass the level count probe_topology returned")

        with trace.stage("compute_surface_weights"):
            center_w, edge_w = fields.integration_weights(
                liquid, solid, config.num_supersamples, extrapolation, config.apply_solid_weights)
            if face_weights is None:
                face_w = fields.face_weights(liquid, solid, config.num_supersamples,
                                             extrapolation, config.apply_solid_weights)
            else:
                face_w = list(face_weights)

        with trace.stage("build_octree"):
            inner_band = dx * max(2.0, float(config.fine_bandwidth))
            mask = octree.build_refinement_mask(liquid, solid, dx, extrapolation, 3.0 * dx,
                                                inner_band)
            labels = octree.build_octree(mask, levels)

        with trace.stage("build_labels"):
            vel_kinds = classify.classify_octree_velocity(labels, center_w, edge_w, solid,
                                                          extrapolation)
            edge_kinds = classify.classify_edge_stress(labels, edge_w)
            center_kinds = classify.classify_center_stress(labels, center_w)
            regular_kinds = [classify.classify_regular_velocity(center_w, edge_w, solid,
                                                                extrapolation, a)
                             for a in range(3)]

        res_per_level = [tuple(l.shape) for l in labels]
        if bboxes is not None:
            # clamp the probe windows to this solve's level resolutions
            bboxes = tuple(
                tuple((min(int(b[d][0]), max(0, (res[d] - 2) & ~1)), min(int(b[d][1]), res[d]))
                      for d in range(3))
                for b, res in zip(bboxes, res_per_level))
        active = {(l, a): vel_kinds[l][a] == classify.FLUID
                  for l in range(levels) for a in range(3)}

        with trace.stage("build_stress_stencils"):
            sdtype = state.viscosity.dtype
            blocks = stencils.build_edge_stress_blocks(
                labels, vel_kinds, edge_kinds, edge_w, state.viscosity, state.solid_velocity,
                dt, dx, config,
            ) + stencils.build_center_stress_blocks(
                labels, vel_kinds, center_kinds, center_w, state.viscosity, state.solid_velocity,
                dt, dx, config,
            )
            mass = stencils.build_mass(labels, vel_kinds, face_w, state.density)

        with trace.stage("restrict_velocity"):
            guess_raw = restriction.restrict_velocity_pyramid(
                [v.to(sdtype) for v in state.velocity], levels)
            zero = torch.zeros((), dtype=sdtype, device=device)
            guess = {k: torch.where(active[k], guess_raw[k], zero) for k in active}

        with trace.stage("build_system"):
            v1_apply, diag = operator.make_operator(blocks, mass, active, res_per_level)
            rhs = operator.boundary_rhs(blocks, mass, guess, active, res_per_level)
            # "v1-fused" runs the "v1" operator: the JAX package rebuilds the
            # coefficients inside each apply to save memory, with the same numbers
            sys_ = System(state, orig_res, levels, route.impl, labels, vel_kinds,
                          regular_kinds, res_per_level, active, v1_apply, v1_apply, rhs, guess,
                          diag, blocks=blocks, mass=mass, mask=mask, edge_kinds=edge_kinds,
                          center_kinds=center_kinds)
            if route.sharded:
                sys_.apply_A = None   # parallel/shard_fused builds each rank's own
            elif route.impl == "cuda":
                topo = Topology() if topology is None else topology
                topo.fill(res_per_level, bboxes, device)
                frame, canons = fused_apply.build_frame_data(
                    labels, vel_kinds, edge_kinds, center_kinds, blocks, mass, res_per_level,
                    canons=topo.canons)
                sys_.apply_A, sys_.embed_tree, sys_.crop_tree = fused_apply.make_fused_operator(
                    frame, canons, active, res_per_level, dx, config.use_enhanced_gradients,
                    modes=topo.modes, buffers=topo.buffers)
                sys_.frame, sys_.canons, sys_.modes = frame, canons, topo.modes
        return sys_


def solve_viscosity(state: FluidState, dt, config: SolverConfig = SolverConfig(),
                    face_weights: Optional[Sequence[torch.Tensor]] = None, *,
                    device="cuda", bboxes=None, pad_levels=None, probe_levels=None,
                    stage_times: Optional[Dict[str, float]] = None,
                    topology: Optional[Topology] = None, mesh=None,
                    mesh_axis: str = "x") -> SolveResult:
    """One viscosity solve (the reference's per-frame solveGasSubclass).

    ``device`` defaults to the card; the state is moved there.
    ``mesh``: a ``parallel.mesh.Mesh`` of more than one rank (every rank
    calls this together, with the whole state; ``device`` is then the
    rank's).  With ``apply_impl`` "cuda"/"auto" in float32 the grid is
    padded for the ranks and the CG runs sharded over them
    (``parallel/shard_fused.py``: the kernels on each rank's halo-filled
    local boxes, all-reduced dots; ``solve_path`` "cuda-sharded", or
    "cuda-plain-sharded" on CPU tensors); the stages before and after it
    run on the whole grid on every rank.  Any other option (``v1``,
    ``v1-fused``, refinement) runs each rank's single-device solve of it,
    under its own ``solve_path``.  ``mesh_axis`` must be the mesh's axis
    name.
    ``face_weights``: the host FLIP loop's face volume fractions
    ("surfaceweights", cpp:144), three face-sampled arrays of the state's
    resolution; computed from the SDFs when omitted.  ``bboxes``:
    per-level crop windows for the fused apply (``make_solver`` supplies
    them).  ``pad_levels``: pad the domain for this many levels even if
    fewer are solved.  ``probe_levels``: also return this frame's
    occupancy of a ``probe_levels``-level octree in
    ``stats.topology_probe`` (decode with :func:`decode_topology_probe`).
    ``stage_times``: a dict that receives per-stage seconds (synchronizes
    at each stage) and the seconds of the spans inside the stages
    (``utils/trace.py``, which names them).  ``topology``: see
    :func:`build_system`."""
    device = torch.device(device if mesh is None else mesh.device)
    route = _route(config, config.dtype or state.viscosity.dtype, device,
                   1 if mesh is None else mesh.size)
    if mesh is not None and mesh_axis != mesh.axis_name:
        raise ValueError(f"mesh axis {mesh_axis!r}, the mesh's is {mesh.axis_name!r}")
    if route.sharded and (bboxes is not None or topology is not None):
        raise ValueError("a sharded solve runs whole local boxes: no bboxes or topology")
    with trace.tracing(stage_times, device):
        sys_ = build_system(state, dt, config, device=device, face_weights=face_weights,
                            bboxes=bboxes, pad_levels=pad_levels, stage_times=stage_times,
                            topology=topology, mesh_n=mesh.size if route.sharded else 1)
        state, levels = sys_.state, sys_.levels
        cg_options = dict(cheb_degree=config.cheb_degree, cancel_poll=config.cancel_poll_iters)

        with trace.stage("solve"):
            if route.refined:
                if route.impl == "cuda":
                    # the inner CG on the canonical grids, through the fused apply
                    apply_A32 = sys_.apply_A
                    canonical = dict(embed_tree=sys_.embed_tree, crop_tree=sys_.crop_tree)
                else:
                    f32 = torch.float32
                    apply_A32, _ = operator.make_operator(
                        _cast_blocks(sys_.blocks, f32),
                        {k: v.to(f32) for k, v in sys_.mass.items()},
                        sys_.active, sys_.res_per_level)
                    canonical = {}
                solution, iters, rel, applies = operator.pcg_refined(
                    sys_.apply_v1, apply_A32, sys_.rhs, sys_.guess, sys_.diag, config.tolerance,
                    config.max_iterations, **canonical)
            elif route.sharded:
                from .parallel import shard_fused

                we, wc = shard_fused.stress_weights(sys_.blocks, levels)
                solution, iters, rel, applies = shard_fused.sharded_fused_pcg(
                    mesh, sys_.vel_kinds, sys_.edge_kinds, sys_.center_kinds, we, wc,
                    sys_.mass, sys_.active, sys_.rhs, sys_.guess, sys_.diag,
                    sys_.res_per_level, state.dx, config.use_enhanced_gradients,
                    config.tolerance, config.max_iterations, cheb_degree=config.cheb_degree)
            elif route.impl == "cuda":
                sol_c, iters, rel, applies = operator.pcg_flat(
                    sys_.apply_A, sys_.embed_tree(sys_.rhs), sys_.embed_tree(sys_.guess),
                    sys_.embed_tree(sys_.diag, fill=1.0), config.tolerance, config.max_iterations,
                    **cg_options)
                solution = sys_.crop_tree(sol_c)
            else:
                solution, iters, rel, applies = operator.pcg_flat(
                    sys_.apply_A, sys_.rhs, sys_.guess, sys_.diag, config.tolerance,
                    config.max_iterations, **cg_options)

        with trace.stage("interpolate_writeback"):
            interpolated = interpolator.interpolate_writeback_fields(
                sys_.labels, solution, sys_.vel_kinds, levels)

        with trace.stage("writeback"):
            new_velocity = writeback.apply_to_regular_grid(
                state.velocity, solution, sys_.labels, sys_.vel_kinds, sys_.regular_kinds,
                state.solid_velocity, levels, interpolated)
            orig = sys_.orig_res
            if tuple(state.liquid_sdf.shape) != orig:
                new_velocity = [
                    v[tuple(slice(0, orig[d] + (1 if d == a else 0)) for d in range(3))]
                    for a, v in enumerate(new_velocity)]

        # everything the host reads back comes in one transfer (float64 holds
        # the counts exactly)
        parts = [torch.as_tensor(rel, device=device).reshape(1),
                 sum(m.sum() for m in sys_.active.values()).reshape(1),
                 sum((k == classify.FLUID).sum() for k in sys_.regular_kinds).reshape(1),
                 octree.active_cell_counts(sys_.labels)]
        if probe_levels is not None:
            with trace.stage("topology_probe"):
                full = capped_levels(tuple(state.liquid_sdf.shape), probe_levels)
                plabels = sys_.labels if full == levels else octree.build_octree(sys_.mask, full)
                parts += [octree.active_cell_counts(plabels),
                          torch.stack(octree.occupied_bboxes(plabels)).reshape(-1)]
    packed = torch.cat([p.to(torch.float64) for p in parts]).tolist()
    stats = SolveStats(
        iterations=int(iters),
        residual=packed[0],
        octree_dofs=int(packed[1]),
        regular_dofs=int(packed[2]),
        active_cells=[int(c) for c in packed[3:3 + levels]],
        solve_path=route.path,
        applies=int(applies),
    )
    if probe_levels is not None:
        stats.topology_probe = [float(iters)] + packed[:3] + packed[3 + levels:]
    return SolveResult(velocity=tuple(new_velocity), stats=stats)


# ---------------------------------------------------------------------------
# host-side topology probe and the per-frame solver closure
# ---------------------------------------------------------------------------


WINDOW_QUANTUM = 16  # hysteresis GROWTH step, not the snap grid (the JAX
# package measured tight windows against 16-snapped ones on the beam scene:
# snapping sweeps ~1.7x more canonical plane area).  Tight windows keep the
# apply minimal; the coarse growth step and the LRU cap of make_solver bound
# the number of cached topologies.
SHRINK_AFTER = 8    # consecutive oversized frames before a re-tighten
SHRINK_RATIO = 1.5  # cached/tight swept-volume ratio that counts as oversized
MAX_PROGRAMS = 8    # make_solver's LRU cap on cached topologies


def _tight_windows(raw, res_per_level, margin=2, q=2):
    """Per-level crop windows from the occupied boxes: ``margin`` covers
    neighbour kind reads around boundary DOFs; both ends snap outward to the
    ``q`` grid (2 keeps origins even, so canonical parity = logical)."""
    out = []
    for bb, res in zip(raw, res_per_level):
        rows = []
        for d in range(3):
            lo, hi = int(bb[d][0]), int(bb[d][1])
            if hi <= lo:
                lo, hi = 0, min(2, res[d])
            lo = max(0, lo - margin) // q * q
            hi = min(res[d], -(-(hi + margin) // q) * q)
            rows.append((lo, hi))
        out.append(tuple(rows))
    return tuple(out)


def _merge_windows(cached, tight, res_per_level, q=WINDOW_QUANTUM):
    """Hysteresis of the per-solver window cache: keep the cached window
    while the fluid stays inside it; on a violation, extend the violated
    side onto the ``q`` grid one quantum past the tight bound (so a moving
    fluid changes topology in coarse steps, and grown bounds land on shared
    grid positions).  Windows shrink only through make_solver's age-out."""
    if cached is None:
        return tight
    out = []
    for cw, tw, res in zip(cached, tight, res_per_level):
        rows = []
        for d in range(3):
            lo, hi = cw[d]
            if tw[d][0] < lo:
                lo = max(0, (tw[d][0] - q) // q * q)
            if tw[d][1] > hi:
                hi = min(res[d], -(-(tw[d][1] + q) // q) * q)
            rows.append((lo, hi))
        out.append(tuple(rows))
    return tuple(out)


def _shrink_target(tight, res_per_level, q=WINDOW_QUANTUM):
    """Re-tighten target: the tight window expanded one quantum per side
    onto the shared ``q`` grid (the positions _merge_windows grows to)."""
    out = []
    for tw, res in zip(tight, res_per_level):
        rows = []
        for d in range(3):
            lo = max(0, (tw[d][0] - q) // q * q)
            hi = min(res[d], -(-(tw[d][1] + q) // q) * q)
            rows.append((lo, hi))
        out.append(tuple(rows))
    return tuple(out)


def _windows_volume(windows) -> int:
    """Total swept cell volume of a window set (the apply's cost scales with
    the canonical boxes' volumes)."""
    total = 0
    for w in windows:
        v = 1
        for d in range(3):
            v *= max(0, w[d][1] - w[d][0])
        total += v
    return total


def _trim_and_window(counts, raw_bboxes, shape, q=2):
    """Trailing empty levels dropped (HDK_OctreeGrid.cpp:198-211), then the
    per-level crop windows."""
    full = len(counts)
    levels = full
    while levels > 1 and counts[levels - 1] == 0:
        levels -= 1
    pshape = padded_shape(shape, full)
    res_per_level = [tuple(int(s) >> l for s in pshape) for l in range(levels)]
    return levels, _tight_windows(raw_bboxes[:levels], res_per_level, q=q)


def probe_topology(state: FluidState, config: SolverConfig, *, device="cuda"):
    """(effective level count, per-level crop windows): mask + octree +
    ACTIVE counts + occupied boxes on the device, fetched in one transfer."""
    device = torch.device(device)
    dx = state.dx
    shape = tuple(state.liquid_sdf.shape)
    levels = capped_levels(shape, config.octree_levels)
    liquid = state.liquid_sdf.to(device)
    solid = state.solid_sdf.to(device)
    target = padded_shape(shape, levels)
    if target != shape:
        pads = tuple((0, int(t) - int(s)) for s, t in zip(shape, target))
        far = 4.0 * dx * max(target)
        liquid = pad_const(liquid, pads, far)
        solid = pad_const(solid, pads, far)
    extrapolation = config.extrapolation * dx
    inner_band = dx * max(2.0, float(config.fine_bandwidth))
    mask = octree.build_refinement_mask(liquid, solid, dx, extrapolation, 3.0 * dx, inner_band)
    labels = octree.build_octree(mask, levels)
    packed = torch.cat([octree.active_cell_counts(labels).to(torch.int64),
                        torch.stack(octree.occupied_bboxes(labels)).to(torch.int64).reshape(-1)])
    packed = packed.cpu().tolist()
    counts = packed[:levels]
    raw = [[packed[levels + 6 * l + 2 * d: levels + 6 * l + 2 * d + 2] for d in range(3)]
           for l in range(levels)]
    return _trim_and_window(counts, raw, shape)


def effective_levels(state: FluidState, config: SolverConfig, *, device="cuda") -> int:
    """Octree level count with trailing empty levels dropped (the
    reference's empty-top-level trim, HDK_OctreeGrid.cpp:198-211): a level
    with no ACTIVE cell adds no DOF, stencil or coupling."""
    return probe_topology(state, config, device=device)[0]


def decode_topology_probe(packed, shape, full_levels):
    """Host decode of ``SolveStats.topology_probe``: (stats dict, effective
    levels, crop windows).  ``packed`` is [iterations, residual,
    octree_dofs, regular_dofs, counts..., boxes...] of the full (untrimmed)
    ``full_levels``-level pyramid."""
    packed = [float(v) for v in packed]
    counts = [int(v) for v in packed[4:4 + full_levels]]
    raw = [[[int(packed[4 + full_levels + 6 * l + 2 * d + k]) for k in (0, 1)]
            for d in range(3)] for l in range(full_levels)]
    lv, windows = _trim_and_window(counts, raw, shape)
    stats = {"iterations": int(packed[0]), "residual": packed[1],
             "octree_dofs": int(packed[2]), "regular_dofs": int(packed[3])}
    return stats, lv, windows


def _contained(tight, used) -> bool:
    return all(u[d][0] <= t[d][0] and t[d][1] <= u[d][1]
               for t, u in zip(tight, used) for d in range(3))


def make_solver(config: SolverConfig = SolverConfig(), *, auto_trim_levels: bool = True,
                async_probe: bool = True, device="cuda"):
    """Solve closure ``solve(state, dt, face_weights=None, stage_times=None)
    -> SolveResult`` with the JAX make_solver's host policy (the windows come
    from the SDFs, never from ``face_weights``).

    ``auto_trim_levels`` (default on): trim empty top levels and crop the
    fused apply to per-level windows of the occupied region.  Windows carry
    hysteresis per level count (:func:`_merge_windows`: grow on a
    violation, by a quantum) and shrink by age-out: after ``SHRINK_AFTER``
    consecutive frames whose cached windows sweep over ``SHRINK_RATIO``
    times the tight windows' volume, re-tighten, to :func:`_shrink_target`
    where that is a shrink by the same ratio, else to the tight windows.
    (The JAX make_solver tests the ratio against the shrink target, which
    on a small domain is the whole domain, so its shrink never fires:
    ROADMAP C1.)

    Each topology key (level count, windows, ``async_probe``, and the
    padded grid, which the JAX jit keys by itself) has a cache entry, a
    :class:`Topology` that keeps the routed boxes and the operator's
    buffers on the card; at most ``MAX_PROGRAMS``, least recently used
    dropped.  A frame of another grid (shape or dx) starts the window
    history anew.

    ``async_probe`` (default on): only the first frame of a grid probes;
    each solve returns its frame's full-height occupancy with the stats
    (``stats.topology_probe``, in the same transfer), and the next frame
    dispatches with those windows.  When the solved frame's occupancy
    escapes the windows it used, or its level trim changed, the frame is
    solved again with its own.  ``solve.cache_info()`` gives ``{"programs":
    entries, "windows": {levels: windows}}``."""
    device = torch.device(device)
    entries: "collections.OrderedDict[tuple, Topology]" = collections.OrderedDict()
    window_cache: Dict[int, tuple] = {}
    slack_age: Dict[int, int] = {}
    carry: Dict[str, object] = {}

    def _entry(key) -> Topology:
        if key not in entries:
            entries[key] = Topology()
        entries.move_to_end(key)
        while len(entries) > MAX_PROGRAMS:
            entries.popitem(last=False)
        return entries[key]

    def _windows(lv, tight, res_per_level):
        cached = window_cache.get(lv)
        windows = _merge_windows(cached, tight, res_per_level)
        if cached is not None and windows == cached:
            if _windows_volume(cached) > SHRINK_RATIO * max(1, _windows_volume(tight)):
                slack_age[lv] = slack_age.get(lv, 0) + 1
                if slack_age[lv] >= SHRINK_AFTER:
                    target = _shrink_target(tight, res_per_level)
                    shrinks = SHRINK_RATIO * _windows_volume(target) <= _windows_volume(cached)
                    windows = target if shrinks else tight
                    slack_age[lv] = 0
            else:
                slack_age[lv] = 0
        else:
            slack_age[lv] = 0
        window_cache[lv] = windows
        return windows

    def _dispatch(lv, tight, state, dt, face_weights, pshape, stage_times):
        cfg = config if lv == config.octree_levels else dataclasses.replace(
            config, octree_levels=lv)
        windows = _windows(lv, tight, [tuple(s >> l for s in pshape) for l in range(lv)])
        out = solve_viscosity(
            state, dt, cfg, face_weights=face_weights, device=device, bboxes=windows,
            pad_levels=config.octree_levels,
            probe_levels=config.octree_levels if async_probe else None,
            stage_times=stage_times, topology=_entry((lv, windows, async_probe, pshape)))
        return out, windows

    def solve(state: FluidState, dt, face_weights=None,
              stage_times: Optional[Dict[str, float]] = None):
        shape = tuple(state.liquid_sdf.shape)
        full = capped_levels(shape, config.octree_levels)
        pshape = padded_shape(shape, full)
        if not auto_trim_levels:
            return solve_viscosity(state, dt, config, face_weights=face_weights, device=device,
                                   stage_times=stage_times,
                                   topology=_entry((config.octree_levels, None, False, pshape)))
        if carry.get("grid") != (pshape, state.dx):
            window_cache.clear()
            slack_age.clear()
            carry.clear()
            carry["grid"] = (pshape, state.dx)
        if async_probe and "probe" in carry:
            lv, tight = carry["probe"]
        else:
            with trace.tracing(stage_times, device), trace.stage("probe"):
                lv, tight = probe_topology(state, config, device=device)
        out, used = _dispatch(lv, tight, state, dt, face_weights, pshape, stage_times)
        if not async_probe:
            return out
        _, lv2, tight2 = decode_topology_probe(out.stats.topology_probe, shape, full)
        carry["probe"] = (lv2, tight2)
        if lv2 != lv or not _contained(tight2, used[:lv2]):
            # the solved frame's occupancy escaped the windows it used (or
            # its trim changed): solve it again with its own probe, which
            # cannot escape
            with trace.tracing(stage_times, device), trace.span("resolve"):
                out, _ = _dispatch(lv2, tight2, state, dt, face_weights, pshape, stage_times)
        return out

    def cache_info():
        """Cached topologies and the current grid's windows per level count."""
        return {"programs": len(entries), "windows": dict(window_cache)}

    solve.cache_info = cache_info
    return solve


def octree_geometry_for_state(state: FluidState, config: SolverConfig = SolverConfig(),
                              path: Optional[str] = None, *, device="cuda"):
    """The octree debug geometry of a state, the analog of the reference's
    ``doPrintOctree`` / ``octreeGeometry`` outputs (cpp:78-82, 283-294):
    (positions, pscale, level) numpy arrays of the ACTIVE cells; also
    writes a binary PLY (``native.export_octree_ply``) when ``path`` is
    given."""
    dx = state.dx
    levels = capped_levels(tuple(state.liquid_sdf.shape), config.octree_levels)
    mask = octree.build_refinement_mask(
        state.liquid_sdf.to(device), state.solid_sdf.to(device), dx, config.extrapolation * dx,
        3.0 * dx, dx * max(2.0, float(config.fine_bandwidth)))
    labels = [l.cpu().numpy() for l in octree.build_octree(mask, levels)]
    if path is not None:
        from . import native

        native.export_octree_ply(labels, dx, path)
    return octree.octree_geometry(labels, dx)
