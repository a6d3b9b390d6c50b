"""Top-level per-frame adaptive viscosity solve (port of ``solver.py``).

The equivalent of HDK_AdaptiveViscosity::solveGasSubclass
(reference Source/HDK_AdaptiveViscosity.cpp:126-710): from the liquid
and solid SDFs, the MAC velocity, solid velocity, viscosity and density,
build the octree, classify the DOFs, build the stress stencils, solve the
SPD system with Jacobi PCG and write the result back to the uniform grid.

Stage names follow the reference's perf-monitor events (cpp:306-880), as in
the JAX package.  PyTorch runs eagerly: the stages are plain function calls
on device tensors, and the CG loop is a Python loop.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from . import classify, fields, interpolator, octree, operator, restriction, stencils, writeback
from .config import SolverConfig, capped_levels
from .ops import fused_apply
from .ops.arrayops import pad_const


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
    # which CG path ran: "cuda" (the hand-written kernels), "cuda-plain"
    # (the same canonical-box apply through the kernels' plain PyTorch
    # version, on CPU tensors) or "v1" (the whole-array operator)
    solve_path: str = ""
    applies: int = 0          # operator applies made by the CG


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


def padded_shape(shape: Sequence[int], levels: int) -> Tuple[int, int, int]:
    """Smallest extents >= ``shape`` divisible by ``2^(levels-1)`` (the
    reference stretches to a power of two, HDK_OctreeGrid.cpp:10-24)."""
    m = 1 << max(0, levels - 1)
    return tuple(-(-int(s) // m) * m for s in shape)


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


class _StageClock:
    """Per-stage ranges: always a ``torch.profiler.record_function`` span
    (a few microseconds, no sync; a profiler trace reads the stages off
    it), and wall times when the caller asks for them, which synchronizes
    the device at each boundary."""

    def __init__(self, out: Optional[Dict[str, float]], device: torch.device):
        self.out = out
        self.device = device

    @contextlib.contextmanager
    def __call__(self, name: str):
        with torch.profiler.record_function(name):
            with self._timed(name):
                yield

    @contextlib.contextmanager
    def _timed(self, name: str):
        if self.out is None:
            yield
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        yield
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.out[name] = self.out.get(name, 0.0) + time.perf_counter() - t0


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
    apply_A: object           # the CG's operator (fused apply for "cuda")
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


def build_system(state: FluidState, dt, config: SolverConfig = SolverConfig(), *,
                 device="cuda", bboxes=None, pad_levels=None,
                 stage_times: Optional[Dict[str, float]] = None) -> System:
    """Every stage of :func:`solve_viscosity` up to the CG: surface weights,
    octree, labels, stencils, restriction, and the system (operator, rhs,
    Jacobi diagonal).  ``bboxes`` are per-level crop windows for the fused
    apply (from :func:`probe_topology`).  The fused apply routes each level
    by the card's L2 budget (``fused_apply.level_modes`` with
    ``fused_apply.route_budget(device)``)."""
    device = torch.device(device)
    _validate_state(state)
    state = state.to(device=device, dtype=config.dtype)
    clock = _StageClock(stage_times, device)
    dx = state.dx
    extrapolation = config.extrapolation * dx
    orig_res = tuple(state.liquid_sdf.shape)
    levels = capped_levels(orig_res, config.octree_levels)
    lv_pad = levels if pad_levels is None else max(levels, capped_levels(orig_res, pad_levels))
    target = padded_shape(orig_res, lv_pad)
    if target != orig_res:
        state = _pad_state(state, target)
    liquid, solid = state.liquid_sdf, state.solid_sdf
    if bboxes is not None and len(bboxes) != levels:
        raise ValueError(f"bboxes has {len(bboxes)} levels, solve has {levels}; "
                         "pass the level count probe_topology returned")

    with clock("compute_surface_weights"):
        center_w, edge_w = fields.integration_weights(
            liquid, solid, config.num_supersamples, extrapolation, config.apply_solid_weights)
        face_w = fields.face_weights(liquid, solid, config.num_supersamples,
                                     extrapolation, config.apply_solid_weights)

    with clock("build_octree"):
        inner_band = dx * max(2.0, float(config.fine_bandwidth))
        mask = octree.build_refinement_mask(liquid, solid, dx, extrapolation, 3.0 * dx,
                                            inner_band)
        labels = octree.build_octree(mask, levels)

    with clock("build_labels"):
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
    active = {(l, a): vel_kinds[l][a] == classify.FLUID for l in range(levels) for a in range(3)}

    with clock("build_stress_stencils"):
        sdtype = state.viscosity.dtype
        blocks = stencils.build_edge_stress_blocks(
            labels, vel_kinds, edge_kinds, edge_w, state.viscosity, state.solid_velocity,
            dt, dx, config,
        ) + stencils.build_center_stress_blocks(
            labels, vel_kinds, center_kinds, center_w, state.viscosity, state.solid_velocity,
            dt, dx, config,
        )
        mass = stencils.build_mass(labels, vel_kinds, face_w, state.density)

    with clock("restrict_velocity"):
        guess_raw = restriction.restrict_velocity_pyramid(
            [v.to(sdtype) for v in state.velocity], levels)
        zero = torch.zeros((), dtype=sdtype, device=device)
        guess = {k: torch.where(active[k], guess_raw[k], zero) for k in active}

    with clock("build_system"):
        v1_apply, diag = operator.make_operator(blocks, mass, active, res_per_level)
        rhs = operator.boundary_rhs(blocks, mass, guess, active, res_per_level)
        impl = config.apply_impl
        if impl == "auto":
            impl = "cuda" if device.type == "cuda" and sdtype == torch.float32 else "v1"
        if impl == "cuda" and sdtype != torch.float32:
            raise ValueError("apply_impl='cuda' computes in float32; for a float64 solve "
                             "use apply_impl='v1'")
        sys_ = System(state, orig_res, levels, impl, labels, vel_kinds, regular_kinds,
                      res_per_level, active, v1_apply, v1_apply, rhs, guess, diag,
                      blocks=blocks, mass=mass)
        if impl == "cuda":
            modes = fused_apply.level_modes(fused_apply.level_canons(res_per_level, bboxes),
                                            fused_apply.route_budget(device))
            frame, canons = fused_apply.build_frame_data(
                labels, vel_kinds, edge_kinds, center_kinds, blocks, mass, res_per_level,
                bboxes=bboxes, modes=modes)
            sys_.apply_A, sys_.embed_tree, sys_.crop_tree = fused_apply.make_fused_operator(
                frame, canons, active, res_per_level, dx, config.use_enhanced_gradients,
                modes=modes)
            sys_.frame, sys_.canons, sys_.modes = frame, canons, modes
    return sys_


def solve_viscosity(state: FluidState, dt, config: SolverConfig = SolverConfig(), *,
                    device="cuda", bboxes=None, pad_levels=None,
                    stage_times: Optional[Dict[str, float]] = None) -> SolveResult:
    """One viscosity solve (the reference's per-frame solveGasSubclass).

    ``device`` defaults to the card; the state is moved there.  The face
    volume fractions are computed from the SDFs (the JAX package can also
    take them from the host FLIP loop; not ported yet).  ``bboxes``:
    per-level crop windows for the fused apply (``make_solver`` supplies
    them).  ``pad_levels``: pad the domain for this many levels even if
    fewer are solved.  ``stage_times``: a dict that receives per-stage
    seconds (synchronizes at each stage)."""
    device = torch.device(device)
    clock = _StageClock(stage_times, device)
    sys_ = build_system(state, dt, config, device=device, bboxes=bboxes,
                        pad_levels=pad_levels, stage_times=stage_times)
    state, levels = sys_.state, sys_.levels

    with clock("solve"):
        if sys_.impl == "cuda":
            sol_c, iters, rel, applies = operator.pcg_flat(
                sys_.apply_A, sys_.embed_tree(sys_.rhs), sys_.embed_tree(sys_.guess),
                sys_.embed_tree(sys_.diag, fill=1.0), config.tolerance, config.max_iterations)
            solution = sys_.crop_tree(sol_c)
        else:
            solution, iters, rel, applies = operator.pcg_flat(
                sys_.apply_A, sys_.rhs, sys_.guess, sys_.diag, config.tolerance,
                config.max_iterations)

    with clock("interpolate_writeback"):
        interpolated = interpolator.interpolate_writeback_fields(
            sys_.labels, solution, sys_.vel_kinds, levels)

    with clock("writeback"):
        new_velocity = writeback.apply_to_regular_grid(
            state.velocity, solution, sys_.labels, sys_.vel_kinds, sys_.regular_kinds,
            state.solid_velocity, levels, interpolated)
        orig = sys_.orig_res
        if tuple(state.liquid_sdf.shape) != orig:
            new_velocity = [v[tuple(slice(0, orig[d] + (1 if d == a else 0)) for d in range(3))]
                            for a, v in enumerate(new_velocity)]

    if sys_.impl == "cuda":
        path = "cuda" if device.type == "cuda" else "cuda-plain"
    else:
        path = sys_.impl
    counts = torch.stack([sum(m.sum() for m in sys_.active.values()),
                          sum((k == classify.FLUID).sum() for k in sys_.regular_kinds)])
    counts = counts.tolist()
    stats = SolveStats(
        iterations=int(iters),
        residual=float(rel),
        octree_dofs=int(counts[0]),
        regular_dofs=int(counts[1]),
        active_cells=[int(c) for c in octree.active_cell_counts(sys_.labels).tolist()],
        solve_path=path,
        applies=int(applies),
    )
    return SolveResult(velocity=tuple(new_velocity), stats=stats)


# ---------------------------------------------------------------------------
# host-side topology probe and the per-frame solver closure
# ---------------------------------------------------------------------------


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


def make_solver(config: SolverConfig = SolverConfig(), *, device="cuda"):
    """Solve closure ``solve(state, dt, stage_times=None) -> SolveResult``.

    Each call probes the octree occupancy, trims empty top levels and crops
    the fused apply to this frame's occupied windows (the JAX make_solver's
    first-frame behaviour; window hysteresis, the async probe and the
    program cache are not ported yet)."""

    def solve(state: FluidState, dt, stage_times: Optional[Dict[str, float]] = None):
        clock = _StageClock(stage_times, torch.device(device))
        with clock("probe"):
            lv, windows = probe_topology(state, config, device=device)
        cfg = config if lv == config.octree_levels else dataclasses.replace(
            config, octree_levels=lv)
        return solve_viscosity(state, dt, cfg, device=device, bboxes=windows,
                               pad_levels=config.octree_levels, stage_times=stage_times)

    return solve
