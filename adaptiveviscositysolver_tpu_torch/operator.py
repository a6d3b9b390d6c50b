"""Matrix-free application of the viscosity system and its CG solvers
(port of ``operator.py``).

    A u  =  M u  +  D^T (W (D u))
    rhs  =  M guess  -  D^T (W b)
    diag =  M  +  sum_s W_s * coeff_s^2

(the reference's ``(Mu + 2 dt D^T K Mtau U D) u = Mu u^n``,
reference Source/HDK_AdaptiveViscosity.cpp:424).  ``u`` is a dict of
dense face tensors per (level, axis).  This whole-array "v1" operator is
the port's in-package reference for the fused CUDA apply.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from .ops import cg_update
from .ops.arrayops import (
    face_child_sum,
    face_child_sum_adjoint,
    face_shape,
    gather_offset,
    scatter_offset,
    transverse_blocksum,
    upread,
    upread_adjoint,
)
from .stencils import StressBlock, StressTerm
from .utils import cancel, trace

UField = Dict[Tuple[int, int], torch.Tensor]


def _lift(term: StressTerm, u: UField, stress_level: int, res_per_level) -> torch.Tensor:
    src = u[(term.src_level, term.face_axis)]
    fshape = face_shape(res_per_level[stress_level], term.face_axis)
    if term.lift == "same":
        return src
    if term.lift == "parent":
        return upread(src, fshape)
    if term.lift == "childsum":
        return face_child_sum(src, term.face_axis, fshape)
    if term.lift == "blocksum":
        return transverse_blocksum(src, term.face_axis)
    raise ValueError(term.lift)


def _lift_adjoint(term: StressTerm, z: torch.Tensor, res_per_level) -> torch.Tensor:
    src_shape = face_shape(res_per_level[term.src_level], term.face_axis)
    if term.lift == "same":
        return z
    if term.lift == "parent":
        return upread_adjoint(z, src_shape)
    if term.lift == "childsum":
        return face_child_sum_adjoint(z, term.face_axis, src_shape)
    if term.lift == "blocksum":
        return transverse_blocksum(z, term.face_axis)
    raise ValueError(term.lift)


def apply_D(blocks: Sequence[StressBlock], u: UField, res_per_level) -> List[torch.Tensor]:
    """tau_s = sum_t coeff_t * lift_t(u)[. + offset_t] per stress grid."""
    taus = []
    for b in blocks:
        tau = None
        for t in b.terms:
            y = _lift(t, u, b.level, res_per_level)
            contrib = t.coeff * gather_offset(y, t.coeff.shape, t.offset)
            tau = contrib if tau is None else tau + contrib
        taus.append(tau)
    return taus


def apply_DT(blocks: Sequence[StressBlock], taus: Sequence[torch.Tensor],
             u_like: UField, res_per_level) -> UField:
    """u_v += sum_s coeff_{s,v} tau_s (adjoint of :func:`apply_D`)."""
    out = {k: torch.zeros_like(v) for k, v in u_like.items()}
    for b, tau in zip(blocks, taus):
        for t in b.terms:
            fshape = face_shape(res_per_level[b.level], t.face_axis)
            z = scatter_offset(t.coeff * tau, fshape, t.offset)
            key = (t.src_level, t.face_axis)
            out[key] = out[key] + _lift_adjoint(t, z, res_per_level)
    return out


def _masked(active: torch.Tensor, value: torch.Tensor, fill: float) -> torch.Tensor:
    return torch.where(active, value, torch.full((), fill, dtype=value.dtype,
                                                 device=value.device))


def make_operator(blocks: Sequence[StressBlock], mass: UField, active: UField,
                  res_per_level):
    """Return (apply_A, diag): the SPD matvec and its Jacobi diagonal.
    ``active`` are boolean FLUID masks per (level, axis)."""

    def apply_A(u: UField) -> UField:
        taus = apply_D(blocks, u, res_per_level)
        taus = [b.weight * t for b, t in zip(blocks, taus)]
        out = apply_DT(blocks, taus, u, res_per_level)
        return {k: _masked(active[k], out[k] + mass[k] * u[k], 0.0) for k in u}

    diag = {k: torch.zeros_like(v) for k, v in mass.items()}
    for b in blocks:
        for t in b.terms:
            fshape = face_shape(res_per_level[b.level], t.face_axis)
            z = scatter_offset(b.weight * t.coeff * t.coeff, fshape, t.offset)
            key = (t.src_level, t.face_axis)
            diag[key] = diag[key] + _lift_adjoint(t, z, res_per_level)
    diag = {k: _masked(active[k], diag[k] + mass[k], 1.0) for k in mass}
    return apply_A, diag


def boundary_rhs(blocks: Sequence[StressBlock], mass: UField, guess: UField,
                 active: UField, res_per_level) -> UField:
    """rhs = M guess - D^T (W b) (cpp:2453-2456, 2772)."""
    taus = [b.weight * b.boundary if b.boundary is not None else torch.zeros_like(b.weight)
            for b in blocks]
    bt = apply_DT(blocks, taus, mass, res_per_level)
    return {k: _masked(active[k], mass[k] * guess[k] - bt[k], 0.0) for k in mass}


# ---------------------------------------------------------------------------
# CG over one flat vector
# ---------------------------------------------------------------------------


def make_packer(shapes: Dict[Tuple[int, int], Tuple[int, int, int]]):
    """(pack, unpack) between a dict of grids and one flat vector, keys in
    sorted order; unpack returns views (no copy)."""
    keys = sorted(shapes)
    sizes = [math.prod(shapes[k]) for k in keys]
    offsets = [0]
    for s in sizes:
        offsets.append(offsets[-1] + s)

    def pack(tree: UField) -> torch.Tensor:
        return torch.cat([tree[k].reshape(-1) for k in keys])

    def unpack(flat: torch.Tensor) -> UField:
        return {k: flat[offsets[i]:offsets[i + 1]].view(shapes[k])
                for i, k in enumerate(keys)}

    return pack, unpack


def _above(rr: torch.Tensor, threshold: torch.Tensor) -> bool:
    """The CG's stop test, read back: the host waits here for the device."""
    with trace.span("cg.converged"):
        return bool(rr > threshold)


def _fuses(b: torch.Tensor, precond: Optional[Callable], dot: Callable) -> bool:
    """Whether :func:`_flat_pcg` runs :func:`_fused_jacobi_pcg`, whose
    vector update runs in the kernels of ``ops/cg_update.py``: a float32
    ``b`` on the card, Jacobi and ``torch.dot``."""
    return (b.device.type == "cuda" and b.dtype == torch.float32 and precond is None
            and dot is torch.dot)


def _flat_pcg(A: Callable[[torch.Tensor], torch.Tensor], b: torch.Tensor,
              x0: torch.Tensor, invd: torch.Tensor, threshold: torch.Tensor,
              max_iterations: int, precond: Optional[Callable] = None, cancel_poll: int = 0,
              dot: Callable = torch.dot):
    """Flat-vector PCG: iterate while ``||r||^2 > threshold`` (tested before
    each iteration, as the JAX ``while_loop`` does; reading the test costs
    one host sync per iteration).  ``precond`` replaces the Jacobi ``z =
    invd * r`` with any fixed SPD map (:func:`make_chebyshev_precond`).
    ``cancel_poll > 0``: every that-many iterations, after the increment,
    read ``utils.cancel``'s flag and stop before the next iteration when it
    is set.  ``dot``: the inner product (a sharded solve's sums the ranks'
    local dots: parallel/shard_fused.py); 3 + 3 per iteration.  Spans
    (``utils/trace.py``): ``cg.converged`` around each stop test, and per
    iteration ``cg.vector`` twice and ``cg.precond`` once, sampled for the
    profiler as a :class:`trace.loop`.  A float32 Jacobi CG on the card
    runs :func:`_fused_jacobi_pcg` (:func:`_fuses`).  Returns (x,
    iterations, ||r||^2); ``x0`` and ``b`` are not written."""
    if _fuses(b, precond, dot):
        return _fused_jacobi_pcg(A, b, x0, invd, threshold, max_iterations, cancel_poll)
    if precond is None:
        def precond(r):
            return invd * r
    r = b - A(x0)
    rr = dot(r, r)
    z = precond(r)
    rz = dot(r, z)
    p = z
    x = x0
    it = 0
    with trace.loop() as lp:
        while it < max_iterations and _above(rr, threshold):
            ap = A(p)
            with trace.span("cg.vector"):
                alpha = rz / dot(p, ap)
                x = x + alpha * p
                r = r - alpha * ap
                rr = dot(r, r)
            with trace.span("cg.precond"):
                z = precond(r)
            with trace.span("cg.vector"):
                rz_new = dot(r, z)
                p = z + (rz_new / rz) * p
                rz = rz_new
            it += 1
            lp.at(it)
            if cancel_poll > 0 and it % cancel_poll == 0 and cancel.is_requested():
                break
    return x, it, rr


def _fused_jacobi_pcg(A: Callable[[torch.Tensor], torch.Tensor], b: torch.Tensor,
                      x0: torch.Tensor, invd: torch.Tensor, threshold: torch.Tensor,
                      max_iterations: int, cancel_poll: int):
    """:func:`_flat_pcg`'s Jacobi loop with its vector work in the three
    kernels of ``ops/cg_update.py``: x, r, z and p allocated once and
    updated in place, alpha and beta formed on the device, rr and rz kept
    in device scalars (rz in two that swap, as ``cg_direction`` reads one
    and writes the other), the cross-block sums finished by the kernel
    that reads them.  An iteration makes 14 passes over the vector and
    4 launches beside the apply: ``dot(p, ap)``, ``cg_update``,
    ``cg_jacobi``, ``cg_direction``.  The same recurrence, order of updates,
    stop test and spans as the loop of :func:`_flat_pcg`, and ``cg.update``
    around each ``cg_update`` inside the first ``cg.vector``; the sums
    round otherwise."""
    x = x0.clone()
    r = b - A(x0)
    z = torch.empty_like(r)
    p = torch.empty_like(r)
    scalars = torch.empty(3, dtype=r.dtype, device=r.device)
    rr, rz, rz_next = scalars.unbind()
    rr.copy_(torch.dot(r, r))
    torch.mul(invd, r, out=z)
    rz.copy_(torch.dot(r, z))
    p.copy_(z)
    rr_part = cg_update.partials(r.numel(), r.device)
    rz_part = torch.zeros_like(rr_part)
    it = 0
    with trace.loop() as lp:
        while it < max_iterations and _above(rr, threshold):
            ap = A(p)
            with trace.span("cg.vector"):
                pap = torch.dot(p, ap)
                with trace.span("cg.update"):
                    cg_update.cg_update(x, r, p, ap, rz, pap, rr_part)
            with trace.span("cg.precond"):
                cg_update.cg_jacobi(r, invd, z, rz_part)
            with trace.span("cg.vector"):
                cg_update.cg_direction(z, p, rr_part, rz_part, rz, rr, rz_next)
                rz, rz_next = rz_next, rz
            it += 1
            lp.at(it)
            if cancel_poll > 0 and it % cancel_poll == 0 and cancel.is_requested():
                break
    return x, it, rr


def estimate_lambda_max(A, invd: torch.Tensor, v0: torch.Tensor, iters: int = 12,
                        dot: Callable = torch.dot):
    """Largest eigenvalue of the Jacobi-scaled operator ``invd * A`` by
    ``iters`` power iterations, as the Rayleigh quotient in the D inner
    product (a lower bound until converged: callers pad it).  ``iters`` + 1
    applies and ``iters`` + 3 ``dot``s; no host read on one device."""
    eps = torch.tensor(1e-30, dtype=v0.dtype, device=v0.device)
    v = v0 * torch.rsqrt(dot(v0, v0) + eps)
    for _ in range(iters):
        w = invd * A(v)
        v = w * torch.rsqrt(dot(w, w) + eps)
    av = A(v)
    return dot(v, av) / (dot(v, v / invd) + eps)


def make_chebyshev_precond(A, invd: torch.Tensor, lam_max, degree: int,
                           lam_min_ratio: float = 1.0 / 30.0):
    """Fixed SPD Chebyshev polynomial preconditioner ``z ~= A^-1 r``:
    ``degree`` semi-iterations on the Jacobi-scaled system from a zero
    guess, on ``[lam_min_ratio * lam_max, lam_max]`` (``degree`` - 1
    applies per call).  Odd degrees only (an even one is raised by one):
    for an eigenvalue above ``lam_max`` an odd polynomial stays positive,
    an even one goes indefinite.  ``lam_max`` is padded by 5 % (the power
    iteration's estimate is a lower bound)."""
    if degree % 2 == 0:
        degree += 1
    lam_max = lam_max * 1.05
    a = lam_min_ratio * lam_max
    b = lam_max
    theta = 0.5 * (b + a)
    delta = 0.5 * (b - a)
    sigma = theta / delta

    def precond(r):
        z = (1.0 / theta) * (invd * r)
        d = z
        rho = 1.0 / sigma
        for _ in range(degree - 1):
            rho_new = 1.0 / (2.0 * sigma - rho)
            d = (rho_new * rho) * d + (2.0 * rho_new / delta) * (invd * (r - A(z)))
            z = z + d
            rho = rho_new
        return z

    return precond


class _CaptureHome:
    """Per device: the side stream every capture runs on, and the graph of
    the last capture, kept (never replayed again) for its memory pool.  The
    next capture shares that pool on the same stream, so it reuses the
    blocks of the last one: the memory the graphs reserve stays one apply's
    transients.  A pool of its own per capture would stay reserved after
    its graph is dropped (the caching allocator returns a dropped pool only
    on ``empty_cache`` or when an allocation outside a capture fails), so
    the reserved memory would grow by one apply's transients a dispatch.
    Captures sharing a pool must not replay at once: the solves on a device
    replay on one stream, one after the other."""

    def __init__(self, device: torch.device):
        self.stream = torch.cuda.Stream(device)
        self.graph: Optional[torch.cuda.CUDAGraph] = None


_capture_homes: Dict[torch.device, _CaptureHome] = {}


class ApplyGraph:
    """A flat apply ``fn`` (flat vector -> flat vector, CUDA tensors)
    replayed from one CUDA graph.  The first call runs ``fn`` eagerly (it
    loads the kernels' libraries and sets their attributes); the second
    captures ``fn`` on the device's side stream into a graph in the pool of
    the device's last capture (:class:`_CaptureHome`), then replays it;
    every later call replays: the input copied into the graph's static
    input and one graph launch.  Each replay returns the graph's static
    output, which the next replay overwrites.  ``counts``: the launch
    counters that ``fn``'s kernel wrappers add to
    (``fused_apply.launch_counts``); what the capture added is taken back
    and added again by every replay, so they count the launches the device
    runs.  Spans (``utils/trace.py``): ``apply.capture`` around the
    capture, ``apply.replay`` around each copy and replay.
    :meth:`release` drops the graph's buffers; only the device's last
    capture stays held, for its pool."""

    def __init__(self, fn: Callable[[torch.Tensor], torch.Tensor], counts: Dict[str, int]):
        self.fn = fn
        self.counts = counts
        self.calls = 0
        self.graph = self.static_in = self.static_out = None
        self.launches: Dict[str, int] = {}

    def __call__(self, flat: torch.Tensor) -> torch.Tensor:
        self.calls += 1
        if self.calls == 1:
            return self.fn(flat)
        if self.graph is None:
            with trace.span("apply.capture"):
                self._capture(flat)
        with trace.span("apply.replay"):
            self.static_in.copy_(flat)
            self.graph.replay()
            for k, n in self.launches.items():
                self.counts[k] += n
        return self.static_out

    def _capture(self, flat: torch.Tensor) -> None:
        before = dict(self.counts)
        self.static_in = torch.empty_like(flat)
        home = _capture_homes.get(flat.device)
        if home is None:
            home = _capture_homes[flat.device] = _CaptureHome(flat.device)
        graph = torch.cuda.CUDAGraph()
        # not torch.cuda.graph: it synchronizes and empties the cache on entry
        with torch.cuda.stream(home.stream):
            graph.capture_begin(pool=None if home.graph is None else home.graph.pool())
            try:
                self.static_out = self.fn(self.static_in)
            finally:
                graph.capture_end()
        self.graph = home.graph = graph
        self.launches = {k: n - before.get(k, 0) for k, n in self.counts.items()}
        self.counts.update(before)

    def release(self) -> None:
        self.graph = self.static_in = self.static_out = None


def pcg_flat(apply_A, rhs: UField, x0: UField, diag: UField, tolerance: float,
             max_iterations: int, cheb_degree: int = 1, cancel_poll: int = 0):
    """PCG with flat-vector state; ``apply_A`` maps grid dicts to grid
    dicts.  Stops when ||r||_2 <= tol * ||b||_2 (Eigen's rule,
    cpp:611-631).  ``cheb_degree > 1``: the degree-k Chebyshev
    preconditioner on a power-iteration lam_max started from ``b``
    (13 applies once), so a solve makes 13 + 1 + (k - 1) + iterations * k
    applies; Jacobi makes 1 + iterations.  ``cancel_poll``: see
    :func:`_flat_pcg`.  An ``apply_A`` marked ``capturable`` (the fused
    apply's card kernels, ``ops/fused_apply.py``) runs as an
    :class:`ApplyGraph` over its ``launch_counts``, released on return.
    The flat apply's result may then be the buffer that the next apply
    overwrites: no caller keeps it across the next apply (the CG, the
    Chebyshev preconditioner and the lam_max estimate use it at once).
    Returns (x, iterations, relative residual, applies)."""
    shapes = {k: tuple(v.shape) for k, v in rhs.items()}
    pack, unpack = make_packer(shapes)
    applies = 0

    def flat_apply(flat):
        return pack(apply_A(unpack(flat)))

    graph = None
    if getattr(apply_A, "capturable", False):
        graph = ApplyGraph(flat_apply, apply_A.launch_counts)
    run = flat_apply if graph is None else graph

    def A(flat):
        nonlocal applies
        applies += 1
        with trace.span("cg.apply"):
            return run(flat)

    try:
        b = pack(rhs)
        invd = 1.0 / pack(diag)
        b_norm2 = torch.dot(b, b)
        threshold = tolerance * tolerance * b_norm2
        precond = None
        if cheb_degree > 1:
            lam = estimate_lambda_max(A, invd, b)
            precond = make_chebyshev_precond(A, invd, lam, cheb_degree)
        x, iters, rr = _flat_pcg(A, b, pack(x0), invd, threshold, max_iterations,
                                 precond=precond, cancel_poll=cancel_poll)
    finally:
        if graph is not None:
            graph.release()
    rel = torch.sqrt(rr / b_norm2.clamp_min(1e-300))
    return unpack(x), iters, rel, applies


def pcg_refined(apply_A_hi, apply_A_lo, rhs: UField, x0: UField, diag: UField,
                tolerance: float, max_iterations: int, inner_tolerance: float = 1e-4,
                max_outer: int = 40, embed_tree=None, crop_tree=None):
    """Mixed precision: float32 Jacobi-CG inner solves of ``A d = r``
    inside an iterative-refinement loop that forms ``r = b - A x`` in the
    rhs's dtype, until ||r||_2 <= tol * ||b||_2 there, ``max_iterations``
    inner iterations in all, or ``max_outer`` passes.  Each inner solve
    stops at ``inner_tolerance`` relative to its own rhs.  ``apply_A_hi``
    acts on rhs-dtype grid dicts, ``apply_A_lo`` on float32 ones: of the
    rhs's shapes, or, given the fused apply's ``embed_tree`` and
    ``crop_tree`` (``ops/fused_apply.py``), canonical ones.  Then each
    pass embeds its residual once and crops its correction once, and an
    ``apply_A_lo`` marked ``capturable`` runs as one :class:`ApplyGraph`
    that every pass's CG replays, released on return (the contract of
    :func:`pcg_flat`).  Spans (``utils/trace.py``): ``refine.residual``
    around each residual (passes + 1), ``refine.inner`` around each
    pass's inner solve, ``cg.apply`` around each inner apply.  Returns
    (x, total inner iterations, relative residual, applies of both)."""
    shapes = {k: tuple(v.shape) for k, v in rhs.items()}
    pack, unpack = make_packer(shapes)
    lo = torch.float32
    applies = 0
    if embed_tree is None:
        pack_lo, unpack_lo = pack, unpack
        invd_lo = (1.0 / pack(diag)).to(lo)
    else:
        diag_c = embed_tree(diag, fill=1.0)
        pack_lo, unpack_lo = make_packer({k: tuple(v.shape) for k, v in diag_c.items()})
        invd_lo = 1.0 / pack_lo(diag_c)

    def flat_lo(flat):
        return pack_lo(apply_A_lo(unpack_lo(flat)))

    graph = None
    if getattr(apply_A_lo, "capturable", False):
        graph = ApplyGraph(flat_lo, apply_A_lo.launch_counts)
    run = flat_lo if graph is None else graph

    def A_lo(flat):
        nonlocal applies
        applies += 1
        with trace.span("cg.apply"):
            return run(flat)

    b = pack(rhs)
    hi = b.dtype

    def residual(x):
        nonlocal applies
        applies += 1
        with trace.span("refine.residual"):
            return b - pack(apply_A_hi(unpack(x)))

    x = pack(x0)
    b_norm2 = torch.dot(b, b)
    threshold = tolerance * tolerance * b_norm2
    itol2 = torch.tensor(inner_tolerance, dtype=lo, device=b.device) ** 2
    try:
        r = residual(x)
        total = outer = 0
        while _above(torch.dot(r, r), threshold) and total < max_iterations and outer < max_outer:
            with trace.span("refine.inner"):
                r_lo = r.to(lo)
                if embed_tree is not None:
                    r_lo = pack_lo(embed_tree(unpack(r_lo)))
                d, it, _ = _flat_pcg(A_lo, r_lo, torch.zeros_like(r_lo), invd_lo,
                                     itol2 * torch.dot(r_lo, r_lo), max_iterations - total)
                if crop_tree is not None:
                    d = pack(crop_tree(unpack_lo(d)))
                x = x + d.to(hi)
            r = residual(x)
            total += it
            outer += 1
    finally:
        if graph is not None:
            graph.release()
    rel = torch.sqrt(torch.dot(r, r) / b_norm2.clamp_min(1e-300))
    return unpack(x), total, rel, applies
