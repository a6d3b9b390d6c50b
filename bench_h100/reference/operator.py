"""Matrix-free application of the viscosity system and its Jacobi CG
(port of ``operator.py``).

    A u  =  M u  +  D^T (W (D u))
    rhs  =  M guess  -  D^T (W b)
    diag =  M  +  sum_s W_s * coeff_s^2

(the reference's ``(Mu + 2 dt D^T K Mtau U D) u = Mu u^n``,
reference Source/HDK_AdaptiveViscosity.cpp:424).  ``u`` is a dict of
dense face tensors per (level, axis): the whole-array "v1" operator.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch

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


def _graphed(fn, example: torch.Tensor):
    """``fn`` (flat vector -> flat vector, no host reads) as one CUDA graph
    replay: the whole-array apply is hundreds of small launches.  The
    returned vector is a buffer the next call overwrites."""
    static_in = example.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(static_in)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static_out = fn(static_in)

    def run(x: torch.Tensor) -> torch.Tensor:
        static_in.copy_(x)
        graph.replay()
        return static_out

    return run


def pcg_jacobi(apply_A, rhs: UField, x0: UField, diag: UField, tolerance: float,
               max_iterations: int):
    """Jacobi PCG with flat-vector state; ``apply_A`` maps grid dicts to
    grid dicts.  Iterates while ``||r||^2 > tol^2 ||b||^2`` (Eigen's rule,
    cpp:611-631), tested before each iteration.  Every vector and scalar
    stays in the rhs's dtype.  On a card the apply runs as a CUDA graph
    (the same kernels, launched at once).  Returns (x, iterations, relative residual)."""
    shapes = {k: tuple(v.shape) for k, v in rhs.items()}
    pack, unpack = make_packer(shapes)

    def A(flat):
        return pack(apply_A(unpack(flat)))

    b = pack(rhs)
    if b.is_cuda:
        A = _graphed(A, b)
    invd = 1.0 / pack(diag)
    b_norm2 = torch.dot(b, b)
    threshold = tolerance * tolerance * b_norm2
    x = pack(x0)
    r = b - A(x)
    rr = torch.dot(r, r)
    z = invd * r
    rz = torch.dot(r, z)
    p = z
    it = 0
    while it < max_iterations and bool(rr > threshold):
        ap = A(p)
        alpha = rz / torch.dot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        rr = torch.dot(r, r)
        z = invd * r
        rz_new = torch.dot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
        it += 1
    rel = torch.sqrt(rr.double() / b_norm2.double().clamp_min(1e-300))
    return unpack(x), it, float(rel)
