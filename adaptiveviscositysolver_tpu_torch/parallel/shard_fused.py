"""The multi-device CG over ``torch.distributed``: x-slabs, halo exchange
by paired send/recv, all-reduced dots (port of
``parallel/shard_pallas.py``, named as ``ops/fused_apply`` is for
``ops/pallas_apply``).

* **Domain decomposition**: the x axis of every level is split into ``n``
  equal slabs of ``w_l`` cells, one per rank of a 1-D group
  (:class:`..parallel.mesh.Mesh`).  Every x-staggered array (x faces, y/z
  edges: extent ``nx + 1``) is carried *ghost-blocked*: a rank holds its
  ``w`` owned rows plus one ghost row, the right neighbour's first face
  (on the last rank the closing face, which it owns), so the rank's
  arrays form a local MAC problem on which the port's kernels run
  unchanged (B6: ``_sharded_apply`` runs ``fused_apply``'s routed level
  pass on each rank's local canonical boxes).
* **Halo**: a local box has an x pad of ``fused_apply.HALO_X`` (4) rows,
  the port's own reach, not the JAX package's ``MAX_HALO`` constant.  The
  range reach is 4: Dᵀ on a slab reads weighted stresses one row past it,
  the even τ range that covers them reaches one row further, and τ reads
  u 2 rows below and 1 above its range (rounded up to even).  Sample by
  sample an owned row reads u only 2 rows away
  (``test_owned_rows_read_two_rows_past_the_slab``).  The pads are
  filled with the neighbours' rows: once per frame for the packed kind
  bytes and the weights, once per apply for the iterate and the
  cross-level views, into the apply's scratch (never the CG's vectors,
  whose ghost rows stay 0).
  A slab narrower than the halo (JAX admits top widths of 1 and lower
  widths of 2) takes its rows from as many ranks as they lie on: ``ceil(
  HALO_X / w)`` hops each side.  Stress rows near a slab edge are computed
  by both neighbours; no output is exchanged.
* **Reductions**: a dot is the local ``torch.dot`` summed over the group
  (``all_reduce``).

On a gloo group with CUDA tensors (several ranks sharing one card, where
NCCL refuses) every transfer goes through host memory; on an NCCL group
(one card per rank; not run so far) the tensors go as they are.  Each
rank counts what it sends and sums in :data:`collective_counts`.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import operator
from ..ops import fused_apply as fa
from ..ops.arrayops import face_shape, upread

UField = Dict[Tuple[int, int], torch.Tensor]
HALO = fa.HALO_X

# per rank: one-way transfers (one array shifted one hop in one direction,
# as one JAX ppermute), all-reduces, all-gathers; and the host seconds spent
# in them (the device synchronized first, so the time is the transfer's)
collective_counts = {"exchanges": 0, "allreduces": 0, "gathers": 0}
collective_seconds = {"exchanges": 0.0, "allreduces": 0.0, "gathers": 0.0}


def reset_collective_counts() -> None:
    for k in collective_counts:
        collective_counts[k] = 0
        collective_seconds[k] = 0.0


# ---------------------------------------------------------------------------
# shardability + ghost-blocked layout
# ---------------------------------------------------------------------------


def shardable_levels(res_per_level: Sequence[Tuple[int, int, int]], n: int) -> bool:
    """True iff the level pyramid admits the 1-D x decomposition over ``n``
    ranks: ``n | nx_l`` on every level, even local widths below the top
    (parity-dependent stencil cases need local parity == global parity;
    the top level has no coarse transitions, cpp:1301-1319), widths >= 1.
    Narrow slabs are admitted as in the JAX package: the halo takes as
    many hops as it needs."""
    levels = len(res_per_level)
    for l, res in enumerate(res_per_level):
        if res[0] % n != 0:
            return False
        w = res[0] // n
        if (l < levels - 1 and w % 2 != 0) or w < 1:
            return False
    return True


def _is_staggered_x(shape, nx: int) -> bool:
    return shape[0] == nx + 1


def block_x(arr, nx: int, n: int):
    """Ghost-blocked form of an x-staggered array: block ``d`` holds global
    rows ``[d*w, d*w + w]`` inclusive (its ``w`` owned faces plus one ghost
    row).  Cell-extent arrays pass through unchanged (they split evenly).
    Takes numpy arrays or tensors."""
    if not _is_staggered_x(arr.shape, nx):
        assert arr.shape[0] == nx, (arr.shape, nx)
        return arr
    w = nx // n
    idx = np.concatenate([np.arange(d * w, d * w + w + 1) for d in range(n)])
    return arr[idx] if isinstance(arr, np.ndarray) else arr[torch.as_tensor(idx)]


def unblock_x(arr, nx: int, n: int):
    """Inverse of :func:`block_x` (owned rows + the final closing face)."""
    w = nx // n
    if arr.shape[0] == nx:
        return arr
    assert arr.shape[0] == n * (w + 1), (arr.shape, nx, n)
    parts = [arr[d * (w + 1): d * (w + 1) + w] for d in range(n)] + [arr[-1:]]
    return np.concatenate(parts) if isinstance(arr, np.ndarray) else torch.cat(parts)


def local_block(arr: torch.Tensor, nx: int, rank: int, n: int) -> torch.Tensor:
    """Rank ``rank``'s block of a global array in the ghost-blocked layout
    (:func:`block_x`'s block ``rank``)."""
    w = nx // n
    stag = int(_is_staggered_x(arr.shape, nx))
    assert arr.shape[0] == nx + stag, (arr.shape, nx)
    return arr[rank * w: rank * w + w + stag]


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


def _sync(mesh) -> None:
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)


def _exchange(mesh, sends: Dict[int, torch.Tensor], recvs: Dict[int, Tuple[int, torch.dtype]]
              ) -> Dict[int, torch.Tensor]:
    """Paired send/recv with other ranks of the group, all posted together
    (the counterpart of the JAX ``_from_left``/``_from_right`` ppermutes):
    ``sends[peer]`` (flat) goes to rank ``peer``; a flat tensor of
    ``recvs[peer] = (numel, dtype)`` comes from it.  Through host memory
    where the group cannot take the device's tensors."""
    staged = mesh.staged
    ops, got = [], {}
    for peer, t in sends.items():
        ops.append(dist.P2POp(dist.isend, t.cpu() if staged else t.contiguous(), peer))
    for peer, (numel, dtype) in recvs.items():
        got[peer] = torch.empty(numel, dtype=dtype, device="cpu" if staged else mesh.device)
        ops.append(dist.P2POp(dist.irecv, got[peer], peer))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return {p: t.to(mesh.device) for p, t in got.items()} if staged else got


def all_reduce_sum(mesh, x: torch.Tensor) -> torch.Tensor:
    """``x`` (0-d) summed over the group: one all-reduce (the JAX
    ``lax.psum``)."""
    collective_counts["allreduces"] += 1
    if mesh.size == 1:
        return x
    _sync(mesh)
    t0 = time.perf_counter()
    t = x.reshape(1).to("cpu" if mesh.staged else x.device, copy=True)
    dist.all_reduce(t)
    out = t.to(x.device).reshape(())
    collective_seconds["allreduces"] += time.perf_counter() - t0
    return out


def all_gather_rows(mesh, parts: Sequence[torch.Tensor]) -> List[List[torch.Tensor]]:
    """Every rank's ``parts`` (the same shapes and dtype on every rank), in
    one all-gather of their concatenation: ``out[rank][i]``."""
    collective_counts["gathers"] += 1
    _sync(mesh)
    t0 = time.perf_counter()
    flat = torch.cat([p.reshape(-1) for p in parts])
    if mesh.staged:
        flat = flat.cpu()
    got = [torch.empty_like(flat) for _ in range(mesh.size)]
    dist.all_gather(got, flat)
    sizes = [p.numel() for p in parts]
    out = [[piece.view(p.shape).to(mesh.device) for piece, p in zip(g.split(sizes), parts)]
           for g in got]
    collective_seconds["gathers"] += time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# halo exchange on local canonical boxes
# ---------------------------------------------------------------------------


class HaloPlan:
    """The x halos of one rank's local boxes (the counterpart of the JAX
    ``fill_halo_canon`` and ``_embed_halo``, for many boxes in one round of
    messages): level ``l`` has slabs of
    ``widths[l]`` cells and boxes ``canons[l]`` (x pad HALO_X).  A rank's
    pad rows below its first row are global rows ``[d w - H, d w)``, those
    from its ghost row up ``[(d + 1) w, (d + 1) w + H)``; they lie on the
    ranks ``d - k`` and ``d + k``, ``k = 1 .. hops``, ``hops = min(ceil(H /
    w), n - 1)``.  Rows past the domain keep the box's fill (zeros, OUTSIDE
    kinds), as a single-device box's pads do; the last rank's closing face
    row is its own."""

    def __init__(self, mesh, widths: Sequence[int], canons: Sequence[fa.Canon]):
        self.mesh = mesh
        self.widths = list(widths)
        self.ox = [c.off[0] for c in canons]
        for c in canons:
            if c.off[0] < HALO:
                raise ValueError(f"a local box needs an x pad of {HALO}, got {c.off[0]}")
        self.hops = [min(math.ceil(HALO / w), mesh.size - 1) for w in widths]

    def _rows_to_left(self, l: int, k: int, src: int) -> int:
        """Rows [0, r) of rank ``src`` that its rank ``src - k`` takes into
        its right halo (the last rank's closing face row included)."""
        w = self.widths[l]
        return min(w + int(src == self.mesh.size - 1), HALO - (k - 1) * w)

    def fill(self, boxes: Sequence[Tuple[torch.Tensor, int]]) -> None:
        """Fill the x halos of ``boxes`` ((box, level) pairs, one dtype) in
        place: one message to and from each rank up to the most hops away;
        ``2 * hops[level]`` one-way transfers counted per box."""
        mesh = self.mesh
        if mesh.size == 1 or not boxes:
            return
        _sync(mesh)
        t0 = time.perf_counter()
        d, n = mesh.rank, mesh.size
        dtype = boxes[0][0].dtype
        sends, recvs, places = {}, {}, {}
        for k in range(1, max(self.hops[l] for _, l in boxes) + 1):
            to_r, to_l, from_l, from_r = [], [], [], []
            for box, l in boxes:
                if k > self.hops[l]:
                    continue
                w, ox = self.widths[l], self.ox[l]
                lo = max(0, k * w - HALO)
                if d + k < n:       # my rows [lo, w) fill rank d + k's left halo
                    to_r.append(box[ox + lo: ox + w])
                if d - k >= 0:      # my first rows fill rank d - k's right halo
                    to_l.append(box[ox: ox + self._rows_to_left(l, k, d)])
                    from_l.append(box[ox - k * w + lo: ox - k * w + w])
                if d + k < n:
                    from_r.append(box[ox + k * w: ox + k * w + self._rows_to_left(l, k, d + k)])
            for peer, out, into in ((d + k, to_r, from_r), (d - k, to_l, from_l)):
                if out:
                    sends[peer] = torch.cat([t.reshape(-1) for t in out])
                    recvs[peer] = (sum(t.numel() for t in into), dtype)
                    places[peer] = into
        got = _exchange(mesh, sends, recvs)
        for peer, into in places.items():
            for dst, piece in zip(into, got[peer].split([t.numel() for t in into])):
                dst.copy_(piece.view(dst.shape))
        collective_counts["exchanges"] += sum(2 * self.hops[l] for _, l in boxes)
        collective_seconds["exchanges"] += time.perf_counter() - t0


# ---------------------------------------------------------------------------
# the sharded CG stage
# ---------------------------------------------------------------------------


def local_canons(res_local: Sequence[Tuple[int, int, int]]) -> List[fa.Canon]:
    """A rank's local boxes: whole local levels, x pad HALO_X."""
    return [fa.make_canon(r, pad_x=HALO) for r in res_local]


def stress_weights(blocks, levels: int):
    """(we, wc): the edge-stress weights per (level, axis) and the center
    weights per level of the stress blocks, the arrays the kernels read."""
    we = {(b.level, b.axis): b.weight for b in blocks if b.kind == "edge"}
    wc = {}
    for b in blocks:
        if b.kind == "center":
            wc.setdefault(b.level, b.weight)
    return we, [wc[l] for l in range(levels)]


def local_routes(res_per_level, mesh) -> Tuple[List[fa.Canon], list]:
    """This rank's routed local boxes and their routes for a global
    pyramid: ``fused_apply.level_modes`` on :func:`local_canons` with
    ``mesh.budget`` (default: ``fused_apply.route_budget`` of the rank's
    device)."""
    canons = local_canons([(r[0] // mesh.size, r[1], r[2]) for r in res_per_level])
    budget = fa.route_budget(mesh.device) if mesh.budget is None else mesh.budget
    modes = fa.level_modes(canons, budget)
    return fa.route_canons(canons, modes), modes


def _local_frame_data(vel_kinds, edge_kinds, center_kinds, we, wc, mass, res_local, canons,
                      halo: HaloPlan) -> Dict[str, torch.Tensor]:
    """Per-rank analog of ``fused_apply.build_frame_data`` on the rank's
    blocked arrays: the same embedding and packing, then the x halos of
    the packed kind bytes and of the weights filled from the neighbours.
    Filling the packed bytes, not each kind grid before packing as the
    JAX package does, gives every slot the neighbour's real row (a cell
    grid's row past a staggered one's ghost too) in 3 or 4 exchanges per
    level instead of 7 or 10.  The mass is read on owned rows only."""
    levels = len(res_local)
    data: Dict[str, torch.Tensor] = {}
    kind_boxes, weight_boxes = [], []
    for l in range(levels):
        c = canons[l]
        kinds = {f"vk{f}": vel_kinds[l][f] for f in range(3)}
        kinds.update({f"ek{a}": edge_kinds[l][a] for a in range(3)})
        kinds["ck"] = center_kinds[l]
        if l + 1 < levels:
            for f in range(3):
                kinds[f"pk{f}"] = upread(vel_kinds[l + 1][f], face_shape(res_local[l], f))
        for g, packed in enumerate(fa.pack_kinds(kinds, c, l, levels)):
            data[f"kp{g}_{l}"] = packed
            kind_boxes.append((packed, l))
        for f in range(3):
            data[f"m{f}_{l}"] = fa.embed(mass[(l, f)].to(fa.F32), c, 0.0)
        for a in range(3):
            data[f"we{a}_{l}"] = fa.embed(we[(l, a)].to(fa.F32), c, 0.0)
            weight_boxes.append((data[f"we{a}_{l}"], l))
        data[f"wc_{l}"] = fa.embed(wc[l].to(fa.F32), c, 0.0)
        weight_boxes.append((data[f"wc_{l}"], l))
    halo.fill(kind_boxes)
    halo.fill(weight_boxes)
    return data


def _sharded_apply(run, canons, halo: HaloPlan, active_c: UField, own: UField, window: UField):
    """apply_A on a rank's local canonical grids (B6): the cross-level
    views of the iterate (right on the owned rows, the slabs of every
    level being aligned), then the halos of the iterate and of the views,
    filled into the apply's scratch in one exchange, then ``run`` (the
    routed level pass on the local boxes: ``fused_tau``/``fused_dt`` or
    the ``tau_level``/``dt_level`` pairs and bricks), then the cross-level
    adjoints of ``zp``/``zc`` cropped to the local grids (their pad rows
    hold terms of the neighbours' faces), and the ownership mask."""
    levels = len(canons)

    def level_args(u: UField) -> List[Dict[str, torch.Tensor]]:
        views = fa.cross_level_views(u, canons)
        uh = {k: v.clone() for k, v in u.items()}
        halo.fill([(uh[k], k[0]) for k in sorted(uh)]
                  + [(v, l) for (_, l, _), v in sorted(views.items())])
        args = []
        for l in range(levels):
            a = dict(run.static[l])
            a.update({f"u{f}": uh[(l, f)] for f in range(3)})
            a.update({f"{name}{f}": v for (name, vl, f), v in views.items() if vl == l})
            args.append(a)
        return args

    def apply_A(u: UField) -> UField:
        outs = fa.join_levels(run(level_args(u)), canons, active_c, window=window)
        # ownership: zero the ghost rows (the right neighbour owns them) so
        # that the all-reduced dots count every DOF once
        return {k: outs[k] * own[k] for k in outs}

    apply_A.level_args = level_args   # the kernels' inputs of one apply (collective)
    return apply_A


def sharded_operator(mesh, vel_kinds, edge_kinds, center_kinds, we, wc, mass: UField,
                     active: UField, res_per_level, dx: float, enhanced: bool):
    """This rank's part of the sharded operator, from the GLOBAL per-level
    grids that every rank holds (the pre-CG stages run on every rank):
    ``(apply_A, embed_tree, gather_tree)``.  ``apply_A`` maps the rank's
    local canonical grids to the same (:func:`_sharded_apply`, its frame
    halo-filled here: one exchange of kinds and one of weights);
    ``embed_tree(tree, fill=0.0)`` takes the rank's ghost-blocked slab of
    a global tree into its boxes, ``fill`` on the pads and on the ghost rows
    it does not own; ``gather_tree`` all-gathers the owned rows back into
    global grids, on every rank.  The routes come from ``mesh.budget``
    (default: ``fused_apply.route_budget`` of the rank's device) on the
    local boxes (``apply_A.modes``).  Raises if the pyramid does not admit
    the decomposition."""
    n, rank = mesh.size, mesh.rank
    levels = len(res_per_level)
    if not shardable_levels(res_per_level, n):
        raise ValueError(f"levels {list(res_per_level)} do not split into {n} x-slabs (n | nx "
                         "on every level, even widths below the top); pad the grid with "
                         "solver.padded_shape(..., mesh_n)")
    dev = mesh.device
    res_local = [(r[0] // n, r[1], r[2]) for r in res_per_level]
    nxs = [r[0] for r in res_per_level]

    def blk(arr, l):
        return local_block(arr, nxs[l], rank, n).to(dev)

    canons, modes = local_routes(res_per_level, mesh)
    halo = HaloPlan(mesh, [r[0] for r in res_local], canons)
    frame = _local_frame_data(
        [[blk(vel_kinds[l][f], l) for f in range(3)] for l in range(levels)],
        [[blk(edge_kinds[l][a], l) for a in range(3)] for l in range(levels)],
        [blk(center_kinds[l], l) for l in range(levels)],
        {k: blk(v, k[0]) for k, v in we.items()}, [blk(wc[l], l) for l in range(levels)],
        {k: blk(v, k[0]) for k, v in mass.items()}, res_local, canons, halo)
    run = fa.make_level_pass(frame, canons, dx, enhanced, modes=modes)

    own, window, active_c = {}, {}, {}
    for l in range(levels):
        for f in range(3):
            o = torch.ones(face_shape(res_local[l], f), dtype=fa.F32, device=dev)
            window[(l, f)] = fa.embed(o, canons[l], 0.0)
            if f == 0 and rank != n - 1:
                o[-1] = 0.0
            own[(l, f)] = fa.embed(o, canons[l], 0.0)
            active_c[(l, f)] = fa.embed(blk(active[(l, f)], l), canons[l], False)
    apply_A = _sharded_apply(run, canons, halo, active_c, own, window)
    apply_A.modes, apply_A.canons, apply_A.metas = modes, canons, run.metas

    def embed_tree(tree: UField, fill=0.0) -> UField:
        # the ghost rows hold the neighbour's DOF: the owner carries it
        return {k: torch.where(own[k] > 0, fa.embed(blk(v, k[0]).to(fa.F32), canons[k[0]], fill),
                               fill) for k, v in tree.items()}

    def gather_tree(u: UField) -> UField:
        keys = sorted(u)
        mine = [fa.crop(u[k], canons[k[0]], face_shape(res_local[k[0]], k[1])) for k in keys]
        every = all_gather_rows(mesh, mine)
        return {k: unblock_x(torch.cat([every[r][i] for r in range(n)]), nxs[k[0]], n)
                for i, k in enumerate(keys)}

    return apply_A, embed_tree, gather_tree


def sharded_fused_pcg(mesh, vel_kinds, edge_kinds, center_kinds, we, wc, mass: UField,
                      active: UField, rhs: UField, guess: UField, diag: UField, res_per_level,
                      dx: float, enhanced: bool, tolerance: float, max_iterations: int,
                      cheb_degree: int = 1):
    """Distributed PCG with the fused apply over the 1-D group of ``mesh``
    (the counterpart of ``sharded_pallas_pcg``): every rank calls it with
    the same GLOBAL per-level grids, builds its part of the operator
    (:func:`sharded_operator`), runs ``operator.pcg_flat`` on its local
    grids with all-reduced dots (Jacobi, or degree-``cheb_degree``
    Chebyshev on an all-reduced lam_max estimate) and all-gathers the
    solution.  The apply is not ``capturable`` (no graph captures a
    collective), so it runs eagerly, and the CG is the loop of PyTorch ops
    (``operator._fuses`` takes ``torch.dot`` only).  The ghost rows of the
    CG's vectors hold 0 (``invd`` 1), so each DOF counts once in a dot.
    Returns (global float32 solution, iterations, relative residual,
    applies)."""
    apply_A, embed_tree, gather_tree = sharded_operator(
        mesh, vel_kinds, edge_kinds, center_kinds, we, wc, mass, active, res_per_level, dx,
        enhanced)

    def dot(x, y):
        return all_reduce_sum(mesh, torch.dot(x, y))

    x, iters, rel, applies = operator.pcg_flat(
        apply_A, embed_tree(rhs), embed_tree(guess), embed_tree(diag, 1.0), tolerance,
        max_iterations, cheb_degree=cheb_degree, dot=dot)
    return gather_tree(x), iters, rel, applies


def expected_exchanges(res_per_level, n: int, applies: int = 1) -> Dict[str, int]:
    """One-way transfers a rank counts for a sharded solve over ``n`` ranks:
    ``frame`` (packed kinds and weights, once), ``apply`` (iterate and views,
    over ``applies`` applies).  With every slab at least HALO_X wide (one hop) ``apply``
    is the JAX package's ``2 (3 L + 6 (L - 1))``; ``frame`` is ``2 sum_l
    (groups_l + 4)`` against its ``2 sum_l (fields_l + 4)``."""
    levels = len(res_per_level)
    hops = [min(math.ceil(HALO / (r[0] // n)), n - 1) for r in res_per_level]
    frame = sum(2 * hops[l] * (len(fa.pack_groups(l, levels)) + 4) for l in range(levels))
    apply = sum(2 * hops[l] * (3 + 3 * (l + 1 < levels) + 3 * (l > 0)) for l in range(levels))
    return {"frame": frame, "apply": apply * applies}
