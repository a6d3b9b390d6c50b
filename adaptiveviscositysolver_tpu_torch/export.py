"""Export the assembled sparse system on the host (port of ``export.py``).

The solve never builds a matrix; this module assembles the explicit scipy
system ``A = M + D^T W D`` from the port's dense term bundles (moved to the
host), for inspection and as a yardstick: a CSR product ``A @ x`` computes
the same function as one apply of the matrix-free operator.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from . import classify
from .ops.arrayops import face_shape
from .stencils import StressBlock


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _np_gather(src, out_shape, offset, fill):
    pads, starts = [], []
    for d in range(3):
        lo = max(0, -offset[d])
        hi = max(0, offset[d] + out_shape[d] - src.shape[d])
        pads.append((lo, hi))
        starts.append(offset[d] + lo)
    p = np.pad(src, pads, constant_values=fill)
    return p[tuple(slice(s, s + n) for s, n in zip(starts, out_shape))]


def _np_upread(coarse, out_shape):
    out = coarse
    for d in range(3):
        out = np.repeat(out, 2, axis=d)
    return out[tuple(slice(0, s) for s in out_shape)]


def _term_column_reads(term, shape, vel_idx, res_per_level):
    """Expand one StressTerm into column-index grids of the stress grid's
    ``shape``, one per velocity DOF the term reads (each a uniform read of
    the DOF index pyramid)."""
    lvl, f = term.src_level, term.face_axis
    idx = vel_idx[lvl][f]
    t_axes = [d for d in range(3) if d != f]
    out = []
    if term.lift == "same":
        out.append(_np_gather(idx, shape, term.offset, classify.OUTSIDE))
    elif term.lift == "parent":
        # the stress grid lives one level below src_level; read idx at q >> 1
        fine_fshape = face_shape(res_per_level[lvl - 1], f)
        out.append(_np_gather(_np_upread(idx, fine_fshape), shape, term.offset,
                              classify.OUTSIDE))
    elif term.lift == "childsum":
        # the stress grid lives one level above src_level; read the 4 child
        # faces (in-axis 2q, transverse 2q + b)
        for b1 in (0, 1):
            for b2 in (0, 1):
                strided = idx[tuple(
                    slice(0, None, 2) if d == f
                    else slice(b1 if d == t_axes[0] else b2, None, 2)
                    for d in range(3)
                )]
                out.append(_np_gather(strided, shape, term.offset, classify.OUTSIDE))
    elif term.lift == "blocksum":
        # same level: the aligned 2x2 transverse block containing the read
        g = np.indices(idx.shape)
        for b1 in (0, 1):
            for b2 in (0, 1):
                coords = [g[0], g[1], g[2]]
                coords[t_axes[0]] = (g[t_axes[0]] & ~1) + b1
                coords[t_axes[1]] = (g[t_axes[1]] & ~1) + b2
                read = idx[tuple(coords)]
                out.append(_np_gather(read, shape, term.offset, classify.OUTSIDE))
    else:
        raise ValueError(term.lift)
    return out


def _assign_indices_np(kind_grids):
    out, counter = [], 0
    for k in kind_grids:
        g = k.astype(np.int64).copy()
        flat = g.reshape(-1)
        sel = np.flatnonzero(flat == classify.FLUID)
        flat[sel] = counter + np.arange(len(sel))
        counter += len(sel)
        out.append(flat.reshape(k.shape))
    return out, counter


def export_sparse_system(
    blocks: Sequence[StressBlock],
    mass: Dict[Tuple[int, int], torch.Tensor],
    vel_kinds,
    guess: Dict[Tuple[int, int], torch.Tensor],
    res_per_level,
):
    """Assemble (A_csr, rhs, vel_index_grids, n_dofs) on the host, in
    float64: DOFs numbered level by level, axis by axis, in row-major
    order over the FLUID faces (the JAX package's numbering)."""
    import scipy.sparse as sp

    levels = len(res_per_level)
    flat_kinds = [_host(vel_kinds[l][a]) for l in range(levels) for a in range(3)]
    idx_grids, total = _assign_indices_np(flat_kinds)
    vel_idx = [[idx_grids[3 * l + a] for a in range(3)] for l in range(levels)]
    n = int(total)

    rhs = np.zeros(n)
    Ds, ws = [], []
    for b in blocks:
        w = _host(b.weight).astype(np.float64).reshape(-1)
        n_rows = w.size
        rows, cols, vals = [], [], []
        for t in b.terms:
            coeff = _host(t.coeff).astype(np.float64)
            shape = coeff.shape
            coeff = coeff.reshape(-1)
            for col_grid in _term_column_reads(t, shape, vel_idx, res_per_level):
                cg = col_grid.reshape(-1)
                sel = (cg >= 0) & (coeff != 0.0) & (w != 0.0)
                if sel.any():
                    rows.append(np.flatnonzero(sel))
                    cols.append(cg[sel])
                    vals.append(coeff[sel])
        if not rows:
            continue
        D = sp.coo_matrix(
            (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
            shape=(n_rows, n),
        ).tocsr()
        Ds.append(D)
        ws.append(w)
        if b.boundary is not None:
            bvec = _host(b.boundary).astype(np.float64).reshape(-1)
            rhs -= D.T @ (w * bvec)

    mdiag = np.zeros(n)
    for l in range(levels):
        for a in range(3):
            idx = vel_idx[l][a]
            sel = idx >= 0
            mdiag[idx[sel]] = _host(mass[(l, a)]).astype(np.float64)[sel]
            rhs[idx[sel]] += mdiag[idx[sel]] * _host(guess[(l, a)]).astype(np.float64)[sel]
    A = sp.diags(mdiag).tocsr()
    if Ds:
        # every block's D^T W D in one product over the stacked gradient rows
        D = sp.vstack(Ds).tocsr()
        A = A + D.T @ sp.diags(np.concatenate(ws)) @ D
    return A.tocsr(), rhs, vel_idx, n
