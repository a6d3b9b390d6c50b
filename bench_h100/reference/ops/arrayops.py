"""Dense pyramid array primitives (port of ``ops/arrayops.py``).

Every neighbour access of the solver is a shifted read, every parent/child
access a strided (factor-2) read or reduce, on whole dense per-level
tensors.  Out-of-bounds reads return an explicit fill value.
"""

from __future__ import annotations

from typing import Sequence

import torch


def pad_const(arr: torch.Tensor, pads: Sequence[Sequence[int]], fill=0) -> torch.Tensor:
    """Pad with a constant: ``pads[d] = (lo, hi)`` (non-negative) per dim.
    Works for every dtype, bool included."""
    shape = [s + lo + hi for s, (lo, hi) in zip(arr.shape, pads)]
    out = torch.full(shape, fill, dtype=arr.dtype, device=arr.device)
    out[tuple(slice(lo, lo + s) for s, (lo, _) in zip(arr.shape, pads))] = arr
    return out


def pad_edge(arr: torch.Tensor, pads: Sequence[Sequence[int]]) -> torch.Tensor:
    """Pad by replicating the border values (``jnp.pad(mode="edge")``)."""
    out = arr
    for d, (lo, hi) in enumerate(pads):
        if lo == 0 and hi == 0:
            continue
        n = out.shape[d]
        idx = torch.arange(-lo, n + hi, device=arr.device).clamp_(0, n - 1)
        out = out.index_select(d, idx)
    return out


def shift(arr: torch.Tensor, axis: int, offset: int, fill=0) -> torch.Tensor:
    """``out[i] = arr[i + offset]`` along ``axis``; OOB reads ``fill``."""
    if offset == 0:
        return arr
    n = arr.shape[axis]
    pads = [(0, 0)] * arr.ndim
    idx = [slice(None)] * arr.ndim
    if offset > 0:
        pads[axis] = (0, offset)
        idx[axis] = slice(offset, offset + n)
    else:
        pads[axis] = (-offset, 0)
        idx[axis] = slice(0, n)
    return pad_const(arr, pads, fill)[tuple(idx)]


def grow(arr: torch.Tensor, axis: int, lo: int = 0, hi: int = 0, fill=0) -> torch.Tensor:
    """Pad ``fill`` entries at the low/high end of ``axis``."""
    pads = [(0, 0)] * arr.ndim
    pads[axis] = (lo, hi)
    return pad_const(arr, pads, fill)


def upread(coarse: torch.Tensor, out_shape: Sequence[int]) -> torch.Tensor:
    """``out[p] = coarse[p >> 1]``, cropped to ``out_shape``."""
    out = coarse
    for d in range(coarse.ndim):
        out = out.repeat_interleave(2, dim=d)
    return out[tuple(slice(0, s) for s in out_shape)]


def upread_adjoint(fine: torch.Tensor, coarse_shape: Sequence[int]) -> torch.Tensor:
    """Adjoint of :func:`upread`: ``out[c] = sum_{p: p>>1 == c} fine[p]``."""
    x = fine
    for d in range(fine.ndim):
        n = x.shape[d]
        target = 2 * coarse_shape[d]
        if n < target:
            x = grow(x, d, hi=target - n)
        shp = x.shape[:d] + (coarse_shape[d], 2) + x.shape[d + 1:]
        x = x.reshape(shp).sum(dim=d + 1)
    return x


def down_reduce_cells(arr: torch.Tensor, op: str) -> torch.Tensor:
    """Reduce 2x2x2 child cells onto the parent cell grid (even extents)."""
    assert all(s % 2 == 0 for s in arr.shape), arr.shape
    cx, cy, cz = (s // 2 for s in arr.shape)
    r = arr.reshape(cx, 2, cy, 2, cz, 2)
    if op == "any":
        return r.any(dim=5).any(dim=3).any(dim=1)
    if op == "all":
        return r.all(dim=5).all(dim=3).all(dim=1)
    if op == "max":
        return r.amax(dim=(1, 3, 5))
    if op == "sum":
        return r.sum(dim=(1, 3, 5))
    raise ValueError(op)


def _block2(arr: torch.Tensor, axes: Sequence[int], op: str) -> torch.Tensor:
    """Reduce aligned pairs along ``axes`` (even extents there) by ``op``,
    "sum" or "max"."""
    out = arr
    for d in sorted(axes):
        assert out.shape[d] % 2 == 0, (out.shape, d)
        shp = out.shape[:d] + (out.shape[d] // 2, 2) + out.shape[d + 1:]
        r = out.reshape(shp)
        out = r.sum(dim=d + 1) if op == "sum" else r.amax(dim=d + 1)
    return out


def block2_sum(arr: torch.Tensor, axes: Sequence[int]) -> torch.Tensor:
    """Sum aligned pairs along ``axes`` (even extents there)."""
    return _block2(arr, axes, "sum")


def repeat2(arr: torch.Tensor, axes: Sequence[int]) -> torch.Tensor:
    out = arr
    for d in sorted(axes):
        out = out.repeat_interleave(2, dim=d)
    return out


def strided_even(arr: torch.Tensor, axis: int) -> torch.Tensor:
    idx = [slice(None)] * arr.ndim
    idx[axis] = slice(0, None, 2)
    return arr[tuple(idx)]


def scatter_even(arr: torch.Tensor, axis: int, out_size: int) -> torch.Tensor:
    """Adjoint of :func:`strided_even`: place entries at even indices."""
    shp = list(arr.shape)
    shp[axis] = 2 * shp[axis]
    out = torch.zeros(shp, dtype=arr.dtype, device=arr.device)
    idx = [slice(None)] * arr.ndim
    idx[axis] = slice(0, None, 2)
    out[tuple(idx)] = arr
    cur = out.shape[axis]
    if cur > out_size:
        sl = [slice(None)] * arr.ndim
        sl[axis] = slice(0, out_size)
        out = out[tuple(sl)]
    elif cur < out_size:
        out = grow(out, axis, hi=out_size - cur)
    return out


def face_shape(res: Sequence[int], axis: int):
    s = list(res)
    s[axis] += 1
    return tuple(s)


def edge_shape(res: Sequence[int], axis: int):
    s = [r + 1 for r in res]
    s[axis] = res[axis]
    return tuple(s)


def node_shape(res: Sequence[int]):
    return tuple(r + 1 for r in res)


def face_child_mean(fine: torch.Tensor, axis: int, coarse_shape: Sequence[int]) -> torch.Tensor:
    """Average of the 4 child faces of each coarse face (getChildFace)."""
    x = strided_even(fine, axis)
    t_axes = [d for d in range(3) if d != axis]
    x = block2_sum(x, t_axes) * 0.25
    assert tuple(x.shape) == tuple(coarse_shape), (x.shape, coarse_shape)
    return x


def face_child_sum(fine: torch.Tensor, axis: int, coarse_shape: Sequence[int]) -> torch.Tensor:
    """Sum of the 4 child faces of each coarse face."""
    x = strided_even(fine, axis)
    t_axes = [d for d in range(3) if d != axis]
    x = block2_sum(x, t_axes)
    assert tuple(x.shape) == tuple(coarse_shape), (x.shape, coarse_shape)
    return x


def face_child_sum_adjoint(coarse: torch.Tensor, axis: int,
                           fine_shape: Sequence[int]) -> torch.Tensor:
    t_axes = [d for d in range(3) if d != axis]
    x = repeat2(coarse, t_axes)
    x = scatter_even(x, axis, fine_shape[axis])
    assert tuple(x.shape) == tuple(fine_shape), (x.shape, fine_shape)
    return x


def transverse_blocksum(arr: torch.Tensor, axis: int) -> torch.Tensor:
    """Sum over the aligned 2x2 transverse block holding each face
    (HDK_AdaptiveViscosity.cpp:1857-1880).  Self-adjoint."""
    t_axes = [d for d in range(3) if d != axis]
    return repeat2(block2_sum(arr, t_axes), t_axes)


def gather_offset(src: torch.Tensor, out_shape: Sequence[int], offset: Sequence[int], fill=0):
    """``out[idx] = src[idx + offset]``; out-of-bounds reads ``fill``."""
    pads, starts = [], []
    for d in range(3):
        lo = max(0, -offset[d])
        hi = max(0, offset[d] + out_shape[d] - src.shape[d])
        pads.append((lo, hi))
        starts.append(offset[d] + lo)
    p = pad_const(src, pads, fill) if any(lo or hi for lo, hi in pads) else src
    return p[tuple(slice(s, s + n) for s, n in zip(starts, out_shape))]


def scatter_offset(w: torch.Tensor, src_shape: Sequence[int], offset: Sequence[int]):
    """Adjoint of :func:`gather_offset`: ``out[idx + offset] += w[idx]``."""
    return gather_offset(w, src_shape, tuple(-o for o in offset))


def upread_k(coarse: torch.Tensor, out_shape: Sequence[int], k: int) -> torch.Tensor:
    """``out[p] = coarse[p >> k]``."""
    if k == 0:
        return coarse[tuple(slice(0, s) for s in out_shape)]
    out = coarse
    for d in range(coarse.ndim):
        out = out.repeat_interleave(1 << k, dim=d)
    return out[tuple(slice(0, s) for s in out_shape)]


def even_snap(arr: torch.Tensor, axis: int) -> torch.Tensor:
    """``out[i] = arr[i - (i & 1)]``."""
    n = arr.shape[axis]
    idx = torch.arange(n, device=arr.device).reshape(
        [n if d == axis else 1 for d in range(arr.ndim)])
    odd = (idx % 2 == 1).expand(arr.shape)
    return torch.where(odd, shift(arr, axis, -1), arr)


def iota(shape: Sequence[int], axis: int, device) -> torch.Tensor:
    """Index along ``axis`` broadcast to ``shape`` (int64)."""
    n = shape[axis]
    return torch.arange(n, device=device).reshape(
        [n if d == axis else 1 for d in range(len(shape))]).expand(tuple(shape))


def fill_where(cond: torch.Tensor, a: float, b: float, dtype) -> torch.Tensor:
    """``where(cond, a, b)`` for two Python scalars, in ``dtype``
    (``torch.where`` of two scalars would pick the default dtype)."""
    out = torch.full(cond.shape, b, dtype=dtype, device=cond.device)
    return out.masked_fill_(cond, a)
