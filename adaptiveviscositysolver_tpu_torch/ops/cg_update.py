"""The Jacobi CG's vector update in three kernels (``csrc/cg_update.cu``),
over flat float32 vectors that the CG keeps for a whole solve and updates
in place (``operator._fused_jacobi_pcg``):

* :func:`cg_update`: ``alpha = rz / pap``, ``x += alpha p``, ``r -= alpha
  ap``, and per-block partial sums of ``r . r``;
* :func:`cg_jacobi`: ``z = invd r`` and per-block partial sums of ``r . z``;
* :func:`cg_direction`: ``rz' = sum of the r . z partials``, ``p = z + (rz' /
  rz) p``; ``rr`` and ``rz'`` written to 0-d device tensors.

``rz``, ``pap``, ``rr`` and ``rz'`` are 0-d float32 tensors on the vectors'
device, read and written by the kernels: the host reads none of them.  The
partial sums are float64, one per block of the kernels' grid
(:func:`partials`); the kernel that consumes them adds them in a fixed
order, so a run repeats bit for bit.

Each wrapper launches its kernel on CUDA tensors (float32 vectors, float64
partials, contiguous, 16-byte aligned, all on one device), raising if it
cannot, on the current stream, and runs the plain PyTorch version on CPU
tensors (one partial, the whole sum); launches are counted.
"""

from __future__ import annotations

import ctypes
import functools

import torch

F32 = torch.float32
F64 = torch.float64
THREADS = 256       # a block's threads (csrc/cg_update.cu kThreads)
BLOCKS_PER_SM = 8
VECTOR = 4          # samples of one 16-byte load

# kernel name -> number of launches (counted where the kernel is launched)
launch_counts = {"cg_update": 0, "cg_jacobi": 0, "cg_direction": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """``csrc/cg_update.cu``'s library, built at first use, with its entry
    points' argument types set."""
    from . import _build

    lib = _build.load("cg_update")
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    for name, argtypes in (("avs_cg_update", [vp] * 7 + [ll, i, vp]),
                           ("avs_cg_jacobi", [vp] * 4 + [ll, i, vp]),
                           ("avs_cg_direction", [vp] * 4 + [i] + [vp] * 3 + [ll, i, vp])):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def grid_blocks(n: int, device) -> int:
    """Blocks of the kernels' grid over a vector of ``n`` samples: one per
    ``THREADS`` x 4 samples, at most ``BLOCKS_PER_SM`` per SM; 1 on the
    CPU.  Any grid computes the same sums (the loops stride over it); this
    one keeps every SM's loads in flight."""
    device = torch.device(device)
    if device.type != "cuda":
        return 1
    index = device.index if device.index is not None else torch.cuda.current_device()
    return max(1, min(BLOCKS_PER_SM * _sms(index), -(-n // (VECTOR * THREADS))))


def partials(n: int, device) -> torch.Tensor:
    """A float64 buffer for one partial sum per block of the grid over a
    vector of ``n`` samples."""
    return torch.zeros(grid_blocks(n, device), dtype=F64, device=device)


def _ptrs(vectors, scalars, parts, n: int):
    """Data pointers of the vectors (float32, ``n`` samples), the 0-d
    scalars (float32) and the partials (float64, 1-D), after the checks of
    the module's docstring; their device."""
    dev = vectors[0].device
    out = []
    for what, ts, dtype, align in (("vector", vectors, F32, 16), ("scalar", scalars, F32, 4),
                                   ("partials", parts, F64, 8)):
        for t in ts:
            ptr = t.data_ptr()
            if t.device != dev or t.dtype != dtype or not t.is_contiguous() or ptr % align \
                    or (what == "vector" and t.numel() != n) \
                    or (what == "scalar" and t.numel() != 1) \
                    or (what == "partials" and (t.dim() != 1 or not 0 < t.numel() < 2 ** 31)):
                raise ValueError(
                    f"cg kernels: a {what} must be a contiguous {dtype} tensor on {dev} at a "
                    f"{align}-byte aligned address"
                    + (f" of {n} samples" if what == "vector" else "")
                    + f", got {t.dtype} {tuple(t.shape)} on {t.device} at {ptr:#x}")
            out.append(ptr)
    return dev, out


def _launch(entry: str, dev: torch.device, *args) -> None:
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = getattr(_library(), entry)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{entry} failed: cudaError {err}")
    launch_counts[entry[len("avs_"):]] += 1


def _whole(part: torch.Tensor, total: torch.Tensor) -> None:
    """The plain versions' partials: the whole sum first, then zeros."""
    part.zero_()
    part[0] = total


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def plain_cg_update(x, r, p, ap, rz, pap, part) -> None:
    """Plain version of :func:`cg_update`."""
    alpha = rz / pap
    torch.add(x, alpha * p, out=x)
    torch.sub(r, alpha * ap, out=r)
    _whole(part, torch.dot(r.to(F64), r.to(F64)))


def plain_cg_jacobi(r, invd, z, part) -> None:
    """Plain version of :func:`cg_jacobi`."""
    torch.mul(invd, r, out=z)
    _whole(part, torch.dot(r.to(F64), z.to(F64)))


def plain_cg_direction(z, p, rr_part, rz_part, rz, rr, rz_new) -> None:
    """Plain version of :func:`cg_direction`."""
    rz_new.copy_(rz_part.sum())
    rr.copy_(rr_part.sum())
    torch.add(z, (rz_new / rz) * p, out=p)


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------


def cg_update(x, r, p, ap, rz, pap, part) -> None:
    """``alpha = rz / pap``; ``x += alpha p`` and ``r -= alpha ap`` in place;
    ``part`` (one float64 per block, :func:`partials`) gets partial sums
    of the new ``r . r``.  CUDA tensors: one launch of ``cg_update`` (reads
    x, p, r, ap, writes x, r).  CPU tensors: :func:`plain_cg_update`."""
    n = x.numel()
    dev, ptrs = _ptrs((x, r, p, ap), (rz, pap), (part,), n)
    if dev.type == "cpu":
        return plain_cg_update(x, r, p, ap, rz, pap, part)
    _launch("avs_cg_update", dev, *ptrs, n, part.numel())


def cg_jacobi(r, invd, z, part) -> None:
    """``z = invd r`` in place; ``part`` gets partial sums of ``r . z``.
    CUDA tensors: one launch of ``cg_jacobi`` (reads r, invd, writes z).
    CPU tensors: :func:`plain_cg_jacobi`."""
    n = r.numel()
    dev, ptrs = _ptrs((r, invd, z), (), (part,), n)
    if dev.type == "cpu":
        return plain_cg_jacobi(r, invd, z, part)
    _launch("avs_cg_jacobi", dev, *ptrs, n, part.numel())


def cg_direction(z, p, rr_part, rz_part, rz, rr, rz_new) -> None:
    """``rz_new`` = the sum of ``rz_part``, ``rr`` = the sum of
    ``rr_part``, and ``p = z + (rz_new / rz) p`` in place.  ``rz_new`` must
    not be ``rz``: every block reads ``rz`` while the first writes
    ``rz_new``.  CUDA tensors: one launch of ``cg_direction`` (reads z, p,
    writes p, on one block per partial; every block adds the partials).
    CPU tensors: :func:`plain_cg_direction`."""
    n = z.numel()
    if rz_part.numel() != rr_part.numel():
        raise ValueError(f"cg_direction: {rr_part.numel()} r.r and {rz_part.numel()} r.z "
                         "partials")
    dev, ptrs = _ptrs((z, p), (rz, rr, rz_new), (rr_part, rz_part), n)
    if ptrs[2] == ptrs[4]:
        raise ValueError("cg_direction: rz_new is rz")
    if dev.type == "cpu":
        return plain_cg_direction(z, p, rr_part, rz_part, rz, rr, rz_new)
    zp, pp, rz_ptr, rr_ptr, rzn_ptr, rrp, rzp = ptrs
    blocks = rz_part.numel()
    _launch("avs_cg_direction", dev, zp, pp, rrp, rzp, blocks, rz_ptr, rr_ptr, rzn_ptr, n, blocks)
