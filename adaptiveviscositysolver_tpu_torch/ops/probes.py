"""The probe tools' streaming kernels (``csrc/probe_kernels.cu``): what the
card's memory sustains for the matvec's traffic, beside the kernels' byte
bounds.

Kernels, replacing the Pallas TPU kernels of the JAX package's tools:

* ``banded_apply`` (T1, ``banded_kernel``, tools/calibrate_bandwidth.py:30):
  ``out = c_0 u + sum_{j=1..nb-1} c_j roll(u, (j - 1) mod 3, axis 1)`` on a
  float32 box, with ``roll`` as ``jnp.roll`` / ``torch.roll``:
  ``roll(u, s, 1)[x, y, z] = u[x, (y - s) mod NY, z]``.  The banded form of
  the matvec, with materialized coefficient planes.
* ``stream_floor`` (T2, ``dma_kernel``, tools/profile_levels.py:128): a
  copy-only floor of one level's kernel pair: reads each of the level's
  inputs (``fused_apply.level_input_names``: u, up/cs, the packed kinds, we,
  wc, m) once over the window's x rows and writes 3 float32 outputs, each
  the sum of the float32 inputs on those rows and exactly 0 on the others.
  ``i8_weight`` times the sum of the int8 inputs is added too: 0 for the
  floor (every byte is still read; see the source), 1 to check the reads.

Both are bound by device-memory bytes (:func:`probe_bytes`).  Each wrapper
launches its kernel on CUDA tensors, raising if it cannot, and runs the
plain PyTorch version on CPU tensors; launches are counted.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .fused_apply import Canon, LevelMeta, level_input_names

F32 = torch.float32
MAX_BANDS = 32     # csrc/probe_kernels.cuh AVS_MAX_BANDS
MAX_F32 = 16       # AVS_MAX_F32
MAX_I8 = 4         # AVS_MAX_I8

# kernel name -> number of launches (counted where the kernel is launched)
launch_counts = {"banded_apply": 0, "stream_floor": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


class _Banded(ctypes.Structure):
    _fields_ = [("u", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("c", ctypes.c_void_p * MAX_BANDS),
                ("nx", ctypes.c_longlong), ("ny", ctypes.c_longlong), ("nz", ctypes.c_longlong),
                ("nb", ctypes.c_longlong)]


class _Floor(ctypes.Structure):
    _fields_ = [("f32", ctypes.c_void_p * MAX_F32), ("i8", ctypes.c_void_p * MAX_I8),
                ("out", ctypes.c_void_p * 3),
                ("n_f32", ctypes.c_longlong), ("n_i8", ctypes.c_longlong),
                ("plane", ctypes.c_longlong), ("row0", ctypes.c_longlong),
                ("row1", ctypes.c_longlong), ("cx", ctypes.c_longlong),
                ("i8_weight", ctypes.c_float)]


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """``csrc/probe_kernels.cu``'s library, built at first use, with its
    entry points' argument types set and its struct layouts checked."""
    from . import _build

    lib = _build.load("probe_kernels")
    for probe, struct in (("avs_banded_bytes", _Banded), ("avs_floor_bytes", _Floor)):
        fn = getattr(lib, probe)
        fn.argtypes, fn.restype = [], ctypes.c_longlong
        if fn() != ctypes.sizeof(struct):
            raise RuntimeError("argument layout mismatch between csrc/probe_kernels.cu and "
                               "Python")
    for name in ("avs_banded_launch", "avs_floor_launch"):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = [ctypes.c_void_p, ctypes.c_void_p], ctypes.c_int
    return lib


def _launch(entry: str, args: ctypes.Structure, dev: torch.device) -> None:
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = getattr(_library(), entry)(ctypes.addressof(args), stream)
    if err != 0:
        raise RuntimeError(f"{entry} failed: cudaError {err}")


def _device(tensors: Sequence[torch.Tensor]) -> torch.device:
    dev = tensors[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"the probe kernels run on cpu or cuda tensors, got {dev}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensors on {dev} and {t.device}")
    return dev


def _check_vec4(t: torch.Tensor, shape, dtypes, what: str) -> None:
    """The kernels read 4 samples per thread with one aligned load, and
    index in 32 bits."""
    if t.numel() >= 2 ** 31:
        raise ValueError(f"{what}: at most 2^31 - 1 samples, got {t.numel()}")
    if tuple(t.shape) != tuple(shape) or t.dtype not in dtypes or not t.is_contiguous() \
            or t.data_ptr() % (4 * t.element_size()):
        raise ValueError(f"{what}: need a contiguous {'/'.join(map(str, dtypes))} tensor of "
                         f"shape {tuple(shape)} at a {4 * t.element_size()}-byte aligned "
                         f"address, got {t.dtype} {tuple(t.shape)}")


# ---------------------------------------------------------------------------
# T1: the banded apply
# ---------------------------------------------------------------------------


def plain_banded_apply(u: torch.Tensor, coeffs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Plain version of :func:`banded_apply`."""
    acc = coeffs[0] * u
    for j, c in enumerate(coeffs[1:], start=1):
        s = (j - 1) % 3
        acc = acc + c * (torch.roll(u, s, 1) if s else u)
    return acc


def banded_apply(u: torch.Tensor, coeffs: Sequence[torch.Tensor]) -> torch.Tensor:
    """``c_0 u + sum_j c_j roll(u, (j - 1) mod 3, axis 1)`` over the
    ``nb = len(coeffs)`` coefficient planes of ``u``'s shape.

    CUDA tensors: one launch of the banded kernel (float32, the last axis
    a multiple of 4, at most ``MAX_BANDS`` planes).  CPU tensors:
    :func:`plain_banded_apply`."""
    if not 1 <= len(coeffs) <= MAX_BANDS:
        raise ValueError(f"1 to {MAX_BANDS} coefficient planes, got {len(coeffs)}")
    dev = _device([u, *coeffs])
    if dev.type == "cpu":
        return plain_banded_apply(u, coeffs)
    if u.dim() != 3 or u.shape[2] % 4:
        raise ValueError(f"need a 3-D box whose last extent is a multiple of 4, got "
                         f"{tuple(u.shape)}")
    for i, t in enumerate([u, *coeffs]):
        _check_vec4(t, u.shape, (F32,), "u" if i == 0 else f"coefficient {i - 1}")
    out = torch.empty_like(u)
    args = _Banded(u=u.data_ptr(), out=out.data_ptr(), nx=u.shape[0], ny=u.shape[1],
                   nz=u.shape[2], nb=len(coeffs))
    for j, c in enumerate(coeffs):
        args.c[j] = c.data_ptr()
    _launch("avs_banded_launch", args, dev)
    launch_counts["banded_apply"] += 1
    return out


# ---------------------------------------------------------------------------
# T2: the stream floor of one level
# ---------------------------------------------------------------------------


def window_rows(canon: Canon) -> Tuple[int, int]:
    """x rows of a level's box that hold its window: the cells and the
    closing face row, after the low pad."""
    ox = canon.off[0]
    return ox, min(canon.shape[0], ox + canon.win[0] + 1)


def floor_inputs(args: Dict[str, torch.Tensor], meta: LevelMeta) -> List[torch.Tensor]:
    """The level's kernel inputs, in ``level_input_names`` order."""
    return [args[n] for n in level_input_names(meta)]


def plain_stream_floor(inputs: Sequence[torch.Tensor], rows: Tuple[int, int],
                       i8_weight: float = 0.0) -> List[torch.Tensor]:
    """Plain version of :func:`stream_floor`."""
    r0, r1 = rows
    acc = torch.zeros(inputs[0].shape, dtype=F32, device=inputs[0].device)
    win = acc[r0:r1]
    for t in inputs:
        if t.dtype == F32:
            win += t[r0:r1]
    i8 = [t[r0:r1].to(torch.int32) for t in inputs if t.dtype == torch.int8]
    if i8:
        win += i8_weight * sum(i8).to(F32)
    return [acc, acc.clone(), acc.clone()]


def stream_floor(inputs: Sequence[torch.Tensor], rows: Tuple[int, int],
                 i8_weight: float = 0.0) -> List[torch.Tensor]:
    """Three float32 box outputs, each the sum of the float32 ``inputs`` on
    x rows ``rows`` plus ``i8_weight`` times the sum of the int8 inputs
    there, and 0 on every other row.  Every input is read once over
    ``rows``.

    CUDA tensors: one launch of the floor kernel (one box of even extents;
    at most ``MAX_F32`` float32 and ``MAX_I8`` int8 inputs).  CPU tensors:
    :func:`plain_stream_floor`."""
    dev = _device(list(inputs))
    shape = tuple(inputs[0].shape)
    if len(shape) != 3 or not 0 <= rows[0] <= rows[1] <= shape[0]:
        raise ValueError(f"rows {rows} of a 3-D box, got shape {shape}")
    if dev.type == "cpu":
        return plain_stream_floor(inputs, rows, i8_weight)
    f32 = [t for t in inputs if t.dtype == F32]
    i8 = [t for t in inputs if t.dtype == torch.int8]
    if len(f32) + len(i8) != len(inputs) or len(f32) > MAX_F32 or len(i8) > MAX_I8:
        raise ValueError(f"at most {MAX_F32} float32 and {MAX_I8} int8 inputs, got "
                         f"{[t.dtype for t in inputs]}")
    plane = shape[1] * shape[2]
    if plane % 4:
        raise ValueError(f"a box plane of a multiple of 4 samples, got {shape}")
    for i, t in enumerate(inputs):
        _check_vec4(t, shape, (F32, torch.int8), f"input {i}")
    out = [torch.empty(shape, dtype=F32, device=dev) for _ in range(3)]
    args = _Floor(n_f32=len(f32), n_i8=len(i8), plane=plane, row0=rows[0], row1=rows[1],
                  cx=shape[0], i8_weight=float(i8_weight))
    for k, t in enumerate(f32):
        args.f32[k] = t.data_ptr()
    for k, t in enumerate(i8):
        args.i8[k] = t.data_ptr()
    for k, t in enumerate(out):
        args.out[k] = t.data_ptr()
    _launch("avs_floor_launch", args, dev)
    launch_counts["stream_floor"] += 1
    return out


def probe_bytes(inputs: Sequence[torch.Tensor], outputs: int,
                rows: Optional[Tuple[int, int]] = None) -> int:
    """Device-memory bytes a probe kernel must move: each input read once
    (over x rows ``rows`` only, if given) and each of ``outputs`` float32
    outputs of the inputs' shape written once."""
    shape = tuple(inputs[0].shape)
    plane = shape[1] * shape[2]
    nrows = shape[0] if rows is None else rows[1] - rows[0]
    reads = sum(t.element_size() for t in inputs) * nrows * plane
    return reads + outputs * 4 * shape[0] * plane
