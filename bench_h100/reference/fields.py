"""Supersampled volume-fraction integration weights (port of ``fields.py``).

The replacement for Houdini's ``computeSDFWeightsSampled`` supersampling
(reference Source/HDK_AdaptiveViscosity.cpp:712-791): every sample
target sits at a uniform fractional offset from the cell grid, so trilinear
interpolation is a fixed-weight combination of clamped shifted tensors.

Sign conventions: liquid SDF negative inside the liquid; solid SDF negative
inside the solid.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from .ops.arrayops import edge_shape, face_shape, pad_edge


def _shift_clamped(arr: torch.Tensor, axis: int, offset: int) -> torch.Tensor:
    """out[i] = arr[clamp(i + offset)] along ``axis``."""
    if offset == 0:
        return arr
    n = arr.shape[axis]
    idx = (torch.arange(n, device=arr.device) + offset).clamp_(0, n - 1)
    return arr.index_select(axis, idx)


def _axis_lerp(arr: torch.Tensor, axis: int, offset: float) -> torch.Tensor:
    """Sample at ``index + offset`` along ``axis`` with edge clamping."""
    base = math.floor(offset)
    frac = offset - base
    lo = _shift_clamped(arr, axis, base)
    if frac == 0.0:
        return lo
    hi = _shift_clamped(arr, axis, base + 1)
    return (1.0 - frac) * lo + frac * hi


def _pair_mean(arr: torch.Tensor, axis: int) -> torch.Tensor:
    pads = [(0, 0)] * 3
    pads[axis] = (1, 1)
    p = pad_edge(arr, pads)
    n = arr.shape[axis]
    lo = [slice(None)] * 3
    hi = [slice(None)] * 3
    lo[axis] = slice(0, n + 1)
    hi[axis] = slice(1, n + 2)
    return 0.5 * (p[tuple(lo)] + p[tuple(hi)])


def cell_to_face_avg(cell_field: torch.Tensor, axis: int) -> torch.Tensor:
    """Cell field at face centers (2-cell clamped mean)."""
    return _pair_mean(cell_field, axis)


def _supersample_offsets(num_samples: int):
    return [(i + 0.5) / num_samples - 0.5 for i in range(num_samples)]


def _staggered_fraction(sdf, kind, axis, num_samples, iso_offset=0.0):
    """Volume fraction on the full staggered target grid (float32, as in
    the JAX package)."""
    subs = _supersample_offsets(num_samples)
    if kind == "center":
        base = [0.0, 0.0, 0.0]
        out_shape = tuple(sdf.shape)
    elif kind == "edge":
        base = [0.0 if d == axis else -0.5 for d in range(3)]
        out_shape = edge_shape(sdf.shape, axis)
    elif kind == "face":
        base = [-0.5 if d == axis else 0.0 for d in range(3)]
        out_shape = face_shape(sdf.shape, axis)
    else:
        raise ValueError(kind)

    src = sdf
    shifts = [0, 0, 0]
    for d in range(3):
        if out_shape[d] == sdf.shape[d] + 1:
            pads = [(0, 0)] * 3
            pads[d] = (1, 1)
            src = pad_edge(src, pads)
            shifts[d] = -1

    acc = torch.zeros(out_shape, dtype=torch.float32, device=sdf.device)
    for ox in subs:
        sx = _axis_lerp(src, 0, base[0] + ox - shifts[0])[: out_shape[0]]
        for oy in subs:
            sy = _axis_lerp(sx, 1, base[1] + oy - shifts[1])[:, : out_shape[1]]
            for oz in subs:
                sz = _axis_lerp(sy, 2, base[2] + oz - shifts[2])[:, :, : out_shape[2]]
                acc = acc + (sz + iso_offset <= 0.0).to(torch.float32)
    return acc / float(num_samples ** 3)


def _open_divide(w, open_frac):
    return torch.where(open_frac > 0, w / open_frac.clamp_min(1e-30),
                       torch.zeros((), dtype=w.dtype, device=w.device))


def integration_weights(liquid_sdf, solid_sdf, num_samples: int,
                        extrapolation: float, apply_solid_weights: bool):
    """Center + 3 edge-type liquid volume fractions, optionally divided by
    the solid open fractions (buildIntegrationWeights, cpp:748-791).
    Returns (center_w, [edge_w_x, edge_w_y, edge_w_z])."""
    center_w = _staggered_fraction(liquid_sdf, "center", None, num_samples)
    edge_w = [_staggered_fraction(liquid_sdf, "edge", a, num_samples) for a in range(3)]
    if apply_solid_weights:
        center_open = _staggered_fraction(-solid_sdf, "center", None, num_samples,
                                          iso_offset=extrapolation)
        center_w = _open_divide(center_w, center_open)
        for a in range(3):
            open_a = _staggered_fraction(-solid_sdf, "edge", a, num_samples,
                                         iso_offset=extrapolation)
            edge_w[a] = _open_divide(edge_w[a], open_a)
    return center_w, edge_w


def face_weights(liquid_sdf, solid_sdf, num_samples: int,
                 extrapolation: float, apply_solid_weights: bool):
    """Liquid volume fractions at the 3 face grids (the host FLIP solver's
    "surfaceweights" input, cpp:144)."""
    ws = [_staggered_fraction(liquid_sdf, "face", a, num_samples) for a in range(3)]
    if apply_solid_weights:
        for a in range(3):
            open_a = _staggered_fraction(-solid_sdf, "face", a, num_samples,
                                         iso_offset=extrapolation)
            ws[a] = _open_divide(ws[a], open_a)
    return ws
