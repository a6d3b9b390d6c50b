"""One viscosity frame, computed plainly: the whole-array pipeline of the
reference modules on the whole (padded) domain, every configured level,
Jacobi CG on the ``v1`` operator.

``reference_frame`` takes the very tensors the program was handed and
returns what the program's closure returns for a frame: the written-back
MAC velocity and the frame's statistics.

It is the plain answer for every configuration: the CG stops by the
configuration's tolerance and ``max_iterations`` alone.  A configuration
that refines (``use_iterative_refinement``) changes the program's route to
that stopping rule, not the answer, so the reference takes no such setting.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import torch

import numpy as np

from . import census, classify, fields, interpolator, octree, restriction, stencils, writeback
from .config import SolverConfig, capped_levels
from .operator import boundary_rhs, make_operator, pcg_jacobi
from .ops.arrayops import pad_const, pad_edge


def padded_shape(shape: Sequence[int], levels: int):
    """Smallest extents >= ``shape`` divisible by ``2^(levels-1)``."""
    m = 1 << max(0, levels - 1)
    return tuple(-(-int(s) // m) * m for s in shape)


def _pad(inp: Dict[str, object], target) -> Dict[str, object]:
    """SDFs padded with a far positive value, velocities with zero,
    viscosity and density with their edge values, on the high side."""
    res = tuple(inp["liquid_sdf"].shape)
    pads = tuple((0, int(t) - int(s)) for s, t in zip(res, target))
    if not any(p for _, p in pads):
        return inp
    far = 4.0 * inp["dx"] * max(target)
    out = dict(inp)
    out["liquid_sdf"] = pad_const(inp["liquid_sdf"], pads, far)
    out["solid_sdf"] = pad_const(inp["solid_sdf"], pads, far)
    out["velocity"] = tuple(pad_const(v, pads, 0) for v in inp["velocity"])
    out["solid_velocity"] = tuple(pad_const(v, pads, 0) for v in inp["solid_velocity"])
    out["viscosity"] = pad_edge(inp["viscosity"], pads)
    out["density"] = pad_edge(inp["density"], pads)
    return out


def _cast_blocks(blocks, dtype):
    def c(x):
        return None if x is None else x.to(dtype)

    return [dataclasses.replace(
        b, weight=c(b.weight), boundary=c(b.boundary),
        terms=[dataclasses.replace(t, coeff=c(t.coeff)) for t in b.terms]) for b in blocks]


def reference_frame(inp: Dict[str, object], dt: float, cfg: SolverConfig,
                    dtype: torch.dtype = torch.float64,
                    solve_dtype: Optional[torch.dtype] = None,
                    solve: bool = True) -> Dict[str, object]:
    """The frame of input fields ``inp`` (keys ``liquid_sdf``,
    ``solid_sdf``, ``velocity``, ``solid_velocity``, ``viscosity``,
    ``density``, ``dx``) at step ``dt``: every stage in ``dtype``; the
    system (operator, rhs, guess, diagonal) and the CG in ``solve_dtype``
    when given.  Returns ``velocity`` (three face grids of the input's
    shape, in ``dtype``), ``iterations``, ``residual``, ``octree_dofs``,
    ``regular_dofs`` and ``active_cells`` (ACTIVE cells per level, empty
    top levels dropped), and ``census``: the same three counts from
    :mod:`census`, which shares no code with the label passes.  Without
    ``solve``, only the counts."""
    inp = {k: (tuple(t.to(dtype) for t in v) if isinstance(v, tuple)
               else v.to(dtype) if isinstance(v, torch.Tensor) else v)
           for k, v in inp.items()}
    dx = float(inp["dx"])
    orig = tuple(inp["liquid_sdf"].shape)
    levels = capped_levels(orig, cfg.octree_levels)
    inp = _pad(inp, padded_shape(orig, levels))
    liquid, solid = inp["liquid_sdf"], inp["solid_sdf"]
    extrapolation = cfg.extrapolation * dx

    center_w, edge_w = fields.integration_weights(
        liquid, solid, cfg.num_supersamples, extrapolation, cfg.apply_solid_weights)
    face_w = fields.face_weights(liquid, solid, cfg.num_supersamples, extrapolation,
                                 cfg.apply_solid_weights)
    mask = octree.build_refinement_mask(liquid, solid, dx, extrapolation, 3.0 * dx,
                                        dx * max(2.0, float(cfg.fine_bandwidth)))
    labels = octree.build_octree(mask, levels)
    second = census.census(
        liquid.cpu().numpy(), solid.cpu().numpy(), center_w.cpu().numpy(),
        [np.asarray(w.cpu()) for w in edge_w], dx, extrapolation, cfg.fine_bandwidth, levels)
    vel_kinds = classify.classify_octree_velocity(labels, center_w, edge_w, solid, extrapolation)
    edge_kinds = classify.classify_edge_stress(labels, edge_w)
    center_kinds = classify.classify_center_stress(labels, center_w)
    regular_kinds = [classify.classify_regular_velocity(center_w, edge_w, solid, extrapolation, a)
                     for a in range(3)]
    res_per_level = [tuple(l.shape) for l in labels]
    active = {(l, a): vel_kinds[l][a] == classify.FLUID for l in range(levels) for a in range(3)}
    blocks = stencils.build_edge_stress_blocks(
        labels, vel_kinds, edge_kinds, edge_w, inp["viscosity"], inp["solid_velocity"],
        dt, dx, cfg,
    ) + stencils.build_center_stress_blocks(
        labels, vel_kinds, center_kinds, center_w, inp["viscosity"], inp["solid_velocity"],
        dt, dx, cfg,
    )
    counts = [int(c) for c in octree.active_cell_counts(labels).tolist()]
    while len(counts) > 1 and counts[-1] == 0:
        counts.pop()
    topology = {
        "octree_dofs": int(sum(int(m.sum()) for m in active.values())),
        "regular_dofs": int(sum(int((k == classify.FLUID).sum()) for k in regular_kinds)),
        "active_cells": counts,
        "census": second,
    }
    if not solve:
        return topology
    mass = stencils.build_mass(labels, vel_kinds, face_w, inp["density"])
    guess_raw = restriction.restrict_velocity_pyramid(list(inp["velocity"]), levels)
    zero = torch.zeros((), dtype=dtype, device=liquid.device)
    guess = {k: torch.where(active[k], guess_raw[k], zero) for k in active}

    sd = solve_dtype or dtype
    if sd != dtype:
        blocks = _cast_blocks(blocks, sd)
        mass = {k: v.to(sd) for k, v in mass.items()}
        guess = {k: v.to(sd) for k, v in guess.items()}
    apply_A, diag = make_operator(blocks, mass, active, res_per_level)
    rhs = boundary_rhs(blocks, mass, guess, active, res_per_level)
    solution, iters, rel = pcg_jacobi(apply_A, rhs, guess, diag, cfg.tolerance,
                                      cfg.max_iterations)
    solution = {k: v.to(dtype) for k, v in solution.items()}

    interpolated = interpolator.interpolate_writeback_fields(labels, solution, vel_kinds, levels)
    velocity = writeback.apply_to_regular_grid(
        inp["velocity"], solution, labels, vel_kinds, regular_kinds, inp["solid_velocity"],
        levels, interpolated)
    velocity = tuple(v[tuple(slice(0, orig[d] + (1 if d == a else 0)) for d in range(3))]
                     for a, v in enumerate(velocity))
    return dict(topology, velocity=velocity, iterations=int(iters), residual=rel)
