"""The comparison that decides ``correct``: a frame the program returned
against the reference's frame of the same inputs.

The reference is the plain answer whatever route the program's solve
takes: a float64 Jacobi CG on the ``v1`` operator to the configuration's
tolerance, under its ``max_iterations``.  A configuration that turns on
``use_iterative_refinement`` has the program reach that stopping rule by
float32 inner CGs inside float64 residuals; it is held to the same answer,
and its ``iters_gap`` compares the inner iterations in all.

Numbers compared, each with its limit from the configuration file
(``limits``):

- ``vel_rel``: the largest gap between the program's written-back MAC
  velocity and the reference's, over all faces of the three components,
  over the reference's largest speed (a widest gap: it swings with where
  the two CGs' roundings part, most at 192^3 where the column meets the
  pool);
- ``vel_l2``: the root-mean-square gap over all faces over the
  reference's root-mean-square velocity (the steadier reading of the same
  comparison);
- ``iters_gap``: the gap between the CG iteration counts;
- ``topology_gap``: the gaps in octree DOFs, regular DOFs and ACTIVE cells
  per level (empty top levels dropped), summed, of the program against the
  reference's label passes and against its census (``reference/census.py``,
  a second count that shares no code with the passes); exact, so its
  limit is 0;
- ``residual``: the relative residual the program reports, held to the
  configuration's tolerance.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import torch

NAMES = ("vel_rel", "vel_l2", "iters_gap", "topology_gap", "residual")


def compare(velocity: Sequence[torch.Tensor], stats: Dict[str, object],
            ref: Dict[str, object]) -> Dict[str, float]:
    """The numbers of one frame; ``stats`` holds the program's
    ``iterations``, ``residual``, ``octree_dofs``, ``regular_dofs`` and
    ``active_cells``."""
    want = ref["velocity"]
    scale = max(float(w.abs().max()) for w in want)
    diff = [g.to(w.dtype) - w for g, w in zip(velocity, want)]
    gap = max(float(d.abs().max()) for d in diff)
    sq = sum(float((d * d).sum()) for d in diff)
    norm = sum(float((w * w).sum()) for w in want)
    topo = sum(_topology_gap(stats, want) for want in (ref, ref["census"]))
    return {"vel_rel": gap / max(scale, 1e-30),
            "vel_l2": math.sqrt(sq / max(norm, 1e-300)),
            "iters_gap": float(abs(int(stats["iterations"]) - ref["iterations"])),
            "topology_gap": float(topo),
            "residual": float(stats["residual"])}


def _topology_gap(got: Dict[str, object], want: Dict[str, object]) -> int:
    got_cells, want_cells = list(got["active_cells"]), list(want["active_cells"])
    width = max(len(got_cells), len(want_cells))
    got_cells += [0] * (width - len(got_cells))
    want_cells += [0] * (width - len(want_cells))
    return (abs(int(got["octree_dofs"]) - int(want["octree_dofs"]))
            + abs(int(got["regular_dofs"]) - int(want["regular_dofs"]))
            + sum(abs(a - b) for a, b in zip(got_cells, want_cells)))


def worst(readings: Sequence[Dict[str, float]]) -> Dict[str, float]:
    """Each number's worst reading over the checked frames (NaN wins)."""
    out = {}
    for name in NAMES:
        vals = [r[name] for r in readings]
        out[name] = math.nan if any(math.isnan(v) for v in vals) else max(vals)
    return out


def passes(reading: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number finite and within its limit."""
    return all(math.isfinite(reading[n]) and reading[n] <= limits[n] for n in NAMES)
