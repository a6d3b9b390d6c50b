"""Bytes one Jacobi CG iteration must move, and the card's peak.

A frozen copy of the program's ``fused_apply.kernel_bytes`` (with
``_window_counts``) over whole windows, so that the yardstick does not move
when the program's kernels or its count change, plus the CG's vector
traffic over the same windows.

Counts are over each level's logical window (its cells plus the closing
face row), not a padded box; every input is read once and every output
written once.  Per level with ``face``, ``edge``, ``cell`` and ``node``
samples (face and edge summed over the three axes), ``p`` = 1 if a coarser
level exists, ``c`` = 1 if a finer one does:

    kinds  = (3 + p) * node                      packed kind bytes
    tau    = 4 face (1 + p + c) + 4 (edge + cell) + kinds + 4 (edge + 3 cell)
             (u, its parent and child-sum views, edge and cell weights and
              the kinds in; the weighted edge and center stresses out)
    D^T    = 4 (edge + 3 cell) + 8 face + kinds + 4 face (1 + p + c)
             (the weighted stresses, u, mass and kinds in; the level's
              output and its cross-level adjoints out)

and, over all levels' faces ``N``, the PCG's vector update after the
apply reads x, r, p, Ap and the inverse diagonal and writes x, r and p:

    vector = 4 * 8 * N
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

# NVIDIA H100 SXM data sheet: 3.35 TB/s of HBM3 at the full 700 W
HBM_BYTES_PER_S = 3.35e12

Window = Tuple[Tuple[int, int], Tuple[int, int], Tuple[int, int]]


def _prod(shape) -> int:
    out = 1
    for s in shape:
        out *= int(s)
    return out


def window_counts(win: Sequence[int]) -> Tuple[int, int, int, int]:
    """(face, edge, cell, node) samples of a window of ``win`` cells."""
    face = sum(_prod([w + (1 if d == a else 0) for d, w in enumerate(win)]) for a in range(3))
    edge = sum(_prod([w + (0 if d == a else 1) for d, w in enumerate(win)]) for a in range(3))
    return face, edge, _prod(win), _prod([w + 1 for w in win])


def extents(windows: Sequence[Window]) -> list:
    """Cell extents of each level's window."""
    return [tuple(int(hi) - int(lo) for lo, hi in w) for w in windows]


def apply_bytes(windows: Sequence[Window]) -> Dict[str, int]:
    """Bytes of the tau and D^T passes of one apply over these windows."""
    wins = extents(windows)
    levels = len(wins)
    tau_b = dt_b = 0
    for l, win in enumerate(wins):
        face, edge, cell, node = window_counts(win)
        p, c = int(l + 1 < levels), int(l > 0)
        kinds = (3 + p) * node
        tau_b += 4 * face * (1 + p + c) + 4 * (edge + cell) + kinds + 4 * (edge + 3 * cell)
        dt_b += 4 * (edge + 3 * cell) + 4 * 2 * face + kinds + 4 * face * (1 + p + c)
    return {"tau": tau_b, "dt": dt_b}


def vector_bytes(windows: Sequence[Window]) -> int:
    """Bytes of one iteration's vector update over these windows."""
    return 4 * 8 * sum(window_counts(w)[0] for w in extents(windows))


def solve_bytes(windows: Sequence[Window], iterations: int) -> int:
    """Bytes of a Jacobi solve of ``iterations`` iterations: one apply
    more than iterations (the initial residual) and one vector update per
    iteration."""
    b = apply_bytes(windows)
    return (iterations + 1) * (b["tau"] + b["dt"]) + iterations * vector_bytes(windows)
