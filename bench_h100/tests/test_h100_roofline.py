"""The frozen byte count equals the program's ``fused_apply.kernel_bytes``
on windows of grids up to 32^3, and the vector traffic is 8 float32
vectors over the windows' faces."""

import pytest
import torch

from _h100 import run  # noqa: F401  (the harness's path)
import roofline


def _program_bytes(res_per_level, windows):
    from adaptiveviscositysolver_tpu_torch.ops import fused_apply as fa

    canons = fa.level_canons(res_per_level, windows)
    return fa.kernel_bytes(fa.level_metas(canons, 1.0 / res_per_level[0][0]))


CASES = [
    # (level-0 resolution, levels, windows or None for the whole grid)
    ((32, 32, 32), 4, None),
    ((32, 32, 32), 3, (((4, 28), (10, 30), (8, 24)), ((2, 14), (4, 16), (4, 12)),
                       ((0, 8), (2, 8), (2, 6)))),
    ((16, 24, 32), 2, (((0, 16), (2, 20), (6, 32)), ((0, 8), (0, 12), (2, 16)))),
    ((32, 32, 32), 1, (((6, 20), (0, 32), (12, 14)),)),
]


@pytest.mark.parametrize("res0, levels, windows", CASES)
def test_apply_bytes_equal_the_programs_kernel_bytes(res0, levels, windows):
    res = [tuple(r >> l for r in res0) for l in range(levels)]
    if windows is None:
        windows = tuple(tuple((0, r) for r in rl) for rl in res)
    assert roofline.apply_bytes(windows) == _program_bytes(res, windows)


def test_bytes_of_the_windows_a_solver_used():
    """The windows ``make_solver`` reports after a beam frame at 32^3."""
    from adaptiveviscositysolver_tpu_torch import SolverConfig, make_solver, scenes

    state = scenes.beam(n=32, device="cpu")
    solve = make_solver(SolverConfig(octree_levels=4, tolerance=1e-3), device="cpu")
    out = solve(state, 1.0 / 24)
    lv = len(out.stats.active_cells)
    windows = solve.cache_info()["windows"][lv]
    res = [tuple(32 >> l for _ in range(3)) for l in range(lv)]
    assert roofline.apply_bytes(windows) == _program_bytes(res, windows)
    faces = sum((w[0] + 1) * w[1] * w[2] + w[0] * (w[1] + 1) * w[2] + w[0] * w[1] * (w[2] + 1)
                for w in roofline.extents(windows))
    assert roofline.vector_bytes(windows) == 32 * faces
    b = roofline.apply_bytes(windows)
    assert roofline.solve_bytes(windows, 10) == 11 * (b["tau"] + b["dt"]) + 10 * 32 * faces
