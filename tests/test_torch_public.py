"""The port's public surface against the JAX package's: the top-level
names, and the four public functions that nothing inside either package
calls (``fields.sample_at_offset``, ``fields.cell_to_edge_avg``,
``arrayops.block2_max``, ``native.available``).

The same float64 (and int8) numpy inputs, made from a seed, go through the
JAX function and the port's on the CPU.  Bars: the two samplers to rtol
1e-12, ``block2_max`` exactly; ``native.available()`` True where the host
``cc`` builds the extension and False where the build fails, while the
checks still raise then (no fallback).
"""

import numpy as np
import pytest
import torch

import adaptiveviscositysolver_tpu as jpkg
import adaptiveviscositysolver_tpu_torch as ppkg
from adaptiveviscositysolver_tpu import fields as jfields
from adaptiveviscositysolver_tpu.ops import arrayops as jops
from adaptiveviscositysolver_tpu_torch import config, fields, native, solver
from adaptiveviscositysolver_tpu_torch.ops import arrayops as tops
from tests.test_torch_stages import T, close, exact, port_test_env  # noqa: F401


def test_top_level_names_match_jax():
    assert ppkg.__all__ == jpkg.__all__
    assert ppkg.__version__ == jpkg.__version__
    for name in ppkg.__all__:
        home = config if name == "SolverConfig" else solver
        assert getattr(ppkg, name) is getattr(home, name), name


def _field(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape)


@pytest.mark.parametrize("offsets", [(0.0, 0.0, 0.0), (1.0, -2.0, 0.0), (0.25, -0.5, 1.75),
                                     (-1.5, 2.25, -0.125), (3.0, 0.5, -4.0)])
def test_sample_at_offset_matches_jax(offsets):
    arr = _field((6, 7, 8))
    got = fields.sample_at_offset(T(arr), offsets)
    close(got, jfields.sample_at_offset(arr, offsets), f"offsets {offsets}")


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_cell_to_edge_avg_matches_jax(axis):
    arr = _field((5, 6, 7), seed=1)
    got = fields.cell_to_edge_avg(T(arr), axis)
    close(got, jfields.cell_to_edge_avg(arr, axis), f"axis {axis}")


@pytest.mark.parametrize("dtype", [np.float64, np.int8])
@pytest.mark.parametrize("axes", [(0,), (2,), (1, 2), (2, 0, 1)])
def test_block2_max_matches_jax(dtype, axes):
    rng = np.random.default_rng(2)
    arr = (rng.normal(size=(4, 6, 8)) if dtype == np.float64
           else rng.integers(-128, 128, size=(4, 6, 8))).astype(dtype)
    got = tops.block2_max(T(arr), axes)
    assert got.dtype == T(arr).dtype
    exact(got, jops.block2_max(arr, axes), f"axes {axes}")
    exact(tops.block2_sum(T(arr), axes), jops.block2_sum(arr, axes), f"sum, axes {axes}")


def test_native_available(monkeypatch, tmp_path):
    """True here (the host cc builds it); False on a failed build, after
    which the checks still raise rather than fall back."""
    assert native.available()
    monkeypatch.setattr(native, "_mod", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setenv("CC", "false")
    assert not native.available()
    labels = [torch.zeros((2, 2, 2), dtype=torch.int8)]
    with pytest.raises(RuntimeError, match="building avs_native.c failed"):
        native.check_octree_invariants(labels)
    with pytest.raises(RuntimeError, match="building avs_native.c failed"):
        native.export_octree_ply(labels, 1.0, str(tmp_path / "x.ply"))
