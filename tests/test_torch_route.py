"""The solve's route (``solver._route``), a pure function of the config,
the solve's dtype, the device and the rank count: every ``solve_path``
and the refusal of ``apply_impl="cuda"`` in float64 without refinement,
pinned over the whole grid of its inputs.  A CUDA device here is only a
``torch.device``: no card is touched."""

import itertools

import pytest
import torch

from adaptiveviscositysolver_tpu_torch import solver
from adaptiveviscositysolver_tpu_torch.config import SolverConfig

IMPLS = ("auto", "cuda", "v1", "v1-fused")
DTYPES = (torch.float32, torch.float64)
GRID = list(itertools.product(IMPLS, DTYPES, (False, True), ("cpu", "cuda"), (1, 2)))


def _want(impl, dtype, refined, device, ranks):
    """The path each combination takes, written out case by case: None
    where the solve is refused."""
    if refined:
        return "refined"
    if impl in ("v1", "v1-fused"):
        return impl
    if dtype == torch.float64:
        return None if impl == "cuda" else "v1"
    kernels = "cuda" if device == "cuda" else "cuda-plain"
    if ranks > 1:
        return kernels + "-sharded"
    if impl == "auto" and device == "cpu":
        return "v1"
    return kernels


@pytest.mark.parametrize("impl,dtype,refined,device,ranks", GRID,
                         ids=[f"{i}-{str(d)[6:]}-{'refined' if r else 'plain'}-{dv}-{n}rank"
                              for i, d, r, dv, n in GRID])
def test_route_pins_every_solve_path(impl, dtype, refined, device, ranks):
    cfg = SolverConfig(apply_impl=impl, use_iterative_refinement=refined)
    want = _want(impl, dtype, refined, device, ranks)
    if want is None:
        with pytest.raises(ValueError, match="apply_impl='cuda' computes in float32"):
            solver._route(cfg, dtype, torch.device(device), ranks)
        return
    route = solver._route(cfg, dtype, torch.device(device), ranks)
    assert route.path == want
    assert route.refined == refined
    assert route.sharded == want.endswith("-sharded")
    # "auto" resolves to the fused apply where its path is, and under
    # refinement on the card (the float32 inner CG through the kernels)
    auto = "cuda" if want.startswith("cuda") or (refined and device == "cuda") else "v1"
    assert route.impl == (auto if impl == "auto" else impl)
    if not route.sharded:   # a rank count that does not shard changes nothing
        assert route == solver._route(cfg, dtype, torch.device(device), 1)
