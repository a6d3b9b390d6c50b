"""The Jacobi CG's fused vector update (``operator._fused_jacobi_pcg`` over
``ops/cg_update.py``) on the CPU, through the kernels' plain versions:
against the loop of ``operator._flat_pcg`` on the 16^3 beam's
``cuda-plain`` system, its spans, which solves take it, and the plain
versions' formulas and checks.  ``operator._fuses`` takes the fused loop
on the card only: the tests that route a CPU solve through it show
``_fuses`` its ``b`` as a card tensor, and the others call
``operator._fused_jacobi_pcg`` directly; the kernels themselves are held
to the plain versions in ``tests/test_torch_gpu.py``."""

import collections
import types

import numpy as np
import pytest
import torch

from adaptiveviscositysolver_tpu_torch import operator, scenes, solver
from adaptiveviscositysolver_tpu_torch.config import SolverConfig
from adaptiveviscositysolver_tpu_torch.ops import cg_update as cg
from adaptiveviscositysolver_tpu_torch.utils import cancel


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The suite runs in parallel processes: one thread each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _rearm():
    cancel.clear()
    yield
    cancel.clear()


def _on_card(b):
    """What ``operator._fuses`` reads of ``b``, as if ``b`` were on the card."""
    return types.SimpleNamespace(device=torch.device("cuda"), dtype=b.dtype)


def _fused_on_cpu(monkeypatch):
    """CPU solves routed as the card's: ``_fuses`` sees ``b`` on the card."""
    fuses = operator._fuses
    monkeypatch.setattr(operator, "_fuses",
                        lambda b, precond, dot: fuses(_on_card(b), precond, dot))


def _cfg():
    return SolverConfig(octree_levels=3, tolerance=1e-5, max_iterations=400,
                        dtype=torch.float32, apply_impl="cuda")


class Counting(dict):
    """A ``stage_times`` dict that counts its writes, as the benchmark's."""

    def __init__(self):
        super().__init__()
        self.entries = collections.Counter()

    def __setitem__(self, key, value):
        self.entries[key] += 1
        super().__setitem__(key, value)


@pytest.fixture(scope="module")
def beam16():
    state = scenes.beam(n=16, device="cpu")
    return state, solver.build_system(state, 0.02, _cfg(), device="cpu")


def _pcg(sys_, **kw):
    pack, _ = operator.make_packer({k: tuple(v.shape)
                                    for k, v in sys_.embed_tree(sys_.rhs).items()})
    x, it, rel, applies = operator.pcg_flat(
        sys_.apply_A, sys_.embed_tree(sys_.rhs), sys_.embed_tree(sys_.guess),
        sys_.embed_tree(sys_.diag, fill=1.0), 1e-5, 400, **kw)
    return pack(x), it, float(rel), applies


def _spd(n=96, seed=3):
    """A dense SPD float64 matrix with a spread diagonal, and a rhs."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    a = q @ np.diag(np.geomspace(1.0, 1e3, n)) @ q.T + np.diag(rng.uniform(1, 50, n))
    return torch.tensor(a), torch.tensor(rng.standard_normal(n))


def _dense_pcg(a, b, dtype, **kw):
    """pcg_flat of ``a x = b`` on one grid of ``dtype``, from 0."""
    a, b = a.to(dtype), b.to(dtype)
    shape = (len(b), 1, 1)

    def apply_A(u):
        return {(0, 0): (a @ u[(0, 0)].reshape(-1)).reshape(shape)}

    return operator.pcg_flat(apply_A, {(0, 0): b.reshape(shape)},
                             {(0, 0): torch.zeros(shape, dtype=dtype)},
                             {(0, 0): torch.diagonal(a).reshape(shape)}, 1e-6, 2000, **kw)


def test_fused_loop_matches_todays_loop(beam16, monkeypatch):
    """The fused loop against the loop of _flat_pcg on the same system:
    iterations within +-1, x within 1e-5 relative (2-norm), both at the
    tolerance, the same applies per iteration."""
    _, sys_ = beam16
    x_t, it_t, rel_t, applies_t = _pcg(sys_)
    _fused_on_cpu(monkeypatch)
    x_f, it_f, rel_f, applies_f = _pcg(sys_)
    assert it_t > 16 and abs(it_f - it_t) <= 1, (it_f, it_t)
    assert rel_t <= 1e-5 and rel_f <= 1e-5
    assert applies_t == it_t + 1 and applies_f == it_f + 1
    assert float(torch.linalg.vector_norm(x_f - x_t)) <= 1e-5 * float(
        torch.linalg.vector_norm(x_t))


def test_fused_loop_spans_and_launches(beam16, monkeypatch):
    """A solve through the fused loop: ``cg.update`` once an iteration,
    ``cg.vector`` twice and ``cg.precond`` once as in today's loop, every
    wrapper once an iteration; without the fused loop no ``cg.update``."""
    state, _ = beam16
    log = Counting()
    todays = solver.solve_viscosity(state, 0.02, _cfg(), device="cpu", stage_times=log)
    assert "cg.update" not in log.entries
    _fused_on_cpu(monkeypatch)
    cg.reset_launch_counts()
    log = Counting()
    out = solver.solve_viscosity(state, 0.02, _cfg(), device="cpu", stage_times=log)
    st, n = out.stats, log.entries
    assert st.solve_path == "cuda-plain" and st.residual <= 1e-5
    assert abs(st.iterations - todays.stats.iterations) <= 1
    assert n["cg.update"] == n["cg.precond"] == st.iterations
    assert n["cg.vector"] == 2 * st.iterations
    assert n["cg.converged"] == st.iterations + 1 and n["cg.apply"] == st.applies
    # the plain versions run on CPU tensors, and count no launch
    assert cg.launch_counts == {"cg_update": 0, "cg_jacobi": 0, "cg_direction": 0}


@pytest.mark.parametrize("case", ["jacobi-float32", "cpu", "float64", "custom-dot", "cheb3"])
def test_fuses_takes_float32_jacobi_on_the_card_only(case):
    """``operator._fuses``: a float32 card ``b``, Jacobi and torch.dot;
    CPU tensors, float64, another dot (the sharded CG's) and a
    preconditioner (Chebyshev's) are refused."""
    b = torch.zeros(4, dtype=torch.float64 if case == "float64" else torch.float32)
    precond = (lambda r: r) if case == "cheb3" else None
    dot = (lambda u, v: torch.dot(u, v)) if case == "custom-dot" else torch.dot
    got = operator._fuses(b if case == "cpu" else _on_card(b), precond, dot)
    assert got == (case == "jacobi-float32"), case


@pytest.mark.parametrize("case", ["jacobi-float32", "cpu", "float64", "custom-dot", "cheb3"])
def test_which_solves_take_the_fused_loop(monkeypatch, case):
    """A float32 Jacobi solve with torch.dot on the card (here: shown to
    ``_fuses`` as on the card) takes the fused loop; CPU tensors
    (``_fuses`` as shipped), float64, another dot (the sharded CG's) and a
    Chebyshev preconditioner take today's loop, and still converge."""
    a, b = _spd()
    if case != "cpu":
        _fused_on_cpu(monkeypatch)
    calls = []
    fused = operator._fused_jacobi_pcg

    def spy(*args, **kw):
        calls.append(1)
        return fused(*args, **kw)

    monkeypatch.setattr(operator, "_fused_jacobi_pcg", spy)
    dtype = torch.float64 if case == "float64" else torch.float32
    if case == "custom-dot":
        bf, inv = b.float(), 1.0 / torch.diagonal(a).float()
        _, it, rr = operator._flat_pcg(lambda v: a.float() @ v, bf, torch.zeros_like(bf), inv,
                                       1e-12 * torch.dot(bf, bf), 2000,
                                       dot=lambda u, v: torch.dot(u, v))
        rel = float(torch.sqrt(rr / torch.dot(bf, bf)))
    else:
        _, it, rel, _ = _dense_pcg(a, b, dtype, cheb_degree=3 if case == "cheb3" else 1)
        rel = float(rel)
    assert len(calls) == (1 if case == "jacobi-float32" else 0), case
    assert it > 10 and rel <= 1e-6, (it, rel)


def test_fused_loop_leaves_x0_and_b_unwritten():
    """The fused loop starts from a nonzero x0, and returns x in a vector
    of its own: the caller's x0 and b are as they were."""
    a, b = _spd()
    a, b = a.float(), b.float()
    x0 = 0.1 * torch.ones_like(b)
    b_in, x0_in = b.clone(), x0.clone()
    invd = 1.0 / torch.diagonal(a)
    x, it, rr = operator._fused_jacobi_pcg(lambda v: a @ v, b, x0, invd,
                                           1e-12 * torch.dot(b, b), 2000, 0)
    assert torch.equal(b, b_in) and torch.equal(x0, x0_in)
    assert x.data_ptr() not in (x0.data_ptr(), b.data_ptr())
    assert float(rr) <= 1e-12 * float(torch.dot(b, b)) and it > 10
    want = torch.linalg.solve(a.double(), b.double())
    assert float(torch.linalg.vector_norm(x.double() - want)) <= 1e-4 * float(
        torch.linalg.vector_norm(want))


def test_fused_loop_cancels_at_the_next_poll():
    """``cancel_poll`` in the fused loop: a request stops the solve at the
    first poll, as in today's loop."""
    a, b = _spd()
    _, it_ref, _, _ = _dense_pcg(a, b, torch.float32)
    assert it_ref > 16
    a, b = a.float(), b.float()
    threshold = 1e-12 * torch.dot(b, b)
    cancel.request()
    _, it_c, rr_c = operator._fused_jacobi_pcg(lambda v: a @ v, b, torch.zeros_like(b),
                                               1.0 / torch.diagonal(a), threshold, 2000, 8)
    assert it_c == 8 and float(rr_c) > float(threshold)


def _vectors(n, seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(n, generator=g) for _ in range(4)]


@pytest.mark.parametrize("n", [1, 4097])
def test_plain_versions_compute_the_iteration(n):
    """The three plain versions, one iteration: x, r, z, p as today's
    loop forms them (bit for bit), the whole r.r and r.z in the first
    partial, zeros after, and rr, rz' from the partials."""
    x, r, p, ap = _vectors(n, n)
    invd = torch.rand(n, generator=torch.Generator().manual_seed(1)) + 0.5
    rz = torch.tensor(0.75)
    pap = torch.tensor(1.5)
    want_x, want_r = x + (rz / pap) * p, r - (rz / pap) * ap
    part, part_z = torch.full((3,), 7.0, dtype=torch.float64), torch.zeros(3, dtype=torch.float64)
    cg.cg_update(x, r, p, ap, rz, pap, part)
    assert torch.equal(x, want_x) and torch.equal(r, want_r)
    r64 = r.double()
    assert torch.equal(part[1:], torch.zeros(2, dtype=torch.float64))
    assert float(part[0]) == pytest.approx(float(r64 @ r64), rel=1e-12)
    z = torch.empty(n)
    cg.cg_jacobi(r, invd, z, part_z)
    assert torch.equal(z, invd * r)
    assert float(part_z[0]) == pytest.approx(float(r64 @ z.double()), rel=1e-12)
    rr, rz_new = torch.tensor(0.0), torch.tensor(0.0)
    want_p = z + (torch.tensor(float(part_z.sum())) / rz) * p
    cg.cg_direction(z, p, part, part_z, rz, rr, rz_new)
    assert float(rr) == np.float32(float(part.sum()))
    assert float(rz_new) == np.float32(float(part_z.sum()))
    assert torch.equal(p, want_p)


@pytest.mark.parametrize("bad", ["float64-vector", "short-vector", "strided-vector",
                                 "float32-partials", "rz-is-rz-new", "partial-counts"])
def test_wrappers_refuse_what_the_kernels_do_not_take(bad):
    n = 64
    x, r, p, ap = _vectors(n, 0)
    z = torch.empty(n)
    rz, rr, rz_new = torch.tensor(1.0), torch.tensor(0.0), torch.tensor(0.0)
    part, part_z = torch.zeros(2, dtype=torch.float64), torch.zeros(2, dtype=torch.float64)
    if bad == "float64-vector":
        call = lambda: cg.cg_update(x, r, p.double(), ap, rz, rz, part)  # noqa: E731
    elif bad == "short-vector":
        call = lambda: cg.cg_jacobi(r, torch.ones(n - 1), z, part)  # noqa: E731
    elif bad == "strided-vector":
        call = lambda: cg.cg_jacobi(r, torch.ones(2 * n)[::2], z, part)  # noqa: E731
    elif bad == "float32-partials":
        call = lambda: cg.cg_jacobi(r, torch.ones(n), z, part.float())  # noqa: E731
    elif bad == "rz-is-rz-new":
        call = lambda: cg.cg_direction(z, p, part, part_z, rz, rr, rz)  # noqa: E731
    else:
        call = lambda: cg.cg_direction(z, p, part, part_z[:1], rz, rr, rz_new)  # noqa: E731
    with pytest.raises(ValueError):
        call()


def test_grid_and_partials_on_the_cpu():
    """One block, so one partial, for CPU vectors of any length."""
    assert cg.grid_blocks(20_000_000, "cpu") == 1
    part = cg.partials(5, torch.device("cpu"))
    assert part.dtype == torch.float64 and tuple(part.shape) == (1,)
