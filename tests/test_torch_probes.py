"""The port's probe kernels (ops/probes.py, csrc/probe_kernels.cu) and tools
on the CPU.

* T1: ``plain_banded_apply`` against the JAX tool's own ``banded_kernel``
  (tools/calibrate_bandwidth.py:30) run through ``pallas_call(...,
  interpret=True)``, where ``pltpu.roll`` runs as ``jnp.roll``; boxes
  whose y extent is not a multiple of the shifts make the roll wrap.
* T2: ``plain_stream_floor`` against the same sum in ``jnp`` over the
  float32 inputs of a level-0 frame, pad rows exactly 0.
* The kernels' per-thread work (``csrc/probe_kernels.cuh``) compiled with
  the host C++ compiler and run thread after thread, against the plain
  versions, so the roll, the shift order and the rows are checked here.
Bars: 3e-5 * max|plain| (float32 sums in another order), as chip_smoke.py.
"""

import ctypes
import functools
import importlib.util
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from adaptiveviscositysolver_tpu_torch import scenes, solver
from adaptiveviscositysolver_tpu_torch.config import SolverConfig
from adaptiveviscositysolver_tpu_torch.ops import fused_apply as fa
from adaptiveviscositysolver_tpu_torch.ops import probes
from adaptiveviscositysolver_tpu_torch.tools import calibrate_bandwidth, profile_levels
from tests.test_torch_stages import N, port_test_env  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
TOL = 3e-5


def _close(got, want, what):
    got, want = N(got).astype(np.float64), N(want).astype(np.float64)
    assert got.shape == want.shape, what
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= TOL * scale, (what, np.abs(got - want).max(), scale)


def _jax_banded_kernel():
    spec = importlib.util.spec_from_file_location("jax_calibrate_bandwidth",
                                                  ROOT / "tools" / "calibrate_bandwidth.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.banded_kernel


def _banded_inputs(shape, nb, seed):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal(shape).astype(np.float32)
    return u, [rng.standard_normal(shape).astype(np.float32) for _ in range(nb)]


BANDED = [((4, 10, 8), 5), ((2, 7, 4), 15), ((4, 1, 8), 3), ((2, 2, 4), 1), ((2, 5, 4), 2)]


@pytest.mark.parametrize("shape,nb", BANDED)
def test_plain_banded_apply_matches_jax_kernel(shape, nb):
    u, cs = _banded_inputs(shape, nb, nb)
    tx = 2
    spec = pl.BlockSpec((tx,) + shape[1:], lambda i: (i, 0, 0))
    call = pl.pallas_call(functools.partial(_jax_banded_kernel(), nb), grid=(shape[0] // tx,),
                          in_specs=[spec] * (nb + 1), out_specs=spec,
                          out_shape=jax.ShapeDtypeStruct(shape, jnp.float32), interpret=True)
    want = np.asarray(call(jnp.asarray(u), *map(jnp.asarray, cs)))
    got = probes.banded_apply(torch.from_numpy(u), [torch.from_numpy(c) for c in cs])
    _close(got, want, (shape, nb))


def _level0(n=16, levels=3):
    state = scenes.buckling(n=n, device="cpu")
    sys_ = solver.build_system(state, 1.0 / 24.0, SolverConfig(octree_levels=levels,
                                                               apply_impl="cuda"), device="cpu")
    g = torch.Generator().manual_seed(5)
    u = sys_.embed_tree({k: torch.randn(m.shape, generator=g) * m for k, m in sys_.active.items()})
    args = sys_.apply_A.level_args(u)
    return sys_, probes.floor_inputs(args[0], sys_.apply_A.metas[0])


@pytest.mark.parametrize("i8_weight", [0.0, 1.0])
def test_plain_stream_floor_matches_jnp_sum(i8_weight):
    sys_, inputs = _level0()
    meta = sys_.apply_A.metas[0]
    assert meta.has_parent and [t.dtype for t in inputs].count(torch.int8) == 4
    rows = probes.window_rows(sys_.canons[0])
    assert rows == (fa.PAD, fa.PAD + sys_.canons[0].win[0] + 1)
    got = probes.stream_floor(inputs, rows, i8_weight)
    ins = [jnp.asarray(N(t)) for t in inputs]
    win = sum(t[rows[0]:rows[1]] for t in ins if t.dtype == jnp.float32)
    win = win + i8_weight * sum(t[rows[0]:rows[1]].astype(jnp.int32) for t in ins
                                if t.dtype == jnp.int8).astype(jnp.float32)
    want = jnp.zeros(meta.shape, jnp.float32).at[rows[0]:rows[1]].set(win)
    for k in range(3):
        _close(got[k], want, k)
        assert not bool(got[k][:rows[0]].any()) and not bool(got[k][rows[1]:].any())


HOST_LOOP = r"""
#include "probe_kernels.cuh"
extern "C" {
long long host_banded_bytes() { return (long long)sizeof(AvsBanded); }
long long host_floor_bytes() { return (long long)sizeof(AvsFloor); }
void host_banded(const AvsBanded* A) {
  for (long long t = 0; t < A->nx * A->ny * (A->nz / 4); ++t) avs::banded_point(*A, t);
}
void host_floor(const AvsFloor* F) {
  for (long long t = 0; t < F->cx * F->plane / 4; ++t) avs::floor_point(*F, t);
}
}
"""


@pytest.fixture(scope="module")
def host_probes(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    assert cxx, "a host C++ compiler is needed to check the kernels' work on the CPU"
    d = tmp_path_factory.mktemp("host_probes")
    (d / "host_loop.cpp").write_text(HOST_LOOP)
    csrc = Path(fa.__file__).resolve().parent.parent / "csrc"
    subprocess.run([cxx, "-O1", "-std=c++17", "-shared", "-fPIC", f"-I{csrc}", "-o",
                    str(d / "libhost.so"), str(d / "host_loop.cpp")], check=True,
                   capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(d / "libhost.so"))
    lib.host_banded_bytes.restype = lib.host_floor_bytes.restype = ctypes.c_longlong
    lib.host_banded.argtypes = lib.host_floor.argtypes = [ctypes.c_void_p]
    return lib


def test_host_structs_match_python_layout(host_probes):
    assert host_probes.host_banded_bytes() == ctypes.sizeof(probes._Banded)
    assert host_probes.host_floor_bytes() == ctypes.sizeof(probes._Floor)
    src = (Path(fa.__file__).resolve().parent.parent / "csrc" / "probe_kernels.cuh").read_text()
    for name, value in (("BANDS", probes.MAX_BANDS), ("F32", probes.MAX_F32),
                        ("I8", probes.MAX_I8)):
        assert f"#define AVS_MAX_{name} {value}\n" in src


@pytest.mark.parametrize("shape,nb", [s for s in BANDED if s[0][2] % 4 == 0])
def test_banded_kernel_work_on_host_matches_plain(host_probes, shape, nb):
    u, cs = _banded_inputs(shape, nb, 10 + nb)
    u, cs = torch.from_numpy(u), [torch.from_numpy(c) for c in cs]
    out = torch.full(shape, float("nan"))
    args = probes._Banded(u=u.data_ptr(), out=out.data_ptr(), nx=shape[0], ny=shape[1],
                          nz=shape[2], nb=nb)
    for j, c in enumerate(cs):
        args.c[j] = c.data_ptr()
    host_probes.host_banded(ctypes.addressof(args))
    _close(out, probes.plain_banded_apply(u, cs), (shape, nb))


@pytest.mark.parametrize("i8_weight", [0.0, 1.0])
def test_floor_kernel_work_on_host_matches_plain(host_probes, i8_weight):
    sys_, inputs = _level0()
    rows = probes.window_rows(sys_.canons[0])
    shape = tuple(inputs[0].shape)
    out = [torch.full(shape, float("nan")) for _ in range(3)]
    f32 = [t for t in inputs if t.dtype == torch.float32]
    i8 = [t for t in inputs if t.dtype == torch.int8]
    args = probes._Floor(n_f32=len(f32), n_i8=len(i8), plane=shape[1] * shape[2], row0=rows[0],
                         row1=rows[1], cx=shape[0], i8_weight=i8_weight)
    for k, t in enumerate(f32):
        args.f32[k] = t.data_ptr()
    for k, t in enumerate(i8):
        args.i8[k] = t.data_ptr()
    for k, t in enumerate(out):
        args.out[k] = t.data_ptr()
    host_probes.host_floor(ctypes.addressof(args))
    want = probes.plain_stream_floor(inputs, rows, i8_weight)
    for k in range(3):
        _close(out[k], want[k], k)
        assert torch.equal(out[k][:rows[0]], want[k][:rows[0]])
        assert torch.equal(out[k][rows[1]:], want[k][rows[1]:])


def test_probe_wrappers_take_the_plain_version_only_on_cpu():
    u = torch.zeros((2, 2, 4), device="meta")
    with pytest.raises(ValueError):
        probes.banded_apply(u, [u])
    with pytest.raises(ValueError):
        probes.stream_floor([u], (0, 2))
    with pytest.raises(ValueError):
        probes.banded_apply(torch.zeros(2, 2, 4), [])
    before = dict(probes.launch_counts)
    probes.banded_apply(torch.zeros(2, 2, 4), [torch.zeros(2, 2, 4)])
    probes.stream_floor([torch.zeros(2, 2, 4)], (0, 1))
    assert probes.launch_counts == before


def test_probe_bytes_count_reads_over_rows_and_box_writes():
    u, cs = calibrate_bandwidth.make_inputs(15, device="cpu")
    # the JAX tool's figure: (nb + 2) planes of the 104 x 112 x 128 box
    assert probes.probe_bytes([u, *cs], outputs=1) == 17 * 104 * 112 * 128 * 4
    box = (6, 4, 8)
    ins = [torch.zeros(box), torch.zeros(box, dtype=torch.int8)]
    assert probes.probe_bytes(ins, 3, (2, 5)) == 5 * 3 * 32 + 3 * 4 * 6 * 32


def test_probe_tools_run_on_cpu(capsys):
    assert calibrate_bandwidth.main(["2", "1", "--device", "cpu"]) == 0
    assert profile_levels.main(["16", "1", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "banded_apply" in out and "level 0 stream floor" in out and "host clock" in out


def test_probe_tools_refuse_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        calibrate_bandwidth.run(2, 1, shape=(2, 2, 4), device="cuda")
    with pytest.raises(RuntimeError):
        profile_levels.run(16, 1, device="cuda")


def test_time_kernels_needs_a_card(monkeypatch):
    """tools.time_kernels times the card only: without one it exits before
    building anything, never falling back to the plain versions."""
    from adaptiveviscositysolver_tpu_torch.tools import time_kernels

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        time_kernels.main()
