"""Build and bind the CUDA kernels of ``csrc/``.

Each source is compiled by ``nvcc`` into a shared library with a plain C
interface (no PyTorch headers, so a build takes seconds) under
``build/torch_kernels/`` at the repository root, at first use, and loaded
with ``ctypes``.  The library name carries a hash of the sources and flags,
so an edited source is rebuilt and a stale library is never loaded.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v"]

# library stem -> (main source, headers it includes)
SOURCES = {"fused_apply": ("fused_apply.cu", ("fused_apply.cuh",))}

_loaded: Dict[str, ctypes.CDLL] = {}
build_log: Dict[str, dict] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the CUDA toolkit")


def library_path(stem: str) -> Path:
    main, headers = SOURCES[stem]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in (main,) + tuple(headers):
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"lib{stem}_{h.hexdigest()[:16]}.so"


def build(stem: str = "fused_apply") -> dict:
    """Compile ``stem``'s library unless it is already built.  Returns
    ``{"seconds", "cached", "log"}``; raises if ``nvcc`` fails."""
    out = library_path(stem)
    if out.exists():
        build_log[stem] = {"seconds": 0.0, "cached": True, "log": ""}
        return build_log[stem]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path()] + NVCC_FLAGS + ["-o", str(tmp), str(CSRC / SOURCES[stem][0])]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    build_log[stem] = {"seconds": time.perf_counter() - t0, "cached": False, "log": log}
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {stem} (exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    return build_log[stem]


def load(stem: str = "fused_apply") -> ctypes.CDLL:
    """The loaded library (built first if missing), argtypes set."""
    lib = _loaded.get(stem)
    if lib is not None:
        return lib
    build(stem)
    lib = ctypes.CDLL(str(library_path(stem)))
    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    lib.avs_frame_bytes.argtypes = []
    lib.avs_frame_bytes.restype = ll
    lib.avs_max_levels.argtypes = []
    lib.avs_max_levels.restype = ll
    for fn in (lib.avs_tau_launch, lib.avs_dt_launch):
        fn.argtypes = [vp, ll, vp]
        fn.restype = ctypes.c_int
    _loaded[stem] = lib
    return lib
