"""Build and bind the CUDA kernels of ``csrc/``.

Each source is compiled by ``nvcc`` into a shared library with a plain C
interface (no PyTorch headers, so a build takes seconds) under
``build/torch_kernels/`` at the repository root, at first use, and loaded
with ``ctypes``.  Several sources build in parallel: one ``nvcc`` each,
all started together.  The library name carries a hash of the sources and flags,
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
_MATVEC_HEADERS = ("fused_apply.cuh", "tile.cuh", "tau_tile.cuh", "dt_tile.cuh")
SOURCES = {"fused_apply": ("fused_apply.cu", _MATVEC_HEADERS),
           "level_apply": ("level_apply.cu", _MATVEC_HEADERS),
           "probe_kernels": ("probe_kernels.cu", ("probe_kernels.cuh",))}

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


def build(*stems: str) -> Dict[str, dict]:
    """Compile the libraries of ``stems`` (default: all) that are not built
    yet, one ``nvcc`` per source, all started together.  Returns ``{stem:
    {"seconds", "cached", "log"}}`` (the ``nvcc`` log, kept beside the
    library, so a cached library still reports its registers); raises if
    an ``nvcc`` fails."""
    stems = stems or tuple(SOURCES)
    procs = {}
    for stem in stems:
        out = library_path(stem)
        if out.exists():
            log = out.with_suffix(".log")
            build_log[stem] = {"seconds": 0.0, "cached": True,
                               "log": log.read_text() if log.exists() else ""}
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path()] + NVCC_FLAGS + ["-o", str(tmp), str(CSRC / SOURCES[stem][0])]
        procs[stem] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp, out, time.perf_counter())
    failed = []
    for stem, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        build_log[stem] = {"seconds": time.perf_counter() - t0, "cached": False, "log": log}
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {stem} (exit {proc.returncode}):\n{log}")
        else:
            out.with_suffix(".log").write_text(log)
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return {stem: build_log[stem] for stem in stems}


def load(stem: str) -> ctypes.CDLL:
    """The loaded library (built first if missing).  The modules that call
    its entry points declare their argument types."""
    lib = _loaded.get(stem)
    if lib is None:
        build(stem)
        lib = _loaded[stem] = ctypes.CDLL(str(library_path(stem)))
    return lib
