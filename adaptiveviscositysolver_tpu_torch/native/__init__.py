"""Native host runtime (port of ``native/``): the reference's octree
invariant checks (HDK_OctreeGrid.cpp:988-1304) and its debug geometry
export (cpp:245-308) as a C extension, ``avs_native.c`` beside this file.

The extension is compiled with the host C compiler (``$CC``, default
``cc``) at first use into ``build/native/`` at the repository root, under a
name that carries a hash of the source, and loaded from there; nothing is
written into the package.  A failed build raises: there is no fallback;
``available()`` says whether the build succeeds.
"""

from __future__ import annotations

import hashlib
import importlib.util
import os
import subprocess
import sysconfig
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "avs_native.c"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
_mod = None


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    return BUILD_DIR / f"avs_native_{digest}{suffix}"


def build() -> Path:
    """Compile the extension unless it is built; returns its path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [os.environ.get("CC", "cc"), "-O2", "-shared", "-fPIC",
           f"-I{sysconfig.get_paths()['include']}", str(SOURCE), "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building {SOURCE.name} failed (exit {proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load():
    global _mod
    if _mod is None:
        spec = importlib.util.spec_from_file_location("avs_native", build())
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _mod = mod
    return _mod


def available() -> bool:
    """Whether the extension builds and loads here.  A query only: the
    checks below still raise on a failed build."""
    try:
        _load()
    except (OSError, RuntimeError, ImportError):
        return False
    return True


def _buffers(labels):
    return [np.ascontiguousarray(l.cpu().numpy() if hasattr(l, "cpu") else np.asarray(l),
                                 np.int8) for l in labels]


def check_octree_invariants(labels, max_fails: int = 16):
    """The reference's three octree unit tests (column consistency,
    UP-adjacency, ACTIVE grading and reciprocity) over the label pyramid
    (tensors or arrays, finest first); returns failure strings, [] when
    every invariant holds."""
    return _load().check_octree_invariants(_buffers(labels), max_fails)


def export_octree_ply(labels, dx: float, path: str, origin=(0.0, 0.0, 0.0)) -> int:
    """ACTIVE cell centers as a binary PLY point cloud with pscale and level
    attributes (the analog of outputOctreeGeometry); returns the point
    count."""
    return _load().export_octree_ply(_buffers(labels), float(dx),
                                     tuple(map(float, origin)), str(path))
