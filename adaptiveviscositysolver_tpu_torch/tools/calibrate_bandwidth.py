"""Achievable device-memory streaming rate for the banded matvec form
(port of the JAX package's ``tools/calibrate_bandwidth.py``).

The question it answers for the port is S2's: would materialized
coefficient planes, ``A u = sum_s C_s shift(u, s)``, beat the kernels'
in-register rebuild of the coefficients from the packed kinds?  The
banded form is pure multiply-add and reads ``nbands`` planes per output, so
its cost is what the card streams.  This times the hand-written banded
kernel (``ops.probes.banded_apply``, T1) with NBANDS coefficient planes
on the JAX tool's box (104 x 112 x 128 float32: the 96^3 level-0
canonical plane it was sized for), and the same bytes through
``torch.Tensor.copy_`` (device to device) as the card's achievable rate,
and prints both with their effective GB/s.

    python -m adaptiveviscositysolver_tpu_torch.tools.calibrate_bandwidth [nbands] [reps]
"""

from __future__ import annotations

import argparse
import json
from typing import List, Tuple

import torch

from ..ops import probes
from . import call_ms, check_device, device_name

SHAPE = (104, 112, 128)


def make_inputs(nbands: int, shape=SHAPE, device="cuda", seed: int = 0
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """(u, coefficient planes), standard normal from ``seed``."""
    g = torch.Generator().manual_seed(seed)
    u = torch.randn(shape, generator=g).to(device)
    return u, [torch.randn(shape, generator=g).to(device) for _ in range(nbands)]


def run(nbands: int = 15, reps: int = 50, shape=SHAPE, device="cuda") -> dict:
    """Times of the banded kernel and of ``copy_`` moving the same bytes."""
    device = check_device(device)
    u, coeffs = make_inputs(nbands, shape, device)
    nbytes = probes.probe_bytes([u, *coeffs], outputs=1)
    ms = call_ms(lambda: probes.banded_apply(u, coeffs), reps, device)
    # a copy reads and writes each byte: half the bytes each way
    src = torch.randn(nbytes // 8, device=device)
    dst = torch.empty_like(src)
    copy_ms = call_ms(lambda: dst.copy_(src), reps, device)
    return {"device": device_name(device), "nbands": nbands, "shape": list(shape),
            "bytes": nbytes, "ms": ms, "gbs": nbytes / ms / 1e6,
            "copy_bytes": 2 * src.numel() * 4, "copy_ms": copy_ms,
            "copy_gbs": 2 * src.numel() * 4 / copy_ms / 1e6}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("nbands", nargs="?", type=int, default=15)
    ap.add_argument("reps", nargs="?", type=int, default=50)
    ap.add_argument("--device", default="cuda", help="cuda (default); cpu for the tests")
    a = ap.parse_args(argv)
    r = run(a.nbands, a.reps, device=a.device)
    print(f"[{r['device']}] banded_apply: nbands={r['nbands']} bytes={r['bytes'] / 1e6:.1f}MB "
          f"{r['ms']:.4f} ms -> {r['gbs']:.0f} GB/s")
    print(f"[{r['device']}] copy_ of the same bytes: {r['copy_ms']:.4f} ms -> "
          f"{r['copy_gbs']:.0f} GB/s")
    print(json.dumps(r))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
