"""The port's probe tools (counterparts of the JAX package's ``tools/``),
run as ``python -m adaptiveviscositysolver_tpu_torch.tools.<name>``:

* ``calibrate_bandwidth`` -- the banded apply (T1) against ``copy_`` of
  the same bytes: the card's achievable streaming rate;
* ``profile_levels`` -- one apply taken apart: each level's kernels, the
  level-0 stream floor (T2) and a one-op floor;
* ``time_kernels`` -- each matvec kernel's time per apply at buckling-96,
  -192 and -256's routes (card only; it times another checkout's package
  too, for an A/B in one run).

The first two run on the card (``--device cpu`` exists for the tests; its
times are host-clock times of the plain versions, not device times).
"""

from __future__ import annotations

import time
from typing import Callable

import torch


def check_device(device) -> torch.device:
    """The device a tool measures on; a missing card is an error, never a
    CPU run."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the probe tools measure the card "
                           "(--device cpu runs the plain versions, for the tests)")
    return device


def device_name(device) -> str:
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu (host clock, plain versions)"


# device clock cycles the card spins per timed call before the timed calls
# start (about 1 ms at the H100's clock): the host queues the calls while
# the device waits, so an event pair times the device's work, not the
# host's time to launch it
SPIN_CYCLES_PER_CALL = 2_000_000


def call_ms(fn: Callable[[], object], reps: int, device) -> float:
    """Mean milliseconds of one ``fn()`` over ``reps`` calls after one
    warm-up.  On the card: CUDA events around each call, with the L2 cache
    flushed before it (a write of twice its size), so every call finds its
    inputs in device memory, as one CG apply finds the last one's; the
    calls are queued behind a spin of the device, so a call whose host
    work is shorter than its device work is timed without launch gaps.  On
    the CPU: the host clock."""
    device = torch.device(device)
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    l2 = torch.cuda.get_device_properties(device).L2_cache_size
    flush = torch.empty(2 * l2, dtype=torch.uint8, device=device)
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
    torch.cuda.synchronize(device)
    torch.cuda._sleep(SPIN_CYCLES_PER_CALL * reps)
    for start, stop in events:
        flush.zero_()
        start.record()
        fn()
        stop.record()
    torch.cuda.synchronize(device)
    return sum(a.elapsed_time(b) for a, b in events) / reps
