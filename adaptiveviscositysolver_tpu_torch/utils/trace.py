"""The port's host-side tracing: the stages of a frame and the spans inside
them, on the caller's clock and on the profiler's.

Two kinds of interval, each opened by name in a ``with`` statement:

* :func:`stage`: a step of a frame (``build_octree``, ``solve``, ...).
  With a sink, it synchronizes the device at both ends and adds the wall
  to ``sink[name]``.
* :func:`span`: work inside a stage (an apply, the CG's vector updates,
  its stop test, ...).  It never synchronizes; with a sink, it adds the
  host wall of the interval to ``sink[name]``.

The sink is the ``stage_times`` dict a caller hands to
``solver.solve_viscosity``, ``solver.build_system`` or ``make_solver``'s
closure, which make it the current one for the call (:class:`tracing`, a
``contextvars.ContextVar``), so the CG and the apply reach it without a
parameter.  The contract with a caller that counts: every interval that
ends without raising writes ``sink[name]`` exactly once, at its exit (the
seconds summed over the call), so a dict that counts its writes counts the
intervals.

While a profiler runs (``torch.autograd._profiler_enabled()``), an
interval is also a ``record_function`` range, so a trace can put the
device's idle time down to the innermost one.  Inside a loop marked by
:class:`loop`, spans reach the profiler only on iteration 0 and every
``PROFILE_EVERY``-th iteration after it; they reach the sink on every
iteration.  With no sink and no profiler, :func:`stage` and :func:`span`
return one shared no-op object (no ``record_function`` is entered).

The port's spans, by where they open:

* ``operator``: ``cg.apply`` around each CG apply, ``cg.vector``,
  ``cg.precond`` and ``cg.converged`` (the stop test's read-back) in the
  CG's loop; ``apply.capture`` and ``apply.replay`` in ``ApplyGraph``;
  under iterative refinement (``pcg_refined``) ``refine.residual`` around
  each float64 residual (passes + 1 a solve) and ``refine.inner`` around
  each pass's float32 inner solve (passes), whose applies alone open
  ``cg.apply``.
* ``ops/fused_apply``: ``apply.views``, ``apply.kernels``, ``apply.join``
  inside an eager or capturing fused apply.
* ``solver``: ``topology.build`` when a ``Topology`` is built, ``resolve``
  around ``make_solver``'s second dispatch of a frame.
"""

from __future__ import annotations

import contextvars
import time
from typing import Dict, Optional

import torch

# Loop iterations between two that reach the profiler: a trace's reader
# puts each idle gap down to a span by a search over the spans, so every
# iteration's spans in a 6 s window would make reading it take minutes.
PROFILE_EVERY = 16

_profiling = torch.autograd._profiler_enabled
# (sink, device to synchronize or None) of the call in progress, or None
_current: contextvars.ContextVar = contextvars.ContextVar("avs_trace_sink", default=None)
# whether spans reach the profiler (False on a loop's unsampled iterations)
_sampled: contextvars.ContextVar = contextvars.ContextVar("avs_trace_sampled", default=True)


class tracing:
    """``with tracing(stage_times, device):`` makes ``stage_times`` the
    sink of the intervals opened inside (None: no sink); :func:`stage`
    synchronizes ``device`` when it is a CUDA device."""

    __slots__ = ("_value", "_token")

    def __init__(self, stage_times: Optional[Dict[str, float]], device):
        device = torch.device(device)
        self._value = None if stage_times is None else (
            stage_times, device if device.type == "cuda" else None)

    def __enter__(self):
        self._token = _current.set(self._value)
        return self

    def __exit__(self, *exc):
        _current.reset(self._token)
        return False


class loop:
    """``with loop() as lp:`` marks a loop whose iterations :func:`span`
    samples for the profiler: iteration 0 on entry, then ``lp.at(it)``
    before iteration ``it``."""

    __slots__ = ("_token",)

    def __enter__(self):
        self._token = _sampled.set(True)
        return self

    def __exit__(self, *exc):
        _sampled.reset(self._token)
        return False

    @staticmethod
    def at(it: int) -> None:
        _sampled.set(it % PROFILE_EVERY == 0)


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Interval:
    __slots__ = ("_name", "_sink", "_sync", "_range", "_t0")

    def __init__(self, name: str, sink, sync, profiled: bool):
        self._name = name
        self._sink = sink
        self._sync = sync
        self._range = torch.profiler.record_function(name) if profiled else None

    def __enter__(self):
        if self._range is not None:
            self._range.__enter__()
        if self._sink is not None:
            if self._sync is not None:
                torch.cuda.synchronize(self._sync)
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._sink is not None and exc_type is None:
            if self._sync is not None:
                torch.cuda.synchronize(self._sync)
            sink = self._sink
            sink[self._name] = sink.get(self._name, 0.0) + time.perf_counter() - self._t0
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
        return False


def stage(name: str):
    """A stage of the frame (see the module's docstring)."""
    cur = _current.get()
    profiled = _profiling()
    if cur is None:
        return _Interval(name, None, None, True) if profiled else _OFF
    return _Interval(name, cur[0], cur[1], profiled)


def span(name: str):
    """A span inside a stage (see the module's docstring)."""
    cur = _current.get()
    profiled = _profiling() and _sampled.get()
    if cur is None:
        return _Interval(name, None, None, True) if profiled else _OFF
    return _Interval(name, cur[0], None, profiled)
