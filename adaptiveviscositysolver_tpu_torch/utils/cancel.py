"""Cooperative cancellation of an in-flight solve (port of
``utils/cancel.py``).

The reference polls ``boss->opInterrupt()`` inside its loops (e.g.
reference Source/HDK_OctreeGrid.cpp:227-228).  Here the CG loop reads this
process-wide flag every ``SolverConfig.cancel_poll_iters`` iterations and
stops when it is set; the solve then writes back the partial iterate, and
``stats.residual`` shows it unconverged.  ``request()`` may come from any
thread; ``clear()`` re-arms before the next solve.  The CG already reads
the host every iteration for its stop test, so a poll costs a flag read.
"""

from __future__ import annotations

import threading

_EVENT = threading.Event()


def request() -> None:
    """Ask the in-flight solve (if any) to stop at its next poll."""
    _EVENT.set()


def clear() -> None:
    """Re-arm: forget a previous cancellation request."""
    _EVENT.clear()


def is_requested() -> bool:
    return _EVENT.is_set()
