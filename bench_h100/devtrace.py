"""Reading a torch.profiler chrome trace: the host spans, the device's
kernels, copies and fills, the device-busy union, and the breakdown.

``busy_us`` and the span and device-event parse are copied from
``chip_smoke.py`` (its ``busy_us`` and ``trace_frame``)."""

from __future__ import annotations

import collections
import json
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
FRAME_SPAN = "bench.frame"


def busy_us(intervals, lo, hi):
    """Microseconds of [lo, hi) covered by at least one (start, end)."""
    busy, end = 0.0, lo
    for s, e in sorted(intervals):
        s, e = max(s, end), min(e, hi)
        if e > s:
            busy += e - s
        end = max(end, e)
    return busy


def load(path: Path) -> Tuple[List[Tuple[str, float, float]], List[Tuple[float, float, str]]]:
    """(host spans [(name, start, end)] of the ``record_function`` ranges,
    device events [(start, end, name)]), in trace microseconds."""
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    spans = [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("cat") == "user_annotation" and "dur" in e]
    device = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
              if e.get("cat") in DEVICE_CATS and "dur" in e]
    return spans, device


def merged(intervals: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of intervals as disjoint sorted intervals."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def summarize(spans, device) -> Dict[str, object]:
    """Per traced frame (``bench.frame`` spans, in order): its bounds, the
    device-busy microseconds in it, and its ``solve`` spans with the busy
    microseconds of each; over the traced window (first frame's start to
    the last one's end): busy and wall seconds, and the breakdown."""
    frames = sorted((s, e) for n, s, e in spans if n == FRAME_SPAN)
    if not frames:
        return {"frames": [], "busy_s": None, "window_s": None, "breakdown": None}
    intervals = [(a, b) for a, b, _ in device]
    solves = sorted((s, e) for n, s, e in spans if n == "solve")
    out_frames = []
    for lo, hi in frames:
        inside = [(s, e) for s, e in solves if lo <= s and e <= hi]
        out_frames.append({"start_us": lo, "end_us": hi, "busy_us": busy_us(intervals, lo, hi),
                           "solve_busy_us": [busy_us(intervals, s, e) for s, e in inside]})
    lo, hi = frames[0][0], frames[-1][1]
    busy = busy_us(intervals, lo, hi)
    return {"frames": out_frames, "busy_s": busy / 1e6, "window_s": (hi - lo) / 1e6,
            "breakdown": breakdown(spans, device, lo, hi)}


def breakdown(spans, device, lo, hi, top: int = 10) -> Dict[str, list]:
    """``device_ops``: the device operations with the most time in
    [lo, hi), summed by name; ``idle_gaps``: the device's idle time in
    [lo, hi), summed by the innermost host span that holds each gap's
    midpoint (the program's stage, or ``bench.frame`` between stages)."""
    per_op: Dict[str, float] = collections.defaultdict(float)
    for a, b, name in device:
        if lo <= a < hi:
            per_op[name[:120]] += (min(b, hi) - a) / 1e6
    busy = merged([(max(a, lo), min(b, hi)) for a, b, _ in device if b > lo and a < hi])
    gaps, end = [], lo
    for s, e in busy + [(hi, hi)]:
        if s > end:
            gaps.append((end, s))
        end = max(end, e)
    inner = sorted(((n, s, e) for n, s, e in spans if s < hi and e > lo), key=lambda t: t[2] - t[1])
    per_gap: Dict[str, float] = collections.defaultdict(float)
    for s, e in gaps:
        mid = 0.5 * (s + e)
        name = next((n for n, a, b in inner if a <= mid < b), "outside spans")
        per_gap[name] += (e - s) / 1e6
    rank = lambda d: sorted(([k, v] for k, v in d.items()), key=lambda kv: -kv[1])[:top]
    return {"device_ops": rank(per_op), "idle_gaps": rank(per_gap)}
