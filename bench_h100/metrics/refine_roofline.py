"""Refinement on the apply's kernels: the least time the float32 inner
CGs' bytes need at the data sheet's 3.35 TB/s (``roofline.solve_bytes``
over the windows the frame used, from ``solve.cache_info()``, and the
inner iterations in all) over the device-busy time inside the program's
``solve`` span, in percent, over the profiled frames that dispatched
once.  The float64 residuals and each pass's extra apply are not counted,
so it is a lower bound of the share."""

import roofline


def read(run):
    need_s = busy_s = 0.0
    traced = run["trace"]["frames"]
    profiled = run["profiled_frames"]
    if len(traced) != len(profiled):
        return None
    for rec, tr in zip(profiled, traced):
        if len(tr["solve_busy_us"]) != 1 or not rec.get("windows") or not tr["solve_busy_us"][0]:
            continue
        windows = rec["windows"][:rec["levels"]]
        need_s += roofline.solve_bytes(windows, rec["iterations"]) / roofline.HBM_BYTES_PER_S
        busy_s += tr["solve_busy_us"][0] / 1e6
    return 100.0 * need_s / busy_s if busy_s > 0 else None
