"""Interpolator and writeback: the program's synchronized
``interpolate_writeback`` and ``writeback`` stage walls per frame,
averaged over the unprofiled frames of the traced window."""

STAGES = ("interpolate_writeback", "writeback")


def read(run):
    frames = run["timing_frames"]
    if not frames or not any(s in f["stage_s"] for f in frames for s in STAGES):
        return None
    return 1e3 * sum(sum(f["stage_s"].get(s, 0.0) for s in STAGES) for f in frames) / len(frames)
