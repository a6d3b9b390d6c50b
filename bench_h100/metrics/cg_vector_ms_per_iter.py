"""CG: the host wall of the vector updates and dots per iteration (the
program's ``cg.vector`` spans, twice an iteration), over the unprofiled
frames of the traced window that dispatched once."""


def read(run):
    frames = [f for f in run["timing_frames"] if f["entries"].get("solve", 0) == 1]
    its = sum(f["iterations"] for f in frames)
    if not its or not any("cg.vector" in f["stage_s"] for f in frames):
        return None
    return 1e3 * sum(f["stage_s"].get("cg.vector", 0.0) for f in frames) / its
