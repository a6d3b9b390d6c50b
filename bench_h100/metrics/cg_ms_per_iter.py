"""CG: the program's synchronized ``solve`` stage wall over its iterations,
over the unprofiled frames of the traced window that dispatched once."""


def read(run):
    frames = [f for f in run["timing_frames"] if f["entries"].get("solve", 0) == 1]
    its = sum(f["iterations"] for f in frames)
    if not its:
        return None
    return 1e3 * sum(f["stage_s"]["solve"] for f in frames) / its
