"""Apply and kernels: the host wall of one operator apply in the CG (the
program's ``cg.apply`` span: unpack, the glue, the kernel launches, pack),
summed over the unprofiled frames of the traced window that dispatched
once and divided by their applies (the span's entries)."""


def read(run):
    frames = [f for f in run["timing_frames"] if f["entries"].get("solve", 0) == 1]
    applies = sum(f["entries"].get("cg.apply", 0) for f in frames)
    if not applies:
        return None
    return 1e3 * sum(f["stage_s"].get("cg.apply", 0.0) for f in frames) / applies
