"""Apply and kernels: the host wall of the kernel wrappers per operator
apply (the program's ``apply.kernels`` span: the input checks, the
descriptors and the launches), summed over the unprofiled frames of the
traced window that dispatched once and divided by their applies (the
``cg.apply`` span's entries)."""


def read(run):
    frames = [f for f in run["timing_frames"] if f["entries"].get("solve", 0) == 1]
    applies = sum(f["entries"].get("cg.apply", 0) for f in frames)
    if not applies or not any("apply.kernels" in f["stage_s"] for f in frames):
        return None
    return 1e3 * sum(f["stage_s"].get("apply.kernels", 0.0) for f in frames) / applies
