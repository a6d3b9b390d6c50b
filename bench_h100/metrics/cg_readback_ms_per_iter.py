"""CG: the host wall of the stop test's read-back per iteration (the
program's ``cg.converged`` span, where the host waits for the device to
catch up), over the unprofiled frames of the traced window that
dispatched once."""


def read(run):
    frames = [f for f in run["timing_frames"] if f["entries"].get("solve", 0) == 1]
    its = sum(f["iterations"] for f in frames)
    if not its or not any("cg.converged" in f["stage_s"] for f in frames):
        return None
    return 1e3 * sum(f["stage_s"].get("cg.converged", 0.0) for f in frames) / its
