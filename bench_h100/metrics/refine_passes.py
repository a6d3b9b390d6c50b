"""Refinement (``operator.pcg_refined``): refinement passes per dispatch,
counted as the program's ``refine.inner`` span entries (one per pass's
float32 inner solve), over the traced window's frames that dispatched
once.  A program without the span reads nothing."""


def read(run):
    frames = [f for f in run["frames"] if f["entries"].get("solve", 0) == 1]
    if not any("refine.inner" in f["entries"] for f in frames):
        return None
    return sum(f["entries"].get("refine.inner", 0) for f in frames) / len(frames)
