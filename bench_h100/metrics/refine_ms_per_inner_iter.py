"""Refinement: the program's synchronized ``solve`` stage wall over its
inner iterations in all (``SolveStats.iterations`` of a refined solve:
every pass's float32 CG), so the float64 residuals, the passes' embeds and
crops and the inner CGs, per inner iteration; over the unprofiled frames
of the traced window that dispatched once."""


def read(run):
    frames = [f for f in run["timing_frames"] if f["entries"].get("solve", 0) == 1]
    its = sum(f["iterations"] for f in frames)
    if not its:
        return None
    return 1e3 * sum(f["stage_s"]["solve"] for f in frames) / its
