"""CG (``operator.pcg_flat``): mean ``SolveStats.iterations`` per dispatch,
over the traced window's frames that dispatched once (a frame solved twice
returns the second dispatch's count only)."""


def read(run):
    its = [f["iterations"] for f in run["frames"] if f["entries"].get("solve", 0) == 1]
    return sum(its) / len(its) if its else None
