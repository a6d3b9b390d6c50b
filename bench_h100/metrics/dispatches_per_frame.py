"""Frame closure (``solver.make_solver``): dispatches of ``solve_viscosity``
per frame, counted as the program's ``solve`` stage entries over the traced
window's frames.  Above 1 means frames solved again."""


def read(run):
    counts = [f["entries"].get("solve", 0) for f in run["frames"]]
    if not counts or not any(counts):
        return None
    return sum(counts) / len(counts)
