"""Frame closure (``solver.make_solver``): new ``solver.Topology`` entries
built per frame (the program's ``topology.build`` span's entries: routed
canons, routes and operator buffers), over every frame of the traced
window, as ``dispatches_per_frame`` counts: a frame solved again is the
one that builds.  A program that records the CG's spans (``cg.converged``)
and no build reads 0."""


def read(run):
    frames = run["frames"]
    if not any("cg.converged" in f["entries"] for f in frames):
        return None
    return sum(f["entries"].get("topology.build", 0) for f in frames) / len(frames)
