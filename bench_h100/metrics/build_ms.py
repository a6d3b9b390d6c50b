"""Build stages (``fields`` ... ``operator``, with the probes): the
program's synchronized stage walls per frame, summed over the stages
before the CG, averaged over the unprofiled frames of the traced window."""

STAGES = ("probe", "compute_surface_weights", "build_octree", "build_labels",
          "build_stress_stencils", "restrict_velocity", "build_system", "topology_probe")


def read(run):
    frames = run["timing_frames"]
    if not frames or not any(s in f["stage_s"] for f in frames for s in STAGES):
        return None
    return 1e3 * sum(sum(f["stage_s"].get(s, 0.0) for s in STAGES) for f in frames) / len(frames)
