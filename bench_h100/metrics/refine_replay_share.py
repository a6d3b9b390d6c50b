"""Refinement: the share of the CG's applies replayed from a CUDA graph
(``apply.replay`` entries over ``cg.apply`` entries), over the traced
window's frames that dispatched once.  One eager apply and one capture a
dispatch give 1 - 1/applies; an inner CG whose every apply runs eager
reads 0."""


def read(run):
    frames = [f for f in run["frames"] if f["entries"].get("solve", 0) == 1]
    applies = sum(f["entries"].get("cg.apply", 0) for f in frames)
    if not applies:
        return None
    return sum(f["entries"].get("apply.replay", 0) for f in frames) / applies
