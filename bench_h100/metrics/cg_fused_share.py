"""CG: the share of the CG iterations whose vector update ran in the fused
kernels (``operator._fused_jacobi_pcg``): ``cg.update`` entries over
``cg.precond`` entries (once an iteration on either loop), over the traced
window's frames.  1 when every iteration is fused; 0 for a program whose
CG has no ``cg.update`` span."""


def read(run):
    iterations = sum(f["entries"].get("cg.precond", 0) for f in run["frames"])
    if not iterations:
        return None
    return sum(f["entries"].get("cg.update", 0) for f in run["frames"]) / iterations
