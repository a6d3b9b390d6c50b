"""Name parity of the port with the JAX package, read from both packages'
sources with ``ast`` (neither is imported).

Every public top-level name of a JAX module (a function, a class, an
assigned name, and in an ``__init__.py`` the names it imports) must have a
counterpart of the same name in the port's module of the same path, unless
it is listed in DIVERGENCES with its reason.  Two files were renamed in the
port (RENAMED).  Private names (a leading ``_``) are out of scope.  The
second test keeps the list from going stale: each entry must still name
something the JAX module has and the port's lacks.
"""

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
JAX_PKG = REPO / "adaptiveviscositysolver_tpu"
PORT_PKG = REPO / "adaptiveviscositysolver_tpu_torch"

RENAMED = {
    "ops/pallas_apply.py": "ops/fused_apply.py",
    "parallel/shard_pallas.py": "parallel/shard_fused.py",
}

_KINDS = "classify's kind code, re-exported; the port's kernels read classify's own"
_C2C = ("the JAX glue comes in a gather and a matmul variant; the port has one of "
        "each view: up_view, up_adjoint, cs_view, cs_adjoint")
_VMEM = ("TPU VMEM routing; the port routes by the card's L2 (route_budget, level_modes, "
         "tau_bytes)")

# (JAX file, name) -> why the port has no counterpart of that name
DIVERGENCES = {
    ("operator.py", "pcg"): "the pytree CG: nothing in the port called it; pcg_flat takes "
                            "the same grid dicts",
    ("operator.py", "tree_axpy"): "a helper of the pytree pcg only",
    ("operator.py", "tree_dot"): "a helper of the pytree pcg only",
    ("ops/pallas_apply.py", "FLUID"): _KINDS,
    ("ops/pallas_apply.py", "UNASSIGNED"): _KINDS,
    ("ops/pallas_apply.py", "SOLIDBOUNDARY"): _KINDS,
    ("ops/pallas_apply.py", "OUTSIDE"): _KINDS,
    ("ops/pallas_apply.py", "MAX_HALO"): "the Pallas kernels' DMA halo; the port's is HALO_X",
    ("ops/pallas_apply.py", "BRICK_SIZES"): "the Pallas y-brick sizes; the port's x-row "
                                            "bricks are sized from the L2 budget",
    ("ops/pallas_apply.py", "VMEM_LIMIT"): _VMEM,
    ("ops/pallas_apply.py", "fits_vmem"): _VMEM,
    ("ops/pallas_apply.py", "fused_vmem_estimate"): _VMEM,
    ("ops/pallas_apply.py", "brick_vmem_estimate"): _VMEM,
    ("ops/pallas_apply.py", "make_pallas_operator"): "the Pallas operator's constructor; the "
                                                     "port's is make_fused_operator",
    ("ops/pallas_apply.py", "up_view_c2c"): _C2C,
    ("ops/pallas_apply.py", "up_adjoint_c2c"): _C2C,
    ("ops/pallas_apply.py", "cs_view_c2c"): _C2C,
    ("ops/pallas_apply.py", "cs_adjoint_c2c"): _C2C,
    ("ops/pallas_apply.py", "up_view_mm"): _C2C,
    ("ops/pallas_apply.py", "up_adjoint_mm"): _C2C,
    ("ops/pallas_apply.py", "cs_view_mm"): _C2C,
    ("ops/pallas_apply.py", "cs_adjoint_mm"): _C2C,
    ("parallel/shard_pallas.py", "MAX_HALO"): "the port's sharded halo is HALO_X",
    ("parallel/shard_pallas.py", "fill_halo_canon"): "the port fills a frame's halo on the "
                                                     "packed kind bytes (HaloPlan.fill)",
    ("parallel/shard_pallas.py", "sharded_pallas_pcg"): "the port's sharded CG is "
                                                        "sharded_fused_pcg",
    ("utils/cancel.py", "poll_host"): "the JAX io_callback target; the port polls the flag "
                                      "on the host (operator.py), with no device callback",
}


def public_names(path: Path) -> set:
    """Public top-level names of one module's source."""
    init = path.name == "__init__.py"
    names = set()

    def walk(body):
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                names.add(node.name)
            elif isinstance(node, ast.Assign):
                names.update(n.id for t in node.targets for n in ast.walk(t)
                             if isinstance(n, ast.Name))
            elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
                names.add(node.target.id)
            elif init and isinstance(node, (ast.Import, ast.ImportFrom)):
                names.update((a.asname or a.name).split(".")[0] for a in node.names)
            elif isinstance(node, (ast.If, ast.Try)):
                walk(node.body)
                walk(node.orelse)
                for handler in getattr(node, "handlers", []):
                    walk(handler.body)
                walk(getattr(node, "finalbody", []))

    walk(ast.parse(path.read_text()).body)
    return {n for n in names if not n.startswith("_")}


def jax_modules():
    return sorted(p.relative_to(JAX_PKG).as_posix() for p in JAX_PKG.rglob("*.py"))


def port_file(rel: str) -> Path:
    return PORT_PKG / RENAMED.get(rel, rel)


def test_every_public_jax_name_has_a_port_counterpart():
    missing = []
    for rel in jax_modules():
        port = port_file(rel)
        assert port.exists(), f"{rel} has no port module ({port.relative_to(REPO)})"
        for name in sorted(public_names(JAX_PKG / rel) - public_names(port)):
            if (rel, name) not in DIVERGENCES:
                missing.append(f"{rel}: {name}")
    assert not missing, missing


@pytest.mark.parametrize("rel,name", sorted(DIVERGENCES))
def test_divergence_list_is_current(rel, name):
    assert DIVERGENCES[(rel, name)]
    assert name in public_names(JAX_PKG / rel), f"the JAX {rel} no longer has {name}"
    assert name not in public_names(port_file(rel)), f"the port's {rel} now has {name}"
