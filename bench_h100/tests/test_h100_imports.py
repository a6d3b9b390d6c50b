"""Nothing a run loads is JAX or the JAX package, and the reference loads
nothing of the program (top-level module names compared whole: the
program's name begins with the JAX package's)."""

import ast
import subprocess
import sys

from _h100 import run

JAX_NAMES = {"jax", "jaxlib", "flax", "adaptiveviscositysolver_tpu"}
PROGRAM = "adaptiveviscositysolver_tpu_torch"


def _top_levels_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\nprint(sorted({m.split('.')[0]"
                          " for m in sys.modules}))"], cwd=run.ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    names = _top_levels_after(
        "import sys; sys.path.insert(0, 'bench_h100'); import run\n"
        "b = run.load_json(run.ROOT / 'BENCHMARK.json')\n"
        "c, f, t = run.find_cell(b, 'beam-64.steady')\n"
        "r = run.run_cell(c, dict(f, n=16), dict(t, states=1, warmup_frames=1), 9, 0.1, True, "
        "'cpu', per_layer=run.cell_metrics(b, c['name'], 'per_layer'), "
        "trace_dir=run.ROOT / 'build' / 'bench_trace_test')\n"
        "assert not run.forbidden_modules()")
    assert PROGRAM in names
    assert not names & JAX_NAMES


def test_the_reference_loads_nothing_of_the_program():
    names = _top_levels_after("import sys; sys.path.insert(0, 'bench_h100')\n"
                              "import reference.solve")
    assert "torch" in names
    assert PROGRAM not in names and not names & JAX_NAMES


def test_no_benchmark_source_imports_jax_and_the_reference_imports_no_program():
    for path in sorted(run.HERE.rglob("*.py")):
        tree = ast.parse(path.read_text())
        mods = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods.add(node.module.split(".")[0])
        assert not mods & JAX_NAMES, path
        if "reference" in path.parts:
            assert mods <= {"__future__", "dataclasses", "math", "numpy", "typing", "torch"}, (path, mods)
