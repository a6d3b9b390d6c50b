"""The harness's result line, and what it does without a card or without
the program beside it."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from _h100 import run, small_cell

E2E = {"setup_s", "frame_ms", "frame_p90_ms", "peak_mem_gib"}


@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
def test_result_line_keys(trace):
    bench = run.load_json(run.ROOT / "BENCHMARK.json")
    cell, config, traffic = small_cell("buckling-192.steady", states=2, warmup_frames=1)
    res = run.run_cell(cell, config, traffic, 2**31 + 3, 0.5, trace, "cpu",
                       per_layer=run.cell_metrics(bench, cell["name"], "per_layer"),
                       trace_dir=run.ROOT / "build" / "bench_trace_test")
    want = {"correct", "attempted", "failed", "metrics", "device", "checks"}
    assert set(res) == want | ({"breakdown"} if trace else set())
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(res["device"])
    names = set(res["metrics"])
    if trace:
        assert names and not names & E2E
        assert names <= {m["name"] for m in bench["per_layer"]}
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        assert res["metrics"]["dispatches_per_frame"]["value"] == 1.0
    else:
        assert names == E2E
    for v in res["metrics"].values():
        assert set(v) == {"value", "unit"} and v["value"] == v["value"]
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(res)


def test_without_a_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, str(run.HERE / "run.py"), "--workload",
                          "beam-64.steady", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=run.ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "correct: false" in out.stderr


def test_alone_in_a_directory_no_result(tmp_path):
    """A checkout that holds only BENCHMARK.json and the benchmark's folder
    has no program to run: the run fails before any result."""
    shutil.copy(run.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(run.HERE, tmp_path / "bench_h100",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    code = ("import sys; sys.path.insert(0, 'bench_h100'); import run; "
            "b = run.load_json(run.ROOT / 'BENCHMARK.json'); "
            "c, f, t = run.find_cell(b, 'buckling-192.steady'); "
            "print(run.run_cell(c, dict(f, n=16), dict(t, states=1, warmup_frames=0), 1, 0.1, "
            "False, 'cpu'))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "adaptiveviscositysolver_tpu_torch" in out.stderr
