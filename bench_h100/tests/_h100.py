"""Shared helpers of the benchmark's tests: the harness's modules on the
path, and a cell cut to a size the CPU runs in seconds."""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

import run  # noqa: E402


def small_cell(workload="buckling-192.steady", n=16, **traffic_changes):
    """(cell, configuration at ``n``^3, traffic with ``traffic_changes``)."""
    bench = run.load_json(run.ROOT / "BENCHMARK.json")
    cell, config, traffic = run.find_cell(bench, workload)
    return cell, dict(config, n=n), dict(traffic, **traffic_changes)
