"""Shared by the harness's CPU tests: the benchmark's files on the path, and
a cell's spec at a size a test can hold (narrow models, short audio)."""

import copy
import json
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent.parent
ROOT = HERE.parent
for p in (str(HERE), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_MODEL = {
    "content_encoder": {"internal_channels": 16, "hidden_channels": 32, "output_channels": 24, "num_layers": 2},
    "f0_estimator": {"internal_channels": 16, "hidden_channels": 32, "output_channels": 400, "num_layers": 2},
    "decoder": {"content_channels": 24, "channels": 16, "hidden_channels": 32, "num_layers": 2,
                "num_harmonics": 8, "filter_channels": [2, 4, 4, 8], "filter_dilations": 2},
}


def tiny(spec):
    """The cell's spec with tiny widths and short traffic (CPU tests only)."""
    spec = copy.deepcopy(spec)
    for part, keys in TINY_MODEL.items():
        spec.config["model"][part].update(keys)
    t = spec.traffic
    if t["kind"] == "offline_files":
        t.update(min_s=0.5, max_s=1.6, pool=3, library_rows=64, check_requests=2, trace_requests=2)
        t["infer"].update(chunk=4800, max_windows_per_step=4)
    else:
        t.update(target_s=1.0, library_tokens=32, warmup_hops=2)
    return spec


@pytest.fixture(scope="session")
def bench():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


@pytest.fixture()
def tiny_spec(bench):
    import cell

    return lambda workload: tiny(cell.Spec(bench, workload, ROOT))
