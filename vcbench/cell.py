"""One run of one cell, found by name in ``BENCHMARK.json``: its
configuration file, its traffic mix (whose ``kind`` names the generator and
driver ``traffic/<kind>.py``), its limits (``checks/<cell>.json``) and, in a
traced run, the per-layer metrics that list it (``metrics/<metric>.py``).

Nothing here names a cell, a configuration or a metric: adding any of them
adds files and entries only.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "alivevc_tpu")


def load_module(path: Path) -> ModuleType:
    """A file of the benchmark loaded by path (its name may hold dots)."""
    name = "vcbench_" + "".join(ch if ch.isalnum() else "_" for ch in str(path.relative_to(HERE)))
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Spec:
    """What a run of ``workload`` reads: the cell's entry, its
    configuration, its traffic, its limits and the metrics it reports."""

    def __init__(self, bench: dict, workload: str, root: Path):
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json (has {sorted(cells)})")
        self.cell = cells[workload]
        self.name = workload
        conf = next(c for c in bench["configs"] if c["name"] == self.cell["config"])
        self.config = read_json(root / conf["file"])
        self.traffic = read_json(HERE / "traffic" / f"{self.cell['traffic']}.json")
        self.checks = read_json(HERE / "checks" / f"{workload}.json")

        def lists(metric):
            return workload in metric.get("workloads", [w["name"] for w in bench["workloads"]])

        self.end_to_end = [m for m in bench["end_to_end"] if lists(m)]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if workload in m.get("workloads", []) or
                          ("workloads" not in m and m["moves"] in reported)]

    def kind(self) -> ModuleType:
        return load_module(HERE / "traffic" / f"{self.traffic['kind']}.py")


def forbidden_modules() -> list:
    """Top-level names in ``sys.modules`` of JAX or the JAX package,
    compared whole (``alivevc_tpu_torch`` is not ``alivevc_tpu``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def judge(checks: Dict[str, dict]) -> bool:
    return all(c["value"] is not None and c["value"] <= c["limit"] for c in checks.values())


def per_layer_metrics(spec: Spec, view) -> Dict[str, dict]:
    """Each listed metric's reader, given the traced run's view; a reader
    that finds nothing returns None and the metric is left out."""
    out = {}
    for m in spec.per_layer:
        value = load_module(HERE / "metrics" / f"{m['name']}.py").read(view)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def result_line(spec: Spec, res: dict, trace: bool, view=None) -> dict:
    """The run's last line: correct, attempted, failed, metrics, device,
    (breakdown), and the numbers compared with their limits last."""
    checks = res["checks"]
    correct = res["failed"] == 0 and res["attempted"] > 0 and judge(checks)
    if trace:
        metrics = per_layer_metrics(spec, view)
    else:
        metrics = {m["name"]: {"value": res["end_to_end"][m["name"]], "unit": m["unit"]}
                   for m in spec.end_to_end}
    line = {"correct": correct, "attempted": res["attempted"], "failed": res["failed"],
            "metrics": metrics, "device": res["device"]}
    if trace and view is not None and view.breakdown is not None:
        line["breakdown"] = view.breakdown
    line["checks"] = checks
    return line


def run(spec: Spec, seed: int, seconds: float, trace: bool, device: str, t_start: float) -> dict:
    """Set up, warm up, measure, check: the kind's ``run``."""
    return spec.kind().run(spec, seed=seed, seconds=seconds, trace=trace, device=device,
                           t_start=t_start)
