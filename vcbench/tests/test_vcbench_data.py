"""A cell, a configuration, a traffic mix and a per-layer metric added as
new files and entries, in a copy, are found with no existing file edited."""

import json
import shutil
import subprocess
import sys

from conftest import HERE, ROOT


def test_added_as_files(tmp_path):
    dst = tmp_path / "vcbench"
    shutil.copytree(HERE, dst, ignore=shutil.ignore_patterns("out", "__pycache__"))
    before = {p: p.read_bytes() for p in dst.rglob("*") if p.is_file()}
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    conf = json.loads((dst / "configs" / "alivevc-fp32.json").read_text())
    conf["name"] = "alivevc-fp32-copy"
    (dst / "configs" / "alivevc-fp32-copy.json").write_text(json.dumps(conf))
    mix = json.loads((dst / "traffic" / "daps_takes_44k.json").read_text())
    mix.update(sample_rate=16_000, min_s=1.0, max_s=8.0)
    (dst / "traffic" / "short_clips_16k.json").write_text(json.dumps(mix))
    (dst / "checks" / "offline-fp32-short.json").write_text(json.dumps({"limits": {"mel_l1": 0.1, "mel_l1_p95": 0.5}}))
    (dst / "metrics" / "steps_seen.offline.py").write_text(
        "def read(v):\n    return float(v.counters['steps'])\n")
    bench["configs"].append({"name": "alivevc-fp32-copy", "source": "https://github.com/uthree/ALiVE-VC",
                             "file": "vcbench/configs/alivevc-fp32-copy.json", "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "offline-fp32-short", "config": "alivevc-fp32-copy",
                               "traffic": "short_clips_16k", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "steps_seen.offline", "unit": "1", "better": "lower",
                               "source": "program_counter", "layer": "offline driver", "moves": "audio_s_per_s",
                               "workloads": ["offline-fp32-short"]})
    bench["end_to_end"][0]["workloads"].append("offline-fp32-short")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import sys, json; sys.path.insert(0, %r); import cell, types\n"
        "spec = cell.Spec(json.load(open(%r)), 'offline-fp32-short', __import__('pathlib').Path(%r))\n"
        "assert spec.config['precision']['dtype'] == 'fp32' and spec.traffic['sample_rate'] == 16000\n"
        "assert spec.kind().__name__.endswith('offline_files_py')\n"
        "assert [m['name'] for m in spec.end_to_end] == ['audio_s_per_s', 'setup_s']\n"
        "v = types.SimpleNamespace(counters={'steps': 3})\n"
        "print(json.dumps(cell.per_layer_metrics(spec, v)))\n"
    ) % (str(dst), str(tmp_path / "BENCHMARK.json"), str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.splitlines()[-1]) == {"steps_seen.offline": {"value": 3.0, "unit": "1"}}
    after = {p: p.read_bytes() for p in before}
    assert after == before


def test_missing_program_fails(tmp_path):
    """In a directory holding only BENCHMARK.json and vcbench/, a run exits
    non-zero and prints no result."""
    shutil.copytree(HERE, tmp_path / "vcbench", ignore=shutil.ignore_patterns("out", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run([sys.executable, "vcbench/run.py", "--workload", "stream-fp32-60ms", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], capture_output=True, text=True, cwd=tmp_path)
    assert out.returncode != 0
    assert not any(line.startswith("{") for line in out.stdout.splitlines())


def test_run_refuses_without_a_card():
    out = subprocess.run([sys.executable, str(HERE / "run.py"), "--workload", "offline-fp32-long", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], capture_output=True, text=True, cwd=ROOT)
    import torch

    if torch.cuda.is_available():
        return
    assert out.returncode != 0 and not out.stdout.strip()
