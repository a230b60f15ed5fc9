"""The PyTorch port stands alone: importing every module of
``alivevc_tpu_torch`` (and ``chip_smoke.py``) in a fresh interpreter, and
running the native WORLD labeler, leaves ``jax`` and the JAX package
``alivevc_tpu`` (its ``native_bindings`` included) out of ``sys.modules``,
and no source file of the port (``train_dp_probe.py`` included) names
either in an import.  Nor ``transformers``: the card's machine has none, and
the port's WavLM teacher is its own."""

import ast
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "alivevc_tpu_torch"

_PROBE = r"""
import importlib, pkgutil, sys, runpy
import alivevc_tpu_torch
names = [m.name for m in pkgutil.walk_packages(alivevc_tpu_torch.__path__, "alivevc_tpu_torch.")]
for name in names:
    importlib.import_module(name)
runpy.run_path(sys.argv[1], run_name="chip_smoke_probe")
import numpy as np
from alivevc_tpu_torch.ops.world import compute_f0
assert compute_f0(np.zeros((1, 3200), np.float32)).shape == (1, 10)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "alivevc_tpu", "transformers"))
print(len(names), bad, " ".join(names))
sys.exit(1 if bad else 0)
"""


def test_importing_the_port_loads_no_jax():
    proc = subprocess.run([sys.executable, "-c", _PROBE, str(ROOT / "chip_smoke.py")],
                          cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_modules = int(proc.stdout.split()[0])
    assert n_modules >= 30
    for mod in ("parallel.mesh", "parallel.sharded_knn", "parallel.distributed_vc",
                "infer.streaming", "ops.resample", "io.audio", "io.checkpoint",
                "models.voice_library", "cli.common", "cli.inference", "cli.realtime_inference",
                "native_bindings", "ops.world", "parallel.halo", "utils.plotting",
                "utils.profiling", "cli.audio_device_list", "models.discriminator", "train.losses",
                "train.optim", "train.gan", "train.fine_tune", "train.f0", "train.library_gen",
                "train.dp", "train.state", "io.dataset", "cli.train_decoder", "cli.fine_tune",
                "cli.train_f0_estimator", "cli.generate_voice_library", "models.wavlm",
                "io.teacher", "train.distill", "cli.train_content_encoder", "cli.export",
                "compat.torch_import", "compat.weights", "compat.jax_train_state"):
        assert f"alivevc_tpu_torch.{mod}" in proc.stdout.split()


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_source_file_imports_jax_or_the_jax_package():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "train_dp_probe.py"]
    assert len(files) >= 30
    for path in ("parallel/sharded_knn.py", "infer/streaming.py", "ops/resample.py", "io/audio.py",
                 "io/checkpoint.py", "models/voice_library.py", "cli/realtime_inference.py",
                 "native_bindings.py", "ops/world.py", "parallel/halo.py", "utils/profiling.py",
                 "models/discriminator.py", "train/gan.py", "train/fine_tune.py", "train/f0.py",
                 "train/optim.py", "io/dataset.py", "cli/train_decoder.py", "models/wavlm.py",
                 "io/teacher.py", "train/distill.py", "cli/train_content_encoder.py",
                 "cli/export.py", "compat/torch_import.py", "compat/jax_train_state.py",
                 "compat/weights.py", "train/state.py", "cli/common.py"):
        assert PKG / path in files
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "alivevc_tpu", "transformers"), f"{path}: imports {mod}"
