"""The port's utilities (``alivevc_tpu_torch/utils/``, ``cli/audio_device_list.py``)
on the CPU: the metrics copy against the JAX package's, the profiling helpers
(the host clock and a trace on the CPU; the card by default), the plotting
copy against JAX's (the same PNG bytes for the same array), and the device
lister without PyAudio."""

import json
import time

import numpy as np
import pytest
import torch

from alivevc_tpu.utils import metrics as jmetrics
from alivevc_tpu.utils.plotting import plot_spectrogram as jplot
from alivevc_tpu_torch.cli import audio_device_list
from alivevc_tpu_torch.utils import (
    MetricsLogger,
    RealTimeFactorMeter,
    StepTimer,
    device_time,
    plot_spectrogram,
    profile_trace,
)


def test_metrics_match_jax(tmp_path, capsys):
    mine, theirs = tmp_path / "mine.jsonl", tmp_path / "theirs.jsonl"
    for cls, path in ((MetricsLogger, mine), (jmetrics.MetricsLogger, theirs)):
        log = cls(str(path), print_every=2)
        for step in range(3):
            log.log(step, loss=1.0 / (step + 1), rtf=np.float32(0.25))
        log.close()
    recs = [[json.loads(line) for line in open(p)] for p in (mine, theirs)]
    assert len(recs[0]) == 3
    for a, b in zip(*recs):
        assert a.keys() == b.keys() and a["step"] == b["step"] and a["loss"] == b["loss"]
    out = capsys.readouterr().out.splitlines()
    assert out == ["step 1 loss: 0.5000 rtf: 0.2500"] * 2

    meters = (RealTimeFactorMeter(), jmetrics.RealTimeFactorMeter())
    for m in meters:
        assert m.rtf == float("inf")
        m.update(3.0, 0.5)
        m.update(1.0, 0.5)
    assert meters[0].summary() == meters[1].summary()
    assert meters[0].audio_seconds_per_second == 4.0 and meters[0].rtf == 0.25

    timer = StepTimer(window=2)
    assert timer.tick() is None and timer.steps_per_second == 0.0
    time.sleep(0.01)
    assert timer.tick() >= 0.01 and timer.seconds_per_step >= 0.01


def test_profiling_on_the_cpu(tmp_path):
    x = torch.randn(64, 64)
    secs = device_time(lambda a: a @ a, x, reps=3, device="cpu")
    assert 0.0 < secs < 1.0
    with profile_trace(str(tmp_path / "trace"), device="cpu") as prof:
        (x @ x).sum()
    assert any("mm" in e.key for e in prof.key_averages())
    trace = json.load(open(tmp_path / "trace" / "trace.json"))
    assert trace["traceEvents"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            device_time(lambda: None)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            with profile_trace(str(tmp_path / "t2")):
                pass


def test_plot_spectrogram_equals_jax(tmp_path):
    spec = np.abs(np.random.default_rng(0).standard_normal((40, 80))).astype(np.float32)
    for log in (True, False):
        a, b = str(tmp_path / f"port{log}.png"), str(tmp_path / f"jax{log}.png")
        plot_spectrogram(spec, a, log=log)
        jplot(spec, b, log=log)
        with open(a, "rb") as fa, open(b, "rb") as fb:
            data = fa.read()
            assert data[:8] == b"\x89PNG\r\n\x1a\n" and data == fb.read()


def test_audio_device_list_needs_pyaudio(monkeypatch):
    import builtins

    real = builtins.__import__

    def no_pyaudio(name, *args, **kwargs):
        if name == "pyaudio":
            raise ImportError("No module named 'pyaudio'")
        return real(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_pyaudio)
    with pytest.raises(SystemExit, match="PyAudio"):
        audio_device_list.main([])
