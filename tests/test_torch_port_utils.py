"""The port's utilities (``alivevc_tpu_torch/utils/``, ``cli/audio_device_list.py``)
on the CPU: the profiler's trace with the program's spans (the card by
default), the plotting copy against JAX's (the same PNG bytes for the same
array), and the device lister without PyAudio."""

import json

import numpy as np
import pytest
import torch

from alivevc_tpu.utils.plotting import plot_spectrogram as jplot
from alivevc_tpu_torch.cli import audio_device_list
from alivevc_tpu_torch.config import DecoderConfig
from alivevc_tpu_torch.models.decoder import Decoder, decoder
from alivevc_tpu_torch.utils import plot_spectrogram, profile_trace

from test_torch_port_util import DEC_KW


def test_profiling_on_the_cpu(tmp_path):
    """``profile_trace`` writes the program's ``vc::`` spans (the decoder's
    source) into the Chrome trace beside the operations."""
    dec = Decoder(DecoderConfig(**DEC_KW), generator=torch.Generator().manual_seed(0)).eval()
    content, f0 = torch.randn(1, 8, 64), torch.full((1, 8, 1), 150.0)
    with torch.no_grad(), profile_trace(str(tmp_path / "trace"), device="cpu") as prof:
        decoder(dec, content, f0)
    assert any("mm" in e.key for e in prof.key_averages())
    names = [e.get("name") for e in json.load(open(tmp_path / "trace" / "trace.json"))["traceEvents"]]
    assert names.count("vc::decoder.source") == 1
    if not torch.cuda.is_available():
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
