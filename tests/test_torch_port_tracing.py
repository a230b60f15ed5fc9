"""The program's spans on the CPU, at small widths:
``utils/profiling.py:span`` (a shared no-op without a profiler, ``vc::``
events under one), the offline converter's spans, the streaming
converter's, and the span names against the benchmark's own
(``vcbench/tracing.py``), whose ``Trace`` assumes that spans of one name
never overlap."""

import ast
import contextlib
import pathlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from alivevc_tpu_torch.config import (
    ContentEncoderConfig,
    DecoderConfig,
    F0EstimatorConfig,
    InferenceConfig,
    StreamingConfig,
)
from alivevc_tpu_torch.infer.offline import OfflineConverter
from alivevc_tpu_torch.infer.streaming import StreamingConverter
from alivevc_tpu_torch.kernels import _lib
from alivevc_tpu_torch.models.content_encoder import ContentEncoder
from alivevc_tpu_torch.models.decoder import Decoder
from alivevc_tpu_torch.models.f0_estimator import F0Estimator
from alivevc_tpu_torch.utils.profiling import PREFIX, span

from test_torch_port_util import CE_KW, DEC_KW, F0_KW

PKG = pathlib.Path(__file__).resolve().parent.parent / "alivevc_tpu_torch"
# the names of the spans vcbench/tracing.py records around the program's calls
BENCHMARK_SPANS = {"request", "step", "retrieval", "filter_level", "resample", "hop"}
STAGES = ("step.f0", "step.content_encoder", "decoder.source")


@pytest.fixture(scope="module")
def models():
    g = torch.Generator().manual_seed(0)
    ce = ContentEncoder(ContentEncoderConfig(**CE_KW), generator=g)
    f0m = F0Estimator(F0EstimatorConfig(**F0_KW), generator=g)
    dec = Decoder(DecoderConfig(**DEC_KW), generator=g)
    for m in (ce, f0m, dec):
        m.eval().requires_grad_(False)
    tgt = np.random.default_rng(0).standard_normal((64, 64)).astype(np.float32)
    return ce, f0m, dec, tgt


def _speech(n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    return (0.3 * np.sin(2 * np.pi * 150 * t) + 0.02 * rng.standard_normal(n)).astype(np.float32)


def _spans(prof) -> dict:
    """{name after the prefix: [(start, end) µs, ...]} of the ``vc::`` events."""
    out = {}
    for e in prof.events():
        if e.name.startswith(PREFIX):
            out.setdefault(e.name[len(PREFIX):], []).append((e.time_range.start, e.time_range.end))
    return {k: sorted(v) for k, v in out.items()}


def _inside(child, parents) -> bool:
    return any(a <= child[0] and child[1] <= b for a, b in parents)


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _spans(prof)


def test_span_without_a_profiler_is_the_shared_no_op():
    assert not torch.autograd._profiler_enabled()
    off = span("offline.step")
    assert off is span("stream.wait") and isinstance(off, contextlib.nullcontext)
    with off, off:                  # reusable and re-entrant
        torch.ones(3).sum()


def test_span_records_vc_events_with_nesting():
    def nested():
        with span("outer"):
            with span("inner"):
                torch.ones(8).sum()
            with span("inner"):
                torch.ones(8).sum()
        return span("outer")

    inner_ctx, spans = _profiled(nested)
    assert not isinstance(inner_ctx, contextlib.nullcontext)
    assert len(spans["outer"]) == 1 and len(spans["inner"]) == 2
    assert all(_inside(s, spans["outer"]) for s in spans["inner"])
    assert spans["inner"][0][1] <= spans["inner"][1][0]


def test_offline_convert_spans_nest_and_leave_the_output_alone(models):
    """One ``offline.convert`` a call (``convert`` resamples and calls the
    16 kHz body without a second one), one ``offline.step`` a batch, each
    stage span once a step, each inside its parent; the output bit-equal to
    an unprofiled call."""
    ce, f0m, dec, tgt = models
    conv = OfflineConverter(ce, f0m, dec, tgt, InferenceConfig(chunk=1600, max_windows_per_step=2),
                            device="cpu")
    wave = _speech(7500)                 # 24 kHz: 5 000 samples, 6 windows, 3 steps
    want = conv.convert(wave, 24_000)
    got, spans = _profiled(lambda: conv.convert(wave, 24_000))
    assert np.array_equal(got, want)
    steps = 3
    assert len(spans["offline.convert"]) == 1
    assert len(spans["offline.step"]) == steps
    assert all(_inside(s, spans["offline.convert"]) for s in spans["offline.step"])
    for name in STAGES:
        assert len(spans[name]) == steps, name
        assert all(_inside(s, spans["offline.step"]) for s in spans[name]), name
        assert all(sum(_inside(s, [p]) for s in spans[name]) == 1 for p in spans["offline.step"]), name
    assert not set(spans) & BENCHMARK_SPANS


@pytest.mark.parametrize("per_step, n, padded", [(2, 6400, True), (8, 6400, False)])
def test_offline_steps_follow_the_window_arithmetic(models, per_step, n, padded):
    """One ``offline.step`` a batch of windows, whether the last batch is
    padded or the file fits one batch; a second file adds as many."""
    ce, f0m, dec, tgt = models
    c = 1600
    conv = OfflineConverter(ce, f0m, dec, tgt, InferenceConfig(chunk=c, max_windows_per_step=per_step),
                            device="cpu")
    m = (n + 2 * c) // c + 1             # windows of stride c over the file padded by c and 4c
    steps = -(-m // per_step)
    assert (m % per_step != 0 and m > per_step) == padded
    _, spans = _profiled(lambda: conv.convert_16k(_speech(n)))
    assert len(spans["offline.convert"]) == 1 and len(spans["offline.step"]) == steps
    _, spans = _profiled(lambda: [conv.convert_16k(_speech(n, seed=s)) for s in (1, 2)])
    assert len(spans["offline.convert"]) == 2 and len(spans["offline.step"]) == 2 * steps
    for name in STAGES:
        assert len(spans[name]) == 2 * steps, name


def test_stream_spans_on_the_cpu(models):
    """The CPU path: the decoder's source span once a hop, and no wait or
    graph launch span (it waits on no event and replays no graph)."""
    ce, f0m, dec, tgt = models
    cfg = StreamingConfig(chunk=640, buffer_size=4)
    conv = StreamingConverter(ce, f0m, dec, tgt, cfg, device="cpu")
    x = _speech(640 * 7)
    conv.prime(x[:640 * 4])
    conv.process_chunk(x[640 * 4:640 * 5])
    outs, spans = _profiled(lambda: [conv.process_chunk(x[640 * h:640 * (h + 1)]) for h in (5, 6)])
    assert all(o.shape == (640,) for o in outs)
    assert len(spans["decoder.source"]) == 2
    assert "stream.wait" not in spans and "stream.replay" not in spans


def _program_span_names() -> set:
    """The names of every ``span("...")`` call in the port's sources."""
    names = set()
    for path in PKG.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Call) and getattr(node.func, "id", None) == "span"
                    and node.args and isinstance(node.args[0], ast.Constant)):
                names.add(node.args[0].value)
    return names


def test_no_program_span_takes_a_benchmark_name():
    names = _program_span_names()
    assert {"offline.convert", "offline.step", "stream.wait", "stream.replay", *STAGES} <= names
    assert _lib.RECOMPUTE_SPAN == PREFIX + "train.plain_recompute"
    assert "train.plain_recompute" in names
    assert not names & BENCHMARK_SPANS
