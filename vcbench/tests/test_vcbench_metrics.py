"""The per-layer readers and the trace arithmetic on a hand-made trace:
device operations at known times, launched inside known spans."""

import types

import numpy as np
import pytest

import cell
import tracing
import work


def fake_trace(ops, spans):
    """ops: (start, end, name, launch) in ns; spans: {name: [(a, b)]}."""
    tr = object.__new__(tracing.Trace)
    tr.start = np.array([o[0] for o in ops], np.int64)
    tr.end = np.array([o[1] for o in ops], np.int64)
    tr.names = [o[2] for o in ops]
    tr.launch = np.array([o[3] for o in ops], np.int64)
    tr.spans = {k: sorted(v) for k, v in spans.items()}
    tr._starts = {k: np.array([a for a, _ in v], np.int64) for k, v in tr.spans.items()}
    tr.linked = len(ops)
    tr.busy_s_, tr.busy_e_ = tracing._merge(tr.start, tr.end)
    return tr


MS = 1_000_000


def offline_view(bench):
    from conftest import ROOT

    spec = cell.Spec(bench, "offline-fp32-long", ROOT)
    # one request [0, 10 ms]: a step [1, 9] launching retrieval [2, 3] and a
    # filter level [4, 5]; device ops: 2 ms retrieval, 1 ms filter, 1 ms other
    ops = [(2 * MS, 4 * MS, "knn_tile", 2 * MS + 1), (5 * MS, 6 * MS, "filter_wide", 4 * MS + 1),
           (7 * MS, 8 * MS, "gemm", 6 * MS), (8 * MS, 8 * MS + MS // 2, "Memcpy DtoH", 9 * MS + 5)]
    spans = {"request": [(0, 10 * MS)], "step": [(1 * MS, 9 * MS)], "retrieval": [(2 * MS, 3 * MS)],
             "filter_level": [(4 * MS, 5 * MS)]}
    tr = fake_trace(ops, spans)
    calls = {"retrieval": [(7200, 100_352, 768, "fp32", "high")],
             "filter_level": [(16, 4500, 256, 64, 8, 5, 6, 450, "fp32")]}
    v = types.SimpleNamespace(spec=spec, trace=tr, calls=calls,
                              counters={"steps": 1, "windows_computed": 16, "windows_cut": 12},
                              precision=spec.config["precision"], model=spec.config["model"],
                              library_rows=100_352, hops=None, t0=0, t1=10 * MS, window_s=0.01,
                              busy_s=tr.busy_s(0, 10 * MS))
    return spec, v


def test_trace_arithmetic():
    tr = fake_trace([(0, 4, "a", 0), (2, 6, "b", 1), (8, 9, "c", 7)], {"s": [(0, 1)], "t": [(6, 8)]})
    assert tr.busy_s(0, 10) == pytest.approx(7e-9)
    assert tr.idle_gaps(0, 10) == [(6, 8), (9, 10)]
    assert list(tr.launched_in("s")) == [True, True, False]
    assert list(tr.launched_in("t")) == [False, False, True]
    assert tr.idle_by_span(0, 10, ["t", "s"], "none") == {"t": 2e-9, "s": 0.0, "none": 1e-9}


def test_offline_readers(bench):
    spec, v = offline_view(bench)
    m = cell.per_layer_metrics(spec, v)
    assert m["window_pad_share.offline"]["value"] == pytest.approx(25.0)
    assert m["knn_roofline.offline"]["value"] == pytest.approx(
        100 * work.knn_call(7200, 100_352, 768, "fp32", "high")["bound_s"] / 2e-3)
    assert m["filter_roofline.offline"]["value"] == pytest.approx(
        100 * work.filter_level_call(16, 4500, 256, 64, 8, 5, 6, 450, "fp32", "tf32")["bound_s"] / 1e-3)
    assert m["frame_models_ms_per_step.offline"]["value"] == pytest.approx(1.0)
    assert m["device_idle_share.offline"]["value"] == pytest.approx(55.0)
    flops = 12 * work.window_flops(spec.config["model"], 100_352, 3 * 48_000)
    assert m["step_mfu.offline"]["value"] == pytest.approx(100 * flops / 0.01 / 495e12)
    b = tracing.breakdown(v.trace, 0, 10 * MS, [("retrieval", "retrieval")], ["step", "request"])
    assert b["device_ops"][0] == ["retrieval", pytest.approx(2e-3)]
    assert ["copies (memcpy, memset)", pytest.approx(5e-4)] in b["device_ops"]
    assert dict(b["idle_gaps"]) == {"step": pytest.approx(3.5e-3), "request": pytest.approx(2e-3)}


def test_stream_readers(bench):
    from conftest import ROOT

    spec = cell.Spec(bench, "stream-fp32-60ms", ROOT)
    # two hops: due at 0 and 60 ms, each returning 4 ms after due, 3 ms busy
    hops = [(0, MS, 4 * MS, 3e-3), (60 * MS, 61 * MS, 64 * MS, 3e-3)]
    v = types.SimpleNamespace(spec=spec, trace=object(), hops=hops, hop_frames=24, library_rows=887,
                              precision=spec.config["precision"], model=spec.config["model"])
    m = cell.per_layer_metrics(spec, v)
    assert m["hop_device_ms.stream"]["value"] == pytest.approx(3.0)
    assert m["device_idle_share.stream"]["value"] == pytest.approx(25.0)
    flops = 24 * sum(work.frame_flops(spec.config["model"], 887).values())
    assert m["hop_mfu.stream"]["value"] == pytest.approx(100 * flops / 4e-3 / 495e12)


def test_readers_find_nothing(bench):
    from conftest import ROOT

    for w in ("offline-fp32-long", "stream-fp32-60ms"):
        spec = cell.Spec(bench, w, ROOT)
        empty = types.SimpleNamespace(spec=spec, trace=None, hops=None, calls=None, counters=None)
        assert cell.per_layer_metrics(spec, empty) == {}
