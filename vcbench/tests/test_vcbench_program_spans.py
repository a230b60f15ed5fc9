"""The readers of the program's own spans (``offline.convert``,
``offline.step``, the step's stages and the stream's waits) on hand-made
traces: device operations at known times, launched inside known spans."""

import types

import pytest

import cell
from test_vcbench_metrics import MS, fake_trace


def test_program_span_readers(bench):
    """The offline readers of the program's own spans: one file
    (``offline.convert`` [1, 19] ms) of two steps ([2, 8] and [10, 16]),
    each step's stages launching known device time; a resample before the
    first step and a copy after the last."""
    from conftest import ROOT

    spec = cell.Spec(bench, "offline-fp32-long", ROOT)

    def ns(t):
        return int(round(t * MS))

    ops = [(ns(1.2), ns(1.8), "resample", ns(1.1)), (ns(17), ns(17.5), "Memcpy DtoH", ns(16.5))]
    spans = {"request": [(0, ns(20))], "offline.convert": [(ns(1), ns(19))], "offline.step": []}
    for s in (0, 8):
        spans["offline.step"].append((ns(2 + s), ns(8 + s)))
        # each stage: its span and the interval on the device of the one operation it launches
        for name, a, b, d0, d1 in (("step.f0", 2.5, 3, 3, 3.5), ("step.content_encoder", 3, 4, 3.5, 5),
                                   ("retrieval", 4, 5, 5, 6), ("decoder.source", 5, 6, 6, 7)):
            spans.setdefault(name, []).append((ns(a + s), ns(b + s)))
            ops.append((ns(d0 + s), ns(d1 + s), name, ns(a + s) + 1))
    tr = fake_trace(ops, spans)
    v = types.SimpleNamespace(spec=spec, trace=tr, calls={}, counters={"steps": 2}, hops=None,
                              precision=spec.config["precision"], model=spec.config["model"],
                              library_rows=100_352, t0=0, t1=20 * MS, window_s=0.02,
                              busy_s=tr.busy_s(0, 20 * MS))
    m = cell.per_layer_metrics(spec, v)
    # the step is busy 4 of its 6 ms; the file 0.6 + 2 x 4 + 0.5 of its 18 ms
    assert m["step_idle_ms_per_step.offline"]["value"] == pytest.approx(2.0)
    assert m["driver_idle_ms_per_file.offline"]["value"] == pytest.approx(18 - 9.1 - 2 * 2.0)
    assert m["f0_estimator_ms_per_step.offline"]["value"] == pytest.approx(0.5)
    assert m["content_encoder_ms_per_step.offline"]["value"] == pytest.approx(1.5)
    assert m["source_ms_per_step.offline"]["value"] == pytest.approx(1.0)
    # a file that ends after the traced window is not counted; its steps are
    v.t1 = 18 * MS
    m = cell.per_layer_metrics(spec, v)
    assert "driver_idle_ms_per_file.offline" not in m
    assert m["step_idle_ms_per_step.offline"]["value"] == pytest.approx(2.0)


def test_hop_host_reader(bench):
    """Two hops (the benchmark's ``hop`` spans), 4 ms with 2.6 ms of event
    waits and 3 ms with 1.6 ms, each with a 0.4 ms graph launch; a wait
    outside any hop (a ``flush``) is not counted."""
    from conftest import ROOT

    spec = cell.Spec(bench, "stream-fp32-60ms", ROOT)
    spans = {"hop": [(MS, 5 * MS), (61 * MS, 64 * MS)],
             "stream.replay": [(int(1.5 * MS), int(1.9 * MS)), (int(61.4 * MS), int(61.8 * MS))],
             "stream.wait": [(int(1.2 * MS), int(1.3 * MS)), (2 * MS, int(4.5 * MS)),
                             (int(61.1 * MS), int(61.2 * MS)), (62 * MS, int(63.5 * MS)), (70 * MS, 71 * MS)]}
    tr = fake_trace([(2 * MS, 4 * MS, "graph", int(1.6 * MS))], spans)
    hops = [(0, MS, 5 * MS, 2e-3), (60 * MS, 61 * MS, 64 * MS, 0.0)]
    v = types.SimpleNamespace(spec=spec, trace=tr, hops=hops, hop_frames=24, library_rows=887, t0=0,
                              t1=64 * MS, precision=spec.config["precision"], model=spec.config["model"])
    m = cell.per_layer_metrics(spec, v)
    assert m["hop_host_ms.stream"]["value"] == pytest.approx(1.0)
    # the eager hop launches no graph: only the waits are taken off
    del tr.spans["stream.replay"]
    assert cell.per_layer_metrics(spec, v)["hop_host_ms.stream"]["value"] == pytest.approx(1.4)
    # without the program's spans (the parent's program) the reader finds nothing
    del tr.spans["stream.wait"]
    assert "hop_host_ms.stream" not in cell.per_layer_metrics(spec, v)
