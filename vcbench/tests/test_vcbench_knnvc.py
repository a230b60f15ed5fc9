"""The cell ``offline-knnvc-libri`` (kind ``offline_utterances``) on the CPU
at a size a test holds: a sound run is correct, the control is not, a run
with the timed path broken underneath is not; the yardstick and the
readers."""

import copy
import time
import types

import numpy as np
import pytest

import cell
import work
import work_knnvc

KNNVC_TINY = {"wavlm": dict(hidden_size=64, num_layers=8, num_heads=4, intermediate_size=128, conv_dim=[32] * 7,
                            num_conv_pos_embedding_groups=4, num_conv_pos_embeddings=16),
              "vocoder": dict(input_channels=64, hidden_channels=16, upsample_initial_channel=32)}


def knnvc_spec(bench):
    from conftest import ROOT

    spec = copy.deepcopy(cell.Spec(bench, "offline-knnvc-libri", ROOT))
    for part, keys in KNNVC_TINY.items():
        spec.config["model"][part].update(keys)
    spec.traffic.update(pool=4, matching_s=10.0, max_s=3.0, median_s=1.5, min_s=0.5, check_requests=2,
                        trace_requests=2)
    spec.checks["limits"].update(mel_l1=1e-3, mel_l1_p95=1e-3)     # read at this size, as TINY_LIMITS
    return spec


def test_knnvc_sound_run_is_correct_and_the_control_is_not(bench):
    spec = knnvc_spec(bench)
    res = cell.run(spec, 3_000_000_001, 1.0, False, "cpu", time.perf_counter())
    line = cell.result_line(spec, res, False)
    assert line["correct"], line["checks"]
    assert set(line["metrics"]) == {"audio_s_per_s", "setup_s"}
    assert not cell.judge(spec.kind().control(spec, 5, "cpu", 1.0))


def test_knnvc_silent_or_altered_output_is_not_correct(bench, monkeypatch):
    from alivevc_tpu_torch.infer import offline

    spec = knnvc_spec(bench)
    real = offline.convert_knnvc
    monkeypatch.setattr(offline, "convert_knnvc", lambda *a, **k: real(*a, **k) * 1e-3)
    line = cell.result_line(spec, cell.run(spec, 7, 0.5, False, "cpu", time.perf_counter()), False)
    assert not line["correct"] and line["checks"]["out_ac_rms_min_neg"]["value"] > -0.01
    monkeypatch.setattr(offline, "convert_knnvc", lambda *a, **k: real(*a, **k).roll(320))
    line = cell.result_line(spec, cell.run(spec, 7, 0.5, False, "cpu", time.perf_counter()), False)
    assert not line["correct"] and line["checks"]["mel_l1"]["value"] > 1e-3


def test_knnvc_yardstick_at_the_published_widths(bench):
    spec = cell.Spec(bench, "offline-knnvc-libri", __import__("conftest").ROOT)
    m = spec.config["model"]
    assert work_knnvc.frames(16_000, m["wavlm"]) == 49
    f = work_knnvc.request_flops(m, 7 * 16_000, 23_900)
    per_s = {k: v / 7e9 for k, v in f.items()}
    assert 5.7 < per_s["front_end"] < 5.9 and 7.4 < per_s["layers"] < 7.7
    assert 38 < per_s["vocoder"] < 39 and 2.3 < per_s["knn"] < 2.5
    assert f["knn"] == work.knn_call(349, 23_900, 1024, "fp32", "high")["flops"]
    kind = spec.kind()
    lengths = kind.lengths_s(spec.traffic)
    assert 1.5 < lengths[0] < 1.7 and 24 < lengths[-1] < 26 and 7.2 < np.mean(lengths) < 7.6
    cuts = kind.matching_lengths(spec.traffic, 3_000_000_001)
    assert sum(cuts) == 480 * 16_000 and min(cuts) >= 1.3 * 16_000
    assert 23_800 < sum(work_knnvc.frames(n, m["wavlm"]) for n in cuts) < 24_000


def test_knnvc_readers(bench):
    from conftest import ROOT

    spec = cell.Spec(bench, "offline-knnvc-libri", ROOT)
    ms = 1_000_000
    tr = types.SimpleNamespace(
        spans={"request": [(0, 100 * ms), (100 * ms, 200 * ms)], "knnvc.content": [(0, 30 * ms), (100 * ms, 130 * ms)],
               "wavlm.attention": [(0, 25 * ms)], "knnvc.match": [(30 * ms, 40 * ms), (130 * ms, 140 * ms)],
               "knnvc.vocoder": [(40 * ms, 90 * ms), (140 * ms, 190 * ms)],
               "offline.convert": [(0, 99 * ms), (100 * ms, 199 * ms)],
               "offline.step": [(0, 95 * ms), (100 * ms, 195 * ms)]},
        start=np.array([1, 31, 41, 101, 131, 141]) * ms, end=np.array([21, 36, 81, 121, 136, 181]) * ms)
    tr.launched_in = lambda name: np.array([any(a <= s < b for a, b in tr.spans[name]) for s in tr.start])
    tr.device_s = lambda mask: float((tr.end[mask] - tr.start[mask]).sum()) / 1e9
    tr.busy_s = lambda a, b: float((np.minimum(tr.end, b) - np.maximum(tr.start, a)).clip(0).sum()) / 1e9
    v = types.SimpleNamespace(trace=tr, t0=0, t1=200 * ms, window_s=0.2, busy_s=0.13, model=spec.config["model"],
                              precision=spec.config["precision"], library_rows=23_900, counters={},
                              request_samples=[7 * 16_000, 5 * 16_000])
    got = {m["name"]: cell.load_module(cell.HERE / "metrics" / f"{m['name']}.py").read(v) for m in spec.per_layer}
    assert got["wavlm_ms_per_request.knnvc"] == pytest.approx(20.0)
    assert got["wavlm_attention_ms_per_request.knnvc"] == pytest.approx(10.0)
    assert got["vocoder_ms_per_request.knnvc"] == pytest.approx(40.0)
    assert got["device_idle_share.offline"] == pytest.approx(35.0)
    # each file idles 4 ms in the driver (99 - 95 ms) and 30 ms inside its step (95 ms less 65 ms busy)
    assert got["driver_idle_ms_per_file.offline"] == pytest.approx(4.0)
    assert got["step_idle_ms_per_step.offline"] == pytest.approx(30.0)
    flops = sum(sum(work_knnvc.request_flops(v.model, n, 23_900).values()) for n in v.request_samples)
    assert got["request_mfu.knnvc"] == pytest.approx(100 * flops / 0.2 / 495e12)
    assert 0 < got["knn_roofline.knnvc"] < 100
    v.trace = None
    assert all(cell.load_module(cell.HERE / "metrics" / f"{m['name']}.py").read(v) is None for m in spec.per_layer)
