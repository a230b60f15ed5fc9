"""The cell ``offline-rvc40k-vocals`` (kind ``offline_rvc``) on the CPU at a
size a test holds: a sound run is correct, the control is not, a run with
the timed path broken underneath is not; a near-tie of cut points is judged
at the program's cuts; the yardstick and the readers."""

import copy
import time
import types

import numpy as np
import pytest

import cell
import work
import work_rvc

RVC_TINY = {"hubert": dict(hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64, conv_dim=[16] * 7,
                           num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4),
            "synthesizer": dict(phone_channels=32, inter_channels=8, hidden_channels=16, filter_channels=32,
                                n_layers=2, gin_channels=8, spk_embed_dim=3),
            "generator": dict(initial_channel=8, upsample_initial_channel=64, gin_channels=8),
            "driver": dict(x_center=2, x_query=1, x_max=3)}


def rvc_spec(bench):
    from conftest import ROOT

    spec = copy.deepcopy(cell.Spec(bench, "offline-rvc40k-vocals", ROOT))
    m = spec.config["model"]
    m["hubert"].update(RVC_TINY["hubert"])
    m["synthesizer"].update(RVC_TINY["synthesizer"])
    m["synthesizer"]["generator"].update(RVC_TINY["generator"])
    m["driver"].update(RVC_TINY["driver"])
    spec.traffic.update(pool=3, median_s=4.0, sigma=0.3, min_s=3.0, max_s=5.5, index_s=12.0, piece_s=1.5,
                        check_requests=2, trace_requests=2)
    spec.checks["limits"].update(mel_l1=1e-3, mel_l1_p95=1e-3)     # read at this size
    return spec


def test_rvc_sound_run_is_correct_and_the_control_is_not(bench):
    spec = rvc_spec(bench)
    res = cell.run(spec, 3_000_000_001, 1.0, False, "cpu", time.perf_counter())
    line = cell.result_line(spec, res, False)
    assert line["correct"], line["checks"]
    assert set(line["metrics"]) == {"audio_s_per_s", "setup_s"}
    assert not cell.judge(spec.kind().control(spec, 5, "cpu", 1.0))


def test_rvc_altered_output_or_cuts_are_not_correct(bench, monkeypatch):
    from alivevc_tpu_torch.infer import offline

    spec = rvc_spec(bench)
    real = offline.convert_rvc_segment
    monkeypatch.setattr(offline, "convert_rvc_segment", lambda *a, **k: real(*a, **k) * 1e-3)
    line = cell.result_line(spec, cell.run(spec, 7, 0.5, False, "cpu", time.perf_counter()), False)
    assert not line["correct"] and line["checks"]["out_ac_rms_min_neg"]["value"] > -0.01
    monkeypatch.setattr(offline, "convert_rvc_segment", real)
    cuts = offline.rvc_split_points
    monkeypatch.setattr(offline, "rvc_split_points", lambda *a, **k: [c + 1600 for c in cuts(*a, **k)])
    line = cell.result_line(spec, cell.run(spec, 7, 0.5, False, "cpu", time.perf_counter()), False)
    assert not line["correct"] and line["checks"]["mel_l1"]["value"] > 1e-3


def test_rvc_near_tie_cut_is_judged_at_the_programs_cut(bench, monkeypatch):
    """A cut one frame away whose moving sum equals the reference's within
    the near-tie margin is judged with the reference at the program's cut,
    and the run is correct."""
    from alivevc_tpu_torch.infer import offline
    from reference import rvc as ref

    spec = rvc_spec(bench)
    real, real_sum = offline.rvc_split_points, ref.moving_sum
    tied = {}            # the reference's moving sums with the tie made, by the audio's length

    def tie(audio, cfg, sr=16_000):
        out = real(audio, cfg, sr)
        if out:
            c = out[0] + cfg.window
            total = real_sum(audio, cfg.window)
            total[c] = total[out[0]]
            tied[audio.shape[0]] = total
            out = [c] + out[1:]
        return out

    monkeypatch.setattr(ref, "moving_sum", lambda a, w: tied[a.shape[0]] if a.shape[0] in tied else real_sum(a, w))
    monkeypatch.setattr(offline, "rvc_split_points", tie)
    line = cell.result_line(spec, cell.run(spec, 7, 0.5, False, "cpu", time.perf_counter()), False)
    assert tied and line["correct"], line["checks"]


def test_rvc_yardstick_at_the_published_widths(bench):
    from conftest import ROOT

    spec = cell.Spec(bench, "offline-rvc40k-vocals", ROOT)
    m = spec.config["model"]
    seg = 40 * 16_000
    f = work_rvc.segment_flops(m, seg, 89_500)
    per_s = {k: v / 40e9 for k, v in f.items()}
    assert 5.3 < per_s["front_end"] < 5.5 and 8.4 < per_s["layers"] < 8.6 and 3.6 < per_s["attention"] < 3.8
    assert 6.8 < per_s["knn"] < 6.9 and 3.0 < per_s["prior"] < 3.2 and 1.0 < per_s["flow"] < 1.1
    assert 91 < per_s["vocoder"] < 92
    assert f["knn"] == work.knn_call(1999, 89_500, 768, "fp32", "high")["flops"]
    kind = spec.kind()
    lengths = kind.lengths_s(spec.traffic)
    assert 128 < lengths[0] < 130 and 392 < lengths[-1] < 395 and 230 < np.mean(lengths) < 240
    d = m["driver"]
    assert work_rvc.segments(16_000 * 100, [608_000, 1_216_100], d) == [608_000 + 32_160, 608_000 + 32_160,
                                                                       1_600_000 - 1_216_000 + 32_000]


def test_rvc_readers(bench):
    from conftest import ROOT

    spec = cell.Spec(bench, "offline-rvc40k-vocals", ROOT)
    ms = 1_000_000
    tr = types.SimpleNamespace(
        spans={"request": [(0, 100 * ms), (100 * ms, 200 * ms)], "rvc.content": [(0, 30 * ms), (100 * ms, 130 * ms)],
               "rvc.match": [(30 * ms, 40 * ms), (130 * ms, 140 * ms)], "rvc.prior": [(40 * ms, 50 * ms)],
               "rvc.vocoder": [(50 * ms, 90 * ms), (150 * ms, 190 * ms)],
               "offline.convert": [(0, 99 * ms), (100 * ms, 199 * ms)],
               "offline.step": [(0, 95 * ms), (100 * ms, 195 * ms)]},
        start=np.array([1, 31, 41, 51, 101, 131, 151]) * ms, end=np.array([21, 36, 46, 81, 121, 136, 181]) * ms,
        names=["gemm", "knn_tile_kernel", "softmax", "hifigan_conv_kernel", "gemm", "knn_merge_kernel", "conv"])
    tr.launched_in = lambda name: np.array([any(a <= s < b for a, b in tr.spans[name]) for s in tr.start])
    tr.device_s = lambda mask: float((tr.end[mask] - tr.start[mask]).sum()) / 1e9
    tr.busy_s = lambda a, b: float((np.minimum(tr.end, b) - np.maximum(tr.start, a)).clip(0).sum()) / 1e9
    segs = [[640_000, 300_000], [500_000]]
    v = types.SimpleNamespace(trace=tr, t0=0, t1=200 * ms, window_s=0.2, busy_s=0.13, model=spec.config["model"],
                              precision=spec.config["precision"], library_rows=89_500, counters={},
                              request_segments=segs)
    got = {m["name"]: cell.load_module(cell.HERE / "metrics" / f"{m['name']}.py").read(v) for m in spec.per_layer}
    assert got["hubert_ms_per_request.rvc"] == pytest.approx(20.0)
    assert got["prior_ms_per_request.rvc"] == pytest.approx(2.5)
    assert got["vocoder_ms_per_request.rvc"] == pytest.approx(30.0)
    assert got["device_idle_share.offline"] == pytest.approx(35.0)
    flops = sum(sum(work_rvc.request_flops(v.model, s, 89_500).values()) for s in segs)
    assert got["request_mfu.rvc"] == pytest.approx(100 * flops / 0.2 / 495e12)
    bound = sum(work_rvc.knn_bound_s(v.model, s, 89_500) for s in segs)
    assert got["knn_roofline.rvc"] == pytest.approx(100 * bound / 0.010)
    v.trace = None
    assert all(cell.load_module(cell.HERE / "metrics" / f"{m['name']}.py").read(v) is None for m in spec.per_layer)
