"""What decides ``correct``, on the CPU at a size a test holds: a sound run
is correct; the control (the reference in the configuration's control
precision in the program's place) is not; and a run with the timed path
broken underneath is not, for each fault the cell can have.

At these widths the numbers differ from the full cell's, so the tests hold
them to limits read at this size (the sound run's reading, a few times
over), not the cell's own."""

import time

import numpy as np
import pytest

import cell

TINY_LIMITS = {
    "offline-fp32-long": {"mel_l1": 1e-3, "mel_l1_p95": 1e-3},
    "stream-fp32-60ms": {"hop_wave_gap": 1e-4, "hop_phi_gap": 1e-3},
}
SECONDS = {"offline-fp32-long": 1.0, "stream-fp32-60ms": 1.2}


def run_tiny(tiny_spec, workload, seed=5):
    spec = tiny_spec(workload)
    spec.checks["limits"] = dict(TINY_LIMITS[workload])
    res = cell.run(spec, seed, SECONDS[workload], False, "cpu", time.perf_counter())
    return cell.result_line(spec, res, False), res


@pytest.mark.parametrize("workload", sorted(TINY_LIMITS))
def test_sound_run_is_correct(tiny_spec, workload):
    line, _ = run_tiny(tiny_spec, workload)
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {"setup_s", "audio_s_per_s" if "offline" in workload else "hop_p95_ms"}


@pytest.mark.parametrize("workload", sorted(TINY_LIMITS))
def test_control_is_not_correct(tiny_spec, workload):
    spec = tiny_spec(workload)
    spec.checks["limits"] = dict(TINY_LIMITS[workload])
    for seed in (1, 2, 3):
        assert not cell.judge(spec.kind().control(spec, seed, "cpu", SECONDS[workload]))


def test_offline_half_the_batch_left_out(tiny_spec, monkeypatch):
    from alivevc_tpu_torch.infer import offline

    real = offline.convert_window

    def half(*args, **kwargs):
        out = real(*args, **kwargs)
        out[out.shape[0] // 2:] = 0.0
        return out

    monkeypatch.setattr(offline, "convert_window", half)
    line, _ = run_tiny(tiny_spec, "offline-fp32-long")
    assert not line["correct"], line["checks"]


def test_offline_answer_altered(tiny_spec, monkeypatch):
    from alivevc_tpu_torch.infer import offline

    real = offline.convert_window

    def altered(*args, **kwargs):
        out = real(*args, **kwargs)
        out[0] *= 0.5                      # one window of each step, where it is produced
        return out

    monkeypatch.setattr(offline, "convert_window", altered)
    line, _ = run_tiny(tiny_spec, "offline-fp32-long")
    assert not line["correct"], line["checks"]


def test_offline_one_window_in_16_off_by_a_percent(tiny_spec):
    """One window in 16 a percent loud in 13 s files, judged by the cell's
    own limits: diluted below the mean's over every frame, and over the
    95th percentile's."""
    from reference import paths

    spec = tiny_spec("offline-fp32-long")
    spec.traffic.update(min_s=12.0, max_s=14.0, pool=2, check_requests=2)
    kind, sr = spec.kind(), spec.traffic["sample_rate"]
    params, _, target, pool = kind.build(spec, 3, "cpu")
    order = kind.Order(len(pool), 3)
    tgt = kind.reference_target(paths.Precisions(), spec, params, target)
    outs = {i: paths.convert_file(paths.Precisions(), params, spec.config["model"], pool[order(i)], sr, tgt,
                                  kind.infer_settings(spec), "cpu")
            for i in kind.check_sample(spec.traffic, order, 3)}
    assert cell.judge(kind.compare(spec, outs, pool, order, params, tgt, "cpu"))
    chunk = spec.traffic["infer"]["chunk"] * sr // 16_000
    for i in outs:
        outs[i] = outs[i].copy()
        for j in range(0, outs[i].shape[0] // chunk, 16):
            outs[i][j * chunk:(j + 1) * chunk] *= np.float32(1.01)
    c = kind.compare(spec, outs, pool, order, params, tgt, "cpu")
    assert c["mel_l1"]["value"] <= c["mel_l1"]["limit"] and c["mel_l1_p95"]["value"] > c["mel_l1_p95"]["limit"], c
    assert not cell.judge(c)


def test_stream_state_unchanged(tiny_spec, monkeypatch):
    from alivevc_tpu_torch.infer import streaming

    def hop_without_state(self, chunk, f0=None):
        cfg = self.cfg
        _, out = streaming.streaming_step(self.ce, self.f0, self.dec, self.state, chunk, self.tgt,
                                          cfg.f0_rate, cfg.pitch_shift, cfg.k, cfg.alpha, cfg, self.dec_cfg, f0)
        return out                         # the window and phi are not carried

    monkeypatch.setattr(streaming.StreamingConverter, "_hop", hop_without_state)
    line, _ = run_tiny(tiny_spec, "stream-fp32-60ms")
    assert not line["correct"], line["checks"]


def test_stream_answer_altered(tiny_spec, monkeypatch):
    from alivevc_tpu_torch.infer import streaming

    real = streaming.StreamingConverter.process_chunk
    calls = []

    def altered(self, chunk):
        out = real(self, chunk)
        calls.append(1)
        return out * np.float32(0.9) if len(calls) == 7 else out

    monkeypatch.setattr(streaming.StreamingConverter, "process_chunk", altered)
    line, _ = run_tiny(tiny_spec, "stream-fp32-60ms")
    assert not line["correct"], line["checks"]
