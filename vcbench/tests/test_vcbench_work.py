"""The yardstick at hand-worked shapes."""

import json
from pathlib import Path

import pytest

import work

CONFIG = json.loads((Path(__file__).resolve().parent.parent / "configs" / "alivevc-bf16.json").read_text())


def test_knn_step():
    c = work.knn_call(7200, 100_352, 768, "bf16", "default")
    assert c["flops"] == 2 * 7200 * 100_352 * 768
    assert c["bytes"] == 7200 * 768 * 2 + 100_352 * 768 * 4 + 7200 * 768 * 4
    assert c["bound_s"] == pytest.approx(c["flops"] / 989e12)
    assert work.knn_call(24, 887, 768, "fp32", "high")["bound_s"] == pytest.approx(
        (24 * 768 * 4 + 887 * 768 * 4 + 24 * 768 * 4) / 3.35e12)


@pytest.mark.parametrize("seconds,windows", [(20, 9), (49, 19), (120, 43)])
def test_windows_cut(seconds, windows):
    assert work.windows_cut(work.len16(seconds * 48_000, 48_000), 48_000) == windows


def test_filter_level():
    c = work.filter_level_call(16, 4500, 256, 64, 8, 5, 6, 450, "bf16", "bf16")
    assert c["flops"] == 2 * 16 * (4500 * 256 * 512 + 36000 * 64 * 64 + 6 * 36000 * 64 * 64 * 5)
    weights = 256 * 512 + 64 + 64 * 64 + 64 + 6 * (64 * 64 * 5 + 64)
    assert c["bytes"] == 2 * (2 * 16 * 4500 * 256 + weights + 16 * 450 * 12 * 64 + 16 * 36000 * 64)


def test_frame_flops():
    f = work.frame_flops(CONFIG["model"], 100_352)
    assert f["knn"] == 2 * 100_352 * 768
    assert f["stft"] == 2 * 1280 * 2 * 641
    ce = 2 * 641 * 512 + 4 * 2 * (512 * 7 + 2 * 512 * 1536) + 2 * 512 * 768
    assert f["content_encoder"] == ce
    assert 260e6 < sum(f.values()) < 290e6
    assert work.window_flops(CONFIG["model"], 100_352, 144_000) == 450 * sum(f.values())
