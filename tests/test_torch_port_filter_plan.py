"""The wide filter kernel's launch plan and its K order, on the CPU.

``kernels/filter.py:wide_plan`` chooses each ``filter_wide_kernel``
launch's tile (64 or 128 rows x 32-256 columns), its K split over a
cluster and so its grid; ``filter_level_wide_replay`` replays the kernel's
sums in their order (chunks of 128 bytes of input channels, every tap of a
chunk before the next; a split's partial sums added in rank order).  The
kernel itself runs only on the card (tests/test_torch_port_gpu.py).

Tolerances: the replay against ``filter_level_plain`` 1e-5 (1 + scale) in
float32 (sums of up to 1 280 products in another order), the 3xTF32 replay
against the level in float64 1e-5 (1 + scale) (the split's ~2^-22 per
product and float32 accumulation), and bf16 storage 4e-2 (1 + scale) (a
bf16 step, 2^-8, after a conv may round either way and carry through the
level), the card tests' tolerances.
"""

import numpy as np
import pytest
import torch

from alivevc_tpu_torch.kernels import filter as kfilter
from test_torch_port_gpu import FILTER_EDGES, HOP_LEVELS, WIDE_ROUTES
from test_torch_port_util import max_err

SMS = kfilter.H100_SMS
DILATIONS = (1, 1, 2, 2, 4, 4)
LEVELS = {0: (256, 256, 10), 1: (256, 64, 8), 2: (64, 16, 2), 3: (16, 8, 2)}   # (C_in, C, rate)
BENCH_N, BENCH_LW = 16, 144_000


def _plans(n, l_in, level, dtype):
    cin, c, r = LEVELS[level]
    return [kfilter.wide_plan(*spec, dtype) for spec in kfilter.wide_launches(n, l_in, cin, c, r, 5, 6)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_wide_plan_at_the_bench_shape(dtype):
    """16 windows of 144 000 samples: 128-row tiles, no split, and more
    tiles than SMs (the persistent grid is one full wave); bf16 takes all
    256 columns of level 0 in one tile, float32 128 (its registers)."""
    for level, l_in in ((0, BENCH_LW // 320), (1, BENCH_LW // 32)):
        plans = _plans(BENCH_N, l_in, level, dtype)
        for p in plans:
            assert p["wgs"] == 2 and p["tm"] == 128 and p["split"] == 1
            assert p["tiles"] >= SMS and p["ctas"] == p["tiles"]
        conv_tn = plans[2]["tn"]
        assert conv_tn == (64 if level == 1 else 256 if dtype == torch.bfloat16 else 128)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_wide_plan_fills_the_card_at_the_hop(dtype):
    """The streaming hop (N = 1, 7 680 samples): PR 4's grid ran level 0's
    convs on 2 blocks.  Every launch of levels 0 and 1 now works on at
    least 32 blocks and at most one wave; level 0's splits K over a cluster
    of 4 (its 8 or 4 chunks), and its convs take the narrowest tiles."""
    for level in (0, 1):
        cin, c, r = LEVELS[level]
        for p in _plans(1, HOP_LEVELS[level] // r, level, dtype):
            assert 32 <= p["ctas"] <= SMS, (level, p)
            assert p["tm"] == 64
        if level == 0:
            convs = _plans(1, HOP_LEVELS[0] // r, 0, dtype)[2:]
            assert all(p["split"] == 4 and p["tn"] == 32 and p["ctas"] == 128 for p in convs)


def test_wide_plan_rules():
    """Over a sweep of shapes: the column tile covers the columns up to the
    type's widest tile unless it was narrowed to fill the card; a split
    divides no chunk finer than one; blocks = tiles x split."""
    for dtype, widest, chunk in ((torch.bfloat16, 256, 64), (torch.float32, 128, 32)):
        for n, length, cin, cols, taps in [(1, 24, 256, 2560, 1), (16, 4500, 256, 256, 5),
                                           (1, 90, 136, 136, 5), (3, 7, 8, 8, 5), (1, 1, 8, 8, 1),
                                           (2, 9608, 64, 64, 5), (1, 5000, 520, 72, 3)]:
            p = kfilter.wide_plan(n, length, cin, cols, taps, dtype)
            assert p["tn"] in kfilter.WIDE_TN and p["tn"] <= widest
            assert p["wgs"] in (1, 2) and p["tm"] == 64 * p["wgs"]
            assert p["split"] in (1, 2, 4) and p["split"] <= p["chunks"] == -(-cin // chunk)
            assert p["tiles"] == n * -(-length // p["tm"]) * -(-cols // p["tn"])
            assert p["ctas"] == p["tiles"] * p["split"]
            if p["tn"] < min(widest, max(32, 1 << (cols - 1).bit_length())):
                # narrowed while the blocks filled at most half the card
                assert p["tn"] == 32 or 2 * p["ctas"] > SMS, p
            if p["wgs"] == 2:
                assert p["split"] == 1 and p["tiles"] >= SMS


def test_card_cases_reach_every_plan():
    """The card tests' wide levels (FILTER_EDGES, WIDE_ROUTES, the hop's
    levels 0-1) reach every column tile of each type, both row tiles and
    every split, so that each kernel instance and the cluster reduction are
    held to the plain version on the card."""
    cases = [(n, l_in, *LEVELS[level], 5, DILATIONS) for level, n, l_in, _ in FILTER_EDGES]
    cases += [case[:7] for case in WIDE_ROUTES]
    cases += [(1, HOP_LEVELS[level] // LEVELS[level][2], *LEVELS[level], 5, DILATIONS)
              for level in (0, 1)]
    for dtype, tns in ((torch.bfloat16, {32, 64, 128, 256}), (torch.float32, {32, 64, 128})):
        seen = []
        for n, l_in, cin, c, r, k, dil in cases:
            if kfilter.takes_narrow(c, cin, r, k, dil):
                continue
            seen += [kfilter.wide_plan(*spec, dtype)
                     for spec in kfilter.wide_launches(n, l_in, cin, c, r, k, len(dil))]
        assert {p["tn"] for p in seen} == tns
        assert {p["wgs"] for p in seen} == {1, 2}
        assert {p["split"] for p in seen} == {1, 2, 4}


def _level(seed, n, l_in, cin, c, rate, k, dilations, frames, dtype=torch.float32):
    """A level's inputs and weights (numpy draws from ``seed``) in the
    layouts ``filter_level_plain`` takes; the conv weights as [tap, in, out]
    views of Conv1d-shaped [out, in, tap] tensors, as ``level_args`` gives them."""
    rng = np.random.default_rng(seed)

    def rnd(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32)).to(dtype)

    n_conv = len(dilations)
    return dict(
        x_prev=rnd(n, l_in, cin, scale=0.3), skip=rnd(n, l_in, cin, scale=0.3),
        up_w=rnd(cin, rate * c, scale=cin ** -0.5), up_b=rnd(c, scale=0.1),
        in_w=rnd(c, c, scale=c ** -0.5), in_b=rnd(c, scale=0.1),
        conv_w=[rnd(c, c, k, scale=(k * c) ** -0.5).permute(2, 1, 0) for _ in range(n_conv)],
        conv_b=[rnd(c, scale=0.1) for _ in range(n_conv)],
        film=torch.cat([torch.cat([1.0 + rnd(n, frames, c, scale=0.2), rnd(n, frames, c, scale=0.2)], 2)
                        for _ in range(n_conv)], 2),
        rate=rate, dilations=list(dilations))


# (windows, input samples, C_in, C, rate, k, dilations, FiLM frames): level
# 0's and level 1's shapes at small L (and the hop's level 0, 240 samples),
# and C = 136 (a partial last chunk)
REPLAY_LEVELS = [(2, 12, 256, 256, 10, 5, DILATIONS, 4), (1, 24, 256, 256, 10, 5, DILATIONS, 24),
                 (1, 30, 256, 64, 8, 5, DILATIONS, 6), (1, 20, 136, 136, 2, 5, (1, 2), 4)]


@pytest.mark.parametrize("split", [None, 1, 2, 4])
@pytest.mark.parametrize("case", range(len(REPLAY_LEVELS)))
def test_wide_replay_split_order_equals_plain(case, split):
    """float32: the wide route's sums in the kernel's K order, each launch
    split as the plan splits it (None) or in 1, 2 or 4 parts added in rank
    order, within 1e-5 (1 + scale) of filter_level_plain."""
    args = _level(20 + case, *REPLAY_LEVELS[case])
    got = kfilter.filter_level_wide_replay(**args, split=split)
    want = kfilter.filter_level_plain(**args)
    scale = float(want.abs().max())
    assert got.shape == want.shape
    assert max_err(got, want) <= 1e-5 * (1.0 + scale), (case, split, max_err(got, want))


@pytest.mark.parametrize("split", [None, 4])
@pytest.mark.parametrize("case", range(len(REPLAY_LEVELS)))
def test_wide_replay_3xtf32_vs_float64(case, split):
    """float32 storage: every product of the wide route split as the kernel
    splits it (3xTF32), in its K order and split, within 1e-5 (1 + scale) of
    the level in float64 (storage roundings to float32 kept) and of
    filter_level_plain."""
    args = _level(40 + case, *REPLAY_LEVELS[case])
    got = kfilter.filter_level_wide_replay(**args, split=split, products="3xtf32")
    want = kfilter.filter_level_wide_replay(**args, split=1, compute=torch.float64)
    scale = float(want.abs().max())
    assert max_err(got, want) <= 1e-5 * (1.0 + scale), (case, split, max_err(got, want))
    assert max_err(got, kfilter.filter_level_plain(**args)) <= 1e-5 * (1.0 + scale)


@pytest.mark.parametrize("case", [0, 2])
def test_wide_replay_bf16_storage(case):
    """bf16 storage: the replay (bf16 operands, float32 sums, split as the
    plan splits it) within 4e-2 (1 + scale) of filter_level_plain in bf16."""
    args = _level(60 + case, *REPLAY_LEVELS[case], dtype=torch.bfloat16)
    got = kfilter.filter_level_wide_replay(**args)
    want = kfilter.filter_level_plain(**args)
    assert got.dtype == want.dtype == torch.bfloat16
    scale = float(want.float().abs().max())
    assert max_err(got, want) <= 4e-2 * (1.0 + scale), (case, max_err(got, want))
