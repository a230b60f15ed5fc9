"""The filter kernels' launch plans and their orders, on the CPU.

``kernels/filter.py:wide_plan`` chooses each ``filter_wide_kernel``
launch's tile (64 or 128 rows x 32-256 columns), its K split over a
cluster and so its grid; ``filter_level_wide_replay`` replays the kernel's
sums in their order (chunks of 128 bytes of input channels, every tap of a
chunk before the next; a split's partial sums added in rank order).
``narrow_plan`` chooses ``filter_narrow_kernel``'s tiles (the rows a tile
computes and the samples it writes), its tile owners and warpgroups a
block and its ring; ``filter_level_tiled`` replays its tiling.  The
kernels themselves run only on the card (tests/test_torch_port_gpu.py).

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
from test_torch_port_gpu import FILTER_EDGES, HOP_LEVELS, NARROW_LEVELS, WIDE_ROUTES
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


# ---------------------------------------------------------------------------
# The narrow kernel (levels 2-3: C = 16 from 64 channels, C = 8 from 16)
# ---------------------------------------------------------------------------

BENCH_NARROW = {2: (72_000, 160), 3: (144_000, 320)}   # output samples, samples a FiLM frame
LIMIT = kfilter.SMEM_LIMIT


def _narrow(level, n, length, fr, dtype):
    cin, c, r = NARROW_LEVELS[level]
    return kfilter.narrow_plan(n, length, cin, c, r, dtype, fr)


def _check_plan(p, n, length, dtype, c):
    """What every narrow plan holds: the layout fits; T and the lead are
    multiples of 8 (and of the rate 2); a tile computes its lead and its T;
    the block's warpgroups fit its registers and each has a subtile; every
    ring stage belongs to one warpgroup (stages a multiple of the tile's
    warpgroups); the tiles cover the windows; the grid is at most one block
    a SM."""
    assert p["smem"] <= LIMIT
    assert p["T"] % 8 == 0 and p["lead"] % 8 == 0 and p["lead"] >= kfilter.lookback(5, DILATIONS)
    assert p["rows"] == p["T"] + p["lead"]
    assert p["owners"] in (1, 2) and p["wgs"] == p["owners"] * p["wpt"]
    assert p["wgs"] <= kfilter.narrow_max_wgs(c, dtype) and p["wpt"] <= -(-p["rows"] // 64)
    assert 2 <= p["stages"] <= kfilter.NARROW_MAX_STAGES and p["stages"] % p["wpt"] == 0
    assert p["tiles"] == n * -(-length // p["T"])
    assert p["blocks"] == min(-(-p["tiles"] // p["owners"]), SMS)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_narrow_plan_at_the_bench_shape(dtype):
    """16 windows of 144 000 samples: whole tiles of 64-row subtiles, every
    SM busy; bf16 takes two tile owners a block with the lookback at most
    10 % of a tile's rows (576 and 1 536 rows); float32 fits two owners at
    C = 8 (640 rows, 8.75 %) and one at C = 16, whose weights (TF32 hi and
    lo) and 256-byte input rows leave room for 320 rows: 17.5 %."""
    for level, (length, fr) in BENCH_NARROW.items():
        c = NARROW_LEVELS[level][1]
        p = _narrow(level, BENCH_N, length, fr, dtype)
        _check_plan(p, BENCH_N, length, dtype, c)
        assert not p["narrowed"] and p["rows"] % 64 == 0 and p["blocks"] == SMS
        if dtype == torch.bfloat16 or level == 3:
            assert p["owners"] == 2 and p["share"] <= 0.10, (level, p)
        else:
            assert p["owners"] == 1 and p["rows"] == 320 and p["share"] == 56 / 320, p
    assert _narrow(2, BENCH_N, 72_000, 160, torch.bfloat16)["rows"] == 576
    assert _narrow(3, BENCH_N, 144_000, 320, torch.bfloat16)["rows"] == 1536


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_narrow_plan_fills_the_card_at_the_hop(dtype):
    """The streaming hop (N = 1: 3 840 and 7 680 samples): PR 4's tiles gave
    20 and 39 blocks; the plan narrows T until at least 64 blocks work, one
    owner a block with its warpgroups on the tile's subtiles."""
    for level in (2, 3):
        length = HOP_LEVELS[level]
        c = NARROW_LEVELS[level][1]
        p = _narrow(level, 1, length, 160 * (level - 1), dtype)
        _check_plan(p, 1, length, dtype, c)
        assert p["narrowed"] and p["owners"] == 1 and p["wpt"] >= 2
        assert 64 <= p["blocks"] <= SMS and p["tiles"] == p["blocks"]
        # the widest T that still gives 64 blocks
        assert -(-length // (p["T"] + 8)) < 64
    assert _narrow(2, 1, 3840, 160, dtype)["T"] == 56 and _narrow(3, 1, 7680, 320, dtype)["T"] == 120


def test_narrow_plan_at_the_training_shape():
    """The GAN trainer's decoder (8 windows of 38 400 samples, float32): the
    narrow levels fit and fill the card."""
    for level, length in ((2, 19_200), (3, 38_400)):
        c = NARROW_LEVELS[level][1]
        p = _narrow(level, 8, length, 160 * (level - 1), torch.float32)
        _check_plan(p, 8, length, torch.float32, c)
        assert p["blocks"] >= 64


def test_narrow_plan_rules():
    """Over a sweep of shapes and both types: the invariants of
    ``_check_plan``; a plan that is not narrowed takes tiles of whole
    64-row subtiles with at most 10 % lookback unless the shared memory
    allows none such (then the largest that fits), and gives at least 64
    tiles; a narrowed one gives at least 64 tiles unless T is already 8."""
    for dtype in (torch.bfloat16, torch.float32):
        for level in (2, 3):
            cin, c, r = NARROW_LEVELS[level]
            for n, length, fr in [(1, 960, 160), (1, 3840, 160), (2, 7680, 320), (4, 48_000, 160),
                                  (16, 72_000, 160), (64, 144_000, 320), (3, 100_000, 400),
                                  (1, 16, 16), (7, 1000, 8)]:
                p = kfilter.narrow_plan(n, length, cin, c, r, dtype, fr)
                _check_plan(p, n, length, dtype, c)
                if p["narrowed"]:
                    assert p["tiles"] >= 64 or p["T"] == 8, p
                else:
                    assert p["rows"] % 64 == 0 and p["tiles"] >= 64
                    fits_good = kfilter.narrow_layout(6, 5, cin, c, r, fr, 576, p["owners"], 2,
                                                      dtype)["smem"] <= LIMIT
                    assert p["share"] <= 0.10 or not fits_good, p


def test_narrow_card_cases_reach_every_branch():
    """The card tests' narrow levels (FILTER_EDGES) take every branch of the
    plan in some type: one and two tile owners, 1-4 warpgroups a tile, 2-4
    ring stages, narrowed and full tiles, a level ending one input row
    into a tile (L mod T = 2) and one ending on a tile's end, several
    windows with several tiles each (their tiles at sample 0 reflect)."""
    seen = {"owners": set(), "wpt": set(), "stages": set(), "narrowed": set()}
    one_row, whole, multi = False, False, False
    for level, n, l_in, frames in FILTER_EDGES:
        if level not in NARROW_LEVELS:
            continue
        cin, c, r = NARROW_LEVELS[level]
        length = l_in * r
        for dtype in (torch.bfloat16, torch.float32):
            p = kfilter.narrow_plan(n, length, cin, c, r, dtype, length // frames)
            for key in seen:
                seen[key].add(p[key])
            one_row |= length % p["T"] == r and length > p["T"]
            whole |= length % p["T"] == 0
            multi |= n >= 3 and length > 2 * p["T"]
    assert seen == {"owners": {1, 2}, "wpt": {1, 2, 3, 4}, "stages": {2, 3, 4}, "narrowed": {False, True}}
    assert one_row and whole and multi


def test_narrow_layout_at_the_bench_plans():
    """The narrow kernel's weight blob (the up conv, the 1x1 and six convs
    as 32-byte slabs, float32 with the TF32 lo half, and the biases) and
    its shared memory at the bench plans."""
    blob = {(2, torch.bfloat16): 20_480, (3, torch.bfloat16): 5_632,
            (2, torch.float32): 80_384, (3, torch.float32): 18_176}
    for (level, dtype), want in blob.items():
        cin, c, r = NARROW_LEVELS[level]
        length, fr = BENCH_NARROW[level]
        p = _narrow(level, BENCH_N, length, fr, dtype)
        lay = kfilter.narrow_layout(6, 5, cin, c, r, fr, p["rows"], p["owners"], p["stages"], dtype)
        assert lay["blob"] == want and lay["smem"] == p["smem"] <= LIMIT


# (level, windows, input samples, FiLM frames) for the tiling replays: the
# plan's tiles at card-test shapes, narrowed (T = 24, 48) and full (T = 264,
# 456), the last one input row into a tile
TILED = [(2, 2, 480, 6), (3, 3, 530, 53), (2, 32, 133, 1), (3, 32, 229, 1)]


def _decoder_level(level, n, l_in, frames, seed, dtype=torch.float32):
    cin, c, r = NARROW_LEVELS[level]
    return _level(seed, n, l_in, cin, c, r, 5, DILATIONS, frames, dtype)


@pytest.mark.parametrize("case", range(len(TILED)))
def test_narrow_tiled_at_the_plan_equals_plain(case):
    """float32: the narrow kernel's tiling at the plan's T and lead
    (recomputed lookback, the tile at sample 0 reflected) within 1e-5 (1 +
    scale) of filter_level_plain."""
    level, n, l_in, frames = TILED[case]
    args = _decoder_level(level, n, l_in, frames, 80 + case)
    cin, c, r = NARROW_LEVELS[level]
    length = l_in * r
    p = kfilter.narrow_plan(n, length, cin, c, r, torch.float32, length // frames)
    assert p["lead"] == kfilter.narrow_lead(5, DILATIONS, r) == 56
    got = kfilter.filter_level_tiled(**args, tile=p["T"])
    want = kfilter.filter_level_plain(**args)
    scale = float(want.abs().max())
    assert max_err(got, want) <= 1e-5 * (1.0 + scale), (case, p["T"], max_err(got, want))


@pytest.mark.parametrize("case", [0, 2])
def test_narrow_tiled_3xtf32_vs_float64(case):
    """float32 storage: the tiling at the plan's T with every product split
    as the kernel splits it (3xTF32) within 1e-5 (1 + scale) of the level in
    float64 (storage roundings to float32 kept)."""
    level, n, l_in, frames = TILED[case]
    args = _decoder_level(level, n, l_in, frames, 90 + case)
    cin, c, r = NARROW_LEVELS[level]
    length = l_in * r
    tile = kfilter.narrow_plan(n, length, cin, c, r, torch.float32, length // frames)["T"]
    got = kfilter.filter_level_tiled(**args, tile=tile, products="3xtf32")
    want = kfilter.filter_level_tiled(**args, tile=length, compute=torch.float64)
    scale = float(want.abs().max())
    assert max_err(got, want) <= 1e-5 * (1.0 + scale), (case, max_err(got, want))
