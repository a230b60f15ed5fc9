"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests carry the ``gpu`` marker and skip on a host without CUDA.  The
machine with the card has no JAX, so this file imports only torch and the
port; run it there without the repo's conftest (which sets JAX up):

    python -m pytest tests/test_torch_port_gpu.py --noconftest -m gpu -q

Tolerances: STFT 1e-3 abs (a float32 FFT against float32 DFT sums of 1280
products);
kNN values 1e-4 abs (float32 sums of the mode's operand products), and with
the packed extraction 1e-4 too (a sum that rounds across a 128-ulp packing
step moves its key by 3.1e-5); oscillator 5e-3 abs (sinf/cosf rounding
grown by the Chebyshev recurrence), the same for the full-formant source
(float32 phase of up to ~500 cycles a frame), and at their edges against
the replay of their own arithmetic 1e-3 (Chebyshev) and 1e-4 (formants);
filter level 1e-3 abs in
float32, and at its edges (all four level shapes, batch 1, lengths that no
tile divides, a narrow level just over its 56-sample lookback, one FiLM
frame a level) 1e-3 (1 + scale) in float32 and 4e-2 (1 + scale) in bf16,
chip_smoke.py's tolerances.  The STFT and kNN kernels' edges (odd shapes,
Lr = k, a device valid-row count below k, d padded or too wide for the
resident query tile) are held to the same tolerances, and 'highest' index sets equal a
float64 ranking wherever its 4th and 5th scores differ by more than 1e-5.
The sharded path: 2 gloo ranks on one card against 1 rank,
identical 'highest' index sets and the waveform within 1e-4 (float32 sums
of the k rows split over the shards, in another order).
"""

import multiprocessing
import os

import numpy as np
import pytest
import torch

from alivevc_tpu_torch.config import DecoderConfig
from alivevc_tpu_torch.kernels import filter as kfilter
from alivevc_tpu_torch.kernels import knn as kknn
from alivevc_tpu_torch.kernels import oscillator as kosc
from alivevc_tpu_torch.kernels import stft as kstft
from alivevc_tpu_torch.models.decoder import Decoder, level_args


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["stft", "knn", "oscillator", "filter_level", "knn_exclusion",
                                  "knn_packed", "oscillator_formants"])
def test_kernel_matches_plain_on_card(name):
    """On the card: each kernel against its plain version at a small shape."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run this file with --noconftest -m gpu")
    # full float32 in the plain versions' products and convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    if name == "stft":
        x = 0.3 * torch.randn(2, 16_000, generator=g, device="cuda")
        assert max_err(kstft.stft_magnitude_cuda(x), kstft.stft_magnitude_plain(x)) <= 1e-3
    elif name == "knn":
        q = torch.randn(300, 768, generator=g, device="cuda")
        lib = torch.randn(5000, 768, generator=g, device="cuda")
        for precision in ("default", "high"):
            v, _ = kknn.knn_topk_cuda(q, lib, 4, precision)
            pv, _ = kknn.knn_topk_plain(q, lib, 4, precision)
            assert max_err(v, pv) <= 1e-4
    elif name == "knn_exclusion":
        q = torch.randn(300, 768, generator=g, device="cuda")
        lib = torch.randn(5000, 768, generator=g, device="cuda")
        pen = torch.where(torch.rand(5000, generator=g, device="cuda") < 0.3, -4.0, 0.0)
        vr = torch.tensor(4093, device="cuda")
        for precision in ("default", "high", "highest"):
            for kw in (dict(valid_rows=vr), dict(valid_rows=4093), dict(penalty=pen),
                       dict(valid_rows=3)):
                v, i = kknn.knn_topk_cuda(q, lib, 4, precision, **kw)
                pv, pi = kknn.knn_topk_plain(q, lib, 4, precision, **kw)
                assert max_err(v.nan_to_num(neginf=0), pv.nan_to_num(neginf=0)) <= 1e-4
                assert torch.equal(torch.isneginf(v), torch.isneginf(pv))
                if "valid_rows" in kw:
                    assert int(i[i != kknn.SENTINEL].max()) < int(kw["valid_rows"])
    elif name == "knn_packed":
        q = torch.randn(300, 768, generator=g, device="cuda")
        for rows in (512, 5000):
            lib = torch.randn(rows, 768, generator=g, device="cuda")
            v, _ = kknn.knn_topk_cuda(q, lib, 4, "default", extraction="packed")
            pv, _ = kknn.knn_topk_plain(q, lib, 4, "default", extraction="packed")
            assert max_err(v, pv) <= 1e-4
    elif name == "oscillator_formants":
        f0 = 80 + 300 * torch.rand(2, 50, 1, generator=g, device="cuda")
        formants = f0 * torch.arange(1, 65, device="cuda")
        amps = torch.exp(0.3 * torch.randn(2, 50, 64, generator=g, device="cuda"))
        got = kosc.harmonic_source_formants_cuda(formants, amps)
        assert max_err(got, kosc.harmonic_source_formants_plain(formants, amps)) <= 5e-3
        assert max_err(got, kosc.harmonic_source_cuda(f0, amps)) <= 5e-3
    elif name == "oscillator":
        f0 = 80 + 300 * torch.rand(2, 50, 1, generator=g, device="cuda")
        amps = torch.exp(0.3 * torch.randn(2, 50, 64, generator=g, device="cuda"))
        assert max_err(kosc.harmonic_source_cuda(f0, amps), kosc.harmonic_source_plain(f0, amps)) <= 5e-3
    else:
        dec = Decoder(DecoderConfig(), generator=torch.Generator().manual_seed(0)).cuda()
        x = 0.3 * torch.randn(2, 960, 16, generator=g, device="cuda")
        s = 0.3 * torch.randn(2, 960, 16, generator=g, device="cuda")
        cond = 0.5 * torch.randn(2, 6, 512, generator=g, device="cuda")   # 1920 samples: 320 a frame
        args = level_args(dec.filter.blocks[3], dec.filter.ups[3], cond)
        with torch.no_grad():
            got = kfilter.filter_level_cuda(x, s, rate=2, **args)
            want = kfilter.filter_level_plain(x, s, rate=2, **args)
        assert max_err(got, want) <= 1e-3


def _knn_vs_plain(q, lib, k, precision, **kw):
    """Kernel vs plain version: values within 1e-4, sentinels in the same
    places, index sets equal wherever the plain k-th and (k+1)-th scores
    are more than 1e-4 apart (or fewer than k + 1 rows rank)."""
    v, i = kknn.knn_topk_cuda(q, lib, k, precision, **kw)
    kp = min(k + 1, lib.shape[0])
    pv, pi = kknn.knn_topk_plain(q, lib, kp, precision, **kw)
    assert torch.equal(torch.isneginf(v), torch.isneginf(pv[:, :k]))
    assert max_err(v.nan_to_num(neginf=0), pv[:, :k].nan_to_num(neginf=0)) <= 1e-4
    clear = torch.ones(q.shape[0], dtype=torch.bool, device=q.device)
    if kp > k:
        clear = (pv[:, k - 1] - pv[:, k]).nan_to_num(nan=1.0, posinf=1.0) > 1e-4
    same = (torch.sort(i, 1).values == torch.sort(pi[:, :k], 1).values).all(1)
    assert bool((same | ~clear).all())
    return v, i


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["stft_edges", "knn_edges", "knn_highest_vs_float64"])
def test_redesigned_kernel_edges_on_card(name):
    """The shared-memory FFT and the tensor-core kNN kernel at their edges."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run this file with --noconftest -m gpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(1)
    if name == "stft_edges":
        # batch 1; L not a multiple of 320; L just over 640; odd L (rows not
        # 16-byte aligned); a hop that is not the default
        for n, length, hop in ((1, 16_000, 320), (1, 16_123, 320), (3, 641, 320), (2, 700, 320),
                               (3, 9_601, 320), (2, 5_000, 160)):
            x = 0.3 * torch.randn(n, length, generator=g, device="cuda")
            got = kstft.stft_magnitude_cuda(x, hop_length=hop)
            want = kstft.stft_magnitude_plain(x, hop_length=hop)
            assert got.shape == want.shape == (n, length // hop + 1, 641)
            assert max_err(got, want) <= 1e-3
        with pytest.raises(ValueError):
            kstft.stft_magnitude_cuda(torch.zeros(1, 640, device="cuda"))
    elif name == "knn_edges":
        q = torch.randn(300, 768, generator=g, device="cuda")     # 300: not a multiple of 64
        for precision in kknn.PRECISIONS:
            for k in (4, 8):
                _knn_vs_plain(q, torch.randn(k, 768, generator=g, device="cuda"), k, precision)
            lib = torch.randn(5003, 768, generator=g, device="cuda")   # not a multiple of 128
            pen = torch.where(torch.rand(5003, generator=g, device="cuda") < 0.3, -4.0, 0.0)
            _knn_vs_plain(q, lib, 8, precision)
            _knn_vs_plain(q, lib, 5, precision, penalty=pen)
            v, i = _knn_vs_plain(q, lib, 4, precision, valid_rows=torch.tensor(2, device="cuda"))
            assert (i[:, 2:] == kknn.SENTINEL).all() and (i[:, :2] < 2).all()
            _knn_vs_plain(q[:37, :100], lib[:, :100], 4, precision)   # d padded to 128
        lib = torch.randn(5003, 768, generator=g, device="cuda")
        _knn_vs_plain(q, lib, 8, "default", extraction="packed")
        _knn_vs_plain(q, lib[:130], 4, "default", extraction="packed")
        # d = 1024: the bf16 query tile no longer fits beside the ring and streams
        wide_q = torch.randn(200, 1024, generator=g, device="cuda")
        wide = torch.randn(3000, 1024, generator=g, device="cuda")
        for kw in ({}, dict(extraction="packed"), dict(valid_rows=torch.tensor(2900, device="cuda"))):
            _knn_vs_plain(wide_q, wide, 4, "default", **kw)
    else:
        q = torch.randn(300, 768, generator=g, device="cuda")
        lib = torch.randn(20_000, 768, generator=g, device="cuda")
        _, i = kknn.knn_topk_cuda(q, lib, 4, "highest")
        s = kknn.normalize_rows(q).double() @ kknn.normalize_rows(lib).double().t()
        top, order = torch.sort(s, dim=1, descending=True)
        clear = (top[:, 3] - top[:, 4]) > 1e-5
        assert float(clear.float().mean()) > 0.8
        same = (torch.sort(i, 1).values == torch.sort(order[:, :4], 1).values).all(1)
        assert bool(same[clear].all())


# (level, windows, input samples, FiLM frames): the four (C, r) level shapes
# (C = 256 / 64 / 16 / 8 at r = 10 / 8 / 2 / 2) at small L, none a multiple
# of the kernels' time tiles (narrow 199, wide 64 or 128); narrow levels of
# 60 samples, just over the 56-sample lookback, so that tile 0 is the only
# tile and reflects; one FiLM frame for a whole level (F r == L, F = 1)
FILTER_EDGES = [(0, 2, 50, 50), (1, 2, 120, 12), (2, 2, 480, 6), (3, 1, 640, 4),
                (0, 1, 2, 2), (1, 1, 8, 1), (2, 1, 30, 1), (3, 2, 30, 1), (3, 3, 530, 53)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_filter_level_edges_on_card(dtype):
    """The redesigned filter kernels (wide at C = 256, 64; one launch at
    C = 16, 8) against filter_level_plain at chip_smoke.py's tolerances:
    float32 1e-3 (1 + scale), bf16 4e-2 (1 + scale)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run this file with --noconftest -m gpu")
    from alivevc_tpu_torch.infer.offline import cast_params
    from alivevc_tpu_torch.kernels import LAUNCHES

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dt = getattr(torch, dtype)
    dec = Decoder(DecoderConfig(), generator=torch.Generator().manual_seed(0)).cuda()
    g = torch.Generator(device="cuda").manual_seed(2)
    for level, n, l_in, frames in FILTER_EDGES:
        up, blk = cast_params(dec.filter.ups[level], dt), cast_params(dec.filter.blocks[level], dt)
        cin, c, r = dec.filter.ups[level].weight.shape
        x = (0.3 * torch.randn(n, l_in, cin, generator=g, device="cuda")).to(dt)
        s = (0.3 * torch.randn(n, l_in, cin, generator=g, device="cuda")).to(dt)
        cond = (0.5 * torch.randn(n, frames, 512, generator=g, device="cuda")).to(dt)
        with torch.no_grad():
            args = level_args(blk, up, cond)
            before = LAUNCHES["filter_level"]
            got = kfilter.filter_level_cuda(x, s, rate=r, **args)
            want = kfilter.filter_level_plain(x, s, rate=r, **args)
        torch.cuda.synchronize()
        assert LAUNCHES["filter_level"] == before + 1
        assert got.shape == want.shape == (n, l_in * r, c) and got.dtype == dt
        scale = float(want.float().abs().max())
        tol = (1e-3 if dt == torch.float32 else 4e-2) * (1.0 + scale)
        assert bool(torch.isfinite(got).all()), (level, n, l_in, frames)
        assert max_err(got, want) <= tol, (level, n, l_in, frames, max_err(got, want), tol)


def _random_level(g, dt, n, l_in, cin, c, rate, k, dilations, frames):
    """A level's inputs and weights in kernels/filter.py's layouts, random
    with unit-scale activations."""
    def rnd(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=g, device="cuda")).to(dt)

    n_conv = len(dilations)
    return dict(
        x_prev=rnd(n, l_in, cin, scale=0.3), skip=rnd(n, l_in, cin, scale=0.3),
        up_w=rnd(cin, rate * c, scale=cin ** -0.5), up_b=rnd(c, scale=0.1),
        in_w=rnd(c, c, scale=c ** -0.5), in_b=rnd(c, scale=0.1),
        conv_w=[rnd(k, c, c, scale=(k * c) ** -0.5) for _ in range(n_conv)],
        conv_b=[rnd(c, scale=0.1) for _ in range(n_conv)],
        film=torch.cat([torch.cat([1.0 + rnd(n, frames, c, scale=0.2), rnd(n, frames, c, scale=0.2)], 2)
                        for _ in range(n_conv)], 2),
        rate=rate, dilations=list(dilations))


# (windows, input samples, C_in, C, rate, k, dilations, FiLM frames): shapes
# off the main path that reach the wide kernel's other tile shapes.  C = 64
# from C_in = 256 at rate 2 (an up conv of N = 128 columns from 256 input
# channels: float32's 64-row tile for wide inputs); C = 136 (every product
# in that tile in float32, three masked column tiles in bf16); C = 16 from
# C_in = 256 and C = 8 at rate 10 (narrow levels the one-launch kernel
# refuses: more input channels or a higher rate than its shared memory
# takes); C = 256 with k = 7 at dilation 4 (a 24-row halo: the largest
# operand tile the wide kernel stages).
WIDE_ROUTES = [(2, 70, 256, 64, 2, 5, (1, 1, 2, 2), 7), (1, 45, 136, 136, 2, 5, (1, 2), 3),
               (2, 90, 256, 16, 2, 5, (1, 1, 2, 2, 4, 4), 9), (1, 33, 16, 8, 10, 5, (1, 2), 11),
               (2, 20, 256, 256, 10, 7, (4, 4), 4)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_filter_level_wide_routes_on_card(dtype):
    """Every tile shape of the wide kernel, and its route for narrow levels
    that the one-launch kernel refuses, against filter_level_plain at
    chip_smoke.py's tolerances; a second call returns the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run this file with --noconftest -m gpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(3)
    for case in WIDE_ROUTES:
        args = _random_level(g, dt, *case)
        with torch.no_grad():
            got = kfilter.filter_level_cuda(**args)
            again = kfilter.filter_level_cuda(**args)
            want = kfilter.filter_level_plain(**args)
        torch.cuda.synchronize()
        n, l_in, _, c, rate = case[:5]
        assert got.shape == want.shape == (n, l_in * rate, c) and got.dtype == dt
        assert torch.equal(got, again), case
        scale = float(want.float().abs().max())
        tol = (1e-3 if dt == torch.float32 else 4e-2) * (1.0 + scale)
        assert bool(torch.isfinite(got).all()), case
        assert max_err(got, want) <= tol, (case, max_err(got, want), tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_filter_level_repeatable_on_card(dtype):
    """The four levels at chip_smoke.py's main-path shapes (16 windows of
    144 000 samples) give the same bits in five calls: a race between the
    kernels' warps, or a read of shared memory that another tile wrote,
    would show as calls that differ."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run this file with --noconftest -m gpu")
    from alivevc_tpu_torch.infer.offline import cast_params

    dt = getattr(torch, dtype)
    dec = Decoder(DecoderConfig(), generator=torch.Generator().manual_seed(0)).cuda()
    g = torch.Generator(device="cuda").manual_seed(4)
    n, lw = 16, 144_000
    cond = (0.5 * torch.randn(n, lw // 320, 512, generator=g, device="cuda")).to(dt)
    for level, length in enumerate((lw // 32, lw // 4, lw // 2, lw)):
        up, blk = cast_params(dec.filter.ups[level], dt), cast_params(dec.filter.blocks[level], dt)
        cin, _, r = dec.filter.ups[level].weight.shape
        x = (0.3 * torch.randn(n, length // r, cin, generator=g, device="cuda")).to(dt)
        s = (0.3 * torch.randn(n, length // r, cin, generator=g, device="cuda")).to(dt)
        with torch.no_grad():
            args = level_args(blk, up, cond)
            first = kfilter.filter_level_cuda(x, s, rate=r, **args)
            for _ in range(4):
                assert torch.equal(kfilter.filter_level_cuda(x, s, rate=r, **args), first), level
        assert bool(torch.isfinite(first).all()), level


# (windows, frames, harmonics, samples a frame): the oscillator kernels'
# edges, each value at least once: Lf = 1, 2, 7, 9, 450, 451; NH = 1, 3,
# 64, 256; seg = 320 and an odd 161 (a middle sample on frame q alone);
# N = 1 and 64.  Lf = 451 leaves a tile of one frame.
OSC_EDGES = [(1, 1, 64, 320), (1, 2, 3, 161), (64, 7, 1, 320), (2, 9, 256, 161), (1, 450, 64, 320),
             (1, 451, 256, 161), (64, 2, 64, 320), (3, 451, 3, 320), (2, 450, 1, 161), (64, 9, 256, 320)]


def _osc_case(g, source, n, lf, nh):
    """Random inputs of one source: f0 80-380 Hz (formants: harmonics of an
    f0 scaled so that the top one stays under 8 kHz, each off its multiple
    by ~1 %), amplitudes exp(0.3 N(0, 1))."""
    f0 = 80.0 + 300.0 * torch.rand(n, lf, 1, generator=g, device="cuda")
    amps = torch.exp(0.3 * torch.randn(n, lf, nh, generator=g, device="cuda"))
    if source == "cheb":
        return (f0, amps), (kosc.harmonic_source_cuda, kosc.harmonic_source_plain,
                            kosc.harmonic_source_replay)
    k = torch.arange(1, nh + 1, device="cuda") * (1.0 + 0.01 * torch.randn(nh, generator=g, device="cuda"))
    formants = f0 * min(1.0, 20.0 / nh) * k
    return (formants, amps), (kosc.harmonic_source_formants_cuda, kosc.harmonic_source_formants_plain,
                              kosc.harmonic_source_formants_replay)


@pytest.mark.gpu
@pytest.mark.parametrize("source", ["cheb", "formants"])
def test_oscillator_edges_on_card(source):
    """Both oscillator kernels at their edges (OSC_EDGES) against the plain
    version at chip_smoke.py's 5e-3, and against the replay of their own
    arithmetic (kernels/oscillator.py:*_replay, run on the card) at 1e-3
    (Chebyshev: sincosf against torch.sin/cos, an ulp apart, grown by the
    recurrence up to k = 256) and 1e-4 (formants: the SFU sine's ~4e-7);
    bf16 amplitudes are read as they are (the same bits as their float32
    values)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run this file with --noconftest -m gpu")
    g = torch.Generator(device="cuda").manual_seed(5)
    replay_tol = 1e-3 if source == "cheb" else 1e-4
    errs = {}
    for n, lf, nh, seg in OSC_EDGES:
        (f, amps), (kernel, plain, replay) = _osc_case(g, source, n, lf, nh)
        got = kernel(f, amps, seg=seg)
        e_plain = max_err(got, plain(f, amps, seg=seg))
        e_replay = max_err(got, replay(f, amps, seg=seg))
        assert got.shape == (n, lf * seg, 1) and bool(torch.isfinite(got).all()), (n, lf, nh, seg)
        errs[(n, lf, nh, seg)] = (e_plain, e_replay)
        ab = amps.bfloat16()
        assert torch.equal(kernel(f, ab, seg=seg), kernel(f, ab.float(), seg=seg)), (n, lf, nh, seg)
    print(f"{source}: (max err vs plain, vs replay) {errs}")
    assert all(p <= 5e-3 and r <= replay_tol for p, r in errs.values()), errs
    # shapes the kernels refuse: no harmonic, NH > 256, frames that do not
    # match, seg > 1024
    (f, amps), (kernel, _, _) = _osc_case(g, source, 1, 4, 8)
    for a, seg in ((amps[..., :0], 320), (torch.ones(1, 4, 257, device="cuda"), 320),
                   (amps[:, :3], 320), (amps, 1025)):
        with pytest.raises(ValueError):
            kernel(f, a, seg=seg)


@pytest.mark.gpu
def test_oscillator_repeatable_without_host_sync_on_card():
    """Both oscillator kernels at chip_smoke.py's main-path shape (16 windows
    of 450 frames, 64 harmonics) give the same bits in five calls, and
    neither wrapper copies between host and device or waits on the stream:
    they run under torch.cuda.set_sync_debug_mode('error'), including a
    first call at a new seg (the weight table's upload)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run this file with --noconftest -m gpu")
    g = torch.Generator(device="cuda").manual_seed(6)
    cases = [_osc_case(g, source, 16, 450, 64) for source in ("cheb", "formants")]
    for (f, amps), (kernel, _, _) in cases:
        first = kernel(f, amps)
        for _ in range(4):
            assert torch.equal(kernel(f, amps), first)
        assert bool(torch.isfinite(first).all())
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for (f, amps), (kernel, _, _) in cases:
            kernel(f, amps)
            kernel(f, amps.bfloat16())
            kernel(f[:2, :9], amps[:2, :9], seg=317)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def _sharded_run(world: int) -> dict:
    """The sharded path on a ('data', 1) x ('library', world) mesh at a small
    size: default model widths, 2 windows of 9 600 samples, 4 001 rows."""
    from alivevc_tpu_torch.config import ContentEncoderConfig, F0EstimatorConfig
    from alivevc_tpu_torch.device import float32_math
    from alivevc_tpu_torch.kernels import LAUNCHES, reset_launches
    from alivevc_tpu_torch.models.content_encoder import ContentEncoder, content_encoder
    from alivevc_tpu_torch.models.f0_estimator import F0Estimator
    from alivevc_tpu_torch.ops.stft import spectrogram
    from alivevc_tpu_torch.parallel import (
        convert_windows_distributed,
        make_mesh,
        pad_library_for_sharding,
        sharded_match_features,
    )

    g = torch.Generator().manual_seed(0)
    ce = ContentEncoder(ContentEncoderConfig(), generator=g).cuda().eval()
    f0m = F0Estimator(F0EstimatorConfig(), generator=g).cuda().eval()
    dec = Decoder(DecoderConfig(), generator=g).cuda().eval()
    lib = torch.randn(4001, 768, generator=torch.Generator(device="cuda").manual_seed(1), device="cuda")
    tt = np.arange(9600) / 16000.0
    windows = torch.from_numpy(np.stack([0.4 * np.sin(2 * np.pi * f * tt)
                                         for f in (120.0, 230.0)]).astype(np.float32)).cuda()
    mesh = make_mesh([("data", 1), ("library", world)], "cuda")
    reset_launches()
    wave = convert_windows_distributed(mesh, ce, f0m, dec, windows, lib, precision="highest")
    with float32_math():
        feat = content_encoder(ce, spectrogram(windows)).reshape(-1, 768)
    _, idx = sharded_match_features(mesh, feat, *pad_library_for_sharding(lib, world),
                                    return_indices=True)
    return {"wave": wave.cpu(), "idx": idx.cpu(), "launches": dict(LAUNCHES)}


def _sharded_rank(rank: int, world: int, tmp: str) -> None:
    import torch.distributed as dist

    from alivevc_tpu_torch.parallel import init_distributed

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_grad_enabled(False)
    init_distributed("gloo", f"file://{tmp}/rendezvous{world}", world, rank)
    try:
        torch.save(_sharded_run(world), os.path.join(tmp, f"w{world}r{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
def test_sharded_path_two_ranks_on_card(tmp_path):
    """convert_windows_distributed and sharded_match_features as 2 gloo ranks
    on one card against 1 rank; every rank launches the path's kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run this file with --noconftest -m gpu")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_sharded_rank, args=(r, w, str(tmp_path)))
             for w, r in ((2, 0), (2, 1), (1, 0))]
    for p in procs:
        p.start()
    for p in procs:
        p.join(300)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
    assert not alive and all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    two, two_b, one = (torch.load(tmp_path / f, weights_only=False)
                       for f in ("w2r0.pt", "w2r1.pt", "w1r0.pt"))
    assert torch.equal(two["wave"], two_b["wave"]) and torch.equal(two["idx"], two_b["idx"])
    assert torch.equal(torch.sort(two["idx"], 1).values, torch.sort(one["idx"], 1).values)
    assert max_err(two["wave"], one["wave"]) <= 1e-4
    for res in (two, two_b, one):
        assert all(res["launches"][k] > 0 for k in ("knn", "oscillator", "filter_level")), res["launches"]


# ---------------------------------------------------------------------------
# the streaming hop's shapes: N = 1, a 24-frame window of 7 680 samples, a
# library of ~900 rows; and capture in a CUDA graph
# ---------------------------------------------------------------------------

HOP = 7680                       # StreamingConfig(): buffer_size 8 x chunk 960
HOP_LEVELS = (HOP // 32, HOP // 4, HOP // 2, HOP)   # output length of up level i
GUARD = 4096                     # sentinel elements on each side of a guarded buffer
SENTINEL = -777.0


def _at_end(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` placed at the very end of a larger allocation."""
    buf = torch.empty(GUARD + t.numel(), dtype=t.dtype, device=t.device)
    view = buf[GUARD:].view(t.shape)
    view.copy_(t)
    return view


class _GuardedTorch:
    """``torch`` as kernels/filter.py sees it, except that ``empty`` and
    ``empty_like`` hand out the middle of a sentinel-filled buffer: a
    kernel that writes past either end of its output or scratch shows."""

    def __init__(self):
        self.buffers = []

    def __getattr__(self, name):
        return getattr(torch, name)

    def empty(self, shape, dtype, device):
        numel = int(np.prod(shape))
        buf = torch.full((2 * GUARD + numel,), SENTINEL, dtype=dtype, device=device)
        self.buffers.append((buf, numel))
        return buf[GUARD:GUARD + numel].view(shape)

    def empty_like(self, t):
        return self.empty(t.shape, dtype=t.dtype, device=t.device)

    def guards_intact(self) -> bool:
        return all(bool((buf[:GUARD] == SENTINEL).all()) and bool((buf[GUARD + n:] == SENTINEL).all())
                   for buf, n in self.buffers)


def _hop_level(dec, level, g):
    """Up level ``level`` at the hop's shapes, float32: (x_prev, skip, rate,
    args) with the activations and FiLM at the end of their allocations."""
    cin, _, r = dec.filter.ups[level].weight.shape
    l_in = HOP_LEVELS[level] // r
    cond = 0.5 * torch.randn(1, HOP // 320, 512, generator=g, device="cuda")
    args = level_args(dec.filter.blocks[level], dec.filter.ups[level], cond)
    args["film"] = _at_end(args["film"])
    x = _at_end(0.3 * torch.randn(1, l_in, cin, generator=g, device="cuda"))
    s = _at_end(0.3 * torch.randn(1, l_in, cin, generator=g, device="cuda"))
    return x, s, r, args


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["stft", "knn_high", "filter_level_0", "filter_level_1",
                                  "filter_level_2", "filter_level_3"])
def test_hop_shape_kernels_on_card(name, monkeypatch):
    """The kernels of the streaming hop at its shapes against their plain
    versions: the STFT of one 7 680-sample window (25 frames: 7 blocks of
    4, the last partial, reflect pad at both ends), kNN 'high' for 24
    queries over 887 rows, and the four float32 filter levels at N = 1 with
    their inputs at the end of their allocations and every output and
    scratch buffer between sentinel guards that must stay untouched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run this file with --noconftest -m gpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(5)
    if name == "stft":
        x = _at_end(0.3 * torch.randn(1, HOP, generator=g, device="cuda"))
        got = kstft.stft_magnitude_cuda(x)
        want = kstft.stft_magnitude_plain(x)
        assert got.shape == (1, 25, 641)
        assert max_err(got, want) <= 1e-3
        assert max_err(got[:, [0, -1]], want[:, [0, -1]]) <= 1e-3
    elif name == "knn_high":
        q = _at_end(torch.randn(24, 768, generator=g, device="cuda"))
        lib = _at_end(torch.randn(887, 768, generator=g, device="cuda"))
        _knn_vs_plain(q, lib, 4, "high")
    else:
        level = int(name[-1])
        dec = Decoder(DecoderConfig(), generator=torch.Generator().manual_seed(0)).cuda()
        x, s, r, args = _hop_level(dec, level, g)
        guarded = _GuardedTorch()
        monkeypatch.setattr(kfilter, "torch", guarded)
        with torch.no_grad():
            got = kfilter.filter_level_cuda(x, s, rate=r, **args)
            torch.cuda.synchronize()
            monkeypatch.undo()
            want = kfilter.filter_level_plain(x, s, rate=r, **args)
        assert got.shape == (1, HOP_LEVELS[level], dec.filter.ups[level].weight.shape[1])
        assert guarded.buffers and guarded.guards_intact(), name
        scale = float(want.abs().max())
        assert bool(torch.isfinite(got).all())
        assert max_err(got, want) <= 1e-3 * (1.0 + scale), (name, max_err(got, want))


def _graph_cases(g):
    """(name, wrapper call, inputs it reads) for each kernel wrapper at the
    hop's shapes (the oscillators at a 24-frame window)."""
    dec = Decoder(DecoderConfig(), generator=torch.Generator().manual_seed(0)).cuda()
    f0 = 80.0 + 300.0 * torch.rand(1, 24, 1, generator=g, device="cuda")
    amps = torch.exp(0.3 * torch.randn(1, 24, 64, generator=g, device="cuda"))
    formants = f0 * torch.arange(1, 65, device="cuda")
    q = torch.randn(24, 768, generator=g, device="cuda")
    lib = torch.randn(887, 768, generator=g, device="cuda")
    x = 0.3 * torch.randn(1, HOP, generator=g, device="cuda")
    wide = _hop_level(dec, 1, g)
    narrow = _hop_level(dec, 3, g)
    return [
        ("stft", lambda: kstft.stft_magnitude_cuda(x), [x]),
        ("knn_high", lambda: kknn.knn_topk_cuda(q, lib, 4, "high")[1], [q, lib]),
        ("knn_default", lambda: kknn.knn_topk_cuda(q, lib, 4, "default")[1], [q, lib]),
        ("oscillator", lambda: kosc.harmonic_source_cuda(f0, amps), [f0, amps]),
        ("oscillator_formants", lambda: kosc.harmonic_source_formants_cuda(formants, amps),
         [formants, amps]),
        ("filter_level_wide", lambda: kfilter.filter_level_cuda(wide[0], wide[1], rate=wide[2],
                                                                **wide[3]), [wide[0], wide[1]]),
        ("filter_level_narrow", lambda: kfilter.filter_level_cuda(
            narrow[0], narrow[1], rate=narrow[2], **narrow[3]), [narrow[0], narrow[1]]),
    ]


@pytest.mark.gpu
def test_kernel_wrappers_replay_in_cuda_graph_on_card():
    """Each wrapper captured in a CUDA graph: after new values are copied
    into the captured inputs, a replay equals an eager call on them; a
    replay adds nothing to the launch counts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run this file with --noconftest -m gpu")
    from alivevc_tpu_torch.kernels import LAUNCHES

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(6)
    with torch.no_grad():
        for name, call, inputs in _graph_cases(g):
            call()          # first use: builds, tables on the card
            torch.cuda.synchronize()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out = call()
            for t in inputs:     # new values, same storage
                t.copy_(t.roll(1, 0) * 1.01 if t.shape[0] > 1 else t.flip(-2) * 1.01)
            want = call()
            counts = dict(LAUNCHES)
            graph.replay()
            torch.cuda.synchronize()
            assert LAUNCHES == counts, name
            assert torch.equal(out, want), (name, max_err(out, want))


@pytest.mark.gpu
def test_streaming_graph_equals_eager_on_card():
    """StreamingConverter at full width: the hop replayed as one CUDA graph
    equals the eager hop over 10 hops from the same primed state (the same
    kernels on the same inputs: expected identical, held to 1e-5); the
    pipelined graph returns the same chunks one hop late; reset re-zeroes
    the state the graph reads."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run this file with --noconftest -m gpu")
    from alivevc_tpu_torch.config import ContentEncoderConfig, F0EstimatorConfig
    from alivevc_tpu_torch.infer.streaming import StreamingConverter
    from alivevc_tpu_torch.kernels import LAUNCHES, reset_launches
    from alivevc_tpu_torch.models.content_encoder import ContentEncoder
    from alivevc_tpu_torch.models.f0_estimator import F0Estimator

    gen = torch.Generator().manual_seed(0)
    ce = ContentEncoder(ContentEncoderConfig(), generator=gen).cuda()
    f0m = F0Estimator(F0EstimatorConfig(), generator=gen).cuda()
    dec = Decoder(DecoderConfig(), generator=gen).cuda()
    tgt = torch.randn(900, 768, generator=torch.Generator(device="cuda").manual_seed(7), device="cuda")
    tt = np.arange(960 * 18) / 16000.0
    wave = (0.4 * np.sin(2 * np.pi * (150 + 40 * np.sin(2 * np.pi * tt)) * tt)).astype(np.float32)
    chunks = [wave[i * 960:(i + 1) * 960] for i in range(8, 18)]
    outs = {}
    for name, kw in (("eager", dict(cuda_graph=False)), ("graph", {}),
                     ("piped", dict(pipeline_depth=1))):
        conv = StreamingConverter(ce, f0m, dec, tgt, **kw)
        assert conv.cuda_graph == (name != "eager")
        conv.prime(wave[:960 * 8])
        reset_launches()
        outs[name] = [conv.process_chunk(c) for c in chunks] + conv.flush()
        if name == "eager":
            assert all(LAUNCHES[k] == 10 for k in ("stft", "knn")) and LAUNCHES["filter_level"] == 40
        else:   # the warm-up hops and the capture only
            assert LAUNCHES["stft"] == 3
        conv.reset()
        conv.prime(wave[:960 * 8])
        again = conv.process_chunk(chunks[0])
        if name != "piped":
            assert np.array_equal(again, outs[name][0])
    err = max(float(np.abs(a - b).max()) for a, b in zip(outs["eager"], outs["graph"]))
    assert err <= 1e-5, err
    assert all(np.isfinite(o).all() for o in outs["graph"])
    assert np.array_equal(outs["piped"][0], np.zeros(960, np.float32))
    for a, b in zip(outs["graph"], outs["piped"][1:]):
        assert np.array_equal(a, b)


# ---------------------------------------------------------------------------
# WORLD pitch on the streaming hop; the halo models as gloo ranks on the card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
def test_streaming_world_pitch_graph_on_card():
    """StreamingConverter(world_pitch=True) at full width: the graph hop
    equals the eager hop over 10 hops (held to 1e-5, expected identical),
    the pipelined graph returns them one hop late, the F0 estimator never
    runs, and after the capture a graph hop makes no synchronising host-device
    copy or wait: process_chunk runs under set_sync_debug_mode('error')."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run this file with --noconftest -m gpu")
    from alivevc_tpu_torch.config import ContentEncoderConfig, F0EstimatorConfig
    from alivevc_tpu_torch.infer.streaming import StreamingConverter
    from alivevc_tpu_torch.kernels import LAUNCHES, reset_launches
    from alivevc_tpu_torch.models.content_encoder import ContentEncoder
    from alivevc_tpu_torch.models.f0_estimator import F0Estimator

    gen = torch.Generator().manual_seed(0)
    ce = ContentEncoder(ContentEncoderConfig(), generator=gen).cuda()
    f0m = F0Estimator(F0EstimatorConfig(), generator=gen).cuda()
    dec = Decoder(DecoderConfig(), generator=gen).cuda()
    calls = []
    f0m.input_layer.register_forward_hook(lambda *_: calls.append(1))
    tgt = torch.randn(900, 768, generator=torch.Generator(device="cuda").manual_seed(7), device="cuda")
    tt = np.arange(960 * 18) / 16000.0
    wave = (0.4 * np.sin(2 * np.pi * (150 + 40 * np.sin(2 * np.pi * tt)) * tt)).astype(np.float32)
    chunks = [wave[i * 960:(i + 1) * 960] for i in range(8, 18)]
    outs = {}
    for name, kw in (("eager", dict(cuda_graph=False)), ("graph", {}),
                     ("piped", dict(pipeline_depth=1))):
        conv = StreamingConverter(ce, f0m, dec, tgt, world_pitch=True, **kw)
        conv.prime(wave[:960 * 8])
        reset_launches()
        outs[name] = [conv.process_chunk(chunks[0])]
        if name != "eager":
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            outs[name] += [conv.process_chunk(c) for c in chunks[1:]]
        finally:
            torch.cuda.set_sync_debug_mode("default")
        outs[name] += conv.flush()
        assert LAUNCHES["stft"] == (10 if name == "eager" else 3)
        np.testing.assert_array_equal(conv.state.window[0].cpu().numpy(), conv._host_window)
    assert not calls, "the F0 estimator ran under world_pitch"
    err = max(float(np.abs(a - b).max()) for a, b in zip(outs["eager"], outs["graph"]))
    assert err <= 1e-5, err
    assert all(np.isfinite(o).all() for o in outs["graph"])
    assert np.array_equal(outs["piped"][0], np.zeros(960, np.float32))
    for a, b in zip(outs["graph"], outs["piped"][1:]):
        assert np.array_equal(a, b)


def _halo_rank(rank: int, world: int, tmp: str) -> None:
    """Rank ``rank`` of ``world`` gloo ranks on cuda:0: the three halo models
    at default widths on its half of a 200-frame input."""
    import torch.distributed as dist

    from alivevc_tpu_torch.config import ContentEncoderConfig, F0EstimatorConfig
    from alivevc_tpu_torch.models.content_encoder import ContentEncoder
    from alivevc_tpu_torch.models.f0_estimator import F0Estimator
    from alivevc_tpu_torch.parallel import (
        content_encoder_sharded,
        f0_estimator_sharded,
        feature_extractor_sharded,
        gather_time,
        init_distributed,
        make_mesh,
        shard_along,
        sharded_frame_model,
    )

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_grad_enabled(False)
    init_distributed("gloo", f"file://{tmp}/halo_rendezvous", world, rank)
    try:
        gen = torch.Generator().manual_seed(0)
        ce = ContentEncoder(ContentEncoderConfig(), generator=gen).cuda()
        f0m = F0Estimator(F0EstimatorConfig(), generator=gen).cuda()
        fe = Decoder(DecoderConfig(), generator=gen).cuda().feature_extractor
        inputs = torch.load(os.path.join(tmp, "inputs.pt"))
        mesh = make_mesh([("data", world)], "cuda")
        spec, cf = (shard_along(inputs[k].cuda(), mesh, "data") for k in ("spec", "cf"))
        out = {
            "ce": sharded_frame_model(mesh, lambda s, ax: content_encoder_sharded(ce, s, ax), spec),
            "f0": sharded_frame_model(mesh, lambda s, ax: f0_estimator_sharded(f0m, s, ax), spec),
            "fe": sharded_frame_model(
                mesh, lambda x, ax: feature_extractor_sharded(fe, x[:, :-1], x[:, -1:], ax), cf),
        }
        torch.save({k: gather_time(mesh, v).cpu() for k, v in out.items()},
                   os.path.join(tmp, f"halo_r{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
def test_halo_two_ranks_on_card(tmp_path):
    """The halo content encoder, F0 estimator and feature extractor as 2 gloo
    ranks on one card equal the dense models within 1e-4 (TF32 off)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run this file with --noconftest -m gpu")
    from alivevc_tpu_torch.config import ContentEncoderConfig, F0EstimatorConfig
    from alivevc_tpu_torch.models.content_encoder import ContentEncoder, content_encoder
    from alivevc_tpu_torch.models.decoder import feature_extractor
    from alivevc_tpu_torch.models.f0_estimator import F0Estimator, f0_estimator

    g = torch.Generator().manual_seed(3)
    spec = torch.rand(200, 641, generator=g)
    cf = torch.cat([torch.randn(200, 768, generator=g), 80 + 200 * torch.rand(200, 1, generator=g)], 1)
    torch.save({"spec": spec, "cf": cf}, tmp_path / "inputs.pt")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_halo_rank, args=(r, 2, str(tmp_path))) for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(300)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
    assert not alive and all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    got = [torch.load(tmp_path / f"halo_r{r}.pt") for r in range(2)]

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    ce = ContentEncoder(ContentEncoderConfig(), generator=gen).cuda()
    f0m = F0Estimator(F0EstimatorConfig(), generator=gen).cuda()
    fe = Decoder(DecoderConfig(), generator=gen).cuda().feature_extractor
    s, c = spec.cuda()[None], cf.cuda()[None]
    with torch.no_grad():
        dense = {"ce": content_encoder(ce, s)[0], "f0": f0_estimator(f0m, s)[0],
                 "fe": feature_extractor(fe, c[..., :-1], c[..., -1:])[0]}
    for k, want in dense.items():
        assert torch.equal(got[0][k], got[1][k]), k
        assert max_err(got[0][k], want.cpu()) <= 1e-4, k


# ---------------------------------------------------------------------------
# training: the kernels' autograd Functions, the wrappers without a
# backward, and every parameter learning through the kernels
# ---------------------------------------------------------------------------

SMALL_DEC = dict(content_channels=64, channels=32, hidden_channels=64, num_layers=2, num_harmonics=16)
SMALL_DISC = dict(periods=(2, 3), period_channels=8, period_max_channels=32, resolutions=(512,),
                  resolution_channels=8)


@pytest.mark.gpu
def test_wrappers_without_backward_refuse_grad_inputs_on_card():
    """The kNN and formant-oscillator launches have no backward: a CUDA
    input that requires grad raises in grad mode (the public ``knn_topk``
    included) and runs under no_grad; the three wrappers with a Function
    return outputs with a grad_fn."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run this file with --noconftest -m gpu")
    g = torch.Generator(device="cuda").manual_seed(8)
    q = torch.randn(40, 768, generator=g, device="cuda").requires_grad_(True)
    lib = torch.randn(512, 768, generator=g, device="cuda")
    f0 = 80 + 300 * torch.rand(1, 8, 1, generator=g, device="cuda")
    amps = torch.rand(1, 8, 16, generator=g, device="cuda").requires_grad_(True)
    formants = f0 * torch.arange(1, 17, device="cuda")
    for call in (lambda: kknn.knn_topk_cuda(q, lib, 4, "highest"),
                 lambda: kknn.knn_topk(q, lib, 4, "highest"),
                 lambda: kknn.knn_topk_cuda(q.detach(), lib.requires_grad_(True), 4, "default"),
                 lambda: kosc.harmonic_source_formants_cuda(formants, amps),
                 lambda: kosc.harmonic_source_cuda(f0, amps),
                 lambda: kstft.stft_magnitude_cuda(0.1 * q.reshape(1, -1))):
        with pytest.raises(RuntimeError, match="requires grad"):
            call()
        with torch.no_grad():
            call()
    lib.requires_grad_(False)
    assert kosc.harmonic_source(f0, amps).grad_fn is not None
    assert kstft.stft_magnitude(0.1 * q.reshape(1, -1)).grad_fn is not None


@pytest.mark.gpu
def test_training_functions_match_plain_autograd_on_card():
    """Each kernel Function on the card: forward within the kernel's
    tolerance of the plain version (filter 1e-3 (1 + scale), source 5e-3,
    STFT 1e-3) and every input's gradient within 1e-4 of the plain
    version's autograd (the backward recomputes it; cuDNN's weight-gradient
    sums are not deterministic); one launch each, none in the backward."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run this file with --noconftest -m gpu")
    from alivevc_tpu_torch.kernels import LAUNCHES, reset_launches

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(9)
    dec = Decoder(DecoderConfig(), generator=torch.Generator().manual_seed(0)).cuda()
    cases = []
    for level, n, l_in in ((0, 2, 30), (1, 2, 60), (3, 2, 480)):
        up, blk = dec.filter.ups[level], dec.filter.blocks[level]
        cin, _, r = up.weight.shape
        x = (0.3 * torch.randn(n, l_in, cin, generator=g, device="cuda")).requires_grad_(True)
        s = 0.3 * torch.randn(n, l_in, cin, generator=g, device="cuda")
        cond = (0.5 * torch.randn(n, l_in * r // 320 or 1, 512, generator=g, device="cuda")
                ).requires_grad_(True)
        cases.append((f"filter_level {level}", "filter_level", 1e-3,
                      lambda up=up, blk=blk, x=x, s=s, cond=cond, r=r:
                      kfilter.filter_level(x, s, rate=r, **level_args(blk, up, cond)),
                      lambda up=up, blk=blk, x=x, s=s, cond=cond, r=r:
                      kfilter.filter_level_plain(x, s, rate=r, **level_args(blk, up, cond)),
                      [x, cond, up.weight, blk.input_conv.weight, blk.blocks[2].c2.to_shift.bias]))
    f0 = (80 + 200 * torch.rand(2, 12, 1, generator=g, device="cuda")).requires_grad_(True)
    amps = torch.exp(0.3 * torch.randn(2, 12, 64, generator=g, device="cuda")).requires_grad_(True)
    cases.append(("oscillator", "oscillator", 5e-3, lambda: kosc.harmonic_source(f0, amps),
                  lambda: kosc.harmonic_source_plain(f0, amps), [f0, amps]))
    w = (0.3 * torch.randn(2, 9600, generator=g, device="cuda")).requires_grad_(True)
    cases.append(("stft", "stft", 1e-3, lambda: kstft.stft_magnitude(w),
                  lambda: kstft.stft_magnitude_plain(w), [w]))
    for name, counter, tol, run, plain, inputs in cases:
        reset_launches()
        out = run()
        assert LAUNCHES[counter] == 1, name
        want = plain()
        scale = float(want.detach().abs().max()) if counter == "filter_level" else 0.0
        assert max_err(out.detach(), want.detach()) <= tol * (1.0 + scale), name
        g_out = torch.randn(want.shape, generator=g, device="cuda")
        got_g = torch.autograd.grad(out, inputs, g_out)
        assert LAUNCHES[counter] == 1, name          # the backward launches nothing
        for a, b in zip(got_g, torch.autograd.grad(want, inputs, g_out)):
            assert max_err(a, b) <= 1e-4 * float(b.abs().max()), name


@pytest.mark.gpu
def test_every_parameter_learns_on_card():
    """One GAN step's gradients on the card (small widths, the kernels'
    Functions in the decoder): every decoder and discriminator parameter
    has a finite, nonzero gradient; the step launches the filter level 8
    times, the oscillator and the STFT twice; a fine-tuning step with a
    library launches the kNN kernel once and moves the tokens."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run this file with --noconftest -m gpu")
    from alivevc_tpu_torch.config import (ContentEncoderConfig, DiscriminatorConfig,
                                          F0EstimatorConfig, VoiceLibraryConfig)
    from alivevc_tpu_torch.kernels import LAUNCHES, reset_launches
    from alivevc_tpu_torch.models.content_encoder import ContentEncoder
    from alivevc_tpu_torch.models.discriminator import Discriminator
    from alivevc_tpu_torch.models.f0_estimator import F0Estimator
    from alivevc_tpu_torch.models.voice_library import VoiceLibrary
    from alivevc_tpu_torch.train.fine_tune import fine_tune_step, init_fine_tune
    from alivevc_tpu_torch.train.gan import gan_draws, gan_grads, init_gan

    gen = torch.Generator().manual_seed(0)
    ce = ContentEncoder(ContentEncoderConfig(internal_channels=32, hidden_channels=64,
                                             output_channels=64, num_layers=2), generator=gen)
    f0m = F0Estimator(F0EstimatorConfig(internal_channels=32, hidden_channels=64, num_layers=2),
                      generator=gen)
    with torch.no_grad():
        f0m.output_layer.bias[120] += 50.0
    ce, f0m = (m.cuda().eval().requires_grad_(False) for m in (ce, f0m))
    dec = Decoder(DecoderConfig(**SMALL_DEC), generator=gen).cuda()
    disc = Discriminator(DiscriminatorConfig(**SMALL_DISC), generator=gen).cuda()
    t = torch.arange(9600, device="cuda") / 16_000.0
    wave = torch.stack([0.4 * torch.sin(2 * np.pi * f * t) for f in (130.0, 210.0)])
    amp, jitter = gan_draws(2, gen, "cuda")
    state = init_gan(dec, disc)
    reset_launches()
    g, d, m = gan_grads(state, ce, f0m, wave, amp, jitter)
    assert {k: LAUNCHES[k] for k in ("filter_level", "oscillator", "stft")} == \
        {"filter_level": 8, "oscillator": 2, "stft": 2}
    for model, grads in ((dec, g), (disc, d)):
        for (name, _), x in zip(model.named_parameters(), grads):
            assert bool(torch.isfinite(x).all()) and bool((x != 0).any()), name
    vl = VoiceLibrary(VoiceLibraryConfig(dim=64), generator=gen).cuda()
    tokens = vl.tokens.detach().clone()
    ft = init_fine_tune(dec, disc, vl)
    reset_launches()
    fine_tune_step(ft, ce, f0m, wave, amp)
    assert LAUNCHES["knn"] == 1 and not torch.equal(vl.tokens, tokens)


WAVLM_NARROW = dict(hidden_size=64, num_layers=10, num_heads=4, intermediate_size=128,
                    conv_dim=(32,) * 7, num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)


@pytest.mark.gpu
def test_wavlm_card_vs_cpu_on_card():
    """The narrow WavLM teacher on the card against the CPU, float32 without
    TF32: every hidden state and the features within 1e-4 abs (the CPU
    tests' tolerance against JAX)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run this file with --noconftest -m gpu")
    import copy

    from alivevc_tpu_torch.models.wavlm import (WavLMConfig, import_wavlm, seeded_state,
                                                wavlm_features, wavlm_hidden_states)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    m = import_wavlm(seeded_state(WavLMConfig(**WAVLM_NARROW), seed=0))
    wave = torch.from_numpy((0.1 * np.random.default_rng(1).standard_normal((2, 16_000))).astype(np.float32))
    card = copy.deepcopy(m).cuda()
    with torch.no_grad():
        for a, b in zip(wavlm_hidden_states(m, wave), wavlm_hidden_states(card, wave.cuda())):
            assert max_err(a, b.cpu()) <= 1e-4
        assert max_err(wavlm_features(m, wave), wavlm_features(card, wave.cuda()).cpu()) <= 1e-4


@pytest.mark.gpu
def test_distill_step_launches_the_stft_once_on_card():
    """One distill step on the card launches the STFT kernel once (forward
    only: the wave carries no gradient) and nothing else; its loss within
    1e-5 relative and its parameters within 1e-6 abs of the CPU's step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run this file with --noconftest -m gpu")
    import copy

    from alivevc_tpu_torch.config import ContentEncoderConfig
    from alivevc_tpu_torch.kernels import LAUNCHES, reset_launches
    from alivevc_tpu_torch.models.content_encoder import ContentEncoder
    from alivevc_tpu_torch.train.distill import distill_step, init_distill

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ce = ContentEncoder(ContentEncoderConfig(internal_channels=32, hidden_channels=64,
                                             output_channels=64, num_layers=2),
                        generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(2)
    wave = torch.from_numpy((0.3 * rng.standard_normal((2, 6400))).astype(np.float32))
    teacher = torch.from_numpy((0.1 * rng.standard_normal((2, 20, 64))).astype(np.float32))
    cpu, card = init_distill(copy.deepcopy(ce)), init_distill(copy.deepcopy(ce).cuda())
    want = distill_step(cpu, wave, teacher)["loss"]
    reset_launches()
    got = distill_step(card, wave.cuda(), teacher.cuda())["loss"]
    assert dict(LAUNCHES) == {**{k: 0 for k in LAUNCHES}, "stft": 1}
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))
    for k, v in cpu.model.state_dict().items():
        assert max_err(card.model.state_dict()[k].cpu(), v) <= 1e-6, k


@pytest.mark.gpu
def test_exported_graphs_match_the_kernel_path_on_card(tmp_path):
    """``cli/export.py``'s filter and voice_library graphs, traced on the
    card, saved and loaded, against the port's eager functions on the
    kernel path: the filter within 1e-3 (1 + max |out|) (phase 2's float32
    filter tolerance: 3xTF32 products against float32), the library match
    with identical index sets, so within 1e-6."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run this file with --noconftest -m gpu")
    from alivevc_tpu_torch.cli import export
    from alivevc_tpu_torch.config import VoiceLibraryConfig
    from alivevc_tpu_torch.kernels import LAUNCHES, reset_launches
    from alivevc_tpu_torch.models.decoder import filter_unet
    from alivevc_tpu_torch.models.voice_library import VoiceLibrary, voice_library_match

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    dec = Decoder(DecoderConfig(**SMALL_DEC), generator=gen).cuda().eval().requires_grad_(False)
    vl = VoiceLibrary(VoiceLibraryConfig(num_tokens=64, dim=64), generator=gen).cuda().requires_grad_(False)
    graphs = export.graphs(None, None, dec, vl)
    rng = np.random.default_rng(3)
    x = torch.from_numpy((0.3 * rng.standard_normal((1, 16 * 320, 1))).astype(np.float32)).cuda()
    c = torch.from_numpy((0.5 * rng.standard_normal((1, 16, 32))).astype(np.float32)).cuda()
    content = torch.from_numpy(rng.standard_normal((1, 16, 64)).astype(np.float32)).cuda()
    loaded = {}
    with torch.no_grad():
        for name, args in (("filter", (x, c)), ("voice_library", (content,))):
            path = str(tmp_path / f"{name}.pt2")
            torch.export.save(torch.export.export(graphs[name], args), path)
            loaded[name] = torch.export.load(path).module()
        reset_launches()
        want_f = filter_unet(dec.filter, x, c, dec.cfg)[..., 0]
        want_v = voice_library_match(vl, content)
        assert LAUNCHES["filter_level"] == 4 and LAUNCHES["knn"] == 1
        got_f, got_v = loaded["filter"](x, c), loaded["voice_library"](content)
    assert got_f.is_cuda and max_err(got_f, want_f) <= 1e-3 * (1.0 + float(want_f.abs().max()))
    assert max_err(got_v, want_v) <= 1e-6


# chip_smoke.py's RESUME_TOL["gan"]: a run resumed through the .ckpt against
# the same run uninterrupted, the worst tensor over the parameters and both
# moments relative to its largest entry (a gradient entry whose sign the
# card's nondeterministic sums flip moves its parameter by 2 lr; at these
# widths one run read 2.3e-3)
RESUME_TOL = 3e-2


def _small_gan_run(gen):
    """The small-width frozen models, a decoder and discriminator to train,
    a batch and three steps' draws, on the card."""
    from alivevc_tpu_torch.config import (ContentEncoderConfig, DiscriminatorConfig,
                                          F0EstimatorConfig)
    from alivevc_tpu_torch.models.content_encoder import ContentEncoder
    from alivevc_tpu_torch.models.discriminator import Discriminator
    from alivevc_tpu_torch.models.f0_estimator import F0Estimator
    from alivevc_tpu_torch.train.gan import gan_draws

    ce = ContentEncoder(ContentEncoderConfig(internal_channels=32, hidden_channels=64,
                                             output_channels=64, num_layers=2), generator=gen)
    f0m = F0Estimator(F0EstimatorConfig(internal_channels=32, hidden_channels=64, num_layers=2),
                      generator=gen)
    with torch.no_grad():
        f0m.output_layer.bias[120] += 50.0
    ce, f0m = (m.cuda().eval().requires_grad_(False) for m in (ce, f0m))
    dec = Decoder(DecoderConfig(**SMALL_DEC), generator=gen).cuda()
    disc = Discriminator(DiscriminatorConfig(**SMALL_DISC), generator=gen).cuda()
    t = torch.arange(9600, device="cuda") / 16_000.0
    wave = torch.stack([0.4 * torch.sin(2 * np.pi * f * t) for f in (130.0, 210.0)])
    return ce, f0m, dec, disc, wave, [gan_draws(2, gen, "cuda") for _ in range(3)]


def _state_tensors(state) -> dict:
    out = {}
    for prefix, model, opt in (("dec", state.dec, state.opt_g), ("disc", state.disc, state.opt_d)):
        for name, p in model.named_parameters():
            out[f"{prefix}.{name}"] = p.detach()
            for key in ("exp_avg", "exp_avg_sq"):
                out[f"{prefix}.{name}:{key}"] = opt.state[p][key]
    return out


@pytest.mark.gpu
def test_gan_resume_through_a_ckpt_on_card(tmp_path):
    """A GAN run at the small widths on the card: 2 steps, the JAX layout's
    ``.ckpt``, fresh modules and optimizers from it, 1 step, against 3
    steps uninterrupted: within chip_smoke.py's gate (the worst tensor
    over the parameters and both moments, relative to its largest entry);
    the read brings back the step and the update counts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run this file with --noconftest -m gpu")
    import copy

    from alivevc_tpu_torch.compat import jax_train_state as jts
    from alivevc_tpu_torch.train.gan import gan_train_step, init_gan, update_count

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ce, f0m, dec, disc, wave, draws = _small_gan_run(torch.Generator().manual_seed(0))

    def run(state, lo, hi):
        for i in range(lo, hi):
            gan_train_step(state, ce, f0m, wave, *draws[i])
        return state

    want = _state_tensors(run(init_gan(copy.deepcopy(dec), copy.deepcopy(disc)), 0, 3))
    path = str(tmp_path / "gan.ckpt")
    jts.write(path, run(init_gan(copy.deepcopy(dec), copy.deepcopy(disc)), 0, 2))
    state = jts.read(path, "gan", "cuda")
    assert state.step == 2 and update_count(state.opt_g) == update_count(state.opt_d) == 2
    got = _state_tensors(run(state, 2, 3))
    worst = max(float((got[k] - v).abs().max() / v.abs().max().clamp_min(1e-30)) for k, v in want.items())
    assert worst <= RESUME_TOL, worst


@pytest.mark.gpu
def test_ckpt_written_on_card_reads_on_cpu_on_card(tmp_path):
    """A GAN state written on the card after a step reads back on the CPU
    with every parameter and moment bit-equal, and written again from the
    CPU gives the same file, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run this file with --noconftest -m gpu")
    from alivevc_tpu_torch.compat import jax_train_state as jts
    from alivevc_tpu_torch.train.gan import gan_train_step, init_gan

    ce, f0m, dec, disc, wave, draws = _small_gan_run(torch.Generator().manual_seed(1))
    state = init_gan(dec, disc)
    gan_train_step(state, ce, f0m, wave, *draws[0])
    card, again = str(tmp_path / "card.ckpt"), str(tmp_path / "cpu.ckpt")
    jts.write(card, state)
    cpu = jts.read(card, "gan", "cpu")
    assert cpu.step == 1 and next(cpu.dec.parameters()).device.type == "cpu"
    want = _state_tensors(state)
    for k, v in _state_tensors(cpu).items():
        assert torch.equal(v, want[k].cpu()), k
    jts.write(again, cpu)
    with np.load(card) as a, np.load(again) as b:
        assert set(a.files) == set(b.files)
        assert all(a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]) for k in a.files)
