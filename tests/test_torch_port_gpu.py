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
    from alivevc_tpu_torch.infer.offline import float32_math
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
