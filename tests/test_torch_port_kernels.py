"""The port's kernel modules (alivevc_tpu_torch/kernels/) against the
JAX package's Pallas kernels, which run here as the JAX package's own tests
run them: under ``pltpu.force_tpu_interpret_mode()`` on the CPU.  On the CPU
each port wrapper takes its kernel's plain PyTorch version, because the
tensors it is given lie on the CPU.

The CUDA kernels themselves build and run only on the card:
test_torch_port_gpu.py holds them against their plain versions there, and
chip_smoke.py does so at the conversion path's full shapes.

Tolerances, with their reasons:
  * STFT: 1e-4 abs (float32 DFT sums of 1280 products, another order); the
    CUDA kernel's FFT plan run in numpy: 1e-4 of the largest magnitude
    against np.fft.rfft in float64 (a float32 FFT of 640 points), 1e-4 abs
    against the Pallas kernel;
  * kNN 3xTF32 (the CUDA kernel's 'high'/'highest' products, emulated):
    1e-6 abs against float64 on unit rows (the dropped lo.lo term and float32
    accumulation), the same index sets as JAX 'highest' wherever the exact
    4th and 5th scores differ by more than 1e-5;
  * kNN 'high'/'highest': identical index sets on every query whose exact
    k-th and (k+1)-th scores differ by more than 1e-6 (the port scores in
    float32; JAX 'high' is bf16x3, 'highest' 6-pass bf16);
  * kNN 'default': the bf16 licence of tests/test_bf16_license.py: flip
    rate <= 4 % against exact ranking, every neighbour within 2e-3 of the
    exact k-th best;
  * kNN row exclusion (``valid_rows``, ``penalty``): as above, against JAX
    ``knn_topk_pallas(valid_rows=...)`` / ``(penalty=...)``, values within
    1e-5 in the exact modes;
  * kNN ``extraction='packed'``: the same index sets as JAX's packed kernel
    wherever the exact 4th and 5th scores are more than 1e-4 apart (the
    packing moves a score by up to 127 ulps at exponent 1, 3.1e-5), values
    within 3.2e-5;
  * full-formant source: JAX's own tolerance (rtol 1e-3, atol 2e-2) against
    ``harmonic_source_pallas`` at 20 frames, and 1e-3 abs against a float64
    evaluation at 70 frames (the JAX kernel carries phase unwrapped in
    float32, so it is held against float64 only at its own short length);
  * oscillator: 1e-3 abs against a float64 evaluation of the function,
    5e-3 against the JAX kernel (whose float32 phase carry is itself ~2.7e-3
    off the float64 value on a 70-frame input; the port sums the frame base
    phase in float64);
  * both sources' CUDA arithmetic replayed on the CPU (the two-frame split,
    the two accumulators, the scan's offsets): 5e-5 abs against the plain
    version (the same float32 values rounded in another order, FMAs where
    the plain version rounds twice), 1e-3 against float64; the split
    reproduces the 3-tap weights exactly;
  * filter level: 5e-3 abs (PARITY.md's filter tolerance).
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from alivevc_tpu.config import DecoderConfig as JDecoderConfig
from alivevc_tpu.kernels.knn_pallas import knn_topk_pallas
from alivevc_tpu.kernels.oscillator_pallas import (
    harmonic_source_cheb_pallas,
    harmonic_source_pallas,
)
from alivevc_tpu.kernels.stft_pallas import stft_magnitude_pallas
from alivevc_tpu_torch.compat import weights
from alivevc_tpu_torch.config import DecoderConfig
from alivevc_tpu_torch.kernels import filter as kfilter
from alivevc_tpu_torch.kernels import knn as kknn
from alivevc_tpu_torch.kernels import oscillator as kosc
from alivevc_tpu_torch.kernels import stft as kstft
from alivevc_tpu_torch.models.decoder import Decoder, level_args

from test_torch_port_util import max_err, n, t

jdec = importlib.import_module("alivevc_tpu.models.decoder")


def test_stft_vs_pallas():
    rng = np.random.default_rng(1)
    x = (0.1 * rng.standard_normal((2, 6400))).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = stft_magnitude_pallas(jnp.asarray(x))
    got = kstft.stft_magnitude(t(x))
    assert got.shape == want.shape and got.dtype == torch.float32
    assert max_err(got, want) <= 1e-4


def _stft_fft_np(x, hop=320):
    """The CUDA kernel's stage sequence in numpy (complex64): reflect pad,
    frames, z[m] = x[2m] + i x[2m+1], the Stockham stages of FFT_RADICES
    with the wrapper's twiddle table, the real-FFT split, |.|."""
    n_fft, nc = kstft.N_FFT, kstft.N_FFT // 2
    tw = kstft.fft_twiddles_np()
    tw = (tw[:, 0] + 1j * tw[:, 1]).astype(np.complex64)
    xp = np.pad(x, ((0, 0), (nc, nc)), mode="reflect")
    t_frames = x.shape[1] // hop + 1
    idx = np.arange(t_frames)[:, None] * hop + np.arange(n_fft)[None, :]
    frames = xp[:, idx].reshape(-1, n_fft)
    z = (frames[:, 0::2] + 1j * frames[:, 1::2]).astype(np.complex64)
    p = 1
    for r_ in kstft.FFT_RADICES:
        m = nc // r_
        i = np.arange(m)
        k = i % p
        r = np.arange(r_)[:, None]
        u = z[:, i[None, :] + r * m] * tw[r * 2 * (nc // (p * r_)) * k[None, :]]
        dft = np.exp(-2j * np.pi * np.outer(np.arange(r_), np.arange(r_)) / r_).astype(np.complex64)
        y = np.einsum("qr,frm->fqm", dft, u)
        out = np.empty_like(z)
        out[:, ((i - k) * r_ + k)[None, :] + r * p] = y
        z, p = out, p * r_
    assert p == nc
    kk = np.arange(1, nc)
    zk, zc = z[:, kk], np.conj(z[:, nc - kk])
    mid = 0.5 * (zk + zc) + tw[kk] * (-0.5j) * (zk - zc)
    spec = np.concatenate([(z[:, :1].real + z[:, :1].imag), mid, (z[:, :1].real - z[:, :1].imag)], 1)
    return np.abs(spec).astype(np.float32).reshape(x.shape[0], t_frames, nc + 1), frames


def test_stft_fft_plan_vs_rfft_and_pallas():
    """The kernel's FFT plan and twiddle table, run in numpy, against
    np.fft.rfft (1e-4 relative to the largest magnitude) and against the
    Pallas kernel in interpret mode (the existing 1e-4 abs)."""
    rng = np.random.default_rng(11)
    x = (0.1 * rng.standard_normal((2, 6400))).astype(np.float32)
    got, frames = _stft_fft_np(x)
    ref = np.abs(np.fft.rfft(frames.astype(np.float64), axis=1)).reshape(got.shape)
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(stft_magnitude_pallas(jnp.asarray(x)))
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-4


def _exact(src, lib, k):
    s = src / np.linalg.norm(src, axis=1, keepdims=True)
    lb = lib / np.linalg.norm(lib, axis=1, keepdims=True)
    sims = s.astype(np.float64) @ lb.astype(np.float64).T
    order = np.argsort(-sims, axis=1, kind="stable")
    return sims, order[:, :k], np.take_along_axis(sims, order[:, :k + 1], axis=1)


@pytest.mark.parametrize("lr,precision", [(1000, "highest"), (1000, "high"), (4096, "high")])
def test_knn_exact_modes_vs_pallas(lr, precision):
    """1000 rows take the carried kernel in JAX, 4096 the two-pass one."""
    rng = np.random.default_rng(lr)
    src = rng.standard_normal((64, 768)).astype(np.float32)
    lib = rng.standard_normal((lr, 768)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        _, want_i = knn_topk_pallas(jnp.asarray(src), jnp.asarray(lib), 4, precision=precision)
    got_v, got_i = kknn.knn_topk(t(src), t(lib), 4, precision)
    _, _, top = _exact(src, lib, 4)
    clear = (top[:, 3] - top[:, 4]) > 1e-6
    assert clear.mean() > 0.9
    same = np.all(np.sort(n(got_i), 1) == np.sort(np.asarray(want_i), 1), axis=1)
    assert same[clear].all()
    np.testing.assert_allclose(n(got_v), top[:, :4], atol=1e-5)


def test_knn_3xtf32_split_vs_float64_and_pallas_highest():
    """The 'high'/'highest' kernel's 3xTF32 scores, emulated: within 1e-6 of
    float64 on 768-wide unit rows, and the same index sets as JAX 'highest'
    (interpret mode) wherever the exact 4th and 5th scores differ by more
    than 1e-5."""
    one = torch.tensor([1.0 + 2.0**-11, -(1.0 + 2.0**-11), 1.0 + 2.0**-12, 3.0])
    assert torch.equal(kknn.tf32_round(one), torch.tensor([1.0 + 2.0**-10, -(1.0 + 2.0**-10), 1.0, 3.0]))
    rng = np.random.default_rng(21)
    src = rng.standard_normal((64, 768)).astype(np.float32)
    lib = rng.standard_normal((1000, 768)).astype(np.float32)
    s, lb = kknn.normalize_rows(t(src)), kknn.normalize_rows(t(lib))
    sims = kknn.scores_3xtf32(s, lb)
    exact = n(s).astype(np.float64) @ n(lb).astype(np.float64).T
    assert np.abs(n(sims) - exact).max() <= 1e-6
    with pltpu.force_tpu_interpret_mode():
        _, want_i = knn_topk_pallas(jnp.asarray(src), jnp.asarray(lib), 4, precision="highest")
    _, got_i = kknn.topk_exact(sims, 4)
    top = -np.sort(-exact, axis=1)[:, :5]
    clear = (top[:, 3] - top[:, 4]) > 1e-5
    assert clear.mean() > 0.8
    same = np.all(np.sort(n(got_i), 1) == np.sort(np.asarray(want_i), 1), axis=1)
    assert same[clear].all()


def test_knn_default_within_bf16_licence():
    rng = np.random.default_rng(0)
    src = rng.standard_normal((256, 768)).astype(np.float32)
    lib = rng.standard_normal((4096, 768)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        v32, i32 = knn_topk_pallas(jnp.asarray(src), jnp.asarray(lib), 4, precision="highest")
    _, i16 = kknn.knn_topk(t(src), t(lib), 4, "default")
    flips = np.any(np.sort(np.asarray(i32), 1) != np.sort(n(i16), 1), 1)
    assert flips.mean() <= 0.04
    sims, _, _ = _exact(src, lib, 4)
    true = np.take_along_axis(sims, n(i16).astype(np.int64), axis=1)
    assert np.all(true >= np.asarray(v32)[:, -1:] - 2e-3)


def _content_queries():
    """768-wide content features of a synthetic voice: the full-width
    content encoder from seed 0 on four windows of 20 480 samples (256
    frames), as the conversion path queries the library."""
    from alivevc_tpu_torch.models.content_encoder import ContentEncoder, content_encoder
    from alivevc_tpu_torch.ops.stft import spectrogram

    rng = np.random.default_rng(0)
    tt = np.arange(20_480) / 16_000.0
    waves = []
    for f in (110.0, 160.0, 220.0, 300.0):
        ph = 2 * np.pi * np.cumsum(f * (1.0 + 0.1 * np.sin(2 * np.pi * 0.7 * tt))) / 16_000.0
        waves.append(0.4 * np.sin(ph) + 0.2 * np.sin(2 * ph) + 0.01 * rng.standard_normal(tt.shape))
    ce = ContentEncoder(generator=torch.Generator().manual_seed(0)).eval()
    with torch.no_grad():
        return content_encoder(ce, spectrogram(t(np.stack(waves)))).reshape(-1, 768)


def test_knn_default_flip_rate_vs_jax_over_library_draws(record_property):
    """The bf16 'default' mode's top-4 flip rate against the exact ranking,
    port (plain version: bf16-rounded unit rows, float32 sums) and JAX
    (``knn_topk_pallas`` 'default' in interpret mode), on the same content
    features over four random 4 096-row libraries.  The port's mean rate may
    exceed JAX's by at most one percentage point: both round the same unit
    rows to bf16, and only the order of the float32 sums differs."""
    src = n(_content_queries())
    rates = {"port": [], "jax": []}
    for seed in range(4):
        lib = np.random.default_rng(100 + seed).standard_normal((4096, 768)).astype(np.float32)
        _, exact, _ = _exact(src, lib, 4)
        exact = np.sort(exact, 1)
        _, port_i = kknn.knn_topk(t(src), t(lib), 4, "default")
        with pltpu.force_tpu_interpret_mode():
            _, jax_i = knn_topk_pallas(jnp.asarray(src), jnp.asarray(lib), 4, precision="default")
        rates["port"].append(float(np.any(np.sort(n(port_i), 1) != exact, 1).mean()))
        rates["jax"].append(float(np.any(np.sort(np.asarray(jax_i), 1) != exact, 1).mean()))
    record_property("flip_rates", rates)
    print(f"bf16 flip rates over 4 library draws: {rates}")
    assert np.mean(rates["port"]) <= np.mean(rates["jax"]) + 0.01, rates


def test_knn_wrapper_checks():
    lib = torch.randn(3, 32)
    with pytest.raises(ValueError):
        kknn.knn_topk_cuda(torch.randn(4, 32), torch.randn(8, 32))   # CPU tensors
    with pytest.raises(ValueError):
        kknn.knn_topk_cuda(torch.randn(4, 32), lib, k=4)             # fewer rows than k
    with pytest.raises(ValueError):
        kknn.prep_operands(torch.randn(4, 32), lib, "fast")


def _exclusion(kind, lr, seed):
    """(JAX kwargs, port kwargs, the rows that stay) of one exclusion."""
    if kind == "valid_rows":
        vr = lr - 108
        return dict(valid_rows=jnp.int32(vr)), dict(valid_rows=torch.tensor(vr)), vr
    rng = np.random.default_rng(seed)
    pen = np.where(rng.random(lr) < 0.3, -4.0, 0.0).astype(np.float32)
    pen[lr - 7:] = -10.0
    return dict(penalty=jnp.asarray(pen)), dict(penalty=t(pen)), pen == 0


@pytest.mark.parametrize("precision", ["highest", "high", "default"])
@pytest.mark.parametrize("kind,lr", [("valid_rows", 4608), ("penalty", 1000)])
def test_knn_exclusion_vs_pallas(kind, lr, precision):
    """valid_rows takes JAX's two-pass route (a penalty column in its exact
    modes), the penalty its carried kernel; the port applies both in every
    mode.  'default' is held to the bf16 licence against JAX 'highest'."""
    rng = np.random.default_rng(lr)
    src = rng.standard_normal((64, 768)).astype(np.float32)
    lib = rng.standard_normal((lr, 768)).astype(np.float32)
    jkw, tkw, keep = _exclusion(kind, lr, lr)
    rows = np.arange(lr)[keep] if kind == "penalty" else np.arange(keep)
    jprec = "highest" if precision == "default" else precision
    with pltpu.force_tpu_interpret_mode():
        want_v, want_i = knn_topk_pallas(jnp.asarray(src), jnp.asarray(lib), 4,
                                         precision=jprec, **jkw)
    got_v, got_i = kknn.knn_topk(t(src), t(lib), 4, precision, **tkw)
    got_i = n(got_i).astype(np.int64)
    assert np.isin(got_i, rows).all() and np.isin(np.asarray(want_i), rows).all()
    sims, _, top = _exact(src, lib[rows], 4)
    if precision == "default":
        flips = np.any(np.sort(np.asarray(want_i), 1) != np.sort(got_i, 1), 1)
        assert flips.mean() <= 0.04
        true = np.take_along_axis(sims, np.searchsorted(rows, got_i), axis=1)
        assert np.all(true >= np.asarray(want_v)[:, -1:] - 2e-3)
        return
    clear = (top[:, 3] - top[:, 4]) > 1e-6
    assert clear.mean() > 0.9
    same = np.all(np.sort(got_i, 1) == np.sort(np.asarray(want_i), 1), axis=1)
    assert same[clear].all()
    np.testing.assert_allclose(n(got_v), np.asarray(want_v), atol=1e-5)


def test_knn_exclusion_edges():
    """valid_rows is clamped to Lr; an int and a 0-d tensor agree; with
    fewer valid rows than k the missing places hold (-inf, SENTINEL)."""
    rng = np.random.default_rng(3)
    src, lib = t(rng.standard_normal((9, 64))), t(rng.standard_normal((40, 64)))
    for precision in kknn.PRECISIONS:
        v, i = kknn.knn_topk(src, lib, 4, precision)
        v2, i2 = kknn.knn_topk(src, lib, 4, precision, valid_rows=10**6)
        assert torch.equal(i, i2) and torch.equal(v, v2)
        v3, i3 = kknn.knn_topk(src, lib, 4, precision, valid_rows=2)
        v4, i4 = kknn.knn_topk(src, lib, 4, precision, valid_rows=torch.tensor(2))
        assert torch.equal(i3, i4) and (i3[:, :2] < 2).all()
        assert (i3[:, 2:] == kknn.SENTINEL).all() and torch.isneginf(v3[:, 2:]).all()
    with pytest.raises(ValueError):
        kknn.knn_topk(src, lib, 4, extraction="fast")


@pytest.mark.parametrize("lr", [1000, 4096])
def test_knn_packed_vs_pallas(lr):
    """JAX's packed extraction runs its carried kernel (tile 512) at any
    library size."""
    rng = np.random.default_rng(lr + 1)
    src = rng.standard_normal((64, 768)).astype(np.float32)
    lib = rng.standard_normal((lr, 768)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want_v, want_i = knn_topk_pallas(jnp.asarray(src), jnp.asarray(lib), 4, precision="default",
                                         extraction="packed")
    got_v, got_i = kknn.knn_topk(t(src), t(lib), 4, "default", extraction="packed")
    _, _, top = _exact(src, lib, 4)
    clear = (top[:, 3] - top[:, 4]) > 1e-4
    assert clear.mean() > 0.8
    same = np.all(np.sort(n(got_i), 1) == np.sort(np.asarray(want_i), 1), axis=1)
    assert same[clear].all()
    pos = np.all(n(got_i) == np.asarray(want_i), axis=1)
    assert np.abs(n(got_v) - np.asarray(want_v))[pos].max() <= 3.2e-5
    # the keys sit within 127 ulps of the exact 'default' scores
    ex_v, _ = kknn.knn_topk(t(src), t(lib), 4, "default")
    assert max_err(got_v, ex_v) <= 3.2e-5


def test_knn_packed_applies_only_where_jax_takes_it():
    """'packed' falls back to the exact extraction outside 'default', with
    an exclusion, or for k > 8 (knn_pallas.py:323-329)."""
    rng = np.random.default_rng(4)
    src, lib = t(rng.standard_normal((16, 64))), t(rng.standard_normal((300, 64)))
    assert kknn.uses_packed("default", 4, None, None, "packed")
    for args in (("high", 4, None, None), ("default", 4, 200, None),
                 ("default", 4, None, torch.zeros(300)), ("default", 9, None, None)):
        assert not kknn.uses_packed(*args, "packed")
    for precision, kw in (("high", {}), ("default", dict(valid_rows=250)),
                          ("default", dict(penalty=torch.zeros(300)))):
        v, i = kknn.knn_topk(src, lib, 4, precision, extraction="packed", **kw)
        v2, i2 = kknn.knn_topk(src, lib, 4, precision, **kw)
        assert torch.equal(v, v2) and torch.equal(i, i2)


def _formant_source_f64(formants, amps, seg=320, sr=16_000):
    """The full-formant source in float64: mean_h amp_h(t) sin(2 pi
    phase_h(t)), each phase the running sum of its interpolated formant,
    re-zeroed at sample 0."""
    w, ws = (a.astype(np.float64) for a in kosc.interp_weights_np(seg))
    nb, lf, nh = formants.shape
    f = formants.astype(np.float64) / sr
    fp = np.concatenate([f[:, :1], f, f[:, -1:]], 1)[..., None]
    cseg = fp[:, :-2] * ws[0] + fp[:, 1:-1] * ws[1] + fp[:, 2:] * ws[2]      # [N, Lf, NH, seg]
    tot = cseg[..., -1]
    phase = cseg + (np.cumsum(tot, 1) - tot)[..., None]
    phase = phase - phase[:, :1, :, :1]
    ap = np.concatenate([amps[:, :1], amps, amps[:, -1:]], 1).astype(np.float64)[..., None]
    a = ap[:, :-2] * w[0] + ap[:, 1:-1] * w[1] + ap[:, 2:] * w[2]
    out = (np.sin(2 * np.pi * phase) * a).mean(2)                              # [N, Lf, seg]
    return out.reshape(nb, lf * seg, 1)


def _formant_inputs(lf, seed, jitter, amp_w):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((1, lf, 512)).astype(np.float32)
    f0 = (rng.random((1, lf, 1)) * 300 + 80).astype(np.float32)
    w = (rng.standard_normal((512, 64)) * amp_w).astype(np.float32)
    formants = f0 * np.arange(1, 65, dtype=np.float32) * (1 + jitter * rng.standard_normal(64))
    return formants.astype(np.float32), np.exp(feats @ w).astype(np.float32)


def test_formant_source_vs_pallas():
    """JAX's own input and tolerance (tests/test_kernels_interpret.py)."""
    formants, amps = _formant_inputs(20, 2, 0.0, 0.05)
    with pltpu.force_tpu_interpret_mode():
        want = harmonic_source_pallas(jnp.asarray(formants), jnp.asarray(amps))
    got = kosc.harmonic_source_formants(t(formants), t(amps))
    assert got.shape == want.shape == (1, 20 * 320, 1)
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=1e-3, atol=2e-2)


def test_formant_source_vs_float64():
    """70 frames of inharmonic formants (each harmonic off its f0 multiple by
    ~1 %), amplitudes of order 1 (the tolerance is absolute), against
    float64; with exact multiples it is the Chebyshev source."""
    formants, amps = _formant_inputs(70, 9, 0.01, 0.01)
    got = kosc.harmonic_source_formants(t(formants), t(amps))
    assert np.abs(n(got) - _formant_source_f64(formants, amps)).max() <= 1e-3
    harmonic, _ = _formant_inputs(70, 9, 0.0, 0.01)
    cheb = kosc.harmonic_source(t(harmonic[..., :1]), t(amps))
    assert max_err(kosc.harmonic_source_formants(t(harmonic), t(amps)), cheb) <= 1e-3


def _source_f64(f0, amps, seg=320, sr=16_000):
    """The offline harmonic source computed directly in float64:
    mean_k amp_k(t) sin(2 pi k phase(t)), phase re-zeroed at sample 0."""
    w, ws = (a.astype(np.float64) for a in kosc.interp_weights_np(seg))
    f = f0[..., 0].astype(np.float64) / sr
    fp = np.concatenate([f[:, :1], f, f[:, -1:]], 1)
    cseg = fp[:, :-2, None] * ws[0] + fp[:, 1:-1, None] * ws[1] + fp[:, 2:, None] * ws[2]
    tot = cseg[:, :, -1]
    phase = (cseg + (np.cumsum(tot, 1) - tot)[:, :, None]).reshape(f.shape[0], -1)
    phase = phase - phase[:, :1]
    ap = np.concatenate([amps[:, :1], amps, amps[:, -1:]], 1).astype(np.float64)
    a = sum(ap[:, j:j + f.shape[1], None, :] * w[j][None, None, :, None] for j in range(3))
    a = a.reshape(f.shape[0], -1, amps.shape[-1])
    k = np.arange(1, amps.shape[-1] + 1)
    return (np.sin(2 * np.pi * phase[:, :, None] * k) * a).mean(-1)[..., None]


@pytest.mark.parametrize("lf", [70, 9])
def test_oscillator_vs_cheb_pallas(lf):
    """Against a float64 evaluation of the same function the port is within
    1e-3.  The JAX Chebyshev kernel itself is ~2.7e-3 from that reference at
    lf = 70 (its float32 phase carry), so port vs JAX kernel is held to
    5e-3."""
    rng = np.random.default_rng(7)
    feats = rng.standard_normal((2, lf, 512)).astype(np.float32)
    f0 = (rng.random((2, lf, 1)) * 300 + 80).astype(np.float32)
    # amplitudes of order 1 (the tolerances are absolute)
    w = (rng.standard_normal((512, 64)) * 0.01).astype(np.float32)
    amps = np.exp(feats @ w).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = harmonic_source_cheb_pallas(jnp.asarray(f0), jnp.asarray(amps))
    got = kosc.harmonic_source(t(f0), t(amps))
    assert got.shape == want.shape
    assert np.abs(n(got) - _source_f64(f0, amps)).max() <= 1e-3
    assert max_err(got, want) <= 5e-3


@pytest.mark.parametrize("seg", [320, 161, 1])
def test_oscillator_two_frame_split(seg):
    """The kernels' two-frame form reproduces the 3-tap weights exactly: a
    sample's weights on (q-1, q, q+1) are its two frames' weights and an
    exact 0, the odd segment's middle sample weighs only frame q, and the
    third prefix weight is 0 in the first half and the constant
    ws[0][seg-1] in the second (the formant kernel's folded term)."""
    w, ws = kosc.interp_weights_np(seg)
    lo, w_lo, w_hi, ws_lo, ws_hi = kosc.two_frame_split(seg)
    r = np.arange(seg)
    first = lo == -1
    assert first.sum() == seg // 2
    taps = np.zeros((3, seg), np.float32)
    taps[lo + 1, r] = w_lo
    taps[lo + 2, r] = w_hi
    np.testing.assert_array_equal(taps, w)
    prefix = np.zeros((3, seg), np.float32)
    prefix[lo + 1, r] = ws_lo
    prefix[lo + 2, r] = ws_hi
    prefix[0, ~first] = ws[0, -1]
    np.testing.assert_array_equal(prefix, ws)
    if seg % 2:
        np.testing.assert_array_equal(w[:, seg // 2], [0.0, 1.0, 0.0])


def _osc_inputs(lf, seed=7):
    """f0 80-380 Hz and amplitudes of order 1 (the tolerances are absolute)."""
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((2, lf, 512)).astype(np.float32)
    f0 = (rng.random((2, lf, 1)) * 300 + 80).astype(np.float32)
    w = (rng.standard_normal((512, 64)) * 0.01).astype(np.float32)
    return f0, np.exp(feats @ w).astype(np.float32)


@pytest.mark.parametrize("lf,seg", [(70, 320), (9, 161), (1, 320), (2, 161)])
def test_oscillator_replay(lf, seg):
    """The Chebyshev kernel's arithmetic (two-frame split, two accumulators,
    the scan's wrapped offsets), replayed on the CPU, matches the plain
    version within 5e-5 (float32 roundings in another order) and the
    float64 function within 1e-3."""
    f0, amps = _osc_inputs(lf)
    got = kosc.harmonic_source_replay(t(f0), t(amps), seg=seg)
    assert got.shape == (2, lf * seg, 1)
    assert max_err(got, kosc.harmonic_source_plain(t(f0), t(amps), seg=seg)) <= 5e-5
    assert np.abs(n(got) - _source_f64(f0, amps, seg=seg)).max() <= 1e-3


@pytest.mark.parametrize("lf,seg,jitter", [(70, 320, 0.01), (9, 161, 0.01), (20, 320, 0.0)])
def test_formant_source_replay(lf, seg, jitter):
    """The formant kernel's arithmetic (2-FMA phase over two frames, x -
    rint(x), two accumulators), replayed on the CPU, matches the plain
    version within 5e-5 and the float64 function within 1e-3."""
    formants, amps = _formant_inputs(lf, 9, jitter, 0.01)
    got = kosc.harmonic_source_formants_replay(t(formants), t(amps), seg=seg)
    assert got.shape == (1, lf * seg, 1)
    assert max_err(got, kosc.harmonic_source_formants_plain(t(formants), t(amps), seg=seg)) <= 5e-5
    assert np.abs(n(got) - _formant_source_f64(formants, amps, seg=seg)).max() <= 1e-3


@pytest.mark.parametrize("h", [1, 64])
def test_phase_offsets(h):
    """The scan's offsets lie in [0, 1) and equal, mod 1 and within float32
    rounding (1e-6), the float64 sum of the earlier frames' float32 totals
    minus the phase of sample 0, over 450 frames."""
    rng = np.random.default_rng(11)
    f = (rng.random((3, 450, h)) * 0.02 * np.arange(1, h + 1)).astype(np.float32)
    got = n(kosc.phase_offsets(t(f), 320))
    assert got.shape == (3, 450, h) and (got >= 0).all() and (got <= 1).all()
    _, ws = kosc.interp_weights_np(320)
    fp = np.concatenate([f[:, :1], f, f[:, -1:]], 1)
    tot = ((fp[:, :-2] * ws[0, -1] + fp[:, 1:-1] * ws[1, -1]) + fp[:, 2:] * ws[2, -1]).astype(np.float64)
    p0 = ((fp[:, :1] * ws[0, 0] + fp[:, 1:2] * ws[1, 0]) + fp[:, 2:3] * ws[2, 0]).astype(np.float64)
    want = np.cumsum(tot, 1) - tot - p0
    d = (got - want) % 1.0
    assert np.minimum(d, 1.0 - d).max() <= 1e-6


def test_oscillator_wrappers_need_cuda():
    """The kernel wrappers take only CUDA tensors; the replays launch
    nothing."""
    from alivevc_tpu_torch.kernels import LAUNCHES, reset_launches

    f0, amps = _osc_inputs(4)
    with pytest.raises(ValueError):
        kosc.harmonic_source_cuda(t(f0), t(amps))
    reset_launches()
    kosc.harmonic_source_replay(t(f0), t(amps))
    kosc.harmonic_source_formants_replay(t(f0 * np.arange(1, 65, dtype=np.float32)), t(amps))
    assert all(v == 0 for v in LAUNCHES.values())


LW = 15_360
F = LW // 320


@pytest.fixture(scope="module")
def filter_models():
    params = jdec.init_decoder(jax.random.PRNGKey(0))
    dec = weights.load_decoder(Decoder(DecoderConfig()), params)
    return params, dec


def _level_inputs(i, seed):
    cfg = DecoderConfig()
    rates = list(reversed(cfg.filter_rates))
    chans = list(reversed(cfg.filter_channels))
    lens = [LW // 32, LW // 4, LW // 2, LW]
    cin = chans[max(i - 1, 0)]
    rng = np.random.default_rng(seed)
    x = (0.3 * rng.standard_normal((1, lens[i] // rates[i], cin))).astype(np.float32)
    s = (0.3 * rng.standard_normal((1, lens[i] // rates[i], cin))).astype(np.float32)
    cond = (0.5 * rng.standard_normal((1, F, cfg.channels))).astype(np.float32)
    return x, s, cond, rates[i]


@pytest.mark.parametrize("i", [0, 1, 2, 3])
def test_filter_level_vs_fused_up_pallas(filter_models, i):
    """Level i of the up path against fused_filter_block_up in its packed
    TPU layout ([N, B, P*C] is a reshape of channels-last [N, L, C])."""
    from alivevc_tpu.kernels.filter_pallas import fused_filter_block_up
    from alivevc_tpu.models.filter_packed import _pfac

    params, dec = filter_models
    x, s, cond, r = _level_inputs(i, 30 + i)
    cfg = JDecoderConfig()
    cin = x.shape[2]
    cout = dec.filter.ups[i].weight.shape[1]
    pin = _pfac(cin) if i else 1
    pout = _pfac(cout)
    up = params["filter"]["ups"][i]
    w3 = up["w"].reshape(cin, r, cout).transpose(1, 0, 2)
    with pltpu.force_tpu_interpret_mode():
        want = fused_filter_block_up(
            params["filter"]["blocks"][i], w3, up["b"],
            jnp.asarray(x.reshape(1, -1, pin * cin)), jnp.asarray(s.reshape(1, -1, pin * cin)),
            jnp.asarray(cond), pin, pout, cout, (x.shape[1] * r) // F, r,
            cfg.filter_kernel_size, precision="highest")
    got = kfilter.filter_level(t(x), t(s), rate=r,
                               **level_args(dec.filter.blocks[i], dec.filter.ups[i], t(cond)))
    assert max_err(got.reshape(1, -1), np.asarray(want).reshape(1, -1)) <= 5e-3


@pytest.mark.parametrize("i", [0, 1, 2, 3])
def test_filter_level_vs_filter_block_of_up(filter_models, i):
    params, dec = filter_models
    x, s, cond, r = _level_inputs(i, 50 + i)
    jf = params["filter"]
    want = jdec.filter_block(jf["blocks"][i], jdec._up(jf["ups"][i], jnp.asarray(x + s), r),
                             jnp.asarray(cond))
    got = kfilter.filter_level(t(x), t(s), rate=r,
                               **level_args(dec.filter.blocks[i], dec.filter.ups[i], t(cond)))
    assert got.shape == want.shape
    assert max_err(got, want) <= 5e-3


def test_filter_level_bf16_storage_rounds_like_the_kernel(filter_models):
    """bf16 storage: the plain version rounds after the up conv, the 1x1 conv
    and every causal conv, and stays within bf16 resolution of float32."""
    _, dec = filter_models
    x, s, cond, r = _level_inputs(3, 70)
    args32 = level_args(dec.filter.blocks[3], dec.filter.ups[3], t(cond))
    want = kfilter.filter_level(t(x), t(s), rate=r, **args32)
    blk = dec.filter.blocks[3].to(torch.bfloat16)
    up = dec.filter.ups[3].to(torch.bfloat16)
    got = kfilter.filter_level(t(x).bfloat16(), t(s).bfloat16(), rate=r,
                               **level_args(blk, up, t(cond).bfloat16()))
    dec.filter.to(torch.float32)
    assert got.dtype == torch.bfloat16
    scale = float(want.detach().abs().max())
    assert max_err(got, want) <= 0.05 * (1.0 + scale)


def _level_args(dec, i, cond):
    return level_args(dec.filter.blocks[i], dec.filter.ups[i], t(cond))


@pytest.mark.parametrize("i,tile", [(2, None), (2, 44), (2, 1000), (3, None), (3, 44), (3, 1000)])
def test_filter_tiling_emulation_equals_plain(filter_models, i, tile):
    """The narrow kernel's tiling replayed on the CPU (recomputed 56-sample
    lookback, in-place reflect of a tile that starts at sample 0), at the
    kernel's own tile (199 samples), at a tile shorter than the lookback and
    at one that does not divide L: within 1e-5 of the plain version."""
    _, dec = filter_models
    x, s, cond, r = _level_inputs(i, 90 + i)
    args = _level_args(dec, i, cond)
    if tile is None:
        tile = kfilter.narrow_tile(args["conv_w"][0].shape[0], args["dilations"], r)
        assert tile == 199
    assert (x.shape[1] * r) % tile
    got = kfilter.filter_level_tiled(t(x), t(s), rate=r, tile=tile, **args)
    want = kfilter.filter_level_plain(t(x), t(s), rate=r, **args)
    assert max_err(got, want) <= 1e-5


@pytest.mark.parametrize("i", [0, 1, 2, 3])
def test_filter_3xtf32_products_vs_float64(filter_models, i):
    """float32 storage: every product of the level split as the kernels
    split it (3xTF32), the narrow levels at the kernel's tiling, within
    1e-5 (1 + scale) of the level evaluated in float64 (storage roundings to
    float32 kept)."""
    _, dec = filter_models
    x, s, cond, r = _level_inputs(i, 110 + i)
    args = _level_args(dec, i, cond)
    length = x.shape[1] * r
    tile = kfilter.narrow_tile(5, args["dilations"], r) if i >= 2 else length
    got = kfilter.filter_level_tiled(t(x), t(s), rate=r, tile=tile, products="3xtf32", **args)
    want = kfilter.filter_level_tiled(t(x), t(s), rate=r, tile=length, compute=torch.float64,
                                      **args)
    scale = float(want.detach().abs().max())
    assert max_err(got, want) <= 1e-5 * (1.0 + scale)
    # the split is what carries it: one TF32 product alone is ~1e-3 off
    a, b = t(x).reshape(-1, x.shape[2]), args["up_w"]
    exact = a.double() @ b.double()
    assert float((kfilter.product_3xtf32(a, b) - exact).abs().max()) <= 1e-6 * (1 + float(exact.abs().max()))


def test_film_single_product_equals_per_conv_linears(filter_models):
    """level_args' one FiLM product equals the twelve per-conv linears
    (scale + 1, shift) within 1e-6 in float32."""
    _, dec = filter_models
    _, _, cond, _ = _level_inputs(1, 7)
    blk = dec.filter.blocks[1]
    film = level_args(blk, dec.filter.ups[1], t(cond))["film"]
    c = blk.input_conv.weight.shape[0]
    assert film.shape == (1, F, 12 * c)
    mcs = [mc for rb in blk.blocks for mc in (rb.c1, rb.c2)]
    for i, mc in enumerate(mcs):
        scale, shift = mc.film(t(cond))
        got_scale, got_shift = kfilter.film_of(film, i, c)
        assert max_err(got_scale, scale) <= 1e-6 and max_err(got_shift, shift) <= 1e-6


def test_filter_wrapper_checks(filter_models):
    """The kernel wrapper takes only CUDA tensors and raises on a shape it
    cannot take; the CPU route never launches."""
    from alivevc_tpu_torch.kernels import LAUNCHES, reset_launches

    _, dec = filter_models
    x, s, cond, r = _level_inputs(3, 5)
    args = _level_args(dec, 3, cond)
    with pytest.raises(ValueError):
        kfilter.filter_level_cuda(t(x), t(s), rate=r, **args)
    reset_launches()
    kfilter.filter_level(t(x), t(s), rate=r, **args)
    assert LAUNCHES["filter_level"] == 0
    assert kfilter.lookback(5, args["dilations"]) == 56


def test_cpu_route_and_launch_counts():
    """A CPU tensor takes the plain version and launches nothing."""
    from alivevc_tpu_torch.kernels import LAUNCHES, reset_launches

    reset_launches()
    kstft.stft_magnitude(torch.zeros(1, 3200))
    kosc.harmonic_source(torch.full((1, 4, 1), 100.0), torch.ones(1, 4, 8))
    kosc.harmonic_source_formants(torch.full((1, 4, 8), 100.0), torch.ones(1, 4, 8))
    kknn.knn_topk(torch.randn(4, 32), torch.randn(8, 32), extraction="packed")
    assert all(v == 0 for v in LAUNCHES.values())
    with pytest.raises(ValueError):
        kstft.stft_magnitude_cuda(torch.zeros(1, 3200))
    with pytest.raises(ValueError):
        kosc.harmonic_source_formants_cuda(torch.zeros(1, 4, 8), torch.ones(1, 4, 8))
