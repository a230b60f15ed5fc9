"""The port's kernel modules (alivevc_tpu_torch/kernels/) against the
JAX package's Pallas kernels, which run here as the JAX package's own tests
run them: under ``pltpu.force_tpu_interpret_mode()`` on the CPU.  On the CPU
each port wrapper takes its kernel's plain PyTorch version, because the
tensors it is given lie on the CPU.

The CUDA kernels themselves build and run only on the card:
test_torch_port_gpu.py holds them against their plain versions there, and
chip_smoke.py does so at the conversion path's full shapes.

Tolerances, with their reasons:
  * STFT: 1e-4 abs (float32 DFT sums of 1280 products, another order);
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
