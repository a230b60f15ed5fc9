"""The training side of the port against the JAX package on the CPU: the
discriminator and its weight bridge, the losses, the optimizers against
optax, the kernels' ``torch.autograd.Function``s, the F0 trainer's step and
voice-library generation.

Tolerances, with their causes:
  * discriminator logits 1e-5 abs, its feature loss and the losses 1e-5
    relative (float32 convolutions and sums in another order);
  * optimizers: 1e-6 abs on the parameters over 8 steps (optax's and the
    port's float32 updates round apart; the steps cross RAdam's rho >= 5
    switch).  AdamW at lr 1e-2; RAdam at the F0 trainer's lr 1e-4.  At lr
    1e-2 RAdam ends 2.6e-6
    apart: from step 6 on, r = sqrt((rho - 4)(rho - 2) ...) follows
    rho = rho_inf - 2 t b2^t / (1 - b2^t), whose 1 - b2^t cancels, and
    XLA's float32 b2^t is one ulp above the correctly rounded value (t >= 6)
    that torch's pow gives, which moves r by ~0.5 %;
  * each ``Function``'s gradients against plain autograd: 1e-6 relative (the
    same plain computation, recomputed);
  * one filter level's gradients against ``jax.grad`` of JAX's plain
    ``filter_block`` o ``_up``: 1e-4 of each tensor's largest entry (float32
    convolutions in another order, through six dilated convs);
  * the F0 step: loss 1e-5 relative, parameters after the step 1e-6 abs
    (RAdam's first step is lr * m_hat, linear in the gradient);
  * voice-library generation: the same slots and frames as JAX, the written
    rows within 1e-4 of JAX's content features (tests/test_torch_port_models.py's
    content-encoder tolerance).
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from alivevc_tpu import config as jc
from alivevc_tpu.compat import torch_import as ti
from alivevc_tpu.models import discriminator as jdisc
from alivevc_tpu.train import f0 as jf0
from alivevc_tpu.train import losses as jl
from alivevc_tpu.train.library_gen import generate_voice_library as jgen
from alivevc_tpu.train.optim import adamw_gan as j_adamw_gan
from alivevc_tpu_torch import config as tc
from alivevc_tpu_torch.compat import weights
from alivevc_tpu_torch.kernels import filter as kfilter
from alivevc_tpu_torch.kernels import oscillator as kosc
from alivevc_tpu_torch.kernels import stft as kstft
from alivevc_tpu_torch.models import discriminator as tdisc
from alivevc_tpu_torch.models.decoder import level_args
from alivevc_tpu_torch.models.voice_library import VoiceLibrary
from alivevc_tpu_torch.train import f0 as tf0
from alivevc_tpu_torch.train import losses as tl
from alivevc_tpu_torch.train import optim as topt
from alivevc_tpu_torch.train.library_gen import generate_voice_library as tgen
from alivevc_tpu_torch.train.library_gen import library_slots

from test_torch_port_util import DEC_KW, DISC_KW, n, t, train_models, train_wave


@pytest.fixture(scope="module")
def models():
    return train_models(0)


def _sd(m):
    return {k: v.detach().numpy() for k, v in m.state_dict().items()}


# ---------------------------------------------------------------------------
# weights and the discriminator
# ---------------------------------------------------------------------------


def test_discriminator_and_library_weights_round_trip(models):
    """port state dict -> JAX ``import_discriminator`` -> the port's
    ``discriminator_state`` gives the state dict back, and
    ``load_discriminator`` loads it (strict); the same for the library."""
    params, (_, _, _, disc) = models
    sd = _sd(disc)
    back = weights.discriminator_state(params["disc"])
    assert set(back) == set(sd)
    assert all(np.array_equal(back[k], sd[k]) for k in sd)
    loaded = weights.load_discriminator(tdisc.Discriminator(tc.DiscriminatorConfig(**DISC_KW)),
                                        params["disc"])
    assert all(torch.equal(v, disc.state_dict()[k]) for k, v in loaded.state_dict().items())
    assert weights.discriminator_config(sd) == tc.DiscriminatorConfig(**DISC_KW)
    assert weights.discriminator_config(_sd(tdisc.Discriminator())) == tc.DiscriminatorConfig()
    tokens = np.random.default_rng(0).standard_normal((512, 64)).astype(np.float32)
    vl = weights.load_voice_library(VoiceLibrary(tc.VoiceLibraryConfig(dim=64)), {"tokens": tokens})
    assert np.array_equal(n(vl.matrix()), tokens)
    assert np.array_equal(np.asarray(ti.import_voice_library(_sd(vl))["tokens"]), tokens)


def test_discriminator_logits_and_feature_loss_match_jax(models):
    params, (_, _, _, disc) = models
    cfg = jc.DiscriminatorConfig(**DISC_KW)
    rng = np.random.default_rng(1)
    real, fake = (0.3 * rng.standard_normal((2, 2401))).astype(np.float32), \
        (0.3 * rng.standard_normal((2, 2401))).astype(np.float32)
    want = jdisc.discriminator_logits(params["disc"], jnp.asarray(fake), cfg)
    got = tdisc.discriminator_logits(disc, t(fake))
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert a.shape == b.shape and np.abs(n(a) - np.asarray(b)).max() <= 1e-5
    want_l = float(jdisc.discriminator_feat_loss(params["disc"], jnp.asarray(fake),
                                                 jnp.asarray(real), cfg))
    got_l = float(tdisc.discriminator_feat_loss(disc, t(fake), t(real)).detach())
    assert abs(got_l - want_l) <= 1e-5 * want_l
    # the quirks: 5 MPD stage outputs a period, and per item the MRD's last
    # activation, so the MRD term is a sum over the batch
    feats = tdisc.discriminator_feats(disc, t(fake))
    assert len(feats) == 5 * 2 + 2 and feats[-1].dim() == 3
    mrd = lambda m, f, r: sum(float((a - b).abs().mean().detach()) for a, b in zip(  # noqa: E731
        tdisc.discriminator_feats(m, f)[10:], tdisc.discriminator_feats(m, r)[10:]))
    twice = mrd(disc, t(np.concatenate([fake, fake])), t(np.concatenate([real, real])))
    assert abs(twice - 2 * mrd(disc, t(fake), t(real))) <= 1e-5 * twice


# ---------------------------------------------------------------------------
# losses and optimizers
# ---------------------------------------------------------------------------


def test_losses_match_jax():
    rng = np.random.default_rng(2)
    a, b = train_wave(2, 6400, 3), train_wave(2, 6400, 4)
    assert np.array_equal(n(tl.cut_center(t(a))), np.asarray(jl.cut_center(jnp.asarray(a))))
    assert tl.cut_center(t(a)).shape == (2, 1600)
    want = float(jl.mel_l1_loss(jnp.asarray(a), jnp.asarray(b)))
    assert abs(float(tl.mel_l1_loss(t(a), t(b))) - want) <= 1e-5 * want
    bad = a.copy()
    bad[0, 100] = np.inf
    got = float(tl.mel_l1_loss(t(bad), t(b)))
    assert np.isfinite(got) and abs(got - float(jl.mel_l1_loss(jnp.asarray(bad), jnp.asarray(b)))) \
        <= 1e-5 * got
    logits = [rng.standard_normal(s).astype(np.float32) for s in ((2, 5, 3, 1), (2, 7, 2, 1))]
    lf = [rng.standard_normal(s).astype(np.float32) for s in ((2, 5, 3, 1), (2, 7, 2, 1))]
    want = float(jl.generator_adv_loss([jnp.asarray(x) for x in logits]))
    assert abs(float(tl.generator_adv_loss([t(x) for x in logits])) - want) <= 1e-6 * want
    want = float(jl.discriminator_adv_loss([jnp.asarray(x) for x in logits],
                                           [jnp.asarray(x) for x in lf]))
    got = float(tl.discriminator_adv_loss([t(x) for x in logits], [t(x) for x in lf]))
    assert abs(got - want) <= 1e-6 * want
    f0_logits = rng.standard_normal((2, 6, 4096)).astype(np.float32)
    f0 = rng.uniform(0.0, 400.0, (2, 6)).astype(np.float32)
    f0[0, :3] = 0.3                                    # floor -> 0: unvoiced
    want = float(jl.f0_cross_entropy(jnp.asarray(f0_logits), jnp.asarray(f0)))
    assert abs(float(tl.f0_cross_entropy(t(f0_logits), t(f0))) - want) <= 1e-5 * want
    total, count = tl.f0_cross_entropy_parts(t(f0_logits), t(f0[..., None]))
    assert int(count) == 9
    # every frame unvoiced: 0 (the max(1) guard), not NaN
    assert float(tl.f0_cross_entropy(t(f0_logits), torch.zeros(2, 6))) == 0.0


def _optax_run(opt, params, grads):
    """The parameters after each update."""
    state, out = opt.init(params), []
    for g in grads:
        upd, state = opt.update(g, state, params)
        params = optax.apply_updates(params, upd)
        out.append(np.asarray(params))
    return out


@pytest.mark.parametrize("name", ["adamw_gan", "library_adamw", "radam"])
def test_optimizer_matches_optax(name):
    rng = np.random.default_rng(5)
    p0 = rng.standard_normal((7, 5)).astype(np.float32)
    grads = [rng.standard_normal((7, 5)).astype(np.float32) * s for s in (1, 0.5, 2, 1, 0.1, 3, 1, 0.7)]
    lr, t_max = (1e-4 if name == "radam" else 1e-2), 6
    if name == "adamw_gan":
        want = _optax_run(j_adamw_gan(lr, 0.8, 0.99, t_max), jnp.asarray(p0), map(jnp.asarray, grads))
    elif name == "library_adamw":
        want = _optax_run(optax.adamw(lr), jnp.asarray(p0), map(jnp.asarray, grads))
    else:
        want = _optax_run(optax.radam(lr), jnp.asarray(p0), map(jnp.asarray, grads))
    p = torch.nn.Parameter(t(p0))
    opt = {"adamw_gan": lambda: topt.adamw_gan([p], lr, 0.8, 0.99),
           "library_adamw": lambda: topt.library_adamw([p], lr),
           "radam": lambda: topt.RAdam([p], lr=lr)}[name]()
    schedule = topt.cosine_annealing(lr, t_max)
    for i, g in enumerate(grads):
        if name == "adamw_gan":
            topt.set_lr(opt, schedule(i))
        topt.apply_grads(opt, [p], [t(g)])
        assert np.abs(n(p) - want[i]).max() <= 1e-6, i


# ---------------------------------------------------------------------------
# the kernels' autograd Functions
# ---------------------------------------------------------------------------


def _grads(out, inputs, w):
    return torch.autograd.grad((out * w).sum(), inputs)


def _assert_same(a, b):
    for x, y in zip(a, b):
        assert np.abs(n(x) - n(y)).max() <= 1e-6 * max(np.abs(n(y)).max(), 1e-30)


def test_functions_backward_is_the_plain_gradient(models, monkeypatch):
    """Each ``Function``, with its kernel launch replaced by the plain
    version (no card here), gives the plain version's autograd gradients
    for every input that asks for one, and None for the others."""
    _, (_, _, dec, _) = models
    monkeypatch.setattr(kfilter, "filter_level_cuda", kfilter.filter_level_plain)
    monkeypatch.setattr(kosc, "harmonic_source_cuda", kosc.harmonic_source_plain)
    monkeypatch.setattr(kstft, "stft_magnitude_cuda", kstft.stft_magnitude_plain)
    g = torch.Generator().manual_seed(0)
    # filter level 3 (C = 8, rate 2)
    up, blk = dec.filter.ups[3], dec.filter.blocks[3]
    x = (0.3 * torch.randn(2, 60, 16, generator=g)).requires_grad_(True)
    s = 0.3 * torch.randn(2, 60, 16, generator=g)
    cond = (0.5 * torch.randn(2, 3, DEC_KW["channels"], generator=g)).requires_grad_(True)
    wanted = [x, cond, up.weight, blk.blocks[1].c2.conv.conv.weight, blk.input_conv.bias]
    a = level_args(blk, up, cond)
    flat = [x, s, a["up_w"], a["up_b"], a["in_w"], a["in_b"], *a["conv_w"], *a["conv_b"], a["film"]]
    out = kfilter.FilterLevelFunction.apply(2, tuple(a["dilations"]), len(a["conv_w"]), *flat)
    w = torch.randn(out.shape, generator=g)
    got = _grads(out, wanted, w)
    plain = kfilter.filter_level_plain(x, s, rate=2, **level_args(blk, up, cond))
    assert torch.equal(out, plain)
    _assert_same(got, _grads(plain, wanted, w))
    # the Chebyshev source: gradients to amps (and f0 where asked)
    f0 = (100.0 + 50.0 * torch.rand(2, 5, 1, generator=g)).requires_grad_(True)
    amps = torch.rand(2, 5, 16, generator=g).requires_grad_(True)
    out = kosc.HarmonicSourceFunction.apply(f0, amps, 16_000, 320)
    w = torch.randn(out.shape, generator=g)
    _assert_same(_grads(out, [f0, amps], w), _grads(kosc.harmonic_source_plain(f0, amps), [f0, amps], w))
    out = kosc.HarmonicSourceFunction.apply(f0.detach(), amps, 16_000, 320)
    assert out.grad_fn.next_functions[0][0] is None    # no gradient asked for f0
    # the STFT magnitude
    wave = (0.3 * torch.randn(2, 3200, generator=g)).requires_grad_(True)
    out = kstft.StftMagnitudeFunction.apply(wave, 1280, 320)
    w = torch.randn(out.shape, generator=g)
    _assert_same(_grads(out, [wave], w), _grads(kstft.stft_magnitude_plain(wave), [wave], w))


def test_filter_level_gradients_match_jax(models):
    """One up level (level 2: C = 16, rate 2) differentiated through the
    port's ``filter_level`` against ``jax.grad`` of JAX's plain
    ``filter_block`` o ``_up``."""
    # the JAX package's models/__init__.py re-exports a function named decoder
    jdec = importlib.import_module("alivevc_tpu.models.decoder")

    params, (_, _, dec, _) = models
    rng = np.random.default_rng(6)
    x = (0.3 * rng.standard_normal((2, 120, 64))).astype(np.float32)
    s = (0.3 * rng.standard_normal((2, 120, 64))).astype(np.float32)
    cond = (0.5 * rng.standard_normal((2, 3, DEC_KW["channels"]))).astype(np.float32)
    w = rng.standard_normal((2, 240, 16)).astype(np.float32)
    fp = params["dec"]["filter"]

    def loss(up, blk, x, c):
        return jnp.sum(jdec.filter_block(blk, jdec._up(up, x + jnp.asarray(s), 2), c) * w)

    g_up, g_blk, g_x, g_c = jax.grad(loss, argnums=(0, 1, 2, 3))(
        fp["ups"][2], fp["blocks"][2], jnp.asarray(x), jnp.asarray(cond))
    up, blk = dec.filter.ups[2], dec.filter.blocks[2]
    xt, ct = t(x).requires_grad_(True), t(cond).requires_grad_(True)
    out = kfilter.filter_level(xt, t(s), rate=2, **level_args(blk, up, ct))
    names = [k for k, _ in up.named_parameters()] + [k for k, _ in blk.named_parameters()]
    got = torch.autograd.grad((out * t(w)).sum(), [xt, ct, *up.parameters(), *blk.parameters()])
    want_sd = {}
    weights.up_state(want_sd, "u", g_up, 64, 16, 2)
    weights.filter_block_state(want_sd, "b", g_blk)
    want = [np.asarray(g_x), np.asarray(g_c)] + [want_sd[f"u.{k}"] for k, _ in up.named_parameters()] \
        + [want_sd[f"b.{k}"] for k, _ in blk.named_parameters()]
    for name, a, b in zip(["x", "cond"] + names, got, want):
        assert np.abs(n(a) - b).max() <= 1e-4 * np.abs(b).max(), name


# ---------------------------------------------------------------------------
# the F0 trainer and library generation
# ---------------------------------------------------------------------------


def test_f0_train_step_matches_jax(models):
    params, (_, f0m, _, _) = models
    wave = train_wave(2, 6400, 7)
    f0 = np.random.default_rng(8).uniform(60.0, 300.0, (2, 20)).astype(np.float32)
    f0[1, 5:9] = 0.0
    key = jax.random.PRNGKey(9)
    amp = np.asarray(jax.random.uniform(key, (2, 1)) * 0.75 + 0.25)
    jstate = jf0.F0TrainState(params["f0"], optax.radam(1e-4).init(params["f0"]),
                              jnp.zeros((), jnp.int32))
    jafter, jm = jf0.f0_train_step(jstate, jnp.asarray(wave), jnp.asarray(f0), key)
    model = tf0.F0Estimator(f0m.cfg)
    model.load_state_dict(f0m.state_dict())
    state = tf0.init_f0_train(model)
    m = tf0.f0_train_step(state, t(wave), t(f0), t(amp))
    assert state.step == 1
    assert abs(float(m["loss"]) - float(jm["loss"])) <= 1e-5 * float(jm["loss"])
    want = weights.f0_estimator_state(jafter.params)
    for name, p in model.state_dict().items():
        assert np.abs(n(p) - want[name]).max() <= 1e-6, name
    assert not torch.equal(model.output_layer.weight, f0m.output_layer.weight)


def test_generate_voice_library_matches_jax(models):
    """The same slots and frames as JAX's (numpy draws), the written rows
    equal to JAX's content features; unhit slots keep the port's own
    Gaussian init."""
    params, (ce, _, _, _) = models
    chunks = train_wave(40, 7680, 10)
    cfg = tc.VoiceLibraryConfig(num_tokens=64, dim=DEC_KW["content_channels"])
    want = np.asarray(jgen(params["ce"], chunks, seed=3, cfg=jc.VoiceLibraryConfig(**vars(cfg)),
                           batch_size=16)["tokens"])
    vl = tgen(ce, chunks, seed=3, cfg=cfg, batch_size=16, device="cpu")
    got = n(vl.matrix())
    slots = library_slots(40, 24, seed=3, num_tokens=64)
    hit = sorted({s for s, _ in slots})
    assert 20 < len(hit) < 64
    assert np.abs(got[hit] - want[hit]).max() <= 1e-4
    miss = sorted(set(range(64)) - set(hit))
    assert not np.allclose(got[miss], want[miss])     # the inits differ (torch vs JAX draws)
