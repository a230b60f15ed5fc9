"""Fine-tuning of the port (``alivevc_tpu_torch/train/fine_tune.py``) against
the JAX package's ``fine_tune_step`` on the CPU, with the voice library
co-trained (here) and without it, the discriminator frozen
(tests/test_torch_port_train_frozen.py): the same weights (the port's,
carried into JAX pytrees by the JAX package's importer), batch and
amplitude draws (from the JAX key, handed to the port as a tensor).

Tolerances, with their causes:
  * losses: 1e-4 relative (the decoders' outputs differ by the oscillator's
    two forms, tests/test_torch_port_train_gan.py);
  * the library match's gradient into the tokens: 1e-5 of its largest
    entry (a gather-mean: the same float32 sums on both sides; the top-k
    index sets are identical);
  * the step's gradients (decoder, tokens, discriminator): 2e-3 of each
    tensor's largest entry, the GAN test's tolerance for the same cause
    (the oscillator's two forms enter the U-Net at its input; measured
    6.5e-4 for the decoder with the library and 8.4e-4 without, 1.1e-4 for
    the tokens, 7.1e-5 for the discriminator).  JAX's step
    is one jitted function, so its gradients are read from its optimizers:
    each is wrapped (``_recording``) to keep, in its state, the gradient
    its update was given; the updates stay optax's;
  * parameters after the step (decoder, discriminator, tokens): 2.5 lr abs
    (AdamW's first step is about lr * sign(g), whatever the gradient's
    scale), and entries more than lr / 2 apart at most 0.5 % of all.
"""

import copy

import numpy as np
import torch

import jax
import jax.numpy as jnp
import optax

from alivevc_tpu import config as jc
from alivevc_tpu.compat import torch_import as ti
from alivevc_tpu.models.voice_library import voice_library_match as jmatch
from alivevc_tpu.train import fine_tune as jft
from alivevc_tpu_torch import config as tc
from alivevc_tpu_torch.compat import weights
from alivevc_tpu_torch.models.voice_library import VoiceLibrary, voice_library_match
from alivevc_tpu_torch.train import fine_tune as tft

from test_torch_port_util import DEC_KW, DISC_KW, n, t, train_models, train_wave, worst_rel

LR = 1e-4
VL_KW = dict(num_tokens=512, dim=DEC_KW["content_channels"])


def _recording(opt: optax.GradientTransformation) -> optax.GradientTransformation:
    """``opt``, keeping beside its state the gradient of its last update."""

    def init(params):
        return opt.init(params), jax.tree_util.tree_map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        updates, inner = opt.update(grads, state[0], params)
        return updates, (inner, grads)

    return optax.GradientTransformation(init, update)


def run_fine_tune(monkeypatch, use_library: bool, freeze_discriminator: bool):
    """The port's and JAX's fine-tuning step on the same inputs; asserts the
    losses, the gradients and the parameters after the step."""
    opts = jft._opts
    monkeypatch.setattr(jft, "_opts", lambda cfg: tuple(_recording(o) for o in opts(cfg)))
    params, (ce, f0m, dec, disc) = train_models(0)
    vl = VoiceLibrary(tc.VoiceLibraryConfig(**VL_KW), generator=torch.Generator().manual_seed(4))
    vl_params = ti.import_voice_library({"tokens": vl.tokens.detach().numpy()})
    jtc = jc.TrainConfig()
    state = jft.init_fine_tune(params["dec"], params["disc"], vl_params, jtc)
    wave = train_wave(2, 9600, seed=2)
    key = jax.random.PRNGKey(7)
    amp = np.asarray(jax.random.uniform(key, (2, 1)) * 2.0)
    after, metrics = jft.fine_tune_step(
        state, params["ce"], params["f0"], jnp.asarray(wave), key, use_library=use_library,
        freeze_discriminator=freeze_discriminator, cfg=jtc, dec_cfg=jc.DecoderConfig(**DEC_KW),
        disc_cfg=jc.DiscriminatorConfig(**DISC_KW))

    pstate = tft.init_fine_tune(copy.deepcopy(dec), copy.deepcopy(disc), vl)
    disc_before = copy.deepcopy(pstate.disc.state_dict())
    tokens_before = vl.tokens.detach().clone()
    grads_g, grads_vl, grads_d, _ = tft.fine_tune_grads(
        pstate, ce, f0m, t(wave), t(amp), use_library=use_library,
        freeze_discriminator=freeze_discriminator)
    named = lambda m, g: dict(zip([k for k, _ in m.named_parameters()], g))  # noqa: E731
    checks = [(named(pstate.dec, grads_g), weights.decoder_state(after.dec_opt[1], dec.cfg))]
    if use_library:
        checks.append((named(pstate.vl, grads_vl), weights.voice_library_state(after.vl_opt[1])))
    assert (grads_vl is None) != use_library
    if freeze_discriminator:
        assert grads_d is None
    else:
        checks.append((named(pstate.disc, grads_d), weights.discriminator_state(after.disc_opt[1])))
    for got_g, want_g in checks:
        err, name = worst_rel(got_g, want_g)
        assert err <= 2e-3, (name, err)

    got = tft.fine_tune_step(pstate, ce, f0m, t(wave), t(amp), use_library=use_library,
                             freeze_discriminator=freeze_discriminator)
    for k, v in metrics.items():
        v = float(v)
        assert abs(float(got[k]) - v) <= 1e-4 * max(abs(v), 1e-6), (k, float(got[k]), v)
    want = {"dec": weights.decoder_state(after.dec_params, dec.cfg),
            "disc": weights.discriminator_state(after.disc_params),
            "vl": weights.voice_library_state(after.vl_params)}
    for model, key_ in ((pstate.dec, "dec"), (pstate.disc, "disc"), (pstate.vl, "vl")):
        moved, total = 0, 0
        for name, p in model.state_dict().items():
            diff = np.abs(n(p) - want[key_][name])
            assert diff.max() <= 2.5 * LR, (key_, name, diff.max())
            moved += int((diff > 0.5 * LR).sum())
            total += diff.size
        assert moved <= 0.005 * total, (key_, moved, total)
    if freeze_discriminator:
        assert all(torch.equal(v, disc_before[k]) for k, v in pstate.disc.state_dict().items())
        assert float(got["loss_d"]) == 0.0
    assert torch.equal(pstate.vl.tokens, tokens_before) != use_library


def test_voice_library_match_and_its_gradient_match_jax():
    rng = np.random.default_rng(3)
    tokens = rng.standard_normal((512, 64)).astype(np.float32)
    source = rng.standard_normal((2, 30, 64)).astype(np.float32)
    w = rng.standard_normal((2, 30, 64)).astype(np.float32)
    want_m = jmatch({"tokens": jnp.asarray(tokens)}, jnp.asarray(source), 4, 0.25)
    want_g = jax.grad(lambda p: jnp.sum(jmatch(p, jnp.asarray(source), 4, 0.25) * w))(
        {"tokens": jnp.asarray(tokens)})["tokens"]
    vl = VoiceLibrary(tc.VoiceLibraryConfig(**VL_KW))
    with torch.no_grad():
        vl.tokens.copy_(t(tokens).t()[None])
    got = voice_library_match(vl, t(source), 4, 0.25)
    assert np.abs(n(got) - np.asarray(want_m)).max() <= 1e-5
    (got_g,) = torch.autograd.grad((got * t(w)).sum(), vl.tokens)
    want_g = np.asarray(want_g).T[None]                       # [1, D, num_tokens]
    assert np.abs(n(got_g) - want_g).max() <= 1e-5 * np.abs(want_g).max()
    assert (np.abs(want_g).sum(axis=1) > 0).sum() > 10        # many tokens were picked


def test_fine_tune_step_with_library_matches_jax(monkeypatch):
    run_fine_tune(monkeypatch, use_library=True, freeze_discriminator=False)
