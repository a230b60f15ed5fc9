"""One GAN step of the port (``alivevc_tpu_torch/train/gan.py``) against the
JAX package's (``alivevc_tpu/train/gan.py``) on the CPU: the same weights
(the port's, carried into JAX pytrees by the JAX package's importer), the
same batch and the same random draws (amplitudes and F0 jitter from the JAX
key, handed to the port as tensors).  JAX runs its plain U-Net here
(``select_filter_impl`` is 'plain' off the TPU) and its trainer's XLA
oscillator; the port runs its plain versions (the kernels' ``Function``s run
on the card).

Tolerances, with their causes:
  * losses: 1e-4 relative (float32 sums in another order; the decoders'
    outputs differ by the oscillator, below);
  * gradients: 2e-3 of each tensor's largest entry.  Measured 1.6e-3, at the
    U-Net's bottom (``filter.ups.0``, ``mid_conv``, ``downs.3``): the JAX
    trainer's oscillator sums the phase as a float32 cumsum over the
    window, the port's from a float64 base phase a frame, and the decoders'
    outputs differ by 4.8e-5 abs (2.8e-4 of the peak) at 9 600 samples;
    that difference enters the U-Net at its input;
  * parameters after the step: 2.5 lr abs (AdamW's first step is about
    lr * sign(g), so an entry whose tiny gradient differs in sign moves by
    2 lr), and entries more than lr / 2 apart at most 0.5 % of all.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from alivevc_tpu import config as jc
from alivevc_tpu.train import gan as jgan
from alivevc_tpu_torch.compat import weights
from alivevc_tpu_torch.train import gan as tgan

from test_torch_port_util import DEC_KW, DISC_KW, n, t, train_models, train_wave, worst_rel

LR = 1e-4


@pytest.fixture(scope="module")
def run():
    params, (ce, f0m, dec, disc) = train_models(0)
    jdcfg, jdisc, jtc = jc.DecoderConfig(**DEC_KW), jc.DiscriminatorConfig(**DISC_KW), jc.TrainConfig()
    opt_g, opt_d = jgan._make_opts(jtc)
    state = jgan.GanState(params["dec"], params["disc"], opt_g.init(params["dec"]),
                          opt_d.init(params["disc"]), jnp.zeros((), jnp.int32))
    wave = train_wave(2, 9600, seed=1)
    r_amp, r_f0 = jax.random.split(jax.random.PRNGKey(3))
    amp = np.asarray(jax.random.uniform(r_amp, (2, 1)) * 2.0)
    jitter = np.asarray(0.5 + jax.random.uniform(r_f0, (1, 1, 1)))
    grads = jax.jit(jgan._gan_grads, static_argnames=("cfg", "dec_cfg", "disc_cfg"))
    gg, gd, metrics = grads(state, params["ce"], params["f0"], jnp.asarray(wave), r_amp, r_f0,
                            cfg=jtc, dec_cfg=jdcfg, disc_cfg=jdisc)
    after = jax.jit(jgan._apply_updates, static_argnums=3)(state, gg, gd, jtc)
    dcfg = dec.cfg
    port = dict(ce=ce, f0m=f0m, dec=dec, disc=disc, wave=t(wave), amp=t(amp), jitter=t(jitter))
    jax_out = dict(grads_g=weights.decoder_state(gg, dcfg), grads_d=weights.discriminator_state(gd),
                   metrics={k: float(v) for k, v in metrics.items()},
                   dec=weights.decoder_state(after.dec_params, dcfg),
                   disc=weights.discriminator_state(after.disc_params))
    return port, jax_out


def _state(port):
    return tgan.init_gan(copy.deepcopy(port["dec"]), copy.deepcopy(port["disc"]))


def test_gan_grads_match_jax(run):
    port, want = run
    state = _state(port)
    g, d, metrics = tgan.gan_grads(state, port["ce"], port["f0m"], port["wave"], port["amp"],
                                   port["jitter"])
    for k, v in want["metrics"].items():
        assert abs(float(metrics[k]) - v) <= 1e-4 * abs(v), (k, float(metrics[k]), v)
    err, name = worst_rel(dict(zip([k for k, _ in state.dec.named_parameters()], g)),
                          want["grads_g"])
    assert err <= 2e-3, (name, err)
    err, name = worst_rel(dict(zip([k for k, _ in state.disc.named_parameters()], d)),
                          want["grads_d"])
    assert err <= 2e-3, (name, err)
    # nothing accumulated in .grad: G's gradients came from autograd.grad
    assert all(p.grad is None for p in list(state.dec.parameters()) + list(state.disc.parameters()))


def test_gan_train_step_matches_jax(run):
    port, want = run
    state = _state(port)
    before = {k: v.clone() for k, v in state.dec.state_dict().items()}
    metrics = tgan.gan_train_step(state, port["ce"], port["f0m"], port["wave"], port["amp"],
                                  port["jitter"])
    assert state.step == 1 and tgan.update_count(state.opt_g) == 1
    assert abs(float(metrics["loss_d"]) - want["metrics"]["loss_d"]) <= 1e-4 * want["metrics"]["loss_d"]
    for model, key in ((state.dec, "dec"), (state.disc, "disc")):
        moved, total = 0, 0
        for name, p in model.state_dict().items():
            diff = np.abs(n(p) - want[key][name])
            assert diff.max() <= 2.5 * LR, (name, diff.max())
            moved += int((diff > 0.5 * LR).sum())
            total += diff.size
        assert moved <= 0.005 * total, (key, moved, total)
    assert any(not torch.equal(before[k], v) for k, v in state.dec.state_dict().items())
