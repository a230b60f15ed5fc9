"""Fine-tuning on target-speaker data, optionally co-training the voice
library (``alivevc_tpu/train/fine_tune.py``; reference: fine_tune.py:137-204).

The GAN step without the rolled fake branch.  With ``use_library`` the
reconstruction goes through the differentiable ``voice_library_match``
(the kNN kernel picks the tokens, the gather-mean carries the gradient
into them) and a third optimizer, ``optax.adamw(lr)``'s
(``train/optim.py:library_adamw``), trains the tokens; without it the
content is self-matched.  ``freeze_discriminator`` leaves the
discriminator and its optimizer as they are (loss_d reported as 0).  All
losses come from the parameters before the update.  The amplitude draw
``amp`` [N, 1] ~ U(0, 2) is a tensor the caller makes (``amp_draws``).
Under a process group (``group``) each rank takes its slice of the batch,
and each model's gradients and the metrics are averaged over the ranks
(one all-reduce each, ``train/dp.py``); with ``group=None`` no collective
runs.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from alivevc_tpu_torch.config import TrainConfig
from alivevc_tpu_torch.models.content_encoder import ContentEncoder
from alivevc_tpu_torch.models.decoder import Decoder, decoder
from alivevc_tpu_torch.models.discriminator import Discriminator, discriminator_logits
from alivevc_tpu_torch.models.f0_estimator import F0Estimator
from alivevc_tpu_torch.models.voice_library import VoiceLibrary, voice_library_match
from alivevc_tpu_torch.ops.knn import match_features
from alivevc_tpu_torch.train import dp
from alivevc_tpu_torch.train.gan import (
    Metrics,
    discriminator_loss,
    frozen_features,
    generator_losses,
    update_count,
)
from alivevc_tpu_torch.train.losses import cut_center
from alivevc_tpu_torch.train.optim import (
    adamw_gan,
    apply_grads,
    cosine_annealing,
    library_adamw,
    set_lr,
)


@dataclasses.dataclass
class FineTuneState:
    dec: Decoder
    disc: Discriminator
    vl: Optional[VoiceLibrary]
    opt_g: torch.optim.Optimizer
    opt_d: torch.optim.Optimizer
    opt_vl: Optional[torch.optim.Optimizer]
    step: int = 0


def init_fine_tune(dec: Decoder, disc: Discriminator, vl: Optional[VoiceLibrary] = None,
                   cfg: TrainConfig = TrainConfig()) -> FineTuneState:
    """The state of a fine-tuning run (the modules train in place)."""
    for m in (dec, disc, vl):
        if m is not None:
            m.train().requires_grad_(True)
    return FineTuneState(
        dec, disc, vl,
        adamw_gan(dec.parameters(), cfg.learning_rate, cfg.adam_b1, cfg.adam_b2),
        adamw_gan(disc.parameters(), cfg.learning_rate, cfg.adam_b1, cfg.adam_b2),
        library_adamw(vl.parameters(), cfg.learning_rate) if vl is not None else None)


def amp_draws(n: int, generator: torch.Generator, device) -> torch.Tensor:
    """amp [n, 1] ~ U(0, 2) from a CPU generator, moved to ``device``."""
    return (torch.rand((n, 1), generator=generator) * 2.0).to(device)


def fine_tune_grads(state: FineTuneState, ce: ContentEncoder, pe: F0Estimator,
                    wave: torch.Tensor, amp: torch.Tensor, use_library: bool = True,
                    freeze_discriminator: bool = False, cfg: TrainConfig = TrainConfig(),
                    group: Optional[dist.ProcessGroup] = None):
    """(G's gradients, the tokens' gradients or None, D's gradients or None,
    metrics) of one batch, averaged over ``group``'s ranks; no update."""
    if use_library and state.vl is None:
        raise ValueError("use_library needs a voice library in the state")
    wave = wave * amp
    content, f0 = frozen_features(ce, pe, wave)
    if use_library:
        matched = voice_library_match(state.vl, content)
    else:
        with torch.no_grad():
            matched = match_features(content, content)
    wave_recon, _ = decoder(state.dec, matched, f0)
    logits = discriminator_logits(state.disc, cut_center(wave_recon))
    metrics = generator_losses(state.disc, ce, wave, wave_recon, content, logits, cfg)
    params = list(state.dec.parameters()) + (list(state.vl.parameters()) if use_library else [])
    grads = torch.autograd.grad(metrics["loss_g"], params)
    n_dec = len(list(state.dec.parameters()))
    grads_g, grads_vl = grads[:n_dec], (grads[n_dec:] if use_library else None)
    metrics = {k: v.detach() for k, v in metrics.items()}
    if freeze_discriminator:
        grads_d = None
        metrics["loss_d"] = torch.zeros((), device=wave.device)
    else:
        loss_d = discriminator_loss(state.disc, wave, wave_recon.detach())
        grads_d = torch.autograd.grad(loss_d, list(state.disc.parameters()))
        metrics["loss_d"] = loss_d.detach()
    grads_g, grads_vl, grads_d = (None if g is None else dp.all_reduce_flat(g, True, group)
                                  for g in (grads_g, grads_vl, grads_d))
    return grads_g, grads_vl, grads_d, dp.all_reduce_metrics(metrics, group)


def apply_fine_tune_updates(state: FineTuneState, grads_g, grads_vl, grads_d,
                            cfg: TrainConfig = TrainConfig()) -> None:
    """The tokens' optimizer (constant lr), the decoder's and, unless its
    gradients are None, the discriminator's (each at the cosine schedule's
    value at its own update count)."""
    schedule = cosine_annealing(cfg.learning_rate, cfg.cosine_t_max)
    if grads_vl is not None:
        apply_grads(state.opt_vl, list(state.vl.parameters()), grads_vl)
    set_lr(state.opt_g, schedule(update_count(state.opt_g)))
    apply_grads(state.opt_g, list(state.dec.parameters()), grads_g)
    if grads_d is not None:
        set_lr(state.opt_d, schedule(update_count(state.opt_d)))
        apply_grads(state.opt_d, list(state.disc.parameters()), grads_d)
    state.step += 1


def fine_tune_step(state: FineTuneState, ce: ContentEncoder, pe: F0Estimator, wave: torch.Tensor,
                   amp: torch.Tensor, use_library: bool = True, freeze_discriminator: bool = False,
                   cfg: TrainConfig = TrainConfig(),
                   group: Optional[dist.ProcessGroup] = None) -> Metrics:
    """One fine-tuning step in place (up to three optimizers step); returns
    the metrics."""
    grads_g, grads_vl, grads_d, metrics = fine_tune_grads(
        state, ce, pe, wave, amp, use_library, freeze_discriminator, cfg, group)
    apply_fine_tune_updates(state, grads_g, grads_vl, grads_d, cfg)
    return metrics
