"""GAN decoder training (``alivevc_tpu/train/gan.py``; reference:
train_decoder.py:117-176).  Per step:

  * amplitude augmentation x U(0, 2) per item;
  * the frozen content encoder and F0 estimator give content and F0 (no
    gradient; the spectrogram is the STFT kernel on the card);
  * ``wave_recon``: the decoder on the self-matched content
    (``match_features(content, content)``) and the true F0; ``wave_fake``:
    the decoder on the content matched against the batch rolled by one
    (pseudo-cross-speaker) with F0 jittered x U(0.5, 1.5);
  * G loss = 45 mel(recon, wave) + 2 feature matching + 1 content
    preservation (the content encoder on the spectrogram of
    ``wave_recon``: gradient flows through the encoder and the STFT
    kernel's ``Function``, not into the encoder's weights) + sum of logit^2
    over D(centre(fake)) and D(centre(recon));
  * the D loss on the detached fake against the real wave (inverted LSGAN
    labels).  Both losses come from the parameters before the update, then
    both optimizers step (AdamW(0.8, 0.99) + cosine annealing).

The random draws are explicit: the step takes ``amp`` [N, 1] and
``jitter`` [1, 1, 1] as tensors (``gan_draws`` makes them from a
``torch.Generator``), where JAX draws them from a key inside the step.
G's gradients come from ``torch.autograd.grad`` over the decoder's
parameters, so nothing accumulates in the discriminator's ``.grad``.
On the card the decoder runs the oscillator and filter kernels through
their ``torch.autograd.Function``s.

With a process group (``group``) each rank takes its own slice of the
batch, the roll crosses the ranks, and G's gradients, D's and the metrics
are each averaged over the ranks by one all-reduce (``train/dp.py``); with
``group=None`` the step is this process's alone and runs no collective.
Like JAX's ``pmean``, the ranks average per-rank losses, so the step
equals the dense step on the whole batch in every term that is a batch
mean; the feature loss's MRD part is a sum over items (the reference's
quirk, ``models/discriminator.py``), and there the ranks see the mean over
ranks of per-rank sums.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from alivevc_tpu_torch.config import TrainConfig
from alivevc_tpu_torch.models.content_encoder import ContentEncoder, content_encoder
from alivevc_tpu_torch.models.decoder import Decoder, decoder
from alivevc_tpu_torch.models.discriminator import (
    Discriminator,
    discriminator_feat_loss,
    discriminator_logits,
)
from alivevc_tpu_torch.models.f0_estimator import F0Estimator, f0_estimate
from alivevc_tpu_torch.ops.knn import match_features
from alivevc_tpu_torch.ops.stft import spectrogram
from alivevc_tpu_torch.train import dp
from alivevc_tpu_torch.train.losses import (
    cut_center,
    discriminator_adv_loss,
    generator_adv_loss,
    mel_l1_loss,
)
from alivevc_tpu_torch.train.optim import adamw_gan, apply_grads, cosine_annealing, set_lr

Metrics = Dict[str, torch.Tensor]


@dataclasses.dataclass
class GanState:
    dec: Decoder
    disc: Discriminator
    opt_g: torch.optim.Optimizer
    opt_d: torch.optim.Optimizer
    step: int = 0


def init_gan(dec: Decoder, disc: Discriminator, cfg: TrainConfig = TrainConfig()) -> GanState:
    """The state of a GAN run over ``dec`` and ``disc`` (trained in place)."""
    for m in (dec, disc):
        m.train().requires_grad_(True)
    return GanState(dec, disc,
                    adamw_gan(dec.parameters(), cfg.learning_rate, cfg.adam_b1, cfg.adam_b2),
                    adamw_gan(disc.parameters(), cfg.learning_rate, cfg.adam_b1, cfg.adam_b2))


def gan_draws(n: int, generator: torch.Generator, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(amp [n, 1] ~ U(0, 2), jitter [1, 1, 1] ~ U(0.5, 1.5)) from a CPU
    generator, moved to ``device``."""
    amp = torch.rand((n, 1), generator=generator) * 2.0
    jitter = 0.5 + torch.rand((1, 1, 1), generator=generator)
    return amp.to(device), jitter.to(device)


def update_count(opt: torch.optim.Optimizer) -> int:
    """Updates ``opt`` has applied (optax's schedule count)."""
    for group in opt.param_groups:
        for p in group["params"]:
            state = opt.state.get(p)
            if state:
                return int(state["step"])
    return 0


def frozen_features(ce: ContentEncoder, pe: F0Estimator, wave: torch.Tensor):
    """(content [N, T, D], f0 [N, T, 1]) of the augmented batch, without
    gradient."""
    with torch.no_grad():
        spec = spectrogram(wave)
        return content_encoder(ce, spec), f0_estimate(pe, spec)


def generator_losses(disc: Discriminator, ce: ContentEncoder, wave: torch.Tensor,
                     wave_recon: torch.Tensor, content: torch.Tensor,
                     logits: List[torch.Tensor], cfg: TrainConfig) -> Metrics:
    """The G loss's terms (shared with fine-tuning) and their weighted sum."""
    loss_mel = mel_l1_loss(wave_recon, wave)
    loss_feat = discriminator_feat_loss(disc, cut_center(wave_recon), cut_center(wave))
    loss_con = (content - content_encoder(ce, spectrogram(wave_recon))).abs().mean()
    loss_adv = generator_adv_loss(logits)
    loss_g = (loss_mel * cfg.mel_weight + loss_feat * cfg.feat_weight
              + loss_con * cfg.content_weight + loss_adv)
    return {"loss_g": loss_g, "mel": loss_mel, "feat": loss_feat, "con": loss_con, "adv": loss_adv}


def discriminator_loss(disc: Discriminator, wave: torch.Tensor, fake: torch.Tensor) -> torch.Tensor:
    return discriminator_adv_loss(discriminator_logits(disc, cut_center(wave)),
                                  discriminator_logits(disc, cut_center(fake)))


def gan_grads(state: GanState, ce: ContentEncoder, pe: F0Estimator, wave: torch.Tensor,
              amp: torch.Tensor, jitter: torch.Tensor, cfg: TrainConfig = TrainConfig(),
              roll: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
              group: Optional[dist.ProcessGroup] = None):
    """(G's gradients, D's gradients, metrics) of one batch, from the
    parameters as they stand; no update.  ``wave`` [N, L] and ``amp``
    [N, 1] are this rank's slice under ``group`` (``jitter`` the same on
    every rank), whose mean gradients and metrics come back.  ``roll``
    replaces the batch roll of the pseudo-cross-speaker match (by default
    ``dp.global_roll`` over ``group``)."""
    if roll is None:
        roll = lambda x: dp.global_roll(x, group)  # noqa: E731
    dec, disc = state.dec, state.disc
    wave = wave * amp
    content, f0 = frozen_features(ce, pe, wave)
    with torch.no_grad():
        matched_self = match_features(content, content)
        matched_roll = match_features(content, roll(content))
    wave_recon, _ = decoder(dec, matched_self, f0)
    wave_fake, _ = decoder(dec, matched_roll, f0 * jitter)
    logits = (discriminator_logits(disc, cut_center(wave_fake))
              + discriminator_logits(disc, cut_center(wave_recon)))
    metrics = generator_losses(disc, ce, wave, wave_recon, content, logits, cfg)
    params_g = list(dec.parameters())
    grads_g = torch.autograd.grad(metrics["loss_g"], params_g)
    loss_d = discriminator_loss(disc, wave, wave_fake.detach())
    grads_d = torch.autograd.grad(loss_d, list(disc.parameters()))
    metrics = {k: v.detach() for k, v in metrics.items()}
    metrics["loss_d"] = loss_d.detach()
    return (dp.all_reduce_flat(grads_g, True, group), dp.all_reduce_flat(grads_d, True, group),
            dp.all_reduce_metrics(metrics, group))


def apply_updates(state: GanState, grads_g, grads_d, cfg: TrainConfig = TrainConfig()) -> None:
    """Both optimizers step, each at the schedule's value at its own update
    count; the step count advances."""
    schedule = cosine_annealing(cfg.learning_rate, cfg.cosine_t_max)
    for opt, m, grads in ((state.opt_g, state.dec, grads_g), (state.opt_d, state.disc, grads_d)):
        set_lr(opt, schedule(update_count(opt)))
        apply_grads(opt, list(m.parameters()), grads)
    state.step += 1


def gan_train_step(state: GanState, ce: ContentEncoder, pe: F0Estimator, wave: torch.Tensor,
                   amp: torch.Tensor, jitter: torch.Tensor, cfg: TrainConfig = TrainConfig(),
                   group: Optional[dist.ProcessGroup] = None) -> Metrics:
    """One GAN step in place; returns the metrics (pre-update losses).
    Under ``group`` every rank applies the same averaged gradients, so the
    replicas stay equal."""
    grads_g, grads_d, metrics = gan_grads(state, ce, pe, wave, amp, jitter, cfg, group=group)
    apply_updates(state, grads_g, grads_d, cfg)
    return metrics
