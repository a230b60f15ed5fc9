"""Optimizers and the learning-rate schedule, held to the JAX package's
optax semantics (``alivevc_tpu/train/optim.py``, ``train/fine_tune.py:54``),
not to ``torch.optim``'s defaults:

  * ``adamw_gan``: AdamW(b1 0.8, b2 0.99, eps 1e-8, weight decay 0.01) for
    the decoder and the discriminator (train_decoder.py:100-104), with the
    learning rate of ``cosine_annealing`` at the 0-based update count set
    before each update (``set_lr``).  ``torch.optim.AdamW`` decays the
    weights by lr * wd * p and adds lr * m_hat / (sqrt(v_hat) + eps), which
    is optax's ``adamw`` update;
  * ``library_adamw``: the voice library's ``optax.adamw(lr)``: b1 0.9, b2
    0.999, eps 1e-8 and optax's default weight decay 1e-4 (torch's default
    is 0.01), constant lr;
  * ``RAdam``: ``optax.radam`` (the F0 trainer, train_content_encoder.py:56),
    written from optax's formulas.  It differs from ``torch.optim.RAdam``:
    optax divides by sqrt(v_hat) + eps (torch by sqrt(v) + eps after
    folding the bias correction into the factor) and takes the rectified
    step at rho >= 5 (torch at rho > 5).  Its step scalars are float32, as
    optax forms them.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Sequence

import torch


def cosine_annealing(base_lr: float, t_max: int, eta_min: float = 0.0) -> Callable[[int], float]:
    """torch's CosineAnnealingLR in closed form (periodic):
    lr(t) = eta_min + (base_lr - eta_min) * (1 + cos(pi t / t_max)) / 2."""

    def schedule(step: int) -> float:
        return eta_min + (base_lr - eta_min) * (1.0 + math.cos(math.pi * step / t_max)) / 2.0

    return schedule


def adamw_gan(params: Iterable[torch.Tensor], learning_rate: float = 1e-4, b1: float = 0.8,
              b2: float = 0.99, weight_decay: float = 0.01) -> torch.optim.AdamW:
    return torch.optim.AdamW(params, lr=learning_rate, betas=(b1, b2), eps=1e-8,
                             weight_decay=weight_decay)


def library_adamw(params: Iterable[torch.Tensor], learning_rate: float = 1e-4) -> torch.optim.AdamW:
    return torch.optim.AdamW(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)


# optax.radam's constants (its only setting in use is the learning rate)
RADAM_B1, RADAM_B2, RADAM_EPS, RADAM_THRESHOLD = 0.9, 0.999, 1e-8, 5.0


class RAdam(torch.optim.Optimizer):
    """``optax.radam(lr)``: m, v as Adam; t = update count,
    rho = rho_inf - 2 t b2^t / (1 - b2^t), rho_inf = 2 / (1 - b2) - 1;
    update = -lr * r * m_hat / (sqrt(v_hat) + eps) where rho >= 5,
    r = sqrt((rho - 4)(rho - 2) rho_inf / ((rho_inf - 4)(rho_inf - 2) rho)),
    else -lr * m_hat."""

    def __init__(self, params, lr: float = 1e-4):
        super().__init__(params, dict(lr=lr))

    @torch.no_grad()
    def step(self, closure=None):
        b1, b2 = RADAM_B1, RADAM_B2
        f32 = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
        ro_inf = 2.0 / (1.0 - b2) - 1.0
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    state["exp_avg"] = torch.zeros_like(p)
                    state["exp_avg_sq"] = torch.zeros_like(p)
                state["step"] += 1
                t = state["step"]
                m, v, g = state["exp_avg"], state["exp_avg_sq"], p.grad
                m.mul_(b1).add_(g, alpha=1.0 - b1)
                v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
                # optax's scalars, in float32 and in its order
                b2t = f32(b2) ** t
                ro = f32(ro_inf) - (2 * t) * b2t / (1.0 - b2t)
                m_hat = m / float(1.0 - f32(b1) ** t)
                if float(ro) >= RADAM_THRESHOLD:
                    r = torch.sqrt((ro - 4.0) * (ro - 2.0) * ro_inf
                                   / ((ro_inf - 4.0) * (ro_inf - 2.0) * ro))
                    v_hat = v / float(1.0 - b2t)
                    p.add_(float(r) * m_hat / (v_hat.sqrt() + RADAM_EPS), alpha=-group["lr"])
                else:
                    p.add_(m_hat, alpha=-group["lr"])


def set_lr(opt: torch.optim.Optimizer, lr: float) -> None:
    for group in opt.param_groups:
        group["lr"] = lr


def apply_grads(opt: torch.optim.Optimizer, params: Sequence[torch.Tensor],
                grads: Sequence[torch.Tensor]) -> None:
    """One update of ``params`` by ``opt`` from ``grads`` (given, as
    ``torch.autograd.grad`` returns them, not accumulated in ``.grad``)."""
    for p, g in zip(params, grads):
        p.grad = g
    opt.step()
    for p in params:
        p.grad = None
