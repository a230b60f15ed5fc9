"""GAN decoder training CLI (reference: train_decoder.py;
``alivevc_tpu/cli/train_decoder.py``).

    python -m alivevc_tpu_torch.cli.train_decoder dataset/ -b 8
    torchrun --nproc-per-node 4 -m alivevc_tpu_torch.cli.train_decoder dataset/ --dp -b 32

The flags and their defaults are the JAX package's.  The frozen content
encoder and F0 estimator load from ``.pt`` / ``.npz`` / ``.ckpt`` files
(seed-0 models where the files do not exist; the defaults are what
``train_content_encoder`` and ``train_f0_estimator`` write by default).
The decoder and the discriminator resume from the training state ``-sp``
(default ``gan_state.ckpt``) where it exists, else start from seed 1 at
the default widths: the JAX package's ``.ckpt`` (its ``GanState`` with the
optax moments, ``compat/jax_train_state.py``) or a ``.pt`` of
``train/state.py`` (which also carries the optimizers, the step and the
models' configurations), written back in the format it came in.  As in the
JAX package, no decoder file of its own is written: ``fine_tune -dep
gan_state.ckpt`` and the inference CLIs read the decoder out of the state.
``--device`` defaults to cuda.  ``--dp`` runs ``gan_train_step`` over the
torch.distributed ranks (rank and world from torchrun's environment): each
rank loads every world-th file, takes batch / world items a step, every
rank runs the minimum over the ranks of their step counts
(``cli/common.py:train_epochs``), every rank reads the state and rank 0
writes it.
"""

from __future__ import annotations

import argparse

import torch

from alivevc_tpu_torch.cli.common import (
    host_shard,
    init_dp,
    load_params_or_init,
    model_line,
    require_format,
    resume_or_start,
    train_epochs,
    write_state,
)
from alivevc_tpu_torch.config import TrainConfig
from alivevc_tpu_torch.io.dataset import WaveChunkDataset
from alivevc_tpu_torch.models.decoder import Decoder
from alivevc_tpu_torch.models.discriminator import Discriminator
from alivevc_tpu_torch.train.dp import my_rows
from alivevc_tpu_torch.train.gan import gan_draws, gan_train_step, init_gan


def build_parser():
    p = argparse.ArgumentParser(description="train decoder (GAN)")
    p.add_argument("dataset")
    p.add_argument("-sp", "--state-path", default="gan_state.ckpt")
    p.add_argument("-cep", "--content-encoder-path", default="content_encoder.ckpt")
    p.add_argument("-f0ep", "--f0-estimator-path", default="f0_estimator.ckpt")
    p.add_argument("-e", "--epoch", default=1000, type=int)
    p.add_argument("-b", "--batch-size", default=1, type=int)
    p.add_argument("-lr", "--learning-rate", default=1e-4, type=float)
    p.add_argument("-len", "--length", default=38400, type=int)
    p.add_argument("-m", "--max-data", default=-1, type=int)
    p.add_argument("--feature-matching", default=2.0, type=float)
    p.add_argument("--mel", default=45.0, type=float)
    p.add_argument("--content", default=1.0, type=float)
    p.add_argument("--save-every", default=300, type=int)
    p.add_argument("--dp", action="store_true",
                   help="data-parallel over torch.distributed ranks (run under torchrun); "
                        "the batch size must be a multiple of the world size")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return p


def train_config(args) -> TrainConfig:
    return TrainConfig(learning_rate=args.learning_rate, mel_weight=args.mel,
                       feat_weight=args.feature_matching, content_weight=args.content)


def gan_line(epoch: int, step: int, m) -> str:
    """The GAN CLIs' line after each step."""
    return (f"Step {step}, D: {float(m['loss_d']):.4f}, Adv.: {float(m['adv']):.4f}, "
            f"Mel.: {float(m['mel']):.4f}, Feat.: {float(m['feat']):.4f}, "
            f"Con.: {float(m['con']):.4f}")


def main(argv=None):
    args = build_parser().parse_args(argv)
    require_format(args.state_path)
    dev, group = init_dp(args.dp, args.device, args.batch_size)
    ce = load_params_or_init(args.content_encoder_path, "content_encoder", dev)
    pe = load_params_or_init(args.f0_estimator_path, "f0_estimator", dev)
    cfg = train_config(args)

    def start():
        for kind in ("decoder", "discriminator"):
            model_line(kind, args.state_path, seed=1)
        gen = torch.Generator().manual_seed(1)
        return init_gan(Decoder(generator=gen).to(dev), Discriminator(generator=gen).to(dev), cfg)

    state = resume_or_start(args.state_path, "gan", dev, start, cfg=cfg)
    ds = WaveChunkDataset([args.dataset], length=args.length, max_files=args.max_data,
                          host_shard=host_shard(group))
    print(f"Loaded {len(ds)} chunks")
    gen = torch.Generator().manual_seed(2)

    def step(sel):
        wave = torch.from_numpy(ds.chunks[sel]).to(dev)
        amp, jitter = gan_draws(args.batch_size, gen, dev)
        return gan_train_step(state, ce, pe, wave, my_rows(amp, group), jitter, cfg, group)

    train_epochs(state, len(ds), args, dev, group, step, gan_line,
                 lambda: write_state(args.state_path, state))
    return state


if __name__ == "__main__":
    main()
