"""GAN decoder training CLI (reference: train_decoder.py;
``alivevc_tpu/cli/train_decoder.py``).

    python -m alivevc_tpu_torch.cli.train_decoder dataset/ -cep content_encoder.pt \\
        -f0ep f0_estimator.pt -sp gan_state.pt -b 8
    torchrun --nproc-per-node 4 -m alivevc_tpu_torch.cli.train_decoder dataset/ --dp -b 32

The flags are the JAX package's.  The frozen content encoder and F0
estimator load from ``.pt`` / ``.npz`` / ``.ckpt`` files (seed-0 models
where the files do not exist).  The decoder and the discriminator resume
from the training state ``-sp`` where it exists, else start from seed 1 at
the default widths: a ``.pt`` of ``train/state.py`` (which also carries
the optimizers, the step and the models' configurations) or the JAX
package's ``gan_state.ckpt`` (its ``GanState`` with the optax moments,
``compat/jax_train_state.py``), written back in the format it came in.
``--device`` defaults to cuda.  ``--dp`` runs ``dp_gan_train_step`` over
torch.distributed ranks (rank and world from torchrun's environment): each
rank loads every world-th file, takes batch / world items a step, every
rank runs the minimum over the ranks of their step counts, every rank reads
the state and rank 0 writes it.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from alivevc_tpu_torch.cli.common import (
    init_dp,
    load_params_or_init,
    read_state,
    require_format,
    steps_per_epoch,
    write_state,
)
from alivevc_tpu_torch.config import TrainConfig
from alivevc_tpu_torch.io.dataset import WaveChunkDataset
from alivevc_tpu_torch.models.decoder import Decoder
from alivevc_tpu_torch.models.discriminator import Discriminator
from alivevc_tpu_torch.train.gan import dp_gan_train_step, gan_draws, gan_train_step, init_gan


def build_parser():
    p = argparse.ArgumentParser(description="train decoder (GAN)")
    p.add_argument("dataset")
    p.add_argument("-sp", "--state-path", default="gan_state.pt")
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


def main(argv=None):
    args = build_parser().parse_args(argv)
    require_format(args.state_path)
    dev, rank, world = init_dp(args.dp, args.device)
    if args.batch_size % world:
        raise SystemExit(f"--dp needs a batch size divisible by the {world} ranks")
    ce = load_params_or_init(args.content_encoder_path, "content_encoder", dev)
    pe = load_params_or_init(args.f0_estimator_path, "f0_estimator", dev)
    cfg = train_config(args)
    if os.path.exists(args.state_path):
        state = read_state(args.state_path, "gan", dev, cfg=cfg)
        print(f"resumed at step {state.step}")
    else:
        gen = torch.Generator().manual_seed(1)
        state = init_gan(Decoder(generator=gen).to(dev), Discriminator(generator=gen).to(dev), cfg)

    def save():
        if rank == 0:
            write_state(args.state_path, state)

    ds = WaveChunkDataset([args.dataset], length=args.length, max_files=args.max_data,
                          host_shard=(rank, world) if world > 1 else None)
    print(f"Loaded {len(ds)} chunks")
    local = args.batch_size // world
    n_steps = steps_per_epoch(len(ds), local, world, dev)
    if n_steps == 0:
        raise SystemExit("no full batch of audio chunks: check the dataset path, length and batch")
    rng_np = np.random.default_rng(0)
    gen = torch.Generator().manual_seed(2)
    for _ in range(args.epoch):
        order = rng_np.permutation(len(ds))
        for s in range(n_steps):
            wave = torch.from_numpy(ds.chunks[order[s * local:(s + 1) * local]]).to(dev)
            amp, jitter = gan_draws(args.batch_size, gen, dev)
            if world > 1:
                m = dp_gan_train_step(state, ce, pe, wave, amp[rank * local:(rank + 1) * local],
                                      jitter, cfg)
            else:
                m = gan_train_step(state, ce, pe, wave, amp, jitter, cfg)
            if rank == 0:
                print(f"Step {state.step}, D: {float(m['loss_d']):.4f}, Adv.: {float(m['adv']):.4f}, "
                      f"Mel.: {float(m['mel']):.4f}, Feat.: {float(m['feat']):.4f}, "
                      f"Con.: {float(m['con']):.4f}")
            if state.step % args.save_every == 0:
                save()
    save()
    if world > 1:
        torch.distributed.destroy_process_group()
    print("Training Complete!")
    return state


if __name__ == "__main__":
    main()
