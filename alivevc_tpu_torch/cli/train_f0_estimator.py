"""F0-estimator training CLI (reference: train_f0_estimator.py;
``alivevc_tpu/cli/train_f0_estimator.py``).

    python -m alivevc_tpu_torch.cli.train_f0_estimator dataset/ -mp f0_estimator.pt -b 8

The flags are the JAX package's.  Chunks get WORLD labels at load time (the
native labeler on the host).  ``-mp`` is a training state, a ``.pt``
(``train/state.py``) or the JAX package's ``.ckpt`` (its ``F0TrainState``
with the RAdam moments, ``compat/jax_train_state.py``): the run resumes
from it where it exists (else a seed-0 estimator at the default widths)
and writes it back in its format, and the inference CLIs read the
estimator out of either (``-f0ep``).  ``--device`` and ``--dp`` as in
``cli/train_decoder.py``; the data-parallel step equals the dense step on
the whole batch.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from alivevc_tpu_torch.cli.common import (
    init_dp,
    read_state,
    require_format,
    steps_per_epoch,
    write_state,
)
from alivevc_tpu_torch.io.dataset import WaveChunkDataset
from alivevc_tpu_torch.models.f0_estimator import F0Estimator
from alivevc_tpu_torch.train.f0 import dp_f0_train_step, f0_amp_draws, f0_train_step, init_f0_train


def build_parser():
    p = argparse.ArgumentParser(description="train f0 estimator")
    p.add_argument("dataset")
    p.add_argument("-mp", "--model-path", default="f0_estimator.pt")
    p.add_argument("-e", "--epoch", default=100, type=int)
    p.add_argument("-b", "--batch-size", default=1, type=int)
    p.add_argument("-lr", "--learning-rate", default=1e-4, type=float)
    p.add_argument("-len", "--length", default=65536, type=int)
    p.add_argument("-m", "--max-data", default=-1, type=int)
    p.add_argument("--save-every", default=1000, type=int)
    p.add_argument("--dp", action="store_true",
                   help="data-parallel over torch.distributed ranks (run under torchrun)")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    require_format(args.model_path)
    dev, rank, world = init_dp(args.dp, args.device)
    if args.batch_size % world:
        raise SystemExit(f"--dp needs a batch size divisible by the {world} ranks")
    ds = WaveChunkDataset([args.dataset], length=args.length, max_files=args.max_data,
                          with_f0=True, host_shard=(rank, world) if world > 1 else None)
    print(f"Loaded {len(ds)} chunks (WORLD F0 labels precomputed)")
    if os.path.exists(args.model_path):
        state = read_state(args.model_path, "f0", dev, learning_rate=args.learning_rate)
        print(f"resumed at step {state.step}")
    else:
        state = init_f0_train(F0Estimator(generator=torch.Generator().manual_seed(0)).to(dev),
                              args.learning_rate)

    def save():
        if rank == 0:
            write_state(args.model_path, state)

    local = args.batch_size // world
    n_steps = steps_per_epoch(len(ds), local, world, dev)
    if n_steps == 0:
        raise SystemExit("no full batch of audio chunks: check the dataset path, length and batch")
    rng_np = np.random.default_rng(0)
    gen = torch.Generator().manual_seed(1)
    for epoch in range(args.epoch):
        order = rng_np.permutation(len(ds))
        for s in range(n_steps):
            sel = order[s * local:(s + 1) * local]
            wave = torch.from_numpy(ds.chunks[sel]).to(dev)
            f0 = torch.from_numpy(ds.f0[sel]).to(dev)
            amp = f0_amp_draws(args.batch_size, gen, dev)
            if world > 1:
                m = dp_f0_train_step(state, wave, f0, amp[rank * local:(rank + 1) * local])
            else:
                m = f0_train_step(state, wave, f0, amp)
            if rank == 0:
                print(f"epoch {epoch} step {state.step} loss {float(m['loss']):.4f}")
            if state.step % args.save_every == 0:
                save()
    save()
    if world > 1:
        torch.distributed.destroy_process_group()
    print("Training Complete!")
    return state


if __name__ == "__main__":
    main()
