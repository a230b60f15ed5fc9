"""F0-estimator training CLI (reference: train_f0_estimator.py;
``alivevc_tpu/cli/train_f0_estimator.py``).

    python -m alivevc_tpu_torch.cli.train_f0_estimator dataset/ -b 8

The flags are the JAX package's.  Chunks get WORLD labels at load time (the
native labeler on the host).  ``-mp`` (default ``f0_estimator.ckpt``, the
name the other CLIs' ``-f0ep`` reads) is a training state, the JAX
package's ``.ckpt`` (its ``F0TrainState`` with the RAdam moments,
``compat/jax_train_state.py``) or a ``.pt`` (``train/state.py``): the run resumes
from it where it exists (else a seed-0 estimator at the default widths)
and writes it back in its format, and the inference CLIs read the
estimator out of either (``-f0ep``).  ``--device`` and ``--dp`` as in
``cli/train_decoder.py``; the data-parallel step equals the dense step on
the whole batch.
"""

from __future__ import annotations

import argparse

import torch

from alivevc_tpu_torch.cli.common import (
    host_shard,
    init_dp,
    model_line,
    require_format,
    resume_or_start,
    train_epochs,
    write_state,
)
from alivevc_tpu_torch.io.dataset import WaveChunkDataset
from alivevc_tpu_torch.models.f0_estimator import F0Estimator
from alivevc_tpu_torch.train.dp import my_rows
from alivevc_tpu_torch.train.f0 import f0_amp_draws, f0_train_step, init_f0_train


def build_parser():
    p = argparse.ArgumentParser(description="train f0 estimator")
    p.add_argument("dataset")
    p.add_argument("-mp", "--model-path", default="f0_estimator.ckpt")
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


def loss_line(epoch: int, step: int, m) -> str:
    """The F0 and distillation CLIs' line after each step."""
    return f"epoch {epoch} step {step} loss {float(m['loss']):.4f}"


def main(argv=None):
    args = build_parser().parse_args(argv)
    require_format(args.model_path)
    dev, group = init_dp(args.dp, args.device, args.batch_size)
    ds = WaveChunkDataset([args.dataset], length=args.length, max_files=args.max_data,
                          with_f0=True, host_shard=host_shard(group))
    print(f"Loaded {len(ds)} chunks (WORLD F0 labels precomputed)")

    def start():
        model_line("f0_estimator", args.model_path)
        return init_f0_train(F0Estimator(generator=torch.Generator().manual_seed(0)).to(dev),
                             args.learning_rate)

    state = resume_or_start(args.model_path, "f0", dev, start, learning_rate=args.learning_rate)
    gen = torch.Generator().manual_seed(1)

    def step(sel):
        wave = torch.from_numpy(ds.chunks[sel]).to(dev)
        f0 = torch.from_numpy(ds.f0[sel]).to(dev)
        amp = f0_amp_draws(args.batch_size, gen, dev)
        return f0_train_step(state, wave, f0, my_rows(amp, group), group)

    train_epochs(state, len(ds), args, dev, group, step, loss_line,
                 lambda: write_state(args.model_path, state))
    return state


if __name__ == "__main__":
    main()
