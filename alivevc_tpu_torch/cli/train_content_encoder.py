"""Content-encoder distillation CLI (reference: train_content_encoder.py;
``alivevc_tpu/cli/train_content_encoder.py``).

    python -m alivevc_tpu_torch.cli.train_content_encoder dataset/ \\
        --wavlm-checkpoint wavlm-base-plus.pt -mp content_encoder.pt
    python -m alivevc_tpu_torch.cli.train_content_encoder dataset/ --teacher-features feats.npz

The flags are the JAX package's, plus ``--device`` and ``--dp`` as in
``cli/train_f0_estimator.py``.  The teacher's features come from
``--teacher-features`` (an ``.npz`` of ``io/teacher.py:
precompute_teacher_features``, key 'features', [M, length // 320, 768],
aligned with this process's chunks), or from ``--wavlm-checkpoint`` (a
Hugging Face ``WavLMModel`` state dict), whose WavLM runs on ``--device``
over the chunks before training.  The JAX CLI's default, a hub download, is
not offered: with neither flag the run stops.  ``-mp`` is a training
state holding the encoder, a ``.pt`` (``train/state.py``) or the JAX
package's ``.ckpt`` (its ``DistillState``, ``compat/jax_train_state.py``):
the run resumes from it where it exists (else a seed-0 encoder at the
default widths) and writes it back in its format, and the inference CLIs
read the encoder out of either (``-cep``).  Under ``--dp``
each rank loads every world-th file and computes or reads its own
features, takes batch / world chunks a step, and every rank runs the
minimum over the ranks of their step counts.
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
from alivevc_tpu_torch.io.teacher import precompute_teacher_features
from alivevc_tpu_torch.models.content_encoder import ContentEncoder
from alivevc_tpu_torch.train.distill import distill_step, dp_distill_step, init_distill


def build_parser():
    p = argparse.ArgumentParser(description="train content encoder (distillation)")
    p.add_argument("dataset")
    p.add_argument("-mp", "--model-path", default="content_encoder.pt")
    p.add_argument("-e", "--epoch", default=1000, type=int)
    p.add_argument("-b", "--batch-size", default=16, type=int)
    p.add_argument("-lr", "--learning-rate", default=1e-4, type=float)
    p.add_argument("-len", "--length", default=65536, type=int)
    p.add_argument("-m", "--max-data", default=-1, type=int)
    p.add_argument("--teacher-features", default=None,
                   help=".npz with precomputed WavLM features (key 'features')")
    p.add_argument("--wavlm-checkpoint", default=None,
                   help="WavLM state dict in Hugging Face keys (.pt/.bin): the port's WavLM "
                        "computes the features on --device")
    p.add_argument("--save-every", default=100, type=int)
    p.add_argument("--dp", action="store_true",
                   help="data-parallel over torch.distributed ranks (run under torchrun)")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    require_format(args.model_path)
    if not (args.teacher_features or args.wavlm_checkpoint):
        raise SystemExit("teacher features are needed: pass --teacher-features feats.npz or "
                         "--wavlm-checkpoint wavlm.pt (a local WavLM state dict; nothing is "
                         "downloaded)")
    dev, rank, world = init_dp(args.dp, args.device)
    if args.batch_size % world:
        raise SystemExit(f"--dp needs a batch size divisible by the {world} ranks")
    ds = WaveChunkDataset([args.dataset], length=args.length, max_files=args.max_data,
                          host_shard=(rank, world) if world > 1 else None)
    print(f"Loaded {len(ds)} chunks")
    if args.teacher_features:
        feats = np.load(args.teacher_features)["features"]
    else:
        feats = precompute_teacher_features(ds.chunks, args.wavlm_checkpoint, device=dev)
    if feats.shape[:2] != (len(ds), args.length // 320):
        raise SystemExit(f"teacher features {feats.shape} do not align with the "
                         f"{len(ds)} chunks of {args.length // 320} frames")

    if os.path.exists(args.model_path):
        state = read_state(args.model_path, "distill", dev, learning_rate=args.learning_rate)
        print(f"resumed at step {state.step}")
    else:
        state = init_distill(ContentEncoder(generator=torch.Generator().manual_seed(0)).to(dev),
                             args.learning_rate)

    def save():
        if rank == 0:
            write_state(args.model_path, state)

    local = args.batch_size // world
    n_steps = steps_per_epoch(len(ds), local, world, dev)
    if n_steps == 0:
        raise SystemExit("no full batch of audio chunks: check the dataset path, length and batch")
    rng = np.random.default_rng(0)
    for epoch in range(args.epoch):
        order = rng.permutation(len(ds))
        for s in range(n_steps):
            sel = order[s * local:(s + 1) * local]
            wave = torch.from_numpy(ds.chunks[sel]).to(dev)
            teacher = torch.from_numpy(np.ascontiguousarray(feats[sel], np.float32)).to(dev)
            step = dp_distill_step if world > 1 else distill_step
            m = step(state, wave, teacher)
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
