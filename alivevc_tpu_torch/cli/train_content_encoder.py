"""Content-encoder distillation CLI (reference: train_content_encoder.py;
``alivevc_tpu/cli/train_content_encoder.py``).

    python -m alivevc_tpu_torch.cli.train_content_encoder dataset/ \\
        --wavlm-checkpoint wavlm-base-plus.pt
    python -m alivevc_tpu_torch.cli.train_content_encoder dataset/ --teacher-features feats.npz

The flags are the JAX package's, plus ``--device`` and ``--dp`` as in
``cli/train_f0_estimator.py``.  The teacher's features come from
``--teacher-features`` (an ``.npz`` of ``io/teacher.py:
precompute_teacher_features``, key 'features', [M, length // 320, 768],
aligned with this process's chunks), or from ``--wavlm-checkpoint`` (a
Hugging Face ``WavLMModel`` state dict), whose WavLM runs on ``--device``
over the chunks before training.  The JAX CLI's default, a hub download, is
not offered: with neither flag the run stops.  ``-mp`` (default
``content_encoder.ckpt``, the name the other CLIs' ``-cep`` reads) is a
training state holding the encoder, the JAX package's ``.ckpt`` (its
``DistillState``, ``compat/jax_train_state.py``) or a ``.pt``
(``train/state.py``):
the run resumes from it where it exists (else a seed-0 encoder at the
default widths) and writes it back in its format, and the inference CLIs
read the encoder out of either (``-cep``).  Under ``--dp``
each rank loads every world-th file and computes or reads its own
features, takes batch / world chunks a step, and every rank runs the
minimum over the ranks of their step counts.
"""

from __future__ import annotations

import argparse

import numpy as np
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
from alivevc_tpu_torch.cli.train_f0_estimator import loss_line
from alivevc_tpu_torch.io.dataset import WaveChunkDataset
from alivevc_tpu_torch.io.teacher import precompute_teacher_features
from alivevc_tpu_torch.models.content_encoder import ContentEncoder
from alivevc_tpu_torch.train.distill import distill_step, init_distill


def build_parser():
    p = argparse.ArgumentParser(description="train content encoder (distillation)")
    p.add_argument("dataset")
    p.add_argument("-mp", "--model-path", default="content_encoder.ckpt")
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
    dev, group = init_dp(args.dp, args.device, args.batch_size)
    ds = WaveChunkDataset([args.dataset], length=args.length, max_files=args.max_data,
                          host_shard=host_shard(group))
    print(f"Loaded {len(ds)} chunks")
    if args.teacher_features:
        feats = np.load(args.teacher_features)["features"]
    else:
        feats = precompute_teacher_features(ds.chunks, args.wavlm_checkpoint, device=dev)
    if feats.shape[:2] != (len(ds), args.length // 320):
        raise SystemExit(f"teacher features {feats.shape} do not align with the "
                         f"{len(ds)} chunks of {args.length // 320} frames")

    def start():
        model_line("content_encoder", args.model_path)
        return init_distill(ContentEncoder(generator=torch.Generator().manual_seed(0)).to(dev),
                            args.learning_rate)

    state = resume_or_start(args.model_path, "distill", dev, start,
                            learning_rate=args.learning_rate)

    def step(sel):
        wave = torch.from_numpy(ds.chunks[sel]).to(dev)
        teacher = torch.from_numpy(np.ascontiguousarray(feats[sel], np.float32)).to(dev)
        return distill_step(state, wave, teacher, group)

    train_epochs(state, len(ds), args, dev, group, step, loss_line,
                 lambda: write_state(args.model_path, state))
    return state


if __name__ == "__main__":
    main()
