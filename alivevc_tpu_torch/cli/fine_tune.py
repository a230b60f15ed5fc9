"""Fine-tuning CLI (reference: fine_tune.py; ``alivevc_tpu/cli/fine_tune.py``):
the decoder's GAN on target-speaker data, optionally co-training the voice
library with a third optimizer.

    python -m alivevc_tpu_torch.cli.fine_tune target_voice/ -dep gan_state.ckpt \\
        -disp gan_state.ckpt --max-step 2000

The flags and their defaults are the JAX package's.  Every model loads from
its path (``.pt``, a training state ``.pt``, or the JAX ``.npz`` /
``.ckpt``; seed-0 models where a file does not exist); ``-lib NONE``
fine-tunes without the library (content self-matched).  ``train_decoder``
writes no ``decoder.ckpt`` or ``discriminator.ckpt`` (in the JAX package
either), so the chain passes its state, ``-dep gan_state.ckpt -disp
gan_state.ckpt``, and each model is read out of it.  The training state
``-sp`` (a ``.pt`` of ``train/state.py`` or the JAX package's
``FineTuneState`` ``.ckpt``, ``compat/jax_train_state.py``) resumes the run
where it exists: its models, optimizers and step take the place of the
model files', and it must hold a library exactly when ``-lib`` names one.
Every ``--save-every`` steps and at the end, the state, the decoder and the
library (``-lib``) are written, each in the format its extension names
(``.pt``: the reference's key layout; ``.ckpt``: the JAX package's).  The
decoder goes to ``-dep``, unless that file is a training state: a
parameter tree written over it would end that run, so the decoder goes
beside it as ``decoder.ckpt`` (or ``.pt``), the name the inference CLIs
read by default.  ``--device`` and ``--dp`` as in ``cli/train_decoder.py``.
"""

from __future__ import annotations

import argparse
import os

import torch

from alivevc_tpu_torch.cli.common import (
    host_shard,
    init_dp,
    load_params_or_init,
    require_format,
    resume_or_start,
    save_model,
    train_epochs,
    write_state,
)
from alivevc_tpu_torch.cli.train_decoder import gan_line, train_config
from alivevc_tpu_torch.compat.torch_import import holds_train_state
from alivevc_tpu_torch.io.dataset import WaveChunkDataset
from alivevc_tpu_torch.train.dp import my_rows
from alivevc_tpu_torch.train.fine_tune import amp_draws, fine_tune_step, init_fine_tune


def build_parser():
    p = argparse.ArgumentParser(description="fine-tune decoder (+voice library)")
    p.add_argument("dataset")
    p.add_argument("-dep", "--decoder-path", default="decoder.ckpt")
    p.add_argument("-disp", "--discriminator-path", default="discriminator.ckpt")
    p.add_argument("-cep", "--content-encoder-path", default="content_encoder.ckpt")
    p.add_argument("-f0ep", "--f0-estimator-path", default="f0_estimator.ckpt")
    p.add_argument("-lib", "--voice-library-path", default="voice_library.ckpt")
    p.add_argument("-sp", "--state-path", default="fine_tune_state.ckpt")
    p.add_argument("-e", "--epoch", default=1000, type=int)
    p.add_argument("-b", "--batch-size", default=1, type=int)
    p.add_argument("-lr", "--learning-rate", default=1e-4, type=float)
    p.add_argument("-len", "--length", default=38400, type=int)
    p.add_argument("-m", "--max-data", default=-1, type=int)
    p.add_argument("--feature-matching", default=2.0, type=float)
    p.add_argument("--mel", default=45.0, type=float)
    p.add_argument("--content", default=1.0, type=float)
    p.add_argument("--max-step", default=-1, type=int)
    p.add_argument("-fd", "--freeze-discriminator", action="store_true")
    p.add_argument("--save-every", default=100, type=int)
    p.add_argument("--dp", action="store_true",
                   help="data-parallel over torch.distributed ranks (run under torchrun)")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return p


def decoder_output(path: str) -> str:
    """Where the fine-tuned decoder is written: ``path`` (``-dep``), or, where
    the file there is a training state, ``decoder<ext>`` beside it."""
    if not (os.path.exists(path) and holds_train_state(path)):
        return path
    out = os.path.join(os.path.dirname(path), "decoder" + os.path.splitext(path)[1])
    if os.path.abspath(out) == os.path.abspath(path):
        raise SystemExit(f"-dep {path} is a training state; the fine-tuned decoder would be "
                         "written over it")
    print(f"decoder: {path} is a training state; the fine-tuned decoder goes to {out}")
    return out


def main(argv=None):
    args = build_parser().parse_args(argv)
    use_library = args.voice_library_path != "NONE"
    require_format(args.state_path, args.decoder_path, args.voice_library_path)
    dec_out = decoder_output(args.decoder_path)
    dev, group = init_dp(args.dp, args.device, args.batch_size)
    ce = load_params_or_init(args.content_encoder_path, "content_encoder", dev)
    pe = load_params_or_init(args.f0_estimator_path, "f0_estimator", dev)
    cfg = train_config(args)

    def start():
        dec = load_params_or_init(args.decoder_path, "decoder", dev)
        disc = load_params_or_init(args.discriminator_path, "discriminator", dev)
        vl = load_params_or_init(args.voice_library_path, "voice_library", dev) if use_library else None
        return init_fine_tune(dec, disc, vl, cfg)

    state = resume_or_start(args.state_path, "fine_tune", dev, start, cfg=cfg)
    if (state.vl is not None) != use_library:
        raise SystemExit(f"{args.state_path} holds {'a' if state.vl is not None else 'no'} voice "
                         f"library, but -lib is {args.voice_library_path}")

    def save_all():
        write_state(args.state_path, state)
        save_model(dec_out, state.dec, "decoder")
        if use_library:
            save_model(args.voice_library_path, state.vl, "voice_library")

    ds = WaveChunkDataset([args.dataset], length=args.length, max_files=args.max_data,
                          host_shard=host_shard(group))
    print(f"Loaded {len(ds)} chunks")
    gen = torch.Generator().manual_seed(2)

    def step(sel):
        wave = torch.from_numpy(ds.chunks[sel]).to(dev)
        amp = amp_draws(args.batch_size, gen, dev)
        return fine_tune_step(state, ce, pe, wave, my_rows(amp, group), use_library,
                              args.freeze_discriminator, cfg, group)

    train_epochs(state, len(ds), args, dev, group, step, gan_line, save_all, args.max_step)
    return state


if __name__ == "__main__":
    main()
