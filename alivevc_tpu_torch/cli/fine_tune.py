"""Fine-tuning CLI (reference: fine_tune.py; ``alivevc_tpu/cli/fine_tune.py``):
the decoder's GAN on target-speaker data, optionally co-training the voice
library with a third optimizer.

    python -m alivevc_tpu_torch.cli.fine_tune target_voice/ -dep decoder.pt \\
        -disp discriminator.pt -lib voice_library.pt --max-step 2000

The flags are the JAX package's.  Every model loads from its path (``.pt``,
a training state ``.pt``, or the JAX ``.npz`` / ``.ckpt``; seed-0 models
where a file does not exist); ``-lib NONE`` fine-tunes without the library
(content self-matched).  The training state ``-sp`` (a ``.pt`` of
``train/state.py`` or the JAX package's ``FineTuneState`` ``.ckpt``,
``compat/jax_train_state.py``) resumes the run where it exists: its models,
optimizers and step take the place of the model files', and it must hold a
library exactly when ``-lib`` names one.  Every ``--save-every`` steps and
at the end, the state, the decoder (``-dep``) and the library (``-lib``)
are written, each in the format its extension names (``.pt``: the
reference's key layout; ``.ckpt``: the JAX package's).  ``--device`` and
``--dp`` as in ``cli/train_decoder.py``.
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
    save_model,
    steps_per_epoch,
    write_state,
)
from alivevc_tpu_torch.cli.train_decoder import train_config
from alivevc_tpu_torch.io.dataset import WaveChunkDataset
from alivevc_tpu_torch.train.fine_tune import (
    amp_draws,
    dp_fine_tune_step,
    fine_tune_step,
    init_fine_tune,
)


def build_parser():
    p = argparse.ArgumentParser(description="fine-tune decoder (+voice library)")
    p.add_argument("dataset")
    p.add_argument("-dep", "--decoder-path", default="decoder.pt")
    p.add_argument("-disp", "--discriminator-path", default="discriminator.pt")
    p.add_argument("-cep", "--content-encoder-path", default="content_encoder.ckpt")
    p.add_argument("-f0ep", "--f0-estimator-path", default="f0_estimator.ckpt")
    p.add_argument("-lib", "--voice-library-path", default="voice_library.pt")
    p.add_argument("-sp", "--state-path", default="fine_tune_state.pt")
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


def main(argv=None):
    args = build_parser().parse_args(argv)
    use_library = args.voice_library_path != "NONE"
    require_format(args.state_path, args.decoder_path, args.voice_library_path)
    dev, rank, world = init_dp(args.dp, args.device)
    if args.batch_size % world:
        raise SystemExit(f"--dp needs a batch size divisible by the {world} ranks")
    ce = load_params_or_init(args.content_encoder_path, "content_encoder", dev)
    pe = load_params_or_init(args.f0_estimator_path, "f0_estimator", dev)
    cfg = train_config(args)
    if os.path.exists(args.state_path):
        state = read_state(args.state_path, "fine_tune", dev, cfg=cfg)
        if (state.vl is not None) != use_library:
            raise SystemExit(f"{args.state_path} holds {'a' if state.vl is not None else 'no'} voice "
                             f"library, but -lib is {args.voice_library_path}")
        print(f"resumed at step {state.step}")
    else:
        dec = load_params_or_init(args.decoder_path, "decoder", dev)
        disc = load_params_or_init(args.discriminator_path, "discriminator", dev)
        vl = load_params_or_init(args.voice_library_path, "voice_library", dev) if use_library else None
        state = init_fine_tune(dec, disc, vl, cfg)

    def save_all():
        if rank == 0:
            write_state(args.state_path, state)
            save_model(args.decoder_path, state.dec, "decoder")
            if use_library:
                save_model(args.voice_library_path, state.vl, "voice_library")

    ds = WaveChunkDataset([args.dataset], length=args.length, max_files=args.max_data,
                          host_shard=(rank, world) if world > 1 else None)
    print(f"Loaded {len(ds)} chunks")
    local = args.batch_size // world
    n_steps = steps_per_epoch(len(ds), local, world, dev)
    if n_steps == 0:
        raise SystemExit("no full batch of audio chunks: check the dataset path, length and batch")
    rng_np = np.random.default_rng(0)
    gen = torch.Generator().manual_seed(2)
    done = False
    for _ in range(args.epoch):
        order = rng_np.permutation(len(ds))
        for s in range(n_steps):
            wave = torch.from_numpy(ds.chunks[order[s * local:(s + 1) * local]]).to(dev)
            amp = amp_draws(args.batch_size, gen, dev)
            kw = dict(use_library=use_library, freeze_discriminator=args.freeze_discriminator,
                      cfg=cfg)
            if world > 1:
                m = dp_fine_tune_step(state, ce, pe, wave, amp[rank * local:(rank + 1) * local], **kw)
            else:
                m = fine_tune_step(state, ce, pe, wave, amp, **kw)
            if rank == 0:
                print(f"Step {state.step}, D: {float(m['loss_d']):.4f}, Adv.: {float(m['adv']):.4f}, "
                      f"Mel.: {float(m['mel']):.4f}, Feat.: {float(m['feat']):.4f}, "
                      f"Con.: {float(m['con']):.4f}")
            if state.step % args.save_every == 0:
                save_all()
            if args.max_step != -1 and state.step >= args.max_step:
                done = True
                break
        if done:
            break
    save_all()
    if world > 1:
        torch.distributed.destroy_process_group()
    print("Training Complete!")
    return state


if __name__ == "__main__":
    main()
