"""Offline batch voice conversion CLI (reference: inference.py).

    python -m alivevc_tpu_torch.cli.inference -i inputs/ -o outputs/ -t target.wav \\
        -lib voice_library.ckpt -p 2 -int 1.2

The flags are the JAX package's (``alivevc_tpu/cli/inference.py``, which
mirrors inference.py:20-43); checkpoints may be reference ``.pt`` files or
the JAX package's ``.npz``.  ``--device`` (default ``cuda``) picks the card
or, by name, the CPU.  Every file in ``--inputs`` is converted at its own
sample rate (resampled to 16 kHz and back).
"""

from __future__ import annotations

import argparse
import glob
import os

from alivevc_tpu_torch.cli.common import load_params_or_init, log_logo, target_matrix
from alivevc_tpu_torch.config import InferenceConfig
from alivevc_tpu_torch.device import resolve_device
from alivevc_tpu_torch.infer.offline import OfflineConverter
from alivevc_tpu_torch.io.audio import read_wav, write_wav

LATER_SLICE = "the port's WORLD and plotting slice"


def build_parser():
    p = argparse.ArgumentParser(description="offline voice conversion")
    p.add_argument("-i", "--inputs", default="./inputs/")
    p.add_argument("-o", "--outputs", default="./outputs/")
    p.add_argument("-dep", "--decoder-path", default="decoder.ckpt")
    p.add_argument("-cep", "--content-encoder-path", default="content_encoder.ckpt")
    p.add_argument("-f0ep", "--f0-estimator-path", default="f0_estimator.ckpt")
    p.add_argument("-f0", "--f0-rate", default=1.0, type=float)
    p.add_argument("-p", "--pitch", default=0.0, type=float)
    p.add_argument("-int", "--intonation", default=1.0, type=float)
    p.add_argument("-t", "--target", default="NONE")
    p.add_argument("-g", "--gain", default=0.0, type=float)
    p.add_argument("-a", "--alpha", default=0.0, type=float)
    p.add_argument("-k", default=4, type=int)
    p.add_argument("-c", "--chunk", default=48000, type=int)
    p.add_argument("-lib", "--voice-library-path", default="NONE")
    p.add_argument("-norm", "--normalize", action="store_true")
    p.add_argument("-wpe", "--world-pitch-estimation", action="store_true",
                   help="WORLD (DIO+StoneMask) pitch; not ported yet")
    p.add_argument("--save-spectrograms", action="store_true",
                   help="log-mel PNGs next to each converted file; not ported yet")
    p.add_argument("--impl", default="kernels", choices=["kernels"],
                   help="compute path: the port's hand-written CUDA kernels")
    p.add_argument("-bf16", action="store_true",
                   help="bfloat16 content encoder and decoder (the licensed fast mode)")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return p


def main(argv=None) -> list:
    """Convert every file of ``--inputs``; returns the outputs, in order."""
    log_logo()
    args = build_parser().parse_args(argv)
    if args.world_pitch_estimation:
        raise NotImplementedError(f"-wpe: WORLD pitch comes with {LATER_SLICE}")
    if args.save_spectrograms:
        raise NotImplementedError(f"--save-spectrograms: plotting comes with {LATER_SLICE}")
    dev = resolve_device(args.device)
    ce = load_params_or_init(args.content_encoder_path, "content_encoder", dev)
    pe = load_params_or_init(args.f0_estimator_path, "f0_estimator", dev)
    dec = load_params_or_init(args.decoder_path, "decoder", dev)
    tgt = target_matrix(args, ce, dev)
    print(f"Loaded {tgt.shape[0]} words.")

    cfg = InferenceConfig(
        chunk=args.chunk,
        f0_rate=args.f0_rate,
        pitch_shift=args.pitch,
        intonation=args.intonation,
        k=args.k,
        alpha=args.alpha,
        gain_db=args.gain,
        normalize=args.normalize,
    )
    conv = OfflineConverter(ce, pe, dec, tgt, cfg, dtype="bf16" if args.bf16 else "fp32",
                            device=dev)
    os.makedirs(args.outputs, exist_ok=True)
    paths = sorted(glob.glob(os.path.join(args.inputs, "*")))
    outs = []
    for i, path in enumerate(paths):
        wave, sr = read_wav(path)
        print(f"converting {path}")
        out = conv.convert(wave, sr)
        stem = f"{i}_{os.path.splitext(os.path.basename(path))[0]}"
        write_wav(os.path.join(args.outputs, stem + ".wav"), out, sr)
        outs.append(out)
    print("Complete!")
    return outs


if __name__ == "__main__":
    main()
