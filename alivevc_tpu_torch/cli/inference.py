"""Offline batch voice conversion CLI (reference: inference.py).

    python -m alivevc_tpu_torch.cli.inference -i inputs/ -o outputs/ -t target.wav \\
        -lib voice_library.ckpt -p 2 -int 1.2

The flags are the JAX package's (``alivevc_tpu/cli/inference.py``, which
mirrors inference.py:20-43); checkpoints may be reference ``.pt`` files,
this package's training states, or the JAX package's ``.npz`` / ``.ckpt``
(parameters, or a trainer's whole state).  ``--device`` (default ``cuda``) picks the card
or, by name, the CPU.  Every file in ``--inputs`` is converted at its own
sample rate (resampled to 16 kHz and back).  ``-wpe`` takes the pitch from
WORLD (DIO + StoneMask, on the host) instead of the F0 estimator;
``--save-spectrograms`` writes input and output log-mel PNGs beside each
converted file (needs matplotlib).
"""

from __future__ import annotations

import argparse
import glob
import os

import torch

from alivevc_tpu_torch.cli.common import load_params_or_init, log_logo, target_matrix
from alivevc_tpu_torch.config import InferenceConfig
from alivevc_tpu_torch.device import resolve_device
from alivevc_tpu_torch.infer.offline import OfflineConverter
from alivevc_tpu_torch.io.audio import read_wav, write_wav
from alivevc_tpu_torch.ops.stft import log_mel_spectrogram


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
                   help="WORLD (DIO+StoneMask) pitch instead of the F0 estimator's")
    p.add_argument("--save-spectrograms", action="store_true",
                   help="log-mel PNGs next to each converted file (needs matplotlib)")
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
    conv = OfflineConverter(ce, pe, dec, tgt, cfg, world_pitch=args.world_pitch_estimation,
                            dtype="bf16" if args.bf16 else "fp32", device=dev)
    os.makedirs(args.outputs, exist_ok=True)
    paths = sorted(glob.glob(os.path.join(args.inputs, "*")))
    outs = []
    for i, path in enumerate(paths):
        wave, sr = read_wav(path)
        print(f"converting {path}")
        out = conv.convert(wave, sr)
        stem = f"{i}_{os.path.splitext(os.path.basename(path))[0]}"
        write_wav(os.path.join(args.outputs, stem + ".wav"), out, sr)
        if args.save_spectrograms:
            save_spectrograms(wave, out, sr, os.path.join(args.outputs, stem), dev)
        outs.append(out)
    print("Complete!")
    return outs


def save_spectrograms(wave, out, sr: int, prefix: str, device: torch.device) -> None:
    """``<prefix>_input_spec.png`` and ``<prefix>_output_spec.png``: the
    log-mel spectrograms of the (mono) input and the output
    (inference.py:154-155)."""
    from alivevc_tpu_torch.utils.plotting import plot_spectrogram

    mono_in = wave.mean(axis=0) if wave.ndim == 2 else wave
    for tag, w in (("input", mono_in), ("output", out)):
        x = torch.as_tensor(w, dtype=torch.float32)[None].to(device)
        mel = log_mel_spectrogram(x, sr)[0].cpu().numpy()
        plot_spectrogram(mel, f"{prefix}_{tag}_spec.png", log=False)


if __name__ == "__main__":
    main()
