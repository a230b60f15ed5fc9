"""Voice-library generation CLI (reference: generate_voice_library.py;
``alivevc_tpu/cli/generate_voice_library.py``).

    python -m alivevc_tpu_torch.cli.generate_voice_library target_voice/ \\
        -cep content_encoder.pt -lib voice_library.pt

Up to 512 random chunks of 7 680 samples of the dataset (numpy's
``default_rng(--seed)``, as the JAX package draws them) through
``train/library_gen.py``, with tokens as wide as the content encoder's
output; the library is written to ``-lib``: a ``.pt`` in the reference's
key layout, or a ``.ckpt`` parameter tree of the JAX package (its own CLI's
output).  ``--device`` defaults to cuda.
"""

from __future__ import annotations

import argparse

import numpy as np

from alivevc_tpu_torch.cli.common import load_params_or_init, require_format, save_model
from alivevc_tpu_torch.config import VoiceLibraryConfig
from alivevc_tpu_torch.device import resolve_device
from alivevc_tpu_torch.io.dataset import WaveChunkDataset
from alivevc_tpu_torch.train.library_gen import generate_voice_library


def build_parser():
    p = argparse.ArgumentParser(description="generate voice library")
    p.add_argument("dataset")
    p.add_argument("-lib", "--voice-library-path", default="voice_library.pt")
    p.add_argument("-cep", "--content-encoder-path", default="content_encoder.ckpt")
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    require_format(args.voice_library_path)
    dev = resolve_device(args.device)
    ce = load_params_or_init(args.content_encoder_path, "content_encoder", dev)
    ds = WaveChunkDataset([args.dataset], length=7680)
    print(f"Loaded {len(ds)} chunks")
    if len(ds) == 0:
        raise SystemExit("no audio chunks found: check the dataset path")
    order = np.random.default_rng(args.seed).permutation(len(ds))[:512]
    print("Generating Library...")
    cfg = VoiceLibraryConfig(dim=ce.cfg.output_channels)
    vl = generate_voice_library(ce, ds.chunks[order], seed=args.seed, cfg=cfg, device=dev)
    save_model(args.voice_library_path, vl, "voice_library")
    print("Complete!")
    return vl


if __name__ == "__main__":
    main()
