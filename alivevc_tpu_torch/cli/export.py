"""Deployment export (reference: export_onnx.py; ``alivevc_tpu/cli/export.py``):
the JAX package's six-graph split, as ``torch.export`` programs saved with
``torch.export.save`` to ``<outputs>/<name>.pt2`` at static shapes of
``--length`` frames, batch 1.

    python -m alivevc_tpu_torch.cli.export -o export/ -cep content_encoder.pt \\
        -f0ep f0_estimator.pt -dep decoder.pt -lib voice_library.pt
    ep = torch.export.load("export/filter.pt2"); wave = ep.module()(source, features)

Graphs: ``f0_estimator`` (spec [1, T, 641] -> argmax Hz [1, T, 1]),
``content_encoder`` (spec -> [1, T, 768]), ``voice_library`` (content ->
the mean of its k = 4 nearest tokens), ``feature_extractor`` (content,
f0 -> [1, T, 512]), ``harmonic_oscillator`` (features -> the upsampled
amplitudes [1, 320 T, 64] only: the sine bank is left to the deploy
runtime, as in the reference's ONNX wrapper, module/decoder.py:226-235) and
``filter`` (source [1, 320 T, 1], features -> wave [1, 320 T]).

The graphs are the plain PyTorch functions, as the JAX package's are its
XLA functions and not its Pallas kernels: a kernel launch through ctypes
cannot be traced, and a ``.pt2`` is a portable artifact.  The two functions
whose main-path form is a kernel are chosen here by name:
``kernels/filter.py:filter_level_plain`` for each up level of the filter
U-Net, and ``kernels/knn.py:knn_topk_plain`` in 'highest' (the exact float32
ranking) for the library match.  The main path's wrappers are untouched.
Tracing runs on ``--device`` (default cuda), where the graphs will run:
constants a traced program holds do not move with ``.to()``.

``--torch-out DIR`` also writes the four models as reference-format ``.pt``
state dicts (content_encoder, f0_estimator, decoder, voice_library).
"""

from __future__ import annotations

import argparse
import os
from typing import Callable, Dict

import torch
from torch import nn

from alivevc_tpu_torch.cli.common import load_params_or_init
from alivevc_tpu_torch.device import resolve_device
from alivevc_tpu_torch.kernels.filter import filter_level_plain
from alivevc_tpu_torch.kernels.knn import knn_topk_plain
from alivevc_tpu_torch.models.content_encoder import content_encoder
from alivevc_tpu_torch.models.decoder import feature_extractor, filter_unet
from alivevc_tpu_torch.models.f0_estimator import f0_estimate
from alivevc_tpu_torch.ops.interp import linear_interpolate
from alivevc_tpu_torch.train.state import save_reference_state

def build_parser():
    p = argparse.ArgumentParser(description="export torch.export graphs")
    p.add_argument("-o", "--outputs", default="./export/")
    p.add_argument("-dep", "--decoder-path", default="decoder.ckpt")
    p.add_argument("-cep", "--content-encoder-path", default="content_encoder.ckpt")
    p.add_argument("-f0ep", "--f0-estimator-path", default="f0_estimator.ckpt")
    p.add_argument("-lib", "--voice-library-path", default="voice_library.ckpt")
    p.add_argument("--length", default=256, type=int,
                   help="frame length for static-shape graphs")
    p.add_argument("--torch-out", default=None,
                   help="also write reference-format torch .pt state dicts here")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu': where the graphs are traced and will run")
    return p


def library_match(vl: nn.Module, content: torch.Tensor, k: int = 4) -> torch.Tensor:
    """``models/voice_library.py:voice_library_match`` (alpha 0) with the plain
    'highest' top-k: content [N, Ls, D] -> the mean of the k nearest tokens."""
    tokens = vl.matrix()
    n, ls, d = content.shape
    _, idx = knn_topk_plain(content.reshape(n * ls, d), tokens, k=k, precision="highest")
    return tokens[idx].float().mean(dim=1).reshape(n, ls, d)


def oscillator_amps(osc: nn.Module, features: torch.Tensor, segment_size: int) -> torch.Tensor:
    """The harmonic oscillator's amplitudes, upsampled to the sample rate."""
    amps = torch.exp(osc.to_amps(features))
    return linear_interpolate(amps, features.shape[1] * segment_size, axis=1)


class Graph(nn.Module):
    """``fn(model, *inputs)`` as a module that holds ``model``'s parameters
    (only the part of a model that the graph reads, so that a ``.pt2``
    carries no other weights)."""

    def __init__(self, fn: Callable, model: nn.Module):
        super().__init__()
        self.fn, self.model = fn, model

    def forward(self, *inputs):
        return self.fn(self.model, *inputs)


def graphs(ce, pe, dec, vl) -> Dict[str, Graph]:
    cfg = dec.cfg
    return {
        "f0_estimator": Graph(f0_estimate, pe),
        "content_encoder": Graph(content_encoder, ce),
        "voice_library": Graph(library_match, vl),
        "feature_extractor": Graph(feature_extractor, dec.feature_extractor),
        "harmonic_oscillator": Graph(lambda osc, x: oscillator_amps(osc, x, cfg.segment_size),
                                     dec.harmonic_oscillator),
        # the filter U-Net with filter_level_plain at every up level
        "filter": Graph(lambda f, s, c: filter_unet(f, s, c, cfg, level=filter_level_plain)[..., 0],
                        dec.filter),
    }


def example_inputs(t: int, ce, pe, dec, vl, device) -> Dict[str, tuple]:
    """Each graph's inputs at ``t`` frames, batch 1 (zeros: only shapes are
    read), at the widths of the given models."""
    z = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=device)  # noqa: E731
    content, feats = z(1, t, dec.cfg.content_channels), z(1, t, dec.cfg.channels)
    return {"f0_estimator": (z(1, t, pe.cfg.input_channels),),
            "content_encoder": (z(1, t, ce.cfg.input_channels),),
            "voice_library": (z(1, t, vl.cfg.dim),),
            "feature_extractor": (content, z(1, t, 1)), "harmonic_oscillator": (feats,),
            "filter": (z(1, t * dec.cfg.segment_size, 1), feats)}


def export_graphs(ce, pe, dec, vl, out_dir: str, length: int, device) -> Dict[str, str]:
    """Trace the six graphs on ``device`` and save them; {name: path}."""
    os.makedirs(out_dir, exist_ok=True)
    inputs = example_inputs(length, ce, pe, dec, vl, device)
    paths = {}
    with torch.no_grad():
        for name, module in graphs(ce, pe, dec, vl).items():
            path = os.path.join(out_dir, f"{name}.pt2")
            torch.export.save(torch.export.export(module, inputs[name]), path)
            print(f"exported {path}")
            paths[name] = path
    return paths


def main(argv=None):
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    ce = load_params_or_init(args.content_encoder_path, "content_encoder", dev)
    pe = load_params_or_init(args.f0_estimator_path, "f0_estimator", dev)
    dec = load_params_or_init(args.decoder_path, "decoder", dev)
    vl = load_params_or_init(args.voice_library_path, "voice_library", dev)
    paths = export_graphs(ce, pe, dec, vl, args.outputs, args.length, dev)
    if args.torch_out:
        for name, module in (("content_encoder", ce), ("f0_estimator", pe), ("decoder", dec),
                             ("voice_library", vl)):
            path = os.path.join(args.torch_out, f"{name}.pt")
            save_reference_state(path, module)
            print(f"exported {path}")
    print("Export complete!")
    return paths


if __name__ == "__main__":
    main()
