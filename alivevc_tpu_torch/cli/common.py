"""Shared CLI helpers: model loading with ``.pt`` / ``.npz`` detection, the
reference's resume-by-existence convention (train_decoder.py:57-64), the
target matrix both conversion CLIs build, and the training CLIs' output
paths, process group and epoch length.

A model file is a reference-format ``.pt`` state dict (the reference's key
names, loaded with ``torch.load(weights_only=True)``), a training state
``.pt`` of this package (``train/state.py``; the model of that kind is read
out of it), or the JAX package's ``.npz`` checkpoint (``io/checkpoint.py``,
carried over by ``compat/weights.py``).  Either way the model is built at
the widths the file holds and loaded with strict key matching; a missing
file gives a model initialised from seed 0.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
from torch import nn

from alivevc_tpu_torch.compat import weights
from alivevc_tpu_torch.config import DecoderConfig
from alivevc_tpu_torch.device import resolve_device
from alivevc_tpu_torch.infer.offline import build_target_matrix
from alivevc_tpu_torch.io.audio import read_wav
from alivevc_tpu_torch.io.checkpoint import load_checkpoint
from alivevc_tpu_torch.models.content_encoder import ContentEncoder
from alivevc_tpu_torch.models.decoder import Decoder
from alivevc_tpu_torch.models.discriminator import Discriminator
from alivevc_tpu_torch.models.f0_estimator import F0Estimator
from alivevc_tpu_torch.models.voice_library import VoiceLibrary
from alivevc_tpu_torch.ops.resample import resample
from alivevc_tpu_torch.train.state import is_train_state


def _decoder_state(tree) -> dict:
    chans, rates = weights.filter_layout(tree)
    return weights.decoder_state(tree, DecoderConfig(filter_channels=chans, filter_rates=rates))


# kind -> (module class, JAX pytree -> reference state dict, state dict -> config)
MODELS = {
    "content_encoder": (ContentEncoder, weights.content_encoder_state,
                        weights.content_encoder_config),
    "f0_estimator": (F0Estimator, weights.f0_estimator_state, weights.f0_estimator_config),
    "decoder": (Decoder, _decoder_state, weights.decoder_config),
    "voice_library": (VoiceLibrary, weights.voice_library_state, weights.voice_library_config),
    "discriminator": (Discriminator, weights.discriminator_state, weights.discriminator_config),
}


def reference_state(path: str, kind: str) -> dict:
    """The reference-format state dict of the model file at ``path``."""
    if path.endswith(".pt"):
        sd = torch.load(path, map_location="cpu", weights_only=True)
        if is_train_state(sd):
            if kind not in sd["models"]:
                raise ValueError(f"{path}: the training state holds no {kind}")
            return sd["models"][kind]
        return sd
    return MODELS[kind][1](load_checkpoint(path))


def load_params_or_init(path: Optional[str], kind: str, device: torch.device) -> nn.Module:
    """The ``kind`` model from ``path`` if the file exists, else initialised
    from seed 0; in eval mode on ``device``."""
    cls, _, config_of = MODELS[kind]
    gen = torch.Generator().manual_seed(0)
    if path and os.path.exists(path):
        sd = reference_state(path, kind)
        module = weights.load_state(cls(config_of(sd), generator=gen), sd)
    else:
        module = cls(generator=gen)
    return module.to(device).eval().requires_grad_(False)


def resample_np(x: np.ndarray, orig: int, new: int, device: torch.device) -> np.ndarray:
    """``ops/resample.py`` on ``device`` for a host array."""
    if orig == new:
        return x
    return resample(torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device),
                    orig, new).cpu().numpy()


def target_matrix(args, ce: nn.Module, device: torch.device, decimation: int = 1) -> torch.Tensor:
    """The target matrix of ``--target`` (first channel at 16 kHz,
    peak-normalised) and ``--voice-library-path``; "NONE" leaves one out."""
    target_wave = None
    if args.target != "NONE":
        w, sr = read_wav(args.target)
        w = resample_np(w[:1], sr, 16_000, device)
        peak = np.abs(w).max()
        if peak > 0:
            w = w / peak
        target_wave = w[0]
    tokens = None
    if args.voice_library_path != "NONE":
        tokens = load_params_or_init(args.voice_library_path, "voice_library", device).matrix()
    return build_target_matrix(ce, target_wave=target_wave, library_tokens=tokens,
                               decimation=decimation, device=device)


def log_logo() -> None:
    print("alivevc_tpu_torch — kNN voice conversion, the PyTorch/CUDA port of alivevc_tpu")


def require_pt(*paths: str) -> None:
    """The training CLIs write ``.pt`` files only (reference-format state
    dicts and training states); refuse another extension before training."""
    bad = [p for p in paths if p != "NONE" and not p.endswith(".pt")]
    if bad:
        raise SystemExit(f"output files must end in .pt (the port writes torch files): {bad}")


def init_dp(dp: bool, device: str):
    """(device, rank, world).  With ``dp`` the process joins the default
    group from the environment torchrun sets (RANK, WORLD_SIZE, LOCAL_RANK,
    MASTER_ADDR, MASTER_PORT): NCCL with one rank a card (cuda:LOCAL_RANK),
    gloo on the CPU."""
    if not dp:
        return resolve_device(device), 0, 1
    import torch.distributed as dist

    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    dev = resolve_device(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", init_method="env://",
                            world_size=world, rank=rank)
    return dev, rank, world


def steps_per_epoch(n_chunks: int, local_batch: int, world: int, device: torch.device) -> int:
    """Full batches of this rank's chunks, and under data parallelism the
    minimum over the ranks, so that every rank runs the same number of
    steps (each rank loads its own files, and a rank that ran more steps
    would wait on a collective forever)."""
    n = n_chunks // local_batch
    if world > 1:
        import torch.distributed as dist

        t = torch.tensor([n], device=device)
        dist.all_reduce(t, op=dist.ReduceOp.MIN)
        n = int(t.item())
    return n
