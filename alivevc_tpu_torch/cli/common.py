"""Shared CLI helpers: model loading (``compat/torch_import.py:
load_params_or_init``: ``.pt`` / ``.npz`` / ``.ckpt`` detection and the
reference's resume-by-existence convention, train_decoder.py:57-64), the
target matrix both conversion CLIs build, and the training CLIs' files,
process group and epoch length.

A model file is a reference-format ``.pt`` state dict (the reference's key
names, loaded with ``torch.load(weights_only=True)``), a training state
``.pt`` of this package (``train/state.py``; the model of that kind is read
out of it), or the JAX package's ``.npz`` / ``.ckpt`` checkpoint: a
parameter tree or a training state (``io/checkpoint.py``, carried over by
``compat/weights.py`` and ``compat/jax_train_state.py``).  Either way the
model is built at the widths the file holds and loaded with strict key
matching; a missing file gives a model initialised from seed 0.

The training CLIs read and write their states and models by the file's
extension, here and nowhere else: ``.pt`` is this package's format,
``.ckpt`` the JAX package's (a training state with its optax moments, or a
parameter tree), so a run moves between the two packages either way;
another extension is refused before training.
"""

from __future__ import annotations

import os

import numpy as np
import torch
from torch import nn

from alivevc_tpu_torch.compat import jax_train_state, weights
from alivevc_tpu_torch.compat.torch_import import load_params_or_init
from alivevc_tpu_torch.device import resolve_device
from alivevc_tpu_torch.infer.offline import build_target_matrix
from alivevc_tpu_torch.io.audio import read_wav
from alivevc_tpu_torch.io.checkpoint import save_checkpoint
from alivevc_tpu_torch.ops.resample import resample
from alivevc_tpu_torch.train.state import read_train_state, save_reference_state, write_train_state


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


FORMATS = (".pt", ".ckpt")


def require_format(*paths: str) -> None:
    """Refuse, before training, an output file that is neither ``.pt`` nor
    ``.ckpt`` ("NONE" names no file)."""
    bad = [p for p in paths if p != "NONE" and not p.endswith(FORMATS)]
    if bad:
        raise SystemExit("output files must end in .pt (this package's torch files) or .ckpt "
                         f"(the JAX package's layout): {bad}")


def read_state(path: str, trainer: str, device: torch.device, **init_kw):
    """A trainer's state (``train/state.py:TRAINERS``) from ``path``: a JAX
    ``.ckpt`` or this package's ``.pt``."""
    if path.endswith(".ckpt"):
        return jax_train_state.read(path, trainer, device, **init_kw)
    return read_train_state(path, trainer, device, **init_kw)


def write_state(path: str, state) -> None:
    if path.endswith(".ckpt"):
        jax_train_state.write(path, state)
    else:
        write_train_state(path, state)


def save_model(path: str, module: nn.Module, kind: str) -> None:
    """A model as a JAX parameter tree (``.ckpt``) or a reference state
    dict (``.pt``)."""
    if path.endswith(".ckpt"):
        save_checkpoint(path, weights.MODELS[kind].params(
            {k: v.detach().cpu().numpy() for k, v in module.state_dict().items()}))
    else:
        save_reference_state(path, module)


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
