"""Shared CLI helpers: model loading (``compat/torch_import.py:
load_params_or_init``: ``.pt`` / ``.npz`` / ``.ckpt`` detection and the
reference's resume-by-existence convention, train_decoder.py:57-64), the
target matrix both conversion CLIs build, and the training CLIs' files,
process group and epoch loop.

A model file is a reference-format ``.pt`` state dict (the reference's key
names, loaded with ``torch.load(weights_only=True)``), a training state
``.pt`` of this package (``train/state.py``; the model of that kind is read
out of it), or the JAX package's ``.npz`` / ``.ckpt`` checkpoint: a
parameter tree or a training state (``io/checkpoint.py``, carried over by
``compat/weights.py`` and ``compat/jax_train_state.py``).  Either way the
model is built at the widths the file holds and loaded with strict key
matching; a missing file gives a model initialised from seed 0.  Each
model a CLI builds prints one line: the file it came from and what that
file holds, or the seed of its weights where there is no file
(``compat/torch_import.py:model_line``).

The training CLIs read and write their states and models by the file's
extension, here and nowhere else: ``.pt`` is this package's format,
``.ckpt`` the JAX package's (a training state with its optax moments, or a
parameter tree), so a run moves between the two packages either way;
another extension is refused before training.  Their default names are
the JAX package's (``.ckpt``), so each CLI's defaults read what the one
before it wrote by default.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from alivevc_tpu_torch.compat import jax_train_state, weights
from alivevc_tpu_torch.compat.torch_import import load_params_or_init, model_line
from alivevc_tpu_torch.device import resolve_device
from alivevc_tpu_torch.infer.offline import build_target_matrix
from alivevc_tpu_torch.io.audio import read_wav
from alivevc_tpu_torch.io.checkpoint import save_checkpoint
from alivevc_tpu_torch.ops.resample import resample
from alivevc_tpu_torch.train.state import (
    TRAINERS,
    read_train_state,
    save_reference_state,
    write_train_state,
)


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


def resume_or_start(path: str, trainer: str, device: torch.device, start, **init_kw):
    """The reference's resume-by-existence: the trainer's state from ``path``
    where the file exists (a ``model_line`` for each of its models, then
    "resumed at step N"), else ``start()``, which prints its own lines."""
    if not os.path.exists(path):
        return start()
    state = read_state(path, trainer, device, **init_kw)
    what = f"{'JAX ' if path.endswith('.ckpt') else ''}training state, step {state.step}"
    for slot in TRAINERS[trainer].slots:
        if getattr(state, slot.module) is not None:
            model_line(slot.kind, path, what)
    print(f"resumed at step {state.step}")
    return state


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


def init_dp(dp: bool, device: str, batch_size: int):
    """(device, group).  Without ``dp`` the process trains alone and the
    group is None.  With ``dp`` it joins the default group from the
    environment torchrun sets (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
    MASTER_PORT): NCCL with one rank a card (cuda:LOCAL_RANK), gloo on the
    CPU; a batch size the ranks do not divide is refused."""
    if not dp:
        return resolve_device(device), None
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    dev = resolve_device(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", init_method="env://",
                            world_size=world, rank=rank)
    if batch_size % world:
        raise SystemExit(f"--dp needs a batch size divisible by the {world} ranks")
    return dev, dist.group.WORLD


def host_shard(group):
    """(rank, world) of this process in ``group``, the dataset's
    ``host_shard``; None alone."""
    return None if group is None else (dist.get_rank(group), dist.get_world_size(group))


def train_epochs(state, n_chunks: int, args, device: torch.device, group, step, line, save,
                 max_step: int = -1) -> None:
    """The training CLIs' loop: ``args.epoch`` epochs over this rank's
    ``n_chunks`` chunks, each epoch a permutation from
    ``np.random.default_rng(0)`` cut into batches of ``args.batch_size``
    / world.  ``step(sel)`` trains on the chunks ``sel`` (this rank's
    slice of the batch) and returns the metrics; rank 0 prints
    ``line(epoch, state.step, metrics)`` and calls ``save()`` every
    ``args.save_every`` steps and at the end.  The loop stops early at
    ``max_step`` (-1: no limit).  Under ``group`` every rank runs the
    minimum over the ranks of their full batches (each rank loads its own
    files, and a rank that ran more steps would wait on a collective
    forever), and the group ends with the loop."""
    rank, world = host_shard(group) or (0, 1)
    local = args.batch_size // world
    n_steps = n_chunks // local
    if group is not None:
        t = torch.tensor([n_steps], device=device)
        dist.all_reduce(t, op=dist.ReduceOp.MIN, group=group)
        n_steps = int(t.item())
    if n_steps == 0:
        raise SystemExit("no full batch of audio chunks: check the dataset path, length and batch")

    def batches():
        rng = np.random.default_rng(0)
        for epoch in range(args.epoch):
            order = rng.permutation(n_chunks)
            for s in range(n_steps):
                yield epoch, order[s * local:(s + 1) * local]

    for epoch, sel in batches():
        metrics = step(sel)
        if rank == 0:
            print(line(epoch, state.step, metrics))
            if state.step % args.save_every == 0:
                save()
        if max_step != -1 and state.step >= max_step:
            break
    if rank == 0:
        save()
    if group is not None:
        dist.destroy_process_group()
    print("Training Complete!")
