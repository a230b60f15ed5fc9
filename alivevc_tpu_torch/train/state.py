"""A trainer's state as one ``.pt`` file: the update count, each model's
state dict in the reference's key layout, each model's configuration and
each optimizer's state dict, written atomically (a temporary file, then a
rename).  ``cli/common.py`` reads a model out of such a file as it reads a
reference ``.pt``, so the inference CLIs load trained weights from it
directly.  (The JAX package's ``.ckpt`` training states, in optax's
layout, are not read.)
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Dict, Optional, Type

import torch
from torch import nn


def _save(obj, path: str) -> None:
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    os.close(fd)
    try:
        torch.save(obj, tmp)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _cpu_state(module: nn.Module) -> dict:
    return {k: t.detach().cpu() for k, t in module.state_dict().items()}


def save_reference_state(path: str, module: nn.Module) -> None:
    """``module``'s state dict (the reference's key layout) as a ``.pt``."""
    _save(_cpu_state(module), path)


def save_train_state(path: str, step: int, models: Dict[str, Optional[nn.Module]],
                     optimizers: Dict[str, Optional[torch.optim.Optimizer]]) -> None:
    """One ``.pt``: {'step', 'models': {name: state dict}, 'configs':
    {name: config fields}, 'optimizers': {name: state dict}}; None entries
    are left out."""
    models = {k: m for k, m in models.items() if m is not None}
    _save({
        "step": int(step),
        "models": {k: _cpu_state(m) for k, m in models.items()},
        "configs": {k: dataclasses.asdict(m.cfg) for k, m in models.items()},
        "optimizers": {k: o.state_dict() for k, o in optimizers.items() if o is not None},
    }, path)


def is_train_state(sd) -> bool:
    return isinstance(sd, dict) and "models" in sd and "step" in sd


def load_train_state(path: str) -> dict:
    """The dict ``save_train_state`` wrote (tensors on the CPU)."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    if not is_train_state(state):
        raise ValueError(f"{path} is not a training state of this package")
    return state


def model_from_state(state: dict, name: str, cls: Type[nn.Module], cfg_cls) -> nn.Module:
    """Model ``name`` of a loaded training state, built at its stored
    configuration and loaded with strict key matching (on the CPU)."""
    cfg = cfg_cls(**{k: tuple(v) if isinstance(v, list) else v
                     for k, v in state["configs"][name].items()})
    module = cls(cfg)
    module.load_state_dict(state["models"][name], strict=True)
    return module
