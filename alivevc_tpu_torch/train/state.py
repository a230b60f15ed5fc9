"""A trainer's state as one ``.pt`` file: the update count, each model's
state dict in the reference's key layout, each model's configuration and
each optimizer's state dict, written atomically (a temporary file, then a
rename).  ``compat/torch_import.py`` reads a model out of such a file as it
reads a reference ``.pt``, so the inference CLIs load trained weights from it
directly.

``TRAINERS`` names, for each of the four trainers, its state class, its
``init_*`` and the models it trains with their optimizers;
``read_train_state`` / ``write_train_state`` carry any of the four through
a ``.pt``.  The JAX package's ``.ckpt`` training states, in optax's layout,
are ``compat/jax_train_state.py``'s; ``cli/common.py`` chooses between the
two by the file's extension.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from alivevc_tpu_torch.compat import weights
from alivevc_tpu_torch.device import DeviceLike, resolve_device
from alivevc_tpu_torch.train import distill, f0, fine_tune, gan


class Slot(NamedTuple):
    kind: str        # the model's kind (``compat/weights.py:MODELS``)
    module: str      # the state's attribute holding the model (None when absent)
    opt: str         # the state's attribute holding its optimizer


class Trainer(NamedTuple):
    state: type      # the port's state class
    init: Callable   # ``init_*(*models in slot order, **kw)`` -> a state
    slots: Tuple[Slot, ...]


_GAN = (Slot("decoder", "dec", "opt_g"), Slot("discriminator", "disc", "opt_d"))
TRAINERS = {
    "gan": Trainer(gan.GanState, gan.init_gan, _GAN),
    "fine_tune": Trainer(fine_tune.FineTuneState, fine_tune.init_fine_tune,
                         _GAN + (Slot("voice_library", "vl", "opt_vl"),)),
    "f0": Trainer(f0.F0TrainState, f0.init_f0_train, (Slot("f0_estimator", "model", "opt"),)),
    "distill": Trainer(distill.DistillState, distill.init_distill,
                       (Slot("content_encoder", "model", "opt"),)),
}


def trainer_of(state) -> str:
    """The ``TRAINERS`` key of a port state object."""
    for name, tr in TRAINERS.items():
        if type(state) is tr.state:
            return name
    raise TypeError(f"{type(state).__name__} is not a trainer's state")


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


def model_from_state(state: dict, kind: str) -> nn.Module:
    """Model ``kind`` of a loaded training state, built at its stored
    configuration and loaded with strict key matching (on the CPU)."""
    m = weights.MODELS[kind]
    cfg = m.config_type(**{k: tuple(v) if isinstance(v, list) else v
                           for k, v in state["configs"][kind].items()})
    module = m.module(cfg)
    module.load_state_dict(state["models"][kind], strict=True)
    return module


def read_train_state(path: str, trainer: str, device: DeviceLike = None, **init_kw):
    """The ``trainer``'s state (``TRAINERS``) from a ``.pt`` of
    ``write_train_state``: the models at their stored configurations on
    ``device``, then ``init_*(models, **init_kw)``, the optimizers' state
    dicts and the step.  A model the file does not hold is None."""
    st = load_train_state(path)
    tr = TRAINERS[trainer]
    dev = resolve_device(device)
    models = [model_from_state(st, s.kind).to(dev) if s.kind in st["models"] else None
              for s in tr.slots]
    state = tr.init(*models, **init_kw)
    for s, m in zip(tr.slots, models):
        if m is not None:
            getattr(state, s.opt).load_state_dict(st["optimizers"][s.kind])
    state.step = st["step"]
    return state


def write_train_state(path: str, state) -> None:
    """A trainer's state object as one ``.pt`` (``save_train_state``)."""
    slots = TRAINERS[trainer_of(state)].slots
    save_train_state(path, state.step, {s.kind: getattr(state, s.module) for s in slots},
                     {s.kind: getattr(state, s.opt) for s in slots})
