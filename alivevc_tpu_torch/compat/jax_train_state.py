"""The JAX package's four training states as ``.ckpt`` files, read into the
port's trainers and written from them.

Each JAX trainer writes its whole state with ``io/checkpoint.py``'s format:
``GanState`` (``alivevc_tpu/train/gan.py:49-54``), ``FineTuneState``
(``train/fine_tune.py:39-46``; its library and the library's optimizer may
be None), ``F0TrainState`` (``train/f0.py:23-26``) and ``DistillState``
(``train/distill.py:26-29``).  The optimizer states are optax 0.2's
chains, written out here (optax is not imported):

  * ``adamw_gan`` (``alivevc_tpu/train/optim.py``; the decoder and the
    discriminator): ``(ScaleByAdamState(count, mu, nu), EmptyState(),
    ScaleByScheduleState(count))``, ``add_decayed_weights`` being the empty
    state at ``t:1``;
  * the voice library's ``optax.adamw(lr)``: ``(ScaleByAdamState,
    EmptyState(), EmptyState())``;
  * ``optax.radam(lr)`` (the F0 trainer, distillation):
    ``(ScaleByAdamState, EmptyState())``.

An empty state writes no key, so these forms differ on the file only in the
schedule's count.  ``mu`` and ``nu`` have the parameters' tree, so they go
through ``compat/weights.py``'s rules as the parameters do, and reach the
port's optimizers by parameter name: ``mu`` is ``exp_avg``, ``nu``
``exp_avg_sq``, ``count`` the optimizer's ``step`` (a float32 tensor for
``torch.optim.AdamW``, an int for ``train/optim.py:RAdam``), and the
state's ``step`` the port state's ``step``.  The port derives the cosine
learning rate from the Adam count (``train/gan.py:update_count``), so a
file whose schedule count differs from its Adam count is refused; JAX never
writes one.

``read`` builds the models at the widths their parameters hold and checks
the file against the layout ``write`` forms for them: a missing or extra key
or another shape is an error that names it; nothing falls back to a fresh
optimizer.  ``write`` writes counts and steps as int32 and the rest as
float32, as optax and JAX make them.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from alivevc_tpu_torch.compat import weights
from alivevc_tpu_torch.device import DeviceLike, resolve_device
from alivevc_tpu_torch.io.checkpoint import Fields, flatten, load_checkpoint, save_checkpoint
from alivevc_tpu_torch.train.optim import RAdam
from alivevc_tpu_torch.train.state import TRAINERS, trainer_of


class ScaleByAdamState(NamedTuple):
    count: Any
    mu: Any
    nu: Any


class EmptyState(NamedTuple):
    """A stateless transform's state: no field, so no key on the file."""


class ScaleByScheduleState(NamedTuple):
    count: Any


class GanState(NamedTuple):
    dec_params: Any
    disc_params: Any
    dec_opt: Any
    disc_opt: Any
    step: Any


class FineTuneState(NamedTuple):
    dec_params: Any
    disc_params: Any
    vl_params: Any
    dec_opt: Any
    disc_opt: Any
    vl_opt: Any
    step: Any


class F0TrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: Any


class DistillState(NamedTuple):
    params: Any
    opt_state: Any
    step: Any


ADAMW_GAN, LIBRARY_ADAMW, RADAM = "adamw_gan", "library_adamw", "radam"


class Place(NamedTuple):
    params: str      # the JAX state's field of a model's parameters
    opt: str         # ... and of its optimizer's state
    chain: str       # the optax chain of that state


# trainer -> (the JAX state, a Place for each of ``train/state.py:TRAINERS``' slots, in order)
LAYOUTS = {
    "gan": (GanState, (Place("dec_params", "dec_opt", ADAMW_GAN),
                       Place("disc_params", "disc_opt", ADAMW_GAN))),
    "fine_tune": (FineTuneState, (Place("dec_params", "dec_opt", ADAMW_GAN),
                                  Place("disc_params", "disc_opt", ADAMW_GAN),
                                  Place("vl_params", "vl_opt", LIBRARY_ADAMW))),
    "f0": (F0TrainState, (Place("params", "opt_state", RADAM),)),
    "distill": (DistillState, (Place("params", "opt_state", RADAM),)),
}


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float32, copy=False)


def _opt_tree(opt: torch.optim.Optimizer, module: torch.nn.Module, kind: str, chain: str):
    named = list(module.named_parameters())
    states = [opt.state.get(p, {}) for _, p in named]
    counts = {int(s["step"]) for s in states if s}
    if len(counts) > 1:
        raise ValueError(f"the {kind}'s optimizer holds several update counts {sorted(counts)}; "
                         "optax keeps one")
    count = np.asarray(counts.pop() if counts else 0, np.int32)

    def moments(key):
        return weights.MODELS[kind].params({
            name: _host(s[key]) if s else np.zeros(tuple(p.shape), np.float32)
            for (name, p), s in zip(named, states)})

    adam = ScaleByAdamState(count, moments("exp_avg"), moments("exp_avg_sq"))
    if chain == ADAMW_GAN:
        return adam, EmptyState(), ScaleByScheduleState(count)
    if chain == LIBRARY_ADAMW:
        return adam, EmptyState(), EmptyState()
    return adam, EmptyState()


def jax_tree(state):
    """A port trainer's state as the JAX package's NamedTuple of numpy
    arrays (what ``write`` writes)."""
    trainer = trainer_of(state)
    jax_state, places = LAYOUTS[trainer]
    fields = {"step": np.asarray(state.step, np.int32)}
    for slot, place in zip(TRAINERS[trainer].slots, places):
        module = getattr(state, slot.module)
        fields[place.params] = fields[place.opt] = None
        if module is not None:
            fields[place.params] = weights.MODELS[slot.kind].params(
                {k: _host(v) for k, v in module.state_dict().items()})
            fields[place.opt] = _opt_tree(getattr(state, slot.opt), module, slot.kind, place.chain)
    return jax_state(**fields)


def write(path: str, state) -> None:
    """A port trainer's state to ``path`` in the JAX package's layout."""
    save_checkpoint(path, jax_tree(state))


def _check_fields(path: str, tree, jax_state: type) -> None:
    if not isinstance(tree, Fields):
        raise ValueError(f"{path}: not a JAX {jax_state.__name__} (its root is not a NamedTuple)")
    missing = sorted(set(jax_state._fields) - set(tree))
    extra = sorted(set(tree) - set(jax_state._fields))
    if missing or extra:
        raise ValueError(f"{path}: not a JAX {jax_state.__name__}: missing fields {missing}, "
                         f"extra fields {extra}")


def _shown(keys) -> str:
    keys = sorted(k.replace("\x1f", "/") for k in keys)
    return f"{len(keys)} {keys[:4]}{' ...' if len(keys) > 4 else ''}"


def _check_layout(path: str, tree, want) -> None:
    got = {k: v.shape for k, v in flatten(tree).items()}
    want = {k: v.shape for k, v in flatten(want).items()}
    missing, extra = set(want) - set(got), set(got) - set(want)
    reshaped = {k for k in set(want) & set(got) if want[k] != got[k]}
    if missing or extra or reshaped:
        raise ValueError(f"{path}: not the layout of its models' JAX training state: missing keys "
                         f"{_shown(missing)}, extra keys {_shown(extra)}, other shapes "
                         f"{_shown(reshaped)}")


def _load_opt(path: str, opt: torch.optim.Optimizer, module: torch.nn.Module, kind: str,
              place: Place, opt_tree) -> None:
    adam = opt_tree[0]
    count = int(adam["count"])
    if place.chain == ADAMW_GAN and int(opt_tree[2]["count"]) != count:
        raise ValueError(f"{path}: {place.opt}'s schedule count {int(opt_tree[2]['count'])} differs "
                         f"from its Adam count {count}; the port derives the learning rate from "
                         "the Adam count")
    mu, nu = weights.MODELS[kind].state(adam["mu"]), weights.MODELS[kind].state(adam["nu"])
    for name, p in module.named_parameters():
        opt.state[p] = {
            "step": count if isinstance(opt, RAdam) else torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": torch.from_numpy(np.ascontiguousarray(mu[name])).to(p.device, p.dtype),
            "exp_avg_sq": torch.from_numpy(np.ascontiguousarray(nu[name])).to(p.device, p.dtype),
        }


def read(path: str, trainer: str, device: DeviceLike = None, **init_kw):
    """The port's state of ``trainer`` (``train/state.py:TRAINERS``) from the
    JAX package's ``.ckpt``: each model at the widths its parameters hold, on
    ``device`` (CUDA unless 'cpu'), then ``init_*(models, **init_kw)`` (a
    ``TrainConfig`` as ``cfg``, or ``learning_rate``), the optimizers'
    moments and counts, and the step."""
    jax_state, places = LAYOUTS[trainer]
    tr = TRAINERS[trainer]
    dev = resolve_device(device)
    tree = load_checkpoint(path)
    _check_fields(path, tree, jax_state)
    models = []
    for slot, place in zip(tr.slots, places):
        if tree[place.params] is None:
            models.append(None)
            continue
        try:
            sd = weights.state_of(slot.kind, tree[place.params])
        except ValueError as e:
            raise ValueError(f"{path}: {place.params}: {e}") from None
        models.append(weights.build(slot.kind, sd).to(dev))
    state = tr.init(*models, **init_kw)
    _check_layout(path, tree, jax_tree(state))
    for slot, place, module in zip(tr.slots, places, models):
        if module is not None:
            _load_opt(path, getattr(state, slot.opt), module, slot.kind, place, tree[place.opt])
    state.step = int(tree["step"])
    return state


def model_params(tree: Fields, kind: str, path: str):
    """The ``kind`` model's parameters in a JAX training state that
    ``io/checkpoint.py:load_checkpoint`` read (the inference CLIs' loader
    takes a model out of a trainer's output this way)."""
    states = [(trainer, jax_state) for trainer, (jax_state, _) in LAYOUTS.items()
              if set(jax_state._fields) == set(tree)]
    if not states:
        raise ValueError(f"{path}: a NamedTuple with fields {sorted(tree)} is none of the JAX "
                         f"training states {[s.__name__ for s, _ in LAYOUTS.values()]}")
    for trainer, _ in states:
        for slot, place in zip(TRAINERS[trainer].slots, LAYOUTS[trainer][1]):
            if slot.kind == kind and tree[place.params] is not None:
                return tree[place.params]
    raise ValueError(f"{path}: the JAX {' / '.join(s.__name__ for _, s in states)} holds no {kind}")
