"""The JAX package's ``.npz`` checkpoint format, read and written by the port.

A checkpoint is one ``.npz`` whose keys are paths through a nested tree of
arrays (``alivevc_tpu/io/checkpoint.py:20-86``): the path starts at ``root``
and each step is joined by ``"\\x1f"`` and tagged ``d:<key>`` (dict),
``l:<i>`` (list), ``t:<i>`` (tuple) or ``n:<field>`` (NamedTuple); a None
leaf is the step ``none`` holding an empty array.  A NamedTuple without
fields (optax's ``EmptyState``, e.g. ``add_decayed_weights``' state at
``t:1`` of an ``adamw`` chain) writes no key, so a tuple's indices may have
gaps.  ``load_checkpoint`` rebuilds the tree from the keys alone, in numpy:
a NamedTuple comes back as ``Fields``, a dict of its fields that writes
``n:`` steps again, and each missing index of a tuple or list as an empty
``Fields()``, which writes no key; so a file read and written again has the
same keys and arrays.  ``compat/weights.py`` carries a model's tree into the
port's modules.  ``save_checkpoint`` writes any such tree of numpy arrays or
tensors atomically (a temporary file, then a rename).
"""

from __future__ import annotations

import os
import tempfile
from typing import Any

import numpy as np
import torch

SEP = "\x1f"   # never appears in a key name


class Fields(dict):
    """A NamedTuple's fields as read back (in the file's order): written as
    ``n:`` steps, where a plain dict writes ``d:`` steps.  ``Fields()`` is an
    empty state, which writes no key."""


def _flatten(tree: Any, prefix: str, out: dict) -> None:
    if isinstance(tree, Fields):
        for name, v in tree.items():
            _flatten(v, f"{prefix}{SEP}n:{name}", out)
    elif isinstance(tree, dict):
        for k in sorted(tree):
            _flatten(tree[k], f"{prefix}{SEP}d:{k}", out)
    elif hasattr(tree, "_fields"):
        for name in tree._fields:
            _flatten(getattr(tree, name), f"{prefix}{SEP}n:{name}", out)
    elif isinstance(tree, (list, tuple)):
        tag = "l" if isinstance(tree, list) else "t"
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}{SEP}{tag}:{i}", out)
    elif tree is None:
        out[f"{prefix}{SEP}none"] = np.zeros(0)
    elif isinstance(tree, torch.Tensor):
        out[prefix] = tree.detach().cpu().numpy()
    else:
        out[prefix] = np.asarray(tree)


def flatten(tree: Any) -> dict:
    """{key: numpy array}, the arrays ``save_checkpoint`` writes for ``tree``."""
    flat: dict = {}
    _flatten(tree, "root", flat)
    return flat


def save_checkpoint(path: str, tree: Any) -> None:
    flat = flatten(tree)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **flat)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _insert(node: dict, steps, value) -> None:
    """Place ``value`` at ``steps`` below ``node``, a dict of tagged steps."""
    step = steps[0]
    if len(steps) == 1:
        node[step] = value
        return
    _insert(node.setdefault(step, {}), steps[1:], value)


def _build(node):
    """Tagged-step dicts -> dicts, ``Fields``, lists and tuples."""
    if not isinstance(node, dict):
        return node
    if "none" in node:
        return None
    tags = {step.split(":", 1)[0] for step in node}
    if len(tags) != 1:
        raise ValueError(f"mixed container tags {sorted(tags)} in one node")
    tag = tags.pop()
    items = {step.split(":", 1)[1]: _build(v) for step, v in node.items()}
    if tag == "d":
        return items
    if tag == "n":
        return Fields(items)
    if tag in ("l", "t"):
        seq = [items.get(str(i), Fields()) for i in range(1 + max(map(int, items)))]
        return seq if tag == "l" else tuple(seq)
    raise ValueError(f"unknown container tag {tag!r}")


def load_checkpoint(path: str) -> Any:
    """The tree saved at ``path``, with numpy arrays at the leaves."""
    root: dict = {}
    with np.load(path) as data:
        for key in data.files:
            steps = key.split(SEP)
            if steps[0] != "root":
                raise ValueError(f"{path}: key {key!r} does not start at root")
            if len(steps) == 1:
                return data[key]
            _insert(root, steps[1:], data[key])
    return _build(root)
