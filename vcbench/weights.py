"""Seeded weights, drawn on the device in a few large calls: one uniform
draw for every uniformly initialised parameter, scaled per parameter to its
bound (1 / sqrt(fan-in), as torch's conv default), one normal draw, and the
constants.  The same tensors go to the program and to the reference."""

from __future__ import annotations

from typing import Dict, List

import torch

from reference.model import Spec


def draw(specs: Dict[str, List[Spec]], gen: torch.Generator, device) -> Dict[str, Dict[str, torch.Tensor]]:
    """{model: {name: float32 tensor}} for ``model.param_specs``' lists."""
    flat = [(m, s) for m, ss in specs.items() for s in ss]
    sizes = {kind: sum(int(torch.Size(shape).numel()) for _, (_, shape, (k, _)) in flat if k == kind)
             for kind in ("uniform", "normal")}
    pools = {
        "uniform": torch.empty(sizes["uniform"], device=device).uniform_(-1.0, 1.0, generator=gen),
        "normal": torch.empty(sizes["normal"], device=device).normal_(0.0, 1.0, generator=gen),
    }
    at = {"uniform": 0, "normal": 0}
    out: Dict[str, Dict[str, torch.Tensor]] = {m: {} for m in specs}
    for m, (name, shape, (kind, value)) in flat:
        if kind == "const":
            out[m][name] = torch.full(shape, float(value), device=device)
            continue
        n = int(torch.Size(shape).numel())
        out[m][name] = pools[kind][at[kind]:at[kind] + n].view(shape) * value
        at[kind] += n
    return out
