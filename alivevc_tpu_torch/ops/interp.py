"""Linear interpolation with ``F.interpolate(mode='linear')`` semantics
(align_corners=False) along any axis of a channels-last tensor.

Output index ``i`` maps to the source coordinate
``max(0, (i + 0.5) * in/out - 0.5)``; the two neighbouring samples are
blended, the upper index clamped to ``in - 1``.  Integer-factor time
upsampling of ``[N, T, C]`` uses the equivalent 3-tap form (frames q-1, q,
q+1 of the edge-padded input), the same arithmetic as the JAX package.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np
import torch

from alivevc_tpu_torch.device import cached

_WEIGHTS: Dict[Tuple[int, str, torch.dtype], Tuple[torch.Tensor, ...]] = {}


@functools.lru_cache(maxsize=None)
def upsample_weights_np(factor: int):
    """Sample r of segment q mixes frames (q-1, q, q+1) of the edge-padded
    input with weights (wa[r], wb[r], wc[r])."""
    r = np.arange(factor)
    u = (r + 0.5) / factor - 0.5
    wa = np.where(u < 0, -u, 0.0)
    wb = np.where(u < 0, 1.0 + u, 1.0 - u)
    wc = np.where(u >= 0, u, 0.0)
    return (wa.astype(np.float32), wb.astype(np.float32), wc.astype(np.float32))


def _upsample_weights(factor: int, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The three weight rows as [1, 1, factor, 1] tensors on ``x``'s device in
    its dtype, cached (``device.cached``: plain tensors only): after the first
    call an upsample copies nothing from the host, so it never waits on the
    stream and a CUDA graph can hold it."""
    return cached(_WEIGHTS, (factor, str(x.device), x.dtype), lambda: tuple(
        torch.from_numpy(w).to(x.device).to(x.dtype)[None, None, :, None]
        for w in upsample_weights_np(factor)))


def _upsample_int_time(x: torch.Tensor, factor: int) -> torch.Tensor:
    n, t, c = x.shape
    wa, wb, wc = _upsample_weights(factor, x)
    x0 = torch.cat([x[:, :1], x[:, :-1]], dim=1)
    x2 = torch.cat([x[:, 1:], x[:, -1:]], dim=1)
    y = x0[:, :, None, :] * wa + x[:, :, None, :] * wb + x2[:, :, None, :] * wc
    return y.reshape(n, t * factor, c)


def linear_interpolate(x: torch.Tensor, out_size: int, axis: int = -1) -> torch.Tensor:
    """Resize ``x`` along ``axis`` to ``out_size`` samples."""
    axis = axis % x.dim()
    in_size = x.shape[axis]
    if in_size == out_size:
        return x
    if x.dim() == 3 and axis == 1 and out_size > in_size and out_size % in_size == 0:
        return _upsample_int_time(x, out_size // in_size)
    scale = in_size / out_size
    i = torch.arange(out_size, dtype=torch.float32, device=x.device)
    src = torch.clamp((i + 0.5) * scale - 0.5, min=0.0)
    i0f = torch.floor(src)
    frac = src - i0f
    i0 = torch.clamp(i0f.long(), max=in_size - 1)
    i1 = torch.clamp(i0 + 1, max=in_size - 1)
    x0 = torch.index_select(x, axis, i0)
    x1 = torch.index_select(x, axis, i1)
    shape = [1] * x.dim()
    shape[axis] = out_size
    frac = frac.reshape(shape).to(x.dtype)
    return x0 + (x1 - x0) * frac
