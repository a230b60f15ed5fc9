"""Harmonic sources: CUDA kernels (``csrc/oscillator.cu``) and their plain
PyTorch versions.

``harmonic_source`` replaces
``alivevc_tpu/kernels/oscillator_pallas.py:harmonic_source_cheb_pallas``:
the decoder's offline oscillator (phi = 0, crop = (0, -1)) with formants
exactly f0 * (1..NH).  Sample r of frame q mixes frames (q-1, q, q+1) with
the x``seg`` linear-interpolation weights (align_corners=False); the phase
inside a frame is the same mix with the prefix-summed weights, and the base
phase of a frame is the sum of the earlier frames' totals, taken in float64
and wrapped mod 1.

``harmonic_source_formants`` replaces ``oscillator_pallas.py:harmonic_source_pallas``:
the same source over any formants [N, Lf, NH] (not necessarily f0
multiples), each harmonic with its own phase by the same closed form and a
float64 base per frame wrapped mod 1 (the JAX kernel carries it unwrapped
in float32).  It is reached through the kernel API, not the decoder.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from alivevc_tpu_torch.kernels import _lib
from alivevc_tpu_torch.ops.interp import upsample_weights_np


@functools.lru_cache(maxsize=None)
def interp_weights_np(seg: int):
    """(w [3, seg], ws [3, seg]): interpolation weights of frames
    (q-1, q, q+1) and their inclusive prefix sums along the segment."""
    w = np.stack(upsample_weights_np(seg)).astype(np.float32)
    return w, np.cumsum(w, axis=1).astype(np.float32)


def _tables(seg: int, device):
    w, ws = interp_weights_np(seg)
    return torch.from_numpy(w).to(device), torch.from_numpy(ws).to(device)


def _edge(x: torch.Tensor) -> torch.Tensor:
    """Pad one frame on each side of axis 1 by edge replication."""
    return torch.cat([x[:, :1], x, x[:, -1:]], dim=1)


def harmonic_source_plain(f0: torch.Tensor, amps: torch.Tensor, sample_rate: int = 16_000,
                          seg: int = 320) -> torch.Tensor:
    """f0 [N, Lf] or [N, Lf, 1] Hz, amps [N, Lf, NH] -> [N, Lf*seg, 1] float32."""
    if f0.dim() == 3:
        f0 = f0[..., 0]
    n, lf = f0.shape
    nh = amps.shape[-1]
    w, ws = _tables(seg, f0.device)
    fp = _edge((f0.float() / sample_rate)[..., None])              # [N, Lf+2, 1]
    cseg = fp[:, :-2] * ws[0] + fp[:, 1:-1] * ws[1] + fp[:, 2:] * ws[2]   # [N, Lf, seg]
    tot = cseg[:, :, -1].double()
    o = (torch.cumsum(tot, dim=1) - tot) - cseg[:, :1, 0].double()
    off = (o - torch.floor(o)).float()
    theta = (2.0 * math.pi) * (cseg + off[..., None])
    s1 = torch.sin(theta)
    twoc = 2.0 * torch.cos(theta)
    ap = _edge(amps.float())
    a0, a1, a2 = ap[:, :-2], ap[:, 1:-1], ap[:, 2:]

    def amp(k):
        return a0[..., k:k + 1] * w[0] + a1[..., k:k + 1] * w[1] + a2[..., k:k + 1] * w[2]

    acc = s1 * amp(0)
    s_km2, s_km1 = torch.zeros_like(s1), s1
    for k in range(1, nh):
        s_k = twoc * s_km1 - s_km2
        acc = acc + s_k * amp(k)
        s_km2, s_km1 = s_km1, s_k
    return (acc / nh).reshape(n, lf * seg, 1)


def harmonic_source_cuda(f0: torch.Tensor, amps: torch.Tensor, sample_rate: int = 16_000,
                         seg: int = 320) -> torch.Tensor:
    """The kernel launch."""
    if f0.dim() == 3:
        f0 = f0[..., 0]
    f = (f0.float() / sample_rate).contiguous()
    a = amps.float().contiguous()
    _lib.require(f, "f0", (torch.float32,), 2)
    _lib.require(a, "amps", (torch.float32,), 3)
    n, lf = f.shape
    if a.shape[:2] != (n, lf) or not 1 <= a.shape[2] <= 256:
        raise ValueError(f"amps {tuple(a.shape)} does not match f0 {tuple(f.shape)} (NH <= 256)")
    w, ws = _tables(seg, f.device)
    out = torch.empty((n, lf * seg, 1), dtype=torch.float32, device=f.device)
    fn = _lib.function("oscillator", "osc_cheb_f32", "pppppiiiip")
    rc = fn(f.data_ptr(), a.data_ptr(), w.data_ptr(), ws.data_ptr(), out.data_ptr(),
            n, lf, a.shape[2], seg, _lib.stream_of(f))
    _lib.check(rc, "osc_cheb_f32")
    _lib.LAUNCHES["oscillator"] += 1
    return out


def harmonic_source(f0: torch.Tensor, amps: torch.Tensor, sample_rate: int = 16_000,
                    seg: int = 320) -> torch.Tensor:
    """Offline harmonic source: the kernel on CUDA tensors, the plain
    version on CPU tensors."""
    if _lib.route(f0) == "cuda":
        return harmonic_source_cuda(f0, amps, sample_rate, seg)
    return harmonic_source_plain(f0, amps, sample_rate, seg)


def harmonic_source_formants_plain(formants: torch.Tensor, amps: torch.Tensor,
                                   sample_rate: int = 16_000, seg: int = 320) -> torch.Tensor:
    """formants [N, Lf, NH] Hz, amps [N, Lf, NH] -> [N, Lf*seg, 1] float32."""
    n, lf, nh = formants.shape
    w, ws = _tables(seg, formants.device)
    fp = _edge(formants.float() / sample_rate)[..., None]                # [N, Lf+2, NH, 1]
    cseg = fp[:, :-2] * ws[0] + fp[:, 1:-1] * ws[1] + fp[:, 2:] * ws[2]   # [N, Lf, NH, seg]
    tot = cseg[..., -1].double()
    o = (torch.cumsum(tot, dim=1) - tot) - cseg[:, :1, :, 0].double()
    x = cseg + (o - torch.floor(o)).float()[..., None]
    theta = (2.0 * math.pi) * (x - torch.floor(x))
    ap = _edge(amps.float())[..., None]
    amp = ap[:, :-2] * w[0] + ap[:, 1:-1] * w[1] + ap[:, 2:] * w[2]
    return ((torch.sin(theta) * amp).sum(dim=2) / nh).reshape(n, lf * seg, 1)


def harmonic_source_formants_cuda(formants: torch.Tensor, amps: torch.Tensor,
                                  sample_rate: int = 16_000, seg: int = 320) -> torch.Tensor:
    """The kernel launch."""
    f = (formants.float() / sample_rate).contiguous()
    a = amps.float().contiguous()
    _lib.require(f, "formants", (torch.float32,), 3)
    _lib.require(a, "amps", (torch.float32,), 3)
    n, lf, nh = f.shape
    if a.shape != f.shape or not 1 <= nh <= 256:
        raise ValueError(f"amps {tuple(a.shape)} does not match formants {tuple(f.shape)} (NH <= 256)")
    w, ws = _tables(seg, f.device)
    out = torch.empty((n, lf * seg, 1), dtype=torch.float32, device=f.device)
    fn = _lib.function("oscillator", "osc_formant_f32", "pppppiiiip")
    rc = fn(f.data_ptr(), a.data_ptr(), w.data_ptr(), ws.data_ptr(), out.data_ptr(),
            n, lf, nh, seg, _lib.stream_of(f))
    _lib.check(rc, "osc_formant_f32")
    _lib.LAUNCHES["oscillator_formants"] += 1
    return out


def harmonic_source_formants(formants: torch.Tensor, amps: torch.Tensor,
                             sample_rate: int = 16_000, seg: int = 320) -> torch.Tensor:
    """Full-formant harmonic source: the kernel on CUDA tensors, the plain
    version on CPU tensors."""
    if _lib.route(formants) == "cuda":
        return harmonic_source_formants_cuda(formants, amps, sample_rate, seg)
    return harmonic_source_formants_plain(formants, amps, sample_rate, seg)
