"""One up level of the filter U-Net: CUDA kernels (``csrc/filter.cu``) and
their plain PyTorch version.

Replaces ``alivevc_tpu/kernels/filter_pallas.py:fused_filter_block_up``
(``_fused_impl``), which runs every up level of ``filter_unet_packed`` on
the TPU.  A level computes

    x = up_conv(x_prev + skip)           transposed conv, kernel = stride = rate
    x = input_conv(x)                    1x1
    3 x: res = x
         x = conv_c1(FiLM_c1(gelu(x)))   causal, k = 5, dilation 1 / 2 / 4,
         x = conv_c2(FiLM_c2(gelu(x))) + res        reflect head

where FiLM is ``x * scale + shift`` with scale (= linear(cond) + 1) and shift
given at frame rate and interpolated to sample rate (align_corners=False).
Tensors are channels-last; storage is float32 or bf16 and the arithmetic
float32 (the plain version rounds to the storage type at the same points as
the kernels: after the up conv, after the 1x1 conv and after every causal
conv).

Weight layouts (the JAX package's): ``up_w`` [C_in, rate*C] (column
j*C + c is tap j of output channel c), ``in_w`` [C, C] ([in, out]),
``conv_w[i]`` [k, C, C] ([tap, in, out]).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from alivevc_tpu_torch.kernels import _lib
from alivevc_tpu_torch.ops.interp import linear_interpolate

Film = Tuple[torch.Tensor, torch.Tensor]


def _mod_conv_plain(x: torch.Tensor, film: Film, w: torch.Tensor, b: torch.Tensor,
                    dilation: int, res: torch.Tensor | None = None) -> torch.Tensor:
    length = x.shape[1]
    scale, shift = film
    g = (F.gelu(x.float()) * linear_interpolate(scale.float(), length, axis=1)
         + linear_interpolate(shift.float(), length, axis=1))
    pad = (w.shape[0] - 1) * dilation
    if pad:
        g = torch.cat([g[:, 1:pad + 1].flip(1), g], dim=1)
    y = F.conv1d(g.transpose(1, 2), w.float().permute(2, 1, 0), b.float(),
                 dilation=dilation).transpose(1, 2)
    if res is not None:
        y = y + res.float()
    return y.to(x.dtype)


def filter_level_plain(x_prev, skip, up_w, up_b, in_w, in_b,
                       conv_w: Sequence[torch.Tensor], conv_b: Sequence[torch.Tensor],
                       film: Sequence[Film], rate: int, dilations: Sequence[int]) -> torch.Tensor:
    """x_prev, skip [N, L_in, C_in] -> [N, L_in * rate, C]."""
    dt = x_prev.dtype
    n, l_in, _ = x_prev.shape
    c = up_b.shape[0]
    x = ((x_prev.float() + skip.float()) @ up_w.float()).reshape(n, l_in * rate, c)
    x = (x + up_b.float()).to(dt)
    x = (x.float() @ in_w.float() + in_b.float()).to(dt)
    for i in range(0, len(conv_w), 2):
        h = _mod_conv_plain(x, film[i], conv_w[i], conv_b[i], dilations[i])
        x = _mod_conv_plain(h, film[i + 1], conv_w[i + 1], conv_b[i + 1], dilations[i + 1], res=x)
    return x


def filter_level_cuda(x_prev, skip, up_w, up_b, in_w, in_b,
                      conv_w: Sequence[torch.Tensor], conv_b: Sequence[torch.Tensor],
                      film: Sequence[Film], rate: int, dilations: Sequence[int]) -> torch.Tensor:
    """The kernel launches: 2 products for the up and input convs, then one
    gelu -> FiLM -> causal-conv kernel per conv."""
    dt = x_prev.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"filter level takes float32 or bf16, got {dt}")

    def prep(t, name, dim):
        t = t.to(dt).contiguous()
        _lib.require(t, name, (dt,), dim)
        return t

    x_prev = prep(x_prev, "x_prev", 3)
    skip = prep(skip, "skip", 3)
    if skip.shape != x_prev.shape:
        raise ValueError(f"skip {tuple(skip.shape)} != x_prev {tuple(x_prev.shape)}")
    n, l_in, c_in = x_prev.shape
    up_w, up_b = prep(up_w, "up_w", 2), prep(up_b, "up_b", 1)
    in_w, in_b = prep(in_w, "in_w", 2), prep(in_b, "in_b", 1)
    c = up_b.shape[0]
    length = l_in * rate
    if up_w.shape != (c_in, rate * c) or in_w.shape != (c, c) or c % 8:
        raise ValueError("filter level weights do not match the level's shapes")
    frames = film[0][0].shape[1]
    r = length // frames
    if r * frames != length:
        raise ValueError(f"level length {length} is not a multiple of {frames} frames")
    bf16 = int(dt == torch.bfloat16)
    stream = _lib.stream_of(x_prev)
    gemm = _lib.function("filter", "filter_gemm_bias", "pppppliiiip")
    conv = _lib.function("filter", "filter_res_conv", "pppppppiiiiiiiip")

    up = torch.empty((n, length, c), dtype=dt, device=x_prev.device)
    _lib.check(gemm(x_prev.data_ptr(), skip.data_ptr(), up_w.data_ptr(), up_b.data_ptr(),
                    up.data_ptr(), n * l_in, c_in, rate * c, c, bf16, stream), "up conv")
    x = torch.empty_like(up)
    _lib.check(gemm(up.data_ptr(), None, in_w.data_ptr(), in_b.data_ptr(), x.data_ptr(),
                    n * length, c, c, c, bf16, stream), "input conv")
    h = x
    for i, (w, b, (scale, shift), d) in enumerate(zip(conv_w, conv_b, film, dilations)):
        w, b = prep(w, "conv_w", 3), prep(b, "conv_b", 1)
        scale, shift = prep(scale, "scale", 3), prep(shift, "shift", 3)
        if w.shape[1:] != (c, c) or scale.shape != (n, frames, c) or shift.shape != scale.shape:
            raise ValueError("causal conv weights or FiLM do not match the level's shapes")
        # the first conv of a block reads x; the second reads its output h
        # and adds the block's input x as the residual
        second = i % 2 == 1
        out = torch.empty_like(x)
        rc = conv((h if second else x).data_ptr(), w.data_ptr(), b.data_ptr(),
                  scale.data_ptr(), shift.data_ptr(), x.data_ptr() if second else None,
                  out.data_ptr(), n, length, c, frames, r, w.shape[0], d, bf16, stream)
        _lib.check(rc, "causal conv")
        if second:
            x = out
        else:
            h = out
    _lib.LAUNCHES["filter_level"] += 1
    return x


def filter_level(x_prev, skip, up_w, up_b, in_w, in_b, conv_w, conv_b, film, rate,
                 dilations) -> torch.Tensor:
    """One up level: the kernels on CUDA tensors, the plain version on CPU
    tensors."""
    fn = filter_level_cuda if _lib.route(x_prev) == "cuda" else filter_level_plain
    return fn(x_prev, skip, up_w, up_b, in_w, in_b, conv_w, conv_b, film, rate, dilations)
