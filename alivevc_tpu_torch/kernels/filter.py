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
float32.  The plain version rounds to the storage type where the kernels do
(each a no-op in float32):
  1. the sum ``x_prev + skip`` (the up conv's operand);
  2. the up conv's output;
  3. the 1x1 conv's output;
  4. each causal conv's operand ``gelu(x) * scale + shift``;
  5. each causal conv's output, and on the second conv of a block its sum
     with the block's input (the JAX kernel rounds at the same two points).

Weight layouts (the JAX package's): ``up_w`` [C_in, rate*C] (column
j*C + c is tap j of output channel c), ``in_w`` [C, C] ([in, out]),
``conv_w[i]`` [k, C, C] ([tap, in, out]).  ``film`` is one frame-rate tensor
[N, F, 2 * n_conv * C]: columns [2 i C, (2 i + 1) C) hold the scale of conv i
(the +1 included), the next C columns its shift
(``models/decoder.py:level_args``).

Routes on the card (``filter_level_cuda``): a level with C = 8 or 16 runs as
one launch of ``filter_narrow_kernel`` (up conv, 1x1 and the six convs in
shared memory; each time tile recomputes its lookback, and a tile that
reaches sample 0 reflects in place); any other level as 8 launches of
``filter_wide_kernel`` (the up conv and the 1x1 as products, then one
implicit GEMM per causal conv).  Every product runs on the tensor cores:
bf16 operands with float32 accumulation in bf16 storage, 3xTF32 in float32
storage.  ``filter_level_tiled`` replays the narrow kernel's tiling, and
optionally its 3xTF32 products, on the CPU for the tests.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch
import torch.nn.functional as F

from alivevc_tpu_torch.kernels import _lib
from alivevc_tpu_torch.kernels.knn import tf32_round
from alivevc_tpu_torch.ops.interp import linear_interpolate

NARROW_C = (8, 16)     # channel counts of the one-launch kernel (csrc/filter.cu)
NARROW_ROWS = 256      # csrc/filter.cu ROWS_CAP: rows a narrow tile holds, lookback included
NARROW_MAX_CIN = 128   # up-conv input channels the narrow kernel's shared memory takes
NARROW_MAX_RATE = 8
MAX_CONV = 8
MAX_TAPS = 7
MAX_HALO = 24          # (k - 1) * dilation of one causal conv, at most


def film_of(film: torch.Tensor, i: int, c: int):
    """(scale, shift) [N, F, C] of causal conv ``i`` in the level's FiLM tensor."""
    return film[..., 2 * i * c:(2 * i + 1) * c], film[..., (2 * i + 1) * c:(2 * i + 2) * c]


def lookback(k: int, dilations: Sequence[int]) -> int:
    """Samples of history the level's causal convs read together: 56 for
    k = 5 and dilations (1, 1, 2, 2, 4, 4)."""
    return sum((k - 1) * d for d in dilations)


def narrow_tile(k: int, dilations: Sequence[int], rate: int) -> int:
    """Output samples a narrow-kernel tile writes: the tile's rows less the
    lookback and the up conv's alignment (199 at the default levels)."""
    return NARROW_ROWS - lookback(k, dilations) - (rate - 1)


def _gelu_film(x, film, i, c, length, dt):
    """Operand of causal conv ``i``: gelu(x) * scale + shift, rounded to ``dt``
    (rounding point 4)."""
    scale, shift = film_of(film, i, c)
    g = (F.gelu(x.float()) * linear_interpolate(scale.float(), length, axis=1)
         + linear_interpolate(shift.float(), length, axis=1))
    return g.to(dt).float()


def _causal_conv_plain(g, w, b, dilation):
    pad = (w.shape[0] - 1) * dilation
    if pad:
        g = torch.cat([g[:, 1:pad + 1].flip(1), g], dim=1)
    return F.conv1d(g.transpose(1, 2), w.float().permute(2, 1, 0), b.float(),
                    dilation=dilation).transpose(1, 2)


def filter_level_plain(x_prev, skip, up_w, up_b, in_w, in_b,
                       conv_w: Sequence[torch.Tensor], conv_b: Sequence[torch.Tensor],
                       film: torch.Tensor, rate: int, dilations: Sequence[int]) -> torch.Tensor:
    """x_prev, skip [N, L_in, C_in] -> [N, L_in * rate, C]."""
    dt = x_prev.dtype
    n, l_in, _ = x_prev.shape
    c = up_b.shape[0]
    length = l_in * rate
    xs = (x_prev.float() + skip.float()).to(dt)
    x = (xs.float() @ up_w.float()).reshape(n, length, c)
    x = (x + up_b.float()).to(dt)
    x = (x.float() @ in_w.float() + in_b.float()).to(dt)
    for i in range(0, len(conv_w), 2):
        g = _gelu_film(x, film, i, c, length, dt)
        h = _causal_conv_plain(g, conv_w[i], conv_b[i], dilations[i]).to(dt)
        g = _gelu_film(h, film, i + 1, c, length, dt)
        y = _causal_conv_plain(g, conv_w[i + 1], conv_b[i + 1], dilations[i + 1]).to(dt)
        x = (y.float() + x.float()).to(dt)
    return x


def product_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of float32 operands as the kernels form it in float32 storage:
    hi = tf32(v), lo = tf32(v - hi) of both operands, lo.hi + hi.lo + hi.hi
    summed in float32 (``kernels/knn.py:tf32_round`` is the rounding)."""
    ah, bh = tf32_round(a), tf32_round(b)
    al, bl = tf32_round(a.float() - ah), tf32_round(b.float() - bh)
    return al @ bh + ah @ bl + ah @ bh


def filter_level_tiled(x_prev, skip, up_w, up_b, in_w, in_b, conv_w, conv_b, film: torch.Tensor,
                       rate: int, dilations: Sequence[int], tile: int,
                       products: str = "exact", compute: torch.dtype = torch.float32) -> torch.Tensor:
    """The narrow kernel's tiling, replayed on the CPU (tests only).  Each
    tile of ``tile`` output samples computes the whole level over the rows
    [b0, t0 + tile), b0 = max(0, t0 - lookback) rounded down to a multiple
    of ``rate``: rows the lookback holds wrongly (their history is cut) feed
    only rows that the tile does not write.  A tile whose rows start at
    sample 0 reflects each conv's head in place.  ``products`` is 'exact'
    (products in ``compute``) or '3xtf32' (the float32 kernels' split);
    roundings to the storage type are those of ``filter_level_plain``."""
    dt = x_prev.dtype
    n, l_in, _ = x_prev.shape
    c = up_b.shape[0]
    length = l_in * rate
    k = conv_w[0].shape[0]
    lb = lookback(k, dilations)

    def prod(a, b):
        if products == "3xtf32":
            return product_3xtf32(a.float(), b.float()).to(compute)
        return a.to(compute) @ b.to(compute)

    def rnd(v):
        return v.to(dt).to(compute)

    scales = [linear_interpolate(film_of(film, i, c)[0].to(compute), length, axis=1)
              for i in range(len(conv_w))]
    shifts = [linear_interpolate(film_of(film, i, c)[1].to(compute), length, axis=1)
              for i in range(len(conv_w))]
    out = torch.empty((n, length, c), dtype=dt)
    for t0 in range(0, length, tile):
        b0 = max(0, t0 - lb) // rate * rate
        e = min(t0 + tile, length)
        q0, q1 = b0 // rate, -(-e // rate)
        xs = rnd(x_prev[:, q0:q1].to(compute) + skip[:, q0:q1].to(compute))
        x = prod(xs.reshape(-1, xs.shape[2]), up_w).reshape(n, (q1 - q0) * rate, c)[:, :e - b0]
        x = rnd(x + up_b.to(compute))
        x = rnd(prod(x.reshape(-1, c), in_w).reshape(x.shape) + in_b.to(compute))
        rows = torch.arange(e - b0)
        for i, (w, b, d) in enumerate(zip(conv_w, conv_b, dilations)):
            src = x if i % 2 == 0 else h
            g = rnd(F.gelu(src) * scales[i][:, b0:e] + shifts[i][:, b0:e])
            cols = []
            for j in range(k):
                idx = rows - (k - 1 - j) * d
                # reflect at sample 0, or (rows the tile does not keep) clamp
                idx = idx.abs() if b0 == 0 else idx.clamp(min=0)
                cols.append(g[:, idx])
            y = prod(torch.cat(cols, dim=2).reshape(-1, k * c), w.reshape(k * c, c))
            y = y.reshape(n, e - b0, c) + b.to(compute)
            if i % 2 == 0:
                h = rnd(y)
            else:
                x = rnd(rnd(y) + x)
        out[:, t0:e] = x[:, t0 - b0:].to(dt)
    return out


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """The kernels read 16-byte vectors: a view that starts off 16 bytes is copied."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def filter_level_cuda(x_prev, skip, up_w, up_b, in_w, in_b,
                      conv_w: Sequence[torch.Tensor], conv_b: Sequence[torch.Tensor],
                      film: torch.Tensor, rate: int, dilations: Sequence[int]) -> torch.Tensor:
    """The kernel launches: one ``filter_narrow_kernel`` for C = 8 or 16,
    else 8 ``filter_wide_kernel`` launches (up conv, 1x1, six causal convs)."""
    dt = x_prev.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"filter level takes float32 or bf16, got {dt}")

    def prep(t, name, dim):
        t = _aligned(t.to(dt).contiguous())
        _lib.require(t, name, (dt,), dim)
        return t

    x_prev = prep(x_prev, "x_prev", 3)
    skip = prep(skip, "skip", 3)
    if skip.shape != x_prev.shape:
        raise ValueError(f"skip {tuple(skip.shape)} != x_prev {tuple(x_prev.shape)}")
    n, l_in, c_in = x_prev.shape
    up_w, up_b = prep(up_w, "up_w", 2), prep(up_b, "up_b", 1)
    in_b = prep(in_b, "in_b", 1)
    c = up_b.shape[0]
    length = l_in * rate
    n_conv = len(conv_w)
    if (up_w.shape != (c_in, rate * c) or in_w.shape != (c, c) or c % 8 or c_in % 8
            or n_conv % 2 or not 0 < n_conv <= MAX_CONV
            or len(conv_b) != n_conv or len(dilations) != n_conv):
        raise ValueError("filter level weights do not match the level's shapes")
    in_w_t = prep(in_w.t(), "in_w", 2)   # [out, in], the Linear's own layout
    conv_b = [prep(b, "conv_b", 1) for b in conv_b]
    k = conv_w[0].shape[0]
    if any(w.shape != (k, c, c) for w in conv_w) or any(b.shape != (c,) for b in conv_b):
        raise ValueError("causal conv weights do not match the level's shapes")
    if k > MAX_TAPS or any(d < 1 or (k - 1) * d > MAX_HALO or length <= (k - 1) * d
                           for d in dilations):
        raise ValueError(f"causal convs of k={k}, dilations {list(dilations)} over {length} "
                         f"samples: need k <= {MAX_TAPS}, (k-1)*d <= {MAX_HALO} < L")
    film = prep(film, "film", 3)
    frames = film.shape[1]
    if film.shape != (n, frames, 2 * n_conv * c) or frames < 1 or length % frames:
        raise ValueError(f"film {tuple(film.shape)} does not match [{n}, F, {2 * n_conv * c}] "
                         f"with F dividing the level's {length} samples")
    bf16 = int(dt == torch.bfloat16)
    stream = _lib.stream_of(x_prev)
    narrow = (c in NARROW_C and c_in <= NARROW_MAX_CIN and rate <= NARROW_MAX_RATE
              and narrow_tile(k, dilations, rate) >= 32)
    if narrow:    # [out, in, tap], the Conv1d weight level_args took its view of
        conv_w = [prep(w.permute(2, 1, 0), "conv_w", 3) for w in conv_w]
    else:         # [out, tap, in], the wide kernel's streaming order
        conv_w_t = [prep(w.permute(2, 0, 1), "conv_w", 3) for w in conv_w]

    if narrow:
        fn = _lib.function("filter", "filter_narrow", "p" * 10 + "ii" + "p" + "i" * 7 + "p")
        ws = (ctypes.c_void_p * n_conv)(*[w.data_ptr() for w in conv_w])
        bs = (ctypes.c_void_p * n_conv)(*[b.data_ptr() for b in conv_b])
        ds = (ctypes.c_int * n_conv)(*dilations)
        out = torch.empty((n, length, c), dtype=dt, device=x_prev.device)
        rc = fn(x_prev.data_ptr(), skip.data_ptr(), up_w.data_ptr(), up_b.data_ptr(),
                in_w_t.data_ptr(), in_b.data_ptr(), ctypes.addressof(ws), ctypes.addressof(bs),
                ctypes.addressof(ds), film.data_ptr(), n_conv, k, out.data_ptr(),
                n, l_in, c_in, c, rate, frames, bf16, stream)
        _lib.check(rc, "filter level (narrow kernel)")
        _lib.LAUNCHES["filter_level"] += 1
        return out

    wide = _lib.function("filter", "filter_wide", "p" * 7 + "i" * 12 + "p")

    def launch(a, a2, w, b, res, o, film_ptr, nn, rows, cin, cols, taps, d, film_off, what):
        rc = wide(a.data_ptr(), a2, w.data_ptr(), b.data_ptr(), res, o.data_ptr(), film_ptr,
                  nn, rows, cin, cols, taps, d, c, frames, length // frames, film.shape[2], film_off,
                  bf16, stream)
        _lib.check(rc, what)

    # the wide kernel streams the weights transposed, [out, (tap, in)]
    up = torch.empty((n, length, c), dtype=dt, device=x_prev.device)
    launch(x_prev, skip.data_ptr(), up_w.t().contiguous(), up_b, None, up, None, 1, n * l_in, c_in,
           rate * c, 1, 0, 0, "filter up conv")
    x = torch.empty_like(up)
    launch(up, None, in_w_t, in_b, None, x, None, 1, n * length, c, c, 1, 0, 0,
           "filter 1x1 conv")
    del up
    h = torch.empty_like(x)
    for i, (w, b, d) in enumerate(zip(conv_w_t, conv_b, dilations)):
        # the first conv of a block reads x and writes h; the second reads h
        # and adds x (the block's input) into x in place
        second = i % 2 == 1
        launch(h if second else x, None, w, b, x.data_ptr() if second else None,
               x if second else h, film.data_ptr(), n, length, c, c, k, d, 2 * i * c,
               "filter causal conv")
    _lib.LAUNCHES["filter_level"] += 1
    return x


def filter_level(x_prev, skip, up_w, up_b, in_w, in_b, conv_w, conv_b, film, rate,
                 dilations) -> torch.Tensor:
    """One up level: the kernels on CUDA tensors, the plain version on CPU
    tensors."""
    fn = filter_level_cuda if _lib.route(x_prev) == "cuda" else filter_level_plain
    return fn(x_prev, skip, up_w, up_b, in_w, in_b, conv_w, conv_b, film, rate, dilations)
