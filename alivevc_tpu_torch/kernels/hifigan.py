"""One dilated conv of a HiFi-GAN ResBlock1 stack with its elementwise work:
CUDA kernel (``csrc/hifigan.cu``) and its plain PyTorch version.

The function, channels last ([N, T, C] float32 throughout)::

    y = conv1d(leaky_relu(x, slope)) + bias          # 'same' zero padding, dilation d
    y = res + y                                      # the second conv of a pair
    stack sum s of n: y (s = 0), acc + y, (acc + y) / n (s = n - 1)

which is ``models/hifigan.py``'s ResBlock1 pair and stack mean, written as
one call a conv.  The kernel replaces no TPU kernel: it replaces cuDNN's
float32 convolutions of the kNN-VC vocoder and the leaky ReLU, residual
and stack passes around them.  Its products are 3xTF32 on wgmma (float32
accuracy, another summation order than cuDNN's); the plain version is
today's composition on PyTorch's own convolution, and the route for CPU
tensors.  On the card the weights go in as TF32 hi and lo planes, K-major
[C_out][(tap, C_in)], split once a vocoder (``weight_planes``, cached on
the conv module and keyed on its weight tensor and the tensor's version,
so a weight changed in place is split again).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from alivevc_tpu_torch.kernels import _lib

CHUNK = 32          # input channels a K chunk (csrc/hifigan.cu)
MAX_STAGES = 4      # weight ring depth, at most
MAX_ROWS = 256      # rows of a TMA box: tile rows plus the taps' halo

Stack = Optional[Tuple[int, int]]   # (this stack, stacks) for a stack's last conv


def split_tf32(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 -> (hi, lo), both TF32 values held as float32 (the low 13
    mantissa bits zero): hi rounds w to nearest with ties away from zero,
    as ``cvt.rna.tf32.f32`` does, and lo rounds w - hi the same way."""
    def rna(x: torch.Tensor) -> torch.Tensor:
        return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)

    w = w.float().contiguous()
    hi = rna(w)
    return hi, rna(w - hi)


def weight_planes(conv: nn.Conv1d) -> Tuple[torch.Tensor, torch.Tensor]:
    """``conv``'s weight [C_out, C_in, k] K-major, [C_out, k * C_in], as TF32
    hi and lo planes: computed once and kept on the module until its weight
    is another tensor, holds other storage (``module.to`` swaps a
    parameter's data) or is changed in place (its version moves)."""
    w = conv.weight
    key = (w._version, w.data_ptr())
    kept = getattr(conv, "_tf32_planes", None)
    if kept is None or kept[0] is not w or kept[1] != key:
        with torch.no_grad():
            hi, lo = split_tf32(w.detach().permute(0, 2, 1).reshape(w.shape[0], -1))
        kept = (w, key, hi, lo)
        conv._tf32_planes = kept
    return kept[2], kept[3]


def hifigan_conv_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, dilation: int, slope: float,
                       res: Optional[torch.Tensor] = None, acc: Optional[torch.Tensor] = None,
                       stack: Stack = None) -> torch.Tensor:
    """x [N, T, C] -> [N, T, C]: ``F.conv1d`` of ``leaky_relu(x, slope)``
    (weight [C, C, k], odd k, 'same' zero padding at ``dilation``) + bias,
    + ``res`` where given; with ``stack`` = (s, n) the stack sum: the value
    (s = 0), ``acc`` + it, and for s = n - 1 that sum / n.  Past the first
    stack the sum is accumulated into ``acc`` in place (and returned), as
    the kernel does.  The conv runs on the channels-first layout PyTorch's
    convolutions take."""
    k = weight.shape[-1]
    xt = F.leaky_relu(x, slope).transpose(1, 2).contiguous()
    y = F.conv1d(xt, weight, bias, padding=(k - 1) * dilation // 2, dilation=dilation).transpose(1, 2)
    if res is not None:
        y = res + y
    if stack is not None:
        s, n = stack
        if s > 0:
            y = acc.add_(y)
        if s == n - 1:
            y = y.div_(n)
    return y


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def conv_plan(n: int, length: int, c: int, taps: int, dilation: int, sms: int) -> Tuple[int, int, int]:
    """(tn, wgs, stages) of one launch: output columns a tile (C up to
    128), warpgroups a block (64 rows each: two where the tiles of 128 rows
    fill the card, else one, for twice the blocks), and the depth of the
    weight ring (the steps a tile has, chunks x taps, up to 4)."""
    tn = min(c, 128)
    tiles_128 = n * -(-length // 128) * (c // tn)
    wgs = 2 if tiles_128 >= sms and 128 + (taps - 1) * dilation <= MAX_ROWS else 1
    return tn, wgs, min(MAX_STAGES, c // CHUNK * taps)


def hifigan_conv_cuda(x: torch.Tensor, w_hi: torch.Tensor, w_lo: torch.Tensor, bias: torch.Tensor, taps: int,
                      dilation: int, slope: float, res: Optional[torch.Tensor] = None,
                      acc: Optional[torch.Tensor] = None, stack: Stack = None) -> torch.Tensor:
    """The kernel launch: the function of ``hifigan_conv_plain`` with the
    weights as ``weight_planes`` gives them ([C, taps * C] hi and lo).  A
    stack's sum past its first stack is accumulated into ``acc`` in place
    (and returned).  C a multiple of 32, at most 256."""
    _lib.refuse_grad("hifigan_conv_cuda", x, w_hi, w_lo, bias, res, acc)
    _lib.require(x, "x", (torch.float32,), 3)
    n, length, c = x.shape
    if c % CHUNK or not CHUNK <= c <= 256:
        raise ValueError(f"the kernel takes C a multiple of {CHUNK} up to 256, got {c}")
    if taps % 2 == 0:
        raise ValueError(f"a 'same' conv needs odd taps, got {taps}")
    for name, t in (("w_hi", w_hi), ("w_lo", w_lo)):
        _lib.require(t, name, (torch.float32,), 2)
        if tuple(t.shape) != (c, taps * c):
            raise ValueError(f"{name} must be [{c}, {taps * c}], got {tuple(t.shape)}")
    _lib.require(bias, "bias", (torch.float32,), 1)
    if bias.shape[0] != c:
        raise ValueError(f"bias must have {c} values, got {bias.shape[0]}")
    if res is not None:
        _lib.require(res, "res", (torch.float32,), 3)
        if res.shape != x.shape:
            raise ValueError(f"res must be {tuple(x.shape)}, got {tuple(res.shape)}")
    s, stacks = stack if stack is not None else (-1, 1)
    if not -1 <= s < stacks:
        raise ValueError(f"stack {stack} is not one of its stacks")
    if s > 0:
        _lib.require(acc, "acc", (torch.float32,), 3)
        if acc.shape != x.shape:
            raise ValueError(f"acc must be {tuple(x.shape)}, got {tuple(acc.shape)}")
        out = acc
    else:
        out = torch.empty_like(x)
    tn, wgs, stages = conv_plan(n, length, c, taps, dilation, sm_count(x.get_device()))
    fn = _lib.function("hifigan", "hifigan_conv", "p" * 6 + "i" * 5 + "f" + "i" * 5 + "p")
    rc = fn(x.data_ptr(), w_hi.data_ptr(), w_lo.data_ptr(), bias.data_ptr(),
            None if res is None else res.data_ptr(), out.data_ptr(), n, length, c, taps, dilation, slope,
            s, stacks, tn, wgs, stages, _lib.stream_of(x))
    _lib.check(rc, "hifigan_conv")
    _lib.LAUNCHES["hifigan_conv"] += 1
    return out


def hifigan_conv(x: torch.Tensor, conv: nn.Conv1d, slope: float, res: Optional[torch.Tensor] = None,
                 acc: Optional[torch.Tensor] = None, stack: Stack = None) -> torch.Tensor:
    """One ResBlock1 conv of ``conv`` (an ``nn.Conv1d`` of C to C channels,
    odd taps, its dilation) on x [N, T, C]: the kernel on a CUDA tensor, the
    plain version on a CPU tensor; on both, a stack's sum past its first
    stack is accumulated into ``acc`` in place."""
    if _lib.route(x) == "cuda":
        hi, lo = weight_planes(conv)
        return hifigan_conv_cuda(x, hi, lo, conv.bias, conv.kernel_size[0], conv.dilation[0], slope, res, acc,
                                 stack)
    return hifigan_conv_plain(x, conv.weight, conv.bias, conv.dilation[0], slope, res, acc, stack)
