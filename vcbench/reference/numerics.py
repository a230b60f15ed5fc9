"""Where the reference rounds: every product's operands pass through a
``Math``, which is exact float32 for the reference itself and rounds to a
lower type for the controls (float32 accumulation throughout, TF32 off).

  * ``fp32``: the operands as they are.
  * ``tf32``: each operand rounded to TF32 (10 mantissa bits, nearest), the
    tensor cores' float32 mode.
  * ``bf16``: each operand rounded to bfloat16.
  * ``fp8``: each operand scaled so that its largest magnitude is 448,
    rounded to float8 e4m3, scaled back (per-tensor scaling, as fp8
    products are run).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

MODES = ("fp32", "tf32", "bf16", "fp8")
E4M3_MAX = 448.0


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    amax = x.abs().max()
    scale = torch.where(amax > 0, E4M3_MAX / amax, torch.ones_like(amax))
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


class Math:
    """Products whose operands are rounded to ``mode`` first."""

    def __init__(self, mode: str = "fp32"):
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}")
        self.mode = mode

    def r(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if self.mode == "tf32":
            return tf32_round(x)
        if self.mode == "bf16":
            return x.to(torch.bfloat16).float()
        if self.mode == "fp8":
            return fp8_round(x)
        return x

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.r(a) @ self.r(b)

    def conv1d(self, x: torch.Tensor, w: torch.Tensor, b=None, **kw) -> torch.Tensor:
        """x [N, T, Cin] channels-last, w [Cout, Cin/groups, k]."""
        y = F.conv1d(self.r(x).transpose(1, 2), self.r(w), None if b is None else b.float(), **kw)
        return y.transpose(1, 2)


@contextlib.contextmanager
def exact_float32():
    """TF32 off for products and convolutions while the reference runs."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
