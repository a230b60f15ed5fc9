"""Device resolution for the port's entry points.

The port runs on the card.  ``None`` means CUDA, and a missing CUDA device
is an error, not a reason to run elsewhere: the CPU is used only when a
caller asks for it by name (``device="cpu"``), as the tests do.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@contextlib.contextmanager
def float32_math():
    """Full float32 products and convolutions for the fp32 mode.

    cuDNN convolutions run in TF32 by default on the card
    (``torch.backends.cudnn.allow_tf32`` is True), which keeps about three
    decimal digits; the fp32 mode turns TF32 off for both convolutions and
    matrix products while it runs, and restores the flags after."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def cached(cache: dict, key, make: Callable):
    """``cache[key]``, made by ``make()`` on first use: the port's tables of
    device tensors (interpolation weights, DFT basis, twiddles), which a
    CUDA graph needs to find on the card without a host copy.  Only plain
    tensors are stored: while ``torch.export`` traces, ``make()`` returns
    fakes that stand for shapes, and a fake left in the cache would be what
    every later eager call computes with.  A stored tensor that tracing
    reads becomes a constant of the traced program."""
    value = cache.get(key)
    if value is None:
        value = make()
        parts = value if isinstance(value, (tuple, list)) else (value,)
        if all(type(t) is torch.Tensor for t in parts):
            cache[key] = value
    return value
