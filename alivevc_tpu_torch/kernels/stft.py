"""STFT magnitude front end: CUDA kernel (``csrc/stft.cu``) and its plain
PyTorch version.

Replaces ``alivevc_tpu/kernels/stft_pallas.py:stft_magnitude_pallas``.  The
reflect pad stays a ``F.pad`` in the wrapper, as it is host-side in JAX;
framing, the DFT products and the magnitude run in the kernel, in float32
whatever the input dtype.
"""

from __future__ import annotations

import torch

from alivevc_tpu_torch.kernels import _lib
from alivevc_tpu_torch.ops.stft import dft_basis, reflect_pad
from alivevc_tpu_torch.ops.stft import stft_magnitude as _stft_plain


def stft_magnitude_plain(x: torch.Tensor, n_fft: int = 1280, hop_length: int = 320) -> torch.Tensor:
    """x [N, L] -> [N, 1 + L//hop, n_fft//2 + 1] float32 (rect window,
    centre reflect pad): frames @ cos/sin basis, then the magnitude."""
    return _stft_plain(x, n_fft, hop_length)


def stft_magnitude_cuda(x: torch.Tensor, n_fft: int = 1280, hop_length: int = 320) -> torch.Tensor:
    """The kernel launch: x [N, L] float32 on the card."""
    _lib.require(x, "x", (torch.float32,), 2)
    if n_fft % 16 or n_fft // 2 >= x.shape[1]:
        raise ValueError(f"n_fft={n_fft} must be a multiple of 16 and < 2*L")
    n, length = x.shape
    xp = reflect_pad(x, n_fft // 2).contiguous()
    t = length // hop_length + 1
    if -(-n * t // 64) > 65535:    # frame tiles ride gridDim.y
        raise ValueError(f"{n * t} frames exceed one launch; split the batch")
    nbins = n_fft // 2 + 1
    cos_b, sin_b = dft_basis(n_fft, "rect", n_fft, x.device)
    out = torch.empty((n, t, nbins), dtype=torch.float32, device=x.device)
    fn = _lib.function("stft", "stft_mag_f32", "ppppiiiiiip")
    rc = fn(xp.data_ptr(), cos_b.data_ptr(), sin_b.data_ptr(), out.data_ptr(),
            n, xp.shape[1], t, n_fft, hop_length, nbins, _lib.stream_of(x))
    _lib.check(rc, "stft_mag_f32")
    _lib.LAUNCHES["stft"] += 1
    return out


def stft_magnitude(x: torch.Tensor, n_fft: int = 1280, hop_length: int = 320) -> torch.Tensor:
    """Magnitude STFT, upcast to float32 as the JAX kernel does: the kernel
    on a CUDA tensor, the plain version on a CPU tensor."""
    x = x.float().contiguous()
    if _lib.route(x) == "cuda":
        return stft_magnitude_cuda(x, n_fft, hop_length)
    return stft_magnitude_plain(x, n_fft, hop_length)
