"""STFT magnitude front end: CUDA kernel (``csrc/stft.cu``) and its plain
PyTorch version.

Replaces ``alivevc_tpu/kernels/stft_pallas.py:stft_magnitude_pallas``: a
rectangular window, n_fft 1280, centre reflect pad, 641 bins, in float32
whatever the input dtype.

The kernel is a shared-memory real FFT per frame, bound by bytes (it reads
x once and writes the magnitudes): each 1280-point frame is a 640-point
complex FFT of its even/odd samples, in the Stockham stages of
``FFT_RADICES``, followed by the real-FFT split step.  It reads the reflect
pad by index arithmetic, so no padded copy of x is made.  The twiddle table
(``fft_twiddles``) is computed here once in float64 and cached per device.
The plain version is the dense DFT product of ``ops/stft.py``.

Gradients (training): ``stft_magnitude`` on the card runs through
``StftMagnitudeFunction``, whose backward differentiates the plain version
recomputed on the saved input (the content loss differentiates the
spectrogram of the decoder's output).
"""

from __future__ import annotations

import functools
from typing import Dict

import numpy as np
import torch

from alivevc_tpu_torch.device import cached
from alivevc_tpu_torch.kernels import _lib
from alivevc_tpu_torch.ops.stft import stft_magnitude as _stft_plain

N_FFT = 1280                     # the kernel's frame length
FFT_RADICES = (5, 8, 16)         # csrc/stft.cu's stages of the 640-point FFT
_TWIDDLES: Dict[str, torch.Tensor] = {}


@functools.lru_cache(maxsize=None)
def fft_twiddles_np() -> np.ndarray:
    """e^{-2 pi i t / 1280} for t < 1280, computed in float64, as float32
    (re, im) pairs [1280, 2]: the FFT stages' twiddles (even t) and the
    split step's."""
    ang = -2.0 * np.pi * np.arange(N_FFT, dtype=np.float64) / N_FFT
    return np.stack([np.cos(ang), np.sin(ang)], axis=1).astype(np.float32)


def fft_twiddles(device) -> torch.Tensor:
    return cached(_TWIDDLES, str(torch.device(device)),
                  lambda: torch.from_numpy(fft_twiddles_np()).to(device))


def stft_magnitude_plain(x: torch.Tensor, n_fft: int = 1280, hop_length: int = 320) -> torch.Tensor:
    """x [N, L] -> [N, 1 + L//hop, n_fft//2 + 1] float32 (rect window,
    centre reflect pad): frames @ cos/sin basis, then the magnitude."""
    return _stft_plain(x, n_fft, hop_length)


def stft_magnitude_cuda(x: torch.Tensor, n_fft: int = 1280, hop_length: int = 320) -> torch.Tensor:
    """The kernel launch: x [N, L] float32 on the card, L > 640."""
    _lib.refuse_grad("stft_magnitude_cuda", x)
    _lib.require(x, "x", (torch.float32,), 2)
    if n_fft != N_FFT:
        raise ValueError(f"the kernel computes n_fft={N_FFT}, not {n_fft}")
    if not 1 <= hop_length <= N_FFT:
        raise ValueError(f"hop_length={hop_length} must be in [1, {N_FFT}]")
    n, length = x.shape
    if length <= N_FFT // 2:
        raise ValueError(f"reflect padding by {N_FFT // 2} needs L > {N_FFT // 2}, got {length}")
    t = length // hop_length + 1
    out = torch.empty((n, t, N_FFT // 2 + 1), dtype=torch.float32, device=x.device)
    fn = _lib.function("stft", "stft_fft_mag_f32", "pppiiiip")
    rc = fn(x.data_ptr(), fft_twiddles(x.device).data_ptr(), out.data_ptr(), n, length, t,
            hop_length, _lib.stream_of(x))
    _lib.check(rc, "stft_fft_mag_f32")
    _lib.LAUNCHES["stft"] += 1
    return out


class StftMagnitudeFunction(torch.autograd.Function):
    """The STFT magnitude on the card with a gradient: forward = the kernel,
    backward = autograd of ``stft_magnitude_plain`` recomputed on the saved
    input."""

    @staticmethod
    def forward(ctx, x, n_fft, hop_length):
        ctx.n_fft, ctx.hop_length = n_fft, hop_length
        ctx.save_for_backward(x)
        return stft_magnitude_cuda(x, n_fft, hop_length)

    @staticmethod
    def backward(ctx, grad_out):
        plain = lambda x: stft_magnitude_plain(x, ctx.n_fft, ctx.hop_length)  # noqa: E731
        return (*_lib.plain_vjp(plain, ctx.saved_tensors, ctx.needs_input_grad[:1], grad_out),
                None, None)


def stft_magnitude(x: torch.Tensor, n_fft: int = 1280, hop_length: int = 320) -> torch.Tensor:
    """Magnitude STFT, upcast to float32 as the JAX kernel does: the kernel
    (with a gradient, ``StftMagnitudeFunction``) on a CUDA tensor, the plain
    version on a CPU tensor."""
    x = x.float().contiguous()
    if _lib.route(x) == "cuda":
        return StftMagnitudeFunction.apply(x, n_fft, hop_length)
    return stft_magnitude_plain(x, n_fft, hop_length)
