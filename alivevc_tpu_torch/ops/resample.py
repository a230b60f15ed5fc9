"""Polyphase windowed-sinc resampler (torchaudio.functional.resample semantics).

The reference resamples with torchaudio's ``sinc_interp_hann`` method at every
audio boundary (module/dataset.py:27, inference.py:91, module/common.py:134,
realtime_inference.py:146).  After reducing the rate pair by their gcd to
(orig, new), each of the ``new`` output phases is a windowed-sinc filter over
the input: the whole bank is one ``F.conv1d`` with ``new`` output channels at
stride ``orig``, whose output channels interleave into the resampled signal.
The same arithmetic as the JAX package's ``ops/resample.py``, whose bank this
module builds the same way in numpy.

Defaults mirror torchaudio: lowpass_filter_width=6, rolloff=0.99, Hann window.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from alivevc_tpu_torch.device import cached, float32_math

# the filter banks on each device, uploaded at first use: a later call makes
# no host copy, so it neither waits on the device nor breaks a graph capture
_BANKS: dict = {}


@functools.lru_cache(maxsize=None)
def resample_kernel_np(orig_freq: int, new_freq: int, lowpass_filter_width: int = 6,
                       rolloff: float = 0.99):
    """The polyphase filter bank (kernels [new_freq, 2 width + orig_freq]
    float32, width): output phase p of block t reads input samples
    [t orig_freq - width, t orig_freq + width + orig_freq)."""
    base_freq = min(orig_freq, new_freq) * rolloff
    width = int(math.ceil(lowpass_filter_width * orig_freq / base_freq))
    idx = np.arange(-width, width + orig_freq, dtype=np.float64) / orig_freq
    t = np.arange(0, -new_freq, -1, dtype=np.float64)[:, None] / new_freq + idx[None, :]
    t = np.clip(t * base_freq, -lowpass_filter_width, lowpass_filter_width)
    window = np.cos(t * math.pi / lowpass_filter_width / 2.0) ** 2
    tpi = t * math.pi
    kernels = np.where(tpi == 0.0, 1.0, np.sin(tpi) / np.where(tpi == 0.0, 1.0, tpi))
    kernels = kernels * window * (base_freq / orig_freq)
    return kernels.astype(np.float32), width


def resample(x: torch.Tensor, orig_freq: int, new_freq: int, lowpass_filter_width: int = 6,
             rolloff: float = 0.99) -> torch.Tensor:
    """Resample ``x`` [..., L] from ``orig_freq`` to ``new_freq`` Hz on its
    device, in float32 (TF32 off on the card).  Output length
    ceil(new_freq L / orig_freq), as torchaudio's."""
    if orig_freq == new_freq:
        return x
    g = math.gcd(int(orig_freq), int(new_freq))
    of, nf = int(orig_freq) // g, int(new_freq) // g
    kernels, width = resample_kernel_np(of, nf, lowpass_filter_width, rolloff)
    kw = kernels.shape[1]
    batch_shape, length = x.shape[:-1], x.shape[-1]
    xf = x.reshape(-1, 1, length).float()
    target_length = int(math.ceil(nf * length / of))
    num_blocks = (target_length + nf - 1) // nf
    # pad so that every block has its whole filter support
    pad_right = width + of + max(0, (num_blocks - 1) * of + kw - (length + 2 * width + of))
    xp = F.pad(xf, (width, pad_right))
    weight = cached(_BANKS, (of, nf, lowpass_filter_width, rolloff, x.device),
                    lambda: torch.from_numpy(kernels).to(x.device)[:, None, :])   # [nf, 1, kw]
    with float32_math():
        out = F.conv1d(xp, weight, stride=of)[:, :, :num_blocks]      # [B, nf, blocks]
    out = out.transpose(1, 2).reshape(xf.shape[0], num_blocks * nf)[:, :target_length]
    return out.reshape(*batch_shape, target_length).to(x.dtype)
