"""The yardstick: the operations and bytes of each layer's function,
computed from its shapes, and the peaks of one NVIDIA H100 SXM (NVIDIA's
data sheet, dense, at 700 W).

Each product is counted once (2 operations a multiply-add), against the
tensor-core peak of the precision contract: bf16 at 989 TFLOP/s; float32
(the exact-ranking mode, its kNN 'high' and its float32 filter levels) at
the TF32 rate, 495 TFLOP/s, the fastest that any form keeping float32
accuracy can multiply.  Each input byte is read once and each output byte
written once.  So a kernel's bound is the same whatever form it takes.
"""

from __future__ import annotations

import math
from typing import Dict

PEAK_FLOPS = {"bf16": 989e12, "tf32": 495e12}
PEAK_BYTES = 3.35e12
PEAK_OF = {"default": "bf16", "bf16": "bf16", "high": "tf32", "highest": "tf32", "fp32": "tf32", "tf32": "tf32"}
ITEM_BYTES = {"bf16": 2, "fp32": 4}


def bound_s(flops: float, nbytes: float, precision: str) -> float:
    """The least time the card could take: the larger of operations over
    the contract's peak and bytes over the memory rate."""
    return max(flops / PEAK_FLOPS[PEAK_OF[precision]], nbytes / PEAK_BYTES)


def len16(samples: int, sr: int, sr16: int = 16_000) -> int:
    """Samples at 16 kHz after resampling (ceil, as torchaudio)."""
    return int(math.ceil(samples * sr16 / sr))


def windows_cut(samples16: int, chunk: int) -> int:
    """Windows the overlap-discard driver cuts from a file: one chunk of
    padding before, four after, three-chunk windows at a one-chunk stride."""
    return (samples16 + 2 * chunk) // chunk + 1


def knn_call(queries: int, rows: int, dim: int, query_dtype: str, precision: str) -> Dict[str, float]:
    """Cosine top-k and the mean of the k rows: 2 Q R D operations; reads the
    queries and the float32 library, writes float32 features."""
    flops = 2.0 * queries * rows * dim
    nbytes = queries * dim * ITEM_BYTES[query_dtype] + rows * dim * 4 + queries * dim * 4
    return {"flops": flops, "bytes": nbytes, "bound_s": bound_s(flops, nbytes, precision)}


def filter_level_call(n: int, l_in: int, c_in: int, c: int, rate: int, taps: int, n_conv: int,
                      film_frames: int, act: str, precision: str) -> Dict[str, float]:
    """One up level of the filter U-Net: (x + skip) times the transposed
    conv's [C_in, rate C], the input pointwise conv, ``n_conv`` causal convs
    of ``taps`` taps; reads x, skip, the weights and the frame-rate FiLM
    [N, F, 2 n_conv C], writes [N, rate L_in, C]."""
    length = l_in * rate
    flops = 2.0 * n * (l_in * c_in * rate * c + length * c * c + n_conv * length * c * c * taps)
    weights = c_in * rate * c + c + c * c + c + n_conv * (c * c * taps + c)
    nbytes = ITEM_BYTES[act] * (2 * n * l_in * c_in + weights + n * film_frames * 2 * n_conv * c
                                + n * length * c)
    return {"flops": flops, "bytes": nbytes, "bound_s": bound_s(flops, nbytes, precision)}


def _convnext_frame(c: int, h: int, k: int, cond: int = 0) -> float:
    return 2.0 * (c * k + c * h + h * c + (2 * cond * c if cond else 0))


def frame_flops(model: dict, lib_rows: int) -> Dict[str, float]:
    """Operations of one 20 ms frame (one hop of the STFT, ``segment_size``
    output samples), by layer."""
    audio, ce, f0, dc = model["audio"], model["content_encoder"], model["f0_estimator"], model["decoder"]
    bins = audio["n_fft"] // 2 + 1
    out = {"stft": 2.0 * audio["n_fft"] * 2 * bins}
    for key, c in (("content_encoder", ce), ("f0_estimator", f0)):
        out[key] = (2.0 * bins * c["internal_channels"]
                    + c["num_layers"] * _convnext_frame(c["internal_channels"], c["hidden_channels"],
                                                        c["kernel_size"])
                    + 2.0 * c["internal_channels"] * c["output_channels"])
    ch = dc["channels"]
    out["knn"] = 2.0 * lib_rows * dc["content_channels"]
    out["feature_extractor"] = (2.0 * dc["content_channels"] * ch + 2.0 * ch + 2.0 * ch * ch
                                + dc["num_layers"] * _convnext_frame(ch, dc["hidden_channels"],
                                                                     dc["kernel_size"], ch)
                                + 2.0 * ch * dc["num_harmonics"])
    out["oscillator"] = 2.0 * dc["num_harmonics"] * dc["segment_size"]
    seg, k, n_conv = dc["segment_size"], dc["filter_kernel_size"], 2 * dc["filter_dilations"]
    chans, rates = list(dc["filter_channels"]), list(dc["filter_rates"])
    f = 2.0 * seg * chans[0] * 7 + 2.0 * seg * chans[0] * 7          # source_in, source_out
    length = seg
    for c, cn, r in zip(chans, chans[1:] + [chans[-1]], rates):
        length //= r
        f += 2.0 * length * r * c * cn
    f += 2.0 * length * chans[-1] * chans[-1] * k                     # mid conv
    rchans = chans[::-1]
    for c, cp, r in zip(rchans, [rchans[0]] + rchans[:-1], rates[::-1]):
        f += 2.0 * length * cp * r * c
        length *= r
        f += 2.0 * length * c * c + n_conv * 2.0 * length * c * c * k
        f += 2.0 * ch * 2 * n_conv * c                                # the level's FiLM product
    out["filter"] = f
    return out


def window_flops(model: dict, lib_rows: int, samples16: int) -> float:
    """Operations of one window of ``samples16`` samples at 16 kHz."""
    frames = samples16 // model["audio"]["hop_length"]
    return frames * sum(frame_flops(model, lib_rows).values())
