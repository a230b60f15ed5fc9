"""The two conversion paths of the reference: a file through the
overlap-discard driver (inference.py:87-134), and a batch of streaming hops
(realtime_inference.py:122-190), with the kNN matching between them
(module/common.py:96-109: cosine top-k, the mean of the k rows).

Every choice the model makes by a ranking (the F0 bin, the k nearest rows)
is returned with its margin, the gap between the last choice and the best
one left out, so that a comparison can tell a near-tie from a fault.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from reference import dsp, model
from reference.numerics import Math


class Precisions:
    """One ``Math`` for each part: 'stft', 'ce', 'f0', 'dec', 'knn'."""

    PARTS = ("stft", "ce", "f0", "dec", "knn")

    def __init__(self, modes: Optional[Dict[str, str]] = None):
        modes = modes or {}
        self.m = {part: Math(modes.get(part, "fp32")) for part in self.PARTS}

    def __getitem__(self, part: str) -> Math:
        return self.m[part]


def knn(m: Math, src: torch.Tensor, lib: torch.Tensor, k: int, alpha: float, rows: int = 4096,
        swap: Optional[torch.Tensor] = None):
    """src [Q, D], lib [R, D] -> (features [Q, D], margin [Q]): the mean of
    the k library rows of highest cosine score; margin = score k - score
    k+1.  ``swap`` [Q] (bool) puts row k+1 in place of row k."""
    def unit(x):
        x = x.float()
        return x * torch.rsqrt(torch.clamp((x * x).sum(1, keepdim=True), min=1e-30))

    lib_u = unit(lib).t()
    feats, margins = [], []
    for q0 in range(0, src.shape[0], rows):
        s = m.mm(unit(src[q0:q0 + rows]), lib_u)
        v, i = torch.topk(s, min(k + 1, lib.shape[0]), dim=1)
        margins.append(v[:, k - 1] - v[:, k] if v.shape[1] > k else torch.full_like(v[:, 0], float("inf")))
        idx = i[:, :k]
        if swap is not None:
            sw = swap[q0:q0 + rows]
            idx = torch.where(sw[:, None] & (torch.arange(k, device=idx.device) == k - 1)[None, :],
                              i[:, k:k + 1].expand(-1, k), idx)
        feats.append(lib[idx].float().mean(1))
    out = torch.cat(feats)
    return out * (1.0 - alpha) + src.float() * alpha, torch.cat(margins)


def f0_choice(logits: torch.Tensor, swap: Optional[torch.Tensor] = None):
    """logits [N, T, bins] -> (f0 Hz [N, T, 1], margin [N, T]): the best bin
    (the runner-up where ``swap``), and the gap between the two over the
    best logit's magnitude (at least 1)."""
    v, i = torch.topk(logits, 2, dim=-1)
    pick = i[..., 0] if swap is None else torch.where(swap, i[..., 1], i[..., 0])
    return pick.float()[..., None], (v[..., 0] - v[..., 1]) / torch.clamp(v[..., 0].abs(), min=1.0)


def target_matrix(pr: Precisions, p: dict, cfg: dict, target_wave, tokens, decimation: int):
    """Encoder frames of the target utterance (every ``decimation``-th), then
    the library tokens: [R, 768]."""
    parts = []
    if target_wave is not None:
        spec = dsp.spectrogram(pr["stft"], torch.as_tensor(target_wave).float()[None], cfg["audio"])
        parts.append(model.content_encoder(pr["ce"], p["ce"], cfg["content_encoder"], spec)[0][::decimation])
    if tokens is not None:
        parts.append(torch.as_tensor(tokens).float())
    return torch.cat(parts)


def convert_windows(pr: Precisions, p: dict, cfg: dict, windows: torch.Tensor, tgt: torch.Tensor,
                    infer: dict) -> torch.Tensor:
    """Windows [B, 3c] at 16 kHz -> converted [B, 3c]: F0 (per-window
    intonation), content, kNN, decoder with the offline source."""
    spec = dsp.spectrogram(pr["stft"], windows, cfg["audio"])
    f0, _ = f0_choice(model.f0_logits(pr["f0"], p["f0"], cfg["f0_estimator"], spec))
    f0 = torch.stack([dsp.apply_intonation(f, infer["intonation"], infer["pitch_shift"]) for f in f0])
    content = model.content_encoder(pr["ce"], p["ce"], cfg["content_encoder"], spec)
    n, t, d = content.shape
    feat, _ = knn(pr["knn"], content.reshape(n * t, d), tgt, cfg["knn"]["k"], cfg["knn"]["alpha"])
    wave, _ = model.decoder(pr["dec"], p["dec"], cfg["decoder"], feat.reshape(n, t, d), f0 * infer["f0_rate"])
    return wave


def convert_file(pr: Precisions, p: dict, cfg: dict, wave: np.ndarray, sr: int, tgt: torch.Tensor,
                 infer: dict, device, block: int = 8) -> np.ndarray:
    """A mono file at ``sr`` -> the converted file at ``sr``: resample to 16
    kHz, peak-normalise, pad one chunk before and four after, cut windows of
    three chunks at a one-chunk stride, convert, keep each centre chunk,
    apply the gain, resample back."""
    sr16 = cfg["audio"]["sample_rate"]
    x = torch.as_tensor(np.asarray(wave, np.float32), device=device)[None]
    x = dsp.resample(x, sr, sr16)[0]
    total, c = x.shape[0], infer["chunk"]
    peak = x.abs().max()
    if float(peak) > 0:
        x = x / peak
    padded = torch.cat([x.new_zeros(c), x, x.new_zeros(4 * c)])
    m = (padded.shape[0] - 3 * c) // c + 1
    windows = padded.unfold(0, 3 * c, c)[:m]
    out = torch.cat([convert_windows(pr, p, cfg, windows[i:i + block], tgt, infer)[:, c:-c]
                     for i in range(0, m, block)])
    out = out.reshape(-1)[:total] * (10.0 ** (infer["gain_db"] / 20.0))
    if infer["normalize"] and float(out.abs().max()) > 0:
        out = out / out.abs().max()
    return dsp.resample(out[None], sr16, sr)[0].cpu().numpy()


def output_span(stream: dict):
    centre = stream["chunk"] * stream["buffer_size"] // 2
    return centre - stream["chunk"] // 2, centre + stream["chunk"] // 2


def stream_hops(pr: Precisions, p: dict, cfg: dict, windows: torch.Tensor, phi: torch.Tensor,
                tgt: torch.Tensor, stream: dict, f0_swap=None, knn_swap=None):
    """Hops from their windows [H, W] and carried phases [H, 1, harmonics]
    (each hop on its own): -> (output chunks [H, chunk], next phases
    [H, harmonics], F0 margins [H, T], kNN margins [H, T])."""
    spec = dsp.spectrogram(pr["stft"], windows, cfg["audio"])
    content = model.content_encoder(pr["ce"], p["ce"], cfg["content_encoder"], spec)
    f0, f0_margin = f0_choice(model.f0_logits(pr["f0"], p["f0"], cfg["f0_estimator"], spec), f0_swap)
    f0 = dsp.shift_pitch(f0 * stream["f0_rate"], stream["pitch_shift"])
    h, t, d = content.shape
    feat, knn_margin = knn(pr["knn"], content.reshape(h * t, d), tgt, cfg["knn"]["k"], cfg["knn"]["alpha"],
                           swap=None if knn_swap is None else knn_swap.reshape(-1))
    begin, end = output_span(stream)
    wave, phi_out = model.decoder(pr["dec"], p["dec"], cfg["decoder"], feat.reshape(h, t, d), f0,
                                  phi=phi, crop=(begin, end))
    return wave[:, begin:end], phi_out[:, end], f0_margin, knn_margin.reshape(h, t)
