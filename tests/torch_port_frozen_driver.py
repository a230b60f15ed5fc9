"""A frozen copy of the offline driver as it was before it kept each file on
the device: NumPy between the steps, a copy to the host after every step and
after the first resample, and the file uploaded again for the second.

``tests/test_torch_port_driver.py`` (CPU) and ``tests/test_torch_port_gpu.py``
(the card) hold ``OfflineConverter.convert`` and ``convert_16k`` to it bit
for bit.  It imports neither JAX nor the test helpers that do, so the card's
tests can import it.  It calls the module's own ``convert_window``,
``convert_knnvc`` and ``resample``, as the driver did."""

from __future__ import annotations

import numpy as np
import torch

from alivevc_tpu_torch.infer import offline


def frozen_convert_16k(conv, wave: np.ndarray) -> np.ndarray:
    if isinstance(conv, offline.KnnVCConverter):
        wave = np.asarray(wave, np.float32)
        if wave.shape[0] < conv.min_samples:
            raise ValueError("shorter than one WavLM frame")
        return offline.convert_knnvc(conv.model, wave, conv.matching_set, conv.k,
                                     conv.precision).cpu().numpy()
    cfg = conv.cfg
    c = cfg.chunk
    wave = np.asarray(wave, np.float32)
    total = wave.shape[0]
    peak = np.abs(wave).max() if total else 0.0
    if peak > 0:
        wave = wave / peak
    padded = np.concatenate([np.zeros(c, np.float32), wave, np.zeros(4 * c, np.float32)])
    m = (padded.shape[0] - 3 * c) // c + 1
    windows = np.stack([padded[i * c: i * c + 3 * c] for i in range(m)])
    f0 = offline.compute_f0(windows, conv.sample_rate)[..., None] if conv.world_pitch else None
    bsz = max(1, cfg.max_windows_per_step)
    outs = []
    for i in range(0, m, bsz):
        batch = windows[i: i + bsz]
        f0_b = None if f0 is None else f0[i: i + bsz]
        n_real = batch.shape[0]
        pad = bsz - n_real if m > bsz else 0
        if pad:
            batch = np.concatenate([batch, np.zeros((pad,) + batch.shape[1:], batch.dtype)])
            if f0_b is not None:
                f0_b = np.concatenate([f0_b, np.zeros((pad,) + f0_b.shape[1:], f0_b.dtype)])
        got = offline.convert_window(
            conv.ce, conv.f0, conv.dec, torch.from_numpy(batch), conv.tgt,
            cfg.f0_rate, cfg.pitch_shift, cfg.intonation, cfg.k, cfg.alpha,
            conv.dec_cfg, None if f0_b is None else torch.from_numpy(f0_b), conv.dtype,
            conv.knn_precision, conv.device,
        )
        outs.append(got[:n_real].cpu().numpy())
    out = np.concatenate(outs)[:, c:-c].reshape(-1)[:total]
    out = out * (10.0 ** (cfg.gain_db / 20.0))
    if cfg.normalize and np.abs(out).max() > 0:
        out = out / np.abs(out).max()
    return out


def frozen_convert(conv, wave: np.ndarray, sr: int) -> np.ndarray:
    wave = np.asarray(wave, np.float32)
    if wave.ndim == 2:
        wave = wave.mean(axis=0 if wave.shape[0] <= wave.shape[1] else 1)
    if sr == conv.sample_rate:
        return frozen_convert_16k(conv, wave)
    x = torch.from_numpy(np.ascontiguousarray(wave))[None].to(conv.device)
    wave16 = offline.resample(x, sr, conv.sample_rate)[0].cpu().numpy()
    out16 = torch.from_numpy(frozen_convert_16k(conv, wave16))[None].to(conv.device)
    return offline.resample(out16, conv.sample_rate, sr)[0].cpu().numpy()
