"""Wave-chunk datasets (``alivevc_tpu/io/dataset.py``; reference:
module/dataset.py:9-78).

Recursively globs audio files, resamples to the dataset's rate
(``ops/resample.py`` on a CPU tensor: loading is host work), splits each
file's first channel into fixed-length chunks (dropping the remainder),
holds them in host RAM, and serves shuffled fixed-shape batches.  With
``with_f0`` each chunk gets its WORLD labels at load time
(``ops/world.py:compute_f0``, the native labeler; a failed build raises).
"""

from __future__ import annotations

import glob
import os
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from alivevc_tpu_torch.io.audio import read_audio
from alivevc_tpu_torch.ops.resample import resample


def _resample_np(wave: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    if sr_in == sr_out:
        return wave
    return resample(torch.from_numpy(np.ascontiguousarray(wave, np.float32)), sr_in, sr_out).numpy()


class WaveChunkDataset:
    """chunks [N, length] float32 at ``sampling_rate``; with ``with_f0``,
    f0 labels [N, length // 320].  ``host_shard`` = (index, count) keeps
    every count-th file from index on, so that data-parallel ranks load
    disjoint files."""

    def __init__(self, source_dirs: List[str], length: int = 65_536, max_files: int = -1,
                 sampling_rate: int = 16_000, with_f0: bool = False,
                 host_shard: Optional[Tuple[int, int]] = None):
        paths: List[str] = []
        for d in source_dirs:
            for fmt in ("wav", "mp3", "ogg", "flac"):
                paths += glob.glob(os.path.join(d, f"**/*.{fmt}"), recursive=True)
        paths.sort()
        if max_files != -1:
            paths = paths[:max_files]
        if host_shard is not None:
            index, count = host_shard
            if not 0 <= index < count:
                raise ValueError(f"host_shard {host_shard}: need 0 <= index < count")
            paths = paths[index::count]
        chunks = []
        for path in paths:
            decoded = read_audio(path)      # mp3/ogg/flac through ffmpeg where it is installed
            if decoded is None:
                continue
            wave, sr = decoded
            wave = _resample_np(wave[:1], sr, sampling_rate)[0]
            for i in range(wave.shape[0] // length):
                chunks.append(wave[i * length:(i + 1) * length].astype(np.float32))
        self.chunks = np.stack(chunks) if chunks else np.zeros((0, length), np.float32)
        self.f0 = None
        if with_f0 and chunks:
            from alivevc_tpu_torch.ops.world import compute_f0

            # 256 chunks a call bounds the resampling scratch on large datasets
            self.f0 = np.concatenate([compute_f0(self.chunks[i:i + 256], sampling_rate)
                                      for i in range(0, len(chunks), 256)])
        self.length = length

    def __len__(self) -> int:
        return self.chunks.shape[0]

    def __getitem__(self, i: int):
        if self.f0 is not None:
            return self.chunks[i], self.f0[i]
        return self.chunks[i]


def batch_iterator(ds: WaveChunkDataset, batch_size: int, seed: int = 0,
                   drop_last: bool = True) -> Iterator:
    """Shuffled fixed-shape batches: wave [B, L] (and f0 [B, T])."""
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(ds))
    end = len(ds) - (len(ds) % batch_size) if drop_last else len(ds)
    for i in range(0, end, batch_size):
        sel = idx[i:i + batch_size]
        if ds.f0 is not None:
            yield ds.chunks[sel], ds.f0[sel]
        else:
            yield ds.chunks[sel]
