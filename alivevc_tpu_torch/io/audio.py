"""Host-side audio I/O (the port's copy of the JAX package's ``io/audio.py``).

WAV via scipy.io.wavfile (PCM 16/24/32 and float); always returns float32 in
[-1, 1], shape [channels, length] like the reference's torchaudio.load
convention (module/dataset.py:25).  mp3/ogg/flac decode through an ``ffmpeg``
binary when one is on PATH (module/dataset.py:22-27 reads them via
torchaudio/sox); where there is none, ``read_audio`` returns None with a
warning.
"""

from __future__ import annotations

import shutil
import subprocess
import tempfile
import warnings
from typing import Optional, Tuple

import numpy as np
from scipy.io import wavfile


_PCM_SCALE = {
    np.dtype(np.int16): 32768.0,
    np.dtype(np.int32): 2147483648.0,
    np.dtype(np.uint8): 128.0,
}


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """→ (wave [C, L] float32 in [-1, 1], sample_rate)."""
    sr, data = wavfile.read(path)
    if data.dtype in _PCM_SCALE:
        scale = _PCM_SCALE[data.dtype]
        if data.dtype == np.uint8:
            data = data.astype(np.float32) - 128.0
        data = data.astype(np.float32) / scale
    else:
        data = data.astype(np.float32)
    if data.ndim == 1:
        data = data[None, :]
    else:
        data = data.T  # [L, C] → [C, L]
    return np.ascontiguousarray(data), int(sr)


def write_wav(path: str, wave: np.ndarray, sample_rate: int) -> None:
    """wave [L] or [C, L] float in [-1, 1] → 16-bit PCM WAV."""
    wave = np.asarray(wave, np.float32)
    if wave.ndim == 2:
        wave = wave.T  # [C, L] → [L, C]
    pcm = np.clip(wave, -1.0, 1.0)
    pcm = (pcm * 32767.0).astype(np.int16)
    wavfile.write(path, sample_rate, pcm)


def gain_db(wave: np.ndarray, db: float) -> np.ndarray:
    """torchaudio.functional.gain semantics (inference.py:136)."""
    return wave * (10.0 ** (db / 20.0))


def ffmpeg_available() -> bool:
    return shutil.which("ffmpeg") is not None


def read_audio(path: str) -> Optional[Tuple[np.ndarray, int]]:
    """Decode any audio file → (wave [C, L] float32, sr), or None.

    WAV decodes natively; mp3/ogg/flac/m4a shell out to ``ffmpeg`` when it is
    installed (decoded to a temporary float32 WAV).  Returns None with a
    warning when no decoder is available for the format.
    """
    if path.lower().endswith(".wav"):
        return read_wav(path)
    if not ffmpeg_available():
        warnings.warn(f"skipping {path}: no ffmpeg on PATH to decode this format")
        return None
    with tempfile.NamedTemporaryFile(suffix=".wav") as tmp:
        proc = subprocess.run(
            ["ffmpeg", "-y", "-v", "error", "-i", path,
             "-f", "wav", "-c:a", "pcm_f32le", tmp.name],
            capture_output=True,
        )
        if proc.returncode != 0:
            warnings.warn(f"ffmpeg failed on {path}: {proc.stderr.decode()[:200]}")
            return None
        return read_wav(tmp.name)
