"""ctypes bindings of the port's native host library (``native/*.cpp``).

  * ``dio_stonemask_native`` and ``dio_stonemask_native_batch`` — the C++
    WORLD-style F0 labeler (DIO + StoneMask, the algorithm of
    ``ops/world.py``); the batch form shards its items over a worker pool;
  * ``NativeRingBuffer`` — a lock-free SPSC sample ring for the realtime
    audio thread.

The sources are copies of the JAX package's ``native/world.cpp`` and
``native/ringbuffer.cpp``.  ``load_native`` builds the library with ``g++``
at first use into ``_build/`` (``kernels/_lib.py``, the loader of the CUDA
kernels) and raises with the compiler's output if the build fails: no
caller falls back to the numpy labeler without asking for it.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from alivevc_tpu_torch.kernels import _lib

_F32P = ctypes.POINTER(ctypes.c_float)
_F64P = ctypes.POINTER(ctypes.c_double)
_D = ctypes.c_double


def load_native() -> ctypes.CDLL:
    """The native library, built on first use, with its C signatures set."""
    lib = _lib.library(_lib.NATIVE_LIB)
    if getattr(lib, "_alive_signatures", False):
        return lib
    lib.alive_dio_stonemask.restype = ctypes.c_int32
    lib.alive_dio_stonemask.argtypes = [
        _F32P, ctypes.c_int32, ctypes.c_int32, _D, _D, _D, _D, _D, _F64P,
    ]
    lib.alive_dio_stonemask_batch.restype = ctypes.c_int32
    lib.alive_dio_stonemask_batch.argtypes = [
        _F32P, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, _D, _D, _D, _D, _D, _F64P,
        ctypes.c_int32,
    ]
    lib.alive_ring_create.restype = ctypes.c_void_p
    lib.alive_ring_create.argtypes = [ctypes.c_int64]
    lib.alive_ring_destroy.restype = None
    lib.alive_ring_destroy.argtypes = [ctypes.c_void_p]
    lib.alive_ring_size.restype = ctypes.c_int64
    lib.alive_ring_size.argtypes = [ctypes.c_void_p]
    lib.alive_ring_push.restype = ctypes.c_int64
    lib.alive_ring_push.argtypes = [ctypes.c_void_p, _F32P, ctypes.c_int64]
    lib.alive_ring_pop.restype = ctypes.c_int64
    lib.alive_ring_pop.argtypes = [ctypes.c_void_p, _F32P, ctypes.c_int64]
    lib.alive_ring_overruns.restype = ctypes.c_int64
    lib.alive_ring_overruns.argtypes = [ctypes.c_void_p]
    lib._alive_signatures = True
    return lib


def native_available() -> bool:
    """True once the library is built and loaded; a failed build raises."""
    return load_native() is not None


def dio_stonemask_native(
    x: np.ndarray,
    fs: int,
    f0_floor: float = 40.0,
    f0_ceil: float = 800.0,
    frame_period_ms: float = 5.0,
    channels_in_octave: float = 2.0,
    allowed_range: float = 0.1,
) -> np.ndarray:
    """x [L] float -> f0 [F] Hz (0 = unvoiced), F ~ duration / frame_period."""
    lib = load_native()
    x32 = np.ascontiguousarray(x, dtype=np.float32)
    n_frames_max = int(len(x32) / fs * 1000.0 / frame_period_ms) + 2
    out = np.zeros(n_frames_max, dtype=np.float64)
    n = lib.alive_dio_stonemask(
        x32.ctypes.data_as(_F32P), len(x32), fs, f0_floor, f0_ceil, frame_period_ms,
        channels_in_octave, allowed_range, out.ctypes.data_as(_F64P),
    )
    return out[:n]


def dio_stonemask_native_batch(
    x: np.ndarray,            # [N, L] float
    fs: int,
    f0_floor: float = 40.0,
    f0_ceil: float = 800.0,
    frame_period_ms: float = 5.0,
    channels_in_octave: float = 2.0,
    allowed_range: float = 0.1,
    n_threads: int = 0,       # 0 = hardware_concurrency
) -> np.ndarray:
    """Threaded batch labeler: [N, L] -> f0 [N, F] Hz (0 = unvoiced).  Items
    are independent; the C++ side shards them over a worker pool."""
    lib = load_native()
    x32 = np.ascontiguousarray(x, dtype=np.float32)
    n_items, item_len = x32.shape
    frames = int(item_len / fs * 1000.0 / frame_period_ms) + 1
    out = np.zeros((n_items, frames), dtype=np.float64)
    got = lib.alive_dio_stonemask_batch(
        x32.ctypes.data_as(_F32P), n_items, item_len, fs, f0_floor, f0_ceil, frame_period_ms,
        channels_in_octave, allowed_range, out.ctypes.data_as(_F64P), n_threads,
    )
    if got != frames:
        raise RuntimeError(f"batch labeler returned {got}, expected {frames}")
    return out


class NativeRingBuffer:
    """Lock-free SPSC sample ring for the realtime audio path."""

    def __init__(self, capacity_samples: int):
        self._lib = load_native()
        self._h = self._lib.alive_ring_create(capacity_samples)
        if not self._h:
            raise MemoryError("ring buffer allocation failed")

    def push(self, samples: np.ndarray) -> int:
        """Push up to ``len(samples)``; returns the count actually stored.

        On overflow the newest samples are dropped (the producer never
        writes past ``tail + capacity``), so a concurrent ``pop`` never
        observes a torn read; dropped samples are tallied in ``overruns``.
        """
        s = np.ascontiguousarray(samples, dtype=np.float32)
        return self._lib.alive_ring_push(self._h, s.ctypes.data_as(_F32P), len(s))

    def pop(self, n: int) -> Optional[np.ndarray]:
        """``n`` samples, or None (nothing taken) while fewer are stored."""
        out = np.empty(n, dtype=np.float32)
        got = self._lib.alive_ring_pop(self._h, out.ctypes.data_as(_F32P), n)
        return out if got == n else None

    def __len__(self) -> int:
        return int(self._lib.alive_ring_size(self._h))

    @property
    def overruns(self) -> int:
        return int(self._lib.alive_ring_overruns(self._h))

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.alive_ring_destroy(self._h)
            self._h = None
