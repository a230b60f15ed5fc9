"""Build, load and launch the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface and loaded with ``ctypes``; nothing
includes PyTorch's headers, so a build takes seconds.  Libraries are built
at first use into ``alivevc_tpu_torch/_build/`` (listed in ``.gitignore``),
named by a hash of their sources and flags, and ``build_all`` compiles every
source at once, one ``nvcc`` process each.

``LAUNCHES`` counts, per kernel, the wrapper calls that launched it on the
card; nothing else adds to it.

Kernels run asynchronously on PyTorch's current stream.  A wrapper may drop
its references to scratch and operand copies right after the launch: the
caching allocator hands freed memory out again only in that stream's order.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Sequence

import torch

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
SOURCES = ("stft", "knn", "oscillator", "filter")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

LAUNCHES: Dict[str, int] = {"stft": 0, "knn": 0, "oscillator": 0, "filter_level": 0,
                            "knn_packed": 0, "oscillator_formants": 0}

_LIBS: Dict[str, ctypes.CDLL] = {}
_FNS: Dict[tuple, object] = {}
_LOCK = threading.Lock()
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "l": ctypes.c_longlong, "f": ctypes.c_float}


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")
    return found


def _so_path(name: str) -> Path:
    h = hashlib.sha1()
    h.update(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:12]}.so"


def build_all(names: Iterable[str] = SOURCES) -> float:
    """Compile every missing library in parallel; returns the seconds spent.
    Compiler output (with ptxas register and shared-memory counts) goes to
    ``_build/<name>.log``."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in names:
        so = _so_path(name)
        if so.exists():
            continue
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, so, tmp, proc in procs:
        log, _ = proc.communicate()
        (BUILD_DIR / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def function(lib_name: str, symbol: str, argtypes: str):
    """The C entry ``symbol`` of ``lib<lib_name>``, built and loaded on first
    use.  ``argtypes`` spells the arguments: p = pointer, i = int,
    l = 64-bit int, f = float."""
    key = (lib_name, symbol)
    fn = _FNS.get(key)
    if fn is None:
        with _LOCK:
            if lib_name not in _LIBS:
                build_all([lib_name])
                _LIBS[lib_name] = ctypes.CDLL(str(_so_path(lib_name)))
            fn = getattr(_LIBS[lib_name], symbol)
            fn.argtypes = [_CTYPES[c] for c in argtypes]
            fn.restype = ctypes.c_int
            _FNS[key] = fn
    return fn


_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def stream_of(t: torch.Tensor) -> int:
    """The handle of PyTorch's current stream on ``t``'s card: the raw
    handle where PyTorch exposes it (making a ``torch.cuda.Stream`` costs
    several microseconds of host time a launch)."""
    if _RAW_STREAM is not None:
        return _RAW_STREAM(t.get_device())
    return torch.cuda.current_stream(t.device).cuda_stream


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")


def require(t: torch.Tensor, name: str, dtypes: Sequence[torch.dtype], dim: int) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of one of ``dtypes``
    with ``dim`` dimensions."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be one of {dtypes}, got {t.dtype}")
    if t.dim() != dim:
        raise ValueError(f"{name} must have {dim} dimensions, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def route(t: torch.Tensor) -> str:
    """'cuda' for a CUDA tensor, 'cpu' for a CPU tensor (the plain PyTorch
    version runs there); any other device raises."""
    if t.is_cuda:
        return "cuda"
    if t.device.type == "cpu":
        return "cpu"
    raise ValueError(f"no kernel for device {t.device}")
