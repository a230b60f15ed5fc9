"""Build, load and launch the port's CUDA kernels, and build its native
host library.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface and loaded with ``ctypes``; nothing
includes PyTorch's headers, so a build takes seconds.  The host library
``native`` (the WORLD F0 labeler and the audio ring buffer,
``native/*.cpp``) is compiled by ``g++`` with ``-march=native``, for the CPU
that builds it.  Libraries are built at first use into
``alivevc_tpu_torch/_build/`` (listed in ``.gitignore``), named by a hash of
their sources and flags (and, for the native library, of the host's name),
and ``build_all`` compiles every source at once, one compiler process each.
A library is compiled to a temporary name and moved into place with
``os.replace``, so processes that build the same library at once each load
a whole file.

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
import platform
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Sequence

import torch

from alivevc_tpu_torch.utils.profiling import PREFIX, span

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
NATIVE = PKG / "native"
BUILD_DIR = PKG / "_build"
SOURCES = ("stft", "knn", "knn_carried", "oscillator", "filter", "hifigan")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
NATIVE_LIB = "native"
NATIVE_SOURCES = ("world.cpp", "ringbuffer.cpp")
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-shared")   # native/Makefile's

LAUNCHES: Dict[str, int] = {"stft": 0, "knn": 0, "oscillator": 0, "filter_level": 0,
                            "filter_narrow": 0, "filter_wide": 0,
                            "knn_packed": 0, "oscillator_formants": 0, "knn_merge": 0,
                            "knn_carried": 0, "knn_carried_packed": 0, "knn_prep": 0,
                            "oscillator_stream": 0, "hifigan_conv": 0}

# the profiler span each kernel ``Function``'s backward recomputes its
# plain version in (``plain_vjp``; chip_smoke.py reads the device time under it)
RECOMPUTE_SPAN = PREFIX + "train.plain_recompute"

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


def _cxx() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found; the native library cannot be built")
    return found


def _recipe(name: str):
    """The flags of ``lib<name>`` and the files its name hashes (the .cu or
    .cpp among them are compiled)."""
    if name == NATIVE_LIB:
        return CXX_FLAGS, [NATIVE / src for src in NATIVE_SOURCES]
    return NVCC_FLAGS, [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]


def _so_path(name: str) -> Path:
    flags, files = _recipe(name)
    h = hashlib.sha1()
    h.update(" ".join(flags).encode())
    for src in files:
        h.update(src.read_bytes())
    if name == NATIVE_LIB:      # -march=native: a build serves only the host that made it
        h.update(platform.node().encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:12]}.so"


def _command(name: str, out: Path) -> list:
    flags, files = _recipe(name)
    compiled = [str(f) for f in files if f.suffix != ".cuh"]
    if name == NATIVE_LIB:
        return [_cxx(), *flags, "-o", str(out), *compiled]
    return [_nvcc(), *flags, "-I", str(CSRC), "-o", str(out), *compiled]


def build_all(names: Iterable[str] = SOURCES) -> float:
    """Compile every missing library in parallel; returns the seconds spent.
    Compiler output (with ptxas register and shared-memory counts) goes to
    ``_build/<name>.log``; a failed build raises with it."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in names:
        so = _so_path(name)
        if so.exists():
            continue
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        procs.append((name, so, tmp, subprocess.Popen(
            _command(name, tmp), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, so, tmp, proc in procs:
        log, _ = proc.communicate()
        (BUILD_DIR / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("the build failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """``lib<name>``, built and loaded on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        with _LOCK:
            if name not in _LIBS:
                build_all([name])
                _LIBS[name] = ctypes.CDLL(str(_so_path(name)))
            lib = _LIBS[name]
    return lib


def function(lib_name: str, symbol: str, argtypes: str):
    """The C entry ``symbol`` of ``lib<lib_name>``, built and loaded on first
    use.  ``argtypes`` spells the arguments: p = pointer, i = int,
    l = 64-bit int, f = float."""
    key = (lib_name, symbol)
    fn = _FNS.get(key)
    if fn is None:
        lib = library(lib_name)
        with _LOCK:
            fn = getattr(lib, symbol)
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


def refuse_grad(what: str, *tensors) -> None:
    """Raise if grad mode is on and a CUDA input of a kernel launch requires
    grad.  The launches write into fresh tensors through ctypes, so their
    outputs carry no ``grad_fn``: a kernel with a backward is reached
    through its ``torch.autograd.Function`` (whose forward runs with grad
    mode off), and one without a backward must not drop a gradient
    quietly.  (A CPU input is refused by the launch's device check.)"""
    if torch.is_grad_enabled() and any(torch.is_tensor(t) and t.is_cuda and t.requires_grad
                                       for t in tensors):
        raise RuntimeError(f"{what}: an input requires grad, and this launch has no backward; "
                           "detach the input or run under torch.no_grad()")


def plain_vjp(plain: Callable[..., torch.Tensor], saved: Sequence[torch.Tensor],
              needs: Sequence[bool], grad_out: torch.Tensor) -> List[Optional[torch.Tensor]]:
    """The backward of a kernel ``Function``: ``plain(*saved)`` recomputed
    with autograd on detached copies of the saved inputs, under
    ``RECOMPUTE_SPAN``; the gradient of each input, None where ``needs``
    is false."""
    with torch.enable_grad(), span("train.plain_recompute"):
        inputs = [t.detach().requires_grad_(need) for t, need in zip(saved, needs)]
        out = plain(*inputs)
        wanted = [t for t, need in zip(inputs, needs) if need]
        grads = iter(torch.autograd.grad(out, wanted, grad_out, allow_unused=True))
    return [next(grads) if need else None for need in needs]


def route(t: torch.Tensor) -> str:
    """'cuda' for a CUDA tensor, 'cpu' for a CPU tensor (the plain PyTorch
    version runs there); any other device raises."""
    if t.is_cuda:
        return "cuda"
    if t.device.type == "cpu":
        return "cpu"
    raise ValueError(f"no kernel for device {t.device}")
