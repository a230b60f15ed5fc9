"""Cosine top-k over a library: CUDA kernel pair (``csrc/knn.cu``) and its
plain PyTorch version.

Replaces ``alivevc_tpu/kernels/knn_twopass.py:knn_topk_twopass`` and
``alivevc_tpu/kernels/knn_pallas.py:knn_topk_pallas`` (the route at
``knn_pallas.py:244-259``): one kernel takes any library of at least k rows.

Precision modes (the JAX names):
  * 'default': bf16 operands, float32 accumulation.  An exact top-k on those
    scores; near-ties may flip against float32 (the licensed bf16 mode).
  * 'high' / 'highest': float32 operands and scores; the ranking is that of
    float32 cosine scores.

Normalisation is ``x * rsqrt(max(sum x^2, 1e-30))`` in float32 before the
mode cast (``knn_twopass.py:230-234``).  Ties go to the smallest library
index.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from alivevc_tpu_torch.kernels import _lib

PRECISIONS = ("default", "high", "highest")
_ROWS_PER_CHUNK = 16 * 128   # library rows one block scans (csrc/knn.cu)


def normalize_rows(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    return x * torch.rsqrt(torch.clamp((x * x).sum(dim=1, keepdim=True), min=1e-30))


def prep_operands(source: torch.Tensor, library: torch.Tensor, precision: str):
    """Normalised operands in the mode's type: bf16 for 'default', float32
    otherwise."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    src, lib = normalize_rows(source), normalize_rows(library)
    if precision == "default":
        src, lib = src.to(torch.bfloat16), lib.to(torch.bfloat16)
    return src, lib


def topk_exact(sims: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis of [Q, C] float32 scores, ties to the
    smallest column (lax.top_k's order): k rounds of max, then the smallest
    column at the max, then mask it out."""
    sims = sims.clone()
    col = torch.arange(sims.shape[1], device=sims.device)[None, :]
    big = torch.iinfo(torch.int64).max
    vals, idxs = [], []
    for _ in range(k):
        m = sims.max(dim=1, keepdim=True).values
        sel = torch.where(sims >= m, col, big).min(dim=1, keepdim=True).values
        vals.append(m)
        idxs.append(sel)
        sims.scatter_(1, sel, float("-inf"))
    return torch.cat(vals, dim=1), torch.cat(idxs, dim=1)


def knn_topk_plain(source: torch.Tensor, library: torch.Tensor, k: int = 4,
                   precision: str = "default", q_chunk: int = 1024):
    """(values [Ls, k] float32, indices [Ls, k] int64): the scores of the
    mode's operands computed in float32, exact top-k per query."""
    src, lib = prep_operands(source, library, precision)
    lib_t = lib.float().t()
    vals, idxs = [], []
    for q0 in range(0, src.shape[0], q_chunk):
        v, i = topk_exact(src[q0:q0 + q_chunk].float() @ lib_t, k)
        vals.append(v)
        idxs.append(i)
    return torch.cat(vals), torch.cat(idxs)


def knn_topk_cuda(source: torch.Tensor, library: torch.Tensor, k: int = 4,
                  precision: str = "default"):
    """The kernel launch (tile scores + per-block top-k, then the merge)."""
    if not 1 <= k <= 8:
        raise ValueError(f"k={k} must be in [1, 8]")
    if library.shape[0] < k:
        raise ValueError(f"library has {library.shape[0]} rows < k={k}")
    src, lib = prep_operands(source, library, precision)
    d = src.shape[1]
    if d % 32:  # zero columns change no dot product
        src = F.pad(src, (0, 32 - d % 32))
        lib = F.pad(lib, (0, 32 - d % 32))
    src, lib = src.contiguous(), lib.contiguous()
    dt = (torch.bfloat16,) if precision == "default" else (torch.float32,)
    _lib.require(src, "source", dt, 2)
    _lib.require(lib, "library", dt, 2)
    if lib.device != src.device:
        raise ValueError("source and library must be on one device")
    ls, lr = src.shape[0], lib.shape[0]
    if -(-ls // 64) > 65535:    # query tiles ride gridDim.y
        raise ValueError(f"{ls} queries exceed one launch; split the batch")
    kk = 4 if k <= 4 else 8
    n_chunks = -(-lr // _ROWS_PER_CHUNK)
    dev = src.device
    cand_v = torch.empty((n_chunks, ls, kk), dtype=torch.float32, device=dev)
    cand_i = torch.empty((n_chunks, ls, kk), dtype=torch.int32, device=dev)
    out_v = torch.empty((ls, kk), dtype=torch.float32, device=dev)
    out_i = torch.empty((ls, kk), dtype=torch.int32, device=dev)
    fn = _lib.function("knn", "knn_topk", "ppppppiiiiiip")
    rc = fn(src.data_ptr(), lib.data_ptr(), cand_v.data_ptr(), cand_i.data_ptr(),
            out_v.data_ptr(), out_i.data_ptr(), ls, lr, src.shape[1], kk,
            int(precision == "default"), _ROWS_PER_CHUNK, _lib.stream_of(src))
    _lib.check(rc, "knn_topk")
    _lib.LAUNCHES["knn"] += 1
    return out_v[:, :k], out_i[:, :k].long()


def knn_topk(source: torch.Tensor, library: torch.Tensor, k: int = 4,
             precision: str = "default"):
    """Cosine top-k of source [Ls, D] against library [Lr, D]: the kernel on
    CUDA tensors, the plain version on CPU tensors."""
    if _lib.route(source) == "cuda":
        return knn_topk_cuda(source, library, k, precision)
    return knn_topk_plain(source, library, k, precision)
