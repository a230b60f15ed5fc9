"""Cosine top-k over a library: CUDA kernel pair (``csrc/knn.cu``) and its
plain PyTorch version.

Replaces ``alivevc_tpu/kernels/knn_twopass.py:knn_topk_twopass`` and
``alivevc_tpu/kernels/knn_pallas.py:knn_topk_pallas`` (the route at
``knn_pallas.py:244-259``): one kernel takes any library of at least k rows.

Precision modes (the JAX names):
  * 'default': bf16 operands, float32 accumulation.  An exact top-k on those
    scores; near-ties may flip against float32 (the licensed bf16 mode).
  * 'high' / 'highest': float32 operands and scores; the ranking is that of
    float32 cosine scores.  The kernel computes them as 3xTF32 on the
    tensor cores (``scores_3xtf32`` emulates it on the CPU): each operand
    splits into TF32 hi + lo, and lo.hi + hi.lo + hi.hi is summed in
    float32, ~2^-22 relative per product.  That is at least as precise as
    JAX's own 'high' (bf16x3, ``knn_twopass.py:246-257``).

What bounds the kernel on an H100 is operations: the score products (3x
them in 3xTF32).  It runs them on the tensor cores (``wgmma``, three
warpgroups of 64 queries a block) fed by a 4-stage ring of TMA tensor
copies with ``mbarrier``s.  It folds each 192 x 128 score tile into register
top-k lists straight from the accumulators while the next slabs land, and
merges the chunks' winners with a warp per query (``csrc/knn.cu``).

Normalisation is ``x * rsqrt(max(sum x^2, 1e-30))`` in float32 before the
mode cast (``knn_twopass.py:230-234``).  Ties go to the smallest library
index.

Row exclusion, in every mode (the sharded path's shard padding):
  * ``valid_rows`` (an int, or a 0-d integer tensor on the source's device):
    rows at index >= min(Lr, valid_rows) never win.  Unlike the JAX
    package's ``knn_topk_twopass``, which applies it only to its packed
    'default' path, the exact modes honour it too.
  * ``penalty`` (float32 [Lr]): added to the float32 score after the
    product.  JAX appends it as an operand column (``knn_twopass.py:238-242``),
    so its 'default' mode rounds it to bf16; penalties exact in bf16 (0, -4,
    -10) give the same ranking in both.
With fewer than k rows left, the missing places hold value -inf and index
``SENTINEL``.

``extraction='packed'`` (``knn_pallas.py:_knn_kernel_fast``/``_pack_topk``)
applies only to 'default' with no exclusion and k <= 8, and falls back to
the exact extraction otherwise, as ``knn_pallas.py:323-329`` does.  Scores
are ranked by ``bits(s + 2)`` with the low 7 mantissa bits replaced by
``127 - (column % 128)``, ties to the smaller index, and returned as that
key minus 2 (within 3.1e-5 of the score).  'auto' is the exact extraction.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from alivevc_tpu_torch.kernels import _lib

PRECISIONS = ("default", "high", "highest")
EXTRACTIONS = ("auto", "exact", "packed")
SENTINEL = 2**31 - 1         # index of a place no valid row filled
_ROWS_PER_CHUNK = 64 * 128   # library rows one block scans, at most (csrc/knn.cu) ...
_MIN_BLOCKS = 2 * 132        # ... unless fewer blocks than two waves on an H100 result
_QUERIES_PER_BLOCK = 192     # csrc/knn.cu: QT
_MAX_CHUNKS = 65535          # chunks ride gridDim.y
_D_MULT = 64                 # the kernel's slab: 128 bytes of a bf16 row
_SUB = 128                   # packed extraction's subtile width (7 index bits)


def normalize_rows(x: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """x * rsqrt(max(sum x^2, 1e-30)) per row in float32, stored as ``dtype``."""
    x = x.float()
    scale = torch.rsqrt(torch.clamp((x * x).sum(dim=1, keepdim=True), min=1e-30))
    return torch.mul(x, scale, out=torch.empty(x.shape, dtype=dtype, device=x.device))


def prep_operands(source: torch.Tensor, library: torch.Tensor, precision: str):
    """Normalised operands in the mode's type: bf16 for 'default' (the
    float32 product rounded once as it is stored), float32 otherwise."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    dt = torch.bfloat16 if precision == "default" else torch.float32
    return normalize_rows(source, dt), normalize_rows(library, dt)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 mantissa bits), ties away from
    zero, as ``cvt.rna.tf32.f32`` rounds: add half of the 13 dropped bits'
    unit to the magnitude's bits, then clear them."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def scores_3xtf32(src: torch.Tensor, lib: torch.Tensor) -> torch.Tensor:
    """[Ls, Lr] scores of float32 operands as the kernel's 'high'/'highest'
    mode forms them: hi = tf32(x), lo = tf32(x - hi), products of TF32
    values (exact in float32) summed in float32 as lo.hi + hi.lo + hi.hi.
    Used by the tests to hold the split's premise on the CPU."""
    sh, lh = tf32_round(src), tf32_round(lib)
    sl, ll = tf32_round(src.float() - sh), tf32_round(lib.float() - lh)
    return sl @ lh.t() + sh @ ll.t() + sh @ lh.t()


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


def merge_plain(cand_v: torch.Tensor, cand_i: torch.Tensor, k: int):
    """The merge's plain version: candidates [Ls, chunks, kk], each chunk's
    top kk in chunk order (a chunk's places by score, then index) -> (values
    [Ls, k], int32 indices [Ls, k]) of the top k of all, ties to the
    smallest index (the smallest column, in that order)."""
    ls = cand_v.shape[0]
    v, col = topk_exact(cand_v.reshape(ls, -1), k)
    return v, torch.gather(cand_i.reshape(ls, -1), 1, col)


def uses_packed(precision: str, k: int, valid_rows, penalty, extraction: str) -> bool:
    """Whether ``extraction`` resolves to the packed form (knn_pallas.py:323-329)."""
    if extraction not in EXTRACTIONS:
        raise ValueError(f"unknown extraction {extraction!r}")
    return (extraction == "packed" and precision == "default" and valid_rows is None
            and penalty is None and k <= 8)


def packed_keys(sims: torch.Tensor) -> torch.Tensor:
    """The packed extraction's ranking keys of float32 scores [Q, Lr]:
    bits(s + 2) with the low 7 mantissa bits set to 127 - (column % 128)."""
    col = torch.arange(sims.shape[1], device=sims.device, dtype=torch.int32) % _SUB
    bits = (sims.float() + 2.0).view(torch.int32)
    return ((bits & ~(_SUB - 1)) | ((_SUB - 1) - col)[None, :]).view(torch.float32)


def knn_topk_plain(source: torch.Tensor, library: torch.Tensor, k: int = 4,
                   precision: str = "default", valid_rows=None, penalty=None,
                   extraction: str = "auto", q_chunk: int = 1024):
    """(values [Ls, k] float32, indices [Ls, k] int64): the scores of the
    mode's operands computed in float32, plus ``penalty``, rows past
    ``valid_rows`` masked, exact top-k per query (or top-k of the packed
    keys)."""
    packed = uses_packed(precision, k, valid_rows, penalty, extraction)
    src, lib = prep_operands(source, library, precision)
    lr = lib.shape[0]
    lib_t = lib.float().t()
    excluded = None
    if valid_rows is not None:
        vr = torch.clamp(torch.as_tensor(valid_rows, device=lib.device), max=lr)
        excluded = torch.arange(lr, device=lib.device)[None, :] >= vr
    vals, idxs = [], []
    for q0 in range(0, src.shape[0], q_chunk):
        sims = src[q0:q0 + q_chunk].float() @ lib_t
        if penalty is not None:
            sims = sims + penalty.float()[None, :]
        if excluded is not None:
            sims = sims.masked_fill(excluded, float("-inf"))
        if packed:
            sims = packed_keys(sims)
        v, i = topk_exact(sims, k)
        if packed:
            v = v - 2.0
        vals.append(v)
        idxs.append(torch.where(torch.isneginf(v), SENTINEL, i))
    return torch.cat(vals), torch.cat(idxs)


def chunking(ls: int, lr: int) -> Tuple[int, int]:
    """(library rows a block scans, chunks): chunks of 128-row tiles, short
    enough to give every SM work, long enough to amortise the per-block
    start and the merge."""
    want = -(-_MIN_BLOCKS // -(-ls // _QUERIES_PER_BLOCK))
    rows_per_chunk = min(_ROWS_PER_CHUNK, 128 * -(-lr // (128 * want)))
    rows_per_chunk = max(rows_per_chunk, 128 * -(-lr // (128 * _MAX_CHUNKS)))
    return rows_per_chunk, -(-lr // rows_per_chunk)


def knn_topk_cuda(source: torch.Tensor, library: torch.Tensor, k: int = 4,
                  precision: str = "default", valid_rows=None, penalty=None,
                  extraction: str = "auto"):
    """The kernel launch (tile scores + per-block top-k, then the merge).
    It has no backward (indices have none): an input that requires grad in
    grad mode raises."""
    out_v, out_i, _, _ = knn_topk_launch(source, library, k, precision, valid_rows, penalty,
                                         extraction)
    return out_v[:, :k], out_i[:, :k].long()


def knn_topk_launch(source: torch.Tensor, library: torch.Tensor, k: int = 4,
                    precision: str = "default", valid_rows=None, penalty=None,
                    extraction: str = "auto"):
    """``knn_topk_cuda``'s launch with the merge's inputs and outputs: (out
    values, out indices, candidate values, candidate indices), the
    candidates [Ls, chunks, kk] (each chunk's top kk, kk = 4 or 8) and the
    outputs [Ls, kk] (int32 indices), so the merge can be checked and timed
    on its own."""
    _lib.refuse_grad("knn_topk_cuda", source, library, penalty)
    if not 1 <= k <= 8:
        raise ValueError(f"k={k} must be in [1, 8]")
    if library.shape[0] < k:
        raise ValueError(f"library has {library.shape[0]} rows < k={k}")
    packed = uses_packed(precision, k, valid_rows, penalty, extraction)
    src, lib = prep_operands(source, library, precision)
    d = src.shape[1]
    if d % _D_MULT:  # zero columns change no dot product
        src = F.pad(src, (0, _D_MULT - d % _D_MULT))
        lib = F.pad(lib, (0, _D_MULT - d % _D_MULT))
    src, lib = src.contiguous(), lib.contiguous()
    dt = (torch.bfloat16,) if precision == "default" else (torch.float32,)
    _lib.require(src, "source", dt, 2)
    _lib.require(lib, "library", dt, 2)
    if lib.device != src.device or lib.shape[1] != src.shape[1]:
        raise ValueError(f"source {tuple(src.shape)} and library {tuple(lib.shape)} must share "
                         "one device and one width")
    ls, lr = src.shape[0], lib.shape[0]
    vr_ptr = 0
    if torch.is_tensor(valid_rows):
        if valid_rows.numel() != 1 or valid_rows.dtype.is_floating_point:
            raise ValueError("valid_rows must be one integer")
        valid_rows = valid_rows.to(device=src.device, dtype=torch.int32).reshape(())
        vr_ptr = valid_rows.data_ptr()
    elif valid_rows is not None:
        if int(valid_rows) < 1:
            raise ValueError(f"valid_rows={valid_rows} leaves no row")
        lr = min(lr, int(valid_rows))   # the grid stops at the valid rows
    pen_ptr = 0
    if penalty is not None:
        penalty = penalty.float().contiguous()
        _lib.require(penalty, "penalty", (torch.float32,), 1)
        if penalty.shape[0] != lib.shape[0] or penalty.device != src.device:
            raise ValueError(f"penalty must be [{lib.shape[0]}] on {src.device}")
        pen_ptr = penalty.data_ptr()
    kk = 4 if k <= 4 else 8
    rows_per_chunk, n_chunks = chunking(ls, lr)
    dev = src.device
    cand_v = torch.empty((ls, n_chunks, kk), dtype=torch.float32, device=dev)
    cand_i = torch.empty((ls, n_chunks, kk), dtype=torch.int32, device=dev)
    out_v = torch.empty((ls, kk), dtype=torch.float32, device=dev)
    out_i = torch.empty((ls, kk), dtype=torch.int32, device=dev)
    fn = _lib.function("knn", "knn_topk", "ppppppppiiiiiiip")
    rc = fn(src.data_ptr(), lib.data_ptr(), pen_ptr, vr_ptr, cand_v.data_ptr(),
            cand_i.data_ptr(), out_v.data_ptr(), out_i.data_ptr(), ls, lr,
            src.shape[1], kk, int(precision == "default"), int(packed), rows_per_chunk,
            _lib.stream_of(src))
    _lib.check(rc, "knn_topk")
    _lib.LAUNCHES["knn_packed" if packed else "knn"] += 1
    _lib.LAUNCHES["knn_merge"] += 1      # the same call launches the merge kernel
    return out_v, out_i, cand_v, cand_i


def knn_topk(source: torch.Tensor, library: torch.Tensor, k: int = 4,
             precision: str = "default", valid_rows=None, penalty=None,
             extraction: str = "auto"):
    """Cosine top-k of source [Ls, D] against library [Lr, D]: the kernel on
    CUDA tensors, the plain version on CPU tensors."""
    if _lib.route(source) == "cuda":
        return knn_topk_cuda(source, library, k, precision, valid_rows, penalty, extraction)
    return knn_topk_plain(source, library, k, precision, valid_rows, penalty, extraction)


def match_features(source: torch.Tensor, library: torch.Tensor, k: int = 4,
                   alpha: float = 0.0, precision: str = "highest") -> torch.Tensor:
    """source [Ls, D] against library [Lr, D]: the mean of the k nearest
    library rows in float32, alpha-blended with the source
    (``knn_pallas.py:match_features_pallas``)."""
    _, idx = knn_topk(source, library, k=k, precision=precision)
    result = library[idx].float().mean(dim=1)
    return result * (1.0 - alpha) + source.float() * alpha
