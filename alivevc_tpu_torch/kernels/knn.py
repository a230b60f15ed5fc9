"""Cosine top-k over a library: two CUDA forms and their plain PyTorch
version.

Replaces ``alivevc_tpu/kernels/knn_pallas.py:knn_topk_pallas`` and
``alivevc_tpu/kernels/knn_twopass.py:knn_topk_twopass`` with their route
(``knn_pallas.py:244-259``), which ``knn_plan`` keeps:
  * libraries under ``CARRIED_MAX_ROWS`` (4 096) rows take the carried form
    (``csrc/knn_carried.cu``, for JAX's carried kernel): one launch that
    normalises both operands, one that scores, takes the top k and merges
    its blocks' winners;
  * larger libraries take the two-pass form (``csrc/knn.cu``): tile scores
    and per-block top-k, then a merge launch.
Either form takes any library of at least k rows (``form`` forces one).

Precision modes (the JAX names):
  * 'default': bf16 operands, float32 accumulation.  An exact top-k on those
    scores; near-ties may flip against float32 (the licensed bf16 mode).
  * 'high' / 'highest': float32 operands and scores; the ranking is that of
    float32 cosine scores.  The kernel computes them as 3xTF32 on the
    tensor cores (``scores_3xtf32`` emulates it on the CPU): each operand
    splits into TF32 hi + lo, and lo.hi + hi.lo + hi.hi is summed in
    float32, ~2^-22 relative per product.  That is at least as precise as
    JAX's own 'high' (bf16x3, ``knn_twopass.py:246-257``).

What bounds the two-pass form on an H100 is operations: the score
products (3x them in 3xTF32).  A prep launch normalises both operands into
the mode's planes (bf16, or TF32 hi and lo); the tile kernel runs the
products on the tensor cores (``wgmma``, both operands from a TMA ring) in
warp-specialised blocks of 128 queries (a producer warpgroup, two consumer
warpgroups whose folds into register top-k lists overlap each other's
products), the library slabs shared by a cluster of blocks through
multicast copies; a merge launch takes the chunks' winners
(``csrc/knn.cu``; ``twopass_plan`` chooses the grid).  What
bounds the carried form at its shapes (the streaming hop's 24 queries, a
512-token voice library) is latency: it puts the library on the wgmma's M
side and up to 128 queries on N, and takes no host operation but its
outputs, its scratch and one C call (``csrc/knn_carried.cu``).

Normalisation is ``x * rsqrt(max(sum x^2, 1e-30))`` in float32 before the
mode cast (``knn_twopass.py:230-234``): the two-pass form takes each row's
scale from PyTorch's own sum (``row_scales``, as the plain version does)
and its prep launch multiplies and casts; the carried form's first launch
sums the squares in another order (the two forms may differ in a score's
last bits).  Ties go to the smallest library index.

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

L2 mode (``normalize=False``; ``l2_topk``): the operands as they are (row
scales of one in the prep launch), and the penalty ``l2_penalty(library)`` =
-1/2 |x|^2, so the tile ranks q.x - |x|^2 / 2 = (|q|^2 - |q - x|^2) / 2:
the order of increasing squared L2 distance, ties to the smallest index.  It
takes the two-pass form at any library size (the carried form normalises
inside its own first launch), so ``knn_topk`` and ``knn_topk_cuda`` have
no such mode.

``extraction='packed'`` (``knn_pallas.py:_knn_kernel_fast``/``_pack_topk``)
applies only to 'default' with no exclusion and k <= 8, and falls back to
the exact extraction otherwise, as ``knn_pallas.py:323-329`` does.  Scores
are ranked by ``bits(s + 2)`` with the low 7 mantissa bits replaced by
``127 - (column % 128)``, ties to the smaller index, and returned as that
key minus 2 (within 3.1e-5 of the score).  'auto' is the exact extraction.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from alivevc_tpu_torch.kernels import _lib

PRECISIONS = ("default", "high", "highest")
EXTRACTIONS = ("auto", "exact", "packed")
SENTINEL = 2**31 - 1         # index of a place no valid row filled
_QUERIES_PER_BLOCK = 128     # csrc/knn.cu: TQ, two consumer warpgroups of 64
_MAX_CHUNKS = 65535          # chunks ride gridDim.y
TWOPASS_CLUSTERS = (2, 1)    # blocks of a cluster along the queries (csrc/knn.cu)
_TWOPASS_BLOCK_TILES = 1.0   # a block's set-up, ring fill and epilogue, in tiles (the plan's cost)
TWOPASS_SLAB = 128           # csrc/knn.cu: SLAB_BYTES, bytes of a row a ring stage holds
_SUB = 128                   # packed extraction's subtile width (7 index bits)
FORMS = ("carried", "twopass")
CARRIED_MAX_ROWS = 4096      # knn_pallas.py:244-259: smaller libraries take the carried kernel
CARRIED_NQ = (8, 24, 64, 128)  # csrc/knn_carried.cu: queries a block (the wgmma N)
CARRIED_WG = (1, 2)          # warpgroups a block, 64 library rows each
CARRIED_SPLITS = (4, 2, 1)   # blocks of a cluster that split the depth
CARRIED_MAX_STAGES = 4       # csrc/knn_carried.cu: ring stages, at most
SMEM_LIMIT = 232_448 - 1024  # a block's 227 KB on an H100, less room for the static flag
SMEM_PER_SM = 233_472        # shared memory of an SM; 1 KB of it is reserved a block
H100_SMS = 132
_HEAD = 1024                 # csrc/knn_carried.cu: HEAD_BYTES
_S_PAD = 4                   # csrc/knn_carried.cu: S_PAD


def row_scales(x: torch.Tensor) -> torch.Tensor:
    """[N, 1] float32 rsqrt(max(sum x^2, 1e-30)) of the rows of x, PyTorch's
    own sum: the plain version's and the two-pass prep launch's scale."""
    x = x.float()
    return torch.rsqrt(torch.clamp((x * x).sum(dim=1, keepdim=True), min=1e-30))


def normalize_rows(x: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """x * rsqrt(max(sum x^2, 1e-30)) per row in float32, stored as ``dtype``."""
    x = x.float()
    return torch.mul(x, row_scales(x), out=torch.empty(x.shape, dtype=dtype, device=x.device))


def prep_operands(source: torch.Tensor, library: torch.Tensor, precision: str, normalize: bool = True):
    """Normalised operands (as they are in the L2 mode) in the mode's type:
    bf16 for 'default' (the float32 product rounded once as it is stored),
    float32 otherwise."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    dt = torch.bfloat16 if precision == "default" else torch.float32
    if not normalize:
        return source.float().to(dt), library.float().to(dt)
    return normalize_rows(source, dt), normalize_rows(library, dt)


def l2_penalty(library: torch.Tensor) -> torch.Tensor:
    """[Lr] float32 -|x|^2 / 2 of the library's rows: the L2 mode's penalty,
    computed once a library."""
    x = library.float()
    return (x * x).sum(dim=1) * -0.5


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
                   extraction: str = "auto", q_chunk: int = 1024, normalize: bool = True):
    """(values [Ls, k] float32, indices [Ls, k] int64): the scores of the
    mode's operands computed in float32, plus ``penalty``, rows past
    ``valid_rows`` masked, exact top-k per query (or top-k of the packed
    keys)."""
    packed = uses_packed(precision, k, valid_rows, penalty, extraction)
    src, lib = prep_operands(source, library, precision, normalize)
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


def prep_width(d: int, precision: str) -> int:
    """Columns of a prepared row (``csrc/knn.cu:knn_prep``): d padded to a
    whole number of 128-byte slabs, 64 bf16 or 32 float32 values."""
    mult = 64 if precision == "default" else 32
    return -(-d // mult) * mult


def knn_prep_plain(source: torch.Tensor, library: torch.Tensor, precision: str, normalize: bool = True):
    """The prep launch's plain version: both operands normalised in float32
    (``normalize_rows``; as they are in the L2 mode), columns zero-padded to
    ``prep_width``, as bf16 [rows, dp] for 'default' or as TF32 planes [2,
    rows, dp] (hi = ``tf32_round(x)``, lo = ``tf32_round(x - hi)``) for
    'high'/'highest'."""
    out = []
    for x in prep_operands(source, library, precision, normalize):
        x = F.pad(x.float(), (0, prep_width(x.shape[1], precision) - x.shape[1]))
        if precision == "default":
            out.append(x.to(torch.bfloat16))
        else:
            hi = tf32_round(x)
            out.append(torch.stack([hi, tf32_round(x - hi)]))
    return tuple(out)


def scores_from_planes(q: torch.Tensor, lib: torch.Tensor) -> torch.Tensor:
    """[Ls, Lr] float32 scores of prepared operands as the tile kernel forms
    them: bf16 products summed in float32, or lo.hi + hi.lo + hi.hi of the
    TF32 planes (``scores_3xtf32``'s order)."""
    if q.dim() == 2:
        return q.float() @ lib.float().t()
    return q[1] @ lib[0].t() + q[0] @ lib[1].t() + q[0] @ lib[0].t()


def twopass_tile(precision: str):
    """(library rows a tile, ring stages) of the tile kernel in this mode
    (csrc/knn.cu: Tile): bf16 256 rows (m64n256k16, 48 KB stages), 3xTF32
    128 rows (m64n128k8 on hi and lo planes, 64 KB stages)."""
    return (256, 4) if precision == "default" else (128, 3)


def twopass_smem(precision: str, stages: int) -> int:
    """csrc/knn.cu:twopass_smem: alignment slack and the mbarriers, then
    the ring of stages (the query slab, then the library slab; TF32 hi and
    lo planes of each)."""
    lt, _ = twopass_tile(precision)
    planes = 1 if precision == "default" else 2
    return 2 * _HEAD + stages * planes * (_QUERIES_PER_BLOCK + lt) * TWOPASS_SLAB


class KnnPlan(NamedTuple):
    """How ``knn_topk_cuda`` runs one call.  ``form`` 'twopass'
    (``twopass_plan``): ``q_tiles`` tiles of 128 queries (padded to whole
    clusters) x ``chunks`` chunks of ``rows_per_chunk`` library rows, a
    block each, in clusters of ``cluster`` blocks along the queries;
    ``tile_l`` library rows a tile, ``stages`` ring stages, ``smem`` bytes
    of dynamic shared memory;
    ``waves`` of blocks at one a multiprocessor and the last one's ``fill``.
    ``form`` 'carried': ``nq`` queries and ``64 wg`` library rows a block, a
    grid of ``q_tiles`` x ``lib_blocks`` clusters of ``split`` blocks that
    split the depth, ``stages`` ring stages, ``smem`` bytes of dynamic
    shared memory, ``scratch`` bytes of scratch (csrc/knn_carried.cu)."""
    form: str
    rows_per_chunk: int = 0
    chunks: int = 0
    nq: int = 0
    wg: int = 0
    q_tiles: int = 0
    lib_blocks: int = 0
    split: int = 0
    stages: int = 0
    smem: int = 0
    scratch: int = 0
    tile_l: int = 0
    cluster: int = 0
    waves: int = 0
    fill: float = 0.0


@functools.lru_cache(maxsize=4096)
def twopass_plan(ls: int, lr: int, precision: str = "default", k: int = 4, packed: bool = False,
                 sms: int = H100_SMS) -> KnnPlan:
    """The two-pass form's grid for ``ls`` queries over ``lr`` ranked rows.
    The tile and ring are the mode's (``twopass_tile``; k and the packed
    extraction change neither).  The cluster: 2 where there are two query
    tiles or more (multicast halves the library's L2 reads), else 1.  Then the
    chunk count that gives the fewest waves of blocks (one a
    multiprocessor, whole clusters resident) times the tiles a block walks
    plus ``_TWOPASS_BLOCK_TILES``, and of those the fewest chunks; at most
    65 535 chunks.  A chunk is a whole number of tiles."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    lt, stages = twopass_tile(precision)
    q_tiles = -(-ls // _QUERIES_PER_BLOCK)
    cluster = next(c for c in TWOPASS_CLUSTERS if c <= q_tiles)
    qp = -(-q_tiles // cluster) * cluster
    resident = sms // cluster * cluster
    tiles = -(-max(1, lr) // lt)
    best, best_key = None, None
    for want in range(1, min(tiles, _MAX_CHUNKS) + 1):
        per = -(-tiles // want)
        chunks = -(-tiles // per)
        if chunks != want:
            continue
        waves = -(-qp * chunks // resident)
        key = (waves * (per + _TWOPASS_BLOCK_TILES), chunks)
        if best_key is None or key < best_key:
            best_key, best = key, (per, chunks, waves)
    per, chunks, waves = best
    blocks = qp * chunks
    return KnnPlan("twopass", rows_per_chunk=per * lt, chunks=chunks, q_tiles=qp, stages=stages,
                   smem=twopass_smem(precision, stages), tile_l=lt, cluster=cluster, waves=waves,
                   fill=(blocks - (waves - 1) * resident) / resident)


def chunking(ls: int, lr: int, precision: str = "default") -> Tuple[int, int]:
    """(library rows a block scans, chunks) of ``twopass_plan``."""
    plan = twopass_plan(ls, lr, precision)
    return plan.rows_per_chunk, plan.chunks


def _mode(precision: str, packed: bool) -> int:
    """csrc/knn_carried.cu's mode: 0 3xTF32, 1 bf16, 2 bf16 packed."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    return 2 if packed else int(precision == "default")


def carried_smem(nq: int, wg: int, stages: int, mode: int) -> int:
    """Dynamic shared memory of a carried block: alignment slack and the
    mbarriers, then the larger of the ring and the score rows."""
    planes = 2 if mode == 0 else 1
    ring = stages * planes * (64 * wg + nq) * 128
    return 2 * _HEAD + max(ring, nq * (64 * wg + _S_PAD) * 4)


def carried_scratch_bytes(ls: int, lr: int, lv: int, d: int, k: int, mode: int, nq: int,
                          wg: int) -> int:
    """csrc/knn_carried.cu:knn_carried_scratch_bytes: the prepared operands
    (bf16, or TF32 hi and lo planes, columns padded to whole slabs), and with
    more than one library block the blocks' lists and a counter a query
    tile; each region rounded up to 1024 bytes."""
    def up(x, m=1024):
        return -(-x // m) * m
    tf32 = mode == 0
    dp, esize, planes = up(d, 32 if tf32 else 64), 4 if tf32 else 2, 2 if tf32 else 1
    kk = 4 if k <= 4 else 8
    n_lb, q_tiles = -(-min(lr, lv) // (64 * wg)), -(-ls // nq)
    total = up(planes * ls * dp * esize) + up(planes * lr * dp * esize)
    if n_lb > 1:
        total += 2 * up(ls * n_lb * kk * 4) + up(q_tiles * 4)
    return total


def carried_split(ls: int, d: int, mode: int) -> int:
    """Blocks that split the depth of a carried score tile: 4 (at most the
    slabs a row has) where the queries fit one tile, else 1.  It depends on
    the queries and the width alone, never on the library, so that a row
    scores the same bits on one rank and in any shard."""
    slabs = -(-d // (32 if mode == 0 else 64))
    if ls > CARRIED_NQ[-1]:
        return 1
    return next(s for s in CARRIED_SPLITS if s <= slabs)


@functools.lru_cache(maxsize=4096)
def _carried_plan(ls: int, lr: int, lv: int, d: int, k: int, mode: int, sms: int) -> KnnPlan:
    split = carried_split(ls, d, mode)
    slabs = -(-d // (32 if mode == 0 else 64))       # 128-byte slabs of a row
    steps = -(-slabs // split)                       # ... that a block walks
    cover = next((nq for nq in CARRIED_NQ if nq >= ls), CARRIED_NQ[-1])
    # a query tile narrower than the queries only where they need several
    choices = [nq for nq in CARRIED_NQ if nq <= cover] if ls > CARRIED_NQ[-1] else [cover]
    best, best_key = None, None
    rows = min(lr, lv)
    for nq in choices:
        for wg in CARRIED_WG:
            stage = (2 if mode == 0 else 1) * (64 * wg + nq) * 128
            stages = min(CARRIED_MAX_STAGES, (SMEM_LIMIT - 2 * _HEAD) // stage)
            if stages < 2:      # one stage refills while another is read
                continue
            stages = max(2, min(stages, steps))
            q_tiles, lib_blocks = -(-ls // nq), -(-rows // (64 * wg))
            blocks = q_tiles * lib_blocks * split
            smem = carried_smem(nq, wg, stages, mode)
            per_sm = max(1, SMEM_PER_SM // (smem + 1024))
            waves = -(-blocks // (sms * per_sm))
            # each block streams its (64 wg + nq) rows over the whole depth
            key = (waves * (64 * wg + nq), blocks)
            if best_key is None or key < best_key:
                best_key = key
                best = KnnPlan("carried", nq=nq, wg=wg, q_tiles=q_tiles, lib_blocks=lib_blocks,
                               split=split, stages=stages, smem=smem,
                               scratch=carried_scratch_bytes(ls, lr, lv, d, k, mode, nq, wg))
    return best


def knn_form(lr: int, route_rows: Optional[int] = None) -> str:
    """'carried' below ``CARRIED_MAX_ROWS`` rows of ``route_rows`` (default
    ``lr``), else 'twopass' (``knn_pallas.py:244-259``)."""
    return "carried" if (lr if route_rows is None else route_rows) < CARRIED_MAX_ROWS else "twopass"


def knn_plan(ls: int, lr: int, precision: str = "default", k: int = 4, form: Optional[str] = None,
             route_rows: Optional[int] = None, valid_rows: Optional[int] = None, d: int = 768,
             packed: bool = False, sms: int = H100_SMS) -> KnnPlan:
    """The form and launch shape of a top-k of ``ls`` queries over ``lr``
    rows (``valid_rows`` of them ranked, where it is a host count) of width
    ``d``.  The form: ``form`` if given, else 'carried' below
    ``CARRIED_MAX_ROWS`` rows of ``route_rows`` (the whole library's rows;
    the sharded path passes them, so that every shard takes the form one
    rank takes), default ``lr``.  The carried form's tile: the query width
    ``nq`` that covers the queries (a narrower one too where more than 128
    queries need several tiles) and ``wg``, chosen for the fewest waves of
    blocks times the rows each block streams (its ``64 wg`` library rows
    and ``nq`` queries), then for the fewest blocks; ``carried_split``
    blocks a tile; up to 4 ring stages, at most the slabs a block walks."""
    form = form or knn_form(lr, route_rows)
    if form not in FORMS:
        raise ValueError(f"unknown form {form!r}")
    lv = lr if valid_rows is None else max(1, min(lr, int(valid_rows)))
    if form == "twopass":
        return twopass_plan(ls, lv, precision, k, packed, sms)
    return _carried_plan(ls, lr, lv, d, k, _mode(precision, packed), sms)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def knn_topk_cuda(source: torch.Tensor, library: torch.Tensor, k: int = 4,
                  precision: str = "default", valid_rows=None, penalty=None,
                  extraction: str = "auto", form: Optional[str] = None,
                  route_rows: Optional[int] = None):
    """The kernel launches of the form ``knn_plan`` takes (``form`` forces
    one; ``route_rows``: the whole library's rows, when ``library`` is a
    shard of it).  They have no backward (indices have none): an input that
    requires grad in grad mode raises."""
    form = form or knn_form(library.shape[0], route_rows)
    if form == "carried":
        return knn_topk_carried(source, library, k, precision, valid_rows, penalty, extraction)
    if form != "twopass":
        raise ValueError(f"unknown form {form!r}")
    out_v, out_i, _, _ = knn_topk_launch(source, library, k, precision, valid_rows, penalty,
                                         extraction)
    return out_v[:, :k], out_i[:, :k].long()


def knn_topk_carried(source: torch.Tensor, library: torch.Tensor, k: int = 4,
                     precision: str = "default", valid_rows=None, penalty=None,
                     extraction: str = "auto"):
    """The carried form (``csrc/knn_carried.cu``): the rows as they come
    (float32; the first launch normalises them), values [Ls, k] float32 and
    indices [Ls, k] int64 written by the second launch.  One count in
    ``_lib.LAUNCHES`` a call ('knn_carried', or 'knn_carried_packed')."""
    _lib.refuse_grad("knn_topk_cuda", source, library, penalty)
    if not 1 <= k <= 8:
        raise ValueError(f"k={k} must be in [1, 8]")
    if library.shape[0] < k:
        raise ValueError(f"library has {library.shape[0]} rows < k={k}")
    packed = uses_packed(precision, k, valid_rows, penalty, extraction)
    mode = _mode(precision, packed)
    src = (source if source.dtype == torch.float32 else source.float()).contiguous()
    lib = (library if library.dtype == torch.float32 else library.float()).contiguous()
    _lib.require(src, "source", (torch.float32,), 2)
    _lib.require(lib, "library", (torch.float32,), 2)
    if lib.device != src.device or lib.shape[1] != src.shape[1]:
        raise ValueError(f"source {tuple(src.shape)} and library {tuple(lib.shape)} must share "
                         "one device and one width")
    ls, lr, d = src.shape[0], lib.shape[0], src.shape[1]
    vr_ptr, lv, pen_ptr, _keep = _exclusion_args(valid_rows, penalty, src.device, lr)
    dev = src.device
    plan = _carried_plan(ls, lr, lv, d, k, mode, _sm_count(src.get_device()))
    scratch = torch.empty(plan.scratch, dtype=torch.uint8, device=dev)
    out_v = torch.empty((ls, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((ls, k), dtype=torch.int64, device=dev)
    fn = _lib.function("knn_carried", "knn_carried", "ppppplppiiiiiiiiiip")
    rc = fn(src.data_ptr(), lib.data_ptr(), pen_ptr, vr_ptr, scratch.data_ptr(), plan.scratch,
            out_v.data_ptr(), out_i.data_ptr(), ls, lr, lv, d, k, mode, plan.nq, plan.wg,
            plan.split, plan.stages, _lib.stream_of(src))
    _lib.check(rc, "knn_carried")
    _lib.LAUNCHES["knn_carried_packed" if packed else "knn_carried"] += 1
    return out_v, out_i


def _exclusion_args(valid_rows, penalty, device: torch.device, lr: int):
    """The exclusion arguments of a launch: (valid-row count pointer or 0,
    rows the grid covers, penalty pointer or 0, the tensors behind the
    pointers, which the caller keeps until the launch).  A device count is
    read by the kernel (no host sync); a host count stops the grid."""
    vr_ptr, lv, keep = 0, lr, []
    if torch.is_tensor(valid_rows):
        if valid_rows.numel() != 1 or valid_rows.dtype.is_floating_point:
            raise ValueError("valid_rows must be one integer")
        valid_rows = valid_rows.to(device=device, dtype=torch.int32).reshape(())
        vr_ptr = valid_rows.data_ptr()
        keep.append(valid_rows)
    elif valid_rows is not None:
        if int(valid_rows) < 1:
            raise ValueError(f"valid_rows={valid_rows} leaves no row")
        lv = min(lr, int(valid_rows))
    pen_ptr = 0
    if penalty is not None:
        penalty = penalty.float().contiguous()
        _lib.require(penalty, "penalty", (torch.float32,), 1)
        if penalty.shape[0] != lr or penalty.device != device:
            raise ValueError(f"penalty must be [{lr}] on {device}")
        pen_ptr = penalty.data_ptr()
        keep.append(penalty)
    return vr_ptr, lv, pen_ptr, keep


def knn_prep_cuda(source: torch.Tensor, library: torch.Tensor, precision: str, rows: Optional[int] = None,
                  normalize: bool = True):
    """The prep launch (``csrc/knn.cu:knn_prep``): ``knn_prep_plain``'s
    planes of the source and of the library's first ``rows`` rows (all by
    default), computed on the card.  Each row's scale is ``row_scales``'s,
    as in the plain version (one in the L2 mode); the kernel multiplies,
    casts or splits, and pads.  One count of 'knn_prep'."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    rows = library.shape[0] if rows is None else rows
    src = source.float().contiguous()
    lib = library[:rows].float().contiguous()
    _lib.require(src, "source", (torch.float32,), 2)
    _lib.require(lib, "library", (torch.float32,), 2)
    if lib.device != src.device or lib.shape[1] != src.shape[1]:
        raise ValueError(f"source {tuple(src.shape)} and library {tuple(lib.shape)} must share "
                         "one device and one width")
    if normalize:
        scale_q, scale_l = row_scales(source), row_scales(library)[:rows]
    else:
        scale_q = torch.ones((src.shape[0], 1), dtype=torch.float32, device=src.device)
        scale_l = torch.ones((rows, 1), dtype=torch.float32, device=src.device)
    ls, lr, d = src.shape[0], lib.shape[0], src.shape[1]
    dp = prep_width(d, precision)
    if precision == "default":
        q = torch.empty((ls, dp), dtype=torch.bfloat16, device=src.device)
        lb = torch.empty((lr, dp), dtype=torch.bfloat16, device=src.device)
    else:
        q = torch.empty((2, ls, dp), dtype=torch.float32, device=src.device)
        lb = torch.empty((2, lr, dp), dtype=torch.float32, device=src.device)
    fn = _lib.function("knn", "knn_prep", "ppppppiiiiip")
    rc = fn(src.data_ptr(), lib.data_ptr(), scale_q.data_ptr(), scale_l.data_ptr(), q.data_ptr(),
            lb.data_ptr(), ls, lr, d, dp, _mode(precision, False), _lib.stream_of(src))
    _lib.check(rc, "knn_prep")
    _lib.LAUNCHES["knn_prep"] += 1
    return q, lb


def knn_topk_launch(source: torch.Tensor, library: torch.Tensor, k: int = 4,
                    precision: str = "default", valid_rows=None, penalty=None,
                    extraction: str = "auto", normalize: bool = True):
    """The two-pass form's launches with the merge's inputs and outputs: (out
    values, out indices, candidate values, candidate indices), the
    candidates [Ls, chunks, kk] (each chunk's top kk, kk = 4 or 8) and the
    outputs [Ls, kk] (int32 indices), so the merge can be checked and timed
    on its own.  Counts 'knn_prep', 'knn' (or 'knn_packed') and 'knn_merge'
    once each."""
    _lib.refuse_grad("knn_topk_cuda", source, library, penalty)
    if not 1 <= k <= 8:
        raise ValueError(f"k={k} must be in [1, 8]")
    if library.shape[0] < k:
        raise ValueError(f"library has {library.shape[0]} rows < k={k}")
    packed = uses_packed(precision, k, valid_rows, penalty, extraction)
    vr_ptr, lr, pen_ptr, _keep = _exclusion_args(valid_rows, penalty, source.device, library.shape[0])
    # rows past a host count never rank: they are not prepared
    q, lb = knn_prep_cuda(source, library, precision, rows=lr, normalize=normalize)
    ls, dp = q.shape[-2], q.shape[-1]
    kk = 4 if k <= 4 else 8
    plan = twopass_plan(ls, lr, precision, k, packed, _sm_count(q.get_device()))
    dev = q.device
    cand_v = torch.empty((ls, plan.chunks, kk), dtype=torch.float32, device=dev)
    cand_i = torch.empty((ls, plan.chunks, kk), dtype=torch.int32, device=dev)
    out_v = torch.empty((ls, kk), dtype=torch.float32, device=dev)
    out_i = torch.empty((ls, kk), dtype=torch.int32, device=dev)
    fn = _lib.function("knn", "knn_topk", "ppppppppiiiiiiiip")
    rc = fn(q.data_ptr(), lb.data_ptr(), pen_ptr, vr_ptr, cand_v.data_ptr(), cand_i.data_ptr(),
            out_v.data_ptr(), out_i.data_ptr(), ls, lr, dp, kk, _mode(precision, packed),
            plan.rows_per_chunk, plan.cluster, plan.stages, _lib.stream_of(q))
    _lib.check(rc, "knn_topk")
    _lib.LAUNCHES["knn_packed" if packed else "knn"] += 1
    _lib.LAUNCHES["knn_merge"] += 1      # the same call launches the merge kernel
    return out_v, out_i, cand_v, cand_i


def knn_topk(source: torch.Tensor, library: torch.Tensor, k: int = 4,
             precision: str = "default", valid_rows=None, penalty=None,
             extraction: str = "auto", route_rows: Optional[int] = None):
    """Cosine top-k of source [Ls, D] against library [Lr, D]: the kernels on
    CUDA tensors (the form ``knn_plan`` routes ``route_rows`` to, default
    Lr), the plain version on CPU tensors."""
    if _lib.route(source) == "cuda":
        return knn_topk_cuda(source, library, k, precision, valid_rows, penalty, extraction,
                             route_rows=route_rows)
    return knn_topk_plain(source, library, k, precision, valid_rows, penalty, extraction)


def l2_topk(source: torch.Tensor, library: torch.Tensor, penalty: torch.Tensor, k: int = 8,
            precision: str = "high"):
    """The k library rows nearest source [Ls, D] by L2 distance, ties to the
    smallest index: (scores q.x - |x|^2 / 2 [Ls, k] float32, indices [Ls, k]
    int64), ``penalty`` being ``l2_penalty(library)``.  On CUDA tensors the
    two-pass launches at any library size, the plain version on CPU
    tensors."""
    if _lib.route(source) == "cuda":
        out_v, out_i, _, _ = knn_topk_launch(source, library, k, precision, penalty=penalty, normalize=False)
        return out_v[:, :k], out_i[:, :k].long()
    return knn_topk_plain(source, library, k, precision, penalty=penalty, normalize=False)


def match_features(source: torch.Tensor, library: torch.Tensor, k: int = 4,
                   alpha: float = 0.0, precision: str = "highest") -> torch.Tensor:
    """source [Ls, D] against library [Lr, D]: the mean of the k nearest
    library rows in float32, alpha-blended with the source
    (``knn_pallas.py:match_features_pallas``)."""
    _, idx = knn_topk(source, library, k=k, precision=precision)
    result = library[idx].float().mean(dim=1)
    return result * (1.0 - alpha) + source.float() * alpha
