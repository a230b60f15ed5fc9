"""One up level of the filter U-Net: CUDA kernels (``csrc/filter.cu``) and
their plain PyTorch version.

Replaces ``alivevc_tpu/kernels/filter_pallas.py:fused_filter_block_up``
(``_fused_impl``), which runs every up level of ``filter_unet_packed`` on
the TPU.  A level computes

    x = up_conv(x_prev + skip)           transposed conv, kernel = stride = rate
    x = input_conv(x)                    1x1
    3 x: res = x
         x = conv_c1(FiLM_c1(gelu(x)))   causal, k = 5, dilation 1 / 2 / 4,
         x = conv_c2(FiLM_c2(gelu(x))) + res        reflect head

where FiLM is ``x * scale + shift`` with scale (= linear(cond) + 1) and shift
given at frame rate and interpolated to sample rate (align_corners=False).
Tensors are channels-last; storage is float32 or bf16 and the arithmetic
float32.  The plain version rounds to the storage type where the kernels do
(each a no-op in float32):
  1. the sum ``x_prev + skip`` (the up conv's operand);
  2. the up conv's output;
  3. the 1x1 conv's output;
  4. each causal conv's operand ``gelu(x) * scale + shift``;
  5. each causal conv's output, and on the second conv of a block its sum
     with the block's input (the JAX kernel rounds at the same two points).

Weight layouts (the JAX package's): ``up_w`` [C_in, rate*C] (column
j*C + c is tap j of output channel c), ``in_w`` [C, C] ([in, out]),
``conv_w[i]`` [k, C, C] ([tap, in, out]).  ``film`` is one frame-rate tensor
[N, F, 2 * n_conv * C]: columns [2 i C, (2 i + 1) C) hold the scale of conv i
(the +1 included), the next C columns its shift
(``models/decoder.py:level_args``).

Routes on the card (``filter_level_cuda``): a level with C = 8 or 16 runs as
one ``filter_narrow_weights_kernel`` launch (its weights in the layout the
products read, float32 as TF32 hi/lo, and its biases) and one launch of
``filter_narrow_kernel`` (up conv, 1x1 and the six convs of a time tile on
chip, on ``wgmma``, inputs, FiLM frames and weights by TMA, the output by
TMA store; each tile recomputes its lookback, a tile that reaches sample 0
reflects in place; its tiles, warpgroups and ring from ``narrow_plan``);
any other level as one
``filter_wide_weights_kernel`` launch (every weight of the level K-major,
[out][(tap, in)], and in float32 its TF32 hi/lo split) and 8 launches of
``filter_wide_kernel`` (the up conv and the 1x1 as products, then one
implicit GEMM per causal conv) on ``wgmma``: the operand from registers
(ldmatrix at any row, which the dilated taps need), the weights by TMA
into an mbarrier ring, the next operand chunk staged by the block in the
shadow of the current chunk's products, a persistent grid.  Each launch's
tile shape, K split and cluster come from ``wide_plan``; at few rows (the
streaming hop) it splits K over a cluster of 2 or 4 blocks that reduce
through distributed shared memory in a fixed order.  Every product runs
on the tensor cores: bf16 operands with float32 accumulation in bf16
storage, 3xTF32 in float32 storage.  ``filter_level_tiled`` replays the
narrow kernel's tiling, ``filter_level_wide_replay`` the wide kernel's K
order and split, optionally with the 3xTF32 products, on the CPU for the
tests.

Gradients (training): on the card a level runs through
``FilterLevelFunction``, whose forward is the kernel launch and whose
backward recomputes ``filter_level_plain`` on detached copies of the saved
inputs and differentiates it, as ``filter_pallas.py:_fused_cvjp_bwd``
differentiates the packed XLA version of the Pallas forward.  No backward
kernel is written: JAX has none either.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from alivevc_tpu_torch.kernels import _lib
from alivevc_tpu_torch.kernels.knn import tf32_round
from alivevc_tpu_torch.ops.interp import linear_interpolate

NARROW_C = (8, 16)     # channel counts of the one-launch kernel (csrc/filter.cu)
NARROW_MAX_CIN = 128   # up-conv input channels the narrow route takes
NARROW_MAX_RATE = 8
MAX_CONV = 8
MAX_TAPS = 7
MAX_HALO = 24          # (k - 1) * dilation of one causal conv, at most
DILATIONS = (1, 1, 2, 2, 4, 4)   # the default level's causal convs (k = 5)


def film_of(film: torch.Tensor, i: int, c: int):
    """(scale, shift) [N, F, C] of causal conv ``i`` in the level's FiLM tensor."""
    return film[..., 2 * i * c:(2 * i + 1) * c], film[..., (2 * i + 1) * c:(2 * i + 2) * c]


def lookback(k: int, dilations: Sequence[int]) -> int:
    """Samples of history the level's causal convs read together: 56 for
    k = 5 and dilations (1, 1, 2, 2, 4, 4)."""
    return sum((k - 1) * d for d in dilations)


def narrow_lead(k: int, dilations: Sequence[int], rate: int) -> int:
    """Rows a narrow tile computes before the samples it writes: the
    lookback rounded up to a multiple of 8 and of the rate (56 at the
    default levels)."""
    unit = math.lcm(8, rate)
    return -(-lookback(k, dilations) // unit) * unit


def takes_narrow(c: int, c_in: int, rate: int, k: int, dilations: Sequence[int]) -> bool:
    """Whether a level runs as one ``filter_narrow_kernel`` launch (else the
    wide route): C = 8 or 16, the up conv's inputs and rate within the
    narrow route's limits."""
    return c in NARROW_C and c_in <= NARROW_MAX_CIN and rate <= NARROW_MAX_RATE


# The narrow kernel's shared memory (csrc/filter.cu:narrow_layout; the card
# test test_narrow_layout_formula_on_card holds the two to each other)
NARROW_UP_ROWS = 64      # input rows an up-conv chunk
NARROW_SLAB = 32         # bytes of K a weight slab row
NARROW_HOFF = MAX_HALO   # operand rows above a tile
NARROW_MAX_ROWS = 2048   # rows a tile computes, at most
NARROW_MAX_STAGES = 4    # input chunks in flight a tile
NARROW_MIN_BLOCKS = 64   # the grid the plan narrows tiles for at few windows
SMEM_LIMIT = 232_448     # dynamic shared memory a block may take on the H100
H100_SMS = 132


def _align(b: int, a: int) -> int:
    return -(-b // a) * a


def narrow_max_wgs(c: int, dtype: torch.dtype) -> int:
    """Warpgroups a narrow block may hold (``csrc/filter.cu:narrow_max_wgs``):
    4, 2 in float32 at C = 16."""
    return 2 if dtype == torch.float32 and c == 16 else 4


def narrow_layout(n_conv: int, k: int, cin: int, c: int, rate: int, frame_rate: int, rows: int,
                  owners: int, stages: int, dtype: torch.dtype) -> dict:
    """The narrow kernel's shared-memory bytes (``smem``) and weight blob
    bytes (``blob``) for tiles of ``rows`` computed rows, ``owners`` tiles a
    block at once and ``stages`` input chunks in flight, at ``frame_rate``
    samples a FiLM frame: the head (mbarriers, zeros), the blob, and per
    tile owner the input ring, the two operand buffers, the level state X,
    each row's FiLM mix and the FiLM table."""
    es = 2 if dtype == torch.bfloat16 else 4
    ms = -(-rows // 64)
    fbox = -(-(rows - 1) // frame_rate) + 2
    rowbytes = cin * es
    swz = rowbytes if rowbytes in (32, 64, 128) else (128 if rowbytes % 128 == 0 else 0)
    bw = min(rowbytes, 128) if swz else rowbytes
    stage = _align(2 * (rowbytes // bw) * NARROW_UP_ROWS * bw, 1024)
    g = _align((NARROW_HOFF + 64 * ms) * c * es, 128)
    x = _align(max(64 * ms * c * es, fbox * 2 * n_conv * c * es), 128)
    rt = _align(64 * ms * 8, 128)
    tab = _align(fbox * n_conv * c * 16, 128)
    region = _align(stages * stage + 2 * g + x + rt + tab, 1024)

    def slabs(kdim):
        return -(-kdim * es // NARROW_SLAB)

    hi = NARROW_SLAB * (rate * c * slabs(cin) + c * slabs(c) + n_conv * c * slabs(k * c))
    blob = hi * (1 if es == 2 else 2) + (2 + n_conv) * c * 4
    return {"smem": 2048 + _align(blob, 1024) + owners * region, "blob": blob, "subtiles": ms,
            "frames": fbox}


@functools.lru_cache(maxsize=256)
def narrow_plan(n: int, length: int, cin: int, c: int, rate: int, dtype: torch.dtype,
                frame_rate: int = 160, k: int = 5, dilations: Sequence[int] = DILATIONS,
                sms: int = H100_SMS) -> dict:
    """The launch plan of one ``filter_narrow_kernel`` launch over ``n``
    windows of ``length`` output samples (``cin`` input channels, ``c``
    output, up-conv ``rate``, ``frame_rate`` samples a FiLM frame), on a
    card of ``sms`` SMs:

    - ``lead``: the rows a tile computes before the samples it writes
      (``narrow_lead``); ``share`` = lead / rows, the work the lookback
      repeats;
    - ``owners``: tiles a block works on at once, each with buffers and a
      warpgroup of its own: 2 where two fit in shared memory with tiles
      whose lookback is at most 10 % of their rows, else 1;
    - ``rows``: the rows a tile computes, a multiple of 64 up to what the
      shared memory takes, chosen among those with at most 10 % lookback
      (or the largest that fits) to even out the last wave (the fewest
      rows a tile owner computes); ``T`` = rows - lead;
    - at few windows (the streaming hop), where those tiles would give
      fewer than 64 blocks (``narrowed``): one owner a block and ``T``
      narrowed (in steps of 8 and of the rate) until the grid covers 64
      SMs, whatever the lookback's share;
    - ``wpt``: warpgroups a tile, which split its 64-row subtiles: as many
      as the block holds (4 warpgroups, 2 in float32 at C = 16: their
      registers) over its owners, at most one a subtile, and fewer where
      no ring (below) fits; ``wgs`` = owners x wpt warpgroups a block;
    - ``stages``: input chunks in flight a tile, the most of 2-4 that fit
      among the multiples of ``wpt`` (each stage belongs to one warpgroup);
    - ``tiles``, ``blocks`` (the persistent grid, at most one a SM), and
      ``smem``.

    Raises ValueError for a level whose weights and smallest tile do not
    fit in shared memory."""
    lead = narrow_lead(k, dilations, rate)
    unit = math.lcm(8, rate)
    step = math.lcm(64, unit)

    def smem(rows, owners, stages):
        return narrow_layout(len(dilations), k, cin, c, rate, frame_rate, rows, owners, stages,
                             dtype)["smem"]

    def fit(owners, stages):
        best = 0
        for rows in range(step, NARROW_MAX_ROWS + 1, step):
            if rows >= lead + unit and smem(rows, owners, stages) <= SMEM_LIMIT:
                best = rows
        return best

    def tiles(rows):
        return n * -(-length // (rows - lead))

    good = _align(10 * lead, step)
    owners = 2 if fit(2, 2) >= good else 1
    top = fit(owners, 2)
    if top == 0:
        raise ValueError(f"filter level C={c} from {cin} channels at rate {rate} in {dtype}: the "
                         "narrow kernel's weights and smallest tile exceed shared memory")
    low = good if top >= good else top
    rows = min(range(low, top + 1, step), key=lambda r: (-(-tiles(r) // (sms * owners)) * r, -r))
    narrowed = tiles(rows) < NARROW_MIN_BLOCKS
    if narrowed:
        owners = 1
        t = rows - lead
        while t > unit and n * -(-length // t) < NARROW_MIN_BLOCKS:
            t -= unit
        rows = t + lead
    # each ring stage belongs to one warpgroup (chunk c to warpgroup c % wpt):
    # stages a multiple of wpt, the most of 2-4 that fit; fewer warpgroups
    # where no such count fits
    for wpt in range(max(1, min(narrow_max_wgs(c, dtype) // owners, -(-rows // 64))), 0, -1):
        fits = [s for s in range(wpt, NARROW_MAX_STAGES + 1, wpt)
                if s >= 2 and smem(rows, owners, s) <= SMEM_LIMIT]
        if fits:
            stages = max(fits)
            break
    count = tiles(rows)
    return {"rows": rows, "T": rows - lead, "lead": lead, "owners": owners, "wpt": wpt,
            "wgs": owners * wpt, "stages": stages, "tiles": count,
            "blocks": min(-(-count // owners), sms), "smem": smem(rows, owners, stages),
            "share": lead / rows, "narrowed": narrowed}


def _gelu_film(x, film, i, c, length, dt):
    """Operand of causal conv ``i``: gelu(x) * scale + shift, rounded to ``dt``
    (rounding point 4)."""
    scale, shift = film_of(film, i, c)
    g = (F.gelu(x.float()) * linear_interpolate(scale.float(), length, axis=1)
         + linear_interpolate(shift.float(), length, axis=1))
    return g.to(dt).float()


def _causal_conv_plain(g, w, b, dilation):
    pad = (w.shape[0] - 1) * dilation
    if pad:
        g = torch.cat([g[:, 1:pad + 1].flip(1), g], dim=1)
    return F.conv1d(g.transpose(1, 2), w.float().permute(2, 1, 0), b.float(),
                    dilation=dilation).transpose(1, 2)


def filter_level_plain(x_prev, skip, up_w, up_b, in_w, in_b,
                       conv_w: Sequence[torch.Tensor], conv_b: Sequence[torch.Tensor],
                       film: torch.Tensor, rate: int, dilations: Sequence[int]) -> torch.Tensor:
    """x_prev, skip [N, L_in, C_in] -> [N, L_in * rate, C]."""
    dt = x_prev.dtype
    n, l_in, _ = x_prev.shape
    c = up_b.shape[0]
    length = l_in * rate
    xs = (x_prev.float() + skip.float()).to(dt)
    x = (xs.float() @ up_w.float()).reshape(n, length, c)
    x = (x + up_b.float()).to(dt)
    x = (x.float() @ in_w.float() + in_b.float()).to(dt)
    for i in range(0, len(conv_w), 2):
        g = _gelu_film(x, film, i, c, length, dt)
        h = _causal_conv_plain(g, conv_w[i], conv_b[i], dilations[i]).to(dt)
        g = _gelu_film(h, film, i + 1, c, length, dt)
        y = _causal_conv_plain(g, conv_w[i + 1], conv_b[i + 1], dilations[i + 1]).to(dt)
        x = (y.float() + x.float()).to(dt)
    return x


def product_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of float32 operands as the kernels form it in float32 storage:
    hi = tf32(v), lo = tf32(v - hi) of both operands, lo.hi + hi.lo + hi.hi
    summed in float32 (``kernels/knn.py:tf32_round`` is the rounding)."""
    ah, bh = tf32_round(a), tf32_round(b)
    al, bl = tf32_round(a.float() - ah), tf32_round(b.float() - bh)
    return al @ bh + ah @ bl + ah @ bh


def filter_level_tiled(x_prev, skip, up_w, up_b, in_w, in_b, conv_w, conv_b, film: torch.Tensor,
                       rate: int, dilations: Sequence[int], tile: int,
                       products: str = "exact", compute: torch.dtype = torch.float32) -> torch.Tensor:
    """The narrow kernel's tiling, replayed on the CPU (tests only).  Each
    tile of ``tile`` output samples computes the whole level over the rows
    [b0, t0 + tile), b0 = max(0, t0 - lead) (``narrow_lead``: the lookback
    rounded up to a multiple of 8 and of ``rate``): rows the lookback holds
    wrongly (their history is cut) feed only rows that the tile does not
    write.  A tile whose rows start at
    sample 0 reflects each conv's head in place.  ``products`` is 'exact'
    (products in ``compute``) or '3xtf32' (the float32 kernels' split);
    roundings to the storage type are those of ``filter_level_plain``."""
    dt = x_prev.dtype
    n, l_in, _ = x_prev.shape
    c = up_b.shape[0]
    length = l_in * rate
    k = conv_w[0].shape[0]
    lead = narrow_lead(k, dilations, rate)

    def prod(a, b):
        if products == "3xtf32":
            return product_3xtf32(a.float(), b.float()).to(compute)
        return a.to(compute) @ b.to(compute)

    def rnd(v):
        return v.to(dt).to(compute)

    scales = [linear_interpolate(film_of(film, i, c)[0].to(compute), length, axis=1)
              for i in range(len(conv_w))]
    shifts = [linear_interpolate(film_of(film, i, c)[1].to(compute), length, axis=1)
              for i in range(len(conv_w))]
    out = torch.empty((n, length, c), dtype=dt)
    for t0 in range(0, length, tile):
        b0 = max(0, t0 - lead)
        e = min(t0 + tile, length)
        q0, q1 = b0 // rate, -(-e // rate)
        xs = rnd(x_prev[:, q0:q1].to(compute) + skip[:, q0:q1].to(compute))
        x = prod(xs.reshape(-1, xs.shape[2]), up_w).reshape(n, (q1 - q0) * rate, c)[:, :e - b0]
        x = rnd(x + up_b.to(compute))
        x = rnd(prod(x.reshape(-1, c), in_w).reshape(x.shape) + in_b.to(compute))
        rows = torch.arange(e - b0)
        for i, (w, b, d) in enumerate(zip(conv_w, conv_b, dilations)):
            src = x if i % 2 == 0 else h
            g = rnd(F.gelu(src) * scales[i][:, b0:e] + shifts[i][:, b0:e])
            cols = []
            for j in range(k):
                idx = rows - (k - 1 - j) * d
                # reflect at sample 0, or (rows the tile does not keep) clamp
                idx = idx.abs() if b0 == 0 else idx.clamp(min=0)
                cols.append(g[:, idx])
            y = prod(torch.cat(cols, dim=2).reshape(-1, k * c), w.reshape(k * c, c))
            y = y.reshape(n, e - b0, c) + b.to(compute)
            if i % 2 == 0:
                h = rnd(y)
            else:
                x = rnd(rnd(y) + x)
        out[:, t0:e] = x[:, t0 - b0:].to(dt)
    return out


WIDE_CHUNK_BYTES = 128   # a K chunk of the wide kernel: 128 bytes of input channels
WIDE_TN = (32, 64, 128, 256)   # its column tiles (float32 up to 128)
WIDE_MAX_SPLIT = 4       # blocks of a cluster that share a tile's K chunks


@functools.lru_cache(maxsize=256)
def wide_plan(n: int, length: int, cin: int, cols: int, taps: int, dtype: torch.dtype,
              sms: int = H100_SMS) -> dict:
    """The launch plan of one ``filter_wide_kernel`` launch over ``n``
    windows of ``length`` rows (a product: n = 1, length = its rows), ``cin``
    input channels, ``cols`` output columns and ``taps`` taps (1 for a
    product), on a card of ``sms`` SMs:

    - ``tn``: the column tile, the narrowest of 32 .. 256 (float32: 128, the
      A fragments' TF32 hi and lo take the registers) that covers the columns;
    - ``wgs``: warpgroups a block, 64 rows each (``tm`` = 64 wgs): 2 where the
      128-row tiles fill the card, else 1;
    - ``split``: blocks of a cluster that share each tile's K chunks (128
      bytes of input channels each, ``chunks`` in all), doubled up to 4 (and
      at most to the chunks) while the blocks would fill at most half the
      card; then ``tn`` halves, down to 32, while they still would.

    ``tiles`` counts the (row, column) tiles, ``ctas`` = tiles x split the
    blocks that work on them (the kernel's persistent grid caps them at one
    wave)."""
    bf16 = dtype == torch.bfloat16
    chunks = -(-cin // (WIDE_CHUNK_BYTES // (2 if bf16 else 4)))
    tn = WIDE_TN[0]
    while tn < (256 if bf16 else 128) and tn < cols:
        tn *= 2

    def tiles(wgs_, tn_):
        return n * -(-length // (64 * wgs_)) * -(-cols // tn_)

    wgs = 2 if tiles(2, tn) >= sms else 1
    split = 1
    while split < WIDE_MAX_SPLIT and chunks >= 2 * split and 2 * tiles(wgs, tn) * split <= sms:
        split *= 2
    while tn > WIDE_TN[0] and 2 * tiles(wgs, tn) * split <= sms:
        tn //= 2
    t = tiles(wgs, tn)
    return {"tm": 64 * wgs, "tn": tn, "wgs": wgs, "split": split, "chunks": chunks, "tiles": t,
            "ctas": t * split}


def wide_launches(n: int, l_in: int, cin: int, c: int, rate: int, taps: int, n_conv: int) -> list:
    """(n, length, cin, cols, taps) of a wide level's 8 launches: the up conv
    and the 1x1 (products over rows), then the causal convs."""
    length = l_in * rate
    return ([(1, n * l_in, cin, rate * c, 1), (1, n * length, c, c, 1)]
            + [(n, length, c, c, taps)] * n_conv)


def _wide_operand(x, film, i, c, length, dt, compute):
    """gelu(x) * scale + shift of causal conv ``i`` in ``compute``, rounded
    to ``dt`` (rounding point 4)."""
    scale, shift = film_of(film, i, c)
    g = (F.gelu(x.to(compute)) * linear_interpolate(scale.to(compute), length, axis=1)
         + linear_interpolate(shift.to(compute), length, axis=1))
    return g.to(dt).to(compute)


def wide_product_replay(g: torch.Tensor, w: torch.Tensor, d: int, split: int, chunk: int,
                        prod) -> torch.Tensor:
    """One wide-kernel launch's sum, in its order: operand ``g`` [n, L, cin]
    (reflect-padded over its head by (taps - 1) d rows here), weights ``w``
    [taps, cin, N].  Block s of the split sums chunks [s C / split, (s + 1) C
    / split) of ``chunk`` channels, all taps of a chunk before the next, each
    slab's ``prod`` added in turn; the blocks' partial sums are then added in
    rank order (tests only)."""
    n, length, cin = g.shape
    taps = w.shape[0]
    halo = (taps - 1) * d
    gp = torch.cat([g[:, 1:halo + 1].flip(1), g], dim=1) if halo else g
    chunks = -(-cin // chunk)
    total = None
    for s in range(split):
        acc = None
        for ci in range(s * chunks // split, (s + 1) * chunks // split):
            cs = slice(ci * chunk, min((ci + 1) * chunk, cin))
            for j in range(taps):
                a = gp[:, j * d:j * d + length, cs].reshape(n * length, -1)
                y = prod(a, w[j, cs])
                acc = y if acc is None else acc + y
        total = acc if total is None else total + acc
    return total.reshape(n, length, -1)


def filter_level_wide_replay(x_prev, skip, up_w, up_b, in_w, in_b, conv_w, conv_b,
                             film: torch.Tensor, rate: int, dilations: Sequence[int],
                             split: Optional[int] = None, products: str = "exact",
                             compute: torch.dtype = torch.float32,
                             sms: int = H100_SMS) -> torch.Tensor:
    """The wide route's 8 launches replayed on the CPU (tests only): each
    launch's K order and split (``wide_plan``'s, or ``split`` for every
    launch, at most its chunks), ``products`` 'exact' (in ``compute``) or
    '3xtf32' (the float32 kernel's split); roundings to the storage type are
    those of ``filter_level_plain``."""
    dt = x_prev.dtype
    n, l_in, cin = x_prev.shape
    c = up_b.shape[0]
    length = l_in * rate
    k = conv_w[0].shape[0]
    chunk = WIDE_CHUNK_BYTES // (2 if dt == torch.bfloat16 else 4)

    def prod(a, b):
        if products == "3xtf32":
            return product_3xtf32(a.float(), b.float()).to(compute)
        return a.to(compute) @ b.to(compute)

    def rnd(v):
        return v.to(dt).to(compute)

    def launch(g, w, d, nn, rows, cols, taps):
        plan = wide_plan(nn, rows, g.shape[2], cols, taps, dt, sms)
        sp = plan["split"] if split is None else min(split, plan["chunks"])
        return wide_product_replay(g, w.to(compute), d, sp, chunk, prod)

    xs = rnd(x_prev.to(compute) + skip.to(compute))
    x = launch(xs.reshape(1, n * l_in, cin), up_w[None], 0, 1, n * l_in, rate * c, 1)
    x = rnd(x.reshape(n, length, c) + up_b.to(compute))
    x = rnd(launch(x.reshape(1, n * length, c), in_w[None], 0, 1, n * length, c, 1).reshape(
        n, length, c) + in_b.to(compute))
    for i in range(0, len(conv_w), 2):
        g = _wide_operand(x, film, i, c, length, dt, compute)
        h = rnd(launch(g, conv_w[i], dilations[i], n, length, c, k) + conv_b[i].to(compute))
        g = _wide_operand(h, film, i + 1, c, length, dt, compute)
        y = rnd(launch(g, conv_w[i + 1], dilations[i + 1], n, length, c, k)
                + conv_b[i + 1].to(compute))
        x = rnd(y + x)
    return x.to(dt)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _wide_weights(mats: Sequence[torch.Tensor], dt: torch.dtype, device: torch.device):
    """Every weight of a wide level, each a [taps, cin, N] view (any
    strides), K-major in one buffer by one ``filter_wide_weights_kernel``
    launch: (hi, lo or None, element offsets).  float32 writes the TF32
    split (hi, lo)."""
    mats = [m.to(dt) for m in mats]
    for m in mats:
        if not m.is_cuda or m.dim() != 3:
            raise ValueError("filter level weights must be 3-D views of CUDA tensors")
    sizes = [m.numel() for m in mats]
    offsets = [sum(sizes[:j]) for j in range(len(mats))]
    total = sum(sizes)
    hi = torch.empty((total,), dtype=dt, device=device)
    lo = None if dt == torch.bfloat16 else torch.empty((total,), dtype=torch.float32, device=device)
    jobs = len(mats)
    src = (ctypes.c_void_p * jobs)(*[m.data_ptr() for m in mats])
    strides = (ctypes.c_longlong * (3 * jobs))(*[s for m in mats for s in m.stride()])
    dims = (ctypes.c_int * (3 * jobs))(*[s for m in mats for s in m.shape])
    fn = _lib.function("filter", "filter_wide_weights", "ipppppip")
    rc = fn(jobs, ctypes.addressof(src), ctypes.addressof(strides), ctypes.addressof(dims),
            hi.data_ptr(), None if lo is None else lo.data_ptr(), int(dt == torch.bfloat16),
            _lib.stream_of(hi))
    _lib.check(rc, "filter level weights")
    return hi, lo, offsets


@functools.lru_cache(maxsize=64)
def _narrow_blob_bytes(n_conv: int, k: int, cin: int, c: int, rate: int, bf16: int) -> int:
    """Bytes of the narrow level's weight blob (``csrc/filter.cu:narrow_layout``)."""
    layout = _lib.function("filter", "filter_narrow_layout", "i" * 10 + "p")
    sizes = (ctypes.c_longlong * 2)()
    _lib.check(layout(n_conv, k, cin, c, rate, 1, 64, 1, 1, bf16, ctypes.addressof(sizes)),
               "filter level weights' layout")
    return sizes[1]


def _narrow_weights(up_w, in_w, conv_w, biases, dt):
    """The narrow level's weights as ``filter_narrow_weights_kernel`` reads
    them (each a [in, out] or [tap, in, out] view, any strides: the device
    pointers, their strides) and its biases' pointers, as ctypes arrays."""
    mats = [up_w[None], in_w.to(dt)[None], *[w.to(dt) for w in conv_w]]
    for m in mats:
        if not m.is_cuda or m.dim() != 3:
            raise ValueError("filter level weights must be 3-D views of CUDA tensors")
    src = (ctypes.c_void_p * len(mats))(*[m.data_ptr() for m in mats])
    strides = (ctypes.c_longlong * (3 * len(mats)))(*[st for m in mats for st in m.stride()])
    bs = (ctypes.c_void_p * len(biases))(*[b.data_ptr() for b in biases])
    return src, strides, bs


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """The kernels read 16-byte vectors: a view that starts off 16 bytes is copied."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def filter_level_cuda(x_prev, skip, up_w, up_b, in_w, in_b,
                      conv_w: Sequence[torch.Tensor], conv_b: Sequence[torch.Tensor],
                      film: torch.Tensor, rate: int, dilations: Sequence[int]) -> torch.Tensor:
    """The kernel launches: the weights' launch and one ``filter_narrow_kernel``
    for C = 8 or 16, else the weights' launch and 8 ``filter_wide_kernel``
    launches (up conv, 1x1, six causal convs)."""
    _lib.refuse_grad("filter_level_cuda", x_prev, skip, up_w, up_b, in_w, in_b, *conv_w, *conv_b,
                     film)
    dt = x_prev.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"filter level takes float32 or bf16, got {dt}")

    def prep(t, name, dim):
        t = _aligned(t.to(dt).contiguous())
        _lib.require(t, name, (dt,), dim)
        return t

    x_prev = prep(x_prev, "x_prev", 3)
    skip = prep(skip, "skip", 3)
    if skip.shape != x_prev.shape:
        raise ValueError(f"skip {tuple(skip.shape)} != x_prev {tuple(x_prev.shape)}")
    n, l_in, c_in = x_prev.shape
    up_w, up_b = prep(up_w, "up_w", 2), prep(up_b, "up_b", 1)
    in_b = prep(in_b, "in_b", 1)
    c = up_b.shape[0]
    length = l_in * rate
    n_conv = len(conv_w)
    if (up_w.shape != (c_in, rate * c) or in_w.shape != (c, c) or c % 8 or c_in % 8
            or n_conv % 2 or not 0 < n_conv <= MAX_CONV
            or len(conv_b) != n_conv or len(dilations) != n_conv):
        raise ValueError("filter level weights do not match the level's shapes")
    conv_b = [prep(b, "conv_b", 1) for b in conv_b]
    k = conv_w[0].shape[0]
    if any(w.shape != (k, c, c) for w in conv_w) or any(b.shape != (c,) for b in conv_b):
        raise ValueError("causal conv weights do not match the level's shapes")
    if k > MAX_TAPS or any(d < 1 or (k - 1) * d > MAX_HALO or length <= (k - 1) * d
                           for d in dilations):
        raise ValueError(f"causal convs of k={k}, dilations {list(dilations)} over {length} "
                         f"samples: need k <= {MAX_TAPS}, (k-1)*d <= {MAX_HALO} < L")
    film = prep(film, "film", 3)
    frames = film.shape[1]
    if film.shape != (n, frames, 2 * n_conv * c) or frames < 1 or length % frames:
        raise ValueError(f"film {tuple(film.shape)} does not match [{n}, F, {2 * n_conv * c}] "
                         f"with F dividing the level's {length} samples")
    bf16 = int(dt == torch.bfloat16)
    stream = _lib.stream_of(x_prev)
    if takes_narrow(c, c_in, rate, k, dilations):
        plan = narrow_plan(n, length, c_in, c, rate, dt, length // frames, k, tuple(dilations),
                           _sm_count(x_prev.get_device()))
        src, strides, bs = _narrow_weights(up_w, in_w, conv_w, [up_b, in_b, *conv_b], dt)
        blob = torch.empty((_narrow_blob_bytes(n_conv, k, c_in, c, rate, bf16),), dtype=torch.uint8,
                           device=x_prev.device)
        fn = _lib.function("filter", "filter_narrow", "p" * 9 + "i" * 16 + "p")
        ds = (ctypes.c_int * n_conv)(*dilations)
        out = torch.empty((n, length, c), dtype=dt, device=x_prev.device)
        rc = fn(x_prev.data_ptr(), skip.data_ptr(), ctypes.addressof(src), ctypes.addressof(strides),
                ctypes.addressof(bs), blob.data_ptr(), film.data_ptr(), out.data_ptr(),
                ctypes.addressof(ds), n_conv, k, n, l_in, c_in, c, rate, frames, plan["rows"],
                plan["T"], plan["lead"], plan["owners"], plan["wpt"], plan["stages"], plan["blocks"],
                bf16, stream)
        _lib.check(rc, "filter level (narrow kernel)")
        _lib.LAUNCHES["filter_level"] += 1
        _lib.LAUNCHES["filter_narrow"] += 1
        return out

    # the weights K-major, [out][(tap, in)], from their [tap, in, out] views
    hi, lo, offs = _wide_weights([up_w[None], in_w[None], *conv_w], dt, x_prev.device)
    esz, lo_esz = hi.element_size(), 4
    wide = _lib.function("filter", "filter_wide", "p" * 8 + "i" * 15 + "p")
    sms = _sm_count(x_prev.get_device())
    specs = wide_launches(n, l_in, c_in, c, rate, k, n_conv)

    def launch(j, a, a2, b, res, o, film_ptr, d, film_off, what):
        nn, rows, cin, cols, taps = specs[j]
        plan = wide_plan(nn, rows, cin, cols, taps, dt, sms)
        rc = wide(a.data_ptr(), a2, hi.data_ptr() + offs[j] * esz,
                  None if lo is None else lo.data_ptr() + offs[j] * lo_esz, b.data_ptr(), res,
                  o.data_ptr(), film_ptr, nn, rows, cin, cols, taps, d, c, frames,
                  length // frames, film.shape[2], film_off, plan["tn"], plan["wgs"],
                  plan["split"], bf16, stream)
        _lib.check(rc, what)

    up = torch.empty((n, length, c), dtype=dt, device=x_prev.device)
    launch(0, x_prev, skip.data_ptr(), up_b, None, up, None, 0, 0, "filter up conv")
    x = torch.empty_like(up)
    launch(1, up, None, in_b, None, x, None, 0, 0, "filter 1x1 conv")
    del up
    h = torch.empty_like(x)
    for i, (b, d) in enumerate(zip(conv_b, dilations)):
        # the first conv of a block reads x and writes h; the second reads h
        # and adds x (the block's input) into x in place
        second = i % 2 == 1
        launch(2 + i, h if second else x, None, b, x.data_ptr() if second else None,
               x if second else h, film.data_ptr(), d, 2 * i * c, "filter causal conv")
    _lib.LAUNCHES["filter_level"] += 1
    _lib.LAUNCHES["filter_wide"] += 1
    return x


def _unpack(n_conv: int, tensors):
    """(x_prev, skip, up_w, up_b, in_w, in_b, conv_w, conv_b, film) from the
    flat tensor list ``FilterLevelFunction`` takes."""
    return (*tensors[:6], list(tensors[6:6 + n_conv]), list(tensors[6 + n_conv:6 + 2 * n_conv]),
            tensors[6 + 2 * n_conv])


class FilterLevelFunction(torch.autograd.Function):
    """The level on the card with a gradient: forward = the kernels, backward
    = autograd of ``filter_level_plain`` recomputed on the saved inputs.
    The tensors arrive flat, (x_prev, skip, up_w, up_b, in_w, in_b,
    *conv_w, *conv_b, film), so that each one gets its own gradient."""

    @staticmethod
    def forward(ctx, rate, dilations, n_conv, *tensors):
        ctx.rate, ctx.dilations, ctx.n_conv = rate, dilations, n_conv
        ctx.save_for_backward(*tensors)
        return filter_level_cuda(*_unpack(n_conv, tensors), rate, dilations)

    @staticmethod
    def backward(ctx, grad_out):
        plain = lambda *t: filter_level_plain(*_unpack(ctx.n_conv, t), ctx.rate,  # noqa: E731
                                              ctx.dilations)
        return (None, None, None,
                *_lib.plain_vjp(plain, ctx.saved_tensors, ctx.needs_input_grad[3:], grad_out))


def filter_level(x_prev, skip, up_w, up_b, in_w, in_b, conv_w, conv_b, film, rate,
                 dilations) -> torch.Tensor:
    """One up level: the kernels (with a gradient, ``FilterLevelFunction``)
    on CUDA tensors, the plain version on CPU tensors."""
    if _lib.route(x_prev) == "cuda":
        return FilterLevelFunction.apply(rate, tuple(dilations), len(conv_w), x_prev, skip, up_w,
                                         up_b, in_w, in_b, *conv_w, *conv_b, film)
    return filter_level_plain(x_prev, skip, up_w, up_b, in_w, in_b, conv_w, conv_b, film, rate,
                              dilations)
