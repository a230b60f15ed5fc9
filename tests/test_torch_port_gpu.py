"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests carry the ``gpu`` marker and skip on a host without CUDA.  The
machine with the card has no JAX, so this file imports only torch and the
port; run it there without the repo's conftest (which sets JAX up):

    python -m pytest tests/test_torch_port_gpu.py --noconftest -m gpu -q

Tolerances: STFT 1e-3 abs (a float32 FFT against float32 DFT sums of 1280
products);
kNN values 1e-4 abs (float32 sums of the mode's operand products), and with
the packed extraction 1e-4 too (a sum that rounds across a 128-ulp packing
step moves its key by 3.1e-5); oscillator 5e-3 abs (sinf/cosf rounding
grown by the Chebyshev recurrence), the same for the full-formant source
(float32 phase of up to ~500 cycles a frame), and at their edges against
the replay of their own arithmetic 1e-3 (Chebyshev) and 1e-4 (formants);
the streaming source: its phase (asin) bit-equal to the plain version's on
the card, its waveform within 1e-6 of the peak (the mean over the harmonics
summed in another order), and a stream's hops through it within 1e-6 of
the peak of the hops through the plain version;
filter level 1e-3 abs in
float32, and at its edges (all four level shapes, batch 1, lengths that no
tile divides, a narrow level just over its 56-sample lookback, one FiLM
frame a level) 1e-3 (1 + scale) in float32 and 4e-2 (1 + scale) in bf16,
chip_smoke.py's tolerances.  The STFT and kNN kernels' edges (odd shapes,
Lr = k, a device valid-row count below k, d padded or too wide for the
resident query tile) are held to the same tolerances, and 'highest' index sets equal a
float64 ranking wherever its 4th and 5th scores differ by more than 1e-5.
The sharded path: 2 gloo ranks on one card against 1 rank,
identical 'highest' index sets and the waveform within 1e-4 (float32 sums
of the k rows split over the shards, in another order).  The offline driver:
bit-equal to the frozen NumPy driver it replaced (the same batches and
element-wise float32 operations).  kNN-VC's vocoder conv (3xTF32 against
cuDNN's float32 conv in another summation order): 1e-4 of max(1, the
plain output's peak) a conv (it reads up to 2.3e-5; the plain version on
TF32-rounded operands reads 2.8e-4 to 4.1e-4), and the whole vocoder's
waveform within 1e-5 of its peak (1.2e-6; TF32 operands 3.7e-4).
"""

import multiprocessing
import os

import numpy as np
import pytest
import torch

from alivevc_tpu_torch.config import DecoderConfig
from alivevc_tpu_torch.kernels import filter as kfilter
from alivevc_tpu_torch.kernels import knn as kknn
from alivevc_tpu_torch.kernels import oscillator as kosc
from alivevc_tpu_torch.kernels import stft as kstft
from alivevc_tpu_torch.models.decoder import Decoder, level_args


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["stft", "knn", "oscillator", "filter_level", "knn_exclusion",
                                  "knn_packed", "oscillator_formants"])
def test_kernel_matches_plain_on_card(name):
    """On the card: each kernel against its plain version at a small shape."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run this file with --noconftest -m gpu")
    # full float32 in the plain versions' products and convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    if name == "stft":
        x = 0.3 * torch.randn(2, 16_000, generator=g, device="cuda")
        assert max_err(kstft.stft_magnitude_cuda(x), kstft.stft_magnitude_plain(x)) <= 1e-3
    elif name == "knn":
        q = torch.randn(300, 768, generator=g, device="cuda")
        lib = torch.randn(5000, 768, generator=g, device="cuda")
        for precision in ("default", "high"):
            v, _ = kknn.knn_topk_cuda(q, lib, 4, precision)
            pv, _ = kknn.knn_topk_plain(q, lib, 4, precision)
            assert max_err(v, pv) <= 1e-4
    elif name == "knn_exclusion":
        q = torch.randn(300, 768, generator=g, device="cuda")
        lib = torch.randn(5000, 768, generator=g, device="cuda")
        pen = torch.where(torch.rand(5000, generator=g, device="cuda") < 0.3, -4.0, 0.0)
        vr = torch.tensor(4093, device="cuda")
        for precision in ("default", "high", "highest"):
            for kw in (dict(valid_rows=vr), dict(valid_rows=4093), dict(penalty=pen),
                       dict(valid_rows=3)):
                v, i = kknn.knn_topk_cuda(q, lib, 4, precision, **kw)
                pv, pi = kknn.knn_topk_plain(q, lib, 4, precision, **kw)
                assert max_err(v.nan_to_num(neginf=0), pv.nan_to_num(neginf=0)) <= 1e-4
                assert torch.equal(torch.isneginf(v), torch.isneginf(pv))
                if "valid_rows" in kw:
                    assert int(i[i != kknn.SENTINEL].max()) < int(kw["valid_rows"])
    elif name == "knn_packed":
        q = torch.randn(300, 768, generator=g, device="cuda")
        for rows in (512, 5000):
            lib = torch.randn(rows, 768, generator=g, device="cuda")
            v, _ = kknn.knn_topk_cuda(q, lib, 4, "default", extraction="packed")
            pv, _ = kknn.knn_topk_plain(q, lib, 4, "default", extraction="packed")
            assert max_err(v, pv) <= 1e-4
    elif name == "oscillator_formants":
        f0 = 80 + 300 * torch.rand(2, 50, 1, generator=g, device="cuda")
        formants = f0 * torch.arange(1, 65, device="cuda")
        amps = torch.exp(0.3 * torch.randn(2, 50, 64, generator=g, device="cuda"))
        got = kosc.harmonic_source_formants_cuda(formants, amps)
        assert max_err(got, kosc.harmonic_source_formants_plain(formants, amps)) <= 5e-3
        assert max_err(got, kosc.harmonic_source_cuda(f0, amps)) <= 5e-3
    elif name == "oscillator":
        f0 = 80 + 300 * torch.rand(2, 50, 1, generator=g, device="cuda")
        amps = torch.exp(0.3 * torch.randn(2, 50, 64, generator=g, device="cuda"))
        assert max_err(kosc.harmonic_source_cuda(f0, amps), kosc.harmonic_source_plain(f0, amps)) <= 5e-3
    else:
        dec = Decoder(DecoderConfig(), generator=torch.Generator().manual_seed(0)).cuda()
        x = 0.3 * torch.randn(2, 960, 16, generator=g, device="cuda")
        s = 0.3 * torch.randn(2, 960, 16, generator=g, device="cuda")
        cond = 0.5 * torch.randn(2, 6, 512, generator=g, device="cuda")   # 1920 samples: 320 a frame
        args = level_args(dec.filter.blocks[3], dec.filter.ups[3], cond)
        with torch.no_grad():
            got = kfilter.filter_level_cuda(x, s, rate=2, **args)
            want = kfilter.filter_level_plain(x, s, rate=2, **args)
        assert max_err(got, want) <= 1e-3


def _knn_vs_plain(q, lib, k, precision, got=None, **kw):
    """Kernel vs plain version: values within 1e-4, sentinels in the same
    places, index sets equal wherever the plain k-th and (k+1)-th scores
    are more than 1e-4 apart (or fewer than k + 1 rows rank).  ``got``: the
    kernel's (values, indices), if already computed."""
    v, i = got if got is not None else kknn.knn_topk_cuda(q, lib, k, precision, **kw)
    kp = min(k + 1, lib.shape[0])
    pv, pi = kknn.knn_topk_plain(q, lib, kp, precision, **kw)
    assert torch.equal(torch.isneginf(v), torch.isneginf(pv[:, :k]))
    assert max_err(v.nan_to_num(neginf=0), pv[:, :k].nan_to_num(neginf=0)) <= 1e-4
    clear = torch.ones(q.shape[0], dtype=torch.bool, device=q.device)
    if kp > k:
        clear = (pv[:, k - 1] - pv[:, k]).nan_to_num(nan=1.0, posinf=1.0) > 1e-4
    same = (torch.sort(i, 1).values == torch.sort(pi[:, :k], 1).values).all(1)
    assert bool((same | ~clear).all())
    return v, i


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["stft_edges", "knn_edges", "knn_highest_vs_float64"])
def test_redesigned_kernel_edges_on_card(name):
    """The shared-memory FFT and the tensor-core kNN kernel at their edges."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run this file with --noconftest -m gpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(1)
    if name == "stft_edges":
        # batch 1; L not a multiple of 320; L just over 640; odd L (rows not
        # 16-byte aligned); a hop that is not the default
        for n, length, hop in ((1, 16_000, 320), (1, 16_123, 320), (3, 641, 320), (2, 700, 320),
                               (3, 9_601, 320), (2, 5_000, 160)):
            x = 0.3 * torch.randn(n, length, generator=g, device="cuda")
            got = kstft.stft_magnitude_cuda(x, hop_length=hop)
            want = kstft.stft_magnitude_plain(x, hop_length=hop)
            assert got.shape == want.shape == (n, length // hop + 1, 641)
            assert max_err(got, want) <= 1e-3
        with pytest.raises(ValueError):
            kstft.stft_magnitude_cuda(torch.zeros(1, 640, device="cuda"))
    elif name == "knn_edges":
        q = torch.randn(300, 768, generator=g, device="cuda")     # 300: not a multiple of 64
        for precision in kknn.PRECISIONS:
            for k in (4, 8):
                _knn_vs_plain(q, torch.randn(k, 768, generator=g, device="cuda"), k, precision)
            lib = torch.randn(5003, 768, generator=g, device="cuda")   # not a multiple of 128
            pen = torch.where(torch.rand(5003, generator=g, device="cuda") < 0.3, -4.0, 0.0)
            _knn_vs_plain(q, lib, 8, precision)
            _knn_vs_plain(q, lib, 5, precision, penalty=pen)
            v, i = _knn_vs_plain(q, lib, 4, precision, valid_rows=torch.tensor(2, device="cuda"))
            assert (i[:, 2:] == kknn.SENTINEL).all() and (i[:, :2] < 2).all()
            _knn_vs_plain(q[:37, :100], lib[:, :100], 4, precision)   # d padded to 128
        lib = torch.randn(5003, 768, generator=g, device="cuda")
        _knn_vs_plain(q, lib, 8, "default", extraction="packed")
        _knn_vs_plain(q, lib[:130], 4, "default", extraction="packed")
        # d = 1024: the bf16 query tile no longer fits beside the ring and streams
        wide_q = torch.randn(200, 1024, generator=g, device="cuda")
        wide = torch.randn(3000, 1024, generator=g, device="cuda")
        for kw in ({}, dict(extraction="packed"), dict(valid_rows=torch.tensor(2900, device="cuda"))):
            _knn_vs_plain(wide_q, wide, 4, "default", **kw)
        # the two-pass tile kernel at its tile's edges (knn_twopass_cases)
        for ls, rows, k, precision, kw, d in knn_twopass_cases():
            q = torch.randn(ls, d, generator=g, device="cuda")
            lib = torch.randn(rows, d, generator=g, device="cuda")
            kw = _carried_kw(kw, rows, g)
            got = kknn.knn_topk_cuda(q, lib, k, precision, form="twopass", **kw)
            _knn_vs_plain(q, lib, k, precision, got=got, **kw)
            if "valid_rows" in kw:
                idx = got[1][got[1] != kknn.SENTINEL]
                assert idx.numel() == 0 or int(idx.max()) < int(kw["valid_rows"]), (ls, rows, k, precision)
    else:
        q = torch.randn(300, 768, generator=g, device="cuda")
        lib = torch.randn(20_000, 768, generator=g, device="cuda")
        _, i = kknn.knn_topk_cuda(q, lib, 4, "highest")
        s = kknn.normalize_rows(q).double() @ kknn.normalize_rows(lib).double().t()
        top, order = torch.sort(s, dim=1, descending=True)
        clear = (top[:, 3] - top[:, 4]) > 1e-5
        assert float(clear.float().mean()) > 0.8
        same = (torch.sort(i, 1).values == torch.sort(order[:, :4], 1).values).all(1)
        assert bool(same[clear].all())


def _past_a_chunk(ls: int, precision: str, lo: int = 5000) -> int:
    """The smallest library of at least ``lo`` rows whose two-pass plan cuts
    it into chunks with one row past the last whole chunk."""
    rows = lo
    while True:
        plan = kknn.twopass_plan(ls, rows, precision)
        if plan.chunks > 1 and rows % plan.rows_per_chunk == 1:
            return rows
        rows += 1


def knn_twopass_cases():
    """(queries, library rows, k, precision, keyword arguments, width) of the
    two-pass tile kernel's card cases, every mode: queries one past a
    128-query tile (a cluster of 2), over three tiles padded to whole
    clusters, and within one tile (a cluster of 1); a library one row past a
    tile and one row past a chunk; a device valid-row count inside the first
    tile and at a chunk's end; k = 1, 5 and 8; a penalty; widths padded to
    whole slabs (100) and rows of fewer slabs than the ring's stages (40);
    whole tiles only (4 096 rows); the packed extraction, also at 130 rows."""
    cases = []
    for precision in kknn.PRECISIONS:
        lt = kknn.twopass_tile(precision)[0]
        chunked = _past_a_chunk(600, precision)
        edge = kknn.twopass_plan(600, chunked, precision).rows_per_chunk
        cases += [(129, 5003, 4, precision, {}, 768),
                  (300, lt + 1, 1, precision, {}, 768),
                  (600, chunked, 5, precision, {}, 768),
                  (600, chunked, 8, precision, {"valid_rows": f"device:{edge}"}, 768),
                  (300, 5003, 4, precision, {"valid_rows": "device:5"}, 768),
                  (300, 5003, 5, precision, {"penalty": "penalty"}, 768),
                  (37, 5003, 4, precision, {}, 100),
                  (600, 9000, 8, precision, {}, 40),
                  (256, 4096, 4, precision, {}, 768)]
    cases += [(300, 130, 4, "default", {"extraction": "packed"}, 768),
              (600, 5003, 8, "default", {"extraction": "packed"}, 768),
              (129, 5003, 1, "default", {"extraction": "packed"}, 100)]
    return cases


@pytest.mark.gpu
def test_knn_twopass_guarded_on_card(monkeypatch):
    """The two-pass form's buffers (the prepared planes, the candidates, the
    outputs) between sentinel guards at the edge cases of every mode, the
    inputs at the end of their allocations, and the launch counts: one
    prep, one tile (or packed) and one merge launch a call, nothing else."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run this file with --noconftest -m gpu")
    from alivevc_tpu_torch.kernels import LAUNCHES

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(17)
    for ls, rows, k, precision, kw, d in knn_twopass_cases():
        q = _at_end(torch.randn(ls, d, generator=g, device="cuda"))
        lib = _at_end(torch.randn(rows, d, generator=g, device="cuda"))
        kw = _carried_kw(kw, rows, g)
        before = dict(LAUNCHES)
        guarded = _GuardedTorch()
        monkeypatch.setattr(kknn, "torch", guarded)
        got = kknn.knn_topk_cuda(q, lib, k, precision, form="twopass", **kw)
        torch.cuda.synchronize()
        monkeypatch.undo()
        case = (ls, rows, k, precision, sorted(kw), d)
        assert len(guarded.buffers) == 6 and guarded.guards_intact(), case
        packed = kknn.uses_packed(precision, k, kw.get("valid_rows"), kw.get("penalty"),
                                  kw.get("extraction", "auto"))
        grew = {key: LAUNCHES[key] - before[key] for key in LAUNCHES}
        assert grew == {**{key: 0 for key in LAUNCHES}, "knn_prep": 1, "knn_merge": 1,
                        "knn_packed" if packed else "knn": 1}, case
        _knn_vs_plain(q, lib, k, precision, got=got, **kw)


KNN_TWOPASS_CLUSTER_SHAPES = ((600, 9000), (129, 4500))   # queries over several tiles, and one past a tile


@pytest.mark.gpu
def test_knn_twopass_every_cluster_on_card():
    """Both clusters the tile kernel takes give a query the same bits: each
    shape's first 128 queries alone (one query tile: a cluster of 1) and
    among all its queries (clusters of 2 sharing the library slabs by
    multicast, query tiles padded to whole clusters), in every mode and
    k = 4 and 8, each call against the plain version (a block's work does
    not depend on its cluster)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run this file with --noconftest -m gpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(20)
    for ls, rows in KNN_TWOPASS_CLUSTER_SHAPES:
        q = torch.randn(ls, 768, generator=g, device="cuda")
        lib = torch.randn(rows, 768, generator=g, device="cuda")
        for precision in kknn.PRECISIONS:
            for k in (4, 8):
                alone = kknn.knn_topk_cuda(q[:128], lib, k, precision, form="twopass")
                among = kknn.knn_topk_cuda(q, lib, k, precision, form="twopass")
                _knn_vs_plain(q[:128], lib, k, precision, got=alone)
                _knn_vs_plain(q, lib, k, precision, got=among)
                case = (ls, precision, k)
                assert torch.equal(alone[0], among[0][:128]) and torch.equal(alone[1], among[1][:128]), case


@pytest.mark.gpu
def test_knn_twopass_ties_on_card():
    """Exact ties go to the smallest index, as the plain version's top-k:
    a library of 600 rows repeated ten times (bit-equal scores for each
    copy, in every chunk and tile), queried with its own rows, and a zero
    query (every score 0), in every mode and k = 4 and 8; indices and
    values equal the plain version's exactly where the plain k scores tie."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run this file with --noconftest -m gpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(21)
    base = torch.randn(600, 768, generator=g, device="cuda")
    lib = base.repeat(10, 1)
    q = torch.cat([base[:300], torch.zeros(1, 768, device="cuda")])
    for precision in kknn.PRECISIONS:
        for k in (4, 8):
            v, i = kknn.knn_topk_cuda(q, lib, k, precision, form="twopass")
            pv, pi = kknn.knn_topk_plain(q, lib, k, precision)
            want = torch.cat([torch.arange(300, device="cuda")[:, None] + 600 * torch.arange(k, device="cuda"),
                              torch.arange(k, device="cuda")[None, :]])
            assert torch.equal(pi, want), precision
            assert torch.equal(i, want), (precision, k)
            assert max_err(v, pv) <= 1e-4, (precision, k)


@pytest.mark.gpu
def test_knn_twopass_repeatable_on_card():
    """Five calls at the conversion path's 7 200 x 100 352 give the same
    bits, in every mode and with the packed extraction."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run this file with --noconftest -m gpu")
    g = torch.Generator(device="cuda").manual_seed(18)
    q = torch.randn(7200, 768, generator=g, device="cuda")
    lib = torch.randn(100_352, 768, generator=g, device="cuda")
    for precision, kw in [(p, {}) for p in kknn.PRECISIONS] + [("default", {"extraction": "packed"})]:
        first = kknn.knn_topk_cuda(q, lib, 4, precision, **kw)
        for _ in range(4):
            again = kknn.knn_topk_cuda(q, lib, 4, precision, **kw)
            assert torch.equal(again[0], first[0]) and torch.equal(again[1], first[1]), precision


@pytest.mark.gpu
def test_knn_twopass_shard_scores_equal_one_rank_on_card():
    """A row scores the same bits wherever it falls: a 12 000-row library
    whole, and its second half as a shard (its last 40 rows excluded by a
    device count, routed by the whole library's rows), give bit-equal
    values for the winners inside the shard, in every mode, although the two
    calls plan other chunks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run this file with --noconftest -m gpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(19)
    lib = torch.randn(12_000, 768, generator=g, device="cuda")
    q = lib[7000:7300] + 0.01 * torch.randn(300, 768, generator=g, device="cuda")
    for precision in kknn.PRECISIONS:
        whole, shard = kknn.twopass_plan(300, 12_000, precision), kknn.twopass_plan(300, 5960, precision)
        assert (whole.rows_per_chunk, whole.chunks) != (shard.rows_per_chunk, shard.chunks)
        fv, fi = kknn.knn_topk(q, lib, 4, precision)
        sv, si = kknn.knn_topk(q, lib[6000:], 4, precision, valid_rows=torch.tensor(5960, device="cuda"),
                               route_rows=12_000)
        assert torch.equal(fi[:, 0], torch.arange(7000, 7300, device="cuda")), precision
        assert torch.equal(si[:, 0] + 6000, fi[:, 0]) and torch.equal(sv[:, 0], fv[:, 0]), precision


# The carried form's card cases (csrc/knn_carried.cu): queries around its
# query tiles (8, 24, 64 and 128 wide; 960 and 7 200 over several tiles)
# and rows around its library blocks (64 rows a warpgroup, 1 or 2 a block)
# up to the route's bound; "k": a library of k rows.
KNN_CARRIED_QUERIES = (1, 24, 63, 64, 65, 960, 7200)
KNN_CARRIED_ROWS = ("k", 127, 128, 887, 4095)
KNN_CARRIED_NARROW = 100     # a width of 2 bf16 slabs (a depth split of 2) and 4 TF32 slabs


def knn_carried_variants(rows):
    """(k, precision, library rows, keyword arguments) of each card case at
    ``rows``: every mode, k = 8, valid_rows as a host int and as a device
    scalar, a 0/-4 penalty ("penalty" stands for it) and the packed
    extraction."""
    if rows == "k":
        return ([(k, p, k, {}) for k in (4, 8) for p in kknn.PRECISIONS]
                + [(4, "highest", 4, {"valid_rows": "device:2"}),
                   (4, "default", 4, {"extraction": "packed"})])
    return [(4, "default", rows, {}), (4, "high", rows, {}), (4, "highest", rows, {}),
            (8, "high", rows, {}), (4, "highest", rows, {"valid_rows": rows - 5}),
            (4, "default", rows, {"valid_rows": f"device:{rows // 2}"}),
            (5, "high", rows, {"penalty": "penalty"}),
            (4, "default", rows, {"extraction": "packed"})]


def _carried_kw(kw, rows, g):
    out = dict(kw)
    if isinstance(kw.get("valid_rows"), str):
        out["valid_rows"] = torch.tensor(int(kw["valid_rows"].split(":")[1]), device="cuda")
    if "penalty" in kw:
        out["penalty"] = torch.where(torch.rand(rows, generator=g, device="cuda") < 0.3, -4.0, 0.0)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("ls", KNN_CARRIED_QUERIES)
def test_knn_carried_edges_on_card(ls, monkeypatch):
    """The carried form against ``knn_topk_plain`` (``_knn_vs_plain``'s
    tolerances) at the edges of its tiles, every mode and exclusion: the
    inputs at the end of their allocations, its outputs and scratch (the
    prepared operands, the blocks' lists and the counters) between sentinel
    guards, one launch count a call and none of the two-pass form's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run this file with --noconftest -m gpu")
    from alivevc_tpu_torch.kernels import LAUNCHES

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(11)
    q = _at_end(torch.randn(ls, 768, generator=g, device="cuda"))
    for spec in KNN_CARRIED_ROWS:
        for k, precision, rows, kw in knn_carried_variants(spec):
            lib = _at_end(torch.randn(rows, 768, generator=g, device="cuda"))
            kw = _carried_kw(kw, rows, g)
            assert kknn.knn_plan(ls, rows, precision, k).form == "carried"
            before = dict(LAUNCHES)
            guarded = _GuardedTorch()
            monkeypatch.setattr(kknn, "torch", guarded)
            got = kknn.knn_topk_cuda(q, lib, k, precision, **kw)
            torch.cuda.synchronize()
            monkeypatch.undo()
            case = (ls, rows, k, precision, sorted(kw))
            assert len(guarded.buffers) == 3 and guarded.guards_intact(), case
            packed = kknn.uses_packed(precision, k, kw.get("valid_rows"), kw.get("penalty"),
                                      kw.get("extraction", "auto"))
            grew = {key: LAUNCHES[key] - before[key] for key in LAUNCHES}
            assert grew == {**{key: 0 for key in LAUNCHES},
                            "knn_carried_packed" if packed else "knn_carried": 1}, case
            assert got[0].shape == (ls, k) and got[1].dtype == torch.int64, case
            _knn_vs_plain(q, lib, k, precision, got=got, **kw)
            if "valid_rows" in kw:
                idx = got[1][got[1] != kknn.SENTINEL]
                assert idx.numel() == 0 or int(idx.max()) < int(kw["valid_rows"]), case
    lib = torch.randn(887, 768, generator=g, device="cuda")
    for precision in kknn.PRECISIONS:       # the columns padded to whole slabs
        _knn_vs_plain(q[:, :KNN_CARRIED_NARROW], lib[:, :KNN_CARRIED_NARROW], 4, precision)


@pytest.mark.gpu
def test_knn_carried_repeatable_on_card():
    """Five calls give the same bits: the hop (24 x 887 'high', one query
    tile over 14 library blocks merged by the last block to finish), a
    fine-tuning step (960 x 512 'highest') and 7 200 x 512 'default' and
    packed (several query tiles and library blocks)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run this file with --noconftest -m gpu")
    g = torch.Generator(device="cuda").manual_seed(12)
    for ls, rows, precision, kw in ((24, 887, "high", {}), (960, 512, "highest", {}),
                                    (7200, 512, "default", {}),
                                    (7200, 512, "default", {"extraction": "packed"})):
        q = torch.randn(ls, 768, generator=g, device="cuda")
        lib = torch.randn(rows, 768, generator=g, device="cuda")
        assert kknn.knn_plan(ls, rows, precision).lib_blocks > 1
        first = kknn.knn_topk_cuda(q, lib, 4, precision, **kw)
        for _ in range(4):
            again = kknn.knn_topk_cuda(q, lib, 4, precision, **kw)
            assert torch.equal(again[0], first[0]) and torch.equal(again[1], first[1]), (ls, rows)


@pytest.mark.gpu
def test_knn_forms_agree_on_card():
    """The two forms forced at shapes both take (24 x 887, 960 x 512, 65 x
    4 095; every mode): values within 1e-5 of each other in 'high' and
    'highest' (each form normalises the rows with its own order of the sum
    of squares, so a score may move in its last bits) and 1e-4 in 'default'
    (where such a move may round a bf16 operand the other way), and index
    sets equal wherever the plain 4th and 5th scores are further apart than
    that.  And the property the sharded path's
    exactness rests on: a row scores the same bits wherever it falls, so
    the carried form over a library and over a shard of it (the shard's
    valid rows on the device) give bit-equal values for the winners inside
    the shard.  The sharded path routes every shard by the whole library's
    rows (``route_rows``), so one rank and the shards take the same form."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run this file with --noconftest -m gpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(13)
    for ls, rows in ((24, 887), (960, 512), (65, 4095)):
        q = torch.randn(ls, 768, generator=g, device="cuda")
        lib = torch.randn(rows, 768, generator=g, device="cuda")
        for precision in kknn.PRECISIONS:
            cv, ci = kknn.knn_topk_cuda(q, lib, 4, precision, form="carried")
            tv, ti = kknn.knn_topk_cuda(q, lib, 4, precision, form="twopass")
            pv, _ = kknn.knn_topk_plain(q, lib, 5, precision)
            tol = 1e-4 if precision == "default" else 1e-5
            assert max_err(cv, tv) <= tol, (ls, rows, precision, max_err(cv, tv))
            clear = (pv[:, 3] - pv[:, 4]) > tol
            same = (torch.sort(ci, 1).values == torch.sort(ti, 1).values).all(1)
            assert bool((same | ~clear).all()), (ls, rows, precision)
    lib = torch.randn(2000, 768, generator=g, device="cuda")
    q = lib[1500:1524] + 0.01 * torch.randn(24, 768, generator=g, device="cuda")
    assert kknn.knn_plan(24, 1000, "highest", route_rows=2000).form == "carried"
    for precision in kknn.PRECISIONS:
        fv, fi = kknn.knn_topk(q, lib, 4, precision)
        sv, si = kknn.knn_topk(q, lib[1000:], 4, precision, valid_rows=torch.tensor(990, device="cuda"),
                               route_rows=2000)
        assert torch.equal(fi[:, 0], torch.arange(1500, 1524, device="cuda")), precision
        assert torch.equal(si[:, 0] + 1000, fi[:, 0]) and torch.equal(sv[:, 0], fv[:, 0]), precision


@pytest.mark.gpu
def test_knn_carried_scratch_formula_on_card():
    """``kernels/knn.py:carried_scratch_bytes`` (what the wrapper allocates)
    equals the kernel's own ``knn_carried_scratch_bytes`` at every card
    case's plan, and every plan's shared memory fits a block."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run this file with --noconftest -m gpu")
    import ctypes

    from alivevc_tpu_torch.kernels import _lib

    fn = _lib.library("knn_carried").knn_carried_scratch_bytes
    fn.argtypes = [ctypes.c_int] * 8
    fn.restype = ctypes.c_longlong
    for ls in KNN_CARRIED_QUERIES:
        for spec in KNN_CARRIED_ROWS:
            for k, precision, rows, kw in knn_carried_variants(spec):
                vr = kw.get("valid_rows")
                lv = vr if isinstance(vr, int) else rows
                packed = kw.get("extraction") == "packed"
                plan = kknn.knn_plan(ls, rows, precision, k, valid_rows=lv, packed=packed)
                mode = 2 if packed else int(precision == "default")
                kk = 4 if k <= 4 else 8
                assert plan.scratch == fn(ls, rows, lv, 768, kk, mode, plan.nq, plan.wg), (ls, rows)
                assert plan.smem <= kknn.SMEM_LIMIT


# (level, windows, input samples, FiLM frames): the four (C, r) level shapes
# (C = 256 / 64 / 16 / 8 at r = 10 / 8 / 2 / 2) at small L, none a multiple
# of the kernels' time tiles (narrow 199, wide 64 or 128); narrow levels of
# 60 samples, just over the 56-sample lookback, so that tile 0 is the only
# tile and reflects; one FiLM frame for a whole level (F r == L, F = 1).
# The small wide levels take wide_plan's K splits over clusters of 2 and 4
# and its narrow column tiles; the last two (4 x 4 510 and 2 x 9 608
# samples) its 128-row tiles without a split, with streamed (C = 256) and
# resident (C = 64) weights.
# The narrow levels' own edges (kernels/filter.py:narrow_plan's tiles): a
# level one input row longer than a tile (C = 16 at 32 windows of 522
# samples in bf16, of 266 in float32; C = 8 at 32 x 458), a level ending one
# input row into a tile over several windows (22 x 1 562), the tiles at
# sample 0 of three windows with several tiles each (3 x 14 000, 3 x 32 000),
# and the streaming hop's N = 1 (3 840 and 7 680 samples); together they
# take every branch of the plan (tests/test_torch_port_filter_plan.py).
FILTER_EDGES = [(0, 2, 50, 50), (1, 2, 120, 12), (2, 2, 480, 6), (3, 1, 640, 4),
                (0, 1, 2, 2), (1, 1, 8, 1), (2, 1, 30, 1), (3, 2, 30, 1), (3, 3, 530, 53),
                (0, 4, 451, 41), (1, 2, 1201, 1),
                (2, 32, 261, 1), (2, 32, 133, 1), (3, 32, 229, 1), (2, 22, 781, 1),
                (2, 3, 7000, 35), (3, 3, 16000, 100), (2, 1, 1920, 24), (3, 1, 3840, 24)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_filter_level_edges_on_card(dtype):
    """The redesigned filter kernels (wide at C = 256, 64; one launch at
    C = 16, 8) against filter_level_plain at chip_smoke.py's tolerances:
    float32 1e-3 (1 + scale), bf16 4e-2 (1 + scale)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run this file with --noconftest -m gpu")
    from alivevc_tpu_torch.infer.offline import cast_params
    from alivevc_tpu_torch.kernels import LAUNCHES

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dt = getattr(torch, dtype)
    dec = Decoder(DecoderConfig(), generator=torch.Generator().manual_seed(0)).cuda()
    g = torch.Generator(device="cuda").manual_seed(2)
    for level, n, l_in, frames in FILTER_EDGES:
        up, blk = cast_params(dec.filter.ups[level], dt), cast_params(dec.filter.blocks[level], dt)
        cin, c, r = dec.filter.ups[level].weight.shape
        x = (0.3 * torch.randn(n, l_in, cin, generator=g, device="cuda")).to(dt)
        s = (0.3 * torch.randn(n, l_in, cin, generator=g, device="cuda")).to(dt)
        cond = (0.5 * torch.randn(n, frames, 512, generator=g, device="cuda")).to(dt)
        with torch.no_grad():
            args = level_args(blk, up, cond)
            before = dict(LAUNCHES)
            got = kfilter.filter_level_cuda(x, s, rate=r, **args)
            want = kfilter.filter_level_plain(x, s, rate=r, **args)
        torch.cuda.synchronize()
        narrow = kfilter.takes_narrow(c, cin, r, 5, args["dilations"])
        assert LAUNCHES["filter_level"] == before["filter_level"] + 1
        assert LAUNCHES["filter_narrow"] == before["filter_narrow"] + narrow
        assert LAUNCHES["filter_wide"] == before["filter_wide"] + (not narrow)
        assert got.shape == want.shape == (n, l_in * r, c) and got.dtype == dt
        scale = float(want.float().abs().max())
        tol = (1e-3 if dt == torch.float32 else 4e-2) * (1.0 + scale)
        assert bool(torch.isfinite(got).all()), (level, n, l_in, frames)
        assert max_err(got, want) <= tol, (level, n, l_in, frames, max_err(got, want), tol)


def _random_level(g, dt, n, l_in, cin, c, rate, k, dilations, frames):
    """A level's inputs and weights in kernels/filter.py's layouts, random
    with unit-scale activations."""
    def rnd(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=g, device="cuda")).to(dt)

    n_conv = len(dilations)
    return dict(
        x_prev=rnd(n, l_in, cin, scale=0.3), skip=rnd(n, l_in, cin, scale=0.3),
        up_w=rnd(cin, rate * c, scale=cin ** -0.5), up_b=rnd(c, scale=0.1),
        in_w=rnd(c, c, scale=c ** -0.5), in_b=rnd(c, scale=0.1),
        conv_w=[rnd(k, c, c, scale=(k * c) ** -0.5) for _ in range(n_conv)],
        conv_b=[rnd(c, scale=0.1) for _ in range(n_conv)],
        film=torch.cat([torch.cat([1.0 + rnd(n, frames, c, scale=0.2), rnd(n, frames, c, scale=0.2)], 2)
                        for _ in range(n_conv)], 2),
        rate=rate, dilations=list(dilations))


# (windows, input samples, C_in, C, rate, k, dilations, FiLM frames): shapes
# off the main path that reach the wide kernel's other tile shapes.  C = 64
# from C_in = 256 at rate 2 (an up conv of N = 128 columns from 256 input
# channels: float32's 64-row tile for wide inputs); C = 136 (every product
# in that tile in float32, three masked column tiles in bf16); C = 16 from
# C_in = 256 and C = 8 at rate 10 (narrow levels the one-launch kernel
# refuses: more input channels or a higher rate than its shared memory
# takes); C = 256 with k = 7 at dilation 4 (a 24-row halo: the largest
# operand tile the wide kernel stages).
WIDE_ROUTES = [(2, 70, 256, 64, 2, 5, (1, 1, 2, 2), 7), (1, 45, 136, 136, 2, 5, (1, 2), 3),
               (2, 90, 256, 16, 2, 5, (1, 1, 2, 2, 4, 4), 9), (1, 33, 16, 8, 10, 5, (1, 2), 11),
               (2, 20, 256, 256, 10, 7, (4, 4), 4)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_filter_level_wide_routes_on_card(dtype):
    """Every tile shape of the wide kernel, and its route for narrow levels
    that the one-launch kernel refuses, against filter_level_plain at
    chip_smoke.py's tolerances; a second call returns the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run this file with --noconftest -m gpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(3)
    for case in WIDE_ROUTES:
        args = _random_level(g, dt, *case)
        with torch.no_grad():
            got = kfilter.filter_level_cuda(**args)
            again = kfilter.filter_level_cuda(**args)
            want = kfilter.filter_level_plain(**args)
        torch.cuda.synchronize()
        n, l_in, _, c, rate = case[:5]
        assert got.shape == want.shape == (n, l_in * rate, c) and got.dtype == dt
        assert torch.equal(got, again), case
        scale = float(want.float().abs().max())
        tol = (1e-3 if dt == torch.float32 else 4e-2) * (1.0 + scale)
        assert bool(torch.isfinite(got).all()), case
        assert max_err(got, want) <= tol, (case, max_err(got, want), tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_filter_level_repeatable_on_card(dtype):
    """The four levels at chip_smoke.py's main-path shapes (16 windows of
    144 000 samples) give the same bits in five calls: a race between the
    kernels' warps, or a read of shared memory that another tile wrote,
    would show as calls that differ."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run this file with --noconftest -m gpu")
    from alivevc_tpu_torch.infer.offline import cast_params

    dt = getattr(torch, dtype)
    dec = Decoder(DecoderConfig(), generator=torch.Generator().manual_seed(0)).cuda()
    g = torch.Generator(device="cuda").manual_seed(4)
    n, lw = 16, 144_000
    cond = (0.5 * torch.randn(n, lw // 320, 512, generator=g, device="cuda")).to(dt)
    for level, length in enumerate((lw // 32, lw // 4, lw // 2, lw)):
        up, blk = cast_params(dec.filter.ups[level], dt), cast_params(dec.filter.blocks[level], dt)
        cin, _, r = dec.filter.ups[level].weight.shape
        x = (0.3 * torch.randn(n, length // r, cin, generator=g, device="cuda")).to(dt)
        s = (0.3 * torch.randn(n, length // r, cin, generator=g, device="cuda")).to(dt)
        with torch.no_grad():
            args = level_args(blk, up, cond)
            first = kfilter.filter_level_cuda(x, s, rate=r, **args)
            for _ in range(4):
                assert torch.equal(kfilter.filter_level_cuda(x, s, rate=r, **args), first), level
        assert bool(torch.isfinite(first).all()), level


# the narrow levels' (C_in, C, rate) by level
NARROW_LEVELS = {2: (64, 16, 2), 3: (16, 8, 2)}


def narrow_layout_cases():
    """(n_conv, k, cin, c, rate, frame rate, rows, owners, stages, dtype) of
    the narrow plans the card tests and the main path take: FILTER_EDGES'
    narrow levels, the bench shape (16 windows of 144 000 samples), the
    hop's, in both types."""
    shapes = [(level, n, l_in * NARROW_LEVELS[level][2], l_in * NARROW_LEVELS[level][2] // frames)
              for level, n, l_in, frames in FILTER_EDGES if level in NARROW_LEVELS]
    shapes += [(2, 16, 72_000, 160), (3, 16, 144_000, 320), (2, 1, 3_840, 160), (3, 1, 7_680, 320)]
    cases = []
    for level, n, length, fr in shapes:
        cin, c, rate = NARROW_LEVELS[level]
        for dt in (torch.bfloat16, torch.float32):
            p = kfilter.narrow_plan(n, length, cin, c, rate, dt, fr)
            cases.append((6, 5, cin, c, rate, fr, p["rows"], p["owners"], p["stages"], dt))
    return cases


@pytest.mark.gpu
def test_narrow_layout_formula_on_card():
    """kernels/filter.py:narrow_layout (the plan's shared memory and the
    weight blob) equals csrc/filter.cu's narrow_layout, which the kernel
    lays its shared memory out by, at every narrow plan of the card tests
    and the main path."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run this file with --noconftest -m gpu")
    import ctypes
    from alivevc_tpu_torch.kernels import _lib

    fn = _lib.function("filter", "filter_narrow_layout", "i" * 10 + "p")
    out = (ctypes.c_longlong * 2)()
    for n_conv, k, cin, c, rate, fr, rows, owners, stages, dt in narrow_layout_cases():
        assert fn(n_conv, k, cin, c, rate, fr, rows, owners, stages, int(dt == torch.bfloat16),
                  ctypes.addressof(out)) == 0
        want = kfilter.narrow_layout(n_conv, k, cin, c, rate, fr, rows, owners, stages, dt)
        assert (out[0], out[1]) == (want["smem"], want["blob"]), (cin, c, rows, owners, stages, dt)
        assert out[0] <= kfilter.SMEM_LIMIT


# (windows, frames, harmonics, samples a frame): the oscillator kernels'
# edges, each value at least once: Lf = 1, 2, 7, 9, 450, 451; NH = 1, 3,
# 64, 256; seg = 320 and an odd 161 (a middle sample on frame q alone);
# N = 1 and 64.  Lf = 451 leaves a tile of one frame.
OSC_EDGES = [(1, 1, 64, 320), (1, 2, 3, 161), (64, 7, 1, 320), (2, 9, 256, 161), (1, 450, 64, 320),
             (1, 451, 256, 161), (64, 2, 64, 320), (3, 451, 3, 320), (2, 450, 1, 161), (64, 9, 256, 320)]


def _osc_case(g, source, n, lf, nh):
    """Random inputs of one source: f0 80-380 Hz (formants: harmonics of an
    f0 scaled so that the top one stays under 8 kHz, each off its multiple
    by ~1 %), amplitudes exp(0.3 N(0, 1))."""
    f0 = 80.0 + 300.0 * torch.rand(n, lf, 1, generator=g, device="cuda")
    amps = torch.exp(0.3 * torch.randn(n, lf, nh, generator=g, device="cuda"))
    if source == "cheb":
        return (f0, amps), (kosc.harmonic_source_cuda, kosc.harmonic_source_plain,
                            kosc.harmonic_source_replay)
    k = torch.arange(1, nh + 1, device="cuda") * (1.0 + 0.01 * torch.randn(nh, generator=g, device="cuda"))
    formants = f0 * min(1.0, 20.0 / nh) * k
    return (formants, amps), (kosc.harmonic_source_formants_cuda, kosc.harmonic_source_formants_plain,
                              kosc.harmonic_source_formants_replay)


@pytest.mark.gpu
@pytest.mark.parametrize("source", ["cheb", "formants"])
def test_oscillator_edges_on_card(source):
    """Both oscillator kernels at their edges (OSC_EDGES) against the plain
    version at chip_smoke.py's 5e-3, and against the replay of their own
    arithmetic (kernels/oscillator.py:*_replay, run on the card) at 1e-3
    (Chebyshev: sincosf against torch.sin/cos, an ulp apart, grown by the
    recurrence up to k = 256) and 1e-4 (formants: the SFU sine's ~4e-7);
    bf16 amplitudes are read as they are (the same bits as their float32
    values)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run this file with --noconftest -m gpu")
    g = torch.Generator(device="cuda").manual_seed(5)
    replay_tol = 1e-3 if source == "cheb" else 1e-4
    errs = {}
    for n, lf, nh, seg in OSC_EDGES:
        (f, amps), (kernel, plain, replay) = _osc_case(g, source, n, lf, nh)
        got = kernel(f, amps, seg=seg)
        e_plain = max_err(got, plain(f, amps, seg=seg))
        e_replay = max_err(got, replay(f, amps, seg=seg))
        assert got.shape == (n, lf * seg, 1) and bool(torch.isfinite(got).all()), (n, lf, nh, seg)
        errs[(n, lf, nh, seg)] = (e_plain, e_replay)
        ab = amps.bfloat16()
        assert torch.equal(kernel(f, ab, seg=seg), kernel(f, ab.float(), seg=seg)), (n, lf, nh, seg)
    print(f"{source}: (max err vs plain, vs replay) {errs}")
    assert all(p <= 5e-3 and r <= replay_tol for p, r in errs.values()), errs
    # shapes the kernels refuse: no harmonic, NH > 256, frames that do not
    # match, seg > 1024
    (f, amps), (kernel, _, _) = _osc_case(g, source, 1, 4, 8)
    for a, seg in ((amps[..., :0], 320), (torch.ones(1, 4, 257, device="cuda"), 320),
                   (amps[:, :3], 320), (amps, 1025)):
        with pytest.raises(ValueError):
            kernel(f, a, seg=seg)


@pytest.mark.gpu
def test_oscillator_repeatable_without_host_sync_on_card():
    """Both oscillator kernels at chip_smoke.py's main-path shape (16 windows
    of 450 frames, 64 harmonics) give the same bits in five calls, and
    neither wrapper copies between host and device or waits on the stream:
    they run under torch.cuda.set_sync_debug_mode('error'), including a
    first call at a new seg (the weight table's upload)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run this file with --noconftest -m gpu")
    g = torch.Generator(device="cuda").manual_seed(6)
    cases = [_osc_case(g, source, 16, 450, 64) for source in ("cheb", "formants")]
    for (f, amps), (kernel, _, _) in cases:
        first = kernel(f, amps)
        for _ in range(4):
            assert torch.equal(kernel(f, amps), first)
        assert bool(torch.isfinite(first).all())
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for (f, amps), (kernel, _, _) in cases:
            kernel(f, amps)
            kernel(f, amps.bfloat16())
            kernel(f[:2, :9], amps[:2, :9], seg=317)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


# (windows, frames, harmonics, samples a frame): the streaming source at the
# hop's shape and its edges (one frame; an odd seg; NH = 1, 3 and 256; an
# offline window's 450 frames, a chain of 144 000 adds)
STREAM_EDGES = [(1, 24, 64, 320), (3, 1, 64, 7), (3, 5, 64, 7), (2, 9, 256, 161), (2, 7, 1, 320),
                (1, 450, 3, 320)]


def _stream_case(g, n, lf, nh, shifted):
    """f0 0-4 095 Hz with a fifth of the frames at 0 (or those shifted up 7
    semitones by ``shift_pitch``, as the hop shifts them), amplitudes exp(0.3
    N(0, 1)), and three (phi, crop0) pairs: per-row phi at the first
    sample, one phi row at the middle, a number at the last."""
    from alivevc_tpu_torch.ops.pitch import shift_pitch

    f0 = 4095.0 * torch.rand(n, lf, 1, generator=g, device="cuda")
    f0 = torch.where(torch.rand(n, lf, 1, generator=g, device="cuda") < 0.2, 0.0, f0)
    if shifted:
        f0 = shift_pitch(f0, 7.0)
    amps = torch.exp(0.3 * torch.randn(n, lf, nh, generator=g, device="cuda"))
    phis = [3.0 * torch.rand(n, 1, nh, generator=g, device="cuda") - 1.5,
            3.0 * torch.rand(1, 1, nh, generator=g, device="cuda") - 1.5, 0.3]
    return f0, amps, phis


@pytest.mark.gpu
def test_oscillator_stream_on_card():
    """The streaming source kernel at the hop's shape and at its edges
    (STREAM_EDGES), f0 across 0-4 095 Hz and shifted, the phase re-zeroed at
    the first, the middle and the last sample: phi_out bit-equal to the
    plain version on the card (the same float32 operations in the same
    order: the chain is ATen's scan order), the waveform within 1e-6 of its
    peak; bf16 amplitudes read as they are; the same bits in three calls,
    none of which copies between host and device or waits on the stream;
    the shapes and arguments it refuses."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run this file with --noconftest -m gpu")
    g = torch.Generator(device="cuda").manual_seed(9)
    errs = {}
    for n, lf, nh, seg in STREAM_EDGES:
        lw = lf * seg
        for shifted in (False, True):
            f0, amps, phis = _stream_case(g, n, lf, nh, shifted)
            for phi, crop0 in zip(phis, (0, lw // 2, lw - 1)):
                wave, phi_out = kosc.harmonic_source_stream_cuda(f0, amps, phi, crop0, seg=seg)
                want_wave, want_phi = kosc.harmonic_source_stream_plain(f0, amps, phi, crop0, seg=seg)
                key = (n, lf, nh, seg, shifted, crop0)
                assert wave.shape == (n, lw, 1) and phi_out.shape == (n, lw, nh), key
                assert torch.equal(phi_out, want_phi), (key, max_err(phi_out, want_phi))
                peak = float(want_wave.abs().max())
                errs[key] = max_err(wave, want_wave) / peak
                assert errs[key] <= 1e-6, (key, errs[key])
                ab = amps.bfloat16()
                got = kosc.harmonic_source_stream_cuda(f0, ab, phi, crop0, seg=seg)
                want = kosc.harmonic_source_stream_cuda(f0, ab.float(), phi, crop0, seg=seg)
                assert all(torch.equal(a, b) for a, b in zip(got, want)), key
    print(f"oscillator_stream: max err vs plain over the peak {errs}")
    f0, amps, phis = _stream_case(g, 1, 24, 64, False)
    first = kosc.harmonic_source_stream_cuda(f0, amps, phis[0], 3360)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = [kosc.harmonic_source_stream_cuda(f0, amps, phis[0], 3360) for _ in range(3)]
        kosc.harmonic_source_stream_cuda(f0[:, :9], amps[:, :9], 0.5, -1, seg=317)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert all(torch.equal(a, b) for out in again for a, b in zip(out, first))
    for args, err in (((f0, amps[..., :0], 0.0, 0), ValueError),
                      ((f0, torch.ones(1, 24, 257, device="cuda"), 0.0, 0), ValueError),
                      ((f0, amps[:, :3], 0.0, 0), ValueError),
                      ((f0, amps, phis[0][..., :8], 0), ValueError),
                      ((f0, amps, phis[0].double(), 0), TypeError),
                      ((f0, amps, 0.0, 24 * 320), IndexError)):
        with pytest.raises(err):
            kosc.harmonic_source_stream_cuda(*args)


def _sharded_run(world: int) -> dict:
    """The sharded path on a ('data', 1) x ('library', world) mesh at a small
    size: default model widths, 2 windows of 9 600 samples, 4 001 rows."""
    from alivevc_tpu_torch.config import ContentEncoderConfig, F0EstimatorConfig
    from alivevc_tpu_torch.device import float32_math
    from alivevc_tpu_torch.kernels import LAUNCHES, reset_launches
    from alivevc_tpu_torch.models.content_encoder import ContentEncoder, content_encoder
    from alivevc_tpu_torch.models.f0_estimator import F0Estimator
    from alivevc_tpu_torch.ops.stft import spectrogram
    from alivevc_tpu_torch.parallel import (
        convert_windows_distributed,
        make_mesh,
        pad_library_for_sharding,
        sharded_match_features,
    )

    g = torch.Generator().manual_seed(0)
    ce = ContentEncoder(ContentEncoderConfig(), generator=g).cuda().eval()
    f0m = F0Estimator(F0EstimatorConfig(), generator=g).cuda().eval()
    dec = Decoder(DecoderConfig(), generator=g).cuda().eval()
    lib = torch.randn(4001, 768, generator=torch.Generator(device="cuda").manual_seed(1), device="cuda")
    tt = np.arange(9600) / 16000.0
    windows = torch.from_numpy(np.stack([0.4 * np.sin(2 * np.pi * f * tt)
                                         for f in (120.0, 230.0)]).astype(np.float32)).cuda()
    mesh = make_mesh([("data", 1), ("library", world)], "cuda")
    reset_launches()
    wave = convert_windows_distributed(mesh, ce, f0m, dec, windows, lib, precision="highest")
    with float32_math():
        feat = content_encoder(ce, spectrogram(windows)).reshape(-1, 768)
    _, idx = sharded_match_features(mesh, feat, *pad_library_for_sharding(lib, world),
                                    return_indices=True)
    return {"wave": wave.cpu(), "idx": idx.cpu(), "launches": dict(LAUNCHES)}


def _sharded_rank(rank: int, world: int, tmp: str) -> None:
    import torch.distributed as dist

    from alivevc_tpu_torch.parallel import init_distributed

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_grad_enabled(False)
    init_distributed("gloo", f"file://{tmp}/rendezvous{world}", world, rank)
    try:
        torch.save(_sharded_run(world), os.path.join(tmp, f"w{world}r{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
def test_sharded_path_two_ranks_on_card(tmp_path):
    """convert_windows_distributed and sharded_match_features as 2 gloo ranks
    on one card against 1 rank; every rank launches the path's kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run this file with --noconftest -m gpu")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_sharded_rank, args=(r, w, str(tmp_path)))
             for w, r in ((2, 0), (2, 1), (1, 0))]
    for p in procs:
        p.start()
    for p in procs:
        p.join(300)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
    assert not alive and all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    two, two_b, one = (torch.load(tmp_path / f, weights_only=False)
                       for f in ("w2r0.pt", "w2r1.pt", "w1r0.pt"))
    assert torch.equal(two["wave"], two_b["wave"]) and torch.equal(two["idx"], two_b["idx"])
    assert torch.equal(torch.sort(two["idx"], 1).values, torch.sort(one["idx"], 1).values)
    assert max_err(two["wave"], one["wave"]) <= 1e-4
    for res in (two, two_b, one):
        # 4 001 rows (4 002 padded) take the carried form on one rank and on each shard
        assert all(res["launches"][k] > 0 for k in ("knn_carried", "oscillator", "filter_level")), \
            res["launches"]


# ---------------------------------------------------------------------------
# the streaming hop's shapes: N = 1, a 24-frame window of 7 680 samples, a
# library of ~900 rows; and capture in a CUDA graph
# ---------------------------------------------------------------------------

HOP = 7680                       # StreamingConfig(): buffer_size 8 x chunk 960
HOP_LEVELS = (HOP // 32, HOP // 4, HOP // 2, HOP)   # output length of up level i
GUARD = 4096                     # sentinel elements on each side of a guarded buffer
SENTINEL = -777.0


def _at_end(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` placed at the very end of a larger allocation."""
    buf = torch.empty(GUARD + t.numel(), dtype=t.dtype, device=t.device)
    view = buf[GUARD:].view(t.shape)
    view.copy_(t)
    return view


class _GuardedTorch:
    """``torch`` as kernels/filter.py sees it, except that ``empty`` and
    ``empty_like`` hand out the middle of a sentinel-filled buffer: a
    kernel that writes past either end of its output or scratch shows."""

    def __init__(self):
        self.buffers = []

    def __getattr__(self, name):
        return getattr(torch, name)

    def empty(self, shape, dtype, device):
        numel = int(np.prod(shape))
        buf = torch.full((2 * GUARD + numel,), _sentinel(dtype), dtype=dtype, device=device)
        self.buffers.append((buf, numel))
        return buf[GUARD:GUARD + numel].view(shape)

    def empty_like(self, t):
        return self.empty(t.shape, dtype=t.dtype, device=t.device)

    def guards_intact(self) -> bool:
        return all(bool((buf[:GUARD] == _sentinel(buf.dtype)).all())
                   and bool((buf[GUARD + n:] == _sentinel(buf.dtype)).all()) for buf, n in self.buffers)


def _sentinel(dtype):
    """The guard value of a buffer: SENTINEL, or 0xA5 in a byte buffer."""
    return 0xA5 if dtype == torch.uint8 else SENTINEL


def _hop_level(dec, level, g):
    """Up level ``level`` at the hop's shapes, float32: (x_prev, skip, rate,
    args) with the activations and FiLM at the end of their allocations."""
    cin, _, r = dec.filter.ups[level].weight.shape
    l_in = HOP_LEVELS[level] // r
    cond = 0.5 * torch.randn(1, HOP // 320, 512, generator=g, device="cuda")
    args = level_args(dec.filter.blocks[level], dec.filter.ups[level], cond)
    args["film"] = _at_end(args["film"])
    x = _at_end(0.3 * torch.randn(1, l_in, cin, generator=g, device="cuda"))
    s = _at_end(0.3 * torch.randn(1, l_in, cin, generator=g, device="cuda"))
    return x, s, r, args


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["stft", "knn_high", "filter_level_0", "filter_level_1",
                                  "filter_level_2", "filter_level_3"])
def test_hop_shape_kernels_on_card(name, monkeypatch):
    """The kernels of the streaming hop at its shapes against their plain
    versions: the STFT of one 7 680-sample window (25 frames: 7 blocks of
    4, the last partial, reflect pad at both ends), kNN 'high' for 24
    queries over 887 rows, and the four float32 filter levels at N = 1 with
    their inputs at the end of their allocations and every output and
    scratch buffer (levels 0-1: the K-major weights too, read by TMA, and
    the K split's cluster reduction writing the outputs) between sentinel
    guards that must stay untouched (levels 2-3: the narrow kernel's
    weight blob too)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run this file with --noconftest -m gpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(5)
    if name == "stft":
        x = _at_end(0.3 * torch.randn(1, HOP, generator=g, device="cuda"))
        got = kstft.stft_magnitude_cuda(x)
        want = kstft.stft_magnitude_plain(x)
        assert got.shape == (1, 25, 641)
        assert max_err(got, want) <= 1e-3
        assert max_err(got[:, [0, -1]], want[:, [0, -1]]) <= 1e-3
    elif name == "knn_high":
        q = _at_end(torch.randn(24, 768, generator=g, device="cuda"))
        lib = _at_end(torch.randn(887, 768, generator=g, device="cuda"))
        _knn_vs_plain(q, lib, 4, "high")
    else:
        level = int(name[-1])
        dec = Decoder(DecoderConfig(), generator=torch.Generator().manual_seed(0)).cuda()
        x, s, r, args = _hop_level(dec, level, g)
        guarded = _GuardedTorch()
        monkeypatch.setattr(kfilter, "torch", guarded)
        with torch.no_grad():
            got = kfilter.filter_level_cuda(x, s, rate=r, **args)
            torch.cuda.synchronize()
            monkeypatch.undo()
            want = kfilter.filter_level_plain(x, s, rate=r, **args)
        assert got.shape == (1, HOP_LEVELS[level], dec.filter.ups[level].weight.shape[1])
        # levels 0-1 (the wide kernel): its K-major weights (TF32 hi, lo) and
        # the up, 1x1 and conv outputs; levels 2-3 (the narrow kernel): its
        # weight blob (read by one bulk copy a block) and the output (written
        # by TMA stores)
        assert len(guarded.buffers) == (5 if level < 2 else 2), (name, len(guarded.buffers))
        assert guarded.guards_intact(), name
        scale = float(want.abs().max())
        assert bool(torch.isfinite(got).all())
        assert max_err(got, want) <= 1e-3 * (1.0 + scale), (name, max_err(got, want))


def _graph_cases(g):
    """(name, wrapper call, inputs it reads) for each kernel wrapper at the
    hop's shapes (the oscillators at a 24-frame window)."""
    dec = Decoder(DecoderConfig(), generator=torch.Generator().manual_seed(0)).cuda()
    f0 = 80.0 + 300.0 * torch.rand(1, 24, 1, generator=g, device="cuda")
    amps = torch.exp(0.3 * torch.randn(1, 24, 64, generator=g, device="cuda"))
    formants = f0 * torch.arange(1, 65, device="cuda")
    phi = 3.0 * torch.rand(1, 1, 64, generator=g, device="cuda") - 1.5
    q = torch.randn(24, 768, generator=g, device="cuda")
    lib = torch.randn(887, 768, generator=g, device="cuda")
    many = torch.randn(960, 768, generator=g, device="cuda")    # several query tiles
    x = 0.3 * torch.randn(1, HOP, generator=g, device="cuda")
    wide = _hop_level(dec, 1, g)
    narrow = _hop_level(dec, 3, g)
    return [
        ("stft", lambda: kstft.stft_magnitude_cuda(x), [x]),
        ("knn_high", lambda: kknn.knn_topk_cuda(q, lib, 4, "high")[1], [q, lib]),
        ("knn_default", lambda: kknn.knn_topk_cuda(q, lib, 4, "default")[1], [q, lib]),
        ("knn_high_twopass", lambda: kknn.knn_topk_cuda(q, lib, 4, "high", form="twopass")[1], [q, lib]),
        ("knn_carried_tiles", lambda: kknn.knn_topk_cuda(many, lib, 8, "highest")[1], [many, lib]),
        ("oscillator", lambda: kosc.harmonic_source_cuda(f0, amps), [f0, amps]),
        ("oscillator_formants", lambda: kosc.harmonic_source_formants_cuda(formants, amps),
         [formants, amps]),
        ("oscillator_stream", lambda: torch.cat([x.flatten() for x in kosc.harmonic_source_stream_cuda(
            f0, amps, phi, 3360)]), [f0, amps, phi]),
        ("filter_level_wide", lambda: kfilter.filter_level_cuda(wide[0], wide[1], rate=wide[2],
                                                                **wide[3]), [wide[0], wide[1]]),
        ("filter_level_narrow", lambda: kfilter.filter_level_cuda(
            narrow[0], narrow[1], rate=narrow[2], **narrow[3]), [narrow[0], narrow[1]]),
    ]


@pytest.mark.gpu
def test_kernel_wrappers_replay_in_cuda_graph_on_card():
    """Each wrapper captured in a CUDA graph: after new values are copied
    into the captured inputs, a replay equals an eager call on them; a
    replay adds nothing to the launch counts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run this file with --noconftest -m gpu")
    from alivevc_tpu_torch.kernels import LAUNCHES

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(6)
    with torch.no_grad():
        for name, call, inputs in _graph_cases(g):
            call()          # first use: builds, tables on the card
            torch.cuda.synchronize()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out = call()
            for t in inputs:     # new values, same storage
                t.copy_(t.roll(1, 0) * 1.01 if t.shape[0] > 1 else t.flip(-2) * 1.01)
            want = call()
            counts = dict(LAUNCHES)
            graph.replay()
            torch.cuda.synchronize()
            assert LAUNCHES == counts, name
            assert torch.equal(out, want), (name, max_err(out, want))


@pytest.mark.gpu
def test_streaming_graph_equals_eager_on_card():
    """StreamingConverter at full width: the hop replayed as one CUDA graph
    equals the eager hop over 10 hops from the same primed state (the same
    kernels on the same inputs: expected identical, held to 1e-5); the
    pipelined graph returns the same chunks one hop late; reset re-zeroes
    the state the graph reads."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run this file with --noconftest -m gpu")
    from alivevc_tpu_torch.config import ContentEncoderConfig, F0EstimatorConfig
    from alivevc_tpu_torch.infer.streaming import StreamingConverter
    from alivevc_tpu_torch.kernels import LAUNCHES, reset_launches
    from alivevc_tpu_torch.models.content_encoder import ContentEncoder
    from alivevc_tpu_torch.models.f0_estimator import F0Estimator

    gen = torch.Generator().manual_seed(0)
    ce = ContentEncoder(ContentEncoderConfig(), generator=gen).cuda()
    f0m = F0Estimator(F0EstimatorConfig(), generator=gen).cuda()
    dec = Decoder(DecoderConfig(), generator=gen).cuda()
    tgt = torch.randn(900, 768, generator=torch.Generator(device="cuda").manual_seed(7), device="cuda")
    tt = np.arange(960 * 18) / 16000.0
    wave = (0.4 * np.sin(2 * np.pi * (150 + 40 * np.sin(2 * np.pi * tt)) * tt)).astype(np.float32)
    chunks = [wave[i * 960:(i + 1) * 960] for i in range(8, 18)]
    outs = {}
    for name, kw in (("eager", dict(cuda_graph=False)), ("graph", {}),
                     ("piped", dict(pipeline_depth=1))):
        conv = StreamingConverter(ce, f0m, dec, tgt, **kw)
        assert conv.cuda_graph == (name != "eager")
        conv.prime(wave[:960 * 8])
        reset_launches()
        outs[name] = [conv.process_chunk(c) for c in chunks] + conv.flush()
        if name == "eager":
            assert all(LAUNCHES[k] == 10 for k in ("stft", "knn_carried")) and LAUNCHES["filter_level"] == 40
        else:   # the warm-up hops and the capture only
            assert LAUNCHES["stft"] == 3
        conv.reset()
        conv.prime(wave[:960 * 8])
        again = conv.process_chunk(chunks[0])
        if name != "piped":
            assert np.array_equal(again, outs[name][0])
    err = max(float(np.abs(a - b).max()) for a, b in zip(outs["eager"], outs["graph"]))
    assert err <= 1e-5, err
    assert all(np.isfinite(o).all() for o in outs["graph"])
    assert np.array_equal(outs["piped"][0], np.zeros(960, np.float32))
    for a, b in zip(outs["graph"], outs["piped"][1:]):
        assert np.array_equal(a, b)


@pytest.mark.gpu
def test_streaming_hops_through_the_source_kernel_equal_the_plain_source_on_card(monkeypatch):
    """StreamingConverter at full width, 20 hops of carried phase as one
    CUDA graph: the hops whose decoder runs the streaming source kernel
    against the same hops forced through the plain version on the card
    (``harmonic_source_stream_plain`` in the decoder's place): within 1e-6
    of the stream's peak, and the carried phase bit-equal after every hop.
    The kernel launches at the two warm-up hops and at the capture only."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run this file with --noconftest -m gpu")
    from alivevc_tpu_torch.config import ContentEncoderConfig, F0EstimatorConfig
    from alivevc_tpu_torch.infer.streaming import WARMUP_HOPS, StreamingConverter
    from alivevc_tpu_torch.kernels import LAUNCHES, reset_launches
    from alivevc_tpu_torch.models import decoder as mdec
    from alivevc_tpu_torch.models.content_encoder import ContentEncoder
    from alivevc_tpu_torch.models.f0_estimator import F0Estimator

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    ce = ContentEncoder(ContentEncoderConfig(), generator=gen).cuda()
    f0m = F0Estimator(F0EstimatorConfig(), generator=gen).cuda()
    dec = Decoder(DecoderConfig(), generator=gen).cuda()
    tgt = torch.randn(900, 768, generator=torch.Generator(device="cuda").manual_seed(7), device="cuda")
    tt = np.arange(960 * 28) / 16000.0
    wave = (0.4 * np.sin(2 * np.pi * (150 + 40 * np.sin(2 * np.pi * tt)) * tt)).astype(np.float32)
    chunks = [wave[i * 960:(i + 1) * 960] for i in range(8, 28)]
    outs, phis = {}, {}
    for name in ("kernel", "plain"):
        if name == "plain":
            monkeypatch.setattr(mdec, "harmonic_source_stream", kosc.harmonic_source_stream_plain)
        conv = StreamingConverter(ce, f0m, dec, tgt)
        conv.prime(wave[:960 * 8])
        reset_launches()
        outs[name], phis[name] = [], []
        for c in chunks:
            outs[name].append(conv.process_chunk(c))
            phis[name].append(conv.state.phi.clone())
        assert LAUNCHES["oscillator_stream"] == (WARMUP_HOPS + 1 if name == "kernel" else 0), name
    peak = max(float(np.abs(o).max()) for o in outs["plain"])
    err = max(float(np.abs(a - b).max()) for a, b in zip(outs["kernel"], outs["plain"]))
    assert err <= 1e-6 * peak, (err, peak)
    assert all(torch.equal(a, b) for a, b in zip(phis["kernel"], phis["plain"]))
    assert any(bool(p.any()) for p in phis["kernel"])


# ---------------------------------------------------------------------------
# WORLD pitch on the streaming hop; the halo models as gloo ranks on the card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
def test_streaming_world_pitch_graph_on_card():
    """StreamingConverter(world_pitch=True) at full width: the graph hop
    equals the eager hop over 10 hops (held to 1e-5, expected identical),
    the pipelined graph returns them one hop late, the F0 estimator never
    runs, and after the capture a graph hop makes no synchronising host-device
    copy or wait: process_chunk runs under set_sync_debug_mode('error')."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run this file with --noconftest -m gpu")
    from alivevc_tpu_torch.config import ContentEncoderConfig, F0EstimatorConfig
    from alivevc_tpu_torch.infer.streaming import StreamingConverter
    from alivevc_tpu_torch.kernels import LAUNCHES, reset_launches
    from alivevc_tpu_torch.models.content_encoder import ContentEncoder
    from alivevc_tpu_torch.models.f0_estimator import F0Estimator

    gen = torch.Generator().manual_seed(0)
    ce = ContentEncoder(ContentEncoderConfig(), generator=gen).cuda()
    f0m = F0Estimator(F0EstimatorConfig(), generator=gen).cuda()
    dec = Decoder(DecoderConfig(), generator=gen).cuda()
    calls = []
    f0m.input_layer.register_forward_hook(lambda *_: calls.append(1))
    tgt = torch.randn(900, 768, generator=torch.Generator(device="cuda").manual_seed(7), device="cuda")
    tt = np.arange(960 * 18) / 16000.0
    wave = (0.4 * np.sin(2 * np.pi * (150 + 40 * np.sin(2 * np.pi * tt)) * tt)).astype(np.float32)
    chunks = [wave[i * 960:(i + 1) * 960] for i in range(8, 18)]
    outs = {}
    for name, kw in (("eager", dict(cuda_graph=False)), ("graph", {}),
                     ("piped", dict(pipeline_depth=1))):
        conv = StreamingConverter(ce, f0m, dec, tgt, world_pitch=True, **kw)
        conv.prime(wave[:960 * 8])
        reset_launches()
        outs[name] = [conv.process_chunk(chunks[0])]
        if name != "eager":
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            outs[name] += [conv.process_chunk(c) for c in chunks[1:]]
        finally:
            torch.cuda.set_sync_debug_mode("default")
        outs[name] += conv.flush()
        assert LAUNCHES["stft"] == (10 if name == "eager" else 3)
        np.testing.assert_array_equal(conv.state.window[0].cpu().numpy(), conv._host_window)
    assert not calls, "the F0 estimator ran under world_pitch"
    err = max(float(np.abs(a - b).max()) for a, b in zip(outs["eager"], outs["graph"]))
    assert err <= 1e-5, err
    assert all(np.isfinite(o).all() for o in outs["graph"])
    assert np.array_equal(outs["piped"][0], np.zeros(960, np.float32))
    for a, b in zip(outs["graph"], outs["piped"][1:]):
        assert np.array_equal(a, b)


def _halo_rank(rank: int, world: int, tmp: str) -> None:
    """Rank ``rank`` of ``world`` gloo ranks on cuda:0: the three halo models
    at default widths on its half of a 200-frame input."""
    import torch.distributed as dist

    from alivevc_tpu_torch.config import ContentEncoderConfig, F0EstimatorConfig
    from alivevc_tpu_torch.models.content_encoder import ContentEncoder
    from alivevc_tpu_torch.models.f0_estimator import F0Estimator
    from alivevc_tpu_torch.parallel import (
        content_encoder_sharded,
        f0_estimator_sharded,
        feature_extractor_sharded,
        gather_time,
        init_distributed,
        make_mesh,
        shard_along,
        sharded_frame_model,
    )

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_grad_enabled(False)
    init_distributed("gloo", f"file://{tmp}/halo_rendezvous", world, rank)
    try:
        gen = torch.Generator().manual_seed(0)
        ce = ContentEncoder(ContentEncoderConfig(), generator=gen).cuda()
        f0m = F0Estimator(F0EstimatorConfig(), generator=gen).cuda()
        fe = Decoder(DecoderConfig(), generator=gen).cuda().feature_extractor
        inputs = torch.load(os.path.join(tmp, "inputs.pt"))
        mesh = make_mesh([("data", world)], "cuda")
        spec, cf = (shard_along(inputs[k].cuda(), mesh, "data") for k in ("spec", "cf"))
        out = {
            "ce": sharded_frame_model(mesh, lambda s, ax: content_encoder_sharded(ce, s, ax), spec),
            "f0": sharded_frame_model(mesh, lambda s, ax: f0_estimator_sharded(f0m, s, ax), spec),
            "fe": sharded_frame_model(
                mesh, lambda x, ax: feature_extractor_sharded(fe, x[:, :-1], x[:, -1:], ax), cf),
        }
        torch.save({k: gather_time(mesh, v).cpu() for k, v in out.items()},
                   os.path.join(tmp, f"halo_r{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
def test_halo_two_ranks_on_card(tmp_path):
    """The halo content encoder, F0 estimator and feature extractor as 2 gloo
    ranks on one card equal the dense models within 1e-4 (TF32 off)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run this file with --noconftest -m gpu")
    from alivevc_tpu_torch.config import ContentEncoderConfig, F0EstimatorConfig
    from alivevc_tpu_torch.models.content_encoder import ContentEncoder, content_encoder
    from alivevc_tpu_torch.models.decoder import feature_extractor
    from alivevc_tpu_torch.models.f0_estimator import F0Estimator, f0_estimator

    g = torch.Generator().manual_seed(3)
    spec = torch.rand(200, 641, generator=g)
    cf = torch.cat([torch.randn(200, 768, generator=g), 80 + 200 * torch.rand(200, 1, generator=g)], 1)
    torch.save({"spec": spec, "cf": cf}, tmp_path / "inputs.pt")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_halo_rank, args=(r, 2, str(tmp_path))) for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(300)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
    assert not alive and all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    got = [torch.load(tmp_path / f"halo_r{r}.pt") for r in range(2)]

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    ce = ContentEncoder(ContentEncoderConfig(), generator=gen).cuda()
    f0m = F0Estimator(F0EstimatorConfig(), generator=gen).cuda()
    fe = Decoder(DecoderConfig(), generator=gen).cuda().feature_extractor
    s, c = spec.cuda()[None], cf.cuda()[None]
    with torch.no_grad():
        dense = {"ce": content_encoder(ce, s)[0], "f0": f0_estimator(f0m, s)[0],
                 "fe": feature_extractor(fe, c[..., :-1], c[..., -1:])[0]}
    for k, want in dense.items():
        assert torch.equal(got[0][k], got[1][k]), k
        assert max_err(got[0][k], want.cpu()) <= 1e-4, k


# ---------------------------------------------------------------------------
# training: the kernels' autograd Functions, the wrappers without a
# backward, and every parameter learning through the kernels
# ---------------------------------------------------------------------------

SMALL_DEC = dict(content_channels=64, channels=32, hidden_channels=64, num_layers=2, num_harmonics=16)
SMALL_DISC = dict(periods=(2, 3), period_channels=8, period_max_channels=32, resolutions=(512,),
                  resolution_channels=8)


@pytest.mark.gpu
def test_wrappers_without_backward_refuse_grad_inputs_on_card():
    """The kNN, formant and streaming oscillator launches have no backward: a CUDA
    input that requires grad raises in grad mode (the public ``knn_topk``
    included) and runs under no_grad; the three wrappers with a Function
    return outputs with a grad_fn."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run this file with --noconftest -m gpu")
    g = torch.Generator(device="cuda").manual_seed(8)
    q = torch.randn(40, 768, generator=g, device="cuda").requires_grad_(True)
    lib = torch.randn(512, 768, generator=g, device="cuda")
    f0 = 80 + 300 * torch.rand(1, 8, 1, generator=g, device="cuda")
    amps = torch.rand(1, 8, 16, generator=g, device="cuda").requires_grad_(True)
    formants = f0 * torch.arange(1, 17, device="cuda")
    for call in (lambda: kknn.knn_topk_cuda(q, lib, 4, "highest"),
                 lambda: kknn.knn_topk(q, lib, 4, "highest"),
                 lambda: kknn.knn_topk_cuda(q.detach(), lib.requires_grad_(True), 4, "default"),
                 lambda: kosc.harmonic_source_formants_cuda(formants, amps),
                 lambda: kosc.harmonic_source_cuda(f0, amps),
                 lambda: kosc.harmonic_source_stream_cuda(f0, amps, 0.1, 3),
                 lambda: kstft.stft_magnitude_cuda(0.1 * q.reshape(1, -1))):
        with pytest.raises(RuntimeError, match="requires grad"):
            call()
        with torch.no_grad():
            call()
    lib.requires_grad_(False)
    assert kosc.harmonic_source(f0, amps).grad_fn is not None
    assert kstft.stft_magnitude(0.1 * q.reshape(1, -1)).grad_fn is not None


@pytest.mark.gpu
def test_training_functions_match_plain_autograd_on_card():
    """Each kernel Function on the card: forward within the kernel's
    tolerance of the plain version (filter 1e-3 (1 + scale), source 5e-3,
    STFT 1e-3) and every input's gradient within 1e-4 of the plain
    version's autograd (the backward recomputes it; cuDNN's weight-gradient
    sums are not deterministic); one launch each, none in the backward."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run this file with --noconftest -m gpu")
    from alivevc_tpu_torch.kernels import LAUNCHES, reset_launches

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(9)
    dec = Decoder(DecoderConfig(), generator=torch.Generator().manual_seed(0)).cuda()
    cases = []
    for level, n, l_in in ((0, 2, 30), (1, 2, 60), (3, 2, 480)):
        up, blk = dec.filter.ups[level], dec.filter.blocks[level]
        cin, _, r = up.weight.shape
        x = (0.3 * torch.randn(n, l_in, cin, generator=g, device="cuda")).requires_grad_(True)
        s = 0.3 * torch.randn(n, l_in, cin, generator=g, device="cuda")
        cond = (0.5 * torch.randn(n, l_in * r // 320 or 1, 512, generator=g, device="cuda")
                ).requires_grad_(True)
        cases.append((f"filter_level {level}", "filter_level", 1e-3,
                      lambda up=up, blk=blk, x=x, s=s, cond=cond, r=r:
                      kfilter.filter_level(x, s, rate=r, **level_args(blk, up, cond)),
                      lambda up=up, blk=blk, x=x, s=s, cond=cond, r=r:
                      kfilter.filter_level_plain(x, s, rate=r, **level_args(blk, up, cond)),
                      [x, cond, up.weight, blk.input_conv.weight, blk.blocks[2].c2.to_shift.bias]))
    f0 = (80 + 200 * torch.rand(2, 12, 1, generator=g, device="cuda")).requires_grad_(True)
    amps = torch.exp(0.3 * torch.randn(2, 12, 64, generator=g, device="cuda")).requires_grad_(True)
    cases.append(("oscillator", "oscillator", 5e-3, lambda: kosc.harmonic_source(f0, amps),
                  lambda: kosc.harmonic_source_plain(f0, amps), [f0, amps]))
    w = (0.3 * torch.randn(2, 9600, generator=g, device="cuda")).requires_grad_(True)
    cases.append(("stft", "stft", 1e-3, lambda: kstft.stft_magnitude(w),
                  lambda: kstft.stft_magnitude_plain(w), [w]))
    for name, counter, tol, run, plain, inputs in cases:
        reset_launches()
        out = run()
        assert LAUNCHES[counter] == 1, name
        want = plain()
        scale = float(want.detach().abs().max()) if counter == "filter_level" else 0.0
        assert max_err(out.detach(), want.detach()) <= tol * (1.0 + scale), name
        g_out = torch.randn(want.shape, generator=g, device="cuda")
        got_g = torch.autograd.grad(out, inputs, g_out)
        assert LAUNCHES[counter] == 1, name          # the backward launches nothing
        for a, b in zip(got_g, torch.autograd.grad(want, inputs, g_out)):
            assert max_err(a, b) <= 1e-4 * float(b.abs().max()), name


@pytest.mark.gpu
def test_every_parameter_learns_on_card():
    """One GAN step's gradients on the card (small widths, the kernels'
    Functions in the decoder): every decoder and discriminator parameter
    has a finite, nonzero gradient; the step launches the filter level 8
    times, the oscillator and the STFT twice; a fine-tuning step with a
    library launches the kNN kernel once and moves the tokens."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run this file with --noconftest -m gpu")
    from alivevc_tpu_torch.config import (ContentEncoderConfig, DiscriminatorConfig,
                                          F0EstimatorConfig, VoiceLibraryConfig)
    from alivevc_tpu_torch.kernels import LAUNCHES, reset_launches
    from alivevc_tpu_torch.models.content_encoder import ContentEncoder
    from alivevc_tpu_torch.models.discriminator import Discriminator
    from alivevc_tpu_torch.models.f0_estimator import F0Estimator
    from alivevc_tpu_torch.models.voice_library import VoiceLibrary
    from alivevc_tpu_torch.train.fine_tune import fine_tune_step, init_fine_tune
    from alivevc_tpu_torch.train.gan import gan_draws, gan_grads, init_gan

    gen = torch.Generator().manual_seed(0)
    ce = ContentEncoder(ContentEncoderConfig(internal_channels=32, hidden_channels=64,
                                             output_channels=64, num_layers=2), generator=gen)
    f0m = F0Estimator(F0EstimatorConfig(internal_channels=32, hidden_channels=64, num_layers=2),
                      generator=gen)
    with torch.no_grad():
        f0m.output_layer.bias[120] += 50.0
    ce, f0m = (m.cuda().eval().requires_grad_(False) for m in (ce, f0m))
    dec = Decoder(DecoderConfig(**SMALL_DEC), generator=gen).cuda()
    disc = Discriminator(DiscriminatorConfig(**SMALL_DISC), generator=gen).cuda()
    t = torch.arange(9600, device="cuda") / 16_000.0
    wave = torch.stack([0.4 * torch.sin(2 * np.pi * f * t) for f in (130.0, 210.0)])
    amp, jitter = gan_draws(2, gen, "cuda")
    state = init_gan(dec, disc)
    reset_launches()
    g, d, m = gan_grads(state, ce, f0m, wave, amp, jitter)
    assert {k: LAUNCHES[k] for k in ("filter_level", "oscillator", "stft")} == \
        {"filter_level": 8, "oscillator": 2, "stft": 2}
    for model, grads in ((dec, g), (disc, d)):
        for (name, _), x in zip(model.named_parameters(), grads):
            assert bool(torch.isfinite(x).all()) and bool((x != 0).any()), name
    vl = VoiceLibrary(VoiceLibraryConfig(dim=64), generator=gen).cuda()
    tokens = vl.tokens.detach().clone()
    ft = init_fine_tune(dec, disc, vl)
    reset_launches()
    fine_tune_step(ft, ce, f0m, wave, amp)
    assert LAUNCHES["knn_carried"] == 1 and not torch.equal(vl.tokens, tokens)


WAVLM_NARROW = dict(hidden_size=64, num_layers=10, num_heads=4, intermediate_size=128,
                    conv_dim=(32,) * 7, num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)


@pytest.mark.gpu
def test_wavlm_card_vs_cpu_on_card():
    """The narrow WavLM teacher on the card against the CPU, float32 without
    TF32: every hidden state and the features within 1e-4 abs (the CPU
    tests' tolerance against JAX)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run this file with --noconftest -m gpu")
    import copy

    from alivevc_tpu_torch.models.wavlm import (WavLMConfig, import_wavlm, seeded_state,
                                                wavlm_features, wavlm_hidden_states)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    m = import_wavlm(seeded_state(WavLMConfig(**WAVLM_NARROW), seed=0))
    wave = torch.from_numpy((0.1 * np.random.default_rng(1).standard_normal((2, 16_000))).astype(np.float32))
    card = copy.deepcopy(m).cuda()
    with torch.no_grad():
        for a, b in zip(wavlm_hidden_states(m, wave), wavlm_hidden_states(card, wave.cuda())):
            assert max_err(a, b.cpu()) <= 1e-4
        assert max_err(wavlm_features(m, wave), wavlm_features(card, wave.cuda()).cpu()) <= 1e-4


@pytest.mark.gpu
def test_distill_step_launches_the_stft_once_on_card():
    """One distill step on the card launches the STFT kernel once (forward
    only: the wave carries no gradient) and nothing else; its loss within
    1e-5 relative and its parameters within 1e-6 abs of the CPU's step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run this file with --noconftest -m gpu")
    import copy

    from alivevc_tpu_torch.config import ContentEncoderConfig
    from alivevc_tpu_torch.kernels import LAUNCHES, reset_launches
    from alivevc_tpu_torch.models.content_encoder import ContentEncoder
    from alivevc_tpu_torch.train.distill import distill_step, init_distill

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ce = ContentEncoder(ContentEncoderConfig(internal_channels=32, hidden_channels=64,
                                             output_channels=64, num_layers=2),
                        generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(2)
    wave = torch.from_numpy((0.3 * rng.standard_normal((2, 6400))).astype(np.float32))
    teacher = torch.from_numpy((0.1 * rng.standard_normal((2, 20, 64))).astype(np.float32))
    cpu, card = init_distill(copy.deepcopy(ce)), init_distill(copy.deepcopy(ce).cuda())
    want = distill_step(cpu, wave, teacher)["loss"]
    reset_launches()
    got = distill_step(card, wave.cuda(), teacher.cuda())["loss"]
    assert dict(LAUNCHES) == {**{k: 0 for k in LAUNCHES}, "stft": 1}
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))
    for k, v in cpu.model.state_dict().items():
        assert max_err(card.model.state_dict()[k].cpu(), v) <= 1e-6, k


@pytest.mark.gpu
def test_exported_graphs_match_the_kernel_path_on_card(tmp_path):
    """``cli/export.py``'s filter and voice_library graphs, traced on the
    card, saved and loaded, against the port's eager functions on the
    kernel path: the filter within 1e-3 (1 + max |out|) (phase 2's float32
    filter tolerance: 3xTF32 products against float32), the library match
    with identical index sets, so within 1e-6."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run this file with --noconftest -m gpu")
    from alivevc_tpu_torch.cli import export
    from alivevc_tpu_torch.config import VoiceLibraryConfig
    from alivevc_tpu_torch.kernels import LAUNCHES, reset_launches
    from alivevc_tpu_torch.models.decoder import filter_unet
    from alivevc_tpu_torch.models.voice_library import VoiceLibrary, voice_library_match

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    dec = Decoder(DecoderConfig(**SMALL_DEC), generator=gen).cuda().eval().requires_grad_(False)
    vl = VoiceLibrary(VoiceLibraryConfig(num_tokens=64, dim=64), generator=gen).cuda().requires_grad_(False)
    graphs = export.graphs(None, None, dec, vl)
    rng = np.random.default_rng(3)
    x = torch.from_numpy((0.3 * rng.standard_normal((1, 16 * 320, 1))).astype(np.float32)).cuda()
    c = torch.from_numpy((0.5 * rng.standard_normal((1, 16, 32))).astype(np.float32)).cuda()
    content = torch.from_numpy(rng.standard_normal((1, 16, 64)).astype(np.float32)).cuda()
    loaded = {}
    with torch.no_grad():
        for name, args in (("filter", (x, c)), ("voice_library", (content,))):
            path = str(tmp_path / f"{name}.pt2")
            torch.export.save(torch.export.export(graphs[name], args), path)
            loaded[name] = torch.export.load(path).module()
        reset_launches()
        want_f = filter_unet(dec.filter, x, c, dec.cfg)[..., 0]
        want_v = voice_library_match(vl, content)
        assert LAUNCHES["filter_level"] == 4 and LAUNCHES["knn_carried"] == 1
        got_f, got_v = loaded["filter"](x, c), loaded["voice_library"](content)
    assert got_f.is_cuda and max_err(got_f, want_f) <= 1e-3 * (1.0 + float(want_f.abs().max()))
    assert max_err(got_v, want_v) <= 1e-6


# chip_smoke.py's RESUME_TOL["gan"]: a run resumed through the .ckpt against
# the same run uninterrupted, the worst tensor over the parameters and both
# moments relative to its largest entry (a gradient entry whose sign the
# card's nondeterministic sums flip moves its parameter by 2 lr; at these
# widths one run read 2.3e-3)
RESUME_TOL = 3e-2


def _small_gan_run(gen):
    """The small-width frozen models, a decoder and discriminator to train,
    a batch and three steps' draws, on the card."""
    from alivevc_tpu_torch.config import (ContentEncoderConfig, DiscriminatorConfig,
                                          F0EstimatorConfig)
    from alivevc_tpu_torch.models.content_encoder import ContentEncoder
    from alivevc_tpu_torch.models.discriminator import Discriminator
    from alivevc_tpu_torch.models.f0_estimator import F0Estimator
    from alivevc_tpu_torch.train.gan import gan_draws

    ce = ContentEncoder(ContentEncoderConfig(internal_channels=32, hidden_channels=64,
                                             output_channels=64, num_layers=2), generator=gen)
    f0m = F0Estimator(F0EstimatorConfig(internal_channels=32, hidden_channels=64, num_layers=2),
                      generator=gen)
    with torch.no_grad():
        f0m.output_layer.bias[120] += 50.0
    ce, f0m = (m.cuda().eval().requires_grad_(False) for m in (ce, f0m))
    dec = Decoder(DecoderConfig(**SMALL_DEC), generator=gen).cuda()
    disc = Discriminator(DiscriminatorConfig(**SMALL_DISC), generator=gen).cuda()
    t = torch.arange(9600, device="cuda") / 16_000.0
    wave = torch.stack([0.4 * torch.sin(2 * np.pi * f * t) for f in (130.0, 210.0)])
    return ce, f0m, dec, disc, wave, [gan_draws(2, gen, "cuda") for _ in range(3)]


def _state_tensors(state) -> dict:
    out = {}
    for prefix, model, opt in (("dec", state.dec, state.opt_g), ("disc", state.disc, state.opt_d)):
        for name, p in model.named_parameters():
            out[f"{prefix}.{name}"] = p.detach()
            for key in ("exp_avg", "exp_avg_sq"):
                out[f"{prefix}.{name}:{key}"] = opt.state[p][key]
    return out


@pytest.mark.gpu
def test_gan_resume_through_a_ckpt_on_card(tmp_path):
    """A GAN run at the small widths on the card: 2 steps, the JAX layout's
    ``.ckpt``, fresh modules and optimizers from it, 1 step, against 3
    steps uninterrupted: within chip_smoke.py's gate (the worst tensor
    over the parameters and both moments, relative to its largest entry);
    the read brings back the step and the update counts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run this file with --noconftest -m gpu")
    import copy

    from alivevc_tpu_torch.compat import jax_train_state as jts
    from alivevc_tpu_torch.train.gan import gan_train_step, init_gan, update_count

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ce, f0m, dec, disc, wave, draws = _small_gan_run(torch.Generator().manual_seed(0))

    def run(state, lo, hi):
        for i in range(lo, hi):
            gan_train_step(state, ce, f0m, wave, *draws[i])
        return state

    want = _state_tensors(run(init_gan(copy.deepcopy(dec), copy.deepcopy(disc)), 0, 3))
    path = str(tmp_path / "gan.ckpt")
    jts.write(path, run(init_gan(copy.deepcopy(dec), copy.deepcopy(disc)), 0, 2))
    state = jts.read(path, "gan", "cuda")
    assert state.step == 2 and update_count(state.opt_g) == update_count(state.opt_d) == 2
    got = _state_tensors(run(state, 2, 3))
    worst = max(float((got[k] - v).abs().max() / v.abs().max().clamp_min(1e-30)) for k, v in want.items())
    assert worst <= RESUME_TOL, worst


@pytest.mark.gpu
def test_gan_resume_is_bit_equal_under_deterministic_mode_on_card(tmp_path, monkeypatch):
    """Under ``torch.use_deterministic_algorithms(True, warn_only=True)``
    (cuDNN's autotuner off, CUBLAS_WORKSPACE_CONFIG=:4096:8): no op warns,
    3 GAN steps at the small widths repeat bit for bit (A' = A), and 2
    steps, the ``.ckpt``, fresh modules and optimizers from it and 1 step
    give A's bits too (B = A), where without the mode cuDNN's weight
    gradients move A' and B by up to ~5e-3 (chip_smoke.py phase 10)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run this file with --noconftest -m gpu")
    import copy
    import warnings

    from alivevc_tpu_torch.compat import jax_train_state as jts
    from alivevc_tpu_torch.train.gan import gan_train_step, init_gan

    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    benchmark = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            ce, f0m, dec, disc, wave, draws = _small_gan_run(torch.Generator().manual_seed(2))

            def run(state, lo, hi):
                for i in range(lo, hi):
                    gan_train_step(state, ce, f0m, wave, *draws[i])
                return _state_tensors(state)

            a = run(init_gan(copy.deepcopy(dec), copy.deepcopy(disc)), 0, 3)
            again = run(init_gan(copy.deepcopy(dec), copy.deepcopy(disc)), 0, 3)
            state = init_gan(copy.deepcopy(dec), copy.deepcopy(disc))
            run(state, 0, 2)
            path = str(tmp_path / "gan.ckpt")
            jts.write(path, state)
            b = run(jts.read(path, "gan", "cuda"), 2, 3)
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.benchmark = benchmark
    warned = {str(w.message) for w in caught if "deterministic" in str(w.message)}
    assert not warned, warned
    for name, v in a.items():
        assert torch.equal(again[name], v) and torch.equal(b[name], v), name


@pytest.mark.gpu
def test_ckpt_written_on_card_reads_on_cpu_on_card(tmp_path):
    """A GAN state written on the card after a step reads back on the CPU
    with every parameter and moment bit-equal, and written again from the
    CPU gives the same file, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run this file with --noconftest -m gpu")
    from alivevc_tpu_torch.compat import jax_train_state as jts
    from alivevc_tpu_torch.train.gan import gan_train_step, init_gan

    ce, f0m, dec, disc, wave, draws = _small_gan_run(torch.Generator().manual_seed(1))
    state = init_gan(dec, disc)
    gan_train_step(state, ce, f0m, wave, *draws[0])
    card, again = str(tmp_path / "card.ckpt"), str(tmp_path / "cpu.ckpt")
    jts.write(card, state)
    cpu = jts.read(card, "gan", "cpu")
    assert cpu.step == 1 and next(cpu.dec.parameters()).device.type == "cpu"
    want = _state_tensors(state)
    for k, v in _state_tensors(cpu).items():
        assert torch.equal(v, want[k].cpu()), k
    jts.write(again, cpu)
    with np.load(card) as a, np.load(again) as b:
        assert set(a.files) == set(b.files)
        assert all(a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]) for k in a.files)


@pytest.mark.gpu
def test_offline_driver_keeps_the_file_on_the_card_on_card():
    """``OfflineConverter.convert(wave, 44_100)`` at full width in fp32 (two
    steps, the second zero-padded; 4 096 library rows, the two-pass kNN)
    equals the frozen NumPy driver (``tests/torch_port_frozen_driver.py``)
    bit for bit, or, were two runs of the frozen driver to differ, within
    their own gap.  The file crosses once each way (``CROSSINGS``), and under
    ``set_sync_debug_mode('warn')`` a call waits on the card at those two
    copies alone."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run this file with --noconftest -m gpu")
    import warnings

    from alivevc_tpu_torch.config import ContentEncoderConfig, F0EstimatorConfig
    from alivevc_tpu_torch.infer import offline
    from alivevc_tpu_torch.models.content_encoder import ContentEncoder
    from alivevc_tpu_torch.models.f0_estimator import F0Estimator
    from torch_port_frozen_driver import frozen_convert

    gen = torch.Generator().manual_seed(0)
    ce = ContentEncoder(ContentEncoderConfig(), generator=gen).cuda()
    f0m = F0Estimator(F0EstimatorConfig(), generator=gen).cuda()
    dec = Decoder(DecoderConfig(), generator=gen).cuda()
    tgt = torch.randn(4096, 768, generator=torch.Generator(device="cuda").manual_seed(3), device="cuda")
    conv = offline.OfflineConverter(ce, f0m, dec, tgt, dtype="fp32")
    sr = 44_100
    t = np.arange(50 * sr) / sr                       # 19 windows at 16 kHz: 16 + 3 of 16
    wave = (0.4 * np.sin(2 * np.pi * (150 + 40 * np.sin(2 * np.pi * 0.5 * t)) * t)).astype(np.float32)
    want = frozen_convert(conv, wave, sr)
    gap = float(np.abs(frozen_convert(conv, wave, sr) - want).max())
    offline.reset_crossings()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            got = conv.convert(wave, sr)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    waits = [str(w.message) for w in caught if "synchroniz" in str(w.message)]
    assert offline.CROSSINGS == {"to_card": 1, "to_host": 1}
    assert len(waits) == 2, waits
    assert got.shape == want.shape and np.isfinite(got).all()
    err = float(np.abs(got - want).max())
    print(f"driver against the frozen driver: max gap {err}, the frozen driver's own {gap}")
    assert err <= gap, (err, gap)


# kNN-VC's vocoder (HiFiGANConfig): each stage's channels, and its length at
# the cell's mean file (370 frames: x 10, 80, 160, 320) and at its longest (1 250)
HIFIGAN_STAGES = ((256, 3_700, 12_500), (128, 29_600, 100_000), (64, 59_200, 200_000), (32, 118_400, 400_000))
HIFIGAN_FORMS = {"plain": None, "residual": None, "stack_first": (0, 3), "stack_middle": (1, 3),
                 "stack_last": (2, 3)}
HIFIGAN_TOL = 1e-4       # of max(1, the plain output's peak)
HIFIGAN_WAVE_TOL = 1e-5  # the whole generator's waveform, of its peak


def _hifigan_conv_case(g, n, length, c, k, d, form):
    """The kernel and the plain version's conv on operands rounded to TF32
    (one pass: x and the weights), each against the plain version, over
    max(1, its peak)."""
    from alivevc_tpu_torch.kernels import hifigan as kh

    x = torch.randn(n, length, c, generator=g, device="cuda")
    bound = (k * c) ** -0.5                        # nn.Conv1d's initial range
    w = (2 * torch.rand(c, c, k, generator=g, device="cuda") - 1) * bound
    b = (2 * torch.rand(c, generator=g, device="cuda") - 1) * bound
    res = None if form == "plain" else torch.randn(n, length, c, generator=g, device="cuda")
    acc = torch.randn(n, length, c, generator=g, device="cuda")
    stack = HIFIGAN_FORMS[form]
    hi, lo = kh.split_tf32(w.permute(0, 2, 1).reshape(c, -1))
    got = kh.hifigan_conv_cuda(x, hi, lo, b, k, d, 0.1, res, acc.clone(), stack)
    want = kh.hifigan_conv_plain(x, w, b, d, 0.1, res, acc.clone(), stack)
    tf32 = kh.hifigan_conv_plain(kh.split_tf32(x)[0], kh.split_tf32(w)[0], b, d, 0.1, res, acc.clone(), stack)
    scale = max(1.0, float(want.abs().max()))
    return max_err(got, want) / scale, max_err(tf32, want) / scale


@pytest.mark.gpu
@pytest.mark.parametrize("c", [s[0] for s in HIFIGAN_STAGES])
def test_hifigan_conv_edges_on_card(c):
    """On the card: the ResBlock1 conv kernel against its plain version
    (cuDNN's float32 conv, TF32 off) at every (taps, dilation) of the
    vocoder's stage of C channels, in each epilogue form, at lengths
    shorter than the taps' halo (5), than a tile (40), not a multiple of 64
    (321, two files) and the cell's longest file.  3xTF32 against float32
    in another summation order reads ~2e-5 of the peak; one pass of TF32
    (10 mantissa bits) reads ~1e-3, and must fail the same tolerance."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run this file with --noconftest -m gpu")
    from alivevc_tpu_torch.device import float32_math

    g = torch.Generator(device="cuda").manual_seed(c)
    longest = {s[0]: s[2] for s in HIFIGAN_STAGES}[c]
    forms = list(HIFIGAN_FORMS)
    errs, i = [], 0
    with float32_math():       # the plain conv in float32 (TF32 off), as the vocoder runs
        for k in (3, 7, 11):
            for d in (1, 3, 5):
                for n, length in ((2, 5), (1, 40), (2, 321), (1, longest)):
                    for form in (forms if length < 1000 else forms[i % len(forms):][:1]):
                        errs.append((*_hifigan_conv_case(g, n, length, c, k, d, form), (k, d, n, length, form)))
                    i += 1
    worst, worst_tf32 = max(errs), max(e[1] for e in errs)
    print(f"hifigan conv C={c}: worst {worst}, one-pass TF32 worst {worst_tf32:.3e}, "
          f"least {min(e[1] for e in errs):.3e}")
    assert worst[0] <= HIFIGAN_TOL < worst_tf32


@pytest.mark.gpu
def test_hifigan_kernel_path_matches_the_plain_path_on_card(monkeypatch):
    """On the card: the whole vocoder at full width on a file of the cell's
    mean length (370 frames) launches the conv kernel 72 times (4 stages x
    3 stacks x 3 dilations x 2 convs) and runs six convolutions besides
    (conv_pre, the four transposed convs, conv_post); its waveform is the
    plain path's (each ResBlock conv through ``hifigan_conv_plain``) within
    1e-5 of its peak (the kernel path reads ~1e-6), which the plain path on
    TF32-rounded operands (~4e-4) does not meet."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run this file with --noconftest -m gpu")
    from torch.profiler import ProfilerActivity, profile

    from alivevc_tpu_torch.config import HiFiGANConfig
    from alivevc_tpu_torch.device import float32_math
    from alivevc_tpu_torch.kernels import _lib
    from alivevc_tpu_torch.kernels import hifigan as kh
    from alivevc_tpu_torch.models import hifigan as mh

    torch.manual_seed(0)
    m = mh.HiFiGAN(HiFiGANConfig()).cuda().eval()
    feats = torch.randn(1, 370, 1024, generator=torch.Generator(device="cuda").manual_seed(1), device="cuda")
    with torch.no_grad(), float32_math():
        mh.hifigan(m, feats)
        _lib.reset_launches()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            got = mh.hifigan(m, feats)
        assert _lib.LAUNCHES["hifigan_conv"] == 72
        assert sum(e.name == "aten::convolution" for e in prof.events()) == 6

        def plain(x, conv, slope, res=None, acc=None, stack=None, tf32=False):
            w = kh.split_tf32(conv.weight)[0] if tf32 else conv.weight
            x = kh.split_tf32(x)[0] if tf32 else x
            return kh.hifigan_conv_plain(x, w, conv.bias, conv.dilation[0], slope, res, acc, stack)

        monkeypatch.setattr(mh, "hifigan_conv", plain)
        want = mh.hifigan(m, feats)
        monkeypatch.setattr(mh, "hifigan_conv", lambda *a, **kw: plain(*a, **kw, tf32=True))
        tf32 = mh.hifigan(m, feats)
    peak = float(want.abs().max())
    err, err_tf32 = max_err(got, want) / peak, max_err(tf32, want) / peak
    print(f"hifigan on the card: waveform peak {peak:.3e}, kernel path {err:.3e}, one-pass TF32 {err_tf32:.3e}")
    assert got.shape == (1, 370 * 320) and err <= HIFIGAN_WAVE_TOL < err_tf32


@pytest.mark.gpu
def test_hifigan_conv_refuses_what_the_kernel_does_not_take_on_card():
    """The wrapper raises on a float64 or a non-contiguous input, and on C
    that is no multiple of 32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run this file with --noconftest -m gpu")
    from alivevc_tpu_torch.kernels import hifigan as kh

    x = torch.randn(1, 100, 64, device="cuda")
    w = torch.randn(64, 64, 3, device="cuda") / 14
    hi, lo = kh.split_tf32(w.permute(0, 2, 1).reshape(64, -1))
    b = torch.zeros(64, device="cuda")
    with pytest.raises(TypeError):
        kh.hifigan_conv_cuda(x.double(), hi, lo, b, 3, 1, 0.1)
    with pytest.raises(ValueError):
        kh.hifigan_conv_cuda(x.transpose(1, 2).contiguous().transpose(1, 2), hi, lo, b, 3, 1, 0.1)
    with pytest.raises(ValueError):
        kh.hifigan_conv_cuda(x[..., :48].contiguous(), hi[:48, :144].contiguous(), lo[:48, :144].contiguous(),
                             b[:48].contiguous(), 3, 1, 0.1)


# RVC v2 (rvc-v2-40k-fp32): the index's rows, a 41 s segment's HuBERT frames,
# and the rows of its last generator stage at C = 32 (4 300 frames x 400)
RVC_INDEX_ROWS = 89_500
RVC_QUERIES = 2_150
RVC_STAGE_ROWS = 1_720_000


@pytest.mark.gpu
def test_knn_l2_mode_on_card():
    """On the card: the L2 mode (operands as they are, the penalty -|x|^2 /
    2, k = 8, 'high') of the two-pass tile at RVC's index (768 x 89 500
    rows, a segment's 2 150 queries) against its plain version on the card
    (float32 products, TF32 off): scores within 2e-5 of the largest
    |q| |x| (3xTF32 products accumulated on the tensor cores against float32
    in another order; it read 8e-6 of it, 7.4e-3 on scores of ~400; the
    cosine mode's tests allow 1e-4 of unit rows), the sets of 8 rows equal
    wherever the plain 8th and 9th scores are farther apart than twice that,
    and those sets the 8 rows nearest by float64 L2 distance.
    A library under 4 096 rows takes the two-pass form too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run this file with --noconftest -m gpu")
    from alivevc_tpu_torch.device import float32_math
    from alivevc_tpu_torch.kernels import _lib

    g = torch.Generator(device="cuda").manual_seed(26)
    with float32_math():
        for rows, queries in ((RVC_INDEX_ROWS, RVC_QUERIES), (1_000, 300)):
            lib = torch.randn(rows, 768, generator=g, device="cuda")
            q = lib[torch.randint(0, rows, (queries,), generator=g, device="cuda")] + \
                0.7 * torch.randn(queries, 768, generator=g, device="cuda")
            pen = kknn.l2_penalty(lib)
            _lib.reset_launches()
            v, i = kknn.l2_topk(q, lib, pen)
            assert _lib.LAUNCHES["knn"] == 1 and _lib.LAUNCHES["knn_carried"] == 0
            pv, pi = kknn.knn_topk_plain(q, lib, 9, "high", penalty=pen, normalize=False)
            tol = 2e-5 * float(q.norm(dim=1).max() * lib.norm(dim=1).max())
            assert max_err(v, pv[:, :8]) <= tol
            clear = (pv[:, 7] - pv[:, 8]) > 2 * tol
            same = (torch.sort(i, 1).values == torch.sort(pi[:, :8], 1).values).all(1)
            assert bool((same | ~clear).all()), int((~same & clear).sum())
            d64 = torch.cdist(q[:64].double(), lib.double()).pow(2)
            near = torch.topk(d64, 8, largest=False).indices
            assert bool(((torch.sort(near, 1).values == torch.sort(i[:64], 1).values).all(1) | ~clear[:64]).all())
            print(f"L2 mode {queries} x {rows}: worst score gap {max_err(v, pv[:, :8]):.3e} (tol {tol:.3e}), "
                  f"{int((~clear).sum())} near-ties")


@pytest.mark.gpu
def test_hifigan_conv_at_rvc_rows_on_card():
    """On the card: the ResBlock1 conv kernel at C = 32 over the rows of a
    41 s RVC segment's last generator stage (1.72 M), every (taps,
    dilation) of the stage, against its plain version, as
    ``test_hifigan_conv_edges_on_card`` holds it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run this file with --noconftest -m gpu")
    from alivevc_tpu_torch.device import float32_math

    g = torch.Generator(device="cuda").manual_seed(32)
    forms = list(HIFIGAN_FORMS)
    errs = []
    with float32_math():
        for j, (k, d) in enumerate((k, d) for k in (3, 7, 11) for d in (1, 3, 5)):
            errs.append(_hifigan_conv_case(g, 1, RVC_STAGE_ROWS, 32, k, d, forms[j % len(forms)]))
    worst, worst_tf32 = max(e[0] for e in errs), max(e[1] for e in errs)
    print(f"hifigan conv C=32 at {RVC_STAGE_ROWS} rows: worst {worst:.3e}, one-pass TF32 worst {worst_tf32:.3e}, "
          f"least {min(e[1] for e in errs):.3e}")
    assert worst <= HIFIGAN_TOL < worst_tf32


@pytest.mark.gpu
def test_rvc_converter_full_width_on_card():
    """On the card: ``RvcConverter.convert`` of a 100 s stereo take at 44.1
    kHz (three segments: cuts near 38 and 76 s) at the published widths,
    seeded weights (the benchmark's draw) and an index of HuBERT's features
    of 300 s of another voice in 3.7 s pieces (~14 900 rows):
    three crossings up and two down, one two-pass L2 kNN call and 72 ResBlock
    conv launches a segment, the reference's cut points, and the 40 kHz
    output within the cell's log-mel L1 limit of the reference's on the same
    noise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run this file with --noconftest -m gpu")
    import json
    import sys
    from pathlib import Path

    vcbench = Path(__file__).resolve().parent.parent / "vcbench"
    if str(vcbench) not in sys.path:
        sys.path.insert(0, str(vcbench))
    import program_rvc
    import weights
    from reference import dsp
    from reference import rvc as ref
    from reference.numerics import exact_float32
    from traffic.offline_rvc import sung

    from alivevc_tpu_torch.infer import offline
    from alivevc_tpu_torch.infer.offline import RvcConverter, build_rvc_index
    from alivevc_tpu_torch.kernels import _lib

    conf = json.loads((vcbench / "configs" / "rvc-v2-40k-fp32.json").read_text())
    voice = json.loads((vcbench / "traffic" / "musdb_vocals_44k.json").read_text())["voice"]
    limits = json.loads((vcbench / "checks" / "offline-rvc40k-vocals.json").read_text())["limits"]
    m = conf["model"]
    params = weights.draw(ref.param_specs(m), torch.Generator(device="cuda").manual_seed(1), "cuda")
    model, dcfg = program_rvc.build_model(m, params)
    g = torch.Generator(device="cuda").manual_seed(2)
    target, _ = sung(g, 300 * 16_000, 16_000, voice, "cuda")
    pieces = [p.cpu().numpy() for p in target.split(59_200)]
    index = build_rvc_index(model, pieces, device="cuda")
    wave, curve = sung(g, 100 * 44_100, 44_100, voice, "cuda")
    wave = torch.stack([0.9 * wave, 0.8 * wave]).cpu().numpy()
    curve = curve.cpu().numpy()
    conv = RvcConverter(model, index, dcfg, device="cuda")
    conv.convert(wave, 44_100, f0=curve, generator=torch.Generator(device="cuda").manual_seed(3))
    offline.reset_crossings()
    _lib.reset_launches()
    got = conv.convert(wave, 44_100, f0=curve, generator=torch.Generator(device="cuda").manual_seed(3))
    torch.cuda.synchronize()
    assert offline.CROSSINGS == {"to_card": 3, "to_host": 2}
    assert _lib.LAUNCHES["knn"] == 3 and _lib.LAUNCHES["knn_merge"] == 3 and _lib.LAUNCHES["hifigan_conv"] == 216
    with torch.no_grad(), exact_float32():
        audio = ref.file_16k(wave, 44_100, "cuda")
        cuts = ref.cuts(ref.highpass(audio, m["driver"]), m["driver"])
        rows = ref.index_rows(ref.Precisions(), params, m, [torch.from_numpy(p).cuda() for p in pieces])
        want = ref.pipeline(ref.Precisions(), params, m, audio, curve, rows,
                            torch.Generator(device="cuda").manual_seed(3), "cuda", cuts)
    assert len(cuts) == 2 and [c // 160 for c in conv.last_cuts] == [c // 160 for c in cuts]
    assert got.shape == want.shape and np.isfinite(got).all()
    a, b = dsp.log_mel(torch.from_numpy(np.stack([got, want])).cuda(), sr=40_000, n_fft=2048, hop=400, n_mels=125)
    l1 = float((a - b).abs().mean())
    print(f"RVC 100 s take: {got.shape[0]} samples at 40 kHz, mel L1 {l1:.3e} (limit {limits['mel_l1']}), "
          f"ac rms {float(np.std(got)):.3f}, waveform gap {float(np.abs(got - want).max()):.3e}")
    assert l1 <= limits["mel_l1"]
