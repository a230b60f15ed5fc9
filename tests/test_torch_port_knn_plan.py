"""The kNN forms' routing and the carried form's launch plan, on the CPU.

``kernels/knn.py:knn_plan`` sends libraries under 4 096 rows to the carried
form (``csrc/knn_carried.cu``, JAX's route at ``knn_pallas.py:244-259``)
and larger ones to the two-pass form (``csrc/knn.cu``), and chooses the
carried form's tile: ``nq`` queries (the wgmma's N) and ``wg`` warpgroups
of 64 library rows a block, its ring depth and shared memory, its scratch.
The kernels run only on the card (tests/test_torch_port_gpu.py); here the
plan is held to what they take, and the carried form's merge (each block's
top k, then the top k of the blocks' lists) to the top k of the whole
score matrix, exactly (both are the top k of one total order: score, then
the smaller index).
"""

import pytest
import torch

from alivevc_tpu_torch.kernels import knn as kknn
from test_torch_port_gpu import (
    KNN_CARRIED_NARROW,
    KNN_CARRIED_QUERIES,
    KNN_CARRIED_ROWS,
    knn_carried_variants,
)

SMS = kknn.H100_SMS
# the carried kernel's shapes on the paths: the streaming hop, a
# fine-tuning step, offline with a 512-token voice library
ROW7_SHAPES = [(24, 887, "high", {}), (24, 887, "default", {}), (960, 512, "highest", {}),
               (7200, 512, "default", {}), (7200, 512, "high", {}),
               (7200, 512, "highest", {"valid_rows": 509}), (7200, 512, "default", {"packed": True})]


@pytest.mark.parametrize("ls,lr,precision,kw", ROW7_SHAPES)
def test_plan_sends_small_libraries_to_the_carried_form(ls, lr, precision, kw):
    """Each of the carried kernel's shapes takes the carried form, and with
    it one launch a query tile's worth of library blocks at most two waves
    deep; the bench's 100 352 rows take the two-pass form."""
    plan = kknn.knn_plan(ls, lr, precision, **kw)
    assert plan.form == "carried"
    assert plan.q_tiles * plan.lib_blocks <= 2 * SMS * max(1, kknn.SMEM_PER_SM // (plan.smem + 1024))
    big = kknn.knn_plan(ls, 100_352, precision, **kw)
    ranked = min(100_352, kw.get("valid_rows", 100_352))
    assert big.form == "twopass" and (big.rows_per_chunk, big.chunks) == kknn.chunking(ls, ranked, precision)


def test_plan_routes_by_the_whole_library():
    """The bound is JAX's (4 095 rows carried, 4 096 two-pass); a shard
    takes the form of the whole library (``route_rows``), as the sharded
    path passes it; ``form`` forces either form at a shape both take."""
    assert kknn.knn_plan(64, 4095).form == "carried" and kknn.knn_plan(64, 4096).form == "twopass"
    assert kknn.knn_plan(7200, 524_288, "highest", route_rows=1_048_576).form == "twopass"
    assert kknn.knn_plan(64, 2001, "highest", route_rows=4002).form == "carried"
    assert kknn.knn_plan(64, 2048, "highest", route_rows=4096).form == "twopass"
    assert kknn.knn_plan(24, 887, "high", form="twopass").form == "twopass"
    assert kknn.knn_plan(24, 8192, "high", form="carried").form == "carried"
    assert kknn.knn_form(887) == "carried" and kknn.knn_form(887, route_rows=5000) == "twopass"
    with pytest.raises(ValueError):
        kknn.knn_plan(24, 887, form="tiled")


def test_plan_at_the_hop_fills_n_with_its_queries():
    """The hop's 24 queries take one 24-wide query tile (no zero-filled query
    slot), and its 887 rows 14 library blocks of one warpgroup."""
    plan = kknn.knn_plan(24, 887, "high")
    assert (plan.nq, plan.wg, plan.q_tiles, plan.lib_blocks) == (24, 1, 1, 14)


def _cases():
    for ls in KNN_CARRIED_QUERIES:
        for spec in KNN_CARRIED_ROWS:
            for k, precision, rows, kw in knn_carried_variants(spec):
                vr = kw.get("valid_rows")
                packed = kw.get("extraction") == "packed"
                yield ls, rows, k, precision, (vr if isinstance(vr, int) else None), packed


def test_plan_grid_covers_every_row_once():
    """Query tiles cover the queries and library blocks the ranked rows,
    each exactly once: no tile or block lies wholly past them (a host
    valid-row count stops the grid, as in the two-pass form)."""
    for ls, rows, k, precision, vr, packed in _cases():
        plan = kknn.knn_plan(ls, rows, precision, k, valid_rows=vr, packed=packed)
        ranked = rows if vr is None else min(rows, vr)
        block = 64 * plan.wg
        assert (plan.q_tiles - 1) * plan.nq < ls <= plan.q_tiles * plan.nq
        assert (plan.lib_blocks - 1) * block < ranked <= plan.lib_blocks * block
        blocks = [range(b * block, min(ranked, (b + 1) * block)) for b in range(plan.lib_blocks)]
        assert sorted(r for b in blocks for r in b) == list(range(ranked))


@pytest.mark.parametrize("d", [768, KNN_CARRIED_NARROW])
def test_split_depends_on_the_queries_and_width_alone(d):
    """The depth split (its partial sums add in rank order, so it decides a
    score's bits) is the same for a library and for every shard of it: 4
    blocks (at most the slabs a row has) while the queries fit one tile,
    else 1."""
    for mode, precision in ((0, "high"), (1, "default")):
        slabs = -(-d // (32 if mode == 0 else 64))
        for ls in (1, 24, 128, 129, 960, 7200):
            splits = {kknn.knn_plan(ls, rows, precision, d=d).split
                      for rows in (4, 127, 500, 887, 2001, 4002 // 2, 4095)}
            want = 1 if ls > 128 else (4 if slabs >= 4 else 2 if slabs >= 2 else 1)
            assert splits == {want}, (d, precision, ls, splits)


def test_plan_sizes_are_legal():
    """What the kernel takes: a query width in CARRIED_NQ (a wgmma N and a
    TMA box of at most 256 rows), 1 or 2 warpgroups (at most 256 threads,
    the launch bound), 2-4 ring stages (one refills while another is read),
    shared memory within a block's 227 KB (less 1 KB) that holds the ring
    and the score rows, at most 65 535 library
    blocks (gridDim.y), and a scratch of the operands (TF32 hi and lo
    planes, or bf16; columns padded to 128-byte slabs) plus, with several
    library blocks, their lists and the counters."""
    for ls, rows, k, precision, vr, packed in _cases():
        plan = kknn.knn_plan(ls, rows, precision, k, valid_rows=vr, packed=packed)
        mode = 2 if packed else int(precision == "default")
        assert plan.nq in kknn.CARRIED_NQ and plan.nq <= 256 and 64 * plan.wg <= 256
        assert plan.wg in kknn.CARRIED_WG and 2 <= plan.stages <= kknn.CARRIED_MAX_STAGES
        planes = 2 if mode == 0 else 1
        ring = plan.stages * planes * (64 * plan.wg + plan.nq) * 128
        assert plan.smem == kknn.carried_smem(plan.nq, plan.wg, plan.stages, mode) <= kknn.SMEM_LIMIT
        assert plan.smem - 2048 >= max(ring, plan.nq * (64 * plan.wg + 4) * 4)
        assert plan.lib_blocks <= 65_535 and plan.split in kknn.CARRIED_SPLITS
        assert plan.split <= 24 // (1 if mode == 0 else 2)      # at most the slabs of a 768-wide row
        dp, esize = (768, 4) if mode == 0 else (768, 2)
        operands = planes * (ls + rows) * dp * esize
        lists = 2 * ls * plan.lib_blocks * (4 if k <= 4 else 8) * 4 if plan.lib_blocks > 1 else 0
        assert operands + lists <= plan.scratch <= operands + lists + 5 * 1024


def test_card_cases_reach_every_route():
    """The card tests' carried cases (KNN_CARRIED_QUERIES x KNN_CARRIED_ROWS
    x ``knn_carried_variants``, and the narrow width) reach every query
    width, both block widths, every depth split (the cluster's reduction),
    one and several library blocks (the block's own answer and the last
    block's merge), every mode, both list lengths and both exclusions, so
    that each kernel instance they run is held to the plain version."""
    seen = set()
    narrow = [(ls, 887, 4, p, None, False, KNN_CARRIED_NARROW) for ls in KNN_CARRIED_QUERIES
              for p in kknn.PRECISIONS]
    for ls, rows, k, precision, vr, packed, d in [(*c, 768) for c in _cases()] + narrow:
        plan = kknn.knn_plan(ls, rows, precision, k, valid_rows=vr, packed=packed, d=d)
        mode = 2 if packed else int(precision == "default")
        seen.add(("nq", plan.nq))
        seen.add(("wg", plan.wg))
        seen.add(("split", plan.split))
        seen.add(("merge", plan.lib_blocks > 1))
        seen.add(("instance", mode, 4 if k <= 4 else 8, plan.lib_blocks > 1))
    assert {x for x in seen if x[0] == "nq"} == {("nq", n) for n in kknn.CARRIED_NQ}
    assert {x for x in seen if x[0] == "wg"} == {("wg", w) for w in kknn.CARRIED_WG}
    assert {x for x in seen if x[0] == "split"} == {("split", s) for s in kknn.CARRIED_SPLITS}
    assert {x for x in seen if x[0] == "merge"} == {("merge", False), ("merge", True)}
    assert {x for x in seen if x[0] == "instance"} >= {("instance", m, kk, many) for m in (0, 1, 2)
                                                       for kk in (4,) for many in (False, True)}
    assert ("instance", 0, 8, True) in seen and ("instance", 1, 8, False) in seen
    variants = [kw for spec in KNN_CARRIED_ROWS for *_, kw in knn_carried_variants(spec)]
    assert any(isinstance(kw.get("valid_rows"), int) for kw in variants)
    assert any(isinstance(kw.get("valid_rows"), str) for kw in variants)
    assert any("penalty" in kw for kw in variants)


@pytest.mark.parametrize("ls,lr,precision", [(24, 887, "high"), (960, 512, "highest"),
                                             (65, 4095, "default")])
def test_carried_merge_is_the_top_k_of_the_blocks(ls, lr, precision):
    """The carried form's answer, replayed on scores rounded to 1/64 (many
    ties): each library block of the plan takes its top 8 (ties to the
    smaller index), the last block the top 8 of all the blocks' lists; the
    values and indices equal the top 8 of the whole score matrix."""
    plan = kknn.knn_plan(ls, lr, precision, 8)
    g = torch.Generator().manual_seed(lr)
    sims = torch.round(torch.randn(ls, lr, generator=g) * 64) / 64
    block = 64 * plan.wg
    cand_v, cand_i = [], []
    for b in range(plan.lib_blocks):
        v, i = kknn.topk_exact(sims[:, b * block:(b + 1) * block], 8)
        cand_v.append(v)
        cand_i.append(i + b * block)
    got_v, got_i = kknn.merge_plain(torch.stack(cand_v, 1), torch.stack(cand_i, 1), 8)
    want_v, want_i = kknn.topk_exact(sims, 8)
    assert torch.equal(got_v, want_v) and torch.equal(got_i, want_i)
