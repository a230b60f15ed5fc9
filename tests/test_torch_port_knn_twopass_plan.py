"""The two-pass kNN form's plan, prep and merge, on the CPU.

``kernels/knn.py:twopass_plan`` chooses the grid of ``csrc/knn.cu``'s tile
kernel: 128-query tiles padded to whole clusters of 1 or 2 blocks,
chunks of whole library tiles (256 rows in bf16, 128 in 3xTF32), a ring
that fits a block's shared memory.  The kernel runs only on the card
(tests/test_torch_port_gpu.py); here the plan is held to what it takes and
to the card cases that exercise it, the prep launch's plain version to the
operands and scores the kernel's arithmetic is defined by, and the merge's
plain version at the plan's chunk counts to JAX's exact merge (Pallas in
interpret mode).

Tolerances: the prepared planes' scores equal ``scores_3xtf32`` of
``prep_operands`` exactly (the same float32 products and sums), and
'highest' is within 1e-6 of float64 on unit rows (the 3xTF32 split drops
lo.lo, ~2^-22 relative per product); merges are exact (both take the top k
of one total order: score, then the smaller index).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from alivevc_tpu.kernels.knn_twopass import _merge_exact
from alivevc_tpu_torch.kernels import knn as kknn
from test_torch_port_gpu import KNN_TWOPASS_CLUSTER_SHAPES, knn_twopass_cases

SMS = kknn.H100_SMS
BENCH = (28_800, 100_352)          # the bench step: 64 windows x 450 frames
OFFLINE = (7_200, 100_352)         # chip_smoke phase 2: 16 windows
SHARD = (7_200, 524_288)           # a shard of phase 4's 1 048 575-row library
SMALLEST = (7_200, kknn.CARRIED_MAX_ROWS)   # the smallest library the route sends here
SHAPES = [BENCH, OFFLINE, SHARD, SMALLEST]


@pytest.mark.parametrize("ls,lr", SHAPES)
@pytest.mark.parametrize("precision", kknn.PRECISIONS)
def test_twopass_plan_is_legal(ls, lr, precision):
    """What the kernel takes: shared memory within a block's 227 KB, at most
    65 535 chunks of whole tiles covering the rows, query tiles padded to
    whole clusters covering the queries, the mode's tile and ring; the
    route sends the shape here."""
    for packed in ((False, True) if precision == "default" else (False,)):
        plan = kknn.knn_plan(ls, lr, precision, 4, packed=packed)
        assert plan.form == "twopass" and plan == kknn.twopass_plan(ls, lr, precision, 4, packed)
        lt, stages = kknn.twopass_tile(precision)
        assert (plan.tile_l, plan.stages) == (lt, stages)
        assert plan.smem == kknn.twopass_smem(precision, stages) <= kknn.SMEM_LIMIT
        assert plan.rows_per_chunk % lt == 0 and plan.chunks <= 65_535
        assert (plan.chunks - 1) * plan.rows_per_chunk < lr <= plan.chunks * plan.rows_per_chunk
        assert plan.cluster in kknn.TWOPASS_CLUSTERS and plan.q_tiles % plan.cluster == 0
        assert plan.q_tiles * 128 >= ls > (plan.q_tiles - plan.cluster) * 128


@pytest.mark.parametrize("ls,lr", SHAPES)
@pytest.mark.parametrize("precision", kknn.PRECISIONS)
def test_twopass_plan_fills_its_waves(ls, lr, precision):
    """Blocks at one a multiprocessor, whole clusters resident: the last
    wave is at least 90 % full at the bench step, phase 2's shape and the
    shard (the smallest library, two chunks of one wave, at least 85 %),
    and no chunk count gives fewer waves times tiles a block."""
    plan = kknn.twopass_plan(ls, lr, precision)
    resident = SMS // plan.cluster * plan.cluster
    blocks = plan.q_tiles * plan.chunks
    assert plan.waves == -(-blocks // resident)
    assert plan.fill == pytest.approx((blocks - (plan.waves - 1) * resident) / resident)
    assert plan.fill >= (0.85 if (ls, lr) == SMALLEST else 0.9)
    tiles = -(-lr // plan.tile_l)
    per = plan.rows_per_chunk // plan.tile_l
    cost = plan.waves * (per + kknn._TWOPASS_BLOCK_TILES)
    for chunks in range(1, tiles + 1):
        p = -(-tiles // chunks)
        waves = -(-plan.q_tiles * -(-tiles // p) // resident)
        assert cost <= waves * (p + kknn._TWOPASS_BLOCK_TILES)


def test_twopass_plan_tile_ignores_the_library():
    """The tile (and so a score's summation order) is the mode's alone: a
    library and each shard of it take the same tile, whatever chunks
    they plan; the cluster is 1 for one query tile and 2 for more."""
    for precision in kknn.PRECISIONS:
        tiles = {kknn.twopass_plan(7200, rows, precision).tile_l
                 for rows in (4096, 100_352, 524_288, 1_048_575, 1_048_576)}
        assert tiles == {kknn.twopass_tile(precision)[0]}
    for precision in kknn.PRECISIONS:
        assert [kknn.twopass_plan(ls, 100_352, precision).cluster for ls in (1, 128, 129, 7200)] == [1, 1, 2, 2]


def _card_plans():
    for ls, rows, k, precision, kw, d in knn_twopass_cases():
        packed = kknn.uses_packed(precision, k, None, None, kw.get("extraction", "auto"))
        yield ls, rows, k, precision, kw, d, packed, kknn.twopass_plan(ls, rows, precision, k, packed)


def test_card_cases_reach_every_branch_of_the_plan():
    """``knn_twopass_cases`` (the card tests' two-pass cases) reach every
    cluster the plan takes, every kernel instance (mode x list length), padding query
    tiles, one chunk and several, a partial last tile, rows of fewer slabs
    than the ring's stages and of more, widths padded to whole slabs, device
    valid-row counts and the penalty, so each path is held to the plain
    version on the card."""
    seen = set()
    for ls, rows, k, precision, kw, d, packed, plan in _card_plans():
        mode = 2 if packed else int(precision == "default")
        slabs = kknn.prep_width(d, precision) * (2 if precision == "default" else 4) // kknn.TWOPASS_SLAB
        seen.add(("cluster", plan.cluster))
        seen.add(("instance", mode, 4 if k <= 4 else 8))
        seen.add(("padded", plan.q_tiles * 128 - ls >= 128))
        seen.add(("chunks", plan.chunks > 1))
        seen.add(("partial", rows % plan.tile_l != 0))
        seen.add(("short rows", slabs < plan.stages))
        seen.add(("padded width", d % 64 != 0))
        seen.add(("valid_rows", "valid_rows" in kw))
        seen.add(("penalty", "penalty" in kw))
    assert {x for x in seen if x[0] == "cluster"} == {("cluster", c) for c in kknn.TWOPASS_CLUSTERS}
    assert {x for x in seen if x[0] == "instance"} == {("instance", m, kk) for m in (0, 1, 2) for kk in (4, 8)}
    for name in ("padded", "chunks", "partial", "short rows", "padded width", "valid_rows", "penalty"):
        assert {(name, True), (name, False)} <= seen, name


def test_card_clusters_test_takes_every_cluster():
    """The cluster card test runs each shape's first 128 queries alone (one
    query tile: a cluster of 1) and among all its queries (a cluster of 2,
    query tiles padded to whole clusters), over several chunks, in every
    mode and list length."""
    assert kknn.TWOPASS_CLUSTERS == (2, 1)
    for ls, rows in KNN_TWOPASS_CLUSTER_SHAPES:
        for precision in kknn.PRECISIONS:
            for k in (4, 8):
                alone, among = kknn.twopass_plan(128, rows, precision, k), kknn.twopass_plan(ls, rows, precision, k)
                assert (alone.cluster, among.cluster) == (1, 2) and among.q_tiles % 2 == 0
                assert alone.chunks > 1 and among.chunks > 1
    assert any(-(-ls // 128) % 2 for ls, _ in KNN_TWOPASS_CLUSTER_SHAPES)   # a padding tile


def test_card_cases_hold_the_edges():
    """The tile's edge cases: queries one past a tile; a
    library one row past a tile and one past a chunk; a device count inside
    the first tile and at a chunk's end; k = 1, 5, 8; d = 100; a penalty;
    packed at 130 rows; in every mode."""
    for precision in kknn.PRECISIONS:
        mine = [c for c in _card_plans() if c[3] == precision]
        assert any(ls == 129 for ls, *_ in mine)
        assert any(rows == plan.tile_l + 1 for _, rows, *_, plan in mine)
        assert any(plan.chunks > 1 and rows % plan.rows_per_chunk == 1 for _, rows, *_, plan in mine)
        counts = [(int(kw["valid_rows"].split(":")[1]), plan) for _, _, _, _, kw, _, _, plan in mine
                  if "valid_rows" in kw]
        assert any(n < plan.tile_l for n, plan in counts)
        assert any(n % plan.rows_per_chunk == 0 for n, plan in counts)
        assert {k for _, _, k, *_ in mine} >= {1, 5, 8}
        assert any(d == 100 for *_, d, _, _ in mine) and any("penalty" in kw for *_, kw, _, _, _ in mine)
    assert any(rows == 130 and packed for _, rows, *_, packed, _ in _card_plans())


@pytest.mark.parametrize("precision", kknn.PRECISIONS)
def test_prep_plain_scores_as_the_kernel_defines_them(precision):
    """The prep's plain version: bf16 planes equal ``prep_operands``'s bf16
    operands padded with zero columns; TF32 planes give exactly
    ``scores_3xtf32`` of ``prep_operands``'s float32 operands (hi + lo is the
    normalised row to 2^-22), and 'highest' scores within 1e-6 of float64
    with the float64 ranking wherever its 4th and 5th scores are 1e-5
    apart.  Padded columns are zeros."""
    rng = np.random.default_rng(7)
    src = torch.from_numpy(rng.standard_normal((64, 768)).astype(np.float32))
    lib = torch.from_numpy(rng.standard_normal((3000, 768)).astype(np.float32))
    q, lb = kknn.knn_prep_plain(src, lib, precision)
    s_op, l_op = kknn.prep_operands(src, lib, precision)
    if precision == "default":
        assert q.dtype == torch.bfloat16 and torch.equal(q, s_op) and torch.equal(lb, l_op)
        return
    assert q.shape == (2, 64, 768) and lb.shape == (2, 3000, 768)
    assert torch.equal(kknn.tf32_round(q[0]), q[0]) and torch.equal(kknn.tf32_round(q[1]), q[1])
    assert float((q[0] + q[1] - s_op).abs().max()) <= 2.0 ** -22
    scores = kknn.scores_from_planes(q, lb)
    assert torch.equal(scores, kknn.scores_3xtf32(s_op, l_op))
    exact = s_op.double() @ l_op.double().t()
    assert float((scores.double() - exact).abs().max()) <= 1e-6
    top, order = torch.sort(exact, dim=1, descending=True)
    clear = (top[:, 3] - top[:, 4]) > 1e-5
    got = torch.sort(torch.topk(scores, 4, dim=1).indices, 1).values
    assert bool((got == torch.sort(order[:, :4], 1).values).all(1)[clear].all())
    narrow_q, narrow_l = kknn.knn_prep_plain(src[:, :100], lib[:, :100], precision)
    assert narrow_q.shape[-1] == kknn.prep_width(100, precision) == 128
    assert not bool(narrow_q[..., 100:].any()) and not bool(narrow_l[..., 100:].any())


@pytest.mark.parametrize("ls,lr,precision", [(24, 887, "high"), (300, 5003, "default"),
                                             (600, 20_000, "highest"), (129, 9000, "default")])
def test_merge_plain_matches_jax_merge_at_plan_chunks(ls, lr, precision):
    """``merge_plain`` (what ``knn_merge_kernel`` is held to) over each
    chunk's top 8 as the plan cuts the library, against JAX's exact merge
    (``knn_twopass.py:_merge_exact``, Pallas in interpret mode) on the same
    candidates: values and indices equal, scores rounded to 1/64 for many
    ties; and both the top 8 of the whole score matrix."""
    plan = kknn.twopass_plan(ls, lr, precision, 8)
    assert plan.chunks > 1
    rng = np.random.default_rng(lr)
    sims = torch.round(torch.from_numpy(rng.standard_normal((ls, lr)).astype(np.float32)) * 64) / 64
    cand_v, cand_i = [], []
    for c0 in range(0, lr, plan.rows_per_chunk):
        v, i = kknn.topk_exact(sims[:, c0:c0 + plan.rows_per_chunk], 8)
        cand_v.append(v)
        cand_i.append(i + c0)
    cv, ci = torch.stack(cand_v, 1), torch.stack(cand_i, 1)
    got_v, got_i = kknn.merge_plain(cv, ci, 8)
    lsp = -(-ls // 8) * 8
    flat_v = np.full((lsp, plan.chunks * 8), -np.inf, np.float32)
    flat_i = np.zeros((lsp, plan.chunks * 8), np.int32)
    flat_v[:ls] = cv.reshape(ls, -1).numpy()
    flat_i[:ls] = ci.reshape(ls, -1).numpy()
    with pltpu.force_tpu_interpret_mode():
        jv, ji = _merge_exact(jnp.asarray(flat_v), jnp.asarray(flat_i), 8, lsp // 8, 8)
    assert np.array_equal(np.asarray(jv)[:ls], got_v.numpy())
    assert np.array_equal(np.asarray(ji)[:ls], got_i.numpy())
    want_v, want_i = kknn.topk_exact(sims, 8)
    assert torch.equal(got_v, want_v) and torch.equal(got_i.long(), want_i)
