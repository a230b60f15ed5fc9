"""The port's library-sharded retrieval and distributed conversion
(``alivevc_tpu_torch/parallel/``) against the JAX package's, on the CPU.

The port runs as 4 spawned gloo ranks (``tests/torch_port_ranks.py``, which
imports no JAX) behind a file rendezvous in the test's own temporary
directory; the JAX oracles run in this process on 4 of the 8 virtual CPU
devices (tests/conftest.py), under ``jax.jit`` (called eagerly, the
shard_map'd conversion takes over a minute a call), while the ranks work.
One rank group runs every check, and each join has a timeout.

Tolerances, with their reasons:
  * sharded kNN, 'high'/'highest': index sets identical to the port's dense
    top-k and to a float64 top-k wherever its k-th and (k+1)-th scores are
    more than 1e-6 apart; matched features within 1e-5 of JAX
    ``sharded_match_features(impl='xla')`` (float32 sums of k rows, split
    over the shards, in another order);
  * sharded kNN, 'default': the bf16 licence (tests/test_bf16_license.py):
    flip rate <= 4 % against the float64 top-k, every neighbour within 2e-3
    of the exact k-th best;
  * ``convert_windows_distributed`` on 2 x 2: 5e-3 abs against JAX's on a
    2 x 2 mesh (PARITY.md's decoder tolerance).
"""

import multiprocessing
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from alivevc_tpu.parallel.distributed_vc import convert_windows_distributed as jax_cwd
from alivevc_tpu.parallel.mesh import make_mesh as jax_make_mesh
from alivevc_tpu.parallel.sharded_knn import pad_library_for_sharding as jax_pad
from alivevc_tpu.parallel.sharded_knn import sharded_match_features as jax_smf
from alivevc_tpu_torch.kernels.knn import knn_topk

import torch_port_ranks
from test_torch_port_util import CE_KW, DEC_KW, F0_KW, jax_models, port_models

WORLD = 4
JOIN_S = 120
VC_KW = dict(pitch_shift=2.0, intonation=1.1, alpha=0.1)


def _knn_cases():
    rng = np.random.default_rng(0)
    pad = (rng.standard_normal((200, 768)).astype(np.float32),
           rng.standard_normal((999, 768)).astype(np.float32))       # pads to 1000
    few = (rng.standard_normal((7, 768)).astype(np.float32),
           rng.standard_normal((13, 768)).astype(np.float32))        # last shard: 1 valid row < k
    base = rng.standard_normal((997, 768)).astype(np.float32)
    base[500] = base[0]                                              # same row in shards 0 and 2
    dup = (np.concatenate([base[:1], rng.standard_normal((4, 768)).astype(np.float32)]), base)
    return {"pad999": pad, "few13": few, "dup997": dup}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("ranks"))
    params, cfgs = jax_models(0)
    ce, f0m, dec = port_models(params)
    rng = np.random.default_rng(5)
    tt = np.arange(9600) / 16000.0
    windows = np.stack([0.4 * np.sin(2 * np.pi * f * tt) + 0.02 * rng.standard_normal(9600)
                        for f in (130.0, 210.0)]).astype(np.float32)
    library = rng.standard_normal((999, DEC_KW["content_channels"])).astype(np.float32)
    cases = _knn_cases()
    torch.save({"ce_kw": CE_KW, "f0_kw": F0_KW, "dec_kw": DEC_KW, "ce": ce.state_dict(),
                "f0": f0m.state_dict(), "dec": dec.state_dict(), "knn_cases": cases,
                "windows": windows, "library": library, "vc_kw": VC_KW},
               os.path.join(tmp, "inputs.pt"))
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=torch_port_ranks.run_rank, args=(r, WORLD, tmp))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        # the JAX oracles, while the ranks work
        mesh4 = jax_make_mesh([("library", WORLD)], devices=jax.devices()[:WORLD])
        smf = jax.jit(jax_smf, static_argnums=0, static_argnames=("k", "impl"))
        want_knn = {}
        for name, (src, lib) in cases.items():
            lib_p, valid = jax_pad(jnp.asarray(lib), WORLD)
            want_knn[name] = np.asarray(smf(mesh4, jnp.asarray(src), lib_p, valid, k=4,
                                            impl="xla"))
        mesh22 = jax_make_mesh([("data", 2), ("library", 2)], devices=jax.devices()[:WORLD])
        cwd = jax.jit(jax_cwd, static_argnums=0, static_argnames=("dec_cfg", "impl"))
        want_vc = np.asarray(cwd(mesh22, *params, jnp.asarray(windows), jnp.asarray(library),
                                 dec_cfg=cfgs[2], impl="xla", **VC_KW))
    finally:
        for p in procs:
            p.join(JOIN_S)
        alive = [p.pid for p in procs if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    assert not alive, f"ranks {alive} did not finish within {JOIN_S} s"
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    got = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False) for r in range(WORLD)]
    return cases, want_knn, want_vc, got


def _exact_f64(src, lib, k=4):
    s = src / np.linalg.norm(src, axis=1, keepdims=True)
    lb = lib / np.linalg.norm(lib, axis=1, keepdims=True)
    sims = s.astype(np.float64) @ lb.astype(np.float64).T
    order = np.argsort(-sims, axis=1, kind="stable")
    return sims, order[:, :k], np.take_along_axis(sims, order[:, :k + 1], axis=1)


@pytest.mark.parametrize("precision", ["highest", "high", "default"])
@pytest.mark.parametrize("case", ["pad999", "few13", "dup997"])
def test_sharded_knn_vs_jax_and_dense(runs, case, precision):
    cases, want_knn, _, got = runs
    src, lib = cases[case]
    matched, idx = got[0][(case, precision)]
    for r in range(1, WORLD):       # every rank holds the same result
        np.testing.assert_array_equal(got[r][(case, precision)][0], matched)
        np.testing.assert_array_equal(got[r][(case, precision)][1], idx)
    assert idx.max() < lib.shape[0]
    sims, exact_i, top = _exact_f64(src, lib)
    if precision == "default":
        flips = np.any(np.sort(idx, 1) != np.sort(exact_i, 1), axis=1)
        assert flips.mean() <= 0.04
        assert np.all(np.take_along_axis(sims, idx, axis=1) >= top[:, 3:4] - 2e-3)
        return
    _, dense_i = knn_topk(torch.from_numpy(src), torch.from_numpy(lib), 4, precision)
    np.testing.assert_array_equal(np.sort(idx, 1), np.sort(dense_i.numpy(), 1))
    clear = (top[:, 3] - top[:, 4]) > 1e-6
    assert np.all(np.sort(idx, 1)[clear] == np.sort(exact_i, 1)[clear])
    np.testing.assert_allclose(matched, want_knn[case], rtol=0, atol=1e-5)
    np.testing.assert_allclose(matched, lib[idx].mean(1), rtol=0, atol=1e-5)


def test_convert_windows_distributed_vs_jax(runs):
    _, _, want_vc, got = runs
    vc = got[0]["vc"]
    assert vc.shape == want_vc.shape and np.isfinite(vc).all()
    for r in range(1, WORLD):
        np.testing.assert_array_equal(got[r]["vc"], vc)
    assert np.abs(vc - want_vc).max() <= 5e-3


def test_mesh_helpers(runs):
    """replicate broadcasts rank 0's parameters; shard_along gives each
    rank its slice of the 'data' axis (ranks 0, 1 hold data 0; 2, 3 data 1)."""
    *_, got = runs
    assert all(g["replicated"] == 0.0 for g in got)
    assert [g["data_shard"] for g in got] == [[0, 1, 2, 3]] * 2 + [[4, 5, 6, 7]] * 2


def test_entry_points_need_cuda_unless_cpu_is_named():
    """Without CUDA and without device='cpu', the distributed entry point
    raises before it touches the mesh."""
    from alivevc_tpu_torch.parallel import convert_windows_distributed

    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the call would run on the card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        convert_windows_distributed(None, None, None, None, np.zeros((2, 9600), np.float32),
                                    np.zeros((8, 64), np.float32))
