"""The port's time-axis halo sharding (``alivevc_tpu_torch/parallel/halo.py``)
against the dense port models and the JAX package's ``sharded_frame_model``
on the CPU mesh.

The port runs as 2 and as 3 spawned gloo ranks (``tests/torch_port_ranks.py``,
which imports no JAX) behind file rendezvous in the test's own temporary
directory, each rank holding its slice of a 60-frame utterance; the JAX
oracles run in this process on 2 and 3 of the 8 virtual CPU devices while the
ranks work.  Tolerance 2e-5 abs (tests/test_parallel.py's halo tolerance): the
sharded models compute the dense ones' values, rounded over other row counts.
"""

import multiprocessing
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from alivevc_tpu.parallel import halo as jhalo
from alivevc_tpu.parallel.mesh import make_mesh as jax_make_mesh
from alivevc_tpu_torch.models.content_encoder import content_encoder
from alivevc_tpu_torch.models.decoder import feature_extractor
from alivevc_tpu_torch.models.f0_estimator import f0_estimator
from alivevc_tpu_torch.parallel import halo_pad
from alivevc_tpu_torch.parallel.halo import TimeAxis

import torch_port_ranks
from test_torch_port_util import CE_KW, DEC_KW, F0_KW, jax_models, port_models

WORLDS = (2, 3)
FRAMES = 60
JOIN_S = 120
TOL = 2e-5


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("halo"))
    params, _ = jax_models(0)
    ce, f0m, dec = port_models(params)
    rng = np.random.default_rng(7)
    spec = np.abs(rng.standard_normal((FRAMES, 641))).astype(np.float32)
    content = rng.standard_normal((FRAMES, DEC_KW["content_channels"])).astype(np.float32)
    f0 = (80.0 + 220.0 * rng.random((FRAMES, 1))).astype(np.float32)
    torch.save({"ce_kw": CE_KW, "f0_kw": F0_KW, "dec_kw": DEC_KW, "ce": ce.state_dict(),
                "f0": f0m.state_dict(), "dec": dec.state_dict(), "spec": spec,
                "content": content, "f0_hz": f0}, os.path.join(tmp, "halo_inputs.pt"))
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=torch_port_ranks.run_halo_rank, args=(r, w, tmp))
             for w in WORLDS for r in range(w)]
    for p in procs:
        p.start()
    try:
        # the JAX oracles and the dense port models, while the ranks work
        fe_p = params[2]["feature_extractor"]
        fns = {
            "ce": lambda x, ax: jhalo.content_encoder_sharded(params[0], x, ax),
            "f0": lambda x, ax: jhalo.f0_estimator_sharded(params[1], x, ax),
            "fe": lambda x, ax: jhalo.feature_extractor_sharded(fe_p, x[:, :-1], x[:, -1:], ax),
        }
        inputs = {"ce": spec, "f0": spec, "fe": np.concatenate([content, f0], axis=1)}
        want_jax = {}
        for w in WORLDS:
            mesh = jax_make_mesh([("data", w)], devices=jax.devices()[:w])
            for name, fn in fns.items():
                run = jax.jit(lambda x, fn=fn, mesh=mesh: jhalo.sharded_frame_model(mesh, fn, x, "data"))
                want_jax[(w, name)] = np.asarray(run(jnp.asarray(inputs[name])))
        t = torch.from_numpy
        dense = {
            "ce": content_encoder(ce, t(spec)[None])[0].numpy(),
            "f0": f0_estimator(f0m, t(spec)[None])[0].numpy(),
            "fe": feature_extractor(dec.feature_extractor, t(content)[None], t(f0)[None])[0].numpy(),
        }
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
    got = {w: [torch.load(os.path.join(tmp, f"halo{w}_rank{r}.pt"), weights_only=False)
               for r in range(w)] for w in WORLDS}
    return got, dense, want_jax


@pytest.mark.parametrize("model", ["ce", "f0", "fe"])
@pytest.mark.parametrize("world", WORLDS)
def test_halo_model_equals_dense_and_jax(runs, world, model):
    got, dense, want_jax = runs
    full = got[world][0][model]
    for r in range(1, world):        # every rank gathers the same whole
        np.testing.assert_array_equal(got[world][r][model], full)
    assert full.shape == dense[model].shape
    assert np.abs(full - dense[model]).max() <= TOL
    assert np.abs(full - want_jax[(world, model)]).max() <= TOL


@pytest.mark.parametrize("world", WORLDS)
def test_halo_pad_takes_the_neighbours_edges(runs, world):
    """Each rank's [4, 2] slice (its rank x 100 + 0..7) padded by 3 frames:
    the left neighbour's last 3 rows, then the right neighbour's first 3,
    zeros past the global edges."""
    got, _, _ = runs
    ramp = np.arange(8, dtype=np.float32).reshape(4, 2)
    for r in range(world):
        left = ramp[-3:] + 100 * (r - 1) if r > 0 else np.zeros((3, 2), np.float32)
        right = ramp[:3] + 100 * (r + 1) if r < world - 1 else np.zeros((3, 2), np.float32)
        want = np.concatenate([left, ramp + 100 * r, right])
        np.testing.assert_array_equal(got[world][r]["halo_pad"], want)


def test_halo_pad_refuses_a_slice_shorter_than_the_halo():
    with pytest.raises(ValueError, match="shorter than the halo"):
        halo_pad(torch.zeros(2, 4), 3, TimeAxis(None, 0, 2))
    x = torch.ones(2, 4)
    assert halo_pad(x, 0, TimeAxis(None, 0, 2)) is x
