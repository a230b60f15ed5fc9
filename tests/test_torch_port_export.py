"""The port's export CLI (``alivevc_tpu_torch/cli/export.py``) and its
reference importer (``compat/torch_import.py``) on the CPU.

JAX models at small widths are written as reference ``.pt`` state dicts by
the JAX package (``compat/torch_export.py``), exported by the port's CLI at
``--length 16`` and loaded back with ``torch.export.load``.  Each graph is
held to the JAX eager function on the same inputs, with the tolerances of
tests/test_torch_port_models.py (1e-4; the filter U-Net 5e-3, PARITY.md's
filter tolerance; f0 bins identical wherever the top two logits are more
than 1e-4 apart; the library match's index sets identical, so 1e-6), and
to the port's eager function (on the CPU its kernel wrappers run their
plain versions) within 1e-6.  ``--torch-out`` files are bit-equal to the
JAX package's exports.  Tracing must leave the port's device-tensor caches
(``ops/interp.py``) holding real tensors: after an export, an eager call
returns a plain ``torch.Tensor`` equal to the one before.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from alivevc_tpu.compat import torch_export
from alivevc_tpu.config import VoiceLibraryConfig as JVoiceLibraryConfig
from alivevc_tpu.models.voice_library import init_voice_library, voice_library_match
from alivevc_tpu.nn.layers import linear as jlinear
from alivevc_tpu.ops.interp import linear_interpolate as jinterp
from alivevc_tpu_torch.cli import export
from alivevc_tpu_torch.compat import torch_import
from alivevc_tpu_torch.config import DiscriminatorConfig
from alivevc_tpu_torch.models import content_encoder as tce
from alivevc_tpu_torch.models import decoder as tdec
from alivevc_tpu_torch.models import f0_estimator as tf0
from alivevc_tpu_torch.models.discriminator import Discriminator
from alivevc_tpu_torch.models.voice_library import voice_library_match as tmatch
from alivevc_tpu_torch.ops import interp

from test_torch_port_util import DISC_KW, jax_models, max_err, n, t

# the JAX package's models/__init__.py re-exports functions of these names
jce = importlib.import_module("alivevc_tpu.models.content_encoder")
jdec = importlib.import_module("alivevc_tpu.models.decoder")
jf0 = importlib.import_module("alivevc_tpu.models.f0_estimator")
T = 16
KINDS = ("content_encoder", "f0_estimator", "decoder", "voice_library")


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    d = tmp_path_factory.mktemp("export")
    params, cfgs = jax_models(0)
    lib = init_voice_library(jax.random.PRNGKey(6), JVoiceLibraryConfig(num_tokens=32, dim=64))
    sds = dict(zip(KINDS, (torch_export.export_content_encoder(params[0]),
                           torch_export.export_f0_estimator(params[1]),
                           torch_export.export_decoder(params[2], cfgs[2]),
                           torch_export.export_voice_library(lib))))
    for kind, sd in sds.items():
        torch_export.save_torch_state_dict(str(d / f"{kind}.pt"), sd)
    # the cache fault: an eager upsample before, the cache emptied, then the export
    x, c = _filter_inputs()
    dec = torch_import.load_params_or_init(str(d / "decoder.pt"), "decoder", torch.device("cpu"))
    before = tdec.filter_unet(dec.filter, t(x), t(c), dec.cfg)
    interp._WEIGHTS.clear()
    paths = export.main(["-o", str(d / "graphs"), "-cep", str(d / "content_encoder.pt"),
                         "-f0ep", str(d / "f0_estimator.pt"), "-dep", str(d / "decoder.pt"),
                         "-lib", str(d / "voice_library.pt"), "--length", str(T),
                         "--torch-out", str(d / "torch"), "--device", "cpu"])
    after = tdec.filter_unet(dec.filter, t(x), t(c), dec.cfg)
    graphs = {name: torch.export.load(p).module() for name, p in paths.items()}
    return d, params, cfgs, lib, sds, graphs, (before, after)


def _filter_inputs():
    rng = np.random.default_rng(3)
    return ((0.3 * rng.standard_normal((1, T * 320, 1))).astype(np.float32),
            (0.5 * rng.standard_normal((1, T, 32))).astype(np.float32))


def _port(d):
    cpu = torch.device("cpu")
    return {k: torch_import.load_params_or_init(str(d / f"{k}.pt"), k, cpu) for k in KINDS}


def _spec():
    rng = np.random.default_rng(0)
    return np.abs(rng.standard_normal((1, T, 641))).astype(np.float32)


def test_six_graphs_written(exported):
    _, _, _, _, _, graphs, _ = exported
    assert sorted(graphs) == sorted(("f0_estimator", "content_encoder", "voice_library",
                                     "feature_extractor", "harmonic_oscillator", "filter"))


def test_content_encoder_and_f0_graphs(exported):
    d, params, _, _, _, graphs, _ = exported
    m = _port(d)
    spec = _spec()
    got = graphs["content_encoder"](t(spec))
    assert max_err(got, jce.content_encoder(params[0], jnp.asarray(spec))) <= 1e-4
    assert max_err(got, tce.content_encoder(m["content_encoder"], t(spec))) <= 1e-6
    bins = n(graphs["f0_estimator"](t(spec)))[..., 0]
    logits = np.asarray(jf0.f0_estimator(params[1], jnp.asarray(spec)))
    top2 = np.sort(logits, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 1e-4
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(bins[clear], np.asarray(jf0.f0_estimate(params[1], jnp.asarray(spec)))[..., 0][clear])
    np.testing.assert_array_equal(bins, n(tf0.f0_estimate(m["f0_estimator"], t(spec)))[..., 0])


def test_voice_library_graph(exported):
    d, _, _, lib, _, graphs, _ = exported
    m = _port(d)
    content = np.random.default_rng(1).standard_normal((1, T, 64)).astype(np.float32)
    got = graphs["voice_library"](t(content))
    assert max_err(got, voice_library_match(lib, jnp.asarray(content))) <= 1e-6
    assert max_err(got, tmatch(m["voice_library"], t(content))) <= 1e-6


def test_decoder_graphs(exported):
    d, params, cfgs, _, _, graphs, _ = exported
    dec = _port(d)["decoder"]
    rng = np.random.default_rng(2)
    content = rng.standard_normal((1, T, 64)).astype(np.float32)
    f0 = (rng.random((1, T, 1)) * 300 + 80).astype(np.float32)
    got = graphs["feature_extractor"](t(content), t(f0))
    jfe = params[2]["feature_extractor"]
    assert max_err(got, jdec.feature_extractor(jfe, jnp.asarray(content), jnp.asarray(f0))) <= 1e-4
    assert max_err(got, tdec.feature_extractor(dec.feature_extractor, t(content), t(f0))) <= 1e-6

    feats = rng.standard_normal((1, T, 32)).astype(np.float32)
    got = graphs["harmonic_oscillator"](t(feats))
    amps = jnp.exp(jlinear(params[2]["harmonic_oscillator"]["to_amps"], jnp.asarray(feats)))
    assert got.shape == (1, T * 320, 16)
    assert max_err(got, jinterp(amps, T * 320, axis=1)) <= 1e-4
    amps_t = torch.exp(dec.harmonic_oscillator.to_amps(t(feats)))
    assert max_err(got, interp.linear_interpolate(amps_t, T * 320, axis=1)) <= 1e-6

    x, c = _filter_inputs()
    got = graphs["filter"](t(x), t(c))
    assert got.shape == (1, T * 320)
    want = jdec.filter_unet(params[2]["filter"], jnp.asarray(x), jnp.asarray(c), cfgs[2])[..., 0]
    assert max_err(got, want) <= 5e-3
    assert max_err(got, tdec.filter_unet(dec.filter, t(x), t(c), dec.cfg)[..., 0]) <= 1e-6


def test_torch_out_bit_equal_to_the_jax_exports(exported):
    d, _, _, _, sds, _, _ = exported
    for kind, sd in sds.items():
        got = torch_import.load_torch_state_dict(str(d / "torch" / f"{kind}.pt"))
        assert sorted(got) == sorted(sd), kind
        for k, v in sd.items():
            np.testing.assert_array_equal(got[k].numpy(), v, err_msg=f"{kind}: {k}")


def test_export_leaves_eager_calls_real(exported):
    """Regression: tracing once filled ``ops/interp.py``'s cache with fake
    tensors, and every later eager upsample computed with them."""
    *_, (before, after) = exported
    assert type(after) is torch.Tensor
    assert all(type(w) is torch.Tensor for ws in interp._WEIGHTS.values() for w in ws)
    assert torch.equal(before, after)


def test_importers_build_at_the_file_widths(exported):
    d, _, cfgs, _, sds, _, _ = exported
    for kind, fn in (("content_encoder", torch_import.import_content_encoder),
                     ("f0_estimator", torch_import.import_f0_estimator),
                     ("decoder", torch_import.import_decoder),
                     ("voice_library", torch_import.import_voice_library)):
        m = fn(torch_import.load_torch_state_dict(str(d / f"{kind}.pt")))
        assert sorted(m.state_dict()) == sorted(sds[kind])
        for k, v in sds[kind].items():
            np.testing.assert_array_equal(m.state_dict()[k].numpy(), v, err_msg=f"{kind}: {k}")
    assert torch_import.import_decoder(sds["decoder"]).cfg.channels == cfgs[2].channels
    disc = Discriminator(DiscriminatorConfig(**DISC_KW), generator=torch.Generator().manual_seed(1))
    got = torch_import.import_discriminator(disc.state_dict())
    assert got.cfg == disc.cfg
    assert all(torch.equal(v, got.state_dict()[k]) for k, v in disc.state_dict().items())
