"""Weight bridge of the PyTorch port (alivevc_tpu_torch/compat/weights.py):
it must produce exactly what the JAX package's compat/torch_export.py emits,
key for key and value for value, and the port's modules must load it with
strict key matching and hand it back unchanged."""

import numpy as np
import pytest

import jax

from alivevc_tpu.compat import torch_export
from alivevc_tpu_torch.compat import weights

from test_torch_port_util import jax_models, port_models


@pytest.fixture(scope="module")
def models():
    params, cfgs = jax_models(0)
    return params, cfgs, port_models(params)


def _exports(params, cfgs):
    return {
        "ce": (torch_export.export_content_encoder(params[0]),
               weights.content_encoder_state(params[0])),
        "f0": (torch_export.export_f0_estimator(params[1]),
               weights.f0_estimator_state(params[1])),
        "dec": (torch_export.export_decoder(params[2], cfgs[2]),
                weights.decoder_state(params[2], cfgs[2])),
    }


@pytest.mark.parametrize("which", ["ce", "f0", "dec"])
def test_bridge_equals_export(models, which):
    params, cfgs, _ = models
    want, got = _exports(params, cfgs)[which]
    assert list(got) == list(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("which", ["ce", "f0", "dec"])
def test_modules_load_and_return_the_export(models, which):
    params, cfgs, mods = models
    want, _ = _exports(params, cfgs)[which]
    module = dict(zip(("ce", "f0", "dec"), mods))[which]
    sd = module.state_dict()
    assert sorted(sd) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)


def test_default_configs_match_export_layout():
    """At the default (full) widths the port's freshly built modules carry
    exactly the export's keys and shapes, so a reference checkpoint loads."""
    from alivevc_tpu.models.content_encoder import init_content_encoder
    from alivevc_tpu.models.decoder import init_decoder
    from alivevc_tpu.models.f0_estimator import init_f0_estimator
    from alivevc_tpu_torch.models.content_encoder import ContentEncoder
    from alivevc_tpu_torch.models.decoder import Decoder
    from alivevc_tpu_torch.models.f0_estimator import F0Estimator

    shapes = lambda tree: jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32), tree)  # noqa: E731
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(1), 3)
    pairs = [
        (ContentEncoder(), torch_export.export_content_encoder(
            shapes(jax.eval_shape(init_content_encoder, k1)))),
        (F0Estimator(), torch_export.export_f0_estimator(
            shapes(jax.eval_shape(init_f0_estimator, k2)))),
        (Decoder(), torch_export.export_decoder(shapes(jax.eval_shape(init_decoder, k3)))),
    ]
    for module, sd in pairs:
        got = {k: tuple(v.shape) for k, v in module.state_dict().items()}
        assert got == {k: tuple(v.shape) for k, v in sd.items()}
        weights.load_state(module, sd)   # strict
