"""A fine-tuning run, with the voice library, moved between the JAX package
and the port (``tests/test_torch_port_train_state.py``'s part (d); a file
of its own, as is the GAN run's, ``test_torch_port_train_state_gan.py``,
because each JAX step compiles for 20-35 s here): JAX takes 2 steps and writes
its ``.ckpt``; the port reads it and takes step 3, held to JAX's own step 3
from the same file; the port writes its state, and JAX reads it and takes
step 4, held to the port's step 4.  The same batch and amplitude draws on both
sides (from the JAX key, handed to the port as a tensor).

Tolerances (``test_torch_port_train_gan.py``, ``_finetune.py``): losses 1e-4
relative; parameters after a step 2.5 lr abs, with at most 0.5 % of a
model's entries over lr / 2.  An AdamW step divides the moments it read from
the file by each other, so moments carried wrong move the parameters (the
exact carry of the moments is ``test_torch_port_train_state.py``'s part
(c)).  The moments are not compared here: the gradient a step folds into
them differs between the two packages by the oscillator's two forms, and at
step 3 the MRD's layer-0 bias gradient reads 2.7e-3 of its largest entry (a
sum over frames whose terms cancel), over the 2e-3 the step tests measured
at step 1.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from alivevc_tpu import config as jc
from alivevc_tpu.train import fine_tune as jft
from alivevc_tpu_torch.train import fine_tune as tft
from alivevc_tpu_torch.train import gan as tgan

from test_torch_port_util import (
    DEC_KW,
    DISC_KW,
    assert_same_step,
    jax_port_jax,
    jax_train_state,
    state_models,
    t,
    train_wave,
)

JCFG = dict(cfg=jc.TrainConfig(), dec_cfg=jc.DecoderConfig(**DEC_KW),
            disc_cfg=jc.DiscriminatorConfig(**DISC_KW))


@pytest.fixture(scope="module")
def models():
    return state_models()


def test_fine_tune_run_moves_between_the_packages(models, tmp_path):
    params, (ce, f0m, *_) = models
    wave = train_wave(2, 9600, seed=2)

    def jax_step(tree, key):
        return jft.fine_tune_step(tree, params["ce"], params["f0"], jnp.asarray(wave), key,
                                  use_library=True, **JCFG)

    def port_step(state, key):
        amp = np.asarray(jax.random.uniform(key, (2, 1)) * 2.0)
        return tft.fine_tune_step(state, ce, f0m, t(wave), t(amp), use_library=True)

    def check(state, before, after, got, want):
        assert_same_step(state, before, after, "fine_tune", got, want, loss_rtol=1e-4)

    state = jax_port_jax("fine_tune", jax_train_state("fine_tune", params), jax_step, port_step,
                         jax.random.split(jax.random.PRNGKey(7), 4), tmp_path, check)
    assert tgan.update_count(state.opt_vl) == 4
