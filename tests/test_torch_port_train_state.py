"""Training states carried between the JAX package's ``.ckpt`` format and the
port's trainers (``alivevc_tpu_torch/compat/jax_train_state.py``), on the
CPU at the test widths of ``test_torch_port_util.py``.

  (a) the port's reader opens a JAX ``adamw_gan`` state, whose
      ``EmptyState`` at ``t:1`` writes no key, and writes it back bit-equal;
  (b) each model's inverse (``compat/weights.py:*_params``) is bit-equal to
      JAX ``import_*`` and has the key set of JAX ``init_*``; each trainer's
      file written by the port has the keys, shapes and dtypes of the JAX
      state, and JAX ``load_checkpoint`` reads it against its template;
  (c) the optimizers continue exactly: JAX takes 2 optax updates and saves,
      the port reads the file, and both apply the same 2 more gradients;
      parameters and both moments agree to 1e-6 abs
      (``test_torch_port_train.py:test_optimizer_matches_optax``'s
      tolerance), and the same run with the moments zeroed does not;
  (d) JAX runs 2 steps of a trainer and writes its state; the port reads it
      and takes step 3, held to JAX's own step 3 from the same file; the
      port writes that state, JAX reads it and takes step 4, held to the
      port's step 4.  Each within its step test's tolerance: the GAN and
      fine-tuning steps' losses 1e-4 relative, parameters 2.5 lr abs with at
      most 0.5 % of entries over lr / 2 (``test_torch_port_train_gan.py``),
      and here also both moments within 2e-3 of each tensor's largest
      entry, the gradients' tolerance there (the moments after a step are
      the file's moments plus a share of the gradient); the F0 and distill
      steps' losses 1e-5 relative and parameters 1e-6 abs
      (``test_torch_port_train.py``, ``test_torch_port_distill.py``).
(e) (the CLIs' resumes from JAX-written ``.ckpt`` files) is in
``test_torch_port_train_state_cli.py``.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax

from alivevc_tpu import config as jc
from alivevc_tpu.compat import torch_import as ti
from alivevc_tpu.io.checkpoint import _flatten as jflatten
from alivevc_tpu.io.checkpoint import load_checkpoint as jload_checkpoint
from alivevc_tpu.io.checkpoint import save_checkpoint as jsave_checkpoint
from alivevc_tpu.models.content_encoder import init_content_encoder
from alivevc_tpu.models.decoder import init_decoder
from alivevc_tpu.models.discriminator import init_discriminator
from alivevc_tpu.models.f0_estimator import init_f0_estimator
from alivevc_tpu.models.voice_library import init_voice_library
from alivevc_tpu.train import distill as jdistill
from alivevc_tpu.train import f0 as jf0
from alivevc_tpu.train import gan as jgan
from alivevc_tpu.train.optim import adamw_gan as j_adamw_gan
from alivevc_tpu_torch import config as tc
from alivevc_tpu_torch.compat import jax_train_state as jts
from alivevc_tpu_torch.compat import weights
from alivevc_tpu_torch.io import checkpoint
from alivevc_tpu_torch.train import distill as tdistill
from alivevc_tpu_torch.train import f0 as tf0
from alivevc_tpu_torch.train import fine_tune as tft
from alivevc_tpu_torch.train import gan as tgan
from alivevc_tpu_torch.train import optim as topt
from alivevc_tpu_torch.train.state import TRAINERS, trainer_of

from test_torch_port_util import (
    CE_KW,
    DEC_KW,
    DISC_KW,
    F0_KW,
    VL_KW,
    assert_same_step,
    jax_port_jax,
    jax_state_tensors,
    jax_train_state,
    n,
    noise_tree,
    state_models,
    state_tensors,
    t,
    train_wave,
)

JCFG = dict(cfg=jc.TrainConfig(), dec_cfg=jc.DecoderConfig(**DEC_KW),
            disc_cfg=jc.DiscriminatorConfig(**DISC_KW))


def _sd(module) -> dict:
    return {k: v.detach().numpy() for k, v in module.state_dict().items()}


@pytest.fixture(scope="module")
def models():
    return state_models()


def _flat(tree) -> dict:
    """The JAX package's own flattening of a tree: {key: numpy array}."""
    out = {}
    jflatten(tree, "root", out)
    return out


def _same_file(a: str, b: str) -> None:
    """Two checkpoints hold the same keys, dtypes and arrays, bit for bit."""
    with np.load(a) as x, np.load(b) as y:
        assert set(x.files) == set(y.files), set(x.files) ^ set(y.files)
        for k in x.files:
            assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k]), k.replace("\x1f", "/")


# ---------------------------------------------------------------------------
# (a) the reader's repair: a tuple whose EmptyState wrote no key
# ---------------------------------------------------------------------------


def test_port_reads_a_jax_adamw_gan_state_and_writes_it_back(models, tmp_path):
    params, _ = models
    opt = j_adamw_gan()
    dec_opt = opt.init(params["dec"])
    dec_opt = (dec_opt[0]._replace(count=jnp.asarray(3, jnp.int32), mu=noise_tree(params["dec"], 1),
                                   nu=noise_tree(params["dec"], 2)), dec_opt[1],
               dec_opt[2]._replace(count=jnp.asarray(3, jnp.int32)))
    path, again = str(tmp_path / "jax.ckpt"), str(tmp_path / "port.ckpt")
    jsave_checkpoint(path, {"opt": dec_opt, "step": jnp.asarray(3, jnp.int32)})
    with np.load(path) as f:
        assert not any("\x1ft:1" in k for k in f.files)          # the gap
    tree = checkpoint.load_checkpoint(path)
    assert isinstance(tree["opt"], tuple) and len(tree["opt"]) == 3
    assert tree["opt"][1] == checkpoint.Fields() and isinstance(tree["opt"][0], checkpoint.Fields)
    assert int(tree["opt"][2]["count"]) == 3
    checkpoint.save_checkpoint(again, tree)
    _same_file(path, again)


# ---------------------------------------------------------------------------
# (b) the layouts
# ---------------------------------------------------------------------------


KINDS = {
    # kind: (index in the models fixture, JAX import_*, JAX init_* at the test widths)
    "content_encoder": (0, ti.import_content_encoder,
                        lambda k: init_content_encoder(k, jc.ContentEncoderConfig(**CE_KW))),
    "f0_estimator": (1, ti.import_f0_estimator,
                     lambda k: init_f0_estimator(k, jc.F0EstimatorConfig(**F0_KW))),
    "decoder": (2, lambda sd: ti.import_decoder(sd, jc.DecoderConfig(**DEC_KW)),
                lambda k: init_decoder(k, jc.DecoderConfig(**DEC_KW))),
    "discriminator": (3, lambda sd: ti.import_discriminator(sd, jc.DiscriminatorConfig(**DISC_KW)),
                      lambda k: init_discriminator(k, jc.DiscriminatorConfig(**DISC_KW))),
    "voice_library": (4, ti.import_voice_library,
                      lambda k: init_voice_library(k, jc.VoiceLibraryConfig(**VL_KW))),
}


@pytest.mark.parametrize("kind", list(KINDS))
def test_params_inverse_matches_jax_import(models, kind):
    """``*_params`` of a random state dict: bit-equal to JAX ``import_*``,
    the same containers, and the key set and shapes of JAX ``init_*``."""
    index, jimport, jinit = KINDS[kind]
    module = models[1][index]
    rng = np.random.default_rng(index)
    sd = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in _sd(module).items()}
    got, want = weights.MODELS[kind].params(sd), jimport(sd)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    got_f, want_f = _flat(got), _flat(want)
    assert set(got_f) == set(want_f)
    for k, v in want_f.items():
        assert got_f[k].dtype == v.dtype and np.array_equal(got_f[k], v), k
    init = _flat(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                        jax.eval_shape(jinit, jax.random.PRNGKey(0))))
    assert {k: v.shape for k, v in got_f.items()} == {k: v.shape for k, v in init.items()}
    # and back: the state dict again, exactly
    back = weights.MODELS[kind].state(got)
    assert set(back) == set(sd) and all(np.array_equal(back[k], sd[k]) for k in sd)


def _port_state(trainer: str, mods, **kw):
    ce, f0m, dec, disc, vl = mods
    if trainer == "gan":
        return tgan.init_gan(dec, disc, **kw)
    if trainer in ("fine_tune", "fine_tune_no_library"):
        return tft.init_fine_tune(dec, disc, vl if trainer == "fine_tune" else None, **kw)
    if trainer == "f0":
        return tf0.init_f0_train(f0m, **kw)
    return tdistill.init_distill(ce, **kw)


def _templates(trainer: str):
    """The JAX template ``load_checkpoint`` reads into: ``init_*``'s own
    shapes (``jax.eval_shape``, no arrays made) where ``init_*`` takes the
    test widths, else the state over ``init_*``-shaped parameters."""
    key = jax.random.PRNGKey(0)
    if trainer == "gan":
        return jax.eval_shape(lambda: jgan.init_gan(key, **JCFG))
    shapes = {name: jax.eval_shape(KINDS[kind][2], key) for name, kind in (
        ("ce", "content_encoder"), ("f0", "f0_estimator"), ("dec", "decoder"),
        ("disc", "discriminator"), ("vl", "voice_library"))}
    return jax.eval_shape(lambda: jax_train_state(trainer, shapes))


@pytest.mark.parametrize("trainer", ["gan", "fine_tune", "fine_tune_no_library", "f0", "distill"])
def test_port_file_has_the_jax_layout(models, trainer, tmp_path):
    params, mods = models
    state = _port_state(trainer, mods)
    path = str(tmp_path / f"{trainer}.ckpt")
    jts.write(path, state)
    want = _flat(jax_train_state(trainer, params))
    with np.load(path) as f:
        got = {k: f[k] for k in f.files}
    assert set(got) == set(want), set(got) ^ set(want)
    for k, v in want.items():
        assert (got[k].shape, got[k].dtype) == (v.shape, v.dtype), k.replace("\x1f", "/")
    template = _templates(trainer)
    back = jload_checkpoint(path, template)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(template)
    for a, s in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(template)):
        assert (a.shape, a.dtype) == (s.shape, s.dtype)


def test_read_refuses_what_is_not_the_layout(models, tmp_path):
    """A missing key, an extra key, a schedule count apart from its Adam
    count, or another trainer's file: each is refused with a message that
    names it."""
    params, _ = models
    good = jax_train_state("gan", params)
    cases = {
        "no_nu": (good._replace(dec_opt=(good.dec_opt[0]._replace(nu={}),) + good.dec_opt[1:]),
                  r"missing keys \d+ \['root/n:dec_opt/t:0/n:nu/d:feature_extractor"),
        "extra": (good._replace(dec_params={**good.dec_params, "bias": jnp.zeros(3)}),
                  r"leaves the decoder has no place for, e\.g\. root/d:bias"),
        "schedule": (good._replace(disc_opt=(good.disc_opt[0]._replace(count=jnp.asarray(2)),)
                                   + good.disc_opt[1:]),
                     r"disc_opt's schedule count 0 differs from its Adam count 2"),
    }
    for name, (tree, match) in cases.items():
        path = str(tmp_path / f"{name}.ckpt")
        jsave_checkpoint(path, tree)
        with pytest.raises(ValueError, match=match):
            jts.read(path, "gan", "cpu")
    path = str(tmp_path / "f0.ckpt")
    jsave_checkpoint(path, jax_train_state("f0", params))
    with pytest.raises(ValueError, match="not a JAX GanState: missing fields"):
        jts.read(path, "gan", "cpu")
    with pytest.raises(ValueError, match="not a content_encoder's parameters"):
        jts.read(path, "distill", "cpu")


# ---------------------------------------------------------------------------
# (c) the optimizers continue exactly
# ---------------------------------------------------------------------------


OPTIMIZERS = {
    # optimizer: (trainer, the models updated, lr, the JAX optimizer of each model's slot)
    "adamw_gan": ("gan", ("decoder", "discriminator"), 1e-2,
                  lambda lr: j_adamw_gan(lr, 0.8, 0.99, 6)),
    "library_adamw": ("fine_tune", ("voice_library",), 1e-2, lambda lr: optax.adamw(lr)),
    "radam": ("f0", ("f0_estimator",), 1e-4, lambda lr: optax.radam(lr)),
}


def _jax_update(tree, trainer, kinds, opt, grads):
    """``tree`` after one optax update of the models ``kinds`` by ``grads``
    ({kind: pytree})."""
    fields = {}
    for slot, place in zip(TRAINERS[trainer].slots, jts.LAYOUTS[trainer][1]):
        if slot.kind in kinds:
            p = getattr(tree, place.params)
            upd, st = opt.update(grads[slot.kind], getattr(tree, place.opt), p)
            fields[place.params], fields[place.opt] = optax.apply_updates(p, upd), st
    return tree._replace(step=tree.step + 1, **fields)


def _port_update(state, kinds, grads, lr_of):
    for slot in TRAINERS[trainer_of(state)].slots:
        if slot.kind in kinds:
            module, opt = getattr(state, slot.module), getattr(state, slot.opt)
            if lr_of is not None:
                topt.set_lr(opt, lr_of(tgan.update_count(opt)))
            sd = weights.MODELS[slot.kind].state(grads[slot.kind])
            names = [k for k, _ in module.named_parameters()]
            topt.apply_grads(opt, list(module.parameters()), [t(sd[k]) for k in names])
    state.step += 1


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_continues_exactly_through_the_file(models, name, tmp_path):
    params, _ = models
    trainer, kinds, lr, make = OPTIMIZERS[name]
    opt = make(lr)
    key = {"decoder": "dec", "discriminator": "disc", "voice_library": "vl",
           "f0_estimator": "f0"}
    grads = [{k: noise_tree(params[key[k]], 10 * i + j) for j, k in enumerate(kinds)} for i in range(4)]
    tree = jax_train_state(trainer, params)
    tree = tree._replace(**{p.opt: opt.init(getattr(tree, p.params))
                            for s, p in zip(TRAINERS[trainer].slots, jts.LAYOUTS[trainer][1])
                            if s.kind in kinds})
    update = jax.jit(lambda tree, g: _jax_update(tree, trainer, kinds, opt, g))
    for g in grads[:2]:
        tree = update(tree, g)
    path = str(tmp_path / f"{name}.ckpt")
    jsave_checkpoint(path, tree)
    for g in grads[2:]:
        tree = update(tree, g)
    want = jax_state_tensors(tree, trainer, kinds)
    kw = dict(learning_rate=lr) if trainer == "f0" else dict(cfg=tc.TrainConfig(learning_rate=lr))
    lr_of = topt.cosine_annealing(lr, 6) if name == "adamw_gan" else None

    def resumed(zero: bool) -> float:
        state = jts.read(path, trainer, "cpu", **kw)
        assert state.step == 2
        if zero:
            for v in [v for k, v in state_tensors(state, kinds).items() if ":" in k]:
                v.zero_()
        for g in grads[2:]:
            _port_update(state, kinds, g, lr_of)
        got = state_tensors(state, kinds)
        assert set(got) == set(want)
        return max(float(np.abs(n(got[k]) - want[k]).max()) for k in want)

    assert resumed(zero=False) <= 1e-6
    assert resumed(zero=True) > 1e-6          # the control: a resume of the models alone


# ---------------------------------------------------------------------------
# (d) JAX -> port -> JAX: the F0 trainer and distillation
# (the GAN and fine-tuning: tests/test_torch_port_train_state_gan.py, _finetune.py)
# ---------------------------------------------------------------------------


def test_f0_trainer_moves_between_the_packages(models, tmp_path):
    params, (_, f0m, *_) = models
    wave = train_wave(2, 6400, 7)
    f0 = np.random.default_rng(8).uniform(60.0, 300.0, (2, 20)).astype(np.float32)
    f0[1, 5:9] = 0.0

    def jax_step(tree, key):
        return jf0.f0_train_step(tree, jnp.asarray(wave), jnp.asarray(f0), key)

    def port_step(state, key):
        amp = np.asarray(jax.random.uniform(key, (2, 1)) * 0.75 + 0.25)
        return tf0.f0_train_step(state, t(wave), t(f0), t(amp))

    def check(state, before, after, got, want):
        assert_same_step(state, before, after, "f0", got, want, loss_rtol=1e-5, grad_rtol=1e-4,
                         param_atol=1e-6)

    jax_port_jax("f0", jax_train_state("f0", params), jax_step, port_step,
                 jax.random.split(jax.random.PRNGKey(9), 4), tmp_path, check)


def test_distillation_moves_between_the_packages(models, tmp_path):
    params, (ce, *_) = models
    wave = train_wave(2, 6400, 1)
    teacher = (0.1 * np.random.default_rng(2).standard_normal(
        (2, 20, CE_KW["output_channels"]))).astype(np.float32)

    def jax_step(tree, key):
        return jdistill.distill_step(tree, jnp.asarray(wave), jnp.asarray(teacher))

    def port_step(state, key):
        return tdistill.distill_step(state, t(wave), t(teacher))

    def check(state, before, after, got, want):
        assert_same_step(state, before, after, "distill", got, want, loss_rtol=1e-5,
                         grad_rtol=1e-4, param_atol=1e-6)

    jax_port_jax("distill", jax_train_state("distill", params), jax_step, port_step,
                 [None] * 4, tmp_path, check)
