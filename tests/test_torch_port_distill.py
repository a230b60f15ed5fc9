"""Content-encoder distillation (``alivevc_tpu_torch/train/distill.py``) and
its CLI against the JAX package on the CPU, at the small widths (``CE_KW``).

The JAX side is its own ``distill_step`` on a ``DistillState`` built by hand
around the same encoder (``compat/torch_import.py`` of the JAX package) and
``optax.radam``; its gradients are ``jax.grad`` of the step's loss
(``alivevc_tpu/train/distill.py:52-55``: the spectrogram, the encoder, the
L1 mean).  Tolerances (float32 convolutions and sums in another order),
with the CPU's readings: the loss 1e-5 relative (4.2e-7); the gradients
1e-4 of each tensor's largest entry (5.4e-7); the parameters after 1 and 3
steps 1e-6 abs (3.7e-9; RAdam's first steps are lr * m_hat, linear in the
gradient).

``distill_grads`` and ``distill_step`` given a group of 2 gloo ranks
(``tests/torch_port_ranks.py:run_distill_rank``) against the same step
alone on the whole batch: the gradients 1e-5 of each tensor's largest entry
(measured 3.8e-7), the losses 1e-6 relative, the parameters after each of
two steps 1e-7 abs (measured 3.7e-9).  The JAX package's own gate for its
dp step is rtol 2e-4 / atol 2e-5.
"""

import copy
import multiprocessing
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from alivevc_tpu.compat import torch_import as ti
from alivevc_tpu.models.content_encoder import content_encoder as jcontent_encoder
from alivevc_tpu.ops.stft import spectrogram as jspectrogram
from alivevc_tpu.train import distill as jdistill
from alivevc_tpu.train.optim import radam
from alivevc_tpu_torch import config as tc
from alivevc_tpu_torch.cli import common, train_content_encoder
from alivevc_tpu_torch.compat import weights
from alivevc_tpu_torch.io.audio import write_wav
from alivevc_tpu_torch.io.teacher import precompute_teacher_features
from alivevc_tpu_torch.models.content_encoder import ContentEncoder
from alivevc_tpu_torch.models.wavlm import WavLMConfig, seeded_state
from alivevc_tpu_torch.train import distill as tdistill
from alivevc_tpu_torch.train.state import load_train_state, save_train_state

import torch_port_ranks
from test_torch_port_util import CE_KW, n, t, train_wave, worst_rel

LR = 1e-4
PARAM_TOL = 1e-7     # dp vs dense parameters after a step (measured 3.7e-9)
WORLD = 2
JOIN_S = 120


def _encoder(seed: int = 0) -> ContentEncoder:
    return ContentEncoder(tc.ContentEncoderConfig(**CE_KW), generator=torch.Generator().manual_seed(seed))


def _batch(n_items: int = 2, length: int = 6400, seed: int = 1):
    wave = train_wave(n_items, length, seed)
    teacher = (0.1 * np.random.default_rng(seed + 1).standard_normal(
        (n_items, length // 320, CE_KW["output_channels"]))).astype(np.float32)
    return wave, teacher


def _jax_state(ce: ContentEncoder):
    params = ti.import_content_encoder({k: v.detach().numpy() for k, v in ce.state_dict().items()})
    return jdistill.DistillState(params, radam(LR).init(params), jnp.zeros((), jnp.int32))


def test_distill_step_matches_jax():
    wave, teacher = _batch()
    ce = _encoder()
    js = _jax_state(ce)
    state = tdistill.init_distill(copy.deepcopy(ce), LR)

    def jloss(params):
        out = jcontent_encoder(params, jspectrogram(jnp.asarray(wave)))
        return jnp.mean(jnp.abs(out - jnp.asarray(teacher)))

    want_loss, want_grads = jax.value_and_grad(jloss)(js.params)
    grads, loss = tdistill.distill_grads(state, t(wave), t(teacher))
    assert abs(float(loss) - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    names = [k for k, _ in state.model.named_parameters()]
    err, name = worst_rel(dict(zip(names, grads)), weights.content_encoder_state(want_grads))
    assert err <= 1e-4, (err, name)

    for steps in (1, 3):
        while int(js.step) < steps:
            js, jm = jdistill.distill_step(js, jnp.asarray(wave), jnp.asarray(teacher), LR)
            m = tdistill.distill_step(state, t(wave), t(teacher))
            assert abs(float(m["loss"]) - float(jm["loss"])) <= 1e-5 * abs(float(jm["loss"]))
        assert state.step == steps
        want = weights.content_encoder_state(js.params)
        for k, v in state.model.state_dict().items():
            assert np.abs(n(v) - want[k]).max() <= 1e-6, (steps, k)


def test_distill_loss_decreases():
    """The JAX package's test_distill_loss_decreases, on the port: the
    default-width encoder, two sines, a random teacher, five steps."""
    tt = np.arange(6400) / 16_000
    rng = np.random.default_rng(0)
    wave = np.stack([0.5 * np.sin(2 * np.pi * rng.uniform(100, 300) * tt) for _ in range(2)])
    teacher = 0.1 * np.random.default_rng(1).standard_normal((2, 20, 768))
    state = tdistill.init_distill(ContentEncoder(generator=torch.Generator().manual_seed(0)))
    losses = [float(tdistill.distill_step(state, t(wave), t(teacher))["loss"]) for _ in range(5)]
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0]


def test_dp_distill_step_equals_dense(tmp_path):
    tmp = str(tmp_path)
    wave, teacher = _batch(4, 6400, seed=5)
    ce = _encoder(2)
    torch.save({"ce_kw": CE_KW, "ce": ce.state_dict(), "wave": t(wave), "teacher": t(teacher)},
               os.path.join(tmp, "distill_inputs.pt"))
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=torch_port_ranks.run_distill_rank, args=(r, WORLD, tmp))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    try:      # the dense gradients and steps, while the ranks work
        state = tdistill.init_distill(copy.deepcopy(ce), LR)
        names = [k for k, _ in state.model.named_parameters()]
        want_grads = dict(zip(names, tdistill.distill_grads(state, t(wave), t(teacher))[0]))
        want = []
        for _ in range(2):
            loss = tdistill.distill_step(state, t(wave), t(teacher))["loss"]
            want.append((float(loss), {k: v.clone() for k, v in state.model.state_dict().items()}))
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
    for r in range(WORLD):
        got = torch.load(os.path.join(tmp, f"distill_rank{r}.pt"), weights_only=False)
        err, name = worst_rel(dict(zip(names, got["grads"][0])), want_grads)
        assert err <= 1e-5, (r, err, name)
        for (w_loss, w_params), g_loss, g_params in zip(want, got["loss"], got["params"]):
            assert abs(float(g_loss) - w_loss) <= 1e-6 * w_loss
            diff = max(float((g_params[k] - v).abs().max()) for k, v in w_params.items())
            assert diff <= PARAM_TOL, (r, diff)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Two 1 s WAVs (four 6 400-sample chunks), a narrow WavLM whose width is
    the small encoder's output (``weight_g`` form), and a training state of
    the small encoder at step 0."""
    d = tmp_path_factory.mktemp("distill_cli")
    data = d / "data"
    data.mkdir()
    for i, w in enumerate(train_wave(2, 16_000, seed=7)):
        write_wav(str(data / f"{i}.wav"), w, 16_000)
    cfg = WavLMConfig(hidden_size=CE_KW["output_channels"], num_layers=10, num_heads=4,
                      intermediate_size=128, conv_dim=(32,) * 7, num_conv_pos_embeddings=16,
                      num_conv_pos_embedding_groups=4)
    torch.save({k: torch.from_numpy(v) for k, v in seeded_state(cfg, 0, legacy_weight_norm=True).items()},
               str(d / "wavlm.pt"))
    ce = _encoder(3)
    save_train_state(str(d / "start.pt"), 0, {"content_encoder": ce},
                     {"content_encoder": tdistill.init_distill(ce).opt})
    return d


def _run(d, name, *flags):
    path = str(d / name)
    if not os.path.exists(path):
        with open(d / "start.pt", "rb") as f, open(path, "wb") as g:
            g.write(f.read())
    state = train_content_encoder.main([str(d / "data"), "-mp", path, "-e", "1", "-b", "2",
                                        "-len", "6400", "--device", "cpu", *flags])
    return path, state


def test_cli_with_either_teacher_source_and_resume(corpus):
    d = corpus
    path_w, state_w = _run(d, "via_wavlm.pt", "--wavlm-checkpoint", str(d / "wavlm.pt"))
    assert state_w.step == 2
    chunks = train_wave(2, 16_000, seed=7)[:, :12_800].reshape(4, 6400)
    feats = precompute_teacher_features(chunks, str(d / "wavlm.pt"), str(d / "feats.npz"),
                                        device="cpu")
    assert feats.shape == (4, 20, CE_KW["output_channels"])
    path_f, state_f = _run(d, "via_feats.pt", "--teacher-features", str(d / "feats.npz"))
    assert state_f.step == 2
    a, b = load_train_state(path_w), load_train_state(path_f)
    for k, v in a["models"]["content_encoder"].items():
        assert torch.allclose(v, b["models"]["content_encoder"][k], rtol=0, atol=1e-6), k
    # resume: the stored widths, optimizer and step; the inference CLIs read the encoder
    _, state_r = _run(d, "via_feats.pt", "--teacher-features", str(d / "feats.npz"))
    assert state_r.step == 4 and state_r.model.cfg == tc.ContentEncoderConfig(**CE_KW)
    ce = common.load_params_or_init(path_f, "content_encoder", torch.device("cpu"))
    for k, v in load_train_state(path_f)["models"]["content_encoder"].items():
        assert torch.equal(ce.state_dict()[k], v), k


def test_cli_refuses_a_run_without_teacher(corpus):
    with pytest.raises(SystemExit) as e:
        _run(corpus, "none.pt")
    assert "--teacher-features" in str(e.value) and "--wavlm-checkpoint" in str(e.value)
