"""Shared set-up of the PyTorch-port parity tests (tests/test_torch_port_*.py),
and the check that the port's own copy of the configuration matches the JAX
package's.

Small configurations (narrow widths, two layers) keep the CPU run short.
JAX parameters come from the JAX package's ``init_*`` functions and are
carried into the port by ``alivevc_tpu_torch.compat.weights``; inputs come
from numpy seeds and reach both sides as numpy arrays.  TF32 plays no part here
(the CPU has none); tests/test_torch_port_gpu.py and chip_smoke.py set
``torch.backends.cuda.matmul.allow_tf32`` and ``torch.backends.cudnn.allow_tf32``
to False on the card.
"""

from __future__ import annotations

import numpy as np
import torch

import jax

# The suite runs as several pytest-xdist workers on one host's cores; each
# worker's PyTorch intra-op pool would spin on cores that the others need (a
# parallel run took over four times as long), so the port's CPU tests use
# one thread a process.
torch.set_num_threads(1)

CE_KW = dict(internal_channels=32, hidden_channels=64, output_channels=64, num_layers=2)
F0_KW = dict(internal_channels=32, hidden_channels=64, num_layers=2)
DEC_KW = dict(content_channels=64, channels=32, hidden_channels=64, num_layers=2,
              num_harmonics=16)


# the training tests' discriminator: 2 periods, 1 resolution, 8 channels
DISC_KW = dict(periods=(2, 3), period_channels=8, period_max_channels=32, resolutions=(512,),
               resolution_channels=8)


def jax_models(seed: int = 0):
    """(ce, f0, dec) JAX parameter pytrees and (ce, f0, dec) JAX configs."""
    from alivevc_tpu import config as jc
    from alivevc_tpu.models.content_encoder import init_content_encoder
    from alivevc_tpu.models.decoder import init_decoder
    from alivevc_tpu.models.f0_estimator import init_f0_estimator

    cfgs = (jc.ContentEncoderConfig(**CE_KW), jc.F0EstimatorConfig(**F0_KW),
            jc.DecoderConfig(**DEC_KW))
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    params = (init_content_encoder(k1, cfgs[0]), init_f0_estimator(k2, cfgs[1]),
              init_decoder(k3, cfgs[2]))
    return params, cfgs


def port_models(params):
    """The port's (ce, f0, dec) modules on the CPU, loaded from JAX params."""
    from alivevc_tpu_torch import config as tc
    from alivevc_tpu_torch.compat import weights
    from alivevc_tpu_torch.models.content_encoder import ContentEncoder
    from alivevc_tpu_torch.models.decoder import Decoder
    from alivevc_tpu_torch.models.f0_estimator import F0Estimator

    dcfg = tc.DecoderConfig(**DEC_KW)
    ce = weights.load_content_encoder(ContentEncoder(tc.ContentEncoderConfig(**CE_KW)), params[0])
    f0 = weights.load_f0_estimator(F0Estimator(tc.F0EstimatorConfig(**F0_KW)), params[1])
    dec = weights.load_decoder(Decoder(dcfg), params[2], dcfg)
    for m in (ce, f0, dec):
        m.eval().requires_grad_(False)
    return ce, f0, dec


def train_models(seed: int = 0, pitch_hz: int = 120):
    """The training tests' models: the port's (ce, f0, dec, disc) at the
    small widths from a torch generator (ce and f0 frozen), and the same
    weights as JAX pytrees {'ce', 'f0', 'dec', 'disc'} through the JAX
    package's own importer (``compat/torch_import.py``).  JAX's eager
    ``init_*`` takes 25-40 s for these four on this CPU (each new operation
    shape compiles), most of a test file's budget.

    The F0 estimator's output bias is raised by 50 at bin ``pitch_hz``, so
    every frame's f0 is a speech pitch: a random estimator's argmax lands
    anywhere in 0-4095 Hz, and at kHz fundamentals the JAX trainer's
    oscillator (``oscillator_impl='xla'``: the phase as a float32 cumsum
    over the window) drifts from the port's (a float64 base phase a frame)
    by ~2e-3 of the decoder's output (measured at 9 600 samples), which
    swamps what the training tests compare."""
    from alivevc_tpu import config as jc
    from alivevc_tpu.compat import torch_import as ti
    from alivevc_tpu_torch import config as tc
    from alivevc_tpu_torch.models.content_encoder import ContentEncoder
    from alivevc_tpu_torch.models.decoder import Decoder
    from alivevc_tpu_torch.models.discriminator import Discriminator
    from alivevc_tpu_torch.models.f0_estimator import F0Estimator

    g = torch.Generator().manual_seed(seed)
    ce = ContentEncoder(tc.ContentEncoderConfig(**CE_KW), generator=g)
    f0 = F0Estimator(tc.F0EstimatorConfig(**F0_KW), generator=g)
    dec = Decoder(tc.DecoderConfig(**DEC_KW), generator=g)
    disc = Discriminator(tc.DiscriminatorConfig(**DISC_KW), generator=g)
    with torch.no_grad():
        f0.output_layer.bias[pitch_hz] += 50.0
    for m in (ce, f0):
        m.eval().requires_grad_(False)
    sd = lambda m: {k: v.detach().numpy() for k, v in m.state_dict().items()}  # noqa: E731
    jax_params = {"ce": ti.import_content_encoder(sd(ce)), "f0": ti.import_f0_estimator(sd(f0)),
                  "dec": ti.import_decoder(sd(dec), jc.DecoderConfig(**DEC_KW)),
                  "disc": ti.import_discriminator(sd(disc), jc.DiscriminatorConfig(**DISC_KW))}
    return jax_params, (ce, f0, dec, disc)


def train_wave(n_items: int, length: int, seed: int = 0) -> np.ndarray:
    """[n_items, length] float32: gliding tones with noise, one pitch an item
    (frames differ, so the self-match has no near-ties)."""
    rng = np.random.default_rng(seed)
    tt = np.arange(length) / 16_000.0
    rows = []
    for _ in range(n_items):
        f = rng.uniform(100.0, 250.0) * (1.0 + 0.3 * tt)
        rows.append(0.4 * np.sin(2 * np.pi * np.cumsum(f) / 16_000.0)
                    + 0.05 * rng.standard_normal(length))
    return np.stack(rows).astype(np.float32)


def worst_rel(got: dict, want: dict) -> tuple:
    """(max over tensors of max |got - want| / max |want|, its name), for two
    dicts of same-named tensors."""
    assert set(got) == set(want), set(got) ^ set(want)
    errs = {k: float(np.abs(n(got[k]) - n(want[k])).max() / max(np.abs(n(want[k])).max(), 1e-30))
            for k in want}
    name = max(errs, key=errs.get)
    return errs[name], name


# ---------------------------------------------------------------------------
# training states carried between the two packages
# (tests/test_torch_port_train_state*.py)
# ---------------------------------------------------------------------------

VL_KW = dict(num_tokens=512, dim=DEC_KW["content_channels"])
TRAIN_LR = 1e-4


def state_models():
    """``train_models(0)`` and a 512-token voice library: the JAX pytrees
    {'ce', 'f0', 'dec', 'disc', 'vl'} and the port's (ce, f0, dec, disc,
    vl) with the same weights."""
    from alivevc_tpu.compat import torch_import as ti
    from alivevc_tpu_torch import config as tc
    from alivevc_tpu_torch.models.voice_library import VoiceLibrary

    params, mods = train_models(0)
    vl = VoiceLibrary(tc.VoiceLibraryConfig(**VL_KW), generator=torch.Generator().manual_seed(4))
    params["vl"] = ti.import_voice_library({"tokens": vl.tokens.detach().numpy()})
    return params, (*mods, vl)


def noise_tree(tree, seed: int, scale: float = 1.0):
    """A tree of ``tree``'s shapes, N(0, scale^2) from ``seed``, in numpy."""
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_unflatten(
        treedef, [(scale * rng.standard_normal(np.shape(x))).astype(np.float32) for x in leaves])


def jax_train_state(trainer: str, params, lr: float = TRAIN_LR):
    """The JAX package's state of ``trainer`` ('gan', 'fine_tune',
    'fine_tune_no_library', 'f0', 'distill') over ``params``, as its
    ``init_*`` forms it."""
    import jax.numpy as jnp

    from alivevc_tpu import config as jc
    from alivevc_tpu.train import distill as jdistill
    from alivevc_tpu.train import f0 as jf0
    from alivevc_tpu.train import fine_tune as jft
    from alivevc_tpu.train import gan as jgan
    from alivevc_tpu.train.optim import radam

    if trainer == "gan":
        opt_g, opt_d = jgan._make_opts(jc.TrainConfig())
        return jgan.GanState(params["dec"], params["disc"], opt_g.init(params["dec"]),
                             opt_d.init(params["disc"]), jnp.zeros((), jnp.int32))
    if trainer in ("fine_tune", "fine_tune_no_library"):
        return jft.init_fine_tune(params["dec"], params["disc"],
                                  params["vl"] if trainer == "fine_tune" else None, jc.TrainConfig())
    p = params["f0" if trainer == "f0" else "ce"]
    cls = jf0.F0TrainState if trainer == "f0" else jdistill.DistillState
    return cls(p, radam(lr).init(p), jnp.zeros((), jnp.int32))


def state_tensors(state, kinds=None) -> dict:
    """{name: tensor}: every parameter and both Adam moments of a port
    trainer's state (of the models ``kinds``, or all); a moment's name ends
    in ':exp_avg' or ':exp_avg_sq'."""
    from alivevc_tpu_torch.train.state import TRAINERS, trainer_of

    out = {}
    for slot in TRAINERS[trainer_of(state)].slots:
        module, opt = getattr(state, slot.module), getattr(state, slot.opt)
        if module is None or (kinds and slot.kind not in kinds):
            continue
        for name, p in module.named_parameters():
            out[f"{slot.kind}.{name}"] = p
            for key in ("exp_avg", "exp_avg_sq"):
                out[f"{slot.kind}.{name}:{key}"] = opt.state[p][key]
    return out


def jax_state_tensors(tree, trainer: str, kinds=None) -> dict:
    """``state_tensors``' names over a JAX state: the parameters, ``mu``
    and ``nu`` in the reference's layout (numpy)."""
    from alivevc_tpu_torch.compat import jax_train_state as jts
    from alivevc_tpu_torch.compat import weights
    from alivevc_tpu_torch.train.state import TRAINERS

    out = {}
    for slot, place in zip(TRAINERS[trainer].slots, jts.LAYOUTS[trainer][1]):
        p = getattr(tree, place.params)
        if p is None or (kinds and slot.kind not in kinds):
            continue
        adam = getattr(tree, place.opt)[0]
        for key, leaf in (("", p), (":exp_avg", adam.mu), (":exp_avg_sq", adam.nu)):
            for name, v in weights.MODELS[slot.kind].state(leaf).items():
                out[f"{slot.kind}.{name}{key}"] = v
    return out


def assert_same_step(state, before, after, trainer: str, got_metrics, want_metrics,
                     loss_rtol: float, grad_rtol=None, param_atol=None,
                     lr: float = TRAIN_LR) -> None:
    """A port state after a step against the JAX state ``after`` that the
    same step made from ``before``: each metric within ``loss_rtol``
    relative; each parameter within ``param_atol`` abs, or (None) within
    2.5 lr with at most 0.5 % of a model's entries over lr / 2 (AdamW's
    steps are about lr * sign(g)).  With ``grad_rtol``, each moment within
    what a gradient ``grad_rtol`` of its largest entry apart gives, g being
    the step's gradient that JAX folded into its first moment,
    (mu_after - b1 mu_before) / (1 - b1): mu within (1 - b1) grad_rtol
    max |g|, nu within (1 - b2) (2 + grad_rtol) grad_rtol max |g|^2."""
    from alivevc_tpu_torch.train.optim import RADAM_B1, RADAM_B2
    from alivevc_tpu_torch.train.state import TRAINERS

    for k, v in want_metrics.items():
        v = float(v)
        assert abs(float(got_metrics[k]) - v) <= loss_rtol * max(abs(v), 1e-6), (k, float(got_metrics[k]), v)
    got, want = state_tensors(state), jax_state_tensors(after, trainer)
    prev = jax_state_tensors(before, trainer)
    assert set(got) == set(want), set(got) ^ set(want)
    betas = {s.kind: getattr(state, s.opt).defaults.get("betas", (RADAM_B1, RADAM_B2))
             for s in TRAINERS[trainer].slots if getattr(state, s.module) is not None}
    moved, total = {}, {}
    for name, w in want.items():
        diff = np.abs(n(got[name]) - w)
        kind, param = name.split(".")[0], name.split(":")[0]
        b1, b2 = betas[kind]
        if ":" in name:
            if grad_rtol is None:
                continue
            g = np.abs(want[f"{param}:exp_avg"] - b1 * prev[f"{param}:exp_avg"]).max() / (1 - b1)
            bound = ((1 - b1) * grad_rtol * g if name.endswith(":exp_avg")
                     else (1 - b2) * (2 + grad_rtol) * grad_rtol * g * g)
            assert diff.max() <= bound, (name, diff.max(), bound)
        elif param_atol is not None:
            assert diff.max() <= param_atol, (name, diff.max())
        else:
            assert diff.max() <= 2.5 * lr, (name, diff.max())
            moved[kind] = moved.get(kind, 0) + int((diff > 0.5 * lr).sum())
            total[kind] = total.get(kind, 0) + diff.size
    for kind in moved:
        assert moved[kind] <= 0.005 * total[kind], (kind, moved[kind], total[kind])


def jax_port_jax(trainer: str, tree, jax_step, port_step, keys, tmp, check, **read_kw):
    """JAX takes steps 1-2 (``keys[0:2]``) from ``tree`` and writes its
    state; JAX's step 3 from that file against the port's, which reads it;
    the port writes its state, and JAX's step 4 from that file against the
    port's step 4.  ``jax_step(tree, key)`` and ``port_step(state, key)``
    return (state, metrics) and metrics; ``check(state, the file's tree,
    JAX's tree after the step, got metrics, want metrics)`` compares.
    Returns the port's state."""
    import os

    from alivevc_tpu.io.checkpoint import load_checkpoint, save_checkpoint
    from alivevc_tpu_torch.compat import jax_train_state as jts

    for key in keys[:2]:
        tree, _ = jax_step(tree, key)
    path = os.path.join(str(tmp), f"{trainer}_jax.ckpt")
    save_checkpoint(path, tree)
    state = jts.read(path, trainer, "cpu", **read_kw)
    assert state.step == 2
    for key, name in ((keys[2], "jax"), (keys[3], "port")):
        before = load_checkpoint(path, tree)
        want, want_m = jax_step(before, key)
        check(state, before, want, port_step(state, key), want_m)
        path = os.path.join(str(tmp), f"{trainer}_port.ckpt")
        jts.write(path, state)
    assert state.step == 4
    return state


def build_jax_native(out_dir) -> str:
    """The JAX package's native library built from its own sources
    (``native/*.cpp``, the Makefile's flags) into ``out_dir``; the path.
    Point JAX's bindings at it with ``native_bindings._LIB_PATHS = [path]``
    and ``native_bindings._lib = None``, whatever a checkout holds."""
    import os
    import subprocess

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    so = os.path.join(str(out_dir), "libalivevc_native.so")
    srcs = [os.path.join(repo, "native", f) for f in ("world.cpp", "ringbuffer.cpp")]
    subprocess.run(["g++", "-O3", "-march=native", "-fPIC", "-std=c++17", "-shared", "-o", so,
                    *srcs], check=True, capture_output=True, timeout=300)
    return so


def t(x) -> torch.Tensor:
    """numpy/JAX array -> float32 CPU tensor (a copy)."""
    return torch.from_numpy(np.array(x, dtype=np.float32))


def n(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


def max_err(a, b) -> float:
    return float(np.abs(n(a) - n(b)).max())


def test_config_copies_match_the_jax_package():
    """The port keeps its own config.py: every dataclass it copies has the
    JAX package's fields and defaults."""
    import dataclasses

    from alivevc_tpu import config as jc
    from alivevc_tpu_torch import config as tc

    for name in ("AudioConfig", "ContentEncoderConfig", "F0EstimatorConfig", "DecoderConfig",
                 "KNNConfig", "InferenceConfig", "StreamingConfig", "VoiceLibraryConfig",
                 "DiscriminatorConfig", "TrainConfig"):
        assert dataclasses.asdict(getattr(tc, name)()) == dataclasses.asdict(getattr(jc, name)()), name
    assert tc.AudioConfig().n_bins == jc.AudioConfig().n_bins == 641
    assert tc.ContentEncoderConfig().input_channels == 641
