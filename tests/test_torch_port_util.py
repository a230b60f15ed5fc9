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
