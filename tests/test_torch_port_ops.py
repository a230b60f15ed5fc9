"""Ops and NN blocks of the PyTorch port against the JAX package on the CPU:
the same numpy inputs and the same (bridged) parameters through both.

Tolerance: 1e-4 abs throughout (float32 on both sides; the two frameworks
sum in different orders), unless a test says otherwise."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from alivevc_tpu.nn import layers as jl
from alivevc_tpu.ops import interp as jinterp
from alivevc_tpu.ops import knn as jknn
from alivevc_tpu.ops import pitch as jpitch
from alivevc_tpu.ops import stft as jstft
from alivevc_tpu_torch.compat import weights
from alivevc_tpu_torch.nn import layers as tl
from alivevc_tpu_torch.ops import interp as tinterp
from alivevc_tpu_torch.ops import knn as tknn
from alivevc_tpu_torch.ops import pitch as tpitch
from alivevc_tpu_torch.ops import stft as tstft

from test_torch_port_util import max_err, n, t

TOL = 1e-4


@pytest.mark.parametrize("in_size,out_size,axis", [(9, 36, 1), (9, 20, 1), (20, 7, 1), (12, 5, -1)])
def test_linear_interpolate(in_size, out_size, axis):
    rng = np.random.default_rng(in_size * out_size)
    shape = (2, in_size, 3) if axis == 1 else (2, 3, in_size)
    x = rng.standard_normal(shape).astype(np.float32)
    want = jinterp.linear_interpolate(jnp.asarray(x), out_size, axis)
    got = tinterp.linear_interpolate(t(x), out_size, axis)
    assert got.shape == want.shape
    assert max_err(got, want) <= 1e-6


def test_pitch_ops():
    rng = np.random.default_rng(1)
    f0 = (rng.random((40, 1)) * 300 + 80).astype(np.float32)
    f0[::5] = 0.0                                     # unvoiced frames
    assert max_err(tpitch.f0_to_pitch(t(f0[1:2])), jpitch.f0_to_pitch(jnp.asarray(f0[1:2]))) <= TOL
    assert max_err(tpitch.shift_pitch(t(f0), 3.0), jpitch.shift_pitch(jnp.asarray(f0), 3.0)) <= 1e-3
    got = tpitch.apply_intonation(t(f0), 1.3, -2.0)
    want = jpitch.apply_intonation(jnp.asarray(f0), 1.3, -2.0)
    # Hz values up to ~500: 1e-3 abs is float32 rounding of log2/pow
    assert max_err(got, want) <= 1e-3
    assert float(got[0]) == 0.0


def test_spectrogram_and_log_mel():
    rng = np.random.default_rng(2)
    x = (0.1 * rng.standard_normal((2, 6400))).astype(np.float32)
    assert max_err(tstft.spectrogram(t(x)), jstft.spectrogram(jnp.asarray(x))) <= TOL
    # log(mel + 1e-4): 1e-3 abs where a mel bin is near 0
    assert max_err(tstft.log_mel_spectrogram(t(x)), jstft.log_mel_spectrogram(jnp.asarray(x))) <= 1e-3


def _lin_sd(p):
    sd = {}
    weights.lin_state(sd, "m", p)
    return {k[2:]: v for k, v in sd.items()}


def test_primitives():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 30, 16)).astype(np.float32)
    assert max_err(tl.gelu(t(x)), jl.gelu(jnp.asarray(x))) <= 1e-6
    p = jl.init_linear(jax.random.PRNGKey(0), 16, 24)
    m = weights.load_state(tl.Linear(16, 24), _lin_sd(p))
    assert max_err(m(t(x)), jl.linear(p, jnp.asarray(x))) <= TOL
    pc = jl.init_conv1d(jax.random.PRNGKey(1), 16, 8, 5)
    sd = {}
    weights.conv_state(sd, "m", pc)
    conv = weights.load_state(tl.Conv(16, 8, 5), {k[2:]: v for k, v in sd.items()})
    want = jl.conv1d(jnp.asarray(x), pc["w"], pc["b"], padding=2, dilation=2)
    assert max_err(tl.conv1d(t(x), conv.weight, conv.bias, padding=2, dilation=2), want) <= TOL
    for d in (1, 2, 4):
        assert max_err(tl.causal_conv1d(conv, t(x), d), jl.causal_conv1d(pc, jnp.asarray(x), d)) <= TOL
    pd = jl.init_conv1d(jax.random.PRNGKey(2), 16, 16, 7, groups=16)
    sd = {}
    weights.dw_state(sd, "m", pd)
    dw = weights.load_state(tl.Conv(16, 16, 7, groups=16), {k[2:]: v for k, v in sd.items()})
    want = jl.depthwise_conv1d(jnp.asarray(x), pd["w"], pd["b"], padding=3)
    assert max_err(tl.depthwise_conv1d(t(x), dw.weight, dw.bias, padding=3), want) <= TOL


def test_norms_and_convnext():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 30, 16)).astype(np.float32)
    cond = rng.standard_normal((2, 30, 12)).astype(np.float32)
    pn = {"scale": jnp.asarray(rng.random(16).astype(np.float32) + 0.5),
          "shift": jnp.asarray(rng.standard_normal(16).astype(np.float32))}
    sd = {}
    weights.norm_state(sd, "m", pn)
    norm = weights.load_state(tl.ChannelNorm(16), {k[2:]: v for k, v in sd.items()})
    assert max_err(norm(t(x)), jl.channel_norm(pn, jnp.asarray(x))) <= TOL

    pa = jl.init_adaptive_channel_norm(jax.random.PRNGKey(5), 16, 12)
    sd = {}
    weights.lin_state(sd, "scale", pa["scale"])
    weights.lin_state(sd, "shift", pa["shift"])
    anorm = weights.load_state(tl.AdaptiveChannelNorm(16, 12), sd)
    assert max_err(anorm(t(x), t(cond)),
                   jl.adaptive_channel_norm(pa, jnp.asarray(x), jnp.asarray(cond))) <= TOL

    pc = jl.init_convnext1d(jax.random.PRNGKey(6), 16, 32, 7, scale=0.5)
    sd = {}
    weights.convnext_state(sd, "m", pc)
    blk = weights.load_state(tl.ConvNeXt1d(16, 32, 7), {k[2:]: v for k, v in sd.items()})
    assert max_err(blk(t(x)), jl.convnext1d(pc, jnp.asarray(x))) <= TOL

    pac = jl.init_adaptive_convnext1d(jax.random.PRNGKey(7), 16, 32, 12, 7, scale=0.5)
    sd = {}
    weights.adaptive_convnext_state(sd, "m", pac)
    ablk = weights.load_state(tl.AdaptiveConvNeXt1d(16, 32, 12, 7), {k[2:]: v for k, v in sd.items()})
    assert max_err(ablk(t(x), t(cond)),
                   jl.adaptive_convnext1d(pac, jnp.asarray(x), jnp.asarray(cond))) <= TOL


@pytest.mark.parametrize("alpha", [0.0, 0.3])
def test_match_features_dense(alpha):
    rng = np.random.default_rng(8)
    src = rng.standard_normal((2, 25, 32)).astype(np.float32)
    ref = rng.standard_normal((200, 32)).astype(np.float32)
    want = jknn.match_features(jnp.asarray(src), jnp.asarray(ref), 4, alpha)
    got = tknn.match_features(t(src), t(ref), 4, alpha)
    assert max_err(got, want) <= 1e-5


def test_topk_ties_go_to_the_smallest_index():
    """Duplicate library rows score equal: the earlier row must win, in the
    plain top-k and in the batched match (lax.top_k's order)."""
    from alivevc_tpu_torch.kernels.knn import knn_topk, topk_exact

    sims = torch.tensor([[0.5, 0.9, 0.9, 0.1, 0.9]])
    v, i = topk_exact(sims, 3)
    assert i.tolist() == [[1, 2, 4]]
    rng = np.random.default_rng(9)
    lib = rng.standard_normal((40, 32)).astype(np.float32)
    lib[30] = lib[7]                                   # exact duplicate of row 7
    q = lib[7:8] + 0.01 * rng.standard_normal((1, 32)).astype(np.float32)
    for precision in ("default", "high", "highest"):
        _, idx = knn_topk(t(q), t(lib), 4, precision)
        assert 7 in idx[0].tolist() and 30 in idx[0].tolist()
        assert idx[0].tolist().index(7) < idx[0].tolist().index(30)
    np.testing.assert_allclose(n(v), [[0.9, 0.9, 0.9]])
