"""Time-axis sharding with a halo exchange at each depthwise conv
(``alivevc_tpu/parallel/halo.py``).

Every frame-rate model of the family (content encoder, F0 estimator, the
decoder's feature extractor) is a stack of finite-receptive-field
convolutions between pointwise operations, so a long utterance can be split
along time over the ranks of one mesh dimension.  Each rank holds a
``[T_local, C]`` slice; before each depthwise conv of kernel k it receives
(k - 1) / 2 edge frames from each ring neighbour, and the global edges get
zeros, exactly the dense conv's zero padding.  The halo a rank receives is
its neighbour's real previous-layer output, so the sharded models compute
the dense ones' values (up to the float32 rounding of products over other
row counts).

The exchange is one ``all_gather`` of each rank's two edge slabs ([2, halo,
C]), from which every rank takes its neighbours' facing slabs.  JAX swaps
them with ``ppermute``, and ``send``/``recv`` would bring each rank only
its two neighbours' slabs instead of all P ranks'; but gloo's point-to-point
calls are not relied on for CUDA tensors, while its ``all_gather`` takes
them, as NCCL's does, so one form serves gloo on the CPU, gloo with several
ranks on one card, and NCCL across cards.  A layer sends 2 * halo * C
elements from each rank and gathers P such slabs on every rank.  NCCL
across cards has not run anywhere: the card check runs this path as gloo
ranks on one card.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from alivevc_tpu_torch.models.content_encoder import ContentEncoder
from alivevc_tpu_torch.models.decoder import FeatureExtractor, f0_encoder
from alivevc_tpu_torch.models.f0_estimator import F0Estimator
from alivevc_tpu_torch.nn.layers import (
    AdaptiveConvNeXt1d,
    ConvNeXt1d,
    adaptive_channel_norm,
    channel_norm,
    depthwise_conv1d,
    gelu,
)


class TimeAxis(NamedTuple):
    """The mesh dimension that splits time: its process group, this rank's
    position on it, and its size."""
    group: dist.ProcessGroup
    rank: int
    size: int


def time_axis(mesh: DeviceMesh, dim: str) -> TimeAxis:
    return TimeAxis(mesh.get_group(dim), mesh.get_local_rank(dim),
                    mesh.size(mesh.mesh_dim_names.index(dim)))


def halo_pad(x: torch.Tensor, halo: int, axis: TimeAxis) -> torch.Tensor:
    """Pad a [T_local, C] slice with ``halo`` frames of each neighbour's edge
    (zeros at the global edges, as dense zero-padded convolution)."""
    if halo == 0:
        return x
    if x.shape[0] < halo:
        raise ValueError(f"a slice of {x.shape[0]} frames is shorter than the halo ({halo})")
    edges = torch.stack([x[:halo], x[-halo:]]).contiguous()        # [2, halo, C]
    slabs = [torch.empty_like(edges) for _ in range(axis.size)]
    dist.all_gather(slabs, edges, group=axis.group)
    zeros = torch.zeros_like(edges[0])
    left = slabs[axis.rank - 1][1] if axis.rank > 0 else zeros
    right = slabs[axis.rank + 1][0] if axis.rank < axis.size - 1 else zeros
    return torch.cat([left, x, right], dim=0)


def _dw_conv_halo(conv, x: torch.Tensor, axis: TimeAxis) -> torch.Tensor:
    """Depthwise conv with same-padding realised through the halo exchange:
    [T_local, C] -> [T_local, C]."""
    halo = (conv.weight.shape[-1] - 1) // 2
    return depthwise_conv1d(halo_pad(x, halo, axis)[None], conv.weight, conv.bias)[0]


def convnext1d_sharded(m: ConvNeXt1d, x: torch.Tensor, axis: TimeAxis) -> torch.Tensor:
    """ConvNeXt1d block on a time-sharded [T_local, C] slice."""
    h = channel_norm(m.norm, _dw_conv_halo(m.dw_conv, x, axis))
    h = m.pw_conv2(gelu(m.pw_conv1(h)))
    return h * m.scale.reshape(-1) + x


def adaptive_convnext1d_sharded(m: AdaptiveConvNeXt1d, x: torch.Tensor, cond: torch.Tensor,
                                axis: TimeAxis) -> torch.Tensor:
    h = adaptive_channel_norm(m.norm, _dw_conv_halo(m.dw_conv, x, axis), cond)
    h = m.pw_conv2(gelu(m.pw_conv1(h)))
    return h * m.scale.reshape(-1) + x


def content_encoder_sharded(m: ContentEncoder, spec: torch.Tensor, axis: TimeAxis) -> torch.Tensor:
    """ContentEncoder on a time-sharded [T_local, 641] slice."""
    x = m.input_layer(spec)
    for block in m.mid_layers:
        x = convnext1d_sharded(block, x, axis)
    return m.output_layer(x)


def f0_estimator_sharded(m: F0Estimator, spec: torch.Tensor, axis: TimeAxis) -> torch.Tensor:
    """F0Estimator logits on a time-sharded [T_local, 641] slice."""
    x = m.input_layer(spec)
    for block in m.mid_layers:
        x = convnext1d_sharded(block, x, axis)
    return m.output_layer(m.last_norm(x))


def feature_extractor_sharded(m: FeatureExtractor, content: torch.Tensor, f0: torch.Tensor,
                              axis: TimeAxis) -> torch.Tensor:
    """The decoder's FeatureExtractor on time-sharded [T_local, 768] content
    and [T_local, 1] f0.  The F0 condition is pointwise (1x1 convs and a
    sine), so only the AdaptiveConvNeXt blocks' depthwise convs exchange
    halos.  The sample-rate filter U-Net is not time-sharded: long audio is
    split into overlap-discard windows instead (``infer/offline.py``)."""
    x = m.input_layer(content)
    cond = f0_encoder(m.f0_enc, f0).to(x.dtype)
    for block in m.mid_layers:
        x = adaptive_convnext1d_sharded(block, x, cond, axis)
    return x


def sharded_frame_model(
    mesh: DeviceMesh,
    model_fn: Callable[[torch.Tensor, TimeAxis], torch.Tensor],
    x_local: torch.Tensor,     # this rank's [T_local, C_in] slice
    dim: str = "data",
) -> torch.Tensor:
    """Run a ``*_sharded`` model, ``model_fn(x_local, axis)``, on this rank's
    slice of a time axis split over the mesh dimension ``dim``; returns this
    rank's slice of the output.  Every rank of ``dim`` must call it."""
    return model_fn(x_local, time_axis(mesh, dim))


def gather_time(mesh: DeviceMesh, y_local: torch.Tensor, dim: str = "data") -> torch.Tensor:
    """The whole [T, C] from every rank's equal [T_local, C] slice, in rank
    order along ``dim``."""
    axis = time_axis(mesh, dim)
    parts = [torch.empty_like(y_local) for _ in range(axis.size)]
    dist.all_gather(parts, y_local.contiguous(), group=axis.group)
    return torch.cat(parts, dim=0)
