"""Batched offline conversion on a ``('data', 'library')`` mesh
(``alivevc_tpu/parallel/distributed_vc.py``, BASELINE config #5).

Windows split over ``data``, the voice library over ``library``, models
replicated.  Each rank converts its windows against its library shard: the
spectrogram (the STFT kernel on the card; the JAX path uses the XLA one), the F0
estimator, intonation, the content encoder, ``local_topk_merge`` over the
``library`` group, and the decoder (Chebyshev source kernel, the filter
kernel on every up level).  The windows are then gathered over ``data``, so
every rank returns the full batch, as the JAX global array holds it.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh

from alivevc_tpu_torch.config import DecoderConfig
from alivevc_tpu_torch.device import DeviceLike, float32_math, resolve_device
from alivevc_tpu_torch.infer.offline import _on
from alivevc_tpu_torch.models.content_encoder import content_encoder
from alivevc_tpu_torch.models.decoder import decoder
from alivevc_tpu_torch.models.f0_estimator import f0_estimate
from alivevc_tpu_torch.ops.pitch import apply_intonation
from alivevc_tpu_torch.ops.stft import spectrogram
from alivevc_tpu_torch.parallel.mesh import shard_along
from alivevc_tpu_torch.parallel.sharded_knn import local_topk_merge, pad_library_for_sharding


@torch.no_grad()
def convert_windows_distributed(
    mesh: DeviceMesh,
    ce: nn.Module,
    f0_est: nn.Module,
    dec: nn.Module,
    windows,                      # [N, Lw], N divisible by the 'data' size
    library,                      # [Lr, 768] unpadded; padded and split here
    f0_rate: float = 1.0,
    pitch_shift: float = 0.0,
    intonation: float = 1.0,
    k: int = 4,
    alpha: float = 0.0,
    dec_cfg: Optional[DecoderConfig] = None,
    precision: str = "highest",
    device: DeviceLike = None,
) -> torch.Tensor:
    """Converted windows [N, Lw] float32, the full batch on every rank.
    float32 throughout, without TF32."""
    dev = resolve_device(device)
    for m, name in ((ce, "ce"), (f0_est, "f0_est"), (dec, "dec")):
        _on(m, dev, name)
    dec_cfg = dec.cfg if dec_cfg is None else dec_cfg
    windows = torch.as_tensor(windows, dtype=torch.float32).to(dev)
    lib_p, valid = pad_library_for_sharding(torch.as_tensor(library).to(dev),
                                            mesh.size(mesh.mesh_dim_names.index("library")))
    lib_shard = shard_along(lib_p, mesh, "library")
    valid_shard = shard_along(valid, mesh, "library")
    win = shard_along(windows, mesh, "data")
    with float32_math():
        spec = spectrogram(win)
        f0 = f0_estimate(f0_est, spec)
        f0 = torch.stack([apply_intonation(f, intonation, pitch_shift) for f in f0])
        content = content_encoder(ce, spec)                              # [n_loc, Ls, 768]
        n_loc, ls, d = content.shape
        matched = local_topk_merge(content.reshape(n_loc * ls, d), lib_shard, valid_shard, mesh,
                                   k=k, alpha=alpha, axis_name="library",
                                   precision=precision).reshape(n_loc, ls, d)
        wave, _ = decoder(dec, matched, f0 * f0_rate, cfg=dec_cfg)
    group = mesh.get_group("data")
    parts = [torch.empty_like(wave) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, wave.contiguous(), group=group)
    return torch.cat(parts)
