"""Rank bodies of the port's multi-process tests (tests/test_torch_port_parallel.py).

Each rank is a spawned process that joins a gloo group through a file
rendezvous and runs on the CPU.  This module imports torch and the port
only: spawned workers must not import JAX (tests/conftest.py and
tests/test_torch_port_util.py set JAX up), so the parent test process
computes the JAX oracles and hands the inputs over in a file it wrote.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def models(spec):
    """The port's (ce, f0, dec) on the CPU from ``spec`` (config kwargs and
    state dicts)."""
    from alivevc_tpu_torch import config as tc
    from alivevc_tpu_torch.models.content_encoder import ContentEncoder
    from alivevc_tpu_torch.models.decoder import Decoder
    from alivevc_tpu_torch.models.f0_estimator import F0Estimator

    ce = ContentEncoder(tc.ContentEncoderConfig(**spec["ce_kw"]))
    f0 = F0Estimator(tc.F0EstimatorConfig(**spec["f0_kw"]))
    dec = Decoder(tc.DecoderConfig(**spec["dec_kw"]))
    for m, key in ((ce, "ce"), (f0, "f0"), (dec, "dec")):
        m.load_state_dict(spec[key])
        m.eval().requires_grad_(False)
    return ce, f0, dec


def run_rank(rank: int, world: int, tmp: str) -> None:
    """Rank ``rank`` of ``world``: reads ``tmp/inputs.pt``, writes
    ``tmp/rank<rank>.pt``."""
    from alivevc_tpu_torch.parallel import (
        convert_windows_distributed,
        init_distributed,
        make_mesh,
        pad_library_for_sharding,
        replicate,
        shard_along,
        sharded_match_features,
    )

    torch.set_num_threads(1)
    spec = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
    init_distributed("gloo", f"file://{tmp}/rendezvous", world, rank)
    try:
        out = {}
        lib_mesh = make_mesh([("library", world)], "cpu")
        for name, (src, lib) in spec["knn_cases"].items():
            lib_p, valid = pad_library_for_sharding(torch.from_numpy(lib), world)
            for precision in ("highest", "high", "default"):
                matched, idx = sharded_match_features(
                    lib_mesh, torch.from_numpy(src), lib_p, valid, k=4,
                    precision=precision, return_indices=True)
                out[(name, precision)] = (matched.numpy(), idx.numpy())

        mesh = make_mesh([("data", 2), ("library", world // 2)], "cpu")
        ce, f0m, dec = models(spec)
        # replicate: every rank ends with rank 0's parameters
        probe = torch.nn.Linear(3, 2)
        torch.nn.init.constant_(probe.weight, float(rank))
        replicate(probe, mesh)
        out["replicated"] = float(probe.weight.detach().abs().max())
        out["data_shard"] = shard_along(torch.arange(8), mesh, "data").tolist()
        out["vc"] = convert_windows_distributed(
            mesh, ce, f0m, dec, spec["windows"], spec["library"], **spec["vc_kw"],
            device="cpu").numpy()
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_halo_rank(rank: int, world: int, tmp: str) -> None:
    """Rank ``rank`` of ``world`` on a ('data', world) mesh: the halo models
    on this rank's slice of the time axis (``tmp/halo_inputs.pt``), the
    slices gathered back; writes ``tmp/halo<world>_rank<rank>.pt``."""
    from alivevc_tpu_torch.parallel import (
        content_encoder_sharded,
        f0_estimator_sharded,
        feature_extractor_sharded,
        gather_time,
        halo_pad,
        init_distributed,
        make_mesh,
        shard_along,
        sharded_frame_model,
    )
    from alivevc_tpu_torch.parallel.halo import time_axis

    torch.set_num_threads(1)
    spec = torch.load(os.path.join(tmp, "halo_inputs.pt"), weights_only=False)
    init_distributed("gloo", f"file://{tmp}/halo_rendezvous{world}", world, rank)
    try:
        mesh = make_mesh([("data", world)], "cpu")
        ce, f0m, dec = models(spec)
        fe = dec.feature_extractor
        x, content, f0 = (shard_along(torch.from_numpy(spec[k]), mesh, "data")
                          for k in ("spec", "content", "f0_hz"))
        out = {
            "ce": sharded_frame_model(mesh, lambda s, ax: content_encoder_sharded(ce, s, ax), x),
            "f0": sharded_frame_model(mesh, lambda s, ax: f0_estimator_sharded(f0m, s, ax), x),
            "fe": sharded_frame_model(
                mesh, lambda cf, ax: feature_extractor_sharded(fe, cf[:, :-1], cf[:, -1:], ax),
                torch.cat([content, f0], dim=1)),
        }
        res = {k: gather_time(mesh, v).numpy() for k, v in out.items()}
        ramp = torch.arange(4 * 2, dtype=torch.float32).reshape(4, 2) + 100 * rank
        res["halo_pad"] = halo_pad(ramp, 3, time_axis(mesh, "data")).numpy()
        torch.save(res, os.path.join(tmp, f"halo{world}_rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
