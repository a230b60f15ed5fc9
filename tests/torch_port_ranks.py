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


def train_models(spec, disc_kw):
    """The port's (ce, f0, dec, disc, vl) from ``spec``'s state dicts, the
    discriminator at ``disc_kw`` (its state dict filtered to those keys)."""
    from alivevc_tpu_torch import config as tc
    from alivevc_tpu_torch.models.discriminator import Discriminator
    from alivevc_tpu_torch.models.voice_library import VoiceLibrary

    ce, f0m, dec = models(spec)
    disc = Discriminator(tc.DiscriminatorConfig(**disc_kw))
    disc.load_state_dict({k: v for k, v in spec["disc"].items() if k in disc.state_dict()})
    vl = VoiceLibrary(tc.VoiceLibraryConfig(**spec["vl_kw"]))
    vl.load_state_dict(spec["vl"])
    return ce, f0m, dec, disc, vl


def run_train_rank(rank: int, world: int, tmp: str) -> None:
    """Rank ``rank`` of the training steps under a process group: this
    rank's slice of ``tmp/train_inputs.pt``'s batches through ``gan_grads``
    (with and without the MRD), ``gan_train_step``, ``fine_tune_step`` and
    ``f0_train_step``; writes ``tmp/train_rank<rank>.pt``."""
    from alivevc_tpu_torch.parallel import init_distributed
    from alivevc_tpu_torch.train import dp
    from alivevc_tpu_torch.train.f0 import f0_train_step, init_f0_train
    from alivevc_tpu_torch.train.fine_tune import fine_tune_step, init_fine_tune
    from alivevc_tpu_torch.train.gan import gan_grads, gan_train_step, init_gan

    torch.set_num_threads(1)
    spec = torch.load(os.path.join(tmp, "train_inputs.pt"), weights_only=False)
    init_distributed("gloo", f"file://{tmp}/train_rendezvous", world, rank)
    group = dist.group.WORLD
    try:
        mine = lambda x: dp.my_rows(x, group)  # noqa: E731
        out = {"roll": dp.global_roll(mine(torch.arange(8.0)[:, None]), group)}
        wave, amp, jitter = spec["wave"], spec["amp"], spec["jitter"]
        for name, disc_kw in (("mpd", spec["mpd_kw"]), ("mrd", spec["disc_kw"])):
            ce, f0m, dec, disc, _ = train_models(spec, disc_kw)
            state = init_gan(dec, disc)
            out[f"gan_{name}"] = gan_grads(state, ce, f0m, mine(wave), mine(amp), jitter,
                                           group=group)
        ce, f0m, dec, disc, vl = train_models(spec, spec["mpd_kw"])
        state = init_gan(dec, disc)
        gan_train_step(state, ce, f0m, mine(wave), mine(amp), jitter, group=group)
        out["gan_step"] = {k: v.clone() for k, v in state.dec.state_dict().items()}
        ce, f0m, dec, disc, vl = train_models(spec, spec["mpd_kw"])
        state = init_fine_tune(dec, disc, vl)
        out["fine_tune_metrics"] = fine_tune_step(state, ce, f0m, mine(wave), mine(amp),
                                                  group=group)
        out["fine_tune"] = {"dec": state.dec.state_dict(), "vl": state.vl.state_dict()}
        state = init_f0_train(f0m)
        out["f0_metrics"] = f0_train_step(state, mine(spec["f0_wave"]), mine(spec["f0_hz"]),
                                          mine(spec["f0_amp"]), group)
        out["f0"] = state.model.state_dict()
        torch.save(out, os.path.join(tmp, f"train_rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def train_states(spec, group):
    """Two steps of each trainer on ``spec``'s whole batch under ``group``
    (None: this process alone): {trainer: (the state's tensors, the
    step count)}."""
    from alivevc_tpu_torch import config as tc
    from alivevc_tpu_torch.models.content_encoder import ContentEncoder
    from alivevc_tpu_torch.train import distill, f0, fine_tune, gan

    def tensors(*modules_and_opts):
        out = {}
        for i, x in enumerate(modules_and_opts):
            if isinstance(x, torch.optim.Optimizer):
                for j, st in enumerate(x.state.values()):
                    out.update({f"{i}.{j}.{k}": torch.as_tensor(v).clone()
                                for k, v in st.items()})
            else:
                out.update({f"{i}.{k}": v.clone() for k, v in x.state_dict().items()})
        return out

    wave, amp, jitter = spec["wave"], spec["amp"], spec["jitter"]
    got = {}
    ce, f0m, dec, disc, _ = train_models(spec, spec["disc_kw"])
    st = gan.init_gan(dec, disc)
    for _ in range(2):
        gan.gan_train_step(st, ce, f0m, wave, amp, jitter, group=group)
    got["gan"] = (tensors(st.dec, st.disc, st.opt_g, st.opt_d), st.step)
    ce, f0m, dec, disc, vl = train_models(spec, spec["mpd_kw"])
    st = fine_tune.init_fine_tune(dec, disc, vl)
    for _ in range(2):
        fine_tune.fine_tune_step(st, ce, f0m, wave, amp, group=group)
    got["fine_tune"] = (tensors(st.dec, st.disc, st.vl, st.opt_g, st.opt_d, st.opt_vl), st.step)
    st = f0.init_f0_train(f0m)
    for _ in range(2):
        f0.f0_train_step(st, spec["f0_wave"], spec["f0_hz"], spec["f0_amp"], group)
    got["f0"] = (tensors(st.model, st.opt), st.step)
    student = ContentEncoder(tc.ContentEncoderConfig(**spec["ce_kw"]))
    student.load_state_dict(spec["ce"])
    st = distill.init_distill(student)
    teacher = spec["teacher"]
    for _ in range(2):
        distill.distill_step(st, spec["f0_wave"], teacher, group)
    got["distill"] = (tensors(st.model, st.opt), st.step)
    return got


def run_one_rank(tmp: str) -> None:
    """Each trainer's two steps alone (``group=None``) and inside a gloo
    group of one rank, from ``tmp/train_inputs.pt``; writes
    ``tmp/one_rank.pt`` {'alone': ..., 'group': ...}."""
    from alivevc_tpu_torch.parallel import init_distributed

    torch.set_num_threads(1)
    spec = torch.load(os.path.join(tmp, "train_inputs.pt"), weights_only=False)
    out = {"alone": train_states(spec, None)}
    init_distributed("gloo", f"file://{tmp}/one_rank_rendezvous", 1, 0)
    try:
        out["group"] = train_states(spec, dist.group.WORLD)
        torch.save(out, os.path.join(tmp, "one_rank.pt"))
    finally:
        dist.destroy_process_group()


def run_distill_rank(rank: int, world: int, tmp: str) -> None:
    """Rank ``rank`` of the data-parallel distillation step: this rank's
    slice of ``tmp/distill_inputs.pt``'s batch through ``distill_grads``,
    then ``distill_step`` twice, under the process group; writes ``tmp/distill_rank<rank>.pt`` (the
    gradients, the losses, and the parameters after each step)."""
    from alivevc_tpu_torch import config as tc
    from alivevc_tpu_torch.models.content_encoder import ContentEncoder
    from alivevc_tpu_torch.parallel import init_distributed
    from alivevc_tpu_torch.train.distill import distill_grads, distill_step, init_distill

    torch.set_num_threads(1)
    spec = torch.load(os.path.join(tmp, "distill_inputs.pt"), weights_only=False)
    init_distributed("gloo", f"file://{tmp}/distill_rendezvous", world, rank)
    try:
        ce = ContentEncoder(tc.ContentEncoderConfig(**spec["ce_kw"]))
        ce.load_state_dict(spec["ce"])
        state = init_distill(ce)
        per = spec["wave"].shape[0] // world
        mine = slice(rank * per, (rank + 1) * per)
        group = dist.group.WORLD
        out = {"grads": distill_grads(state, spec["wave"][mine], spec["teacher"][mine], group),
               "loss": [], "params": []}
        for _ in range(2):
            out["loss"].append(distill_step(state, spec["wave"][mine], spec["teacher"][mine],
                                            group)["loss"])
            out["params"].append({k: v.clone() for k, v in state.model.state_dict().items()})
        torch.save(out, os.path.join(tmp, f"distill_rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
