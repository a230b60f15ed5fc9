"""The training steps under a process group (``gan_grads``,
``gan_train_step``, ``fine_tune_step``, ``f0_train_step``, each given the
group) on 2 spawned gloo ranks (``tests/torch_port_ranks.py:
run_train_rank``, no JAX in the workers), against the same steps alone
(``group=None``) on the whole batch with the same draws, computed here
while the ranks work.

What each holds to:
  * the roll crosses ranks: rank j's first row is rank j-1's last;
  * GAN with a periods-only discriminator (every loss term a batch mean):
    the averaged gradients equal the dense step's, 1e-5 of each tensor's
    largest entry (float32 sums over half batches, then averaged);
  * GAN with the MRD: its feature term is a sum over the batch (the
    reference's quirk), so, as with the JAX package's pmean, the gradients
    equal the mean over ranks of each rank's dense gradients (with the
    cross-rank roll), 1e-5; every metric but 'feat' equals the dense
    step's (1e-5 relative);
  * the GAN and fine-tuning updates: every rank holds the same parameters
    after the step, within 2.5 lr of the dense step's (AdamW's first step
    is about lr * sign(g): a gradient entry near 0 may differ in sign), and
    entries more than lr / 2 apart at most 0.5 % of all;
  * the F0 step, with the voiced frames spread unevenly over the ranks:
    loss 1e-6 relative and parameters 1e-7 abs of the dense step's (both
    parts of the cross entropy are summed before the division);
  * in a gloo group of one rank (``run_one_rank``), two steps of each
    trainer (GAN, fine-tuning, F0, distillation) leave the parameters, the
    optimizer moments and the step count bit-equal to two steps alone: the
    collectives of one rank are exact.
"""

import copy
import multiprocessing
import os

import numpy as np
import pytest
import torch

from alivevc_tpu_torch import config as tc
from alivevc_tpu_torch.models.discriminator import Discriminator
from alivevc_tpu_torch.models.voice_library import VoiceLibrary
from alivevc_tpu_torch.train import f0 as tf0
from alivevc_tpu_torch.train import fine_tune as tft
from alivevc_tpu_torch.train import gan as tgan

import torch_port_ranks
from test_torch_port_util import CE_KW, DEC_KW, DISC_KW, F0_KW, n, t, train_models, train_wave

WORLD = 2
JOIN_S = 120
LR = 1e-4
MPD_KW = {**DISC_KW, "resolutions": ()}
VL_KW = dict(num_tokens=64, dim=DEC_KW["content_channels"])


def _disc(disc, kw):
    m = Discriminator(tc.DiscriminatorConfig(**kw))
    m.load_state_dict({k: v for k, v in disc.state_dict().items() if k in m.state_dict()})
    return m


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """(the directory of ``train_inputs.pt``, (ce, f0m, dec, disc, vl), the
    inputs it holds)."""
    tmp = str(tmp_path_factory.mktemp("train_ranks"))
    _, (ce, f0m, dec, disc) = train_models(0)
    vl = VoiceLibrary(tc.VoiceLibraryConfig(**VL_KW), generator=torch.Generator().manual_seed(3))
    g = torch.Generator().manual_seed(4)
    wave = t(train_wave(4, 9600, seed=5))
    amp, jitter = tgan.gan_draws(4, g, "cpu")
    f0_wave = t(train_wave(4, 6400, seed=6))
    f0 = 60.0 + 240.0 * torch.rand(4, 20, generator=g)
    f0[2:, 3:15] = 0.0                          # rank 1 holds fewer voiced frames
    f0_amp = tf0.f0_amp_draws(4, g, "cpu")
    teacher = 0.1 * torch.randn(4, 20, CE_KW["output_channels"], generator=g)
    spec = {"ce_kw": CE_KW, "f0_kw": F0_KW, "dec_kw": DEC_KW, "disc_kw": DISC_KW, "mpd_kw": MPD_KW,
            "vl_kw": VL_KW, "ce": ce.state_dict(), "f0": f0m.state_dict(), "dec": dec.state_dict(),
            "disc": disc.state_dict(), "vl": vl.state_dict(), "wave": wave, "amp": amp,
            "jitter": jitter, "f0_wave": f0_wave, "f0_hz": f0, "f0_amp": f0_amp,
            "teacher": teacher}
    torch.save(spec, os.path.join(tmp, "train_inputs.pt"))
    return tmp, (ce, f0m, dec, disc, vl), spec


@pytest.fixture(scope="module")
def runs(inputs):
    tmp, (ce, f0m, dec, disc, vl), spec = inputs
    wave, amp, jitter = spec["wave"], spec["amp"], spec["jitter"]
    f0_wave, f0, f0_amp = spec["f0_wave"], spec["f0_hz"], spec["f0_amp"]
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=torch_port_ranks.run_train_rank, args=(r, WORLD, tmp))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    try:      # the dense references, while the ranks work
        want = {}
        st = tgan.init_gan(copy.deepcopy(dec), _disc(disc, MPD_KW))
        want["gan_mpd"] = tgan.gan_grads(st, ce, f0m, wave, amp, jitter)
        tgan.apply_updates(st, *want["gan_mpd"][:2])
        want["gan_step"] = st.dec.state_dict()
        st = tgan.init_gan(copy.deepcopy(dec), copy.deepcopy(disc))
        want["gan_mrd"] = tgan.gan_grads(st, ce, f0m, wave, amp, jitter)
        content, _ = tgan.frozen_features(ce, f0m, wave * amp)
        shards = []
        for j in range(WORLD):
            prev = content[(2 * j - 1) % 4:(2 * j - 1) % 4 + 1]
            roll = lambda c, prev=prev: torch.cat([prev, c[:-1]])  # noqa: E731
            shards.append(tgan.gan_grads(st, ce, f0m, wave[2 * j:2 * j + 2], amp[2 * j:2 * j + 2],
                                         jitter, roll=roll))
        want["gan_mrd_shards"] = shards
        ft = tft.init_fine_tune(copy.deepcopy(dec), _disc(disc, MPD_KW), copy.deepcopy(vl))
        want["fine_tune_metrics"] = tft.fine_tune_step(ft, ce, f0m, wave, amp)
        want["fine_tune"] = {"dec": ft.dec.state_dict(), "vl": ft.vl.state_dict()}
        fs = tf0.init_f0_train(copy.deepcopy(f0m))
        want["f0_metrics"] = tf0.f0_train_step(fs, f0_wave, f0, f0_amp)
        want["f0"] = fs.model.state_dict()
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
    got = [torch.load(os.path.join(tmp, f"train_rank{r}.pt"), weights_only=False)
           for r in range(WORLD)]
    return got, want


@pytest.fixture(scope="module")
def one_rank(inputs):
    tmp, _, _ = inputs
    p = multiprocessing.get_context("spawn").Process(target=torch_port_ranks.run_one_rank,
                                                    args=(tmp,))
    p.start()
    p.join(JOIN_S)
    if p.is_alive():
        p.kill()
        p.join(10)
    assert p.exitcode == 0, p.exitcode
    return torch.load(os.path.join(tmp, "one_rank.pt"), weights_only=False)


def _close(got, want, tol):
    for a, b in zip(got, want):
        assert np.abs(n(a) - n(b)).max() <= tol * max(np.abs(n(b)).max(), 1e-30)


def _after_step(got: dict, want: dict):
    moved, total = 0, 0
    for k, v in want.items():
        diff = np.abs(n(got[k]) - n(v))
        assert diff.max() <= 2.5 * LR, (k, diff.max())
        moved += int((diff > 0.5 * LR).sum())
        total += diff.size
    assert moved <= 0.005 * total, (moved, total)


def test_roll_crosses_ranks(runs):
    got, _ = runs
    assert [n(g["roll"])[:, 0].tolist() for g in got] == [[7.0, 0.0, 1.0, 2.0], [3.0, 4.0, 5.0, 6.0]]


def test_dp_gan_grads_equal_dense(runs):
    got, want = runs
    gg, gd, wm = want["gan_mpd"]
    for g in got:
        dg, dd, dm = g["gan_mpd"]
        _close(dg, gg, 1e-5)
        _close(dd, gd, 1e-5)
        for k, v in wm.items():
            assert abs(float(dm[k]) - float(v)) <= 1e-5 * abs(float(v)), k


def test_dp_gan_grads_with_mrd_are_the_mean_of_rank_gradients(runs):
    got, want = runs
    shards = want["gan_mrd_shards"]
    mean_g = [(a + b) / 2 for a, b in zip(shards[0][0], shards[1][0])]
    mean_d = [(a + b) / 2 for a, b in zip(shards[0][1], shards[1][1])]
    dense_m = want["gan_mrd"][2]
    for g in got:
        dg, dd, dm = g["gan_mrd"]
        _close(dg, mean_g, 1e-5)
        _close(dd, mean_d, 1e-5)
        for k in ("loss_d", "mel", "con", "adv"):
            assert abs(float(dm[k]) - float(dense_m[k])) <= 1e-5 * abs(float(dense_m[k])), k
        feat = (float(shards[0][2]["feat"]) + float(shards[1][2]["feat"])) / 2
        assert abs(float(dm["feat"]) - feat) <= 1e-5 * feat


def test_dp_gan_and_fine_tune_steps_update_like_dense(runs):
    got, want = runs
    for g in got:
        assert all(torch.equal(v, got[0]["gan_step"][k]) for k, v in g["gan_step"].items())
        _after_step(g["gan_step"], want["gan_step"])
        for part in ("dec", "vl"):
            _after_step(g["fine_tune"][part], want["fine_tune"][part])
        for k, v in want["fine_tune_metrics"].items():
            assert abs(float(g["fine_tune_metrics"][k]) - float(v)) <= 1e-5 * max(abs(float(v)), 1e-6), k


def test_dp_f0_step_equals_dense(runs):
    got, want = runs
    for g in got:
        loss = float(want["f0_metrics"]["loss"])
        assert abs(float(g["f0_metrics"]["loss"]) - loss) <= 1e-6 * loss
        for k, v in want["f0"].items():
            assert np.abs(n(g["f0"][k]) - n(v)).max() <= 1e-7, k


@pytest.mark.parametrize("trainer", ["gan", "fine_tune", "f0", "distill"])
def test_one_rank_group_equals_alone(one_rank, trainer):
    alone, alone_step = one_rank["alone"][trainer]
    grouped, grouped_step = one_rank["group"][trainer]
    assert grouped_step == alone_step == 2
    assert alone.keys() == grouped.keys()
    for k, v in alone.items():
        assert torch.equal(grouped[k], v), k
