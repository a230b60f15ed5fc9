"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests carry the ``gpu`` marker and skip on a host without CUDA.  The
machine with the card has no JAX, so this file imports only torch and the
port; run it there without the repo's conftest (which sets JAX up):

    python -m pytest tests/test_torch_port_gpu.py --noconftest -m gpu -q

Tolerances: STFT 1e-3 abs (float32 sums of 1280 products in another order);
kNN values 1e-4 abs (float32 sums of the mode's operand products), and with
the packed extraction 1e-4 too (a sum that rounds across a 128-ulp packing
step moves its key by 3.1e-5); oscillator 5e-3 abs (sinf/cosf rounding
grown by the Chebyshev recurrence), the same for the full-formant source
(float32 phase of up to ~500 cycles a frame); filter level 1e-3 abs in
float32.  The sharded path: 2 gloo ranks on one card against 1 rank,
identical 'highest' index sets and the waveform within 1e-4 (float32 sums
of the k rows split over the shards, in another order).
"""

import multiprocessing
import os

import numpy as np
import pytest
import torch

from alivevc_tpu_torch.config import DecoderConfig
from alivevc_tpu_torch.kernels import filter as kfilter
from alivevc_tpu_torch.kernels import knn as kknn
from alivevc_tpu_torch.kernels import oscillator as kosc
from alivevc_tpu_torch.kernels import stft as kstft
from alivevc_tpu_torch.models.decoder import Decoder, level_args


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["stft", "knn", "oscillator", "filter_level", "knn_exclusion",
                                  "knn_packed", "oscillator_formants"])
def test_kernel_matches_plain_on_card(name):
    """On the card: each kernel against its plain version at a small shape."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run this file with --noconftest -m gpu")
    # full float32 in the plain versions' products and convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    if name == "stft":
        x = 0.3 * torch.randn(2, 16_000, generator=g, device="cuda")
        assert max_err(kstft.stft_magnitude_cuda(x), kstft.stft_magnitude_plain(x)) <= 1e-3
    elif name == "knn":
        q = torch.randn(300, 768, generator=g, device="cuda")
        lib = torch.randn(5000, 768, generator=g, device="cuda")
        for precision in ("default", "high"):
            v, _ = kknn.knn_topk_cuda(q, lib, 4, precision)
            pv, _ = kknn.knn_topk_plain(q, lib, 4, precision)
            assert max_err(v, pv) <= 1e-4
    elif name == "knn_exclusion":
        q = torch.randn(300, 768, generator=g, device="cuda")
        lib = torch.randn(5000, 768, generator=g, device="cuda")
        pen = torch.where(torch.rand(5000, generator=g, device="cuda") < 0.3, -4.0, 0.0)
        vr = torch.tensor(4093, device="cuda")
        for precision in ("default", "high", "highest"):
            for kw in (dict(valid_rows=vr), dict(valid_rows=4093), dict(penalty=pen),
                       dict(valid_rows=3)):
                v, i = kknn.knn_topk_cuda(q, lib, 4, precision, **kw)
                pv, pi = kknn.knn_topk_plain(q, lib, 4, precision, **kw)
                assert max_err(v.nan_to_num(neginf=0), pv.nan_to_num(neginf=0)) <= 1e-4
                assert torch.equal(torch.isneginf(v), torch.isneginf(pv))
                if "valid_rows" in kw:
                    assert int(i[i != kknn.SENTINEL].max()) < int(kw["valid_rows"])
    elif name == "knn_packed":
        q = torch.randn(300, 768, generator=g, device="cuda")
        for rows in (512, 5000):
            lib = torch.randn(rows, 768, generator=g, device="cuda")
            v, _ = kknn.knn_topk_cuda(q, lib, 4, "default", extraction="packed")
            pv, _ = kknn.knn_topk_plain(q, lib, 4, "default", extraction="packed")
            assert max_err(v, pv) <= 1e-4
    elif name == "oscillator_formants":
        f0 = 80 + 300 * torch.rand(2, 50, 1, generator=g, device="cuda")
        formants = f0 * torch.arange(1, 65, device="cuda")
        amps = torch.exp(0.3 * torch.randn(2, 50, 64, generator=g, device="cuda"))
        got = kosc.harmonic_source_formants_cuda(formants, amps)
        assert max_err(got, kosc.harmonic_source_formants_plain(formants, amps)) <= 5e-3
        assert max_err(got, kosc.harmonic_source_cuda(f0, amps)) <= 5e-3
    elif name == "oscillator":
        f0 = 80 + 300 * torch.rand(2, 50, 1, generator=g, device="cuda")
        amps = torch.exp(0.3 * torch.randn(2, 50, 64, generator=g, device="cuda"))
        assert max_err(kosc.harmonic_source_cuda(f0, amps), kosc.harmonic_source_plain(f0, amps)) <= 5e-3
    else:
        dec = Decoder(DecoderConfig(), generator=torch.Generator().manual_seed(0)).cuda()
        x = 0.3 * torch.randn(2, 960, 16, generator=g, device="cuda")
        s = 0.3 * torch.randn(2, 960, 16, generator=g, device="cuda")
        cond = 0.5 * torch.randn(2, 6, 512, generator=g, device="cuda")
        args = level_args(dec.filter.blocks[3], dec.filter.ups[3], cond)
        with torch.no_grad():
            got = kfilter.filter_level_cuda(x, s, rate=2, **args)
            want = kfilter.filter_level_plain(x, s, rate=2, **args)
        assert max_err(got, want) <= 1e-3


def _sharded_run(world: int) -> dict:
    """The sharded path on a ('data', 1) x ('library', world) mesh at a small
    size: default model widths, 2 windows of 9 600 samples, 4 001 rows."""
    from alivevc_tpu_torch.config import ContentEncoderConfig, F0EstimatorConfig
    from alivevc_tpu_torch.infer.offline import float32_math
    from alivevc_tpu_torch.kernels import LAUNCHES, reset_launches
    from alivevc_tpu_torch.models.content_encoder import ContentEncoder, content_encoder
    from alivevc_tpu_torch.models.f0_estimator import F0Estimator
    from alivevc_tpu_torch.ops.stft import spectrogram
    from alivevc_tpu_torch.parallel import (
        convert_windows_distributed,
        make_mesh,
        pad_library_for_sharding,
        sharded_match_features,
    )

    g = torch.Generator().manual_seed(0)
    ce = ContentEncoder(ContentEncoderConfig(), generator=g).cuda().eval()
    f0m = F0Estimator(F0EstimatorConfig(), generator=g).cuda().eval()
    dec = Decoder(DecoderConfig(), generator=g).cuda().eval()
    lib = torch.randn(4001, 768, generator=torch.Generator(device="cuda").manual_seed(1), device="cuda")
    tt = np.arange(9600) / 16000.0
    windows = torch.from_numpy(np.stack([0.4 * np.sin(2 * np.pi * f * tt)
                                         for f in (120.0, 230.0)]).astype(np.float32)).cuda()
    mesh = make_mesh([("data", 1), ("library", world)], "cuda")
    reset_launches()
    wave = convert_windows_distributed(mesh, ce, f0m, dec, windows, lib, precision="highest")
    with float32_math():
        feat = content_encoder(ce, spectrogram(windows)).reshape(-1, 768)
    _, idx = sharded_match_features(mesh, feat, *pad_library_for_sharding(lib, world),
                                    return_indices=True)
    return {"wave": wave.cpu(), "idx": idx.cpu(), "launches": dict(LAUNCHES)}


def _sharded_rank(rank: int, world: int, tmp: str) -> None:
    import torch.distributed as dist

    from alivevc_tpu_torch.parallel import init_distributed

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_grad_enabled(False)
    init_distributed("gloo", f"file://{tmp}/rendezvous{world}", world, rank)
    try:
        torch.save(_sharded_run(world), os.path.join(tmp, f"w{world}r{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
def test_sharded_path_two_ranks_on_card(tmp_path):
    """convert_windows_distributed and sharded_match_features as 2 gloo ranks
    on one card against 1 rank; every rank launches the path's kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run this file with --noconftest -m gpu")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_sharded_rank, args=(r, w, str(tmp_path)))
             for w, r in ((2, 0), (2, 1), (1, 0))]
    for p in procs:
        p.start()
    for p in procs:
        p.join(300)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
    assert not alive and all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    two, two_b, one = (torch.load(tmp_path / f, weights_only=False)
                       for f in ("w2r0.pt", "w2r1.pt", "w1r0.pt"))
    assert torch.equal(two["wave"], two_b["wave"]) and torch.equal(two["idx"], two_b["idx"])
    assert torch.equal(torch.sort(two["idx"], 1).values, torch.sort(one["idx"], 1).values)
    assert max_err(two["wave"], one["wave"]) <= 1e-4
    for res in (two, two_b, one):
        assert all(res["launches"][k] > 0 for k in ("knn", "oscillator", "filter_level")), res["launches"]
