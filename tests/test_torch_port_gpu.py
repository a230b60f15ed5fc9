"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests carry the ``gpu`` marker and skip on a host without CUDA.  The
machine with the card has no JAX, so this file imports only torch and the
port; run it there without the repo's conftest (which sets JAX up):

    python -m pytest tests/test_torch_port_gpu.py --noconftest -m gpu -q

Tolerances: STFT 1e-3 abs (float32 sums of 1280 products in another order);
kNN values 1e-4 abs (float32 sums of the mode's operand products);
oscillator 5e-3 abs (sinf/cosf rounding grown by the Chebyshev recurrence);
filter level 1e-3 abs in float32.
"""

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
@pytest.mark.parametrize("name", ["stft", "knn", "oscillator", "filter_level"])
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
