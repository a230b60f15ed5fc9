"""The HiFi-GAN ResBlock1 conv (``kernels/hifigan.py``) on the CPU: its plain
version against the composition ``models/hifigan.py`` ran before the conv
took its leaky ReLU, residual and stack sum in (frozen below), bit for bit
at every (C, taps, dilation) the vocoder's configuration has and in each
epilogue form; the whole ``hifigan`` bit for bit against the frozen
generator; the TF32 hi/lo split of the weights, its cache, and the
kernel's launch plan at the benchmark cell's shapes.  The kernel itself
runs on the card (``tests/test_torch_port_gpu.py``)."""

import pytest
import torch
import torch.nn.functional as F

from alivevc_tpu_torch.config import HiFiGANConfig
from alivevc_tpu_torch.kernels import hifigan as kh
from alivevc_tpu_torch.models.hifigan import HiFiGAN, hifigan

torch.set_num_threads(1)

CFG = HiFiGANConfig()
SLOPE = CFG.lrelu_slope
STAGE_CHANNELS = tuple(CFG.upsample_initial_channel >> (i + 1) for i in range(len(CFG.upsample_rates)))
CONVS = [(c, k, d) for c in STAGE_CHANNELS for k, dils in zip(CFG.resblock_kernel_sizes, CFG.resblock_dilation_sizes)
         for d in dils]
FORMS = ("plain", "residual", "stack_first", "stack_middle", "stack_last")
SMS = 132   # an H100 SXM's multiprocessors


def _frozen_conv(conv_w, conv_b, x, dilation):
    k = conv_w.shape[-1]
    return F.conv1d(x, conv_w, conv_b, padding=(k * dilation - dilation) // 2, dilation=dilation)


def frozen_hifigan(m: HiFiGAN, feats: torch.Tensor) -> torch.Tensor:
    """``models/hifigan.py:hifigan`` as it was before its ResBlocks ran
    channels last through ``hifigan_conv``: channels first, each pair
    x + c2(leaky(c1(leaky(x)))), the stacks summed, then / 3."""
    cfg = m.cfg
    slope, kernels = cfg.lrelu_slope, len(cfg.resblock_kernel_sizes)

    def conv(c, x):
        return F.conv1d(x, c.weight, c.bias, padding=c.padding, dilation=c.dilation)

    def resblock(b, x):
        for c1, c2 in zip(b.convs1, b.convs2):
            x = x + conv(c2, F.leaky_relu(conv(c1, F.leaky_relu(x, slope)), slope))
        return x

    x = conv(m.conv_pre, m.lin_pre(feats).transpose(1, 2))
    for i, up in enumerate(m.ups):
        x = F.conv_transpose1d(F.leaky_relu(x, slope), up.weight, up.bias, stride=up.stride, padding=up.padding)
        blocks = m.resblocks[i * kernels:(i + 1) * kernels]
        xs = resblock(blocks[0], x)
        for b in blocks[1:]:
            xs = xs + resblock(b, x)
        x = xs / kernels
    return torch.tanh(conv(m.conv_post, F.leaky_relu(x)))[:, 0]


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("c,k,d", CONVS)
def test_plain_conv_is_the_frozen_composition_bit_for_bit(c, k, d, form):
    g = torch.Generator().manual_seed(c * 1000 + k * 10 + d)
    n, length = 2, 37
    x = torch.randn(n, c, length, generator=g)                     # channels first, as the frozen code holds it
    w = torch.randn(c, c, k, generator=g) / (k * c) ** 0.5
    b = 0.1 * torch.randn(c, generator=g)
    res = torch.randn(n, c, length, generator=g)
    acc = torch.randn(n, c, length, generator=g)
    y = _frozen_conv(w, b, F.leaky_relu(x, SLOPE), d)
    want = {"plain": y, "residual": res + y, "stack_first": res + y, "stack_middle": acc + (res + y),
            "stack_last": (acc + (res + y)) / 3}[form]
    stack = {"stack_first": (0, 3), "stack_middle": (1, 3), "stack_last": (2, 3)}.get(form)
    got = kh.hifigan_conv_plain(x.transpose(1, 2).contiguous(), w, b, d, SLOPE,
                                res=None if form == "plain" else res.transpose(1, 2),
                                acc=acc.transpose(1, 2), stack=stack)
    assert got.shape == (n, length, c)
    assert torch.equal(got, want.transpose(1, 2))
    if form in ("stack_middle", "stack_last"):       # the sum is taken in acc, as on the card
        assert got.data_ptr() == acc.data_ptr() and torch.equal(acc, want)


@pytest.mark.parametrize("n,frames,width", [(1, 9, 32), (2, 13, 64)])
def test_hifigan_on_the_cpu_is_the_frozen_generator_bit_for_bit(n, frames, width):
    torch.manual_seed(frames)
    m = HiFiGAN(HiFiGANConfig(input_channels=32, hidden_channels=16, upsample_initial_channel=width)).eval()
    feats = torch.randn(n, frames, 32)
    with torch.no_grad():
        got, want = hifigan(m, feats), frozen_hifigan(m, feats)
    assert got.shape == (n, frames * CFG.hop_length)
    assert torch.equal(got, want)


def test_tf32_split_sums_to_the_weight_and_rounds_ties_away():
    w = torch.randn(256, 11 * 256, generator=torch.Generator().manual_seed(3)) / 50
    hi, lo = kh.split_tf32(w)
    for plane in (hi, lo):                 # TF32 values: the low 13 mantissa bits are zero
        assert int((plane.view(torch.int32) & 0x1FFF).abs().max()) == 0
    # hi + lo is w to within the rounding of the rest to TF32: 2^-22 of |w|
    assert bool(((hi + lo - w).abs() <= 2.0 ** -22 * w.abs()).all())
    assert bool(((w - hi).abs() <= 2.0 ** -11 * w.abs()).all())
    ties = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 3 * 2.0 ** -11])
    assert kh.split_tf32(ties)[0].tolist() == [1 + 2.0 ** -10, -(1 + 2.0 ** -10), 1 + 2 * 2.0 ** -10]


def test_weight_planes_are_kept_until_the_weight_changes():
    conv = torch.nn.Conv1d(32, 32, 7, padding=9, dilation=3)
    hi, lo = kh.weight_planes(conv)
    want = kh.split_tf32(conv.weight.detach().permute(0, 2, 1).reshape(32, -1))
    assert hi.shape == (32, 7 * 32) and torch.equal(hi, want[0]) and torch.equal(lo, want[1])
    assert kh.weight_planes(conv)[0] is hi                            # kept
    with torch.no_grad():
        conv.weight.mul_(2.0)                                         # changed in place: split again
    hi2, lo2 = kh.weight_planes(conv)
    assert hi2 is not hi and torch.equal(hi2, 2 * hi) and torch.equal(lo2, 2 * lo)
    conv.weight = torch.nn.Parameter(conv.weight.detach() + 1)        # another tensor: split again
    assert torch.equal(kh.weight_planes(conv)[0],
                       kh.split_tf32(conv.weight.detach().permute(0, 2, 1).reshape(32, -1))[0])
    hi3 = kh.weight_planes(conv)[0]
    conv.weight.data = conv.weight.data - 1                           # other storage, as module.to swaps it
    assert torch.equal(kh.weight_planes(conv)[0], kh.split_tf32(conv.weight.detach().permute(0, 2, 1)
                                                                 .reshape(32, -1))[0])
    assert not torch.equal(kh.weight_planes(conv)[0], hi3)


@pytest.mark.parametrize("frames", [1, 80, 370, 1250])
def test_conv_plan_fits_the_card_at_the_cell_lengths(frames):
    """Every launch the vocoder makes for a file of ``frames`` frames (the
    cell's 1.6-25 s files give 80-1 250) takes a plan the kernel accepts:
    tn divides C, the tile's rows and halo fit one TMA box, the ring holds
    two steps."""
    length = frames
    for i, rate in enumerate(CFG.upsample_rates):
        length *= rate
        c = STAGE_CHANNELS[i]
        for k, dils in zip(CFG.resblock_kernel_sizes, CFG.resblock_dilation_sizes):
            for d in dils:
                tn, wgs, stages = kh.conv_plan(1, length, c, k, d, SMS)
                assert c % tn == 0 and tn in (32, 64, 128) and wgs in (1, 2)
                assert 64 * wgs + (k - 1) * d <= kh.MAX_ROWS
                assert 2 <= stages <= kh.MAX_STAGES
