"""Harmonic sources: CUDA kernels (``csrc/oscillator.cu``) and their plain
PyTorch versions.

``harmonic_source`` replaces
``alivevc_tpu/kernels/oscillator_pallas.py:harmonic_source_cheb_pallas``:
the decoder's offline oscillator (phi = 0, crop = (0, -1)) with formants
exactly f0 * (1..NH).  Sample r of frame q mixes frames (q-1, q, q+1) with
the x``seg`` linear-interpolation weights (align_corners=False); the phase
inside a frame is the same mix with the prefix-summed weights, and the base
phase of a frame is the sum of the earlier frames' totals, taken in float64
and wrapped mod 1.

``harmonic_source_formants`` replaces ``oscillator_pallas.py:harmonic_source_pallas``:
the same source over any formants [N, Lf, NH] (not necessarily f0
multiples), each harmonic with its own phase by the same closed form and a
float64 base per frame wrapped mod 1 (the JAX kernel carries it unwrapped
in float32).  It is reached through the kernel API, not the decoder.

Both sources run in the two-frame form (``two_frame_split``: a sample mixes
only two frames) from each frame's wrapped float64 base phase
(``phase_offsets``).  A Chebyshev call is one launch, whose blocks sum
their own base phases; a formant call launches the phase scan and then the
source, and nothing else.  The interpolation tables live on the card,
cached per device, and 1 / sample rate is a kernel argument, so a call
copies nothing between host and device and never waits on the stream.
``harmonic_source_replay`` and ``harmonic_source_formants_replay`` repeat
the kernels' arithmetic in PyTorch, for the tests.

``harmonic_source_stream`` is the streaming source (a carried phase phi,
the phase re-zeroed at sample ``crop0``), which the streaming hop runs
through the decoder: per harmonic the float32 running sum of its
frequency in time order, as ``torch.cumsum`` takes it on the card (the
plain version, ``harmonic_source_stream_plain``, is module/decoder.py's
oscillator).  It replaces no Pallas kernel: the JAX package's streaming
source is plain ``jnp.cumsum`` (alivevc_tpu/models/decoder.py:139).  Its
call launches the chain and then the source; ``harmonic_source_stream_replay``
repeats its arithmetic with the chain as an explicit float32 sequential sum
(``torch.cumsum`` on the CPU sums float32 in float64).

Gradients (training): ``harmonic_source`` on the card runs through
``HarmonicSourceFunction``: the forward is the Chebyshev kernel, the
backward differentiates ``harmonic_source_plain`` recomputed on the saved
f0 and amplitudes.  The formant and streaming sources have no backward,
and their launches raise on an input that requires grad in grad mode.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Tuple

import numpy as np
import torch

from alivevc_tpu_torch.device import cached
from alivevc_tpu_torch.kernels import _lib
from alivevc_tpu_torch.ops.interp import linear_interpolate, upsample_weights_np

NH_MAX = 256      # harmonics the kernels hold in shared memory
SEG_MAX = 1024    # samples a frame
AMP_DTYPES = (torch.float32, torch.bfloat16)   # amplitudes the kernels read as they are
_DEVICE_TABLES: Dict[Tuple[int, int], torch.Tensor] = {}


@functools.lru_cache(maxsize=None)
def interp_weights_np(seg: int):
    """(w [3, seg], ws [3, seg]): interpolation weights of frames
    (q-1, q, q+1) and their inclusive prefix sums along the segment."""
    w = np.stack(upsample_weights_np(seg)).astype(np.float32)
    return w, np.cumsum(w, axis=1).astype(np.float32)


def _tables(seg: int, device):
    w, ws = interp_weights_np(seg)
    return torch.from_numpy(w).to(device), torch.from_numpy(ws).to(device)


def _device_table(seg: int, t: torch.Tensor) -> torch.Tensor:
    """[6, seg] float32 on ``t``'s card, w then ws, cached per card.  The
    first call copies it from pinned host memory without a stream wait
    (``device.cached``)."""
    def make():
        host = torch.from_numpy(np.concatenate(interp_weights_np(seg))).pin_memory()
        return host.to(t.device, non_blocking=True)

    return cached(_DEVICE_TABLES, (seg, t.get_device()), make)


@functools.lru_cache(maxsize=None)
def inv_rate(sample_rate: int) -> float:
    """1 / sample_rate rounded to float32: on the card PyTorch divides a
    float32 tensor by a Python number as a product by this value, so the
    kernels' f = Hz * inv_rate equals the plain version's f there."""
    return float(np.float32(1.0) / np.float32(sample_rate))


def _edge(x: torch.Tensor) -> torch.Tensor:
    """Pad one frame on each side of axis 1 by edge replication."""
    return torch.cat([x[:, :1], x, x[:, -1:]], dim=1)


def harmonic_source_plain(f0: torch.Tensor, amps: torch.Tensor, sample_rate: int = 16_000,
                          seg: int = 320) -> torch.Tensor:
    """f0 [N, Lf] or [N, Lf, 1] Hz, amps [N, Lf, NH] -> [N, Lf*seg, 1] float32."""
    if f0.dim() == 3:
        f0 = f0[..., 0]
    n, lf = f0.shape
    nh = amps.shape[-1]
    w, ws = _tables(seg, f0.device)
    fp = _edge((f0.float() / sample_rate)[..., None])              # [N, Lf+2, 1]
    cseg = fp[:, :-2] * ws[0] + fp[:, 1:-1] * ws[1] + fp[:, 2:] * ws[2]   # [N, Lf, seg]
    tot = cseg[:, :, -1].double()
    o = (torch.cumsum(tot, dim=1) - tot) - cseg[:, :1, 0].double()
    off = (o - torch.floor(o)).float()
    theta = (2.0 * math.pi) * (cseg + off[..., None])
    s1 = torch.sin(theta)
    twoc = 2.0 * torch.cos(theta)
    ap = _edge(amps.float())
    a0, a1, a2 = ap[:, :-2], ap[:, 1:-1], ap[:, 2:]

    def amp(k):
        return a0[..., k:k + 1] * w[0] + a1[..., k:k + 1] * w[1] + a2[..., k:k + 1] * w[2]

    acc = s1 * amp(0)
    s_km2, s_km1 = torch.zeros_like(s1), s1
    for k in range(1, nh):
        s_k = twoc * s_km1 - s_km2
        acc = acc + s_k * amp(k)
        s_km2, s_km1 = s_km1, s_k
    return (acc / nh).reshape(n, lf * seg, 1)


def _operands(f: torch.Tensor, amps: torch.Tensor, h: int, seg: int):
    """Check the shapes and types; returns (f, amps) as the kernels read
    them: float32 frequencies and float32 or bf16 amplitudes, contiguous.
    Nothing is converted or copied that is already so (each PyTorch call
    costs host time before the launch)."""
    if f.dtype != torch.float32:
        f = f.float()
    if not f.is_contiguous():
        f = f.contiguous()
    a = amps if amps.dtype in AMP_DTYPES else amps.float()
    if not a.is_contiguous():
        a = a.contiguous()
    _lib.require(f, "frequencies", (torch.float32,), f.dim())
    _lib.require(a, "amps", AMP_DTYPES, 3)
    n, lf, nh = a.shape
    if f.shape[:2] != (n, lf) or f.numel() != n * lf * h or not 1 <= nh <= NH_MAX:
        raise ValueError(f"amps {tuple(a.shape)} does not match {tuple(f.shape)} (NH <= {NH_MAX})")
    if n < 1 or lf < 1 or not 1 <= seg <= SEG_MAX:
        raise ValueError(f"{tuple(f.shape)} with seg={seg}: need N, Lf >= 1 and seg <= {SEG_MAX}")
    return f, a


def harmonic_source_cuda(f0: torch.Tensor, amps: torch.Tensor, sample_rate: int = 16_000,
                         seg: int = 320) -> torch.Tensor:
    """The kernel launch: f0 [N, Lf] or [N, Lf, 1] Hz and amps [N, Lf, NH]
    (float32 or bf16, read as they are) on the card.  One launch of
    ``osc_cheb_kernel``, which computes its frames' base phases itself."""
    _lib.refuse_grad("harmonic_source_cuda", f0, amps)
    if f0.dim() not in (2, 3) or f0.dim() == 3 and f0.shape[2] != 1:
        raise ValueError(f"f0 must be [N, Lf] or [N, Lf, 1], got {tuple(f0.shape)}")
    f, a = _operands(f0, amps, 1, seg)
    n, lf, nh = a.shape
    out = torch.empty((n, lf * seg, 1), dtype=torch.float32, device=f.device)
    rc = _lib.function("oscillator", "osc_cheb", "ppippiiiifp")(
        f.data_ptr(), a.data_ptr(), a.dtype == torch.bfloat16, _device_table(seg, f).data_ptr(),
        out.data_ptr(), n, lf, nh, seg, inv_rate(sample_rate), _lib.stream_of(f))
    _lib.check(rc, "osc_cheb")
    _lib.LAUNCHES["oscillator"] += 1
    return out


class HarmonicSourceFunction(torch.autograd.Function):
    """The Chebyshev source on the card with a gradient: forward = the
    kernel, backward = autograd of ``harmonic_source_plain`` recomputed on
    the saved f0 and amplitudes."""

    @staticmethod
    def forward(ctx, f0, amps, sample_rate, seg):
        ctx.sample_rate, ctx.seg = sample_rate, seg
        ctx.save_for_backward(f0, amps)
        return harmonic_source_cuda(f0, amps, sample_rate, seg)

    @staticmethod
    def backward(ctx, grad_out):
        plain = lambda f0, amps: harmonic_source_plain(f0, amps, ctx.sample_rate,  # noqa: E731
                                                       ctx.seg)
        return (*_lib.plain_vjp(plain, ctx.saved_tensors, ctx.needs_input_grad[:2], grad_out),
                None, None)


def harmonic_source(f0: torch.Tensor, amps: torch.Tensor, sample_rate: int = 16_000,
                    seg: int = 320) -> torch.Tensor:
    """Offline harmonic source: the kernel (with a gradient,
    ``HarmonicSourceFunction``) on CUDA tensors, the plain version on CPU
    tensors."""
    if _lib.route(f0) == "cuda":
        return HarmonicSourceFunction.apply(f0, amps, sample_rate, seg)
    return harmonic_source_plain(f0, amps, sample_rate, seg)


def harmonic_source_formants_plain(formants: torch.Tensor, amps: torch.Tensor,
                                   sample_rate: int = 16_000, seg: int = 320) -> torch.Tensor:
    """formants [N, Lf, NH] Hz, amps [N, Lf, NH] -> [N, Lf*seg, 1] float32."""
    n, lf, nh = formants.shape
    w, ws = _tables(seg, formants.device)
    fp = _edge(formants.float() / sample_rate)[..., None]                # [N, Lf+2, NH, 1]
    cseg = fp[:, :-2] * ws[0] + fp[:, 1:-1] * ws[1] + fp[:, 2:] * ws[2]   # [N, Lf, NH, seg]
    tot = cseg[..., -1].double()
    o = (torch.cumsum(tot, dim=1) - tot) - cseg[:, :1, :, 0].double()
    x = cseg + (o - torch.floor(o)).float()[..., None]
    theta = (2.0 * math.pi) * (x - torch.floor(x))
    ap = _edge(amps.float())[..., None]
    amp = ap[:, :-2] * w[0] + ap[:, 1:-1] * w[1] + ap[:, 2:] * w[2]
    return ((torch.sin(theta) * amp).sum(dim=2) / nh).reshape(n, lf * seg, 1)


def harmonic_source_formants_cuda(formants: torch.Tensor, amps: torch.Tensor,
                                  sample_rate: int = 16_000, seg: int = 320) -> torch.Tensor:
    """The kernel launch: formants [N, Lf, NH] Hz and amps [N, Lf, NH]
    (float32 or bf16, read as they are) on the card.  Two launches: the
    phase scan into an [N, Lf, NH] scratch, then ``osc_formant_kernel``."""
    _lib.refuse_grad("harmonic_source_formants_cuda", formants, amps)
    if formants.dim() != 3:
        raise ValueError(f"formants must be [N, Lf, NH], got {tuple(formants.shape)}")
    f, a = _operands(formants, amps, amps.shape[-1], seg)
    n, lf, nh = a.shape
    out = torch.empty((n, lf * seg, 1), dtype=torch.float32, device=f.device)
    off = torch.empty((n, lf, nh), dtype=torch.float32, device=f.device)
    rc = _lib.function("oscillator", "osc_formant", "ppipppiiiifp")(
        f.data_ptr(), a.data_ptr(), a.dtype == torch.bfloat16, _device_table(seg, f).data_ptr(),
        off.data_ptr(), out.data_ptr(), n, lf, nh, seg, inv_rate(sample_rate), _lib.stream_of(f))
    _lib.check(rc, "osc_formant")
    _lib.LAUNCHES["oscillator_formants"] += 1
    return out


def harmonic_source_formants(formants: torch.Tensor, amps: torch.Tensor,
                             sample_rate: int = 16_000, seg: int = 320) -> torch.Tensor:
    """Full-formant harmonic source: the kernel on CUDA tensors, the plain
    version on CPU tensors."""
    if _lib.route(formants) == "cuda":
        return harmonic_source_formants_cuda(formants, amps, sample_rate, seg)
    return harmonic_source_formants_plain(formants, amps, sample_rate, seg)


def harmonic_source_stream_plain(f0: torch.Tensor, amps: torch.Tensor, phi=0.0, crop0: int = 0,
                                 sample_rate: int = 16_000, seg: int = 320):
    """The streaming source in PyTorch operations (module/decoder.py:80-95):
    f0 [N, Lf, 1] Hz, amps [N, Lf, NH], phi the number or [N or 1, 1, NH],
    the phase re-zeroed at sample ``crop0`` -> (wave [N, Lw, 1], phi_out
    [N, Lw, NH])."""
    nh = amps.shape[-1]
    lw = f0.shape[1] * seg
    mul = torch.arange(1, nh + 1, dtype=torch.float32, device=f0.device)
    formants = linear_interpolate(f0.float() * mul, lw, axis=1)
    amps = linear_interpolate(amps.float(), lw, axis=1)
    dt = torch.cumsum(formants / sample_rate, dim=1)      # float32 phase
    dt = dt - dt[:, crop0][:, None, :]
    harmonics = torch.sin(2.0 * math.pi * dt + phi)
    phi_out = torch.asin(harmonics)
    wave = torch.mean(harmonics * amps, dim=2, keepdim=True)
    return wave, phi_out


def harmonic_source_stream_cuda(f0: torch.Tensor, amps: torch.Tensor, phi=0.0, crop0: int = 0,
                                sample_rate: int = 16_000, seg: int = 320):
    """The kernel launch: f0 [N, Lf] or [N, Lf, 1] Hz and amps [N, Lf, NH]
    (float32 or bf16, read as they are) on the card; phi the number or a
    float32 [N or 1, 1, NH] tensor there; ``crop0`` a sample index (negative
    counts from the end).  Two launches: ``osc_stream_chain_kernel`` (the
    running sums into an [N, Lw, NH] scratch), then ``osc_stream_kernel``.
    Returns (wave [N, Lw, 1], phi_out [N, Lw, NH])."""
    _lib.refuse_grad("harmonic_source_stream_cuda", f0, amps, phi)
    if f0.dim() not in (2, 3) or f0.dim() == 3 and f0.shape[2] != 1:
        raise ValueError(f"f0 must be [N, Lf] or [N, Lf, 1], got {tuple(f0.shape)}")
    f, a = _operands(f0, amps, 1, seg)
    n, lf, nh = a.shape
    lw = lf * seg
    crop = crop0 + lw if crop0 < 0 else crop0
    if not 0 <= crop < lw:
        raise IndexError(f"crop0={crop0} is outside the {lw} samples")
    if torch.is_tensor(phi):
        if not phi.is_contiguous():
            phi = phi.contiguous()
        _lib.require(phi, "phi", (torch.float32,), 3)
        if phi.shape not in ((1, 1, nh), (n, 1, nh)):
            raise ValueError(f"phi must be [{n} or 1, 1, {nh}], got {tuple(phi.shape)}")
        phi_ptr, phi_stride, phi_c = phi.data_ptr(), nh if phi.shape[0] > 1 else 0, 0.0
    else:
        phi_ptr, phi_stride, phi_c = None, 0, float(phi)
    dt = torch.empty((n, lw, nh), dtype=torch.float32, device=f.device)
    wave = torch.empty((n, lw, 1), dtype=torch.float32, device=f.device)
    phi_out = torch.empty((n, lw, nh), dtype=torch.float32, device=f.device)
    rc = _lib.function("oscillator", "osc_stream", "ppipifppppiiiiifp")(
        f.data_ptr(), a.data_ptr(), a.dtype == torch.bfloat16, phi_ptr, phi_stride, phi_c,
        _device_table(seg, f).data_ptr(), dt.data_ptr(), wave.data_ptr(), phi_out.data_ptr(), n, lf,
        nh, seg, crop, inv_rate(sample_rate), _lib.stream_of(f))
    _lib.check(rc, "osc_stream")
    _lib.LAUNCHES["oscillator_stream"] += 1
    return wave, phi_out


def harmonic_source_stream(f0: torch.Tensor, amps: torch.Tensor, phi=0.0, crop0: int = 0,
                           sample_rate: int = 16_000, seg: int = 320):
    """Streaming harmonic source: the kernel on CUDA tensors, the plain
    version on CPU tensors."""
    if _lib.route(f0) == "cuda":
        return harmonic_source_stream_cuda(f0, amps, phi, crop0, sample_rate, seg)
    return harmonic_source_stream_plain(f0, amps, phi, crop0, sample_rate, seg)


# ---------------------------------------------------------------------------
# The kernels' arithmetic, replayed in PyTorch (tests only)
# ---------------------------------------------------------------------------


def two_frame_split(seg: int):
    """The kernels' two-frame form of the x``seg`` interpolation, as [seg]
    arrays: sample r < seg // 2 mixes frames (q-1, q), the others (q, q+1).
    Returns (lo, w_lo, w_hi, ws_lo, ws_hi): ``lo`` is the lower frame's
    offset from q (-1 or 0), then the two frames' weights and prefix-summed
    weights.  In the second half the prefix weight of frame q-1 is the
    constant ws[0][seg-1], which the formant kernel folds into its per-frame
    phase constant."""
    w, ws = interp_weights_np(seg)
    first = np.arange(seg) < seg // 2
    lo = np.where(first, -1, 0)
    pick = lambda t, a, b: np.where(first, t[a], t[b]).astype(np.float32)  # noqa: E731
    return lo, pick(w, 0, 1), pick(w, 1, 2), pick(ws, 0, 1), pick(ws, 1, 2)


def _fma(a, b, c) -> torch.Tensor:
    """float32 a * b + c with one rounding, as an FMA (the float32 product
    is exact in float64; the float64 sum is rounded twice, which moves a
    result by one ulp in rare ties)."""
    return (torch.as_tensor(a).double() * torch.as_tensor(b).double()
            + torch.as_tensor(c).double()).float()


def phase_offsets(f: torch.Tensor, seg: int) -> torch.Tensor:
    """The phase scan: f [N, Lf, H] cycles a sample -> [N, Lf, H] float32,
    each frame's float64 exclusive prefix of the float32 frame totals,
    minus the phase of sample 0, wrapped mod 1.  The totals round as the
    plain version's do."""
    ws = torch.from_numpy(interp_weights_np(seg)[1]).to(f.device)
    fp = _edge(f)
    tot = ((fp[:, :-2] * ws[0, -1] + fp[:, 1:-1] * ws[1, -1]) + fp[:, 2:] * ws[2, -1]).double()
    p0 = ((fp[:, :1] * ws[0, 0] + fp[:, 1:2] * ws[1, 0]) + fp[:, 2:3] * ws[2, 0]).double()
    excl = torch.cat([torch.zeros_like(tot[:, :1]), torch.cumsum(tot, dim=1)[:, :-1]], dim=1)
    o = excl - p0
    return (o - torch.floor(o)).float()


def _two_frames(x: torch.Tensor, seg: int):
    """x [N, Lf, C] frame values -> (lower, upper) frame values of every
    sample, [N, Lf, seg, C] each, under the two-frame split."""
    lo = torch.from_numpy(two_frame_split(seg)[0]).to(x.device)
    rows = torch.arange(x.shape[1], device=x.device)[:, None] + 1 + lo[None, :]   # rows of _edge(x)
    xp = _edge(x)
    return xp[:, rows], xp[:, rows + 1]


def harmonic_source_replay(f0: torch.Tensor, amps: torch.Tensor, sample_rate: int = 16_000,
                           seg: int = 320) -> torch.Tensor:
    """``harmonic_source`` as ``osc_cheb_kernel`` computes it: the wrapped
    base phases, theta as the plain version forms it, the two accumulators
    A_lo, A_hi (one FMA each), the recurrence from sin(theta) and sin(0),
    then (w_lo A_lo + w_hi A_hi) / NH.  f = f0 / sample_rate is
    formed as the plain version forms it on the tensors' device; the
    kernel's product by ``inv_rate`` equals it on the card."""
    if f0.dim() == 3:
        f0 = f0[..., 0]
    n, lf = f0.shape
    nh = amps.shape[-1]
    dev = f0.device
    w, ws = (torch.from_numpy(t).to(dev) for t in interp_weights_np(seg))
    f = (f0.float() / sample_rate)[..., None]
    off = phase_offsets(f, seg)
    fp = _edge(f)
    x = ((fp[:, :-2] * ws[0] + fp[:, 1:-1] * ws[1]) + fp[:, 2:] * ws[2]) + off   # [N, Lf, seg]
    theta = (2.0 * math.pi) * x
    twoc = 2.0 * torch.cos(theta)
    a_lo, a_hi = _two_frames(amps.float(), seg)
    acc_lo = torch.zeros_like(x)
    acc_hi = torch.zeros_like(x)
    s, s_prev = torch.sin(theta), torch.zeros_like(x)
    for k in range(nh):
        acc_lo = _fma(s, a_lo[..., k], acc_lo)
        acc_hi = _fma(s, a_hi[..., k], acc_hi)
        s, s_prev = _fma(s, twoc, -s_prev), s
    _, w_lo, w_hi, _, _ = (torch.from_numpy(t).to(dev) for t in two_frame_split(seg))
    out = _fma(w_lo, acc_lo, w_hi * acc_hi) * (1.0 / nh)
    return out.reshape(n, lf * seg, 1)


def harmonic_source_formants_replay(formants: torch.Tensor, amps: torch.Tensor,
                                    sample_rate: int = 16_000, seg: int = 320) -> torch.Tensor:
    """``harmonic_source_formants`` as ``osc_formant_kernel`` computes it:
    the scan's wrapped offsets, the phase as 2 FMAs over the two frames
    (the second half's frame q-1 term folded into the phase constant),
    reduced to x - rint(x), its sine, and the two accumulators.  f is
    formed as in ``harmonic_source_replay``."""
    n, lf, nh = formants.shape
    dev = formants.device
    ws = torch.from_numpy(interp_weights_np(seg)[1]).to(dev)
    lo, w_lo, w_hi, ws_lo, ws_hi = (torch.from_numpy(t).to(dev) for t in two_frame_split(seg))
    f = formants.float() / sample_rate
    off = phase_offsets(f, seg)                                         # [N, Lf, NH]
    second = _fma(_edge(f)[:, :-2], ws[0, -1], off)
    const = torch.where((lo == -1)[:, None], off[:, :, None], second[:, :, None])   # [N, Lf, seg, NH]
    f_lo, f_hi = _two_frames(f, seg)
    x = _fma(f_hi, ws_hi[:, None], _fma(f_lo, ws_lo[:, None], const))
    s = torch.sin((2.0 * math.pi) * (x - torch.round(x)))
    a_lo, a_hi = _two_frames(amps.float(), seg)
    acc_lo = torch.zeros(n, lf, seg, device=dev)
    acc_hi = torch.zeros(n, lf, seg, device=dev)
    for h in range(nh):
        acc_lo = _fma(s[..., h], a_lo[..., h], acc_lo)
        acc_hi = _fma(s[..., h], a_hi[..., h], acc_hi)
    out = _fma(w_lo, acc_lo, w_hi * acc_hi) * (1.0 / nh)
    return out.reshape(n, lf * seg, 1)


def harmonic_source_stream_replay(f0: torch.Tensor, amps: torch.Tensor, phi=0.0, crop0: int = 0,
                                  sample_rate: int = 16_000, seg: int = 320):
    """``harmonic_source_stream`` as ``osc_stream_chain_kernel`` and
    ``osc_stream_kernel`` compute it, on the CPU: each increment
    ((lo w_lo + hi w_hi) * ``inv_rate``, the two frames of the two-frame
    split, every product and sum rounded to float32), the chain as an
    explicit float32 sum in time order (``numpy.add.accumulate``), the
    phase argument (2 pi) * (dt - dt[crop0]) + phi, its sine and asin, and
    the amplitude-weighted mean.  Returns (wave [N, Lw, 1], phi_out, dt,
    theta), the last three [N, Lw, NH]."""
    if f0.dim() == 3:
        f0 = f0[..., 0]
    n, lf = f0.shape
    nh = amps.shape[-1]
    lw = lf * seg
    _, w_lo, w_hi, _, _ = (torch.from_numpy(t) for t in two_frame_split(seg))
    x = f0.float().cpu()[..., None] * torch.arange(1, nh + 1, dtype=torch.float32)   # [N, Lf, NH]
    x_lo, x_hi = _two_frames(x, seg)                                     # [N, Lf, seg, NH]
    inc = (x_lo * w_lo[:, None] + x_hi * w_hi[:, None]) * inv_rate(sample_rate)
    dt = torch.from_numpy(np.add.accumulate(inc.reshape(n, lw, nh).numpy(), axis=1, dtype=np.float32))
    theta = (2.0 * math.pi) * (dt - dt[:, crop0][:, None, :]) + (
        phi.float().cpu() if torch.is_tensor(phi) else phi)
    s = torch.sin(theta)
    a_lo, a_hi = _two_frames(amps.float().cpu(), seg)
    a = (a_lo * w_lo[:, None] + a_hi * w_hi[:, None]).reshape(n, lw, nh)
    return (s * a).mean(dim=2, keepdim=True), torch.asin(s), dt, theta
