#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``alivevc_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero without
printing the final line:

  0. the card's name and power limit (nvidia-smi);
  1. build every CUDA kernel from ``alivevc_tpu_torch/csrc`` (one nvcc per
     source, all at once);
  2. each kernel against its plain PyTorch version on the card, at the
     shapes its paths give it (the offline path; the sharded path's
     524 288-row shards with their valid-row counts; a penalty column; the
     packed extraction; the full-formant source), with its CUDA-event time,
     the plain version's time, one PyTorch call's time where one computes
     the same function (the STFT: ``torch.stft`` + ``abs``; kNN: ``matmul``
     + ``topk`` on the normalised operands), and the least time the card
     could take (bound; kNN 'high'/'highest' and the float32 filter levels
     at the 3xTF32 tensor-core floor, three TF32 products per product).
     Each filter level also records ``products_library_ms``: its eight
     products alone as cuDNN/cuBLAS calls (a yardstick, not the function).
     Each oscillator row also records ``kernel_ms``, the device time of its
     kernels alone (torch.profiler: the Chebyshev source; the formant
     source and its phase scan), and its grid (tiles of 4 frames, resident
     blocks, waves).
     Each time is the median of at least 5 runs and at least 20 ms of timed
     work (2 runs for a plain version), after one warm-up;
  3. the main path end to end at full model width (default configs, random
     weights from a seed, a 100 352 x 768 library from the seed):
     ``OfflineConverter.convert_16k`` answers three requests (10 s, 30 s,
     61 s) in bf16 and in fp32, one ``convert_window`` step at the bench
     shape (64 windows x 144 000 samples) and the bf16 licence's log-mel L1.
     Launch counters are zeroed just before this phase and read just after
     it: every kernel must have run.  The bench-shape step is profiled by
     kernel group, and a device span named ``filter`` outside the
     filter_level group, or ``osc_`` outside the oscillator group, fails
     the run.  Then the licence's kNN flip rate (direct
     kernel calls) and a small-input check of the card's output against the
     plain versions on the CPU, neither of them counted.
  4. the library-sharded path at full width: ``convert_windows_distributed``
     on a ('data', 1) x ('library', 2) mesh as 2 gloo ranks on the one card
     (NCCL takes one rank per card), 16 windows of 144 000 samples, a
     1 048 575 x 768 library from the seed (shard 1 carries one padding
     row), kNN 'highest', plus ``sharded_match_features`` in 'default' and
     'highest' on the same queries.  Rank 0 profiles one step by kernel
     group.  Each rank zeroes its launch counters before the path and sends
     them back with its results.  Then the same
     entry point on one rank: identical 'highest' index sets, waveform
     within 1e-4, 'default' flip rate <= 4 %.
  5. the kernel API, the path through which the packed kNN extraction and
     the full-formant source are reached: ``kernels.knn_topk(...,
     extraction='packed')`` and ``kernels.harmonic_source_formants`` at full
     width, counters zeroed before and read after, then each held against
     its exact counterpart (uncounted).

Its last lines are the ``kernels`` JSON line, the nvidia-smi line, and
``{"ok": true, "device": {...}}``.  Float32 products run without TF32
(``torch.backends.cuda.matmul.allow_tf32 = False``); float32 convolutions
too (``torch.backends.cudnn.allow_tf32 = False``), as in the port's fp32
mode.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, float32 outside
# the tensor cores, bf16 and TF32 on the tensor cores.
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
PEAK_BF16 = 989e12
PEAK_TF32 = 495e12

LW = 144_000          # overlap-discard window (3 x 48 000 samples)
LF = LW // 320        # frames per window
N_STEP = 16           # windows per step (InferenceConfig.max_windows_per_step)
LIB_ROWS = 100_352
MIN_RUNS = 5          # timed runs per kernel, at least ...
MIN_TIMED_MS = 20.0   # ... and at least this much timed work (median taken)
SHARD_LIB_ROWS = 1_048_575   # phase 4: padded to 2 x 524 288
SHARD_RANKS = 2
SHARD_TIMEOUT_S = 600
SEED = 0
OFFLINE_KERNELS = ("stft", "knn", "oscillator", "filter_level")
SHARDED_KERNELS = ("knn", "oscillator", "filter_level")
API_KERNELS = ("knn_packed", "oscillator_formants")


class SmokeFailure(RuntimeError):
    pass


def need(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, min_runs: int = MIN_RUNS, warmup: int = 1) -> float:
    """Median milliseconds of ``fn`` by CUDA events, over at least
    ``min_runs`` runs and at least MIN_TIMED_MS of timed work."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    while len(times) < min_runs or sum(times) < MIN_TIMED_MS:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound_ms(nbytes: float, flops: float, peak: float):
    tb, tf = nbytes / PEAK_BYTES * 1e3, flops / peak * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def kernel_device_ms(fn, keys, runs: int = 20):
    """Mean device time of one call of ``fn`` in the kernels whose names hold
    one of ``keys`` (torch.profiler over ``runs`` calls after a warm-up; the
    wrapper's host time is left out), or None if the profiler recorded no
    device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    spans = [e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA and any(k in e.name for k in keys)]
    return sum(spans) / 1e3 / runs if spans else None


def osc_grid(formant: bool, nh: int = 64) -> dict:
    """The oscillator source kernel's grid at the main-path shape: one block
    a tile of 4 frames, the blocks that fit on the card at once, and the
    waves that makes."""
    import torch
    from alivevc_tpu_torch.kernels import _lib

    per_sm = _lib.function("oscillator", "osc_blocks_per_sm", "ii")(int(formant), nh)
    resident = per_sm * torch.cuda.get_device_properties(0).multi_processor_count
    tiles = N_STEP * math.ceil(LF / 4)
    return {"tiles": tiles, "resident_blocks": resident, "waves": tiles / resident}


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------


def check_stft(gen):
    import torch
    from alivevc_tpu_torch.kernels.stft import stft_magnitude_cuda, stft_magnitude_plain

    x = 0.3 * torch.randn(N_STEP, LW, generator=gen, device="cuda")
    got = stft_magnitude_cuda(x)
    want = stft_magnitude_plain(x)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    # float32 sums of 1280 products, taken in another order
    need(got.shape == want.shape and err <= 1e-3, f"stft: max abs err {err} > 1e-3")
    n_frames = N_STEP * got.shape[1]
    # the function's least work: read x, write the magnitudes; a real FFT
    # of 1280 points (~2.5 n log2 n operations) and 3 per magnitude
    nbytes = x.numel() * 4 + got.numel() * 4
    flops = n_frames * (2.5 * 1280 * math.log2(1280) + 3.0 * got.shape[2])
    b, by = bound_ms(nbytes, flops, PEAK_F32)
    window = torch.ones(1280, device="cuda")

    def library_call():   # the whole function in one PyTorch call
        torch.stft(x, 1280, 320, window=window, center=True, pad_mode="reflect",
                   return_complex=True).abs()

    return {
        "name": "stft", "variant": f"[{N_STEP}, {LW}] f32",
        "max_abs_err": err, "tol": 1e-3,
        "ms": cuda_ms(lambda: stft_magnitude_cuda(x)),
        "plain_ms": cuda_ms(lambda: stft_magnitude_plain(x), 2),
        "library_ms": cuda_ms(library_call),
        "bound_ms": b, "bound_by": by,
    }


def check_knn(gen, lib_rows, precision, valid_rows=None, penalty=False, extraction="auto"):
    """One kNN variant: ``valid_rows`` (a device scalar, as the sharded path
    passes it), a 0/-4 ``penalty`` column, or the packed extraction."""
    import torch
    from alivevc_tpu_torch.kernels.knn import knn_topk_cuda, knn_topk_plain, prep_operands

    ls = N_STEP * LF
    q = torch.randn(ls, 768, generator=gen, device="cuda")
    lib = torch.randn(lib_rows, 768, generator=gen, device="cuda")
    kw, tag, rows = {"extraction": extraction}, "", lib_rows
    if valid_rows is not None:
        kw["valid_rows"] = torch.tensor(valid_rows, device="cuda")
        tag, rows = f" valid_rows={valid_rows}", valid_rows
    if penalty:
        kw["penalty"] = torch.where(torch.rand(lib_rows, generator=gen, device="cuda") < 0.25, -4.0, 0.0)
        tag = " penalty 0/-4"
    packed = extraction == "packed"
    if packed:
        tag = " packed"
    v, i = knn_topk_cuda(q, lib, 4, precision, **kw)
    pv, pi = knn_topk_plain(q, lib, 5, precision, **kw)
    torch.cuda.synchronize()
    err = float((v - pv[:, :4]).abs().max())
    # float32 sums of the mode's operand products, in another order: the
    # scores agree to ~1e-6 (a packed key moves by up to 3.1e-5 when such a
    # sum rounds across a packing step); index sets must agree wherever the
    # plain 4th and 5th scores are further apart than that
    tol = 1e-4
    clear = (pv[:, 3] - pv[:, 4]) > (1e-4 if packed else 1e-5)
    same = (torch.sort(i, 1).values == torch.sort(pi[:, :4], 1).values).all(1)
    bad = int((clear & ~same).sum())
    if valid_rows is not None:
        need(int(i.max()) < valid_rows, f"knn: a row past valid_rows={valid_rows} won")
    need(err <= tol and bad == 0,
         f"knn[{precision},{lib_rows}{tag}]: max abs err {err}, {bad} index sets differ")
    src, lb = prep_operands(q, lib, precision)

    def library_call():
        s = src @ lb.t()
        if valid_rows is not None:
            s[:, valid_rows:] = float("-inf")
        if penalty:
            s = s + kw["penalty"]
        torch.topk(s, 4, dim=1)

    # the function reads float32 queries and the rows it ranks (plus the
    # penalty), writes values + indices; products over the rows it ranks,
    # on the tensor cores: bf16 for 'default', three TF32 products (3xTF32,
    # float32-faithful) for 'high'/'highest'
    nbytes = (ls + rows) * 768 * 4 + ls * 4 * 8 + (lib_rows * 4 if penalty else 0)
    flops = 2.0 * ls * rows * 768
    if precision == "default":
        b, by = bound_ms(nbytes, flops, PEAK_BF16)
    else:
        b, by = bound_ms(nbytes, 3.0 * flops, PEAK_TF32)
    return {
        "name": "knn_packed" if packed else "knn",
        "variant": f"{ls} x {lib_rows} x 768 {precision}{tag}",
        "max_abs_err": err, "tol": tol, "index_sets_differing": bad,
        "ms": cuda_ms(lambda: knn_topk_cuda(q, lib, 4, precision, **kw)),
        "plain_ms": cuda_ms(lambda: knn_topk_plain(q, lib, 4, precision, **kw), 2),
        "library_ms": cuda_ms(library_call),
        "bound_ms": b, "bound_by": by,
    }


def check_oscillator(gen):
    import torch
    from alivevc_tpu_torch.kernels.oscillator import harmonic_source_cuda, harmonic_source_plain

    f0 = 80.0 + 320.0 * torch.rand(N_STEP, LF, 1, generator=gen, device="cuda")
    amps = torch.exp(0.3 * torch.randn(N_STEP, LF, 64, generator=gen, device="cuda"))
    got = harmonic_source_cuda(f0, amps)
    want = harmonic_source_plain(f0, amps)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    # sinf/cosf round differently in the kernel and in torch; the Chebyshev
    # recurrence grows a one-ulp difference in 2cos(theta) about k^2/2-fold
    # by harmonic k = 64 (theta reaches ~50 rad at 400 Hz)
    need(err <= 5e-3, f"oscillator: max abs err {err} > 5e-3")
    nbytes = f0.numel() * 4 + amps.numel() * 4 + got.numel() * 4
    # per sample and harmonic: one FMA each for the interpolated amplitude,
    # the sin(k theta) recurrence and the weighted sum
    flops = 6.0 * N_STEP * LW * 64
    b, by = bound_ms(nbytes, flops, PEAK_F32)
    return {
        "name": "oscillator", "variant": f"f0 [{N_STEP}, {LF}], amps [{N_STEP}, {LF}, 64]",
        "max_abs_err": err, "tol": 5e-3,
        "ms": cuda_ms(lambda: harmonic_source_cuda(f0, amps)),
        "kernel_ms": kernel_device_ms(lambda: harmonic_source_cuda(f0, amps), ("osc_",)),
        "plain_ms": cuda_ms(lambda: harmonic_source_plain(f0, amps), 2),
        "library_ms": None,
        "bound_ms": b, "bound_by": by, **osc_grid(False),
    }


def formant_inputs(gen):
    """Formants f0 * (1..64), f0 80-380 Hz, and amplitudes [16, 450, 64]."""
    import torch

    f0 = 80.0 + 300.0 * torch.rand(N_STEP, LF, 1, generator=gen, device="cuda")
    amps = torch.exp(0.3 * torch.randn(N_STEP, LF, 64, generator=gen, device="cuda"))
    return f0, f0 * torch.arange(1, 65, device="cuda"), amps


def check_formants(gen):
    import torch
    from alivevc_tpu_torch.kernels.oscillator import (
        harmonic_source_formants_cuda,
        harmonic_source_formants_plain,
    )

    _, formants, amps = formant_inputs(gen)
    got = harmonic_source_formants_cuda(formants, amps)
    want = harmonic_source_formants_plain(formants, amps)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    # float32 phase of up to ~500 cycles a frame at harmonic 64, rounded in
    # another order and reduced mod 1 before sinpif / torch.sin
    need(err <= 5e-3, f"oscillator_formants: max abs err {err} > 5e-3")
    nbytes = formants.numel() * 4 + amps.numel() * 4 + got.numel() * 4
    # per sample and harmonic: 7 FMAs (phase mix, amplitude mix, weighted
    # sum) and one sine
    flops = 15.0 * N_STEP * LW * 64
    b, by = bound_ms(nbytes, flops, PEAK_F32)
    return {
        "name": "oscillator_formants",
        "variant": f"formants, amps [{N_STEP}, {LF}, 64]",
        "max_abs_err": err, "tol": 5e-3,
        "ms": cuda_ms(lambda: harmonic_source_formants_cuda(formants, amps)),
        "kernel_ms": kernel_device_ms(lambda: harmonic_source_formants_cuda(formants, amps), ("osc_",)),
        "plain_ms": cuda_ms(lambda: harmonic_source_formants_plain(formants, amps), 2),
        "library_ms": None,
        "bound_ms": b, "bound_by": by, **osc_grid(True),
    }


def level_products(x, s, args, rate):
    """The level's eight products alone, each one cuDNN/cuBLAS call on
    operands prepared beforehand: the up conv and the 1x1 (``torch.matmul``)
    and the six causal convs (``F.conv1d`` on reflect-padded [N, C, L + 4d]
    operands).  A yardstick only: it skips gelu, FiLM and every rounding, so
    it does not compute the level's function.  Its own generator, so that
    the shared one (and phase 3's library) draws as before."""
    import torch
    import torch.nn.functional as F

    n, l_in, _ = x.shape
    c = args["up_b"].shape[0]
    length = l_in * rate
    xs = x + s
    gen = torch.Generator(device=x.device).manual_seed(SEED + 4)
    mid = torch.randn(n, length, c, generator=gen, device=x.device).to(x.dtype)
    w = [cw.permute(2, 1, 0).contiguous() for cw in args["conv_w"]]
    k = w[0].shape[2]
    ops = {d: F.pad(mid.transpose(1, 2), ((k - 1) * d, 0), mode="reflect").contiguous()
           for d in set(args["dilations"])}

    def run():
        torch.matmul(xs, args["up_w"])
        torch.matmul(mid, args["in_w"])
        for wi, b, d in zip(w, args["conv_b"], args["dilations"]):
            F.conv1d(ops[d], wi, b, dilation=d)

    return run


def check_filter_levels(gen, dec):
    import torch
    from alivevc_tpu_torch.infer.offline import cast_params
    from alivevc_tpu_torch.kernels.filter import filter_level_cuda, filter_level_plain
    from alivevc_tpu_torch.models.decoder import level_args

    cfg = dec.cfg
    lens = [LW // 32, LW // 4, LW // 2, LW]          # output length of up level i
    cond32 = 0.5 * torch.randn(N_STEP, LF, cfg.channels, generator=gen, device="cuda")
    rows = []
    for dt in (torch.float32, torch.bfloat16):
        for i, (up, blk) in enumerate(zip(dec.filter.ups, dec.filter.blocks)):
            up_d, blk_d = cast_params(up, dt), cast_params(blk, dt)
            cin, c, r = up.weight.shape
            l_in = lens[i] // r
            x = (0.3 * torch.randn(N_STEP, l_in, cin, generator=gen, device="cuda")).to(dt)
            s = (0.3 * torch.randn(N_STEP, l_in, cin, generator=gen, device="cuda")).to(dt)
            args = level_args(blk_d, up_d, cond32.to(dt))
            got = filter_level_cuda(x, s, rate=r, **args)
            want = filter_level_plain(x, s, rate=r, **args)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            scale = float(want.float().abs().max())
            # float32: sums of up to 5*256 products in another order; bf16:
            # the same, then rounding to bf16 after every conv may land one
            # bf16 step (2^-8 relative) apart and carry through the level
            tol = 1e-3 * (1.0 + scale) if dt == torch.float32 else 4e-2 * (1.0 + scale)
            tag = "f32" if dt == torch.float32 else "bf16"
            need(err <= tol, f"filter level {i} ({tag}, C={c}): max abs err {err} > {tol}")
            isz = x.element_size()
            nbytes = isz * (2 * x.numel() + got.numel() + args["film"].numel()
                            + sum(p.numel() for p in list(up.parameters()) + list(blk.parameters())))
            flops = 2.0 * N_STEP * (l_in * cin * r * c + lens[i] * c * c
                                    + 6 * lens[i] * c * c * cfg.filter_kernel_size)
            # the products on the tensor cores: bf16, or 3xTF32 (three TF32
            # products each) in float32 storage
            if dt == torch.float32:
                b, by = bound_ms(nbytes, 3.0 * flops, PEAK_TF32)
            else:
                b, by = bound_ms(nbytes, flops, PEAK_BF16)
            rows.append({
                "name": "filter_level", "variant": f"level {i} C={c} L={lens[i]} {tag}",
                "max_abs_err": err, "tol": tol,
                "ms": cuda_ms(lambda: filter_level_cuda(x, s, rate=r, **args)),
                "plain_ms": cuda_ms(lambda: filter_level_plain(x, s, rate=r, **args), 2),
                "library_ms": None,
                "products_library_ms": cuda_ms(level_products(x, s, args, r)),
                "bound_ms": b, "bound_by": by,
            })
            del got, want
    return rows


# ---------------------------------------------------------------------------
# phase 3: the main path end to end
# ---------------------------------------------------------------------------


def request_wave(seconds: float, rng):
    import numpy as np

    t = np.arange(int(seconds * 16_000)) / 16_000.0
    f = 110.0 + 60.0 * np.sin(2 * np.pi * 0.3 * t)
    phase = 2 * np.pi * np.cumsum(f) / 16_000.0
    wave = 0.4 * np.sin(phase) + 0.2 * np.sin(2 * phase) + 0.01 * rng.standard_normal(t.shape)
    return wave.astype(np.float32)


def run_main_path(ce, f0m, dec, lib, card):
    import numpy as np
    import torch
    from alivevc_tpu_torch.infer.offline import OfflineConverter, convert_window
    from alivevc_tpu_torch.kernels import LAUNCHES
    from alivevc_tpu_torch.ops.stft import log_mel_spectrogram

    rng = np.random.default_rng(0)
    requests = [request_wave(s, rng) for s in (10.0, 30.0, 61.0)]
    report = {}
    for dtype in ("bf16", "fp32"):
        conv = OfflineConverter(ce, f0m, dec, lib, dtype=dtype)
        for wave in requests:
            before = dict(LAUNCHES)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = conv.convert_16k(wave)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            need(out.shape == wave.shape, f"{dtype}: output length {out.shape} != {wave.shape}")
            need(bool(np.isfinite(out).all()), f"{dtype}: non-finite output")
            grew = {k: LAUNCHES[k] - before[k] for k in OFFLINE_KERNELS}
            need(all(v > 0 for v in grew.values()), f"{dtype}: a kernel did not launch: {grew}")
            secs = len(wave) / 16_000.0
            print(f"request {dtype} {secs:.0f} s audio: {dt:.3f} s wall, "
                  f"{secs / dt:.1f} audio-s/s, launches {grew} [{card}]")
            report[f"request_{dtype}_{secs:.0f}s_wall_s"] = dt

    # one step at the bench shape: 64 windows x 144 000 samples
    t = np.arange(LW) / 16_000.0
    waves = np.stack([0.4 * np.sin(2 * np.pi * rng.uniform(100, 300) * t) for _ in range(64)])
    x = torch.from_numpy(waves.astype(np.float32)).cuda()
    conv16 = OfflineConverter(ce, f0m, dec, lib, dtype="bf16")
    step = lambda: convert_window(conv16.ce, conv16.f0, conv16.dec, x, conv16.tgt, dtype="bf16")  # noqa: E731
    out = step()
    torch.cuda.synchronize()
    need(out.shape == (64, LW) and bool(torch.isfinite(out).all()), "bench-shape step: bad output")
    reps = 3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        step()
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / reps
    audio_s = 64 * 48_000 / 16_000.0
    print(f"bench shape bf16: {dt * 1e3:.2f} ms/step, {audio_s / dt:.1f} audio-s/s "
          f"(64 windows x {LW}, library {LIB_ROWS}) [{card}]")
    report["bench_bf16_ms_per_step"] = dt * 1e3
    report["bench_bf16_audio_s_per_s"] = audio_s / dt
    report["bench_bf16_profile"] = profile_step(step, card)

    # bf16 licence, its end-to-end half: log-mel L1 vs fp32 ('highest' kNN)
    xa = x[:8]
    conv32 = OfflineConverter(ce, f0m, dec, lib, dtype="fp32")
    out32 = convert_window(conv32.ce, conv32.f0, conv32.dec, xa, lib, dtype="fp32",
                           knn_precision="highest")
    out16 = convert_window(conv16.ce, conv16.f0, conv16.dec, xa, lib, dtype="bf16")
    mel_l1 = float((log_mel_spectrogram(out16) - log_mel_spectrogram(out32)).abs().mean())
    print(f"bf16 licence: log-mel L1 {mel_l1:.5f} (<= 0.25)")
    need(mel_l1 <= 0.25, f"bf16 log-mel L1 {mel_l1} > 0.25")
    report["bf16_mel_l1"] = mel_l1
    return report, xa


def knn_flip_rate(ce, lib, xa):
    """The licence's kNN half: top-4 sets of the 'default' (bf16) mode vs
    float32 scores for the content features of ``xa``.  It calls the kernel
    directly, so it runs after the main path's launch counts are read."""
    import torch
    from alivevc_tpu_torch.kernels.knn import knn_topk_cuda
    from alivevc_tpu_torch.models.content_encoder import content_encoder
    from alivevc_tpu_torch.ops.stft import spectrogram

    feat = content_encoder(ce, spectrogram(xa)).reshape(-1, 768)
    _, i32 = knn_topk_cuda(feat, lib, 4, "high")
    _, i16 = knn_topk_cuda(feat, lib, 4, "default")
    flips = float((torch.sort(i32, 1).values != torch.sort(i16, 1).values).any(1).float().mean())
    print(f"bf16 licence: kNN flip rate {flips:.5f} at {LIB_ROWS} rows (<= 0.04)")
    need(flips <= 0.04, f"bf16 kNN flip rate {flips} > 0.04")
    return flips


KERNEL_GROUPS = (
    ("stft", ("stft_fft",)),
    ("knn", ("knn_tile", "knn_merge")),
    ("oscillator", ("osc_scan", "osc_cheb", "osc_formant")),
    ("filter_level", ("filter_wide_kernel", "filter_narrow_kernel")),
)


def profile_step(step, card, label="one bench-shape bf16 step"):
    """Device time of one step by kernel group (torch.profiler), and the
    device's busy share of the step's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = [(e.time_range.start, e.time_range.end, e.name) for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    if not spans:
        print("profile: the profiler recorded no device time (not measured)")
        return None
    groups = {g: 0.0 for g, _ in KERNEL_GROUPS}
    groups["other (cuBLAS, cuDNN, elementwise, copies)"] = 0.0
    for start, end, name in spans:
        g = next((g for g, keys in KERNEL_GROUPS if any(k in name for k in keys)),
                 "other (cuBLAS, cuDNN, elementwise, copies)")
        # every filter kernel of the port must count as the filter level's,
        # every oscillator kernel (the phase scan too) as the oscillator's
        need("filter" not in name or g == "filter_level",
             f"profile: device span {name!r} lands in {g!r}, not in filter_level")
        need("osc_" not in name or g == "oscillator",
             f"profile: device span {name!r} lands in {g!r}, not in oscillator")
        groups[g] += (end - start) / 1e3
    busy, cur_s, cur_e = 0.0, None, None
    for start, end, _ in sorted(spans):
        if cur_e is None or start > cur_e:
            busy += 0.0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = start, end
        else:
            cur_e = max(cur_e, end)
    busy = (busy + cur_e - cur_s) / 1e3
    total = sum(groups.values())
    print(f"profile, {label} [{card}]: wall {wall_us / 1e3:.2f} ms, "
          f"device busy {busy:.2f} ms ({100 * busy * 1e3 / wall_us:.1f} % of wall)")
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {g:45s} {ms:9.3f} ms  {100 * ms / total:5.1f} %")
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy, "by_group_ms": groups}


def reference_check(ce, f0m, dec, lib):
    """Kernels on the card vs the plain versions on the CPU, fp32, two
    windows of 9 600 samples.  f0 is given: the estimator's argmax may flip
    on a near-tie between the two devices."""
    import copy

    import numpy as np
    import torch
    from alivevc_tpu_torch.infer.offline import convert_window

    rng = np.random.default_rng(1)
    t = np.arange(9600) / 16_000.0
    x = np.stack([0.4 * np.sin(2 * np.pi * f * t) for f in (120.0, 220.0)]).astype(np.float32)
    f0 = (100.0 + 200.0 * rng.random((2, 30, 1))).astype(np.float32)
    tgt = lib[:2048]
    got = convert_window(ce, f0m, dec, x, tgt, f0_override=f0).cpu()
    cpu = [copy.deepcopy(m).cpu() for m in (ce, f0m, dec)]
    want = convert_window(*cpu, x, tgt.cpu(), f0_override=f0, device="cpu")
    err = float((got - want).abs().max())
    print(f"reference check (card kernels vs CPU plain, fp32): max abs err {err:.3e} (<= 5e-3)")
    need(err <= 5e-3, f"card vs CPU: max abs err {err} > 5e-3")
    return err


# ---------------------------------------------------------------------------
# phase 4: the library-sharded path
# ---------------------------------------------------------------------------


def shard_windows():
    """16 windows of 144 000 samples from the seed: a gliding tone and
    noise, one pitch per window."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    t = np.arange(LW) / 16_000.0
    rows = []
    for _ in range(N_STEP):
        f = rng.uniform(90.0, 300.0) * (1.0 + 0.1 * np.sin(2 * np.pi * 0.5 * t))
        phase = 2 * np.pi * np.cumsum(f) / 16_000.0
        rows.append(0.4 * np.sin(phase) + 0.1 * np.sin(2 * phase) + 0.01 * rng.standard_normal(LW))
    return np.stack(rows).astype(np.float32)


def run_sharded(n_lib: int) -> dict:
    """This rank's part of the sharded path on a ('data', 1) x ('library',
    n_lib) mesh: models and library from the seed, launch counters zeroed,
    one warm-up, one timed and one profiled ``convert_windows_distributed``
    step, then
    ``sharded_match_features`` in 'highest' and 'default' on the step's
    content features.  Needs the default process group."""
    import torch
    import torch.distributed as dist
    from alivevc_tpu_torch.config import ContentEncoderConfig, DecoderConfig, F0EstimatorConfig
    from alivevc_tpu_torch.infer.offline import float32_math
    from alivevc_tpu_torch.kernels import LAUNCHES, reset_launches
    from alivevc_tpu_torch.models.content_encoder import ContentEncoder, content_encoder
    from alivevc_tpu_torch.models.decoder import Decoder
    from alivevc_tpu_torch.models.f0_estimator import F0Estimator
    from alivevc_tpu_torch.ops.stft import spectrogram
    from alivevc_tpu_torch.parallel import (
        convert_windows_distributed,
        make_mesh,
        pad_library_for_sharding,
        replicate,
        sharded_match_features,
    )

    cpu_gen = torch.Generator().manual_seed(SEED)
    ce = ContentEncoder(ContentEncoderConfig(), generator=cpu_gen).cuda().eval()
    f0m = F0Estimator(F0EstimatorConfig(), generator=cpu_gen).cuda().eval()
    dec = Decoder(DecoderConfig(), generator=cpu_gen).cuda().eval()
    lib = torch.randn(SHARD_LIB_ROWS, 768, generator=torch.Generator(device="cuda").manual_seed(SEED + 1),
                      device="cuda")
    windows = torch.from_numpy(shard_windows()).cuda()
    mesh = make_mesh([("data", 1), ("library", n_lib)], "cuda")
    for m in (ce, f0m, dec):
        replicate(m, mesh)

    reset_launches()
    step_s = []
    for _ in range(2):
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wave = convert_windows_distributed(mesh, ce, f0m, dec, windows, lib, precision="highest")
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    # a third step, profiled on rank 0 (every rank must take part)
    step = lambda: convert_windows_distributed(mesh, ce, f0m, dec, windows, lib, precision="highest")  # noqa: E731
    dist.barrier()
    if dist.get_rank() == 0:
        profile_step(step, card_line(), f"one sharded step, rank 0 of {n_lib}")
    else:
        step()
        torch.cuda.synchronize()
    with float32_math():
        feat = content_encoder(ce, spectrogram(windows)).reshape(-1, 768)
    lib_p, valid = pad_library_for_sharding(lib, n_lib)
    idx = {}
    for precision in ("highest", "default"):
        _, idx[precision] = sharded_match_features(mesh, feat, lib_p, valid, precision=precision,
                                                   return_indices=True)
    torch.cuda.synchronize()
    return {"wave": wave.cpu(), "idx": {k: v.cpu() for k, v in idx.items()},
            "step_s": step_s, "launches": dict(LAUNCHES)}


def shard_rank(rank: int, world: int, tmp: str) -> None:
    """A spawned rank of phase 4: gloo on cuda:0, results to tmp/rank<r>.pt."""
    import os

    import torch
    import torch.distributed as dist
    from alivevc_tpu_torch.parallel import init_distributed

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_grad_enabled(False)
    init_distributed("gloo", f"file://{tmp}/rendezvous", world, rank)
    try:
        torch.save(run_sharded(world), os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_sharded_phase(card):
    """Phase 4: 2 ranks on the card, then one rank, the same entry point."""
    import multiprocessing
    import os
    import tempfile

    import torch
    import torch.distributed as dist
    from alivevc_tpu_torch.parallel import init_distributed

    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=shard_rank, args=(r, SHARD_RANKS, tmp)) for r in range(SHARD_RANKS)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        try:
            for p in procs:
                p.join(max(1.0, SHARD_TIMEOUT_S - (time.perf_counter() - t0)))
            alive = [p.pid for p in procs if p.is_alive()]
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(30)
        need(not alive, f"sharded ranks {alive} did not finish in {SHARD_TIMEOUT_S} s")
        need(all(p.exitcode == 0 for p in procs), f"sharded ranks failed: {[p.exitcode for p in procs]}")
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                 for r in range(SHARD_RANKS)]
        init_distributed("gloo", f"file://{tmp}/rendezvous1", 1, 0)
        try:
            one = run_sharded(1)
        finally:
            dist.destroy_process_group()

    wave, idx = ranks[0]["wave"], ranks[0]["idx"]
    need(tuple(wave.shape) == (N_STEP, LW) and bool(torch.isfinite(wave).all()), "sharded: bad output")
    for r in ranks[1:]:
        need(torch.equal(r["wave"], wave) and all(torch.equal(r["idx"][k], idx[k]) for k in idx),
             "sharded: the ranks disagree")
    for r, res in enumerate(ranks):
        need(all(res["launches"][k] > 0 for k in SHARDED_KERNELS),
             f"sharded rank {r}: a kernel of the path did not launch: {res['launches']}")
    launches = {k: sum(res["launches"][k] for res in ranks) for k in ranks[0]["launches"]}
    sets2 = torch.sort(idx["highest"], 1).values
    sets1 = torch.sort(one["idx"]["highest"], 1).values
    differing = int((sets2 != sets1).any(1).sum())
    wave_err = float((wave - one["wave"]).abs().max())
    flips = float((torch.sort(idx["default"], 1).values != sets2).any(1).float().mean())
    step_ms = 1e3 * max(res["step_s"][-1] for res in ranks)
    one_ms = 1e3 * one["step_s"][-1]
    print(f"sharded path [{card}]: {SHARD_RANKS} gloo ranks on one card, mesh ('data', 1) x "
          f"('library', {SHARD_RANKS}), {N_STEP} windows x {LW}, library {SHARD_LIB_ROWS} x 768, kNN "
          f"'highest': step {step_ms:.2f} ms (one rank, whole library: {one_ms:.2f} ms); 'highest' "
          f"index sets differing from one rank: {differing}; waveform max abs diff {wave_err:.3e} "
          f"(<= 1e-4); 'default' flip rate {flips:.5f} (<= 0.04); launches {launches}")
    need(differing == 0, f"sharded: {differing} 'highest' index sets differ from one rank")
    need(wave_err <= 1e-4, f"sharded: waveform differs from one rank by {wave_err} > 1e-4")
    need(flips <= 0.04, f"sharded: 'default' flip rate {flips} > 0.04")
    return launches, {"sharded_step_ms": step_ms, "single_rank_step_ms": one_ms,
                      "sharded_wave_max_abs_diff": wave_err, "sharded_default_flip_rate": flips}


# ---------------------------------------------------------------------------
# phase 5: the kernel API (packed kNN extraction, full-formant source)
# ---------------------------------------------------------------------------


def run_kernel_api(gen, card):
    import torch
    from alivevc_tpu_torch import kernels
    from alivevc_tpu_torch.kernels import LAUNCHES, reset_launches
    from alivevc_tpu_torch.kernels.knn import knn_topk_cuda
    from alivevc_tpu_torch.kernels.oscillator import harmonic_source_cuda

    q = torch.randn(N_STEP * LF, 768, generator=gen, device="cuda")
    lib = torch.randn(LIB_ROWS, 768, generator=gen, device="cuda")
    f0, formants, amps = formant_inputs(gen)
    reset_launches()
    pv, pi = kernels.knn_topk(q, lib, 4, "default", extraction="packed")
    src = kernels.harmonic_source_formants(formants, amps)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    need(all(launches[k] > 0 for k in API_KERNELS), f"kernel API: a kernel did not launch: {launches}")
    # uncounted: each against its exact counterpart
    ev, ei = knn_topk_cuda(q, lib, 5, "default")
    clear = (ev[:, 3] - ev[:, 4]) > 1e-4
    same = (torch.sort(pi, 1).values == torch.sort(ei[:, :4], 1).values).all(1)
    bad = int((clear & ~same).sum())
    kerr = float((pv - ev[:, :4]).abs().max())
    serr = float((src - harmonic_source_cuda(f0, amps)).abs().max())
    print(f"kernel API [{card}]: packed vs exact 'default' max abs {kerr:.3e} (<= 3.2e-5), "
          f"{bad} clear index sets differ; formant vs Chebyshev source max abs {serr:.3e} (<= 5e-3); "
          f"launches {launches}")
    need(kerr <= 3.2e-5 and bad == 0, f"packed kNN: err {kerr}, {bad} index sets differ")
    need(bool(torch.isfinite(src).all()) and serr <= 5e-3, f"formant source vs Chebyshev: {serr}")
    return launches


# ---------------------------------------------------------------------------


REPLACES = {
    "stft": ("alivevc_tpu_torch/csrc/stft.cu", "alivevc_tpu/kernels/stft_pallas.py:77"),
    "knn": ("alivevc_tpu_torch/csrc/knn.cu",
            "alivevc_tpu/kernels/knn_twopass.py:331 (+ :344, :372, :395, :195; knn_pallas.py:331)"),
    "oscillator": ("alivevc_tpu_torch/csrc/oscillator.cu",
                   "alivevc_tpu/kernels/oscillator_pallas.py:229"),
    "filter_level": ("alivevc_tpu_torch/csrc/filter.cu", "alivevc_tpu/kernels/filter_pallas.py:771"),
    "knn_packed": ("alivevc_tpu_torch/csrc/knn.cu",
                   "alivevc_tpu/kernels/knn_pallas.py:331 (_knn_kernel_fast, _pack_topk)"),
    "oscillator_formants": ("alivevc_tpu_torch/csrc/oscillator.cu",
                            "alivevc_tpu/kernels/oscillator_pallas.py:281"),
}


def kernels_line(rows, launches):
    """One entry per kernel.  The numbers are those of the kernel's variant
    on the bf16 main path (kNN 'default' at the 100 352-row library; the
    filter's four up levels in bf16, summed: one step runs all four; the
    packed kNN at the 100 352-row library); every measured variant is
    listed under 'variants'.  Launches are summed over the paths driven
    (phases 3, 4 with both ranks, 5)."""
    out = []
    for name, (source, replaces) in REPLACES.items():
        mine = [r for r in rows if r["name"] == name]
        if name == "knn":
            main = [r for r in mine if r["variant"].endswith(f"{LIB_ROWS} x 768 default")]
        elif name == "knn_packed":
            main = [r for r in mine if f" {LIB_ROWS} x 768" in r["variant"]]
        elif name == "filter_level":
            main = [r for r in mine if r["variant"].endswith("bf16")]
        else:
            main = mine
        entry = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in main),
            "ms": sum(r["ms"] for r in main),
            "plain_ms": sum(r["plain_ms"] for r in main),
            "bound_ms": sum(r["bound_ms"] for r in main),
            "bound_by": max(main, key=lambda r: r["bound_ms"])["bound_by"],
            "library_ms": (None if any(r["library_ms"] is None for r in main)
                           else sum(r["library_ms"] for r in main)),
            **({"products_library_ms": sum(r["products_library_ms"] for r in main)}
               if name == "filter_level" else {}),
            **({"kernel_ms": main[0]["kernel_ms"]} if "kernel_ms" in main[0] else {}),
            "variants": [{k: v for k, v in r.items() if k != "name"} for r in mine],
        }
        out.append(entry)
    return {"kernels": out}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    try:
        import alivevc_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e})", file=sys.stderr)
        return 2
    from alivevc_tpu_torch.config import ContentEncoderConfig, DecoderConfig, F0EstimatorConfig
    from alivevc_tpu_torch.kernels import LAUNCHES, build_all, reset_launches
    from alivevc_tpu_torch.models.content_encoder import ContentEncoder
    from alivevc_tpu_torch.models.decoder import Decoder
    from alivevc_tpu_torch.models.f0_estimator import F0Estimator

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_grad_enabled(False)
    t_start = time.perf_counter()

    # phase 0
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
          f"tf32 matmul={torch.backends.cuda.matmul.allow_tf32} cudnn={torch.backends.cudnn.allow_tf32}")

    # phase 1
    secs = build_all()
    print(f"build: {secs:.1f} s for {', '.join(['stft', 'knn', 'oscillator', 'filter'])}")

    # phase 2
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cpu_gen = torch.Generator().manual_seed(SEED)
    dec = Decoder(DecoderConfig(), generator=cpu_gen).cuda().eval()
    shard = (SHARD_LIB_ROWS + 1) // SHARD_RANKS
    rows = [check_stft(gen)]
    for lib_rows, precision in ((LIB_ROWS, "default"), (LIB_ROWS, "high"), (512, "default"), (512, "high")):
        rows.append(check_knn(gen, lib_rows, precision))
    # its own generator, so that `gen` (and phase 3's library) run as before
    rows.append(check_knn(torch.Generator(device="cuda").manual_seed(SEED + 3), LIB_ROWS, "highest"))
    for precision in ("default", "highest"):      # phase 4's last shard
        rows.append(check_knn(gen, shard, precision, valid_rows=shard - 1))
    rows.append(check_knn(gen, 512, "highest", valid_rows=509))
    rows.append(check_knn(gen, LIB_ROWS, "high", penalty=True))
    for lib_rows in (512, LIB_ROWS):
        rows.append(check_knn(gen, lib_rows, "default", extraction="packed"))
    rows.append(check_oscillator(gen))
    rows.append(check_formants(gen))
    rows.extend(check_filter_levels(gen, dec))
    for r in rows:
        lib_ms = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.3f}"
        prod = f" products_library {r['products_library_ms']:.3f}" if "products_library_ms" in r else ""
        if "kernel_ms" in r:
            kms = "not measured" if r["kernel_ms"] is None else f"{r['kernel_ms']:.4f}"
            prod += (f" kernels alone {kms} ({r['tiles']} tiles on {r['resident_blocks']} resident "
                     f"blocks, {r['waves']:.2f} waves)")
        print(f"kernel {r['name']:19s} {r['variant']:52s} err {r['max_abs_err']:.3e} "
              f"(tol {r['tol']:.1e}) ms {r['ms']:.4f} plain {r['plain_ms']:.3f} "
              f"library {lib_ms}{prod} bound {r['bound_ms']:.4f} ({r['bound_by']}) [{card}]")
    torch.cuda.empty_cache()
    print(f"phase 2 done at {time.perf_counter() - t_start:.1f} s")

    # phase 3
    ce = ContentEncoder(ContentEncoderConfig(), generator=cpu_gen).cuda().eval()
    f0m = F0Estimator(F0EstimatorConfig(), generator=cpu_gen).cuda().eval()
    lib = torch.randn(LIB_ROWS, 768, generator=gen, device="cuda")
    reset_launches()
    report, xa = run_main_path(ce, f0m, dec, lib, card)
    launches = dict(LAUNCHES)
    need(all(launches[k] > 0 for k in OFFLINE_KERNELS), f"a kernel was not launched: {launches}")
    print(f"main-path launches: {launches}")
    report["bf16_knn_flip_rate"] = knn_flip_rate(ce, lib, xa)
    reference_check(ce, f0m, dec, lib)
    print(f"phase 3 done at {time.perf_counter() - t_start:.1f} s; report {json.dumps(report)}")
    del ce, f0m, lib, xa

    # phase 4
    sharded_launches, sharded = run_sharded_phase(card)
    print(f"phase 4 done at {time.perf_counter() - t_start:.1f} s; report {json.dumps(sharded)}")

    # phase 5
    api_launches = run_kernel_api(gen, card)
    print(f"phase 5 done at {time.perf_counter() - t_start:.1f} s")

    total = {k: launches[k] + sharded_launches[k] + api_launches[k] for k in launches}
    print(json.dumps(kernels_line(rows, total)))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
