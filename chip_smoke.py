#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``alivevc_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero without
printing the final line:

  0. the card's name and power limit (nvidia-smi);
  1. build every CUDA kernel from ``alivevc_tpu_torch/csrc`` and the native
     host library (the WORLD labeler) from ``alivevc_tpu_torch/native`` (one
     nvcc per source and one g++, all at once);
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
     products alone as cuDNN/cuBLAS calls (a yardstick, not the function);
     ``form_bytes_floor_ms``: the bytes its launches move (each launch's
     inputs read once, its output written once: the wide route's 9
     launches pass every intermediate through device memory) over the
     card's memory rate, beside ``bound_ms``, which counts the level's own
     inputs and output only; and its launches as ``narrow_plan`` or
     ``wide_plan`` plans them.
     Each oscillator row also records ``kernel_ms``, the device time of its
     kernels alone (torch.profiler: the Chebyshev source; the formant
     source and its phase scan), and its grid (tiles of 4 frames, resident
     blocks, waves).
     Each time is the median of at least 5 runs and at least 20 ms of timed
     work (2 runs for a plain version), after one warm-up.  The kNN merge
     (``knn_merge_kernel``, one launch a kNN call) has rows of its own, on
     the candidates a kNN call gives it at the bench shape ('default' and
     'high'), the hop's shape and the 524 288-row shard: its outputs against
     ``merge_plain`` on the same candidates (exact), its device time alone
     (torch.profiler), and ``torch.topk`` + ``torch.gather`` over the
     flattened candidates as the library call (at the hop's shape the
     two-pass form forced: there the carried form merges in its own
     launch).  The two-pass form's prep (``knn_prep_kernel``, one launch a
     call: both operands normalised into bf16 or TF32 hi and lo planes) has
     rows of its own too, against ``knn_prep_plain`` at the bench shape
     ('default' and 'high').  Libraries under 4 096 rows take the carried form
     (``csrc/knn_carried.cu``, rows 'knn_carried' and 'knn_carried_packed');
     its shapes (the hop's 24 x 887 'high' and 'default', a fine-tuning
     step's 960 x 512 'highest', 7 200 x 512 'default' and 'high') run
     through both forms on one draw ("A/B" rows).  The kNN-VC cell's
     retrieval has rows of its own, "(kNN-VC)": 1 024 features, 370 and
     1 240 queries against 23 947 rows, 'high', and the merge and prep at
     370 queries, each held to its plain version.  The kNN-VC vocoder's
     ResBlock convs (``csrc/hifigan.cu``) have a row a stage, "(kNN-VC
     vocoder)": the stage's 18 convs (3 stacks x 3 dilations x 2) at C =
     256, 128, 64, 32 on the cell's mean file (370 frames: 3 700 to
     118 400 rows), the stack mean included, against the same stage
     through ``hifigan_conv_plain``, with cuDNN's float32 convs and their
     leaky, residual and stack passes channels first as the library call
     (what the vocoder ran before; the port no longer calls it).  Then the
     cell's whole path, ``KnnVCConverter.convert`` at full width (WavLM-Large
     to layer 6, 'high' retrieval over 23 947 x 1 024 rows, the vocoder;
     weights from the seed) on one 7.4 s file, its counters zeroed before
     and read after: ``hifigan_conv`` 72 launches, the two-pass kNN kernels
     each launched, and six convolutions inside ``knnvc.vocoder``
     (conv_pre, four transposed convs, conv_post).  The RVC cell's
     kernels have rows of their own, "(RVC)": the L2 mode of the two-pass
     tile (operands as they are, the penalty -|x|^2 / 2, k = 8, 'high') at
     2 150 queries against 89 513 x 768 rows, held to ``knn_topk_plain``
     with ``normalize=False``, and its prep launch with unit row scales held
     to ``knn_prep_plain`` bit for bit; and the ResBlock convs of one 41 s
     segment's last generator stage, C = 32 over 1.72 M rows, held to the
     same stage through ``hifigan_conv_plain``.  Then the RVC cell's whole
     path, ``RvcConverter.convert`` at full width (HuBERT-base, the L2 8-NN
     over 89 513 x 768 rows, the prior, the flow and the NSF generator;
     weights the benchmark's draw from the seed) on a 100 s stereo take at
     44.1 kHz, its counters zeroed before and read after: three segments,
     so ``knn`` and ``knn_merge`` 3 launches each, ``hifigan_conv`` 216,
     crossings 3 up and 2 down, and each of the segment's spans three
     times.  Every kNN row also
     records ``kernel_ms``, its form's kernels alone (torch.profiler),
     ``library_norm_ms``, ``matmul`` + ``topk`` with the normalisation of
     both operands (the function's whole work; ``library_ms`` starts from
     normalised operands), and the plan (``grid``);
  3. the main path end to end at full model width (default configs, random
     weights from a seed, a 100 352 x 768 library from the seed):
     ``OfflineConverter.convert_16k`` answers three requests (10 s, 30 s,
     61 s) in bf16 and in fp32, each crossing between host and card once
     each way (``CROSSINGS``), one ``convert_window`` step at the bench
     shape (64 windows x 144 000 samples) in bf16 and one in fp32 (kNN
     'high', the exact-ranking mode), and the bf16 licence's log-mel L1.
     The 10 s request also goes through ``OfflineConverter(world_pitch=True)``
     in bf16 and fp32: WORLD labels the pitch on the host (its host time is
     printed beside the request's wall time), every offline kernel must
     launch and the F0 estimator must not run (a forward hook counts its
     calls, and must see the one plain step after).
     Launch counters are zeroed just before this phase and read just after
     it: every kernel must have run.  Both bench-shape steps are profiled by
     kernel group (the filter's narrow and wide kernels apart, and their
     sum as filter_level; the kNN prep, tile, merge and carried kernels
     apart, and their sum as knn), and a device span named ``filter``
     outside the filter_narrow and filter_wide groups, ``osc_`` outside the
     oscillator group, or ``knn`` outside the kNN groups, fails the run.  Then the licence's kNN flip rate (direct
     kernel calls; gated on phase 3's library, and reported on four more
     library draws) and small-input checks of the card's output against the
     plain versions on the CPU (f0 given; and with WORLD's f0, which is the
     same host computation on both sides), none of them counted.
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
  6. the realtime path at full width: ``StreamingConverter`` (8-chunk window
     of 960-sample hops, a target matrix of a 30 s voice decimated x4 plus
     512 library tokens, 887 rows).  The eager hop, counters zeroed before
     its 50 hops and read after, must launch the STFT, kNN, streaming source
     and filter-level kernels (the narrow and the wide); the hop replayed as one CUDA graph must equal it (<= 1e-5 over
     50 hops); the pipelined graph (depth 1) must equal the synchronous one
     delayed by a hop, exactly; one hop on the card against the plain hop on
     the CPU (f0 given) within 5e-3 (waveform) and 0.25 rad (phi).  Then the
     kernels at the hop's shapes against their plain versions (each filter
     level with its grid; the streaming source with its phase bit-equal, its
     device time alone, the chain's bound and ``torch.cumsum`` alone on the
     same increments as the library call), the per-hop latency (median, p90, p99 over 200
     hops) of the eager, graph and pipelined graph forms and the real-time
     factor, a profile of 20 hops of each form by kernel group.  Then the
     same three forms with ``world_pitch=True`` (f0 from WORLD on the host,
     copied into the graph's static f0 input each hop): the eager hop
     counted, the F0 estimator never run, the graph hop equal to the eager
     one (<= 1e-5 over 50 hops), the pipelined graph equal to the
     synchronous one delayed by a hop, and each form's per-hop latency with
     WORLD's host ms a hop, over WPE_LATENCY_HOPS = 60 hops, and the
     device's busy share of 20 graph hops (profiled).  Last, both CLIs in
     file mode on a 44.1 kHz wav, plain and with ``-wpe`` (counted, each its
     own window).  The phase must finish within 60 s.  WORLD takes 18-34 ms
     a hop on the host, by the host, so the ``-wpe`` forms' latency runs 60
     hops, not the plain forms' 200: at 200, one run's phase 6 took 56.4 s.
  7. the frame-rate models sharded along time at full width: a 600 s
     synthetic utterance (30 000 frames, its spectrogram by the STFT kernel,
     counted) through the content encoder, the F0 estimator and the feature
     extractor as 2 gloo ranks on the one card, 15 000 frames a rank, with a
     halo exchange at each depthwise conv; each rank's slice against the
     dense model on the whole input (<= 1e-4, TF32 off), each rank's time,
     the dense time (rank 0 alone on the card), the halo bytes each rank
     sends and gathers a layer, and rank 0's profile of one sharded
     content-encoder pass.

  8. training at full width, float32, random weights from seed 0 (the F0
     estimator's output bias raised at 120 Hz, so its f0 is a speech pitch):
     each kernel ``Function`` (the four filter levels at 8 x 38 400 samples,
     the Chebyshev source, the STFT) against its plain version, forward and
     the gradient of every input, with the backward's time; five
     ``gan_train_step``s at 8 x 38 400 after two warm-ups (ms/step, peak
     memory, launches a step: filter_level 8 (filter_narrow 4, filter_wide
     4), oscillator 2, stft 2; one step
     profiled by group, the plain backward recompute apart); every decoder
     and discriminator parameter with a finite, nonzero gradient; one GAN
     step on the card against the CPU at 1 x 9 600 (losses, per-module
     gradient norms); two ``fine_tune_step``s with a 512-token library (the
     kNN kernel once a step), five ``f0_train_step``s at 8 x 65 536,
     ``generate_voice_library`` over 512 chunks; ``gan_grads`` on 2 gloo
     ranks on the one card against the same semantics computed densely; the
     ``train_decoder`` and ``train_f0_estimator`` CLIs on synthetic WAVs.
     The phase must finish within 90 s.
  9. distillation and export at full width, float32 without TF32: the
     default WavLM teacher (94 M parameters, a Hugging Face state dict drawn
     from the seed, written to a temporary ``.pt`` and loaded by
     ``io/teacher.py``) extracting features for 16 x 65 536 (ms, peak
     memory; one chunk against the CPU within 1e-4); five ``distill_step``s
     of the default content encoder at 16 x 65 536 after a warm-up (ms/step,
     peak memory, the STFT kernel exactly once a step and nothing else, one
     step profiled); one step's loss and per-module gradient norms against
     the CPU at 2 x 65 536; ``distill_grads`` on 2 gloo ranks on the one
     card against the dense gradients (the worst tensor); the
     ``train_content_encoder`` CLI for 2 steps with ``--wavlm-checkpoint``
     and with ``--teacher-features``, then ``inference -cep`` on the
     training state; ``cli/export.py`` at --length 256 on the card, each
     ``.pt2`` loaded and held against the port's eager kernel path, the
     ``--torch-out`` files loaded strictly, the eager path unchanged after
     the export; the STFT kernel's row at [16, 65 536].  The phase must
     finish within 90 s.
  10. resume, at full width, float32 without TF32: the GAN (8 x 38 400),
     fine-tuning with a 512-token library (the kNN kernel 'highest' on 960
     queries x 512 tokens), the F0 trainer (RAdam, 8 x 65 536) and
     distillation (RAdam, 16 x 65 536), each carried through the JAX
     package's ``.ckpt`` layout (``compat/jax_train_state.py``): run A takes
     3 GAN steps (2 for the others) uninterrupted, A' the same again (the
     card's repeat spread), B all but the last, ``write``, fresh modules and
     optimizers from ``read``, the last; the control is B with the moments
     zeroed, what a resume of the models alone gives.  The worst tensor over
     the parameters and both moments, relative to its largest entry, of B,
     A' and the control against A: B within the trainer's RESUME_TOL, the
     control above it.  The GAN file's key set and shapes equal the layout ``write`` forms
     for a freshly built state, and the file read and written again is
     bit-equal; each file's size and write and read seconds.  Counters
     zeroed before the runs and read after: the filter, oscillator, STFT
     and kNN kernels must each launch.  Then the deterministic sub-run, a
     process of its own (CUBLAS_WORKSPACE_CONFIG=:4096:8 set before cuBLAS
     starts, so no other phase runs under it): the GAN and fine-tuning runs
     A, A' and B under ``torch.use_deterministic_algorithms(True,
     warn_only=True)`` with cuDNN's autotuner off, every op that warned
     printed; with none, A' and B must equal A within 1e-6, else B keeps its
     gate.  The phase must finish within 90 s (60 s before the sub-run).
  11. the CLIs' default chain at full width in a temporary working
     directory, on the JAX package's ``.ckpt`` names: ``train_content_encoder
     --wavlm-checkpoint`` (phase 9's seed-drawn teacher as a local ``.pt``),
     ``train_f0_estimator``, ``generate_voice_library``, ``train_decoder``,
     ``fine_tune -dep gan_state.ckpt -disp gan_state.ckpt`` and ``inference``
     on a 10 s file, 2 steps a trainer; every model a stage builds from a
     file must hash (state dict, sha256) to the file an earlier stage wrote;
     each stage's wall time and launches.  The phase must finish within
     60 s.

Its last lines are the ``kernels`` JSON line, the nvidia-smi line, and
``{"ok": true, "device": {...}}``.  Float32 products run without TF32
(``torch.backends.cuda.matmul.allow_tf32 = False``); float32 convolutions
too (``torch.backends.cudnn.allow_tf32 = False``), as in the port's fp32
mode.
"""

from __future__ import annotations

import contextlib
import json
import math
import statistics
import subprocess
import sys
import time
from unittest import mock

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
KNNVC_ROWS = 23_947             # offline-knnvc-libri's matching set: 480 s of speech, WavLM's frames
KNNVC_QUERIES = (370, 1_240)    # the frames of its mean (7.4 s) and longest (~25 s) files
KNNVC_MEAN_S = 7.4              # its mean file, seconds at 16 kHz (370 frames)
RVC_INDEX_ROWS = 89_513         # offline-rvc40k-vocals' index: HuBERT's frames of 1 800 s in 3.7 s pieces
RVC_QUERIES = 2_150             # HuBERT's frames of one 41 s segment with its 1 s of padding each side
RVC_STAGE_ROWS = 1_720_000      # that segment's last generator stage at C = 32 (4 300 frames x 400)
RVC_TAKE_S = 100.0              # three segments: cuts near 38 and 76 s
OFFLINE_KERNELS = ("stft", "knn_prep", "knn", "knn_merge", "oscillator", "filter_level", "filter_narrow",
                   "filter_wide")
SHARDED_KERNELS = ("knn_prep", "knn", "knn_merge", "oscillator", "filter_level", "filter_narrow", "filter_wide")
API_KERNELS = ("knn_packed", "knn_carried_packed", "oscillator_formants")


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


def check_stft(gen, n=N_STEP, length=LW, tag=""):
    import torch
    from alivevc_tpu_torch.kernels.stft import stft_magnitude_cuda, stft_magnitude_plain

    x = 0.3 * torch.randn(n, length, generator=gen, device="cuda")
    got = stft_magnitude_cuda(x)
    want = stft_magnitude_plain(x)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    # float32 sums of 1280 products, taken in another order
    need(got.shape == want.shape and err <= 1e-3, f"stft: max abs err {err} > 1e-3")
    n_frames = n * got.shape[1]
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
        "name": "stft", "variant": f"[{n}, {length}] f32{tag}",
        "max_abs_err": err, "tol": 1e-3,
        "ms": cuda_ms(lambda: stft_magnitude_cuda(x)),
        "plain_ms": cuda_ms(lambda: stft_magnitude_plain(x), 2),
        "library_ms": cuda_ms(library_call),
        "bound_ms": b, "bound_by": by,
    }


def check_knn(gen, lib_rows, precision, valid_rows=None, penalty=False, extraction="auto",
              ls=N_STEP * LF, suffix="", form=None, dim=768):
    """One kNN variant: ``valid_rows`` (a device scalar, as the sharded path
    passes it), a 0/-4 ``penalty`` column, or the packed extraction; ``ls``
    queries (the streaming hop's 24) of ``dim`` features (kNN-VC's 1 024
    beside ALiVE-VC's 768); the form ``knn_plan`` routes the
    library to, or ``form`` forced.  The row's name is its form's kernel
    ('knn' / 'knn_packed': the two-pass form; 'knn_carried' /
    'knn_carried_packed': the carried form).  Beside the wrapper's time, the
    form's kernels alone (``kernel_ms``, torch.profiler), and two library
    columns: ``matmul`` + ``topk`` on operands normalised beforehand
    (``library_ms``), and with the normalisation (``library_norm_ms``, the
    same work as the function)."""
    import torch
    from alivevc_tpu_torch.kernels.knn import (
        knn_plan,
        knn_topk_cuda,
        knn_topk_plain,
        prep_operands,
    )

    q = torch.randn(ls, dim, generator=gen, device="cuda")
    lib = torch.randn(lib_rows, dim, generator=gen, device="cuda")
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
    plan = knn_plan(ls, lib_rows, precision, 4, form=form, packed=packed)
    name = ("knn_carried" if plan.form == "carried" else "knn") + ("_packed" if packed else "")
    kw["form"] = plan.form
    v, i = knn_topk_cuda(q, lib, 4, precision, **kw)
    plain_kw = {key: val for key, val in kw.items() if key != "form"}
    pv, pi = knn_topk_plain(q, lib, 5, precision, **plain_kw)
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

    def library_call(normalise=False):
        a, b = prep_operands(q, lib, precision) if normalise else (src, lb)
        s = a @ b.t()
        if valid_rows is not None:
            s[:, valid_rows:] = float("-inf")
        if penalty:
            s = s + kw["penalty"]
        torch.topk(s, 4, dim=1)

    # the function reads float32 queries and the rows it ranks (plus the
    # penalty), writes values + indices (the two-pass form also writes and
    # reads its prepared planes once); products over the rows it ranks,
    # on the tensor cores: bf16 for 'default', three TF32 products (3xTF32,
    # float32-faithful) for 'high'/'highest'
    nbytes = (ls + rows) * dim * 4 + ls * 4 * 8 + (lib_rows * 4 if penalty else 0)
    if plan.form == "twopass":   # the prep's planes, written once and read once
        nbytes += 2 * (ls + rows) * dim * (2 if precision == "default" else 8)
    flops = 2.0 * ls * rows * dim
    if precision == "default":
        b, by = bound_ms(nbytes, flops, PEAK_BF16)
    else:
        b, by = bound_ms(nbytes, 3.0 * flops, PEAK_TF32)
    keys = ("knn_carried",) if plan.form == "carried" else ("knn_prep", "knn_tile", "knn_merge")
    return {
        "name": name,
        "variant": f"{ls} x {lib_rows} x {dim} {precision}{tag}{suffix}",
        "max_abs_err": err, "tol": tol, "index_sets_differing": bad,
        "ms": cuda_ms(lambda: knn_topk_cuda(q, lib, 4, precision, **kw)),
        "kernel_ms": kernel_device_ms(lambda: knn_topk_cuda(q, lib, 4, precision, **kw), keys),
        "plain_ms": cuda_ms(lambda: knn_topk_plain(q, lib, 4, precision, **plain_kw), 2),
        "library_ms": cuda_ms(library_call),
        "library_norm_ms": cuda_ms(lambda: library_call(True)),
        "bound_ms": b, "bound_by": by,
        "grid": {k: val for k, val in plan._asdict().items() if val or k == "form"},
    }


def check_knn_merge(gen, lib_rows, precision, ls=N_STEP * LF, valid_rows=None, suffix="", dim=768):
    """The kNN merge (``knn_merge_kernel``, pass B of ``csrc/knn.cu``) on its
    own, on the candidates a two-pass kNN call at this shape gives it (the
    two-pass form forced where the library is small enough for the carried
    form, which merges inside its own launch): its outputs
    against ``merge_plain`` on the same candidates (values and indices
    exact: both take the top k by score, ties to the smallest index); its
    device time alone (torch.profiler, the tile kernel left out); the plain
    merge's time; one ``torch.topk`` over the candidates flattened to [Ls,
    chunks * kk] plus the ``torch.gather`` of their row indices (the library
    call); and its bound, bytes: the candidates read once, the outputs
    written once."""
    import torch
    from alivevc_tpu_torch.kernels.knn import knn_topk_cuda, knn_topk_launch, merge_plain

    q = torch.randn(ls, dim, generator=gen, device="cuda")
    lib = torch.randn(lib_rows, dim, generator=gen, device="cuda")
    kw, tag = {}, ""
    if valid_rows is not None:
        kw["valid_rows"] = torch.tensor(valid_rows, device="cuda")
        tag = f" valid_rows={valid_rows}"
    out_v, out_i, cand_v, cand_i = knn_topk_launch(q, lib, 4, precision, **kw)
    kk, n_chunks = cand_v.shape[2], cand_v.shape[1]
    pv, pi = merge_plain(cand_v, cand_i, kk)
    torch.cuda.synchronize()
    err = float((out_v - pv).abs().max())
    bad = int((out_i != pi).any(1).sum())
    need(err == 0.0 and bad == 0,
         f"knn merge[{precision},{lib_rows}{tag}]: max abs err {err}, {bad} index lists differ")
    flat_v, flat_i = cand_v.reshape(ls, -1), cand_i.reshape(ls, -1)

    def library_call():
        col = torch.topk(flat_v, kk, dim=1).indices
        torch.gather(flat_i, 1, col)

    nbytes = cand_v.numel() * 4 + cand_i.numel() * 4 + out_v.numel() * 4 + out_i.numel() * 4
    b, by = bound_ms(nbytes, 0.0, PEAK_F32)
    ms = kernel_device_ms(lambda: knn_topk_cuda(q, lib, 4, precision, form="twopass", **kw),
                          ("knn_merge_kernel",))
    need(ms is not None, "knn merge: the profiler recorded no device time for knn_merge_kernel")
    return {
        "name": "knn_merge",
        "variant": f"merge of {ls} x {lib_rows} x {dim} {precision}{tag}{suffix}",
        "max_abs_err": err, "tol": 0.0, "index_lists_differing": bad,
        "candidates": [ls, n_chunks, kk],
        "ms": ms,
        "plain_ms": cuda_ms(lambda: merge_plain(cand_v, cand_i, kk), 2),
        "library_ms": cuda_ms(library_call),
        "bound_ms": b, "bound_by": by,
    }


def check_knn_prep(gen, lib_rows, precision, ls=N_STEP * LF, dim=768, suffix="", normalize=True):
    """The two-pass form's prep launch (``knn_prep_kernel``: both operands
    normalised, or as they are in the L2 mode, into bf16, or TF32 hi and lo
    planes) against its plain version, ``knn_prep_plain``, plane by plane
    and bit for bit (tolerance 0): both take each row's scale from
    ``row_scales`` (one in the L2 mode) and round the product once, then
    cast to bf16 or split; its device time alone (torch.profiler).  No one
    PyTorch call computes it.  Bound: bytes, the float32 rows read once and
    the planes written once."""
    import torch
    from alivevc_tpu_torch.kernels.knn import knn_prep_cuda, knn_prep_plain

    q = torch.randn(ls, dim, generator=gen, device="cuda")
    lib = torch.randn(lib_rows, dim, generator=gen, device="cuda")
    got = knn_prep_cuda(q, lib, precision, normalize=normalize)
    want = knn_prep_plain(q, lib, precision, normalize=normalize)
    torch.cuda.synchronize()
    err = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
    differ = sum(int((g.view(torch.int16 if g.dtype == torch.bfloat16 else torch.int32)
                      != w.view(torch.int16 if w.dtype == torch.bfloat16 else torch.int32)).sum())
                 for g, w in zip(got, want))
    tol = 0.0
    need(differ == 0 and err <= tol,
         f"knn prep[{precision},{lib_rows}]: {differ} values differ from the plain planes, max abs err {err}")
    nbytes = (ls + lib_rows) * dim * (4 + (2 if precision == "default" else 8))
    b, by = bound_ms(nbytes, 0.0, PEAK_F32)
    ms = kernel_device_ms(lambda: knn_prep_cuda(q, lib, precision, normalize=normalize), ("knn_prep",))
    need(ms is not None, "knn prep: the profiler recorded no device time for knn_prep_kernel")
    return {
        "name": "knn_prep",
        "variant": f"prep of {ls} x {lib_rows} x {dim} {precision}{suffix}",
        "max_abs_err": err, "tol": tol,
        "ms": cuda_ms(lambda: knn_prep_cuda(q, lib, precision, normalize=normalize)),
        "kernel_ms": ms,
        "plain_ms": cuda_ms(lambda: knn_prep_plain(q, lib, precision, normalize=normalize), 2),
        "library_ms": None,
        "bound_ms": b, "bound_by": by,
    }


def check_knn_wide():
    """The kNN-VC cell's retrieval: ``KNNVC_QUERIES`` queries (its mean and
    longest files' frames) of 1 024 features against a matching set of
    ``KNNVC_ROWS`` rows, 'high', through the two-pass tile, its merge and its
    prep, each held to its plain version as the 768-wide rows are.  A
    generator of their own, so that the other rows draw as before."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED + 21)
    rows = [check_knn(gen, KNNVC_ROWS, "high", ls=ls, dim=1024, suffix=" (kNN-VC)") for ls in KNNVC_QUERIES]
    rows.append(check_knn_merge(gen, KNNVC_ROWS, "high", ls=KNNVC_QUERIES[0], dim=1024, suffix=" (kNN-VC)"))
    rows.append(check_knn_prep(gen, KNNVC_ROWS, "high", ls=KNNVC_QUERIES[0], dim=1024, suffix=" (kNN-VC)"))
    return rows


def check_knn_l2():
    """The RVC cell's retrieval: the L2 mode (``l2_topk``: the operands as
    they are, the penalty -|x|^2 / 2, k = 8, 'high') of the two-pass tile,
    ``RVC_QUERIES`` queries near rows of an ``RVC_INDEX_ROWS`` x 768 index,
    against ``knn_topk_plain(normalize=False)`` on the card in float32 with
    TF32 off, as ``tests/test_torch_port_gpu.py`` holds it: scores within
    2e-5 of the largest |q| |x|, the sets of 8 rows equal wherever the plain
    8th and 9th scores are further apart than twice that; and its prep
    launch with unit row scales.  The library call: ``matmul`` plus the
    penalty and ``topk``, in float32.  A generator of its own."""
    import torch
    from alivevc_tpu_torch.device import float32_math
    from alivevc_tpu_torch.kernels.knn import knn_topk_plain, l2_penalty, l2_topk

    gen = torch.Generator(device="cuda").manual_seed(SEED + 26)
    ls, rows, dim = RVC_QUERIES, RVC_INDEX_ROWS, 768
    lib = torch.randn(rows, dim, generator=gen, device="cuda")
    q = lib[torch.randint(0, rows, (ls,), generator=gen, device="cuda")] + \
        0.7 * torch.randn(ls, dim, generator=gen, device="cuda")
    pen = l2_penalty(lib)
    with float32_math():
        v, i = l2_topk(q, lib, pen)
        pv, pi = knn_topk_plain(q, lib, 9, "high", penalty=pen, normalize=False)
        torch.cuda.synchronize()
        err = float((v - pv[:, :8]).abs().max())
        tol = 2e-5 * float(q.norm(dim=1).max() * lib.norm(dim=1).max())
        clear = (pv[:, 7] - pv[:, 8]) > 2 * tol
        same = (torch.sort(i, 1).values == torch.sort(pi[:, :8], 1).values).all(1)
        bad = int((clear & ~same).sum())
        need(err <= tol and bad == 0, f"knn L2[high,{rows}]: max abs err {err} (tol {tol}), {bad} index sets differ")

        def library_call():
            torch.topk(q @ lib.t() + pen, 8, dim=1)

        # the float32 queries, rows and penalty read once, the outputs written
        # once, the prep's planes written once and read once; 3xTF32 products
        nbytes = (ls + rows) * dim * 4 + rows * 4 + ls * 8 * 8 + 2 * (ls + rows) * dim * 8
        b, by = bound_ms(nbytes, 3.0 * 2.0 * ls * rows * dim, PEAK_TF32)
        row = {
            "name": "knn",
            "variant": f"{ls} x {rows} x {dim} high L2 k=8 (RVC)",
            "max_abs_err": err, "tol": tol, "index_sets_differing": bad, "near_ties": int((~clear).sum()),
            "ms": cuda_ms(lambda: l2_topk(q, lib, pen)),
            "kernel_ms": kernel_device_ms(lambda: l2_topk(q, lib, pen), ("knn_prep", "knn_tile", "knn_merge")),
            "plain_ms": cuda_ms(lambda: knn_topk_plain(q, lib, 8, "high", penalty=pen, normalize=False), 2),
            "library_ms": cuda_ms(library_call),
            "bound_ms": b, "bound_by": by,
        }
    return [row, check_knn_prep(gen, rows, "high", ls=ls, suffix=" L2 (RVC)", normalize=False)]


HIFIGAN_STAGES = ((256, 3_700), (128, 29_600), (64, 59_200), (32, 118_400))   # C, rows at 370 frames
HIFIGAN_TOL = 1e-4   # tests/test_torch_port_gpu.py's, of max(1, the plain stage's peak)


def check_hifigan_stages(stages=HIFIGAN_STAGES, suffix="kNN-VC vocoder", seed=SEED + 25):
    """The kNN-VC vocoder's ResBlocks (or ``stages``: C and rows, such as
    the RVC generator's last stage), a stage a row: ``models/hifigan.py:
    _resblocks`` (18 kernel launches) against the same convs through
    ``hifigan_conv_plain``, the library call the channels-first cuDNN
    composition the vocoder ran before.  The bound: each conv's 3xTF32
    operations at 495 / 3 TFLOP/s, or its bytes (x and out, the residual
    for the second of a pair, the running sum for the last conv of every
    stack past the first) at the card's memory rate, the larger, summed.
    Weights at nn.Conv1d's initial range, from a generator of their own.
    Both vocoders' ResBlocks take (3, 7, 11) taps at dilations (1, 3, 5)."""
    import torch
    import torch.nn.functional as F
    from alivevc_tpu_torch.config import HiFiGANConfig
    from alivevc_tpu_torch.kernels import hifigan as kh
    from alivevc_tpu_torch.models import hifigan as mh

    cfg = HiFiGANConfig()
    slope, stacks = cfg.lrelu_slope, len(cfg.resblock_kernel_sizes)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    with torch.random.fork_rng(devices=[]):   # the modules' initial draws leave the global generator as it was
        torch.manual_seed(seed)
        blocks_at = [[mh._ResBlock1(c, k, d).cuda().eval()
                      for k, d in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes)] for c, _ in stages]
    rows = []
    for (c, length), blocks in zip(stages, blocks_at):
        x = torch.randn(1, length, c, generator=gen, device="cuda")
        xc = x.transpose(1, 2).contiguous()

        def plain_conv(x, conv, slope, res=None, acc=None, stack=None):
            return kh.hifigan_conv_plain(x, conv.weight, conv.bias, conv.dilation[0], slope, res, acc, stack)

        def plain():
            with mock.patch.object(mh, "hifigan_conv", plain_conv):
                return mh._resblocks(blocks, x, slope)

        def library_call():   # the channels-first composition on cuDNN's float32 convs
            def conv(m, v):
                return F.conv1d(v, m.weight, m.bias, padding=m.padding, dilation=m.dilation)
            xs = None
            for b in blocks:
                h = xc
                for c1, c2 in zip(b.convs1, b.convs2):
                    h = h + conv(c2, F.leaky_relu(conv(c1, F.leaky_relu(h, slope)), slope))
                xs = h if xs is None else xs + h
            return xs / stacks

        got = mh._resblocks(blocks, x, slope)
        want = plain()
        torch.cuda.synchronize()
        err = float((got - want).abs().max()) / max(1.0, float(want.abs().max()))
        need(err <= HIFIGAN_TOL, f"hifigan_conv C={c}: err {err} > {HIFIGAN_TOL}")
        bounds = []
        for s, (k, dils) in enumerate(zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes)):
            for p in range(len(dils)):
                # c1 reads x and writes out; c2 reads the residual too, and the last of a stack
                # past the first the running sum
                for arrays in (2, 3 + (p == len(dils) - 1 and s > 0)):
                    bounds.append(bound_ms(arrays * length * c * 4, 2 * length * k * c * c, PEAK_TF32 / 3))
        kinds = sorted({by for _, by in bounds})
        rows.append({
            "name": "hifigan_conv", "variant": f"[1, {length}, {c}] 18 convs f32 ({suffix})",
            "max_abs_err": err, "tol": HIFIGAN_TOL,
            "ms": cuda_ms(lambda: mh._resblocks(blocks, x, slope)),
            "plain_ms": cuda_ms(plain, 2),
            "library_ms": cuda_ms(library_call),
            "bound_ms": sum(b for b, _ in bounds), "bound_by": " and ".join(kinds),
            "grid": [kh.conv_plan(1, length, c, k, 1, kh.sm_count(0)) for k in cfg.resblock_kernel_sizes],
        })
    return rows


def run_knnvc_path(card):
    """The kNN-VC cell's path at full width: ``KnnVCConverter.convert``
    (WavLM-Large to layer 6, the 4-NN mean in 'high' over a ``KNNVC_ROWS``
    x 1 024 matching set, the vocoder), weights and matching set from the
    seed, on one 16 kHz file of the cell's mean length.  The first convert
    warms up; the counters are zeroed just before the second and read just
    after, under the profiler: ``hifigan_conv`` must launch 72 times (4
    stages x 3 stacks x 3 dilations x 2 convs), the two-pass kNN kernels
    each at least once, and inside ``knnvc.vocoder`` the profiler must see
    six convolutions (conv_pre, the four transposed convs, conv_post) and no
    other.  Returns the counts."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from alivevc_tpu_torch.config import HiFiGANConfig
    from alivevc_tpu_torch.infer.offline import KnnVC, KnnVCConverter
    from alivevc_tpu_torch.kernels import LAUNCHES, reset_launches
    from alivevc_tpu_torch.models.hifigan import HiFiGAN
    from alivevc_tpu_torch.models.wavlm import WAVLM_LARGE, WavLM
    from alivevc_tpu_torch.utils.profiling import PREFIX

    with torch.random.fork_rng(devices=[0]):    # the other phases draw as before
        torch.manual_seed(SEED + 26)
        with torch.device("cuda"):
            model = KnnVC(WavLM(WAVLM_LARGE).eval(), HiFiGAN(HiFiGANConfig()).eval(), 6)
            mset = torch.randn(KNNVC_ROWS, 1024)
    conv = KnnVCConverter(model, mset, device="cuda")
    wave = request_wave(KNNVC_MEAN_S, np.random.default_rng(SEED + 26))
    conv.convert(wave, 16_000)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = conv.convert(wave, 16_000)
    dt = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    events = prof.events()
    spans = [e.time_range for e in events if e.name == PREFIX + "knnvc.vocoder"]
    need(len(spans) == 1, f"kNN-VC path: {len(spans)} knnvc.vocoder spans, expected 1")
    convs = sum(e.name == "aten::convolution" and spans[0].start <= e.time_range.start <= spans[0].end
                for e in events)
    print(f"kNN-VC path [{card}]: KnnVCConverter.convert of {KNNVC_MEAN_S} s at 16 kHz, WavLM-Large to "
          f"layer 6, {KNNVC_ROWS} x 1024 matching set 'high': {dt:.3f} s wall (profiled); launches {launches}; "
          f"convolutions inside knnvc.vocoder {convs} (expected 6)")
    need(out.shape == wave.shape and bool(np.isfinite(out).all()),
         f"kNN-VC path: output {out.shape}, finite {bool(np.isfinite(out).all())}")
    need(launches["hifigan_conv"] == 72, f"kNN-VC path: hifigan_conv launched {launches['hifigan_conv']} times, "
                                         f"expected 72")
    need(all(launches[k] > 0 for k in ("knn_prep", "knn", "knn_merge")), f"kNN-VC path: launches {launches}")
    need(convs == 6, f"kNN-VC path: {convs} convolutions inside knnvc.vocoder, expected 6")
    return launches


RVC_SPANS = {"offline.convert": 1, "rvc.highpass": 1, "rvc.split": 1, "offline.step": 3, "rvc.content": 3,
             "rvc.match": 3, "rvc.prior": 3, "rvc.vocoder": 3, "rvc.source": 3}


def run_rvc_path(card):
    """The RVC cell's path at full width: ``RvcConverter.convert`` (HuBERT-
    base to layer 12, the L2 8-NN in 'high' over an ``RVC_INDEX_ROWS`` x 768
    index, the prior, the reversed flow and the NSF generator at 40 kHz),
    the weights the benchmark's draw (``vcbench/configs/rvc-v2-40k-fp32.json``)
    from the seed, the index rows from the seed, on a stereo take of
    ``RVC_TAKE_S`` s at 44.1 kHz sung by the cell's voice with its F0 curve.
    Every draw takes a generator of its own.  The first convert warms up;
    the counters are zeroed just before the second and read just after,
    under the profiler: three segments, so ``knn`` and ``knn_merge`` 3
    launches each (and no carried form), ``hifigan_conv`` 216 (3 x 72),
    crossings 3 up and 2 down, and the spans ``RVC_SPANS`` counts.  Returns
    the launches."""
    import numpy as np
    import torch
    from pathlib import Path
    from torch.profiler import ProfilerActivity, profile

    from alivevc_tpu_torch.infer import offline
    from alivevc_tpu_torch.infer.offline import RvcConverter
    from alivevc_tpu_torch.kernels import LAUNCHES, reset_launches
    from alivevc_tpu_torch.utils.profiling import PREFIX

    vcbench = Path(__file__).resolve().parent / "vcbench"
    if str(vcbench) not in sys.path:
        sys.path.insert(0, str(vcbench))
    import program_rvc
    import weights
    from reference import rvc as ref
    from traffic.offline_rvc import sung

    conf = json.loads((vcbench / "configs" / "rvc-v2-40k-fp32.json").read_text())
    voice = json.loads((vcbench / "traffic" / "musdb_vocals_44k.json").read_text())["voice"]
    params = weights.draw(ref.param_specs(conf["model"]), torch.Generator(device="cuda").manual_seed(SEED + 27),
                          "cuda")
    model, dcfg = program_rvc.build_model(conf["model"], params)
    g = torch.Generator(device="cuda").manual_seed(SEED + 28)
    index = torch.randn(RVC_INDEX_ROWS, 768, generator=g, device="cuda")
    wave, curve = sung(g, int(RVC_TAKE_S * 44_100), 44_100, voice, "cuda")
    wave = torch.stack([0.9 * wave, 0.8 * wave]).cpu().numpy()
    curve = curve.cpu().numpy()
    conv = RvcConverter(model, index, dcfg, device="cuda")
    conv.convert(wave, 44_100, f0=curve, generator=torch.Generator(device="cuda").manual_seed(SEED + 29))
    torch.cuda.synchronize()
    reset_launches()
    offline.reset_crossings()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = conv.convert(wave, 44_100, f0=curve, generator=torch.Generator(device="cuda").manual_seed(SEED + 29))
    dt = time.perf_counter() - t0
    launches, crossings = dict(LAUNCHES), dict(offline.CROSSINGS)
    spans = {name: sum(e.name == PREFIX + name for e in prof.events()) for name in RVC_SPANS}
    print(f"RVC path [{card}]: RvcConverter.convert of a {RVC_TAKE_S:.0f} s stereo take at 44.1 kHz, HuBERT-base, "
          f"L2 8-NN over {RVC_INDEX_ROWS} x 768 'high', the NSF generator at 40 kHz: {dt:.3f} s wall (profiled), "
          f"cuts {conv.last_cuts}; launches {launches}; crossings {crossings}; spans {spans}")
    seconds = out.shape[0] / conv.output_rate     # RVC's frames drop a few samples a segment
    need(out.ndim == 1 and abs(seconds - RVC_TAKE_S) < 0.1 and bool(np.isfinite(out).all()),
         f"RVC path: output {out.shape} ({seconds:.3f} s), finite {bool(np.isfinite(out).all())}")
    need(len(conv.last_cuts) == 2, f"RVC path: cuts {conv.last_cuts}, expected 2")
    need(launches["knn"] == 3 and launches["knn_merge"] == 3 and launches["knn_prep"] == 3
         and launches["knn_carried"] == 0, f"RVC path: kNN launches {launches}, expected 3 two-pass calls")
    need(launches["hifigan_conv"] == 216, f"RVC path: hifigan_conv launched {launches['hifigan_conv']} times, "
                                          f"expected 216")
    need(crossings == {"to_card": 3, "to_host": 2}, f"RVC path: crossings {crossings}, expected 3 up and 2 down")
    need(spans == RVC_SPANS, f"RVC path: spans {spans}, expected {RVC_SPANS}")
    return launches


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


def filter_grid(n, l_in, cin, c, r, length, k, dilations, dtype, frames):
    """A level's launches as ``kernels/filter.py`` plans them: a narrow level
    (C = 8, 16) the weights' launch and one of ``filter_narrow_kernel``,
    planned by ``narrow_plan`` (the rows a tile computes, the samples it
    writes, the lookback's share of its rows, warpgroups a block, ring
    stages, tiles, blocks of the persistent grid); a wide level the
    weights' launch and 8 of ``filter_wide_kernel``, each [tm, tn, split,
    blocks] by ``wide_plan`` (blocks = tiles x split, which the persistent
    grid caps at one wave)."""
    import torch
    from alivevc_tpu_torch.kernels.filter import narrow_plan, takes_narrow, wide_launches, wide_plan

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if takes_narrow(c, cin, r, k, dilations):
        p = narrow_plan(n, length, cin, c, r, dtype, length // frames, k, tuple(dilations), sms)
        return {"launches": 2, **{key: p[key] for key in ("rows", "T", "share", "owners", "wpt", "stages",
                                                          "tiles", "blocks")}}
    plans = [wide_plan(*spec, dtype, sms) for spec in wide_launches(n, l_in, cin, c, r, k, len(dilations))]
    return {"launches": 9, "plans": [[p["tm"], p["tn"], p["split"], p["ctas"]] for p in plans]}


def form_bytes(n, l_in, cin, c, r, n_conv, film_frames, weights, isz, wide):
    """Bytes the level's launches move, each launch's inputs read once and
    its output written once: the narrow route's (x_prev, skip, FiLM,
    weights in; the level out; its weights' launch moves a few kilobytes
    more, not counted), or the wide route's 9 (the weights
    read and written K-major, float32 as TF32 hi + lo; the up conv; the
    1x1; each causal conv reads its operand and its FiLM columns and writes
    its output, the second of a block also reads the residual)."""
    length = l_in * r
    io = 2 * n * l_in * cin
    film = n * film_frames * 2 * n_conv * c
    if not wide:
        return isz * (io + n * length * c + film + weights)
    act = n * length * c
    k_major = weights * (isz if isz == 2 else 8)     # the weights as the products read them
    return (weights * isz + 2 * k_major
            + isz * (io + act + 2 * act + n_conv * 2 * act + n_conv // 2 * act + film))


def check_filter_levels(gen, dec, n=N_STEP, lw=LW, dtypes=("f32", "bf16"), tag=""):
    """The four up levels for ``n`` windows of ``lw`` samples (FiLM at
    ``lw / 320`` frames), in each of ``dtypes``."""
    import torch
    from alivevc_tpu_torch.infer.offline import cast_params
    from alivevc_tpu_torch.kernels.filter import filter_level_cuda, filter_level_plain, takes_narrow
    from alivevc_tpu_torch.models.decoder import level_args

    cfg = dec.cfg
    lens = [lw // 32, lw // 4, lw // 2, lw]          # output length of up level i
    cond32 = 0.5 * torch.randn(n, lw // 320, cfg.channels, generator=gen, device="cuda")
    rows = []
    for dt in (torch.float32 if d == "f32" else torch.bfloat16 for d in dtypes):
        for i, (up, blk) in enumerate(zip(dec.filter.ups, dec.filter.blocks)):
            up_d, blk_d = cast_params(up, dt), cast_params(blk, dt)
            cin, c, r = up.weight.shape
            l_in = lens[i] // r
            x = (0.3 * torch.randn(n, l_in, cin, generator=gen, device="cuda")).to(dt)
            s = (0.3 * torch.randn(n, l_in, cin, generator=gen, device="cuda")).to(dt)
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
            dname = "f32" if dt == torch.float32 else "bf16"
            need(err <= tol, f"filter level {i} ({dname}{tag}, C={c}): max abs err {err} > {tol}")
            isz = x.element_size()
            nbytes = isz * (2 * x.numel() + got.numel() + args["film"].numel()
                            + sum(p.numel() for p in list(up.parameters()) + list(blk.parameters())))
            flops = 2.0 * n * (l_in * cin * r * c + lens[i] * c * c
                               + 6 * lens[i] * c * c * cfg.filter_kernel_size)
            # the products on the tensor cores: bf16, or 3xTF32 (three TF32
            # products each) in float32 storage
            if dt == torch.float32:
                b, by = bound_ms(nbytes, 3.0 * flops, PEAK_TF32)
            else:
                b, by = bound_ms(nbytes, flops, PEAK_BF16)
            wide = not takes_narrow(c, cin, r, cfg.filter_kernel_size, args["dilations"])
            n_weights = sum(p.numel() for p in list(up.parameters()) + list(blk.parameters()))
            floor = form_bytes(n, l_in, cin, c, r, len(args["conv_w"]), args["film"].shape[1],
                               n_weights, isz, wide) / PEAK_BYTES * 1e3
            rows.append({
                "name": "filter_level", "variant": f"level {i} C={c} L={lens[i]} {dname}{tag}",
                "max_abs_err": err, "tol": tol,
                "ms": cuda_ms(lambda: filter_level_cuda(x, s, rate=r, **args)),
                "plain_ms": cuda_ms(lambda: filter_level_plain(x, s, rate=r, **args), 2),
                "library_ms": None,
                "products_library_ms": cuda_ms(level_products(x, s, args, r)),
                "bound_ms": b, "bound_by": by, "form_bytes_floor_ms": floor,
                "grid": filter_grid(n, l_in, cin, c, r, lens[i], cfg.filter_kernel_size,
                                    args["dilations"], dt, args["film"].shape[1]),
            })
            del got, want
    return rows


# ---------------------------------------------------------------------------
# phase 3: the main path end to end
# ---------------------------------------------------------------------------


def request_wave(seconds: float, rng, sr: int = 16_000):
    import numpy as np

    t = np.arange(int(seconds * sr)) / float(sr)
    f = 110.0 + 60.0 * np.sin(2 * np.pi * 0.3 * t)
    phase = 2 * np.pi * np.cumsum(f) / float(sr)
    wave = 0.4 * np.sin(phase) + 0.2 * np.sin(2 * phase) + 0.01 * rng.standard_normal(t.shape)
    return wave.astype(np.float32)


def run_main_path(ce, f0m, dec, lib, card):
    import numpy as np
    import torch
    from alivevc_tpu_torch.infer.offline import CROSSINGS, OfflineConverter, convert_window, reset_crossings
    from alivevc_tpu_torch.kernels import LAUNCHES
    from alivevc_tpu_torch.ops.stft import log_mel_spectrogram

    rng = np.random.default_rng(0)
    requests = [request_wave(s, rng) for s in (10.0, 30.0, 61.0)]
    report = {}
    for dtype in ("bf16", "fp32"):
        conv = OfflineConverter(ce, f0m, dec, lib, dtype=dtype)
        for wave in requests:
            before = dict(LAUNCHES)
            reset_crossings()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = conv.convert_16k(wave)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            need(out.shape == wave.shape, f"{dtype}: output length {out.shape} != {wave.shape}")
            need(bool(np.isfinite(out).all()), f"{dtype}: non-finite output")
            grew = {k: LAUNCHES[k] - before[k] for k in OFFLINE_KERNELS}
            need(all(v > 0 for v in grew.values()), f"{dtype}: a kernel did not launch: {grew}")
            need(CROSSINGS == {"to_card": 1, "to_host": 1}, f"{dtype}: host-device copies {CROSSINGS}")
            secs = len(wave) / 16_000.0
            print(f"request {dtype} {secs:.0f} s audio: {dt:.3f} s wall, "
                  f"{secs / dt:.1f} audio-s/s, launches {grew}, crossings {CROSSINGS} [{card}]")
            report[f"request_{dtype}_{secs:.0f}s_wall_s"] = dt
    report.update(world_requests(ce, f0m, dec, lib, requests[0], card))

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

    # the same step in fp32, the exact-ranking mode (kNN 'high')
    conv32 = OfflineConverter(ce, f0m, dec, lib, dtype="fp32")
    step32 = lambda: convert_window(conv32.ce, conv32.f0, conv32.dec, x, conv32.tgt, dtype="fp32")  # noqa: E731
    out = step32()
    torch.cuda.synchronize()
    need(out.shape == (64, LW) and bool(torch.isfinite(out).all()), "bench-shape fp32 step: bad output")
    del out
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        step32()
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / reps
    print(f"bench shape fp32 (kNN 'high'): {dt * 1e3:.2f} ms/step, {audio_s / dt:.1f} audio-s/s "
          f"(64 windows x {LW}, library {LIB_ROWS}) [{card}]")
    report["bench_fp32_ms_per_step"] = dt * 1e3
    report["bench_fp32_audio_s_per_s"] = audio_s / dt
    report["bench_fp32_profile"] = profile_step(step32, card, label="one bench-shape fp32 step (kNN 'high')")

    # bf16 licence, its end-to-end half: log-mel L1 vs fp32 ('highest' kNN)
    xa = x[:8]
    out32 = convert_window(conv32.ce, conv32.f0, conv32.dec, xa, lib, dtype="fp32",
                           knn_precision="highest")
    out16 = convert_window(conv16.ce, conv16.f0, conv16.dec, xa, lib, dtype="bf16")
    mel_l1 = float((log_mel_spectrogram(out16) - log_mel_spectrogram(out32)).abs().mean())
    print(f"bf16 licence: log-mel L1 {mel_l1:.5f} (<= 0.25)")
    need(mel_l1 <= 0.25, f"bf16 log-mel L1 {mel_l1} > 0.25")
    report["bf16_mel_l1"] = mel_l1
    return report, xa


class HostTimer:
    """Wraps ``module.<name>`` (a host function, here WORLD's ``compute_f0``)
    while in use, recording the host seconds of each call."""

    def __init__(self, module, name: str):
        self.module, self.name, self.seconds = module, name, []

    def __enter__(self):
        self.real = getattr(self.module, self.name)

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            out = self.real(*args, **kwargs)
            self.seconds.append(time.perf_counter() - t0)
            return out

        setattr(self.module, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


@contextlib.contextmanager
def estimator_calls(f0m):
    """A list that grows by one each time the F0 estimator runs, while in
    use (a forward hook on its first layer, which ``f0_estimate`` calls as a
    module)."""
    calls = []
    handle = f0m.input_layer.register_forward_hook(lambda *_: calls.append(1))
    try:
        yield calls
    finally:
        handle.remove()


def world_requests(ce, f0m, dec, lib, wave, card) -> dict:
    """Phase 3's WORLD-pitch requests: ``wave`` (10 s) through
    ``OfflineConverter(world_pitch=True)`` in bf16 and fp32.  The STFT, kNN,
    oscillator and filter kernels must launch, the F0 estimator must not
    run; prints WORLD's host time beside the request's wall time."""
    import numpy as np
    import torch
    from alivevc_tpu_torch.infer import offline
    from alivevc_tpu_torch.kernels import LAUNCHES

    report = {}
    for dtype in ("bf16", "fp32"):
        conv = offline.OfflineConverter(ce, f0m, dec, lib, world_pitch=True, dtype=dtype)
        before = dict(LAUNCHES)
        torch.cuda.synchronize()
        with HostTimer(offline, "compute_f0") as world, estimator_calls(f0m) as calls:
            t0 = time.perf_counter()
            out = conv.convert_16k(wave)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        grew = {k: LAUNCHES[k] - before[k] for k in OFFLINE_KERNELS}
        need(out.shape == wave.shape and bool(np.isfinite(out).all()), f"-wpe {dtype}: bad output")
        need(all(v > 0 for v in grew.values()), f"-wpe {dtype}: a kernel did not launch: {grew}")
        need(not calls, f"-wpe {dtype}: the F0 estimator ran {len(calls)} times")
        w_s = sum(world.seconds)
        secs = len(wave) / 16_000.0
        print(f"request -wpe {dtype} {secs:.0f} s audio: {dt:.3f} s wall, WORLD (compute_f0, host) "
              f"{w_s:.3f} s = {100 * w_s / dt:.1f} % of it, F0 estimator calls 0, launches {grew} "
              f"[{card}]")
        report[f"request_wpe_{dtype}_{secs:.0f}s_wall_s"] = dt
        report[f"request_wpe_{dtype}_{secs:.0f}s_world_s"] = w_s
    # the hook does see the estimator when it runs
    with estimator_calls(f0m) as calls:
        offline.convert_window(ce, f0m, dec, torch.from_numpy(wave[None, :9600]).cuda(), lib[:2048])
    need(len(calls) == 1, f"the F0 estimator hook saw {len(calls)} calls of one plain step")
    return report


def world_reference_check(ce, f0m, dec, lib):
    """``OfflineConverter(world_pitch=True)`` on the card against the plain
    path on the CPU, fp32, 0.6 s of audio in windows of 14 400 samples: both
    label the same windows with the same host WORLD, so f0 is the same."""
    import copy

    import numpy as np
    from alivevc_tpu_torch.config import InferenceConfig
    from alivevc_tpu_torch.infer.offline import OfflineConverter

    wave = request_wave(0.6, np.random.default_rng(2))
    cfg = InferenceConfig(chunk=4800)
    got = OfflineConverter(ce, f0m, dec, lib[:2048], cfg, world_pitch=True).convert_16k(wave)
    cpu = [copy.deepcopy(m).cpu() for m in (ce, f0m, dec)]
    want = OfflineConverter(*cpu, lib[:2048].cpu(), cfg, world_pitch=True,
                            device="cpu").convert_16k(wave)
    err = float(np.abs(got - want).max())
    print(f"reference check -wpe (card kernels vs CPU plain, fp32, same WORLD f0): max abs err "
          f"{err:.3e} (<= 5e-3)")
    need(err <= 5e-3, f"-wpe card vs CPU: max abs err {err} > 5e-3")
    return err


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


def knn_flip_rates_over_draws(ce, xa, draws: int = 4):
    """The licence's kNN half on ``draws`` more random libraries of LIB_ROWS
    rows (their own generators, seeds SEED + 10 ...), on the same content
    features: reported beside the committed draw's gated rate, not gated."""
    import torch
    from alivevc_tpu_torch.kernels.knn import knn_topk_cuda
    from alivevc_tpu_torch.models.content_encoder import content_encoder
    from alivevc_tpu_torch.ops.stft import spectrogram

    feat = content_encoder(ce, spectrogram(xa)).reshape(-1, 768)
    rates = []
    for d in range(draws):
        gen = torch.Generator(device="cuda").manual_seed(SEED + 10 + d)
        lib = torch.randn(LIB_ROWS, 768, generator=gen, device="cuda")
        _, i32 = knn_topk_cuda(feat, lib, 4, "high")
        _, i16 = knn_topk_cuda(feat, lib, 4, "default")
        rates.append(float((torch.sort(i32, 1).values != torch.sort(i16, 1).values).any(1).float().mean()))
    print(f"bf16 licence: kNN flip rate on {draws} more library draws at {LIB_ROWS} rows "
          f"(reported, not gated): {rates}, mean {statistics.mean(rates):.5f}")
    return rates


KERNEL_GROUPS = (
    ("stft", ("stft_fft",)),
    ("knn_prep", ("knn_prep",)),
    ("knn_tile", ("knn_tile",)),
    ("knn_merge", ("knn_merge",)),
    ("knn_carried", ("knn_carried",)),
    ("oscillator", ("osc_scan", "osc_cheb", "osc_formant", "osc_stream")),
    ("filter_narrow", ("filter_narrow_kernel", "filter_narrow_weights_kernel")),
    ("filter_wide", ("filter_wide_kernel", "filter_wide_weights_kernel")),
)
FILTER_GROUPS = ("filter_narrow", "filter_wide")   # their sum is reported as filter_level
KNN_GROUPS = ("knn_prep", "knn_tile", "knn_merge", "knn_carried")   # their sum is reported as knn


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
    # the device-side copies of profiler annotations (the program's vc::
    # spans) are ranges over kernels, not work, and are left out
    spans = [(e.time_range.start, e.time_range.end, e.name) for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and not getattr(e, "is_user_annotation", False)]
    if not spans:
        print("profile: the profiler recorded no device time (not measured)")
        return None
    groups = {g: 0.0 for g, _ in KERNEL_GROUPS}
    groups["other (cuBLAS, cuDNN, elementwise, copies)"] = 0.0
    for start, end, name in spans:
        g = next((g for g, keys in KERNEL_GROUPS if any(k in name for k in keys)),
                 "other (cuBLAS, cuDNN, elementwise, copies)")
        # every filter kernel of the port must count as a filter level's,
        # every oscillator kernel (the phase scan too) as the oscillator's
        need("filter" not in name or g in FILTER_GROUPS,
             f"profile: device span {name!r} lands in {g!r}, not in {FILTER_GROUPS}")
        need("osc_" not in name or g == "oscillator",
             f"profile: device span {name!r} lands in {g!r}, not in oscillator")
        need("knn" not in name or g in KNN_GROUPS,
             f"profile: device span {name!r} lands in {g!r}, not in {KNN_GROUPS}")
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
          f"device busy {busy:.2f} ms ({100 * busy * 1e3 / wall_us:.1f} % of wall), "
          f"{len(spans)} device spans")
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {g:45s} {ms:9.3f} ms  {100 * ms / total:5.1f} %")
    level = sum(groups[g] for g in FILTER_GROUPS)
    knn = sum(groups[g] for g in KNN_GROUPS)
    print(f"  {'filter_level (filter_narrow + filter_wide)':45s} {level:9.3f} ms  {100 * level / total:5.1f} %")
    print(f"  {'knn (prep + tile + merge + carried)':45s} {knn:9.3f} ms  {100 * knn / total:5.1f} %")
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy,
            "by_group_ms": {**groups, "filter_level": level, "knn": knn}, "device_spans": len(spans)}


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
    if sys.argv[1:2] == [DETERMINISTIC_FLAG]:
        deterministic_resume(sys.argv[2])
        return 0
    from alivevc_tpu_torch.config import ContentEncoderConfig, DecoderConfig, F0EstimatorConfig
    from alivevc_tpu_torch.device import float32_math
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
    small = lib[:512]                  # a voice library's size: the carried form's packed kernel
    reset_launches()
    pv, pi = kernels.knn_topk(q, lib, 4, "default", extraction="packed")
    spv, spi = kernels.knn_topk(q, small, 4, "default", extraction="packed")
    src = kernels.harmonic_source_formants(formants, amps)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    need(all(launches[k] > 0 for k in API_KERNELS), f"kernel API: a kernel did not launch: {launches}")
    # uncounted: each against its exact counterpart
    kerr, bad = 0.0, 0
    for got_v, got_i, rows in ((pv, pi, lib), (spv, spi, small)):
        ev, ei = knn_topk_cuda(q, rows, 5, "default")
        clear = (ev[:, 3] - ev[:, 4]) > 1e-4
        same = (torch.sort(got_i, 1).values == torch.sort(ei[:, :4], 1).values).all(1)
        bad += int((clear & ~same).sum())
        kerr = max(kerr, float((got_v - ev[:, :4]).abs().max()))
    serr = float((src - harmonic_source_cuda(f0, amps)).abs().max())
    print(f"kernel API [{card}]: packed vs exact 'default' max abs {kerr:.3e} (<= 3.2e-5), "
          f"{bad} clear index sets differ; formant vs Chebyshev source max abs {serr:.3e} (<= 5e-3); "
          f"launches {launches}")
    need(kerr <= 3.2e-5 and bad == 0, f"packed kNN: err {kerr}, {bad} index sets differ")
    need(bool(torch.isfinite(src).all()) and serr <= 5e-3, f"formant source vs Chebyshev: {serr}")
    return launches


# ---------------------------------------------------------------------------
# phase 6: the realtime path (the streaming hop, eager and as one CUDA graph;
# the two CLIs in file mode)
# ---------------------------------------------------------------------------

HOP_CHUNK = 960              # StreamingConfig(): a 60 ms hop at 16 kHz ...
HOP_PRIME = 8                # ... over a window of buffer_size = 8 chunks
HOP_WINDOW = HOP_CHUNK * HOP_PRIME
COMPARE_HOPS = 50
LATENCY_HOPS = 200
PROFILE_HOPS = 20
STREAM_KERNELS = ("stft", "knn_carried", "oscillator_stream", "filter_level", "filter_narrow",
                  "filter_wide")   # the carried kNN form
CLI_OFFLINE_KERNELS = ("stft", "knn_carried", "oscillator", "filter_level", "filter_narrow", "filter_wide")
PHASE6_LIMIT_S = 60.0
WPE_LATENCY_HOPS = 60        # the -wpe forms' latency hops (WORLD runs on the host each hop)


def hop_latency_ms(conv, chunks, warmup: int = 3):
    """Host-clock milliseconds of each ``process_chunk`` call, chunk in to
    numpy out, after ``warmup`` untimed calls (the first captures the graph)."""
    for c in chunks[:warmup]:
        conv.process_chunk(c)
    times = []
    for c in chunks[warmup:]:
        t0 = time.perf_counter()
        conv.process_chunk(c)
        times.append((time.perf_counter() - t0) * 1e3)
    conv.flush()
    q = statistics.quantiles(times, n=100, method="inclusive")
    return {"median": statistics.median(times), "p90": q[89], "p99": q[98], "hops": len(times)}


def sm_clock_mhz():
    """The card's SM clock now and its maximum (nvidia-smi), MHz."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True, timeout=60)
    now, top = (float(v) for v in out.stdout.strip().splitlines()[0].split(","))
    return now, top


def check_oscillator_stream(gen):
    """The streaming source at the hop's shape (the decoder's call in
    ``streaming_step``: f0 [1, 24], amps [1, 24, 64], a carried phi, the
    phase re-zeroed at the output chunk's first sample, 3 360): phi_out
    bit-equal to the plain version on the card and the waveform within 1e-6
    of its peak.  The bound is the chain: Lw dependent float32 adds a
    harmonic at 4 cycles each, at the SM clock read after the timed runs;
    the library call is ``torch.cumsum`` alone on the plain version's
    increments, the one operation of it that the port no longer calls."""
    import torch
    from alivevc_tpu_torch.kernels.oscillator import (
        harmonic_source_stream_cuda,
        harmonic_source_stream_plain,
        inv_rate,
    )
    from alivevc_tpu_torch.ops.interp import linear_interpolate

    lf, nh, crop0 = HOP_WINDOW // 320, 64, HOP_WINDOW // 2 - HOP_CHUNK // 2
    f0 = 80.0 + 320.0 * torch.rand(1, lf, 1, generator=gen, device="cuda")
    amps = torch.exp(0.3 * torch.randn(1, lf, nh, generator=gen, device="cuda"))
    phi = 3.0 * torch.rand(1, 1, nh, generator=gen, device="cuda") - 1.5
    wave, phi_out = harmonic_source_stream_cuda(f0, amps, phi, crop0)
    want_wave, want_phi = harmonic_source_stream_plain(f0, amps, phi, crop0)
    torch.cuda.synchronize()
    need(torch.equal(phi_out, want_phi), "oscillator_stream: phi_out differs from the plain version's")
    err = float((wave - want_wave).abs().max())
    tol = 1e-6 * float(want_wave.abs().max())
    need(err <= tol, f"oscillator_stream: max abs err {err} > {tol}")
    inc = linear_interpolate(f0 * torch.arange(1, nh + 1, device="cuda"), HOP_WINDOW, axis=1) * inv_rate(16_000)
    ms = cuda_ms(lambda: harmonic_source_stream_cuda(f0, amps, phi, crop0))
    clock, clock_max = sm_clock_mhz()
    return {
        "name": "oscillator_stream", "variant": f"f0 [1, {lf}], amps [1, {lf}, {nh}], crop {crop0} (hop)",
        "max_abs_err": err, "tol": tol, "ms": ms,
        "kernel_ms": kernel_device_ms(lambda: harmonic_source_stream_cuda(f0, amps, phi, crop0),
                                      ("osc_stream",)),
        "plain_ms": cuda_ms(lambda: harmonic_source_stream_plain(f0, amps, phi, crop0), 2),
        "library_ms": cuda_ms(lambda: torch.cumsum(inc, dim=1)),
        "bound_ms": HOP_WINDOW * 4 / (clock * 1e3), "bound_by": f"chain at {clock:.0f} MHz",
        "sm_clock_mhz": clock, "sm_clock_max_mhz": clock_max,
    }


def hop_card_vs_cpu(ce, f0m, dec, tgt, state, chunk, rng):
    """One hop on the card (kernels) against the port's plain hop on the CPU
    from the same state (window and a carried phi), f0 given: the
    estimator's argmax may flip on a near-tie between the two devices."""
    import copy

    import numpy as np
    from alivevc_tpu_torch.infer.streaming import StreamState, streaming_step

    f0 = (80.0 + 200.0 * rng.random((1, HOP_WINDOW // 320, 1))).astype(np.float32)
    card_state, got = streaming_step(ce, f0m, dec, StreamState(state.window.clone(), state.phi.clone()),
                                     chunk, tgt, f0_override=f0)
    cpu = [copy.deepcopy(m).cpu() for m in (ce, f0m, dec)]
    cpu_state, want = streaming_step(*cpu, StreamState(state.window.cpu(), state.phi.cpu()), chunk,
                                     tgt.cpu(), f0_override=f0)
    return (float((got.cpu() - want).abs().max()),
            float((card_state.phi.cpu() - cpu_state.phi).abs().max()))


def run_cli_phase(card, flags=()):
    """Both CLIs in file mode on a 44.1 kHz wav the script writes, with a 10
    s target voice at 16 kHz (models from seed 0: no checkpoint files) and
    ``flags`` added, counters zeroed before each and read after; returns the
    launches, summed."""
    import os
    import tempfile

    import numpy as np
    from alivevc_tpu_torch.cli import inference, realtime_inference
    from alivevc_tpu_torch.io.audio import read_wav, write_wav
    from alivevc_tpu_torch.kernels import LAUNCHES, reset_launches

    sr = 44_100
    total = {k: 0 for k in LAUNCHES}
    with tempfile.TemporaryDirectory() as tmp:
        os.makedirs(os.path.join(tmp, "in"))
        rng = np.random.default_rng(SEED + 7)
        wave = request_wave(4.0, rng, sr)
        write_wav(os.path.join(tmp, "in", "voice.wav"), wave, sr)
        target = os.path.join(tmp, "target.wav")
        write_wav(target, request_wave(10.0, rng), 16_000)
        length16 = math.ceil(160 * len(wave) / 441)
        # a 10 s target is a library of ~500 rows: the carried kNN form
        runs = (
            ("offline", CLI_OFFLINE_KERNELS, lambda: inference.main(
                ["-i", os.path.join(tmp, "in"), "-o", os.path.join(tmp, "out"), "-t", target,
                 *flags])[0],
             os.path.join(tmp, "out", "0_voice.wav"), sr, math.ceil(441 * length16 / 160)),
            ("realtime", STREAM_KERNELS, lambda: realtime_inference.main(
                ["--input-wav", os.path.join(tmp, "in", "voice.wav"),
                 "--output-wav", os.path.join(tmp, "streamed.wav"), "-t", target, *flags]),
             os.path.join(tmp, "streamed.wav"), 16_000, length16 // HOP_CHUNK * HOP_CHUNK),
        )
        for name, kernels, run, path, want_sr, want_len in runs:
            reset_launches()
            t0 = time.perf_counter()
            out = run()
            dt = time.perf_counter() - t0
            got = dict(LAUNCHES)
            written, written_sr = read_wav(path)
            need(all(got[k] > 0 for k in kernels), f"{name} CLI: a kernel did not launch: {got}")
            need(out.shape == (want_len,) and written.shape == (1, want_len) and written_sr == want_sr,
                 f"{name} CLI: output {out.shape} / file {written.shape} at {written_sr} Hz, "
                 f"expected {want_len} samples at {want_sr} Hz")
            need(bool(np.isfinite(out).all()), f"{name} CLI: non-finite output")
            print(f"{name} CLI {' '.join(flags)}, file mode, 4 s at {sr} Hz in: {want_len} samples "
                  f"at {want_sr} Hz out, "
                  f"{dt:.2f} s wall (models built from seed 0, capture included), launches {got} [{card}]")
            for k in total:
                total[k] += got[k]
    return total


def run_realtime_world(ce, f0m, dec, tgt, prime, hops, card):
    """Phase 6's WORLD-pitch forms of ``StreamingConverter(world_pitch=True)``:
    the eager hop counted (the F0 estimator must not run), the graph hop
    against it, the pipelined graph against the synchronous one delayed by a
    hop, and each form's per-hop latency with WORLD's host ms a hop."""
    import numpy as np
    import torch
    from alivevc_tpu_torch.infer import streaming
    from alivevc_tpu_torch.kernels import LAUNCHES, reset_launches

    def converter(**kw):
        conv = streaming.StreamingConverter(ce, f0m, dec, tgt, world_pitch=True, **kw)
        conv.prime(prime)
        return conv

    eager = converter(cuda_graph=False)
    reset_launches()
    with estimator_calls(f0m) as calls:
        eager_out = [eager.process_chunk(c) for c in hops[:COMPARE_HOPS]]
        torch.cuda.synchronize()
        launches = dict(LAUNCHES)
        need(all(launches[k] > 0 for k in STREAM_KERNELS),
             f"realtime -wpe: a kernel did not launch: {launches}")
        graph = converter()
        graph_out = [graph.process_chunk(c) for c in hops[:COMPARE_HOPS]]
        piped = converter(pipeline_depth=1)
        piped_out = [piped.process_chunk(c) for c in hops[:COMPARE_HOPS]] + piped.flush()
    need(not calls, f"realtime -wpe: the F0 estimator ran {len(calls)} times")
    diff = max(float(np.abs(a - b).max()) for a, b in zip(eager_out, graph_out))
    same = (len(piped_out) == COMPARE_HOPS + 1 and not piped_out[0].any()
            and all(np.array_equal(a, b) for a, b in zip(graph_out, piped_out[1:])))
    print(f"realtime -wpe: eager hop launches per hop "
          f"{ {k: launches[k] / COMPARE_HOPS for k in launches} }; graph replay vs eager over "
          f"{COMPARE_HOPS} hops: max abs diff {diff:.3e} (<= 1e-5); pipelined (depth 1) equals "
          f"synchronous delayed by one hop: {same}; F0 estimator calls 0")
    need(diff <= 1e-5, f"realtime -wpe: graph replay differs from the eager hop by {diff}")
    need(all(bool(np.isfinite(o).all()) for o in graph_out), "realtime -wpe: non-finite output")
    need(same, "realtime -wpe: the pipelined outputs are not the synchronous ones delayed by one hop")
    latency = {}
    for name, conv in (("eager, synchronous", eager), ("graph, synchronous", graph),
                       ("graph, pipelined", piped)):
        with HostTimer(streaming, "compute_f0") as world:
            lat = hop_latency_ms(conv, hops[:WPE_LATENCY_HOPS + 3])
        lat["real_time_factor"] = lat["median"] / 60.0
        lat["world_ms_median"] = 1e3 * statistics.median(world.seconds)
        lat["world_ms_mean"] = 1e3 * statistics.mean(world.seconds)
        latency[name] = lat
        print(f"realtime -wpe: per-hop latency, {name}: median {lat['median']:.3f} ms, p90 "
              f"{lat['p90']:.3f}, p99 {lat['p99']:.3f} over {lat['hops']} hops; real-time factor "
              f"{lat['real_time_factor']:.4f}; WORLD (compute_f0, host) median "
              f"{lat['world_ms_median']:.3f} ms a hop, mean {lat['world_ms_mean']:.3f} [{card}]")
    # the device's busy share of a -wpe hop (WORLD keeps the host, not the card, busy)
    prof = profile_step(lambda: [graph.process_chunk(c) for c in hops[:PROFILE_HOPS]], card,
                        f"{PROFILE_HOPS} hops, graph, synchronous, -wpe")
    return launches, {"wpe_graph_vs_eager_max_abs": diff, "wpe_latency_ms": latency,
                      "wpe_graph_busy_share": None if prof is None
                      else prof["device_busy_ms"] / prof["wall_ms"]}


def run_realtime(ce, f0m, dec, gen, card):
    """Phase 6: ``StreamingConverter`` at full width over a target matrix of
    a 30 s synthetic voice (decimated x4: 375 rows) and 512 library tokens
    from the seed: the eager hop counted, graph against eager, pipelined
    against synchronous, a hop on the card against the CPU, the hop-shape
    kernel rows, per-hop latency of each form, the profile, the CLIs."""
    import numpy as np
    import torch
    from alivevc_tpu_torch.infer.offline import build_target_matrix
    from alivevc_tpu_torch.infer.streaming import StreamingConverter
    from alivevc_tpu_torch.kernels import LAUNCHES, reset_launches

    t_start = time.perf_counter()
    rng = np.random.default_rng(SEED + 6)
    tokens = torch.randn(512, 768, generator=torch.Generator(device="cuda").manual_seed(SEED + 6),
                         device="cuda")
    tgt = build_target_matrix(ce, target_wave=request_wave(30.0, rng), library_tokens=tokens,
                              decimation=4)
    need(tuple(tgt.shape) == (375 + 512, 768), f"realtime: target matrix {tuple(tgt.shape)}")
    n_chunks = HOP_PRIME + LATENCY_HOPS + 10
    stream = request_wave(n_chunks * HOP_CHUNK / 16_000.0, rng).reshape(n_chunks, HOP_CHUNK)
    prime, hops = stream[:HOP_PRIME].reshape(-1), list(stream[HOP_PRIME:])

    def converter(**kw):
        conv = StreamingConverter(ce, f0m, dec, tgt, **kw)
        conv.prime(prime)
        return conv

    # 1. the eager hop, counted
    eager = converter(cuda_graph=False)
    reset_launches()
    eager_out = [eager.process_chunk(c) for c in hops[:COMPARE_HOPS]]
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    need(all(launches[k] > 0 for k in STREAM_KERNELS), f"realtime: a kernel did not launch: {launches}")
    per_hop = {k: launches[k] / COMPARE_HOPS for k in launches}
    print(f"realtime: eager hop launches per hop {per_hop} ({COMPARE_HOPS} hops) [{card}]")
    # 2. the same hops replayed as one CUDA graph
    graph = converter()
    graph_out = [graph.process_chunk(c) for c in hops[:COMPARE_HOPS]]
    diff = max(float(np.abs(a - b).max()) for a, b in zip(eager_out, graph_out))
    print(f"realtime: graph replay vs eager hop over {COMPARE_HOPS} hops: max abs diff {diff:.3e} (<= 1e-5)")
    need(diff <= 1e-5, f"realtime: graph replay differs from the eager hop by {diff}")
    need(all(bool(np.isfinite(o).all()) for o in graph_out), "realtime: non-finite output")
    # 3. pipelined at depth 1: the same chunks, one hop late
    piped = converter(pipeline_depth=1)
    piped_out = [piped.process_chunk(c) for c in hops[:COMPARE_HOPS]] + piped.flush()
    same = (len(piped_out) == COMPARE_HOPS + 1 and not piped_out[0].any()
            and all(np.array_equal(a, b) for a, b in zip(graph_out, piped_out[1:])))
    print(f"realtime: pipelined (depth 1) equals synchronous delayed by one hop: {same}")
    need(same, "realtime: the pipelined outputs are not the synchronous ones delayed by one hop")
    # 4. a hop on the card against the plain hop on the CPU.  phi: the card
    # sums the float32 phase steps in float32, the CPU's cumsum in float64;
    # between the crop's start and its end (960 samples) at the top harmonic
    # (64 x f0 <= 280 Hz: 5 000-8 600 cycles, where float32 values are 2^-11
    # to 2^-10 cycles apart) that rounding walks ~0.03 rad (one standard
    # deviation); phi = asin(sin theta) is 1-Lipschitz in theta
    wave_err, phi_err = hop_card_vs_cpu(ce, f0m, dec, tgt, eager.state, hops[COMPARE_HOPS], rng)
    print(f"realtime: one hop on the card vs the plain hop on the CPU (fp32, f0 given): waveform "
          f"max abs err {wave_err:.3e} (<= 5e-3), phi {phi_err:.3e} (<= 0.25 rad)")
    need(wave_err <= 5e-3 and phi_err <= 0.25, f"realtime: card vs CPU {wave_err}, phi {phi_err}")
    # 5. the kernels at the hop's shapes against their plain versions (uncounted)
    rows = [check_stft(gen, 1, HOP_WINDOW, " (hop)"),
            check_knn(gen, tgt.shape[0], "high", ls=HOP_WINDOW // 320, suffix=" (hop)")]
    rows += check_filter_levels(gen, dec, n=1, lw=HOP_WINDOW, dtypes=("f32",), tag=" (hop)")
    rows.append(check_oscillator_stream(gen))
    # 6. per-hop latency of each form, and the real-time factor
    latency = {}
    for name, conv in (("eager, synchronous", eager), ("graph, synchronous", graph),
                       ("graph, pipelined", piped)):
        lat = hop_latency_ms(conv, hops[:LATENCY_HOPS + 3])
        lat["real_time_factor"] = lat["median"] / 60.0
        latency[name] = lat
        print(f"realtime: per-hop latency, {name}: median {lat['median']:.3f} ms, p90 {lat['p90']:.3f}, "
              f"p99 {lat['p99']:.3f} over {lat['hops']} hops; real-time factor "
              f"{lat['real_time_factor']:.4f} [{card}]")
    # 7. device time of a hop and the busy share, by kernel group
    profiles = {}
    for name, conv in (("graph", graph), ("eager", eager)):
        prof = profile_step(lambda: [conv.process_chunk(c) for c in hops[:PROFILE_HOPS]], card,
                            f"{PROFILE_HOPS} hops, {name}, synchronous")
        if prof is not None:
            by = {g: prof["by_group_ms"][g] / PROFILE_HOPS for g in ("knn", *FILTER_GROUPS, "filter_level")}
            print(f"realtime: {name} hop device time {prof['device_busy_ms'] / PROFILE_HOPS:.4f} ms, "
                  f"{prof['device_spans'] / PROFILE_HOPS:.1f} device spans a hop, kNN kernels "
                  f"{by['knn']:.4f} ms a hop, filter kernels {by['filter_level']:.4f} (narrow "
                  f"{by['filter_narrow']:.4f}, wide {by['filter_wide']:.4f})")
        profiles[name] = prof
    # 8. WORLD pitch: the same three forms with f0 from the host
    wpe_launches, wpe_report = run_realtime_world(ce, f0m, dec, tgt, prime, hops, card)
    # 9. the CLIs, plain and with -wpe
    cli_launches = run_cli_phase(card)
    wpe_cli_launches = run_cli_phase(card, ("-wpe",))
    elapsed = time.perf_counter() - t_start
    print(f"realtime: phase 6 took {elapsed:.1f} s (<= {PHASE6_LIMIT_S:.0f})")
    need(elapsed <= PHASE6_LIMIT_S, f"phase 6 took {elapsed:.1f} s > {PHASE6_LIMIT_S}")
    report = {"launches_per_eager_hop": per_hop, "graph_vs_eager_max_abs": diff,
              "card_vs_cpu_wave": wave_err, "card_vs_cpu_phi": phi_err, "latency_ms": latency,
              "hop_device_ms": {k: None if v is None else v["device_busy_ms"] / PROFILE_HOPS
                                for k, v in profiles.items()},
              "hop_knn_device_ms": {k: None if v is None else v["by_group_ms"]["knn"] / PROFILE_HOPS
                                    for k, v in profiles.items()},
              "hop_filter_device_ms": {k: None if v is None else {g: v["by_group_ms"][g] / PROFILE_HOPS
                                                                   for g in (*FILTER_GROUPS, "filter_level")}
                                       for k, v in profiles.items()},
              "hop_busy_share": {k: None if v is None else v["device_busy_ms"] / v["wall_ms"]
                                 for k, v in profiles.items()},
              "elapsed_s": elapsed, **wpe_report}
    return ({k: launches[k] + wpe_launches[k] + cli_launches[k] + wpe_cli_launches[k]
             for k in launches}, rows, report)


# ---------------------------------------------------------------------------
# phase 7: the frame-rate models sharded along time (halo exchange)
# ---------------------------------------------------------------------------

HALO_SECONDS = 600.0         # a 600 s utterance: 30 000 frames, 15 000 a rank
HALO_RANKS = 2
HALO_TIMEOUT_S = 300
HALO_TOL = 1e-4


def run_halo(world: int) -> dict:
    """This rank's part of phase 7 on a ('data', world) mesh: the utterance's
    spectrogram by the STFT kernel (counted), then the content encoder, the
    F0 estimator and the feature extractor on this rank's slice of time,
    each timed (host clock, synchronised, after a warm-up), and each dense
    model on the whole input against this rank's slice.  Needs the default
    process group."""
    import numpy as np
    import torch
    import torch.distributed as dist
    if sys.argv[1:2] == [DETERMINISTIC_FLAG]:
        deterministic_resume(sys.argv[2])
        return 0
    from alivevc_tpu_torch.config import ContentEncoderConfig, DecoderConfig, F0EstimatorConfig
    from alivevc_tpu_torch.kernels import LAUNCHES, reset_launches
    from alivevc_tpu_torch.kernels.stft import stft_magnitude
    from alivevc_tpu_torch.models.content_encoder import ContentEncoder, content_encoder
    from alivevc_tpu_torch.models.decoder import Decoder, feature_extractor
    from alivevc_tpu_torch.models.f0_estimator import F0Estimator, f0_estimator
    from alivevc_tpu_torch.parallel import (
        content_encoder_sharded,
        f0_estimator_sharded,
        feature_extractor_sharded,
        make_mesh,
        shard_along,
        sharded_frame_model,
    )

    cpu_gen = torch.Generator().manual_seed(SEED)
    ce = ContentEncoder(ContentEncoderConfig(), generator=cpu_gen).cuda().eval()
    f0m = F0Estimator(F0EstimatorConfig(), generator=cpu_gen).cuda().eval()
    fe = Decoder(DecoderConfig(), generator=cpu_gen).cuda().eval().feature_extractor
    wave = torch.from_numpy(request_wave(HALO_SECONDS, np.random.default_rng(SEED + 8))).cuda()
    frames = int(HALO_SECONDS * 50)
    t = np.arange(frames) * 320 / 16_000.0
    f0 = torch.from_numpy((110.0 + 60.0 * np.sin(2 * np.pi * 0.3 * t)).astype(np.float32)).cuda()
    mesh = make_mesh([("data", world)], "cuda")

    reset_launches()
    spec = stft_magnitude(wave[None])[0, :-1]                                # [30 000, 641]
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    content = content_encoder(ce, spec[None])[0]
    dense_fns = {
        "content_encoder": lambda: content_encoder(ce, spec[None])[0],
        "f0_estimator": lambda: f0_estimator(f0m, spec[None])[0],
        "feature_extractor": lambda: feature_extractor(fe, content[None], f0[None, :, None])[0],
    }
    local = {k: shard_along(v, mesh, "data") for k, v in
             (("spec", spec), ("content", content), ("f0", f0[:, None]))}
    sharded_fns = {
        "content_encoder": lambda: sharded_frame_model(
            mesh, lambda x, ax: content_encoder_sharded(ce, x, ax), local["spec"]),
        "f0_estimator": lambda: sharded_frame_model(
            mesh, lambda x, ax: f0_estimator_sharded(f0m, x, ax), local["spec"]),
        "feature_extractor": lambda: sharded_frame_model(
            mesh, lambda x, ax: feature_extractor_sharded(fe, x[:, :-1], x[:, -1:], ax),
            torch.cat([local["content"], local["f0"]], dim=1)),
    }

    def timed(fn):
        fn()                       # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    res = {"launches": launches, "frames": frames, "local_frames": local["spec"].shape[0],
           "ms": {}, "dense_ms": {}, "err": {}, "channels": {}}
    for name, fn in sharded_fns.items():
        dist.barrier()
        out, res["ms"][name] = timed(fn)
        want = dense_fns[name]()
        res["err"][name] = float((out - shard_along(want, mesh, "data")).abs().max())
        dist.barrier()
        if dist.get_rank() == 0:   # the dense model alone on the card
            _, res["dense_ms"][name] = timed(dense_fns[name])
        dist.barrier()
        res["channels"][name] = {"content_encoder": ce, "f0_estimator": f0m,
                                 "feature_extractor": fe}[name].mid_layers[0].dw_conv.weight.shape[0]
    # one more sharded content-encoder pass, profiled on rank 0 (every rank takes part)
    dist.barrier()
    if dist.get_rank() == 0:
        profile_step(sharded_fns["content_encoder"], card_line(),
                     f"halo content encoder, rank 0 of {world}")
    else:
        sharded_fns["content_encoder"]()
        torch.cuda.synchronize()
    res["layers"] = {"content_encoder": len(ce.mid_layers), "f0_estimator": len(f0m.mid_layers),
                     "feature_extractor": len(fe.mid_layers)}
    res["halo"] = (ce.mid_layers[0].dw_conv.weight.shape[-1] - 1) // 2
    return res


def halo_rank(rank: int, world: int, tmp: str) -> None:
    """A spawned rank of phase 7: gloo on cuda:0, results to tmp/halo<r>.pt."""
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
        torch.save(run_halo(world), os.path.join(tmp, f"halo{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_halo_phase(card):
    """Phase 7: the halo models as HALO_RANKS gloo ranks on the one card, each
    rank's slice against the dense model on the whole input."""
    import multiprocessing
    import os
    import tempfile

    import torch

    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=halo_rank, args=(r, HALO_RANKS, tmp)) for r in range(HALO_RANKS)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        try:
            for p in procs:
                p.join(max(1.0, HALO_TIMEOUT_S - (time.perf_counter() - t0)))
            alive = [p.pid for p in procs if p.is_alive()]
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(30)
        need(not alive, f"halo ranks {alive} did not finish in {HALO_TIMEOUT_S} s")
        need(all(p.exitcode == 0 for p in procs), f"halo ranks failed: {[p.exitcode for p in procs]}")
        ranks = [torch.load(os.path.join(tmp, f"halo{r}.pt"), weights_only=False)
                 for r in range(HALO_RANKS)]
    report = {"frames": ranks[0]["frames"], "ranks": HALO_RANKS, "models": {}}
    for name in ranks[0]["ms"]:
        c, layers, halo = ranks[0]["channels"][name], ranks[0]["layers"][name], ranks[0]["halo"]
        sent = 2 * halo * c * 4          # bytes each rank contributes a layer (float32 edge slabs)
        entry = {"rank_ms": [r["ms"][name] for r in ranks],
                 "dense_ms": ranks[0]["dense_ms"][name],
                 "max_abs_err": max(r["err"][name] for r in ranks),
                 "layers": layers, "halo_frames": halo, "channels": c,
                 "bytes_sent_per_rank_per_layer": sent,
                 "bytes_gathered_per_rank_per_layer": sent * HALO_RANKS}
        report["models"][name] = entry
        print(f"halo [{card}]: {name} on {HALO_RANKS} gloo ranks on one card, {ranks[0]['frames']} "
              f"frames ({ranks[0]['local_frames']} a rank), full width: rank ms "
              f"{', '.join(f'{m:.3f}' for m in entry['rank_ms'])}; dense on one rank "
              f"{entry['dense_ms']:.3f} ms; max abs err vs dense {entry['max_abs_err']:.3e} "
              f"(<= {HALO_TOL:.0e}); {layers} layers, halo {halo} frames x {c} channels: "
              f"{sent} bytes sent and {sent * HALO_RANKS} gathered per rank per layer")
        need(entry["max_abs_err"] <= HALO_TOL,
             f"halo {name}: {entry['max_abs_err']} from dense > {HALO_TOL}")
    for r, res in enumerate(ranks):
        need(res["launches"]["stft"] > 0, f"halo rank {r}: the STFT kernel did not launch")
    launches = {k: sum(res["launches"][k] for res in ranks) for k in ranks[0]["launches"]}
    return launches, report


# ---------------------------------------------------------------------------
# phase 8: training (the GAN decoder trainer with gradients through the
# filter, oscillator and STFT kernels; fine-tuning with the voice library;
# the F0 trainer; library generation; data parallel; two training CLIs)
# ---------------------------------------------------------------------------

DEV = "cuda"
TRAIN_N = 8                  # GAN batch: 8 x 38 400 samples (TrainConfig.length)
TRAIN_LEN = 38_400
F0_TRAIN_N, F0_TRAIN_LEN = 8, 65_536     # the F0 trainer's chunk
LIB_CHUNKS, LIB_CHUNK_LEN = 512, 7_680   # generate_voice_library's input
GAN_WARMUP, GAN_STEPS = 2, 5
TRAIN_RANKS = 2
TRAIN_TIMEOUT_S = 300
# the dp gradients' worst tensor vs the dense semantics, set from the readings of
# train_dp_probe.py and this check on an H100 (G <= 1.05e-5, D <= 5.7e-7; a reference whose
# roll row came from another batch's content encoder run, 5e-6 apart, read D 7.4e-4 to 3.5e-3)
DP_GRAD_TOL = {"G": 1e-4, "D": 1e-5}
PHASE8_LIMIT_S = 90.0
PITCH_HZ = 120
# 4 levels x 2 decoder calls: 2 narrow (C = 16, 8) and 2 wide levels a call
PER_GAN_STEP = {"filter_level": 8, "filter_narrow": 4, "filter_wide": 4, "oscillator": 2, "stft": 2}


def train_models():
    """Full-width models from seed 0 (float32): the frozen content encoder
    and F0 estimator, and a decoder and discriminator to train.  The F0
    estimator's output bias is raised by 50 at bin 120, so its f0 is a
    speech pitch: a random estimator's argmax falls anywhere in 0-4095 Hz,
    and a near-tie there could flip between the card and the CPU."""
    import torch
    from alivevc_tpu_torch.config import (ContentEncoderConfig, DecoderConfig,
                                          DiscriminatorConfig, F0EstimatorConfig)
    from alivevc_tpu_torch.models.content_encoder import ContentEncoder
    from alivevc_tpu_torch.models.decoder import Decoder
    from alivevc_tpu_torch.models.discriminator import Discriminator
    from alivevc_tpu_torch.models.f0_estimator import F0Estimator

    g = torch.Generator().manual_seed(SEED)
    ce = ContentEncoder(ContentEncoderConfig(), generator=g)
    f0m = F0Estimator(F0EstimatorConfig(), generator=g)
    dec = Decoder(DecoderConfig(), generator=g)
    disc = Discriminator(DiscriminatorConfig(), generator=g)
    with torch.no_grad():
        f0m.output_layer.bias[PITCH_HZ] += 50.0
    for m in (ce, f0m):
        m.eval().requires_grad_(False)
    return [m.to(DEV) for m in (ce, f0m, dec, disc)]


def train_batch(n: int, length: int, seed: int):
    """[n, length] float32 on the card: gliding tones with noise, one pitch
    an item, from ``seed``; and each item's pitch in Hz."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    t = np.arange(length) / 16_000.0
    base = rng.uniform(100.0, 250.0, n)
    rows = [0.4 * np.sin(2 * np.pi * np.cumsum(b * (1.0 + 0.2 * np.sin(2 * np.pi * 0.5 * t))) / 16_000.0)
            + 0.02 * rng.standard_normal(length) for b in base]
    return torch.from_numpy(np.stack(rows).astype(np.float32)).to(DEV), base


def _rel_err(got, want) -> float:
    return max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
               for a, b in zip(got, want) if b is not None)


def worst_tensor(names, got, want) -> dict:
    """``_rel_err`` with its tensor: the largest max |got - want| / max
    |want| over same-ordered tensors, the tensor's name and its max |want|."""
    errs = [(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30), nm, float(b.abs().max()))
            for nm, a, b in zip(names, got, want)]
    err, name, peak = max(errs)
    return {"rel_err": err, "tensor": name, "max_abs_grad": peak}


def function_row(name, variant, run_fn, run_plain, inputs, gen, fwd_tol):
    """A kernel ``Function`` against its plain version on the same inputs:
    the forward's max abs error, and the gradient of every input for one
    random grad_out (max over inputs of max |diff| / max |plain|, held to
    1e-4: the backward is the plain version's own autograd, recomputed, so
    only cuDNN's non-deterministic weight-gradient sums differ).  Times: the
    kernel forward alone (no graph), the Function's forward + backward, the
    plain version's forward and its forward + backward (CUDA events)."""
    import torch

    out, want = run_fn(), run_plain()
    fwd_err = float((out - want).detach().abs().max())
    g_out = torch.randn(want.shape, generator=gen, device=want.device)
    got_g = torch.autograd.grad(out, inputs, g_out)
    want_g = torch.autograd.grad(want, inputs, g_out)
    grad_err = _rel_err(got_g, want_g)
    del out, want, got_g, want_g
    need(fwd_err <= fwd_tol, f"{name} {variant}: forward max abs err {fwd_err} > {fwd_tol}")
    need(grad_err <= 1e-4, f"{name} {variant}: gradient rel err {grad_err} > 1e-4")

    def fwd():
        with torch.no_grad():
            run_fn()

    def plain_fwd():
        with torch.no_grad():
            run_plain()

    fb = cuda_ms(lambda: torch.autograd.grad(run_fn(), inputs, g_out))
    ms = cuda_ms(fwd)
    row = {"name": name, "variant": f"{variant} (train)", "max_abs_err": fwd_err, "tol": fwd_tol,
           "grad_rel_err": grad_err, "ms": ms, "function_fwd_bwd_ms": fb, "backward_ms": fb - ms,
           "plain_ms": cuda_ms(plain_fwd, 2),
           "plain_fwd_bwd_ms": cuda_ms(lambda: torch.autograd.grad(run_plain(), inputs, g_out), 2)}
    return row


def check_train_functions(dec, gen):
    """Phase 8, step 1: each kernel Function at the GAN step's shapes: the
    filter's four levels for N = 8 x 38 400 samples (FiLM at 120 frames),
    the Chebyshev source, and the STFT, forward and gradients against the
    plain versions."""
    import torch
    from alivevc_tpu_torch.kernels.filter import filter_level, filter_level_plain
    from alivevc_tpu_torch.kernels.oscillator import harmonic_source, harmonic_source_plain
    from alivevc_tpu_torch.kernels.stft import stft_magnitude, stft_magnitude_plain
    from alivevc_tpu_torch.models.decoder import level_args

    cfg = dec.cfg
    rows = []
    lens = [TRAIN_LEN // 32, TRAIN_LEN // 4, TRAIN_LEN // 2, TRAIN_LEN]
    cond = (0.5 * torch.randn(TRAIN_N, TRAIN_LEN // 320, cfg.channels, generator=gen,
                              device=DEV)).requires_grad_(True)
    for i, (up, blk) in enumerate(zip(dec.filter.ups, dec.filter.blocks)):
        cin, c, r = up.weight.shape
        l_in = lens[i] // r
        x = (0.3 * torch.randn(TRAIN_N, l_in, cin, generator=gen, device=DEV)).requires_grad_(True)
        s = (0.3 * torch.randn(TRAIN_N, l_in, cin, generator=gen, device=DEV)).requires_grad_(True)
        with torch.no_grad():
            scale = float(filter_level_plain(x, s, rate=r, **level_args(blk, up, cond)).abs().max())
        rows.append(function_row(
            "filter_level", f"level {i} C={c} L={lens[i]} N={TRAIN_N} f32",
            lambda: filter_level(x, s, rate=r, **level_args(blk, up, cond)),
            lambda: filter_level_plain(x, s, rate=r, **level_args(blk, up, cond)),
            [x, s, cond, *up.parameters(), *blk.parameters()], gen, 1e-3 * (1.0 + scale)))
    lf = TRAIN_LEN // 320
    f0 = (100.0 + 150.0 * torch.rand(TRAIN_N, lf, 1, generator=gen, device=DEV)).requires_grad_(True)
    amps = torch.exp(0.5 * torch.randn(TRAIN_N, lf, cfg.num_harmonics, generator=gen,
                                       device=DEV)).requires_grad_(True)
    # sinf/cosf rounding grown by the Chebyshev recurrence (phase 2's tolerance)
    rows.append(function_row("oscillator", f"[{TRAIN_N}, {lf}] x {cfg.num_harmonics} f32",
                             lambda: harmonic_source(f0, amps), lambda: harmonic_source_plain(f0, amps),
                             [f0, amps], gen, 5e-3))
    x = (0.3 * torch.randn(TRAIN_N, TRAIN_LEN, generator=gen, device=DEV)).requires_grad_(True)
    rows.append(function_row("stft", f"[{TRAIN_N}, {TRAIN_LEN}] f32", lambda: stft_magnitude(x),
                             lambda: stft_magnitude_plain(x), [x], gen, 1e-3))
    return rows


def print_train_rows(rows, card) -> None:
    for r in rows:
        print(f"train function {r['name']:13s} {r['variant']:42s} fwd err {r['max_abs_err']:.3e} "
              f"(tol {r['tol']:.1e}) grad rel err {r['grad_rel_err']:.3e} (tol 1e-4) kernel fwd "
              f"{r['ms']:.4f} ms, Function fwd+bwd {r['function_fwd_bwd_ms']:.3f} (backward "
              f"{r['backward_ms']:.3f}), plain fwd {r['plain_ms']:.3f}, plain fwd+bwd "
              f"{r['plain_fwd_bwd_ms']:.3f} [{card}]")


TRAIN_GROUPS = (
    ("filter narrow kernels", ("filter_narrow_kernel", "filter_narrow_weights_kernel")),
    ("filter wide kernels", ("filter_wide_kernel", "filter_wide_weights_kernel")),
    ("oscillator kernel", ("osc_cheb",)),
    ("STFT kernel", ("stft_fft",)),
    ("kNN kernels", ("knn_prep", "knn_tile", "knn_merge", "knn_carried")),
    ("cuDNN/cuBLAS", ("gemm", "cudnn", "cutlass", "xmma", "cublas", "implicit_convolve",
                      "fprop", "dgrad", "wgrad")),
)


def _group(name: str) -> str:
    return next((g for g, keys in TRAIN_GROUPS if any(k in name for k in keys)), "other")


def profile_train_step(step, card, label):
    """Device time of one training step by group, the plain backward
    recompute (the device time launched under the Functions'
    ``RECOMPUTE_SPAN``) as a group of its own, and the device's busy share
    of the step's wall time.  ``step`` runs twice; the second is recorded."""
    import torch
    from alivevc_tpu_torch.kernels import _lib
    from torch.profiler import ProfilerActivity, profile, schedule

    # one step under the profiler before the recorded one: without it the
    # trace lost the step's first kernels (the distill step's one STFT
    # launch, which comes first, left no span)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        step()
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        prof.step()
    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    # kernels and copies; the device-side copies of profiler annotations
    # (the recompute span, torch.optim's "Optimizer.step#...") are ranges over
    # kernels, not work, and are left out
    spans = [(e.time_range.start, e.time_range.end, e.name) for e in events
             if e.device_type == cuda and not getattr(e, "is_user_annotation", False)
             and e.name != _lib.RECOMPUTE_SPAN]
    if not spans:
        print(f"profile, {label}: the profiler recorded no device time (not measured)")
        return None
    total = {g: 0.0 for g, _ in TRAIN_GROUPS}
    total["other"] = 0.0
    for start, end, name in spans:
        total[_group(name)] += (end - start) / 1e3
    inside = {g: 0.0 for g in total}
    n_inside = 0
    stack = [e for e in events if e.name == _lib.RECOMPUTE_SPAN and e.device_type != cuda]
    n_spans = len(stack)
    while stack:
        e = stack.pop()
        for k in getattr(e, "kernels", []):
            inside[_group(k.name)] += k.duration / 1e3
            n_inside += 1
        stack.extend(e.cpu_children)
    recompute = sum(inside.values())
    groups = {g: total[g] - inside[g] for g in total}
    groups["plain backward recompute"] = recompute if n_inside else None

    def union_ms(ranges):
        covered, cur_s, cur_e = 0.0, None, None
        for start, end in sorted(ranges):
            if cur_e is None or start > cur_e:
                covered += 0.0 if cur_e is None else cur_e - cur_s
                cur_s, cur_e = start, end
            else:
                cur_e = max(cur_e, end)
        return (covered + cur_e - cur_s) / 1e3 if cur_e is not None else 0.0

    busy = union_ms([(a, b) for a, b, _ in spans])
    # the recompute spans' device-side copies: from the first kernel launched
    # under a span to its last, on the device's timeline
    under = union_ms([(e.time_range.start, e.time_range.end) for e in events
                      if e.device_type == cuda and e.name == _lib.RECOMPUTE_SPAN])
    streams = len({getattr(e, "device_resource_id", None) for e in events if e.device_type == cuda})
    dev_total = sum(total.values())
    print(f"profile, {label} [{card}]: wall {wall_ms:.2f} ms, device busy {busy:.2f} ms "
          f"({100 * busy / wall_ms:.1f} % of wall), {len(spans)} device spans on {streams} streams "
          f"(cuDNN's own streams overlap the main one, so the groups may sum past the busy time), "
          f"{n_spans} recompute spans holding {n_inside} kernels and covering {under:.2f} ms "
          f"({100 * under / wall_ms:.1f} %) of the wall on the device's timeline")
    for g, ms in sorted(groups.items(), key=lambda kv: -(kv[1] or 0.0)):
        if ms is None:
            print(f"  {g:45s} not measured (no kernel linked under {_lib.RECOMPUTE_SPAN})")
        else:
            print(f"  {g:45s} {ms:9.3f} ms  {100 * ms / dev_total:5.1f} %")
    print("  of which in the recompute: " + ", ".join(f"{g} {ms:.3f}" for g, ms in inside.items()))
    other = {}
    for start, end, name in spans:
        if _group(name) == "other":
            other[name] = other.get(name, (0, 0.0))
            other[name] = (other[name][0] + 1, other[name][1] + (end - start) / 1e3)
    for name, (count, ms) in sorted(other.items(), key=lambda kv: -kv[1][1])[:8]:
        print(f"  other: {ms:8.3f} ms in {count:5d} spans  {name[:110]}")
    return {"wall_ms": wall_ms, "device_busy_ms": busy, "by_group_ms": groups,
            "recompute_by_group_ms": inside, "recompute_covers_ms": under,
            "device_spans": len(spans), "streams": streams}


def group_norms(names, grads, prefixes):
    import torch

    out = {}
    for pre in prefixes:
        sq = [g.double().pow(2).sum() for nm, g in zip(names, grads) if nm.startswith(pre)]
        out[pre] = float(torch.stack(sq).sum().sqrt())
    return out


def gan_card_vs_cpu(ce, f0m, dec, disc):
    """Phase 8, step 4: one GAN step's losses and per-module gradient norms
    at batch 1 x 9 600, full width, on the card (kernels) and on the CPU
    (plain versions), the same draws, TF32 off."""
    import copy

    import torch
    from alivevc_tpu_torch.train.gan import gan_draws, gan_grads, init_gan

    wave, _ = train_batch(1, 9600, SEED + 20)
    amp, jitter = gan_draws(1, torch.Generator().manual_seed(SEED + 21), "cpu")
    res = {}
    for where in ("card", "cpu"):
        dev = DEV if where == "card" else "cpu"
        mods = [copy.deepcopy(m).to(dev) for m in (ce, f0m, dec, disc)]
        st = init_gan(mods[2], mods[3])
        g, d, m = gan_grads(st, mods[0], mods[1], wave.to(dev), amp.to(dev), jitter.to(dev))
        norms = group_norms([k for k, _ in st.dec.named_parameters()], g,
                            ("feature_extractor", "harmonic_oscillator", "filter"))
        norms.update(group_norms([k for k, _ in st.disc.named_parameters()], d, ("MPD", "MRD")))
        res[where] = ({k: float(v) for k, v in m.items()}, norms)
    loss_err = max(abs(res["card"][0][k] - v) / max(abs(v), 1e-12) for k, v in res["cpu"][0].items())
    norm_err = max(abs(res["card"][1][k] - v) / max(v, 1e-30) for k, v in res["cpu"][1].items())
    return res, loss_err, norm_err


def dp_reference(ce, f0m, dec, disc, wave, amp, jitter):
    """The JAX package's data-parallel semantics computed densely on the
    card: each of the 2 ranks' halves through ``gan_grads`` with the roll
    crossing ranks, averaged; and the dense step on the whole batch."""
    import torch
    from alivevc_tpu_torch.train.gan import frozen_features, gan_grads, init_gan

    st = init_gan(dec, disc)
    half = wave.shape[0] // TRAIN_RANKS
    parts = [slice(half * j, half * (j + 1)) for j in range(TRAIN_RANKS)]
    # each rank's content from its own half, as the rank computes it
    last = [frozen_features(ce, f0m, wave[sl] * amp[sl])[0][-1:] for sl in parts]
    shards = []
    for j, sl in enumerate(parts):
        prev = last[j - 1]
        shards.append(gan_grads(st, ce, f0m, wave[sl], amp[sl], jitter,
                                roll=lambda c, prev=prev: torch.cat([prev, c[:-1]])))
    mean_g = [sum(s[0][i] for s in shards) / TRAIN_RANKS for i in range(len(shards[0][0]))]
    mean_d = [sum(s[1][i] for s in shards) / TRAIN_RANKS for i in range(len(shards[0][1]))]
    _, _, dense_m = gan_grads(st, ce, f0m, wave, amp, jitter)
    return mean_g, mean_d, dense_m


def train_rank(rank: int, world: int, tmp: str) -> None:
    """A spawned rank of phase 8's data-parallel check: gloo on cuda:0, this
    rank's half of the batch through ``gan_grads`` under the group; rank 0 writes the
    averaged gradients and metrics to tmp/train0.pt."""
    import os

    import torch
    import torch.distributed as dist
    from alivevc_tpu_torch.parallel import init_distributed
    from alivevc_tpu_torch.train.gan import gan_draws, gan_grads, init_gan

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_distributed("gloo", f"file://{tmp}/rendezvous", world, rank)
    try:
        ce, f0m, dec, disc = train_models()
        wave, _ = train_batch(2 * world, TRAIN_LEN, SEED + 30)
        amp, jitter = gan_draws(2 * world, torch.Generator().manual_seed(SEED + 31), DEV)
        sl = slice(2 * rank, 2 * rank + 2)
        g, d, m = gan_grads(init_gan(dec, disc), ce, f0m, wave[sl], amp[sl], jitter,
                            group=dist.group.WORLD)
        torch.cuda.synchronize()
        if rank == 0:
            torch.save({"g": [x.cpu() for x in g], "d": [x.cpu() for x in d],
                        "m": {k: float(v) for k, v in m.items()}}, os.path.join(tmp, "train0.pt"))
    finally:
        dist.destroy_process_group()


def run_train_dp(card):
    """Phase 8, step 6: ``gan_train_step``'s gradients on 2 gloo ranks on
    the one card (batch 2 each) against the same semantics computed densely
    (the mean of the two halves' gradients, the roll crossing them), and its
    metrics against the dense step at batch 4 (every one but 'feat', whose
    MRD part is a sum over the batch)."""
    import multiprocessing
    import os
    import tempfile

    import torch
    from alivevc_tpu_torch.train.gan import gan_draws

    with tempfile.TemporaryDirectory() as tmp:
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=train_rank, args=(r, TRAIN_RANKS, tmp)) for r in range(TRAIN_RANKS)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        try:
            ce, f0m, dec, disc = train_models()
            wave, _ = train_batch(2 * TRAIN_RANKS, TRAIN_LEN, SEED + 30)
            amp, jitter = gan_draws(2 * TRAIN_RANKS, torch.Generator().manual_seed(SEED + 31), DEV)
            mean_g, mean_d, dense_m = dp_reference(ce, f0m, dec, disc, wave, amp, jitter)
            for p in procs:
                p.join(max(1.0, TRAIN_TIMEOUT_S - (time.perf_counter() - t0)))
            alive = [p.pid for p in procs if p.is_alive()]
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(30)
        need(not alive, f"training ranks {alive} did not finish in {TRAIN_TIMEOUT_S} s")
        need(all(p.exitcode == 0 for p in procs), f"training ranks failed: {[p.exitcode for p in procs]}")
        got = torch.load(os.path.join(tmp, "train0.pt"), weights_only=False)
    g = worst_tensor([k for k, _ in dec.named_parameters()], [x.to(DEV) for x in got["g"]], mean_g)
    d = worst_tensor([k for k, _ in disc.named_parameters()], [x.to(DEV) for x in got["d"]], mean_d)
    m_err = max(abs(got["m"][k] - float(dense_m[k])) / max(abs(float(dense_m[k])), 1e-12)
                for k in ("loss_d", "mel", "con", "adv"))
    dt = time.perf_counter() - t0
    print(f"train dp [{card}]: gan_grads on {TRAIN_RANKS} gloo ranks on one card (batch 2 each, "
          f"{TRAIN_LEN} samples): gradients vs the two halves' mean, worst tensor's rel err: G "
          f"{g['rel_err']:.3e} at {g['tensor']} (max |grad| {g['max_abs_grad']:.3e}); D "
          f"{d['rel_err']:.3e} at {d['tensor']} (max |grad| {d['max_abs_grad']:.3e}) (<= "
          f"{DP_GRAD_TOL}); metrics but 'feat' vs the dense step at batch 4, rel err "
          f"{m_err:.3e} (<= 1e-4); 'feat' {got['m']['feat']:.6f} (ranks' mean) vs dense "
          f"{float(dense_m['feat']):.6f}; {dt:.1f} s with the ranks' start")
    need(g["rel_err"] <= DP_GRAD_TOL["G"] and d["rel_err"] <= DP_GRAD_TOL["D"],
         f"train dp: gradient rel err G {g}, D {d} over {DP_GRAD_TOL}")
    need(m_err <= 1e-4, f"train dp: metrics rel err {m_err} > 1e-4")
    return {"dp_grad_rel_err_g": g["rel_err"], "dp_grad_rel_err_d": d["rel_err"],
            "dp_grad_worst": {"G": g, "D": d}, "dp_metric_rel_err": m_err}


def run_train_clis(card):
    """Phase 8, step 7: ``cli/train_decoder.py`` (2 steps at 1 x 38 400) and
    ``cli/train_f0_estimator.py`` (2 steps at 1 x 65 536, WORLD labels on
    the host) on a temporary directory of synthetic WAVs, full width, models
    from seed 0 (no checkpoint files)."""
    import os
    import tempfile

    import numpy as np
    from alivevc_tpu_torch.cli import train_decoder, train_f0_estimator
    from alivevc_tpu_torch.io.audio import write_wav
    from alivevc_tpu_torch.kernels import LAUNCHES, reset_launches

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "data")
        os.makedirs(data)
        rng = np.random.default_rng(SEED + 40)
        for i in range(2):
            write_wav(os.path.join(data, f"{i}.wav"), request_wave(4.5, rng), 16_000)
        runs = (("train_decoder", lambda: train_decoder.main(
                    [data, "-sp", os.path.join(tmp, "gan_state.pt"), "-e", "1", "-b", "1",
                     "-cep", os.path.join(tmp, "none.ckpt"), "-f0ep", os.path.join(tmp, "none.ckpt")]), 2),
                ("train_f0_estimator", lambda: train_f0_estimator.main(
                    [data, "-mp", os.path.join(tmp, "f0_state.pt"), "-e", "1", "-b", "1"]), 2))
        for name, run, steps in runs:
            reset_launches()
            t0 = time.perf_counter()
            state = run()
            dt = time.perf_counter() - t0
            need(state.step == steps and os.path.exists(os.path.join(tmp, "gan_state.pt" if name ==
                 "train_decoder" else "f0_state.pt")), f"{name} CLI: {state.step} steps, expected {steps}")
            print(f"{name} CLI, full width, {steps} steps, models from seed 0: {dt:.2f} s wall "
                  f"(dataset load, model build and steps), launches {dict(LAUNCHES)} [{card}]")
            out[name] = dt
    return out


def run_training(card):
    """Phase 8: training at full width, float32, random weights from seed 0;
    counters zeroed before the GAN steps and read after.  Returns (launches
    over the phase, the Functions' rows, the report)."""
    import copy

    import numpy as np
    import torch
    from alivevc_tpu_torch.config import VoiceLibraryConfig
    from alivevc_tpu_torch.kernels import LAUNCHES, reset_launches
    from alivevc_tpu_torch.models.voice_library import VoiceLibrary
    from alivevc_tpu_torch.train.f0 import f0_amp_draws, f0_train_step, init_f0_train
    from alivevc_tpu_torch.train.fine_tune import amp_draws, fine_tune_step, init_fine_tune
    from alivevc_tpu_torch.train.gan import gan_draws, gan_grads, gan_train_step, init_gan
    from alivevc_tpu_torch.train.library_gen import generate_voice_library

    t_phase = time.perf_counter()
    total = {k: 0 for k in LAUNCHES}

    def add(counts):
        for k in total:
            total[k] += counts[k]

    report = {}
    gen = torch.Generator(device=DEV).manual_seed(SEED + 10)
    ce, f0m, dec, disc = train_models()

    # 1. each Function against its plain version (uncounted)
    rows = check_train_functions(copy.deepcopy(dec), gen)
    print_train_rows(rows, card)

    # the plain backward recompute a GAN step runs, from the rows' CUDA-event
    # times: each level twice (two decoder calls), the source twice, the STFT
    # once (the content loss)
    by = {r["variant"]: r["backward_ms"] for r in rows}
    recompute_ms = sum(2 * v for k, v in by.items() if k.startswith("level")) + sum(
        (2 if r["name"] == "oscillator" else 1) * r["backward_ms"] for r in rows
        if r["name"] in ("oscillator", "stft"))
    print(f"train: the Functions' backward (plain recompute) a GAN step, from the rows above: "
          f"{recompute_ms:.3f} ms [{card}]")
    report["recompute_ms_per_step"] = recompute_ms

    # 2. GAN steps at 8 x 38 400
    state = init_gan(copy.deepcopy(dec), copy.deepcopy(disc))
    wave, _ = train_batch(TRAIN_N, TRAIN_LEN, SEED + 11)
    draw_gen = torch.Generator().manual_seed(SEED + 12)
    times = []
    reset_launches()
    for i in range(GAN_WARMUP + GAN_STEPS):
        if i == GAN_WARMUP:
            torch.cuda.reset_peak_memory_stats()
            add(LAUNCHES)
            reset_launches()
        amp, jitter = gan_draws(TRAIN_N, draw_gen, DEV)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = gan_train_step(state, ce, f0m, wave, amp, jitter)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    per_step = {k: v / GAN_STEPS for k, v in LAUNCHES.items()}
    add(LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**20
    timed = times[GAN_WARMUP:]
    print(f"train GAN [{card}]: {GAN_STEPS} gan_train_steps at {TRAIN_N} x {TRAIN_LEN} after "
          f"{GAN_WARMUP} warm-up: ms/step median {statistics.median(timed):.2f}, min {min(timed):.2f}, "
          f"max {max(timed):.2f} (all {', '.join(f'{x:.2f}' for x in timed)}); peak memory "
          f"{peak:.1f} MiB; launches a step {per_step} (expected {PER_GAN_STEP}); losses "
          f"{ {k: round(float(v), 5) for k, v in m.items()} }")
    need(all(per_step[k] == v for k, v in PER_GAN_STEP.items()),
         f"GAN step launches {per_step} != {PER_GAN_STEP}")
    need(all(np.isfinite(float(v)) for v in m.values()), f"GAN step: non-finite metrics {m}")
    amp, jitter = gan_draws(TRAIN_N, draw_gen, DEV)
    prof = profile_train_step(lambda: gan_train_step(state, ce, f0m, wave, amp, jitter), card,
                              f"one GAN step at {TRAIN_N} x {TRAIN_LEN}")
    report["gan"] = {"ms_median": statistics.median(timed), "ms_min": min(timed),
                     "ms_max": max(timed), "peak_mib": peak, "launches_per_step": per_step,
                     "profile": prof}

    # 3. every parameter learns (one step's gradients, uncounted)
    amp, jitter = gan_draws(TRAIN_N, draw_gen, DEV)
    g, d, _ = gan_grads(state, ce, f0m, wave, amp, jitter)
    for label, model, grads in (("decoder", state.dec, g), ("discriminator", state.disc, d)):
        bad = [nm for (nm, _), x in zip(model.named_parameters(), grads)
               if not bool(torch.isfinite(x).all()) or not bool((x != 0).any())]
        print(f"train: every {label} parameter learns: {len(grads) - len(bad)} of {len(grads)} "
              f"tensors have a finite, nonzero gradient{'' if not bad else f'; not: {bad}'} [{card}]")
        need(not bad, f"{label} parameters without a finite, nonzero gradient: {bad}")
    del g, d

    # 4. card against CPU
    res, loss_err, norm_err = gan_card_vs_cpu(ce, f0m, dec, disc)
    print(f"train card vs CPU [{card}]: one GAN step at 1 x 9600, full width, TF32 off: losses "
          f"max rel err {loss_err:.3e} (<= 1e-3), per-module gradient norms max rel err "
          f"{norm_err:.3e} (<= 1e-2); card {res['card']}; CPU {res['cpu']}")
    need(loss_err <= 1e-3 and norm_err <= 1e-2,
         f"card vs CPU: losses {loss_err}, gradient norms {norm_err}")
    report["card_vs_cpu"] = {"loss_rel_err": loss_err, "grad_norm_rel_err": norm_err}
    del state
    torch.cuda.empty_cache()

    # 5. the other trainers
    lib_cfg = VoiceLibraryConfig(dim=ce.cfg.output_channels)
    vl = VoiceLibrary(lib_cfg, generator=torch.Generator().manual_seed(SEED + 13)).to(DEV)
    ft = init_fine_tune(copy.deepcopy(dec), copy.deepcopy(disc), vl)
    tokens0 = vl.tokens.detach().clone()
    reset_launches()
    ft_ms = []
    for _ in range(2):
        amp = amp_draws(TRAIN_N, draw_gen, DEV)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fine_tune_step(ft, ce, f0m, wave, amp)
        torch.cuda.synchronize()
        ft_ms.append((time.perf_counter() - t0) * 1e3)
    ft_launches = dict(LAUNCHES)
    add(LAUNCHES)
    moved = float((vl.tokens.detach() - tokens0).abs().max())
    print(f"train fine-tune [{card}]: 2 fine_tune_steps at {TRAIN_N} x {TRAIN_LEN} with a 512-token "
          f"library: ms/step {', '.join(f'{x:.2f}' for x in ft_ms)}; launches {ft_launches}; tokens "
          f"moved by up to {moved:.3e}")
    # the 512-token library takes the carried form, one launch a step
    need(ft_launches["knn_carried"] == 2 and ft_launches["knn"] == 0 and moved > 0,
         f"fine-tune: kNN launches {ft_launches['knn_carried']} carried, {ft_launches['knn']} "
         f"two-pass, tokens moved {moved}")
    del ft, vl
    f0s = init_f0_train(copy.deepcopy(f0m))
    f0_wave, base = train_batch(F0_TRAIN_N, F0_TRAIN_LEN, SEED + 14)
    labels = torch.from_numpy(np.repeat(base[:, None], F0_TRAIN_LEN // 320, 1).astype(np.float32)).to(DEV)
    reset_launches()
    f0_ms, losses = [], []
    for _ in range(5):
        amp = f0_amp_draws(F0_TRAIN_N, draw_gen, DEV)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(f0_train_step(f0s, f0_wave, labels, amp)["loss"]))
        f0_ms.append((time.perf_counter() - t0) * 1e3)
    f0_launches = dict(LAUNCHES)
    add(LAUNCHES)
    print(f"train F0 [{card}]: 5 f0_train_steps at {F0_TRAIN_N} x {F0_TRAIN_LEN}: ms/step "
          f"{', '.join(f'{x:.2f}' for x in f0_ms)}; losses {losses}; launches {f0_launches}")
    need(f0_launches["stft"] == 5 and all(np.isfinite(losses)), f"F0 trainer: {f0_launches}, {losses}")
    chunks = train_batch(LIB_CHUNKS, LIB_CHUNK_LEN, SEED + 15)[0].cpu().numpy()
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lib = generate_voice_library(ce, chunks, seed=SEED, cfg=lib_cfg, device=DEV)
    torch.cuda.synchronize()
    lib_ms = (time.perf_counter() - t0) * 1e3
    lib_launches = dict(LAUNCHES)
    add(LAUNCHES)
    print(f"train library generation [{card}]: {LIB_CHUNKS} chunks of {LIB_CHUNK_LEN}: {lib_ms:.2f} ms, "
          f"launches {lib_launches}, tokens {tuple(lib.tokens.shape)}")
    need(bool(torch.isfinite(lib.tokens).all()) and lib_launches["stft"] == LIB_CHUNKS // 64,
         f"library generation: {lib_launches}")
    report["fine_tune_ms"], report["f0_ms"], report["library_ms"] = ft_ms, f0_ms, lib_ms

    # 6. data parallel, 7. the CLIs
    torch.cuda.empty_cache()
    report["dp"] = run_train_dp(card)
    torch.cuda.empty_cache()
    report["cli_s"] = run_train_clis(card)
    elapsed = time.perf_counter() - t_phase
    report["phase_s"] = elapsed
    print(f"train: phase 8 took {elapsed:.1f} s (<= {PHASE8_LIMIT_S:.0f})")
    need(elapsed <= PHASE8_LIMIT_S, f"phase 8 took {elapsed:.1f} s > {PHASE8_LIMIT_S}")
    return total, rows, report


# ---------------------------------------------------------------------------
# phase 9: distillation (the WavLM teacher, the distill step, its dp step,
# the CLI) and export (the six torch.export graphs)
# ---------------------------------------------------------------------------

DISTILL_N, DISTILL_LEN = 16, 65_536      # the distillation CLI's default -b and -len
DISTILL_STEPS = 5
DISTILL_RANKS = 2
DISTILL_TIMEOUT_S = 300
TEACHER_TOL = 1e-4           # card vs CPU features, float32 without TF32 (the CPU tests' tolerance)
# the dp gradients' worst tensor (max abs err / its max): vs the two halves'
# mean on the card (the ranks read 0.0); vs the dense step on the whole batch,
# where each L1 sign that the two batch shapes round apart moves an entry by
# 2 |x| / (N T C) (over the four batches: 3, 1, 0, 0 flips reading 8.8e-4,
# 8.2e-4, 7.1e-7, 6.3e-7); vs the dense step with the halves' L1 signs, the
# float32 floor if the flips are the whole dense error (6.1e-7 to 7.1e-7; one
# flip left out reads ~8e-4).  A rank without the all-reduce (the control)
# reads 0.23-0.51 and must read above the dense gate.
DISTILL_DP_TOL = 1e-5
DISTILL_DENSE_TOL = 1e-2
DISTILL_SIGNED_TOL = 1e-5
# (wave seed, teacher seed) of the batches read; the ranks run the first
DISTILL_DP_BATCHES = ((SEED + 50, SEED + 51), (SEED + 53, SEED + 54), (SEED + 55, SEED + 56),
                      (SEED + 57, SEED + 58))
EXPORT_LEN = 256
EXPORT_TOL = 1e-5            # graph vs eager: |diff| / max(1, max |eager|)
PHASE9_LIMIT_S = 90.0


def distill_student():
    """The default content encoder from seed 0, on the card."""
    import torch
    from alivevc_tpu_torch.models.content_encoder import ContentEncoder

    return ContentEncoder(generator=torch.Generator().manual_seed(SEED)).to(DEV)


def distill_target(n: int, seed: int):
    """A teacher-shaped target [n, 204, 768] on the card, N(0, 0.1^2) from ``seed``."""
    import numpy as np
    import torch

    t = 0.1 * np.random.default_rng(seed).standard_normal((n, DISTILL_LEN // 320, 768), dtype=np.float32)
    return torch.from_numpy(t).to(DEV)


def distill_rank(rank: int, world: int, tmp: str) -> None:
    """A spawned rank of phase 9's dp check: gloo on cuda:0, this rank's
    slice of the batch through ``distill_grads`` under the group; rank 0 writes the
    gradients and the loss to tmp/distill0.pt."""
    import os

    import torch
    import torch.distributed as dist
    from alivevc_tpu_torch.parallel import init_distributed
    from alivevc_tpu_torch.train.distill import distill_grads, init_distill

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_distributed("gloo", f"file://{tmp}/rendezvous", world, rank)
    try:
        wave, _ = train_batch(DISTILL_N, DISTILL_LEN, SEED + 50)
        teacher = distill_target(DISTILL_N, SEED + 51)
        per = DISTILL_N // world
        sl = slice(rank * per, (rank + 1) * per)
        g, loss = distill_grads(init_distill(distill_student()), wave[sl], teacher[sl],
                                dist.group.WORLD)
        torch.cuda.synchronize()
        if rank == 0:
            torch.save({"g": [x.cpu() for x in g], "loss": float(loss)}, os.path.join(tmp, "distill0.pt"))
    finally:
        dist.destroy_process_group()


def start_distill_ranks(tmp: str):
    """Spawn phase 9's dp ranks (their start, ~20 s of imports and CUDA
    set-up, overlaps the CLIs and the export); returns (processes, start)."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=distill_rank, args=(r, DISTILL_RANKS, tmp)) for r in range(DISTILL_RANKS)]
    for p in procs:
        p.start()
    return procs, time.perf_counter()


def distill_dense_readings(state, names, wave_seed: int, target_seed: int):
    """Phase 9's dp readings on one batch of 16, on the card: the halves'
    mean (the two halves' ``distill_grads`` averaged, what the ranks'
    all-reduce computes) against the dense gradients on the whole batch;
    the L1 signs that differ between the dense forward and the halves'
    (cuBLAS and cuDNN choose by shape, so ``out`` rounds apart where it
    meets the teacher); the halves' mean against the dense gradients taken
    with the halves' signs (d loss / d out = sign(out_halves - teacher) /
    (N T C)), which reads the float32 floor if those flips account for the
    whole dense error; and the control, one half's gradients alone (a rank
    without the all-reduce), against both.  Returns (the readings, (dense
    gradients, dense loss, halves' mean, signed gradients))."""
    import torch
    from alivevc_tpu_torch.models.content_encoder import content_encoder
    from alivevc_tpu_torch.ops.stft import spectrogram
    from alivevc_tpu_torch.train.distill import distill_grads

    wave, _ = train_batch(DISTILL_N, DISTILL_LEN, wave_seed)
    teacher = distill_target(DISTILL_N, target_seed)
    dense_g, dense_loss = distill_grads(state, wave, teacher)
    per = DISTILL_N // DISTILL_RANKS
    parts = [slice(per * j, per * (j + 1)) for j in range(DISTILL_RANKS)]
    halves = [distill_grads(state, wave[sl], teacher[sl])[0] for sl in parts]
    mean_g = [sum(h[i] for h in halves) / DISTILL_RANKS for i in range(len(dense_g))]
    with torch.no_grad():
        signs = torch.cat([torch.sign(content_encoder(state.model, spectrogram(wave[sl])) - teacher[sl])
                           for sl in parts])
    out = content_encoder(state.model, spectrogram(wave))
    flips = int((torch.sign(out.detach() - teacher) != signs).sum())
    signed_g = list(torch.autograd.grad(torch.mean((out - teacher) * signs),
                                        list(state.model.parameters())))
    readings = {"seeds": [wave_seed, target_seed], "l1_sign_flips": flips, "elements": signs.numel(),
                "mean_vs_dense": worst_tensor(names, mean_g, dense_g),
                "mean_vs_signed": worst_tensor(names, mean_g, signed_g),
                "control_vs_dense": worst_tensor(names, halves[0], dense_g),
                "control_vs_mean": worst_tensor(names, halves[0], mean_g)}
    return readings, (dense_g, dense_loss, mean_g, signed_g)


def finish_distill_dp(card, procs, t0, tmp):
    """Phase 9: ``distill_grads`` under the group (the gradients
    ``distill_step`` applies) on 2 gloo ranks on the one card, 8 x 65 536 each, against the
    halves' mean, the dense step on the whole batch of 16, and the dense
    step with the halves' L1 signs (``distill_dense_readings``, which also
    reads the last three over the other batches of ``DISTILL_DP_BATCHES``
    and the control)."""
    import os

    import torch
    from alivevc_tpu_torch.train.distill import init_distill

    try:
        state = init_distill(distill_student())
        names = [k for k, _ in state.model.named_parameters()]
        readings = []
        for ws, ts in DISTILL_DP_BATCHES:
            r, tensors = distill_dense_readings(state, names, ws, ts)
            if not readings:
                dense_g, dense_loss, mean_g, signed_g = tensors
            del tensors
            readings.append(r)
        for p in procs:
            p.join(max(1.0, DISTILL_TIMEOUT_S - (time.perf_counter() - t0)))
        alive = [p.pid for p in procs if p.is_alive()]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(30)
    need(not alive, f"distill ranks {alive} did not finish in {DISTILL_TIMEOUT_S} s")
    need(all(p.exitcode == 0 for p in procs), f"distill ranks failed: {[p.exitcode for p in procs]}")
    got = torch.load(os.path.join(tmp, "distill0.pt"), weights_only=False)
    g = [x.to(DEV) for x in got["g"]]
    w = worst_tensor(names, g, mean_g)
    wd = worst_tensor(names, g, dense_g)
    ws = worst_tensor(names, g, signed_g)
    loss_err = abs(got["loss"] - float(dense_loss)) / abs(float(dense_loss))
    dt = time.perf_counter() - t0

    def at(x):
        return f"{x['rel_err']:.3e} at {x['tensor']}"

    for r in readings:
        print(f"distill dp batch (seeds {r['seeds'][0]}, {r['seeds'][1]}) [{card}]: {r['l1_sign_flips']} "
              f"of {r['elements']} L1 signs differ between the dense and the halves' forwards; the "
              f"halves' mean vs dense {at(r['mean_vs_dense'])} (<= {DISTILL_DENSE_TOL:.0e}), vs dense "
              f"with the halves' signs {at(r['mean_vs_signed'])} (<= {DISTILL_SIGNED_TOL:.0e}); control, "
              f"one half alone (no all-reduce): vs dense {at(r['control_vs_dense'])} (> "
              f"{DISTILL_DENSE_TOL:.0e}), vs the halves' mean {at(r['control_vs_mean'])}")
    print(f"distill dp [{card}]: distill_grads on {DISTILL_RANKS} gloo ranks on one card "
          f"({DISTILL_N // DISTILL_RANKS} x {DISTILL_LEN} each, seeds {DISTILL_DP_BATCHES[0]}): worst "
          f"tensor's max abs err / its max vs the two halves' mean {at(w)} (max |grad| "
          f"{w['max_abs_grad']:.3e}; <= {DISTILL_DP_TOL:.0e}); vs the dense step at {DISTILL_N} {at(wd)} "
          f"(<= {DISTILL_DENSE_TOL:.0e}); vs the dense step with the halves' L1 signs {at(ws)} (<= "
          f"{DISTILL_SIGNED_TOL:.0e}); loss rel err vs dense {loss_err:.3e} (<= 1e-5); {dt:.1f} s since "
          f"the ranks' start")
    need(w["rel_err"] <= DISTILL_DP_TOL and wd["rel_err"] <= DISTILL_DENSE_TOL
         and ws["rel_err"] <= DISTILL_SIGNED_TOL and loss_err <= 1e-5,
         f"distill dp: gradients vs halves {w}, vs dense {wd}, vs signed dense {ws}, loss rel err {loss_err}")
    need(all(r["mean_vs_dense"]["rel_err"] <= DISTILL_DENSE_TOL
             and r["mean_vs_signed"]["rel_err"] <= DISTILL_SIGNED_TOL
             and r["control_vs_dense"]["rel_err"] > DISTILL_DENSE_TOL for r in readings),
         f"distill dp readings: {readings}")
    return {"dp_grad_rel_err": w["rel_err"], "dp_grad_worst": w, "dense_grad_rel_err": wd["rel_err"],
            "dense_grad_worst": wd, "signed_dense_grad_worst": ws, "dp_loss_rel_err": loss_err,
            "batches": readings}


def run_distill_clis(card, teacher, wavlm_path, tmp):
    """Phase 9: ``cli/train_content_encoder.py`` for 2 steps (-b 2 over four
    65 536-sample chunks of synthetic WAVs), with ``--wavlm-checkpoint`` and
    with ``--teacher-features`` (features from the phase's teacher), then
    ``cli/inference.py -cep`` on the training state the first run wrote.
    Counters zeroed before each run and read after; returns (launches,
    summed; the first training state's path; the report)."""
    import os

    import numpy as np
    import torch
    from alivevc_tpu_torch.cli import inference, train_content_encoder
    from alivevc_tpu_torch.cli.common import load_params_or_init
    from alivevc_tpu_torch.io.audio import read_wav, write_wav
    from alivevc_tpu_torch.io.dataset import WaveChunkDataset
    from alivevc_tpu_torch.kernels import LAUNCHES, reset_launches
    from alivevc_tpu_torch.train.state import load_train_state

    data = os.path.join(tmp, "data")
    os.makedirs(data)
    rng = np.random.default_rng(SEED + 60)
    for i in range(2):
        write_wav(os.path.join(data, f"{i}.wav"), request_wave(8.5, rng), 16_000)
    chunks = WaveChunkDataset([data], length=DISTILL_LEN).chunks
    np.savez(os.path.join(tmp, "feats.npz"), features=teacher.extract(chunks).cpu().numpy())
    total = {k: 0 for k in LAUNCHES}
    report = {}
    paths = {}
    for name, flags in (("wavlm", ["--wavlm-checkpoint", wavlm_path]),
                        ("features", ["--teacher-features", os.path.join(tmp, "feats.npz")])):
        paths[name] = os.path.join(tmp, f"ce_{name}.pt")
        reset_launches()
        t0 = time.perf_counter()
        state = train_content_encoder.main([data, "-mp", paths[name], "-e", "1", "-b", "2",
                                            "--device", DEV, *flags])
        dt = time.perf_counter() - t0
        got = dict(LAUNCHES)
        need(state.step == 2 and os.path.exists(paths[name]) and got["stft"] == 2,
             f"train_content_encoder {name}: {state.step} steps, launches {got}")
        print(f"train_content_encoder CLI with {flags[0]}, full width, 2 steps at 2 x {DISTILL_LEN}: "
              f"{dt:.2f} s wall (dataset, teacher, model build and steps), launches {got} [{card}]")
        report[f"cli_{name}_s"] = dt
        for k in total:
            total[k] += got[k]
    a, b = (load_train_state(p)["models"]["content_encoder"] for p in paths.values())
    report["cli_runs_max_abs_diff"] = max(float((v - b[k]).abs().max()) for k, v in a.items())
    in_dir, target = os.path.join(tmp, "in"), os.path.join(tmp, "target.wav")
    os.makedirs(in_dir)
    write_wav(os.path.join(in_dir, "voice.wav"), request_wave(2.0, rng), 16_000)
    write_wav(target, request_wave(10.0, rng), 16_000)
    reset_launches()
    t0 = time.perf_counter()
    out = inference.main(["-i", in_dir, "-o", os.path.join(tmp, "out"), "-t", target,
                          "-cep", paths["wavlm"], "--device", DEV])[0]
    dt = time.perf_counter() - t0
    got = dict(LAUNCHES)
    written, _ = read_wav(os.path.join(tmp, "out", "0_voice.wav"))
    ce = load_params_or_init(paths["wavlm"], "content_encoder", torch.device(DEV))
    same = all(torch.equal(ce.state_dict()[k].cpu(), v) for k, v in a.items())
    need(out.shape == (32_000,) and written.shape == (1, 32_000) and bool(np.isfinite(out).all())
         and same and all(got[k] > 0 for k in CLI_OFFLINE_KERNELS),
         f"inference -cep: output {out.shape}, file {written.shape}, encoder as trained {same}, {got}")
    print(f"inference CLI -cep <the distillation's training state>: 2 s in, {out.shape[0]} samples "
          f"out, {dt:.2f} s wall, the encoder read as trained, launches {got}; the two distillation "
          f"runs' encoders differ by at most {report['cli_runs_max_abs_diff']:.3e} [{card}]")
    report["cli_inference_s"] = dt
    for k in total:
        total[k] += got[k]
    return total, paths["wavlm"], report


def run_export(card, ce_path, tmp):
    """Phase 9: ``cli/export.py`` at --length 256 on the card (the encoder
    from ``ce_path``, the other models from seed 0), each ``.pt2`` loaded and
    run against the port's eager function on the kernel path (uncounted),
    the ``--torch-out`` files loaded strictly, and the eager path after the
    export equal to the one before (with ``ops/interp.py``'s cache emptied
    first, so that tracing would meet it empty)."""
    import os

    import torch
    from alivevc_tpu_torch.cli import export
    from alivevc_tpu_torch.cli.common import load_params_or_init
    from alivevc_tpu_torch.compat import torch_import
    from alivevc_tpu_torch.models.content_encoder import content_encoder
    from alivevc_tpu_torch.models.decoder import feature_extractor, filter_unet
    from alivevc_tpu_torch.models.f0_estimator import f0_estimate, f0_estimator
    from alivevc_tpu_torch.models.voice_library import voice_library_match
    from alivevc_tpu_torch.ops import interp
    from alivevc_tpu_torch.ops.stft import spectrogram

    dev = torch.device(DEV)
    paths = {"content_encoder": ce_path, **{k: os.path.join(tmp, f"none_{k}.pt")
                                            for k in ("f0_estimator", "decoder", "voice_library")}}
    m = {k: load_params_or_init(p, k, dev) for k, p in paths.items()}
    t = EXPORT_LEN
    wave, _ = train_batch(1, t * 320, SEED + 70)
    source = wave[:, :, None]
    with torch.no_grad():
        spec = spectrogram(wave)
        content = content_encoder(m["content_encoder"], spec)
        f0 = f0_estimate(m["f0_estimator"], spec)
        feats = feature_extractor(m["decoder"].feature_extractor, content, f0)
        osc, seg = m["decoder"].harmonic_oscillator, m["decoder"].cfg.segment_size
        eager = {"amps": export.oscillator_amps(osc, feats, seg),
                 "filter": filter_unet(m["decoder"].filter, source, feats, m["decoder"].cfg)[..., 0]}
    interp._WEIGHTS.clear()
    t0 = time.perf_counter()
    written = export.main(["-o", os.path.join(tmp, "export"), "--length", str(t), "--torch-out",
                           os.path.join(tmp, "torch_out"), "-cep", paths["content_encoder"],
                           "-f0ep", paths["f0_estimator"], "-dep", paths["decoder"],
                           "-lib", paths["voice_library"], "--device", DEV])
    export_s = time.perf_counter() - t0
    with torch.no_grad():
        after = {"amps": export.oscillator_amps(osc, feats, seg),
                 "filter": filter_unet(m["decoder"].filter, source, feats, m["decoder"].cfg)[..., 0]}
    real = all(type(v) is torch.Tensor and torch.equal(v, eager[k]) for k, v in after.items())
    need(real, "export: an eager call after the export is not a real tensor equal to the one before")
    t0 = time.perf_counter()
    graphs = {k: torch.export.load(p).module() for k, p in written.items()}
    load_s = time.perf_counter() - t0
    errs = {}
    with torch.no_grad():
        cases = {
            "content_encoder": ((spec,), content),
            "feature_extractor": ((content, f0), feats),
            "harmonic_oscillator": ((feats,), eager["amps"]),
            "voice_library": ((content,), voice_library_match(m["voice_library"], content)),
            "filter": ((source, feats), eager["filter"]),
        }
        for name, (args, want) in cases.items():
            got = graphs[name](*args)
            need(got.shape == want.shape and got.device == want.device,
                 f"export {name}: {tuple(got.shape)} on {got.device}")
            err = float((got - want).abs().max())
            scale = float(want.abs().max())
            if name == "filter":    # the kernel's 3xTF32 products against float32 (phase 2)
                tol = 1e-3 * (1.0 + scale)
            elif name == "voice_library":   # identical index sets
                tol = 1e-6
            else:
                tol = EXPORT_TOL * max(1.0, scale)
            errs[name] = {"max_abs_err": err, "tol": tol, "max_abs": scale}
            need(err <= tol, f"export {name}: graph vs eager max abs err {err} > {tol}")
        # f0: the argmax bins, identical wherever the top two logits are more
        # than 1e-4 apart (the CPU tests' rule for a discrete output)
        bins = graphs["f0_estimator"](spec)
        top2 = torch.topk(f0_estimator(m["f0_estimator"], spec), 2, dim=-1).values
        clear = (top2[..., 0] - top2[..., 1]) > 1e-4
        differ = int((bins[..., 0] != f0[..., 0]).sum())
        differ_clear = int(((bins[..., 0] != f0[..., 0]) & clear).sum())
        errs["f0_estimator"] = {"bins_differing": differ, "bins_differing_clear": differ_clear,
                                "frames": t, "clear_frames": int(clear.sum())}
        need(differ_clear == 0, f"export f0_estimator: {differ_clear} clear bins differ")
    for kind, cls_import in (("content_encoder", torch_import.import_content_encoder),
                             ("f0_estimator", torch_import.import_f0_estimator),
                             ("decoder", torch_import.import_decoder),
                             ("voice_library", torch_import.import_voice_library)):
        sd = torch_import.load_torch_state_dict(os.path.join(tmp, "torch_out", f"{kind}.pt"))
        loaded = cls_import(sd)      # strict key matching
        need(all(torch.equal(v, m[kind].state_dict()[k].cpu()) for k, v in loaded.state_dict().items()),
             f"export --torch-out {kind}: weights differ")
    sizes = {k: os.path.getsize(p) for k, p in written.items()}
    print(f"export [{card}]: cli.export at --length {t} on the card, 6 graphs in {export_s:.2f} s "
          f"(tracing and saving), loaded in {load_s:.2f} s, {sum(sizes.values()) / 2**20:.1f} MiB; graph "
          f"vs the eager kernel path: {json.dumps(errs)}; --torch-out loads strictly; the eager path "
          f"after the export returns real tensors equal to the ones before")
    return {"export_s": export_s, "load_s": load_s, "errors": errs, "bytes": sizes}


def run_distillation(card):
    """Phase 9: distillation at full width (the default WavLM teacher from a
    seed-drawn state dict, the default content encoder, batch 16 x 65 536),
    float32 without TF32, and export; counters zeroed before the timed
    distill steps and the CLI runs and read after.  Returns (launches, the
    STFT row at the distillation's shape, the report)."""
    import copy
    import os
    import tempfile

    import numpy as np
    import torch
    from alivevc_tpu_torch.io.teacher import WavLMTeacher
    from alivevc_tpu_torch.kernels import LAUNCHES, reset_launches
    from alivevc_tpu_torch.models.wavlm import WavLMConfig, seeded_state, wavlm_features
    from alivevc_tpu_torch.train.distill import distill_grads, distill_step, init_distill

    t_phase = time.perf_counter()
    total = {k: 0 for k in LAUNCHES}
    report = {}
    with tempfile.TemporaryDirectory() as tmp:
        # 1. the teacher
        wavlm_path = os.path.join(tmp, "wavlm.pt")
        torch.save({k: torch.from_numpy(v) for k, v in seeded_state(WavLMConfig(), SEED).items()},
                   wavlm_path)
        teacher = WavLMTeacher(wavlm_path)
        n_params = sum(p.numel() for p in teacher.model.parameters())
        wave, _ = train_batch(DISTILL_N, DISTILL_LEN, SEED + 52)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        feats = teacher.extract(wave)
        t_ms = cuda_ms(lambda: teacher.extract(wave))
        t_peak = (torch.cuda.max_memory_allocated() - base) / 2**20
        with torch.no_grad():
            cpu_feat = wavlm_features(copy.deepcopy(teacher.model).cpu(), wave[:1].cpu())
        t_err = float((feats[:1].cpu() - cpu_feat).abs().max())
        print(f"distill teacher [{card}]: WavLM ({n_params / 1e6:.1f} M parameters, seed-drawn, HF keys) "
              f"features for {DISTILL_N} x {DISTILL_LEN}: {tuple(feats.shape)}, {t_ms:.3f} ms (CUDA "
              f"events, median), peak memory above the weights {t_peak:.1f} MiB; card vs CPU, one chunk, "
              f"TF32 off: max abs err {t_err:.3e} (<= {TEACHER_TOL:.0e}; max |feature| "
              f"{float(cpu_feat.abs().max()):.3f})")
        need(feats.shape == (DISTILL_N, DISTILL_LEN // 320, 768) and bool(torch.isfinite(feats).all())
             and t_err <= TEACHER_TOL, f"teacher: {tuple(feats.shape)}, card vs CPU {t_err}")
        report["teacher"] = {"ms": t_ms, "peak_mib": t_peak, "card_vs_cpu": t_err, "params": n_params}

        # 2. distill steps at 16 x 65 536
        state = init_distill(distill_student())
        distill_step(state, wave, feats)          # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        times, losses = [], []
        reset_launches()
        for _ in range(DISTILL_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(float(distill_step(state, wave, feats)["loss"]))
            times.append((time.perf_counter() - t0) * 1e3)
        launches = dict(LAUNCHES)
        for k in total:
            total[k] += launches[k]
        peak = (torch.cuda.max_memory_allocated() - base) / 2**20
        print(f"distill step [{card}]: {DISTILL_STEPS} distill_steps at {DISTILL_N} x {DISTILL_LEN} after "
              f"1 warm-up: ms/step median {statistics.median(times):.2f}, min {min(times):.2f}, max "
              f"{max(times):.2f} (all {', '.join(f'{x:.2f}' for x in times)}); peak memory above the "
              f"models {peak:.1f} MiB; launches {launches} (expected stft {DISTILL_STEPS}, nothing else); "
              f"losses {losses}")
        need(launches == {**{k: 0 for k in launches}, "stft": DISTILL_STEPS}
             and all(np.isfinite(losses)), f"distill steps: launches {launches}, losses {losses}")
        prof = profile_train_step(lambda: distill_step(state, wave, feats), card,
                                  f"one distill step at {DISTILL_N} x {DISTILL_LEN}")
        report["step"] = {"ms_median": statistics.median(times), "ms_min": min(times),
                          "ms_max": max(times), "peak_mib": peak, "launches": launches,
                          "profile": prof}

        # 3. card against CPU at 2 x 65 536
        res = {}
        for where in ("card", "cpu"):
            dev = DEV if where == "card" else "cpu"
            st = init_distill(copy.deepcopy(distill_student()).to(dev))
            g, loss = distill_grads(st, wave[:2].to(dev), feats[:2].to(dev))
            names = [k for k, _ in st.model.named_parameters()]
            res[where] = (float(loss), group_norms(names, g, ("input_layer", "mid_layers", "output_layer")))
        loss_err = abs(res["card"][0] - res["cpu"][0]) / abs(res["cpu"][0])
        norm_err = max(abs(res["card"][1][k] - v) / max(v, 1e-30) for k, v in res["cpu"][1].items())
        print(f"distill card vs CPU [{card}]: one step at 2 x {DISTILL_LEN}, full width, TF32 off: loss "
              f"rel err {loss_err:.3e} (<= 1e-4), per-module gradient norms max rel err {norm_err:.3e} "
              f"(<= 1e-3); card {res['card']}; CPU {res['cpu']}")
        need(loss_err <= 1e-4 and norm_err <= 1e-3, f"distill card vs CPU: {loss_err}, {norm_err}")
        report["card_vs_cpu"] = {"loss_rel_err": loss_err, "grad_norm_rel_err": norm_err}
        del state

        # 4. the CLIs and 5. export, while 6. the dp ranks start
        dp_tmp = os.path.join(tmp, "dp")
        os.makedirs(dp_tmp)
        procs, t_ranks = start_distill_ranks(dp_tmp)
        try:
            cli_launches, ce_path, report["cli"] = run_distill_clis(card, teacher, wavlm_path, tmp)
            for k in total:
                total[k] += cli_launches[k]
            del teacher
            torch.cuda.empty_cache()
            report["export"] = run_export(card, ce_path, tmp)
        except BaseException:
            for p in procs:
                p.kill()
                p.join(30)
            raise
        report["dp"] = finish_distill_dp(card, procs, t_ranks, dp_tmp)
    stft_row = check_stft(torch.Generator(device="cuda").manual_seed(SEED + 9), DISTILL_N, DISTILL_LEN,
                          " (distill)")
    elapsed = time.perf_counter() - t_phase
    report["phase_s"] = elapsed
    print(f"distill: phase 9 took {elapsed:.1f} s (<= {PHASE9_LIMIT_S:.0f})")
    need(elapsed <= PHASE9_LIMIT_S, f"phase 9 took {elapsed:.1f} s > {PHASE9_LIMIT_S}")
    return total, stft_row, report


# ---------------------------------------------------------------------------
# phase 10: resume (training states through the JAX package's .ckpt layout,
# compat/jax_train_state.py)
# ---------------------------------------------------------------------------

RESUME_STEPS = {"gan": 3, "fine_tune": 2, "f0": 2, "distill": 2}   # run A's; run B writes after all but one
# B (resumed) vs A (uninterrupted): the worst tensor over the parameters and both moments,
# relative to its largest entry, a gate a trainer; the control (moments zeroed) must read
# above it.  Set from two runs on an H100 (700 W): A' (A repeated) read 3.19e-3 and 2.18e-3 on
# the GAN, 4.70e-3 on fine-tuning (an AdamW step moves a parameter by about lr * sign(g), so a
# gradient entry whose sign the card's nondeterministic sums flip moves it by 2 lr), B
# 3.00e-3, 2.18e-3 and 3.08e-3, the controls 1.54 and 3.78; the F0 trainer and distillation
# read 0.0 for both (their sums were deterministic; RAdam's first steps are linear in the
# gradient, so a reordered float32 sum would move them by ~1e-7), the controls 0.66 and 0.50
RESUME_TOL = {"gan": 3e-2, "fine_tune": 5e-2, "f0": 1e-5, "distill": 1e-5}
# the deterministic sub-run (GAN and fine-tuning under torch.use_deterministic_algorithms): with
# no op warned, A' vs A and B vs A within this (0.0 expected: the same sums in the same order)
DETERMINISTIC_TRAINERS = ("gan", "fine_tune")
DETERMINISTIC_TOL = 1e-6
DETERMINISTIC_FLAG = "--deterministic-resume"
DETERMINISTIC_TIMEOUT_S = 300
# 60 s before the deterministic sub-run; it takes ~30 s in a process of its own (30.5 s in its
# first run on an H100 at 700 W, the phase 57.9 s), so the limit is raised by 30 s
PHASE10_LIMIT_S = 90.0
RESUME_KERNELS = ("filter_level", "filter_narrow", "filter_wide", "oscillator", "stft",
                  "knn_carried")   # fine-tuning's library


def state_tensors(state) -> dict:
    """{name: tensor}: every parameter of a port trainer's state and both of
    its Adam moments (names ending ':exp_avg', ':exp_avg_sq')."""
    from alivevc_tpu_torch.train.state import TRAINERS, trainer_of

    out = {}
    for slot in TRAINERS[trainer_of(state)].slots:
        module, opt = getattr(state, slot.module), getattr(state, slot.opt)
        if module is None:
            continue
        for name, p in module.named_parameters():
            out[f"{slot.kind}.{name}"] = p.detach()
            for key in ("exp_avg", "exp_avg_sq"):
                out[f"{slot.kind}.{name}:{key}"] = opt.state[p][key]
    return out


def worst_apart(got: dict, want: dict) -> dict:
    """The largest max |got - want| / max |want| over same-named tensors
    (computed on the card, read back once) and its tensor."""
    import torch

    names = list(want)
    need(set(got) == set(want), f"tensor names differ: {sorted(set(got) ^ set(want))[:4]}")
    errs = torch.stack([(got[k] - want[k]).abs().max() / want[k].abs().max().clamp_min(1e-30)
                        for k in names]).cpu().tolist()
    i = max(range(len(names)), key=errs.__getitem__)
    return {"rel_err": errs[i], "tensor": names[i]}


def resume_readings(trainer, label, fresh, step, path, card, control=True, **init_kw) -> dict:
    """Run A: ``RESUME_STEPS[trainer]`` steps from ``fresh()``; A': the same
    again (the card's repeat spread); B: all but the last, ``write`` to
    ``path``, fresh modules and optimizers from ``read``, the last; with
    ``control``, the control: B's file read with the moments zeroed, the
    last step, and the gate (B within RESUME_TOL, the control above it).
    Each against A."""
    import os

    import torch
    from alivevc_tpu_torch.compat import jax_train_state as jts

    n = RESUME_STEPS[trainer]

    def run(state, lo):
        for i in range(lo, n):
            step(state, i)
        torch.cuda.synchronize()
        return state

    a = state_tensors(run(fresh(), 0))
    r = {"repeat": worst_apart(state_tensors(run(fresh(), 0)), a)}
    state = fresh()
    for i in range(n - 1):
        step(state, i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    jts.write(path, state)
    r["write_s"] = time.perf_counter() - t0
    del state
    t0 = time.perf_counter()
    state = jts.read(path, trainer, DEV, **init_kw)
    torch.cuda.synchronize()
    r["read_s"] = time.perf_counter() - t0
    need(state.step == n - 1, f"{label}: read step {state.step}, expected {n - 1}")
    r["resumed"] = worst_apart(state_tensors(run(state, n - 1)), a)
    del state
    shown = ""
    if control:
        state = jts.read(path, trainer, DEV, **init_kw)
        for name, v in state_tensors(state).items():
            if ":" in name:
                v.zero_()
        r["control"] = worst_apart(state_tensors(run(state, n - 1)), a)
        shown = (f", control (B with the moments zeroed) vs A {r['control']['rel_err']:.3e} "
                 f"({r['control']['tensor']}); gate {RESUME_TOL[trainer]:.0e}")
    r["file_mb"] = os.path.getsize(path) / 1e6
    print(f"resume {label} [{card}]: {n} steps (A, A') against {n - 1}, the .ckpt, 1 (B): "
          f"worst tensor over the parameters and both moments, max |diff| / max |A|: B vs A "
          f"{r['resumed']['rel_err']:.3e} ({r['resumed']['tensor']}), A' vs A "
          f"{r['repeat']['rel_err']:.3e} ({r['repeat']['tensor']}){shown}; file "
          f"{r['file_mb']:.1f} MB, write {r['write_s']:.2f} s, read {r['read_s']:.2f} s")
    if control:
        need(r["resumed"]["rel_err"] <= RESUME_TOL[trainer] < r["control"]["rel_err"],
             f"{label}: resumed {r['resumed']}, control {r['control']} against the gate "
             f"{RESUME_TOL[trainer]}")
    return r


def check_gan_file(path, fresh, card) -> dict:
    """The GAN file's key set and shapes against the layout ``write`` forms
    for a freshly built state; the file read and written again, bit-equal."""
    import os

    import numpy as np
    from alivevc_tpu_torch.compat import jax_train_state as jts
    from alivevc_tpu_torch.io.checkpoint import flatten

    want = {k: v.shape for k, v in flatten(jts.jax_tree(fresh())).items()}
    again = path + ".again.ckpt"
    t0 = time.perf_counter()
    jts.write(again, jts.read(path, "gan", DEV))
    round_s = time.perf_counter() - t0
    with np.load(path) as f, np.load(again) as g:
        got = {k: f[k].shape for k in f.files}
        same = set(f.files) == set(g.files) and all(
            f[k].dtype == g[k].dtype and np.array_equal(f[k], g[k]) for k in f.files)
    os.unlink(again)
    print(f"resume GAN file [{card}]: {len(got)} keys, the key set and shapes of a fresh state's "
          f"layout: {got == want}; read and written again bit-equal: {same} ({round_s:.2f} s)")
    need(got == want, f"GAN file layout: {sorted(set(got) ^ set(want))[:4]} or shapes differ")
    need(same, "the GAN file read and written again is not bit-equal")
    return {"keys": len(got), "read_write_s": round_s}


def resume_runs():
    """Phase 10's runs: (trainer, label, a fresh state's maker, one step)
    for the GAN, fine-tuning with a 512-token library, the F0 trainer and
    distillation, with their models, batches and draws from the seed."""
    import copy

    import numpy as np
    import torch
    from alivevc_tpu_torch.config import VoiceLibraryConfig
    from alivevc_tpu_torch.models.voice_library import VoiceLibrary
    from alivevc_tpu_torch.train.distill import distill_step, init_distill
    from alivevc_tpu_torch.train.f0 import f0_amp_draws, f0_train_step, init_f0_train
    from alivevc_tpu_torch.train.fine_tune import amp_draws, fine_tune_step, init_fine_tune
    from alivevc_tpu_torch.train.gan import gan_draws, gan_train_step, init_gan

    ce, f0m, dec, disc = train_models()
    vl = VoiceLibrary(VoiceLibraryConfig(dim=ce.cfg.output_channels),
                      generator=torch.Generator().manual_seed(SEED + 60)).to(DEV)
    wave, _ = train_batch(TRAIN_N, TRAIN_LEN, SEED + 61)
    f0_wave, base = train_batch(F0_TRAIN_N, F0_TRAIN_LEN, SEED + 62)
    labels = torch.from_numpy(np.repeat(base[:, None], F0_TRAIN_LEN // 320, 1).astype(np.float32)).to(DEV)
    d_wave, _ = train_batch(DISTILL_N, DISTILL_LEN, SEED + 63)
    target = distill_target(DISTILL_N, SEED + 64)
    draw_gen = torch.Generator().manual_seed(SEED + 65)
    gan_d = [gan_draws(TRAIN_N, draw_gen, DEV) for _ in range(RESUME_STEPS["gan"])]
    ft_d = [amp_draws(TRAIN_N, draw_gen, DEV) for _ in range(RESUME_STEPS["fine_tune"])]
    f0_d = [f0_amp_draws(F0_TRAIN_N, draw_gen, DEV) for _ in range(RESUME_STEPS["f0"])]
    student = distill_student()
    return (
        ("gan", f"GAN ({TRAIN_N} x {TRAIN_LEN})",
         lambda: init_gan(copy.deepcopy(dec), copy.deepcopy(disc)),
         lambda st, i: gan_train_step(st, ce, f0m, wave, *gan_d[i])),
        ("fine_tune", f"fine-tune with a 512-token library ({TRAIN_N} x {TRAIN_LEN})",
         lambda: init_fine_tune(copy.deepcopy(dec), copy.deepcopy(disc), copy.deepcopy(vl)),
         lambda st, i: fine_tune_step(st, ce, f0m, wave, ft_d[i])),
        ("f0", f"F0 trainer, RAdam ({F0_TRAIN_N} x {F0_TRAIN_LEN})",
         lambda: init_f0_train(copy.deepcopy(f0m)),
         lambda st, i: f0_train_step(st, f0_wave, labels, f0_d[i])),
        ("distill", f"distillation, RAdam ({DISTILL_N} x {DISTILL_LEN})",
         lambda: init_distill(copy.deepcopy(student)),
         lambda st, i: distill_step(st, d_wave, target)),
    )


def deterministic_resume(out_path: str) -> None:
    """Phase 10's deterministic sub-run, in a process of its own
    (``chip_smoke.py --deterministic-resume OUT``; the parent sets
    CUBLAS_WORKSPACE_CONFIG, which cuBLAS reads when it starts): the GAN and
    fine-tuning runs A, A' and B of ``resume_readings`` under
    ``torch.use_deterministic_algorithms(True, warn_only=True)`` with cuDNN's
    autotuner off.  Writes the readings, every op that warned and the
    launches to ``out_path`` as JSON."""
    import tempfile
    import warnings

    import torch
    from alivevc_tpu_torch.kernels import LAUNCHES, reset_launches

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    card = card_line()
    runs = {r[0]: r for r in resume_runs()}
    report = {}
    reset_launches()
    with warnings.catch_warnings(record=True) as caught, tempfile.TemporaryDirectory() as tmp:
        warnings.simplefilter("always")
        for trainer in DETERMINISTIC_TRAINERS:
            _, label, fresh, step = runs[trainer]
            t0 = time.perf_counter()
            report[trainer] = resume_readings(trainer, f"{label}, deterministic", fresh, step,
                                              f"{tmp}/{trainer}.ckpt", card, control=False)
            report[trainer]["s"] = time.perf_counter() - t0
            torch.cuda.empty_cache()
    alert = " does not have a deterministic implementation"
    report["warned"] = sorted({str(w.message).split(alert)[0] for w in caught if alert in str(w.message)})
    report["launches"] = dict(LAUNCHES)
    with open(out_path, "w") as f:
        json.dump(report, f)


def run_deterministic_resume(card) -> dict:
    """Phase 10's deterministic sub-run (``deterministic_resume``) as a child
    process, so that CUBLAS_WORKSPACE_CONFIG and the deterministic mode
    touch no other phase.  With no op warned, A' and B must equal A to
    DETERMINISTIC_TOL; where ops warned, they are printed and B keeps its
    RESUME_TOL gate."""
    import os
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "deterministic.json")
        sys.stdout.flush()
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), DETERMINISTIC_FLAG, out],
                              env={**os.environ, "CUBLAS_WORKSPACE_CONFIG": ":4096:8"},
                              timeout=DETERMINISTIC_TIMEOUT_S)
        r = {"s": time.perf_counter() - t0}
        need(proc.returncode == 0 and os.path.exists(out),
             f"phase 10's deterministic sub-run exited {proc.returncode}")
        with open(out) as f:
            r.update(json.load(f))
    print(f"resume deterministic [{card}]: {r['s']:.1f} s (a process of its own); ops that warned "
          f"under torch.use_deterministic_algorithms(True, warn_only=True): "
          f"{r['warned'] or 'none'}; launches {r['launches']}")
    for trainer in DETERMINISTIC_TRAINERS:
        repeat, resumed = r[trainer]["repeat"]["rel_err"], r[trainer]["resumed"]["rel_err"]
        if r["warned"]:
            need(resumed <= RESUME_TOL[trainer],
                 f"deterministic {trainer}: B vs A {resumed} > {RESUME_TOL[trainer]}")
        else:
            need(max(repeat, resumed) <= DETERMINISTIC_TOL,
                 f"deterministic {trainer}: A' vs A {repeat}, B vs A {resumed} > {DETERMINISTIC_TOL}")
    return r


def run_resume(card):
    """Phase 10: the four trainers' runs resumed through the JAX package's
    ``.ckpt`` layout at full width, float32 without TF32, then the
    deterministic sub-run; counters zeroed before the runs and read after.
    Returns (launches, the report)."""
    import tempfile

    import torch
    from alivevc_tpu_torch.kernels import LAUNCHES, reset_launches

    t_phase = time.perf_counter()
    report = {}
    runs = resume_runs()
    total = {k: 0 for k in LAUNCHES}
    with tempfile.TemporaryDirectory() as tmp:
        for trainer, label, fresh, step in runs:
            reset_launches()
            t0 = time.perf_counter()
            r = resume_readings(trainer, label, fresh, step, f"{tmp}/{trainer}.ckpt", card)
            r["launches"] = dict(LAUNCHES)
            r["s"] = time.perf_counter() - t0
            for k in total:
                total[k] += LAUNCHES[k]
            if trainer == "gan":
                r["file"] = check_gan_file(f"{tmp}/gan.ckpt", fresh, card)
            print(f"resume {label}: {r['s']:.1f} s, launches {r['launches']} [{card}]")
            report[trainer] = r
            torch.cuda.empty_cache()
    del runs
    torch.cuda.empty_cache()
    report["deterministic"] = run_deterministic_resume(card)
    for k in total:
        total[k] += report["deterministic"]["launches"][k]
    print(f"resume launches: {total}")
    need(all(total[k] > 0 for k in RESUME_KERNELS), f"phase 10: a kernel was not launched: {total}")
    elapsed = time.perf_counter() - t_phase
    report["phase_s"] = elapsed
    print(f"resume: phase 10 took {elapsed:.1f} s (<= {PHASE10_LIMIT_S:.0f})")
    need(elapsed <= PHASE10_LIMIT_S, f"phase 10 took {elapsed:.1f} s > {PHASE10_LIMIT_S}")
    return total, report


# ---------------------------------------------------------------------------
# phase 11: the CLIs' default chain (the JAX package's .ckpt names) at full width
# ---------------------------------------------------------------------------

PHASE11_LIMIT_S = 60.0
CHAIN_KERNELS = ("stft", "filter_level", "filter_narrow", "filter_wide", "oscillator",
                 "knn_carried")   # small libraries


def state_digest(sd) -> str:
    """sha256 over a state dict's names and float32 bytes, in key order
    (tensors on any device, or numpy arrays)."""
    import hashlib

    import numpy as np
    import torch

    h = hashlib.sha256()
    for k in sorted(sd):
        v = sd[k].detach().cpu().numpy() if isinstance(sd[k], torch.Tensor) else sd[k]
        h.update(k.encode())
        h.update(np.ascontiguousarray(v, np.float32).tobytes())
    return h.hexdigest()


@contextlib.contextmanager
def models_built(module):
    """Record (kind, path, ``state_digest``) of every model that a CLI module
    builds through ``load_params_or_init`` in the block."""
    from alivevc_tpu_torch.compat.torch_import import load_params_or_init

    built = []

    def record(path, kind, device):
        m = load_params_or_init(path, kind, device)
        built.append((kind, path, state_digest(m.state_dict())))
        return m

    module.load_params_or_init = record
    try:
        yield built
    finally:
        module.load_params_or_init = load_params_or_init


def run_cli_chain(card):
    """Phase 11: the six CLIs one after another on their default file names
    (the JAX package's ``.ckpt``) in a temporary working directory, at full
    width: ``train_content_encoder --wavlm-checkpoint`` (phase 9's seed-drawn
    teacher saved as a local ``.pt``; 2 steps at 1 x 65 536),
    ``train_f0_estimator`` (2 steps at 1 x 65 536), ``generate_voice_library``,
    ``train_decoder`` (2 steps at 1 x 38 400), ``fine_tune -dep gan_state.ckpt
    -disp gan_state.ckpt --max-step 2`` (the one gap the JAX defaults leave)
    and ``inference`` on one 10 s file.  Every model a stage builds from a
    file must be the file an earlier stage wrote (state-dict sha256), and no
    stage may build a seed-0 model where a file should be; counters zeroed
    before each stage and read after.  Returns (launches, the report)."""
    import os
    import tempfile

    import numpy as np
    import torch
    from alivevc_tpu_torch.cli import (fine_tune, generate_voice_library, inference,
                                       train_content_encoder, train_decoder, train_f0_estimator)
    from alivevc_tpu_torch.compat.torch_import import reference_state
    from alivevc_tpu_torch.io.audio import read_wav, write_wav
    from alivevc_tpu_torch.kernels import LAUNCHES, reset_launches
    from alivevc_tpu_torch.models.wavlm import WavLMConfig, seeded_state

    t_phase = time.perf_counter()
    total = {k: 0 for k in LAUNCHES}
    report = {}
    here = os.getcwd()
    ce = ("content_encoder", "content_encoder.ckpt")
    f0 = ("f0_estimator", "f0_estimator.ckpt")
    stages = (
        ("train_content_encoder", train_content_encoder,
         ["data", "--wavlm-checkpoint", "wavlm.pt", "-e", "1", "-b", "1"], ()),
        ("train_f0_estimator", train_f0_estimator, ["data", "-e", "1", "-b", "1"], ()),
        ("generate_voice_library", generate_voice_library, ["data"], (ce,)),
        ("train_decoder", train_decoder, ["data", "-e", "1", "-b", "1"], (ce, f0)),
        ("fine_tune", fine_tune, ["data", "-dep", "gan_state.ckpt", "-disp", "gan_state.ckpt", "-e",
                                  "1", "-b", "1", "--max-step", "2"],
         (ce, f0, ("decoder", "gan_state.ckpt"), ("discriminator", "gan_state.ckpt"),
          ("voice_library", "voice_library.ckpt"))),
        ("inference", inference, ["-t", "data/0.wav"], (ce, f0, ("decoder", "decoder.ckpt"))),
    )
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            rng = np.random.default_rng(SEED + 70)
            os.makedirs("data")
            os.makedirs("inputs")
            for i in range(2):
                write_wav(f"data/{i}.wav", request_wave(4.5, rng), 16_000)
            write_wav("inputs/voice.wav", request_wave(10.0, rng), 16_000)
            t0 = time.perf_counter()
            torch.save({k: torch.from_numpy(v) for k, v in seeded_state(WavLMConfig(), SEED).items()},
                       "wavlm.pt")
            report["teacher_file_s"] = time.perf_counter() - t0
            for name, cli, argv, reads in stages:
                want = {(kind, path): state_digest(reference_state(path, kind)) for kind, path in reads}
                reset_launches()
                t0 = time.perf_counter()
                with models_built(cli) as built:
                    result = cli.main(argv + ["--device", DEV])
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                got = dict(LAUNCHES)
                for k in total:
                    total[k] += got[k]
                seen = {(kind, path): digest for kind, path, digest in built}
                need(len(built) == len(seen) and seen == want,
                     f"phase 11 {name}: built {sorted(seen)}, each from the file an earlier stage "
                     f"wrote: {[k for k in seen if seen[k] == want.get(k)]}; expected {sorted(want)}")
                if name == "inference":
                    written, _ = read_wav("outputs/0_voice.wav")
                    need(result[0].shape == (160_000,) and written.shape == (1, 160_000)
                         and bool(np.isfinite(result[0]).all()),
                         f"inference: output {result[0].shape}, file {written.shape}")
                elif name != "generate_voice_library":
                    need(result.step == 2, f"phase 11 {name}: {result.step} steps, expected 2")
                reads_shown = ", ".join(f"{k} <- {p}" for k, p in reads) or "none (the first run)"
                print(f"chain {name} [{card}]: {dt:.2f} s wall (files, model builds, data, steps), "
                      f"launches {got}; models from files, each state-dict sha256 equal to the "
                      f"file's: {reads_shown}")
                report[name] = {"s": dt, "launches": got, "models_from_files": len(want)}
            report["files_mb"] = {f: os.path.getsize(f) / 1e6 for f in sorted(os.listdir(".")) if
                                  f.endswith(".ckpt")}
        finally:
            os.chdir(here)
    print(f"chain files [{card}]: {', '.join(f'{k} {v:.1f} MB' for k, v in report['files_mb'].items())}")
    print(f"chain launches: {total}")
    need(all(total[k] > 0 for k in CHAIN_KERNELS), f"phase 11: a kernel was not launched: {total}")
    elapsed = time.perf_counter() - t_phase
    report["phase_s"] = elapsed
    print(f"chain: phase 11 took {elapsed:.1f} s (<= {PHASE11_LIMIT_S:.0f})")
    need(elapsed <= PHASE11_LIMIT_S, f"phase 11 took {elapsed:.1f} s > {PHASE11_LIMIT_S}")
    return total, report


# ---------------------------------------------------------------------------


REPLACES = {
    "stft": ("alivevc_tpu_torch/csrc/stft.cu", "alivevc_tpu/kernels/stft_pallas.py:77"),
    "knn": ("alivevc_tpu_torch/csrc/knn.cu",
            "alivevc_tpu/kernels/knn_twopass.py:331 (+ :344, :395)"),
    "knn_carried": ("alivevc_tpu_torch/csrc/knn_carried.cu",
                    "alivevc_tpu/kernels/knn_pallas.py:331 (_knn_kernel; + knn_twopass.py:195 "
                    "_merge_exact at its shapes)"),
    "knn_merge": ("alivevc_tpu_torch/csrc/knn.cu (knn_merge_kernel)",
                  "alivevc_tpu/kernels/knn_twopass.py:372 (_merge_packed_kernel; + :195 _merge_exact)"),
    "knn_prep": ("alivevc_tpu_torch/csrc/knn.cu (knn_prep_kernel)",
                 "alivevc_tpu/kernels/knn_twopass.py:331 (+ :344, :395): its operands' normalisation and "
                 "cast (:230-257), ahead of the tile kernel"),
    "oscillator": ("alivevc_tpu_torch/csrc/oscillator.cu",
                   "alivevc_tpu/kernels/oscillator_pallas.py:229"),
    "filter_level": ("alivevc_tpu_torch/csrc/filter.cu", "alivevc_tpu/kernels/filter_pallas.py:771"),
    "filter_narrow": ("alivevc_tpu_torch/csrc/filter.cu (filter_narrow_weights_kernel + filter_narrow_kernel)",
                      "alivevc_tpu/kernels/filter_pallas.py:771 (fused_filter_block_up at C = 16, 8)"),
    "filter_wide": ("alivevc_tpu_torch/csrc/filter.cu (filter_wide_weights_kernel + filter_wide_kernel)",
                    "alivevc_tpu/kernels/filter_pallas.py:771 (fused_filter_block_up at C = 256, 64)"),
    "knn_packed": ("alivevc_tpu_torch/csrc/knn.cu",
                   "alivevc_tpu/kernels/knn_pallas.py:331 (_knn_kernel_fast, _pack_topk)"),
    "knn_carried_packed": ("alivevc_tpu_torch/csrc/knn_carried.cu",
                           "alivevc_tpu/kernels/knn_pallas.py:331 (_knn_kernel_fast, _pack_topk)"),
    "oscillator_formants": ("alivevc_tpu_torch/csrc/oscillator.cu",
                            "alivevc_tpu/kernels/oscillator_pallas.py:281"),
    "oscillator_stream": ("alivevc_tpu_torch/csrc/oscillator.cu (osc_stream_chain_kernel + osc_stream_kernel)",
                          "none: the JAX package's streaming source is plain jnp.cumsum "
                          "(alivevc_tpu/models/decoder.py:139)"),
    "hifigan_conv": ("alivevc_tpu_torch/csrc/hifigan.cu (hifigan_conv_kernel)",
                     "none: cuDNN's float32 convs of the kNN-VC vocoder's ResBlocks (the JAX package has no "
                     "kNN-VC); launched by phase 2's kNN-VC convert, 72 a call, and by no phase below"),
}


FILTER_ENTRIES = ("filter_level", "filter_narrow", "filter_wide")


def narrow_level(row) -> bool:
    """Whether a filter_level row is a narrow level (C = 16 or 8)."""
    return " C=16 " in row["variant"] or " C=8 " in row["variant"]


def kernels_line(rows, launches):
    """One entry per kernel.  The numbers are those of the kernel's variant
    on the bf16 main path (kNN 'default' at the 100 352-row library; the
    filter's four up levels in bf16, summed: one step runs all four, and as
    'filter_narrow' (levels 2-3) and 'filter_wide' (levels 0-1); the
    packed kNN at the 100 352-row library; the carried kNN form at the
    streaming hop, 'high', and its packed kernel at 512 rows); every measured variant, the
    streaming hop's and the training Functions' included, is listed under 'variants'.  Launches
    are summed over the paths driven (phase 2's kNN-VC and RVC converts, phases 3, 4 with both ranks, 5, 6,
    7 with both ranks, 8, 9, 10 with its deterministic sub-run, 11)."""
    out = []
    for name, (source, replaces) in REPLACES.items():
        mine = [r for r in rows if r["name"] == name]
        if name in ("knn", "knn_merge", "knn_prep"):
            main = [r for r in mine if r["variant"].endswith(f"{LIB_ROWS} x 768 default")]
        elif name == "knn_packed":
            main = [r for r in mine if f" {LIB_ROWS} x 768" in r["variant"]]
        elif name == "knn_carried":       # the streaming hop's call, phase 6's target matrix
            main = [r for r in mine if r["variant"].endswith("high (hop)")]
        elif name == "knn_carried_packed":
            main = [r for r in mine if r["variant"].startswith(f"{N_STEP * LF} x 512 x 768")]
        elif name == "hifigan_conv":        # the kNN-VC vocoder's four stages, not the RVC stage's row
            main = [r for r in mine if r["variant"].endswith("(kNN-VC vocoder)")]
        elif name == "oscillator_stream":   # the streaming hop's call, its only caller
            main = mine
        elif name in FILTER_ENTRIES:   # the bf16 main path's levels: all four, the narrow or the wide
            mine = [r for r in rows if r["name"] == "filter_level"
                    and (name == "filter_level" or narrow_level(r) == (name == "filter_narrow"))]
            main = [r for r in mine if r["variant"].endswith("bf16")]
        else:     # the STFT and the oscillators: the offline row, not the hop's, training's or distillation's
            main = [r for r in mine if not r["variant"].endswith(("(hop)", "(train)", "(distill)"))]
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
            **({"products_library_ms": sum(r["products_library_ms"] for r in main),
                "form_bytes_floor_ms": sum(r["form_bytes_floor_ms"] for r in main)}
               if name in FILTER_ENTRIES else {}),
            **({"kernel_ms": main[0]["kernel_ms"]} if "kernel_ms" in main[0] else {}),
            "variants": [{k: v for k, v in r.items() if k != "name"} for r in mine],
        }
        out.append(entry)
    return {"kernels": out}


def print_rows(rows, card) -> None:
    for r in rows:
        lib_ms = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.3f}"
        prod = f" products_library {r['products_library_ms']:.3f}" if "products_library_ms" in r else ""
        if "form_bytes_floor_ms" in r:
            prod += f" form_bytes_floor {r['form_bytes_floor_ms']:.4f}"
        if "kernel_ms" in r:
            kms = "not measured" if r["kernel_ms"] is None else f"{r['kernel_ms']:.4f}"
            prod += f" kernels alone {kms}"
            if "tiles" in r:
                prod += (f" ({r['tiles']} tiles on {r['resident_blocks']} resident blocks, "
                         f"{r['waves']:.2f} waves)")
        if "library_norm_ms" in r:
            prod += f" library+normalise {r['library_norm_ms']:.4f}"
        if "grid" in r:
            prod += f" grid {r['grid']}"
        print(f"kernel {r['name']:19s} {r['variant']:52s} err {r['max_abs_err']:.3e} "
              f"(tol {r['tol']:.1e}) ms {r['ms']:.4f} plain {r['plain_ms']:.3f} "
              f"library {lib_ms}{prod} bound {r['bound_ms']:.4f} ({r['bound_by']}) [{card}]")


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
    if sys.argv[1:2] == [DETERMINISTIC_FLAG]:
        deterministic_resume(sys.argv[2])
        return 0
    from alivevc_tpu_torch.config import ContentEncoderConfig, DecoderConfig, F0EstimatorConfig
    from alivevc_tpu_torch.kernels import LAUNCHES, _lib, build_all, reset_launches
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
    libs = [*_lib.SOURCES, _lib.NATIVE_LIB]
    secs = build_all(libs)
    print(f"build: {secs:.1f} s for {', '.join(libs)} (nvcc, and g++ for the native library)")

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
    # the carried form's shapes, each form on the same draw (a generator of
    # their own, so that `gen` and phase 3's library draw as before)
    for ls, lib_rows, precision in ((24, 887, "high"), (24, 887, "default"), (960, 512, "highest"),
                                    (N_STEP * LF, 512, "default"), (N_STEP * LF, 512, "high")):
        for form in ("carried", "twopass"):
            ab_gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
            rows.append(check_knn(ab_gen, lib_rows, precision, ls=ls, form=form,
                                  suffix=" (A/B carried)" if form == "carried" else " (A/B two-pass)"))
    merge_gen = torch.Generator(device="cuda").manual_seed(SEED + 7)   # leaves `gen` as it was
    for precision in ("default", "high"):
        rows.append(check_knn_merge(merge_gen, LIB_ROWS, precision))
    rows.append(check_knn_merge(merge_gen, 887, "high", ls=24, suffix=" (hop)"))
    rows.append(check_knn_merge(merge_gen, shard, "highest", valid_rows=shard - 1))
    for precision in ("default", "high"):
        rows.append(check_knn_prep(merge_gen, LIB_ROWS, precision))
    for lib_rows in (512, LIB_ROWS):
        rows.append(check_knn(gen, lib_rows, "default", extraction="packed"))
    rows.extend(check_knn_wide())
    rows.extend(check_knn_l2())
    rows.extend(check_hifigan_stages())
    rows.extend(check_hifigan_stages(((32, RVC_STAGE_ROWS),), "RVC vocoder", SEED + 26))
    rows.append(check_oscillator(gen))
    rows.append(check_formants(gen))
    rows.extend(check_filter_levels(gen, dec))
    print_rows(rows, card)
    torch.cuda.empty_cache()
    knnvc_launches = run_knnvc_path(card)
    torch.cuda.empty_cache()
    rvc_launches = run_rvc_path(card)
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
    report["bf16_knn_flip_rates_other_draws"] = knn_flip_rates_over_draws(ce, xa)
    reference_check(ce, f0m, dec, lib)
    world_reference_check(ce, f0m, dec, lib)
    print(f"phase 3 done at {time.perf_counter() - t_start:.1f} s; report {json.dumps(report)}")
    del lib, xa

    # phase 4
    sharded_launches, sharded = run_sharded_phase(card)
    print(f"phase 4 done at {time.perf_counter() - t_start:.1f} s; report {json.dumps(sharded)}")

    # phase 5
    api_launches = run_kernel_api(gen, card)
    print(f"phase 5 done at {time.perf_counter() - t_start:.1f} s")

    # phase 6
    torch.cuda.empty_cache()
    rt_launches, rt_rows, realtime = run_realtime(ce, f0m, dec, gen, card)
    print_rows(rt_rows, card)
    rows.extend(rt_rows)
    print(f"phase 6 done at {time.perf_counter() - t_start:.1f} s; report {json.dumps(realtime)}")

    # phase 7
    halo_launches, halo = run_halo_phase(card)
    print(f"phase 7 done at {time.perf_counter() - t_start:.1f} s; report {json.dumps(halo)}")

    # phase 8
    torch.cuda.empty_cache()
    with torch.enable_grad():
        train_launches, train_rows, training = run_training(card)
    rows.extend(train_rows)
    print(f"phase 8 done at {time.perf_counter() - t_start:.1f} s; report {json.dumps(training)}")

    # phase 9
    torch.cuda.empty_cache()
    with torch.enable_grad():
        distill_launches, distill_stft, distill = run_distillation(card)
    print_rows([distill_stft], card)
    rows.append(distill_stft)
    print(f"phase 9 done at {time.perf_counter() - t_start:.1f} s; report {json.dumps(distill)}")

    # phase 10
    torch.cuda.empty_cache()
    with torch.enable_grad():
        resume_launches, resume = run_resume(card)
    print(f"phase 10 done at {time.perf_counter() - t_start:.1f} s; report {json.dumps(resume)}")

    # phase 11
    torch.cuda.empty_cache()
    with torch.enable_grad():
        chain_launches, chain = run_cli_chain(card)
    print(f"phase 11 done at {time.perf_counter() - t_start:.1f} s; report {json.dumps(chain)}")

    total = {k: knnvc_launches[k] + rvc_launches[k] + launches[k] + sharded_launches[k] + api_launches[k] + rt_launches[k]
             + halo_launches[k] + train_launches[k] + distill_launches[k] + resume_launches[k]
             + chain_launches[k] for k in launches}
    print(json.dumps(kernels_line(rows, total)))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
