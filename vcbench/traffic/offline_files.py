"""Offline files, one client in a closed loop: each file goes through
``OfflineConverter.convert(wave, sr)`` and the next starts when it returns.

The mix's parameters (``traffic/<mix>.json``): ``sample_rate``; ``pool``
files whose lengths are the pool's quantiles of a log-uniform law between
``min_s`` and ``max_s`` (the same lengths for every seed; the seed draws
their voices and, each pass over the pool, their order); the voice
(``traffic/voice.py``); a target recording of that voice at 16 kHz,
peak-normalised as the offline CLI reads ``--target``, whose encoder frames
(``build_target_matrix``, every frame) are the ``library_rows`` rows of the
target matrix; ``check_requests`` files compared with the reference (the
first of the longest among them, the others drawn from the first two
passes); ``trace_requests`` files profiled at the start of a traced window.

Warm-up converts one file of each batch shape the pool gives the driver (a
file of m windows runs steps of min(m, windows a step) windows).  The
window closes at the return of the last file started before ``seconds`` ran
out; ``audio_s_per_s`` is the audio seconds of input converted over all of
it.  The collector runs in the window as it does for users; the harness's
own objects from set-up are frozen out of its view (``gc.freeze``).
"""

from __future__ import annotations

import contextlib
import gc
import time
from types import SimpleNamespace

import numpy as np
import torch

import common
import tracing
import work
from reference import dsp, paths
from reference.numerics import exact_float32


def lengths_s(p: dict) -> list:
    lo, hi, n = p["min_s"], p["max_s"], p["pool"]
    return [lo * (hi / lo) ** ((j + 0.5) / n) for j in range(n)]


def make_pool(p: dict, seed: int, device) -> list:
    """The pool's files (host float32 arrays), each drawn on the device from
    its own stream of the seed."""
    from traffic import voice

    sr = p["sample_rate"]
    return [voice.voice(common.generator(seed, f"file{j}", device), int(round(s * sr)), sr, p["voice"],
                        device).cpu().numpy() for j, s in enumerate(lengths_s(p))]


def make_target(p: dict, audio: dict, seed: int, device) -> torch.Tensor:
    """The target recording [library_rows x hop] at 16 kHz, peak-normalised;
    its encoder frames are the library's rows."""
    from traffic import voice

    w = voice.voice(common.generator(seed, "target", device), p["library_rows"] * audio["hop_length"],
                    audio["sample_rate"], p["voice"], device)
    return w / w.abs().max()


class Order:
    """Request i's pool index: each pass over the pool in a seeded order."""

    def __init__(self, n: int, seed: int):
        self.n, self.rng, self.seq = n, np.random.default_rng(common.subseed(seed, "order")), []

    def __call__(self, i: int) -> int:
        while len(self.seq) <= i:
            self.seq.extend(self.rng.permutation(self.n).tolist())
        return self.seq[i]


def check_sample(p: dict, order: Order, seed: int) -> list:
    """Requests whose outputs are compared: the first request of the
    longest file, and ``check_requests - 1`` more drawn from the first two
    passes."""
    n = p["pool"]
    longest = int(np.argmax(lengths_s(p)))
    first = next(i for i in range(n) if order(i) == longest)
    rng = np.random.default_rng(common.subseed(seed, "check"))
    rest = [int(i) for i in rng.permutation(2 * n) if i != first][:p["check_requests"] - 1]
    return sorted([first] + rest)


def infer_settings(spec) -> dict:
    s = dict(spec.traffic["infer"])
    s.update(k=spec.config["model"]["knn"]["k"], alpha=spec.config["model"]["knn"]["alpha"])
    return s


def build(spec, seed: int, device):
    """Weights, the target recording and the pool, as both sides get them."""
    p = spec.traffic
    params, specs = common.draw_weights(spec.config, seed, device)
    return params, specs, make_target(p, spec.config["model"]["audio"], seed, device), make_pool(p, seed, device)


def reference_target(pr: paths.Precisions, spec, params, target) -> torch.Tensor:
    """The reference's own target matrix from the target recording."""
    with torch.no_grad(), exact_float32():
        return paths.target_matrix(pr, params, spec.config["model"], target, None, 1)


def compare(spec, outs: dict, pool, order: Order, params, tgt, device) -> dict:
    """The log-mel L1 (the bf16 licence's measure, at 16 kHz) of the
    compared outputs against the reference's conversion of the same files
    (on the reference's target matrix ``tgt``): ``mel_l1`` over all their
    frames, ``mel_l1_worst_window`` over the frames of each window's kept
    chunk, the worst such chunk of any file, and ``mel_l1_p<q>`` the q-th
    percentile of the frames' L1.  An output missing or of another length
    reads infinite.  All are printed; the numbers the cell's limits name
    are returned."""
    cfg, sr = spec.config["model"], spec.traffic["sample_rate"]
    infer, pr = infer_settings(spec), paths.Precisions()
    per_chunk = infer["chunk"] // cfg["audio"]["hop_length"]
    frames, chunks = [], []
    with torch.no_grad(), exact_float32():
        for i, got in sorted(outs.items()):
            want = paths.convert_file(pr, params, cfg, pool[order(i)], sr, tgt, infer, device)
            if got is None or got.shape != want.shape:
                frames.append(torch.tensor([float("inf")]))
                chunks.append(torch.tensor([float("inf")]))
                continue
            pair = torch.from_numpy(np.stack([got, want])).to(device)
            a, b = dsp.log_mel(dsp.resample(pair, sr, cfg["audio"]["sample_rate"]))
            d = (a - b).abs().mean(dim=1).cpu()
            frames.append(d)
            chunks.append(torch.stack([x.mean() for x in d.split(per_chunk)]))
    every = torch.cat(frames) if frames else torch.tensor([float("inf")])
    found = {"mel_l1": float(every.mean()),
             "mel_l1_worst_window": float(torch.cat(chunks).max()) if chunks else float("inf")}
    for q in (50, 75, 90, 95, 99):
        found[f"mel_l1_p{q}"] = float(torch.quantile(every.double(), q / 100.0))
    print("offline check: " + ", ".join(f"{k} {v!r}" for k, v in found.items()), flush=True)
    return {k: common.check(found[k], lim) for k, lim in spec.checks["limits"].items()}


def control(spec, seed: int, device, seconds: float) -> dict:
    """The reference in the configuration's control precision, its target
    matrix too, put in the program's place on the requests a run compares
    (``seconds`` is not needed: a run compares requests of its first two
    passes)."""
    params, _, target, pool = build(spec, seed, device)
    order = Order(len(pool), seed)
    pr = paths.Precisions(spec.config["control"])
    sr = spec.traffic["sample_rate"]
    ctl_tgt = reference_target(pr, spec, params, target)
    with torch.no_grad(), exact_float32():
        outs = {i: paths.convert_file(pr, params, spec.config["model"], pool[order(i)], sr, ctl_tgt,
                                      infer_settings(spec), device)
                for i in check_sample(spec.traffic, order, seed)}
    del ctl_tgt
    return compare(spec, outs, pool, order, params, reference_target(paths.Precisions(), spec, params, target),
                   device)


def _spans(calls: dict, counters: dict):
    """The traced run's wrappers: spans around the step, retrieval, the
    filter levels and the resampler, with the shapes the yardstick needs."""
    from alivevc_tpu_torch.infer import offline
    from alivevc_tpu_torch.models import decoder as dec_mod

    def step_rec(args, kwargs):
        counters["steps"] += 1
        counters["windows_computed"] += int(args[3].shape[0])

    def knn_rec(args, kwargs):
        src, lib = args[0], args[1]
        n, ls, d = src.shape
        calls["retrieval"].append((n * ls, lib.shape[0], d, "bf16" if src.dtype == torch.bfloat16 else "fp32",
                                   kwargs.get("precision", "default")))

    def level_rec(args, kwargs):
        x, up_w, conv_w, film = args[0], kwargs["up_w"], kwargs["conv_w"], kwargs["film"]
        n, l_in, c_in = x.shape
        calls["filter_level"].append((n, l_in, c_in, up_w.shape[1] // kwargs["rate"], kwargs["rate"],
                                      conv_w[0].shape[0], len(conv_w), film.shape[1],
                                      "bf16" if x.dtype == torch.bfloat16 else "fp32"))

    def unet(orig):
        level = tracing.spanned("filter_level", dec_mod.filter_level, level_rec)
        return lambda m, source, c, cfg, level_=None: orig(m, source, c, cfg, level=level)

    stack = contextlib.ExitStack()      # entered here, closed by the session
    stack.enter_context(tracing.patched(offline, "convert_window",
                                        lambda f: tracing.spanned("step", f, step_rec)))
    stack.enter_context(tracing.patched(offline, "match_features_kernel",
                                        lambda f: tracing.spanned("retrieval", f, knn_rec)))
    stack.enter_context(tracing.patched(offline, "resample", lambda f: tracing.spanned("resample", f)))
    stack.enter_context(tracing.patched(dec_mod, "filter_unet", unet))
    return stack


def run(spec, seed: int, seconds: float, trace: bool, device, t_start: float) -> dict:
    from alivevc_tpu_torch.config import InferenceConfig
    from alivevc_tpu_torch.infer.offline import OfflineConverter, build_target_matrix

    import program

    p, cfg = spec.traffic, spec.config
    sr = p["sample_rate"]
    common.stage(t_start, "imports and the card")
    params, _, target, pool = build(spec, seed, device)
    common.stage(t_start, "weights, target recording and files drawn")
    ce, f0m, dec = program.build_models(cfg["model"], params)
    tgt = build_target_matrix(ce, target_wave=target.cpu().numpy(), device=device)
    icfg = InferenceConfig(**infer_settings(spec))
    conv = OfflineConverter(ce, f0m, dec, tgt, icfg, dtype=cfg["precision"]["dtype"],
                            knn_precision=cfg["precision"]["knn_precision"], device=device)
    order = Order(len(pool), seed)
    sample = set(check_sample(p, order, seed))

    common.stage(t_start, f"target matrix of {tgt.shape[0]} rows and converter built")
    # warm-up: one file of each batch shape the pool gives
    per_step = icfg.max_windows_per_step
    shapes = {}
    for j, w in enumerate(pool):
        shapes.setdefault(min(work.windows_cut(work.len16(w.shape[0], sr), icfg.chunk), per_step), j)
    for j in shapes.values():
        conv.convert(pool[j], sr)
    common.stage(t_start, f"warm-up of {len(shapes)} batch shapes")

    calls = {"retrieval": [], "filter_level": []}
    counters = {"steps": 0, "windows_computed": 0, "windows_cut": 0}
    tracer = tracing.Session(_spans(calls, counters)) if trace else None
    setup_s = time.perf_counter() - t_start
    gc.collect()
    gc.freeze()

    outs, attempted, failed, audio_s, errors, took = {}, 0, 0, 0.0, [], []
    usage0 = common.host_usage()
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while time.perf_counter() < deadline:
        i = attempted
        wave = pool[order(i)]
        traced = tracer is not None and tracer.active
        t_req = time.perf_counter()
        try:
            if traced:
                with tracing.span("request"):
                    out = conv.convert(wave, sr)
                counters["windows_cut"] += work.windows_cut(work.len16(wave.shape[0], sr), icfg.chunk)
            else:
                out = conv.convert(wave, sr)
            ok = out.shape[0] >= wave.shape[0] and bool(np.isfinite(out[::97]).all())
        except Exception as exc:          # a request that fails counts as failed, and the run goes on
            out, ok = None, False
            errors.append(repr(exc))
        took.append((time.perf_counter() - t_req) * sr / wave.shape[0])
        attempted += 1
        failed += 0 if ok else 1
        audio_s += wave.shape[0] / sr
        if i in sample:
            outs[i] = out
        if traced and i + 1 == p["trace_requests"]:
            tracer.stop()
    t_end = time.perf_counter()
    usage1 = common.host_usage()
    gc.unfreeze()
    dev = common.device_info(device)
    for e in errors[:3]:
        print(f"request failed: {e}", flush=True)
    q = np.percentile(took, [10, 50, 90]) * 1e3 if took else [float("nan")] * 3
    print(f"offline: {attempted} files in {t_end - t0:.4f} s; ms a second of audio p10 {q[0]:.4f} "
          f"p50 {q[1]:.4f} p90 {q[2]:.4f}; {common.host_line(usage0, usage1)}", flush=True)

    del conv, ce, f0m, dec, tgt
    common.free_program(device)
    checks = compare(spec, outs, pool, order, params, reference_target(paths.Precisions(), spec, params, target),
                     device)
    res = {"end_to_end": {"audio_s_per_s": audio_s / (t_end - t0), "setup_s": setup_s},
           "attempted": attempted, "failed": failed, "checks": checks, "device": dev}
    if tracer is not None:
        res["view"] = offline_view(spec, tracer.stop(), calls, counters, dev)
    return res


def offline_view(spec, tr, calls: dict, counters: dict, dev: dict) -> SimpleNamespace:
    """What the per-layer readers of an offline cell read."""
    view = SimpleNamespace(spec=spec, trace=tr, calls=calls, counters=counters, breakdown=None,
                           precision=spec.config["precision"], model=spec.config["model"],
                           library_rows=spec.traffic["library_rows"], hops=None)
    if tr is None or len(tr) == 0:
        view.trace = None
        return view
    # the traced window on the profiler's clock: from the first request span
    # to the end of the last
    req = tr.spans.get("request", [])
    view.t0, view.t1 = req[0][0], req[-1][1]
    view.window_s = (view.t1 - view.t0) / 1e9
    view.busy_s = tr.busy_s(view.t0, view.t1)
    dev["busy_s"], dev["window_s"] = view.busy_s, view.window_s
    view.breakdown = tracing.breakdown(
        tr, view.t0, view.t1,
        [("retrieval (match_features_kernel: kNN kernels, row sums, mean of k rows)", "retrieval"),
         ("filter levels (filter_level kernels)", "filter_level")],
        ["retrieval", "filter_level", "step", "resample", "request"])
    return view
