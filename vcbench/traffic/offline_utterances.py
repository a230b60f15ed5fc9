"""Utterances converted whole, one client in a closed loop, by a kNN-VC
model: each file goes through ``OfflineConverter.convert(wave, sr)`` (a
``KnnVCConverter``) and the next starts when it returns.

The mix's parameters (``traffic/<mix>.json``): ``sample_rate`` (16 kHz, the
model's); ``pool`` files whose lengths are the pool's quantiles (i + 0.5) /
pool of a log-normal law (``median_s``, ``sigma``) clipped to ``min_s`` ..
``max_s`` (the same lengths for every seed; the seed draws their voices
and, each pass over the pool, their order); the voice (``traffic/voice.py``);
``matching_s`` seconds of one target voice cut into utterances of the same
law (seeded), whose features, one utterance at a time, are the matching set
(``build_matching_set``); ``check_requests`` files compared with the
reference (the first of the longest, the others drawn from the first two
passes); ``trace_requests`` files profiled at the start of a traced window.

Warm-up converts every file of the pool once, so every length the window
sees has run.  The window closes at the return of the last file started
before ``seconds`` ran out; ``audio_s_per_s`` is the audio seconds of input
converted over all of it.  The collector runs in the window as it does for
users; the harness's own objects from set-up are frozen out of its view
(``gc.freeze``).
"""

from __future__ import annotations

import gc
import statistics
import time
from types import SimpleNamespace

import numpy as np
import torch

import common
import tracing
import weights as weights_mod
from reference import dsp, knnvc
from reference.numerics import exact_float32
from traffic.offline_files import Order


def _law(p: dict, q: float) -> float:
    s = p["median_s"] * float(np.exp(p["sigma"] * statistics.NormalDist().inv_cdf(q)))
    return min(max(s, p["min_s"]), p["max_s"])


def lengths_s(p: dict) -> list:
    return [_law(p, (j + 0.5) / p["pool"]) for j in range(p["pool"])]


def matching_lengths(p: dict, seed: int) -> list:
    """Samples of each matching-set utterance: lengths drawn from the law
    until ``matching_s`` is covered, the last cut to fit (a remainder under
    ``min_s`` joins the one before)."""
    rng = np.random.default_rng(common.subseed(seed, "matching"))
    sr, left, out = p["sample_rate"], int(round(p["matching_s"] * p["sample_rate"])), []
    while left > 0:
        n = min(left, int(round(_law(p, float(rng.uniform(1e-6, 1 - 1e-6))) * sr)))
        if left - n < int(p["min_s"] * sr):
            n = left
        out.append(n)
        left -= n
    return out


def draw_weights(config: dict, seed: int, device):
    specs = knnvc.param_specs(config["model"])
    return weights_mod.draw(specs, common.generator(seed, "weights", device), device)


def build(spec, seed: int, device):
    """Weights, the matching-set utterances (device float32) and the pool
    (host float32), as both sides get them."""
    from traffic import voice

    p = spec.traffic
    sr = p["sample_rate"]
    params = draw_weights(spec.config, seed, device)
    cuts = matching_lengths(p, seed)
    target = voice.voice(common.generator(seed, "target", device), sum(cuts), sr, p["voice"], device)
    targets = list(target.split(cuts))
    pool = [voice.voice(common.generator(seed, f"file{j}", device), int(round(s * sr)), sr, p["voice"],
                        device).cpu().numpy() for j, s in enumerate(lengths_s(p))]
    return params, targets, pool


def check_sample(p: dict, order: Order, seed: int) -> list:
    """The first request of the longest file, and ``check_requests - 1``
    more drawn from the first two passes."""
    n = p["pool"]
    longest = int(np.argmax(lengths_s(p)))
    first = next(i for i in range(n) if order(i) == longest)
    rng = np.random.default_rng(common.subseed(seed, "check"))
    rest = [int(i) for i in rng.permutation(2 * n) if i != first][:p["check_requests"] - 1]
    return sorted([first] + rest)


def reference_set(pr: knnvc.Precisions, spec, params, targets) -> torch.Tensor:
    with torch.no_grad(), exact_float32():
        return knnvc.matching_set(pr, params, spec.config["model"], targets)


def compare(spec, outs: dict, pool, order: Order, params, mset, device) -> dict:
    """The log-mel L1 (16 kHz) of the compared outputs against the
    reference's conversion of the same files on its own matching set
    (``mel_l1`` over all their frames, ``mel_l1_p<q>`` the q-th percentile
    of the frames' L1), and what keeps that comparison meaningful with
    random weights: each output's RMS about its mean, the level of its
    signal (``out_ac_rms_max``, and the smallest as ``out_ac_rms_min_neg``,
    negated so that a limit is an upper one; a random generator's biases
    add a DC offset, which carries no voice and which a plain RMS would
    count), and the share of samples beyond 0.99 (``clip_share``).  An output missing or of
    another length reads infinite.  All are printed; the numbers the cell's
    limits name are returned."""
    cfg, sr = spec.config["model"], spec.traffic["sample_rate"]
    pr = knnvc.Precisions()
    frames, rms, clipped, samples = [], [], 0, 0
    with torch.no_grad(), exact_float32():
        for i, got in sorted(outs.items()):
            want = knnvc.convert_file(pr, params, cfg, pool[order(i)], sr, mset, device)
            if got is None or got.shape != want.shape:
                frames.append(torch.tensor([float("inf")]))
                rms.append(float("inf"))
                continue
            rms.append(float(np.std(got, dtype=np.float64)))
            clipped += int((np.abs(got) > 0.99).sum())
            samples += got.shape[0]
            pair = torch.from_numpy(np.stack([got, want])).to(device)
            a, b = dsp.log_mel(dsp.resample(pair, sr, cfg["sample_rate"]))
            frames.append((a - b).abs().mean(dim=1).cpu())
    every = torch.cat(frames) if frames else torch.tensor([float("inf")])
    found = {"mel_l1": float(every.mean())}
    for q in (50, 75, 90, 95, 99):
        found[f"mel_l1_p{q}"] = float(torch.quantile(every.double(), q / 100.0))
    found["out_ac_rms_max"] = max(rms) if rms else float("inf")
    found["out_ac_rms_min_neg"] = -min(rms) if rms else float("inf")
    found["clip_share"] = clipped / samples if samples else float("inf")
    print("offline check: " + ", ".join(f"{k} {v!r}" for k, v in found.items()), flush=True)
    return {k: common.check(found[k], lim) for k, lim in spec.checks["limits"].items()}


def control(spec, seed: int, device, seconds: float) -> dict:
    """The reference in the configuration's control precision, its
    matching set too, put in the program's place on the requests a run
    compares (``seconds`` is not needed: a run compares requests of its
    first two passes)."""
    params, targets, pool = build(spec, seed, device)
    order = Order(len(pool), seed)
    pr = knnvc.Precisions(spec.config["control"])
    sr = spec.traffic["sample_rate"]
    ctl_set = reference_set(pr, spec, params, targets)
    with torch.no_grad(), exact_float32():
        outs = {i: knnvc.convert_file(pr, params, spec.config["model"], pool[order(i)], sr, ctl_set, device)
                for i in check_sample(spec.traffic, order, seed)}
    del ctl_set
    return compare(spec, outs, pool, order, params, reference_set(knnvc.Precisions(), spec, params, targets),
                   device)


def run(spec, seed: int, seconds: float, trace: bool, device, t_start: float) -> dict:
    from alivevc_tpu_torch.infer.offline import KnnVCConverter, build_matching_set

    import program_knnvc

    p, cfg = spec.traffic, spec.config
    sr = p["sample_rate"]
    common.stage(t_start, "imports and the card")
    params, targets, pool = build(spec, seed, device)
    common.stage(t_start, f"weights, {len(targets)} matching-set utterances and {len(pool)} files drawn")
    model = program_knnvc.build_model(cfg["model"], params)
    mset = build_matching_set(model, [t.cpu().numpy() for t in targets], device=device)
    conv = KnnVCConverter(model, mset, k=cfg["model"]["knn"]["k"], precision=cfg["precision"]["knn_precision"],
                          device=device)
    order = Order(len(pool), seed)
    sample = set(check_sample(p, order, seed))
    common.stage(t_start, f"matching set of {mset.shape[0]} rows and converter built")
    for w in pool:
        conv.convert(w, sr)
    common.stage(t_start, f"warm-up of the {len(pool)} files")

    tracer = tracing.Session() if trace else None
    traced_samples = []
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
                traced_samples.append(wave.shape[0])
            else:
                out = conv.convert(wave, sr)
            ok = out.shape[0] == wave.shape[0] and bool(np.isfinite(out[::97]).all())
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

    rows = int(mset.shape[0])
    del conv, model, mset
    common.free_program(device)
    checks = compare(spec, outs, pool, order, params, reference_set(knnvc.Precisions(), spec, params, targets),
                     device)
    res = {"end_to_end": {"audio_s_per_s": audio_s / (t_end - t0), "setup_s": setup_s},
           "attempted": attempted, "failed": failed, "checks": checks, "device": dev}
    if tracer is not None:
        res["view"] = utterance_view(spec, tracer.stop(), traced_samples, rows, dev)
    return res


def utterance_view(spec, tr, samples: list, rows: int, dev: dict) -> SimpleNamespace:
    """What the per-layer readers of a kNN-VC cell read: the trace, the
    traced requests' lengths (samples at 16 kHz) and the matching set's
    rows.  ``counters`` is empty, not None: the kind counts nothing, and the
    offline readers of the device's idle share take None for a view of
    another kind."""
    view = SimpleNamespace(spec=spec, trace=tr, breakdown=None, calls=None, counters={}, hops=None,
                           precision=spec.config["precision"], model=spec.config["model"],
                           library_rows=rows, request_samples=samples)
    if tr is None or len(tr) == 0 or "request" not in tr.spans:
        view.trace = None
        return view
    req = tr.spans["request"]
    view.t0, view.t1 = req[0][0], req[-1][1]
    view.window_s = (view.t1 - view.t0) / 1e9
    view.busy_s = tr.busy_s(view.t0, view.t1)
    dev["busy_s"], dev["window_s"] = view.busy_s, view.window_s
    view.breakdown = tracing.breakdown(
        tr, view.t0, view.t1,
        [("WavLM to layer 6 (knnvc.content)", "knnvc.content"), ("retrieval (knnvc.match)", "knnvc.match"),
         ("vocoder (knnvc.vocoder)", "knnvc.vocoder")],
        ["knnvc.content", "knnvc.match", "knnvc.vocoder", "offline.step", "request"])
    return view

