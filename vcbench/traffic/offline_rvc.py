"""Sung takes converted whole, one client in a closed loop, by RVC v2: each
take goes through ``OfflineConverter.convert(wave, sr, f0=curve,
generator=...)`` (an ``RvcConverter``) and the next starts when it returns.

The mix's parameters (``traffic/<mix>.json``): ``sample_rate`` and
``channels`` of the takes; ``pool`` takes whose lengths are the pool's
quantiles (i + 0.5) / pool of a log-normal law (``median_s``, ``sigma``)
clipped to ``min_s`` .. ``max_s`` (the same lengths for every seed; the seed
draws their voices, their channel gains and, each pass over the pool, their
order); the sung voice (``voice``: phrases of ``phrase_min_s`` ..
``phrase_max_s`` between rests of ``rest_min_s`` .. ``rest_max_s``, its f0
gliding between anchors every ``glide_s`` s, log-uniform in ``f0_min_hz`` ..
``f0_max_hz``, ``harmonics`` at 1/h under a syllable-rate envelope, white
noise of std ``noise`` throughout); each take's F0 curve is the one its voice
was drawn with, at 100 frames a second, 0 in rests; ``index_s`` seconds of
one target voice at 16 kHz cut into ``piece_s`` s pieces (RVC's training-set
slices), whose HuBERT features, one piece at a time, are the index;
``check_requests`` requests compared with the reference (the first of the
window); ``trace_requests`` requests profiled at the start of a traced
window.

Warm-up converts every take of the pool once, so every length the window
sees has run.  The window closes at the return of the last take started
before ``seconds`` ran out; ``audio_s_per_s`` is the audio seconds of input
converted over all of it.  Each request draws its noise from a generator of
its own, seeded from the run's seed and the request's number, so the
reference draws the same.
"""

from __future__ import annotations

import gc
import math
import statistics
import time
from types import SimpleNamespace

import numpy as np
import torch

import common
import tracing
import weights as weights_mod
from reference import dsp
from reference import rvc as ref
from reference.numerics import exact_float32
from traffic.offline_files import Order

NEAR_TIE = 1e-6      # moving sums this close (relative) make a near-tie of two cut points


def _law(p: dict, q: float) -> float:
    s = p["median_s"] * float(np.exp(p["sigma"] * statistics.NormalDist().inv_cdf(q)))
    return min(max(s, p["min_s"]), p["max_s"])


def lengths_s(p: dict) -> list:
    return [_law(p, (j + 0.5) / p["pool"]) for j in range(p["pool"])]


def len16(samples: int, sr: int) -> int:
    return int(math.ceil(samples * 16_000 / sr))


def sung(gen: torch.Generator, samples: int, sr: int, v: dict, device):
    """A sung voice [samples] float32 on ``device`` and its F0 at the start
    of each 10 ms frame [ceil(samples 16 000 / sr) // 160] float32 (0 in
    rests)."""
    dt = torch.float64
    step = max(1, int(v["glide_s"] * sr))
    anchors = samples // step + 2
    lo, hi = math.log(v["f0_min_hz"]), math.log(v["f0_max_hz"])
    logf = torch.empty(anchors, device=device, dtype=dt).uniform_(lo, hi, generator=gen)
    env_a = torch.empty(anchors, device=device, dtype=dt).uniform_(0.2, 1.0, generator=gen)
    pairs = int(samples / sr / (v["phrase_min_s"] + v["rest_min_s"])) + 2
    phrase = torch.empty(pairs, device=device, dtype=dt).uniform_(v["phrase_min_s"], v["phrase_max_s"], generator=gen)
    rest = torch.empty(pairs, device=device, dtype=dt).uniform_(v["rest_min_s"], v["rest_max_s"], generator=gen)
    edges = torch.cumsum(torch.stack([phrase, rest], dim=1).reshape(-1), 0)   # ends of phrase, rest, phrase, ...

    def at(t_s: torch.Tensor):
        """(f0 Hz, envelope, voiced) at times t_s (float64 seconds)."""
        pos = t_s * sr / step
        i0 = pos.floor().long().clamp(max=anchors - 2)
        frac = pos - i0
        f0 = torch.exp(logf[i0] * (1 - frac) + logf[i0 + 1] * frac)
        env = env_a[i0] * (1 - frac) + env_a[i0 + 1] * frac
        voiced = torch.searchsorted(edges, t_s, right=True) % 2 == 0
        return f0, env, voiced

    f0, env, voiced = at(torch.arange(samples, device=device, dtype=dt) / sr)
    phase = torch.cumsum(f0 / sr, dim=0)
    out = torch.zeros(samples, device=device, dtype=torch.float32)
    for h in range(1, v["harmonics"] + 1):
        hp = phase * h
        out += (torch.sin(2 * math.pi * (hp - hp.floor())) / h).float()
    noise = torch.empty(samples, device=device).normal_(0.0, v["noise"], generator=gen)
    wave = v["level"] * (env * voiced).float() * out + noise
    frames = len16(samples, sr) // 160
    cf0, _, cvoiced = at(torch.arange(frames, device=device, dtype=dt) * 0.01)
    return wave.contiguous(), torch.where(cvoiced, cf0, 0.0).float()


def draw_weights(config: dict, seed: int, device):
    specs = ref.param_specs(config["model"])
    return weights_mod.draw(specs, common.generator(seed, "weights", device), device)


def build(spec, seed: int, device):
    """Weights, the index's pieces (device float32, 16 kHz) and the pool
    (host float32 [channels, L] takes and their F0 curves), as both sides
    get them."""
    p = spec.traffic
    sr, v = p["sample_rate"], p["voice"]
    params = draw_weights(spec.config, seed, device)
    total, piece = int(round(p["index_s"] * 16_000)), int(round(p["piece_s"] * 16_000))
    target, _ = sung(common.generator(seed, "target", device), total, 16_000, v, device)
    pieces = list(target.split(piece))
    pool = []
    for j, s in enumerate(lengths_s(p)):
        gen = common.generator(seed, f"take{j}", device)
        wave, curve = sung(gen, int(round(s * sr)), sr, v, device)
        gains = torch.empty(p["channels"], device=device).uniform_(v["gain_min"], v["gain_max"], generator=gen)
        pool.append(((gains[:, None] * wave[None]).cpu().numpy(), curve.cpu().numpy()))
    return params, pieces, pool


def noise_gen(seed: int, i: int, device) -> torch.Generator:
    return common.generator(seed, f"noise{i}", device)


def reference_index(pr: ref.Precisions, spec, params, pieces) -> torch.Tensor:
    with torch.no_grad(), exact_float32():
        return ref.index_rows(pr, params, spec.config["model"], pieces)


def compare(spec, outs: dict, cuts: dict, pool, order: Order, params, index, seed: int, device,
            pr: ref.Precisions = None) -> dict:
    """The log-mel L1 (RVC's 40 kHz mel: n_fft 2 048, hop 400, 125 bands)
    of the compared outputs against the reference's conversion of the same
    takes (its own index, the same F0 curve and noise; ``pr`` in the
    control), ``mel_l1`` over all their frames, ``mel_l1_p<q>`` the q-th
    percentile of the frames' L1; each output's RMS about its mean
    (``out_ac_rms_max``, and the smallest as ``out_ac_rms_min_neg``,
    negated so that a limit is an upper one) and the share of samples
    beyond 0.99 (``clip_share``).  Where the program cut a take elsewhere
    than the reference, and the moving sums at the two places are within
    ``NEAR_TIE`` of each other, the reference converts it at the program's
    cuts (a near-tie); other cuts stand, and an output of another length
    reads infinite.  All are printed; the numbers the cell's limits name
    are returned."""
    model, sr = spec.config["model"], spec.traffic["sample_rate"]
    d = model["driver"]
    pr = pr or ref.Precisions()
    frames, rms, clipped, samples, ties = [], [], 0, 0, 0
    with torch.no_grad(), exact_float32():
        for i, got in sorted(outs.items()):
            wave, curve = pool[order(i)]
            audio = ref.file_16k(wave, sr, device)
            their = ref.cuts(ref.highpass(audio, d), d)
            mine = cuts.get(i)
            use = their
            if mine is not None and [c // d["window"] for c in mine] != [c // d["window"] for c in their]:
                if ref.near_tie(ref.highpass(audio, d), d, mine, their, NEAR_TIE):
                    use, ties = list(mine), ties + 1
            want = ref.pipeline(pr, params, model, audio, curve, index, noise_gen(seed, i, device), device, use)
            if got is None or got.shape != want.shape:
                frames.append(torch.tensor([float("inf")]))
                rms.append(float("inf"))
                continue
            rms.append(float(np.std(got, dtype=np.float64)))
            clipped += int((np.abs(got) > 0.99).sum())
            samples += got.shape[0]
            pair = torch.from_numpy(np.stack([got, want])).to(device)
            a, b = dsp.log_mel(pair, sr=40_000, n_fft=2048, hop=400, n_mels=125)
            frames.append((a - b).abs().mean(dim=1).cpu())
            del pair, a, b
    every = torch.cat(frames) if frames else torch.tensor([float("inf")])
    found = {"mel_l1": float(every.mean())}
    for q in (50, 75, 90, 95, 99):
        found[f"mel_l1_p{q}"] = float(torch.quantile(every.double(), q / 100.0))
    found["out_ac_rms_max"] = max(rms) if rms else float("inf")
    found["out_ac_rms_min_neg"] = -min(rms) if rms else float("inf")
    found["clip_share"] = clipped / samples if samples else float("inf")
    print(f"offline check ({len(outs)} takes, {ties} near-tie cuts): "
          + ", ".join(f"{k} {v!r}" for k, v in found.items()), flush=True)
    return {k: common.check(found[k], lim) for k, lim in spec.checks["limits"].items()}


def control(spec, seed: int, device, seconds: float) -> dict:
    """The reference in the configuration's control precision, its index
    too, put in the program's place on the requests a run compares
    (``seconds`` is not needed: a run compares the first requests)."""
    params, pieces, pool = build(spec, seed, device)
    order = Order(len(pool), seed)
    pr = ref.Precisions(spec.config["control"])
    ctl_index = reference_index(pr, spec, params, pieces)
    sr, d = spec.traffic["sample_rate"], spec.config["model"]["driver"]
    outs = {}
    with torch.no_grad(), exact_float32():
        for i in range(spec.traffic["check_requests"]):
            wave, curve = pool[order(i)]
            audio = ref.file_16k(wave, sr, device)
            outs[i] = ref.pipeline(pr, params, spec.config["model"], audio, curve, ctl_index,
                                   noise_gen(seed, i, device), device, ref.cuts(ref.highpass(audio, d), d))
    del ctl_index
    return compare(spec, outs, {}, pool, order, params, reference_index(ref.Precisions(), spec, params, pieces),
                   seed, device)


def run(spec, seed: int, seconds: float, trace: bool, device, t_start: float) -> dict:
    from alivevc_tpu_torch.infer.offline import RvcConverter, build_rvc_index

    import program_rvc

    p, cfg = spec.traffic, spec.config
    sr = p["sample_rate"]
    common.stage(t_start, "imports and the card")
    params, pieces, pool = build(spec, seed, device)
    common.stage(t_start, f"weights, {len(pieces)} index pieces and {len(pool)} takes drawn")
    model, dcfg = program_rvc.build_model(cfg["model"], params)
    index = build_rvc_index(model, [w.cpu().numpy() for w in pieces], device=device)
    conv = RvcConverter(model, index, dcfg, device=device)
    order = Order(len(pool), seed)
    common.stage(t_start, f"index of {index.shape[0]} rows and converter built")
    for j, (w, curve) in enumerate(pool):
        conv.convert(w, sr, f0=curve, generator=noise_gen(seed, -1 - j, device))
    common.stage(t_start, f"warm-up of the {len(pool)} takes")

    tracer = tracing.Session() if trace else None
    traced = []
    setup_s = time.perf_counter() - t_start
    gc.collect()
    gc.freeze()

    outs, cuts, attempted, failed, audio_s, errors, took = {}, {}, 0, 0, 0.0, [], []
    usage0 = common.host_usage()
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while time.perf_counter() < deadline:
        i = attempted
        wave, curve = pool[order(i)]
        n16 = len16(wave.shape[-1], sr)
        tracing_now = tracer is not None and tracer.active
        t_req = time.perf_counter()
        try:
            if tracing_now:
                with tracing.span("request"):
                    out = conv.convert(wave, sr, f0=curve, generator=noise_gen(seed, i, device))
                traced.append((n16, list(conv.last_cuts)))
            else:
                out = conv.convert(wave, sr, f0=curve, generator=noise_gen(seed, i, device))
            ok = (out.ndim == 1 and abs(out.shape[0] - 2.5 * n16) <= 1000 * (2 + n16 // 608_000)
                  and bool(np.isfinite(out[::97]).all()))
        except Exception as exc:          # a request that fails counts as failed, and the run goes on
            out, ok = None, False
            errors.append(repr(exc))
        took.append((time.perf_counter() - t_req) * sr / wave.shape[-1])
        attempted += 1
        failed += 0 if ok else 1
        audio_s += wave.shape[-1] / sr
        if i < p["check_requests"]:
            outs[i], cuts[i] = out, list(conv.last_cuts)
        if tracing_now and i + 1 == p["trace_requests"]:
            tracer.stop()
    t_end = time.perf_counter()
    usage1 = common.host_usage()
    gc.unfreeze()
    dev = common.device_info(device)
    for e in errors[:3]:
        print(f"request failed: {e}", flush=True)
    q = np.percentile(took, [10, 50, 90]) * 1e3 if took else [float("nan")] * 3
    print(f"offline: {attempted} takes in {t_end - t0:.4f} s; ms a second of audio p10 {q[0]:.4f} "
          f"p50 {q[1]:.4f} p90 {q[2]:.4f}; {common.host_line(usage0, usage1)}", flush=True)

    rows = int(index.shape[0])
    del conv, model, index
    common.free_program(device)
    checks = compare(spec, outs, cuts, pool, order, params, reference_index(ref.Precisions(), spec, params, pieces),
                     seed, device)
    res = {"end_to_end": {"audio_s_per_s": audio_s / (t_end - t0), "setup_s": setup_s},
           "attempted": attempted, "failed": failed, "checks": checks, "device": dev}
    if tracer is not None:
        res["view"] = take_view(spec, tracer.stop(), traced, rows, dev)
    return res


def take_view(spec, tr, traced: list, rows: int, dev: dict) -> SimpleNamespace:
    """What the per-layer readers of an RVC cell read: the trace, each traced
    request's segments (samples at 16 kHz, ``work_rvc.segments``) and the
    index's rows.  ``counters`` is empty, not None: the kind counts nothing,
    and the offline readers of the device's idle share take None for a view
    of another kind."""
    import work_rvc

    d = spec.config["model"]["driver"]
    view = SimpleNamespace(spec=spec, trace=tr, breakdown=None, calls=None, counters={}, hops=None,
                           precision=spec.config["precision"], model=spec.config["model"], library_rows=rows,
                           request_segments=[work_rvc.segments(n, c, d) for n, c in traced])
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
        [("HuBERT-base, 12 layers (rvc.content)", "rvc.content"), ("retrieval (rvc.match)", "rvc.match"),
         ("prior and flow (rvc.prior)", "rvc.prior"), ("NSF generator (rvc.vocoder)", "rvc.vocoder")],
        ["rvc.content", "rvc.match", "rvc.prior", "rvc.vocoder", "rvc.highpass", "rvc.split", "offline.step",
         "offline.convert", "request"])
    return view
