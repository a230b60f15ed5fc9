"""One live stream on the audio clock: ``StreamingConverter.process_chunk``
gets chunk i at t0 + i hop, an open loop that does not wait for the
converter (a late hop delays the next, whose latency counts the wait).

The mix's parameters (``traffic/<mix>.json``): ``stream`` (the converter's
``StreamingConfig``: chunk, window of ``buffer_size`` chunks, f0 rate,
pitch shift, target decimation), ``pipeline_depth`` and ``cuda_graph``;
the input voice and a ``target_s`` target voice (``traffic/voice.py``),
whose encoder frames with ``library_tokens`` seeded Gaussian tokens make
the target matrix (``build_target_matrix``); ``prime_chunks`` chunks that
fill the window, then ``warmup_hops`` hops (the first captures the graph)
before the window opens.

``hop_p95_ms`` is the 95th percentile over every hop of the window, from
when its chunk was due to the return of ``process_chunk`` with its output.
The collector runs in the window as it does for users; the harness's own
objects from set-up are frozen out of its view (``gc.freeze``).
"""

from __future__ import annotations

import gc
import time
from types import SimpleNamespace

import numpy as np
import torch

import common
import tracing
from reference import paths
from reference.numerics import exact_float32


def stream_settings(spec) -> dict:
    s = dict(spec.traffic["stream"])
    s.update(k=spec.config["model"]["knn"]["k"], alpha=spec.config["model"]["knn"]["alpha"])
    return s


def hops_in(spec, seconds: float) -> int:
    st = spec.traffic["stream"]
    return int(seconds * spec.config["model"]["audio"]["sample_rate"] // st["chunk"])


def build(spec, seed: int, seconds: float, device):
    """Weights, the target voice and tokens, and the input stream (host
    float32) long enough for the priming, the warm-up and the window."""
    from traffic import voice

    p, sr = spec.traffic, spec.config["model"]["audio"]["sample_rate"]
    chunk = p["stream"]["chunk"]
    params, _ = common.draw_weights(spec.config, seed, device)
    target = voice.voice(common.generator(seed, "target", device), int(p["target_s"] * sr), sr,
                         p["voice"], device)
    tokens = torch.empty(p["library_tokens"], spec.config["model"]["decoder"]["content_channels"],
                         device=device).normal_(generator=common.generator(seed, "tokens", device))
    n = p["prime_chunks"] + p["warmup_hops"] + hops_in(spec, seconds)
    stream = voice.voice(common.generator(seed, "stream", device), n * chunk, sr, p["voice"], device)
    return params, target, tokens, stream.cpu().numpy()


def reference_target(spec, params, target, tokens):
    with torch.no_grad(), exact_float32():
        return paths.target_matrix(paths.Precisions(), params, spec.config["model"], target, tokens,
                                   spec.traffic["stream"]["target_decimation"])


def _windows(spec, stream: np.ndarray, first: int, count: int, device) -> torch.Tensor:
    """The rolling windows of hops ``first`` .. ``first + count - 1`` (hop j
    takes chunk prime_chunks + j and the buffer_size - 1 before it)."""
    st = spec.traffic["stream"]
    c, w = st["chunk"], st["chunk"] * st["buffer_size"]
    ends = [(spec.traffic["prime_chunks"] + j + 1) * c for j in range(first, first + count)]
    return torch.from_numpy(np.stack([stream[e - w:e] for e in ends])).to(device)


def _alternatives(f0_tie: torch.Tensor, knn_tie: torch.Tensor, most: int = 8):
    """The other ways a hop's near-ties could have gone: none taken the
    other way (the hop alone, whose rounding differs from the batch's by
    about 1e-7 of a logit, which can reorder a near-tie), each near-tie
    taken the other way alone (the first ``most``), then all of them."""
    ties = [("f0", t) for t in torch.nonzero(f0_tie)[:, 0].tolist()] + \
           [("knn", t) for t in torch.nonzero(knn_tie)[:, 0].tolist()]
    out = [(torch.zeros_like(f0_tie), torch.zeros_like(knn_tie))]
    for which, t in ties[:most]:
        fs, ks = torch.zeros_like(f0_tie), torch.zeros_like(knn_tie)
        (fs if which == "f0" else ks)[t] = True
        out.append((fs, ks))
    if len(ties) > 1:
        out.append((f0_tie, knn_tie))
    return out


def compare(spec, outs: list, phis: torch.Tensor, stream: np.ndarray, params, tgt: torch.Tensor,
            device, block: int = 32) -> dict:
    """Each hop after the priming (the warm-up's and the window's) against
    the reference's hop from the same window and the phase the converter
    carried into it (zero into the first): the widest output gap over the
    stream's peak, and the widest gap of the phase carried out.  A hop
    over a limit whose reference chose an F0 bin or a k-th row by less than
    the near-tie margins is judged again against the reference of that hop
    alone, as chosen and with those choices taken the other way
    (``_alternatives``), and the nearest counts."""
    n = len(outs)
    cfg, st = spec.config["model"], stream_settings(spec)
    tie, lim, pr = spec.checks["near_tie"], spec.checks["limits"], paths.Precisions()
    prev = torch.cat([torch.zeros_like(phis[:1]), phis[:n - 1]])[:, None, :]
    with torch.no_grad(), exact_float32():
        parts = [paths.stream_hops(pr, params, cfg, _windows(spec, stream, b0, min(block, n - b0), device),
                                   prev[b0:b0 + block], tgt, st) for b0 in range(0, n, block)]
        want, phi_next, f0_m, knn_m = (torch.cat(x) for x in zip(*parts))
        peak = max(float(want.abs().max()), 1e-30)
        got = torch.stack([torch.as_tensor(x, device=device) if x is not None else
                           torch.full_like(want[0], float("inf")) for x in outs])
        wg = (got - want).abs().amax(1) / peak
        pg = (phis - phi_next).abs().amax(1)
        f0_tie, knn_tie = f0_m < tie["f0"], knn_m < tie["knn"]
        fragile = f0_tie.any(1) | knn_tie.any(1)
        off = (wg > lim["hop_wave_gap"]) | (pg > lim["hop_phi_gap"])
        swapped = 0
        for h in torch.nonzero(fragile & off)[:, 0].tolist():
            win = _windows(spec, stream, h, 1, device)
            for fs, ks in _alternatives(f0_tie[h], knn_tie[h]):
                alt, alt_phi, _, _ = paths.stream_hops(pr, params, cfg, win, prev[h:h + 1], tgt, st,
                                                       f0_swap=fs[None], knn_swap=ks[None])
                awg = float((got[h] - alt[0]).abs().max()) / peak
                apg = float((phis[h] - alt_phi[0]).abs().max())
                if awg / lim["hop_wave_gap"] + apg / lim["hop_phi_gap"] < \
                        float(wg[h]) / lim["hop_wave_gap"] + float(pg[h]) / lim["hop_phi_gap"]:
                    wg[h], pg[h] = awg, apg
            swapped += int(wg[h] <= lim["hop_wave_gap"] and pg[h] <= lim["hop_phi_gap"])
    print(f"stream check: {n} hops, {int(fragile.sum())} with a near-tie, {int(off.sum())} over a limit "
          f"as the reference chose, {swapped} of them within it with a near-tie taken the other way",
          flush=True)
    return {"hop_wave_gap": common.check(float(wg.max()), lim["hop_wave_gap"]),
            "hop_phi_gap": common.check(float(pg.max()), lim["hop_phi_gap"])}


def run(spec, seed: int, seconds: float, trace: bool, device, t_start: float) -> dict:
    from alivevc_tpu_torch.config import StreamingConfig
    from alivevc_tpu_torch.infer.offline import build_target_matrix
    from alivevc_tpu_torch.infer.streaming import StreamingConverter

    import program

    p, cfg = spec.traffic, spec.config
    st = p["stream"]
    sr = cfg["model"]["audio"]["sample_rate"]
    chunk, hop_s = st["chunk"], st["chunk"] / sr
    common.stage(t_start, "imports and the card")
    params, target, tokens, stream = build(spec, seed, seconds, device)
    common.stage(t_start, "weights, target voice, tokens and stream drawn")
    ce, f0m, dec = program.build_models(cfg["model"], params)
    tgt = build_target_matrix(ce, target_wave=target.cpu().numpy(), library_tokens=tokens,
                              decimation=st["target_decimation"], device=device)
    conv = StreamingConverter(ce, f0m, dec, tgt, StreamingConfig(**stream_settings(spec)),
                              pipeline_depth=p["pipeline_depth"],
                              cuda_graph=p["cuda_graph"] if torch.device(device).type == "cuda" else False,
                              device=device)
    common.stage(t_start, "target matrix and converter built")
    prime = p["prime_chunks"]
    conv.prime(stream[:prime * chunk])
    outs, phis = [], []
    for j in range(p["warmup_hops"]):
        outs.append(conv.process_chunk(stream[(prime + j) * chunk:(prime + j + 1) * chunk]))
        phis.append(conv.state.phi.reshape(-1).clone())
    common.stage(t_start, f"primed, {p['warmup_hops']} warm-up hops (the graph captured)")
    n_hops = hops_in(spec, seconds)
    ring = torch.zeros((n_hops, conv.state.phi.numel()), device=device)
    first = prime + p["warmup_hops"]
    tracer = tracing.Session() if trace else None
    common.sync()
    setup_s = time.perf_counter() - t_start
    gc.collect()
    gc.freeze()

    lat, times, failed, errors = [], [], 0, []
    usage0 = common.host_usage()
    t0 = time.perf_counter() + hop_s
    for i in range(n_hops):
        due = t0 + i * hop_s
        while time.perf_counter() < due:      # on the clock: a generator that sleeps wakes up late
            pass
        chunk_in = stream[(first + i) * chunk:(first + i + 1) * chunk]
        start = time.perf_counter()
        try:
            if tracer is not None:
                with tracing.span("hop"):
                    out = conv.process_chunk(chunk_in)
            else:
                out = conv.process_chunk(chunk_in)
            ok = out.shape == (chunk,) and bool(np.isfinite(out).all())
        except Exception as exc:          # a hop that fails counts as failed, and the stream goes on
            out, ok = None, False
            errors.append(repr(exc))
        end = time.perf_counter()
        ring[i].copy_(conv.state.phi.reshape(-1))
        outs.append(out)
        lat.append(end - due)
        times.append((due, start, end))
        failed += 0 if ok else 1
    usage1 = common.host_usage()
    gc.unfreeze()
    traced = tracer.stop() if tracer is not None else None
    dev = common.device_info(device)
    for e in errors[:3]:
        print(f"hop failed: {e}", flush=True)
    late = [s - d for d, s, _ in times]
    print(f"stream: {n_hops} hops, generator late by median {1e3 * float(np.median(late)):.4f} ms, "
          f"max {1e3 * max(late):.4f} ms; latency ms p50 {np.percentile(lat, 50) * 1e3:.4f} "
          f"p90 {np.percentile(lat, 90) * 1e3:.4f} p99 {np.percentile(lat, 99) * 1e3:.4f} "
          f"max {max(lat) * 1e3:.4f}; hops over 5 ms at {[i for i, x in enumerate(lat) if x > 0.005]}; "
          f"{common.host_line(usage0, usage1)}", flush=True)

    del conv, ce, f0m, dec
    common.free_program(device)
    ref_tgt = reference_target(spec, params, target, tokens)
    checks = compare(spec, outs, torch.cat([torch.stack(phis), ring]) if phis else ring, stream, params,
                     ref_tgt, device)
    lat_ms = np.array(lat) * 1e3
    res = {"end_to_end": {"hop_p95_ms": float(np.percentile(lat_ms, 95)), "setup_s": setup_s},
           "attempted": n_hops, "failed": failed, "checks": checks, "device": dev}
    if trace:
        res["view"] = stream_view(spec, traced, times, dev, tgt.shape[0])
    return res


def control(spec, seed: int, device, seconds: float) -> dict:
    """The reference hop in the configuration's control precision, put in
    the converter's place: hop by hop over the same stream, carrying its
    own phase."""
    params, target, tokens, stream = build(spec, seed, seconds, device)
    tgt = reference_target(spec, params, target, tokens)
    pr = paths.Precisions(spec.config["control"])
    cfg, st = spec.config["model"], stream_settings(spec)
    ctl_tgt = paths.target_matrix(pr, params, cfg, target, tokens, st["target_decimation"])
    phi = torch.zeros((1, 1, cfg["decoder"]["num_harmonics"]), device=device)
    outs, phis = [], []
    with torch.no_grad(), exact_float32():
        for j in range(spec.traffic["warmup_hops"] + hops_in(spec, seconds)):
            out, phi_next, _, _ = paths.stream_hops(pr, params, cfg, _windows(spec, stream, j, 1, device),
                                                    phi, ctl_tgt, st)
            phi = phi_next[:, None, :]
            outs.append(out[0])
            phis.append(phi_next[0])
    return compare(spec, outs, torch.stack(phis), stream, params, tgt, device)


def stream_view(spec, tr, times: list, dev: dict, rows: int) -> SimpleNamespace:
    """What the per-layer readers of a stream cell read: each hop's interval
    (due, call, return) on the profiler's clock and its device time."""
    view = SimpleNamespace(spec=spec, trace=tr, breakdown=None, hops=None, calls=None, counters=None,
                           precision=spec.config["precision"], model=spec.config["model"],
                           library_rows=rows)
    if tr is None or len(tr) == 0 or "hop" not in tr.spans:
        view.trace = None
        return view
    hops = []
    for (due, start, end), (a, b) in zip(times, tr.spans["hop"]):
        due_ns = a - int((start - due) * 1e9)
        hops.append((due_ns, a, b, tr.busy_s(a, b)))
    view.hops = hops
    view.t0, view.t1 = hops[0][0], hops[-1][2]
    view.window_s = (view.t1 - view.t0) / 1e9
    view.busy_s = tr.busy_s(view.t0, view.t1)
    view.hop_frames = (spec.traffic["stream"]["chunk"] * spec.traffic["stream"]["buffer_size"]
                       // spec.config["model"]["audio"]["hop_length"])
    dev["busy_s"], dev["window_s"] = view.busy_s, view.window_s
    view.breakdown = tracing.breakdown(tr, view.t0, view.t1, [], ["hop"])
    return view

