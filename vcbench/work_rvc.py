"""The yardstick of the RVC cells: the operations of one request from the
shapes of its segments, by part, with ``work.py``'s conventions (each product
counted once, 2 operations a multiply-add; norms, activations, softmax and
the source's elementwise work not counted) and its peaks.  The kNN is
``work.knn_call`` (the L2 mode's products are the cosine mode's: q.x, and the
penalty added after)."""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import work


def segments(samples: int, cuts: Sequence[int], d: dict, sr: int = 16_000) -> List[int]:
    """The 16 kHz samples of each segment RVC converts of a file of
    ``samples`` cut at ``cuts`` (Pipeline.pipeline: each cut floored to a
    frame, a segment from the cut before to the cut plus twice the padding
    and a frame, the last to the end of the padded file)."""
    w, pad2 = d["window"], 2 * sr * d["x_pad"]
    out, s, t = [], 0, 0
    for t in cuts:
        t = t // w * w
        out.append(t + pad2 + w - s)
        s = t
    out.append(samples + pad2 - t)
    return out


def conv_lengths(samples: int, h: dict) -> list:
    out, n = [], samples
    for k, s in zip(h["conv_kernel"], h["conv_stride"]):
        n = (n - k) // s + 1
        out.append(n)
    return out


def segment_flops(model: dict, samples: int, rows: int) -> Dict[str, float]:
    """Operations of one segment of ``samples`` samples at 16 kHz against
    ``rows`` index rows, by part: HuBERT's conv front end with the projection
    and the positional conv, its 12 layers (projections and FFN; the
    attention's scores and product with V apart), the kNN, the prior
    (content and pitch in, six layers with their banded relative terms,
    proj), the flow, the generator."""
    h, s, d = model["hubert"], model["synthesizer"], model["driver"]
    g = s["generator"]
    dh, ff = h["hidden_size"], h["intermediate_size"]
    lens = conv_lengths(samples, h)
    t1 = lens[-1]
    front, cin = 0.0, 1
    for n, c, k in zip(lens, h["conv_dim"], h["conv_kernel"]):
        front += 2.0 * n * c * cin * k
        cin = c
    front += 2.0 * t1 * cin * dh
    front += 2.0 * t1 * dh * (dh // h["num_conv_pos_embedding_groups"]) * h["num_conv_pos_embeddings"]
    layers = h["num_layers"] * 2.0 * t1 * (4 * dh * dh + 2 * dh * ff)
    attention = h["num_layers"] * 2.0 * 2 * t1 * t1 * dh
    t = min(samples // d["window"], 2 * t1)
    c, f, inter = s["hidden_channels"], s["filter_channels"], s["inter_channels"]
    band = 2 * s["window_size"] + 1
    prior = 2.0 * t * s["phone_channels"] * c + 2.0 * t * c * 2 * inter
    prior += s["n_layers"] * (2.0 * t * 4 * c * c + 2.0 * 2 * t * t * c + 2.0 * 2 * t * band * c
                              + 2.0 * 2 * t * c * f * s["kernel_size"])
    half, n_wn = inter // 2, s["flow_layers"]
    flow = s["n_flows"] * (2.0 * t * half * c + 2.0 * t * c * half + n_wn * 2.0 * t * c * 2 * c * s["flow_kernel_size"]
                           + (n_wn - 1) * 2.0 * t * c * 2 * c + 2.0 * t * c * c)
    ch = g["upsample_initial_channel"]
    voc = 2.0 * t * g["initial_channel"] * ch * 7
    length, rates = t, g["upsample_rates"]
    for i, (u, k) in enumerate(zip(rates, g["upsample_kernel_sizes"])):
        voc += 2.0 * length * ch * (ch // 2) * k
        length, ch = length * u, ch // 2
        stride = math.prod(rates[i + 1:])
        voc += 2.0 * length * ch * (2 * stride if stride > 1 else 1)          # the source's noise conv
        for kr, dils in zip(g["resblock_kernel_sizes"], g["resblock_dilation_sizes"]):
            voc += 2 * len(dils) * 2.0 * length * ch * ch * kr
    voc += 2.0 * length * ch * 7
    return {"front_end": front, "layers": layers, "attention": attention,
            "knn": work.knn_call(t1, rows, dh, "fp32", "high")["flops"], "prior": prior, "flow": flow,
            "vocoder": voc}


def request_flops(model: dict, segs: Sequence[int], rows: int) -> Dict[str, float]:
    """``segment_flops`` summed over a request's segments."""
    out: Dict[str, float] = {}
    for n in segs:
        for k, v in segment_flops(model, n, rows).items():
            out[k] = out.get(k, 0.0) + v
    return out


def knn_bound_s(model: dict, segs: Sequence[int], rows: int) -> float:
    """The least time of a request's kNN calls (``work.knn_call``, one a
    segment, its HuBERT frames as queries)."""
    h = model["hubert"]
    return sum(work.knn_call(conv_lengths(n, h)[-1], rows, h["hidden_size"], "fp32", "high")["bound_s"]
               for n in segs)
