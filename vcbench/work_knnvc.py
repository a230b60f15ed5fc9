"""The yardstick of the kNN-VC cells: the operations of one request from
the shapes of its utterance, by part, with ``work.py``'s conventions (each
product counted once, 2 operations a multiply-add; norms, activations and
softmax not counted) and its peaks.  The kNN is ``work.knn_call``."""

from __future__ import annotations

from typing import Dict

import work


def conv_lengths(samples: int, wavlm: dict) -> list:
    """The length after each conv of the front end."""
    out, n = [], samples
    for k, s in zip(wavlm["conv_kernel"], wavlm["conv_stride"]):
        n = (n - k) // s + 1
        out.append(n)
    return out


def frames(samples: int, wavlm: dict) -> int:
    """WavLM frames of an utterance: the queries of its kNN call."""
    return conv_lengths(samples, wavlm)[-1]


def request_flops(model: dict, samples: int, rows: int) -> Dict[str, float]:
    """Operations of converting one utterance of ``samples`` samples at 16
    kHz against ``rows`` matching-set rows, by part: the conv front end with
    the projection and the positional conv, the layers run (their
    projections and FFN; the attention's scores and product with V apart),
    the kNN, the vocoder."""
    w, v = model["wavlm"], model["vocoder"]
    d, ff, layers = w["hidden_size"], w["intermediate_size"], model["layer"]
    lens = conv_lengths(samples, w)
    t = lens[-1]
    front, cin = 0.0, 1
    for n, c, k in zip(lens, w["conv_dim"], w["conv_kernel"]):
        front += 2.0 * n * c * cin * k
        cin = c
    front += 2.0 * t * cin * d
    front += 2.0 * t * d * (d // w["num_conv_pos_embedding_groups"]) * w["num_conv_pos_embeddings"]
    dense = layers * 2.0 * t * (4 * d * d + 8 * d + 2 * d * ff)
    attention = layers * 2.0 * 2 * t * t * d
    voc = 2.0 * t * v["input_channels"] * v["hidden_channels"]
    c = v["upsample_initial_channel"]
    voc += 2.0 * t * v["hidden_channels"] * c * 7
    length = t
    for u, k in zip(v["upsample_rates"], v["upsample_kernel_sizes"]):
        voc += 2.0 * length * c * (c // 2) * k
        length, c = length * u, c // 2
        for kr, dils in zip(v["resblock_kernel_sizes"], v["resblock_dilation_sizes"]):
            voc += 2 * len(dils) * 2.0 * length * c * c * kr
    voc += 2.0 * length * c * 7
    return {"front_end": front, "layers": dense, "attention": attention,
            "knn": work.knn_call(t, rows, d, "fp32", "high")["flops"], "vocoder": voc}
