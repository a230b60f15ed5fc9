"""ALiVE-VC's three networks as plain functions over a flat dict of
parameters, named as the published PyTorch modules name them
(uthree/ALiVE-VC module/common.py, content_encoder.py, f0_estimator.py,
decoder.py), activations channels-last [N, T, C].

``param_specs`` lists every parameter with its shape and how it is drawn;
``weights.py`` draws them, and a forward takes only names from that list
(``check_params`` holds a dict to it strictly).  Every product goes through
a ``numerics.Math``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from reference.numerics import Math

Spec = Tuple[str, Tuple[int, ...], tuple]    # (name, shape, (kind, value))


def _linear_spec(prefix: str, cin: int, cout: int) -> List[Spec]:
    b = 1.0 / math.sqrt(cin)
    return [(f"{prefix}.weight", (cout, cin, 1), ("uniform", b)),
            (f"{prefix}.bias", (cout,), ("uniform", b))]


def _conv_spec(prefix: str, cin: int, cout: int, k: int, groups: int = 1) -> List[Spec]:
    b = 1.0 / math.sqrt(cin // groups * k)
    return [(f"{prefix}.weight", (cout, cin // groups, k), ("uniform", b)),
            (f"{prefix}.bias", (cout,), ("uniform", b))]


def _convnext_spec(prefix: str, c: int, h: int, k: int, layers: int, cond: int = 0) -> List[Spec]:
    out = _conv_spec(f"{prefix}.dw_conv", c, c, k, groups=c)
    if cond:
        out += _linear_spec(f"{prefix}.norm.scale", cond, c) + _linear_spec(f"{prefix}.norm.shift", cond, c)
    else:
        out += [(f"{prefix}.norm.scale", (1, c, 1), ("const", 1.0)),
                (f"{prefix}.norm.shift", (1, c, 1), ("const", 0.0))]
    out += _linear_spec(f"{prefix}.pw_conv1", c, h) + _linear_spec(f"{prefix}.pw_conv2", h, c)
    return out + [(f"{prefix}.scale", (1, c, 1), ("const", 1.0 / layers))]


def param_specs(model: dict) -> Dict[str, List[Spec]]:
    """{'ce': [...], 'f0': [...], 'dec': [...]} from a configuration's
    ``model`` section."""
    n_bins = model["audio"]["n_fft"] // 2 + 1
    ce, f0, dc = model["content_encoder"], model["f0_estimator"], model["decoder"]
    specs = {}
    for key, c, extra in (("ce", ce, False), ("f0", f0, True)):
        s = _linear_spec("input_layer", n_bins, c["internal_channels"])
        for i in range(c["num_layers"]):
            s += _convnext_spec(f"mid_layers.{i}", c["internal_channels"], c["hidden_channels"],
                                c["kernel_size"], c["num_layers"])
        if extra:
            s += [("last_norm.scale", (1, c["internal_channels"], 1), ("const", 1.0)),
                  ("last_norm.shift", (1, c["internal_channels"], 1), ("const", 0.0))]
        specs[key] = s + _linear_spec("output_layer", c["internal_channels"], c["output_channels"])
    ch = dc["channels"]
    s = _linear_spec("feature_extractor.input_layer", dc["content_channels"], ch)
    s += [("feature_extractor.f0_enc.c1.weight", (ch, 1, 1), ("normal", 0.3)),
          ("feature_extractor.f0_enc.c1.bias", (ch,), ("uniform", 1.0))]
    s += _linear_spec("feature_extractor.f0_enc.c2", ch, ch)
    for i in range(dc["num_layers"]):
        s += _convnext_spec(f"feature_extractor.mid_layers.{i}", ch, dc["hidden_channels"],
                            dc["kernel_size"], dc["num_layers"], cond=ch)
    s += _linear_spec("harmonic_oscillator.to_amps", ch, dc["num_harmonics"])
    chans, rates, k = list(dc["filter_channels"]), list(dc["filter_rates"]), dc["filter_kernel_size"]
    s += _conv_spec("filter.source_in", 1, chans[0], 7)
    for j, (c, cn, r) in enumerate(zip(chans, chans[1:] + [chans[-1]], rates)):
        s += _conv_spec(f"filter.downs.{j}", c, cn, r)
    s += _conv_spec("filter.mid_conv.conv", chans[-1], chans[-1], k)
    rchans = chans[::-1]
    for j, (c, cp, r) in enumerate(zip(rchans, [rchans[0]] + rchans[:-1], rates[::-1])):
        b = 1.0 / math.sqrt(c * r)          # a transposed conv's fan-in is cout * k
        s += [(f"filter.ups.{j}.weight", (cp, c, r), ("uniform", b)),
              (f"filter.ups.{j}.bias", (c,), ("uniform", b))]
    for j, c in enumerate(rchans):
        s += _linear_spec(f"filter.blocks.{j}.input_conv", c, c)
        for d in range(dc["filter_dilations"]):
            for half in ("c1", "c2"):
                p = f"filter.blocks.{j}.blocks.{d}.{half}"
                s += _conv_spec(f"{p}.conv.conv", c, c, k)
                s += _linear_spec(f"{p}.to_scale", ch, c) + _linear_spec(f"{p}.to_shift", ch, c)
    s += _conv_spec("filter.source_out", chans[0], 1, 7)
    specs["dec"] = s
    return specs


def check_params(params: Dict[str, torch.Tensor], specs: List[Spec], what: str) -> None:
    """Strict load: exactly the spec's names, each with the spec's shape."""
    want = {n: tuple(shape) for n, shape, _ in specs}
    got = {n: tuple(t.shape) for n, t in params.items()}
    if want != got:
        missing, extra = sorted(set(want) - set(got)), sorted(set(got) - set(want))
        wrong = sorted(n for n in set(want) & set(got) if want[n] != got[n])
        raise KeyError(f"{what}: missing {missing[:5]}, unexpected {extra[:5]}, wrong shape {wrong[:5]}")


# ---------------------------------------------------------------------------
# layers (module/common.py)
# ---------------------------------------------------------------------------


def linear(m: Math, p, name: str, x: torch.Tensor) -> torch.Tensor:
    return m.mm(x, p[f"{name}.weight"][:, :, 0].t()) + p[f"{name}.bias"].float()


def _norm(x: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    """Over channels: mean, unbiased std, eps added to sigma."""
    mu = x.mean(dim=-1, keepdim=True)
    d = x - mu
    var = (d * d).sum(dim=-1, keepdim=True) / (x.shape[-1] - 1)
    return d / (torch.sqrt(var) + eps)


def convnext(m: Math, p, name: str, x: torch.Tensor, cond=None) -> torch.Tensor:
    w = p[f"{name}.dw_conv.weight"]
    k = w.shape[-1]
    h = m.conv1d(x, w, p[f"{name}.dw_conv.bias"], padding=(k - 1) // 2, groups=x.shape[-1])
    if cond is None:
        h = _norm(h) * p[f"{name}.norm.scale"].reshape(-1) + p[f"{name}.norm.shift"].reshape(-1)
    else:
        h = _norm(h) * linear(m, p, f"{name}.norm.scale", cond) + linear(m, p, f"{name}.norm.shift", cond)
    h = F.gelu(linear(m, p, f"{name}.pw_conv1", h))
    h = linear(m, p, f"{name}.pw_conv2", h)
    return h * p[f"{name}.scale"].reshape(-1) + x


def _stack(m: Math, p, spec: torch.Tensor, layers: int) -> torch.Tensor:
    x = linear(m, p, "input_layer", spec)
    for i in range(layers):
        x = convnext(m, p, f"mid_layers.{i}", x)
    return x


def content_encoder(m: Math, p, cfg: dict, spec: torch.Tensor) -> torch.Tensor:
    """spec [N, T, n_bins] -> content [N, T, 768]."""
    return linear(m, p, "output_layer", _stack(m, p, spec.float(), cfg["num_layers"]))


def f0_logits(m: Math, p, cfg: dict, spec: torch.Tensor) -> torch.Tensor:
    """spec [N, T, n_bins] -> logits [N, T, bins]; bin index = Hz."""
    x = _stack(m, p, spec.float(), cfg["num_layers"])
    x = _norm(x) * p["last_norm.scale"].reshape(-1) + p["last_norm.shift"].reshape(-1)
    return linear(m, p, "output_layer", x)


# ---------------------------------------------------------------------------
# decoder (module/decoder.py)
# ---------------------------------------------------------------------------


def interp_time(x: torch.Tensor, out_len: int) -> torch.Tensor:
    """[N, T, C] -> [N, out_len, C], F.interpolate(mode='linear',
    align_corners=False) along time."""
    t = x.shape[1]
    if t == out_len:
        return x
    src = torch.clamp((torch.arange(out_len, device=x.device, dtype=torch.float64) + 0.5)
                      * (t / out_len) - 0.5, min=0.0)
    i0 = torch.clamp(torch.floor(src).long(), max=t - 1)
    i1 = torch.clamp(i0 + 1, max=t - 1)
    frac = (src - torch.floor(src)).float()[None, :, None]
    x0, x1 = x[:, i0], x[:, i1]
    return x0 + (x1 - x0) * frac


def upsample_3tap(x: torch.Tensor, factor: int) -> torch.Tensor:
    """The same interpolation at an integer factor, written as the streaming
    oscillator's published arithmetic forms it: sample r of frame q mixes
    frames q-1, q, q+1 (edge-padded) with float32 weights."""
    r = np.arange(factor)
    u = (r + 0.5) / factor - 0.5
    ws = [np.where(u < 0, -u, 0.0), np.where(u < 0, 1.0 + u, 1.0 - u), np.where(u >= 0, u, 0.0)]
    wa, wb, wc = (torch.from_numpy(w.astype(np.float32)).to(x.device).to(x.dtype)[None, None, :, None]
                  for w in ws)
    n, t, c = x.shape
    x0 = torch.cat([x[:, :1], x[:, :-1]], dim=1)
    x2 = torch.cat([x[:, 1:], x[:, -1:]], dim=1)
    y = x0[:, :, None, :] * wa + x[:, :, None, :] * wb + x2[:, :, None, :] * wc
    return y.reshape(n, t * factor, c)


def feature_extractor(m: Math, p, cfg: dict, content: torch.Tensor, f0: torch.Tensor) -> torch.Tensor:
    x = linear(m, p, "feature_extractor.input_layer", content.float())
    cond = torch.sin(linear(m, p, "feature_extractor.f0_enc.c1", f0.float()))
    cond = linear(m, p, "feature_extractor.f0_enc.c2", cond)
    for i in range(cfg["num_layers"]):
        x = convnext(m, p, f"feature_extractor.mid_layers.{i}", x, cond)
    return x


def _interp_weights(seg: int):
    """Sample r of frame q mixes frames q-1, q, q+1 (edge-padded) with these
    float32 weights: linear interpolation, align_corners=False, at x seg."""
    r = np.arange(seg)
    u = (r + 0.5) / seg - 0.5
    return [np.where(u < 0, -u, 0.0).astype(np.float32), np.where(u < 0, 1.0 + u, 1.0 - u).astype(np.float32),
            np.where(u >= 0, u, 0.0).astype(np.float32)]


def source_offline(f0: torch.Tensor, amps: torch.Tensor, sr: int, seg: int) -> torch.Tensor:
    """The offline harmonic source (phase 0 at the window's first sample):
    f0 [N, T, 1] Hz, amps [N, T, H] -> [N, T seg], the mean over harmonics
    of amp_h sin(h theta).  The phase keeps the published design's
    precision: the frequency f0 / sr and its running sum inside a frame in
    float32 (the interpolation weights' prefix sums times the frame's
    three frequencies), each frame's starting phase summed in float64 and
    wrapped; sin(h theta) is then taken exactly."""
    n, t, nh = amps.shape
    w = [torch.from_numpy(x).to(f0.device) for x in _interp_weights(seg)]
    ws = [torch.cumsum(x, 0) for x in w]
    edge = lambda x: torch.cat([x[:, :1], x, x[:, -1:]], dim=1)            # noqa: E731
    fp = edge(f0[..., 0].float() / sr)[..., None]                          # [N, T+2, 1]
    cseg = fp[:, :-2] * ws[0] + fp[:, 1:-1] * ws[1] + fp[:, 2:] * ws[2]    # [N, T, seg]
    tot = cseg[:, :, -1].double()
    o = (torch.cumsum(tot, dim=1) - tot) - cseg[:, :1, 0].double()
    theta = (2.0 * math.pi * (cseg + (o - torch.floor(o)).float()[..., None])).double()
    ap = edge(amps.float())
    acc = torch.zeros_like(cseg)
    for h in range(nh):
        a = ap[:, :-2, h:h + 1] * w[0] + ap[:, 1:-1, h:h + 1] * w[1] + ap[:, 2:, h:h + 1] * w[2]
        acc = acc + torch.sin(theta * (h + 1)).float() * a
    return (acc / nh).reshape(n, t * seg)


def source_stream(f0: torch.Tensor, amps: torch.Tensor, phi: torch.Tensor, crop0: int,
                  sr: int, seg: int):
    """The streaming source (module/decoder.py:91-95): per harmonic the
    float32 running sum of its frequency, re-zeroed at ``crop0``, plus the
    carried pseudo-phase phi; returns (wave [N, L], phi_out [N, L, H] =
    asin of each harmonic)."""
    n, t, nh = amps.shape
    mul = torch.arange(1, nh + 1, dtype=torch.float32, device=f0.device)
    formants = upsample_3tap(f0.float() * mul, seg)
    a = upsample_3tap(amps.float(), seg)
    dt = torch.cumsum(formants / sr, dim=1)
    dt = dt - dt[:, crop0][:, None, :]
    harmonics = torch.sin(2.0 * math.pi * dt + phi)
    return torch.mean(harmonics * a, dim=2), torch.asin(harmonics)


def _causal(m: Math, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, d: int) -> torch.Tensor:
    pad = (w.shape[-1] - 1) * d
    if pad:
        x = torch.cat([x[:, 1:pad + 1].flip(1), x], dim=1)
    return m.conv1d(x, w, b, dilation=d)


def filter_unet(m: Math, p, cfg: dict, source: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
    """source [N, L], cond [N, T, C] -> [N, L]."""
    rates, chans = list(cfg["filter_rates"]), list(cfg["filter_channels"])
    x = m.conv1d(source[..., None], p["filter.source_in.weight"], p["filter.source_in.bias"], padding=3)
    skips = []
    for j, r in enumerate(rates):
        w = p[f"filter.downs.{j}.weight"]                       # [Cout, Cin, r]
        n, length, cin = x.shape
        x = m.mm(x.reshape(n, length // r, r * cin), w.permute(2, 1, 0).reshape(r * cin, -1))
        x = x + p[f"filter.downs.{j}.bias"].float()
        skips.append(x)
    x = _causal(m, x, p["filter.mid_conv.conv.weight"], p["filter.mid_conv.conv.bias"], 1)
    for j, (s, r) in enumerate(zip(reversed(skips), reversed(rates))):
        w = p[f"filter.ups.{j}.weight"]                         # [Cin, Cout, r]
        n, length, _ = x.shape
        c = w.shape[1]
        x = m.mm(x + s, w.permute(0, 2, 1).reshape(w.shape[0], r * c)).reshape(n, length * r, c)
        x = linear(m, p, f"filter.blocks.{j}.input_conv", x + p[f"filter.ups.{j}.bias"].float())
        for d in range(cfg["filter_dilations"]):
            res = x
            for half in ("c1", "c2"):
                q = f"filter.blocks.{j}.blocks.{d}.{half}"
                scale = interp_time(linear(m, p, f"{q}.to_scale", cond) + 1.0, x.shape[1])
                shift = interp_time(linear(m, p, f"{q}.to_shift", cond), x.shape[1])
                x = _causal(m, F.gelu(x) * scale + shift, p[f"{q}.conv.conv.weight"],
                            p[f"{q}.conv.conv.bias"], 2 ** d)
            x = x + res
    return m.conv1d(x, p["filter.source_out.weight"], p["filter.source_out.bias"], padding=3)[..., 0]


def decoder(m: Math, p, cfg: dict, content: torch.Tensor, f0: torch.Tensor, phi=None,
            crop: Tuple[int, int] = (0, -1)):
    """content [N, T, 768], f0 [N, T, 1] -> (wave [N, T seg], phi_out or
    None).  Without ``phi`` the offline source; with it the streaming
    source, re-zeroed at crop[0]."""
    feats = feature_extractor(m, p, cfg, content, f0)
    amps = torch.exp(linear(m, p, "harmonic_oscillator.to_amps", feats))
    sr, seg = cfg["sample_rate"], cfg["segment_size"]
    if phi is None:
        source, phi_out = source_offline(f0, amps, sr, seg), None
    else:
        source, phi_out = source_stream(f0, amps, phi, crop[0], sr, seg)
    return filter_unet(m, p, cfg, source, feats), phi_out
