"""Phase-continuous streaming voice conversion (realtime_inference.py:122-190).

One hop over an explicit carried state:

  state = (rolling window [1, W] at 16 kHz, phi [1, 1, Nh])
  step(state, new_chunk) -> (state', centre chunk of the converted window)

The reference recomputes the whole 8-chunk (480 ms) window every 60 ms hop
and keeps the output continuous across hops with the decoder's ``crop``
phase re-zeroing plus the carried pseudo-phase phi = asin(sin theta) taken
at the end of the output chunk (module/decoder.py:91-95,
realtime_inference.py:166-167).  This is the JAX package's
``infer/streaming.py``.  The hop runs the STFT kernel, the content encoder
and F0 estimator, the kNN kernel in 'high' (float32 scores: JAX streaming is
float32 only) and the decoder with phi and crop, which takes the plain
oscillator and the filter-level kernels; all in float32 with TF32 off.

Where JAX compiles the hop into one program, ``StreamingConverter`` on the
card captures it once as a CUDA graph over static tensors (the input chunk,
the window, phi, the target matrix, the output chunk) and replays it every
hop; ``cuda_graph=False`` runs the same hop eagerly.  Both forms update the
state in place, so a hop's output does not depend on which one ran.

With ``world_pitch`` the hop takes WORLD's pitch (``ops/world.py``) in place
of the F0 estimator's, computed on the host from the window the hop will
see, as JAX does.  The converter keeps that window's samples on the host as
well, so nothing is read back from the card, and f0 enters the hop as one
more static input: the graph is captured with ``f0_override``.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from alivevc_tpu_torch.config import DecoderConfig, StreamingConfig
from alivevc_tpu_torch.device import DeviceLike, float32_math, resolve_device
from alivevc_tpu_torch.infer.offline import _on
from alivevc_tpu_torch.kernels.stft import stft_magnitude
from alivevc_tpu_torch.models.content_encoder import content_encoder
from alivevc_tpu_torch.models.decoder import decoder
from alivevc_tpu_torch.models.f0_estimator import f0_estimate
from alivevc_tpu_torch.ops.knn import match_features_kernel
from alivevc_tpu_torch.ops.pitch import shift_pitch
from alivevc_tpu_torch.ops.world import compute_f0
from alivevc_tpu_torch.utils.profiling import span

WARMUP_HOPS = 2   # eager hops on a side stream before the capture


class StreamState(NamedTuple):
    window: torch.Tensor   # [1, buffer_size * chunk] rolling 16 kHz window
    phi: torch.Tensor      # [1, 1, num_harmonics] carried pseudo-phase


def init_stream_state(cfg: StreamingConfig = StreamingConfig(),
                      dec_cfg: DecoderConfig = DecoderConfig(),
                      device: DeviceLike = None) -> StreamState:
    dev = resolve_device(device)
    return StreamState(
        window=torch.zeros((1, cfg.buffer_size * cfg.chunk), dtype=torch.float32, device=dev),
        phi=torch.zeros((1, 1, dec_cfg.num_harmonics), dtype=torch.float32, device=dev),
    )


def output_span(cfg: StreamingConfig) -> Tuple[int, int]:
    """[begin, end) of the window's samples that a hop returns: the chunk
    centred in the window."""
    center = (cfg.chunk * cfg.buffer_size) // 2
    return center - cfg.chunk // 2, center + cfg.chunk // 2


@torch.no_grad()
def streaming_step(
    ce: nn.Module,
    f0_est: nn.Module,
    dec: nn.Module,
    state: StreamState,
    new_chunk,                   # [chunk] fresh 16 kHz samples
    tgt: torch.Tensor,           # [Lr, 768]
    f0_rate: float = 1.0,
    pitch_shift: float = 0.0,
    k: int = 4,
    alpha: float = 0.0,
    cfg: StreamingConfig = StreamingConfig(),
    dec_cfg: Optional[DecoderConfig] = None,
    f0_override=None,            # [1, T, 1] Hz, bypasses the estimator
) -> Tuple[StreamState, torch.Tensor]:
    """One 60 ms hop on the state's device.  Returns (state', the centre
    chunk [chunk] of the converted window)."""
    dev = state.window.device
    for m, name in ((ce, "ce"), (f0_est, "f0_est"), (dec, "dec")):
        _on(m, dev, name)
    dec_cfg = dec.cfg if dec_cfg is None else dec_cfg
    chunk = cfg.chunk
    new_chunk = torch.as_tensor(new_chunk, dtype=torch.float32).to(dev)
    window = torch.cat([state.window[:, chunk:], new_chunk.reshape(1, chunk)], dim=1)
    begin_out, end_out = output_span(cfg)
    with float32_math():
        spec = stft_magnitude(window)[:, :-1, :]
        content = content_encoder(ce, spec)
        if f0_override is not None:
            f0 = torch.as_tensor(f0_override, dtype=torch.float32).to(dev) * f0_rate
        else:
            f0 = f0_estimate(f0_est, spec) * f0_rate
        f0 = shift_pitch(f0, pitch_shift)
        content = match_features_kernel(content, tgt, k=k, alpha=alpha, precision="high")
        wave, phi_out = decoder(dec, content, f0, phi=state.phi, crop=(begin_out, end_out),
                                cfg=dec_cfg)
    phi_next = phi_out[:, end_out][:, None, :]
    return StreamState(window=window, phi=phi_next), wave[0, begin_out:end_out]


class StreamingConverter:
    """Holds the models and the state; feed 16 kHz chunks, get converted 16
    kHz chunks with ``buffer_size / 2`` chunks of latency.

    ``pipeline_depth`` = d >= 1 overlaps the device with real time: each
    ``process_chunk`` starts hop N and a non-blocking copy of its output into
    one of d + 1 pinned host buffers (an event recorded after it), and
    returns hop N - d's output once that hop's event has completed, at the
    price of d more chunks of latency.  The first d calls return silence;
    ``flush`` drains the hops in flight.  d = 0 is the reference's
    synchronous loop.  The input chunk (and WORLD's f0) goes in through a
    pinned staging buffer of the same ring.

    ``cuda_graph`` (None: True on the card) captures the hop as one CUDA
    graph at the first ``process_chunk``, after ``WARMUP_HOPS`` eager hops on
    a side stream (they build the kernels and make the first-use copies,
    then the state is put back).  A capture or replay that fails raises;
    nothing falls back to the eager hop.

    ``world_pitch`` labels each hop's pitch with WORLD on the host, from a
    host copy of the window (``prime``, ``reset`` and ``process_chunk`` keep
    it equal to ``state.window``: the same float32 samples).  Pipelined, the
    host labels hop N while the card runs hop N - 1."""

    def __init__(
        self,
        ce: nn.Module,
        f0_est: nn.Module,
        dec: nn.Module,
        tgt,
        cfg: StreamingConfig = StreamingConfig(),
        dec_cfg: Optional[DecoderConfig] = None,
        world_pitch: bool = False,
        pipeline_depth: int = 0,
        cuda_graph: Optional[bool] = None,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        on_card = self.device.type == "cuda"
        if cuda_graph is None:
            cuda_graph = on_card
        if cuda_graph and not on_card:
            raise ValueError("cuda_graph=True needs a CUDA device")
        if pipeline_depth < 0:
            raise ValueError(f"pipeline_depth={pipeline_depth} must be >= 0")
        self.ce = ce.to(self.device).eval()
        self.f0 = f0_est.to(self.device).eval()
        self.dec = dec.to(self.device).eval()
        self.tgt = torch.as_tensor(tgt, dtype=torch.float32).to(self.device).contiguous()
        self.cfg = cfg
        self.dec_cfg = dec.cfg if dec_cfg is None else dec_cfg
        self.world_pitch = world_pitch
        self.pipeline_depth = pipeline_depth
        self.cuda_graph = cuda_graph
        self.state = init_stream_state(cfg, self.dec_cfg, self.device)
        self._host_window = np.zeros(cfg.buffer_size * cfg.chunk, np.float32)
        self._pending: List = []       # slots (card) or arrays (CPU) not yet returned
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        if on_card:
            slots = pipeline_depth + 1
            self._chunk_dev = torch.zeros(cfg.chunk, dtype=torch.float32, device=self.device)
            self._stage = torch.zeros((slots, cfg.chunk), dtype=torch.float32).pin_memory()
            self._host_out = torch.zeros((slots, cfg.chunk), dtype=torch.float32).pin_memory()
            if world_pitch:
                frames = cfg.buffer_size * cfg.chunk // self.dec_cfg.segment_size
                self._f0_dev = torch.zeros((1, frames, 1), dtype=torch.float32, device=self.device)
                self._f0_stage = torch.zeros((slots, frames), dtype=torch.float32).pin_memory()
            self._events = [torch.cuda.Event() for _ in range(slots)]
            self._slot = 0

    def reset(self) -> None:
        """Zero the window and phi in place (the graph keeps reading them)."""
        self.state.window.zero_()
        self.state.phi.zero_()
        self._host_window[:] = 0.0
        self._pending = []

    def prime(self, samples: np.ndarray) -> None:
        """Fill the rolling window without converting.

        The reference loop returns nothing until its ring holds
        ``buffer_size`` chunks (realtime_inference.py:133-137); priming with
        the first ``buffer_size`` chunks reproduces that warm-up (phi stays
        as it is, zero after a reset)."""
        samples = np.asarray(samples, np.float32).reshape(-1)
        hw = self._host_window
        self._host_window = np.concatenate([hw, samples])[-hw.shape[0]:]
        self.state.window.copy_(torch.from_numpy(self._host_window)[None, :].to(self.device))

    def _hop(self, chunk: torch.Tensor, f0: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One hop from ``self.state``, written back into it in place; ``f0``
        [1, T, 1] Hz bypasses the estimator."""
        cfg = self.cfg
        state, out = streaming_step(self.ce, self.f0, self.dec, self.state, chunk, self.tgt,
                                    cfg.f0_rate, cfg.pitch_shift, cfg.k, cfg.alpha, cfg,
                                    self.dec_cfg, f0)
        self.state.window.copy_(state.window)
        self.state.phi.copy_(state.phi)
        return out

    def _capture(self) -> None:
        """Warm up on a side stream, restore the state, capture one hop."""
        saved = (self.state.window.clone(), self.state.phi.clone())
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        f0 = self._f0_dev if self.world_pitch else None
        with torch.cuda.stream(side):
            for _ in range(WARMUP_HOPS):
                self._hop(self._chunk_dev, f0)
        current.wait_stream(side)
        self.state.window.copy_(saved[0])
        self.state.phi.copy_(saved[1])
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self._out_dev = self._hop(self._chunk_dev, f0)
        self._graph = graph

    def process_chunk(self, chunk: np.ndarray) -> np.ndarray:
        chunk = np.asarray(chunk, np.float32)
        if chunk.shape != (self.cfg.chunk,):
            raise ValueError(f"chunk of shape {chunk.shape}, expected ({self.cfg.chunk},)")
        self._host_window = np.concatenate([self._host_window[self.cfg.chunk:], chunk])
        f0 = (compute_f0(self._host_window[None], 16_000, self.dec_cfg.segment_size)[0]
              if self.world_pitch else None)
        if self.device.type != "cuda":
            f0 = None if f0 is None else torch.from_numpy(f0)[None, :, None]
            self._pending.append(self._hop(torch.from_numpy(chunk.copy()), f0).numpy().copy())
        else:
            if self.cuda_graph and self._graph is None:
                self._capture()
            s = self._slot
            self._slot = (s + 1) % len(self._events)
            with span("stream.wait"):
                self._events[s].synchronize()     # the slot's last copies are done
            self._stage[s].numpy()[:] = chunk
            self._chunk_dev.copy_(self._stage[s], non_blocking=True)
            if f0 is not None:
                self._f0_stage[s].numpy()[:] = f0
                self._f0_dev.view(-1).copy_(self._f0_stage[s], non_blocking=True)
                f0 = self._f0_dev
            if self._graph is not None:
                with span("stream.replay"):
                    self._graph.replay()
                out = self._out_dev
            else:
                out = self._hop(self._chunk_dev, f0)
            self._host_out[s].copy_(out, non_blocking=True)
            self._events[s].record()
            self._pending.append(s)
        if len(self._pending) <= self.pipeline_depth:
            return np.zeros(self.cfg.chunk, np.float32)
        return self._take(self._pending.pop(0))

    def _take(self, item) -> np.ndarray:
        if self.device.type != "cuda":
            return item
        with span("stream.wait"):
            self._events[item].synchronize()
        return self._host_out[item].numpy().copy()

    def flush(self) -> list:
        """Drain the hops still in flight (returns [] in synchronous mode)."""
        outs = [self._take(item) for item in self._pending]
        self._pending = []
        return outs
