"""Streaming voice conversion CLI (reference: realtime_inference.py).

    python -m alivevc_tpu_torch.cli.realtime_inference --input-wav in.wav --output-wav out.wav

Two modes, with the JAX package's flags (``alivevc_tpu/cli/realtime_inference.py``):

  * ``--input-wav/--output-wav``: file-driven streaming.  The wav is pushed
    through the 60 ms-hop pipeline chunk by chunk, as the microphone path
    would push it, and the output is written at 16 kHz;
  * live microphone and speaker through PyAudio (-i/-o device indices,
    -b buffer size, -c chunk...), imported only in this mode.

On the card the hop runs as one CUDA graph (``StreamingConverter``).
"""

from __future__ import annotations

import argparse

import numpy as np

from alivevc_tpu_torch.cli.common import load_params_or_init, log_logo, resample_np, target_matrix
from alivevc_tpu_torch.config import StreamingConfig
from alivevc_tpu_torch.device import resolve_device
from alivevc_tpu_torch.infer.streaming import StreamingConverter
from alivevc_tpu_torch.io.audio import read_wav, write_wav


def build_parser():
    p = argparse.ArgumentParser(description="streaming voice conversion")
    p.add_argument("--input-wav", default=None, help="file-driven streaming input")
    p.add_argument("--output-wav", default=None)
    p.add_argument("-i", "--input", default=0, type=int)
    p.add_argument("-o", "--output", default=0, type=int)
    p.add_argument("-l", "--loopback", default=-1, type=int,
                   help="optional second output device index (-1 = off)")
    p.add_argument("-g", "--gain", default=0.0, type=float)
    p.add_argument("-ig", "--input-gain", default=0.0, type=float)
    p.add_argument("-ic", "--inputchannels", default=1, type=int)
    p.add_argument("-oc", "--outputchannels", default=1, type=int)
    p.add_argument("-lc", "--loopbackchannels", default=1, type=int)
    p.add_argument("-isr", "--input-sr", default=16000, type=int)
    p.add_argument("-osr", "--output-sr", default=16000, type=int)
    p.add_argument("-lsr", "--loopback-sr", default=16000, type=int)
    p.add_argument("-dep", "--decoder-path", default="decoder.ckpt")
    p.add_argument("-cep", "--content-encoder-path", default="content_encoder.ckpt")
    p.add_argument("-f0ep", "--f0-estimator-path", default="f0_estimator.ckpt")
    p.add_argument("-b", "--buffersize", default=8, type=int)
    p.add_argument("-c", "--chunk", default=960, type=int)
    p.add_argument("-f0", "--f0-rate", default=1.0, type=float)
    p.add_argument("-p", "--pitch", default=0.0, type=float)
    p.add_argument("-t", "--target", default="NONE")
    p.add_argument("-k", default=4, type=int)
    p.add_argument("-a", "--alpha", default=0.0, type=float)
    p.add_argument("-lib", "--voice-library-path", default="NONE")
    p.add_argument("-wpe", "--world-pitch-estimation", action="store_true",
                   help="WORLD (DIO+StoneMask) pitch instead of the F0 estimator's")
    p.add_argument("-pd", "--pipeline-depth", default=1, type=int,
                   help="overlap the device with real time: each hop returns the previous "
                        "hop's output (+1 hop of latency); 0 = the synchronous reference loop")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return p


def build_converter(args) -> StreamingConverter:
    dev = resolve_device(args.device)
    ce = load_params_or_init(args.content_encoder_path, "content_encoder", dev)
    pe = load_params_or_init(args.f0_estimator_path, "f0_estimator", dev)
    dec = load_params_or_init(args.decoder_path, "decoder", dev)
    cfg = StreamingConfig(
        chunk=args.chunk,
        buffer_size=args.buffersize,
        f0_rate=args.f0_rate,
        pitch_shift=args.pitch,
        k=args.k,
        alpha=args.alpha,
    )
    # the realtime path decimates the target utterance's frames x4
    # (realtime_inference.py:88)
    tgt = target_matrix(args, ce, dev, decimation=cfg.target_decimation)
    print(f"Loaded {tgt.shape[0]} words.")
    return StreamingConverter(ce, pe, dec, tgt, cfg, world_pitch=args.world_pitch_estimation,
                              pipeline_depth=args.pipeline_depth, device=dev)


def run_file_mode(args) -> np.ndarray:
    conv = build_converter(args)
    wave, sr = read_wav(args.input_wav)
    wave = resample_np(wave, sr, 16000, conv.device)
    wave = wave[0] * (10.0 ** (args.input_gain / 20.0))
    c = args.chunk
    n = wave.shape[0] // c
    outs = [conv.process_chunk(wave[i * c:(i + 1) * c]) for i in range(n)]
    # the pipelined mode returns chunks late: drop the leading silence and
    # drain the hops in flight, so that the file stays hop-aligned
    outs = outs[conv.pipeline_depth:] + conv.flush()
    out = np.concatenate(outs) * (10.0 ** (args.gain / 20.0))
    path = args.output_wav or "streamed.wav"
    write_wav(path, out, 16000)
    print(f"streamed {n} chunks -> {path}")
    return out


def run_live_mode(args) -> None:
    import pyaudio   # the live mode's only dependency; absent, its ImportError stands

    # the devices read at input_sr; the pipeline hops at 16 kHz
    read_chunk = args.chunk
    args.chunk = int(round(args.chunk * 16000 / args.input_sr))
    conv = build_converter(args)
    audio = pyaudio.PyAudio()
    stream_in = audio.open(format=pyaudio.paInt16, rate=args.input_sr, channels=args.inputchannels,
                           input_device_index=args.input, input=True)
    stream_out = audio.open(format=pyaudio.paInt16, rate=args.output_sr,
                            channels=args.outputchannels, output_device_index=args.output,
                            output=True)
    # optional loopback output (realtime_inference.py:40-46, 114-116)
    stream_loop = (
        audio.open(format=pyaudio.paInt16, rate=args.loopback_sr, channels=args.loopbackchannels,
                   output_device_index=args.loopback, output=True)
        if args.loopback != -1 else None
    )
    in_gain = 10.0 ** (args.input_gain / 20.0)
    out_gain = 10.0 ** (args.gain / 20.0)
    print("converting voice...")
    while True:
        x = np.frombuffer(stream_in.read(read_chunk), np.int16).astype(np.float32) / 32768.0
        x = resample_np(x[None], args.input_sr, 16000, conv.device)[0]
        out = conv.process_chunk(x * in_gain) * out_gain
        out = resample_np(out[None], 16000, args.output_sr, conv.device)[0]
        payload = (np.clip(out, -1, 1) * 32767).astype(np.int16).tobytes()
        stream_out.write(payload)
        if stream_loop is not None:
            stream_loop.write(payload)


def main(argv=None):
    """File mode returns the converted 16 kHz wave; live mode runs until
    interrupted."""
    log_logo()
    args = build_parser().parse_args(argv)
    if args.input_wav:
        return run_file_mode(args)
    run_live_mode(args)


if __name__ == "__main__":
    main()
