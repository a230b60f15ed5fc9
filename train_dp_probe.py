"""Probe of chip_smoke.py's data-parallel training check (phase 8, step 6),
on one CUDA card: ``python3 train_dp_probe.py [--seeds N]``.

``dp_gan_grads`` runs on 2 gloo ranks on the one card (batch 2 each, 38 400
samples, full width, TF32 off), over N batches (seeds 30, 40, ... from
chip_smoke's SEED).  Against each batch's ranks the main process computes
two references:

  * "per-half": chip_smoke's ``dp_reference`` (each half through
    ``gan_grads``, the roll's row from the other half's own content, as the
    rank computes it), twice, to show its run-to-run spread in one process;
  * "whole-batch row": the same, but the roll's row taken from the content
    encoder run over the whole batch of 4, a row that differs from the
    rank's own by float rounding (1.7e-6 to 7.6e-6 abs on an H100): it
    shows how far the gate sits above such a difference.

For each reference and each model it prints the worst tensor's relative
error (max |dp - ref| / max |ref| of the tensor, chip_smoke's metric), its
name and its largest |gradient|; and, for each half, how far the two forms'
roll rows lie apart and how many of the first item's frames match other
neighbours with one row than with the other.  The last line is a JSON
object of every reading.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import sys
import tempfile
import time

import chip_smoke as cs

RANKS = cs.TRAIN_RANKS


def batch(seed: int):
    import torch
    from alivevc_tpu_torch.train.gan import gan_draws

    wave, _ = cs.train_batch(2 * RANKS, cs.TRAIN_LEN, seed)
    amp, jitter = gan_draws(2 * RANKS, torch.Generator().manual_seed(seed + 1), cs.DEV)
    return wave, amp, jitter


def rank_main(rank: int, tmp: str, seeds) -> None:
    import torch
    import torch.distributed as dist
    from alivevc_tpu_torch.parallel import init_distributed
    from alivevc_tpu_torch.train.gan import dp_gan_grads, init_gan

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_distributed("gloo", f"file://{tmp}/rendezvous", RANKS, rank)
    try:
        ce, f0m, dec, disc = cs.train_models()
        out = []
        for seed in seeds:
            wave, amp, jitter = batch(seed)
            sl = slice(2 * rank, 2 * rank + 2)
            g, d, _ = dp_gan_grads(init_gan(dec, disc), ce, f0m, wave[sl], amp[sl], jitter)
            out.append({"g": [x.cpu() for x in g], "d": [x.cpu() for x in d]})
        torch.cuda.synchronize()
        if rank == 0:
            torch.save(out, os.path.join(tmp, "probe0.pt"))
    finally:
        dist.destroy_process_group()


def whole_batch_reference(ce, f0m, dec, disc, wave, amp, jitter):
    """The dp semantics with each roll row taken from the whole batch's
    content; also the roll rows of both forms."""
    import torch
    from alivevc_tpu_torch.train.gan import frozen_features, gan_grads, init_gan

    st = init_gan(dec, disc)
    half = wave.shape[0] // RANKS
    parts = [slice(half * j, half * (j + 1)) for j in range(RANKS)]
    whole = frozen_features(ce, f0m, wave * amp)[0]
    rows_whole = [whole[sl][-1:] for sl in parts]
    rows_half = [frozen_features(ce, f0m, wave[sl] * amp[sl])[0][-1:] for sl in parts]
    shards = [gan_grads(st, ce, f0m, wave[sl], amp[sl], jitter,
                        roll=lambda c, prev=rows_whole[j - 1]: torch.cat([prev, c[:-1]]))
              for j, sl in enumerate(parts)]
    mean_g = [sum(s[0][i] for s in shards) / RANKS for i in range(len(shards[0][0]))]
    mean_d = [sum(s[1][i] for s in shards) / RANKS for i in range(len(shards[0][1]))]
    return mean_g, mean_d, rows_half, rows_whole, parts


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("train_dp_probe: no CUDA card", file=sys.stderr)
        return 1
    from alivevc_tpu_torch.kernels import _lib
    from alivevc_tpu_torch.ops.knn import match_features
    from alivevc_tpu_torch.train.gan import frozen_features

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    _lib.build_all()
    seeds = [cs.SEED + 30 + 10 * i for i in range(args.seeds)]
    readings = []
    with tempfile.TemporaryDirectory() as tmp:
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=rank_main, args=(r, tmp, seeds)) for r in range(RANKS)]
        for p in procs:
            p.start()
        try:
            ce, f0m, dec, disc = cs.train_models()
            names = {"G": [k for k, _ in dec.named_parameters()],
                     "D": [k for k, _ in disc.named_parameters()]}
            refs = []
            for seed in seeds:
                wave, amp, jitter = batch(seed)
                a1 = cs.dp_reference(ce, f0m, dec, disc, wave, amp, jitter)[:2]
                a2 = cs.dp_reference(ce, f0m, dec, disc, wave, amp, jitter)[:2]
                bg, bd, rows_half, rows_whole, parts = whole_batch_reference(
                    ce, f0m, dec, disc, wave, amp, jitter)
                flips = []
                for j, sl in enumerate(parts):
                    first = frozen_features(ce, f0m, wave[sl] * amp[sl])[0][:1]
                    m_half = match_features(first, rows_half[j - 1])
                    m_whole = match_features(first, rows_whole[j - 1])
                    frames = (m_half - m_whole).abs().amax(dim=-1)
                    rows_apart = (rows_half[j - 1] - rows_whole[j - 1]).abs().max()
                    flips.append({"row_max_abs_diff": float(rows_apart),
                                  "frames": int(frames.numel()),
                                  "frames_other_neighbours": int((frames > 1e-3).sum()),
                                  "matched_max_abs_diff": float(frames.max())})
                refs.append((a1, a2, (bg, bd), flips))
            for p in procs:
                p.join(600)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(30)
        if any(p.exitcode != 0 for p in procs):
            print(f"train_dp_probe: ranks failed {[p.exitcode for p in procs]}", file=sys.stderr)
            return 1
        got = torch.load(os.path.join(tmp, "probe0.pt"), weights_only=False)
    for seed, ranks, (a1, a2, b, flips) in zip(seeds, got, refs):
        r = {"seed": seed, "roll_rows": flips}
        for label, ref in (("per_half", a1), ("per_half_again", a2), ("whole_batch_row", b)):
            r[label] = {m: cs.worst_tensor(names[m], [x.to(cs.DEV) for x in ranks[key]], ref[i])
                        for i, (m, key) in enumerate((("G", "g"), ("D", "d")))}
        r["per_half_vs_again"] = {m: cs.worst_tensor(names[m], a2[i], a1[i])
                                  for i, m in enumerate(("G", "D"))}
        readings.append(r)
        print(f"seed {seed} [{card}]:")
        for label in ("per_half", "per_half_again", "whole_batch_row", "per_half_vs_again"):
            print("  " + label + ": " + "; ".join(
                f"{m} {v['rel_err']:.3e} at {v['tensor']} (max |grad| {v['max_abs_grad']:.3e})"
                for m, v in r[label].items()))
        for j, f in enumerate(flips):
            print(f"  half {j}: roll rows {f['row_max_abs_diff']:.3e} apart; "
                  f"{f['frames_other_neighbours']} of {f['frames']} frames of its first item match "
                  f"other neighbours (matched features up to {f['matched_max_abs_diff']:.3e} apart)")
    print(card)
    print(json.dumps({"card": card, "readings": readings}))
    return 0


if __name__ == "__main__":
    t0 = time.perf_counter()
    rc = main()
    print(f"train_dp_probe: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    sys.exit(rc)
