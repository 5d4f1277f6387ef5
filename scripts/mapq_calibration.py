"""MAPQ calibration: wrong-call rate by reported MAPQ bin.

The MAPQ table (constants.MAPQ_TABLE, our frozen spec per SURVEY.md
section 7 hard-part 3) had zero validation pressure: on repeat genomes
~0.25% of unique calls are wrong (PERF.md round 4), which downstream WGBS
tooling tolerates ONLY if those calls carry low MAPQ.  This bins simulated
reads by the MAPQ actually emitted and reports the wrong-call rate and
implied phred (-10*log10) per bin -- calibrated means implied phred is
roughly >= the reported MAPQ.

A call is wrong if the read is reported mapped with MAPQ > 0 at a locus
other than the simulated one (accuracy.py correctness rule: true contig,
+-max_errors of the true leftmost coordinate, true strand).

Run: python scripts/mapq_calibration.py --cache <prefix> [--n 32768] [--pe]
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import math

import numpy as np

from bitmapperbs_tpu import constants as K
from bitmapperbs_tpu.config import AlignerConfig
from bitmapperbs_tpu.utils.artifacts import artifacts_dir
from bitmapperbs_tpu.index.build import build_index, load_index, save_index
from bitmapperbs_tpu.index.device import upload_index
from bitmapperbs_tpu.models.host import map_pairs, map_reads
from bitmapperbs_tpu.utils.simulate import (random_genome_fasta,
                                            simulate_pairs, simulate_reads)


def _tally(bins, rec, truth, names, e):
    """truth = (contig, coord, is_reverse)"""
    if rec.flag & K.FLAG_UNMAPPED:
        return
    b = bins.setdefault(rec.mapq, [0, 0])
    b[0] += 1
    contig, coord, is_rev = truth
    ok = (rec.rname == names[contig]
          and abs((rec.pos - 1) - coord) <= e
          and bool(rec.flag & K.FLAG_REVERSE) == is_rev)
    b[1] += not ok


def report(bins, label):
    print(f"\n{label}: wrong-call rate by reported MAPQ")
    print(f"{'mapq':>5} {'calls':>8} {'wrong':>6} {'rate':>9} {'phred':>6}")
    out = {}
    for q in sorted(bins):
        n, wrong = bins[q]
        rate = wrong / n if n else 0.0
        phred = (-10 * math.log10(rate)) if wrong else float("inf")
        ph = f"{phred:6.1f}" if wrong else "   inf"
        print(f"{q:>5} {n:>8} {wrong:>6} {rate:>9.5f} {ph}")
        out[q] = {"calls": n, "wrong": wrong, "rate": round(rate, 6)}
    hi = [(q, b) for q, b in bins.items() if q >= 20]
    n_hi = sum(b[0] for _, b in hi)
    w_hi = sum(b[1] for _, b in hi)
    print(f"MAPQ>=20: {w_hi}/{n_hi} wrong "
          f"({w_hi / max(n_hi, 1):.6f})")
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=32768)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--cache", default=None,
                    help="index artifact prefix (e.g. artifacts/idx_3g_rep_r4)")
    ap.add_argument("--genome-bp", type=int, default=2_000_000,
                    help="toy-genome size when no --cache is given")
    ap.add_argument("--read-len", type=int, default=90)
    ap.add_argument("--pe", action="store_true")
    ap.add_argument("--json", default=None, help="also dump bins as JSON")
    ap.add_argument("--overflow-split", action="store_true",
                    help="SE only: cross-tab wrong calls by the per-read "
                         "candidate-overflow flag (is the cap-42 residual "
                         "concentrated in overflowed reads?)")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")

    if args.cache:
        idx = load_index(args.cache)
    else:
        cache = os.path.join(artifacts_dir(), f"acc_idx_{args.genome_bp}")
        if os.path.exists(cache + ".json"):
            idx = load_index(cache)
        else:
            rng = np.random.default_rng(0)
            idx = build_index(random_genome_fasta(
                rng, contigs=(args.genome_bp // 2, args.genome_bp // 2)))
            save_index(idx, cache)
    dix = upload_index(idx)

    cfg = AlignerConfig(max_errors=4, indels=True, read_len_bucket=96,
                        batch_size=args.batch, paired=args.pe)
    from bitmapperbs_tpu.cli import autotune_for_genome
    cfg = autotune_for_genome(cfg, argparse.Namespace(),
                              int(sum(idx.genome.lengths)))
    e = cfg.max_errors
    names = idx.genome.names
    bins = {}

    if args.pe:
        cfg = cfg.replace(min_insert=0, max_insert=500)
        done = 0
        while done < args.n:
            m = min(args.batch * 4, args.n - done)
            pairs = simulate_pairs(idx.genome, m, read_len=args.read_len,
                                   seed=500 + done, sub_rate=0.01,
                                   indel_rate=0.005, min_insert=150,
                                   max_insert=480)
            recs = map_pairs(idx, dix, cfg,
                                    [(p[0].codes, p[1].codes) for p in pairs])
            for p, i in zip(pairs, range(0, len(recs), 2)):
                for mate, rec in ((p[0], recs[i]), (p[1], recs[i + 1])):
                    _tally(bins, rec,
                           (mate.contig, mate.coord, mate.is_reverse),
                           names, e)
            done += m
        out = report(bins, f"PE n={2 * args.n}")
    else:
        ovf_bins = {}   # (mapq, overflowed) -> [calls, wrong]
        done = 0
        while done < args.n:
            m = min(args.batch * 4, args.n - done)
            sims = simulate_reads(idx.genome, m, read_len=args.read_len,
                                  seed=500 + done, sub_rate=0.01,
                                  indel_rate=0.005)
            recs = map_reads(idx, dix, cfg, [s.codes for s in sims],
                                 [s.qual for s in sims])
            ovf = np.zeros(m, bool)
            if args.overflow_split:
                import jax.numpy as jnp
                from bitmapperbs_tpu.models.aligner import map_batch_device
                from bitmapperbs_tpu.models.host import prepare_batch
                for lo in range(0, m, args.batch):
                    chunk = sims[lo:lo + args.batch]
                    a, ln = prepare_batch([s.codes for s in chunk],
                                          cfg.read_len_bucket, args.batch)
                    o = map_batch_device(dix, cfg, jnp.asarray(a),
                                         jnp.asarray(ln))
                    ovf[lo:lo + len(chunk)] = np.asarray(
                        o["overflow"])[:len(chunk)]
            for s, rec, ov in zip(sims, recs, ovf):
                _tally(bins, rec, (s.contig, s.coord, s.is_reverse),
                       names, e)
                if args.overflow_split and not rec.flag & K.FLAG_UNMAPPED:
                    b = ovf_bins.setdefault((rec.mapq, bool(ov)), [0, 0])
                    b[0] += 1
                    ok = (rec.rname == names[s.contig]
                          and abs((rec.pos - 1) - s.coord) <= e
                          and bool(rec.flag & K.FLAG_REVERSE)
                          == s.is_reverse)
                    b[1] += not ok
            done += m
        out = report(bins, f"SE n={args.n}")
        if args.overflow_split:
            print("\ncross-tab (mapq, overflowed) -> calls wrong:")
            for key in sorted(ovf_bins):
                n_c, w = ovf_bins[key]
                print(f"  mapq={key[0]:>2} ovf={int(key[1])}: "
                      f"{n_c:>7} {w:>5}  ({w / n_c:.5f})")

    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
