"""Accuracy evaluation on simulated reads with known truth (SURVEY.md
section 4 / section 6: precision/recall on simulated WGBS is the de-facto
oracle; the reference's paper validates the same way).

A mapped read is CORRECT if it is placed on the true contig within
+-max_errors of the true leftmost coordinate and on the true strand.
  recall    = correct / simulated
  precision = correct / (uniquely reported, MAPQ > 0)

Run: python scripts/accuracy.py [--pe] [--pbat] [--n 4000]
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from bitmapperbs_tpu import constants as K
from bitmapperbs_tpu.config import AlignerConfig
from bitmapperbs_tpu.utils.artifacts import artifacts_dir
from bitmapperbs_tpu.index.build import build_index, load_index, save_index
from bitmapperbs_tpu.index.device import upload_index
from bitmapperbs_tpu.models.host import map_pairs, map_reads
from bitmapperbs_tpu.utils.simulate import (random_genome_fasta,
                                            simulate_pairs, simulate_reads)


def evaluate_se(idx, dix, cfg, sims):
    recs = map_reads(idx, dix, cfg, [s.codes for s in sims],
                         [s.qual for s in sims])
    e = cfg.max_errors
    correct = reported = unique = 0
    for s, r in zip(sims, recs):
        if r.flag & K.FLAG_UNMAPPED:
            continue
        reported += 1
        if r.mapq == 0:
            continue
        unique += 1
        rev = bool(r.flag & K.FLAG_REVERSE)
        ok = (r.rname == idx.genome.names[s.contig]
              and abs((r.pos - 1) - s.coord) <= e
              and rev == s.is_reverse)
        correct += ok
    return correct, unique, reported, len(sims)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=4000)
    ap.add_argument("--genome-bp", type=int, default=2_000_000)
    ap.add_argument("--cache", default=None,
                    help="index cache prefix to load instead of building "
                         "(e.g. artifacts/idx_3g for the 3.08 Gbp artifact)")
    ap.add_argument("--read-len", type=int, default=90)
    ap.add_argument("--pbat", action="store_true")
    ap.add_argument("--pe", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend")
    args = ap.parse_args()
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    rng = np.random.default_rng(0)
    cache = args.cache or os.path.join(artifacts_dir(),
                                       f"acc_idx_{args.genome_bp}")
    if os.path.exists(cache + ".json"):
        idx = load_index(cache)
    else:
        idx = build_index(random_genome_fasta(
            rng, contigs=(args.genome_bp // 2, args.genome_bp // 2)))
        save_index(idx, cache)
    dix = upload_index(idx)

    protos = ("OT", "OB", "CTOT", "CTOB") if args.pbat else ("OT", "OB")
    cfg = AlignerConfig(max_errors=4, indels=True, read_len_bucket=96,
                        batch_size=args.n, non_directional=args.pbat,
                        paired=args.pe)
    from bitmapperbs_tpu.cli import autotune_for_genome
    cfg = autotune_for_genome(cfg, argparse.Namespace(), 
                              int(sum(idx.genome.lengths)))

    if args.pe:
        pairs = simulate_pairs(idx.genome, args.n, read_len=args.read_len,
                               seed=11, sub_rate=0.01, indel_rate=0.005)
        recs = map_pairs(idx, dix, cfg,
                                [(p[0].codes, p[1].codes) for p in pairs])
        e = cfg.max_errors
        correct = unique = reported = 0
        total = 2 * len(pairs)
        for p, i in zip(pairs, range(0, len(recs), 2)):
            for mate, rec in ((p[0], recs[i]), (p[1], recs[i + 1])):
                if rec.flag & K.FLAG_UNMAPPED:
                    continue
                reported += 1
                if rec.mapq == 0:
                    continue
                unique += 1
                rev = bool(rec.flag & K.FLAG_REVERSE)
                correct += (rec.rname == idx.genome.names[mate.contig]
                            and abs((rec.pos - 1) - mate.coord) <= e
                            and rev == mate.is_reverse)
    else:
        sims = simulate_reads(idx.genome, args.n, read_len=args.read_len,
                              seed=11, sub_rate=0.01, indel_rate=0.005,
                              protocols=protos)
        correct, unique, reported, total = evaluate_se(idx, dix, cfg, sims)

    print(f"simulated={total} reported={reported} unique={unique} "
          f"correct={correct}")
    print(f"recall={correct / total:.4f} "
          f"precision={correct / max(unique, 1):.4f} "
          f"mapped_rate={reported / total:.4f}")


if __name__ == "__main__":
    main()
