"""Seed/candidate occupancy study on a cached index.

Re-runs the round-3 PERF.md occupancy methodology (hardware-independent
COUNTS via the oracle's frozen seeding, host CPU only) on any artifact --
built for the repeat-structured genomes, where the heavy tail comes from
repeat families instead of 3-letter-alphabet statistics.

Per read and frame it measures, under a given seeding config:
  - per-seed interval sizes (pre/post adaptive extension)
  - seeds dropped by the max_seed_occ frequency threshold
  - locate volume (sum of kept interval sizes) vs locate_budget
  - unique candidate anchors (the flat-buffer occupancy driver) vs Kc
  - overflow flag

plus TRUE-LOCUS SURVIVAL: whether the truth anchor is still among the
(capped) candidates -- the count that predicts recall without running the
full pipeline.

Run: python scripts/occupancy_study.py --cache artifacts/idx_1g_rep
         [--n 2048] [--ext 20,4] [--no-ext] [--kc 128]
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from bitmapperbs_tpu import constants as K
from bitmapperbs_tpu.config import AlignerConfig
from bitmapperbs_tpu.index import packed
from bitmapperbs_tpu.index.build import load_index
from bitmapperbs_tpu.oracle.pipeline import se_frames, seed_slices
from bitmapperbs_tpu.utils import dna
from bitmapperbs_tpu.utils.simulate import simulate_reads


def study_read(idx, cfg, read, truth_fwd):
    """One read -> occupancy stats dict (mirrors oracle collect_candidates
    step by step, but records the intermediate counts)."""
    m = len(read)
    L = idx.genome.length
    frame_reads = {K.PAT_CT: read, K.PAT_GA: dna.revcomp(read)}
    tot_anchors = 0
    tot_drop = 0
    tot_locate = 0
    overflow = False
    true_alive = False
    for p, b in se_frames(cfg):
        pat = dna.ct_convert(frame_reads[p])
        block = idx.blocks[b]
        t_anchor = truth_fwd if b == K.BLOCK_FWD else L - truth_fwd - m
        seeds = []
        for si, (start, end) in enumerate(seed_slices(m, cfg.num_seeds)):
            sp, ep = packed.count(block, pat[start:end])
            if cfg.seed_ext_max:
                k = 0
                while (ep - sp > cfg.seed_ext_occ and start > 0
                       and k < cfg.seed_ext_max):
                    nsp, nep = packed.extend_backward(
                        block, np.uint64(sp), np.uint64(ep),
                        int(pat[start - 1]))
                    if nsp >= nep:
                        break
                    sp, ep = int(nsp), int(nep)
                    start -= 1
                    k += 1
            cnt = ep - sp
            if cnt == 0:
                continue
            if cnt > cfg.max_seed_occ:
                tot_drop += 1
                overflow = True
                continue
            seeds.append((int(cnt), si, int(sp), start))
        entries = []
        for cnt, _, sp, start in sorted(seeds):
            entries.extend((sp + k, start) for k in range(cnt))
        tot_locate += len(entries)
        if len(entries) > cfg.locate_budget:
            entries = entries[:cfg.locate_budget]
            overflow = True
        anchors = set()
        if entries:
            tps = packed.locate(block, np.array([r for r, _ in entries]))
            for tp, (_, start) in zip(tps.astype(np.int64), entries):
                a = int(tp) - start
                if 0 <= a <= block.n - 1 - m:
                    anchors.add(a)
        out = sorted(anchors)
        if len(out) > cfg.max_candidates:
            out = out[:cfg.max_candidates]
            overflow = True
        tot_anchors += len(out)
        e = cfg.max_errors
        if any(abs(a - t_anchor) <= e for a in out):
            true_alive = True
    return {"anchors": tot_anchors, "dropped_seeds": tot_drop,
            "locate": tot_locate, "overflow": overflow,
            "true_alive": true_alive}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cache", required=True)
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--ext", default="20,4",
                    help="seed_ext_max,seed_ext_occ (the Gbp auto-tune)")
    ap.add_argument("--no-ext", action="store_true")
    ap.add_argument("--kc", type=int, default=128)
    ap.add_argument("--occ-cap", type=int, default=0,
                    help="max_seed_occ override (0 = config default)")
    ap.add_argument("--lb", type=int, default=0,
                    help="locate_budget override (0 = config default)")
    ap.add_argument("--num-seeds", type=int, default=0)
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--intervals", default=None,
                    help="rep_intervals.npz (scripts/rep_intervals.py): "
                         "also report survival conditioned on how much of "
                         "each read lies inside planted repeats")
    args = ap.parse_args()

    ext_max, ext_occ = ((0, 0) if args.no_ext
                        else tuple(int(x) for x in args.ext.split(",")))
    cfg = AlignerConfig(max_errors=4, indels=True, read_len_bucket=96,
                        batch_size=args.n, seed_ext_max=ext_max,
                        seed_ext_occ=ext_occ, max_candidates=args.kc)
    if args.occ_cap:
        cfg = cfg.replace(max_seed_occ=args.occ_cap)
    if args.lb:
        cfg = cfg.replace(locate_budget=args.lb)
    if args.num_seeds:
        cfg = cfg.replace(num_seeds=args.num_seeds)
    idx = load_index(args.cache)
    gbp = sum(idx.genome.lengths) / 1e9
    sims = simulate_reads(idx.genome, args.n, read_len=90, seed=args.seed,
                          sub_rate=0.01, indel_rate=0.005)
    rows = []
    for s in sims:
        t = int(idx.genome.offsets[s.contig]) + s.coord
        rows.append(study_read(idx, cfg, s.codes, t))
    anc = np.array([r["anchors"] for r in rows])
    loc = np.array([r["locate"] for r in rows])
    drp = np.array([r["dropped_seeds"] for r in rows])
    ovf = np.array([r["overflow"] for r in rows])
    alive = np.array([r["true_alive"] for r in rows])
    print(f"cache={args.cache} ({gbp:.2f} Gbp) n={args.n} "
          f"ext={ext_max}/{ext_occ} Kc={args.kc} "
          f"O={cfg.max_seed_occ} LB={cfg.locate_budget}")
    print(f"  occupancy/read  mean {anc.mean():7.1f}  p50 "
          f"{np.percentile(anc, 50):6.0f}  p99 {np.percentile(anc, 99):6.0f}"
          f"  max {anc.max()}")
    print(f"  locate vol/read mean {loc.mean():7.1f}  p99 "
          f"{np.percentile(loc, 99):6.0f}")
    print(f"  dropped heavy seeds/read mean {drp.mean():5.2f}   "
          f"overflow reads {ovf.mean():.3f}")
    print(f"  true-locus survival {alive.mean():.4f}  "
          f"(upper bound on seeding recall)")

    if args.intervals:
        iv = np.load(args.intervals)
        u_s, u_e = iv["union_starts"], iv["union_ends"]
        # total overlap of [t, t+m) with the disjoint sorted union
        t0 = np.array([int(idx.genome.offsets[s.contig]) + s.coord
                       for s in sims], dtype=np.int64)
        t1 = t0 + np.array([len(s.codes) for s in sims], dtype=np.int64)
        lo = np.searchsorted(u_e, t0, side="right")
        hi = np.searchsorted(u_s, t1, side="left")
        ov = np.zeros(len(sims), dtype=np.int64)
        for i in range(len(sims)):
            if hi[i] > lo[i]:
                ov[i] = np.minimum(u_e[lo[i]:hi[i]], t1[i]).sum() - \
                        np.maximum(u_s[lo[i]:hi[i]], t0[i]).sum()
        frac = ov / (t1 - t0)
        for name, m in (("outside repeats      ", frac == 0),
                        ("partial (<80% inside)",
                         (frac > 0) & (frac < 0.8)),
                        ("inside repeat (>=80%)", frac >= 0.8)):
            if m.any():
                print(f"  survival {name}: {alive[m].mean():.4f}  "
                      f"(n={int(m.sum())})")


if __name__ == "__main__":
    main()
