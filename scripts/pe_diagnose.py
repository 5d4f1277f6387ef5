"""Classify non-proper pairs at scale.

At 3.08 Gbp the proper-pair rate (0.977) sits below SE recall (0.989).
This script answers WHY, pair by pair, against simulated truth:

  1. branch each pair took (models/pool._decide_pair: pair / resc / disc)
     -- note human_bench's "proper" line counts only the on-device join
     (`pair_valid`); rescued pairs ALSO emit FLAG_PROPER in SAM, so the
     first output here is the honest proper rate.
  2. for each non-proper pair, per-mate TRUE ALIGNABILITY at the truth
     locus: the frozen score (asym Hamming fast path, else banded
     semi-global edit distance, oracle/pipeline.score_candidate) evaluated
     AT the simulated coordinate, min over the mate's frames.  A mate with
     true score > e is unmappable BY SPEC (the error model draws >e-edit
     reads ~1% of the time); a pair containing one is not a pipeline miss.
  3. the residue -- both mates alignable yet no proper pair -- is the real
     deficit, sub-classified by what the SE stage and rescue did.

Run: python scripts/pe_diagnose.py [--cache PREFIX] [--n 4096]
"""
from __future__ import annotations

import argparse
import collections
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from bitmapperbs_tpu import constants as K
from bitmapperbs_tpu.config import AlignerConfig
from bitmapperbs_tpu.index.build import load_index
from bitmapperbs_tpu.oracle import align
from bitmapperbs_tpu.oracle.pipeline import frame_slice, se_frames
from bitmapperbs_tpu.utils import dna
from bitmapperbs_tpu.utils.artifacts import find_artifact
from bitmapperbs_tpu.utils.simulate import simulate_pairs


def true_score(genome_codes, rc_ref, cfg, read, mate, fwd_pos):
    """Frozen candidate score at the truth locus, min over the mate's
    frames (mirrors oracle score_candidate; window [a-e, m+2e))."""
    m = len(read)
    e = cfg.max_errors
    L = len(genome_codes)
    best = 10**9
    frame_reads = {K.PAT_CT: read, K.PAT_GA: dna.revcomp(read)}
    for p, b in se_frames(cfg, mate=mate):
        fr = frame_reads[p]
        frame_ref = genome_codes if b == K.BLOCK_FWD else rc_ref
        a0 = fwd_pos if b == K.BLOCK_FWD else L - fwd_pos - m
        # true leftmost coord can shift by up to e under indels: scan the
        # +-e anchor neighbourhood exactly like the accuracy criterion
        for a in range(a0 - e, a0 + e + 1):
            if a < 0 or a + m > L:
                continue
            ham = align.hamming(frame_slice(frame_ref, a, m), fr)
            if ham <= e:
                return int(ham)
            if cfg.indels:
                win = frame_slice(frame_ref, a - e, m + 2 * e)
                best = min(best, align.edit_distance(win, fr))
                if best <= e:
                    return int(best)
    return int(best)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cache", default=None)
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--seed", type=int, default=2)
    args = ap.parse_args()

    import jax.numpy as jnp

    from bitmapperbs_tpu.index.device import upload_index
    from bitmapperbs_tpu.models.host import prepare_batch
    from bitmapperbs_tpu.models.paired import map_batch_pe_device
    from bitmapperbs_tpu.models.pool import _decide_pair, _se_hit_from

    cache = args.cache or find_artifact("idx_3g")
    idx = load_index(cache)
    L = idx.genome.length
    rc_ref = dna.revcomp(np.asarray(idx.genome.codes))

    n = args.n
    cfg = AlignerConfig(max_errors=4, indels=True, read_len_bucket=96,
                        batch_size=n, paired=True, min_insert=0,
                        max_insert=500, seed_ext_max=20, seed_ext_occ=4,
                        max_candidates=128)
    prs = simulate_pairs(idx.genome, n, read_len=90, seed=args.seed,
                         sub_rate=0.01, indel_rate=0.005,
                         min_insert=150, max_insert=480)
    prs = (prs * n)[:n]
    a1, l1 = prepare_batch([p[0].codes for p in prs], 96, n)
    a2, l2 = prepare_batch([p[1].codes for p in prs], 96, n)

    dix = upload_index(idx)
    out = map_batch_pe_device(dix, cfg, jnp.asarray(a1), jnp.asarray(l1),
                              jnp.asarray(a2), jnp.asarray(l2))
    host = {k: (np.asarray(v) if not isinstance(v, dict) else
                {k2: np.asarray(v2) for k2, v2 in v.items()})
            for k, v in out.items()}

    e = cfg.max_errors
    counts = collections.Counter()
    detail = collections.Counter()
    for i, (s1, s2) in enumerate(prs):
        m1, m2 = len(s1.codes), len(s2.codes)
        branch, h1, h2, _ = _decide_pair(host, i, m1, m2, L)
        t1 = int(idx.genome.offsets[s1.contig]) + s1.coord
        t2 = int(idx.genome.offsets[s2.contig]) + s2.coord

        def ok(h, t):
            return h is not None and abs(int(h.fwd_anchor) - t) <= e

        if branch in ("pair", "resc"):
            if ok(h1, t1) and ok(h2, t2):
                counts[f"proper_correct_{branch}"] += 1
            else:
                counts[f"proper_WRONG_{branch}"] += 1
            continue

        # discordant: why?
        sc1 = true_score(idx.genome.codes, rc_ref, cfg, s1.codes, 0, t1)
        sc2 = true_score(idx.genome.codes, rc_ref, cfg, s2.codes, 1, t2)
        una = (sc1 > e) + (sc2 > e)
        if una:
            counts[f"disc_unalignable_{una}mate"] += 1
            continue
        counts["disc_BOTH_ALIGNABLE"] += 1
        # sub-classify the real misses
        se1b, _ = _se_hit_from(host["se1"], i, m1, L)
        se2b, _ = _se_hit_from(host["se2"], i, m2, L)
        k1 = "ok" if ok(se1b, t1) else ("wrong" if se1b else "none")
        k2 = "ok" if ok(se2b, t2) else ("wrong" if se2b else "none")
        rv = bool(host["resc_valid"][i])
        detail[f"se1={k1} se2={k2} resc_valid={rv}"] += 1

    print(f"n={n} pairs at {sum(idx.genome.lengths)/1e9:.2f} Gbp")
    proper = sum(v for k, v in counts.items() if k.startswith("proper"))
    print(f"honest proper rate (pair+resc branches): {proper}/{n} "
          f"= {proper/n:.4f}   [device-join-only pair_valid: "
          f"{int(host['pair_valid'][:n].sum())}/{n}]")
    for k in sorted(counts):
        print(f"  {k:28s} {counts[k]}")
    if detail:
        print("  -- both-alignable discordant breakdown --")
        for k in sorted(detail):
            print(f"    {k}: {detail[k]}")


if __name__ == "__main__":
    main()
