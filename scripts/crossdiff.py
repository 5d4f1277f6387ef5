"""Large-scale differential verification harness (SURVEY.md section 4:
scale-proof golden verification).

The NumPy oracle runs ~20 reads/s, so golden SAM differentials cap out at
~10^2 reads.  This harness scales correctness checking to 10^5+ reads at
100 Mbp+ genomes in minutes by layering:

1. device cross-diff: every read mapped by BOTH device pipelines --
   compact (production) and dense (the spec implementation) -- and all
   output tuples compared bitwise.  Any mismatch localizes to a read and
   fails loudly.  This is exactly the invariant the gdrop fallback relies
   on (CLAUDE.md: compact must be bit-identical to dense except
   flat-buffer overflow).
2. batch-split invariance: the same reads mapped again with a different
   batch partition must produce identical tuples (order-free selection).
3. oracle sampling: a random subsample is taken through the full NumPy
   oracle to SAM lines and compared byte-for-byte against the device
   path's SAM (host finalize is shared, so this checks the tuples AND the
   finalize glue end-to-end).

Usage: python scripts/crossdiff.py [--n 100000] [--genome-bp 100000000]
       [--oracle-sample 200] [--pe] [--seed 0]
`--pe` runs the same three layers over the paired-end pipeline (pair join,
second-best, mate rescue tuples; oracle sample through map_batch_pe) --
the PE path has the most host-assembly surface, so it gets its own sweep.
Exit code 0 = all layers clean.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

import jax
import jax.numpy as jnp


def _as_np(out):
    return {k: (np.asarray(v) if not isinstance(v, dict)
                else {kk: np.asarray(vv) for kk, vv in v.items()})
            for k, v in out.items()}


def _flatten(out, pre=""):
    """Nested device-output dict -> flat {dotted.key: np.ndarray}."""
    flat = {}
    for k, v in out.items():
        if isinstance(v, dict):
            flat.update(_flatten(v, pre + k + "."))
        else:
            flat[pre + k] = np.asarray(v)
    return flat


def _diff(a, b, keys, label, where=""):
    bad = []
    for k in keys:
        if isinstance(a[k], dict):
            bad += _diff(a[k], b[k], a[k].keys(), label, where + k + ".")
            continue
        neq = np.flatnonzero(a[k] != b[k])
        if len(neq):
            bad.append((where + k, neq[:5], a[k][neq[:3]], b[k][neq[:3]]))
    return bad


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--genome-bp", type=int, default=100_000_000)
    ap.add_argument("--oracle-sample", type=int, default=200)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--read-len", type=int, default=90)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--pe", action="store_true")
    ap.add_argument("--pbat", action="store_true",
                    help="non-directional mode: 4-frame simulated reads, "
                         "PBAT pattern planes (SE layers only)")
    ap.add_argument("--flat-cap", type=int, default=0,
                    help="override the adaptive flat cap (small values make "
                         "the gdrop->dense fallback fire, exercising the "
                         "host fallback + overflow accounting end to end)")
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend")
    ap.add_argument("--cache", default=None,
                    help="explicit index artifact prefix (e.g. the 3.08 Gbp "
                         "artifacts/idx_3g); the Gbp auto-tune is applied")
    args = ap.parse_args()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from bitmapperbs_tpu.config import AlignerConfig
    from bitmapperbs_tpu.index.build import build_index, load_index, save_index
    from bitmapperbs_tpu.index.device import upload_index
    from bitmapperbs_tpu.models.aligner import map_batch_device
    from bitmapperbs_tpu.models.host import map_reads, prepare_batch
    from bitmapperbs_tpu.utils.simulate import (random_genome_fasta,
                                                simulate_reads_bulk)

    from bitmapperbs_tpu.utils.artifacts import artifacts_dir, find_artifact
    if args.cache:
        cache = args.cache
    else:
        name = {100_000_000: "idx_100m",
                10_000_000: "profile_idx_10m"}.get(args.genome_bp)
        cache = find_artifact(name) if name else None
        if cache is None and name:
            cache = os.path.join(artifacts_dir(), name)   # build + save
    if cache and os.path.exists(cache + ".json"):
        idx = load_index(cache)
    else:
        rng = np.random.default_rng(7)
        idx = build_index(random_genome_fasta(
            rng, contigs=(args.genome_bp // 2, args.genome_bp // 2)))
        if cache:
            save_index(idx, cache)
    dix = upload_index(idx)
    B = args.batch
    cfg = AlignerConfig(max_errors=4, indels=True, read_len_bucket=96,
                        batch_size=B, non_directional=args.pbat,
                        locate_flat_cap=args.flat_cap or 0)
    if sum(idx.genome.lengths) > 512_000_000:
        # Gbp auto-tune (cli.autotune_for_genome; PERF.md round-3 study;
        # PBAT additionally gets the 192-slot/3-chunk flat buffer)
        cfg = cfg.replace(seed_ext_max=20, seed_ext_occ=4,
                          max_candidates=128)
        if args.pbat and not args.flat_cap:
            cfg = cfg.replace(locate_flat_cap=192, flat_chunks=3)
        print(f"[crossdiff] {sum(idx.genome.lengths)/1e9:.2f} Gbp cache: "
              "applied Gbp auto-tune (seed-ext 20/4, Kc128)", flush=True)
    keys = ("best_score", "best_bp", "best_anchor", "second_score",
            "overflow", "gdrop")

    if args.pe:
        return pe_crossdiff(args, idx, dix, cfg)

    protos = (("OT", "OB", "CTOT", "CTOB") if args.pbat else ("OT", "OB"))
    codes, ci, coord, si = simulate_reads_bulk(
        idx.genome, args.n, read_len=args.read_len, seed=args.seed,
        sub_rate=0.01, protocols=protos)
    lengths = np.full(args.n, args.read_len, np.int32)

    # ---- layer 1: compact vs dense, full corpus ---------------------------
    t0 = time.time()
    n_bad = n_gdrop = 0
    halves = []       # for layer 2: remap with a shifted batch split
    for lo in range(0, args.n, B):
        arr = np.full((B, 96), 4, np.uint8)
        m = min(B, args.n - lo)
        arr[:m, :args.read_len] = codes[lo:lo + m]
        arr[m:, :] = 0
        ln = np.full(B, args.read_len, np.int32)
        arr_j, ln_j = jnp.asarray(arr), jnp.asarray(ln)
        comp = _as_np(map_batch_device(dix, cfg, arr_j, ln_j))
        dense = _as_np(map_batch_device(dix, cfg.replace(compact=False),
                                        arr_j, ln_j))
        n_gdrop += int(comp["gdrop"].sum())
        ok_lanes = ~comp["gdrop"]   # gdrop lanes are DEFINED to differ
        sel = {k: np.where(ok_lanes, comp[k], dense[k]) for k in keys}
        bad = _diff(sel, dense, keys, "compact-vs-dense")
        for k, at, av, bv in bad:
            print(f"MISMATCH batch@{lo} {k} lanes {at}: {av} vs {bv}")
            n_bad += 1
        halves.append((comp, m, lo))
    print(f"layer1 compact-vs-dense: {args.n} reads, {n_bad} mismatches, "
          f"{n_gdrop} gdrop fallbacks, {time.time()-t0:.0f}s", flush=True)

    # ---- layer 2: batch-split invariance (offset split by B//2) ----------
    t0 = time.time()
    n_bad2 = 0
    full = {k: np.concatenate([h[0][k][:h[1]] for h in halves])
            for k in keys}
    for lo in range(B // 2, args.n, B):
        arr = np.full((B, 96), 4, np.uint8)
        m = min(B, args.n - lo)
        arr[:m, :args.read_len] = codes[lo:lo + m]
        arr[m:, :] = 0
        ln = np.full(B, args.read_len, np.int32)
        comp = _as_np(map_batch_device(dix, cfg, jnp.asarray(arr),
                                       jnp.asarray(ln)))
        ok = ~(comp["gdrop"][:m] | full["gdrop"][lo:lo + m])
        for k in ("best_score", "best_bp", "best_anchor", "second_score"):
            neq = np.flatnonzero(ok & (comp[k][:m] != full[k][lo:lo + m]))
            if len(neq):
                print(f"SPLIT-MISMATCH @{lo} {k} lanes {neq[:5]}")
                n_bad2 += 1
    print(f"layer2 batch-split invariance: {n_bad2} mismatches, "
          f"{time.time()-t0:.0f}s", flush=True)

    # ---- layer 3: oracle SAM sampling -------------------------------------
    t0 = time.time()
    from bitmapperbs_tpu.oracle.pipeline import map_batch_se
    sub = np.random.default_rng(args.seed + 1).choice(
        args.n, size=min(args.oracle_sample, args.n), replace=False)
    sub_reads = [codes[i] for i in sub]
    qn = [f"s{i}" for i in sub]
    quals = ["I" * args.read_len for _ in sub]
    ocfg = cfg.replace(batch_size=len(sub))
    oracle_sam = [r.line() for r in map_batch_se(idx, ocfg, sub_reads,
                                                 quals, qn)]
    device_sam = [r.line() for r in map_reads(idx, dix, ocfg, sub_reads,
                                                  quals, qn)]
    n_bad3 = sum(1 for a, b in zip(oracle_sam, device_sam) if a != b)
    for a, b in zip(oracle_sam, device_sam):
        if a != b:
            print(f"ORACLE-MISMATCH:\n  oracle: {a}\n  device: {b}")
    print(f"layer3 oracle SAM sample ({len(sub)} reads): {n_bad3} "
          f"mismatches, {time.time()-t0:.0f}s", flush=True)

    total_bad = n_bad + n_bad2 + n_bad3
    print("CLEAN" if total_bad == 0 else f"FAILED: {total_bad} mismatches")
    return 1 if total_bad else 0


def pe_crossdiff(args, idx, dix, cfg):
    """The same three layers over the paired-end pipeline."""
    from bitmapperbs_tpu.models.host import map_pairs, prepare_batch
    from bitmapperbs_tpu.models.paired import map_batch_pe_device
    from bitmapperbs_tpu.oracle.paired import map_batch_pe
    from bitmapperbs_tpu.utils.simulate import simulate_pairs

    B = args.batch
    cfg = cfg.replace(paired=True, min_insert=0, max_insert=500)
    rl = args.read_len

    t0 = time.time()
    prs = simulate_pairs(idx.genome, args.n, read_len=rl, seed=args.seed,
                         sub_rate=0.01, min_insert=150, max_insert=480)
    prs = (prs * args.n)[:args.n]   # tight contigs may skip a few
    pairs = [(p[0].codes, p[1].codes) for p in prs]
    print(f"simulated {len(pairs)} pairs in {time.time()-t0:.0f}s",
          flush=True)

    def run_batch(lo, run_cfg):
        m = min(B, args.n - lo)
        a1, l1 = prepare_batch([p[0] for p in pairs[lo:lo + m]], 96, B)
        a2, l2 = prepare_batch([p[1] for p in pairs[lo:lo + m]], 96, B)
        out = map_batch_pe_device(dix, run_cfg,
                                  jnp.asarray(a1), jnp.asarray(l1),
                                  jnp.asarray(a2), jnp.asarray(l2))
        return _flatten(out), m

    # ---- layer 1: compact vs dense, all pair/rescue/SE tuples -------------
    t0 = time.time()
    n_bad = n_gdrop = 0
    kept = []                       # (flat_out, m) per batch for layer 2
    for lo in range(0, args.n, B):
        comp, m = run_batch(lo, cfg)
        dense, _ = run_batch(lo, cfg.replace(compact=False))
        gdrop = comp["gdrop"]
        n_gdrop += int(gdrop[:m].sum())
        for k, a in comp.items():
            ok = ~gdrop.reshape((len(gdrop),) + (1,) * (a.ndim - 1))
            neq = np.flatnonzero((np.where(ok, a, dense[k]) != dense[k])
                                 .reshape(len(gdrop), -1).any(axis=1))
            if len(neq):
                print(f"PE MISMATCH batch@{lo} {k} lanes {neq[:5]}")
                n_bad += 1
        kept.append((comp, m))
    print(f"layer1 PE compact-vs-dense: {args.n} pairs, {n_bad} mismatches, "
          f"{n_gdrop} gdrop fallbacks, {time.time()-t0:.0f}s", flush=True)

    # ---- layer 2: batch-split invariance ----------------------------------
    t0 = time.time()
    n_bad2 = 0
    sel_keys = [k for k in kept[0][0]
                if k.startswith(("pair_", "resc_", "se1.best", "se1.second",
                                 "se2.best", "se2.second"))]
    full = {k: np.concatenate([h[0][k][:h[1]] for h in kept])
            for k in sel_keys + ["gdrop"]}
    for lo in range(B // 2, args.n, B):
        comp, m = run_batch(lo, cfg)
        ok = ~(comp["gdrop"][:m] | full["gdrop"][lo:lo + m])
        for k in sel_keys:
            neq = np.flatnonzero(ok & (comp[k][:m] != full[k][lo:lo + m]))
            if len(neq):
                print(f"PE SPLIT-MISMATCH @{lo} {k} lanes {neq[:5]}")
                n_bad2 += 1
    print(f"layer2 PE batch-split invariance: {n_bad2} mismatches, "
          f"{time.time()-t0:.0f}s", flush=True)

    # ---- layer 3: oracle SAM sampling --------------------------------------
    t0 = time.time()
    sub = np.random.default_rng(args.seed + 1).choice(
        args.n, size=min(args.oracle_sample, args.n), replace=False)
    sub_pairs = [pairs[i] for i in sub]
    qn = [f"p{i}" for i in sub]
    ocfg = cfg.replace(batch_size=min(B, len(sub)))
    oracle_sam = [r.line() for r in map_batch_pe(idx, ocfg, sub_pairs,
                                                 qnames=qn)]
    device_sam = [r.line() for r in map_pairs(idx, dix, ocfg,
                                                     sub_pairs, qnames=qn)]
    n_bad3 = sum(1 for a, b in zip(oracle_sam, device_sam) if a != b)
    for a, b in zip(oracle_sam, device_sam):
        if a != b:
            print(f"PE ORACLE-MISMATCH:\n  oracle: {a}\n  device: {b}")
    print(f"layer3 PE oracle SAM sample ({len(sub)} pairs): {n_bad3} "
          f"mismatches, {time.time()-t0:.0f}s", flush=True)

    total_bad = n_bad + n_bad2 + n_bad3
    print("CLEAN" if total_bad == 0 else f"FAILED: {total_bad} mismatches")
    return 1 if total_bad else 0


if __name__ == "__main__":
    sys.exit(main())
