"""Human-scale (3.08 Gbp) benchmark + accuracy (BASELINE config 5 scale).

Loads the cached 3.08 Gbp index (artifacts/idx_3g, scripts/build_big.py),
uploads it to the device, and measures:
  - SE throughput at 4k and 16k batches (+ gdrop / overflow rates)
  - PE throughput at 4k pairs
  - accuracy vs simulated truth (recall / precision)
  - optional deeper k-mer table (--klt 15/16): rebuilt post-hoc from the
    packed block (no SA-IS rerun) to measure the seeding-step saving

Run: python scripts/human_bench.py [--cache artifacts/idx_3g] [--klt 15]
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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cache", default=None,
                    help="artifact prefix (default: idx_3g in the "
                         "artifacts dir)")
    ap.add_argument("--klt", type=int, default=0,
                    help="rebuild the k-mer table at this depth first")
    ap.add_argument("--batches", default="4096,16384")
    ap.add_argument("--pe", action="store_true", default=True)
    ap.add_argument("--no-pe", dest="pe", action="store_false")
    ap.add_argument("--pbat", action="store_true", default=True)
    ap.add_argument("--no-pbat", dest="pbat", action="store_false")
    args = ap.parse_args()

    from bitmapperbs_tpu.config import AlignerConfig
    from bitmapperbs_tpu.index.build import build_klt, load_index
    from bitmapperbs_tpu.index.device import upload_index
    from bitmapperbs_tpu.models.aligner import INF, map_batch_device
    from bitmapperbs_tpu.models.host import prepare_batch
    from bitmapperbs_tpu.utils.artifacts import find_artifact
    from bitmapperbs_tpu.utils.simulate import (simulate_pairs,
                                                simulate_reads,
                                                simulate_reads_bulk)

    cache = args.cache or find_artifact("idx_3g")
    if cache is None:
        sys.exit("no idx_3g artifact found (run scripts/build_big.py)")
    t0 = time.time()
    idx = load_index(cache)
    print(f"loaded {sum(idx.genome.lengths)/1e9:.2f} Gbp index in "
          f"{time.time()-t0:.0f}s (sa_rate={idx.blocks[0].sa_rate} "
          f"klt_k={idx.blocks[0].klt_k} {idx.nbytes()/1e9:.2f} GB)",
          flush=True)

    if args.klt:
        t0 = time.time()
        for b in idx.blocks:
            b.klt = build_klt(b, args.klt)
            b.klt_k = args.klt
        print(f"rebuilt KLT at k={args.klt} in {time.time()-t0:.0f}s "
              f"({idx.blocks[0].klt.nbytes * 2 / 1e6:.0f} MB)", flush=True)

    t0 = time.time()
    dix = upload_index(idx)
    jax.block_until_ready(dix.cp_rows)
    print(f"uploaded {dix.nbytes/1e9:.2f} GB to HBM in {time.time()-t0:.0f}s",
          flush=True)
    L = idx.genome.length

    def se_run(batch, sims, label, pbat=False):
        # round-3 Gbp auto-tune (cli.autotune_for_genome; PERF.md study):
        # adaptive seed extension + Kc128 (+ PBAT flat-cap 192/3-chunks)
        cfg = AlignerConfig(max_errors=4, indels=True, read_len_bucket=96,
                            batch_size=batch, seed_ext_max=20,
                            seed_ext_occ=4, max_candidates=128,
                            non_directional=pbat,
                            locate_flat_cap=192 if pbat else 0,
                            flat_chunks=3 if pbat else 1)
        arr, lengths = prepare_batch([s.codes for s in sims], 96, batch)
        arr, lengths = jnp.asarray(arr), jnp.asarray(lengths)
        out = map_batch_device(dix, cfg, arr, lengths)
        np.asarray(out["best_score"])   # warm (materialization sync)
        # TIMING: every timed iteration gets a DISTINCT input batch (no
        # call can be elided) and is synced by materializing one output
        iters = 6
        protos = (("OT", "OB", "CTOT", "CTOB") if pbat else ("OT", "OB"))
        timed = []
        for i in range(iters):
            cb, _, _, _ = simulate_reads_bulk(idx.genome, batch, read_len=90,
                                              seed=100 + i, sub_rate=0.01,
                                              protocols=protos)
            a_i = np.full((batch, 96), 4, np.uint8)
            a_i[:, :90] = cb
            timed.append((jnp.asarray(a_i),
                          jnp.asarray(np.full(batch, 90, np.int32))))
        t0 = time.perf_counter()
        outs = [map_batch_device(dix, cfg, a_i, l_i) for (a_i, l_i) in timed]
        for o in outs:
            np.asarray(o["best_score"])
        dt = (time.perf_counter() - t0) / iters
        bs = np.asarray(out["best_score"])
        ba = np.asarray(out["best_anchor"])
        bp = np.asarray(out["best_bp"])
        lens = np.asarray(lengths)
        mapped = correct = 0
        for i, s in enumerate(sims):
            if bs[i] >= int(INF):
                continue
            mapped += 1
            b = int(bp[i]) >> 1
            a = int(ba[i])
            fwd = a if b == 0 else L - a - int(lens[i])
            true = int(idx.genome.offsets[s.contig]) + s.coord
            correct += abs(fwd - true) <= 4
        print(f"{label}: {batch/dt:.0f} reads/s/chip ({dt*1e3:.1f} ms) "
              f"mapped={mapped}/{len(sims)} correct={correct} "
              f"recall={correct/len(sims):.4f} "
              f"ovf={int(np.asarray(out['overflow']).sum())} "
              f"gdrop={int(np.asarray(out['gdrop']).sum())}", flush=True)

    for batch in (int(b) for b in args.batches.split(",")):
        sims = simulate_reads(idx.genome, batch, read_len=90, seed=1,
                              sub_rate=0.01, indel_rate=0.005)
        sims = (sims * batch)[:batch]
        try:   # sections are independent: an HBM OOM at one batch size
            se_run(batch, sims, f"3.08G SE b={batch}")
        except Exception as err:
            print(f"3.08G SE b={batch} FAILED: {str(err)[:200]}", flush=True)

    if args.pbat:
        batch = 4096
        sims = simulate_reads(idx.genome, batch, read_len=90, seed=4,
                              sub_rate=0.01, indel_rate=0.005,
                              protocols=("OT", "OB", "CTOT", "CTOB"))
        sims = (sims * batch)[:batch]
        try:
            se_run(batch, sims, f"3.08G PBAT b={batch}", pbat=True)
        except Exception as err:
            print(f"3.08G PBAT FAILED: {str(err)[:200]}", flush=True)

    if args.pe:
        from bitmapperbs_tpu.models.paired import map_batch_pe_device
        pe_b = 4096
        cfg = AlignerConfig(max_errors=4, indels=True, read_len_bucket=96,
                            batch_size=pe_b, paired=True, min_insert=0,
                            max_insert=500, seed_ext_max=20, seed_ext_occ=4,
                            max_candidates=128)
        prs = simulate_pairs(idx.genome, pe_b, read_len=90, seed=2,
                             sub_rate=0.01, indel_rate=0.005,
                             min_insert=150, max_insert=480)
        prs = (prs * pe_b)[:pe_b]
        a1, l1 = prepare_batch([p[0].codes for p in prs], 96, pe_b)
        a2, l2 = prepare_batch([p[1].codes for p in prs], 96, pe_b)
        pe_args = tuple(jnp.asarray(x) for x in (a1, l1, a2, l2))
        out = map_batch_pe_device(dix, cfg, *pe_args)
        np.asarray(out["pair_valid"])   # warm (materialization sync)
        timed = []
        for i in range(4):   # distinct batches (timing note in se_run)
            prs_i = simulate_pairs(idx.genome, pe_b, read_len=90,
                                   seed=200 + i, sub_rate=0.01,
                                   indel_rate=0.005, min_insert=150,
                                   max_insert=480)
            prs_i = (prs_i * pe_b)[:pe_b]
            b1, m1 = prepare_batch([p[0].codes for p in prs_i], 96, pe_b)
            b2, m2 = prepare_batch([p[1].codes for p in prs_i], 96, pe_b)
            timed.append(tuple(jnp.asarray(x) for x in (b1, m1, b2, m2)))
        t0 = time.perf_counter()
        outs = [map_batch_pe_device(dix, cfg, *a) for a in timed]
        for o in outs:
            np.asarray(o["pair_valid"])
        dt = (time.perf_counter() - t0) / 4
        pv = np.asarray(out["pair_valid"])
        # honest proper rate: rescue-branch pairs also emit FLAG_PROPER
        # (models/pool._decide_pair; see scripts/pe_diagnose.py)
        n_prop = int((pv | np.asarray(out["resc_valid"])).sum())
        print(f"3.08G PE b={pe_b}: {2*pe_b/dt:.0f} reads/s/chip "
              f"({dt*1e3:.1f} ms) proper={n_prop}/{pe_b} "
              f"(join-only {int(pv.sum())})", flush=True)


if __name__ == "__main__":
    main()
