"""Stage breakdown of the end-to-end SE path.

Replicates bench.py's e2e workload (10 Mbp genome, 16k x 90 bp reads) and
times every host stage of models/host.map_reads separately, then the
stitched pipeline, so the gap between the device rate and the end-to-end
rate decomposes into named line items.

Run: python scripts/profile_e2e.py [--batch 16384] [--iters 4]
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
    ap.add_argument("--batch", type=int, default=16384)
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from bitmapperbs_tpu.config import AlignerConfig
    from bitmapperbs_tpu.index.build import build_index
    from bitmapperbs_tpu.index.device import upload_index
    from bitmapperbs_tpu.models.aligner import map_batch_device
    from bitmapperbs_tpu.models.host import (map_reads, prepare_batch)
    from bitmapperbs_tpu.models import native_finalize
    from bitmapperbs_tpu.models.pool import _finalize_se_task_local
    from bitmapperbs_tpu.utils import dna
    from bitmapperbs_tpu.utils.simulate import (random_genome_fasta,
                                                simulate_reads)

    t_start = time.time()

    def mark(msg):
        print(f"[{time.time() - t_start:6.0f}s] {msg}", flush=True)

    rng = np.random.default_rng(0)
    idx = build_index(random_genome_fasta(rng, contigs=(5_000_000,
                                                        5_000_000)))
    mark("index built")
    dix = upload_index(idx)
    mark("index uploaded")
    bucket, batch = 96, args.batch
    cfg = AlignerConfig(max_errors=4, indels=True, read_len_bucket=bucket,
                        batch_size=batch)

    def mk_reads(seed):
        sims = simulate_reads(idx.genome, batch, read_len=90, seed=seed,
                              sub_rate=0.01, indel_rate=0.005)
        return [s.codes for s in sims]

    reads = mk_reads(1)
    quals = ["I" * len(r) for r in reads]
    qnames = [f"r{i}" for i in range(len(reads))]

    # warm compile
    arr, lengths = prepare_batch(reads, bucket, batch)
    mark("batch prepared; compiling")
    out = map_batch_device(dix, cfg, jnp.asarray(arr), jnp.asarray(lengths))
    np.asarray(out["best_score"])
    mark("warm compile + first run done")

    it = args.iters
    stage = {}

    def tstage(name, fn, n=it):
        t0 = time.perf_counter()
        for _ in range(n):
            r = fn()
        stage[name] = (time.perf_counter() - t0) / n
        return r

    tstage("revcomp_ref", lambda: dna.revcomp(idx.genome.codes))
    rc_ref = dna.revcomp(idx.genome.codes)
    tstage("prepare_batch", lambda: prepare_batch(reads, bucket, batch))
    arr, lengths = prepare_batch(reads, bucket, batch)
    tstage("h2d_asarray", lambda: jnp.asarray(arr).block_until_ready())
    arr_d, len_d = jnp.asarray(arr), jnp.asarray(lengths)

    # device compute alone (distinct batches; materialization sync)
    dev_batches = []
    for i in range(it):
        a_i, l_i = prepare_batch(mk_reads(10 + i), bucket, batch)
        dev_batches.append((jnp.asarray(a_i), jnp.asarray(l_i)))
    t0 = time.perf_counter()
    outs = [map_batch_device(dix, cfg, a, l) for (a, l) in dev_batches]
    for o in outs:
        np.asarray(o["best_score"])
    stage["device_map"] = (time.perf_counter() - t0) / it

    out = map_batch_device(dix, cfg, arr_d, len_d)
    np.asarray(out["best_score"])   # settle
    tstage("gdrop_leaf_fetch", lambda: np.asarray(out["gdrop"]))
    out_np = tstage("device_get", lambda: jax.device_get(out))
    nb = sum(v.nbytes for v in jax.tree.leaves(out_np))
    print(f"device_get payload: {nb / 1e6:.2f} MB", flush=True)

    task = (arr, lengths, len(reads), quals, qnames, out_np)
    have_native = native_finalize.finalize_se_native(
        idx, rc_ref, cfg, arr[:4], lengths[:4], quals[:4], qnames[:4],
        {k: (v[:4] if hasattr(v, "__getitem__") else v)
         for k, v in out_np.items()}) is not None
    print(f"native finalize available: {have_native}", flush=True)
    recs = tstage("finalize_local", lambda: _finalize_se_task_local(
        idx, rc_ref, cfg, task), n=max(1, it // 2))

    # stitched pipeline, distinct read lists
    read_lists = [mk_reads(30 + i) for i in range(it)]
    t0 = time.perf_counter()
    for rl in read_lists:
        map_reads(idx, dix, cfg, rl, quals, qnames)
    stage["e2e_map_reads"] = (time.perf_counter() - t0) / it

    # steady state: ONE call spanning several batches, so the in-flight
    # window (MAX_INFLIGHT) overlaps device compute with host finalize --
    # the production shape (cli feeds whole read chunks through one call)
    nb = 4
    reads_n = [r for rl in read_lists for r in rl][: nb * batch]
    while len(reads_n) < nb * batch:
        reads_n.extend(reads_n[: nb * batch - len(reads_n)])
    quals_n = ["I" * len(r) for r in reads_n]
    qnames_n = [f"s{i}" for i in range(len(reads_n))]
    t0 = time.perf_counter()
    map_reads(idx, dix, cfg, reads_n, quals_n, qnames_n)
    stage[f"e2e_steady_{nb}x"] = (time.perf_counter() - t0) / nb

    print(f"\n=== per-{batch}-read-batch stage times ===")
    for k, v in stage.items():
        print(f"{k:>20}: {v * 1e3:8.1f} ms  ({batch / v:9.0f} reads/s)")
    host_sum = (stage["prepare_batch"] + stage["h2d_asarray"]
                + stage["gdrop_leaf_fetch"] + stage["device_get"]
                + stage["finalize_local"])
    print(f"{'host stages sum':>20}: {host_sum * 1e3:8.1f} ms "
          f"({batch / host_sum:9.0f} reads/s)")
    print(f"{'pipeline bound':>20}: "
          f"{max(host_sum, stage['device_map']) * 1e3:8.1f} ms")


if __name__ == "__main__":
    main()
