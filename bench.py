"""Device mapping throughput on one GPU (reads/s per device).

Workload: 10 Mbp random genome, 16,384-read batches of 90 bp simulated
reads (1 % substitutions, 0.5 % indels), e = 4 with indels; paired-end and
end-to-end (map + finalize to SAM records) rates go to stderr.

Prints the card and its power limit on stderr and ONE JSON line on stdout:
{"metric", "value", "unit", "vs_baseline", "device"}.  vs_baseline is the
ratio to this repo's NumPy oracle on the same reads.  Exits 2 unless jax's
platform is gpu: a CPU number is never reported as a device rate.
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np


def _timed(fn, batches) -> float:
    """Seconds per batch: every batch dispatched back to back, then one
    block_until_ready (distinct inputs, so no call can be elided)."""
    import jax

    jax.block_until_ready(fn(*batches[0]))        # compile + warm
    t0 = time.perf_counter()
    jax.block_until_ready([fn(*b) for b in batches[1:]])
    return (time.perf_counter() - t0) / (len(batches) - 1)


def main() -> int:
    import jax

    from bitmapperbs_tpu.utils.profiling import gpu_cards

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.stderr.write(f"[bench] jax platform is {dev.platform!r}, not "
                         f"gpu; no metric emitted\n")
        return 2
    sys.stderr.write(f"[bench] {gpu_cards()}\n")

    from bitmapperbs_tpu.config import AlignerConfig
    from bitmapperbs_tpu.index.build import build_index
    from bitmapperbs_tpu.index.device import upload_index
    from bitmapperbs_tpu.models.aligner import map_batch_device
    from bitmapperbs_tpu.models.host import map_reads, prepare_batch
    from bitmapperbs_tpu.models.paired import map_batch_pe_device
    from bitmapperbs_tpu.oracle.pipeline import map_batch_se
    from bitmapperbs_tpu.utils.artifacts import enable_compile_cache
    from bitmapperbs_tpu.utils.simulate import (random_genome_fasta,
                                                simulate_pairs,
                                                simulate_reads)

    enable_compile_cache()
    genome_bp = 10_000_000
    idx = build_index(random_genome_fasta(
        np.random.default_rng(0), contigs=(genome_bp // 2, genome_bp // 2)))
    dix = upload_index(idx)
    bucket, batch = 96, 16384
    cfg = AlignerConfig(max_errors=4, indels=True, read_len_bucket=bucket,
                        batch_size=batch)
    err = dict(read_len=90, sub_rate=0.01, indel_rate=0.005)

    reads, se_batches = [], []
    for i in range(9):
        rl = [s.codes for s in simulate_reads(idx.genome, batch, seed=10 + i,
                                              **err)]
        reads.append(rl)
        se_batches.append((dix, cfg) + tuple(
            jax.device_put(prepare_batch(rl, bucket, batch))))
    device_rps = batch / _timed(map_batch_device, se_batches)

    pe_batch = 4096
    pe_cfg = cfg.replace(paired=True, min_insert=0, max_insert=500,
                         batch_size=pe_batch)
    pe_batches = []
    for seed in range(20, 25):
        prs = simulate_pairs(idx.genome, pe_batch, seed=seed, min_insert=150,
                             max_insert=480, **err)
        a1, l1 = prepare_batch([p[0].codes for p in prs], bucket, pe_batch)
        a2, l2 = prepare_batch([p[1].codes for p in prs], bucket, pe_batch)
        pe_batches.append((dix, pe_cfg) + tuple(
            jax.device_put((a1, l1, a2, l2))))
    pe_rps = 2 * pe_batch / _timed(map_batch_pe_device, pe_batches)
    sys.stderr.write(f"[bench] paired-end: {pe_rps:.0f} reads/s "
                     f"({pe_rps / 2:.0f} pairs/s)\n")

    # end to end: device map + host finalize -> SamRecords, 4 batches in
    # one call so the in-flight window overlaps device and host work
    e2e = [r for rl in reads[:4] for r in rl]
    map_reads(idx, dix, cfg, reads[4])                        # warm
    t0 = time.perf_counter()
    recs = map_reads(idx, dix, cfg, e2e)
    e2e_rps = len(e2e) / (time.perf_counter() - t0)
    n_mapped = sum(1 for r in recs if not r.flag & 0x4)
    sys.stderr.write(f"[bench] end-to-end (map + finalize -> records, one "
                     f"host process): {e2e_rps:.0f} reads/s "
                     f"({n_mapped}/{len(e2e)} mapped)\n")

    n_o = 16
    t0 = time.perf_counter()
    map_batch_se(idx, cfg, reads[0][:n_o])
    oracle_rps = n_o / (time.perf_counter() - t0)

    print(json.dumps({
        "metric": "reads_per_second_per_device",
        "value": round(device_rps, 1),
        "unit": "reads/s",
        "vs_baseline": round(device_rps / oracle_rps, 2),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
