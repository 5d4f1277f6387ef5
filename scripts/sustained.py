"""Sustained device throughput: stream millions of DISTINCT simulated reads
through the mapping pipeline (fresh batch content each step, batches kept in
flight), reporting steady-state reads/s and mapping sanity counters.

Usage: python scripts/sustained.py [--reads 2000000] [--index PREFIX]
"""
from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", type=int, default=2_000_000)
    ap.add_argument("--index", default="artifacts/idx_100m")
    ap.add_argument("--batch", type=int, default=8192)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from bitmapperbs_tpu import constants as K
    from bitmapperbs_tpu.config import AlignerConfig
    from bitmapperbs_tpu.index.build import load_index
    from bitmapperbs_tpu.index.device import upload_index
    from bitmapperbs_tpu.models.aligner import map_batch_device
    from bitmapperbs_tpu.utils.simulate import simulate_reads_bulk

    idx = load_index(args.index)
    dix = upload_index(idx)
    B = args.batch
    cfg = AlignerConfig(max_errors=4, indels=True, read_len_bucket=96,
                        batch_size=B)
    lengths = jnp.full(B, 90, jnp.int32)

    def gen(seed):
        codes, ci, coord, si = simulate_reads_bulk(
            idx.genome, B, read_len=90, seed=seed, sub_rate=0.01)
        arr = np.full((B, 96), K.N_CODE, dtype=np.uint8)
        arr[:, :90] = codes
        return arr, ci, coord

    arr, _, _ = gen(0)
    out = map_batch_device(dix, cfg, jnp.asarray(arr), lengths)
    jax.block_until_ready(out)

    n_batches = -(-args.reads // B)
    window, mapped, total = [], 0, 0
    t0 = time.perf_counter()
    for b in range(n_batches):
        arr, ci, coord = gen(b + 1)
        out = map_batch_device(dix, cfg, jnp.asarray(arr), lengths)
        window.append(out)
        if len(window) >= 3:
            done = window.pop(0)
            mapped += int(np.asarray(done["best_score"]).__lt__(
                K.INF_SCORE).sum())
            total += B
    for done in window:
        mapped += int(np.asarray(done["best_score"]).__lt__(
            K.INF_SCORE).sum())
        total += B
    dt = time.perf_counter() - t0
    print(f"sustained: {total} distinct reads in {dt:.1f}s -> "
          f"{total / dt:.0f} reads/s/chip  (mapped {100.0 * mapped / total:.2f}%)")


if __name__ == "__main__":
    main()
