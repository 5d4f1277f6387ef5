"""Upgrade an existing index artifact's k-mer table depth in place.

Gbp builds default to klt_k 16 (constants.KLT_MAX_K_GBP; its throughput
gain is not measured on the GPU).  This rebuilds the KLT of an already-built artifact post-hoc (minutes; no
SA-IS) and atomically replaces the .bin/.json, so the at-scale caches get
the new default without a 2 h rebuild.  Everything except the KLT (and
the manifest's klt_k) is byte-unchanged; device outputs are bit-identical
(the KLT resolves the same backward-search prefix steps -- human_bench
--klt measured identical mapped/recall/overflow counts at 14/15/16).

Run: python scripts/upgrade_klt.py <artifact-prefix> [k]
"""
from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from bitmapperbs_tpu.index.build import build_klt, load_index, save_index


def main() -> None:
    prefix = sys.argv[1]
    k = int(sys.argv[2]) if len(sys.argv) > 2 else 16
    idx = load_index(prefix)
    cur = idx.blocks[0].klt_k
    if cur == k:
        print(f"{prefix} already at klt_k={k}; nothing to do")
        return
    print(f"{prefix}: klt_k {cur} -> {k}", flush=True)
    for b in idx.blocks:
        t0 = time.time()
        b.klt = build_klt(b, k)
        b.klt_k = k
        print(f"  block rebuilt in {time.time() - t0:.0f}s "
              f"({b.klt.nbytes / 1e6:.0f} MB)", flush=True)
    idx.meta["klt_k"] = k
    t0 = time.time()
    save_index(idx, prefix + ".klttmp")
    os.replace(prefix + ".klttmp.bin", prefix + ".bin")
    os.replace(prefix + ".klttmp.json", prefix + ".json")
    print(f"  re-saved atomically in {time.time() - t0:.0f}s", flush=True)


if __name__ == "__main__":
    main()
