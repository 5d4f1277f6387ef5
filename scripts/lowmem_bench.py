"""Measure the lowmem (bwtinc dynamic-BWT) build mode at the scale it
exists for (the pSAscan role is byte-identity-tested at toy
scale only; its Gbp-scale wall time and peak RSS were never measured, so
"bounded-RAM human-genome build" was a capability claim without numbers).

Each (mode, scale) build runs in its own subprocess so peak RSS
(ru_maxrss) is per-build, and artifacts are byte-compared across modes.

Stages (pick with argv, default "100m"):
  100m       -- 100 Mbp calibration: sais vs lowmem wall/RSS ratio
  1g         -- 1.03 Gbp: lowmem build (wall, RSS) + sais build of the
                SAME genome; asserts .bin/.json byte-identity
Run detached: nohup nice -n 19 python scripts/lowmem_bench.py 1g > /tmp/lowmem1g.log 2>&1 &
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from bitmapperbs_tpu.utils.artifacts import artifacts_dir  # noqa: E402

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")

_CHILD = r"""
import os, resource, sys, time
import numpy as np
repo, mode, out_prefix, n_bp = (sys.argv[1], sys.argv[2], sys.argv[3],
                                int(sys.argv[4]))
sys.path.insert(0, repo)
sys.path.insert(0, os.path.join(repo, "scripts"))
from bitmapperbs_tpu.index.build import build_index, save_index
from bitmapperbs_tpu.utils.simulate import random_genome

# deterministic genome shared across modes (seed fixed per scale)
rng = np.random.default_rng(31)
n_c = max(2, n_bp // 515_000_000 * 2) if n_bp > 515_000_000 else 2
genome = random_genome(rng, contigs=(n_bp // n_c,) * n_c)
t0 = time.time()
idx = build_index(genome, sa_rate=8, build_mode=mode)
dt = time.time() - t0
save_index(idx, out_prefix)
ru = resource.getrusage(resource.RUSAGE_SELF)
# cpu_s is the honest cost on this one-core VM: wall_s is polluted by
# nice-19 contention and bench.py SIGSTOPs
print(f"RESULT {mode} n_bp={n_bp} wall_s={dt:.0f} "
      f"cpu_s={ru.ru_utime + ru.ru_stime:.0f} "
      f"peak_rss_gb={ru.ru_maxrss / 1e6:.2f}", flush=True)
"""


def run_build(mode: str, out_prefix: str, n_bp: int) -> None:
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    p = subprocess.run(
        [sys.executable, "-c", _CHILD, REPO, mode, out_prefix, str(n_bp)],
        env=env)
    if p.returncode != 0:
        sys.exit(f"{mode} build failed")


def compare(a: str, b: str) -> None:
    for ext in (".bin", ".json"):
        ba = open(a + ext, "rb").read()
        bb = open(b + ext, "rb").read()
        if ext == ".json":
            # identical up to the build-host metadata (none today) --
            # compare parsed content to be explicit
            assert json.loads(ba) == json.loads(bb), f"{ext} differs"
        else:
            assert ba == bb, f"{ext} differs ({len(ba)} vs {len(bb)} bytes)"
    print(f"byte-identity OK: {a} == {b}", flush=True)


def main() -> None:
    stage = sys.argv[1] if len(sys.argv) > 1 else "100m"
    n_bp = {"100m": 100_000_000, "1g": 1_030_000_000}[stage]
    d = os.path.join(artifacts_dir(), "lowmem_bench")
    os.makedirs(d, exist_ok=True)
    for mode in ("lowmem", "sais"):
        prefix = os.path.join(d, f"{stage}_{mode}")
        if os.path.exists(prefix + ".json"):
            print(f"{prefix} already built; skipping", flush=True)
            continue
        t0 = time.time()
        run_build(mode, prefix, n_bp)
        print(f"{mode} {stage}: total {time.time() - t0:.0f}s", flush=True)
    compare(os.path.join(d, f"{stage}_lowmem"),
            os.path.join(d, f"{stage}_sais"))


if __name__ == "__main__":
    main()
