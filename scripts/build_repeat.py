"""Build the 1.03 Gbp REPEAT-STRUCTURED index cache (idx_1g_rep).

Every at-scale accuracy/occupancy number before this study was on a
uniform-random genome, whose seed-occupancy heavy tail comes only from
3-letter-alphabet statistics.  This genome plants human-profile repeat
structure (utils/simulate.plant_repeats: SINE/LINE-like dispersed families
at 85-95% identity, tandem satellite, multi-Mbp segmental duplications)
into the random backbone -- the regime the reference's adaptive seeding
exists for (SURVEY.md C9, section 7 hard-part 2).

1.03 Gbp (4 x 257.5 Mbp contigs) sits above the 512 Mbp Gbp-autotune
threshold (cli.autotune_for_genome), so the production seed-extension
config is exercised exactly as it would be on GRCh38, at ~1/3 the SA-IS
cost of the 3.08 Gbp build.  Block-resumable via build_big.build_scale.

Run detached:  nohup nice -n 19 python scripts/build_repeat.py > rep1g.log 2>&1 &
"""
from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from bitmapperbs_tpu.index.build import Genome
from bitmapperbs_tpu.utils.artifacts import artifacts_dir
from bitmapperbs_tpu.utils.simulate import plant_repeats
from build_big import build_scale, log

CONTIG_LEN = 257_500_000
N_CONTIGS = 4
SEED = 11


def _genome_1g_rep() -> Genome:
    """1.03 Gbp repeat-structured genome, checkpointed like _genome_3g."""
    d = artifacts_dir()
    cpath = os.path.join(d, "ckpt_1g_rep_codes.bin")
    mpath = os.path.join(d, "ckpt_1g_rep_genome.json")
    if os.path.exists(mpath):
        with open(mpath) as f:
            m = json.load(f)
        codes = np.memmap(cpath, dtype=np.uint8, mode="r")
        log("1.03 Gbp repeat: genome loaded from checkpoint")
        return Genome(names=m["names"],
                      offsets=np.asarray(m["offsets"], dtype=np.int64),
                      lengths=np.asarray(m["lengths"], dtype=np.int64),
                      codes=codes)

    from bitmapperbs_tpu.index.build import CONTIG_PAD

    rng = np.random.default_rng(SEED)
    gc = 0.42
    p = np.array([(1 - gc) / 2, gc / 2, gc / 2, (1 - gc) / 2])
    names, offsets, lengths, parts = [], [], [], []
    pad = np.full(CONTIG_PAD, 4, dtype=np.uint8)
    pos = 0
    for i in range(N_CONTIGS):
        log(f"1.03 Gbp repeat: contig {i + 1}/{N_CONTIGS} backbone")
        codes = rng.choice(4, size=CONTIG_LEN, p=p).astype(np.uint8)
        stats = plant_repeats(rng, codes)
        log(f"1.03 Gbp repeat: contig {i + 1} repeats planted {stats}")
        names.append(f"chr{i + 1}")
        pos += CONTIG_PAD
        offsets.append(pos)
        lengths.append(CONTIG_LEN)
        pos += CONTIG_LEN
        parts.extend([pad, codes])
    parts.append(pad)
    all_codes = np.concatenate(parts)
    del parts
    all_codes.tofile(cpath + ".tmp")
    os.replace(cpath + ".tmp", cpath)
    with open(mpath + ".tmp", "w") as f:
        json.dump({"names": names, "offsets": offsets,
                   "lengths": lengths}, f)
    os.replace(mpath + ".tmp", mpath)
    log("1.03 Gbp repeat: genome checkpointed")
    return Genome(names=names,
                  offsets=np.asarray(offsets, dtype=np.int64),
                  lengths=np.asarray(lengths, dtype=np.int64),
                  codes=np.memmap(cpath, dtype=np.uint8, mode="r"))


def main() -> None:
    build_scale({8: "idx_1g_rep"}, _genome_1g_rep, "ckpt_1g_rep",
                "1.03 Gbp repeat")
    log("repeat artifact built")


if __name__ == "__main__":
    main()
