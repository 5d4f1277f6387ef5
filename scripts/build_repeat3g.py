"""Build the 3.08 Gbp REPEAT-STRUCTURED index cache (idx_3g_rep_r4).

The flagship 3.08 Gbp numbers are on a UNIFORM-RANDOM
genome; the repeat study that validated the Gbp autotune ran at 1.03 Gbp.
This builds the honest flagship artifact: the GRCh38 contig-length profile
(scripts/build_big.GRCH38_LENGTHS) with human-profile repeat structure
planted per contig (utils/simulate.plant_repeats: SINE/LINE-like dispersed
families at 85-95% identity, tandem satellite, segmental duplications) --
the adaptive-seeding regime the reference exists for (SURVEY.md C9,
section 7 hard-part 2), at the scale the headline claims.

sa_rate 4 only (the bench-preferred config, +23% measured in round 4).
Block-resumable via build_big.build_scale (SA + pack checkpoints under
ckpt_3g_rep/).

Run detached:  nohup nice -n 19 python scripts/build_repeat3g.py > /tmp/rep3g.log 2>&1 &
"""
from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from bitmapperbs_tpu.index.build import CONTIG_PAD, Genome
from bitmapperbs_tpu.utils.artifacts import artifacts_dir
from bitmapperbs_tpu.utils.simulate import plant_repeats
from build_big import GRCH38_LENGTHS, build_scale, log

SEED = 13


def _genome_3g_rep() -> Genome:
    """3.08 Gbp repeat-structured genome, checkpointed like _genome_3g."""
    d = artifacts_dir()
    cpath = os.path.join(d, "ckpt_3g_rep_codes.bin")
    mpath = os.path.join(d, "ckpt_3g_rep_genome.json")
    if os.path.exists(mpath):
        with open(mpath) as f:
            m = json.load(f)
        codes = np.memmap(cpath, dtype=np.uint8, mode="r")
        log("3.08 Gbp repeat: genome loaded from checkpoint")
        return Genome(names=m["names"],
                      offsets=np.asarray(m["offsets"], dtype=np.int64),
                      lengths=np.asarray(m["lengths"], dtype=np.int64),
                      codes=codes)

    rng = np.random.default_rng(SEED)
    gc = 0.42
    p = np.array([(1 - gc) / 2, gc / 2, gc / 2, (1 - gc) / 2])
    names, offsets, lengths, parts = [], [], [], []
    pad = np.full(CONTIG_PAD, 4, dtype=np.uint8)
    pos = 0
    for i, ln in enumerate(GRCH38_LENGTHS):
        codes = rng.choice(4, size=ln, p=p).astype(np.uint8)
        stats = plant_repeats(rng, codes)
        log(f"3.08 Gbp repeat: contig {i + 1}/{len(GRCH38_LENGTHS)} "
            f"({ln / 1e6:.0f} Mbp) planted {stats}")
        names.append(f"chr{i + 1}")
        pos += CONTIG_PAD
        offsets.append(pos)
        lengths.append(ln)
        pos += ln
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
    log("3.08 Gbp repeat: genome checkpointed")
    return Genome(names=names,
                  offsets=np.asarray(offsets, dtype=np.int64),
                  lengths=np.asarray(lengths, dtype=np.int64),
                  codes=np.memmap(cpath, dtype=np.uint8, mode="r"))


def main() -> None:
    build_scale({4: "idx_3g_rep_r4"}, _genome_3g_rep, "ckpt_3g_rep",
                "3.08 Gbp repeat")
    log("3 Gbp repeat artifact built")


if __name__ == "__main__":
    main()
