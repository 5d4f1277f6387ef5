"""Rebuild the at-scale index caches (idx_100m, idx_3g, idx_3g_r4).

Artifacts now live in the persistent artifacts dir (utils/artifacts.py;
default <repo>/artifacts, gitignored).

The 3 Gbp build is BLOCK-RESUMABLE: the expensive units
are one SA-IS pass per block (~1.7 h each on one host core) and one
pack per (block, sa_rate) (~20 min each).  Each packed (block, rate)
result is checkpointed to <artifacts>/ckpt_3g/<block>_r<rate>/ the moment
it exists, the raw SA is checkpointed the moment SA-IS finishes (round 5:
closes the ~30 min kill window between SA-IS and the first pack), and the
genome codes are checkpointed once, so a mid-build kill costs minutes.

  1. 100 Mbp, 2x50 Mbp contigs, seed 7  -> idx_100m
     (same recipe as scripts/crossdiff.py so the caches are interchangeable)
  2. 3.08 Gbp, 24 GRCh38-length contigs, seed 3: SA-IS per block, then BOTH
     sampling rates packed from the same suffix array:
       sa_rate 8 -> idx_3g     (~9.5 GB, the proven-upload artifact)
       sa_rate 4 -> idx_3g_r4  (~12.6 GB, half the locate LF steps)
     plus the genome-plane device cache (index/device.ensure_plane_cache).

Run detached:  nohup nice -n 19 python scripts/build_big.py > build3g.log 2>&1 &
A `<prefix>.done` marker is written after each artifact is fully serialized.
"""
from __future__ import annotations

import hashlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from bitmapperbs_tpu import constants as K
from bitmapperbs_tpu.index.build import (BSIndex, INDEX_VERSION, CONTIG_PAD,
                                         Genome, PackedBlock, build_block,
                                         build_index, build_klt,
                                         default_klt_k, parse_fasta,
                                         save_index)
from bitmapperbs_tpu.index import sais
from bitmapperbs_tpu.index.device import ensure_plane_cache
from bitmapperbs_tpu.utils import dna
from bitmapperbs_tpu.utils.artifacts import artifacts_dir, find_artifact
from bitmapperbs_tpu.utils.simulate import (random_genome,
                                            random_genome_fasta)

T0 = time.time()

# GRCh38 chr1..22,X,Y assembly lengths (public constants) -- a human-scale
# contig profile for the random genome; sum = 3.088 Gbp.
GRCH38_LENGTHS = (
    248956422, 242193529, 198295559, 190214555, 181538259, 170805979,
    159345973, 145138636, 138394717, 133797422, 135086622, 133275309,
    114364328, 107043718, 101991189, 90338345, 83257441, 80373285,
    58617616, 64444167, 46709983, 50818468, 156040895, 57227415,
)


def log(msg: str) -> None:
    print(f"[{time.time() - T0:8.0f}s] {msg}", flush=True)


def mark_done(prefix: str) -> None:
    with open(prefix + ".done", "w") as f:
        f.write("ok\n")


def build_100m() -> None:
    if find_artifact("idx_100m"):
        log("idx_100m already present; skipping")
        return
    prefix = os.path.join(artifacts_dir(), "idx_100m")
    rng = np.random.default_rng(7)
    log("100 Mbp: generating genome")
    fa = random_genome_fasta(rng, contigs=(50_000_000, 50_000_000))
    log("100 Mbp: building index (SA-IS both blocks)")
    idx = build_index(fa, build_mode="sais")
    save_index(idx, prefix)
    mark_done(prefix)
    log(f"100 Mbp: saved {prefix} ({idx.nbytes() / 1e9:.2f} GB)")


# ---- at-scale block checkpoints ------------------------------------------

def _ckpt_dir(name: str, rate: int, ns: str = "ckpt_3g") -> str:
    return os.path.join(artifacts_dir(), ns, f"{name}_r{rate}")


def _save_block_ckpt(name: str, rate: int, blk: PackedBlock,
                     ns: str = "ckpt_3g") -> None:
    d = _ckpt_dir(name, rate, ns)
    tmp = d + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    np.save(os.path.join(tmp, "cbase.npy"), blk.cbase)
    np.save(os.path.join(tmp, "cp_rows.npy"), blk.cp_rows)
    np.save(os.path.join(tmp, "sa_samples.npy"), blk.sa_samples)
    np.save(os.path.join(tmp, "klt.npy"), blk.klt)
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump({"n": blk.n, "sa_rate": blk.sa_rate,
                   "klt_k": blk.klt_k}, f)
    import shutil
    shutil.rmtree(d, ignore_errors=True)   # clear any torn residue
    os.replace(tmp, d)   # atomic: a torn checkpoint never has the final name


def _load_block_ckpt(name: str, rate: int, mmap: bool,
                     ns: str = "ckpt_3g") -> PackedBlock | None:
    d = _ckpt_dir(name, rate, ns)
    if not os.path.exists(os.path.join(d, "meta.json")):
        return None
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    mm = "r" if mmap else None
    return PackedBlock(
        n=meta["n"],
        cbase=np.load(os.path.join(d, "cbase.npy")),
        cp_rows=np.load(os.path.join(d, "cp_rows.npy"), mmap_mode=mm),
        sa_samples=np.load(os.path.join(d, "sa_samples.npy"), mmap_mode=mm),
        sa_rate=meta["sa_rate"],
        klt_k=meta["klt_k"],
        klt=np.load(os.path.join(d, "klt.npy")),
    )


def _sa_ckpt_path(name: str, ns: str) -> str:
    return os.path.join(artifacts_dir(), ns, f"{name}_sa.npy")


def _save_sa_ckpt(name: str, ns: str, sa: np.ndarray) -> None:
    """Checkpoint the raw suffix array the moment SA-IS finishes.

    Closes a resumability hole: a kill between
    "SA-IS done" and the first packed-block checkpoint used to re-run the
    whole ~29 min SA-IS; now it costs only this write (~1 min at 3 Gbp,
    24.7 GB int64).  Deleted once every sa_rate pack for the block is
    checkpointed."""
    path = _sa_ckpt_path(name, ns)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.save(f, sa)
    os.replace(tmp, path)


def _genome_3g() -> Genome:
    """3.08 Gbp genome as direct codes, checkpointed (~5 min to regenerate;
    build3g.log round 4 -- no FASTA round trip since commit b48341d)."""
    d = artifacts_dir()
    cpath = os.path.join(d, "ckpt_3g_codes.bin")
    mpath = os.path.join(d, "ckpt_3g_genome.json")
    if os.path.exists(mpath):
        with open(mpath) as f:
            m = json.load(f)
        codes = np.memmap(cpath, dtype=np.uint8, mode="r")
        log("3.08 Gbp: genome loaded from checkpoint")
        return Genome(names=m["names"],
                      offsets=np.asarray(m["offsets"], dtype=np.int64),
                      lengths=np.asarray(m["lengths"], dtype=np.int64),
                      codes=codes)
    rng = np.random.default_rng(3)
    log("3.08 Gbp: generating 24-contig genome (direct codes)")
    # bit-identical to parse_fasta(random_genome_fasta(rng, ...)) -- same
    # rng stream -- but without the ~22 min GB-scale FASTA round trip
    genome = random_genome(rng, contigs=GRCH38_LENGTHS)
    genome.codes.tofile(cpath + ".tmp")
    os.replace(cpath + ".tmp", cpath)
    with open(mpath + ".tmp", "w") as f:
        json.dump({"names": genome.names,
                   "offsets": genome.offsets.tolist(),
                   "lengths": genome.lengths.tolist()}, f)
    os.replace(mpath + ".tmp", mpath)
    log("3.08 Gbp: genome checkpointed")
    return genome


def build_scale(stems_by_rate: dict, genome_fn, ns: str,
                label: str, plane_cache: bool = True) -> None:
    """Generic block-resumable at-scale build.

    stems_by_rate: {sa_rate: artifact stem}; each (block, rate) packed
    result checkpoints under <artifacts>/<ns>/ the moment it exists, and
    the raw SA checkpoints the moment SA-IS finishes, so a mid-build kill
    costs minutes anywhere (SURVEY.md section 5.4: the index is the
    checkpoint -- here made granular).
    """
    rates = sorted(stems_by_rate, reverse=True)
    if all(find_artifact(s) for s in stems_by_rate.values()):
        log(f"{label} artifacts already present; skipping build")
    else:
        genome = genome_fn()
        log(f"{label}: {sum(genome.lengths) / 1e9:.3f} Gbp, "
            f"{len(genome.lengths)} contigs")
        klt_k = default_klt_k(len(genome.codes) + 1)
        sha = hashlib.sha256(genome.codes.tobytes()).hexdigest()

        blocks = {r: [] for r in rates}
        for name in ("fwd", "rc"):
            have = {r: _load_block_ckpt(name, r, mmap=True, ns=ns)
                    for r in rates}
            def ensure_klt(blk, r):
                """Checkpoints can predate a KLT-depth default change
                (round 5: Gbp cap 14 -> 16); rebuild just the table so
                the artifact stays internally consistent."""
                if blk.klt_k == klt_k:
                    return blk
                t0 = time.time()
                blk.klt = build_klt(blk, klt_k)
                blk.klt_k = klt_k
                _save_block_ckpt(name, r, blk, ns=ns)
                log(f"{label}: block {name} r{r} KLT rebuilt at "
                    f"k={klt_k} in {time.time() - t0:.0f}s")
                return _load_block_ckpt(name, r, mmap=True, ns=ns)

            if all(have.values()):
                log(f"{label}: block {name} loaded from checkpoints")
                for r in rates:
                    blocks[r].append(ensure_klt(have[r], r))
                continue
            conv = dna.ct_convert(genome.codes if name == "fwd"
                                  else dna.revcomp(genome.codes))
            sa_path = _sa_ckpt_path(name, ns)
            if os.path.exists(sa_path):
                sa = np.load(sa_path)
                log(f"{label}: SA for block {name} loaded from checkpoint")
            else:
                text = np.concatenate(
                    [np.ascontiguousarray(conv, dtype=np.uint8),
                     np.zeros(1, dtype=np.uint8)])
                t0 = time.time()
                log(f"{label}: SA-IS on block {name} (n={len(text)})")
                sa = sais.suffix_array(text)
                log(f"{label}: SA-IS {name} done in {time.time() - t0:.0f}s")
                del text
                t0 = time.time()
                _save_sa_ckpt(name, ns, sa)
                log(f"{label}: SA checkpoint {name} written "
                    f"in {time.time() - t0:.0f}s")
            for rate in rates:
                if have[rate] is not None:
                    blocks[rate].append(ensure_klt(have[rate], rate))
                    continue
                t0 = time.time()
                blk = build_block(conv, sa=sa, sa_rate=rate, klt_k=klt_k)
                _save_block_ckpt(name, rate, blk, ns=ns)
                # reopen mmap-backed so the packed blocks never all sit
                # in RAM at once during the final saves
                blocks[rate].append(
                    _load_block_ckpt(name, rate, mmap=True, ns=ns))
                del blk
                log(f"{label}: packed block {name} sa_rate={rate} "
                    f"in {time.time() - t0:.0f}s (checkpointed)")
            del sa, conv
            # every rate for this block is packed -- the SA ckpt is spent
            if os.path.exists(_sa_ckpt_path(name, ns)):
                os.remove(_sa_ckpt_path(name, ns))

        for rate in rates:
            stem = stems_by_rate[rate]
            prefix = os.path.join(artifacts_dir(), stem)
            if find_artifact(stem):
                continue
            meta = {
                "version": INDEX_VERSION,
                "genome_sha256": sha,
                "cp_block": K.CP_BLOCK,
                "sa_sample_rate": rate,
                "klt_k": klt_k,
                "contig_pad": CONTIG_PAD,
            }
            idx = BSIndex(genome=genome, blocks=blocks[rate], meta=meta)
            save_index(idx, prefix)
            mark_done(prefix)
            log(f"{label}: saved {prefix} ({idx.nbytes() / 1e9:.2f} GB)")

    if not plane_cache:
        return
    # derived device-plane cache (shared across sa_rates via genome sha)
    from bitmapperbs_tpu.index.build import load_index
    prefix = find_artifact(stems_by_rate[rates[0]])
    if prefix:
        t0 = time.time()
        path = ensure_plane_cache(load_index(prefix))
        log(f"{label}: plane cache ready ({path}) in {time.time() - t0:.0f}s")


def build_3g() -> None:
    build_scale({8: "idx_3g", 4: "idx_3g_r4"}, _genome_3g, "ckpt_3g",
                "3.08 Gbp")


def build_3g_r4_only() -> None:
    """sa_rate-4 artifact only (the bench-preferred one; PERF.md round 4).

    Skips the rate-8 packs/save (~50 min on this core) when wall time is
    short; checkpoints share the ckpt_3g namespace so a later full build_3g
    reuses every (block, 4) unit."""
    build_scale({4: "idx_3g_r4"}, _genome_3g, "ckpt_3g", "3.08 Gbp")


STAGES = {"100m": build_100m, "3g": build_3g, "3g_r4": build_3g_r4_only}


def main() -> None:
    stages = sys.argv[1:] or ["100m", "3g"]
    for s in stages:
        STAGES[s]()
    log("all artifacts built")


if __name__ == "__main__":
    main()
