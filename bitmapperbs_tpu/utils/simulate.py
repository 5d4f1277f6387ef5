"""Simulated-WGBS read generator with ground truth (SURVEY.md section 4:
simulated reads with known positions are the de-facto oracle for accuracy).

Simulates: fragment sampling from contigs, per-cytosine methylation,
bisulfite conversion, sequencing errors (substitutions and optional indels),
all four strand protocols, and paired-end fragments.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from bitmapperbs_tpu import constants as K
from bitmapperbs_tpu.index.build import CONTIG_PAD, Genome
from bitmapperbs_tpu.utils import dna


@dataclasses.dataclass
class SimRead:
    codes: np.ndarray        # as-sequenced read codes
    qual: str
    contig: int
    coord: int               # 0-based true leftmost fwd coordinate
    strand: str              # OT / OB / CTOT / CTOB
    n_subs: int
    n_indels: int

    @property
    def is_reverse(self) -> bool:
        return self.strand in ("OB", "CTOT")


def _bisulfite(fragment: np.ndarray, rng, meth_rate: float) -> np.ndarray:
    """C -> T unless methylated (in the fragment's own strand space)."""
    out = fragment.copy()
    cs = np.flatnonzero(out == K.C)
    unmeth = cs[rng.random(len(cs)) >= meth_rate]
    out[unmeth] = K.T
    return out


def _add_errors(read: np.ndarray, rng, sub_rate: float, indel_rate: float):
    out = read.copy()
    subs = np.flatnonzero(rng.random(len(out)) < sub_rate)
    for i in subs:
        out[i] = (out[i] + rng.integers(1, 4)) % 4
    n_ind = 0
    if indel_rate > 0:
        lst = list(out)
        i = 0
        while i < len(lst):
            r = rng.random()
            if r < indel_rate / 2 and len(lst) > 20:
                del lst[i]
                n_ind += 1
            elif r < indel_rate and len(lst) > 0:
                lst.insert(i, int(rng.integers(0, 4)))
                n_ind += 1
                i += 2
            else:
                i += 1
        out = np.array(lst, dtype=np.uint8)
    return out, len(subs), n_ind


def simulate_reads(genome: Genome, n: int, read_len: int = 100, *,
                   seed: int = 0, meth_rate: float = 0.3,
                   sub_rate: float = 0.005, indel_rate: float = 0.0,
                   protocols=("OT", "OB")) -> list[SimRead]:
    """Directional default (OT/OB); pass all four protocols for PBAT-style."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ci = int(rng.integers(0, len(genome.names)))
        clen = int(genome.lengths[ci])
        if clen < read_len + 2:
            continue
        coord = int(rng.integers(0, clen - read_len))
        start = int(genome.offsets[ci]) + coord
        frag = genome.codes[start:start + read_len]
        strand = protocols[int(rng.integers(0, len(protocols)))]
        if strand == "OT":
            r = _bisulfite(frag, rng, meth_rate)
        elif strand == "OB":
            r = _bisulfite(dna.revcomp(frag), rng, meth_rate)
        elif strand == "CTOT":
            r = dna.revcomp(_bisulfite(frag, rng, meth_rate))
        else:  # CTOB
            r = dna.revcomp(_bisulfite(dna.revcomp(frag), rng, meth_rate))
        r, n_subs, n_ind = _add_errors(r, rng, sub_rate, indel_rate)
        qual = "I" * len(r)
        out.append(SimRead(codes=r, qual=qual, contig=ci, coord=coord,
                           strand=strand, n_subs=n_subs, n_indels=n_ind))
    return out


def simulate_pairs(genome: Genome, n: int, read_len: int = 100, *,
                   seed: int = 0, min_insert: int = 150, max_insert: int = 500,
                   meth_rate: float = 0.3, sub_rate: float = 0.005,
                   indel_rate: float = 0.0):
    """FR paired-end fragments: R1 from the fragment 5' end (OT or OB),
    R2 from the opposite strand's 5' end.  Returns list of (SimRead, SimRead)
    with true coordinates for both mates."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ci = int(rng.integers(0, len(genome.names)))
        clen = int(genome.lengths[ci])
        insert = int(rng.integers(min_insert, max_insert + 1))
        if clen < insert + 2:
            continue
        coord = int(rng.integers(0, clen - insert))
        start = int(genome.offsets[ci]) + coord
        frag = genome.codes[start:start + insert]
        from_ot = bool(rng.integers(0, 2))
        # bisulfite-convert the whole fragment on its originating strand
        if from_ot:
            conv = _bisulfite(frag, rng, meth_rate)
            r1, s1 = conv[:read_len], "OT"
            r2, s2 = dna.revcomp(conv)[:read_len], "CTOT"
            c1, c2 = coord, coord + insert - read_len
        else:
            conv = _bisulfite(dna.revcomp(frag), rng, meth_rate)
            r1, s1 = conv[:read_len], "OB"
            r2, s2 = dna.revcomp(conv)[:read_len], "CTOB"
            c1, c2 = coord + insert - read_len, coord
        pair = []
        for r, s, c in ((r1, s1, c1), (r2, s2, c2)):
            r, n_subs, n_ind = _add_errors(r, rng, sub_rate, indel_rate)
            pair.append(SimRead(codes=r, qual="I" * len(r), contig=ci,
                                coord=c, strand=s, n_subs=n_subs,
                                n_indels=n_ind))
        out.append((pair[0], pair[1]))
    return out


def simulate_reads_bulk(genome: Genome, n: int, read_len: int = 100, *,
                        seed: int = 0, meth_rate: float = 0.3,
                        sub_rate: float = 0.005,
                        protocols=("OT", "OB")):
    """Vectorized bulk simulator (no indels): ~100x the per-read generator.

    For sustained-throughput runs that need millions of reads.  Returns
    (codes uint8[n, read_len], contig int32[n], coord int64[n],
    strand_idx int8[n] indexing `protocols`).
    """
    rng = np.random.default_rng(seed)
    eligible = np.flatnonzero(genome.lengths >= read_len + 2)
    ci = eligible[rng.integers(0, len(eligible), n)]
    coord = rng.integers(0, genome.lengths[ci] - read_len)
    start = genome.offsets[ci] + coord
    frag = genome.codes[start[:, None] + np.arange(read_len)]
    si = rng.integers(0, len(protocols), n).astype(np.int8)

    out = np.empty((n, read_len), dtype=np.uint8)
    for k, proto in enumerate(protocols):
        sel = si == k
        f = frag[sel]
        if proto in ("OB", "CTOB"):
            f = 3 - f[:, ::-1]
            f[frag[sel][:, ::-1] == K.N_CODE] = K.N_CODE
        conv = f.copy()
        cs = conv == K.C
        conv[cs & (rng.random(conv.shape) >= meth_rate)] = K.T
        if proto in ("CTOT", "CTOB"):
            rcv = 3 - conv[:, ::-1]
            rcv[conv[:, ::-1] == K.N_CODE] = K.N_CODE
            conv = rcv
        out[sel] = conv
    subs = rng.random(out.shape) < sub_rate
    out[subs] = (out[subs] + rng.integers(1, 4, int(subs.sum()))) % 4
    return out, ci.astype(np.int32), coord.astype(np.int64), si


def plant_repeats(rng, codes: np.ndarray, *, dispersed_frac: float = 0.27,
                  line_frac: float = 0.17, tandem_frac: float = 0.03,
                  segdup_frac: float = 0.05,
                  divergence=(0.05, 0.15), record: list | None = None) -> dict:
    """Overwrite a random backbone with human-like repeat structure, in place.

    Uniform-random genomes have only 3-letter-alphabet statistics in their
    seed-occupancy tail; real genomes add interspersed repeat families,
    tandem satellite arrays, and segmental duplications -- the regime the
    reference's adaptive seeding exists for (SURVEY.md C9, section 7
    hard-part 2).  Human-profile defaults: ~10%+17% SINE/LINE-like
    dispersed copies at 85-95% identity, ~3% tandem satellite, ~5%
    segmental duplications at 95-99% identity (~45%+ repeat-derived total,
    GRC-scale proportions).

    codes must not contain the contig N padding yet (plant before padding)
    or may: N positions are simply overwritten.  Returns a stats dict.

    record: optional list; every planted interval is appended as
    (start, end, kind) with kind in {"dispersed","line","tandem","segdup"}
    (segdups record both source and destination).  Recording consumes no
    extra rng draws, so a replay with the same rng reproduces the same
    genome bit-for-bit (scripts/rep_intervals.py relies on this).
    """
    L = len(codes)
    stats = {"dispersed": 0, "line": 0, "tandem": 0, "segdup": 0}

    def _mutate(seq, rate):
        m = rng.random(len(seq)) < rate
        out = seq.copy()
        out[m] = (out[m] + rng.integers(1, 4, int(m.sum()))) % 4
        return out

    # dispersed families: SINE-like (~300 bp) and LINE-like (~6 kb) copies
    # of per-family consensi, each copy independently diverged
    for frac, unit, fams, key in ((dispersed_frac, 300, 8, "dispersed"),
                                  (line_frac, 6000, 4, "line")):
        total = int(L * frac)
        if total < unit:
            continue
        n_copies = max(1, total // unit)
        consensi = [rng.integers(0, 4, unit).astype(np.uint8)
                    for _ in range(fams)]
        fam = rng.integers(0, fams, n_copies)
        pos = rng.integers(0, max(1, L - unit), n_copies)
        div = rng.uniform(divergence[0], divergence[1], n_copies)
        # LINE copies are frequently 5'-truncated (real-genome statistic
        # that changes the occupancy curve: full-length copies are rare)
        tr = (rng.integers(0, unit - 50, n_copies)
              if unit > 1000 else np.zeros(n_copies, dtype=np.int64))
        for i in range(n_copies):
            c = _mutate(consensi[fam[i]][tr[i]:], div[i])
            codes[pos[i]:pos[i] + len(c)] = c[:L - pos[i]]
            stats[key] += 1
            if record is not None:
                record.append((int(pos[i]),
                               int(pos[i]) + min(len(c), L - int(pos[i])),
                               key))

    # tandem satellite arrays (alpha-satellite-like 171 bp units and short
    # microsatellites), each array a lightly-diverging tiling of one unit
    total = int(L * tandem_frac)
    placed = 0
    while placed < total:
        u = int(rng.choice([2, 4, 6, 20, 171]))
        unit = rng.integers(0, 4, u).astype(np.uint8)
        arr_len = int(min(rng.integers(u * 10, 50_000), total - placed))
        if arr_len < u * 2:
            break
        reps = -(-arr_len // u)
        arr = _mutate(np.tile(unit, reps)[:arr_len], 0.02)
        p = int(rng.integers(0, max(1, L - arr_len)))
        codes[p:p + arr_len] = arr[:L - p]
        placed += arr_len
        stats["tandem"] += 1
        if record is not None:
            record.append((p, p + min(arr_len, L - p), "tandem"))

    # segmental duplications: multi-Mbp self-copies at 95-99% identity
    total = int(L * segdup_frac)
    placed = 0
    while placed < total:
        seg = int(min(rng.integers(500_000, 5_000_000), total - placed))
        if seg < 100_000 or L < 2 * seg:
            break
        src = int(rng.integers(0, L - seg))
        dst = int(rng.integers(0, L - seg))
        codes[dst:dst + seg] = _mutate(codes[src:src + seg],
                                       float(rng.uniform(0.01, 0.05)))
        placed += seg
        stats["segdup"] += 1
        if record is not None:
            record.append((src, src + seg, "segdup"))
            record.append((dst, dst + seg, "segdup"))
    return stats


def repeat_genome_fasta(rng, contigs=(2000, 1500), gc: float = 0.42,
                        **repeat_kw) -> str:
    """random_genome_fasta with plant_repeats applied per contig (tests and
    sub-Gbp studies; at 3 Gbp build codes directly via plant_repeats)."""
    parts = []
    p = np.array([(1 - gc) / 2, gc / 2, gc / 2, (1 - gc) / 2])
    for i, ln in enumerate(contigs):
        codes = rng.choice(4, size=ln, p=p).astype(np.uint8)
        plant_repeats(rng, codes, **repeat_kw)
        chars = np.frombuffer(b"ACGT", dtype=np.uint8)[codes]
        parts.append(f">chr{i + 1}\n{chars.tobytes().decode()}\n")
    return "".join(parts)


def random_genome(rng, contigs=(2000, 1500), gc: float = 0.42) -> Genome:
    """Random genome built directly as a Genome (no FASTA text round trip).

    Draws the SAME `rng.choice` stream per contig as random_genome_fasta,
    so for a given seed the resulting codes are bit-identical to
    `parse_fasta(random_genome_fasta(rng, ...))` -- but skips the GB-scale
    string assembly + re-parse, which dominates at-scale genome generation
    (~22 min of the 3.08 Gbp rebuild, scripts/build_big.py round 4)."""
    p = np.array([(1 - gc) / 2, gc / 2, gc / 2, (1 - gc) / 2])
    pad = np.full(CONTIG_PAD, K.N_CODE, dtype=np.uint8)
    pieces, offsets, lengths = [pad], [], []
    pos = CONTIG_PAD
    for ln in contigs:
        codes = rng.choice(4, size=ln, p=p).astype(np.uint8)
        offsets.append(pos)
        lengths.append(ln)
        pieces.append(codes)
        pieces.append(pad)
        pos += ln + CONTIG_PAD
    return Genome(
        names=[f"chr{i + 1}" for i in range(len(contigs))],
        offsets=np.asarray(offsets, dtype=np.int64),
        lengths=np.asarray(lengths, dtype=np.int64),
        codes=np.concatenate(pieces),
    )


def random_genome_fasta(rng, contigs=(2000, 1500), gc: float = 0.42,
                        names=None) -> str:
    """Random FASTA text (vectorized; fine for 10^8 bp).  Contigs are named
    chr1.. unless `names` are given."""
    p = np.array([(1 - gc) / 2, gc / 2, gc / 2, (1 - gc) / 2])
    names = names or [f"chr{i + 1}" for i in range(len(contigs))]
    parts = []
    for name, ln in zip(names, contigs):
        codes = rng.choice(4, size=ln, p=p).astype(np.uint8)
        chars = np.frombuffer(b"ACGT", dtype=np.uint8)[codes]
        width = 70
        nrows = -(-ln // width)
        rows = np.full((nrows, width + 1), ord("\n"), dtype=np.uint8)
        pad = nrows * width - ln
        flat = np.concatenate([chars, np.full(pad, ord("\n"), np.uint8)])
        rows[:, :width] = flat.reshape(nrows, width)
        body = rows.tobytes().decode().rstrip("\n")
        parts.append(f">{name}\n{body}\n")
    return "".join(parts)
