"""Device PE pipeline SAM == oracle PE SAM, byte-for-byte (config 3)."""
import numpy as np
import pytest

from bitmapperbs_tpu.config import AlignerConfig
from bitmapperbs_tpu.index.build import build_index
from bitmapperbs_tpu.index.device import upload_index
from bitmapperbs_tpu.models.host import map_pairs
from bitmapperbs_tpu.oracle.paired import map_batch_pe
from bitmapperbs_tpu.utils.simulate import random_genome_fasta, simulate_pairs


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(23)
    idx = build_index(random_genome_fasta(rng, contigs=(6000, 3000)))
    return idx, upload_index(idx)


def _compare(idx, dix, cfg, pairs):
    inp = [(a.codes, b.codes) for a, b in pairs]
    oracle = [r.line() for r in map_batch_pe(idx, cfg, inp)]
    device = [r.line() for r in map_pairs(idx, dix, cfg, inp)]
    mism = [i for i, (a, b) in enumerate(zip(oracle, device)) if a != b]
    assert not mism, (
        f"{len(mism)} of {len(oracle)} mismatch, first at {mism[0]}:"
        f"\n oracle: {oracle[mism[0]]}\n device: {device[mism[0]]}")


def cfg_pe(**kw):
    base = dict(max_errors=3, indels=False, paired=True, min_insert=120,
                max_insert=280, read_len_bucket=96, batch_size=64)
    base.update(kw)
    return AlignerConfig(**base)


def test_pe_parity_clean(setup):
    idx, dix = setup
    pairs = simulate_pairs(idx.genome, 40, read_len=80, seed=41,
                           min_insert=150, max_insert=260, sub_rate=0.005)
    _compare(idx, dix, cfg_pe(), pairs)


def test_pe_parity_indels(setup):
    idx, dix = setup
    pairs = simulate_pairs(idx.genome, 30, read_len=80, seed=42,
                           min_insert=150, max_insert=260,
                           sub_rate=0.01, indel_rate=0.01)
    _compare(idx, dix, cfg_pe(indels=True, max_errors=4), pairs)


def test_pe_parity_rescue_path(setup):
    idx, dix = setup
    rng = np.random.default_rng(1)
    pairs = simulate_pairs(idx.genome, 25, read_len=80, seed=43,
                           min_insert=150, max_insert=260, sub_rate=0.0)
    inp = []
    for s1, s2 in pairs:
        r2 = s2.codes.copy()
        for j in (5, 30, 60):  # kill most seeds of mate2 -> rescue path
            r2[j] = (r2[j] + 1 + rng.integers(0, 3)) % 4
        inp.append((s1.codes, r2))
    cfg = cfg_pe(max_errors=3)
    orecs = map_batch_pe(idx, cfg, inp)
    oracle = [r.line() for r in orecs]
    device = [r.line() for r in map_pairs(idx, dix, cfg, inp)]
    assert oracle == device
    n_proper = sum(bool(r.flag & 0x2) for r in orecs)
    assert n_proper >= 40  # most pairs recovered via rescue


def test_pe_parity_discordant(setup):
    idx, dix = setup
    pairs = simulate_pairs(idx.genome, 20, read_len=70, seed=44,
                           min_insert=150, max_insert=260, sub_rate=0.0)
    cfg = cfg_pe(min_insert=0, max_insert=50)  # insert range excludes truth
    _compare(idx, dix, cfg, pairs)


def test_pe_rescue_window_underflow(setup):
    """Anchor near the frame start with min_insert > anchor+len (or
    max_insert < missing-mate length): the oracle's rescue window is empty
    (hi < 0 -> lo > hi -> no rescue); the device's uint32 hi must take the
    same branch instead of wrapping into a near-full-genome scan.  The
    missing mate is planted as an exact match FAR from the anchor, so a
    wrapped window would find it and emit a spurious proper pair."""
    from bitmapperbs_tpu.utils import dna
    idx, dix = setup
    g = np.asarray(idx.genome.codes)

    # rev-anchored: r1 = OB-style read at fwd coord 0 (reverse orientation);
    # r2 matches the (rev block, GA) rescue frame exactly at fwd ~4000
    inp = [(dna.revcomp(g[0:80]), g[4000:4080].copy())]
    cfg = cfg_pe(max_errors=3, indels=True, min_insert=200, max_insert=400)
    recs_o = map_batch_pe(idx, cfg, inp)
    oracle = [r.line() for r in recs_o]
    device = [r.line() for r in map_pairs(idx, dix, cfg, inp)]
    assert oracle == device
    assert not any(r.flag & 0x2 for r in recs_o)  # no (spurious) proper pair

    # fwd-anchored flavor: max_insert < missing-mate length; the planted
    # distant match for the (fwd block, GA) frame is a revcomp'd fwd slice
    inp2 = [(g[0:80].copy(), dna.revcomp(g[4000:4080]))]
    cfg2 = cfg_pe(max_errors=3, indels=True, min_insert=0, max_insert=60)
    recs_o2 = map_batch_pe(idx, cfg2, inp2)
    oracle2 = [r.line() for r in recs_o2]
    device2 = [r.line() for r in map_pairs(idx, dix, cfg2, inp2)]
    assert oracle2 == device2
    assert not any(r.flag & 0x2 for r in recs_o2)


def test_pe_non_directional_parity(setup):
    """PBAT paired-end: all four conversion frames per mate + rescue."""
    idx, dix = setup
    pairs = simulate_pairs(idx.genome, 40, read_len=70, seed=91,
                           sub_rate=0.01, indel_rate=0.005,
                           min_insert=150, max_insert=400)
    cfg = cfg_pe(max_errors=4, indels=True, non_directional=True,
                 read_len_bucket=96, batch_size=40, min_insert=100,
                 max_insert=450)
    _compare(idx, dix, cfg, pairs)
