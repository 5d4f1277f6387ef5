"""Golden differential test: device pipeline SAM == oracle SAM, byte-for-byte
(SURVEY.md section 4 item 3; BASELINE config 1/2 exit criterion)."""
import numpy as np
import pytest

from bitmapperbs_tpu.config import AlignerConfig
from bitmapperbs_tpu.index.build import build_index
from bitmapperbs_tpu.index.device import upload_index
from bitmapperbs_tpu.models.host import map_reads
from bitmapperbs_tpu.oracle.pipeline import map_batch_se
from bitmapperbs_tpu.utils.simulate import random_genome_fasta, simulate_reads


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(21)
    idx = build_index(random_genome_fasta(rng, contigs=(5000, 2000)))
    return idx, upload_index(idx)


def _compare(idx, dix, cfg, sims):
    reads = [s.codes for s in sims]
    quals = [s.qual for s in sims]
    oracle = [r.line() for r in map_batch_se(idx, cfg, reads, quals)]
    device = [r.line() for r in map_reads(idx, dix, cfg, reads, quals)]
    mism = [i for i, (a, b) in enumerate(zip(oracle, device)) if a != b]
    assert not mism, (
        f"{len(mism)} mismatching records, first: "
        f"\n oracle: {oracle[mism[0]]}\n device: {device[mism[0]]}")
    return oracle


def test_mismatch_only_parity(setup):
    idx, dix = setup
    sims = simulate_reads(idx.genome, 80, read_len=96, seed=31, sub_rate=0.01)
    cfg = AlignerConfig(max_errors=3, indels=False, read_len_bucket=96,
                        batch_size=80)
    recs = _compare(idx, dix, cfg, sims)
    assert sum("\t16\t" in r or "\t0\t" in r for r in recs) > 70


def test_indel_mode_parity(setup):
    idx, dix = setup
    sims = simulate_reads(idx.genome, 60, read_len=90, seed=32,
                          sub_rate=0.01, indel_rate=0.01)
    cfg = AlignerConfig(max_errors=4, indels=True, read_len_bucket=96,
                        batch_size=60)
    _compare(idx, dix, cfg, sims)


def test_non_directional_parity(setup):
    idx, dix = setup
    sims = simulate_reads(idx.genome, 60, read_len=80, seed=33, sub_rate=0.005,
                          protocols=("OT", "OB", "CTOT", "CTOB"))
    cfg = AlignerConfig(max_errors=3, indels=True, non_directional=True,
                        read_len_bucket=96, batch_size=60)
    _compare(idx, dix, cfg, sims)


def test_variable_length_bucket_parity(setup):
    idx, dix = setup
    rng = np.random.default_rng(5)
    sims = simulate_reads(idx.genome, 50, read_len=90, seed=34, sub_rate=0.01)
    for s in sims:  # truncate to varied lengths within the bucket
        s.codes = s.codes[:int(rng.integers(50, 91))]
    cfg = AlignerConfig(max_errors=3, indels=True, read_len_bucket=96,
                        batch_size=50)
    reads = [s.codes for s in sims]
    oracle = [r.line() for r in map_batch_se(idx, cfg, reads)]
    device = [r.line() for r in map_reads(idx, dix, cfg, reads)]
    assert oracle == device


def test_repeats_and_ambiguity_parity():
    rng = np.random.default_rng(9)
    unit = "".join(rng.choice(list("ACGT"), size=400))
    fasta = f">rep\n{unit}{unit}\n>uniq\n" + "".join(
        rng.choice(list("ACGT"), size=1500)) + "\n"
    idx = build_index(fasta)
    dix = upload_index(idx)
    sims = simulate_reads(idx.genome, 60, read_len=64, seed=35, sub_rate=0.01)
    cfg = AlignerConfig(max_errors=2, indels=True, read_len_bucket=64,
                        batch_size=60)
    _compare(idx, dix, cfg, sims)


def test_compact_vs_dense_grids(setup):
    """Compacted candidate pipeline is bit-identical to the dense spec path
    (same grids, not just same selection), including overflow flags."""
    import jax.numpy as jnp
    from bitmapperbs_tpu.models import aligner
    from bitmapperbs_tpu.models.host import prepare_batch
    idx, dix = setup
    rng = np.random.default_rng(11)
    sims = simulate_reads(idx.genome, 64, read_len=90, seed=36,
                          sub_rate=0.02, indel_rate=0.01)
    reads = [s.codes for s in sims]
    for s, cut in zip(sims, rng.integers(40, 91, len(sims))):
        s.codes = s.codes[:cut]
    for nd, indels in ((False, True), (True, True), (False, False)):
        cfg = AlignerConfig(max_errors=4, indels=indels, non_directional=nd,
                            read_len_bucket=96, batch_size=64)
        arr, lengths = prepare_batch(reads, 96, 64)
        frames = tuple(aligner.frames_for(cfg))
        gd = aligner.candidate_grids(dix, cfg, jnp.asarray(arr),
                                     jnp.asarray(lengths), frames)
        gc = aligner.candidate_grids_compact(dix, cfg, jnp.asarray(arr),
                                             jnp.asarray(lengths), frames)
        assert not np.asarray(gc["gdrop"]).any()
        for k in ("score", "fwd", "frame_a", "bp", "overflow"):
            np.testing.assert_array_equal(np.asarray(gd[k]),
                                          np.asarray(gc[k]), err_msg=k)


def test_gdrop_fallback_sam_equal(setup):
    """A tiny flat buffer forces gdrop; the host fallback restores exact
    dense/oracle SAM for the flagged reads."""
    import jax.numpy as jnp
    from bitmapperbs_tpu.models.aligner import map_batch_device
    idx, dix = setup
    sims = simulate_reads(idx.genome, 40, read_len=90, seed=37, sub_rate=0.01)
    reads = [s.codes for s in sims]
    cfg = AlignerConfig(max_errors=3, indels=True, read_len_bucket=96,
                        batch_size=40, locate_flat_cap=1)
    from bitmapperbs_tpu.models.host import prepare_batch
    arr, lengths = prepare_batch(reads, 96, 40)
    out = map_batch_device(dix, cfg, jnp.asarray(arr), jnp.asarray(lengths))
    assert np.asarray(out["gdrop"]).any()  # cap=1 must overflow somewhere
    oracle = [r.line() for r in map_batch_se(idx, cfg, reads)]
    device = [r.line() for r in map_reads(idx, dix, cfg, reads)]
    assert oracle == device


def test_truncation_prefers_specific_seeds():
    """With a tiny locate budget and a junk (high-frequency) first seed,
    ascending-frequency expansion must still find the true locus."""
    import jax.numpy as jnp
    from bitmapperbs_tpu.models.host import map_reads

    rng = np.random.default_rng(77)
    # genome: long T-homopolymer region (junk seeds) + unique sequence
    junk = "T" * 600
    uniq = "".join(rng.choice(list("ACG"), size=3000))
    idx = build_index(f">c\n{junk}{uniq}\n")
    dix = upload_index(idx)
    # read whose FIRST seed lies in the junk region, rest unique: pos ~580
    start = int(idx.genome.offsets[0]) + 580
    frag = idx.genome.codes[start:start + 80]
    read = np.where(frag == 1, 3, frag).astype(np.uint8)  # OT converted
    cfg = AlignerConfig(max_errors=3, indels=True, read_len_bucket=96,
                        batch_size=1, locate_budget=8, max_seed_occ=64)
    recs = map_reads(idx, dix, cfg, [read])
    assert recs[0].pos == 581, recs[0].line()
    oracle = map_batch_se(idx, cfg, [read])
    assert recs[0].line() == oracle[0].line()


def test_flat_chunks_bit_identical(setup):
    """Occupancy-chunked locate/verify (flat_chunks=N) must be bit-identical
    to the single-pass compact path in every mode: skipped lanes are exactly
    the masked ones."""
    import jax.numpy as jnp
    from bitmapperbs_tpu.models.aligner import map_batch_device
    from bitmapperbs_tpu.models.host import prepare_batch

    idx, dix = setup
    B = 64
    sims = simulate_reads(idx.genome, B, read_len=90, seed=9,
                          sub_rate=0.02, indel_rate=0.01)
    arr, lengths = prepare_batch([s.codes for s in sims], 96, B)
    arr, lengths = jnp.asarray(arr), jnp.asarray(lengths)
    for base in (
        AlignerConfig(max_errors=4, indels=True, read_len_bucket=96,
                      batch_size=B, use_pallas=False),
        AlignerConfig(max_errors=3, indels=False, read_len_bucket=96,
                      batch_size=B, non_directional=True, use_pallas=False),
    ):
        o0 = map_batch_device(dix, base, arr, lengths)
        for nc in (2, 8, 13):
            oc = map_batch_device(dix, base.replace(flat_chunks=nc),
                                  arr, lengths)
            for k in o0:
                np.testing.assert_array_equal(
                    np.asarray(o0[k]), np.asarray(oc[k]),
                    err_msg=f"chunks={nc} key={k}")


def test_seed_extension_parity():
    """Adaptive seed extension (C9): on a repeat-salted genome where seeds
    go heavy, oracle and device stay byte-identical with extension on, the
    compact path stays bit-identical to dense, and extension recovers reads
    the capped no-extension config loses."""
    rng = np.random.default_rng(77)
    unit = "".join(rng.choice(list("ACGT"), size=200))
    fa = random_genome_fasta(rng, contigs=(8000,)) + f">rep\n{unit * 40}\n"
    idx = build_index(fa)
    dix = upload_index(idx)
    sims = simulate_reads(idx.genome, 64, read_len=60, seed=9, sub_rate=0.02,
                          indel_rate=0.01)
    base = AlignerConfig(max_errors=3, indels=True, read_len_bucket=64,
                         batch_size=64, max_candidates=8, max_seed_occ=48,
                         locate_budget=64)
    ext = base.replace(seed_ext_max=12, seed_ext_occ=2)
    recs_ext = _compare(idx, dix, ext, sims)        # oracle == device
    reads = [s.codes for s in sims]

    # extension must actually fire: it shrinks the occupied-entry totals
    # (the 3 Gbp benefit study lives in PERF.md; at toy scale the assertion
    # is just that heavy repeat seeds got extended)
    from bitmapperbs_tpu.models.aligner import (_order_seeds, _seed_stage,
                                                candidate_grids,
                                                candidate_grids_compact,
                                                frames_for)
    import jax.numpy as jnp
    from bitmapperbs_tpu.models.host import prepare_batch
    arr, lengths = prepare_batch(reads, 64, 64)
    arr, lengths = jnp.asarray(arr), jnp.asarray(lengths)
    frames = tuple(frames_for(ext))

    def occupancy(cfg):
        _, _, _, st, sp, ep = _seed_stage(dix, cfg, arr, lengths, frames)
        cnt, _, _ = _order_seeds(cfg, sp, ep, st)
        return int(np.asarray(cnt).sum())
    assert occupancy(ext) < occupancy(base), (occupancy(ext),
                                              occupancy(base))
    g1 = candidate_grids(dix, ext, arr, lengths, frames)
    g2 = candidate_grids_compact(dix, ext, arr, lengths, frames)
    ok = ~np.asarray(g2["gdrop"])       # gdrop lanes are DEFINED to differ
    assert ok.any()                     # (the host reruns them dense)
    for k in ("score", "fwd", "frame_a", "bp"):
        a, b = np.asarray(g1[k]), np.asarray(g2[k])
        assert (a[ok] == b[ok]).all(), k
