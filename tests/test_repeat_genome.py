"""Repeat-structured genome: the adaptive-seeding regime.

plant_repeats builds the heavy-tailed seed-occupancy distribution that
uniform-random genomes lack (SURVEY.md C9 / section 7 hard-part 2); these
tests pin the generator's statistics and that the mapper stays correct and
deterministic on such a genome.
"""
import numpy as np
import pytest

from bitmapperbs_tpu.config import AlignerConfig
from bitmapperbs_tpu.index.build import build_index
from bitmapperbs_tpu.index.device import upload_index
from bitmapperbs_tpu.models.aligner import INF, map_batch_device
from bitmapperbs_tpu.models.host import prepare_batch
from bitmapperbs_tpu.utils.simulate import (plant_repeats,
                                            repeat_genome_fasta,
                                            simulate_reads)


def test_plant_repeats_heavy_tail():
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, 4_000_000).astype(np.uint8)
    uniform = codes.copy()
    stats = plant_repeats(rng, codes)
    assert stats["dispersed"] > 100 and stats["tandem"] >= 1

    def max_kmer_count(c, k=16, n=1_000_000):
        w = np.lib.stride_tricks.sliding_window_view(c[:n], k)
        h = (w.astype(np.uint64)
             * (4 ** np.arange(k, dtype=np.uint64))).sum(1)
        return int(np.unique(h, return_counts=True)[1].max())

    assert max_kmer_count(uniform) <= 3
    assert max_kmer_count(codes) > 10   # dispersed families dominate


def test_plant_repeats_record_is_rng_neutral():
    """record= must consume no rng draws and cover every changed base --
    scripts/rep_intervals.py replays the generator with record= to recover
    the planted intervals of an already-built genome, which is only sound
    under both properties."""
    rng1 = np.random.default_rng(3)
    c1 = rng1.integers(0, 4, 2_000_000).astype(np.uint8)
    backbone = c1.copy()
    rng2 = np.random.default_rng(3)
    c2 = rng2.integers(0, 4, 2_000_000).astype(np.uint8)
    rec: list = []
    plant_repeats(rng1, c1, record=rec)
    plant_repeats(rng2, c2)
    np.testing.assert_array_equal(c1, c2)
    assert rec and all(0 <= s < e <= len(c1) for s, e, _ in rec)
    covered = np.zeros(len(c1), dtype=bool)
    for s, e, _ in rec:
        covered[s:e] = True
    changed = c1 != backbone
    assert not (changed & ~covered).any()


@pytest.fixture(scope="module")
def rep_setup():
    rng = np.random.default_rng(5)
    fa = repeat_genome_fasta(rng, contigs=(700_000, 300_000))
    idx = build_index(fa)
    return idx, upload_index(idx)


def test_repeat_genome_recall(rep_setup):
    """Gbp-autotune config (adaptive seed extension + Kc128) keeps recall
    on a repeat-structured genome; unique-region reads stay correct."""
    import jax.numpy as jnp
    idx, dix = rep_setup
    n = 512
    sims = simulate_reads(idx.genome, n, read_len=90, seed=7,
                          sub_rate=0.01, indel_rate=0.005)
    cfg = AlignerConfig(max_errors=4, indels=True, read_len_bucket=96,
                        batch_size=n, seed_ext_max=20, seed_ext_occ=4,
                        max_candidates=128)
    arr, lengths = prepare_batch([s.codes for s in sims], 96, n)
    out = map_batch_device(dix, cfg, jnp.asarray(arr), jnp.asarray(lengths))
    bs = np.asarray(out["best_score"])
    ba = np.asarray(out["best_anchor"])
    bp = np.asarray(out["best_bp"])
    L = idx.genome.length
    correct = mapped = 0
    for i, s in enumerate(sims):
        if bs[i] >= int(INF):
            continue
        mapped += 1
        b = int(bp[i]) >> 1
        a = int(ba[i])
        fwd = a if b == 0 else L - a - int(np.asarray(lengths)[i])
        true = int(idx.genome.offsets[s.contig]) + s.coord
        correct += abs(fwd - true) <= 4
    # repeat-derived reads legitimately multi-map (the device reports one
    # best; a copy elsewhere can genuinely score <= truth), so the bar is
    # placement-correctness of most reads, not near-1.0 recall
    assert mapped / n > 0.97
    assert correct / n > 0.80


def test_repeat_genome_batch_split_deterministic(rep_setup):
    """Order-free selection invariant holds under the heavy tail: mapping
    in one batch == mapping in two half batches (CLAUDE.md invariant)."""
    import jax.numpy as jnp
    idx, dix = rep_setup
    n = 256
    sims = simulate_reads(idx.genome, n, read_len=90, seed=9, sub_rate=0.01)
    cfg = AlignerConfig(max_errors=4, indels=True, read_len_bucket=96,
                        batch_size=n, seed_ext_max=20, seed_ext_occ=4,
                        max_candidates=128)
    arr, lengths = prepare_batch([s.codes for s in sims], 96, n)
    full = map_batch_device(dix, cfg, jnp.asarray(arr), jnp.asarray(lengths))
    cfg_h = cfg.replace(batch_size=n // 2)
    h1 = map_batch_device(dix, cfg_h, jnp.asarray(arr[:n // 2]),
                          jnp.asarray(lengths[:n // 2]))
    h2 = map_batch_device(dix, cfg_h, jnp.asarray(arr[n // 2:]),
                          jnp.asarray(lengths[n // 2:]))
    for k in ("best_score", "best_anchor", "best_bp", "second_score"):
        np.testing.assert_array_equal(
            np.asarray(full[k]),
            np.concatenate([np.asarray(h1[k]), np.asarray(h2[k])]), k)
