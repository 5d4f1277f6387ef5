"""Edge-input robustness: long reads (Wd=5 kernels), N-heavy reads, reads
shorter than the seed count, higher error budgets -- all against the oracle
(byte-identical SAM)."""
import numpy as np
import pytest

from bitmapperbs_tpu.config import AlignerConfig
from bitmapperbs_tpu.index.build import build_index
from bitmapperbs_tpu.index.device import upload_index
from bitmapperbs_tpu.models.host import map_reads
from bitmapperbs_tpu.oracle.pipeline import map_batch_se
from bitmapperbs_tpu import constants as K
from bitmapperbs_tpu.utils.simulate import random_genome_fasta, simulate_reads


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(29)
    idx = build_index(random_genome_fasta(rng, contigs=(8000, 3000)))
    return idx, upload_index(idx)


def _compare(idx, dix, cfg, reads):
    oracle = [r.line() for r in map_batch_se(idx, cfg, reads)]
    device = [r.line() for r in map_reads(idx, dix, cfg, reads)]
    assert oracle == device
    return oracle


def test_long_reads_151bp(setup):
    """151 bp reads in a 160 bucket: Wd=5 word paths in every kernel."""
    idx, dix = setup
    sims = simulate_reads(idx.genome, 40, read_len=151, seed=51,
                          sub_rate=0.01, indel_rate=0.005)
    cfg = AlignerConfig(max_errors=5, indels=True, read_len_bucket=160,
                        batch_size=40)
    recs = _compare(idx, dix, cfg, [s.codes for s in sims])
    assert sum("\t151M\t" in r or "M" in r.split("\t")[5] for r in recs) > 30


def test_n_heavy_and_degenerate_reads(setup):
    idx, dix = setup
    rng = np.random.default_rng(5)
    sims = simulate_reads(idx.genome, 20, read_len=80, seed=52, sub_rate=0.01)
    reads = [s.codes for s in sims]
    # inject Ns at random positions
    for r in reads[:10]:
        r[rng.integers(0, len(r), 3)] = K.N_CODE
    # an all-N read, a homopolymer, and a tiny read (< num_seeds chars)
    reads.append(np.full(80, K.N_CODE, dtype=np.uint8))
    reads.append(np.full(80, K.A, dtype=np.uint8))
    reads.append(np.array([K.A, K.C, K.G], dtype=np.uint8))
    cfg = AlignerConfig(max_errors=3, indels=True, read_len_bucket=96,
                        batch_size=len(reads))
    _compare(idx, dix, cfg, reads)


def test_sensitive_preset_high_errors(setup):
    idx, dix = setup
    sims = simulate_reads(idx.genome, 30, read_len=90, seed=53,
                          sub_rate=0.05, indel_rate=0.01)
    cfg = AlignerConfig(max_errors=6, indels=True, read_len_bucket=96,
                        batch_size=30, max_seed_occ=128, locate_budget=256,
                        max_candidates=64, locate_flat_cap=32)
    recs = _compare(idx, dix, cfg, [s.codes for s in sims])
    mapped = sum("\t0\t*\t0\t0\t*" not in r for r in recs)
    assert mapped > 20


def test_mismatch_only_mode_parity(setup):
    idx, dix = setup
    sims = simulate_reads(idx.genome, 30, read_len=64, seed=54, sub_rate=0.02)
    cfg = AlignerConfig(max_errors=2, indels=False, read_len_bucket=64,
                        batch_size=30)
    _compare(idx, dix, cfg, [s.codes for s in sims])
