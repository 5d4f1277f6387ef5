"""Finalize worker pool (-t): spawned numpy-only workers must produce
records byte-identical to the in-process path (SE and PE)."""
import numpy as np
import pytest

from bitmapperbs_tpu.config import AlignerConfig
from bitmapperbs_tpu.index.build import build_index
from bitmapperbs_tpu.index.device import upload_index
from bitmapperbs_tpu.models.host import (make_finalize_pool, map_pairs,
                                         map_reads)
from bitmapperbs_tpu.utils.simulate import (random_genome_fasta,
                                            simulate_pairs, simulate_reads)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(23)
    idx = build_index(random_genome_fasta(rng, contigs=(6000,)))
    return idx, upload_index(idx)


def test_pool_matches_inprocess(setup):
    idx, dix = setup
    cfg = AlignerConfig(max_errors=3, indels=True, read_len_bucket=64,
                        batch_size=24)
    pool = make_finalize_pool(idx, cfg, 2)
    try:
        sims = simulate_reads(idx.genome, 50, read_len=60, seed=7,
                              sub_rate=0.02, indel_rate=0.01)
        reads = [s.codes for s in sims]
        a = [r.line() for r in map_reads(idx, dix, cfg, reads)]
        b = [r.line() for r in map_reads(idx, dix, cfg, reads, pool=pool)]
        assert a == b

        pe_cfg = cfg.replace(paired=True, min_insert=100, max_insert=400)
        prs = simulate_pairs(idx.genome, 20, read_len=60, seed=8,
                             sub_rate=0.01, min_insert=150, max_insert=350)
        inp = [(p[0].codes, p[1].codes) for p in prs]
        pool2 = make_finalize_pool(idx, pe_cfg, 2)
        try:
            a = [r.line() for r in map_pairs(idx, dix, pe_cfg, inp)]
            b = [r.line() for r in map_pairs(idx, dix, pe_cfg, inp,
                                                    pool=pool2)]
            assert a == b
        finally:
            pool2.terminate()
    finally:
        pool.terminate()
