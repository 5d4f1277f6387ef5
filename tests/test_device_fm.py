"""Device (jnp, CPU backend) FM ops vs host packed readers (SURVEY.md 4.2)."""
import numpy as np
import pytest

from bitmapperbs_tpu import constants as K
from bitmapperbs_tpu.index import packed
from bitmapperbs_tpu.index.build import build_index
from bitmapperbs_tpu.index.device import upload_index
from bitmapperbs_tpu.utils import dna
from bitmapperbs_tpu.utils.simulate import random_genome_fasta


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(3)
    idx = build_index(random_genome_fasta(rng, contigs=(3000, 1000)))
    return idx, upload_index(idx)


def test_occ_parity(setup, rng):
    import jax.numpy as jnp
    from bitmapperbs_tpu.ops import fm
    idx, dix = setup
    n = 400
    block = rng.integers(0, 2, n).astype(np.int32)
    c = rng.integers(0, K.CONV_ALPHA, n).astype(np.uint32)
    i = np.array([rng.integers(0, idx.blocks[b].n + 1) for b in block],
                 dtype=np.uint32)
    got = np.asarray(fm.occ(dix, jnp.asarray(block), jnp.asarray(c),
                            jnp.asarray(i)))
    want = np.array([packed.occ(idx.blocks[b], cc, ii)
                     for b, cc, ii in zip(block, c, i)])
    np.testing.assert_array_equal(got.astype(np.int64), want.astype(np.int64))


def test_locate_parity(setup, rng):
    import jax.numpy as jnp
    from bitmapperbs_tpu.ops import fm
    idx, dix = setup
    n = 500
    block = rng.integers(0, 2, n).astype(np.int32)
    i = np.array([rng.integers(0, idx.blocks[b].n) for b in block],
                 dtype=np.uint32)
    got = np.asarray(fm.locate(dix, jnp.asarray(block), jnp.asarray(i),
                               jnp.ones(n, dtype=bool)))
    want = np.concatenate([
        packed.locate(idx.blocks[0], i[block == 0]),
        packed.locate(idx.blocks[1], i[block == 1])])
    order = np.concatenate([np.flatnonzero(block == 0),
                            np.flatnonzero(block == 1)])
    np.testing.assert_array_equal(got[order].astype(np.int64),
                                  want.astype(np.int64))


def test_search_parity(setup, rng):
    import jax.numpy as jnp
    from bitmapperbs_tpu.ops import fm
    idx, dix = setup
    m, nseeds = 64, 40
    conv = dna.ct_convert(idx.genome.codes)
    pats, starts, ends, blocks = [], [], [], []
    for _ in range(nseeds):
        pos = int(rng.integers(300, 2500))
        pats.append(conv[pos:pos + m])
        s = int(rng.integers(0, m - 16))
        starts.append(s)
        ends.append(s + int(rng.integers(8, 17)))
        blocks.append(int(rng.integers(0, 2)))
    pats = np.stack(pats)
    sp, ep = fm.search_patterns(
        dix, jnp.asarray(blocks, jnp.int32), jnp.asarray(pats),
        jnp.asarray(starts, jnp.int32), jnp.asarray(ends, jnp.int32),
        max_len=17)
    sp, ep = np.asarray(sp), np.asarray(ep)
    for k in range(nseeds):
        wsp, wep = packed.count(idx.blocks[blocks[k]],
                                pats[k, starts[k]:ends[k]])
        assert (int(sp[k]), int(ep[k])) == (wsp, wep), k


def test_klt_exact_vs_plain(setup, rng):
    """KLT-initialized search is bit-identical to the plain serial loop,
    including short slices (< klt_k) and empty intervals (freeze parity)."""
    import jax.numpy as jnp
    from bitmapperbs_tpu.ops import fm
    idx, dix = setup
    assert dix.klt_k > 0
    m, nseeds = 64, 60
    conv = dna.ct_convert(idx.genome.codes)
    pats, starts, ends, blocks = [], [], [], []
    for t in range(nseeds):
        pos = int(rng.integers(300, 2500))
        p = conv[pos:pos + m].copy()
        if t % 3 == 0:  # inject mismatches so some intervals empty mid-seed
            p[rng.integers(0, m, 3)] = rng.integers(1, 4, 3)
        pats.append(p)
        s = int(rng.integers(0, m - 24))
        starts.append(s)
        # lengths straddling klt_k: shorter, equal, and longer slices
        ends.append(s + int(rng.integers(2, 25)))
        blocks.append(int(rng.integers(0, 2)))
    pats = np.stack(pats)
    args = (jnp.asarray(blocks, np.int32), jnp.asarray(pats),
            jnp.asarray(starts, np.int32), jnp.asarray(ends, np.int32))
    sp0, ep0 = fm.search_patterns(dix, *args, max_len=25)
    km = fm.rolling_kmers(jnp.asarray(pats), dix.klt_k)
    ek = jnp.take_along_axis(
        km, jnp.clip(jnp.asarray(ends, np.int32) - 1, 0, m - 1)[:, None],
        axis=-1)[:, 0]
    sp1, ep1 = fm.search_patterns(dix, *args, max_len=25, end_kmers=ek)
    np.testing.assert_array_equal(np.asarray(sp0), np.asarray(sp1))
    np.testing.assert_array_equal(np.asarray(ep0), np.asarray(ep1))


def test_klt_entries_match_count(setup, rng):
    """Table entries equal a fresh backward search of the k-mer itself."""
    idx, _ = setup
    b = idx.blocks[0]
    k = b.klt_k
    for _ in range(50):
        digits = rng.integers(0, 3, k)
        kmer = (digits + 1).astype(np.uint8)   # codes 1..3
        # build_klt convention: step t consumes position end-1-t, i.e. the
        # pattern read right-to-left; digit t is pattern[k-1-t] - 1
        idx3 = int(sum(int(d) * 3 ** t for t, d in enumerate(digits[::-1])))
        wsp, wep = packed.count(b, kmer)
        got = b.klt[idx3]
        if wsp >= wep:
            assert got[0] >= got[1]
        else:
            assert (int(got[0]), int(got[1])) == (wsp, wep)


def test_chunked_put_matches_direct(setup, monkeypatch):
    """Chunked upload (bounded host staging of big arrays) is bit-identical
    to a direct device_put, including the non-divisible last chunk."""
    from bitmapperbs_tpu.index import device as dev
    idx, dix = setup
    monkeypatch.setattr(dev, "_PUT_THRESHOLD", 64)
    monkeypatch.setattr(dev, "_CHUNK_BYTES", 1000)   # forces ragged chunks
    dix2 = dev.upload_index(idx)
    for f in ("cp_rows", "cbase", "sa_samples", "n", "g_planes", "klt"):
        np.testing.assert_array_equal(np.asarray(getattr(dix, f)),
                                      np.asarray(getattr(dix2, f)), err_msg=f)

def test_upload_from_artifact_matches_inram(setup, tmp_path):
    """mmap-loaded artifact upload (stitched per-block puts + genome-plane
    sidecar cache) is bit-identical to the in-RAM upload, and the plane
    cache file is created once and reused."""
    import os

    from bitmapperbs_tpu.index import device as dev
    from bitmapperbs_tpu.index.build import load_index, save_index
    idx, dix = setup
    prefix = str(tmp_path / "art")
    save_index(idx, prefix)
    idx2 = load_index(prefix)
    assert idx2.source_prefix == prefix
    dix2 = dev.upload_index(idx2)   # creates the plane cache
    cache = dev._planes_cache_path(idx2)
    assert cache is not None and os.path.exists(cache)
    mtime = os.path.getmtime(cache)
    for f in ("cp_rows", "cbase", "sa_samples", "n", "g_planes", "klt"):
        np.testing.assert_array_equal(np.asarray(getattr(dix, f)),
                                      np.asarray(getattr(dix2, f)), err_msg=f)
    dix3 = dev.upload_index(idx2)   # second upload reuses the cache
    assert os.path.getmtime(cache) == mtime
    np.testing.assert_array_equal(np.asarray(dix2.g_planes),
                                  np.asarray(dix3.g_planes))


def test_upload_ignores_stale_plane_cache(setup, tmp_path):
    """A size-mismatched plane cache is rebuilt in RAM, not trusted."""
    import os

    from bitmapperbs_tpu.index import device as dev
    from bitmapperbs_tpu.index.build import load_index, save_index
    idx, dix = setup
    prefix = str(tmp_path / "art")
    save_index(idx, prefix)
    idx2 = load_index(prefix)
    cache = dev._planes_cache_path(idx2)
    np.zeros(7, dtype=np.uint32).tofile(cache)   # wrong size
    dix2 = dev.upload_index(idx2)
    np.testing.assert_array_equal(np.asarray(dix.g_planes),
                                  np.asarray(dix2.g_planes))
