"""Multi-device tests on the virtual 8-CPU mesh (SURVEY.md section 4 items
4-5): data-parallel determinism across shardings, sharded-index parity."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from bitmapperbs_tpu.config import AlignerConfig
from bitmapperbs_tpu.index.build import build_index
from bitmapperbs_tpu.index.device import upload_index
from bitmapperbs_tpu.models.aligner import map_batch_device
from bitmapperbs_tpu.models.host import prepare_batch
from bitmapperbs_tpu.parallel.shard import make_sharded_se_mapper
from bitmapperbs_tpu.utils.simulate import random_genome_fasta, simulate_reads

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(31)
    idx = build_index(random_genome_fasta(rng, contigs=(8000, 3000)))
    cfg = AlignerConfig(max_errors=3, indels=True, read_len_bucket=64,
                        batch_size=64)
    sims = simulate_reads(idx.genome, 64, read_len=60, seed=7, sub_rate=0.01)
    reads, lengths = prepare_batch([s.codes for s in sims], 64, 64)
    return idx, cfg, jnp.asarray(reads), jnp.asarray(lengths)


def _as_np(out):
    return {k: np.asarray(v) for k, v in out.items()}


def test_data_parallel_matches_single_device(setup):
    idx, cfg, reads, lengths = setup
    dix = upload_index(idx)
    ref = _as_np(map_batch_device(dix, cfg, reads, lengths))

    for n in (2, 8):
        mesh = Mesh(np.array(jax.devices()[:n]), ("data",))
        dix_r = jax.device_put(dix, NamedSharding(mesh, P()))
        reads_s = jax.device_put(reads, NamedSharding(mesh, P("data", None)))
        len_s = jax.device_put(lengths, NamedSharding(mesh, P("data")))
        fn = make_sharded_se_mapper(cfg, mesh, dix_r)
        got = _as_np(fn(dix_r, reads_s, len_s))
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=f"{n}:{k}")


@pytest.mark.parametrize("idx_axis", [None, "idx"])
def test_chunked_mesh_upload_matches_direct(setup, monkeypatch, idx_axis):
    """Mesh uploads with the chunked path forced (tiny threshold, ragged
    chunks) equal the direct put in values and placement: replicated, every
    device's copy equals the single-device upload; sharded over idx, each
    device holds only its rows."""
    from bitmapperbs_tpu.index import device as dev

    idx = setup[0]
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("data", "idx"))
    single = dev.upload_index(idx)
    direct = dev.upload_index(idx, mesh=mesh, idx_axis=idx_axis)
    monkeypatch.setattr(dev, "_PUT_THRESHOLD", 64)
    monkeypatch.setattr(dev, "_CHUNK_BYTES", 1000)
    chunked = dev.upload_index(idx, mesh=mesh, idx_axis=idx_axis)
    for f in ("cp_rows", "cbase", "sa_samples", "n", "g_planes", "klt"):
        a, b = getattr(direct, f), getattr(chunked, f)
        assert b.sharding.is_equivalent_to(a.sharding, a.ndim), f
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=f)
        if b.sharding.is_fully_replicated:
            want = np.asarray(getattr(single, f))
            for sh in b.addressable_shards:
                np.testing.assert_array_equal(np.asarray(sh.data), want,
                                              err_msg=f"{f} {sh.device}")
        else:
            assert {sh.data.shape[0] for sh in b.addressable_shards} == {
                b.shape[0] // mesh.shape["idx"]}, f


def test_sharded_index_matches_replicated(setup):
    idx, cfg, reads, lengths = setup
    dix = upload_index(idx)
    ref = _as_np(map_batch_device(dix, cfg, reads, lengths))

    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("data", "idx"))
    dix_s = upload_index(idx, mesh=mesh, idx_axis="idx")
    reads_s = jax.device_put(reads, NamedSharding(mesh, P("data", None)))
    len_s = jax.device_put(lengths, NamedSharding(mesh, P("data")))
    fn = make_sharded_se_mapper(cfg, mesh, dix_s)
    got = _as_np(fn(dix_s, reads_s, len_s))
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_batch_split_invariance(setup):
    """Same reads, different batch partitioning -> identical per-read output
    (the frozen selection is order-free; SURVEY.md hard-part 3)."""
    idx, cfg, reads, lengths = setup
    dix = upload_index(idx)
    full = _as_np(map_batch_device(dix, cfg, reads, lengths))
    cfg2 = cfg.replace(batch_size=32)
    h1 = _as_np(map_batch_device(dix, cfg2, reads[:32], lengths[:32]))
    h2 = _as_np(map_batch_device(dix, cfg2, reads[32:], lengths[32:]))
    for k in ("best_score", "best_bp", "best_anchor", "second_score"):
        np.testing.assert_array_equal(
            np.concatenate([h1[k], h2[k]]), full[k], err_msg=k)


def test_pe_data_parallel_matches_single_device(setup):
    """PE pipeline under shard_map == single-device PE, bitwise."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from bitmapperbs_tpu.models.paired import map_batch_pe_device
    from bitmapperbs_tpu.models.host import prepare_batch
    from bitmapperbs_tpu.parallel.shard import make_sharded_pe_mapper
    from bitmapperbs_tpu.utils.simulate import simulate_pairs

    idx, cfg, _, _ = setup
    dix = upload_index(idx)
    pe_cfg = cfg.replace(paired=True, min_insert=100, max_insert=400,
                         batch_size=32)
    prs = simulate_pairs(idx.genome, 32, read_len=60, seed=61, sub_rate=0.01,
                         min_insert=150, max_insert=350)
    a1, l1 = prepare_batch([p[0].codes for p in prs], 64, 32)
    a2, l2 = prepare_batch([p[1].codes for p in prs], 64, 32)
    args = tuple(jnp.asarray(x) for x in (a1, l1, a2, l2))

    single = map_batch_pe_device(dix, pe_cfg, *args)

    mesh = Mesh(np.array(jax.devices()[:8]), ("data",))
    fn = make_sharded_pe_mapper(pe_cfg.replace(batch_size=4), mesh, dix)
    with mesh:
        sharded = fn(dix, *args)

    def cmp(a, b):
        for k in a:
            if isinstance(a[k], dict):
                cmp(a[k], b[k])
            else:
                np.testing.assert_array_equal(np.asarray(a[k]),
                                              np.asarray(b[k]), err_msg=k)
    cmp(single, sharded)


def test_flat_chunks_data_parallel(setup):
    """flat_chunks under the shard_map DP mapper (the CLI multichip path)
    must stay bit-identical: each shard runs its own occupancy-bounded
    while_loop, no cross-shard coupling."""
    idx, cfg, reads, lengths = setup
    dix = upload_index(idx)
    ref = _as_np(map_batch_device(dix, cfg, reads, lengths))

    cfgc = cfg.replace(flat_chunks=8)
    mesh = Mesh(np.array(jax.devices()[:8]), ("data",))
    dix_r = jax.device_put(dix, NamedSharding(mesh, P()))
    reads_s = jax.device_put(reads, NamedSharding(mesh, P("data", None)))
    len_s = jax.device_put(lengths, NamedSharding(mesh, P("data")))
    fn = make_sharded_se_mapper(cfgc, mesh, dix_r)
    got = _as_np(fn(dix_r, reads_s, len_s))
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_sharded_index_with_seed_extension(setup):
    """Seed extension's per-step occ gathers go through the psum-merged
    sharded fetch path; outputs must stay bitwise identical to the
    replicated single-device run with the same extension config."""
    idx, cfg, reads, lengths = setup
    cfg = cfg.replace(seed_ext_max=10, seed_ext_occ=2, max_candidates=16)
    dix = upload_index(idx)
    ref = _as_np(map_batch_device(dix, cfg, reads, lengths))

    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("data", "idx"))
    dix_s = upload_index(idx, mesh=mesh, idx_axis="idx")
    reads_s = jax.device_put(reads, NamedSharding(mesh, P("data", None)))
    len_s = jax.device_put(lengths, NamedSharding(mesh, P("data")))
    fn = make_sharded_se_mapper(cfg, mesh, dix_s)
    got = _as_np(fn(dix_s, reads_s, len_s))
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
