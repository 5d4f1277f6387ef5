"""shard_map pipelines over a device mesh (SURVEY.md 2.2 / 3.5, config 5).

Two modes:
- replicated index (default): mesh ('data',), reads sharded over devices,
  DeviceIndex replicated; zero collectives in the hot path.
- sharded index: mesh ('data', 'idx'), DeviceIndex's big arrays sharded over
  'idx', reads sharded over 'data' and replicated over 'idx'; every index
  fetch psum-merges shard-local partial rows over 'idx' (ops/fm.fetch_*).

Both modes produce bitwise-identical results to the single-device pipeline
(frozen order-free selection), which the mesh tests assert.
"""
from __future__ import annotations

import dataclasses

import numpy as np

import jax
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from bitmapperbs_tpu.config import AlignerConfig
from bitmapperbs_tpu.index.build import BSIndex
from bitmapperbs_tpu.index.device import DeviceIndex, upload_index
from bitmapperbs_tpu.models.aligner import map_batch_device


def _dix_specs(dix: DeviceIndex, idx_axis: str | None):
    if idx_axis is None:
        return DeviceIndex(
            cp_rows=P(), cbase=P(), sa_samples=P(), n=P(), g_planes=P(),
            klt=P(), rows_max=dix.rows_max, genome_len=dix.genome_len,
            samples_max=dix.samples_max, sa_rate=dix.sa_rate,
            klt_k=dix.klt_k, g_words=dix.g_words, idx_axis=None)
    return DeviceIndex(
        cp_rows=P(idx_axis, None), cbase=P(), sa_samples=P(idx_axis),
        n=P(), g_planes=P(idx_axis, None), klt=P(),
        rows_max=dix.rows_max, genome_len=dix.genome_len,
        samples_max=dix.samples_max, sa_rate=dix.sa_rate,
        klt_k=dix.klt_k, g_words=dix.g_words, idx_axis=idx_axis)


def make_sharded_se_mapper(cfg: AlignerConfig, mesh: Mesh,
                           dix: DeviceIndex):
    """Returns jitted fn(dix, reads, lengths) running under shard_map."""
    idx_axis = dix.idx_axis
    specs = _dix_specs(dix, idx_axis)

    def local(dix_l, reads, lengths):
        out = map_batch_device(dix_l, cfg, reads, lengths)
        return out

    out_spec = P("data")
    fn = shard_map(
        local, mesh=mesh,
        in_specs=(specs, P("data", None), P("data")),
        out_specs={k: out_spec for k in
                   ("best_score", "best_bp", "best_anchor",
                    "second_score", "overflow", "gdrop")},
        check_vma=False,
    )
    return jax.jit(fn)


def make_sharded_pe_mapper(cfg: AlignerConfig, mesh: Mesh,
                           dix: DeviceIndex):
    """Paired-end analogue of make_sharded_se_mapper: pairs sharded over
    'data', index replicated or sharded over 'idx'; the output pytree
    (including the nested se1/se2 dicts) is data-sharded."""
    from bitmapperbs_tpu.models.paired import map_batch_pe_device

    idx_axis = dix.idx_axis
    specs = _dix_specs(dix, idx_axis)

    def local(dix_l, r1, l1, r2, l2):
        return map_batch_pe_device(dix_l, cfg, r1, l1, r2, l2)

    d = P("data")
    se_spec = {k: d for k in ("best_score", "best_bp", "best_anchor",
                              "second_score", "overflow", "gdrop")}
    out_specs = {
        "pair_valid": d, "gdrop": d, "pair_sum": d, "pair_second_sum": d,
        "pair_s1": d, "pair_a1": d, "pair_bp1": d, "pair_a2": d,
        "pair_bp2": d, "se1": dict(se_spec), "se2": dict(se_spec),
        "resc_valid": d, "resc_anch_is_1": d, "resc_fwd": d,
        "resc_score": d, "resc_second": d, "resc_block": d, "resc_pat": d,
    }
    fn = shard_map(
        local, mesh=mesh,
        in_specs=(specs, P("data", None), P("data"), P("data", None),
                  P("data")),
        out_specs=out_specs,
        check_vma=False,
    )
    return jax.jit(fn)


@dataclasses.dataclass
class CliMappers:
    """Multi-device mapping entry points for the CLI (SURVEY.md 3.5 / 7 P5).

    Wraps the shard_map mappers with input device_put so models/host.py can
    call them exactly like the single-device jits.  `se_dense`/`pe_dense`
    are the compact-off spec mappers used for the per-read gdrop fallback;
    outputs stay bitwise-identical to single-device (tests/test_sharding.py,
    tests/test_cli.py::test_cli_multichip_*)."""

    mesh: Mesh
    dix: DeviceIndex
    batch_round: int
    se: object = None
    se_dense: object = None
    pe: object = None
    pe_dense: object = None


def make_cli_mappers(idx: BSIndex, cfg: AlignerConfig, devices=None,
                     shard_index: int = 0,
                     reuse: "CliMappers | None" = None) -> CliMappers:
    """Build the production multi-device mappers over the local devices.

    devices: list of jax devices (default jax.local_devices()).
    shard_index: if > 0, shard the index arrays over an 'idx' axis of this
    size (for indexes larger than one device's memory); the data axis gets
    the remaining ndev // shard_index devices.  0 = replicated.
    reuse: an existing CliMappers whose mesh + uploaded index are reused
    (only the jitted mappers are rebuilt for the new cfg -- cli -e rate
    mode builds one mapper set per read-length budget without re-uploading
    the index).
    """
    if reuse is not None:
        mesh, dix, data = reuse.mesh, reuse.dix, reuse.batch_round
    else:
        devices = (list(jax.local_devices()) if devices is None
                   else list(devices))
        ndev = len(devices)
        if shard_index:
            if ndev % shard_index:
                raise ValueError(f"--shard-index {shard_index} does not "
                                 f"divide device count {ndev}")
            data = ndev // shard_index
            mesh = Mesh(np.array(devices).reshape(data, shard_index),
                        ("data", "idx"))
            dix = upload_index(idx, mesh=mesh, idx_axis="idx")
        else:
            data = ndev
            mesh = Mesh(np.array(devices), ("data",))
            dix = upload_index(idx, mesh=mesh)

    out = CliMappers(mesh=mesh, dix=dix, batch_round=data)
    rd_s = NamedSharding(mesh, P("data", None))
    ln_s = NamedSharding(mesh, P("data"))

    def wrap_se(fn):
        def call(arr, lengths):
            return fn(dix, jax.device_put(arr, rd_s),
                      jax.device_put(lengths, ln_s))
        return call

    def wrap_pe(fn):
        def call(a1, l1, a2, l2):
            return fn(dix, jax.device_put(a1, rd_s),
                      jax.device_put(l1, ln_s),
                      jax.device_put(a2, rd_s),
                      jax.device_put(l2, ln_s))
        return call

    if cfg.paired:
        out.pe = wrap_pe(make_sharded_pe_mapper(cfg, mesh, dix))
        out.pe_dense = wrap_pe(make_sharded_pe_mapper(
            cfg.replace(compact=False), mesh, dix))
    else:
        out.se = wrap_se(make_sharded_se_mapper(cfg, mesh, dix))
        out.se_dense = wrap_se(make_sharded_se_mapper(
            cfg.replace(compact=False), mesh, dix))
    return out


def global_stats(out, mesh: Mesh):
    """psum'd device counters (SURVEY.md 5.5): mapped / overflow counts."""
    from bitmapperbs_tpu.models.aligner import INF

    mapped = (out["best_score"] < INF).sum()
    overflow = out["overflow"].sum()
    return {"mapped": int(mapped), "overflow": int(overflow),
            "total": int(out["best_score"].shape[0])}
