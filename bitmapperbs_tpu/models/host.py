"""Host side of the device pipeline: batch prep, dispatch, finalize, SAM.

The device returns per-read (best, second) tuples; this module rebuilds
oracle Hit objects from them and reuses oracle/pipeline.finalize_hit, so a
device batch and an oracle batch produce byte-identical SAM lines whenever
the tuples agree (which the parity tests assert).
"""
from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from bitmapperbs_tpu import constants as K
from bitmapperbs_tpu.config import AlignerConfig
from bitmapperbs_tpu.index.build import BSIndex
from bitmapperbs_tpu.index.device import DeviceIndex
from bitmapperbs_tpu.io.sam import SamRecord, unmapped_record
from bitmapperbs_tpu.models.aligner import INF, map_batch_device
from bitmapperbs_tpu.models.finalize import finalize_batch
from bitmapperbs_tpu.models.pool import (_assemble_pair, _assemble_pe_local,
                                         _assemble_pe_task,
                                         _finalize_se_task,
                                         _finalize_se_task_local,
                                         _se_hit_from, device_results_to_hits,
                                         make_finalize_pool)
from bitmapperbs_tpu.oracle.pipeline import Hit, finalize_hit


def prepare_batch(reads, m_pad: int, batch: int | None = None):
    """List of code arrays -> (uint8[B, m_pad] N-padded, int32[B] lengths)."""
    B = len(reads) if batch is None else batch
    arr = np.full((B, m_pad), K.N_CODE, dtype=np.uint8)
    lengths = np.full(B, m_pad, dtype=np.int32)  # dummy rows: full-length A
    arr[len(reads):] = K.A
    for i, r in enumerate(reads):
        r = np.asarray(r, dtype=np.uint8)
        if len(r) > m_pad:
            raise ValueError(f"read {i} longer than bucket {m_pad}")
        arr[i, :len(r)] = r
        lengths[i] = len(r)
    return arr, lengths


MAX_INFLIGHT = 3  # device batches dispatched ahead of host finalize


def _pad_rows(n: int, bs: int, rnd: int) -> int:
    """Batch-row count for n reads: full batches use bs; partial batches
    (tail of a file, or a (budget, bucket) subgroup in -e rate mode) pad to
    the next power of two so the number of distinct compiled shapes stays
    O(log bs) instead of one per observed group size."""
    if n < bs:
        p = 1
        while p < n:
            p <<= 1
        n = min(bs, p)
    else:
        n = bs
    return -(-n // rnd) * rnd   # mesh data-axis multiple


def map_reads(idx: BSIndex, dix: DeviceIndex, cfg: AlignerConfig,
              reads, quals=None, qnames=None, stats=None,
              pool=None, mappers=None) -> list[SamRecord]:
    """End-to-end device mapping of a list of reads -> SAM records.

    Batches are dispatched ahead of host-side finalization (JAX async
    dispatch; SURVEY.md hard-part 7: host I/O must overlap device compute),
    with a bounded in-flight window; output order is preserved.
    stats: optional io.stats.MapStats -- device capacity-overflow flags are
    accumulated into stats.overflow_reads (SURVEY.md 5.5: silent caps eat
    recall, so they must be counted).
    pool: optional finalize pool (make_finalize_pool) -- per-batch finalize
    fans out over worker processes; results are gathered in order.
    mappers: optional parallel.shard.CliMappers -- routes the mapping through
    the shard_map multi-chip pipeline (all local chips) instead of the
    single-device jit; batch sizes are padded to the data-axis multiple.
    """
    quals = quals or [""] * len(reads)
    qnames = qnames or [f"r{i}" for i in range(len(reads))]
    rc_ref = idx.genome.rc_codes()
    m_pad = cfg.read_len_bucket
    out_recs: list[SamRecord] = []
    futures = []
    bs = cfg.batch_size
    rnd = mappers.batch_round if mappers is not None else 1
    map_fn = (mappers.se if mappers is not None
              else lambda a, l: map_batch_device(dix, cfg, a, l))
    dense_fn = mappers.se_dense if mappers is not None else None

    def drain(item):
        lo, chunk, arr, lengths, out = item
        # one pipelined device->host transfer of the whole output dict (one
        # sync per batch, not one per array); gdrop is read from it too
        out_np = jax.device_get(out)
        if stats is not None:
            stats.gdrop_reads += int(out_np["gdrop"][:len(chunk)].sum())
        out_np = _gdrop_fallback_se(dix, cfg, arr, lengths, out_np, dense_fn)
        if stats is not None:
            stats.overflow_reads += int(out_np["overflow"][:len(chunk)].sum())
        task = (arr, lengths, len(chunk), quals[lo:lo + len(chunk)],
                qnames[lo:lo + len(chunk)], out_np)
        if pool is not None:
            # cfg rides along: the pool's baked-in cfg may differ (-e rate
            # mode maps budget groups with distinct static configs)
            futures.append(pool.apply_async(_finalize_se_task,
                                            (task + (cfg,),)))
        else:
            out_recs.extend(_finalize_se_task_local(idx, rc_ref, cfg, task))

    pending = []
    for lo in range(0, len(reads), bs):
        chunk = reads[lo:lo + bs]
        B = _pad_rows(len(chunk), bs, rnd)
        arr, lengths = prepare_batch(chunk, m_pad, batch=B)
        out = map_fn(jnp.asarray(arr), jnp.asarray(lengths))  # async dispatch
        pending.append((lo, chunk, arr, lengths, out))
        if len(pending) >= MAX_INFLIGHT:
            drain(pending.pop(0))
    for item in pending:
        drain(item)
    for fut in futures:   # ordered gather
        out_recs.extend(fut.get())
    return out_recs


def _merge_where(sel, dense, fast):
    """Per-read merge of (possibly nested) device output dicts."""
    out = {}
    for k, v in fast.items():
        if isinstance(v, dict):
            out[k] = _merge_where(sel, dense[k], v)
        else:
            out[k] = np.where(sel, np.asarray(dense[k]), np.asarray(v))
    return out


def _gdrop_fallback_se(dix, cfg: AlignerConfig, arr, lengths, out_np,
                       dense_fn=None):
    """Re-run flat-buffer-overflow reads through the dense path.

    The compacted pipeline (aligner.candidate_grids_compact) drops candidate
    entries batch-dependently when its flat buffer fills; to keep output
    deterministic across batch compositions and shardings, every flagged
    read's result is replaced by the dense path's (the spec).  Unflagged
    reads are bit-identical between the two, so merging per read is exact.
    out_np: the already-fetched (host) output dict.
    dense_fn: optional dense-path mapper (multi-chip CliMappers.se_dense).
    """
    gdrop = out_np["gdrop"]
    if not (cfg.compact and gdrop.any()):
        return out_np
    if dense_fn is None:
        dense_fn = lambda a, l: map_batch_device(
            dix, cfg.replace(compact=False), a, l)
    dense = jax.device_get(dense_fn(jnp.asarray(arr), jnp.asarray(lengths)))
    return _merge_where(gdrop, dense, out_np)


# --------------------------------------------------------------------------
# paired-end host assembly (decision order mirrors oracle/paired.map_pair)
# --------------------------------------------------------------------------

def map_pairs(idx: BSIndex, dix: DeviceIndex, cfg: AlignerConfig,
              pairs, quals=None, qnames=None,
              stats=None, pool=None, mappers=None) -> list[SamRecord]:
    """End-to-end device PE mapping -> SAM records (2 per pair)."""
    from bitmapperbs_tpu.models.paired import map_batch_pe_device

    rc_ref = idx.genome.rc_codes()
    m_pad = cfg.read_len_bucket
    out_recs: list[SamRecord] = []
    futures = []
    bs = cfg.batch_size
    rnd = mappers.batch_round if mappers is not None else 1
    map_fn = (mappers.pe if mappers is not None
              else lambda a1, l1, a2, l2: map_batch_pe_device(
                  dix, cfg, a1, l1, a2, l2))
    dense_fn = (mappers.pe_dense if mappers is not None
                else lambda a1, l1, a2, l2: map_batch_pe_device(
                    dix, cfg.replace(compact=False), a1, l1, a2, l2))

    def drain(item):
        lo, chunk, a1, l1, a2, l2, out = item
        host = jax.device_get(out)   # one pipelined transfer (see SE drain)
        gdrop = host["gdrop"]
        if stats is not None:
            stats.overflow_reads += int(
                (host["se1"]["overflow"][:len(chunk)]
                 | host["se2"]["overflow"][:len(chunk)]).sum())
            stats.gdrop_reads += 2 * int(gdrop[:len(chunk)].sum())
        if cfg.compact and gdrop.any():
            dense = jax.device_get(dense_fn(jnp.asarray(a1), jnp.asarray(l1),
                                            jnp.asarray(a2), jnp.asarray(l2)))
            host = _merge_where(gdrop, dense, host)
        task = (a1, l1, a2, l2, len(chunk),
                quals[lo:lo + len(chunk)] if quals else None,
                qnames[lo:lo + len(chunk)] if qnames else
                [f"p{lo + i}" for i in range(len(chunk))], host)
        if pool is not None:
            futures.append(pool.apply_async(_assemble_pe_task,
                                            (task + (cfg,),)))
        else:
            out_recs.extend(_assemble_pe_local(idx, rc_ref, cfg, *task))

    pending = []
    for lo in range(0, len(pairs), bs):
        chunk = pairs[lo:lo + bs]
        B = _pad_rows(len(chunk), bs, rnd)
        a1, l1 = prepare_batch([p[0] for p in chunk], m_pad, B)
        a2, l2 = prepare_batch([p[1] for p in chunk], m_pad, B)
        out = map_fn(jnp.asarray(a1), jnp.asarray(l1),
                     jnp.asarray(a2), jnp.asarray(l2))
        pending.append((lo, chunk, a1, l1, a2, l2, out))
        if len(pending) >= MAX_INFLIGHT:
            drain(pending.pop(0))
    for item in pending:
        drain(item)
    for fut in futures:
        out_recs.extend(fut.get())
    return out_recs


