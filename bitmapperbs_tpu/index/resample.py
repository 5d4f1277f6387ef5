"""SA-sample densification: halve an index's sa_rate WITHOUT an SA rerun.

Locate's LF walk is bounded by sa_rate, and at human scale (3.08 Gbp,
sa_rate 8) the walk is the dominant per-candidate gather cost on device
(PERF.md gather model: ~8 rows/candidate at rate 8 vs ~4 at rate 4).  A
fresh sa_rate-4 build would repeat the hours-scale suffix-array phase; this
module instead derives the missing samples from the existing artifact:

  For every marked row r with SA[r] = v (v = 0 mod rate), LF^(rate/2)(r)
  is the row with SA = v - rate/2 -- exactly the midpoint sample a
  rate/2 build would have marked.  One vectorized LF^(rate/2) pass over
  all current samples (+ a <=rate-step tail walk from row 0, whose SA is
  n-1, for the positions above the largest current sample) yields the
  full rate/2 sample set.  Mark bit-planes and the per-row cumulative
  mark counts in cp_rows are then rewritten in place.

The result is byte-identical to building directly at the halved rate
(tests/test_resample.py), so no INDEX_VERSION bump: the artifact layout is
unchanged, only its density parameter.

Reference parity note: the reference fixes its SA sample rate at build
time (SURVEY.md C6); post-hoc densification is a new capability: locate
steps are lockstep gathers, so the rate directly multiplies the locate
stage's gather volume.
"""
from __future__ import annotations

import numpy as np

from bitmapperbs_tpu import constants as K
from bitmapperbs_tpu.index import packed
from bitmapperbs_tpu.index.build import BSIndex, PackedBlock


def _marked_rows(block: PackedBlock) -> np.ndarray:
    """Row indices (BWT positions) of all marked rows, in row order.

    Row order == sa_samples rank order, so the result aligns 1:1 with
    block.sa_samples.
    """
    words = np.ascontiguousarray(block.cp_rows[:, K.CP_MARK_OFF + 1:])
    bits = np.unpackbits(words.view(np.uint8), bitorder="little")
    rows = np.flatnonzero(bits)
    assert len(rows) == len(block.sa_samples), \
        f"mark count {len(rows)} != sample count {len(block.sa_samples)}"
    return rows


def _lf_steps(block: PackedBlock, rows: np.ndarray, steps: int,
              chunk: int = 1 << 24) -> np.ndarray:
    """LF^steps over a batch of BWT rows, chunked to bound transient RAM."""
    out = np.empty(len(rows), dtype=np.uint64)
    for lo in range(0, len(rows), chunk):
        cur = rows[lo:lo + chunk].astype(np.uint64)
        for _ in range(steps):
            cur = packed.lf(block, cur)
        out[lo:lo + chunk] = cur
    return out


def _rewrite_marks(block: PackedBlock, rows: np.ndarray,
                   vals: np.ndarray) -> None:
    """Replace the block's mark bit-planes + cumulative counts + samples."""
    n_rows = block.cp_rows.shape[0]
    bits = np.zeros(n_rows * K.CP_BLOCK, dtype=np.uint8)
    bits[rows] = 1
    words = np.packbits(bits, bitorder="little").view("<u4").reshape(
        n_rows, K.CP_WORDS)
    per_row = np.bitwise_count(words).sum(axis=1, dtype=np.uint64)
    cum = np.cumsum(per_row)
    block.cp_rows[:, K.CP_MARK_OFF] = (cum - per_row).astype(np.uint32)
    block.cp_rows[:, K.CP_MARK_OFF + 1:] = words
    block.sa_samples = vals.astype(np.uint32)


def halve_block_sa_rate(block: PackedBlock) -> None:
    """Densify one block's SA samples from sa_rate to sa_rate // 2, in place."""
    rate = block.sa_rate
    if rate < 2 or rate % 2:
        raise ValueError(f"cannot halve sa_rate {rate}")
    h = rate // 2
    old_rows = _marked_rows(block)
    old_vals = block.sa_samples.astype(np.uint64)

    # midpoint samples: SA = v - h reached by LF^h from each marked row
    src = old_vals >= h
    new_rows = _lf_steps(block, old_rows[src], h)
    new_vals = old_vals[src] - h

    # tail: positions = h (mod rate) above the largest current sample have
    # no source sample to walk from; reach them from row 0 (SA[0] = n - 1,
    # the sentinel-suffix row) with < rate LF steps
    v_max = int(old_vals.max())
    tail_rows, tail_vals = [], []
    p = v_max + h
    if p < block.n:
        r0 = np.uint64(0)
        v0 = int(packed.locate(block, np.array([0], dtype=np.uint64))[0])
        assert v0 == block.n - 1, \
            f"row 0 SA = {v0}, expected n-1 = {block.n - 1}"
        cur = r0
        for _ in range(v0 - p):
            cur = packed.lf(block, np.array([cur], dtype=np.uint64))[0]
        tail_rows.append(int(cur))
        tail_vals.append(p)

    rows_all = np.concatenate(
        [old_rows.astype(np.uint64), new_rows,
         np.array(tail_rows, dtype=np.uint64)])
    vals_all = np.concatenate(
        [old_vals, new_vals, np.array(tail_vals, dtype=np.uint64)])
    order = np.argsort(rows_all, kind="stable")
    rows_all, vals_all = rows_all[order], vals_all[order]
    assert np.all(np.diff(rows_all) > 0), "duplicate marked rows"
    _rewrite_marks(block, rows_all.astype(np.int64), vals_all)
    block.sa_rate = h


def halve_sa_rate(idx: BSIndex, target_rate: int | None = None) -> BSIndex:
    """Densify every block until sa_rate == target_rate (default: one halving).

    Mutates `idx` in place and returns it.
    """
    if target_rate is None:
        target_rate = idx.blocks[0].sa_rate // 2
    for b in idx.blocks:
        while b.sa_rate > target_rate:
            halve_block_sa_rate(b)
        if b.sa_rate != target_rate:
            raise ValueError(
                f"target rate {target_rate} unreachable from {b.sa_rate}")
    idx.meta["sa_sample_rate"] = target_rate
    return idx
