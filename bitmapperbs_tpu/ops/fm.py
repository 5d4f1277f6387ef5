"""Device FM-index lane ops: occ/rank, backward search, bounded-LF locate.

Device restatement of SURVEY.md C7-C10: every op is elementwise over an
arbitrary lane shape; each lane carries (block, position) and the occ query
is one row gather from the stacked checkpoint table followed by
population_count -- no data-dependent control flow, so everything jits and
shards cleanly.  All positions are uint32; gather rows are int32.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from bitmapperbs_tpu import constants as K
from bitmapperbs_tpu.index.device import DeviceIndex

_A = K.CONV_ALPHA
_W = K.CP_WORDS
U32 = jnp.uint32
FULL = np.uint32(0xFFFFFFFF)


def _lower_mask(within):
    """uint32 lanes -> [..., _W] per-word masks of bits < within."""
    nbits = jnp.clip(
        within.astype(jnp.int32)[..., None] - jnp.arange(_W, dtype=jnp.int32) * 32,
        0, 32)
    safe = (U32(1) << jnp.minimum(nbits, 31).astype(U32)) - U32(1)
    return jnp.where(nbits >= 32, FULL, safe)


def _popcount_sum(words):
    return jax.lax.population_count(words).sum(axis=-1, dtype=U32)


def fetch_cp_rows(dix: DeviceIndex, row, width: int | None = None):
    """Gather checkpoint rows by GLOBAL flat row index.

    width: only the first `width` u32 of each row are fetched (XLA narrows
    the gather's slice size) -- occ/backward search needs the 12 count+plane
    words, not the SA-mark tail.

    Replicated index: plain gather.  Sharded index (dix.idx_axis set): each
    device gathers its local range and the partial rows are psum-merged over
    the index axis (SURVEY.md 3.5: shard-local partials + collectives)."""
    w = slice(None) if width is None else slice(0, width)
    if dix.idx_axis is None:
        return dix.cp_rows[row, w]
    shard_rows = dix.cp_rows.shape[0]
    base = (jax.lax.axis_index(dix.idx_axis) * shard_rows).astype(jnp.int32)
    local = row - base
    ok = (local >= 0) & (local < shard_rows)
    got = dix.cp_rows[jnp.clip(local, 0, shard_rows - 1), w]
    got = jnp.where(ok[..., None], got, 0)
    return jax.lax.psum(got, dix.idx_axis)


def fetch_sa_samples(dix: DeviceIndex, flat_idx):
    """sa_samples flat gather by GLOBAL index, psum-merged when sharded."""
    flat_idx = jnp.minimum(flat_idx, 2 * dix.samples_max - 1)
    if dix.idx_axis is None:
        return dix.sa_samples[flat_idx]
    shard = dix.sa_samples.shape[0]
    base = (jax.lax.axis_index(dix.idx_axis) * shard).astype(jnp.int32)
    local = flat_idx - base
    ok = (local >= 0) & (local < shard)
    got = dix.sa_samples[jnp.clip(local, 0, shard - 1)]
    return jax.lax.psum(jnp.where(ok, got, 0), dix.idx_axis)


def block_n(dix: DeviceIndex, block):
    """dix.n[block] via a 2-way select (no per-lane table gather)."""
    return jnp.where(block == 0, dix.n[0], dix.n[1])


def occ(dix: DeviceIndex, block, c, i):
    """# occurrences of symbol c in BWT_block[0:i). Lanes of (block, c, i)."""
    row = (i // K.CP_BLOCK).astype(jnp.int32) + block.astype(jnp.int32) * dix.rows_max
    within = i % K.CP_BLOCK
    rows = fetch_cp_rows(dix, row)
    base = _select_word(rows[..., :_A], c.astype(jnp.int32))
    p0 = rows[..., _A:_A + _W]
    p1 = rows[..., _A + _W:_A + 2 * _W]
    b0 = (U32(0) - (c.astype(U32) & 1))[..., None]
    b1 = (U32(0) - ((c.astype(U32) >> 1) & 1))[..., None]
    ind = ~(p0 ^ b0) & ~(p1 ^ b1)
    return base + _popcount_sum(ind & _lower_mask(within))


def _cbase(dix: DeviceIndex, block, c):
    """cbase[block, c] per lane via an 8-way where-chain over the scalar
    table (no per-lane gather of a tiny table)."""
    code = block.astype(jnp.int32) * _A + c.astype(jnp.int32)
    flat = dix.cbase.reshape(-1)
    out = jnp.broadcast_to(flat[0], code.shape)
    for k in range(1, 2 * _A):
        out = jnp.where(code == k, flat[k], out)
    return out


def extend_backward(dix: DeviceIndex, block, sp, ep, c):
    """One backward-search step per lane; empty intervals stay empty.

    The sp and ep occ lookups are stacked into ONE gather (2N rows): one
    wide gather instead of two narrow ones.
    """
    cb = _cbase(dix, block, c)
    both = occ(dix, jnp.stack([block, block]), jnp.stack([c, c]),
               jnp.stack([sp, ep]))
    return cb + both[0], cb + both[1]


def bwt_symbol(dix: DeviceIndex, block, i):
    row = (i // K.CP_BLOCK).astype(jnp.int32) + block.astype(jnp.int32) * dix.rows_max
    within = (i % K.CP_BLOCK).astype(jnp.int32)
    rows = fetch_cp_rows(dix, row)
    w = within // 32
    b = (within % 32).astype(U32)
    p0 = jnp.take_along_axis(rows[..., _A:_A + _W], w[..., None], axis=-1)[..., 0]
    p1 = jnp.take_along_axis(rows[..., _A + _W:_A + 2 * _W], w[..., None], axis=-1)[..., 0]
    return ((p0 >> b) & 1) | (((p1 >> b) & 1) << 1)


def _mark_rank(dix: DeviceIndex, block, i):
    row = (i // K.CP_BLOCK).astype(jnp.int32) + block.astype(jnp.int32) * dix.rows_max
    within = i % K.CP_BLOCK
    rows = fetch_cp_rows(dix, row)
    base = rows[..., K.CP_MARK_OFF]
    words = rows[..., K.CP_MARK_OFF + 1:]
    rank = base + _popcount_sum(words & _lower_mask(within))
    w = (within // 32).astype(jnp.int32)
    bit = jnp.take_along_axis(words, w[..., None], axis=-1)[..., 0]
    marked = (bit >> (within % 32).astype(U32)) & 1
    return marked.astype(jnp.bool_), rank


def _select_word(words, w):
    """words[..., k] selected by per-lane w via a where-chain
    (instead of a per-element take_along_axis gather)."""
    out = words[..., 0]
    for k in range(1, words.shape[-1]):
        out = jnp.where(w == k, words[..., k], out)
    return out


def locate(dix: DeviceIndex, block, i, valid):
    """SA_block[i] per lane via <= dix.sa_rate lockstep LF steps
    (SURVEY.md hard-part 1: the walk is a fixed unroll with done-masking).

    Each step is ONE gather of the combined checkpoint row (occ counts,
    BWT planes, and SA-mark bits share a row precisely so this works).  The SA-sample lookup happens once after the
    loop.  Invalid lanes walk garbage safely.  Returns uint32 positions.
    """
    blk = block.astype(jnp.int32)
    nmax = block_n(dix, blk)
    i = jnp.minimum(jnp.where(valid, i, 0).astype(U32), nmax - 1)
    zeros = jnp.zeros_like(i)

    def step(_, st):
        cur, steps, rank_out, done = st
        row = (cur // K.CP_BLOCK).astype(jnp.int32) + blk * dix.rows_max
        rows = fetch_cp_rows(dix, row)             # ONE gather per step
        within = cur % K.CP_BLOCK
        w = (within // 32).astype(jnp.int32)
        b = (within % 32).astype(U32)

        # SA-mark test + rank from the same row
        mwords = rows[..., K.CP_MARK_OFF + 1:]
        mbit = (_select_word(mwords, w) >> b) & 1
        mrank = rows[..., K.CP_MARK_OFF] + _popcount_sum(
            mwords & _lower_mask(within))
        hit = (mbit == 1) & ~done
        rank_out = jnp.where(hit, mrank, rank_out)
        done = done | (mbit == 1)

        # BWT symbol + occ rank from the same row -> LF step
        p0 = rows[..., _A:_A + _W]
        p1 = rows[..., _A + _W:_A + 2 * _W]
        c0 = (_select_word(p0, w) >> b) & 1
        c1 = (_select_word(p1, w) >> b) & 1
        c = c0 | (c1 << 1)
        base = _select_word(rows[..., :_A], c.astype(jnp.int32))
        ind = ~(p0 ^ (U32(0) - c0)[..., None]) & ~(p1 ^ (U32(0) - c1)[..., None])
        occ_c = base + _popcount_sum(ind & _lower_mask(within))
        nxt = jnp.minimum(_cbase(dix, blk, c) + occ_c, nmax - 1)
        cur = jnp.where(done, cur, nxt)
        steps = jnp.where(done, steps, steps + 1)
        return cur, steps, rank_out, done

    _, steps, rank, done = jax.lax.fori_loop(
        0, dix.sa_rate, step,
        (i, zeros, zeros, jnp.zeros(i.shape, dtype=jnp.bool_)))

    sample = fetch_sa_samples(
        dix, blk * dix.samples_max + rank.astype(jnp.int32))
    return sample + steps


def extend_seeds(dix: DeviceIndex, block, patterns, starts, sp, ep,
                 ext_max: int, ext_occ: int):
    """Adaptive seed extension, lockstep over lanes (SURVEY.md C9 "extend
    each seed backward until occurrence count <= threshold").

    Lanes whose interval holds more than ext_occ rows keep prepending the
    read character left of their current start -- up to ext_max characters,
    stopping at the read start or when a step would EMPTY the interval (the
    lane keeps its last nonempty interval and goes dead: characters are
    consecutive, so retrying with the next one would search a gapped
    pattern).  Each step is the same one stacked occ gather as a main
    search step; satisfied lanes idle masked.  Returns (sp, ep, starts) --
    starts move left by the number of characters actually consumed, so the
    anchor projection (tp - start) stays exact.  Mirrors the oracle loop in
    oracle/pipeline.collect_candidates; parity tested.
    """
    m = patterns.shape[-1]
    # all potentially-consumed characters in one gather (in-loop
    # take_along_axis costs a full per-lane gather per step)
    ts = jnp.arange(ext_max, dtype=jnp.int32)
    j = jnp.clip(starts[..., None] - 1 - ts, 0, m - 1)
    chars = jnp.take_along_axis(patterns, j, axis=-1)

    def step(t, state):
        sp, ep, st, dead = state
        active = ~dead & (ep - sp > U32(ext_occ)) & (st > 0)
        c = jax.lax.dynamic_index_in_dim(chars, t, axis=-1, keepdims=False)
        nsp, nep = extend_backward(dix, block, sp, ep, c.astype(U32))
        empty = nep <= nsp
        take = active & ~empty
        return (jnp.where(take, nsp, sp), jnp.where(take, nep, ep),
                jnp.where(take, st - 1, st), dead | (active & empty))

    sp, ep, starts, _ = jax.lax.fori_loop(
        0, ext_max, step,
        (sp, ep, starts, jnp.zeros(sp.shape, dtype=jnp.bool_)))
    return sp, ep, starts


def rolling_kmers(patterns, k: int):
    """Base-3 rolling k-mer codes over converted patterns.

    patterns: uint8[..., m] converted codes (1..3).  Returns int32[..., m]
    where out[..., j] = sum_{t<k} (patterns[..., j-t] - 1) * 3^t -- exactly
    the KLT index of the k-mer ENDING at position j (build_klt convention:
    backward step t consumes pattern position end-1-t).  Positions j < k-1
    mix in out-of-range garbage; callers only read j >= k-1.
    """
    d = patterns.astype(jnp.int32) - 1
    out = jnp.zeros(patterns.shape, jnp.int32)
    p3 = 1
    for t in range(k):
        if t == 0:
            shifted = d
        else:
            shifted = jnp.concatenate(
                [jnp.zeros((*d.shape[:-1], t), jnp.int32), d[..., :-t]],
                axis=-1)
        out = out + shifted * p3
        p3 *= 3
    return out


def klt_lookup(dix: DeviceIndex, block, kmer_idx):
    """(sp, ep) after klt_k backward steps, one row gather per lane."""
    rows = dix.klt[block.astype(jnp.int32) * (3 ** dix.klt_k)
                   + kmer_idx.astype(jnp.int32)]
    return rows[..., 0], rows[..., 1]


def search_patterns(dix: DeviceIndex, block, patterns, starts, ends,
                    max_len: int | None = None, end_kmers=None):
    """Batched backward search of seed slices, lockstep over lanes.

    patterns: uint8[..., m] converted codes ($AGT space) per lane.
    starts/ends: int32 lanes -- seed slice [start, end) within the pattern.
    block: int32 lanes.  max_len: static bound on slice length (defaults to m).
    end_kmers: optional int32 lanes -- rolling_kmers(...)[..., end-1] per
    lane; when given (and dix.klt_k > 0), lanes whose slice is >= klt_k long
    start from the k-mer lookup table, replacing the first klt_k serial occ
    steps with one gather.  Bit-identical to the plain path (the table
    carries the same freeze-on-empty semantics).
    Returns (sp, ep) uint32 lanes.

    All lanes run the remaining steps; lanes whose slice is shorter idle on a
    masked no-op.  Empty intervals propagate unchanged (occ(sp)==occ(ep)).
    """
    m = patterns.shape[-1]
    lens = ends - starts
    if max_len is None:
        max_len = m
    k = dix.klt_k if end_kmers is not None else 0
    if k >= max_len:   # table deeper than any slice: plain path
        k = 0
    sp0 = jnp.zeros(starts.shape, U32)
    ep0 = jnp.broadcast_to(block_n(dix, block), starts.shape).astype(U32)

    def make_step(phase_mask=None, chars=None, t0=0):
        def step(t, st):
            sp, ep = st
            active = (t < lens) & (ep > sp)   # freeze empties (host parity)
            if phase_mask is not None:
                active = active & phase_mask
            if chars is None:
                j = jnp.clip(ends - 1 - t, 0, m - 1)
                c = jnp.take_along_axis(patterns, j[..., None],
                                        axis=-1)[..., 0]
            else:
                c = jax.lax.dynamic_index_in_dim(chars, t - t0, axis=-1,
                                                 keepdims=False)
            nsp, nep = extend_backward(dix, block, sp, ep, c.astype(U32))
            return (jnp.where(active, nsp, sp), jnp.where(active, nep, ep))
        return step

    def main_chars(t0):
        """One up-front gather of every main-loop character (in-loop
        take_along_axis costs a full per-lane gather per step)."""
        ts = jnp.arange(t0, max_len, dtype=jnp.int32)
        j = jnp.clip(ends[..., None] - 1 - ts, 0, m - 1)
        return jnp.take_along_axis(patterns, j, axis=-1)

    if k == 0:
        return jax.lax.fori_loop(0, max_len, make_step(chars=main_chars(0)),
                                 (sp0, ep0))

    short = lens < k
    sp_t, ep_t = klt_lookup(dix, block, end_kmers)

    # phase A: only short lanes walk their (< k) chars; runs at all only
    # when a short lane exists in the batch (rare: reads < num_seeds * k bp)
    def phase_a(st):
        return jax.lax.fori_loop(0, k, make_step(short), st)

    sp_a, ep_a = jax.lax.cond(jnp.any(short), phase_a, lambda st: st,
                              (sp0, ep0))
    sp1 = jnp.where(short, sp_a, sp_t)
    ep1 = jnp.where(short, ep_a, ep_t)

    # phase B: steps k..max_len (short lanes are already past their length)
    return jax.lax.fori_loop(k, max_len,
                             make_step(chars=main_chars(k), t0=k),
                             (sp1, ep1))
