"""Device verification ops: bit-packed window extraction, asymmetric Hamming,
multi-word bit-parallel Myers (SURVEY.md C11/C12, BASELINE "popcount-over-XOR"
filter and "fixed-band bit-parallel DP ... masked batching").

Layout: reads and reference windows are 3 bit-planes of uint32 words
(bit0, bit1 of the 2-bit base code, plus an N mask); LSB = lowest position.
The semi-global band is realized by the window itself: the read aligns
end-to-end against a window [anchor-e, anchor+m+e), free start/end -- this
matches oracle/align.py's edit_matrix exactly.

Everything is elementwise over an arbitrary lane shape and jits cleanly.
These functions are the spec: ops/kernels.py holds the GPU kernels that
replace `fused_verify` and `myers_scan` on the hot path, bit-identical.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from bitmapperbs_tpu import constants as K

U32 = jnp.uint32
FULL = np.uint32(0xFFFFFFFF)
# uint32 values >= this are treated as wrapped-around negatives (window
# starts like anchor - e near position 0).  Real positions are < 2^32 - 4096.
_NEG_T = np.uint32(0xFFFFF000)


def _mask_lt(nbits):
    """uint32 lanes nbits in [0,32] -> mask of the lowest nbits bits."""
    nb = jnp.clip(nbits.astype(jnp.int32), 0, 32)
    safe = (U32(1) << jnp.minimum(nb, 31).astype(U32)) - U32(1)
    return jnp.where(nb >= 32, FULL, safe)


def pack_codes(codes):
    """uint8[..., m] base codes (0..3, 4=N) -> (b0, b1, nmask) uint32[..., m/32].

    m must be a multiple of 32.  LSB = lowest position.
    """
    m = codes.shape[-1]
    assert m % 32 == 0
    shaped = codes.reshape(*codes.shape[:-1], m // 32, 32).astype(U32)
    w = U32(1) << jnp.arange(32, dtype=U32)
    isn = shaped == K.N_CODE
    c = jnp.where(isn, 0, shaped)
    b0 = ((c & 1) * w).sum(axis=-1, dtype=U32)
    b1 = (((c >> 1) & 1) * w).sum(axis=-1, dtype=U32)
    nm = (isn.astype(U32) * w).sum(axis=-1, dtype=U32)
    return b0, b1, nm


def length_mask(lengths, m: int):
    """int32 lanes -> uint32[..., m/32] mask of bits < length."""
    nw = m // 32
    return _mask_lt(lengths[..., None].astype(jnp.int32)
                    - jnp.arange(nw, dtype=jnp.int32) * 32)


def window_planes(g_planes, orient, start, nwords: int, genome_len: int,
                  idx_axis: str | None = None, g_words: int | None = None):
    """Extract `nwords` position-aligned uint32 words per lane from the
    packed genome planes, starting at (possibly wrapped-negative) `start`.

    g_planes: uint32[2 * W, 3] FLAT rows (block-0 words then block-1 words;
    [b0, b1, nmask] interleaved so one 12-byte ROW gather fetches all three
    planes of a word).  The flat layout
    keeps the in-jit view reshape-free (layout fixed at upload; measured
    equal temp memory, but no reliance on XLA folding the reshape) and
    makes the sharded row math uniform.  A legacy (2, W, 3) input is
    still accepted (tests/scripts) and reshaped here.
    Word 0 of every block is a zero pad word (see upload_index) so that
    wrapped-negative starts down to -32 resolve via the +32 bias below.
    g_words: per-block GLOBAL row count W (required for the sharded layout,
    where g_planes holds only this device's row range; defaults to
    rows/2 for replicated flat input).
    orient:   int32 lanes (0 fwd / 1 rc); start: uint32 lanes.
    Out-of-range positions (start<0 via wraparound -- legal down to -32,
    i.e. anchor-e with e<=31 -- or >= genome_len) are N-filled, matching
    oracle frame_slice exactly.
    Returns (b0, b1, nmask): each uint32[..., nwords].
    """
    if g_planes.ndim == 3:          # legacy layout (replicated only)
        W = g_planes.shape[1]
        flat = g_planes.reshape(2 * W, 3)
    else:
        flat = g_planes
        W = g_words if g_words is not None else flat.shape[0] // 2
    sh = (start & 31).astype(U32)
    # +32 bias into the zero-padded plane: unwraps starts in [-32, 0)
    wi = ((start + 32) >> 5).astype(jnp.int32)
    offs = jnp.arange(nwords + 1, dtype=jnp.int32)
    rows = jnp.clip(wi[..., None] + offs, 0, W - 1)

    def funnel(raw):
        lo = raw[..., :-1]
        hi = raw[..., 1:]
        shb = sh[..., None]
        return jnp.where(shb == 0, lo, (lo >> shb) | (hi << (U32(32) - shb)))

    ob = orient.astype(jnp.int32)[..., None]
    if idx_axis is None:
        raw3 = flat[ob * W + rows]                       # ..., nwords+1, 3
    else:
        # sharded flat rows: this device holds rows [base, base + Rl)
        Rl = flat.shape[0]
        base = (jax.lax.axis_index(idx_axis) * Rl).astype(jnp.int32)
        g = ob * W + rows
        local = g - base
        ok = (local >= 0) & (local < Rl)
        raw3 = flat[jnp.clip(local, 0, Rl - 1)]
        raw3 = jax.lax.psum(jnp.where(ok[..., None], raw3, 0), idx_axis)
    b0, b1, nm = (funnel(raw3[..., p]) for p in range(3))

    # out-of-range -> N: per word, positions [ws, ws+32)
    ws = start[..., None] + jnp.arange(nwords, dtype=U32) * 32
    wrapped = ws >= _NEG_T
    neg_amt = (U32(0) - ws)
    low_invalid = jnp.where(wrapped, _mask_lt(jnp.minimum(neg_amt, 32)), U32(0))
    L = jnp.uint32(genome_len)
    # uint32-safe: when ws < L the difference L-ws cannot underflow
    valid_bits = jnp.where(ws >= L, U32(0),
                           jnp.minimum(L - ws, U32(32))).astype(jnp.int32)
    valid_bits = jnp.where(wrapped, jnp.int32(32), valid_bits)
    oob = (~_mask_lt(valid_bits)) | low_invalid
    return b0 & ~oob, b1 & ~oob, nm | oob


def hamming(ref_planes, read_planes, lenmask):
    """Asymmetric bisulfite mismatch count per lane (popcount over XOR).

    ref_planes/read_planes: (b0, b1, nmask) uint32[..., Wd] each.
    lenmask: uint32[..., Wd] bits < read length.
    Rule (in-frame): match iff ref==read or (ref==C and read==T); N never.
    """
    r0, r1, rn = ref_planes
    d0, d1, dn = read_planes
    eq = ~(r0 ^ d0) & ~(r1 ^ d1)
    ref_c = r0 & ~r1          # C = 01 (bit0=1, bit1=0)
    read_t = d0 & d1          # T = 11
    match = (eq | (ref_c & read_t)) & ~rn & ~dn
    mism = ~match & lenmask
    return jax.lax.population_count(mism).sum(axis=-1, dtype=jnp.int32)


def shift_planes(planes, e: int, Wd: int):
    """(..., Ww>=Wd+1) plane words starting at (anchor - e) -> the (..., Wd)
    words starting at anchor, by an e-bit (< 32) right funnel shift.  Yields
    exactly window_planes(anchor, Wd): oob/N marking is per-position."""
    if e == 0:
        return tuple(p[..., :Wd] for p in planes)
    sh = U32(e)
    ish = U32(32 - e)
    return tuple((p[..., :Wd] >> sh) | (p[..., 1:Wd + 1] << ish)
                 for p in planes)


def peq_from_planes(d0, d1, dn, pad):
    """build_peq computed from already-packed read planes (so the compact
    path gathers 3 plane words per lane instead of a 4xWd table)."""
    is_a = ~d0 & ~d1 & ~dn
    is_c = d0 & ~d1 & ~dn
    is_g = ~d0 & d1 & ~dn
    is_t = d0 & d1 & ~dn
    return jnp.stack([is_a | pad, is_c | is_t | pad, is_g | pad, is_t | pad],
                     axis=-2)


def fused_verify(wide, read_planes, lenmask, m: int, ncols: int, e: int):
    """Candidate verification of the compact path, per lane: the anchored
    asymmetric Hamming distance where it is <= e, else the semi-global
    Myers distance over the wide window.

    wide: (b0, b1, nmask) uint32[..., Ww] starting at anchor - e;
    read_planes: (b0, b1, nmask) uint32[..., Wd]; lenmask uint32[..., Wd].
    Returns int32 lanes.  ops/kernels.verify_fused_kernel is bit-identical.
    """
    Wd = m // 32
    ham = hamming(shift_planes(wide, e, Wd), read_planes, lenmask)
    pad = ~lenmask
    peq = peq_from_planes(*read_planes, pad)
    med = myers(wide, peq, pad, m, ncols)
    return jnp.where(ham <= e, ham, med)


def build_peq(frame_reads, lengths, m: int):
    """PEQ planes for Myers: uint32[..., 4, m/32].

    PEQ[c] bit j == asym_match(ref_char=c, read[j]); rows >= length are
    always-match padding (so the padded pattern's distance equals the real
    read's -- masked batching over variable-length reads).
    """
    d0, d1, dn = pack_codes(frame_reads)
    pad = ~length_mask(lengths, m)
    is_a = ~d0 & ~d1 & ~dn
    is_c = d0 & ~d1 & ~dn
    is_g = ~d0 & d1 & ~dn
    is_t = d0 & d1 & ~dn
    peq = jnp.stack([
        is_a | pad,            # ref A
        is_c | is_t | pad,     # ref C matches read C or read T
        is_g | pad,            # ref G
        is_t | pad,            # ref T
    ], axis=-2)
    return peq, pad


def myers(window_planes_, peq, pad, m: int, ncols: int):
    """Multi-word bit-parallel semi-global edit distance per lane.

    window_planes_: (b0, b1, nmask) uint32[..., Ww] covering ncols columns.
    peq: uint32[..., 4, Wd]; pad: uint32[..., Wd] (always-match rows).
    Returns int32 lanes: min over end columns of D[m_pad][j], which equals
    the real read's semi-global distance (pad rows are free diagonals).

    Myers/Hyyro search variant: D[0][j] = 0 -> the horizontal carry into
    row 0 is 0 (X = HP << 1, no |1).  Verified against oracle edit_matrix.
    """
    wb0, wb1, wn = window_planes_
    Wd = m // 32
    lanes = pad.shape[:-1]

    vp0 = jnp.broadcast_to(FULL, (*lanes, Wd))
    vn0 = jnp.zeros((*lanes, Wd), U32)
    score0 = jnp.full(lanes, m, jnp.int32)
    best0 = score0

    def col(j, st):
        vp, vn, score, best = st
        w = j >> 5
        b = U32(j & 31)
        c0 = (jax.lax.dynamic_index_in_dim(wb0, w, axis=-1, keepdims=False) >> b) & 1
        c1 = (jax.lax.dynamic_index_in_dim(wb1, w, axis=-1, keepdims=False) >> b) & 1
        cn = (jax.lax.dynamic_index_in_dim(wn, w, axis=-1, keepdims=False) >> b) & 1
        code = (c0 | (c1 << 1)).astype(jnp.int32)
        eq_sym = jnp.take_along_axis(
            peq, code[..., None, None], axis=-2)[..., 0, :]
        eq = jnp.where((cn == 1)[..., None], pad, eq_sym)

        # D0 = (((eq & vp) + vp) ^ vp) | eq | vn   with multi-word carry
        t = eq & vp
        s1 = t + vp
        c_add = (s1 < t).astype(U32)
        # propagate the addition carry across words (static unroll, LSW first)
        sums = [s1[..., 0]]
        carries = [c_add[..., 0]]
        for wi in range(1, Wd):
            sw = s1[..., wi] + carries[-1]
            cw = c_add[..., wi] | (sw < s1[..., wi]).astype(U32)
            sums.append(sw)
            carries.append(cw)
        ssum = jnp.stack(sums, axis=-1)
        d0 = (ssum ^ vp) | eq | vn
        hp = vn | ~(d0 | vp)
        hn = vp & d0

        top = U32(31)
        score = score + ((hp[..., Wd - 1] >> top) & 1).astype(jnp.int32) \
                      - ((hn[..., Wd - 1] >> top) & 1).astype(jnp.int32)
        best = jnp.minimum(best, score)

        # X = hp << 1 (shift-in 0: free start); vp = (hn << 1) | ~(d0 | X)
        def shl1(x):
            lo = x << 1
            hi_in = jnp.concatenate(
                [jnp.zeros((*lanes, 1), U32), x[..., :-1] >> 31], axis=-1)
            return lo | hi_in

        x = shl1(hp)
        vp = shl1(hn) | ~(d0 | x)
        vn = d0 & x
        return vp, vn, score, best

    _, _, _, best = jax.lax.fori_loop(0, ncols, col, (vp0, vn0, score0, best0))
    return best


def myers_scan(window_planes_, peq, pad, m: int, ncols: int):
    """Per-end-column semi-global scores: int32[..., ncols].

    Same recurrence as `myers`, but every column's running score is emitted:
    out[..., j] = min edit distance of the (padded) read vs any window infix
    ending at column j.  Because the pad rows are always-match diagonals,
    out[..., j] equals the REAL read's score for the alignment ending at
    column j - (m - length) -- the column->position shift the mate-rescue
    scan accounts for.  One scan over a whole insert window replaces a
    banded DP per candidate offset (models/paired.py).
    """
    wb0, wb1, wn = window_planes_
    Wd = m // 32
    lanes = pad.shape[:-1]

    vp0 = jnp.broadcast_to(FULL, (*lanes, Wd))
    vn0 = jnp.zeros((*lanes, Wd), U32)
    score0 = jnp.full(lanes, m, jnp.int32)

    def col(st, j):
        vp, vn, score = st
        w = j >> 5
        b = (j & 31).astype(U32)
        c0 = (jax.lax.dynamic_index_in_dim(wb0, w, axis=-1, keepdims=False) >> b) & 1
        c1 = (jax.lax.dynamic_index_in_dim(wb1, w, axis=-1, keepdims=False) >> b) & 1
        cn = (jax.lax.dynamic_index_in_dim(wn, w, axis=-1, keepdims=False) >> b) & 1
        code = (c0 | (c1 << 1)).astype(jnp.int32)
        eq_sym = jnp.take_along_axis(
            peq, code[..., None, None], axis=-2)[..., 0, :]
        eq = jnp.where((cn == 1)[..., None], pad, eq_sym)

        t = eq & vp
        s1 = t + vp
        c_add = (s1 < t).astype(U32)
        sums = [s1[..., 0]]
        carries = [c_add[..., 0]]
        for wi in range(1, Wd):
            sw = s1[..., wi] + carries[-1]
            cw = c_add[..., wi] | (sw < s1[..., wi]).astype(U32)
            sums.append(sw)
            carries.append(cw)
        ssum = jnp.stack(sums, axis=-1)
        d0 = (ssum ^ vp) | eq | vn
        hp = vn | ~(d0 | vp)
        hn = vp & d0

        top = U32(31)
        score = score + ((hp[..., Wd - 1] >> top) & 1).astype(jnp.int32) \
                      - ((hn[..., Wd - 1] >> top) & 1).astype(jnp.int32)

        def shl1(x):
            lo = x << 1
            hi_in = jnp.concatenate(
                [jnp.zeros((*lanes, 1), U32), x[..., :-1] >> 31], axis=-1)
            return lo | hi_in

        x = shl1(hp)
        vp = shl1(hn) | ~(d0 | x)
        vn = d0 & x
        return (vp, vn, score), score

    _, scores = jax.lax.scan(col, (vp0, vn0, score0),
                             jnp.arange(ncols, dtype=jnp.int32))
    return jnp.moveaxis(scores, 0, -1)
