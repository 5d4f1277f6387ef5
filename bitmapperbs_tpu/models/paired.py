"""Device paired-end pipeline (SURVEY.md call stack 3.3, BASELINE config 3).

Runs the SE candidate stages for both mates (mate 2 with opposite
conversion), then on-device: proper-pair join over compatible frame pairs,
lexicographic pair selection, pair second-best, per-mate SE selection, and
a windowed mate-rescue verification pass.  The host (models/host.py) applies
the same decision order as oracle/paired.map_pair: proper pair -> rescue ->
discordant SE fallback, so SAM equality again reduces to tuple equality.

Memory note: the pair join materializes (B, Kc, Kc) per compatible frame
pair sequentially (staged reductions), never the full P-way stack.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from bitmapperbs_tpu import constants as K
from bitmapperbs_tpu.config import AlignerConfig
from bitmapperbs_tpu.index.device import DeviceIndex
from bitmapperbs_tpu.models.aligner import (INF, INVALID, U32,
                                            candidate_stage, select_se)
from bitmapperbs_tpu.oracle.pipeline import se_frames
from bitmapperbs_tpu.ops import verify
from bitmapperbs_tpu.ops.kernels import verify_impl

# bp code -> is-reverse (bp = block*2 + pat; see constants.IS_REVERSE)
_REV_BY_BP = [K.IS_REVERSE[(bp >> 1, bp & 1)] for bp in range(4)]


def _frame_anchor(fwd, block_arr, m_arr, L):
    return jnp.where(block_arr == K.BLOCK_FWD, fwd,
                     U32(L) - fwd - m_arr.astype(U32))


def _lex_lt(a: tuple, b: tuple):
    """Elementwise lexicographic a < b over equal-length tuples of arrays."""
    lt = None
    eq = None
    for x, y in zip(a, b):
        this_lt = x < y
        this_eq = x == y
        if lt is None:
            lt, eq = this_lt, this_eq
        else:
            lt = lt | (eq & this_lt)
            eq = eq & this_eq
    return lt


@functools.partial(jax.jit, static_argnames=("cfg",))
def map_batch_pe_device(dix: DeviceIndex, cfg: AlignerConfig,
                        reads1, lengths1, reads2, lengths2):
    """Paired batch -> decision inputs for the host PE assembler."""
    B, m = reads1.shape
    e = cfg.max_errors
    Kc = cfg.max_candidates
    L = dix.genome_len
    frames1 = tuple(se_frames(cfg, mate=0))
    frames2 = tuple(se_frames(cfg, mate=1))

    g1 = candidate_stage(dix, cfg, reads1, lengths1, frames1)
    g2 = candidate_stage(dix, cfg, reads2, lengths2, frames2)
    m1u = lengths1.astype(U32)
    m2u = lengths2.astype(U32)

    # ---- proper-pair join over compatible (same block, opposite pat) ------
    compat = [(i1, i2)
              for i1, (p1, b1) in enumerate(frames1)
              for i2, (p2, b2) in enumerate(frames2)
              if b1 == b2 and p1 != p2]

    WORST = (jnp.full(B, 2 * INF, jnp.int32), jnp.full(B, INVALID, U32),
             jnp.full(B, INVALID, U32), jnp.full(B, 127, jnp.int32),
             jnp.full(B, 127, jnp.int32))
    best = WORST
    best_s1 = jnp.full(B, INF, jnp.int32)   # payload: mate-1 score of best

    def pair_grid(i1, i2):
        s1, f1 = g1["score"][:, i1], g1["fwd"][:, i1]        # B,Kc
        s2, f2 = g2["score"][:, i2], g2["fwd"][:, i2]
        rev1 = _REV_BY_BP[frames1[i1][1] * 2 + frames1[i1][0]]
        if not rev1:  # mate1 is the forward-orientation mate
            ffwd, frev = f1[:, :, None], f2[:, None, :]
            mrev = m2u[:, None, None]
        else:
            ffwd, frev = f2[:, None, :], f1[:, :, None]
            mrev = m1u[:, None, None]
        insert = frev + mrev - ffwd
        ok = ((s1[:, :, None] < INF) & (s2[:, None, :] < INF)
              & (ffwd <= frev)
              & (insert >= U32(cfg.min_insert))
              & (insert <= U32(cfg.max_insert)))
        ssum = jnp.where(ok, s1[:, :, None] + s2[:, None, :], 2 * INF)
        return ssum, ok

    pair_data = []
    for i1, i2 in compat:
        ssum, ok = pair_grid(i1, i2)
        f1 = g1["fwd"][:, i1][:, :, None]
        f2 = g2["fwd"][:, i2][:, None, :]
        bp1 = frames1[i1][1] * 2 + frames1[i1][0]
        bp2 = frames2[i2][1] * 2 + frames2[i2][0]
        # staged lexicographic min inside this pair grid
        sflat = ssum.reshape(B, -1)
        smin = sflat.min(axis=-1)
        w1 = jnp.where(ssum == smin[:, None, None],
                       jnp.broadcast_to(f1, ssum.shape), INVALID)
        f1min = w1.reshape(B, -1).min(axis=-1)
        m2sel = (ssum == smin[:, None, None]) & (
            jnp.broadcast_to(f1, ssum.shape) == f1min[:, None, None])
        w2 = jnp.where(m2sel, jnp.broadcast_to(f2, ssum.shape), INVALID)
        f2min = w2.reshape(B, -1).min(axis=-1)
        cand = (smin, f1min, f2min,
                jnp.full(B, bp1, jnp.int32), jnp.full(B, bp2, jnp.int32))
        # mate-1 score of the selected candidate (payload for finalize's
        # ungapped-at-score test; the selected cell is unique per read)
        s1b = jnp.broadcast_to(g1["score"][:, i1][:, :, None], ssum.shape)
        m3sel = m2sel & (jnp.broadcast_to(f2, ssum.shape)
                         == f2min[:, None, None])
        s1min = jnp.where(m3sel, s1b, INF).reshape(B, -1).min(axis=-1)
        take = _lex_lt(cand, best)
        best = tuple(jnp.where(take, c, b) for c, b in zip(cand, best))
        best_s1 = jnp.where(take, s1min, best_s1)
        pair_data.append((ssum, f1, f2, bp1, bp2))

    psum, pf1, pf2, pbp1, pbp2 = best
    pair_valid = psum < 2 * INF
    pa1 = _frame_anchor(pf1, pbp1 >> 1, m1u, L)
    pa2 = _frame_anchor(pf2, pbp2 >> 1, m2u, L)

    # ---- pair second-best (distinct if EITHER mate at a distinct locus) ---
    second_sum = jnp.full(B, 2 * INF, jnp.int32)
    for (ssum, f1, f2, bp1, bp2) in pair_data:
        a1 = _frame_anchor(f1, jnp.int32(bp1 >> 1), m1u[:, None, None], L)
        a2 = _frame_anchor(f2, jnp.int32(bp2 >> 1), m2u[:, None, None], L)
        d1 = (pbp1[:, None, None] != bp1) | (
            jnp.maximum(a1, pa1[:, None, None])
            - jnp.minimum(a1, pa1[:, None, None]) > U32(e))
        d2 = (pbp2[:, None, None] != bp2) | (
            jnp.maximum(a2, pa2[:, None, None])
            - jnp.minimum(a2, pa2[:, None, None]) > U32(e))
        s = jnp.where(d1 | d2, ssum, 2 * INF).reshape(B, -1).min(axis=-1)
        second_sum = jnp.minimum(second_sum, s)

    # ---- per-mate SE selection (for rescue anchoring and fallback) ---------
    se1 = select_se(g1, e)
    se2 = select_se(g2, e)

    # ---- mate rescue -------------------------------------------------------
    # anchored mate = smaller SE key (score, fwd_anchor, bp); oracle: <=
    rev_tab = jnp.asarray(_REV_BY_BP, jnp.bool_)
    f1fwd = _se_fwd(se1, m1u, L)
    f2fwd = _se_fwd(se2, m2u, L)
    key1 = (se1["best_score"], f1fwd, se1["best_bp"])
    key2 = (se2["best_score"], f2fwd, se2["best_bp"])
    anch_is_1 = (se1["best_score"] < INF) & (
        (se2["best_score"] >= INF) | ~_lex_lt(key2, key1))

    have_anchor = (se1["best_score"] < INF) | (se2["best_score"] < INF)
    A = jnp.where(anch_is_1, f1fwd, f2fwd)                 # fwd anchor
    a_bp = jnp.where(anch_is_1, se1["best_bp"], se2["best_bp"])
    a_rev = rev_tab[jnp.clip(a_bp, 0, 3)]
    a_len = jnp.where(anch_is_1, m1u, m2u)
    ms_len = jnp.where(anch_is_1, m2u, m1u)                # missing mate len
    ms_lengths = jnp.where(anch_is_1, lengths2, lengths1)
    block = jnp.clip(a_bp >> 1, 0, 1)

    # missing mate's frame read planes / peq: pattern = opposite of anchored
    opp_pat = jnp.where(anch_is_1, 1 - (se1["best_bp"] & 1),
                        1 - (se2["best_bp"] & 1))          # B
    ms_planes, ms_peq, ms_pad, ms_lenmask = _missing_mate_tables(
        cfg, g1, g2, anch_is_1, opp_pat, ms_lengths, m)

    Wd = m // 32
    R = cfg.max_insert - cfg.min_insert + 1
    # fwd offset range [lo, hi], uint32 with explicit underflow clamps
    # (A + a_len and A + max_insert stay < 2^32 for uint32 genomes)
    lo_rev = jnp.where(A + a_len >= U32(cfg.max_insert),
                       A + a_len - U32(cfg.max_insert), U32(0))
    lo_fwd = jnp.where(A + U32(cfg.min_insert) >= ms_len,
                       A + U32(cfg.min_insert) - ms_len, U32(0))
    lo = jnp.where(a_rev, lo_rev, lo_fwd)
    # hi needs the same underflow guards: the oracle computes hi in signed
    # ints and a negative hi (< lo) means "no rescue window"; unguarded u32
    # wrap here would instead survive the L - ms_len clamp and scan a
    # near-full-genome window (spurious proper pairs).
    hi_ok = jnp.where(a_rev, A + a_len >= U32(cfg.min_insert),
                      A + U32(cfg.max_insert) >= ms_len)
    hi = jnp.where(a_rev,
                   jnp.where(A + a_len >= U32(cfg.min_insert),
                             A + a_len - U32(cfg.min_insert), U32(0)),
                   jnp.where(A + U32(cfg.max_insert) >= ms_len,
                             A + U32(cfg.max_insert) - ms_len, U32(0)))
    hi = jnp.minimum(hi, U32(L) - ms_len)
    r_ok = have_anchor & hi_ok & (lo <= hi)

    if cfg.indels and e > 0:
        # ONE semi-global Myers scan per pair over the whole insert window
        # (oracle/paired.rescue frozen spec): the per-offset banded DPs'
        # alignment sets union to the scan's infix set, so one (B,) lane
        # pass replaces (B, R) lanes of banded DP.  Column j of the scan is
        # the REAL read's alignment ending at win_start + j - (m - length)
        # (pad rows shift by m - length; verify.myers_scan docstring).
        a_lo = jnp.where(block == 0, lo, U32(L) - hi - ms_len)
        span = hi - lo                                     # == a_hi - a_lo
        ncols = R + m + 2 * e
        Ww = -(-ncols // 32)
        win_start = jnp.where(r_ok, a_lo - U32(e), 0)      # wrap >= -e legal
        win = verify.window_planes(
            dix.g_planes, block, win_start, Ww, L, dix.idx_axis,
            dix.g_words)
        S = verify_impl(cfg).rescue_scan(win, ms_peq, ms_pad, m,
                                         ncols)            # B, ncols
        # real frame anchor of column j: A_raw = a_lo + (j - (e + m - 1));
        # valid iff j >= e+m-1 and j - (e+m-1) <= span (wrap-free in u32)
        j = jnp.arange(ncols, dtype=jnp.int32)
        joff = j - (e + m - 1)                             # may be negative
        in_range = (joff >= 0) & (joff[None, :] <= span[:, None].astype(
            jnp.int32))
        A_raw = a_lo[:, None] + jnp.maximum(joff, 0).astype(U32)
        valid = r_ok[:, None] & in_range & (S <= e)
        P = jnp.where(block[:, None] == 0, A_raw,
                      U32(L) - A_raw - ms_len[:, None])
        rscore = jnp.where(valid, S, INF)
        rs_best = rscore.min(axis=-1)
        rm1 = valid & (S == rs_best[:, None])
        rp_best = jnp.where(rm1, P, INVALID).min(axis=-1)
        A_best = jnp.where(block == 0, rp_best,
                           U32(L) - rp_best - ms_len)
        rdiff = jnp.maximum(A_raw, A_best[:, None]) - jnp.minimum(
            A_raw, A_best[:, None])
        rs_second = jnp.where(valid & (rdiff > U32(e)), S, INF).min(axis=-1)
    else:
        # mismatch-only: per-offset Hamming over the window (frozen spec)
        p = lo[:, None] + jnp.arange(R, dtype=U32)         # B,R fwd positions
        p_ok = (r_ok[:, None] & (p >= lo[:, None]) & (p <= hi[:, None]))
        a_ms = _frame_anchor(p, block[:, None], ms_len[:, None], L)
        rp = tuple(pl[:, None, :] for pl in ms_planes)
        ref = verify.window_planes(
            dix.g_planes, jnp.broadcast_to(block[:, None], (B, R)),
            jnp.where(p_ok, a_ms, 0), Wd, L, dix.idx_axis, dix.g_words)
        rham = verify.hamming(ref, rp, ms_lenmask[:, None, :])
        rscore = jnp.where(p_ok & (rham <= e), rham, INF)  # B,R
        rs_best = rscore.min(axis=-1)
        rm1 = rscore == rs_best[:, None]
        rp_best = jnp.where(rm1, p, INVALID).min(axis=-1)
        rdiff = jnp.maximum(p, rp_best[:, None]) - jnp.minimum(
            p, rp_best[:, None])
        rs_second = jnp.where(rdiff > U32(e), rscore, INF).min(axis=-1)

    return {
        "pair_valid": pair_valid,
        "gdrop": g1["gdrop"] | g2["gdrop"],
        "pair_sum": psum, "pair_second_sum": second_sum,
        "pair_s1": best_s1,
        "pair_a1": pa1, "pair_bp1": pbp1,
        "pair_a2": pa2, "pair_bp2": pbp2,
        "se1": se1, "se2": se2,
        "resc_valid": have_anchor & (rs_best < INF),
        "resc_anch_is_1": anch_is_1,
        "resc_fwd": rp_best, "resc_score": rs_best,
        "resc_second": rs_second,
        "resc_block": block, "resc_pat": opp_pat,
    }


def _se_fwd(se, m_u32, L):
    """Recover the SE best hit's fwd anchor from (bp, frame anchor)."""
    return jnp.where(se["best_bp"] >> 1 == K.BLOCK_FWD, se["best_anchor"],
                     U32(L) - se["best_anchor"] - m_u32)


def _missing_mate_tables(cfg, g1, g2, anch_is_1, opp_pat, ms_lengths, m):
    """Read planes / PEQ / masks of the missing mate at pattern `opp_pat`.

    Frame layout: se_frames gives [own, own(, other, other)] patterns, so
    frame index 0 carries the mate's own pattern and (in non-directional
    mode) index 2 the opposite.  In directional mode the opposite pattern
    of the anchored mate is always the missing mate's own pattern (idx 0).
    """
    def tables(grids, want_alt):
        fr = grids["frame_reads"]
        f_idx = 2 if (want_alt and fr.shape[1] > 2) else 0
        return fr[:, f_idx]

    nd = cfg.non_directional
    # anchored mate's own pattern: bp & 1.  missing's own pattern differs by
    # mate; opp_pat == missing mate's own pattern except flipped-ND cases.
    own2 = K.PAT_GA  # mate2's first-frame pattern
    own1 = K.PAT_CT
    if not nd:
        ms_reads = jnp.where(anch_is_1[:, None],
                             tables(g2, False), tables(g1, False))
    else:
        ms_reads = jnp.where(
            anch_is_1[:, None],
            jnp.where((opp_pat == own2)[:, None],
                      tables(g2, False), tables(g2, True)),
            jnp.where((opp_pat == own1)[:, None],
                      tables(g1, False), tables(g1, True)))
    planes = verify.pack_codes(ms_reads)
    lenmask = verify.length_mask(ms_lengths, m)
    peq, pad = verify.build_peq(ms_reads, ms_lengths, m)
    return planes, peq, pad, lenmask
