"""The jit-compiled single-end device mapping pipeline (SURVEY.md L4
restatement, call stack 3.2): convert -> seed -> locate -> dedup/cap ->
Hamming filter -> Myers verify -> order-free best/second selection.

The pipeline is one jitted function over fixed-shape batches; every stage is
lane-parallel with masking (no data-dependent shapes).  It must produce the
same (best, second) tuples as oracle/pipeline.map_read_se -- the shared
host-side finalize then guarantees identical SAM.

Fixed capacities (all from AlignerConfig, mirrored exactly in the oracle):
  S  = num_seeds            pigeonhole seeds per (pattern, block) frame
  O  = max_seed_occ         SA rows per seed
  LB = locate_budget        located rows per frame  (truncation: seed order)
  Kc = max_candidates       verified anchors per frame (truncation: sorted)
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from bitmapperbs_tpu import constants as K
from bitmapperbs_tpu.config import AlignerConfig
from bitmapperbs_tpu.index.device import DeviceIndex
from bitmapperbs_tpu.ops import fm, verify
from bitmapperbs_tpu.ops.kernels import verify_impl

U32 = jnp.uint32
# numpy scalars: identical inside jit, but importing this module must
# not initialize a jax backend (jnp scalar constants would)
INVALID = np.uint32(0xFFFFFFFF)
INF = np.int32(K.INF_SCORE)


def frames_for(cfg: AlignerConfig) -> list[tuple[int, int]]:
    """Static (pattern, block) frame list; order fixes bp_code = block*2+pat."""
    out = [(K.PAT_CT, K.BLOCK_FWD), (K.PAT_CT, K.BLOCK_RC)]
    if cfg.non_directional:
        out += [(K.PAT_GA, K.BLOCK_FWD), (K.PAT_GA, K.BLOCK_RC)]
    return out


def _revcomp_padded(reads, lengths):
    """Reverse-complement the real prefix of each padded read (pad -> N)."""
    B, m = reads.shape
    comp = jnp.where(reads < 4, 3 - reads, reads)
    idxs = jnp.clip(lengths[:, None] - 1 - jnp.arange(m, dtype=jnp.int32),
                    0, m - 1)
    rc = jnp.take_along_axis(comp, idxs, axis=1)
    return jnp.where(jnp.arange(m)[None, :] < lengths[:, None], rc,
                     jnp.uint8(K.N_CODE))


def _seed_bounds(lengths, num_seeds: int):
    """Pigeonhole slice [start, end) per seed, per read (int32)."""
    s = jnp.arange(num_seeds, dtype=jnp.int32)
    starts = (s[None, :] * lengths[:, None]) // num_seeds
    ends = ((s[None, :] + 1) * lengths[:, None]) // num_seeds
    return starts, ends


def _seed_stage(dix: DeviceIndex, cfg: AlignerConfig, reads, lengths,
                frames: tuple[tuple[int, int], ...]):
    """Shared convert + seed stages: returns frame tables and seed (sp, ep)."""
    B, m = reads.shape
    S = cfg.num_seeds
    F = len(frames)

    conv = jnp.asarray(K.CONV_MAP, dtype=jnp.uint8)
    rc = _revcomp_padded(reads, lengths)
    frame_reads = jnp.stack(
        [reads if p == K.PAT_CT else rc for p, _ in frames], axis=1)  # B,F,m
    patterns = conv[frame_reads]                                      # B,F,m
    blocks = jnp.asarray([b for _, b in frames], jnp.int32)           # F
    bp_codes = jnp.asarray([b * 2 + p for p, b in frames], jnp.int32)

    # ---- seeding: backward-search every (read, frame, seed) ---------------
    starts, ends = _seed_bounds(lengths, S)              # B,S
    starts_l = jnp.broadcast_to(starts[:, None, :], (B, F, S))
    ends_l = jnp.broadcast_to(ends[:, None, :], (B, F, S))
    block_l = jnp.broadcast_to(blocks[None, :, None], (B, F, S))
    pat_l = jnp.broadcast_to(patterns[:, :, None, :], (B, F, S, m))
    max_seed_len = -(-m // S)
    end_kmers = None
    if dix.klt_k and max_seed_len > dix.klt_k:
        km = fm.rolling_kmers(patterns, dix.klt_k)            # B,F,m
        idx_e = jnp.clip(ends_l - 1, 0, m - 1)                # B,F,S
        end_kmers = jnp.take_along_axis(
            jnp.broadcast_to(km[:, :, None, :], (B, F, S, m)),
            idx_e[..., None], axis=-1)[..., 0]
    sp, ep = fm.search_patterns(dix, block_l, pat_l, starts_l, ends_l,
                                max_len=max_seed_len, end_kmers=end_kmers)
    if cfg.seed_ext_max:
        # adaptive extension (C9): heavy seeds grow leftward until rare;
        # starts move with them so anchors (tp - start) stay exact
        sp, ep, starts_l = fm.extend_seeds(
            dix, block_l, pat_l, starts_l, sp, ep,
            cfg.seed_ext_max, cfg.seed_ext_occ)
    return frame_reads, blocks, bp_codes, starts_l, sp, ep


def _order_seeds(cfg: AlignerConfig, sp, ep, starts_l):
    """Per-frame seed reorder by ASCENDING kept-occurrence count (stable by
    seed index): the frozen expansion order, so locate-budget truncation
    drops the least-informative (junk) seeds' entries first (mirrors
    oracle collect_candidates).  Returns (cnt, sp, start) in that order.
    S is tiny (e+1), so the permutation is applied with where-chains, not
    gathers."""
    S = sp.shape[-1]
    cnt_u = ep - sp
    seed_ok = (cnt_u > 0) & (cnt_u <= cfg.max_seed_occ)
    cnt = jnp.where(seed_ok, cnt_u, 0).astype(jnp.int32)
    key = cnt * S + jnp.arange(S, dtype=jnp.int32)
    order = jnp.argsort(key, axis=-1)

    def take_small(x):
        outs = []
        for j in range(S):
            oj = order[..., j]
            v = x[..., 0]
            for k in range(1, S):
                v = jnp.where(oj == k, x[..., k], v)
            outs.append(v)
        return jnp.stack(outs, axis=-1)

    return take_small(cnt), take_small(sp), take_small(starts_l)


def candidate_grids(dix: DeviceIndex, cfg: AlignerConfig, reads, lengths,
                    frames: tuple[tuple[int, int], ...]):
    """Stages convert..verify for the given static frame list.

    Returns a dict of (B, F, Kc) grids: score (int32, INF = invalid),
    fwd (uint32 fwd-genome anchor), frame_a (uint32 frame anchor),
    bp (int32 block*2+pat), plus overflow bool[B], gdrop bool[B] (flat-
    buffer overflow; always False on this dense path) and frame_reads.

    This is the DENSE reference implementation (the spec): every stage runs
    over worst-case (B, F, budget) grids.  candidate_grids_compact produces
    identical grids over occupied slots only; this path remains the
    correctness oracle and the host's fallback when the flat buffer drops
    entries (cfg.compact / gdrop).
    """
    B, m = reads.shape
    e = cfg.max_errors
    S = cfg.num_seeds
    O = cfg.max_seed_occ
    LB = cfg.locate_budget
    Kc = cfg.max_candidates
    F = len(frames)
    Wd = m // 32
    L = dix.genome_len

    frame_reads, blocks, bp_codes, starts_l, sp, ep = _seed_stage(
        dix, cfg, reads, lengths, frames)

    # ---- expansion into the locate grid (ascending-frequency seed order;
    # truncation at LB drops junk-seed entries first) -----------------------
    cnt, sp, starts_l = _order_seeds(cfg, sp, ep, starts_l)      # B,F,S
    offs = jnp.cumsum(cnt, axis=-1) - cnt                        # exclusive
    total = jnp.cumsum(cnt, axis=-1)[..., -1]                    # B,F
    slot = offs[..., None] + jnp.arange(O, dtype=jnp.int32)      # B,F,S,O
    entry_ok = (jnp.arange(O, dtype=jnp.int32) < cnt[..., None]) & (slot < LB)
    sa_rows = sp[..., None] + jnp.arange(O, dtype=U32)           # B,F,S,O

    row_id = (jnp.arange(B, dtype=jnp.int32)[:, None] * F
              + jnp.arange(F, dtype=jnp.int32)[None, :])         # B,F
    flat_idx = jnp.where(entry_ok,
                         row_id[..., None, None] * LB + slot,
                         B * F * LB)                             # drop slot
    sa_grid = jnp.zeros(B * F * LB + 1, U32).at[
        flat_idx.reshape(-1)].set(sa_rows.reshape(-1), mode="drop")
    st_grid = jnp.zeros(B * F * LB + 1, jnp.int32).at[
        flat_idx.reshape(-1)].set(
        jnp.broadcast_to(starts_l[..., None], (B, F, S, O)).reshape(-1),
        mode="drop")
    ok_grid = jnp.zeros(B * F * LB + 1, jnp.bool_).at[
        flat_idx.reshape(-1)].set(entry_ok.reshape(-1), mode="drop")
    sa_grid = sa_grid[:-1].reshape(B, F, LB)
    st_grid = st_grid[:-1].reshape(B, F, LB)
    ok_grid = ok_grid[:-1].reshape(B, F, LB)
    overflow = total > LB                                        # B,F

    # ---- locate + anchor projection ---------------------------------------
    block_lb = jnp.broadcast_to(blocks[None, :, None], (B, F, LB))
    tp = fm.locate(dix, block_lb, sa_grid, ok_grid)              # B,F,LB
    anchor = tp - st_grid.astype(U32)
    n_lane = fm.block_n(dix, block_lb)
    a_ok = ok_grid & (tp >= st_grid.astype(U32)) & (
        anchor <= n_lane - 1 - lengths[:, None, None].astype(U32))
    anchor = jnp.where(a_ok, anchor, INVALID)

    # ---- dedup (sort + unique) and cap at Kc ------------------------------
    srt = jnp.sort(anchor, axis=-1)                              # B,F,LB
    uniq = (srt != INVALID) & jnp.concatenate(
        [jnp.ones((B, F, 1), jnp.bool_), srt[..., 1:] != srt[..., :-1]],
        axis=-1)
    rank = jnp.cumsum(uniq, axis=-1) - 1
    nuniq = jnp.cumsum(uniq, axis=-1)[..., -1]
    overflow = overflow | (nuniq > Kc)
    dst = jnp.where(uniq & (rank < Kc),
                    row_id[..., None] * Kc + rank, B * F * Kc)
    cand = jnp.full(B * F * Kc + 1, INVALID, U32).at[
        dst.reshape(-1)].set(srt.reshape(-1), mode="drop")
    cand = cand[:-1].reshape(B, F, Kc)                           # anchors
    c_ok = cand != INVALID

    # ---- verification: Hamming filter then (optionally) Myers -------------
    read_planes = verify.pack_codes(frame_reads)                 # 3 x B,F,Wd
    lenmask = verify.length_mask(lengths, m)[:, None, :]         # B,1,Wd
    block_kc = jnp.broadcast_to(blocks[None, :, None], (B, F, Kc))
    ref_planes = verify.window_planes(
        dix.g_planes, block_kc, jnp.where(c_ok, cand, 0), Wd, L,
        dix.idx_axis, dix.g_words)
    rp = tuple(p[:, :, None, :] for p in read_planes)
    ham = verify.hamming(ref_planes, rp, lenmask[:, :, None, :])  # B,F,Kc

    if cfg.indels and e > 0:
        ncols = m + 2 * e
        Ww = -(-ncols // 32)
        win_planes = verify.window_planes(
            dix.g_planes, block_kc,
            jnp.where(c_ok, cand, 0) - U32(e), Ww, L, dix.idx_axis,
            dix.g_words)
        peq, pad = verify.build_peq(frame_reads, lengths[:, None], m)
        peq_b = jnp.broadcast_to(peq[:, :, None], (B, F, Kc, 4, Wd))
        pad_b = jnp.broadcast_to(pad[:, :, None], (B, F, Kc, Wd))
        med = verify.myers(win_planes, peq_b, pad_b, m, ncols)
        score = jnp.where(ham <= e, ham, med)
    else:
        score = ham
    score = jnp.where(c_ok & (score <= e), score, INF)           # B,F,Kc

    # ---- fwd-coordinate anchors -------------------------------------------
    fwd = jnp.where(
        jnp.asarray([b for _, b in frames], jnp.int32)[None, :, None]
        == K.BLOCK_FWD,
        cand,
        U32(L) - cand - lengths[:, None, None].astype(U32))
    fwd = jnp.where(score < INF, fwd, INVALID)
    frame_a = jnp.where(score < INF, cand, INVALID)
    bp = jnp.broadcast_to(bp_codes[None, :, None], (B, F, Kc))

    return {
        "score": score, "fwd": fwd, "frame_a": frame_a, "bp": bp,
        "overflow": overflow.any(axis=-1),
        "gdrop": jnp.zeros(B, jnp.bool_),
        "frame_reads": frame_reads,
    }


def _blocks_select(frames, f):
    """blocks[f] per lane as a static where-chain (frame blocks are static,
    so no per-lane table gather is needed)."""
    vals = [b for _, b in frames]
    out = jnp.full(f.shape, vals[0], jnp.int32)
    for k in range(1, len(vals)):
        out = jnp.where(f == k, jnp.int32(vals[k]), out)
    return out


def _chunked_lanes(nchunks: int, n_used, outs_init, args, fn):
    """Run per-lane `fn` over flat-buffer chunks, skipping whole chunks past
    the last occupied slot (`n_used`, traced scalar).

    args/outs_init: arrays with a leading CAP lane axis.  fn(*chunk_args) ->
    tuple matching outs_init.  Lanes the loop never visits keep their
    outs_init values -- callers must already mask those lanes (true for the
    locate and verify stages: every lane >= n_used has ok/keep False).
    Chunks are fixed-size so the loop body compiles once.
    """
    CAP = args[0].shape[0]
    C = -(-CAP // nchunks)
    pad = nchunks * C - CAP

    def padded(a):
        return jnp.pad(a, ((0, pad),) + ((0, 0),) * (a.ndim - 1)) if pad \
            else a

    argsP = tuple(padded(a) for a in args)
    outsP = tuple(padded(o) for o in outs_init)
    n_used = n_used.astype(jnp.int32)

    def cond(st):
        i = st[0]
        return (i < nchunks) & (i * C < n_used)

    def body(st):
        i, outs = st
        sl = tuple(jax.lax.dynamic_slice_in_dim(a, i * C, C, 0)
                   for a in argsP)
        res = fn(*sl)
        outs = tuple(jax.lax.dynamic_update_slice_in_dim(o, r, i * C, 0)
                     for o, r in zip(outs, res))
        return i + 1, outs

    _, outs = jax.lax.while_loop(cond, body, (jnp.int32(0), outsP))
    return tuple(o[:CAP] for o in outs)


def candidate_grids_compact(dix: DeviceIndex, cfg: AlignerConfig, reads,
                            lengths, frames: tuple[tuple[int, int], ...]):
    """candidate_grids over a FLAT buffer of occupied slots.

    The dense path sizes every stage for the worst case (LB locate slots and
    Kc verify slots per (read, frame)) while the average occupancy is a few
    candidates per read, so locate/verify burn ~10-20x their useful gather
    and DP work.  Here the (read, frame, seed) occurrence lists are flattened
    batch-wide into CAP = B * cfg.locate_flat_cap slots (slot -> seed via
    searchsorted on the per-frame cumulative counts -- no giant scatter),
    located, deduped with one 2-key sort, verified, and scattered back into
    the dense (B, F, Kc) grids consumers expect.

    Bit-identical to the dense path for every read whose frames fit the flat
    buffer; reads with dropped entries are flagged in `gdrop` and must be
    re-run dense by the host (models/host.py) to stay deterministic across
    batch compositions and shardings.
    """
    B, m = reads.shape
    e = cfg.max_errors
    S = cfg.num_seeds
    O = cfg.max_seed_occ
    LB = cfg.locate_budget
    Kc = cfg.max_candidates
    F = len(frames)
    Wd = m // 32
    L = dix.genome_len
    R = B * F
    CAP = B * cfg.resolve_flat_cap(dix.genome_len, F)

    frame_reads, blocks, bp_codes, starts_l, sp, ep = _seed_stage(
        dix, cfg, reads, lengths, frames)

    # ---- flat expansion: slot -> (frame, seed, offset) -------------------
    # Each (frame, seed) with kept occurrences owns a contiguous RUN of flat
    # slots.  One scatter marks every run's start slot with its (frame, seed)
    # code and global start, and a cummax propagates them across the packed
    # buffer -- cheaper than per-slot searchsorted + cumulative-row gathers
    # (runs' codes are monotone over the buffer, so cummax is exact).
    # Seeds expand in ascending-frequency order (frozen truncation spec).
    cnt, sp, starts_l = _order_seeds(cfg, sp, ep, starts_l)      # B,F,S
    cum = jnp.cumsum(cnt, axis=-1)                               # inclusive
    offs = (cum - cnt).reshape(R, S)                             # exclusive
    total = cum[..., -1]                                         # B,F
    frame_occ = jnp.minimum(total, LB).reshape(R)                # R
    frame_base = jnp.cumsum(frame_occ) - frame_occ               # R, exclusive
    overflow = total > LB                                        # B,F
    gdrop = ((frame_base + frame_occ > CAP).reshape(B, F)
             & (frame_occ.reshape(B, F) > 0)).any(axis=-1)       # B

    src_ok = (cnt.reshape(R, S) > 0) & (offs < frame_occ[:, None])
    gstart = frame_base[:, None] + offs                          # R,S
    dst = jnp.where(src_ok, gstart, CAP).reshape(-1)
    fs_code = (jnp.arange(R, dtype=jnp.int32)[:, None] * S
               + jnp.arange(S, dtype=jnp.int32)).reshape(-1)
    fs = jax.lax.cummax(
        jnp.zeros(CAP + 1, jnp.int32).at[dst].max(fs_code)[:CAP])
    gs = jax.lax.cummax(
        jnp.zeros(CAP + 1, jnp.int32).at[dst].max(gstart.reshape(-1))[:CAP])
    g = jnp.arange(CAP, dtype=jnp.int32)
    n_used = (frame_base[-1] + frame_occ[-1]).astype(jnp.int32)
    ok = g < n_used                           # buffer is packed
    # one stacked per-(frame,seed) table gather instead of three
    len_bfs = jnp.broadcast_to(lengths[:, None, None], (B, F, S))
    seed_tab = jnp.stack(
        [sp.reshape(-1), starts_l.reshape(-1).astype(U32),
         len_bfs.reshape(-1).astype(U32)], axis=-1)              # R*S, 3
    picked = seed_tab[fs]
    sa_row = picked[:, 0] + (g - gs).astype(U32)
    st = picked[:, 1].astype(jnp.int32)
    len_b = picked[:, 2].astype(jnp.int32)
    fidx = fs // S
    blk = _blocks_select(frames, fidx % F)

    # ---- locate + anchor projection ----------------------------------------
    chunks = cfg.flat_chunks if dix.idx_axis is None else 0
    if chunks > 1:
        (tp,) = _chunked_lanes(
            chunks, n_used, (jnp.zeros(CAP, U32),), (blk, sa_row, ok),
            lambda b_, r_, o_: (fm.locate(dix, b_, r_, o_),))
    else:
        tp = fm.locate(dix, blk, sa_row, ok)
    anchor = tp - st.astype(U32)
    n_lane = fm.block_n(dix, blk)
    a_ok = ok & (tp >= st.astype(U32)) & (
        anchor <= n_lane - 1 - len_b.astype(U32))
    anchor = jnp.where(a_ok, anchor, INVALID)

    # ---- dedup: one flat 2-key sort + per-frame unique rank ----------------
    # (read lengths ride along as a sort payload so the verify stage needs
    # no per-lane length gather afterwards)
    key_row = jnp.where(a_ok, fidx, R)
    rowS, anchS, lenS = jax.lax.sort((key_row, anchor, len_b), num_keys=2)
    validS = rowS < R
    first = jnp.concatenate([
        jnp.ones(1, jnp.bool_),
        (rowS[1:] != rowS[:-1]) | (anchS[1:] != anchS[:-1])])
    uniq = validS & first
    s_in = jnp.cumsum(uniq.astype(jnp.int32))
    s_excl = s_in - uniq
    seg_first = jnp.full(R + 1, 1 << 30, jnp.int32).at[rowS].min(s_excl)
    rank = s_excl - seg_first[jnp.minimum(rowS, R)]
    nuniq = jnp.zeros(R + 1, jnp.int32).at[rowS].add(uniq.astype(jnp.int32))
    overflow = overflow | (nuniq[:R].reshape(B, F) > Kc)
    keep = uniq & (rank < Kc)

    # ---- verification on the flat (sorted) lanes ---------------------------
    rowC = jnp.minimum(rowS, R - 1)
    blkS = _blocks_select(frames, rowC % F)
    cand = jnp.where(keep, anchS, 0)

    planes3 = jnp.stack(verify.pack_codes(frame_reads), axis=2)  # B,F,3,Wd
    # one flat (CAP, 3*Wd) row gather fetches all three planes of a read
    rp = planes3.reshape(R, 3 * Wd)[rowC]                         # CAP,3*Wd
    d0, d1, dn = rp[:, :Wd], rp[:, Wd:2 * Wd], rp[:, 2 * Wd:]
    lenmask = verify.length_mask(lenS, m)                        # CAP,Wd
    fused_verify = verify_impl(cfg).fused_verify

    def _verify_lanes(blk_, cand_, d0_, d1_, dn_, lm_):
        if cfg.indels and e > 0:
            ncols = m + 2 * e
            Ww = -(-ncols // 32)                                  # == Wd + 1
            wide = verify.window_planes(dix.g_planes, blk_, cand_ - U32(e),
                                        Ww, L, dix.idx_axis, dix.g_words)
            # funnel shift + Hamming filter + Myers + select in one pass
            # (a GPU kernel on the GPU; bit-identical to the dense path)
            return (fused_verify(wide, (d0_, d1_, dn_), lm_, m, ncols, e),)
        ref = verify.window_planes(dix.g_planes, blk_, cand_, Wd, L,
                                   dix.idx_axis, dix.g_words)
        return (verify.hamming(ref, (d0_, d1_, dn_), lm_),)

    v_args = (blkS, cand, d0, d1, dn, lenmask)
    if chunks > 1:
        # valid (sorted-front) lanes only; skipped lanes keep INF and are
        # masked by `keep` below anyway
        n_valid = jnp.sum(validS.astype(jnp.int32))
        (score,) = _chunked_lanes(chunks, n_valid,
                                  (jnp.full(CAP, INF, jnp.int32),),
                                  v_args, _verify_lanes)
    else:
        (score,) = _verify_lanes(*v_args)
    score = jnp.where(keep & (score <= e), score, INF)

    # ---- scatter back into the dense (B, F, Kc) grids ----------------------
    dst = jnp.where(keep, rowS * Kc + rank, R * Kc)
    score_d = jnp.full(R * Kc + 1, INF, jnp.int32).at[dst].set(
        score, mode="drop")[:-1].reshape(B, F, Kc)
    cand_d = jnp.full(R * Kc + 1, INVALID, U32).at[dst].set(
        anchS, mode="drop")[:-1].reshape(B, F, Kc)

    fwd = jnp.where(
        jnp.asarray([b for _, b in frames], jnp.int32)[None, :, None]
        == K.BLOCK_FWD,
        cand_d,
        U32(L) - cand_d - lengths[:, None, None].astype(U32))
    fwd = jnp.where(score_d < INF, fwd, INVALID)
    frame_a = jnp.where(score_d < INF, cand_d, INVALID)
    bp = jnp.broadcast_to(bp_codes[None, :, None], (B, F, Kc))

    return {
        "score": score_d, "fwd": fwd, "frame_a": frame_a, "bp": bp,
        "overflow": overflow.any(axis=-1), "gdrop": gdrop,
        "frame_reads": frame_reads,
    }


def candidate_stage(dix: DeviceIndex, cfg: AlignerConfig, reads, lengths,
                    frames: tuple[tuple[int, int], ...]):
    """Dispatch: compacted pipeline (default) or dense reference path."""
    fn = candidate_grids_compact if cfg.compact else candidate_grids
    return fn(dix, cfg, reads, lengths, frames)


def select_se(grids, e: int):
    """Order-free (score, fwd_anchor, block, pat) best/second reduction."""
    B = grids["score"].shape[0]
    sflat = grids["score"].reshape(B, -1)
    aflat = grids["fwd"].reshape(B, -1)
    frame_a = grids["frame_a"].reshape(B, -1)
    bpflat = grids["bp"].reshape(B, -1)

    s_best = sflat.min(axis=-1)                                   # B
    m1 = sflat == s_best[:, None]
    a_best = jnp.where(m1, aflat, INVALID).min(axis=-1)
    m2 = m1 & (aflat == a_best[:, None])
    bp_best = jnp.where(m2, bpflat, 127).min(axis=-1)
    m3 = m2 & (bpflat == bp_best[:, None])
    fa_best = jnp.where(m3, frame_a, INVALID).min(axis=-1)

    diff = jnp.maximum(frame_a, fa_best[:, None]) - jnp.minimum(
        frame_a, fa_best[:, None])
    distinct = (bpflat != bp_best[:, None]) | (diff > U32(e))
    s_second = jnp.where(distinct, sflat, INF).min(axis=-1)

    return {
        "best_score": s_best,
        "best_bp": bp_best,
        "best_anchor": fa_best,
        "second_score": s_second,
        "overflow": grids["overflow"],
        "gdrop": grids["gdrop"],
    }


@functools.partial(jax.jit, static_argnames=("cfg",))
def map_batch_device(dix: DeviceIndex, cfg: AlignerConfig, reads, lengths):
    """Single-end mapping: reads uint8[B, m_pad] (pad = N), lengths int32[B].

    Returns per-read arrays:
      best_score   int32[B]   (INF when unmapped)
      best_bp      int32[B]   block*2 + pat of the winning frame
      best_anchor  uint32[B]  frame-local anchor
      second_score int32[B]   (INF when no distinct-locus second)
      overflow     bool[B]    any capacity truncation occurred
      gdrop        bool[B]    flat-buffer drop: host must re-run dense
    """
    grids = candidate_stage(dix, cfg, reads, lengths, tuple(frames_for(cfg)))
    return select_se(grids, cfg.max_errors)
