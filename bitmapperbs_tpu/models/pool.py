"""Host finalize worker pool and the jax-free decode/assembly helpers.

The host finalize is pure numpy/python and ~10x slower than the device
mapping, so it fans out over SPAWNED worker processes (fork deadlocks under
jax's threads).  This module is deliberately jax-free: spawn workers import
it (plus oracle/io modules) without pulling in jax, and share the genome via
memory-mapped files so per-worker memory stays O(1) even for GRCh38.
SURVEY.md C19's pthread pool becomes this: the device replaces the mapping
workers, worker processes replace the rest.
"""
from __future__ import annotations

import os

import numpy as np

from bitmapperbs_tpu import constants as K
from bitmapperbs_tpu.config import AlignerConfig
from bitmapperbs_tpu.io.sam import SamRecord, unmapped_record
from bitmapperbs_tpu.models import native_finalize
from bitmapperbs_tpu.models.finalize import (finalize_batch,
                                             finalize_batch_device)
from bitmapperbs_tpu.oracle.pipeline import Hit, finalize_hit

INF = K.INF_SCORE

def device_results_to_hits(cfg: AlignerConfig, genome_len: int, lengths,
                           out) -> list[tuple[Hit | None, Hit | None]]:
    """Device output dict -> per-read (best, second) oracle Hits."""
    bs = np.asarray(out["best_score"])
    bp = np.asarray(out["best_bp"])
    ba = np.asarray(out["best_anchor"])
    ss = np.asarray(out["second_score"])
    res = []
    for i in range(len(bs)):
        if bs[i] >= int(INF):
            res.append((None, None))
            continue
        b, p = int(bp[i]) >> 1, int(bp[i]) & 1
        a = int(ba[i])
        fwd = a if b == K.BLOCK_FWD else genome_len - a - int(lengths[i])
        best = Hit(int(bs[i]), fwd, b, p, a)
        second = None
        if ss[i] < int(INF):
            second = Hit(int(ss[i]), 0, 0, 0, 0)  # only .score is consumed
        res.append((best, second))
    return res



_POOL_CTX: dict = {}


def _pool_worker_init(codes_path, rc_path, L, names, offsets, lengths, cfg):
    from bitmapperbs_tpu.index.build import Genome

    codes = np.memmap(codes_path, dtype=np.uint8, mode="r", shape=(L,))
    rc = np.memmap(rc_path, dtype=np.uint8, mode="r", shape=(L,))
    genome = Genome(names=names, offsets=offsets, lengths=lengths,
                    codes=codes)

    class _SlimIndex:
        pass

    idx = _SlimIndex()
    idx.genome = genome
    _POOL_CTX["idx"] = idx
    _POOL_CTX["rc_ref"] = rc
    _POOL_CTX["cfg"] = cfg


def _finalize_se_task(args):
    """Worker: device outputs -> SamRecords (hits + finalize + unmapped).

    Takes the PADDED read array + lengths (one pickle each) and the numpy
    device-output dict; everything per-read happens in the worker."""
    idx = _POOL_CTX["idx"]
    rc_ref = _POOL_CTX["rc_ref"]
    # per-task cfg override (cli -e rate mode maps each read-length budget
    # with its own static config); None = the pool's construction-time cfg
    arr, lengths, n, quals, qnames, out_np, cfg = args
    cfg = cfg if cfg is not None else _POOL_CTX["cfg"]
    recs = native_finalize.finalize_se_native(
        idx, rc_ref, cfg, arr[:n], lengths[:n], quals, qnames, out_np)
    if recs is None:   # library not built: numpy spec path
        recs = finalize_batch_device(idx, rc_ref, cfg, arr[:n], lengths[:n],
                                     quals, qnames, out_np)
    return [rec if rec is not None
            else unmapped_record(qnames[i], arr[i, :lengths[i]], quals[i])
            for i, rec in enumerate(recs)]


def make_finalize_pool(idx: BSIndex, cfg: AlignerConfig, threads: int,
                       tmpdir: str | None = None):
    """Spawn a finalize pool (or None for in-process).

    Writes the genome (both orientations) to memory-mapped temp files once;
    each worker maps them read-only (page cache shared across workers)."""
    if threads <= 1:
        return None
    import multiprocessing
    import tempfile

    import atexit
    import shutil

    d = tempfile.mkdtemp(prefix="btbs_pool_", dir=tmpdir)
    codes_path = os.path.join(d, "codes.u8")
    rc_path = os.path.join(d, "rc.u8")
    idx.genome.codes.astype(np.uint8).tofile(codes_path)
    idx.genome.rc_codes().tofile(rc_path)
    # the memmap files are ~2x genome size (6+ GB for GRCh38): remove the
    # temp dir when the pool shuts down (and at exit as a backstop)
    def _cleanup(path=d):
        shutil.rmtree(path, ignore_errors=True)

    atexit.register(_cleanup)
    # spawn, not fork: forking a process that has started jax's runtime
    # threads can deadlock; workers are numpy-only and never touch a device
    ctx = multiprocessing.get_context("spawn")
    pool = ctx.Pool(
        threads, initializer=_pool_worker_init,
        initargs=(codes_path, rc_path, idx.genome.length,
                  idx.genome.names, idx.genome.offsets,
                  idx.genome.lengths, cfg))
    orig_terminate = pool.terminate

    def _terminate():
        orig_terminate()
        _cleanup()

    pool.terminate = _terminate
    return pool



def _finalize_se_task_local(idx, rc_ref, cfg, task):
    arr, lengths, n, quals, qnames, out_np = task
    recs = native_finalize.finalize_se_native(
        idx, rc_ref, cfg, arr[:n], lengths[:n], quals, qnames, out_np)
    if recs is None:   # library not built: numpy spec path
        recs = finalize_batch_device(idx, rc_ref, cfg, arr[:n], lengths[:n],
                                     quals, qnames, out_np)
    return [rec if rec is not None
            else unmapped_record(qnames[i], arr[i, :lengths[i]], quals[i])
            for i, rec in enumerate(recs)]



def _assemble_pe_task(args):
    idx = _POOL_CTX["idx"]
    rc_ref = _POOL_CTX["rc_ref"]
    *rest, cfg = args
    cfg = cfg if cfg is not None else _POOL_CTX["cfg"]
    return _assemble_pe_local(idx, rc_ref, cfg, *rest)


def _cigar_ref_span(cig: str) -> int:
    """Reference bases consumed by a CIGAR (M/D ops).  The ungapped "NNM"
    form -- the overwhelming majority -- parses without the regex that
    dominated the PE patch stage."""
    if cig[-1] == "M" and cig[:-1].isdigit():
        return int(cig[:-1])
    span = 0
    v = 0
    for ch in cig:
        if "0" <= ch <= "9":
            v = v * 10 + ord(ch) - 48
        else:
            if ch in "MD":
                span += v
            v = 0
    return span


def _patch_pair_fields(r1, r2, proper: bool):
    """opaired._emit_pair's tail: RNEXT/PNEXT(/TLEN when proper)."""
    if r1.rname == r2.rname:
        r1.rnext = r2.rnext = "="
        if proper:
            left, right = (r1, r2) if r1.pos <= r2.pos else (r2, r1)
            tlen = right.pos + _cigar_ref_span(right.cigar) - left.pos
            left.tlen, right.tlen = tlen, -tlen
    else:
        r1.rnext, r2.rnext = r2.rname, r1.rname
    r1.pnext, r2.pnext = r2.pos, r1.pos


def _assemble_pe_local(idx, rc_ref, cfg, a1, l1, a2, l2, n, quals, qnames,
                       host):
    """Batch-assemble PE records: decide every pair's first-choice branch,
    finalize ALL the implied records in one vectorized finalize_batch, then
    patch PE fields -- per-pair python (_assemble_pair) only for pairs
    whose optimistic records were rejected by finalize (contig-edge cases)
    or that need a later branch.  Byte-identical to the per-pair path
    (asserted by the PE parity suites through map_pairs)."""
    from bitmapperbs_tpu.oracle import paired as opaired
    from bitmapperbs_tpu import constants as K2

    e = cfg.max_errors
    L = idx.genome.length
    rev_of = lambda h: K.IS_REVERSE[(h.block, h.pat)]

    reads1 = [a1[i, :l1[i]] for i in range(n)]
    reads2 = [a2[i, :l2[i]] for i in range(n)]

    # ---- phase 1: branch decisions + optimistic finalize work items -------
    it_reads, it_quals, it_qn, it_hits, it_flags, it_mapq = [], [], [], [], [], []
    it_src = []   # (mate 0/1, pair index): row source for the padded batch
    plan = []   # per pair: (branch, (item_idx1, item_idx2) | None)

    def add_item(read, qual, qn, best, second, flag, mapq, mate, pi):
        it_reads.append(read)
        it_quals.append(qual)
        it_qn.append(qn)
        it_hits.append((best, second))
        it_flags.append(flag)
        it_mapq.append(mapq)
        it_src.append((mate, pi))
        return len(it_reads) - 1

    for i in range(n):
        q = quals[i] if quals else ("", "")
        qn = qnames[i] if qnames else f"p{i}"
        m1, m2 = len(reads1[i]), len(reads2[i])

        branch, h1, h2, mapq = _decide_pair(host, i, m1, m2, L)
        if branch in ("pair", "resc"):
            base = [K.FLAG_PAIRED | K.FLAG_PROPER | K.FLAG_READ1,
                    K.FLAG_PAIRED | K.FLAG_PROPER | K.FLAG_READ2]
            j1 = add_item(reads1[i], q[0], qn, h1, None,
                          base[0] | (K.FLAG_MATE_REVERSE if rev_of(h2) else 0),
                          mapq, 0, i)
            j2 = add_item(reads2[i], q[1], qn, h2, None,
                          base[1] | (K.FLAG_MATE_REVERSE if rev_of(h1) else 0),
                          mapq, 1, i)
            plan.append((branch, (j1, j2)))
            continue

        # discordant / singleton
        sel = [_se_hit_from(host["se1"], i, m1, L),
               _se_hit_from(host["se2"], i, m2, L)]
        js = []
        for mi, reads_m in ((0, reads1[i]), (1, reads2[i])):
            best, second = sel[mi]
            mate_best = sel[1 - mi][0]
            extra = K.FLAG_PAIRED | (K.FLAG_READ1 if mi == 0
                                     else K.FLAG_READ2)
            if mate_best is None:
                extra |= K.FLAG_MATE_UNMAPPED
            elif rev_of(mate_best):
                extra |= K.FLAG_MATE_REVERSE
            if best is not None:
                js.append(add_item(reads_m, q[mi], qn, best, second,
                                   extra, None, mi, i))
            else:
                js.append(("unmapped", extra, mi))
        plan.append(("disc", tuple(js)))

    # padded batch for the items without per-item row fills: gather rows
    # from the already-padded a1/a2 by (mate, pair) source
    n_it = len(it_reads)
    arr_it = np.empty((n_it, a1.shape[1]), dtype=np.uint8)
    len_it = np.empty(n_it, dtype=np.int64)
    if n_it:
        src = np.array(it_src, dtype=np.int64)
        for mate, (am, lm) in enumerate(((a1, l1), (a2, l2))):
            s = src[:, 0] == mate
            arr_it[s] = am[src[s, 1]]
            len_it[s] = np.asarray(lm)[src[s, 1]]

    recs_flat = None
    if native_finalize.available() and n_it:
        # native path wants device-output-shaped arrays; rebuild them from
        # the decided Hits (second=None encodes as INF)
        outs = {
            "best_score": np.array([h.score for h, _ in it_hits],
                                   dtype=np.int64),
            "best_bp": np.array([h.block * 2 + h.pat for h, _ in it_hits],
                                dtype=np.int64),
            "best_anchor": np.array([h.anchor for h, _ in it_hits],
                                    dtype=np.int64),
            "second_score": np.array(
                [s.score if s is not None else K.INF_SCORE
                 for _, s in it_hits], dtype=np.int64),
        }
        recs_flat = native_finalize.finalize_se_native(
            idx, rc_ref, cfg, arr_it, len_it, it_quals, it_qn, outs,
            flag_extras=it_flags, mapq_overrides=it_mapq)
    if recs_flat is None:
        recs_flat = finalize_batch(idx, rc_ref, cfg, it_reads, it_quals,
                                   it_qn, it_hits, flag_extras=it_flags,
                                   mapq_overrides=it_mapq,
                                   padded=(arr_it, len_it))

    # ---- phase 2: assemble per pair, falling back per-pair when needed ----
    out: list[SamRecord] = []
    for i, (branch, js) in enumerate(plan):
        q = quals[i] if quals else ("", "")
        qn = qnames[i] if qnames else f"p{i}"

        if branch in ("pair", "resc"):
            r1r, r2r = recs_flat[js[0]], recs_flat[js[1]]
            if r1r is not None and r2r is not None:
                _patch_pair_fields(r1r, r2r, proper=True)
                out.extend((r1r, r2r))
                continue
            # rare: finalize rejected -> full per-pair decision tree
            out.extend(_assemble_pair(idx, rc_ref, cfg,
                                      (reads1[i], reads2[i]), q, qn,
                                      host, i, L, e, opaired, K2))
            continue

        pair_recs = []
        for mi, j in enumerate(js):
            if isinstance(j, tuple):       # unmapped placeholder
                _, extra, _ = j
                rec = unmapped_record(qn, (reads1[i], reads2[i])[mi],
                                      q[mi], flag_extra=extra)
            else:
                rec = recs_flat[j]
                if rec is None:
                    rec = unmapped_record(
                        qn, (reads1[i], reads2[i])[mi], q[mi],
                        flag_extra=it_flags[j])
            pair_recs.append(rec)
        r1r, r2r = pair_recs
        if not (r1r.flag & K.FLAG_UNMAPPED) \
                and not (r2r.flag & K.FLAG_UNMAPPED):
            _patch_pair_fields(r1r, r2r, proper=False)
        out.extend(pair_recs)
    return out



def _decide_pair(host, i, m1, m2, L, skip_pair=False):
    """THE device-host PE branch decision for pair i (single copy; mirrors
    oracle/paired.map_pair's decision order, which stays the frozen spec).

    Returns ("pair"|"resc", h1, h2, mapq) for a proper/rescued pair, or
    ("disc", None, None, None) for the discordant/singleton fallback.
    `skip_pair` skips the proper-pair branch (used when its optimistic
    finalize was rejected and the caller retries from rescue)."""
    _INF = int(K.INF_SCORE)
    if not skip_pair and host["pair_valid"][i]:
        bp1, bp2 = int(host["pair_bp1"][i]), int(host["pair_bp2"][i])
        a1, a2 = int(host["pair_a1"][i]), int(host["pair_a2"][i])
        f1 = a1 if bp1 >> 1 == K.BLOCK_FWD else L - a1 - m1
        f2 = a2 if bp2 >> 1 == K.BLOCK_FWD else L - a2 - m2
        s1 = int(host["pair_s1"][i])
        ssum = int(host["pair_sum"][i])
        h1 = Hit(s1, f1, bp1 >> 1, bp1 & 1, a1)
        h2 = Hit(ssum - s1, f2, bp2 >> 1, bp2 & 1, a2)
        s2sum = int(host["pair_second_sum"][i])
        if s2sum < 2 * _INF and s2sum == ssum:
            mapq = 0
        else:
            mapq = K.mapq_from_gap(ssum, s2sum if s2sum < 2 * _INF else None)
        return ("pair", h1, h2, mapq)

    if host["resc_valid"][i]:
        anch_is_1 = bool(host["resc_anch_is_1"][i])
        se_a = host["se1"] if anch_is_1 else host["se2"]
        m_anch = m1 if anch_is_1 else m2
        m_miss = m2 if anch_is_1 else m1
        anchored, anch_second = _se_hit_from(se_a, i, m_anch, L)
        if anchored is not None:
            b = int(host["resc_block"][i])
            p = int(host["resc_pat"][i])
            fwd = int(host["resc_fwd"][i])
            a = fwd if b == K.BLOCK_FWD else L - fwd - m_miss
            rb = Hit(int(host["resc_score"][i]), fwd, b, p, a)
            rsecond = int(host["resc_second"][i])
            rsecond = rsecond if rsecond < _INF else None
            anch_amb = anch_second is not None and \
                anch_second.score == anchored.score
            anch_mapq = 0 if anch_amb else K.mapq_from_gap(
                anchored.score, anch_second.score if anch_second else None)
            resc_mapq = 0 if (rsecond is not None and rsecond == rb.score) \
                else K.mapq_from_gap(rb.score, rsecond)
            mapq = min(anch_mapq, resc_mapq)
            hh = (anchored, rb) if anch_is_1 else (rb, anchored)
            return ("resc", hh[0], hh[1], mapq)

    return ("disc", None, None, None)


def _se_hit_from(host_se, i, m, L):
    _INF = K.INF_SCORE
    if host_se["best_score"][i] >= int(_INF):
        return None, None
    bp = int(host_se["best_bp"][i])
    b, p = bp >> 1, bp & 1
    a = int(host_se["best_anchor"][i])
    fwd = a if b == K.BLOCK_FWD else L - a - m
    best = Hit(int(host_se["best_score"][i]), fwd, b, p, a)
    second = None
    if host_se["second_score"][i] < int(_INF):
        second = Hit(int(host_se["second_score"][i]), 0, 0, 0, 0)
    return best, second



def _assemble_pair(idx, rc_ref, cfg, reads, q, qn, host, i, L, e,
                   opaired, K2):
    m1, m2 = len(reads[0]), len(reads[1])

    branch, h1, h2, mapq = _decide_pair(host, i, m1, m2, L)
    if branch == "pair":
        recs = opaired._emit_pair(idx, rc_ref, cfg, reads, q, qn,
                                  h1, h2, mapq, mapq)
        if recs:
            return recs
        # proper-pair finalize rejected (contig-edge): retry from rescue
        branch, h1, h2, mapq = _decide_pair(host, i, m1, m2, L,
                                            skip_pair=True)
    if branch == "resc":
        recs = opaired._emit_pair(idx, rc_ref, cfg, reads, q, qn,
                                  h1, h2, mapq, mapq)
        if recs:
            return recs

    # discordant / singleton fallback
    sel = [_se_hit_from(host["se1"], i, m1, L),
           _se_hit_from(host["se2"], i, m2, L)]
    recs = []
    for mi in (0, 1):
        best, second = sel[mi]
        mate_best = sel[1 - mi][0]
        extra = K.FLAG_PAIRED | (K.FLAG_READ1 if mi == 0 else K.FLAG_READ2)
        if mate_best is None:
            extra |= K.FLAG_MATE_UNMAPPED
        elif K.IS_REVERSE[(mate_best.block, mate_best.pat)]:
            extra |= K.FLAG_MATE_REVERSE
        rec = None
        if best is not None:
            rec = finalize_hit(idx, rc_ref, cfg, reads[mi], q[mi], qn,
                               best, second, flag_extra=extra)
        if rec is None:
            rec = unmapped_record(qn, reads[mi], q[mi], flag_extra=extra)
        recs.append(rec)
    r1r, r2r = recs
    if not (r1r.flag & K.FLAG_UNMAPPED) and not (r2r.flag & K.FLAG_UNMAPPED):
        if r1r.rname == r2r.rname:
            r1r.rnext = r2r.rnext = "="
        else:
            r1r.rnext, r2r.rnext = r2r.rname, r1r.rname
        r1r.pnext, r2r.pnext = r2r.pos, r1r.pos
    return recs
