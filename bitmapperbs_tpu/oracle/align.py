"""Alignment semantics oracle: asymmetric matching, Hamming, semi-global edit
distance with traceback -> CIGAR/MD/NM (SURVEY.md C11-C13).

Everything here is plain numpy / Python on ORIGINAL-space codes *in the
alignment frame* (the frame where the pattern matched forward; block 1 uses
rc(W) codes).  The asymmetric bisulfite rule in-frame is always:

    match(ref, read) = (ref == read) or (ref == C and read == T)
    N (code 4) on either side never matches.

The device kernels (ops/hamming.py, ops/myers.py) must reproduce these
numbers exactly; tests compare against this module.

Frozen spec decisions (SURVEY.md section 7 "freeze in Phase 0"):
- Verification is semi-global: the read aligns end-to-end, the reference
  window [anchor-e, anchor+m+e) is local (free start/end columns).
- Candidate score = d_ham if d_ham <= e else d_edit (SURVEY.md call stack 3.4
  "accept-as-is" fast path; d_edit <= d_ham always, so this only ever
  over-reports by a bounded amount, identically in oracle and device).
- Traceback tie-break: prefer diagonal, then ref-gap (D), then read-gap (I).
- End column: the smallest j achieving the minimal last-row score.
- NM/MD are computed under the asymmetric rule (bisulfite conversions are
  matches, not edits); methylation calls go to the XM-style tag instead.
"""
from __future__ import annotations

import numpy as np

from bitmapperbs_tpu import constants as K


def asym_match(ref: np.ndarray, read: np.ndarray, ga: bool = False) -> np.ndarray:
    """Elementwise bisulfite-asymmetric match.

    In the alignment frame the rule is always CT (`ga=False`).  When
    re-deriving MD/NM in forward-genome orientation for a reverse-frame hit
    (XG == "GA"), both sides are complemented and the rule flips to
    ref G =~ read A (`ga=True`).
    """
    ref = np.asarray(ref)
    read = np.asarray(read)
    eq = ref == read
    if ga:
        bs = (ref == K.G) & (read == K.A)
    else:
        bs = (ref == K.C) & (read == K.T)
    valid = (ref != K.N_CODE) & (read != K.N_CODE)
    return (eq | bs) & valid


def hamming(ref: np.ndarray, read: np.ndarray) -> int:
    """Asymmetric mismatch count over equal-length in-frame sequences."""
    return int((~asym_match(ref, read)).sum())


def edit_matrix(window: np.ndarray, read: np.ndarray) -> np.ndarray:
    """Full semi-global DP matrix D[i, j]: read[0:i] vs window ending at j.

    D[0, j] = 0 (free start anywhere in window); D[i, 0] = i.

    Row-vectorized with the exact prefix-min identity: with
    t[j] = min(D[i-1, j-1] + sub, D[i-1, j] + 1) and t[0] = D[i, 0] = i,
    unrolling the left-neighbor dependency gives
    D[i, j] = min_{k <= j} (t[k] + (j - k)), i.e. a running minimum of
    t[k] - k -- bit-identical to the naive three-way recurrence (pinned by
    tests/test_oracle_pipeline.py::test_edit_matrix_matches_naive), ~100x
    faster, which is what makes >=500-read oracle differentials at 3 Gbp
    tractable."""
    m, w = len(read), len(window)
    match = asym_match(window[None, :], read[:, None])  # [m, w]
    D = np.zeros((m + 1, w + 1), dtype=np.int32)
    D[:, 0] = np.arange(m + 1)
    jr = np.arange(w + 1, dtype=np.int32)
    t = np.empty(w + 1, dtype=np.int32)
    for i in range(1, m + 1):
        prev = D[i - 1]
        t[0] = i
        np.minimum(prev[:-1] + (match[i - 1] == 0), prev[1:] + 1,
                   out=t[1:], dtype=np.int32, casting="unsafe")
        np.minimum.accumulate(t - jr, out=t)
        D[i] = t + jr
    return D


def edit_distance(window: np.ndarray, read: np.ndarray) -> int:
    """min over end columns of the semi-global DP (the Myers kernel's value)."""
    return int(edit_matrix(window, read)[len(read)].min())


def traceback(window: np.ndarray, read: np.ndarray, D=None):
    """Optimal semi-global alignment -> (dist, ref_start, cigar_ops).

    cigar_ops: list of (op, length), op in "MID", read-global, in frame
    coordinates.  ref interval is [ref_start, ref_start + ref_span) within
    `window`.  Deterministic tie-break: diag > D (ref gap) > I (read gap);
    end column = smallest j with minimal D[m, j].
    D: optional precomputed edit_matrix(window, read) (the batched
    finalizer computes DPs for many reads at once -- models/finalize.py).
    """
    m = len(read)
    if D is None:
        D = edit_matrix(window, read)
    j = int(np.argmin(D[m]))  # smallest index of the min
    i = m
    ops: list[str] = []
    match = asym_match(window[None, :], read[:, None]) if m and len(window) else None
    while i > 0:
        if j > 0 and D[i, j] == D[i - 1, j - 1] + (0 if match[i - 1, j - 1] else 1):
            ops.append("M")
            i -= 1
            j -= 1
        elif j > 0 and D[i, j] == D[i, j - 1] + 1:
            ops.append("D")
            j -= 1
        else:
            ops.append("I")
            i -= 1
    ops.reverse()
    # drop leading/trailing pure-D runs (they only shift the ref interval)
    start_trim = 0
    while start_trim < len(ops) and ops[start_trim] == "D":
        start_trim += 1
    end_trim = len(ops)
    while end_trim > start_trim and ops[end_trim - 1] == "D":
        end_trim -= 1
    ref_start = j + start_trim
    ops = ops[start_trim:end_trim]
    cigar = []
    for op in ops:
        if cigar and cigar[-1][0] == op:
            cigar[-1][1] += 1
        else:
            cigar.append([op, 1])
    dist = int(D[m].min())
    return dist, ref_start, [(op, ln) for op, ln in cigar]


def meth_context(genome: np.ndarray, q: int, ga: bool) -> str:
    """Bismark-style cytosine context letter (lowercase) at fwd position q.

    ga=False: ref C on the top strand; context from genome[q+1], genome[q+2].
    ga=True:  ref G = cytosine on the bottom strand; context from the
    complemented upstream bases genome[q-1], genome[q-2].
    Returns 'z' (CpG), 'x' (CHG), 'h' (CHH) or 'u' (unknown / N context).
    """
    L = len(genome)

    def base(p):
        return int(genome[p]) if 0 <= p < L else K.N_CODE

    if not ga:
        b1, b2 = base(q + 1), base(q + 2)
        g, n = K.G, K.N_CODE
    else:
        # on the Crick strand, "next" is q-1, q-2 complemented: G <-> C
        b1, b2 = base(q - 1), base(q - 2)
        g, n = K.C, K.N_CODE
    if b1 == g:
        return "z"
    if b1 == n:
        return "u"
    if b2 == g:
        return "x"
    if b2 == n:
        return "u"
    return "h"


def cigar_md_nm(window: np.ndarray, read: np.ndarray, ref_start: int,
                cigar: list[tuple[str, int]], ga: bool = False,
                genome: np.ndarray | None = None, gpos: int = 0):
    """MD / NM / methylation string from an alignment.

    NM counts asymmetric-rule edits (conversions excluded); MD likewise.
    XM is a Bismark-style methylation string aligned with SEQ: upper case =
    methylated, lower = converted; Z/z CpG, X/x CHG, H/h CHH, U/u unknown.
    Context needs bases beyond the alignment window: pass the full `genome`
    plus the window's absolute fwd position `gpos`; without it the context
    letter falls back to 'z'/'Z' (context-free).
    With ga=True the cytosine appears as ref G / read G-or-A (fwd-orientation
    view of a reverse-frame hit).
    """
    nm = 0
    md_parts: list[str] = []
    md_run = 0
    xm: list[str] = []
    ref_c, read_meth = (K.G, K.G) if ga else (K.C, K.C)
    i, j = 0, ref_start
    for op, ln in cigar:
        if op == "M":
            # vectorized per run (the per-character version dominated the
            # host finalize profile)
            r = np.asarray(window[j:j + ln])
            d = np.asarray(read[i:i + ln])
            match = asym_match(r, d, ga=ga)
            is_c = match & (r == ref_c)
            if genome is not None and is_c.any():
                q = gpos + j + np.flatnonzero(is_c)
                Lg = len(genome)
                if ga:
                    b1 = np.where((q - 1 >= 0) & (q - 1 < Lg),
                                  genome[np.clip(q - 1, 0, Lg - 1)], K.N_CODE)
                    b2 = np.where((q - 2 >= 0) & (q - 2 < Lg),
                                  genome[np.clip(q - 2, 0, Lg - 1)], K.N_CODE)
                    gsym = K.C
                else:
                    b1 = np.where(q + 1 < Lg, genome[np.clip(q + 1, 0, Lg - 1)],
                                  K.N_CODE)
                    b2 = np.where(q + 2 < Lg, genome[np.clip(q + 2, 0, Lg - 1)],
                                  K.N_CODE)
                    gsym = K.G
                ctx = np.where(
                    b1 == gsym, ord("z"),
                    np.where(b1 == K.N_CODE, ord("u"),
                             np.where(b2 == gsym, ord("x"),
                                      np.where(b2 == K.N_CODE, ord("u"),
                                               ord("h"))))).astype(np.uint8)
            else:
                ctx = np.full(int(is_c.sum()), ord("z"), dtype=np.uint8)
            meth = d[is_c] == read_meth
            xm_run = np.full(ln, ord("."), dtype=np.uint8)
            xm_run[is_c] = np.where(meth, ctx - 32, ctx)
            xm.append(xm_run.tobytes().decode())
            mm = np.flatnonzero(~match)
            nm += len(mm)
            prev = 0
            for q in mm:
                md_parts.append(str(md_run + int(q) - prev))
                md_parts.append("ACGTN"[int(r[q])])
                md_run = 0
                prev = int(q) + 1
            md_run += ln - prev
            i += ln
            j += ln
        elif op == "I":
            nm += ln
            xm.append("." * ln)
            i += ln
        else:  # D
            nm += ln
            md_parts.append(str(md_run))
            md_run = 0
            md_parts.append("^" + "".join(
                "ACGTN"[int(window[j + t])] for t in range(ln)))
            j += ln
    md_parts.append(str(md_run))
    return "".join(md_parts), nm, "".join(xm)


def cigar_string(cigar: list[tuple[str, int]]) -> str:
    return "".join(f"{ln}{op}" for op, ln in cigar)


def cigar_ref_span(cigar: list[tuple[str, int]]) -> int:
    return sum(ln for op, ln in cigar if op in "MD")
