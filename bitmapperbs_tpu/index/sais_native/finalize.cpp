// Native single-end finalize: device outputs -> SAM record fields.
//
// Reference parity: BitMapperBS's traceback/output stage is native C
// (SURVEY.md C13/C18); this is this package's equivalent for the host
// side of the pipeline.  Semantics are a line-for-line translation of the
// frozen numpy implementation in models/finalize.py (which itself is
// byte-identical to the per-read oracle finalize_hit) -- the numpy path
// stays the spec, and tests/test_native_finalize.py asserts field-for-field
// equality on randomized batches.  The win is constant-factor: the numpy
// path costs ~33 us/read in interpreter/numpy-call overhead; this pass runs
// the same math in ~1-2 us/read, so a single host core can keep up with the
// device rate (PERF.md round-3 ladder).
//
// Conventions (constants.py): A=0 C=1 G=2 T=3 N=4; complement(x)=3-x (N->N
// handled explicitly); block 0 = CT(W) forward, block 1 = CT(rc W); pattern
// 0 = CT(read), 1 = CT(revcomp read); IS_REVERSE = block XOR pattern... NO:
// (0,0)F (1,0)T (0,1)T (1,1)F = block != pattern.  Frame-space asymmetric
// match is always (w==r || (w==C && r==T)) with N matching nothing.
//
// Build: part of libsais.so (make -C bitmapperbs_tpu/index/sais_native).
// Self-test: make check-asan (randomized invariants under ASan+UBSan).

#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>

namespace {

constexpr int A = 0, C = 1, G = 2, T = 3, NCODE = 4;
constexpr int64_t INF_SCORE = 1 << 20;
constexpr int INF16 = 1 << 13;

inline bool is_rev(int blk, int pat) { return blk != pat; }

inline bool asym_ct(uint8_t w, uint8_t r) {
    // frame-space rule: ref C matches read T; N matches nothing
    return (w != NCODE) && (r != NCODE) && (w == r || (w == C && r == T));
}

inline uint8_t gcode(const uint8_t* g, int64_t L, int64_t p) {
    return (p >= 0 && p < L) ? g[p] : (uint8_t)NCODE;
}

inline uint8_t fetch(const uint8_t* g, int64_t L, int64_t p, bool rc) {
    // rc: read the reverse complement rc(W)[p] = comp(W[L-1-p]) without a
    // materialized 3 GB rc array (N complements to N)
    if (p < 0 || p >= L) return (uint8_t)NCODE;
    if (!rc) return g[p];
    uint8_t c = g[L - 1 - p];
    return c == NCODE ? (uint8_t)NCODE : (uint8_t)(3 - c);
}

struct StrArena {
    char* buf;
    int64_t cap;
    int64_t used;
    bool overflow;
    int64_t put(const char* s, int64_t len) {
        if (used + len > cap) { overflow = true; return used; }
        std::memcpy(buf + used, s, (size_t)len);
        int64_t off = used;
        used += len;
        return off;
    }
};

inline int fmt_int(char* dst, int64_t v) {
    // v >= 0 always here
    char tmp[24];
    int k = 0;
    if (v == 0) tmp[k++] = '0';
    while (v > 0) { tmp[k++] = (char)('0' + v % 10); v /= 10; }
    for (int i = 0; i < k; i++) dst[i] = tmp[k - 1 - i];
    return k;
}

const char BASES[6] = "ACGTN";

} // namespace

extern "C" {

// Returns 0 ok, 1 string arena overflow (caller re-runs with a bigger one).
// out_kind: 0 = no record (unmapped / rejected / suppressed-ambiguous),
//           1 = record (fields + strings filled),
//           2 = degenerate alignment -> python finalize_hit fallback
//               (out_pos carries the frame-space degen ref start).
// str_off[8*i .. 8*i+7] = (off, len) pairs for cigar, md, xm, seq.
int btbs_finalize_se(
    const uint8_t* arr, int64_t bucket, const int64_t* lengths, int64_t n,
    const int64_t* best_score, const int64_t* best_bp,
    const int64_t* best_anchor, const int64_t* second_score,
    const uint8_t* genome, int64_t L,
    const int64_t* offsets, const int64_t* clens, int64_t n_contigs,
    int32_t e, int32_t indels, int32_t report_ambiguous,
    const int32_t* mq_tab /* gap 0..3 -> mapq, [4] = no-second/cap */,
    const int32_t* flag_extra /* nullable: OR'd into FLAG */,
    const int32_t* mq_over /* nullable: >=0 replaces MAPQ */,
    int32_t* out_kind, int32_t* out_flag, int32_t* out_ci, int64_t* out_pos,
    int32_t* out_mapq, int32_t* out_nm, int32_t* out_rev, int32_t* out_tag,
    char* sbuf, int64_t sbuf_cap, int64_t* sbuf_used, int64_t* str_off)
{
    StrArena ar{sbuf, sbuf_cap, 0, false};
    const int B = 7 * e + 1;            // band, d = didx - e

    std::vector<uint8_t> fr, fwd_read, win, ops, chron;
    std::vector<int> D, sub;            // DP rows (m+1) x B; sub over window
    std::vector<char> tmp;

    for (int64_t i = 0; i < n; i++) {
        out_kind[i] = 0;
        if (best_score[i] >= INF_SCORE) continue;
        const int64_t m = lengths[i];
        const int blk = (int)(best_bp[i] >> 1), pat = (int)(best_bp[i] & 1);
        const int64_t a = best_anchor[i];
        const int64_t score = best_score[i];
        const int64_t sec = second_score[i] < INF_SCORE ? second_score[i]
                                                        : -1;
        const bool ambiguous = sec >= 0 && sec == score;
        int mapq;
        if (ambiguous) {
            if (!report_ambiguous) continue;       // suppressed -> unmapped
            mapq = 0;
        } else if (sec < 0) {
            mapq = mq_tab[4];
        } else {
            int64_t gap = sec - score;
            if (gap < 0) gap = 0;
            if (gap > 4) gap = 4;
            mapq = mq_tab[gap];
        }
        const uint8_t* read = arr + i * bucket;
        const bool rev = is_rev(blk, pat);
        const bool ga = blk == 1;      // frame ref = rc(W) for block 1

        // frame-space read (pattern 1 = revcomp) + Hamming at the anchor
        fr.resize((size_t)m);
        if (pat == 0) {
            std::memcpy(fr.data(), read, (size_t)m);
        } else {
            for (int64_t j = 0; j < m; j++) {
                uint8_t c = read[m - 1 - j];
                fr[(size_t)j] = c == NCODE ? (uint8_t)NCODE
                                           : (uint8_t)(3 - c);
            }
        }
        int64_t ham = 0;
        for (int64_t j = 0; j < m; j++)
            ham += !asym_ct(fetch(genome, L, a + j, ga), fr[(size_t)j]);

        int64_t frame_pos = a, ref_span = m;
        bool fast = !indels || ham == score;

        // trimmed, fwd-orientation ops; empty in the fast path (pure M)
        ops.clear();
        if (!fast) {
            // banded DP in diagonal coords (see models/finalize.py for the
            // faithfulness proof of the d in [-e, 6e] band)
            const int64_t w = m + 2 * e;
            win.resize((size_t)w);
            for (int64_t j = 0; j < w; j++)
                win[(size_t)j] = fetch(genome, L, a - e + j, ga);
            D.assign((size_t)((m + 1) * B), INF16);
            for (int d = e; d < B; d++) D[(size_t)d] = 0;
            for (int64_t r = 1; r <= m; r++) {
                const int* prev = D.data() + (r - 1) * B;
                int* cur = D.data() + r * B;
                int left = INF16;
                for (int d = 0; d < B; d++) {
                    const int64_t j = r + d - e;   // 1-based window column
                    int s = 1;
                    if (j >= 1 && j <= w)
                        s = !asym_ct(win[(size_t)(j - 1)],
                                     fr[(size_t)(r - 1)]);
                    int v = prev[d] + s;
                    int up = (d + 1 < B ? prev[d + 1] : INF16) + 1;
                    if (up < v) v = up;
                    if (left + 1 < v) v = left + 1;
                    cur[d] = v;
                    left = v;
                }
            }
            // end column: smallest valid j achieving the row minimum
            const int* last = D.data() + m * B;
            int didx0 = -1, bestv = INF16 + 1;
            for (int d = 0; d < B; d++) {
                const int64_t j = m + d - e;
                if (j < 0 || j > w) continue;
                if (last[d] < bestv) { bestv = last[d]; didx0 = d; }
            }
            // walk-order backtrace (priority M > D > I, j>0/didx>0 guards)
            chron.clear();
            int64_t icur = m, jcur = m + didx0 - e;
            while (icur > 0) {
                int d = (int)(jcur - icur + e);
                if (d < 0) d = 0;
                if (d >= B) d = B - 1;
                const int here = D[(size_t)(icur * B + d)];
                int s = 1;
                if (jcur >= 1 && jcur <= w)
                    s = !asym_ct(win[(size_t)(jcur - 1)],
                                 fr[(size_t)(icur - 1)]);
                uint8_t op;
                if (jcur > 0 && here == D[(size_t)((icur - 1) * B + d)] + s)
                    op = 1;                         // M
                else if (jcur > 0 && d > 0
                         && here == D[(size_t)(icur * B + d - 1)] + 1)
                    op = 2;                         // D (ref gap)
                else
                    op = 3;                         // I (read gap)
                chron.push_back(op);
                if (op != 2) icur--;
                if (op != 3) jcur--;
            }
            std::reverse(chron.begin(), chron.end()); // chronological
            // trim leading/trailing D
            int64_t first = -1, last_k = -1;
            for (int64_t k = 0; k < (int64_t)chron.size(); k++)
                if (chron[(size_t)k] != 2) { if (first < 0) first = k;
                                             last_k = k; }
            if (first < 0) {                         // degenerate: spec
                out_kind[i] = 2;
                out_pos[i] = jcur + (int64_t)chron.size();
                continue;
            }
            ops.assign(chron.begin() + first, chron.begin() + last_k + 1);
            if (rev) std::reverse(ops.begin(), ops.end());
            frame_pos = a - e + jcur + first;
            ref_span = 0;
            for (uint8_t op : ops) if (op != 3) ref_span++;
        }

        const int64_t fwd_pos = blk == 0 ? frame_pos
                                         : L - frame_pos - ref_span;
        // contig: searchsorted(offsets, fwd_pos, 'right') - 1
        int64_t ci = (std::upper_bound(offsets, offsets + n_contigs,
                                       fwd_pos) - offsets) - 1;
        if (ci < 0) continue;
        const int64_t coord = fwd_pos - offsets[ci];
        if (coord < 0 || coord + ref_span > clens[ci]) continue;

        // output-space read (reverse-complemented when the hit is reverse)
        fwd_read.resize((size_t)m);
        if (!rev) {
            std::memcpy(fwd_read.data(), read, (size_t)m);
        } else {
            for (int64_t j = 0; j < m; j++) {
                uint8_t c = read[m - 1 - j];
                fwd_read[(size_t)j] = c == NCODE ? (uint8_t)NCODE
                                                 : (uint8_t)(3 - c);
            }
        }
        const uint8_t ref_c = ga ? (uint8_t)G : (uint8_t)C;
        const uint8_t gsym = ga ? (uint8_t)C : (uint8_t)G;
        const int64_t dq = ga ? -1 : 1;

        tmp.resize((size_t)(10 * m + 64 + 16 * (int64_t)ops.size()));
        char* cig = tmp.data();
        int cig_len = 0;
        char* md = tmp.data() + 2 * m + 16 + 8 * (int64_t)ops.size();
        int md_len = 0;
        char* xm = md + 4 * m + 32 + 4 * (int64_t)ops.size();
        char* sq = xm + m;
        for (int64_t j = 0; j < m; j++) {
            xm[j] = '.';
            sq[j] = BASES[fwd_read[(size_t)j]];
        }
        int nm = 0;

        auto xm_at = [&](int64_t rpos, int64_t q, uint8_t rq, uint8_t rd) {
            // Bismark context at a matched ref-C (frame-adjusted) column
            if (rq != ref_c) return;
            const uint8_t b1 = gcode(genome, L, q + dq);
            const uint8_t b2 = gcode(genome, L, q + 2 * dq);
            char c;
            if (b1 == gsym) c = 'z';
            else if (b1 == NCODE) c = 'u';
            else if (b2 == gsym) c = 'x';
            else if (b2 == NCODE) c = 'u';
            else c = 'h';
            if (rd == ref_c) c = (char)(c - 32);   // unconverted = methylated
            xm[rpos] = c;
        };

        if (ops.empty()) {
            // fast path: ungapped M-run
            cig_len = fmt_int(cig, m);
            cig[cig_len++] = 'M';
            int64_t prev = 0;
            for (int64_t j = 0; j < m; j++) {
                const uint8_t rq = gcode(genome, L, fwd_pos + j);
                const uint8_t rd = fwd_read[(size_t)j];
                const bool bs = ga ? (rq == G && rd == A)
                                   : (rq == C && rd == T);
                const bool match = (rq != NCODE) && (rd != NCODE)
                                   && (rq == rd || bs);
                if (!match) {
                    nm++;
                    md_len += fmt_int(md + md_len, j - prev);
                    md[md_len++] = BASES[rq];
                    prev = j + 1;
                } else {
                    xm_at(j, fwd_pos + j, rq, rd);
                }
            }
            md_len += fmt_int(md + md_len, m - prev);
        } else {
            // slow path: aligned-column grid (mirrors oracle cigar_md_nm)
            int64_t readpos = 0, refoff = 0, cummatch = 0, prevm = 0;
            int64_t run_n = 0;
            uint8_t run_op = 0;
            int64_t del_run = 0;            // open ^-run in MD
            for (size_t k = 0; k < ops.size(); k++) {
                const uint8_t op = ops[k];
                if (op == run_op) run_n++;
                else {
                    if (run_n) {
                        cig_len += fmt_int(cig + cig_len, run_n);
                        cig[cig_len++] = "\0MDI"[run_op];
                    }
                    run_op = op; run_n = 1;
                }
                const int64_t q = fwd_pos + refoff;
                const uint8_t rq = op != 3 ? gcode(genome, L, q)
                                           : (uint8_t)NCODE;
                const uint8_t rd = op != 2 ? fwd_read[(size_t)readpos]
                                           : (uint8_t)NCODE;
                if (op == 1) {
                    const bool bs = ga ? (rq == G && rd == A)
                                       : (rq == C && rd == T);
                    const bool match = (rq != NCODE) && (rd != NCODE)
                                       && (rq == rd || bs);
                    if (match) {
                        xm_at(readpos, q, rq, rd);
                        cummatch++;
                        del_run = 0;
                    } else {
                        nm++;
                        md_len += fmt_int(md + md_len, cummatch - prevm);
                        prevm = cummatch;
                        md[md_len++] = BASES[rq];
                        del_run = 0;
                    }
                } else if (op == 2) {
                    nm++;
                    if (del_run == 0) {
                        md_len += fmt_int(md + md_len, cummatch - prevm);
                        prevm = cummatch;
                        md[md_len++] = '^';
                    }
                    md[md_len++] = BASES[rq];
                    del_run++;
                } else {
                    nm++;
                    del_run = 0;
                }
                if (op != 2) readpos++;
                if (op != 3) refoff++;
            }
            if (run_n) {
                cig_len += fmt_int(cig + cig_len, run_n);
                cig[cig_len++] = "\0MDI"[run_op];
            }
            md_len += fmt_int(md + md_len, cummatch - prevm);
        }

        if (mq_over && mq_over[i] >= 0) mapq = mq_over[i];
        out_kind[i] = 1;
        out_flag[i] = (rev ? 0x10 : 0) | (flag_extra ? flag_extra[i] : 0);
        out_ci[i] = (int32_t)ci;
        out_pos[i] = coord + 1;
        out_mapq[i] = mapq;
        out_nm[i] = nm;
        out_rev[i] = rev;
        out_tag[i] = blk * 2 + pat;
        str_off[8 * i + 0] = ar.put(cig, cig_len);
        str_off[8 * i + 1] = cig_len;
        str_off[8 * i + 2] = ar.put(md, md_len);
        str_off[8 * i + 3] = md_len;
        str_off[8 * i + 4] = ar.put(xm, m);
        str_off[8 * i + 5] = m;
        str_off[8 * i + 6] = ar.put(sq, m);
        str_off[8 * i + 7] = m;
        if (ar.overflow) { *sbuf_used = ar.used; return 1; }
    }
    *sbuf_used = ar.used;
    return 0;
}

} // extern "C"

#ifdef FINALIZE_SELFTEST
// Randomized invariants under ASan/UBSan: bounds, well-formed strings,
// CIGAR/MD consistency (read length and ref span add up), NM >= |score
// difference| sanity.  Byte-parity vs the numpy spec lives in pytest.
#include <cstdio>
#include <cstdlib>

static uint64_t rs = 0x9E3779B97F4A7C15ull;
static uint64_t rnd() {
    rs ^= rs << 13; rs ^= rs >> 7; rs ^= rs << 17; return rs;
}

int main() {
    const int64_t L = 20000;
    std::vector<uint8_t> g(L), rc(L);
    for (int64_t i = 0; i < L; i++) g[(size_t)i] = (uint8_t)(rnd() % 4);
    for (int64_t i = 0; i < L; i++) rc[(size_t)i] = 3 - g[(size_t)(L-1-i)];
    int64_t offs[2] = {0, 12000};
    int64_t cls[2] = {11800, 7900};
    int32_t mq[5] = {0, 20, 30, 40, 42};
    const int64_t n = 512, bucket = 64;
    const int e = 3;
    std::vector<uint8_t> arr((size_t)(n * bucket), 4);
    std::vector<int64_t> len(n), bs(n), bp(n), ba(n), ss(n);
    for (int64_t i = 0; i < n; i++) {
        int64_t m = 40 + (int64_t)(rnd() % 25);
        len[(size_t)i] = m;
        int blk = (int)(rnd() & 1), pat = (int)(rnd() & 1);
        int64_t a = (int64_t)(rnd() % (uint64_t)(L - m - 8));
        const uint8_t* ref = blk == 0 ? g.data() : rc.data();
        // plant a read whose frame pattern matches at a with <= e edits
        std::vector<uint8_t> fr((size_t)m);
        for (int64_t j = 0; j < m; j++) {
            uint8_t w = ref[(size_t)(a + j)];
            fr[(size_t)j] = (w == 1 && (rnd() & 1)) ? 3 : w;  // C->T half
        }
        int edits = (int)(rnd() % (uint64_t)(e + 1));
        for (int k = 0; k < edits; k++)
            fr[(size_t)(rnd() % (uint64_t)m)] = (uint8_t)(rnd() % 4);
        // store in read orientation (pattern 1 = revcomp of frame)
        for (int64_t j = 0; j < m; j++) {
            uint8_t c = pat == 0 ? fr[(size_t)j]
                                 : (uint8_t)(3 - fr[(size_t)(m - 1 - j)]);
            arr[(size_t)(i * bucket + (pat == 0 ? j : j))] = c;
        }
        // recompute the true Hamming in frame space as the "score"
        int64_t ham = 0;
        for (int64_t j = 0; j < m; j++) {
            uint8_t w = ref[(size_t)(a + j)], r = fr[(size_t)j];
            ham += !((w != 4) && (r != 4) && (w == r || (w == 1 && r == 3)));
        }
        bs[(size_t)i] = ham <= e + 1 ? ham : ham;  // any score; DP may gap
        bp[(size_t)i] = blk * 2 + pat;
        ba[(size_t)i] = a;
        ss[(size_t)i] = (rnd() & 3) == 0 ? bs[(size_t)i] : INF_SCORE;
    }
    std::vector<int32_t> kind(n), flag(n), ci(n), mapq(n), nm(n), rev(n),
        tag(n);
    std::vector<int64_t> pos(n), soff((size_t)(8 * n));
    std::vector<char> sb((size_t)(n * (10 * bucket + 64)));
    int64_t used = 0;
    int rcde = btbs_finalize_se(
        arr.data(), bucket, len.data(), n, bs.data(), bp.data(), ba.data(),
        ss.data(), g.data(), L, offs, cls, 2, e, 1, 1, mq,
        nullptr, nullptr,
        kind.data(), flag.data(), ci.data(), pos.data(), mapq.data(),
        nm.data(), rev.data(), tag.data(), sb.data(),
        (int64_t)sb.size(), &used, soff.data());
    if (rcde != 0) { std::printf("arena overflow\n"); return 1; }
    int recs = 0;
    for (int64_t i = 0; i < n; i++) {
        if (kind[(size_t)i] != 1) continue;
        recs++;
        // CIGAR read-length/ref-span consistency
        const char* cg = sb.data() + soff[(size_t)(8 * i)];
        int64_t cl = soff[(size_t)(8 * i + 1)];
        int64_t rl = 0, span = 0, v = 0;
        for (int64_t k = 0; k < cl; k++) {
            char c = cg[k];
            if (c >= '0' && c <= '9') { v = v * 10 + (c - '0'); continue; }
            if (c == 'M') { rl += v; span += v; }
            else if (c == 'I') rl += v;
            else if (c == 'D') span += v;
            else { std::printf("bad cigar op %c\n", c); return 1; }
            v = 0;
        }
        if (rl != len[(size_t)i]) {
            std::printf("cigar read length %lld != %lld\n",
                        (long long)rl, (long long)len[(size_t)i]);
            return 1;
        }
        if (pos[(size_t)i] < 1
            || pos[(size_t)i] - 1 + span > cls[ci[(size_t)i]]) {
            std::printf("record leaves contig\n"); return 1;
        }
    }
    std::printf("finalize selftest OK (%d records, %lld arena bytes)\n",
                recs, (long long)used);
    return 0;
}
#endif
