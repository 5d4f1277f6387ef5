"""Core encodings and frozen semantic constants.

This module freezes the alphabet / strand / conversion conventions for the whole
framework.  Everything else (oracle, device kernels, SAM writer) derives from
these definitions, so they must never change silently.

Reference parity: BitMapperBS (chhylp123/BitMapperBS) indexes only the
C->T-converted genome (forward and reverse-complement strands) and treats a
G->A-space search as a C->T-space search of the reverse-complemented pattern
(SURVEY.md section 0 item 2; the reference tree was unavailable, so citations are
to the survey spec rather than file:line).

Base encoding (original, 4-letter space)
----------------------------------------
    A=0, C=1, G=2, T=3          (2-bit; complement(x) = 3 - x)
    N is carried as a separate mask plane, never as a code.

Converted (3-letter FM) space
-----------------------------
    SENTINEL=0, A=1, G=2, T=3   (C never occurs after C->T conversion)
    Genome N bases are mapped to A in the converted text (arbitrary but frozen;
    verification against the *original* genome treats N as mismatching
    everything, so this only risks spurious seeds, never wrong output).

Blocks
------
The index holds two "blocks" per genome:
    block 0: CT(W)        -- C->T conversion of the forward genome
    block 1: CT(rc(W))    -- C->T conversion of the reverse complement
Positions inside a block are uint32 (a human strand, ~3.1e9 bp, exceeds int32
but fits uint32).  A block-1 hit at block offset `q` spanning `s` reference
bases corresponds to forward-genome interval [L - q - s, L - q).

Patterns
--------
    pattern 0: CT(read)             -- directional libraries
    pattern 1: CT(revcomp(read))    -- added for non-directional / PBAT
Bismark-convention conversion tags follow from (block, pattern):
    (block 0, pat 0) -> XR=CT XG=CT  (OT),   FLAG fwd
    (block 1, pat 0) -> XR=CT XG=GA  (OB),   FLAG reverse
    (block 0, pat 1) -> XR=GA XG=CT  (CTOT), FLAG reverse
    (block 1, pat 1) -> XR=GA XG=GA  (CTOB), FLAG fwd
"""

# ---- original 4-letter space ------------------------------------------------
A, C, G, T = 0, 1, 2, 3
BASE_CHARS = "ACGT"
N_CODE = 4  # host-side only; device carries an N mask plane instead

# ---- converted 3-letter FM space -------------------------------------------
SENTINEL = 0
CONV_A, CONV_G, CONV_T = 1, 2, 3
CONV_ALPHA = 4  # sentinel + 3 letters
CONV_CHARS = "$AGT"

# original code -> converted code (C->T collapse, N(4)->A)
#            A        C       G       T       N
CONV_MAP = (CONV_A, CONV_T, CONV_G, CONV_T, CONV_A)

# ---- blocks / patterns / strand bookkeeping --------------------------------
BLOCK_FWD = 0  # CT(W)
BLOCK_RC = 1   # CT(rc(W))
PAT_CT = 0     # CT(read)
PAT_GA = 1     # CT(revcomp(read))  == a G->A-space search of the read

# (block, pattern) -> SAM reverse-strand flag bit set?
IS_REVERSE = {(0, 0): False, (1, 0): True, (0, 1): True, (1, 1): False}
# (block, pattern) -> (XR, XG) Bismark-style conversion tags
CONV_TAGS = {(0, 0): ("CT", "CT"), (1, 0): ("CT", "GA"),
             (0, 1): ("GA", "CT"), (1, 1): ("GA", "GA")}

# ---- FM-index physical layout ----------------------------------------------
# Checkpointed bit-plane BWT with SA-sample mark bits folded into the SAME
# row, so one row gather per LF step fetches everything the step needs.
#   row = [cnt_sentinel, cnt_A, cnt_G, cnt_T,   0..3   cumulative occ
#          p0w0..p0w3,                          4..7   BWT bit-plane 0
#          p1w0..p1w3,                          8..11  BWT bit-plane 1
#          mark_cnt,                            12     cumulative SA marks
#          mw0..mw3]                            13..16 SA-sample mark bits
# 17 uint32 per 128 positions (LSB = lowest position within each word).
CP_BLOCK = 128
CP_WORDS = CP_BLOCK // 32          # 4 words per plane per row
CP_MARK_OFF = CONV_ALPHA + 2 * CP_WORDS          # 12
CP_ROW_U32 = CP_MARK_OFF + 1 + CP_WORDS          # 17

# SA sampling (text-order): SA rows i with SA[i] % sa_rate == 0 are marked;
# an LF walk reaches a mark in < sa_rate steps (bounded unroll).  The rate is
# a per-index build parameter (stored in the artifact): it trades sample
# memory (4n/rate bytes/block) against LF-walk gather count (SURVEY.md
# hard-part 1).  DEFAULT_SA_RATE 8 is the cap for the largest genomes
# (GRCh38 two-block samples at rate 8 ~= 3.1 GB); index/build.py picks 4
# below 3.5 Gbp.
DEFAULT_SA_RATE = 8

# k-mer lookup table (KLT): the first KLT k backward-search steps of every
# seed start from the full interval [0, n), so their (sp, ep) depends only on
# the seed's last k converted characters.  A dense base-3 table over the
# 3-letter converted alphabet ({A,G,T} -> digits 0..2) resolves those k steps
# with ONE row gather instead of k serial occ gathers -- the single biggest
# fixed cost in the seeding stage.  Entries store the same frozen-on-empty
# semantics as the search loop, so KLT-initialized search is bit-identical.
# k is a per-index build parameter; 14 -> 3^14 * 2 u32 = 38 MB per block
# (each +1 of k trades device memory and build time for one serial occ
# gather per seed).  Gbp-scale builds default to 16 (689 MB, small beside a
# 12.6 GB index; outputs are identical at any k); small genomes keep 14.
KLT_MAX_K = 14
KLT_MAX_K_GBP = 16          # genomes over KLT_GBP_THRESHOLD bp
KLT_GBP_THRESHOLD = 512_000_000

# ---- score sentinel (device pipelines and host decoding share it) -------
INF_SCORE = 1 << 20

# ---- SAM flags --------------------------------------------------------------
FLAG_PAIRED = 0x1
FLAG_PROPER = 0x2
FLAG_UNMAPPED = 0x4
FLAG_MATE_UNMAPPED = 0x8
FLAG_REVERSE = 0x10
FLAG_MATE_REVERSE = 0x20
FLAG_READ1 = 0x40
FLAG_READ2 = 0x80

# ---- MAPQ rule (frozen; our spec, SURVEY.md section 7 hard-part 3) ----------
# d1 = best distance, d2 = second-best distinct-locus distance (None if absent)
#   tie at best (ambiguous)      -> MAPQ 0
#   gap = d2 - d1: 1 -> 10, 2 -> 20, 3 -> 30, >=4 or no second -> 42
#
# CALIBRATED round 5 (was 1->20, 2->30, 3->40): on a repeat-structured
# genome (scripts/mapq_calibration.py, the adversarial class for unique-
# call precision) the measured wrong-call rates were gap1 8.5% (phred 11),
# gap2 0.9% (phred 21), gap3 0 at n=272, no-second 4e-4 (phred 34) -- the
# old table over-promised by ~10 phred at every gap.  The new values state
# the measured confidence, so a downstream MAPQ>=20 filter actually drops
# the gap-1 calls that are wrong ~1-in-12 times on repeat genomes.  The
# >=4/no-second cap stays 42 (the bowtie2/Bismark convention downstream
# WGBS tooling expects); its measured phred on the repeat class is ~34.
# Spec-change rule (CLAUDE.md): oracle and device consume this one table
# (oracle/pipeline.py, models/finalize._MQ_TAB -> native finalize arg),
# so both paths moved in lockstep.
MAPQ_TABLE = {0: 0, 1: 10, 2: 20, 3: 30}
MAPQ_MAX = 42


def mapq_from_gap(d1: int, d2) -> int:
    """Deterministic MAPQ from best/second-best distance gap."""
    if d2 is None:
        return MAPQ_MAX
    gap = int(d2) - int(d1)
    if gap >= 4:
        return MAPQ_MAX
    return MAPQ_TABLE[max(gap, 0)]
