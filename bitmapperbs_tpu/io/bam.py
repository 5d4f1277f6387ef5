"""BAM output: BGZF container + binary alignment records (SURVEY.md C18,
reference capability "--bam").  Self-contained (zlib only); validated against
samtools-compatible readers via pysam-free round-trip tests.
"""
from __future__ import annotations

import re
import struct
import zlib

from bitmapperbs_tpu.io.sam import SamRecord

_BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")

_SEQ_NIBBLE = {"=": 0, "A": 1, "C": 2, "M": 3, "G": 4, "R": 5, "S": 6,
               "V": 7, "T": 8, "W": 9, "Y": 10, "H": 11, "K": 12, "D": 13,
               "B": 14, "N": 15}
_CIGAR_OP = {"M": 0, "I": 1, "D": 2, "N": 3, "S": 4, "H": 5, "P": 6,
             "=": 7, "X": 8}

# byte-translation tables: the per-character nibble/qual loops dominated
# the encoder profile (~90 dict lookups / ord() calls per record)
# chars below '!' (ord 33) are invalid phred33; map them to a 0xFE sentinel
# so the encoder can reject malformed quality strings with one memchr scan
# instead of a per-character python loop
_QUAL_TAB = bytes(c - 33 if c >= 33 else 0xFE for c in range(256))
_CIGAR_ONE = re.compile(r"^(\d+)M$")
# nibble packing at C speed: translate codes to hex digits, then
# bytes.fromhex packs each digit pair into (hi << 4) | lo
_NIB_HEX = bytes(b"0123456789abcdef"[_SEQ_NIBBLE.get(chr(c), 15)]
                 for c in range(256))
_CIG1_CACHE: dict[int, bytes] = {}


def _bgzf_block(data: bytes) -> bytes:
    comp = zlib.compressobj(6, zlib.DEFLATED, -15)
    cdata = comp.compress(data) + comp.flush()
    # BSIZE = total block size - 1 (BGZF spec): header(12) + extra(6) +
    # cdata + footer(8), minus 1
    bsize = len(cdata) + 25
    header = struct.pack(
        "<BBBBIBBHBBHH",
        0x1f, 0x8b, 8, 4,    # gzip magic, deflate, FEXTRA
        0, 0, 0xff,          # mtime, xfl, os
        6,                   # XLEN
        66, 67, 2,           # 'B', 'C', subfield length
        bsize)
    footer = struct.pack("<II", zlib.crc32(data) & 0xFFFFFFFF,
                         len(data) & 0xFFFFFFFF)
    return header + cdata + footer


class BgzfWriter:
    """Minimal BGZF writer: buffers to <=64KB blocks."""

    MAX = 65000

    def __init__(self, fh):
        self.fh = fh
        self.buf = bytearray()

    def write(self, data: bytes) -> None:
        self.buf += data
        while len(self.buf) >= self.MAX:
            self.fh.write(_bgzf_block(bytes(self.buf[:self.MAX])))
            del self.buf[:self.MAX]

    def flush(self) -> None:
        """Emit buffered bytes as a complete BGZF block and flush the file.

        After this, fh.tell() is a BGZF block boundary AND a BAM record
        boundary (records are only ever appended whole to the buffer), so it
        is a sound resume-truncation point (cli --resume with --bam)."""
        if self.buf:
            self.fh.write(_bgzf_block(bytes(self.buf)))
            self.buf.clear()
        self.fh.flush()

    def close(self) -> None:
        self.flush()
        self.fh.write(_BGZF_EOF)
        self.fh.flush()


def reg2bin(beg: int, end: int) -> int:
    """BAM spec bin computation for [beg, end)."""
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def _encode_record(rec: SamRecord, ref_ids: dict[str, int]) -> bytes:
    ref_id = ref_ids.get(rec.rname, -1)
    pos = rec.pos - 1
    name = rec.qname.encode() + b"\0"
    cig_txt = rec.cigar
    if cig_txt[-1] == "M" and cig_txt[:-1].isdigit():  # ungapped: "90M"
        n_ops = 1
        span = int(cig_txt[:-1])
        cigar = _CIG1_CACHE.get(span)
        if cigar is None:
            cigar = _CIG1_CACHE[span] = struct.pack("<I", span << 4)
        if len(_CIG1_CACHE) > 4096:
            _CIG1_CACHE.clear()
    elif cig_txt != "*":
        cigar_ops = re.findall(r"(\d+)([MIDNSHP=X])", cig_txt)
        n_ops = len(cigar_ops)
        span = sum(int(n) for n, op in cigar_ops if op in "MDN=X")
        cigar = b"".join(struct.pack("<I", (int(n) << 4) | _CIGAR_OP[op])
                         for n, op in cigar_ops)
    else:
        n_ops = 0
        span = 0
        cigar = b""
    seq = rec.seq if rec.seq != "*" else ""
    l_seq = len(seq)
    hx = seq.encode().translate(_NIB_HEX)
    if l_seq % 2:
        hx += b"0"            # pad nibble 0 ('='), matching htslib
    packed = bytes.fromhex(hx.decode("ascii"))
    if rec.qual in ("*", "") or l_seq == 0:
        qual = b"\xff" * l_seq
    elif len(rec.qual) != l_seq:
        # the SAM text would carry the mismatched string verbatim; encoding
        # it as "missing" would silently diverge BAM from SAM
        raise ValueError(
            f"quality length {len(rec.qual)} != sequence length {l_seq} "
            f"for read {rec.qname!r}")
    else:
        qual = rec.qual.encode().translate(_QUAL_TAB)
        if 0xFE in qual:  # sentinel: a char below '!' (invalid phred33)
            raise ValueError(
                f"invalid quality string for read {rec.qname!r}: contains "
                f"a character below '!' (not phred33)")
    span = span or 1
    nref_id = ref_ids.get(rec.rnext, ref_id if rec.rnext == "=" else -1)
    tags = bytearray()
    if rec.nm is not None:
        tags += b"NMi" + struct.pack("<i", rec.nm)
    for tag, val in (("MD", rec.md), ("XM", rec.xm), ("XR", rec.xr),
                     ("XG", rec.xg)):
        if val is not None:
            tags += tag.encode() + b"Z" + val.encode() + b"\0"
    body = struct.pack(
        "<iiBBHHHiiii",
        ref_id, pos if ref_id >= 0 else -1,
        len(name), rec.mapq,
        reg2bin(pos, pos + span) if ref_id >= 0 else 4680,
        n_ops, rec.flag, l_seq,
        nref_id, rec.pnext - 1, rec.tlen,
    ) + name + cigar + packed + qual + bytes(tags)
    return struct.pack("<i", len(body)) + body


class BamWriter:
    """Drop-in alternative to SamWriter producing BAM."""

    def __init__(self, fh, names, lengths, rg=None, cl="bitmapperbs_tpu",
                 write_header=True):
        from bitmapperbs_tpu.io.sam import header

        self.bgzf = BgzfWriter(fh)
        if write_header:  # False on --resume: appending blocks to a
            # truncated-at-block-boundary BAM (BGZF blocks concatenate)
            text = "\n".join(header(names, lengths, rg, cl)) + "\n"
            out = b"BAM\1" + struct.pack("<i", len(text)) + text.encode()
            out += struct.pack("<i", len(names))
            for n, ln in zip(names, lengths):
                nb = str(n).encode() + b"\0"
                out += struct.pack("<i", len(nb)) + nb \
                    + struct.pack("<i", int(ln))
            self.bgzf.write(out)
        self.ref_ids = {str(n): i for i, n in enumerate(names)}

    def write(self, rec: SamRecord) -> None:
        self.bgzf.write(_encode_record(rec, self.ref_ids))

    def flush(self) -> None:
        self.bgzf.flush()

    def close(self) -> None:
        self.bgzf.close()


def read_bam_records(path) -> tuple[str, list[bytes]]:
    """BAM file -> (header text, raw alignment records).

    Each record is its encoded body without the block_size prefix, so two
    files hold the same alignments iff their records are equal bytes.
    BGZF is multi-member gzip, which gzip.decompress reads whole."""
    import gzip

    with open(path, "rb") as f:
        raw = gzip.decompress(f.read())
    if raw[:4] != b"BAM\1":
        raise ValueError(f"{path}: not a BAM file")
    l_text, = struct.unpack_from("<i", raw, 4)
    text = raw[8:8 + l_text].decode()
    off = 8 + l_text
    n_ref, = struct.unpack_from("<i", raw, off)
    off += 4
    for _ in range(n_ref):
        l_name, = struct.unpack_from("<i", raw, off)
        off += 8 + l_name
    recs = []
    while off < len(raw):
        size, = struct.unpack_from("<i", raw, off)
        recs.append(raw[off + 4:off + 4 + size])
        off += 4 + size
    return text, recs


def bam_record_fields(body: bytes) -> tuple[str, int, int, int, int]:
    """(qname, flag, ref_id, 0-based pos, mapq) of a raw BAM record."""
    ref_id, pos, l_name, mapq, _bin, _ncig, flag = struct.unpack_from(
        "<iiBBHHH", body, 0)
    return body[32:32 + l_name - 1].decode(), flag, ref_id, pos, mapq
