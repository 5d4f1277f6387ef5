"""BAM writer round-trip: decode our own BGZF+BAM bytes and compare fields."""
import gzip
import io
import struct

import numpy as np
import pytest

from bitmapperbs_tpu.config import AlignerConfig
from bitmapperbs_tpu.index.build import build_index
from bitmapperbs_tpu.io.bam import BamWriter
from bitmapperbs_tpu.oracle.pipeline import map_batch_se
from bitmapperbs_tpu.utils.simulate import random_genome_fasta, simulate_reads

_CIGAR_OPS = "MIDNSHP=X"
_NIB = "=ACMGRSVTWYHKDBN"


def decode_bam(data: bytes):
    raw = gzip.decompress(data)
    assert raw[:4] == b"BAM\1"
    off = 4
    l_text, = struct.unpack_from("<i", raw, off); off += 4
    text = raw[off:off + l_text].decode(); off += l_text
    n_ref, = struct.unpack_from("<i", raw, off); off += 4
    refs = []
    for _ in range(n_ref):
        l_name, = struct.unpack_from("<i", raw, off); off += 4
        name = raw[off:off + l_name - 1].decode(); off += l_name
        l_ref, = struct.unpack_from("<i", raw, off); off += 4
        refs.append((name, l_ref))
    recs = []
    while off < len(raw):
        bs, = struct.unpack_from("<i", raw, off); off += 4
        body = raw[off:off + bs]; off += bs
        (ref_id, pos, l_rn, mapq, _bin, n_cig, flag, l_seq,
         nref, npos, tlen) = struct.unpack_from("<iiBBHHHiiii", body, 0)
        p = 32
        qname = body[p:p + l_rn - 1].decode(); p += l_rn
        cig = []
        for _ in range(n_cig):
            v, = struct.unpack_from("<I", body, p); p += 4
            cig.append(f"{v >> 4}{_CIGAR_OPS[v & 15]}")
        seq = "".join(
            _NIB[(body[p + k // 2] >> (4 if k % 2 == 0 else 0)) & 15]
            for k in range(l_seq))
        p += (l_seq + 1) // 2
        qual = bytes(body[p:p + l_seq]); p += l_seq
        tags = {}
        while p < len(body):
            tag = body[p:p + 2].decode(); typ = chr(body[p + 2]); p += 3
            if typ == "i":
                tags[tag], = struct.unpack_from("<i", body, p); p += 4
            elif typ == "Z":
                end = body.index(0, p)
                tags[tag] = body[p:end].decode(); p = end + 1
            else:
                raise AssertionError(f"unexpected tag type {typ}")
        recs.append(dict(qname=qname, flag=flag, ref_id=ref_id, pos=pos,
                         mapq=mapq, cigar="".join(cig) or "*", seq=seq,
                         tlen=tlen, tags=tags, nref=nref, npos=npos))
    return text, refs, recs


def test_bam_roundtrip(rng):
    idx = build_index(random_genome_fasta(rng, contigs=(3000,)))
    sims = simulate_reads(idx.genome, 20, read_len=70, seed=3, sub_rate=0.01)
    cfg = AlignerConfig(max_errors=3, indels=True)
    sam = map_batch_se(idx, cfg, [s.codes for s in sims],
                       [s.qual for s in sims])
    buf = io.BytesIO()
    w = BamWriter(buf, idx.genome.names, idx.genome.lengths)
    for r in sam:
        w.write(r)
    w.close()
    text, refs, recs = decode_bam(buf.getvalue())
    assert refs == [("chr1", 3000)]
    assert "@PG" in text
    assert len(recs) == len(sam)
    for got, want in zip(recs, sam):
        assert got["qname"] == want.qname
        assert got["flag"] == want.flag
        assert got["cigar"] == want.cigar
        assert got["seq"] == want.seq
        assert got["mapq"] == want.mapq
        if not want.flag & 0x4:
            assert refs[got["ref_id"]][0] == want.rname
            assert got["pos"] == want.pos - 1
            assert got["tags"]["NM"] == want.nm
            assert got["tags"]["MD"] == want.md
            assert got["tags"]["XM"] == want.xm


def test_bgzf_eof_marker(rng):
    buf = io.BytesIO()
    w = BamWriter(buf, ["c"], [100])
    w.close()
    assert buf.getvalue().endswith(bytes.fromhex(
        "1f8b08040000000000ff0600424302001b0003000000000000000000"))


def test_read_bam_records_roundtrip(tmp_path):
    """read_bam_records gives back the header text and each record's exact
    encoded bytes; bam_record_fields decodes qname/flag/ref/pos/mapq."""
    from bitmapperbs_tpu.io.bam import (BamWriter, _encode_record,
                                        bam_record_fields, read_bam_records)
    from bitmapperbs_tpu.io.sam import SamRecord

    recs = [SamRecord(qname=f"q{i}", flag=16 * (i % 2), rname="chr2",
                      pos=10 + i, mapq=42, cigar="4M", rnext="*", pnext=0,
                      tlen=0, seq="ACGT", qual="IIII", nm=0)
            for i in range(3)]
    recs.append(SamRecord(qname="u", flag=4, rname="*", pos=0, mapq=0,
                          cigar="*", rnext="*", pnext=0, tlen=0, seq="ACGT",
                          qual="IIII"))
    path = tmp_path / "x.bam"
    with open(path, "wb") as f:
        w = BamWriter(f, ["chr1", "chr2"], [100, 200])
        for r in recs:
            w.write(r)
        w.close()
    text, got = read_bam_records(str(path))
    assert "@SQ\tSN:chr2\tLN:200" in text
    ids = {"chr1": 0, "chr2": 1}
    assert got == [_encode_record(r, ids)[4:] for r in recs]
    assert bam_record_fields(got[1]) == ("q1", 16, 1, 10, 42)
    assert bam_record_fields(got[3])[:3] == ("u", 4, -1)
