"""Multi-host driver logic (SURVEY.md 2.2/5.8, section 4 item 4).

The record-strided shard math and the stats psum run single-process on the
virtual CPU mesh; the full two-process jax.distributed path runs as a
subprocess smoke test (real DCN control plane on localhost).
"""
import json
import os
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

from bitmapperbs_tpu.io.stats import MapStats
from bitmapperbs_tpu.parallel import multihost

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_host_shard_partition():
    H = 3
    shards = [multihost.HostShard(h, H) for h in range(H)]
    n = 100
    codes = [np.zeros(2, np.uint8) + i for i in range(n)]
    qnames = [f"r{i}" for i in range(n)]
    quals = [""] * n
    seen = []
    # batches of 7 with a global start_record, as the CLI produces
    for lo in range(0, n, 7):
        hi = min(lo + 7, n)
        for sh in shards:
            c, q, _ = sh.filter_batch(codes[lo:hi], qnames[lo:hi],
                                      quals[lo:hi], lo)
            seen.extend(q)
    assert sorted(seen, key=lambda s: int(s[1:])) == qnames  # exact cover


def test_byte_range_plan_exact_cover(tmp_path):
    """Byte-range shard plans tile the file exactly at record boundaries,
    even with '@'-leading quality lines and varied read lengths; per-host
    range readers concatenate to the full record set in order."""
    from bitmapperbs_tpu.io.fastq import FastqReader, write_fastq

    rng = np.random.default_rng(5)
    n = 53
    reads = [rng.integers(0, 4, int(rng.integers(40, 90))).astype(np.uint8)
             for _ in range(n)]
    # quality strings that START with '@' to stress the boundary snap
    quals = [("@" if i % 2 else "I") * len(r) for i, r in enumerate(reads)]
    fq = tmp_path / "r.fq"
    write_fastq(str(fq), reads, [f"r{i}" for i in range(n)], quals)
    size = os.path.getsize(fq)

    for H in (2, 3, 5):
        plans = [multihost.plan_byte_range(str(fq), h, H) for h in range(H)]
        assert plans[0].offset == 0
        assert plans[-1].limit_offset == size
        for h in range(H - 1):
            assert plans[h].limit_offset == plans[h + 1].offset
            assert (plans[h].start_record + plans[h].n_records
                    == plans[h + 1].start_record)
        assert sum(p.n_records for p in plans) == n
        got = []
        for p in plans:
            r = FastqReader(str(fq), batch_size=7,
                            resume_offset=p.offset,
                            resume_record=p.start_record,
                            limit_offset=p.limit_offset)
            for b in r:
                got.extend(b.qnames)
        assert got == [f"r{i}" for i in range(n)]


def test_byte_range_plan_pe_alignment(tmp_path):
    """PE plans align mate 2 by record count even when the mate files have
    different byte layouts (different read lengths)."""
    from bitmapperbs_tpu.io.fastq import read_pairs, write_fastq

    rng = np.random.default_rng(6)
    n = 31
    r1 = [rng.integers(0, 4, 80).astype(np.uint8) for _ in range(n)]
    r2 = [rng.integers(0, 4, 40).astype(np.uint8) for _ in range(n)]
    f1, f2 = tmp_path / "r1.fq", tmp_path / "r2.fq"
    write_fastq(str(f1), r1, [f"p{i}" for i in range(n)])
    write_fastq(str(f2), r2, [f"p{i}" for i in range(n)])

    H = 3
    got = []
    for h in range(H):
        p = multihost.plan_byte_range(str(f1), h, H, path2=str(f2))
        for b1, b2 in read_pairs(str(f1), str(f2), batch_size=4,
                                 resume_offsets=(p.offset, p.offset2),
                                 resume_record=p.start_record,
                                 limit_records=p.n_records):
            assert b1.qnames == b2.qnames
            got.extend(b1.qnames)
    assert got == [f"p{i}" for i in range(n)]


def test_shard_path():
    assert multihost.shard_path("out.sam", 0, 1) == "out.sam"
    assert multihost.shard_path("out.sam", 2, 4) == "out.shard2.sam"
    assert multihost.shard_path("o", 1, 2) == "o.shard1.sam"


def test_global_stats_single_process():
    st = MapStats(total=10, mapped=8, unique=7, ambiguous=1, unmapped=2)
    g = multihost.global_stats(st)
    assert g["total"] == 10 and g["mapped"] == 8 and g["unmapped"] == 2


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _cli_subprocess(args, extra_env=None):
    """Run the CLI in a CPU-forced subprocess (jax.config before the CLI
    import, so the setting holds whatever the environment says)."""
    code = ("import jax, sys; jax.config.update('jax_platforms', 'cpu'); "
            "from bitmapperbs_tpu.cli import main; "
            "sys.exit(main(sys.argv[1:]))")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    if extra_env:
        env.update(extra_env)
    return subprocess.Popen([sys.executable, "-c", code] + args, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)


@pytest.fixture(scope="module")
def tiny_dataset(tmp_path_factory):
    from bitmapperbs_tpu.index.build import build_index, save_index
    from bitmapperbs_tpu.utils.simulate import (random_genome_fasta,
                                                simulate_reads)
    from bitmapperbs_tpu.io.fastq import write_fastq

    d = tmp_path_factory.mktemp("mh")
    rng = np.random.default_rng(4)
    fasta_text = random_genome_fasta(rng, contigs=(3000,))
    ref = d / "ref.fa"
    ref.write_text(fasta_text)
    idx = build_index(str(ref))
    save_index(idx, str(ref) + ".btidx")
    sims = simulate_reads(idx.genome, 36, read_len=64, seed=5, sub_rate=0.01)
    fq = d / "reads.fq"
    write_fastq(str(fq), [s.codes for s in sims],
                [f"r{i}" for i in range(len(sims))],
                ["I" * 64 for _ in sims])
    return d, ref, fq


def _sam_records(path):
    return sorted(l for l in open(path).read().splitlines()
                  if l and not l.startswith("@"))


def _stub_cli_subprocess(args):
    """CLI subprocess with jax.distributed stubbed out (sequential hosts)."""
    code = ("import jax, sys; jax.config.update('jax_platforms', 'cpu'); "
            "from bitmapperbs_tpu.parallel import multihost; "
            "multihost.init_distributed = lambda c, n, p: (p or 0, n); "
            "from bitmapperbs_tpu.cli import main; "
            "sys.exit(main(sys.argv[1:]))")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.Popen([sys.executable, "-c", code] + args, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def test_two_host_byte_range_cli(tiny_dataset):
    """--dist-shard bytes: two hosts' shard outputs concatenate to exactly
    the single-host record set (each host decodes only its byte range)."""
    d, ref, fq = tiny_dataset
    single = d / "single_b.sam"
    p = _stub_cli_subprocess(["search", str(ref), "--seq", str(fq), "-o",
                              str(single), "--oracle", "--batch-size", "8",
                              "--read-bucket", "64"])
    _, err = p.communicate(timeout=300)
    assert p.returncode == 0, err.decode()
    for h in range(2):
        p = _stub_cli_subprocess(
            ["search", str(ref), "--seq", str(fq), "-o", str(d / "bh.sam"),
             "--oracle", "--batch-size", "8", "--read-bucket", "64",
             "--dist-hosts", "2", "--dist-host-id", str(h),
             "--dist-shard", "bytes"])
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err.decode()
        assert b"(bytes)" in err
    merged = (_sam_records(d / "bh.shard0.sam")
              + _sam_records(d / "bh.shard1.sam"))
    assert sorted(merged) == _sam_records(single)


def test_byte_shard_rejects_gz(tiny_dataset):
    """--dist-shard bytes on a .gz input must fail loudly: byte-range plans
    are computed on uncompressed offsets; on compressed bytes hosts would
    silently drop/duplicate records."""
    import gzip

    d, ref, fq = tiny_dataset
    gzfq = d / "reads.fq.gz"
    gzfq.write_bytes(gzip.compress(fq.read_bytes()))
    p = _stub_cli_subprocess(
        ["search", str(ref), "--seq", str(gzfq), "-o", str(d / "gz.sam"),
         "--oracle", "--batch-size", "8", "--read-bucket", "64",
         "--dist-hosts", "2", "--dist-host-id", "0",
         "--dist-shard", "bytes"])
    _, err = p.communicate(timeout=300)
    assert p.returncode != 0
    assert b"uncompressed" in err
    # auto mode on the same input must route to records and succeed
    p = _stub_cli_subprocess(
        ["search", str(ref), "--seq", str(gzfq), "-o", str(d / "gz.sam"),
         "--oracle", "--batch-size", "8", "--read-bucket", "64",
         "--dist-hosts", "2", "--dist-host-id", "0",
         "--dist-shard", "auto"])
    _, err = p.communicate(timeout=300)
    assert p.returncode == 0, err.decode()
    assert b"(records)" in err


def test_two_process_distributed_smoke(tiny_dataset):
    """Two real processes over jax.distributed (localhost coordinator):
    shard outputs concatenate to exactly the single-host record set."""
    d, ref, fq = tiny_dataset
    single = d / "single.sam"
    p = _cli_subprocess(["search", str(ref), "--seq", str(fq), "-o",
                         str(single), "--oracle", "--batch-size", "8",
                         "--read-bucket", "64"])
    out, err = p.communicate(timeout=300)
    assert p.returncode == 0, err.decode()

    port = _free_port()
    procs = []
    for h in range(2):
        procs.append(_cli_subprocess(
            ["search", str(ref), "--seq", str(fq), "-o", str(d / "mh.sam"),
             "--oracle", "--batch-size", "8", "--read-bucket", "64",
             "--dist-hosts", "2", "--dist-host-id", str(h),
             "--dist-coordinator", f"127.0.0.1:{port}"]))
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err.decode()

    merged = (_sam_records(d / "mh.shard0.sam")
              + _sam_records(d / "mh.shard1.sam"))
    assert sorted(merged) == _sam_records(single)
