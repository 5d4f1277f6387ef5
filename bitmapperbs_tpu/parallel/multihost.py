"""Multi-host (DCN) driver: sharded FASTQ in, sharded SAM out, global stats.

SURVEY.md section 2.2 / 5.8: the reference is single-node pthreads; this
package scales over hosts with `jax.distributed` for the control plane,
device collectives inside the shard_map'd mapper (parallel/shard.py), and
the host network only for input sharding and end-of-run statistics.

Topology: every host runs this same driver.  Host h of H reads FASTQ records
h, h+H, h+2H, ... (record-strided sharding needs no index pass and balances
read-length skew), maps them on its local devices through the shard_map
pipeline over the GLOBAL mesh, and writes `<out>.shard<h>.sam`.  Shards
concatenate to a complete record set (order differs from input; each record
is independent and tagged by qname).  End-of-run counters are summed over
hosts with a psum on a tiny device array (the only DCN collective).

Degrades exactly to the single-host path when process_count == 1, which is
how the logic is unit-tested (a real pod run only changes process_count).
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np

import jax
import jax.numpy as jnp

from bitmapperbs_tpu.config import AlignerConfig
from bitmapperbs_tpu.index.build import BSIndex
from bitmapperbs_tpu.io.stats import MapStats


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> tuple[int, int]:
    """jax.distributed.initialize wrapper; returns (process_id, num_processes).

    With no arguments on a single host this is a no-op returning (0, 1).
    On a cluster, pass the coordinator address (host:port), the process
    count and this process's id before any other JAX call.  A host that
    cannot reach the coordinator times out inside jax.distributed -- that
    timeout IS the missing-host detection of SURVEY.md 5.3; the run then
    restarts from each host's output cursor.
    """
    if num_processes is not None and num_processes > 1:
        jax.distributed.initialize(coordinator_address=coordinator,
                                   num_processes=num_processes,
                                   process_id=process_id)
    return jax.process_index(), jax.process_count()


@dataclasses.dataclass
class HostShard:
    """Record-strided FASTQ shard assignment for this host."""

    process_id: int
    num_processes: int

    def owns(self, record_index: int) -> bool:
        return record_index % self.num_processes == self.process_id

    def filter_batch(self, codes, qnames, quals, start_record: int):
        keep = [i for i in range(len(codes))
                if self.owns(start_record + i)]
        return ([codes[i] for i in keep], [qnames[i] for i in keep],
                [quals[i] for i in keep])


def _snap_record_start(path: str, target: int) -> int:
    """Smallest FASTQ record-start byte offset >= (roughly) target.

    Record-start detection: a line is a record header iff it starts with
    '@' AND the line two below starts with '+' (quality lines may start
    with '@' but are always followed by header->sequence, and sequence
    lines never start with '+').  Deterministic, so all hosts computing
    adjacent boundaries agree and ranges tile exactly.
    """
    size = os.path.getsize(path)
    if target <= 0:
        return 0
    if target >= size:
        return size
    with open(path, "rb") as f:
        f.seek(target)
        f.readline()                      # skip the (possibly) partial line
        offs, lines = [], []
        for _ in range(8):
            offs.append(f.tell())
            line = f.readline()
            if not line:
                break
            lines.append(line)
        for i in range(min(4, len(lines))):
            if lines[i][:1] == b"@" and i + 2 < len(lines) \
                    and lines[i + 2][:1] == b"+":
                return offs[i]
    return size


def _count_newlines(path: str, lo: int, hi: int) -> int:
    """Newlines in bytes [lo, hi) -- block reads + bytes.count, no decode
    (~50-100x cheaper than the FASTQ decode path)."""
    n = 0
    with open(path, "rb") as f:
        f.seek(lo)
        left = hi - lo
        while left > 0:
            chunk = f.read(min(1 << 24, left))
            if not chunk:
                break
            n += chunk.count(b"\n")
            left -= len(chunk)
    return n


def _offset_of_record(path: str, record_index: int) -> int:
    """Byte offset of FASTQ record `record_index` (scan: newline counting)."""
    need = 4 * record_index
    if need == 0:
        return 0
    off = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(1 << 24)
            if not chunk:
                return off
            c = chunk.count(b"\n")
            if c >= need:
                nl = np.flatnonzero(
                    np.frombuffer(chunk, np.uint8) == ord("\n"))
                return off + int(nl[need - 1]) + 1
            need -= c
            off += len(chunk)


@dataclasses.dataclass
class ByteRangePlan:
    """Per-host byte-range FASTQ shard (SURVEY.md 2.2 DCN row).

    Unlike record-striding (HostShard), each host reads and DECODES only
    its ~1/H byte range; planning costs one boundary snap plus a newline
    scan of the range/prefix (no decode).  Uncompressed FASTQ only --
    .gz cannot seek, use record striding or per-host files there.
    """

    start_record: int          # global index of this host's first record
    offset: int                # mate-1 start byte
    limit_offset: int          # mate-1 end byte (exclusive; snapped)
    n_records: int             # records owned by this host
    offset2: int = 0           # mate-2 start byte (PE)


def plan_byte_range(path: str, process_id: int, num_processes: int,
                    path2: str | None = None) -> ByteRangePlan:
    """Byte-range shard plan for host `process_id` of `num_processes`.

    SE: equal byte ranges snapped to record starts; the host decodes only
    [offset, limit_offset).  PE: ranges are chosen on mate-1 and mate 2 is
    aligned by RECORD COUNT (mate files need not have equal byte layouts);
    the alignment scan is newline counting only.
    """
    size = os.path.getsize(path)
    lo = _snap_record_start(path, size * process_id // num_processes)
    hi = _snap_record_start(path, size * (process_id + 1) // num_processes)
    start_record = _count_newlines(path, 0, lo) // 4
    n_records = _count_newlines(path, lo, hi) // 4
    plan = ByteRangePlan(start_record=start_record, offset=lo,
                         limit_offset=hi, n_records=n_records)
    if path2 is not None:
        plan.offset2 = _offset_of_record(path2, start_record)
    return plan


def shard_path(output: str, process_id: int, num_processes: int) -> str:
    if num_processes == 1:
        return output
    base = output[:-4] if output.endswith(".sam") else output
    return f"{base}.shard{process_id}.sam"


def global_stats(stats: MapStats) -> dict:
    """Sum per-host counters over all hosts (single DCN psum).

    Each host contributes its counters on its first local device only, then
    a pmapped psum over the GLOBAL device set (jax extends the axis across
    processes) yields the exact cross-host totals on every host.
    """
    names = ("total", "mapped", "unique", "ambiguous", "unmapped",
             "proper_pairs", "overflow_reads")
    vals = np.array([getattr(stats, k) for k in names], dtype=np.int64)
    n_local = jax.local_device_count()
    contrib = np.zeros((n_local, len(vals)), dtype=np.int64)
    contrib[0] = vals
    summed = np.asarray(
        jax.pmap(lambda x: jax.lax.psum(x, "d"), axis_name="d")(
            jnp.asarray(contrib)))[0]
    return {k: int(v) for k, v in zip(names, summed)}
