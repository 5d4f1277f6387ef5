"""Device-resident index arrays (SURVEY.md L2 restatement).

The two PackedBlocks are padded to a common shape and stacked on a leading
block axis so one gather, indexed by `block * rows_max + row`, serves lanes
working in either block (occ-table lookup = "vectorized gather over
device-resident bit-packed BWT blocks", BASELINE).  The original genome is held
as bit-packed planes in both orientations (fwd and rc) so block-1
verification gathers contiguous forward words instead of bit-reversing.

All positions/counters are uint32 (SURVEY.md hard-part 6); gather row
indices are int32 (row counts are < 2^31 even for GRCh38).
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from bitmapperbs_tpu import constants as K
from bitmapperbs_tpu.index.build import BSIndex


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DeviceIndex:
    # FM blocks, stacked [2, ...]
    cp_rows: jax.Array      # uint32[2 * rows_max, CP_ROW_U32] (flattened)
    cbase: jax.Array        # uint32[2, CONV_ALPHA]
    sa_samples: jax.Array   # uint32[2 * samples_max] (flat; shardable)
    n: jax.Array            # uint32[2] text lengths (incl sentinel)
    # original genome, bit-packed planes, fwd + rc orientations.  FLAT
    # rows (block-0 words then block-1 words), fixed at upload so no jit
    # ever reshapes the multi-GB table (and sharded row math is uniform).
    g_planes: jax.Array     # uint32[2 * g_words, 3]: row -> [b0, b1, nmask]
    # k-mer lookup table (constants.py KLT): first klt_k backward-search
    # steps in one gather; always replicated (worst case 3^14 * 2 u32
    # = 38 MB per block, 76 MB both blocks at KLT_MAX_K=14).
    klt: jax.Array          # uint32[2 * 3^klt_k, 2] (flat over blocks)
    rows_max: int = dataclasses.field(metadata=dict(static=True))
    genome_len: int = dataclasses.field(metadata=dict(static=True))
    samples_max: int = dataclasses.field(metadata=dict(static=True))
    sa_rate: int = dataclasses.field(default=K.DEFAULT_SA_RATE,
                                     metadata=dict(static=True))
    klt_k: int = dataclasses.field(default=0, metadata=dict(static=True))
    # per-block GLOBAL g_planes row count (block-1 rows start at this offset;
    # needed by sharded fetches where the local array is only a row range)
    g_words: int = dataclasses.field(default=0, metadata=dict(static=True))
    # sharded-index mode (BASELINE: index "replicated or sharded"): when set,
    # cp_rows / sa_samples / g_planes hold only this device's shard along
    # their major axis and every fetch psums partial gathers over this axis.
    idx_axis: str | None = dataclasses.field(
        default=None, metadata=dict(static=True))

    @property
    def nbytes(self) -> int:
        return sum(int(a.size) * 4 for a in
                   (self.cp_rows, self.sa_samples, self.g_planes))


# Arrays above _PUT_THRESHOLD are streamed in row chunks of _CHUNK_BYTES and
# stitched into a donated device buffer: the host never holds more than one
# chunk beyond the (possibly mmap-backed) source, and device memory peaks at
# the full array plus one chunk.
_CHUNK_BYTES = 256 << 20
_PUT_THRESHOLD = 1 << 30


def _stitched_put(parts, shape, dtype, placement):
    """Row-stitch a list of (row_offset, ndarray) into one device array.

    placement: None (default device), a Device or a Sharding.  Sources may
    be mmap views straight off the artifact.  Rows not covered by any part
    stay zero (block padding semantics).  A sharded placement is assembled
    on the host and put once, so each device receives only its rows."""
    nbytes = int(np.prod(shape, dtype=np.int64)) * np.dtype(dtype).itemsize
    replicated = (placement is None or isinstance(placement, jax.Device)
                  or placement.is_fully_replicated)
    if nbytes <= _PUT_THRESHOLD or not replicated:
        out = np.zeros(shape, dtype=dtype)
        for off, a in parts:
            out[off:off + a.shape[0]] = a
        return jax.device_put(out, placement)
    row_bytes = max(1, nbytes // max(1, shape[0]))
    rows = max(1, _CHUNK_BYTES // row_bytes)

    def _update(buf, chunk, start):
        return jax.lax.dynamic_update_slice_in_dim(buf, chunk, start, axis=0)

    update = jax.jit(_update, donate_argnums=0)
    buf = jnp.zeros(shape, dtype=dtype, device=placement)
    for off, a in parts:
        for s in range(0, a.shape[0], rows):
            chunk = jax.device_put(np.ascontiguousarray(a[s:s + rows]),
                                   placement)
            buf = update(buf, chunk, jnp.int32(off + s))
            del chunk
    return jax.block_until_ready(buf)


PLANES_CACHE_VERSION = 1


def _planes_cache_path(idx: BSIndex) -> str | None:
    """Derived genome-plane cache living next to the artifact.

    Keyed by genome_sha256 so artifacts of the same genome at different
    sa_rates (e.g. idx_3g / idx_3g_r4) share one cache file."""
    if idx.source_prefix is None:
        return None
    sha = idx.meta.get("genome_sha256", "")[:16]
    if not sha:
        return None
    d = os.path.dirname(os.path.abspath(idx.source_prefix))
    return os.path.join(d, f"gplanes_{sha}.v{PLANES_CACHE_VERSION}.bin")


def _device_layout_planes(genome) -> np.ndarray:
    """Genome -> gp uint32[2 * (words+1), 3] in the exact upload layout.

    Leading zero word: ops/verify.window_planes biases starts by +32 so
    wrapped-negative window starts (anchor - e near position 0) resolve;
    plane-INTERLEAVED rows so one gather fetches all 3 planes of a word."""
    planes = genome.packed_planes()
    words = len(planes["g0"])
    gp = np.zeros((2, words + 1, 3), dtype=np.uint32)
    for oi, pref in enumerate(("g", "r")):
        for pi, suf in enumerate(("0", "1", "n")):
            gp[oi, 1:, pi] = planes[pref + suf]
    return gp.reshape(2 * (words + 1), 3)


def ensure_plane_cache(idx: BSIndex) -> str | None:
    """Write the genome-plane cache if the index came from disk; return its
    path (None for in-RAM indexes).  Atomic: temp file + rename."""
    path = _planes_cache_path(idx)
    if path is None:
        return None
    if not os.path.exists(path):
        gp = _device_layout_planes(idx.genome)
        tmp = path + f".tmp.{os.getpid()}"
        gp.tofile(tmp)
        os.replace(tmp, path)
    return path


def _load_or_build_planes(idx: BSIndex) -> np.ndarray:
    path = _planes_cache_path(idx)
    words = (idx.genome.length + 31) // 32
    n_rows = 2 * (words + 1)
    if path is not None:
        if not os.path.exists(path):
            ensure_plane_cache(idx)
        gp = np.memmap(path, dtype=np.uint32, mode="r")
        if gp.size == n_rows * 3:
            return gp.reshape(n_rows, 3)
        # stale/foreign cache (size mismatch): rebuild in RAM, don't trust it
    return _device_layout_planes(idx.genome)


def upload_index(idx: BSIndex, device=None, mesh=None,
                 idx_axis: str | None = None) -> DeviceIndex:
    """Host BSIndex -> device arrays.

    device: target device (default: jax's default device).  With a `mesh`,
    every array is replicated over it instead; with `idx_axis` too, the big
    arrays (cp_rows, sa_samples, g_planes) are sharded over that mesh axis
    (their per-block strides padded to a multiple of its size, which the
    fetch_* address math reads from rows_max / samples_max) and every
    fetch psums partial rows over it (ops/fm.py).

    Zero-copy from an mmap-loaded artifact: per-block cp/sa segments are
    chunk-streamed straight into the stacked device buffers, and the genome
    planes come from the on-disk cache when present (recomputing them is
    minutes of single-core work at 3 Gbp)."""
    ns = mesh.shape[idx_axis] if idx_axis else 1
    rows_max = -(-max(b.cp_rows.shape[0] for b in idx.blocks) // ns) * ns
    smax = max(max(len(b.sa_samples) for b in idx.blocks), 1)
    smax = -(-smax // ns) * ns

    cp_parts = [(i * rows_max, b.cp_rows) for i, b in enumerate(idx.blocks)]
    sa_parts = [(i * smax, b.sa_samples) for i, b in enumerate(idx.blocks)]
    gp = _load_or_build_planes(idx)
    g_words = gp.shape[0] // 2

    klt_k = idx.blocks[0].klt_k
    assert all(b.klt_k == klt_k for b in idx.blocks)
    klt = np.stack([b.klt for b in idx.blocks])       # [2, 3^k, 2]

    small = big = device
    if mesh is not None:
        small = big = NamedSharding(mesh, P())
        if idx_axis:
            big = NamedSharding(mesh, P(idx_axis))
    put = lambda x: jax.device_put(np.ascontiguousarray(x), small)
    return DeviceIndex(
        cp_rows=_stitched_put(cp_parts, (2 * rows_max, K.CP_ROW_U32),
                              np.uint32, big),
        cbase=put(np.stack([b.cbase for b in idx.blocks])),
        sa_samples=_stitched_put(sa_parts, (2 * smax,), np.uint32, big),
        n=put(np.array([b.n for b in idx.blocks], dtype=np.uint32)),
        # sharded: pad rows at the END to a multiple of the axis size (the
        # per-block row offset g_words is unchanged)
        g_planes=_stitched_put([(0, gp)], (-(-gp.shape[0] // ns) * ns, 3),
                               np.uint32, big),
        klt=put(klt.reshape(2 * 3 ** klt_k, 2)),
        rows_max=rows_max,
        genome_len=idx.genome.length,
        samples_max=smax,
        sa_rate=idx.blocks[0].sa_rate,
        klt_k=klt_k,
        g_words=g_words,
        idx_axis=idx_axis,
    )
