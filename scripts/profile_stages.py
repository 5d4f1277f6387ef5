"""Per-stage wall timing of the SE device pipeline on the bench workload.

Times each pipeline stage in isolation (jitted, block_until_ready) so we can
see where reads/s/chip goes (SURVEY.md section 5.1: tracing/profiling).
"""
from __future__ import annotations

import functools
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

from bitmapperbs_tpu import constants as K
from bitmapperbs_tpu.config import AlignerConfig
from bitmapperbs_tpu.index.build import build_index
from bitmapperbs_tpu.index.device import upload_index
from bitmapperbs_tpu.models import aligner
from bitmapperbs_tpu.models.host import prepare_batch
from bitmapperbs_tpu.ops import fm, verify
from bitmapperbs_tpu.utils.simulate import random_genome_fasta, simulate_reads


def timed(fn, *args, iters=3):
    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
        jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters, out


def main():
    rng = np.random.default_rng(0)
    genome_bp = 10_000_000
    idx = build_index(random_genome_fasta(
        rng, contigs=(genome_bp // 2, genome_bp // 2)))
    dix = upload_index(idx)

    bucket, batch = 96, 4096
    cfg = AlignerConfig(max_errors=4, indels=True, read_len_bucket=bucket,
                        batch_size=batch)
    sims = simulate_reads(idx.genome, batch, read_len=90, seed=1,
                          sub_rate=0.01, indel_rate=0.005)
    reads, lengths = prepare_batch([s.codes for s in sims], bucket, batch)
    reads, lengths = jnp.asarray(reads), jnp.asarray(lengths)

    frames = tuple(aligner.frames_for(cfg))
    B, m = reads.shape
    e, S, O, LB, Kc = (cfg.max_errors, cfg.num_seeds, cfg.max_seed_occ,
                       cfg.locate_budget, cfg.max_candidates)
    F = len(frames)
    print(f"B={B} m={m} e={e} S={S} O={O} LB={LB} Kc={Kc} F={F}")

    # full pipeline
    full = functools.partial(aligner.map_batch_device, dix, cfg)
    dt, _ = timed(full, reads, lengths)
    print(f"full pipeline      {dt*1e3:8.1f} ms   {B/dt:10.0f} reads/s")

    # stage 1: seeding (search_patterns)
    conv = jnp.asarray(K.CONV_MAP, dtype=jnp.uint8)
    rc = aligner._revcomp_padded(reads, lengths)
    frame_reads = jnp.stack(
        [reads if p == K.PAT_CT else rc for p, _ in frames], axis=1)
    patterns = conv[frame_reads]
    blocks = jnp.asarray([b for _, b in frames], jnp.int32)
    starts, ends = aligner._seed_bounds(lengths, S)
    starts_l = jnp.broadcast_to(starts[:, None, :], (B, F, S))
    ends_l = jnp.broadcast_to(ends[:, None, :], (B, F, S))
    block_l = jnp.broadcast_to(blocks[None, :, None], (B, F, S))
    pat_l = jnp.broadcast_to(patterns[:, :, None, :], (B, F, S, m))
    max_seed_len = -(-m // S)

    seed_fn = jax.jit(functools.partial(fm.search_patterns, max_len=max_seed_len))
    dt, (sp, ep) = timed(seed_fn, dix, block_l, pat_l, starts_l, ends_l)
    print(f"seeding ({S}x{max_seed_len} steps) {dt*1e3:8.1f} ms")

    # stage 2: locate on the dense LB grid
    cnt = jnp.where((ep - sp > 0) & (ep - sp <= O), ep - sp, 0).astype(jnp.int32)
    print("  seed lanes:", B * F * S, " total occupancy:",
          int(cnt.sum()), " per-read avg:", float(cnt.sum()) / B)
    sa_grid = jnp.broadcast_to(sp[..., :1], (B, F, LB)).astype(jnp.uint32)
    ok_grid = jnp.ones((B, F, LB), jnp.bool_)
    block_lb = jnp.broadcast_to(blocks[None, :, None], (B, F, LB))
    loc_fn = jax.jit(fm.locate)
    dt, _ = timed(loc_fn, dix, block_lb, sa_grid, ok_grid)
    print(f"locate ({B*F*LB} lanes x {K.SA_SAMPLE_RATE} LF) {dt*1e3:8.1f} ms")

    # stage 3: hamming over Kc grid
    cand = jnp.zeros((B, F, Kc), jnp.uint32)
    Wd = m // 32
    L = dix.genome_len
    block_kc = jnp.broadcast_to(blocks[None, :, None], (B, F, Kc))
    read_planes = verify.pack_codes(frame_reads)
    lenmask = verify.length_mask(lengths, m)[:, None, :]

    @jax.jit
    def ham_fn(cand):
        ref_planes = verify.window_planes(
            dix.g_planes, block_kc, cand, Wd, L, dix.idx_axis)
        rp = tuple(p[:, :, None, :] for p in read_planes)
        return verify.hamming(ref_planes, rp, lenmask[:, :, None, :])

    dt, _ = timed(ham_fn, cand)
    print(f"hamming ({B*F*Kc} lanes)   {dt*1e3:8.1f} ms")

    # stage 4: myers over Kc grid
    ncols = m + 2 * e
    Ww = -(-ncols // 32)

    @jax.jit
    def myers_stage(cand):
        win_planes = verify.window_planes(
            dix.g_planes, block_kc, cand, Ww, L, dix.idx_axis)
        peq, pad = verify.build_peq(frame_reads, lengths[:, None], m)
        peq_b = jnp.broadcast_to(peq[:, :, None], (B, F, Kc, 4, Wd))
        pad_b = jnp.broadcast_to(pad[:, :, None], (B, F, Kc, Wd))
        return verify.myers(win_planes, peq_b, pad_b, m, ncols)

    dt, _ = timed(myers_stage, cand)
    print(f"myers ({B*F*Kc} lanes)     {dt*1e3:8.1f} ms")

    # dedup/sort stage
    anchor = jnp.zeros((B, F, LB), jnp.uint32)

    @jax.jit
    def sort_fn(anchor):
        return jnp.sort(anchor, axis=-1)

    dt, _ = timed(sort_fn, anchor)
    print(f"sort ({B*F*LB})            {dt*1e3:8.1f} ms")


if __name__ == "__main__":
    main()
