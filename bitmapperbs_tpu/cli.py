"""Command-line driver (SURVEY.md C1, section 2.1 capability surface).

Two subcommands mirroring the reference:
    bitmapperbs_tpu index  ref.fa [--prefix P]
    bitmapperbs_tpu search ref.fa --seq r.fq [options]   (SE)
    bitmapperbs_tpu search ref.fa --seq1 1.fq --seq2 2.fq --pe [options] (PE)
Legacy spellings `--index ref.fa` / `--search ref.fa` are accepted too.

Streaming runs checkpoint a (record, byte-offset) cursor next to the output
(SURVEY.md 5.3/5.4) so an interrupted multi-batch run resumes at the last
completed batch with `--resume`.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import sys
import time


def _translate_legacy(argv):
    if argv and argv[0] in ("--index", "--search"):
        return [argv[0][2:]] + argv[1:]
    return argv


def build_parser():
    from bitmapperbs_tpu.io.sam import VERSION

    ap = argparse.ArgumentParser(prog="bitmapperbs_tpu",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--version", action="version",
                    version=f"bitmapperbs_tpu {VERSION}")
    sub = ap.add_subparsers(dest="cmd", required=True)

    ix = sub.add_parser("index", help="build the bisulfite FM-index")
    ix.add_argument("ref")
    ix.add_argument("--prefix", default=None,
                    help="index output prefix (default: <ref>.btidx)")
    ix.add_argument("--sa-rate", type=int, default=None,
                    help="SA sample rate (default: 4 for <=134 Mbp, else 8; "
                         "lower = faster locate, more device memory)")
    ix.add_argument("--klt-k", type=int, default=None,
                    help="k-mer lookup table depth (default: genome-size "
                         "adaptive, <= 14)")
    ix.add_argument("-t", "--threads", type=int, default=1,
                    help="build the two FM blocks (CT(W), CT(rc W)) in "
                         "parallel worker processes (>=2 halves the "
                         "suffix-array wall time; needs RAM for two "
                         "concurrent builds)")
    ix.add_argument("--build-mode", choices=("auto", "sais", "lowmem"),
                    default="auto",
                    help="sais: in-RAM suffix array (~12 B/char); lowmem: "
                         "native dynamic-BWT insertion, no suffix array "
                         "(~1 B/char peak -- whole-genome builds on small "
                         "hosts); auto picks by genome size")

    rs = sub.add_parser(
        "resample",
        help="densify an index's SA samples (halve sa-rate) in place -- "
             "faster locate without rebuilding the suffix array")
    rs.add_argument("prefix", help="index prefix (from `index`)")
    rs.add_argument("--sa-rate", type=int, default=None,
                    help="target rate (default: half the current rate; must "
                         "be current/2^k)")
    rs.add_argument("--out", default=None,
                    help="output prefix (default: rewrite in place)")

    se = sub.add_parser("search", help="map reads")
    se.add_argument("ref")
    se.add_argument("--seq", help="single-end FASTQ(.gz)")
    se.add_argument("--seq1", help="paired-end mate 1")
    se.add_argument("--seq2", help="paired-end mate 2")
    se.add_argument("--pe", action="store_true", help="paired-end mode")
    se.add_argument("-o", "--output", default="-", help="SAM output (default stdout)")
    se.add_argument("--bam", action="store_true",
                    help="write BAM instead of SAM (also implied by a .bam "
                         "output path)")
    se.add_argument("-e", "--max-errors", type=float, default=4,
                    help="error budget: an integer = max edit distance; a "
                         "fraction in (0,1) = error rate, resolved as "
                         "floor(rate * first-read length) (min 1)")
    se.add_argument("--no-indels", action="store_true",
                    help="Hamming-only mode (mismatches, no gaps)")
    se.add_argument("--min", dest="min_insert", type=int, default=0)
    se.add_argument("--max", dest="max_insert", type=int, default=1000)
    se.add_argument("--pbat", "--non-directional", dest="non_directional",
                    action="store_true")
    se.add_argument("--fast", action="store_true",
                    help="sensitivity preset: fewer candidates")
    se.add_argument("--sensitive", action="store_true",
                    help="sensitivity preset: more candidates")
    se.add_argument("--seed-ext", type=int, default=None, metavar="N",
                    help="adaptive seed extension: a heavy seed grows left "
                         "by up to N chars until its interval is small "
                         "(default: auto -- 20 for genomes over 512 Mbp, "
                         "else off; 0 disables)")
    se.add_argument("--seed-ext-occ", type=int, default=4, metavar="T",
                    help="extension stops once a seed's interval holds <= T "
                         "occurrences (with --seed-ext)")
    se.add_argument("--max-candidates", type=int, default=None, metavar="K",
                    help="verified anchors per read per (pattern, block) "
                         "(default: auto -- 128 for genomes over 512 Mbp, "
                         "else 64)")
    se.add_argument("-t", "--threads", type=int, default=1,
                    help="host IO worker threads (device does the mapping)")
    se.add_argument("--batch-size", type=int, default=4096)
    se.add_argument("--flat-chunks", type=int, default=None, metavar="N",
                    help="run locate/verify over the candidate buffer in N "
                         "occupancy-bounded chunks (skip work past the last "
                         "occupied slot; bit-identical; default: size-"
                         "adaptive)")
    se.add_argument("--read-bucket", type=int, default=None,
                    help="padded read length (multiple of 32; default: "
                         "sized from the first reads -- shorter buckets map "
                         "proportionally faster)")
    se.add_argument("--phred64", action="store_true")
    se.add_argument("--unmapped-out", default=None,
                    help="write unmapped reads to this FASTQ")
    se.add_argument("--ambiguous-out", default=None,
                    help="write ambiguous (MAPQ 0) reads to this FASTQ")
    se.add_argument("--suppress-ambiguous", action="store_true",
                    help="do not report multi-mapping (MAPQ 0) reads")
    se.add_argument("--stats-json", default=None)
    se.add_argument("--resume", action="store_true",
                    help="resume from the output's cursor checkpoint")
    se.add_argument("--dist-hosts", type=int, default=1,
                    help="number of hosts in a multi-host (pod) run")
    se.add_argument("--dist-host-id", type=int, default=None,
                    help="this host's process id (default: auto)")
    se.add_argument("--dist-coordinator", default=None,
                    help="jax.distributed coordinator address host:port")
    se.add_argument("--dist-shard", choices=("auto", "bytes", "records"),
                    default="auto",
                    help="multi-host input sharding: 'bytes' = per-host "
                         "byte ranges (each host decodes ~1/H of the FASTQ; "
                         "uncompressed only), 'records' = record striding "
                         "(every host decodes everything, keeps 1/H); auto "
                         "picks bytes unless input is .gz")
    se.add_argument("--shard-index", type=int, default=0, metavar="N",
                    help="shard the index over N devices (for indexes larger "
                         "than one device's memory; must divide the local "
                         "device count; default 0 = replicated)")
    se.add_argument("--single-device", action="store_true",
                    help="map on one device even when more are attached")
    se.add_argument("--platform", choices=("auto", "cpu", "gpu"),
                    default="auto",
                    help="require this jax platform (cpu = host-only run, "
                         "e.g. debugging; gpu = fail unless a GPU is found; "
                         "default: jax's own choice)")
    se.add_argument("--profile", default=None, metavar="DIR",
                    help="write a jax.profiler trace (XProf/Perfetto) to DIR")
    se.add_argument("--oracle", action="store_true",
                    help="use the pure-CPU numpy oracle path (debug)")
    se.add_argument("--rg", default=None, help="read group id")
    return ap


def default_prefix(ref):
    return ref + ".btidx"


def cmd_index(args) -> int:
    from bitmapperbs_tpu.index.build import build_index, save_index

    prefix = args.prefix or default_prefix(args.ref)
    t0 = time.time()
    idx = build_index(args.ref, sa_rate=args.sa_rate, klt_k=args.klt_k,
                      build_mode=args.build_mode, jobs=args.threads)
    save_index(idx, prefix)
    sys.stderr.write(
        f"[bitmapperbs_tpu] indexed {sum(idx.genome.lengths)} bp "
        f"({len(idx.genome.names)} contigs) in {time.time() - t0:.1f}s "
        f"-> {prefix}.bin ({idx.nbytes() / 1e6:.0f} MB)\n")
    return 0


def make_config(args):
    from bitmapperbs_tpu.config import AlignerConfig

    e = args.max_errors
    if not 0 < e < 1 and e != int(e):
        raise SystemExit(f"error: -e must be an integer or a rate in (0,1), "
                         f"got {e}")
    cfg = AlignerConfig(
        max_errors=int(e),
        indels=not args.no_indels,
        non_directional=args.non_directional,
        paired=bool(args.pe),
        min_insert=args.min_insert,
        max_insert=args.max_insert,
        batch_size=args.batch_size,
        read_len_bucket=args.read_bucket,
        report_ambiguous=not args.suppress_ambiguous,
        sam_rg=args.rg,
    )
    if getattr(args, "flat_chunks", None) is not None:
        cfg = cfg.replace(flat_chunks=args.flat_chunks)
    if args.fast:
        cfg = cfg.replace(max_seed_occ=32, locate_budget=64, max_candidates=16)
    if args.sensitive:
        cfg = cfg.replace(max_seed_occ=512, locate_budget=512,
                          max_candidates=128)
    if getattr(args, "seed_ext", None) is not None:
        cfg = cfg.replace(seed_ext_max=args.seed_ext,
                          seed_ext_occ=args.seed_ext_occ)
    if getattr(args, "max_candidates", None) is not None:
        cfg = cfg.replace(max_candidates=args.max_candidates)
    cfg.validate()
    return cfg


def autotune_for_genome(cfg, args, genome_bp: int):
    """Genome-size config auto-tune (SURVEY.md C9).  At Gbp scale the
    3-letter alphabet makes T-rich seeds heavy-tailed: measured at 3.08 Gbp,
    mean candidate occupancy is ~259 entries/read and the default caps
    collapse recall to 0.59.  Adaptive seed extension (grow heavy seeds
    until <= 4 occurrences, <= 20 chars) cuts occupancy to ~78 and, with
    max_candidates 128, restores recall to 0.989 -- above even the
    cap-512 dense sweep (0.988) at a third of the candidate volume
    (PERF.md, 3 Gbp occupancy study).  Explicit flags always win."""
    if genome_bp <= 512_000_000:
        return cfg
    tuned = []
    # The small-genome presets are harmful at Gbp scale (measured on the
    # 3 Gbp repeat genome): --fast's tiny caps cut recall to 0.83, and
    # --sensitive's occ/LB flood gdrops 14% of reads into host dense reruns
    # (device recall 0.77).  Remap them onto the adaptive-seeding regime's
    # real lever, the candidate cap: the Kc sweep (Kc64 / 128 /
    # 256-2chunks) is monotone in recall.
    explicit_kc = getattr(args, "max_candidates", None) is not None
    if getattr(args, "fast", False):
        cfg = cfg.replace(max_seed_occ=128, locate_budget=256)
        if not explicit_kc:
            cfg = cfg.replace(max_candidates=64)
        tuned.append("fast -> Kc64 (Gbp regime)")
    if getattr(args, "sensitive", False):
        cfg = cfg.replace(max_seed_occ=128, locate_budget=256)
        if not explicit_kc:
            cfg = cfg.replace(max_candidates=256)
        if getattr(args, "flat_chunks", None) is None:
            cfg = cfg.replace(flat_chunks=max(cfg.flat_chunks, 2))
        tuned.append("sensitive -> Kc256/2-chunks (Gbp regime)")
    if getattr(args, "seed_ext", None) is None and cfg.seed_ext_max == 0:
        cfg = cfg.replace(seed_ext_max=20,
                          seed_ext_occ=getattr(args, "seed_ext_occ", 4))
        tuned.append(f"seed-ext {cfg.seed_ext_max} "
                     f"(occ<={cfg.seed_ext_occ})")
    if (getattr(args, "max_candidates", None) is None
            and not getattr(args, "fast", False)
            and not getattr(args, "sensitive", False)):
        cfg = cfg.replace(max_candidates=128)
        tuned.append("max-candidates 128")
    if (cfg.non_directional and cfg.locate_flat_cap == 0
            and getattr(args, "flat_chunks", None) is None):
        # 4 frames carry ~2x the SE occupancy (~156/read measured at
        # 3.08 Gbp with extension): above flat_cap_max=128, so PBAT would
        # gdrop ~22% of reads into dense reruns; 192 slots in 3
        # occupancy-bounded chunks measured gdrop-free at recall 0.9893
        cfg = cfg.replace(locate_flat_cap=192, flat_chunks=3)
        tuned.append("flat-cap 192 (3 chunks)")
    if tuned:
        sys.stderr.write(f"[bitmapperbs_tpu] {genome_bp/1e9:.2f} Gbp genome:"
                         f" auto-tuned {', '.join(tuned)}\n")
    return cfg


def cmd_resample(args) -> int:
    from bitmapperbs_tpu.index.build import load_index, save_index
    from bitmapperbs_tpu.index.resample import halve_sa_rate

    t0 = time.time()
    # mmap=False: densification rewrites cp_rows in place; a v4 mmap view
    # is read-only
    idx = load_index(args.prefix, mmap=False)
    old = idx.blocks[0].sa_rate
    halve_sa_rate(idx, args.sa_rate)
    save_index(idx, args.out or args.prefix)
    sys.stderr.write(
        f"[bitmapperbs_tpu] sa_rate {old} -> {idx.blocks[0].sa_rate} "
        f"({idx.nbytes() / 1e6:.0f} MB) in {time.time() - t0:.1f}s\n")
    return 0


MAX_READ_LEN = 1024   # short-read aligner (SURVEY.md: WGBS reads 50-300 bp)


def _budget_for(rate: float, length: int) -> int:
    """Per-read -e rate resolution: floor(rate*len) (SURVEY.md 2.1 'max
    errors or error rate').  A resolved budget beyond the config maximum
    fails loudly -- silently clamping would unmap reads the user's rate
    promises to tolerate."""
    b = max(1, int(rate * length))
    if b > 15:
        raise SystemExit(f"error: -e {rate} resolves to max_errors={b} for "
                         f"a {length} bp read (limit 15); use a smaller "
                         f"rate or an explicit integer -e")
    return b


def _cfg_key(cfg, rate, length: int):
    """Per-read static-config key (error budget, padded-length bucket).

    Budget: -e rate mode resolves floor(rate*len) per read.  Bucket: grows
    in 32-wide steps beyond the base bucket so a longer read later in the
    file maps in its own group instead of aborting the run; SURVEY.md 5.7
    'bucketing + masked batching'."""
    if length > MAX_READ_LEN:
        raise SystemExit(f"error: read of {length} bp exceeds the "
                         f"{MAX_READ_LEN} bp short-read limit")
    b = _budget_for(rate, length) if rate is not None else cfg.max_errors
    bk = max(cfg.read_len_bucket, -(-length // 32) * 32)
    return (b, bk)


def _map_grouped_se(run, cfg, rate, codes, quals, qnames):
    """Partition a batch by per-read (budget, bucket) and map each group
    with its own static config; records are reassembled in input order."""
    keys = [_cfg_key(cfg, rate, len(c)) for c in codes]
    uniq = sorted(set(keys))
    if len(uniq) == 1:
        b, bk = uniq[0]
        return run(cfg.replace(max_errors=b, read_len_bucket=bk),
                   codes, quals, qnames)
    recs = [None] * len(codes)
    for key in uniq:
        b, bk = key
        sel = [i for i, v in enumerate(keys) if v == key]
        sub = run(cfg.replace(max_errors=b, read_len_bucket=bk),
                  [codes[i] for i in sel],
                  [quals[i] for i in sel], [qnames[i] for i in sel])
        for i, r in zip(sel, sub):
            recs[i] = r
    return recs


def _map_grouped_pe(run, cfg, rate, prs, quals, qn):
    """PE analogue of _map_grouped_se: a pair's key is the max of its two
    mates' (equal-length mates -- the norm -- resolve exactly per read);
    two records per pair, input order preserved."""
    keys = []
    for a, b in prs:
        ka = _cfg_key(cfg, rate, len(a))
        kb = _cfg_key(cfg, rate, len(b))
        keys.append((max(ka[0], kb[0]), max(ka[1], kb[1])))
    uniq = sorted(set(keys))
    if len(uniq) == 1:
        b, bk = uniq[0]
        return run(cfg.replace(max_errors=b, read_len_bucket=bk),
                   prs, quals, qn)
    recs = [None] * (2 * len(prs))
    for key in uniq:
        b, bk = key
        sel = [i for i, v in enumerate(keys) if v == key]
        sub = run(cfg.replace(max_errors=b, read_len_bucket=bk),
                  [prs[i] for i in sel],
                  [quals[i] for i in sel], [qn[i] for i in sel])
        for j, i in enumerate(sel):
            recs[2 * i], recs[2 * i + 1] = sub[2 * j], sub[2 * j + 1]
    return recs


def _closing_iter(pf):
    """Yield from a Prefetcher, closing it when iteration stops for ANY
    reason (exhaustion, break, or an exception unwinding the caller) --
    the generator's finally runs when its frame is released, so the pump
    thread and its open FASTQ handle never outlive an aborted run."""
    try:
        yield from pf
    finally:
        pf.close()


def cmd_search(args) -> int:
    if getattr(args, "platform", "auto") != "auto":
        # must precede backend init (the config is read at first device use)
        import jax

        jax.config.update("jax_platforms", args.platform)
        try:
            backend = jax.default_backend()
        except RuntimeError:
            backend = "none"
        if backend != args.platform:
            sys.stderr.write(f"error: --platform {args.platform}: backend "
                             f"not available (jax has: {backend})\n")
            return 2
    import numpy as np

    from bitmapperbs_tpu import constants as K
    from bitmapperbs_tpu.index.build import load_index
    from bitmapperbs_tpu.io.fastq import FastqReader, read_pairs, write_fastq
    from bitmapperbs_tpu.io.sam import SamWriter
    from bitmapperbs_tpu.io.stats import MapStats
    from bitmapperbs_tpu.utils import dna

    if args.pe and not (args.seq1 and args.seq2):
        sys.stderr.write("error: --pe requires --seq1 and --seq2\n")
        return 2
    if not args.pe and not args.seq:
        sys.stderr.write("error: single-end search requires --seq\n")
        return 2

    # ref may be the FASTA path (resolves <ref>.btidx) or an index prefix
    # built with `index --prefix` (possibly with a suffix spelled out);
    # the .json manifest identifies both the v4 .bin and legacy .npz forms
    for prefix in (default_prefix(args.ref), args.ref,
                   re.sub(r"\.(bin|npz)$", "", args.ref)):
        if prefix is not None and os.path.exists(prefix + ".json"):
            break
    else:
        sys.stderr.write(f"error: index not found at "
                         f"{default_prefix(args.ref)}.json "
                         f"(run: bitmapperbs_tpu index {args.ref})\n")
        return 2
    if args.read_bucket is None:
        # size the padded-length bucket from the head of the input: mapping
        # cost is ~linear in the bucket, so a 100 bp library should not pay
        # for a 160-wide batch.  A longer read later in the file maps in a
        # grown per-batch bucket group (_cfg_key) instead of aborting.
        lens = []
        for p in ((args.seq1, args.seq2) if args.pe else (args.seq,)):
            head = next(iter(FastqReader(p, batch_size=1024)), None)
            if head is not None:
                lens.extend(len(c) for c in head.codes)
        mx = max(lens) if lens else 160
        args.read_bucket = max(32, -(-mx // 32) * 32)
        sys.stderr.write(f"[bitmapperbs_tpu] read bucket auto-sized to "
                         f"{args.read_bucket} (longest head read {mx} bp)\n")
    error_rate = None
    if 0 < args.max_errors < 1:
        # -e as an error RATE (SURVEY.md 2.1 "max errors or error rate"):
        # the budget resolves PER READ as floor(rate * length) (mixed-length
        # FASTQs get per-length budgets; each distinct budget is one static
        # jit config).  The base config uses the first read's length.
        first = next(iter(FastqReader(args.seq1 if args.pe else args.seq,
                                      batch_size=1)), None)
        if first is None or not len(first.codes):
            sys.stderr.write("error: empty FASTQ\n")
            return 2
        error_rate = args.max_errors
        args.max_errors = _budget_for(error_rate, len(first.codes[0]))
        sys.stderr.write(f"[bitmapperbs_tpu] -e {error_rate} -> per-read "
                         f"max_errors=floor(rate*len) (first read: "
                         f"{args.max_errors} at {len(first.codes[0])} bp)\n")
    cfg = make_config(args)
    idx = load_index(prefix)
    cfg = autotune_for_genome(cfg, args, int(sum(idx.genome.lengths)))

    # finalize worker pool (-t): spawned before any jax device op; workers
    # are numpy-only and share the genome via memmap (models/pool.py)
    pool = None
    if not args.oracle and args.threads > 1:
        from bitmapperbs_tpu.models.host import make_finalize_pool
        pool = make_finalize_pool(idx, cfg, args.threads)

    # multi-host (SURVEY.md 2.2/5.8): per-host FASTQ shard (byte ranges by
    # default -- each host decodes ~1/H; record striding for .gz), per-host
    # SAM shard, global stats psum at the end
    shard = None
    range_plan = None
    if args.dist_hosts > 1:
        from bitmapperbs_tpu.parallel import multihost
        pid, nproc = multihost.init_distributed(
            args.dist_coordinator, args.dist_hosts, args.dist_host_id)
        gz = any(str(p).endswith(".gz")
                 for p in (args.seq, args.seq1, args.seq2) if p)
        mode = args.dist_shard
        if mode == "auto":
            mode = "records" if gz else "bytes"
        elif mode == "bytes" and gz:
            # byte-range planning works on uncompressed offsets only; on a
            # .gz the plan would be computed in compressed space while the
            # reader seeks decompressed offsets -> silent record loss
            raise SystemExit("error: --dist-shard bytes requires "
                             "uncompressed FASTQ inputs (use 'records' or "
                             "'auto' for .gz)")
        if mode == "bytes":
            range_plan = multihost.plan_byte_range(
                args.seq1 if args.pe else args.seq, pid, nproc,
                path2=args.seq2 if args.pe else None)
        else:
            shard = multihost.HostShard(pid, nproc)
        if args.output != "-":
            args.output = multihost.shard_path(args.output, pid, nproc)
        sys.stderr.write(f"[bitmapperbs_tpu] host {pid}/{nproc} ({mode}) -> "
                         f"{args.output}\n")

    use_oracle = args.oracle
    if not use_oracle:
        import jax

        from bitmapperbs_tpu.index.device import upload_index
        from bitmapperbs_tpu.models.host import map_pairs, map_reads
        from bitmapperbs_tpu.utils.artifacts import enable_compile_cache

        # persistent XLA compilation cache: repeat runs with the same
        # shapes/config skip the mapping jits' compile
        enable_compile_cache()
        # multi-device: >1 local device -> shard_map over all of them
        # (SURVEY.md 3.5 / 7 Phase 5: the 1-host-all-devices production path);
        # index replicated by default, sharded with --shard-index N
        mappers = None
        n_local = len(jax.local_devices())
        if n_local > 1 and not args.single_device:
            from bitmapperbs_tpu.parallel.shard import make_cli_mappers
            mappers = make_cli_mappers(idx, cfg, shard_index=args.shard_index)
            dix = mappers.dix
            sys.stderr.write(
                f"[bitmapperbs_tpu] mapping over {n_local} devices "
                f"(mesh {dict(mappers.mesh.shape)})\n")
        elif args.shard_index:
            sys.stderr.write("error: --shard-index needs >1 local device\n")
            return 2
        else:
            dix = upload_index(idx)

    # per-group mapper sets (-e rate budgets / grown length buckets),
    # sharing the base mappers' mesh + uploaded index
    _group_mappers = {}

    def mappers_for(c):
        key = (c.max_errors, c.read_len_bucket)
        if mappers is None or key == (cfg.max_errors, cfg.read_len_bucket):
            return mappers
        if key not in _group_mappers:
            from bitmapperbs_tpu.parallel.shard import make_cli_mappers
            _group_mappers[key] = make_cli_mappers(
                idx, c, shard_index=args.shard_index, reuse=mappers)
        return _group_mappers[key]

    bam = args.bam or args.output.endswith(".bam")
    if bam and args.output == "-":
        sys.stderr.write("error: --bam requires -o FILE\n")
        return 2

    cursor_path = (args.output + ".cursor") if args.output != "-" else None
    resume = {"record": 0, "offset": 0, "out_pos": 0}
    if range_plan is not None:   # shard start; a cursor overrides it below
        resume = {"record": range_plan.start_record,
                  "offset": range_plan.offset,
                  "offset2": range_plan.offset2, "out_pos": 0}
    resumed = False              # cursor-resumed (vs fresh, possibly sharded)
    if args.resume and cursor_path and os.path.exists(cursor_path):
        resumed = True
        with open(cursor_path) as f:
            resume = json.load(f)
        # a crash can land between the output flush and the cursor write;
        # truncating the output to the cursor's byte position makes the
        # (flush, cursor) pair effectively atomic -- no duplicate records.
        # save_cursor() flushes the writer first, so out_pos is a record
        # boundary for SAM and a BGZF-block + record boundary for BAM
        # (BgzfWriter.flush), making the truncate-and-append sound for both.
        if resume.get("out_pos") is not None and os.path.exists(args.output):
            with open(args.output, "r+b") as f:
                f.truncate(resume["out_pos"])
        sys.stderr.write(f"[bitmapperbs_tpu] resuming at record "
                         f"{resume['record']}\n")

    out_fh = sys.stdout if args.output == "-" else open(
        args.output,
        ("ab" if bam else "a") if resumed else ("wb" if bam else "w"))
    stats = MapStats()
    unmapped = []
    ambiguous = []
    t0 = time.time()

    cl = "bitmapperbs_tpu " + " ".join(sys.argv[1:])
    if bam:
        from bitmapperbs_tpu.io.bam import BamWriter
        writer = BamWriter(out_fh, idx.genome.names, idx.genome.lengths,
                           rg=args.rg, cl=cl, write_header=not resumed)
    elif not resumed:
        writer = SamWriter(out_fh, idx.genome.names, idx.genome.lengths,
                           rg=args.rg, cl=cl)
    else:
        writer = SamWriter.__new__(SamWriter)
        writer.fh = out_fh

    def emit(records, reads, qnames, quals):
        for rec, r, qn, q in zip(records, reads, qnames, quals):
            writer.write(rec)
            stats.add_record(rec)
            if args.unmapped_out and rec.flag & K.FLAG_UNMAPPED:
                unmapped.append((r, qn, q))
            if args.ambiguous_out and rec.mapq == 0 \
                    and not rec.flag & K.FLAG_UNMAPPED:
                ambiguous.append((r, qn, q))

    def save_cursor(record, offset, offset2=0):
        if cursor_path:
            writer.flush()  # out_pos must be a record/BGZF-block boundary
            # atomic replace: a SIGKILL mid-write must never leave a torn
            # cursor file (resume would crash parsing it)
            with open(cursor_path + ".tmp", "w") as f:
                json.dump({"record": record, "offset": offset,
                           "offset2": offset2,
                           "out_pos": out_fh.tell()}, f)
            os.replace(cursor_path + ".tmp", cursor_path)

    from bitmapperbs_tpu.utils.profiling import device_trace
    trace_ctx = device_trace(args.profile)
    trace_ctx.__enter__()

    if not args.pe:
        reader = FastqReader(
            args.seq, cfg.batch_size, args.phred64,
            resume_offset=resume["offset"], resume_record=resume["record"],
            limit_offset=(range_plan.limit_offset if range_plan is not None
                          else None))
        # group `threads` reader batches per call so the finalize pool has
        # cross-batch work; cursor granularity becomes the group
        group_n = max(1, args.threads)
        gbuf: list = []
        last = [None]

        def flush_group():
            if not gbuf:
                return
            codes = [c for g in gbuf for c in g[0]]
            qnames = [c for g in gbuf for c in g[1]]
            quals = [c for g in gbuf for c in g[2]]
            gbuf.clear()
            if use_oracle:
                from bitmapperbs_tpu.oracle.pipeline import map_batch_se
                run = lambda c, cs, qs, ns: map_batch_se(idx, c, cs, qs, ns)
            else:
                run = lambda c, cs, qs, ns: map_reads(
                    idx, dix, c, cs, qs, ns, stats=stats, pool=pool,
                    mappers=mappers_for(c))
            recs = _map_grouped_se(run, cfg, error_rate, codes, quals,
                                   qnames)
            emit(recs, codes, qnames, quals)
            out_fh.flush()
            save_cursor(*last[0])

        from bitmapperbs_tpu.io.fastq import Prefetcher
        for batch in _closing_iter(Prefetcher(reader)):
            codes, qnames, quals = batch.codes, batch.qnames, batch.quals
            last[0] = (batch.start_record + len(batch), batch.end_offset)
            if shard is not None:
                codes, qnames, quals = shard.filter_batch(
                    codes, qnames, quals, batch.start_record)
                if not codes:
                    if not gbuf:
                        save_cursor(*last[0])
                    continue
            gbuf.append((codes, qnames, quals))
            if len(gbuf) >= group_n:
                flush_group()
        flush_group()
    else:
        limit_records = None
        if range_plan is not None:
            limit_records = range_plan.n_records - (
                resume["record"] - range_plan.start_record)
        from bitmapperbs_tpu.io.fastq import Prefetcher
        for b1, b2 in _closing_iter(Prefetcher(read_pairs(
                args.seq1, args.seq2, cfg.batch_size, args.phred64,
                resume_offsets=(resume["offset"], resume.get("offset2", 0)),
                resume_record=resume["record"],
                limit_records=limit_records))):
            prs = list(zip(b1.codes, b2.codes))
            quals = list(zip(b1.quals, b2.quals))
            qn = b1.qnames
            # cursor from the UNfiltered batch: under --dist-hosts the shard
            # filter drops records owned by other hosts, but the resume
            # cursor must still advance by the full batch so record indices
            # and byte offsets stay aligned (shard ownership is by global
            # record index)
            cursor = (b1.start_record + len(b1), b1.end_offset, b2.end_offset)
            if shard is not None:
                prs, qn, quals = shard.filter_batch(
                    prs, qn, quals, b1.start_record)
                if not prs:
                    save_cursor(*cursor)
                    continue
            if use_oracle:
                from bitmapperbs_tpu.oracle.paired import map_batch_pe
                run = lambda c, ps, qs, ns: map_batch_pe(idx, c, ps, qs, ns)
            else:
                run = lambda c, ps, qs, ns: map_pairs(
                    idx, dix, c, ps, qs, ns, stats=stats, pool=pool,
                    mappers=mappers_for(c))
            recs = _map_grouped_pe(run, cfg, error_rate, prs, quals, qn)
            flat_reads = [r for p in prs for r in p]
            flat_qn = [q_ for q_ in qn for _ in (0, 1)]
            flat_q = [q for p in quals for q in p]
            emit(recs, flat_reads, flat_qn, flat_q)
            out_fh.flush()
            save_cursor(*cursor)

    trace_ctx.__exit__(None, None, None)
    if args.profile:
        sys.stderr.write(f"[bitmapperbs_tpu] profiler trace -> "
                         f"{args.profile}\n")
    if bam:
        writer.close()
    wall = time.time() - t0
    stats.report(wall_s=wall)
    if shard is not None:
        from bitmapperbs_tpu.parallel.multihost import global_stats
        g = global_stats(stats)
        sys.stderr.write(f"[bitmapperbs_tpu] global (all {args.dist_hosts} "
                         f"hosts): {g}\n")
    if args.stats_json:
        # with the run's resolved base config (read bucket, autotune, flat
        # cap inputs), so a caller can rebuild exactly what was mapped
        with open(args.stats_json, "w") as f:
            f.write(stats.to_json(config=dataclasses.asdict(cfg)) + "\n")
    if args.unmapped_out and unmapped:
        write_fastq(args.unmapped_out, [u[0] for u in unmapped],
                    [u[1] for u in unmapped], [u[2] for u in unmapped])
    if args.ambiguous_out and ambiguous:
        write_fastq(args.ambiguous_out, [u[0] for u in ambiguous],
                    [u[1] for u in ambiguous], [u[2] for u in ambiguous])
    if out_fh is not sys.stdout:
        out_fh.close()
    if cursor_path and os.path.exists(cursor_path):
        os.unlink(cursor_path)  # completed: drop the resume cursor
    if pool is not None:
        pool.terminate()
    return 0


def main(argv=None) -> int:
    argv = _translate_legacy(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    if args.cmd == "index":
        return cmd_index(args)
    if args.cmd == "resample":
        return cmd_resample(args)
    return cmd_search(args)


if __name__ == "__main__":
    sys.exit(main())
