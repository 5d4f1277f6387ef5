"""Smoke run of the aligner on one GPU at Arabidopsis scale.

    python chip_smoke.py              # one GPU, all phases below
    python chip_smoke.py --four-gpus  # only the four-GPU phase

Phases (any failure ends the run with a nonzero exit; nothing is caught):
  device   card name and power limit (nvidia-smi), jax devices and version;
           exits 2 unless jax's platform is gpu.
  setup    builds the native library from the tracked sources, writes a
           seeded synthetic genome with the sequence lengths of Arabidopsis
           thaliana TAIR10 (Chr1-5, ChrM, ChrC: 119.7 Mbp) and indexes it
           with `python -m bitmapperbs_tpu index ref.fa -t 2`.
  reads    simulates 150 bp bisulfite reads with the truth in the qname:
           SE 65,536 (.fq.gz), PE 32,768 pairs (insert 200-500), PBAT
           32,768 (all four strands).
  search   maps each library through cli.main on the GPU (-t <cores>,
           --stats-json): SE -> SAM, PE -> SAM (--max 600), PBAT -> BAM.
  check    for 512 seeded reads (pairs) per library the records must equal
           the --oracle path's byte for byte; prints recall and precision
           against the truth, mapped fraction, proper pairs, gdrop count.
  kernels  each GPU kernel against its jnp spec at m = 160, e in {4, 6} and
           a real batch's lane count: bitwise parity, device times, and the
           SE / PE device pipelines timed with the kernels and with the spec.

The four-GPU phase maps the SE and PE reads on one device, on four with the
index replicated, and with it sharded 2x2 and 1x4; all SAM records must be
byte-identical.  After every index upload it prints, per device, the bytes
of the index shards placed there and the growth of its bytes_in_use.

Times printed here are smoke timings of one run, labelled with the card and
its power limit; they are not a benchmark.  The last stdout line is
{"ok": true, "device": {"platform", "kind", "count"}}.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# Arabidopsis thaliana TAIR10 sequence lengths (bp)
TAIR10 = (("Chr1", 30_427_671), ("Chr2", 19_698_289), ("Chr3", 23_459_830),
          ("Chr4", 18_585_056), ("Chr5", 26_975_502), ("ChrM", 366_924),
          ("ChrC", 154_478))
READ_LEN = 150
SAMPLE = 512
MAX_INSERT = 600


def log(msg: str) -> None:
    print(msg, flush=True)


# --------------------------------------------------------------------------
# set-up: native library, genome, index, reads
# --------------------------------------------------------------------------

def setup(work: str, seed: int) -> str:
    import numpy as np

    from bitmapperbs_tpu.utils.simulate import random_genome_fasta

    t0 = time.perf_counter()
    subprocess.run(["make", "-B", "-C",
                    os.path.join(ROOT, "bitmapperbs_tpu", "index",
                                 "sais_native")],
                   check=True, stdout=subprocess.DEVNULL)
    log(f"[setup] native library built in {time.perf_counter() - t0:.1f} s")
    ref = os.path.join(work, "ref.fa")
    t0 = time.perf_counter()
    names = [n for n, _ in TAIR10]
    lens = [n for _, n in TAIR10]
    with open(ref, "w") as f:
        f.write(random_genome_fasta(np.random.default_rng(seed), lens,
                                    gc=0.36, names=names))
    log(f"[setup] genome {sum(lens)} bp ({len(lens)} sequences, TAIR10 "
        f"lengths) written in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-m", "bitmapperbs_tpu", "index", ref,
                    "-t", "2"], check=True, cwd=ROOT)
    log(f"[setup] index built in {time.perf_counter() - t0:.1f} s "
        f"(set-up, not mapping time)")
    return ref


def _write_fq(path, sims, qnames):
    from bitmapperbs_tpu.io.fastq import write_fastq

    write_fastq(path, [s.codes for s in sims], qnames,
                [s.qual for s in sims])


def make_reads(work: str, genome, seed: int, n_se: int, n_pe: int,
               n_pb: int) -> dict:
    """Simulated libraries; qnames carry the truth (contig, coord, strand)."""
    from bitmapperbs_tpu.utils.simulate import simulate_pairs, simulate_reads

    t0 = time.perf_counter()
    kw = dict(read_len=READ_LEN, sub_rate=0.005, indel_rate=0.001)
    libs = {}
    for name, n, protos, s in (("se", n_se, ("OT", "OB"), 1),
                               ("pbat", n_pb, ("OT", "OB", "CTOT", "CTOB"),
                                3)):
        sims = simulate_reads(genome, n, seed=seed + s, protocols=protos,
                              **kw)
        qn = [f"r{i}_{r.contig}_{r.coord}_{r.strand}"
              for i, r in enumerate(sims)]
        fq = os.path.join(work, f"{name}.fq.gz")
        _write_fq(fq, sims, qn)
        libs[name] = dict(fq=[fq], sims=sims, qnames=qn)
    pairs = simulate_pairs(genome, n_pe, seed=seed + 2, min_insert=200,
                           max_insert=500, **kw)
    qn = [f"p{i}_{a.contig}_{a.coord}_{a.strand}_{b.coord}_{b.strand}"
          for i, (a, b) in enumerate(pairs)]
    fqs = [os.path.join(work, f"pe_{k}.fq.gz") for k in (1, 2)]
    for k, fq in enumerate(fqs):
        _write_fq(fq, [p[k] for p in pairs], qn)
    libs["pe"] = dict(fq=fqs, sims=pairs, qnames=qn)
    log(f"[reads] SE {len(libs['se']['sims'])}, PE {len(pairs)} pairs, "
        f"PBAT {len(libs['pbat']['sims'])} reads of {READ_LEN} bp simulated "
        f"in {time.perf_counter() - t0:.1f} s")
    return libs


def search_args(ref: str, lib: str, fqs, out: str) -> list[str]:
    if lib == "pe":
        return ["search", ref, "--pe", "--seq1", fqs[0], "--seq2", fqs[1],
                "--max", str(MAX_INSERT), "-o", out]
    extra = ["--pbat"] if lib == "pbat" else []
    return ["search", ref, "--seq", fqs[0], "-o", out] + extra


# --------------------------------------------------------------------------
# output parsing and checks
# --------------------------------------------------------------------------

def records(path: str) -> tuple[list[str], dict]:
    """Alignment records by qname (SAM lines, or raw BAM record bytes) and
    the reference names in header order."""
    from bitmapperbs_tpu.io.bam import bam_record_fields, read_bam_records

    by_q: dict = {}
    if path.endswith(".bam"):
        text, recs = read_bam_records(path)
        for r in recs:
            by_q.setdefault(bam_record_fields(r)[0], []).append(r)
    else:
        text = ""
        with open(path) as f:
            for line in f:
                if line.startswith("@"):
                    text += line
                else:
                    by_q.setdefault(line.split("\t", 1)[0], []).append(line)
    names = [f.split("SN:")[1].split("\t")[0] for f in text.splitlines()
             if f.startswith("@SQ")]
    return names, by_q


def _fields(rec, names):
    """(flag, rname, 0-based pos, mapq) of a SAM line or raw BAM record."""
    from bitmapperbs_tpu.io.bam import bam_record_fields

    if isinstance(rec, bytes):
        _, flag, rid, pos, mapq = bam_record_fields(rec)
        return flag, names[rid] if rid >= 0 else "*", pos, mapq
    f = rec.split("\t", 5)
    return int(f[1]), f[2], int(f[3]) - 1, int(f[4])


def accuracy(lib: str, by_q: dict, names, ref_names, e: int) -> dict:
    """Recall / precision against the qname truth (correct = MAPQ > 0 on the
    true contig and strand within e of the true leftmost coordinate)."""
    total = correct = unique = mapped = proper = 0
    for q, recs in by_q.items():
        t = q.split("_")
        for rec in recs:
            flag, rname, pos, mapq = _fields(rec, names)
            if lib == "pe":
                coord, strand = ((int(t[2]), t[3]) if flag & 0x40
                                 else (int(t[4]), t[5]))
                proper += bool(flag & 0x2)
            else:
                coord, strand = int(t[2]), t[3]
            total += 1
            if flag & 0x4:
                continue
            mapped += 1
            if mapq == 0:
                continue
            unique += 1
            correct += (rname == ref_names[int(t[1])]
                        and abs(pos - coord) <= e
                        and bool(flag & 0x10) == (strand in ("OB", "CTOT")))
    out = {"records": total, "recall": correct / total,
           "precision": correct / max(unique, 1),
           "mapped_fraction": mapped / total}
    if lib == "pe":
        out["proper_pair_fraction"] = proper / total
    return out


def oracle_check(main, ref: str, lib: str, spec: dict, by_q: dict,
                 work: str, seed: int) -> int:
    """Map SAMPLE seeded reads (pairs) through --oracle; their records must
    equal the device run's byte for byte."""
    import numpy as np

    from bitmapperbs_tpu.io.fastq import write_fastq

    n = len(spec["qnames"])
    pick = np.sort(np.random.default_rng(seed).choice(
        n, min(SAMPLE, n), replace=False))
    qn = [spec["qnames"][i] for i in pick]
    fqs = []
    for k in range(len(spec["fq"])):
        sims = [spec["sims"][i][k] if lib == "pe" else spec["sims"][i]
                for i in pick]
        fqs.append(os.path.join(work, f"{lib}_oracle_{k}.fq"))
        write_fastq(fqs[-1], [s.codes for s in sims], qn,
                    [s.qual for s in sims])
    out = os.path.join(work, f"{lib}_oracle" + (".bam" if lib == "pbat"
                                                  else ".sam"))
    t0 = time.perf_counter()
    rc = main(search_args(ref, lib, fqs, out) + ["--oracle"])
    assert rc == 0, f"oracle search exited {rc}"
    _, orc = records(out)
    assert sorted(orc) == sorted(qn), "oracle output is not the sample"
    bad = [q for q in qn if orc[q] != by_q.get(q)]
    assert not bad, (f"{lib}: {len(bad)} of {len(qn)} sampled records "
                     f"differ from the oracle, first {bad[0]}:\n"
                     f"  device {by_q.get(bad[0])}\n  oracle {orc[bad[0]]}")
    log(f"[check] {lib}: {len(qn)} sampled {'pairs' if lib == 'pe' else 'reads'}"
        f" byte-identical to --oracle ({time.perf_counter() - t0:.1f} s)")
    return len(qn)


class CompileClock:
    """Seconds JAX spends compiling (tracing, lowering, backend compile)."""

    def __init__(self):
        import jax

        self.total = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event, duration, **_):
        if event.startswith("/jax/core/compile/"):
            self.total += duration


# --------------------------------------------------------------------------
# kernel phase
# --------------------------------------------------------------------------

def kernel_inputs(rng, L: int, m: int, e: int, ncols: int):
    """Lanes like a real batch's: windows at anchor - e and bisulfite reads
    copied from them with a substitution rate, one indel and short reads,
    plus unrelated reads, so both verification branches are taken."""
    import numpy as np

    from bitmapperbs_tpu import constants as K

    Ww = -(-ncols // 32)
    win = rng.integers(0, 4, (L, Ww * 32), dtype=np.uint8)
    win[rng.random(win.shape) < 0.002] = K.N_CODE
    j = np.arange(m)
    shift = rng.integers(-1, 2, L)
    cut = rng.integers(0, m, L)
    src = e + j[None, :] + np.where(j[None, :] >= cut[:, None],
                                    shift[:, None], 0)
    reads = np.take_along_axis(win, np.clip(src, 0, Ww * 32 - 1), axis=1)
    sub = rng.random(reads.shape) < 0.01
    reads[sub] = (reads[sub] + 1) % 4
    reads[(reads == K.C) & (rng.random(reads.shape) < 0.7)] = K.T
    other = rng.random(L) < 0.2
    reads[other] = rng.integers(0, 4, (int(other.sum()), m), dtype=np.uint8)
    lengths = np.where(rng.random(L) < 0.1, rng.integers(m // 2, m, L), m)
    reads[j[None, :] >= lengths[:, None]] = K.N_CODE
    return win, reads, lengths.astype(np.int32)


def device_ms(fn, args, reps: int = 5) -> float:
    """Median wall ms of fn(*args) to block_until_ready (compiled first)."""
    import jax
    import numpy as np

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


def kernel_phase(lanes_verify: int, lanes_scan: int, seed: int) -> list[dict]:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from bitmapperbs_tpu.ops import kernels, verify

    rng = np.random.default_rng(seed)
    m = 160
    rows = []
    for e in (4, 6):
        for name, L, ncols in (
                ("verify_fused", lanes_verify, m + 2 * e),
                ("myers_scan", lanes_scan, MAX_INSERT + 1 + m + 2 * e)):
            win, reads, lengths = kernel_inputs(rng, L, m, e, ncols)
            wp = verify.pack_codes(jnp.asarray(win))
            if name == "verify_fused":
                args = (wp, verify.pack_codes(jnp.asarray(reads)),
                        verify.length_mask(jnp.asarray(lengths), m))
                spec = jax.jit(verify.fused_verify, static_argnums=(3, 4, 5))
                kern = kernels.verify_fused_kernel
                static = (m, ncols, e)
            else:
                args = (wp, *verify.build_peq(jnp.asarray(reads),
                                              jnp.asarray(lengths), m))
                spec = jax.jit(verify.myers_scan, static_argnums=(3, 4))
                kern = kernels.myers_scan_kernel
                static = (m, ncols)
            want = np.asarray(spec(*args, *static))
            got = np.asarray(kern(*args, *static))
            assert got.shape == want.shape and np.array_equal(got, want), (
                f"{name} e={e}: kernel differs from the spec in "
                f"{int((got != want).sum())} of {want.size} values")
            row = {"kernel": name, "m": m, "e": e, "lanes": L,
                   "ncols": ncols, "bitwise_equal": True,
                   "spec_ms": device_ms(lambda *a: spec(*a, *static), args),
                   "kernel_ms": device_ms(lambda *a: kern(*a, *static), args)}
            log(f"[kernels] {json.dumps(row)}")
            rows.append(row)
    return rows


def e2e_phase(idx, cfgs: dict, libs: dict, n_batches: int) -> list[dict]:
    """The SE and PE device pipelines (map_batch_device / map_batch_pe_device,
    the smoke's own reads and configs) with the kernels and with the spec:
    parity of every output and ms per batch (spec, kernel, kernel, spec)."""
    import jax
    import numpy as np

    from bitmapperbs_tpu.index.device import upload_index
    from bitmapperbs_tpu.models.aligner import map_batch_device
    from bitmapperbs_tpu.models.host import prepare_batch
    from bitmapperbs_tpu.models.paired import map_batch_pe_device

    dix = upload_index(idx)
    rows = []
    for lib in ("se", "pe"):
        cfg = cfgs[lib]
        B, mp = cfg.batch_size, cfg.read_len_bucket
        sims = libs[lib]["sims"]
        batches = []
        for b in range(n_batches):
            chunk = sims[b * B:(b + 1) * B]
            if lib == "pe":
                a1, l1 = prepare_batch([p[0].codes for p in chunk], mp, B)
                a2, l2 = prepare_batch([p[1].codes for p in chunk], mp, B)
                batches.append(jax.device_put((a1, l1, a2, l2)))
            else:
                batches.append(jax.device_put(
                    prepare_batch([s.codes for s in chunk], mp, B)))
        fn = map_batch_pe_device if lib == "pe" else map_batch_device
        variants = {"kernel": cfg, "spec": cfg.replace(use_pallas=False)}
        outs = {k: jax.device_get(fn(dix, c, *batches[0]))
                for k, c in variants.items()}
        for (path, a), b in zip(
                jax.tree_util.tree_leaves_with_path(outs["spec"]),
                jax.tree_util.tree_leaves(outs["kernel"])):
            assert np.array_equal(a, b), f"{lib} {path}: kernel != spec"
        ms = {k: [] for k in variants}
        for k in ("spec", "kernel", "kernel", "spec"):
            t0 = time.perf_counter()
            jax.block_until_ready([fn(dix, variants[k], *a)
                                   for a in batches])
            ms[k].append((time.perf_counter() - t0) * 1e3 / n_batches)
        row = {"pipeline": lib, "batches": n_batches, "batch": B,
               "outputs_equal": True,
               "spec_ms_per_batch": ms["spec"],
               "kernel_ms_per_batch": ms["kernel"]}
        log(f"[kernels] e2e {json.dumps(row)}")
        rows.append(row)
    return rows


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------

def one_gpu(args, work: str, label: str) -> dict:
    import jax

    from bitmapperbs_tpu.cli import main
    from bitmapperbs_tpu.config import AlignerConfig
    from bitmapperbs_tpu.index.build import load_index

    clock = CompileClock()
    ref = setup(work, args.seed)
    idx = load_index(ref + ".btidx")
    libs = make_reads(work, idx.genome, args.seed, 65_536, 32_768, 32_768)
    threads = str(os.cpu_count() or 1)
    summary = {"searches": {}}
    cfgs = {}
    for lib in ("se", "pe", "pbat"):
        spec = libs[lib]
        out = os.path.join(work, lib + (".bam" if lib == "pbat" else ".sam"))
        stats = os.path.join(work, lib + ".stats.json")
        c0 = clock.total
        t0 = time.perf_counter()
        assert main(search_args(ref, lib, spec["fq"], out) + [
            "--platform", "gpu", "-t", threads, "--stats-json", stats]) == 0, (
            f"{lib} search failed")
        wall = time.perf_counter() - t0
        names, by_q = records(out)
        with open(stats) as f:
            st = json.load(f)
        cfgs[lib] = AlignerConfig.from_dict(st["config"])
        row = {"wall_s": round(wall, 2),
               "compile_s": round(clock.total - c0, 2),
               "reads": st["total"], "gdrop_reads": st["gdrop_reads"],
               **accuracy(lib, by_q, names, idx.genome.names,
                          cfgs[lib].max_errors)}
        log(f"[search] {lib}: {json.dumps(row)}  (smoke timing on {label}; "
            f"not a benchmark)")
        row["oracle_sample"] = oracle_check(main, ref, lib, spec, by_q,
                                            work, args.seed + 100)
        summary["searches"][lib] = row
    summary["peak_bytes_in_use"] = \
        jax.devices()[0].memory_stats()["peak_bytes_in_use"]
    log(f"[search] peak_bytes_in_use {summary['peak_bytes_in_use']} "
        f"after all searches")
    log(f"[search] compile seconds so far {clock.total:.1f}")

    flat = cfgs["se"].resolve_flat_cap(idx.genome.length, 2)
    summary["kernels"] = kernel_phase(cfgs["se"].batch_size * flat,
                                      cfgs["pe"].batch_size, args.seed + 200)
    summary["e2e"] = e2e_phase(idx, cfgs, libs, n_batches=4)
    summary["compile_s"] = round(clock.total, 2)
    return summary


def four_gpus(args, work: str) -> dict:
    import jax

    from bitmapperbs_tpu.cli import main
    from bitmapperbs_tpu.config import AlignerConfig
    from bitmapperbs_tpu.index.build import load_index
    from bitmapperbs_tpu.index.device import upload_index
    from bitmapperbs_tpu.parallel.shard import make_cli_mappers

    devs = jax.local_devices()
    assert len(devs) == 4, f"--four-gpus needs 4 devices, found {len(devs)}"
    ref = setup(work, args.seed)
    idx = load_index(ref + ".btidx")
    libs = make_reads(work, idx.genome, args.seed, 65_536, 32_768, 0)
    summary = {}

    def in_use():
        return [(d.memory_stats() or {}).get("bytes_in_use", 0)
                for d in devs]

    first = {}
    for mode, extra, shard in (("1 device", ["--single-device"], None),
                               ("4 replicated", [], 0),
                               ("2x2 sharded index", ["--shard-index", "2"],
                                2),
                               ("1x4 sharded index", ["--shard-index", "4"],
                                4)):
        base = in_use()
        dix = (upload_index(idx) if shard is None
               else make_cli_mappers(idx, AlignerConfig(),
                                     shard_index=shard).dix)
        jax.block_until_ready(dix)
        shards = dict.fromkeys(devs, 0)
        for leaf in jax.tree_util.tree_leaves(dix):
            for sh in leaf.addressable_shards:
                shards[sh.device] += sh.data.nbytes
        row = {"index_shard_bytes": list(shards.values()),
               "bytes_in_use_delta": [a - b for a, b in
                                      zip(in_use(), base)]}
        log(f"[4gpu] {mode}: after upload, per device {json.dumps(row)}")
        del dix
        for lib in ("se", "pe"):
            out = os.path.join(work, f"{lib}_{shard}.sam")
            t0 = time.perf_counter()
            assert main(search_args(ref, lib, libs[lib]["fq"], out) + [
                "--platform", "gpu"] + extra) == 0, (
                f"{mode} {lib} failed")
            _, by_q = records(out)
            first.setdefault(lib, by_q)
            assert by_q == first[lib], f"{mode} {lib}: SAM differs from 1 device"
            row[f"{lib}_wall_s"] = round(time.perf_counter() - t0, 2)
        log(f"[4gpu] {mode}: SE and PE SAM records byte-identical to 1 "
            f"device  {json.dumps(row)}")
        summary[mode] = row
    return summary


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the four-GPU phase (needs 4 devices)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the genome, the reads and the samples")
    ap.add_argument("--out", default=None,
                    help="also write the summary JSON into this directory")
    args = ap.parse_args()

    from bitmapperbs_tpu.utils.profiling import gpu_cards

    smi = gpu_cards()
    log("card (nvidia-smi name, power.limit):")
    log(smi)
    import jax

    log(f"jax {jax.__version__}: {jax.devices()}")
    platform = jax.devices()[0].platform
    if platform != "gpu":
        sys.stderr.write(f"chip_smoke: jax platform is {platform!r}, not "
                         f"gpu; nothing run\n")
        return 2

    from bitmapperbs_tpu.utils.artifacts import artifacts_dir, \
        enable_compile_cache

    enable_compile_cache()
    work = os.path.join(artifacts_dir(), "chip_smoke")
    os.makedirs(work, exist_ok=True)
    label = smi.splitlines()[0]
    t0 = time.perf_counter()
    if args.four_gpus:
        summary = four_gpus(args, work)
    else:
        summary = one_gpu(args, work, label)
    summary["card"] = smi
    summary["total_s"] = round(time.perf_counter() - t0, 1)
    log(f"[done] {summary['total_s']} s on {label}")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        name = "chip_smoke_4gpu.json" if args.four_gpus else "chip_smoke.json"
        with open(os.path.join(args.out, name), "w") as f:
            json.dump(summary, f, indent=1)
    d = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": d[0].platform, "kind": d[0].device_kind,
        "count": len(d)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
