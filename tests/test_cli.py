"""CLI surface tests (index + search round trip, cursor resume)."""
import importlib
import json
import os
import sys

import numpy as np
import pytest

from bitmapperbs_tpu.cli import main
from bitmapperbs_tpu.config import AlignerConfig
from bitmapperbs_tpu.index.build import parse_fasta
from bitmapperbs_tpu.io.fastq import write_fastq
from bitmapperbs_tpu.utils.simulate import random_genome_fasta, simulate_reads


@pytest.fixture
def workdir(tmp_path, rng):
    fa = random_genome_fasta(rng, contigs=(4000,))
    ref = tmp_path / "ref.fa"
    ref.write_text(fa)
    g = parse_fasta(fa)
    sims = simulate_reads(g, 30, read_len=80, seed=4, sub_rate=0.01)
    write_fastq(tmp_path / "reads.fq", [s.codes for s in sims],
                quals=[s.qual for s in sims])
    return tmp_path, sims


def test_index_and_search_se(workdir, capsys):
    d, sims = workdir
    assert main(["index", str(d / "ref.fa")]) == 0
    out = d / "out.sam"
    assert main(["search", str(d / "ref.fa"), "--seq", str(d / "reads.fq"),
                 "-o", str(out), "--read-bucket", "96",
                 "--batch-size", "30", "--oracle",
                 "--stats-json", str(d / "s.json")]) == 0
    lines = out.read_text().splitlines()
    assert lines[0].startswith("@HD")
    body = [l for l in lines if not l.startswith("@")]
    assert len(body) == 30
    stats = json.loads((d / "s.json").read_text())
    assert stats["mapped"] >= 28
    # the resolved config rides along and rebuilds a hashable config
    cfg = AlignerConfig.from_dict(stats["config"])
    assert (cfg.read_len_bucket, cfg.batch_size) == (96, 30)
    assert hash(cfg) == hash(cfg.replace())
    assert not os.path.exists(str(out) + ".cursor")


def test_search_bam_output(workdir):
    d, sims = workdir
    main(["index", str(d / "ref.fa")])
    out = d / "out.bam"
    assert main(["search", str(d / "ref.fa"), "--seq", str(d / "reads.fq"),
                 "-o", str(out), "--read-bucket", "96",
                 "--batch-size", "30", "--oracle"]) == 0
    from tests.test_bam import decode_bam
    text, refs, recs = decode_bam(out.read_bytes())
    assert refs[0][0] == "chr1"
    assert len(recs) == 30
    # --bam without a file errors cleanly
    assert main(["search", str(d / "ref.fa"), "--seq", str(d / "reads.fq"),
                 "--bam", "--oracle"]) == 2


def test_platform_flag(workdir):
    # --platform cpu runs the device pipeline on the host backend (conftest
    # already forces cpu; this asserts the flag parses and maps end-to-end)
    d, _ = workdir
    main(["index", str(d / "ref.fa")])
    out = d / "plat.sam"
    assert main(["search", str(d / "ref.fa"), "--seq", str(d / "reads.fq"),
                 "-o", str(out), "--read-bucket", "96", "--batch-size", "30",
                 "--platform", "cpu"]) == 0
    body = [l for l in out.read_text().splitlines() if not l.startswith("@")]
    assert len(body) == 30


def test_legacy_flag_spelling(workdir):
    d, _ = workdir
    assert main(["--index", str(d / "ref.fa")]) == 0


def test_search_pe_validation(workdir, capsys):
    d, _ = workdir
    main(["index", str(d / "ref.fa")])
    assert main(["search", str(d / "ref.fa"), "--pe"]) == 2
    assert main(["search", str(d / "ref.fa")]) == 2


def test_cursor_resume(workdir):
    d, sims = workdir
    main(["index", str(d / "ref.fa")])
    out = d / "res.sam"
    # first run with small batches, then simulate interruption by replaying
    # from a saved cursor: do a full run, capture, then resume-from-middle
    assert main(["search", str(d / "ref.fa"), "--seq", str(d / "reads.fq"),
                 "-o", str(out), "--read-bucket", "96", "--batch-size", "10",
                 "--oracle"]) == 0
    full = [l for l in out.read_text().splitlines() if not l.startswith("@")]

    # interrupted run: write first 10 records + cursor, then resume
    out2 = d / "res2.sam"
    cursor = str(out2) + ".cursor"
    assert main(["search", str(d / "ref.fa"), "--seq", str(d / "reads.fq"),
                 "-o", str(out2), "--read-bucket", "96", "--batch-size", "10",
                 "--oracle"]) == 0
    # craft a cursor pointing after the first batch and truncate output
    lines = out2.read_text().splitlines(keepends=True)
    hdr = [l for l in lines if l.startswith("@")]
    body = [l for l in lines if not l.startswith("@")]
    with open(out2, "w") as f:
        f.writelines(hdr + body[:10])
    reads_path = d / "reads.fq"
    with open(reads_path, "rb") as f:
        off = 0
        for _ in range(10 * 4):
            off += len(f.readline())
    json.dump({"record": 10, "offset": off}, open(cursor, "w"))
    assert main(["search", str(d / "ref.fa"), "--seq", str(d / "reads.fq"),
                 "-o", str(out2), "--read-bucket", "96", "--batch-size", "10",
                 "--oracle", "--resume"]) == 0
    resumed = [l for l in out2.read_text().splitlines()
               if not l.startswith("@")]
    assert resumed == full


def test_cli_multichip_matches_single_device(workdir):
    """The CLI's production multi-chip path (shard_map over all local
    devices, replicated AND sharded index) writes SAM byte-identical to the
    single-device path (SURVEY.md 3.5 / 7 Phase 5)."""
    import jax
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    d, sims = workdir
    main(["index", str(d / "ref.fa")])
    base = ["search", str(d / "ref.fa"), "--seq", str(d / "reads.fq"),
            "--read-bucket", "96", "--batch-size", "8"]

    def body(p):  # @PG carries the (different) command line
        return [l for l in p.read_text().splitlines()
                if not l.startswith("@PG")]

    out1 = d / "one.sam"
    assert main(base + ["-o", str(out1), "--single-device"]) == 0
    out8 = d / "eight.sam"
    assert main(base + ["-o", str(out8)]) == 0
    assert body(out8) == body(out1)
    outs = d / "sharded.sam"
    assert main(base + ["-o", str(outs), "--shard-index", "4"]) == 0
    assert body(outs) == body(out1)


def test_ambiguous_out(tmp_path):
    """--ambiguous-out captures MAPQ-0 mapped reads (repeat genome)."""
    import numpy as np
    from bitmapperbs_tpu.cli import main
    from bitmapperbs_tpu.index.build import build_index, save_index
    from bitmapperbs_tpu.io.fastq import write_fastq
    from bitmapperbs_tpu.utils.simulate import simulate_reads

    rng = np.random.default_rng(3)
    workdir = tmp_path
    unit = "".join(rng.choice(list("ACGT"), size=500))
    ref = workdir / "rep.fa"
    ref.write_text(f">rep\n{unit}{unit}\n")
    idx = build_index(str(ref))
    save_index(idx, str(ref) + ".btidx")
    sims = simulate_reads(idx.genome, 20, read_len=60, seed=4, sub_rate=0.0)
    write_fastq(str(workdir / "r.fq"), [s.codes for s in sims],
                [f"r{i}" for i in range(len(sims))],
                ["I" * 60 for _ in sims])
    out = workdir / "o.sam"
    amb = workdir / "amb.fq"
    assert main(["search", str(ref), "--seq", str(workdir / "r.fq"),
                 "-o", str(out), "--oracle", "--batch-size", "20",
                 "--read-bucket", "64", "--ambiguous-out", str(amb)]) == 0
    n_amb_records = sum(1 for l in open(out)
                        if not l.startswith("@")
                        and l.split("\t")[4] == "0"
                        and not int(l.split("\t")[1]) & 4)
    assert n_amb_records > 10  # tandem repeat: most reads are ambiguous
    n_fq = sum(1 for l in open(amb) if l.startswith("@"))
    assert n_fq == n_amb_records


def test_error_rate_per_read_budgets(tmp_path, rng):
    """-e as a rate resolves per read-length: a mixed 60/120 bp FASTQ maps
    with budgets 2 and 4 (rate 0.035), matching per-budget -e runs exactly;
    device path agrees with the oracle."""
    from bitmapperbs_tpu.index.build import build_index, save_index
    from bitmapperbs_tpu.utils.simulate import simulate_reads

    fa = random_genome_fasta(rng, contigs=(6000,))
    ref = tmp_path / "ref.fa"
    ref.write_text(fa)
    idx = build_index(str(ref))
    save_index(idx, str(ref) + ".btidx")
    short = simulate_reads(idx.genome, 10, read_len=60, seed=7, sub_rate=0.02)
    long_ = simulate_reads(idx.genome, 10, read_len=120, seed=8, sub_rate=0.02)
    reads, names, quals = [], [], []
    for i in range(10):  # interleave so every batch is mixed
        for tag, s in (("s", short[i]), ("l", long_[i])):
            reads.append(s.codes)
            names.append(f"{tag}{i}")
            quals.append("I" * len(s.codes))
    fq = tmp_path / "mix.fq"
    write_fastq(str(fq), reads, names, quals)

    def body(p):
        return [l for l in open(p).read().splitlines()
                if not l.startswith("@")]

    base = ["search", str(ref), "--seq", str(fq), "--oracle",
            "--batch-size", "20", "--read-bucket", "128"]
    out_rate = tmp_path / "rate.sam"
    assert main(base + ["-o", str(out_rate), "-e", "0.035"]) == 0
    # reference: each length group mapped alone with its resolved budget
    by_name = {}
    for e, tag in (("2", "s"), ("4", "l")):
        sub_fq = tmp_path / f"only{tag}.fq"
        keep = [i for i, n in enumerate(names) if n.startswith(tag)]
        write_fastq(str(sub_fq), [reads[i] for i in keep],
                    [names[i] for i in keep], [quals[i] for i in keep])
        out = tmp_path / f"only{tag}.sam"
        assert main(["search", str(ref), "--seq", str(sub_fq), "--oracle",
                     "--batch-size", "20", "--read-bucket", "128",
                     "-o", str(out), "-e", e]) == 0
        for l in body(out):
            by_name[l.split("\t")[0]] = l
    got = body(out_rate)
    assert len(got) == 20
    for l in got:
        assert l == by_name[l.split("\t")[0]]
    # device path: byte-identical records to the oracle rate run
    out_dev = tmp_path / "rate_dev.sam"
    assert main(["search", str(ref), "--seq", str(fq), "--platform", "cpu",
                 "--single-device", "--batch-size", "20",
                 "--read-bucket", "128", "-o", str(out_dev),
                 "-e", "0.035"]) == 0
    assert body(out_dev) == got


def test_auto_bucket_growth_mixed_lengths(tmp_path, rng):
    """A read longer than the sized bucket maps in its own grown bucket
    group instead of aborting the run; records are byte-identical to a run
    whose --read-bucket covers every read up front."""
    from bitmapperbs_tpu.index.build import build_index, save_index
    from bitmapperbs_tpu.utils.simulate import simulate_reads

    ref = tmp_path / "ref.fa"
    ref.write_text(random_genome_fasta(rng, contigs=(5000,)))
    idx = build_index(str(ref))
    save_index(idx, str(ref) + ".btidx")
    short = simulate_reads(idx.genome, 8, read_len=50, seed=3, sub_rate=0.02)
    long_ = simulate_reads(idx.genome, 4, read_len=150, seed=4, sub_rate=0.02)
    reads = [s.codes for s in short] + [s.codes for s in long_]
    names = [f"s{i}" for i in range(8)] + [f"l{i}" for i in range(4)]
    fq = tmp_path / "mix.fq"
    write_fastq(str(fq), reads, names, ["I" * len(r) for r in reads])

    def body(p):
        return [l for l in open(p).read().splitlines()
                if not l.startswith("@")]

    outs = []
    for tag, bucket in (("small", "64"), ("big", "160")):
        out = tmp_path / f"{tag}.sam"
        assert main(["search", str(ref), "--seq", str(fq), "-o", str(out),
                     "--platform", "cpu", "--single-device",
                     "--batch-size", "12", "--read-bucket", bucket]) == 0
        outs.append(body(out))
    assert outs[0] == outs[1]
    assert len(outs[0]) == 12


def test_autotune_for_genome():
    """Gbp-genome auto-tune: extension + Kc128 (+ PBAT flat cap) kick in
    above 512 Mbp unless the user passed explicit flags."""
    import argparse

    from bitmapperbs_tpu.cli import autotune_for_genome
    from bitmapperbs_tpu.config import AlignerConfig

    def ns(**kw):
        base = dict(seed_ext=None, seed_ext_occ=4, max_candidates=None,
                    fast=False, sensitive=False, flat_chunks=None)
        base.update(kw)
        return argparse.Namespace(**base)
    small = autotune_for_genome(AlignerConfig(), ns(), 100_000_000)
    assert small.seed_ext_max == 0 and small.max_candidates == 64
    big = autotune_for_genome(AlignerConfig(), ns(), 3_082_006_400)
    assert big.seed_ext_max == 20 and big.seed_ext_occ == 4
    assert big.max_candidates == 128
    pbat = autotune_for_genome(AlignerConfig(non_directional=True), ns(),
                               3_082_006_400)
    assert pbat.locate_flat_cap == 192 and pbat.flat_chunks == 3
    # explicit flags win
    expl = autotune_for_genome(AlignerConfig(seed_ext_max=8),
                               ns(seed_ext=8, max_candidates=96),
                               3_082_006_400)
    assert expl.seed_ext_max == 8 and expl.max_candidates == 64


def test_multichip_with_rate_groups(tmp_path, rng):
    """-e rate grouping on the 8-device virtual mesh: per-budget mapper sets
    share the uploaded index (make_cli_mappers reuse) and the output is
    byte-identical to --single-device."""
    from bitmapperbs_tpu.index.build import build_index, save_index
    from bitmapperbs_tpu.utils.simulate import simulate_reads

    ref = tmp_path / "ref.fa"
    ref.write_text(random_genome_fasta(rng, contigs=(5000,)))
    idx = build_index(str(ref))
    save_index(idx, str(ref) + ".btidx")
    a = simulate_reads(idx.genome, 12, read_len=50, seed=41, sub_rate=0.02)
    b = simulate_reads(idx.genome, 12, read_len=100, seed=42, sub_rate=0.02)
    reads = [s.codes for pair in zip(a, b) for s in pair]
    fq = tmp_path / "mix.fq"
    write_fastq(str(fq), reads, [f"m{i}" for i in range(24)],
                ["I" * len(r) for r in reads])

    def body(p):
        return [l for l in open(p).read().splitlines()
                if not l.startswith("@")]

    base = ["search", str(ref), "--seq", str(fq), "--platform", "cpu",
            "--batch-size", "24", "--read-bucket", "128", "-e", "0.04"]
    one = tmp_path / "one.sam"
    assert main(base + ["-o", str(one), "--single-device"]) == 0
    eight = tmp_path / "eight.sam"
    assert main(base + ["-o", str(eight)]) == 0
    assert body(eight) == body(one)
    assert len(body(one)) == 24


def test_gbp_preset_remap():
    """Round 5: the small-genome --fast/--sensitive knobs are harmful at
    Gbp scale (measured: --fast is no faster at recall 0.83; --sensitive
    gdrops 14% of reads); autotune remaps them onto the candidate cap."""
    import argparse

    from bitmapperbs_tpu.cli import autotune_for_genome
    from bitmapperbs_tpu.config import AlignerConfig

    base = AlignerConfig(max_seed_occ=32, locate_budget=64,
                         max_candidates=16)   # --fast small-genome knobs
    cfg = autotune_for_genome(base, argparse.Namespace(fast=True), 3 << 30)
    assert (cfg.max_seed_occ, cfg.locate_budget, cfg.max_candidates) == \
        (128, 256, 64)
    assert cfg.seed_ext_max == 20   # extension still auto-enabled

    base = AlignerConfig(max_seed_occ=512, locate_budget=512,
                         max_candidates=128)  # --sensitive knobs
    cfg = autotune_for_genome(base, argparse.Namespace(sensitive=True),
                              3 << 30)
    assert (cfg.max_seed_occ, cfg.locate_budget, cfg.max_candidates) == \
        (128, 256, 256)
    assert cfg.flat_chunks >= 2

    # explicit flags still win over the remap
    cfg = autotune_for_genome(
        AlignerConfig(max_candidates=32),
        argparse.Namespace(fast=True, max_candidates=32), 3 << 30)
    assert cfg.max_candidates == 32

    # below the threshold the presets are untouched
    cfg = autotune_for_genome(
        AlignerConfig(max_seed_occ=32, locate_budget=64, max_candidates=16),
        argparse.Namespace(fast=True), 100_000_000)
    assert (cfg.max_seed_occ, cfg.locate_budget, cfg.max_candidates) == \
        (32, 64, 16)


def test_platform_gpu_fails_without_gpu(workdir, capsys):
    """--platform gpu on a machine (here: a process) without a GPU backend
    exits 2 instead of mapping on the CPU."""
    import jax

    d, _ = workdir
    main(["index", str(d / "ref.fa")])
    try:
        assert main(["search", str(d / "ref.fa"), "--seq",
                     str(d / "reads.fq"), "-o", str(d / "gpu.sam"),
                     "--platform", "gpu"]) == 2
    finally:
        jax.config.update("jax_platforms", "cpu")
    assert "--platform gpu" in capsys.readouterr().err
    assert not (d / "gpu.sam").exists()


@pytest.mark.parametrize("script", ["bench", "chip_smoke"])
def test_gpu_scripts_exit_2_without_gpu(script, monkeypatch, capsys):
    """bench.py and chip_smoke.py report nothing from a CPU: they exit 2
    before any set-up and print no result line."""
    mod = importlib.import_module(script)
    monkeypatch.setattr(sys, "argv", [script + ".py"])
    assert mod.main() == 2
    out = capsys.readouterr()
    assert '"ok"' not in out.out and '"metric"' not in out.out
    assert "not gpu" in out.err


def test_compile_cache_env_wins(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, JAX reads it itself: the helper
    sets no other directory."""
    import jax

    from bitmapperbs_tpu.utils.artifacts import enable_compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cc"))
    assert enable_compile_cache() == str(tmp_path / "cc")
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_is_checkout_artifacts(monkeypatch):
    """Without the variable the cache goes to <checkout>/artifacts/jaxcache,
    a fixed path computed from the package location."""
    import jax

    import bitmapperbs_tpu
    from bitmapperbs_tpu.utils.artifacts import enable_compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setenv("BTBS_ARTIFACTS", "/nonexistent-elsewhere")
    want = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(bitmapperbs_tpu.__file__))), "artifacts", "jaxcache")
    before = jax.config.jax_compilation_cache_dir
    try:
        assert enable_compile_cache() == want
        assert jax.config.jax_compilation_cache_dir == want
        assert os.path.isdir(want)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
