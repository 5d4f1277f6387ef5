"""Kill/resume coverage for the block-resumable at-scale builder
(scripts/build_big.build_scale; SURVEY.md 5.4).

The round-4 wipe landed in the ~30 min window between "SA-IS done" and the
first packed-block checkpoint, re-running the whole SA-IS.  build_scale now
checkpoints the raw SA the moment SA-IS finishes; these tests crash a real
subprocess build exactly in that window (deterministically: build_block is
replaced by os._exit in the child) and require the resumed run to
  (a) never re-run SA-IS for the checkpointed block (counted in the child),
  (b) produce artifacts byte-identical to an uninterrupted build.

Scale is ~0.5 Mbp so the suite stays fast; the code path is the same one
the 3 Gbp build runs (same build_scale, same checkpoint files).
"""
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = r"""
import importlib.util, os, sys
import jax
jax.config.update('jax_platforms', 'cpu')
import numpy as np

repo, mode = sys.argv[1], sys.argv[2]
sys.path.insert(0, repo)
spec = importlib.util.spec_from_file_location(
    'build_big', os.path.join(repo, 'scripts', 'build_big.py'))
bb = importlib.util.module_from_spec(spec)
spec.loader.exec_module(bb)

from bitmapperbs_tpu.utils.simulate import random_genome

def genome_fn():
    return random_genome(np.random.default_rng(11),
                         contigs=(300_000, 200_000))

if mode == 'crash':
    # deterministic SIGKILL-equivalent in the exact window the round-4
    # wipe hit: after the SA checkpoint, before the first pack
    bb.build_block = lambda *a, **k: os._exit(9)
else:
    from bitmapperbs_tpu.index import sais
    orig = sais.suffix_array
    calls = []
    def counting(text):
        calls.append(len(text))
        return orig(text)
    bb.sais.suffix_array = counting

bb.build_scale({8: 'idx_small', 4: 'idx_small_r4'}, genome_fn,
               'ckpt_small', 'small', plane_cache=False)
if mode != 'crash':
    with open(os.path.join(os.environ['BTBS_ARTIFACTS'],
                           'sais_calls.txt'), 'w') as f:
        f.write(str(len(calls)))
"""


def _run(mode, art_dir):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["BTBS_ARTIFACTS"] = str(art_dir)
    return subprocess.run([sys.executable, "-c", _CHILD, REPO, mode],
                          env=env, capture_output=True, timeout=600)


def test_sa_checkpoint_survives_kill_before_pack(tmp_path):
    crash_dir = tmp_path / "crashed"
    full_dir = tmp_path / "full"
    crash_dir.mkdir()
    full_dir.mkdir()

    # uninterrupted reference build
    p = _run("full", full_dir)
    assert p.returncode == 0, p.stderr.decode()
    assert (full_dir / "sais_calls.txt").read_text() == "2"  # fwd + rc

    # crashed build: dies after the fwd SA checkpoint, before any pack
    p = _run("crash", crash_dir)
    assert p.returncode == 9, p.stderr.decode()
    assert (crash_dir / "ckpt_small" / "fwd_sa.npy").exists()
    assert not (crash_dir / "ckpt_small" / "fwd_r8").exists()
    assert not (crash_dir / "idx_small.json").exists()

    # resume: must reuse the fwd SA (exactly ONE SA-IS call, for rc)
    p = _run("resume", crash_dir)
    assert p.returncode == 0, p.stderr.decode()
    assert (crash_dir / "sais_calls.txt").read_text() == "1"
    assert b"SA for block fwd loaded from checkpoint" in p.stdout

    # spent SA checkpoints are deleted once every rate is packed
    assert not (crash_dir / "ckpt_small" / "fwd_sa.npy").exists()
    assert not (crash_dir / "ckpt_small" / "rc_sa.npy").exists()

    # artifacts byte-identical to the uninterrupted build
    for stem in ("idx_small", "idx_small_r4"):
        for ext in (".bin", ".json"):
            a = (crash_dir / (stem + ext)).read_bytes()
            b = (full_dir / (stem + ext)).read_bytes()
            assert a == b, f"{stem}{ext} differs after crash/resume"


@pytest.mark.skipif(not os.environ.get("RUN_BIG"),
                    reason="100 Mbp variant (~4 min); set RUN_BIG=1")
def test_sa_checkpoint_kill_resume_100m(tmp_path):
    """The kill/resume proof at 100 Mbp scale."""
    child = _CHILD.replace("contigs=(300_000, 200_000)",
                           "contigs=(50_000_000, 50_000_000)")

    def run(mode, art_dir):
        env = dict(os.environ)
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        env["BTBS_ARTIFACTS"] = str(art_dir)
        return subprocess.run([sys.executable, "-c", child, REPO, mode],
                              env=env, capture_output=True, timeout=3600)

    d = tmp_path / "big"
    d.mkdir()
    p = run("crash", d)
    assert p.returncode == 9, p.stderr.decode()
    assert (d / "ckpt_small" / "fwd_sa.npy").exists()
    p = run("resume", d)
    assert p.returncode == 0, p.stderr.decode()
    assert (d / "sais_calls.txt").read_text() == "1"
    assert (d / "idx_small.json").exists()
