"""CI smoke for the large-scale differential harness (scripts/crossdiff.py).

The full harness runs 10^5 reads at 100 Mbp on the GPU; here it
runs a miniature corpus on CPU so the three layers (compact-vs-dense,
batch-split invariance, oracle SAM sampling) stay wired and green.
"""
import sys


def test_crossdiff_smoke(monkeypatch):
    from scripts import crossdiff

    monkeypatch.setattr(sys, "argv", [
        "crossdiff.py", "--n", "600", "--genome-bp", "300000",
        "--batch", "256", "--oracle-sample", "12", "--read-len", "64"])
    assert crossdiff.main() == 0


def test_crossdiff_gdrop_fires(monkeypatch, capsys):
    """With a squeezed flat cap the gdrop->dense fallback fires on real
    batches and the full three-layer differential (incl. the host-path
    oracle SAM sample, which runs the fallback) stays clean -- the CI
    answer to 'overflow paths only ever fire in synthetic toys'."""
    from scripts import crossdiff

    monkeypatch.setattr(sys, "argv", [
        "crossdiff.py", "--n", "600", "--genome-bp", "300000",
        "--batch", "256", "--oracle-sample", "24", "--read-len", "64",
        "--flat-cap", "2"])
    assert crossdiff.main() == 0
    out = capsys.readouterr().out
    import re
    m = re.search(r"(\d+) gdrop fallbacks", out)
    assert m and int(m.group(1)) > 0, out
