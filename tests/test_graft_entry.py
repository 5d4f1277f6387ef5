"""__graft_entry__.py's entry points on the CPU virtual mesh: the forward
mapping step jits and runs, and the multi-device dry run (replicated and
sharded index, SE / PE / PBAT) is bitwise identical to one device."""
import numpy as np

import jax

import __graft_entry__ as graft


def test_entry_runs():
    fn, args = graft.entry()
    score, bp, anchor = jax.jit(fn)(*args)
    assert score.shape == bp.shape == anchor.shape == (64,)
    assert int((np.asarray(score) < (1 << 20)).sum()) > 48


def test_dryrun_multichip_4(capsys):
    graft.dryrun_multichip(4)
    out = capsys.readouterr().out
    assert "dp x sharded-idx (2x2) OK" in out
    assert "pbat dp(4) OK" in out
