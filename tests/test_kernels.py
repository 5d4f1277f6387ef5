"""GPU verification kernels (ops/kernels.py) against the jnp spec.

The kernels run here in Pallas interpret mode; on the GPU they are compiled
through Triton and checked by chip_smoke.py's kernel phase at real widths.
Everything is integer (uint32 bit-vectors, int32 scores), so equality is
bitwise: there is no tolerance, and matmul precision (TF32) does not apply.
"""
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from bitmapperbs_tpu import constants as K
from bitmapperbs_tpu.config import AlignerConfig
from bitmapperbs_tpu.ops import kernels, verify


def _lanes(rng, L, m, e, ncols):
    """Window codes (L, Ww*32) at anchor - e and N-padded reads (L, m) that
    are copies of the window with 0..e+2 edits, so both the Hamming branch
    (ham <= e) and the Myers branch are taken; some lanes are short."""
    Ww = max(-(-ncols // 32), m // 32 + (e > 0))
    win = rng.integers(0, 4, (L, Ww * 32)).astype(np.uint8)
    win[rng.random(win.shape) < 0.01] = K.N_CODE
    lengths = np.where(rng.random(L) < 0.3, rng.integers(m // 2, m + 1, L),
                       m).astype(np.int32)
    reads = np.full((L, m), K.N_CODE, np.uint8)
    for i in range(L):
        r = list(win[i, e:e + lengths[i]])
        for _ in range(int(rng.integers(0, e + 3))):
            op, j = rng.integers(0, 3), int(rng.integers(0, len(r)))
            if op == 0:
                r[j] = int(rng.integers(0, 4))
            elif op == 1 and len(r) > 8:
                del r[j]
            else:
                r.insert(j, int(rng.integers(0, 4)))
        r = np.array(r[:lengths[i]], np.uint8)
        r[r == K.C] = np.where(rng.random(int((r == K.C).sum())) < 0.7,
                               K.T, K.C)                 # bisulfite
        lengths[i] = len(r)
        reads[i, :len(r)] = r
    return win, reads, lengths


@pytest.mark.parametrize("L", [37, 100])
@pytest.mark.parametrize("m", [32, 96])
@pytest.mark.parametrize("e", [0, 2, 4])
def test_verify_fused_kernel_matches_spec(rng, e, m, L):
    """Lane counts that are not a multiple of the 32-lane block (the block
    lanes_per_program picks for them) exercise the masked tail program."""
    ncols = m + 2 * e
    win, reads, lengths = _lanes(rng, L, m, e, ncols)
    wide = verify.pack_codes(jnp.asarray(win))
    rp = verify.pack_codes(jnp.asarray(reads))
    lm = verify.length_mask(jnp.asarray(lengths), m)
    want = np.asarray(verify.fused_verify(wide, rp, lm, m, ncols, e))
    got = np.asarray(kernels.verify_fused_kernel(
        wide, rp, lm, m, ncols, e, interpret=True))
    np.testing.assert_array_equal(got, want)
    assert (want <= e).any() and (want > e).any()


@pytest.mark.parametrize("L", [37, 100])
@pytest.mark.parametrize("m", [32, 96])
@pytest.mark.parametrize("e", [0, 2, 4])
def test_myers_scan_kernel_matches_spec(rng, e, m, L):
    """The rescue scan's window is a whole insert range wide (R + m + 2e
    columns, not a multiple of 32)."""
    ncols = 45 + m + 2 * e
    win, reads, lengths = _lanes(rng, L, m, e, ncols)
    wp = verify.pack_codes(jnp.asarray(win))
    peq, pad = verify.build_peq(jnp.asarray(reads), jnp.asarray(lengths), m)
    want = np.asarray(verify.myers_scan(wp, peq, pad, m, ncols))
    got = np.asarray(kernels.myers_scan_kernel(wp, peq, pad, m, ncols,
                                               interpret=True))
    assert got.shape == (L, ncols)
    np.testing.assert_array_equal(got, want)


def test_kernel_lane_shapes(rng):
    """Leading lane dims are flattened and restored; broadcast lanes (one
    read's PEQ shared by several windows) are expanded, as in the spec."""
    m, e = 32, 2
    ncols = m + 2 * e
    win, reads, lengths = _lanes(rng, 12, m, e, ncols)
    wide = tuple(x.reshape(3, 4, -1)
                 for x in verify.pack_codes(jnp.asarray(win)))
    rp = tuple(x.reshape(3, 4, -1)
               for x in verify.pack_codes(jnp.asarray(reads)))
    lm = verify.length_mask(jnp.asarray(lengths), m).reshape(3, 4, -1)
    got = kernels.verify_fused_kernel(wide, rp, lm, m, ncols, e,
                                      interpret=True)
    assert got.shape == (3, 4)
    np.testing.assert_array_equal(
        got, verify.fused_verify(wide, rp, lm, m, ncols, e))
    peq, pad = verify.build_peq(jnp.asarray(reads[:3]),
                                jnp.asarray(lengths[:3]), m)
    wp = tuple(x.reshape(3, 4, -1) for x in verify.pack_codes(
        jnp.asarray(win)))
    got = kernels.myers_scan_kernel(wp, peq[:, None], pad[:, None], m,
                                    ncols, interpret=True)
    assert got.shape == (3, 4, ncols)
    peq4 = jnp.broadcast_to(peq[:, None], (3, 4, 4, m // 32))
    pad4 = jnp.broadcast_to(pad[:, None], (3, 4, m // 32))
    np.testing.assert_array_equal(
        got, verify.myers_scan(wp, peq4, pad4, m, ncols))


@pytest.mark.parametrize("L,T", [(1, 32), (512 * 32, 32), (512 * 64, 64),
                                 (512 * 128, 128), (10 ** 6, 128)])
def test_lanes_per_program(L, T):
    assert kernels.lanes_per_program(L) == T


def test_dispatch_picks_kernels_on_gpu(monkeypatch):
    """On the GPU backend the kernels are chosen (not traced here) ..."""
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    impl = kernels.verify_impl(AlignerConfig())
    assert impl.fused_verify is kernels.verify_fused_kernel
    assert impl.rescue_scan is kernels.myers_scan_kernel
    assert kernels.verify_impl(AlignerConfig(), "gpu") == impl


@pytest.mark.parametrize("backend,use_pallas", [("cpu", True), ("cpu", False),
                                                ("gpu", False)])
def test_dispatch_picks_spec(backend, use_pallas):
    """... and the jnp spec on the CPU or when use_pallas is off."""
    impl = kernels.verify_impl(AlignerConfig(use_pallas=use_pallas), backend)
    assert impl == kernels.VerifyImpl(verify.fused_verify, verify.myers_scan)


def test_dispatch_default_backend_here():
    assert kernels.verify_impl(AlignerConfig()).fused_verify \
        is verify.fused_verify


@pytest.fixture(scope="module")
def toy():
    from bitmapperbs_tpu.index.build import build_index
    from bitmapperbs_tpu.index.device import upload_index
    from bitmapperbs_tpu.utils.simulate import random_genome_fasta

    idx = build_index(random_genome_fasta(np.random.default_rng(5),
                                          contigs=(6000, 3000)))
    return idx, upload_index(idx)


def _interpret_impl(cfg, backend=None):
    return kernels.VerifyImpl(
        functools.partial(kernels.verify_fused_kernel, interpret=True),
        functools.partial(kernels.myers_scan_kernel, interpret=True))


def test_pipelines_with_kernels_match_spec(toy, monkeypatch):
    """The SE and PE device pipelines give identical outputs with the
    kernels (interpret mode) in place of the spec, at the lane shapes the
    pipelines really produce (flat candidate buffer, rescue windows)."""
    from bitmapperbs_tpu.models import aligner, host, paired
    from bitmapperbs_tpu.utils.simulate import simulate_pairs

    idx, dix = toy
    pairs = simulate_pairs(idx.genome, 24, read_len=90, seed=7,
                           min_insert=120, max_insert=300, sub_rate=0.01,
                           indel_rate=0.01)
    a1, l1 = host.prepare_batch([p[0].codes for p in pairs], 96, 24)
    a2, l2 = host.prepare_batch([p[1].codes for p in pairs], 96, 24)
    # max_candidates=33: a config no other test traces
    cfg = AlignerConfig(max_errors=3, read_len_bucket=96, batch_size=24,
                        paired=True, min_insert=100, max_insert=320,
                        max_candidates=33)
    want_se = aligner.map_batch_device(dix, cfg, a1, l1)
    want_pe = paired.map_batch_pe_device(dix, cfg, a1, l1, a2, l2)
    monkeypatch.setattr(aligner, "verify_impl", _interpret_impl)
    monkeypatch.setattr(paired, "verify_impl", _interpret_impl)
    # a new static config, so both jits trace afresh with the kernels
    kcfg = cfg.replace(use_pallas=False)
    got_se = aligner.map_batch_device(dix, kcfg, a1, l1)
    got_pe = paired.map_batch_pe_device(dix, kcfg, a1, l1, a2, l2)
    for want, got in ((want_se, got_se), (want_pe, got_pe)):
        for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want),
                                jax.tree_util.tree_leaves(got)):
            np.testing.assert_array_equal(g, w, err_msg=str(path))
    assert int(np.asarray(got_pe["pair_valid"]).sum()) > 12
    assert int(np.asarray(got_pe["resc_valid"]).sum()) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("e", [4, 6])
def test_kernels_compiled_for_gpu_match_spec(gpu_device, e):
    """The Triton-compiled kernels (no interpret mode) at m = 160: bitwise
    equal to the spec on the card."""
    rng = np.random.default_rng(e)
    m, L = 160, 3000
    for ncols in (m + 2 * e, 121 + m + 2 * e):
        win, reads, lengths = _lanes(rng, L, m, e, ncols)
        with jax.default_device(gpu_device):
            wp = verify.pack_codes(jnp.asarray(win))
            rp = verify.pack_codes(jnp.asarray(reads))
            lm = verify.length_mask(jnp.asarray(lengths), m)
            peq, pad = verify.build_peq(jnp.asarray(reads),
                                        jnp.asarray(lengths), m)
            if ncols == m + 2 * e:
                got = kernels.verify_fused_kernel(wp, rp, lm, m, ncols, e)
                want = verify.fused_verify(wp, rp, lm, m, ncols, e)
            else:
                got = kernels.myers_scan_kernel(wp, peq, pad, m, ncols)
                want = verify.myers_scan(wp, peq, pad, m, ncols)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
