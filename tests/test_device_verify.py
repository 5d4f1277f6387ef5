"""Device Hamming/Myers/window ops vs oracle align semantics."""
import numpy as np
import pytest

import jax.numpy as jnp

from bitmapperbs_tpu import constants as K
from bitmapperbs_tpu.oracle import align
from bitmapperbs_tpu.oracle.pipeline import frame_slice
from bitmapperbs_tpu.ops import verify
from bitmapperbs_tpu.utils import dna

M = 96  # padded read bucket for these tests (multiple of 32)


def _pad(read, m=M):
    out = np.full(m, K.N_CODE, np.uint8)
    out[:len(read)] = read
    return out


def test_pack_codes_roundtrip(rng):
    codes = rng.integers(0, 5, size=(3, 64)).astype(np.uint8)
    b0, b1, nm = verify.pack_codes(jnp.asarray(codes))
    for lane in range(3):
        for j in range(64):
            w, b = j // 32, j % 32
            c = codes[lane, j]
            if c == K.N_CODE:
                assert (int(nm[lane, w]) >> b) & 1 == 1
            else:
                got = ((int(b0[lane, w]) >> b) & 1) | (((int(b1[lane, w]) >> b) & 1) << 1)
                assert got == c


def test_window_planes_matches_frame_slice(rng):
    L = 500
    genome = rng.integers(0, 4, L).astype(np.uint8)
    genome[rng.integers(0, L, 20)] = K.N_CODE
    rc = dna.revcomp(genome)
    planes = np.zeros((2, (L + 31) // 32 + 3, 3), dtype=np.uint32)
    from bitmapperbs_tpu.index.build import _pack_bits
    for oi, g in enumerate((genome, rc)):
        isn = g == K.N_CODE
        c = np.where(isn, 0, g)
        for pi, bits in enumerate(((c & 1), (c >> 1) & 1, isn.astype(np.uint8))):
            pk = _pack_bits(bits.astype(np.uint8))
            planes[oi, 1:1 + len(pk), pi] = pk  # word 0 = zero pad
    gp = jnp.asarray(planes)
    nwords = 4
    starts = np.array([0, 1, 31, 32, 33, 100, L - 130, L - 100, L - 10,
                       (1 << 32) - 5, (1 << 32) - 31], dtype=np.uint64
                      ).astype(np.uint32)
    orients = np.array([0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0], dtype=np.int32)
    b0, b1, nm = verify.window_planes(gp, jnp.asarray(orients),
                                      jnp.asarray(starts), nwords, L)
    for k, (s, o) in enumerate(zip(starts.astype(np.int64), orients)):
        if s > L:  # wrapped negative
            s = s - (1 << 32)
        ref = genome if o == 0 else rc
        want = frame_slice(ref, int(s), nwords * 32)
        for j in range(nwords * 32):
            w, b = j // 32, j % 32
            isn = (int(nm[k, w]) >> b) & 1
            if want[j] == K.N_CODE:
                assert isn == 1, (k, j, s)
            else:
                assert isn == 0, (k, j, s, want[j])
                got = ((int(b0[k, w]) >> b) & 1) | (((int(b1[k, w]) >> b) & 1) << 1)
                assert got == want[j], (k, j)


def test_hamming_matches_oracle(rng):
    n = 200
    lens = rng.integers(40, M + 1, n)
    refs = rng.integers(0, 4, (n, M)).astype(np.uint8)
    reads = []
    for k in range(n):
        r = refs[k, :lens[k]].copy()
        # bisulfite-convert some Cs, add some errors and Ns
        cs = np.flatnonzero(r == K.C)
        r[cs[rng.random(len(cs)) < 0.7]] = K.T
        for _ in range(int(rng.integers(0, 6))):
            r[rng.integers(0, lens[k])] = rng.integers(0, 5)
        reads.append(_pad(r))
    reads = np.stack(reads)
    rp = verify.pack_codes(jnp.asarray(reads))
    fp = verify.pack_codes(jnp.asarray(refs))
    lm = verify.length_mask(jnp.asarray(lens, jnp.int32), M)
    got = np.asarray(verify.hamming(fp, rp, lm))
    for k in range(n):
        want = align.hamming(refs[k, :lens[k]], reads[k, :lens[k]])
        assert got[k] == want, k


@pytest.mark.parametrize("e", [2, 5])
def test_myers_matches_oracle_dp(rng, e):
    n = 120
    ncols = M + 2 * e
    nwin = -(-ncols // 32)
    lens = rng.integers(50, M + 1, n)
    wins, reads, wants = [], [], []
    for k in range(n):
        m = int(lens[k])
        window = rng.integers(0, 4, nwin * 32).astype(np.uint8)
        read = window[e:e + m].copy()
        cs = np.flatnonzero(read == K.C)
        read[cs[rng.random(len(cs)) < 0.7]] = K.T
        # inject substitutions and indels
        lst = list(read)
        for _ in range(int(rng.integers(0, e + 2))):
            op = rng.integers(0, 3)
            i = int(rng.integers(0, len(lst)))
            if op == 0:
                lst[i] = int(rng.integers(0, 4))
            elif op == 1 and len(lst) > 40:
                del lst[i]
            else:
                lst.insert(i, int(rng.integers(0, 4)))
        read = np.array(lst[:m], np.uint8)
        lens[k] = len(read)
        window[rng.integers(0, len(window), 3)] = K.N_CODE
        wins.append(window)
        reads.append(_pad(read))
        # the padded kernel scans exactly len(read) + 2e real columns: the
        # pad rows consume the remaining M - len(read) columns for free
        wants.append(align.edit_distance(window[:len(read) + 2 * e], read))
    wins = np.stack(wins)
    reads = np.stack(reads)
    wp = verify.pack_codes(jnp.asarray(wins))
    peq, pad = verify.build_peq(jnp.asarray(reads),
                                jnp.asarray(lens, jnp.int32), M)
    got = np.asarray(verify.myers(wp, peq, pad, M, ncols))
    np.testing.assert_array_equal(got, np.array(wants))


def test_myers_scan_matches_oracle_columns(rng):
    """Per-column scan scores == oracle edit_matrix bottom row, including
    the pad-row column shift for padded reads."""
    import jax.numpy as jnp
    from bitmapperbs_tpu.oracle import align
    from bitmapperbs_tpu.ops import verify

    m_pad, ncols = 64, 96
    B = 20
    for _ in range(4):
        wlen = ncols
        win = rng.integers(0, 4, (B, wlen)).astype(np.uint8)
        win[rng.random((B, wlen)) < 0.05] = K.N_CODE
        lengths = rng.integers(30, m_pad + 1, B).astype(np.int32)
        reads = rng.integers(0, 4, (B, m_pad)).astype(np.uint8)
        for i in range(B):
            reads[i, lengths[i]:] = K.N_CODE

        wb = verify.pack_codes(win.reshape(B, wlen))
        Ww = wlen // 32
        peq, pad = verify.build_peq(jnp.asarray(reads),
                                    jnp.asarray(lengths), m_pad)
        S = np.asarray(verify.myers_scan(
            tuple(jnp.asarray(x) for x in wb), peq, pad, m_pad, ncols))
        for i in range(B):
            L = int(lengths[i])
            D = align.edit_matrix(win[i], reads[i, :L])
            npad = m_pad - L
            for j in range(ncols):
                jr = j - npad
                if 0 <= jr < wlen:
                    assert S[i, j] == D[L, jr + 1], (i, j)
