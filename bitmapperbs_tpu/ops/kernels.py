"""GPU kernels for the two verification loops of the hot path, and the one
place that chooses between them and the jnp spec (ops/verify.py).

Both kernels run the bit-parallel Myers recurrence with one candidate lane
per GPU thread: a lane's VP/VN words (Wd = m / 32, 5 for 150 bp reads) stay
in registers for the whole column loop, where the spec's loop moves them
through device memory at every column.  Lanes are the program axis (T lanes
per program).  The lane-major inputs are read in place, one word row at a
time -- a warp's loads of successive words hit the same cache lines -- so no
transposed copy is made.

- verify_fused_kernel, for verify.fused_verify (every compact SE/PE/PBAT
  batch): funnel shift + popcount-over-XOR Hamming + PEQ from the read
  planes + Myers + select, in one pass.
- myers_scan_kernel, for verify.myers_scan (paired-end mate rescue): the
  running score at every column, written column-major so stores coalesce.

Everything is integer, so the kernels are bitwise equal to the spec.  They
are Pallas kernels for the Triton route; interpret=True runs them on the CPU
(tests only -- the dispatch below never asks for it).
"""
from __future__ import annotations

import functools
import math
from typing import Callable, NamedTuple

import numpy as np

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from bitmapperbs_tpu.ops import verify

U32 = np.uint32            # numpy scalars inline into kernels as literals
FULL = np.uint32(0xFFFFFFFF)


class VerifyImpl(NamedTuple):
    """The two hot-path verification functions, spec or kernel."""
    fused_verify: Callable   # (wide, read_planes, lenmask, m, ncols, e)
    rescue_scan: Callable    # (win_planes, peq, pad, m, ncols)


def verify_impl(cfg, backend: str | None = None) -> VerifyImpl:
    """GPU kernels when the backend is the GPU and cfg.use_pallas is set;
    the jnp spec otherwise (CPU, or use_pallas=False)."""
    if backend is None:
        backend = jax.default_backend()
    if cfg.use_pallas and backend == "gpu":
        return VerifyImpl(verify_fused_kernel, myers_scan_kernel)
    return VerifyImpl(verify.fused_verify, verify.myers_scan)


# --------------------------------------------------------------------------
# shared per-lane pieces (lists of (T,) uint32 word vectors, LSW first)
# --------------------------------------------------------------------------

def _peq_lists(d0, d1, dn, pad):
    """PEQ[c][k] for the four reference symbols (asymmetric bisulfite match,
    pad rows always match): verify.peq_from_planes, per word."""
    peq = [[], [], [], []]
    for k in range(len(pad)):
        nn = ~dn[k]
        peq[0].append((~d0[k] & ~d1[k] & nn) | pad[k])
        peq[1].append((d0[k] & nn) | pad[k])           # read C or T
        peq[2].append((~d0[k] & d1[k] & nn) | pad[k])
        peq[3].append((d0[k] & d1[k] & nn) | pad[k])
    return peq


def _column_eq(peq, pad, c0, c1, cn):
    """Match words of one window column: PEQ[code], or the pad rows where
    the column is N.  c0/c1/cn are 0/1 lanes (code bits and N bit)."""
    s0, s1, sn = U32(0) - c0, U32(0) - c1, U32(0) - cn
    eq = []
    for k in range(len(pad)):
        lo = (peq[0][k] & ~s0) | (peq[1][k] & s0)
        hi = (peq[2][k] & ~s0) | (peq[3][k] & s0)
        sym = (lo & ~s1) | (hi & s1)
        eq.append((sym & ~sn) | (pad[k] & sn))
    return eq


def _myers_step(eq, vp, vn, score):
    """One Myers/Hyyro column over Wd words with carry across words; free
    start (no carry into row 0).  Same recurrence as verify.myers."""
    Wd = len(vp)
    d0, hp, hn = [], [], []
    carry = None
    for k in range(Wd):
        t = eq[k] & vp[k]
        s = t + vp[k]
        c = (s < t).astype(U32)
        if carry is not None:
            s2 = s + carry
            c = c | (s2 < s).astype(U32)
            s = s2
        carry = c
        x = (s ^ vp[k]) | eq[k] | vn[k]
        d0.append(x)
        hp.append(vn[k] | ~(x | vp[k]))
        hn.append(vp[k] & x)
    score = (score + (hp[-1] >> U32(31)).astype(jnp.int32)
             - (hn[-1] >> U32(31)).astype(jnp.int32))
    nvp, nvn = [], []
    for k in range(Wd):
        x = hp[k] << U32(1)
        y = hn[k] << U32(1)
        if k:
            x = x | (hp[k - 1] >> U32(31))
            y = y | (hn[k - 1] >> U32(31))
        nvp.append(y | ~(d0[k] | x))
        nvn.append(d0[k] & x)
    return nvp, nvn, score


def _column_loop(load_word, ncols, step, carry):
    """Run `step(j, c0, c1, cn, carry)` over window columns 0..ncols-1.

    load_word(w) -> (b0, b1, nmask) lanes of window word w.  The outer loop
    walks words, the inner one the word's bits (shifting the three words
    right as it goes), so each window word is loaded once."""
    def bits(w, nbits, carry):
        def body(b, st):
            words, carry = st
            c0, c1, cn = (x & U32(1) for x in words)
            carry = step(w * 32 + b, c0, c1, cn, carry)
            return tuple(x >> U32(1) for x in words), carry
        return jax.lax.fori_loop(0, nbits, body, (load_word(w), carry))[1]

    nfull, tail = divmod(ncols, 32)
    carry = jax.lax.fori_loop(0, nfull, lambda w, c: bits(w, 32, c), carry)
    if tail:
        carry = bits(nfull, tail, carry)
    return carry


def _lane_rows(base, T, L):
    ok = base + jnp.arange(T, dtype=jnp.int32) < L

    def row(ref, k):
        return plgpu.load(ref.at[pl.ds(base, T), k], mask=ok, other=0)
    return ok, row


# --------------------------------------------------------------------------
# kernels
# --------------------------------------------------------------------------

def _fused_verify_body(w0_ref, w1_ref, wn_ref, d0_ref, d1_ref, dn_ref,
                       lm_ref, out_ref, *, L, T, m, ncols, e):
    """T lanes: wide window planes (L, Ww) at anchor - e, read planes and
    length mask (L, Wd) -> out (L,) = ham if ham <= e else Myers distance."""
    Wd = m // 32
    base = pl.program_id(0) * T
    ok, row = _lane_rows(base, T, L)
    win = (w0_ref, w1_ref, wn_ref)
    d0, d1, dn, lm = ([row(r, k) for k in range(Wd)]
                      for r in (d0_ref, d1_ref, dn_ref, lm_ref))

    # anchored Hamming: shift the wide window right by e bits
    ham = jnp.zeros((T,), jnp.int32)
    rows = [[row(r, k) for k in range(Wd + (e > 0))] for r in win]
    for k in range(Wd):
        if e:
            a0, a1, an = ((p[k] >> U32(e)) | (p[k + 1] << U32(32 - e))
                          for p in rows)
        else:
            a0, a1, an = (p[k] for p in rows)
        eqb = ~(a0 ^ d0[k]) & ~(a1 ^ d1[k])
        match = (eqb | (a0 & ~a1 & d0[k] & d1[k])) & ~an & ~dn[k]
        # popcount of the int32 view: Triton lowers it to __nv_popc
        ham = ham + jax.lax.population_count(
            jax.lax.bitcast_convert_type(~match & lm[k], jnp.int32))

    pad = [~x for x in lm]
    peq = _peq_lists(d0, d1, dn, pad)

    def step(j, c0, c1, cn, st):
        vp, vn, score, best = st
        vp, vn, score = _myers_step(_column_eq(peq, pad, c0, c1, cn),
                                    vp, vn, score)
        return vp, vn, score, jnp.minimum(best, score)

    score0 = jnp.full((T,), m, jnp.int32)
    st = ([jnp.full((T,), FULL, U32) for _ in range(Wd)],
          [jnp.zeros((T,), U32) for _ in range(Wd)], score0, score0)
    best = _column_loop(lambda w: tuple(row(r, w) for r in win), ncols,
                        step, st)[3]
    plgpu.store(out_ref.at[pl.ds(base, T)], jnp.where(ham <= e, ham, best),
                mask=ok)


def _myers_scan_body(w0_ref, w1_ref, wn_ref, peq_ref, pad_ref, out_ref, *,
                     L, T, m, ncols):
    """T lanes: window planes (L, Ww), PEQ (L, 4 * Wd), pad (L, Wd) ->
    out (ncols, L): the running score after every column."""
    Wd = m // 32
    base = pl.program_id(0) * T
    ok, row = _lane_rows(base, T, L)
    win = (w0_ref, w1_ref, wn_ref)
    peq = [[row(peq_ref, c * Wd + k) for k in range(Wd)] for c in range(4)]
    pad = [row(pad_ref, k) for k in range(Wd)]

    def step(j, c0, c1, cn, st):
        vp, vn, score = st
        vp, vn, score = _myers_step(_column_eq(peq, pad, c0, c1, cn),
                                    vp, vn, score)
        plgpu.store(out_ref.at[j, pl.ds(base, T)], score, mask=ok)
        return vp, vn, score

    st = ([jnp.full((T,), FULL, U32) for _ in range(Wd)],
          [jnp.zeros((T,), U32) for _ in range(Wd)],
          jnp.full((T,), m, jnp.int32))
    _column_loop(lambda w: tuple(row(r, w) for r in win), ncols, step, st)


# --------------------------------------------------------------------------
# wrappers (drop-in for the spec functions)
# --------------------------------------------------------------------------

def lanes_per_program(L: int) -> int:
    """Lanes per program, a power of two in [32, 128]: 128 (4 warps) for
    batch-sized lane counts, fewer when that would leave the grid with
    under ~512 programs to spread over the SMs (the rescue scan has one
    lane per pair)."""
    T = 128
    while T > 32 and -(-L // T) < 512:
        T //= 2
    return T


def _as_rows(x, lanes, W):
    return jnp.broadcast_to(x, (*lanes, W)).reshape(-1, W)


def _call(body, args, out_shape, L, T, interpret, name):
    return pl.pallas_call(
        body,
        out_shape=out_shape,
        grid=(-(-L // T),),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=T // 32,
                                             num_stages=1),
        interpret=interpret,
        name=name,
    )(*args)


@functools.partial(jax.jit, static_argnames=("m", "ncols", "e", "interpret"))
def verify_fused_kernel(wide, read_planes, lenmask, m: int, ncols: int,
                        e: int, interpret: bool = False):
    """Kernel form of verify.fused_verify (same arguments, bitwise-equal
    int32 lanes)."""
    Wd = m // 32
    Ww = wide[0].shape[-1]
    lanes = jnp.broadcast_shapes(*(x.shape[:-1]
                                   for x in (*wide, *read_planes, lenmask)))
    L = math.prod(lanes)
    T = lanes_per_program(L)
    args = ([_as_rows(p, lanes, Ww) for p in wide]
            + [_as_rows(p, lanes, Wd) for p in (*read_planes, lenmask)])
    body = functools.partial(_fused_verify_body, L=L, T=T, m=m, ncols=ncols,
                             e=e)
    out = _call(body, args, jax.ShapeDtypeStruct((L,), jnp.int32), L, T,
                interpret, "verify_fused")
    return out.reshape(lanes)


@functools.partial(jax.jit, static_argnames=("m", "ncols", "interpret"))
def myers_scan_kernel(win_planes, peq, pad, m: int, ncols: int,
                      interpret: bool = False):
    """Kernel form of verify.myers_scan: int32[..., ncols], bitwise equal."""
    Wd = m // 32
    Ww = win_planes[0].shape[-1]
    lanes = jnp.broadcast_shapes(*(x.shape[:-1] for x in win_planes),
                                 peq.shape[:-2], pad.shape[:-1])
    L = math.prod(lanes)
    T = lanes_per_program(L)
    args = ([_as_rows(p, lanes, Ww) for p in win_planes]
            + [jnp.broadcast_to(peq, (*lanes, 4, Wd)).reshape(L, 4 * Wd),
               _as_rows(pad, lanes, Wd)])
    body = functools.partial(_myers_scan_body, L=L, T=T, m=m, ncols=ncols)
    out = _call(body, args, jax.ShapeDtypeStruct((ncols, L), jnp.int32), L,
                T, interpret, "myers_scan")
    return out.T.reshape(*lanes, ncols)
