"""Batched posterior decoding on device (JAX) + host OA traceback.

The per-(query, HMM) hmmalign replacement at production scale: the heavy
Forward+Backward recurrences run as batched odds-domain scans on device; the
tiny optimal-accuracy fill/traceback (validated bit-for-bit against the
binary in tests/test_hmmalign_parity.py) runs on host from the posterior
matrices.
"""

from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .align_ref import oa_columns_from_pp
from .bank import ProfileBank
from .profile import Profile


def _dchain_fwd(x, y):
    a1, b1 = x
    a2, b2 = y
    return a1 * a2, b1 * a2 + b2


def _posterior_one(em_odds, t_mm, t_mi, t_md, t_im, t_ii, t_dm, t_dd, bm,
                   codes, qlen, multihit):
    """Posterior decode for one (HMM, query) pair; returns pp arrays
    [Lmax+1, Mp+1] for M/I and [Lmax+1] for N/J/C."""
    Mp1 = em_odds.shape[0]
    Lmax = codes.shape[0]
    nj = 1.0 if multihit else 0.0
    e_loop = 0.5 if multihit else 0.0
    e_move = 0.5 if multihit else 1.0
    pmove = (2.0 + nj) / (qlen.astype(jnp.float32) + 2.0 + nj)
    ploop = 1.0 - pmove

    sh = lambda v: jnp.concatenate([jnp.zeros((1,), v.dtype), v[:-1]])
    shl = lambda v: jnp.concatenate([v[1:], jnp.zeros((1,), v.dtype)])
    t_dd_s = sh(t_dd)

    # ---------------- forward scan, storing rows ----------------
    def fstep(carry, xi):
        Mv, Iv, Dv, N, B, J, C, ls = carry
        x, i = xi
        e = em_odds[:, x]
        srcM = sh(Mv * t_mm) + sh(Iv * t_im) + sh(Dv * t_dm) + B * bm
        Mrow = srcM * e
        Irow = Mv * t_mi + Iv * t_ii
        a = t_dd_s
        b = sh(Mrow * t_md)
        _, Drow = jax.lax.associative_scan(_dchain_fwd, (a, b))
        E = jnp.sum(Mrow) + jnp.sum(Drow)
        Jn = J * ploop + E * e_loop
        Cn = C * ploop + E * e_move
        Nn = N * ploop
        Bn = Nn * pmove + Jn * pmove
        scale = jnp.maximum(jnp.maximum(jnp.max(Mrow), Cn),
                            jnp.maximum(Nn, 1e-35))
        inv = 1.0 / scale
        new = (Mrow * inv, Irow * inv, Drow * inv, Nn * inv, Bn * inv,
               Jn * inv, Cn * inv, ls + jnp.log(scale))
        keep = i < qlen
        out = tuple(jnp.where(keep, n, c) for n, c in zip(new, carry))
        return out, out + (jnp.where(keep, E * inv, 0.0),)

    z = jnp.zeros((Mp1,), jnp.float32)
    init = (z, z, z, jnp.float32(1.0), pmove, jnp.float32(0.0),
            jnp.float32(0.0), jnp.float32(0.0))
    (fM_f, fI_f, fD_f, fN_f, fB_f, fJ_f, fC_f, fs_f), ys = jax.lax.scan(
        fstep, init, (codes, jnp.arange(Lmax)))
    fE = jnp.concatenate([jnp.zeros((1,), jnp.float32), ys[8]])
    fM = jnp.concatenate([init[0][None], ys[0]])      # [L+1, Mp1]
    fI = jnp.concatenate([init[1][None], ys[1]])
    fD = jnp.concatenate([init[2][None], ys[2]])
    fN = jnp.concatenate([jnp.float32(1.0)[None], ys[3]])
    fB = jnp.concatenate([pmove[None], ys[4]])
    fJ = jnp.concatenate([jnp.float32(0.0)[None], ys[5]])
    fC = jnp.concatenate([jnp.float32(0.0)[None], ys[6]])
    fs = jnp.concatenate([jnp.float32(0.0)[None], ys[7]])
    logZ = jnp.log(fC_f * pmove) + fs_f

    # ---------------- backward scan ----------------
    # row index i from L down to 0; backward values with own scales.
    t_dd_l = shl(t_dd)   # not used; backward chain uses t_dd directly

    def bstep(carry, xi):
        bM_n, bI_n, bD_n, bN_n, bJ_n, bC_n, ls = carry
        x, i = xi                     # residue x = codes[i] consumed i->i+1
        e = em_odds[:, x]
        is_last = i >= qlen           # rows beyond qlen stay frozen
        Cv = bC_n * ploop
        Bv = jnp.sum(bm * e * bM_n)
        Nv = bN_n * ploop + Bv * pmove
        Jv = bJ_n * ploop + Bv * pmove
        Ev = Cv * e_move + Jv * e_loop
        # delete chain right-to-left:
        # D[k] = t_dd[k]*D[k+1] + (Mnext[k+1]*e[k+1]*t_dm[k] + Ev)
        cvec = shl(bM_n * e) * t_dm + Ev
        # boundary: D[Mp1-1] source only E (t_dm pad 0 handles)
        a_r = t_dd
        rev = lambda v: v[::-1]
        _, Dv_r = jax.lax.associative_scan(
            _dchain_fwd, (rev(a_r), rev(cvec)))
        Dv = rev(Dv_r)
        # match: E + Mnext[k+1]*e[k+1]*tmm[k] + Inext[k]*tmi[k] + D[k+1]*tmd[k]
        Mv = (Ev + shl(bM_n * e) * t_mm + bI_n * t_mi + shl(Dv) * t_md)
        Iv = shl(bM_n * e) * t_im + bI_n * t_ii
        scale = jnp.maximum(jnp.maximum(jnp.max(Mv), Nv), 1e-35)
        inv = 1.0 / scale
        new = (Mv * inv, Iv * inv, Dv * inv, Nv * inv, Jv * inv,
               Cv * inv, ls + jnp.log(scale))
        # freeze rows at/after qlen: they correspond to padding
        out = tuple(jnp.where(is_last, c, n) for n, c in zip(new, carry))
        extras = (jnp.where(is_last, 0.0, Bv * inv),
                  jnp.where(is_last, 0.0, Ev * inv))
        return out, out + extras

    # init at row L=qlen: C=move, E=C*e_move, D/M rows via chain with
    # Mnext=0. Implement by starting carry "beyond" the end with C=move
    # and scanning i = Lmax-1 .. 0; rows >= qlen freeze at the init value,
    # which equals the true row-qlen values because inputs there are 0.
    zero = jnp.zeros((Mp1,), jnp.float32)
    EL = pmove * e_move
    cL = jnp.full((Mp1,), EL, jnp.float32)
    _, DL_r = jax.lax.associative_scan(
        _dchain_fwd, (t_dd[::-1], cL[::-1]))
    DL = DL_r[::-1]
    ML = EL + jnp.concatenate([DL[1:], jnp.zeros((1,), jnp.float32)]) * t_md
    binit = (ML, zero, DL, jnp.float32(0.0), jnp.float32(0.0),
             jnp.float32(pmove), jnp.float32(0.0))
    _, bys = jax.lax.scan(bstep, binit,
                          (codes, jnp.arange(Lmax)), reverse=True)
    # bys rows are for i = 0..Lmax-1; row qlen value = binit
    bM = jnp.concatenate([bys[0], ML[None]])
    bI = jnp.concatenate([bys[1], zero[None]])
    bN = jnp.concatenate([bys[3], jnp.float32(0.0)[None]])
    bJ = jnp.concatenate([bys[4], jnp.float32(0.0)[None]])
    bC = jnp.concatenate([bys[5], jnp.float32(pmove)[None]])
    bs = jnp.concatenate([bys[6], jnp.float32(0.0)[None]])
    bB = jnp.concatenate([bys[7], jnp.float32(0.0)[None]])
    bE = jnp.concatenate([bys[8], (pmove * e_move)[None]])
    # NOTE: rows between qlen and Lmax hold frozen init values; the host
    # consumer slices to qlen.

    # ---------------- posteriors ----------------
    Lr = jnp.arange(Lmax + 1)
    # align scales: value_true[i] = v[i] * exp(s[i]); backward row i scale
    # bs[i]. For row qlen exactly, bs = 0.
    def bsel(arr, row_default):
        return arr
    logf = fs
    logb = bs
    factor = jnp.exp(logf[:, None] + logb[:, None] - logZ)
    pp_M = fM * bM * factor
    pp_I = fI * bI * factor
    fac1 = jnp.exp(logf[:-1] + logb[1:] - logZ)
    pp_N = jnp.concatenate([jnp.zeros((1,), jnp.float32),
                            fN[:-1] * ploop * bN[1:] * fac1])
    pp_J = jnp.concatenate([jnp.zeros((1,), jnp.float32),
                            fJ[:-1] * ploop * bJ[1:] * fac1])
    pp_C = jnp.concatenate([jnp.zeros((1,), jnp.float32),
                            fC[:-1] * ploop * bC[1:] * fac1])
    # B/E state posteriors (state occupancy at row i)
    factor1 = jnp.exp(logf + logb - logZ)
    pp_B = fB * bB * factor1
    pp_E = fE * bE * factor1
    return pp_M, pp_I, pp_N, pp_J, pp_C, pp_B, pp_E


@functools.partial(jax.jit, static_argnames=("multihit",))
def posterior_pp_pairs(em_odds, t_mm, t_mi, t_md, t_im, t_ii, t_dm, t_dd,
                       bm, codes, qlens, multihit=False):
    """Batched posterior decode over pairs: all bank arrays have leading
    pair axis [P, ...]; codes [P, Lmax]; qlens [P]."""
    f = jax.vmap(_posterior_one,
                 in_axes=(0,) * 9 + (0, 0, None))
    return f(em_odds, t_mm, t_mi, t_md, t_im, t_ii, t_dm, t_dd, bm,
             codes, qlens, multihit)[:5]


@functools.partial(jax.jit, static_argnames=("multihit", "topk"))
def posterior_pp_pairs_sparse(em_odds, t_mm, t_mi, t_md, t_im, t_ii,
                              t_dm, t_dd, bm, codes, qlens,
                              multihit=False, topk=64):
    """Sparse posterior decode: per row, the top-k M/I posteriors and
    their state indices (device->host transfer shrinks ~40x; values
    below the top-k are numerically irrelevant to OA decisions)."""
    def one(eo, a, b, c, d, e, f_, g, h, cd, ql):
        ppM, ppI, ppN, ppJ, ppC = _posterior_one(
            eo, a, b, c, d, e, f_, g, h, cd, ql, multihit)[:5]
        vM, iM = jax.lax.top_k(ppM, topk)
        vI, iI = jax.lax.top_k(ppI, topk)
        return vM, iM.astype(jnp.int32), vI, iI.astype(jnp.int32),             ppN, ppJ, ppC
    f = jax.vmap(one, in_axes=(0,) * 9 + (0, 0))
    return f(em_odds, t_mm, t_mi, t_md, t_im, t_ii, t_dm, t_dd, bm,
             codes, qlens)


@functools.partial(jax.jit, static_argnames=("multihit", "topk"))
def posterior_sparse_rows(bank_args, rows, codes, qlens,
                          multihit=False, topk=64):
    """Sparse posterior decode with the bank resident on device:
    bank_args are full [H, ...] arrays, rows [P] selects the model per
    pair ON DEVICE (no per-chunk host gathers);
    indices return as int16 (Mp+1 < 32768) to shrink the transfer."""
    sel = tuple(a[rows] for a in bank_args)

    def one(eo, a, b, c, d, e, f_, g, h, cd, ql):
        ppM, ppI, ppN, ppJ, ppC = _posterior_one(
            eo, a, b, c, d, e, f_, g, h, cd, ql, multihit)[:5]
        vM, iM = jax.lax.top_k(ppM, topk)
        vI, iI = jax.lax.top_k(ppI, topk)
        return (vM, iM.astype(jnp.int16), vI, iI.astype(jnp.int16),
                ppN, ppJ, ppC)
    f = jax.vmap(one, in_axes=(0,) * 9 + (0, 0))
    return f(*sel, codes, qlens)


def densify_sparse_pp(vM, iM, vI, iI, Mp1: int):
    """Host-side reconstruction of a dense [L+1, Mp1] posterior pair."""
    L1, k = vM.shape
    ppM = np.zeros((L1, Mp1), dtype=np.float64)
    ppI = np.zeros((L1, Mp1), dtype=np.float64)
    r = np.repeat(np.arange(L1), k)
    ppM[r, iM.ravel()] = vM.ravel()
    ppI[r, iI.ravel()] = vI.ravel()
    return ppM, ppI


def aligned_columns_from_pp(prof: Profile, pp_M, pp_I, pp_N, pp_J, pp_C,
                            qlen: int) -> np.ndarray:
    """Host OA fill + traceback from device posteriors (validated logic
    from align_ref)."""
    M = prof.M
    pp = dict(M=np.asarray(pp_M[:qlen + 1, :M + 1], dtype=np.float64),
              I=np.asarray(pp_I[:qlen + 1, :M + 1], dtype=np.float64),
              N=np.asarray(pp_N[:qlen + 1], dtype=np.float64),
              J=np.asarray(pp_J[:qlen + 1], dtype=np.float64),
              C=np.asarray(pp_C[:qlen + 1], dtype=np.float64))
    return oa_columns_from_pp(prof, pp)
