"""Device-batched flank posterior rows for the reporting gate.

The hmmsearch reporting gate needs, per (model, target) pair, only the
special-state posterior rows of the multihit decoding — mocc[i]
(in-homology mass), ppB[i], ppE[i] — to find candidate regions
(p7_domaindef semantics, hmm/domaindef.py:find_regions) and decide
most pairs outright:

  * no region                      -> not reported;
  * a region with split mass < RT3 -> reported (single envelope,
                                      deterministic);
  * only multidomain regions       -> the per-region 200-trace
                                      stochastic ensemble decides
                                      (host, native/_domaindef).

On the host engine the full [L, M] Forward+Backward per pair is the
dominant gate cost (~2-4 ms/pair C++; 137 s for the 70,500-pair
example grid on 4 cores). These scans batch well on a device —
odds-domain DP over [Q, Mp] tiles — and the rows are tiny ([3, L+1]
f32 per pair), so device->host traffic stays negligible.

This module implements the batched Forward AND Backward special-row
scans (the backward mirrors hmm/forward.py:_forward_one right-to-left;
f64 oracle: hmm/domaindef.py:_posteriors_multihit), a vectorized host
region finder, and the three-way gate prefilter. Reference semantics:
p7_domaindef.c as decoded from the bundled binary (see
hmm/trace_ensemble.py); WITCH consumes the gate as score-list
membership (witch_msa/gcmm/loader.py:286-297).
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

RT1 = 0.25
RT2 = 0.10
RT3 = 0.20


def _dchain_combine(x, y):
    a1, b1 = x
    a2, b2 = y
    return a1 * a2, b1 * a2 + b2


def _flank_one(em_odds, t_mm, t_mi, t_md, t_im, t_ii, t_dm, t_dd, bm,
               codes, qlen):
    """Special-state posterior rows for one (HMM, query) pair.

    Odds-domain f32 with per-row rescaling both directions (the same
    numeric strategy as the scoring kernel). Returns
    (fwd_nats, ppB[L+1], ppE[L+1], mocc[L+1]) with padded rows zeroed.
    """
    Mp1 = em_odds.shape[0]
    Lmax = codes.shape[0]
    qlenf = qlen.astype(jnp.float32)
    nj = 1.0
    pmove = (2.0 + nj) / (qlenf + 2.0 + nj)
    ploop = 1.0 - pmove
    log_loop = jnp.log(ploop)
    # multihit: E->C and E->J both 0.5
    e_move = jnp.float32(0.5)
    e_loop = jnp.float32(0.5)

    sh = lambda v: jnp.concatenate([jnp.zeros((1,), v.dtype), v[:-1]])
    shl = lambda v: jnp.concatenate([v[1:], jnp.zeros((1,), v.dtype)])
    t_dd_s = sh(t_dd)

    # ---- forward scan, emitting log special rows --------------------
    def fstep(carry, xi):
        Mv, Iv, Dv, N, B, J, C, logscale = carry
        x, i = xi
        e = em_odds[:, x]
        srcM = (sh(Mv * t_mm) + sh(Iv * t_im) + sh(Dv * t_dm) + B * bm)
        Mrow = srcM * e
        Irow = Mv * t_mi + Iv * t_ii
        a = t_dd_s
        b = sh(Mrow * t_md)
        _, Drow = jax.lax.associative_scan(_dchain_combine, (a, b))
        E = jnp.sum(Mrow) + jnp.sum(Drow)
        Jn = J * ploop + E * e_loop
        Cn = C * ploop + E * e_move
        Nn = N * ploop
        Bn = Nn * pmove + Jn * pmove
        # log specials of row i (true value = val * exp(logscale))
        ys = jnp.log(jnp.stack([Nn, Bn, Jn, Cn, E])) + logscale
        scale = jnp.maximum(jnp.max(Mrow), jnp.maximum(Cn, Nn))
        scale = jnp.maximum(scale, 1e-35)
        inv = 1.0 / scale
        new = (Mrow * inv, Irow * inv, Drow * inv, Nn * inv, Bn * inv,
               Jn * inv, Cn * inv, logscale + jnp.log(scale))
        keep = i < qlen
        out = tuple(jnp.where(keep, n, c) for n, c in zip(new, carry))
        ys = jnp.where(keep, ys, jnp.full((5,), -jnp.inf))
        return out, ys

    z = jnp.zeros((Mp1,), jnp.float32)
    finit = (z, z, z, jnp.float32(1.0), pmove, jnp.float32(0.0),
             jnp.float32(0.0), jnp.float32(0.0))
    (Mv, Iv, Dv, N, B, J, C, logscale), fy = jax.lax.scan(
        fstep, finit, (codes, jnp.arange(Lmax)))
    fwd = jnp.log(C * pmove) + logscale
    # row 0 specials: N=1, B=pmove, J=C=E=0
    f0 = jnp.log(jnp.stack([jnp.float32(1.0), pmove, jnp.float32(0.0),
                            jnp.float32(0.0), jnp.float32(0.0)]))
    logF = jnp.concatenate([f0[None, :], fy], axis=0)   # [Lmax+1, 5]

    # ---- backward scan (right-to-left), emitting log special rows ---
    # carry rows live at position i+1; each step consumes x = codes[i]
    # and produces row i. Reference recurrence:
    # hmm/forward_ref.py:backward_matrices.
    def bstep(carry, xi):
        Mn, In, N, J, C, logscale = carry
        x, i = xi
        ms = em_odds[:, x]
        mne = Mn * ms
        Bv = jnp.sum(bm * mne)
        Ni = N * ploop + Bv * pmove
        Ji = J * ploop + Bv * pmove
        Ci = C * ploop
        Ei = Ci * e_move + Ji * e_loop
        # delete chain right-to-left: D[k] = c[k] + tdd[k] * D[k+1],
        # c[k] = Mn[k+1]*ms[k+1]*tdm[k] + Ei  (boundary zeros in the
        # padded transition vectors close the chain)
        # D[k] = c[k] + t_dd[k] * D[k+1]: right-to-left chain, so the
        # reversed scan's coefficient is flip(t_dd) UNshifted (the
        # factor lives at the target index, unlike the forward chain)
        c = shl(mne) * t_dm + Ei
        _, Drev = jax.lax.associative_scan(_dchain_combine,
                                           (jnp.flip(t_dd),
                                            jnp.flip(c)))
        Di = jnp.flip(Drev)
        Mi = Ei + shl(mne) * t_mm + In * t_mi + shl(Di) * t_md
        Ii = shl(mne) * t_im + In * t_ii
        ys = jnp.log(jnp.stack([Ni, Ji, Ci, Bv, Ei])) + logscale
        scale = jnp.maximum(jnp.max(Mi), jnp.maximum(Ni, Ci))
        scale = jnp.maximum(scale, 1e-35)
        inv = 1.0 / scale
        new = (Mi * inv, Ii * inv, Ni * inv, Ji * inv, Ci * inv,
               logscale + jnp.log(scale))
        keep = i < qlen
        out = tuple(jnp.where(keep, n, c2) for n, c2 in zip(new, carry))
        ys = jnp.where(keep, ys, jnp.full((5,), -jnp.inf))
        return out, ys

    # terminal state at row L: C = move, E_L = move * e_move, and the
    # M/D rows carry the E exit: D_L[k] = E_L + tdd[k] * D_L[k+1],
    # M_L[k] = E_L + D_L[k+1] * tmd[k] (reference:
    # forward_ref.backward_matrices at i == L)
    EL = pmove * e_move
    cL = jnp.full((Mp1,), EL)
    _, DLrev = jax.lax.associative_scan(_dchain_combine,
                                        (jnp.flip(t_dd),
                                         jnp.flip(cL)))
    DL = jnp.flip(DLrev)
    MnL = (EL + shl(DL) * t_md).at[0].set(0.0)
    binit = (MnL, z, jnp.float32(0.0), jnp.float32(0.0), pmove,
             jnp.float32(0.0))
    xs = (jnp.flip(codes), jnp.flip(jnp.arange(Lmax)))
    _, by = jax.lax.scan(bstep, binit, xs)
    by = jnp.flip(by, axis=0)                           # rows 0..Lmax-1
    # row L backward specials: N=J=-inf, C=move, B=-inf, E=move+e_move
    bL = jnp.stack([-jnp.inf, -jnp.inf, jnp.log(pmove), -jnp.inf,
                    jnp.log(pmove) + jnp.log(e_move)])
    logB = jnp.concatenate([by, bL[None, :]], axis=0)   # [Lmax+1, 5]
    # rows past qlen carry the init pattern at position qlen; row
    # indices > qlen are masked to -inf by `keep`, but row qlen itself
    # must hold the terminal specials: positions i in [0, qlen) came
    # from the scan; select terminal values at i == qlen.
    idx = jnp.arange(Lmax + 1)
    at_end = (idx == qlen)[:, None]
    logB = jnp.where(at_end, bL[None, :], logB)

    # ---- combine ----------------------------------------------------
    # ppN[i] = F_N[i-1] * loop * B_N[i] / fwd   (i >= 1), etc.
    fN, fB, fJ, fC, fE = (logF[:, k] for k in range(5))
    bN, bJ, bC, bB, bE = (logB[:, 0], logB[:, 1], logB[:, 2],
                          logB[:, 3], logB[:, 4])
    i_arr = jnp.arange(Lmax + 1)
    live = (i_arr >= 1) & (i_arr <= qlen)
    neg1 = jnp.full((1,), -jnp.inf)
    shF = lambda v: jnp.concatenate([neg1, v[:-1]])
    ppN = jnp.where(live, jnp.exp(shF(fN) + log_loop + bN - fwd), 0.0)
    ppJ = jnp.where(live, jnp.exp(shF(fJ) + log_loop + bJ - fwd), 0.0)
    ppC = jnp.where(live, jnp.exp(shF(fC) + log_loop + bC - fwd), 0.0)
    ppB = jnp.where(i_arr <= qlen, jnp.exp(fB + bB - fwd), 0.0)
    ppE = jnp.where(i_arr <= qlen, jnp.exp(fE + bE - fwd), 0.0)
    mocc = 1.0 - (jnp.nan_to_num(ppN) + jnp.nan_to_num(ppJ)
                  + jnp.nan_to_num(ppC))
    mocc = jnp.where(live, mocc, 0.0)
    return fwd, jnp.nan_to_num(ppB), jnp.nan_to_num(ppE), mocc


@functools.partial(jax.jit, static_argnames=())
def flank_rows_bank(em_odds, t_mm, t_mi, t_md, t_im, t_ii, t_dm, t_dd,
                    bm, codes, qlens):
    """Batched special-row posteriors: queries [Q, Lmax] x bank [H].

    Returns (fwd [Q, H] nats, ppB/ppE/mocc [Q, H, Lmax+1] f32).
    """
    f_h = jax.vmap(_flank_one,
                   in_axes=(0, 0, 0, 0, 0, 0, 0, 0, 0, None, None))
    f_qh = jax.vmap(f_h, in_axes=(None,) * 9 + (0, 0))
    return f_qh(em_odds, t_mm, t_mi, t_md, t_im, t_ii, t_dm, t_dd, bm,
                codes, qlens)


def prefilter_grid(banks, codes: np.ndarray, lens: np.ndarray,
                   col_of, H: int, q_chunk: int = 128,
                   return_rows: bool = False):
    """Three-way gate decisions for a full [Q, H] grid.

    Runs the batched flank-row scans per bank (device) in fixed-shape
    query chunks and classifies every pair on host. Returns the
    decision matrix [Q, H] int8 (-1 not reported / +1 reported /
    0 needs the trace ensemble). Used by the pipeline's
    --full-search-results path to skip native evaluation of no-region
    pairs when a device backend is doing the pre-scoring.

    With return_rows the (mocc, ppB, ppE) rows are kept as
    [Q, H, Lmax+1] f32 and returned alongside, so the native engine
    can evaluate the surviving pairs without recomputing the
    full-sequence Forward+Backward (native evaluate_targets_rows).
    """
    Q = codes.shape[0]
    dec = np.zeros((Q, H), np.int8)
    rows_keep = None
    if return_rows:
        Lp1 = codes.shape[1] + 1
        rows_keep = tuple(np.zeros((Q, H, Lp1), np.float32)
                          for _ in range(3))
    for b in banks:
        args = (b.em_odds, b.t_mm, b.t_mi, b.t_md, b.t_im, b.t_ii,
                b.t_dm, b.t_dd, b.bm)
        Hb = len(b.hmm_indices)
        cols = [col_of[int(idx)] for idx in b.hmm_indices]
        step = min(q_chunk, Q)
        for s in range(0, Q, step):
            n = min(step, Q - s)
            # pad the final chunk to the fixed shape: one compile
            c = np.ones((step, codes.shape[1]), np.int32)
            c[:n] = codes[s:s + n]
            l_arr = np.ones(step, np.int32)
            l_arr[:n] = lens[s:s + n]
            _, ppB, ppE, mocc = [np.asarray(x) for x in flank_rows_bank(
                *args, c, l_arr)]
            flat = lambda a: a[:n].reshape(n * Hb, -1)
            d, _ = gate_prefilter(flat(mocc), flat(ppB), flat(ppE),
                                  np.repeat(l_arr[:n], Hb))
            d = d.reshape(n, Hb)
            for jj, colj in enumerate(cols):
                dec[s:s + n, colj] = d[:, jj]
                if rows_keep is not None:
                    rows_keep[0][s:s + n, colj] = mocc[:n, jj]
                    rows_keep[1][s:s + n, colj] = ppB[:n, jj]
                    rows_keep[2][s:s + n, colj] = ppE[:n, jj]
    if return_rows:
        return dec, rows_keep
    return dec


def find_regions_rows(mocc: np.ndarray, ppB: np.ndarray,
                      ppE: np.ndarray, L: int
                      ) -> List[Tuple[int, int]]:
    """p7_domaindef region scan on one pair's rows (host semantics
    identical to hmm/domaindef.py:find_regions)."""
    dB = np.zeros(L + 1)
    dB[1:] = ppB[:L]
    dE = np.zeros(L + 1)
    dE[1:] = ppE[1:L + 1]
    regions = []
    i2 = -1
    triggered = False
    for i in range(1, L + 1):
        if not triggered:
            if mocc[i] - dB[i] < RT2:
                i2 = i
            elif i2 == -1:
                i2 = i
            if mocc[i] >= RT1:
                triggered = True
        else:
            if mocc[i] - dE[i] < RT2:
                regions.append((max(i2, 1), i))
                i2 = -1
                triggered = False
    if triggered:
        regions.append((max(i2, 1), L))
    return regions


def gate_prefilter(mocc: np.ndarray, ppB: np.ndarray, ppE: np.ndarray,
                   qlens: np.ndarray):
    """Three-way gate decision from batched rows.

    mocc/ppB/ppE: [N, Lmax+1] (one row set per pair, any batch
    flattening); qlens: [N]. Returns (decision [N] int8,
    pending regions list): decision -1 = not reported (no region),
    +1 = reported (some region is deterministically a single
    envelope), 0 = pending — `pending[k]` lists the multidomain
    regions [(i, j), ...] of pair k that the host trace ensemble
    must resolve (hmm/trace_ensemble.py:resolve_region).
    """
    N, Lp1 = mocc.shape
    decision = np.full(N, -1, np.int8)
    pending: List[List[Tuple[int, int]]] = [[] for _ in range(N)]
    # vectorized short-circuit: no row with mocc >= RT1 can have a
    # region (the trigger never fires) — the common case on a full
    # grid (most pairs are non-homologous)
    may = np.flatnonzero((mocc >= RT1).any(axis=1))
    for k in may:
        L = int(qlens[k])
        regions = find_regions_rows(mocc[k], ppB[k], ppE[k], L)
        if not regions:
            continue
        btot = np.cumsum(np.concatenate([[0.0], ppB[k][:L]]))
        etot = np.cumsum(np.concatenate([[0.0], ppE[k][1:L + 1]]))
        multi = []
        for (i, j) in regions:
            ps = np.arange(i, j + 1)
            epre = (etot[ps] - etot[i - 1]).astype(np.float32)
            bpost = (btot[j] - btot[ps - 1]).astype(np.float32)
            if float(np.minimum(epre, bpost).max()) < RT3:
                decision[k] = 1
                multi = []
                break
            multi.append((i, j))
        if decision[k] != 1 and multi:
            decision[k] = 0
            pending[k] = multi
    return decision, pending
