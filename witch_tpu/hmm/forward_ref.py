"""Reference (numpy, float64, log-space) Forward/Backward/posterior for
calibration. The production device kernels are validated against this module;
this module is validated against the bundled HMMER 3.1b2 binaries.

Replaces the compute contract of `hmmsearch --noali -E 99999999 --max`
(reference witch_msa/gcmm/algorithm.py:524-537): full-sequence Forward
bit score in multihit local mode, null1-corrected, with the null2
biased-composition correction.
"""

from __future__ import annotations

import numpy as np

from .profile import Profile, null1_score


def _logsumexp2(a, b):
    m = np.maximum(a, b)
    out = m + np.log1p(np.exp(-np.abs(a - b)))
    return np.where(np.isneginf(m), -np.inf, out)


def forward_matrices(prof: Profile, codes: np.ndarray):
    """Full Forward DP. codes: [L] encoded query (no gaps).

    Returns (fwd_nats, dict of matrices) where matrices are [L+1, M+1]
    (row 0 = before any residue) plus special-state vectors [L+1].
    """
    M = prof.M
    L = len(codes)
    loop, move = prof.length_model(L)
    e_loop, e_move = prof.xsc_e_loop, prof.xsc_e_move

    NEG = -np.inf
    Mx = np.full((L + 1, M + 1), NEG)
    Ix = np.full((L + 1, M + 1), NEG)
    Dx = np.full((L + 1, M + 1), NEG)
    N = np.full(L + 1, NEG)
    B = np.full(L + 1, NEG)
    E = np.full(L + 1, NEG)
    J = np.full(L + 1, NEG)
    C = np.full(L + 1, NEG)

    N[0] = 0.0
    B[0] = move  # N->B

    tmm, tim, tdm = prof.t_mm, prof.t_im, prof.t_dm
    tmi, tii = prof.t_mi, prof.t_ii
    tmd, tdd = prof.t_md, prof.t_dd
    bm = prof.bm

    for i in range(1, L + 1):
        x = codes[i - 1]
        ms = prof.msc[:, x]          # [M+1]
        # match: from M/I/D at k-1 of previous row, or B (entry)
        prevM = Mx[i - 1, :-1]       # k-1 = 0..M-1
        prevI = Ix[i - 1, :-1]
        prevD = Dx[i - 1, :-1]
        src = _logsumexp2(
            _logsumexp2(prevM + tmm[:-1], prevI + tim[:-1]),
            _logsumexp2(prevD + tdm[:-1], B[i - 1] + bm[1:]))
        Mx[i, 1:] = src + ms[1:]
        # insert: from M/I at k of previous row (no I_M)
        Ix[i, 1:M] = _logsumexp2(Mx[i - 1, 1:M] + tmi[1:M],
                                 Ix[i - 1, 1:M] + tii[1:M])
        # delete chain: D[k] = lse(M[k-1]+tmd[k-1], D[k-1]+tdd[k-1]);
        # closed form via cumulative logs: D[k] = ca[k] + lse_{j<=k}(b[j]-ca[j])
        b = np.full(M + 1, NEG)
        b[2:] = Mx[i, 1:M] + tmd[1:M]
        ca = np.zeros(M + 1)
        ca[2:] = np.cumsum(tdd[1:M])  # ca[k] = sum of tdd[1..k-1]
        with np.errstate(invalid="ignore"):
            Dx[i, 2:] = (ca + np.logaddexp.accumulate(b - ca))[2:]
        # E: all M_k and D_k exit free (local)
        E[i] = _logsumexp2(
            np.logaddexp.reduce(Mx[i, 1:]),
            np.logaddexp.reduce(Dx[i, 2:]) if M >= 2 else NEG)
        J[i] = _logsumexp2(J[i - 1] + loop, E[i] + e_loop)
        C[i] = _logsumexp2(C[i - 1] + loop, E[i] + e_move)
        N[i] = N[i - 1] + loop
        B[i] = _logsumexp2(N[i] + move, J[i] + move)

    fwd = C[L] + move
    return fwd, dict(M=Mx, I=Ix, D=Dx, N=N, B=B, E=E, J=J, C=C)


def forward_score(prof: Profile, codes: np.ndarray) -> float:
    fwd, _ = forward_matrices(prof, codes)
    return fwd


def backward_matrices(prof: Profile, codes: np.ndarray):
    """Backward DP matching forward_matrices' conventions (vectorized)."""
    M = prof.M
    L = len(codes)
    loop, move = prof.length_model(L)
    e_loop, e_move = prof.xsc_e_loop, prof.xsc_e_move
    NEG = -np.inf

    Mx = np.full((L + 1, M + 1), NEG)
    Ix = np.full((L + 1, M + 1), NEG)
    Dx = np.full((L + 1, M + 1), NEG)
    N = np.full(L + 1, NEG)
    B = np.full(L + 1, NEG)
    E = np.full(L + 1, NEG)
    J = np.full(L + 1, NEG)
    C = np.full(L + 1, NEG)

    tmm, tim, tdm = prof.t_mm, prof.t_im, prof.t_dm
    tmi, tii = prof.t_mi, prof.t_ii
    tmd, tdd = prof.t_md, prof.t_dd
    bm = prof.bm

    C[L] = move
    E[L] = C[L] + e_move

    neg_row = np.full(M + 1, NEG)

    def dchain(Ei, Mnext, ms):
        """D_k = lse(Mnext[k+1]+ms[k+1]+tdm[k], D_{k+1}+tdd[k], Ei),
        computed right-to-left via the cumulative-log trick."""
        c = np.full(M + 1, NEG)
        if M >= 2:
            c[1:M] = np.logaddexp(Mnext[2:M + 1] + ms[2:M + 1] + tdm[1:M],
                                  Ei)
        else:
            pass
        c[M] = Ei
        # ca[k] = sum of tdd[k..M-1]
        ca = np.zeros(M + 1)
        if M >= 2:
            ca[1:M] = np.cumsum(tdd[1:M][::-1])[::-1]
        with np.errstate(invalid="ignore"):
            rev = np.logaddexp.accumulate((c - ca)[::-1])[::-1]
            out = ca + rev
        out[0] = NEG
        return out

    for i in range(L, -1, -1):
        if i == L:
            Mnext = Inext = neg_row
            ms = neg_row
            Bv = NEG
            N[L] = NEG
            J[L] = NEG
        else:
            x = codes[i]
            ms = prof.msc[:, x]
            Mnext, Inext = Mx[i + 1], Ix[i + 1]
            Bv = np.logaddexp.reduce(bm[1:] + ms[1:] + Mnext[1:])
            B[i] = Bv
            N[i] = _logsumexp2(N[i + 1] + loop, Bv + move)
            J[i] = _logsumexp2(J[i + 1] + loop, Bv + move)
            C[i] = C[i + 1] + loop
            E[i] = _logsumexp2(C[i] + e_move, J[i] + e_loop)
        Dx[i] = dchain(E[i], Mnext, ms)
        with np.errstate(invalid="ignore"):
            # match: E exit, M->M_{k+1}, M->I_k, M->D_{k+1}
            v = np.full(M + 1, E[i])
            v[1:M] = np.logaddexp(
                np.logaddexp(v[1:M],
                             Mnext[2:M + 1] + ms[2:M + 1] + tmm[1:M]),
                np.logaddexp(Inext[1:M] + tmi[1:M],
                             Dx[i, 2:M + 1] + tmd[1:M]))
            v[0] = NEG
            Mx[i] = v
            # insert
            Ix[i, 1:M] = np.logaddexp(Mnext[2:M + 1] + ms[2:M + 1] + tim[1:M],
                                      Inext[1:M] + tii[1:M])
            Ix[i, 0] = NEG
            Ix[i, M] = NEG

    bck = N[0]
    return bck, dict(M=Mx, I=Ix, D=Dx, N=N, B=B, E=E, J=J, C=C)


def bit_score(prof: Profile, codes: np.ndarray) -> float:
    """Null1-corrected pre-score in bits (no null2)."""
    fwd = forward_score(prof, codes)
    return (fwd - null1_score(len(codes))) / np.log(2.0)
