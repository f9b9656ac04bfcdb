"""Consistency-based multiple alignment (the backbone quality engine).

The reference's scenario-A backbone quality comes from MAFFT L-INS-i
inside MAGUS (witch_msa/tools/magus/align/aligner.py:69-102 +
external_tools.py:48-66): all-pairs local alignments feeding a
consistency objective plus iterative refinement. Progressive-only
methods collapse on the twilight-zone data WITCH targets (measured on
examples/data: SP recall ~0.01 progressive vs 0.47-0.54 for
L-INS-i/MAGUS), so this module implements the probabilistic-consistency
architecture (ProbCons-style) on this codebase's array conventions:

  1. pair-HMM match posteriors for all sequence pairs
     (native/pairhmm_kernel.cpp: [pairs, L, L] wavefront with per-row
     rescale);
  2. one or more consistency transforms P'_xz = mean_y P_xy P_yz
     (sparse float32 matmuls);
  3. expected-accuracy guide tree (UPGMA over 1 - pairwise EA);
  4. progressive profile merge maximizing summed posteriors
     (native ea_align NW, gap cost 0);
  5. randomized iterative refinement (bipartition, re-project,
     realign) keeping improvements of the EA objective.

This engine aligns the *subsets* (<= ~60 seqs); the full-backbone
driver (align_backbone_consistency) clusters larger inputs into
phylogenetic neighborhoods via the anchor-EA embedding, aligns each
with the core, and merges along a subset-level UPGMA with merge-time
sampled cross-subset posteriors.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .core.alignment import PackedAlignment
from .core.alphabet import ALPHABETS, Alphabet


def _hky_joint(bg: np.ndarray, kappa: float,
               target_identity: float) -> np.ndarray:
    """[4, 4] HKY joint P(a, b) at the divergence whose expected
    identity matches target_identity (canonical ACGT order:
    transitions A<->G, C<->T weighted kappa; same construction as
    tree_estimate.ml_refine's rate matrix)."""
    K = 4
    S = np.ones((K, K))
    S[0, 2] = S[2, 0] = kappa
    S[1, 3] = S[3, 1] = kappa
    Q = S * bg[None, :]
    np.fill_diagonal(Q, 0.0)
    np.fill_diagonal(Q, -Q.sum(1))
    Q /= -(bg * np.diag(Q)).sum()
    d = np.sqrt(bg)
    B = Q * d[:, None] / d[None, :]
    lam, U = np.linalg.eigh(0.5 * (B + B.T))
    A = U / d[:, None]
    Ainv = U.T * d[None, :]

    def ident(t):
        P = (A * np.exp(lam * t)) @ Ainv
        return float((bg * np.diag(P)).sum())

    lo, hi = 0.0, 50.0
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        if ident(mid) > target_identity:
            lo = mid
        else:
            hi = mid
    t = 0.5 * (lo + hi)
    P = (A * np.exp(lam * t)) @ Ainv
    J = bg[:, None] * P
    return 0.5 * (J + J.T)


def _emission_odds(alphabet: Alphabet, match_p: float,
                   kappa: Optional[float] = None) -> np.ndarray:
    """[num_codes, num_codes] match emission odds for the pair HMM.

    Canonical joint: P(a,b) = p*pi_a*[a==b] + (1-p)*pi_a*pi_b with the
    molecule background pi; degenerate codes get expectation under
    their expansion; gap codes (never present in degapped input) are
    neutral 1.0. With kappa (nucleic only), the joint instead comes
    from an HKY substitution process at the divergence that matches
    the same expected identity — transitions score above
    transversions, the distinction the identity mixture cannot make.
    """
    from .hmm.priors import get_background
    K = alphabet.K
    bg = get_background(alphabet.name)
    if kappa is not None and K == 4:
        target = match_p + (1.0 - match_p) * float((bg ** 2).sum())
        joint = _hky_joint(bg, kappa, target)
    else:
        joint = match_p * np.diag(bg) \
            + (1.0 - match_p) * np.outer(bg, bg)
    odds4 = joint / np.outer(bg, bg)
    E = alphabet.expansion_matrix()            # [C, K], gap row zero
    em = E @ odds4 @ E.T
    zero = E.sum(axis=1) == 0
    em[zero, :] = 1.0
    em[:, zero] = 1.0
    return np.ascontiguousarray(em, np.float64)


def pairwise_posteriors(codes: List[np.ndarray], alphabet: Alphabet,
                        match_p: float = 0.35, delta: float = 0.04,
                        eps: float = 0.75, cutoff: float = 0.01,
                        kappa: Optional[float] = None,
                        workers: int = 8):
    """All-pairs sparse match posteriors + EA distance matrix.

    Returns (post, D): post[(s, t)] for s < t is a scipy CSR matrix
    [len_s, len_t] of match posteriors; D is the [n, n] 1-EA distance.
    """
    import scipy.sparse as sp
    from .native import _pairhmm

    em = _emission_odds(alphabet, match_p, kappa)
    n = len(codes)
    codes32 = [np.ascontiguousarray(c, np.int32) for c in codes]
    tasks = [(s, t) for s in range(n) for t in range(s + 1, n)]

    def one(st):
        s, t = st
        I, J, P, ea = _pairhmm.posterior(codes32[s], codes32[t], em,
                                         delta, eps, cutoff)
        m = sp.csr_matrix((P, (I, J)),
                          shape=(len(codes32[s]), len(codes32[t])),
                          dtype=np.float32)
        return s, t, m, ea

    D = np.zeros((n, n))
    post: Dict[Tuple[int, int], object] = {}
    with ThreadPoolExecutor(max_workers=workers) as ex:
        for s, t, m, ea in ex.map(one, tasks):
            post[(s, t)] = m
            D[s, t] = D[t, s] = 1.0 - ea
    return post, D


def _get(post, s, t):
    if s == t:
        return None
    if (s, t) in post:
        return post[(s, t)]
    if (t, s) in post:
        return post[(t, s)].T.tocsr()
    return None


def _coo(post, s, t, cache):
    """(I, J, P) triplets of the (s, t) posterior, memoized.

    The refinement loops hit every pair hundreds of times; scipy's
    tocoo()/.T.tocsr() allocations dominated subset alignment before
    this cache (profiled 47s of 62s in refine_bipartitions at n=40).
    Missing pairs are NOT cached (the merge loop adds pairs lazily).
    """
    if s == t:
        return None
    r = cache.get((s, t))
    if r is not None:
        return r
    if (s, t) in post:
        m = post[(s, t)].tocoo()
        r = (m.row.astype(np.int64), m.col.astype(np.int64),
             m.data.astype(np.float64))
    elif (t, s) in post:
        m = post[(t, s)].tocoo()
        r = (m.col.astype(np.int64), m.row.astype(np.int64),
             m.data.astype(np.float64))
    else:
        return None
    cache[(s, t)] = r
    return r


def consistency_transform(post, n: int, cutoff: float = 0.01,
                          workers: int = 8, lens=None, sims=None):
    """One round of P'_xz = (2 P_xz + sum_{y!=x,z} w_y P_xy P_yz) / W.

    Unweighted (sims=None): w_y = 1, W = n — the classic ProbCons
    transform.  With `sims` ([n, n] similarity, e.g. pairwise EA),
    w_y = sims[x, y] * sims[y, z] and W = 2 + sum w_y — MSAProbs-style
    weighted consistency that discounts diverged relay sequences.

    Uses the native threaded SpGEMM (pairhmm_kernel.cpp:transform);
    falls back to scipy when the extension is absent.
    """
    import scipy.sparse as sp

    keys = list(post.keys())
    if sims is not None:
        sims = np.ascontiguousarray(sims, np.float64)
    try:
        from .native import _pairhmm
        if lens is None:
            ln = {}
            for (s, t), m in post.items():
                ln[s], ln[t] = m.shape
            lens = np.zeros(n, np.int32)
            for s, L in ln.items():
                lens[s] = L
        ks = np.ascontiguousarray([k[0] for k in keys], np.int32)
        kt = np.ascontiguousarray([k[1] for k in keys], np.int32)
        ipl = [np.ascontiguousarray(post[k].indptr, np.int64)
               for k in keys]
        ixl = [np.ascontiguousarray(post[k].indices, np.int32)
               for k in keys]
        vl = [np.ascontiguousarray(post[k].data, np.float32)
              for k in keys]
        args9 = (n, ks, kt, ipl, ixl, vl,
                 np.ascontiguousarray(lens, np.int32),
                 float(cutoff), int(workers))
        try:
            res = _pairhmm.transform(*args9, sims)
        except TypeError:
            # Stale pre-sims _pairhmm.so (autobuild only fires when the
            # .so is missing): retry the legacy 9-arg signature when the
            # weighted path was not requested, else rebuild via scipy.
            if sims is not None:
                raise ImportError("stale _pairhmm.so lacks sims support")
            res = _pairhmm.transform(*args9)
        out = {}
        for k, (ip, ix, va) in zip(keys, res):
            out[k] = sp.csr_matrix((va, ix, ip), shape=post[k].shape)
        return out
    except ImportError:
        pass

    def one(key):
        x, z = key
        acc = 2.0 * post[key]
        denom = float(n) if sims is None else 2.0
        for y in range(n):
            if y == x or y == z:
                continue
            w = 1.0
            if sims is not None:
                w = float(sims[x, y] * sims[y, z])
                denom += w
                if w < 1e-3:
                    continue
            a = _get(post, x, y)
            b = _get(post, y, z)
            acc = acc + w * (a @ b)
        acc = acc * (1.0 / denom)
        acc.data[acc.data < cutoff] = 0.0
        acc.eliminate_zeros()
        return key, acc.tocsr()

    out = {}
    with ThreadPoolExecutor(max_workers=workers) as ex:
        for key, m in ex.map(one, keys):
            out[key] = m
    return out


def _residue_cols(codes_mat: np.ndarray, gap_code: int) -> List[np.ndarray]:
    """Per-row array mapping residue index -> column index."""
    out = []
    for row in codes_mat:
        out.append(np.flatnonzero(row != gap_code).astype(np.int64))
    return out


def _group_score(post, rowsA: Sequence[int], colsA: List[np.ndarray],
                 WA: int, rowsB: Sequence[int], colsB: List[np.ndarray],
                 WB: int, cache=None) -> np.ndarray:
    """[WA, WB] summed posterior mass between two aligned groups."""
    if cache is None:
        cache = {}
    try:
        from .native import _pairhmm
        if hasattr(_pairhmm, "group_score"):
            cal, cbl, Il, Jl, Pl = [], [], [], [], []
            for ai, s in enumerate(rowsA):
                for bi, t in enumerate(rowsB):
                    c = _coo(post, s, t, cache)
                    if c is None or len(c[2]) == 0:
                        continue
                    cal.append(colsA[ai])
                    cbl.append(colsB[bi])
                    Il.append(c[0])
                    Jl.append(c[1])
                    Pl.append(c[2])
            return np.asarray(_pairhmm.group_score(int(WA), int(WB),
                                                   cal, cbl, Il, Jl, Pl))
    except ImportError:
        pass
    S = np.zeros(WA * WB, np.float64)
    idx_chunks, val_chunks, pend = [], [], 0
    for ai, s in enumerate(rowsA):
        ca = colsA[ai]
        for bi, t in enumerate(rowsB):
            c = _coo(post, s, t, cache)
            if c is None or len(c[2]) == 0:
                continue
            I, J, P = c
            idx_chunks.append(ca[I] * WB + colsB[bi][J])
            val_chunks.append(P)
            pend += len(P)
            if pend > 4_000_000:
                S += np.bincount(np.concatenate(idx_chunks),
                                 np.concatenate(val_chunks),
                                 minlength=WA * WB)
                idx_chunks, val_chunks, pend = [], [], 0
    if idx_chunks:
        S += np.bincount(np.concatenate(idx_chunks),
                         np.concatenate(val_chunks), minlength=WA * WB)
    return S.reshape(WA, WB)


def _align_groups(post, A_rows, A_codes, B_rows, B_codes, gap_code,
                  cache=None, want_score=False):
    from .native import _oa  # noqa: F401  (ensures package import order)
    from .native import _pairhmm
    colsA = _residue_cols(A_codes, gap_code)
    colsB = _residue_cols(B_codes, gap_code)
    S = _group_score(post, A_rows, colsA, A_codes.shape[1],
                     B_rows, colsB, B_codes.shape[1], cache=cache)
    ops = np.asarray(_pairhmm.ea_align(np.ascontiguousarray(S)), np.int8)
    nA, nB = A_codes.shape[0], B_codes.shape[0]
    W = len(ops)
    out = np.full((nA + nB, W), gap_code, np.uint8)
    out[:nA, np.flatnonzero(ops != 2)] = A_codes
    out[nA:, np.flatnonzero(ops != 1)] = B_codes
    score = None
    if want_score:
        # cross-group mass realized by the NW solution: matched
        # columns' S cells (= the DP's objective value)
        mk = ops == 0
        ai = np.cumsum(ops != 2) - 1
        bi = np.cumsum(ops != 1) - 1
        score = float(S[ai[mk], bi[mk]].sum())
    return out, list(A_rows) + list(B_rows), score


def _ea_objective(post, rows, codes_mat, gap_code, cache=None) -> float:
    """Total pairwise posterior mass realized by the alignment."""
    if cache is None:
        cache = {}
    cols = _residue_cols(codes_mat, gap_code)
    total = 0.0
    n = len(rows)
    for ai in range(n):
        for bi in range(ai + 1, n):
            c = _coo(post, rows[ai], rows[bi], cache)
            if c is None or len(c[2]) == 0:
                continue
            I, J, P = c
            hit = cols[ai][I] == cols[bi][J]
            total += float(P[hit].sum())
    return total


def _cross_mass(post, rows_a, cols_a, rows_b, cols_b, cache) -> float:
    """Posterior mass realized between two row groups of one
    alignment (cols_* map residue index -> current column)."""
    total = 0.0
    for ai, s in enumerate(rows_a):
        ca = cols_a[ai]
        for bi, t in enumerate(rows_b):
            c = _coo(post, s, t, cache)
            if c is None or len(c[2]) == 0:
                continue
            I, J, P = c
            hit = ca[I] == cols_b[bi][J]
            total += float(P[hit].sum())
    return total


def estimate_params(codes: List[np.ndarray], alphabet: Alphabet,
                    workers: int = 8, seed: int = 0, sample: int = 12,
                    kappa: Optional[float] = None
                    ) -> Tuple[float, float, float]:
    """Adaptive pair-HMM parameters from a probe pass.

    Aligns a small sample of sequence pairs at fixed probe parameters
    and maps the mean expected accuracy (fraction of confidently
    alignable residues — a divergence proxy that separates data
    classes far better than raw identity) linearly onto
    (match_p, delta). Calibrated on the example 16S twilight-zone set
    (EA 0.36 -> mp 0.12, de 0.010) and a moderately diverged synthetic
    family (EA 0.61 -> mp 0.52, de 0.050); the midpoint was validated
    to land on the recall plateau.

    Returns (match_p, delta, mean_ea).
    """
    n = len(codes)
    rng = np.random.default_rng(seed)
    idx = rng.choice(n, min(sample, n), replace=False)
    sub = [codes[i] for i in idx]
    _, D = pairwise_posteriors(sub, alphabet, match_p=0.3, delta=0.02,
                               eps=0.75, cutoff=0.05, kappa=kappa,
                               workers=workers)
    m = len(sub)
    if m < 2:
        return 0.3, 0.02, 0.5
    e = 1.0 - float(D[np.triu_indices(m, 1)].mean())
    mp = float(np.clip(0.12 + 1.6 * (e - 0.36), 0.10, 0.60))
    de = float(np.clip(0.01 + 0.16 * (e - 0.36), 0.008, 0.06))
    return mp, de, e


def refine_bipartitions(post, rows, mat, gap_code, rounds: int,
                        rng, groups: Optional[List[np.ndarray]] = None,
                        cache=None):
    """Randomized EA refinement: bipartition rows, re-project, realign.

    `groups` (optional) gives additional structured bipartitions to try
    (e.g. one subset vs the rest) before the random ones; each group is
    a collection of ROW IDS (not positions — accepted moves reorder the
    rows).

    Acceptance is incremental: re-projecting a bipartition keeps each
    side's internal alignment intact, so only the CROSS-group realized
    mass changes — the NW solution's own score (want_score) vs the
    current cross mass. Equivalent to comparing full EA objectives, at
    a quarter of the cost.
    """
    if cache is None:
        cache = {}
    n = len(rows)
    if n < 3:
        return rows, mat, _ea_objective(post, rows, mat, gap_code,
                                        cache=cache)
    splits = [set(g) for g in (groups or [])]
    n_random = max(0, rounds)
    for k in range(len(splits) + n_random):
        if k < len(splits):
            gset = splits[k]
            mask = np.array([r in gset for r in rows])
        else:
            mask = rng.random(n) < 0.5
        if not (0 < mask.sum() < n):
            continue
        ia = np.flatnonzero(mask)
        ib = np.flatnonzero(~mask)
        A_codes = mat[ia]
        B_codes = mat[ib]
        A_codes = A_codes[:, ~(A_codes == gap_code).all(axis=0)]
        B_codes = B_codes[:, ~(B_codes == gap_code).all(axis=0)]
        ra = [rows[i] for i in ia]
        rb = [rows[i] for i in ib]
        cols_all = _residue_cols(mat, gap_code)
        cur_cross = _cross_mass(post, ra, [cols_all[i] for i in ia],
                                rb, [cols_all[i] for i in ib], cache)
        merged, new_rows, new_cross = _align_groups(
            post, ra, A_codes, rb, B_codes, gap_code, cache=cache,
            want_score=True)
        if new_cross > cur_cross + 1e-9:
            rows, mat = new_rows, merged
    return rows, mat, _ea_objective(post, rows, mat, gap_code,
                                    cache=cache)


def consistency_align_core(codes: List[np.ndarray], alphabet: Alphabet,
                           match_p: Optional[float] = None,
                           delta: Optional[float] = None,
                           eps: float = 0.75, rounds: int = 1,
                           refine_rounds: int = 50, cutoff: float = 0.01,
                           kappa: Optional[float] = None,
                           seed: int = 0, workers: int = 8,
                           weighted: bool = False, log=None):
    """ProbCons-style alignment core.

    match_p/delta default to adaptive estimation (estimate_params).
    Returns (rows, mat, post, D): row order (indices into codes), the
    aligned uint8 matrix, the transformed posteriors, and the pairwise
    EA distance matrix.
    """
    from .backbone_progressive import upgma_merges

    n = len(codes)
    gap_code = alphabet.gap_code
    if n == 1:
        return [0], codes[0][None, :].astype(np.uint8), {}, \
            np.zeros((1, 1))
    if match_p is None or delta is None:
        mp_e, de_e, e = estimate_params(codes, alphabet, workers=workers,
                                        seed=seed, kappa=kappa)
        match_p = mp_e if match_p is None else match_p
        delta = de_e if delta is None else delta
        if log:
            log("consistency: adaptive params mean_ea=%.3f -> "
                "match_p=%.3f delta=%.3f" % (e, match_p, delta))

    post, D = pairwise_posteriors(codes, alphabet, match_p=match_p,
                                  delta=delta, eps=eps, cutoff=cutoff,
                                  kappa=kappa, workers=workers)
    if log:
        log("consistency: %d pair posteriors, mean EA dist %.3f"
            % (len(post), float(D[np.triu_indices(n, 1)].mean())))
    sims = None
    if weighted:
        sims = np.clip(1.0 - D, 0.0, 1.0)
        if int(weighted) >= 2:
            # relative weighting only: normalize so the mean relay
            # weight is ~1 (raw EA products over-crush relays in the
            # twilight zone, measured: SP 0.875/0.789 vs 0.877/0.792)
            m = float(sims[np.triu_indices(n, 1)].mean())
            if m > 0:
                sims = sims / m
    for r in range(rounds):
        post = consistency_transform(post, n, cutoff=cutoff,
                                     workers=workers, sims=sims)

    merges = upgma_merges(D)
    node: Dict[int, Tuple[List[int], np.ndarray]] = {
        i: ([i], codes[i][None, :].astype(np.uint8)) for i in range(n)}
    clades: List[List[int]] = []
    cache: Dict = {}
    for t, (a, b) in enumerate(merges):
        (ra, ca), (rb, cb) = node.pop(a), node.pop(b)
        merged, rows, _ = _align_groups(post, ra, ca, rb, cb, gap_code,
                                        cache=cache)
        node[n + t] = (rows, merged)
        if 1 < len(rows) < n:
            clades.append(list(rows))
    rows, mat = node[n + len(merges) - 1]

    # tree-edge bipartitions first (every guide-tree clade vs the
    # rest — the refinement schedule L-INS-i's dvtditr uses), then
    # random splits
    rng = np.random.default_rng(seed)
    rows, mat, cur_obj = refine_bipartitions(post, rows, mat, gap_code,
                                             refine_rounds, rng,
                                             groups=clades, cache=cache)
    if log:
        log("consistency: %d seqs -> %d cols (EA obj %.1f)"
            % (n, mat.shape[1], cur_obj))
    return rows, mat, post, D


def consistency_align(names: List[str], seqs: List[str], molecule: str,
                      match_p: Optional[float] = None,
                      delta: Optional[float] = None,
                      eps: float = 0.75, rounds: int = 1,
                      refine_rounds: int = 50, cutoff: float = 0.01,
                      kappa: Optional[float] = None,
                      seed: int = 0, workers: int = 8,
                      log=None) -> PackedAlignment:
    """ProbCons-style alignment of up to ~80 sequences."""
    alphabet = ALPHABETS[molecule]
    seqs = [s.upper() for s in seqs]
    codes = [alphabet.encode(s) for s in seqs]
    rows, mat, _, _ = consistency_align_core(
        codes, alphabet, match_p=match_p, delta=delta, eps=eps,
        rounds=rounds, refine_rounds=refine_rounds, cutoff=cutoff,
        kappa=kappa, seed=seed, workers=workers, log=log)
    aln = PackedAlignment([names[i] for i in rows], mat, alphabet)
    aln, _ = aln.delete_all_gap_columns()
    order = {nm: i for i, nm in enumerate(aln.names)}
    sel = [order[nm] for nm in names]
    return PackedAlignment(list(names), aln.codes[sel], alphabet)


def profile_posterior(fA, occA, fB, occB, odds4, delta, eps,
                      cutoff=0.01):
    """Pair-HMM posterior between two alignment COLUMN profiles.

    Emission odds per column pair interpolate between neutral (1.0)
    and the expected residue-pair odds, weighted by the probability
    both columns carry a residue on an aligned row pair
    (occA*occB) — low-occupancy private insert columns carry little
    evidence either way. Returns (I, J, P float32, ea)."""
    from .native import _pairhmm
    core = (fA @ odds4) @ fB.T
    EM = 1.0 + (occA[:, None] * occB[None, :]) * (core - 1.0)
    return _pairhmm.posterior_dense(
        np.ascontiguousarray(np.maximum(EM, 1e-6), np.float64),
        delta, eps, cutoff)


def _column_profile(mat: np.ndarray, alphabet: Alphabet):
    """(freq [W, K] residue distribution, occ [W] non-gap fraction)."""
    expand = alphabet.expansion_matrix()
    Wd = mat.shape[1]
    counts = np.zeros((Wd, alphabet.K), np.float64)
    for c in range(expand.shape[0]):
        if not expand[c].any():
            continue
        nc = (mat == c).sum(axis=0).astype(np.float64)
        if nc.any():
            counts += nc[:, None] * expand[c][None, :]
    tot = counts.sum(axis=1)
    occ = tot / max(mat.shape[0], 1)
    freq = counts / np.maximum(tot, 1e-9)[:, None]
    return freq, occ





def _device_embedding(codes32, anchors, em, delta, eps,
                      chunk: int = 1024) -> np.ndarray:
    """[n, A] normalized pair-HMM forward log-odds on device.

    One scalar per (sequence, anchor) pair leaves the device (the
    posteriors themselves never leave device memory). Scores are
    forward log-odds per
    min-length residue: a monotone divergence proxy on the same
    footing as the native path's expected accuracy for the purposes of
    k-means neighborhoods / farthest-point geometry.
    """
    import jax.numpy as jnp

    from .ops.pairhmm_forward import pairhmm_forward_logodds

    n = len(codes32)
    A = len(anchors)
    lens = np.array([len(c) for c in codes32], np.int64)
    LBp = max(128, -(-int(lens[anchors].max()) // 128) * 128)
    anc = np.zeros((A, LBp), np.int32)
    for t, ai in enumerate(anchors):
        anc[t, :lens[ai]] = codes32[ai]
    emj = jnp.asarray(em, jnp.float32)

    pairs = [(s, t) for s in range(n) for t in range(A)]
    pairs.sort(key=lambda st: lens[st[0]])
    E = np.zeros((n, A), np.float64)
    for off in range(0, len(pairs), chunk):
        blk = pairs[off:off + chunk]
        P = len(blk)
        LAp = max(128, -(-int(max(lens[s] for s, _ in blk)) // 128) * 128)
        # pad the batch dim only to the next multiple of 128 (not the
        # full chunk) so the trailing partial block doesn't waste
        # chunk-1 rows of compute
        Pp = max(128, -(-P // 128) * 128)
        cA = np.zeros((Pp, LAp), np.int32)
        lA = np.ones(Pp, np.int32)
        cB = np.zeros((Pp, LBp), np.int32)
        lB = np.ones(Pp, np.int32)
        for r, (s, t) in enumerate(blk):
            cA[r, :lens[s]] = codes32[s]
            lA[r] = lens[s]
            cB[r] = anc[t]
            lB[r] = lens[anchors[t]]
        lo = np.asarray(pairhmm_forward_logodds(
            jnp.asarray(cA), jnp.asarray(lA), jnp.asarray(cB),
            jnp.asarray(lB), emj, delta, eps))[:P]
        for r, (s, t) in enumerate(blk):
            E[s, t] = lo[r] / max(1, min(lens[s], lens[anchors[t]]))
    return E


def anchor_embedding(codes: List[np.ndarray], alphabet: Alphabet,
                     n_anchors: int = 24, match_p: float = 0.3,
                     delta: float = 0.02, eps: float = 0.75,
                     workers: int = 8, seed: int = 0,
                     use_device: Optional[bool] = None) -> np.ndarray:
    """[n, A] expected-accuracy embedding against farthest-point anchors.

    k-mer distances are noise on twilight-zone inputs, but pair-HMM
    expected accuracy still resolves neighborhoods (the example
    backbone has mean nearest-neighbor identity 0.59 against mean
    pairwise 0.31). Each sequence is embedded by its EA to a diverse
    anchor set; clustering on this embedding recovers phylogenetic
    neighborhoods the way MAGUS's guide-tree decomposition does.

    use_device=True (or WITCH_TPU_DEVICE_EMBED=1) replaces the native
    EA with batched device forward scans (_device_embedding). Measured
    on 150 real backbone seqs: per-anchor correlation with EA only
    ~0.68 (co-cluster agreement 0.72) — forward log-odds is NOT a
    validated EA stand-in, and the AVX-512 pair-HMM kernel already
    runs the native embedding in seconds, so the device path stays
    opt-in (kept for experiments at much larger n).
    """
    from .backbone import _kmer_profiles
    from .native import _pairhmm

    n = len(codes)
    A = min(n_anchors, n)
    prof = _kmer_profiles(codes, alphabet.K)
    rng = np.random.default_rng(seed)
    anchors = [int(rng.integers(n))]
    d = 1.0 - prof @ prof[anchors[0]]
    for _ in range(A - 1):
        anchors.append(int(np.argmax(d)))
        d = np.minimum(d, 1.0 - prof @ prof[anchors[-1]])
    em = _emission_odds(alphabet, match_p)
    codes32 = [np.ascontiguousarray(c, np.int32) for c in codes]

    if use_device is None:
        use_device = os.environ.get(
            "WITCH_TPU_DEVICE_EMBED", "") not in ("", "0", "false")
    if use_device:
        return _device_embedding(codes32, anchors, em, delta, eps)

    E = np.zeros((n, A), np.float64)

    def one(task):
        s, ai = task
        _, _, _, ea = _pairhmm.posterior(codes32[s], codes32[anchors[ai]],
                                         em, delta, eps, 0.5)
        return s, ai, ea

    tasks = [(s, ai) for s in range(n) for ai in range(A)]
    with ThreadPoolExecutor(max_workers=workers) as ex:
        for s, ai, ea in ex.map(one, tasks):
            E[s, ai] = ea
    return E


def _kmeans_rows(E: np.ndarray, k: int, seed: int = 0,
                 n_iter: int = 25) -> List[np.ndarray]:
    """Plain k-means over embedding rows; farthest-point init."""
    n = E.shape[0]
    k = min(k, n)
    rng = np.random.default_rng(seed)
    centers = [int(rng.integers(n))]
    d = ((E - E[centers[0]]) ** 2).sum(axis=1)
    for _ in range(k - 1):
        centers.append(int(np.argmax(d)))
        d = np.minimum(d, ((E - E[centers[-1]]) ** 2).sum(axis=1))
    C = E[centers].copy()
    assign = None
    for _ in range(n_iter):
        d2 = ((E[:, None, :] - C[None, :, :]) ** 2).sum(axis=2)
        new_assign = np.argmin(d2, axis=1)
        if assign is not None and np.array_equal(new_assign, assign):
            break
        assign = new_assign
        for c in range(k):
            rows = E[assign == c]
            if len(rows):
                C[c] = rows.mean(axis=0)
    return [np.flatnonzero(assign == c) for c in range(k)
            if np.any(assign == c)]


def _tree_clusters(D: np.ndarray, max_size: int,
                   min_size: Optional[int] = None) -> List[np.ndarray]:
    """UPGMA tree over D, cut top-down into clusters <= max_size
    (centroid-style decomposition on the guide tree).

    Undersized clusters (outlier clades the cut strands as singletons
    or pairs) are folded into their nearest cluster by mean distance —
    tiny subsets starve the consistency transform (no relay partners)
    and multiply merge boundaries."""
    from .backbone_progressive import upgma_merges
    n = D.shape[0]
    merges = upgma_merges(D)
    members = {i: [i] for i in range(n)}
    children = {}
    for t, (a, b) in enumerate(merges):
        children[n + t] = (a, b)
        members[n + t] = members[a] + members[b]
    out = []
    stack = [n + len(merges) - 1] if merges else [0]
    while stack:
        nd = stack.pop()
        if len(members[nd]) <= max_size or nd < n:
            out.append(np.asarray(sorted(members[nd])))
        else:
            stack.extend(children[nd])
    if min_size is None:
        min_size = min(max(8, max_size // 6), max(2, n // 4))
    clusters = [list(c) for c in out]
    while len(clusters) > 1:
        sizes = [len(c) for c in clusters]
        small = min(range(len(clusters)), key=lambda i: sizes[i])
        if sizes[small] >= min_size:
            break
        rows = clusters[small]
        best, best_d = -1, np.inf
        for j, other in enumerate(clusters):
            if j == small:
                continue
            d = float(D[np.ix_(rows, other)].mean())
            # prefer targets that stay within bounds; oversize only
            # as a last resort (d penalized)
            if len(other) + len(rows) > int(1.3 * max_size):
                d += 1e3
            if d < best_d:
                best, best_d = j, d
        clusters[best] = sorted(clusters[best] + rows)
        clusters.pop(small)
    return [np.asarray(c) for c in clusters]


def _alignment_identity_dist(mat: np.ndarray, K: int,
                             gap_code: int) -> np.ndarray:
    """[n, n] (1 - identity over mutually aligned residues)."""
    n = mat.shape[0]
    res = mat < K
    D = np.zeros((n, n))
    for s in range(n):
        m = res[s][None, :] & res
        same = (mat == mat[s][None, :]) & m
        iden = same.sum(axis=1) / np.maximum(m.sum(axis=1), 1)
        D[s] = 1.0 - iden
        D[s, s] = 0.0
    return (D + D.T) / 2.0



def sparse_global_align(names: List[str], seqs: List[str],
                        molecule: str, neighbors: int = 24,
                        rand_pairs: int = 8,
                        match_p: Optional[float] = None,
                        delta: Optional[float] = None, eps: float = 0.75,
                        rounds: int = 1, refine_rounds: int = 30,
                        cutoff: float = 0.01, seed: int = 0,
                        workers: int = 8, log=None) -> PackedAlignment:
    """Sparse global consistency alignment (arbitrary n).

    One coherent ProbCons-style pass over ALL sequences with a sparse
    pair graph: each sequence is paired with its `neighbors` nearest
    sequences in the anchor-EA embedding plus `rand_pairs` random
    others; the consistency transform runs over the sparse graph (the
    native SpGEMM skips absent pairs); the merge is progressive over a
    full UPGMA guide tree with posterior-mass scoring; randomized
    bipartition refinement polishes the result.

    This subsumes the subset-decompose-merge architecture: close pairs
    get direct posteriors, distant pairs inherit through common
    neighbors — the information flow the reference gets from MAGUS's
    guide-tree decomposition + cross-subset MAFFT-backbone graph
    (witch_msa/tools/magus/align/merge/graph_build/graph_builder.py).
    """
    import scipy.sparse as sp
    from .backbone_progressive import upgma_merges
    from .native import _pairhmm

    alphabet = ALPHABETS[molecule]
    seqs = [s.upper() for s in seqs]
    n = len(seqs)
    codes = [alphabet.encode(s) for s in seqs]
    gap_code = alphabet.gap_code
    if n == 1:
        return PackedAlignment(list(names), codes[0][None, :], alphabet)
    if n <= neighbors + rand_pairs + 2:
        return consistency_align(names, seqs, molecule, match_p=match_p,
                                 delta=delta, eps=eps, rounds=max(rounds, 1),
                                 refine_rounds=refine_rounds,
                                 cutoff=cutoff, seed=seed,
                                 workers=workers, log=log)
    if match_p is None or delta is None:
        mp_e, de_e, e = estimate_params(codes, alphabet, workers=workers,
                                        seed=seed)
        match_p = mp_e if match_p is None else match_p
        delta = de_e if delta is None else delta
        if log:
            log("sparse-global: adaptive params mean_ea=%.3f -> "
                "match_p=%.3f delta=%.3f" % (e, match_p, delta))

    E = anchor_embedding(codes, alphabet, workers=workers, seed=seed)
    Edist = np.sqrt(((E[:, None, :] - E[None, :, :]) ** 2).sum(-1))

    # sparse pair graph: m nearest + r random per sequence
    rng = np.random.default_rng(seed + 101)
    pair_set = set()
    order = np.argsort(Edist, axis=1)
    for s in range(n):
        for t in order[s, 1:neighbors + 1]:
            pair_set.add((min(s, int(t)), max(s, int(t))))
        for t in rng.choice(n, rand_pairs, replace=False):
            if int(t) != s:
                pair_set.add((min(s, int(t)), max(s, int(t))))
    pairs = sorted(pair_set)
    if log:
        log("sparse-global: %d/%d pairs (%.1f%%)"
            % (len(pairs), n * (n - 1) // 2,
               200.0 * len(pairs) / (n * (n - 1))))

    em = _emission_odds(alphabet, match_p)
    codes32 = [np.ascontiguousarray(c, np.int32) for c in codes]

    def one(stt):
        s, t = stt
        I, J, P, _ea = _pairhmm.posterior(codes32[s], codes32[t], em,
                                          delta, eps, cutoff)
        return s, t, sp.csr_matrix(
            (P, (I, J)), shape=(len(codes32[s]), len(codes32[t])),
            dtype=np.float32)

    post: Dict[Tuple[int, int], object] = {}
    with ThreadPoolExecutor(max_workers=workers) as ex:
        for s, t, m in ex.map(one, pairs):
            post[(s, t)] = m
    if log:
        log("sparse-global: posteriors done")
    lens = np.array([len(c) for c in codes], np.int32)
    for r in range(rounds):
        post = consistency_transform(post, n, cutoff=cutoff,
                                     workers=workers, lens=lens)
        if log:
            log("sparse-global: transform round %d done" % (r + 1))

    merges = upgma_merges(Edist)
    node = {i: ([i], codes[i][None, :].astype(np.uint8))
            for i in range(n)}
    cache = {}
    for t, (a, b) in enumerate(merges):
        (ra, ca), (rb, cb) = node.pop(a), node.pop(b)
        merged, rws, _ = _align_groups(post, ra, ca, rb, cb, gap_code,
                                       cache=cache)
        node[n + t] = (rws, merged)
    rows, mat = node[n + len(merges) - 1]
    if log:
        log("sparse-global: merged %d seqs -> %d cols"
            % (mat.shape[0], mat.shape[1]))

    rows, mat, obj = refine_bipartitions(
        post, rows, mat, gap_code, refine_rounds,
        np.random.default_rng(seed), cache=cache)
    if log:
        log("sparse-global: %d cols after refinement (EA obj %.1f)"
            % (mat.shape[1], obj))

    aln = PackedAlignment([names[i] for i in rows], mat, alphabet)
    aln, _ = aln.delete_all_gap_columns()
    idx = {nm: i for i, nm in enumerate(aln.names)}
    sel = [idx[nm] for nm in names]
    return PackedAlignment(list(names), aln.codes[sel], alphabet)


# ---------------------------------------------------------------------------
# Column-graph merge (MAGUS-graph analogue in subset-column space)
# ---------------------------------------------------------------------------

def _build_column_graph(subs, codes32, em, delta, eps, cutoff,
                        gap_code, density=0.2, cap_lo=400, cap_hi=8000,
                        workers=8, seed=0, log=None):
    """Cross-subset column graph from sampled pair-HMM posteriors.

    For every subset pair (a, b) sample `density * na * nb` sequence
    pairs (clamped to [cap_lo, cap_hi]), run the native pair HMM on the
    raw sequences, and accumulate posterior mass into subset-column
    coordinates: W[(a, b)][ca, cb] = sum over sampled (s, t) of
    P_st[i, j] with residue i of s in column ca of subset a. This is
    the MAGUS alignment graph (graph_builder.py:26-231) with pair-HMM
    posteriors in place of MAFFT-backbone co-alignment counts.

    Returns (W, nsamp): CSR matrices [Wa, Wb] keyed (a, b) with a < b,
    and the per-pair sequence-pair sample counts (for mean-posterior
    normalization).
    """
    import scipy.sparse as sp
    from .native import _pairhmm

    S = len(subs)
    rng = np.random.default_rng(seed)
    # per subset: row id -> residue-index-to-column map
    res_cols: List[Dict[int, np.ndarray]] = []
    for grows, smat in subs:
        cols = _residue_cols(smat, gap_code)
        res_cols.append({r: c for r, c in zip(grows, cols)})

    tasks = []   # (a, b, s_row, t_row)
    nsamp: Dict[Tuple[int, int], int] = {}
    for a in range(S):
        for b in range(a + 1, S):
            ra, rb = subs[a][0], subs[b][0]
            total = len(ra) * len(rb)
            k = int(np.clip(density * total, min(cap_lo, total),
                            min(cap_hi, total)))
            sel = rng.choice(total, k, replace=False)
            for ix in sel:
                tasks.append((a, b, ra[int(ix) // len(rb)],
                              rb[int(ix) % len(rb)]))
            nsamp[(a, b)] = k

    def one(task):
        a, b, s, t = task
        I, J, P, _ea = _pairhmm.posterior(codes32[s], codes32[t], em,
                                          delta, eps, cutoff)
        return a, b, res_cols[a][s][I], res_cols[b][t][J], P

    acc: Dict[Tuple[int, int], list] = {k: [] for k in nsamp}
    with ThreadPoolExecutor(max_workers=workers) as ex:
        for a, b, ca, cb, P in ex.map(one, tasks):
            acc[(a, b)].append((ca, cb, P))
    W: Dict[Tuple[int, int], object] = {}
    for (a, b), chunks in acc.items():
        Wa = subs[a][1].shape[1]
        Wb = subs[b][1].shape[1]
        if chunks:
            I = np.concatenate([c[0] for c in chunks])
            J = np.concatenate([c[1] for c in chunks])
            V = np.concatenate([c[2] for c in chunks])
            W[(a, b)] = sp.csr_matrix((V, (I, J)), shape=(Wa, Wb),
                                      dtype=np.float64)
        else:
            W[(a, b)] = sp.csr_matrix((Wa, Wb), dtype=np.float64)
    if log:
        log("column-graph: %d sampled pair posteriors over %d "
            "subset pairs" % (len(tasks), len(nsamp)))
    return W, nsamp


def _orient(W, a, b):
    """CSR for (a, b) regardless of stored key order (None if absent)."""
    if (a, b) in W:
        return W[(a, b)]
    if (b, a) in W:
        return W[(b, a)].T.tocsr()
    return None


def _column_consistency(W, nsamp, sizes, rounds: int = 1,
                        direct_w: float = 2.0, cutoff: float = 1e-4,
                        size_weight: bool = False, log=None):
    """Column-space consistency transform over the subset-column graph.

    Normalizes each W_ab by its sample count (mean posterior per
    sampled sequence pair — a probability-scale column-match score),
    then runs `rounds` of

        Wbar'_ab = (direct_w * Wbar_ab + sum_c w_c Wbar_ac @ Wbar_cb)
                   / (direct_w + sum_c w_c)

    relaying through every other subset c with both edges present
    (w_c = 1, or subset size when size_weight). Returns expected
    TOTAL-mass matrices What_ab = Wbar'_ab * (na * nb) for merge
    scoring (the scale _group_score produces when every pair is
    sampled). The relay is the cross-subset information flow the
    reference gets from MAGUS's sampled MAFFT backbones feeding one
    global graph (graph_builder.py:26-231): two columns co-align when
    they co-align to a common third subset's column.
    """
    keys = list(W.keys())
    S = len(sizes)
    Wbar = {k: (W[k] * (1.0 / max(nsamp[k], 1))).tocsr() for k in keys}
    for _ in range(max(0, rounds)):
        out = {}
        for (a, b) in keys:
            acc = direct_w * Wbar[(a, b)]
            denom = direct_w
            for c in range(S):
                if c == a or c == b:
                    continue
                m1 = _orient(Wbar, a, c)
                m2 = _orient(Wbar, c, b)
                if m1 is None or m2 is None:
                    continue
                wc = float(sizes[c]) if size_weight else 1.0
                acc = acc + wc * (m1 @ m2)
                denom += wc
            acc = acc * (1.0 / denom)
            acc.data[acc.data < cutoff] = 0.0
            acc.eliminate_zeros()
            out[(a, b)] = acc.tocsr()
        Wbar = out
    What = {}
    for (a, b) in keys:
        What[(a, b)] = (Wbar[(a, b)] * float(sizes[a] * sizes[b])).tocsr()
    return What


def _graph_group_score(What, sidsA, cmA, WA, sidsB, cmB, WB):
    """[WA, WB] summed expected mass between two merged groups, read
    off the transformed column graph through each group's column maps."""
    S = np.zeros(WA * WB, np.float64)
    for a in sidsA:
        for b in sidsB:
            m = _orient(What, a, b)
            if m is None or m.nnz == 0:
                continue
            coo = m.tocoo()
            np.add.at(S, cmA[a][coo.row] * WB + cmB[b][coo.col],
                      coo.data)
    return S.reshape(WA, WB)


def _apply_ops(A_codes, B_codes, ops, gap_code):
    """Glue two aligned blocks along an ea_align op string
    (0=both, 1=A column, 2=B column)."""
    nA, nB = A_codes.shape[0], B_codes.shape[0]
    Wm = len(ops)
    out = np.full((nA + nB, Wm), gap_code, np.uint8)
    posA = np.flatnonzero(ops != 2)
    posB = np.flatnonzero(ops != 1)
    out[:nA, posA] = A_codes
    out[nA:, posB] = B_codes
    return out, posA, posB


def _graph_objective(What, colmaps) -> float:
    """Total graph mass realized by the glued alignment (column maps
    agreeing on the merged column)."""
    tot = 0.0
    for (a, b), m in What.items():
        if a not in colmaps or b not in colmaps or m.nnz == 0:
            continue
        coo = m.tocoo()
        hit = colmaps[a][coo.row] == colmaps[b][coo.col]
        tot += float(coo.data[hit].sum())
    return tot


def _graph_merge(subs, What, DS, gap_code, log=None):
    """Progressive merge of subset alignments along a subset-level
    UPGMA, scored purely from the column graph. Returns
    (rows, mat, colmaps)."""
    from .backbone_progressive import upgma_merges
    from .native import _pairhmm

    S = len(subs)
    node = {}
    for i, (grows, smat) in enumerate(subs):
        node[i] = (list(grows), smat,
                   {i: np.arange(smat.shape[1], dtype=np.int64)})
    merges = upgma_merges(DS)
    for t, (a, b) in enumerate(merges):
        ra, ca, cma = node.pop(a)
        rb, cb, cmb = node.pop(b)
        Sc = _graph_group_score(What, list(cma), cma, ca.shape[1],
                                list(cmb), cmb, cb.shape[1])
        ops = np.asarray(_pairhmm.ea_align(np.ascontiguousarray(Sc)),
                         np.int8)
        merged, posA, posB = _apply_ops(ca, cb, ops, gap_code)
        cm = {s: posA[m] for s, m in cma.items()}
        cm.update({s: posB[m] for s, m in cmb.items()})
        node[S + t] = (ra + rb, merged, cm)
        if log:
            log("graph-merge: %d+%d seqs -> %d cols"
                % (len(ra), len(rb), merged.shape[1]))
    key = S + len(merges) - 1 if merges else 0
    return node[key]


def _trace_merge(subs, What, gap_code, inflation: float = 2.0,
                 log=None):
    """Global column-graph trace (the MAGUS MCL + minclusters
    analogue, magus/align/merge/graph_trace/min_clusters.py:17-181).

    Clusters ALL subset columns jointly with sparse Markov clustering
    on the transformed graph, purges within-subset violations (a
    cluster keeps at most one column per subset — the best-connected
    one), then emits clusters left-to-right with a frontier ordering:
    a cluster is emitted when every member column is its subset's next
    unemitted column; when no cluster is fully ready, the one with the
    highest ready weight fraction is split (a "break"). Returns
    (rows, mat, colmaps) in the same contract as _graph_merge.
    """
    import scipy.sparse as sp

    S = len(subs)
    widths = [smat.shape[1] for _, smat in subs]
    offs = np.concatenate([[0], np.cumsum(widths)])
    n_nodes = int(offs[-1])
    subset_of = np.empty(n_nodes, np.int32)
    col_of = np.empty(n_nodes, np.int64)
    for s in range(S):
        subset_of[offs[s]:offs[s + 1]] = s
        col_of[offs[s]:offs[s + 1]] = np.arange(widths[s])

    rows_l, cols_l, vals_l = [], [], []
    for (a, b), m in What.items():
        if m.nnz == 0:
            continue
        coo = m.tocoo()
        rows_l.append(offs[a] + coo.row)
        cols_l.append(offs[b] + coo.col)
        vals_l.append(coo.data)
    if not rows_l:
        return _graph_merge(subs, What, np.zeros((S, S)), gap_code,
                            log=log)
    I = np.concatenate(rows_l)
    J = np.concatenate(cols_l)
    V = np.concatenate(vals_l)
    A = sp.csr_matrix((np.concatenate([V, V]),
                       (np.concatenate([I, J]),
                        np.concatenate([J, I]))),
                      shape=(n_nodes, n_nodes))

    # sparse MCL: expansion (A @ A) + inflation + column renormalize,
    # with support pruning to keep the matrix sparse
    loops = np.maximum(np.asarray(A.max(axis=0).todense()).ravel(),
                       1e-12)
    M = (A + sp.diags(loops)).tocsc()
    M = M @ sp.diags(1.0 / np.maximum(
        np.asarray(M.sum(axis=0)).ravel(), 1e-300))
    budget = 48 * n_nodes          # nnz cap (mcl-style pruning)
    for _ in range(30):
        M2 = (M @ M).tocsc()
        M2.data = np.power(M2.data, inflation)
        thr = 1e-6
        if M2.nnz > budget:
            thr = max(thr, float(np.partition(M2.data,
                                              M2.nnz - budget)
                                 [M2.nnz - budget]))
        M2.data[M2.data < thr] = 0.0
        M2.eliminate_zeros()
        M2 = M2 @ sp.diags(1.0 / np.maximum(
            np.asarray(M2.sum(axis=0)).ravel(), 1e-300))
        delta = abs(M2 - M).max()
        M = M2
        if delta < 1e-6:
            break
    # clusters = connected components of the attractor support
    support = M.copy()
    support.data = (support.data > 1e-4).astype(np.float64)
    n_comp, labels = sp.csgraph.connected_components(
        support + support.T, directed=False)

    # purge within-subset violations: keep the best-connected column
    # per (cluster, subset); evicted columns become singletons
    order = np.argsort(labels, kind="stable")
    strength = np.asarray(A.sum(axis=1)).ravel()
    best: Dict[Tuple[int, int], int] = {}
    for nd in order:
        key = (int(labels[nd]), int(subset_of[nd]))
        cur = best.get(key)
        if cur is None or strength[nd] > strength[cur]:
            best[key] = nd
    next_label = n_comp
    for nd in range(n_nodes):
        if best[(int(labels[nd]), int(subset_of[nd]))] != nd:
            labels[nd] = next_label
            next_label += 1

    # frontier ordering with splits
    members: Dict[int, List[int]] = {}
    for nd in range(n_nodes):
        members.setdefault(int(labels[nd]), []).append(nd)
    cluster_of = labels.copy()
    nxt = [0] * S                      # next unemitted column per subset
    emitted_cols: List[List[int]] = []  # node lists, one per out column
    remaining = n_nodes
    # ready_nodes[c] = member nodes currently at their subset frontier
    while remaining > 0:
        # find clusters of the frontier columns
        frontier = [(s, int(cluster_of[offs[s] + nxt[s]]))
                    for s in range(S) if nxt[s] < widths[s]]
        full = []
        best_part = None
        for s, c in frontier:
            mem = members[c]
            ready = [nd for nd in mem
                     if nxt[int(subset_of[nd])] == col_of[nd]]
            if len(ready) == len(mem):
                full.append((len(mem), c, ready))
            else:
                frac = len(ready) / len(mem)
                if best_part is None or frac > best_part[0]:
                    best_part = (frac, c, ready)
        if full:
            # emit the largest fully-ready cluster
            full.sort(reverse=True)
            _, c, ready = full[0]
        else:
            _, c, ready = best_part          # split: a "break"
            members[c] = [nd for nd in members[c] if nd not in ready]
        seen = set()
        col_nodes = []
        for nd in ready:
            s = int(subset_of[nd])
            if s in seen:
                continue
            seen.add(s)
            col_nodes.append(nd)
        if c in members and all(nd in col_nodes for nd in
                                members.get(c, [])):
            members.pop(c, None)
        emitted_cols.append(col_nodes)
        for nd in col_nodes:
            nxt[int(subset_of[nd])] += 1
        remaining -= len(col_nodes)

    # assemble the merged matrix + column maps
    Wm = len(emitted_cols)
    colmaps = {s: np.zeros(widths[s], np.int64) for s in range(S)}
    for j, nodes in enumerate(emitted_cols):
        for nd in nodes:
            colmaps[int(subset_of[nd])][col_of[nd]] = j
    rows_out: List[int] = []
    blocks = []
    for s in range(S):
        grows, smat = subs[s]
        block = np.full((smat.shape[0], Wm), gap_code, np.uint8)
        block[:, colmaps[s]] = smat
        blocks.append(block)
        rows_out.extend(grows)
    mat = np.concatenate(blocks, axis=0)
    if log:
        log("trace-merge: %d clusters over %d columns -> %d output "
            "cols" % (n_comp, n_nodes, Wm))
    return rows_out, mat, colmaps


def _graph_refine(subs, What, rows, mat, colmaps, gap_code,
                  passes: int = 1, log=None):
    """Leave-one-subset-out refinement in column space: pull one
    subset's block out, realign it against the rest on the graph,
    keep improvements of the realized-mass objective."""
    from .native import _pairhmm

    cur = _graph_objective(What, colmaps)
    n_sub = len(subs)
    if n_sub < 3:
        return rows, mat, colmaps, cur
    row_pos = {r: i for i, r in enumerate(rows)}
    for _ in range(max(0, passes)):
        improved = False
        for si in range(n_sub):
            grows, smat = subs[si]
            sset = set(grows)
            ib = np.array([i for i, r in enumerate(rows)
                           if r not in sset])
            rest = mat[ib]
            keep = ~(rest == gap_code).all(axis=0)
            rest = rest[:, keep]
            # old merged column -> rest column (columns where only
            # subset si had residues drop out)
            newpos = np.cumsum(keep) - 1
            cm_rest = {s: newpos[cm] for s, cm in colmaps.items()
                       if s != si}
            Sc = _graph_group_score(
                What, [si],
                {si: np.arange(smat.shape[1], dtype=np.int64)},
                smat.shape[1], list(cm_rest), cm_rest, rest.shape[1])
            ops = np.asarray(_pairhmm.ea_align(np.ascontiguousarray(Sc)),
                             np.int8)
            merged, posA, posB = _apply_ops(smat, rest, ops, gap_code)
            new_cm = {s: posB[m] for s, m in cm_rest.items()}
            new_cm[si] = posA[np.arange(smat.shape[1])]
            new_obj = _graph_objective(What, new_cm)
            if new_obj > cur + 1e-9:
                new_rows = list(grows) + [rows[i] for i in ib]
                rows, mat, colmaps, cur = new_rows, merged, new_cm, \
                    new_obj
                row_pos = {r: i for i, r in enumerate(rows)}
                improved = True
                if log:
                    log("graph-refine: subset %d replaced "
                        "(obj %.1f, %d cols)" % (si, cur, mat.shape[1]))
        if not improved:
            break
    return rows, mat, colmaps, cur


def align_backbone_consistency(names: List[str], seqs: List[str],
                               molecule: str,
                               subset_size: Optional[int] = None,
                               match_p: Optional[float] = None,
                               delta: Optional[float] = None,
                               eps: float = 0.75,
                               rounds: int = 1, refine_rounds: int = 50,
                               cutoff: float = 0.01, seed: int = 0,
                               kappa: Optional[float] = None,
                               pair_cap: Optional[int] = None,
                               iters: int = 1,
                               merge_mode: str = "column",
                               col_rounds: int = 1,
                               direct_w: float = 2.0,
                               density: float = 0.2,
                               col_cutoff: float = 1e-4,
                               size_weight: bool = False,
                               refine_passes: int = 2,
                               workers: int = 8, log=None
                               ) -> PackedAlignment:
    """Full-backbone alignment: decompose, align subsets with the
    consistency engine, merge subset alignments along a subset-level
    guide tree using cross-subset representative posteriors.

    The same divide-and-merge shape as the reference's MAGUS
    (decompose -> L-INS-i subsets -> graph merge,
    witch_msa/tools/magus/align/aligner.py) with the graph replaced by
    merge-time sampled cross-subset pair posteriors.
    """
    from .backbone_progressive import upgma_merges

    alphabet = ALPHABETS[molecule]
    seqs = [s.upper() for s in seqs]
    n = len(seqs)
    if subset_size is None:
        # target ~6 subsets: the transform needs >= 3 for relays, but
        # every extra subset adds merge boundaries — measured at n=500
        # on the example backbone: 9 subsets of <=83 score SP 0.725 vs
        # 0.666 for 14 subsets of <=50; at n=150, 3 subsets of 50
        # score 0.690 vs 0.661 for 2 subsets of 90 (no relays)
        subset_size = int(np.clip(n / 6, 50, 120))
    if n <= int(1.3 * subset_size):
        return consistency_align(names, seqs, molecule, match_p=match_p,
                                 delta=delta, eps=eps, rounds=rounds,
                                 refine_rounds=refine_rounds,
                                 cutoff=cutoff, kappa=kappa, seed=seed,
                                 workers=workers, log=log)
    codes = [alphabet.encode(s) for s in seqs]
    gap_code = alphabet.gap_code
    if match_p is None or delta is None:
        mp_e, de_e, e = estimate_params(codes, alphabet, workers=workers,
                                        seed=seed, kappa=kappa)
        match_p = mp_e if match_p is None else match_p
        delta = de_e if delta is None else delta
        if log:
            log("backbone: adaptive params mean_ea=%.3f -> "
                "match_p=%.3f delta=%.3f" % (e, match_p, delta))

    import scipy.sparse as sp
    from .native import _pairhmm
    em_glob = _emission_odds(alphabet, match_p, kappa)
    codes32 = [np.ascontiguousarray(c, np.int32) for c in codes]
    post: Dict[Tuple[int, int], object] = {}   # persistent across iters
    pair_rng = np.random.default_rng(seed + 10007)

    def ensure_pairs(rowsA, rowsB, cap):
        """Compute pair-HMM posteriors for a capped random sample of
        cross pairs at a join — the information-density analogue of
        MAGUS's cross-subset MAFFT-backbone graph
        (graph_builder.py:26-231), which samples <=200-seq backbones."""
        cross = [(a, b) for a in rowsA for b in rowsB]
        if len(cross) > cap:
            sel = pair_rng.choice(len(cross), cap, replace=False)
            cross = [cross[i] for i in sel]
        todo = [(a, b) for a, b in cross
                if (a, b) not in post and (b, a) not in post]

        def one(ab):
            a, b = ab
            I, J, P, _ea = _pairhmm.posterior(
                codes32[a], codes32[b], em_glob, delta, eps, cutoff)
            return a, b, sp.csr_matrix(
                (P, (I, J)), shape=(len(codes32[a]), len(codes32[b])),
                dtype=np.float32)

        with ThreadPoolExecutor(max_workers=workers) as ex:
            for a, b, m in ex.map(one, todo):
                post[(a, b)] = m
        return len(todo)

    # iteration 0 clusters from the EA anchor embedding; later
    # iterations re-derive neighborhoods from the previous alignment
    # (PASTA-style iteration)
    E = anchor_embedding(codes, alphabet, workers=workers, seed=seed)

    def join_cap(na, nb):
        # fixed caps starve big joins (at n=500 the root join has 62k
        # cross pairs; 1200 samples = 2% coverage left columns unpaired
        # and ballooned the output width) — scale with the join, bound
        # the worst case
        if pair_cap is not None:
            return pair_cap
        return min(15000, max(1500, int(0.2 * na * nb)))

    D_aln = None
    rows = mat = None
    for it in range(max(1, iters)):
        if it == 0:
            n_clusters = max(2, -(-n // subset_size))
            clusters = _kmeans_rows(E, n_clusters, seed=seed)
            split = []
            for idx in clusters:
                if len(idx) > int(1.5 * subset_size):
                    k = -(-len(idx) // subset_size)
                    split.extend(np.array_split(idx, k))
                else:
                    split.append(idx)
            clusters = [c for c in split if len(c)]
        else:
            clusters = _tree_clusters(D_aln, subset_size)
        if log:
            log("backbone[it%d]: %d subsets (sizes %s)"
                % (it, len(clusters),
                   sorted((len(c) for c in clusters), reverse=True)))

        # align each subset with per-subset adaptive parameters (a
        # tight neighborhood wants stronger match odds than the mix)
        subs = []   # (global_rows, mat)
        for ci, idx in enumerate(clusters):
            if len(idx) == 1:
                subs.append(([int(idx[0])],
                             codes[int(idx[0])][None, :].astype(np.uint8)))
                continue
            sub_codes = [codes[i] for i in idx]
            srows, smat, _, _D = consistency_align_core(
                sub_codes, alphabet, match_p=None, delta=None, eps=eps,
                rounds=rounds, refine_rounds=refine_rounds,
                cutoff=cutoff, kappa=kappa, seed=seed + ci,
                workers=workers)
            subs.append(([int(idx[r]) for r in srows], smat))
            if log:
                log("backbone[it%d]: subset %d/%d aligned (%d seqs, "
                    "%d cols)" % (it, ci + 1, len(clusters),
                                  smat.shape[0], smat.shape[1]))

        # subset-level UPGMA: anchor-centroid distance (it 0) or mean
        # alignment-identity distance (later iterations)
        S = len(subs)
        if it == 0:
            cent = np.stack([E[[i for i in grows]].mean(axis=0)
                             for grows, _ in subs])
            DS = np.sqrt(((cent[:, None, :] - cent[None, :, :]) ** 2
                          ).sum(-1))
        else:
            DS = np.zeros((S, S))
            for a in range(S):
                for b in range(a + 1, S):
                    DS[a, b] = DS[b, a] = float(np.mean(
                        D_aln[np.ix_(subs[a][0], subs[b][0])]))
        if merge_mode in ("column", "trace"):
            # MAGUS-graph analogue: explicit cross-subset column graph
            # + column-space consistency transform + graph-scored
            # merge/refinement (see _build_column_graph).
            Wg, nsamp = _build_column_graph(
                subs, codes32, em_glob, delta, eps, cutoff, gap_code,
                density=density, cap_lo=400,
                cap_hi=pair_cap if pair_cap is not None else 8000,
                workers=workers, seed=seed + 77 + it, log=log)
            sizes_sub = [len(g) for g, _ in subs]
            What = _column_consistency(
                Wg, nsamp, sizes_sub, rounds=col_rounds,
                direct_w=direct_w, cutoff=col_cutoff,
                size_weight=size_weight, log=log)
            if merge_mode == "trace":
                rows, mat, colmaps = _trace_merge(subs, What, gap_code,
                                                  log=log)
            else:
                rows, mat, colmaps = _graph_merge(subs, What, DS,
                                                  gap_code, log=log)
            rows, mat, colmaps, obj = _graph_refine(
                subs, What, rows, mat, colmaps, gap_code,
                passes=refine_passes, log=log)
            if log:
                log("backbone[it%d]: %d seqs -> %d cols "
                    "(graph obj %.1f)"
                    % (it, mat.shape[0], mat.shape[1], obj))
        else:
            merges = upgma_merges(DS)
            node = {i: (subs[i][0], subs[i][1]) for i in range(S)}
            merge_cache: Dict = {}
            for t, (a, b) in enumerate(merges):
                (ra, ca), (rb, cb) = node.pop(a), node.pop(b)
                npairs = ensure_pairs(ra, rb, join_cap(len(ra), len(rb)))
                merged, rws, _ = _align_groups(post, ra, ca, rb, cb,
                                               gap_code,
                                               cache=merge_cache)
                node[S + t] = (rws, merged)
                if log:
                    log("backbone[it%d]: merged %d+%d seqs -> %d cols "
                        "(+%d pair posteriors)"
                        % (it, len(ra), len(rb), merged.shape[1],
                           npairs))
            rows, mat = node[S + len(merges) - 1] if merges else node[0]

            # top-level structured refinement (leave-one-subset-out)
            groups = [grows for grows, _ in subs]
            rng = np.random.default_rng(seed + it)
            rows, mat, obj = refine_bipartitions(post, rows, mat,
                                                 gap_code, 0, rng,
                                                 groups=groups,
                                                 cache=merge_cache)
            if log:
                log("backbone[it%d]: %d seqs -> %d cols (EA obj %.1f)"
                    % (it, mat.shape[0], mat.shape[1], obj))
        if it < max(1, iters) - 1:
            # alignment-derived distances for the next iteration,
            # indexed by global sequence id
            inv = np.argsort(np.asarray(rows))
            D_aln = _alignment_identity_dist(mat[inv], alphabet.K,
                                             gap_code)

    aln = PackedAlignment([names[i] for i in rows], mat, alphabet)
    aln, _ = aln.delete_all_gap_columns()
    order = {nm: i for i, nm in enumerate(aln.names)}
    sel = [order[nm] for nm in names]
    return PackedAlignment(list(names), aln.codes[sel], alphabet)
