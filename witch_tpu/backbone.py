"""Backbone selection / alignment / tree (scenario A/B support).

Reference behavior (witch_msa/gcmm/backbone.py): pick up to 1000 full-length
sequences within +-25% of the median length as the backbone, align them with
MAGUS, and estimate a FastTree2 tree; the rest become queries.

TPU-native re-design: backbone alignment is produced by iterative profile-HMM
refinement — seed a profile from a median-length sequence, batch-align all
backbone sequences to it with the posterior-OA kernel, overlay the per-seq
alignments into an MSA, rebuild the profile (entropy-weighted), and iterate.
The tree comes from device pairwise distances + NJ (tree_estimate).

This replaces MAGUS/FastTree behaviorally, not bit-for-bit: scenario A
outputs are therefore method-equivalent rather than bit-identical to the
reference (which is itself nondeterministic here: it samples the backbone
with an unseeded RNG, backbone.py:117-118).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .core.alignment import PackedAlignment
from .core.alphabet import ALPHABETS, Alphabet, infer_datatype
from .hmm.build import build_hmm, quantize_like_text
from .io.fasta import read_fasta, write_fasta


def select_backbone(records: Sequence[Tuple[str, str]],
                    backbone_size: int = 1000,
                    threshold: float = 0.25,
                    seed: int = 0,
                    strategy: str = "median_length"):
    """Split records into (backbone, queries) by the reference's rule:
    full-length = within +-threshold of median ungapped length; sample
    up to backbone_size of those (seeded here, unseeded in the reference).
    strategy='random' skips the length filter and samples uniformly
    (the reference's [Backbone] selection_strategy=random).
    """
    lengths = np.array([len(s) for _, s in records])
    if strategy == "random":
        rng = np.random.default_rng(seed)
        n_bb = min(backbone_size, len(records))
        full = sorted(rng.choice(len(records), n_bb, replace=False))
        full_set = set(full)
        return ([records[i] for i in full],
                [records[i] for i in range(len(records))
                 if i not in full_set])
    # the reference's median formula (backbone.py:91-97), including its
    # upper-biased even-length case — behaviorally important for mixed
    # full-length/fragment inputs
    sl = np.sort(lengths)
    n = len(sl)
    l2 = n // 2
    if n % 2 == 1 or l2 == n - 1:
        med = float(sl[l2])
    else:
        med = (float(sl[l2]) + float(sl[l2 + 1])) / 2.0
    lo = int(med * (1 - threshold))
    hi = int(med * (1 + threshold))
    full = [i for i in range(len(records)) if lo <= lengths[i] <= hi]
    rng = np.random.default_rng(seed)
    if len(full) > backbone_size:
        chosen = rng.choice(len(full), backbone_size, replace=False)
        full = sorted(full[i] for i in chosen)
    full_set = set(full)
    backbone = [records[i] for i in full]
    queries = [records[i] for i in range(len(records))
               if i not in full_set]
    return backbone, queries


def _msa_from_alignments(seqs: List[str], cols: List[np.ndarray],
                         M: int, alphabet: Alphabet) -> PackedAlignment:
    """Overlay per-sequence (aligned_columns) results into one MSA.

    cols[i][r] = 0-based match column of residue r, or -1 (insertion).
    Insertion runs attach before their next match column (M for trailing).
    """
    n = len(seqs)
    runs_len = np.zeros(M + 1, dtype=np.int64)
    parsed = []
    for s, ac in zip(seqs, cols):
        match_chars = {}
        runs: Dict[int, List[str]] = {}
        pending: List[str] = []
        for r, ch in enumerate(s):
            c = ac[r]
            if c >= 0:
                if pending:
                    runs.setdefault(int(c), []).extend(pending)
                    pending = []
                match_chars[int(c)] = ch
            else:
                pending.append(ch)
        if pending:
            runs.setdefault(M, []).extend(pending)
        runs = {g: "".join(v) for g, v in runs.items()}
        for g, v in runs.items():
            runs_len[g] = max(runs_len[g], len(v))
        parsed.append((match_chars, runs))

    total = M + int(runs_len.sum())
    col_pos = np.zeros(M, dtype=np.int64)
    run_pos = np.zeros(M + 1, dtype=np.int64)
    pos = 0
    for g in range(M + 1):
        run_pos[g] = pos
        pos += int(runs_len[g])
        if g < M:
            col_pos[g] = pos
            pos += 1
    names = ["s%d" % i for i in range(n)]
    rows = []
    for match_chars, runs in parsed:
        out = np.full(total, "-", dtype="U1")
        for c, ch in match_chars.items():
            out[col_pos[c]] = ch
        for g, v in runs.items():
            start = run_pos[g]
            out[start:start + len(v)] = list(v)
        rows.append("".join(out))
    aln = PackedAlignment.from_records(list(zip(names, rows)),
                                       alphabet=alphabet)
    aln2, _ = aln.delete_all_gap_columns()
    return aln2


def _kmer_profiles(codes: List[np.ndarray], K: int, k: int = 4):
    """L2-normalized k-mer count vectors (degenerate codes skipped)."""
    nfeat = K ** k
    out = np.zeros((len(codes), nfeat), np.float32)
    mult = K ** np.arange(k)[::-1]
    for i, c in enumerate(codes):
        ok = c < K
        if len(c) < k:
            continue
        win = np.lib.stride_tricks.sliding_window_view(c, k)
        okw = np.lib.stride_tricks.sliding_window_view(
            ok.astype(np.int8), k).all(axis=1)
        idx = (win[okw].astype(np.int64) * mult).sum(axis=1)
        np.add.at(out[i], idx, 1.0)
        n = np.linalg.norm(out[i])
        if n > 0:
            out[i] /= n
    return out


def align_backbone(names: List[str], seqs: List[str], molecule: str,
                   n_iters: int = 3, use_device: bool = True,
                   log=None, seed_group: int = 24,
                   support_frac: float = 0.15) -> PackedAlignment:
    """Iterative HMM-refinement multiple alignment of the backbone.

    Seeding: rather than a single sequence (which forces everything that
    doesn't match it into insert states), the seed profile is built from a
    small neighborhood — the `seed_group` sequences most similar (k-mer
    cosine) to the median-length sequence, aligned to it and
    support-filtered. Iterations then realign ALL sequences and stop early
    once the overlay width converges.
    """
    alphabet = ALPHABETS[molecule]
    seqs = [s.upper() for s in seqs]
    codes = [alphabet.encode(s) for s in seqs]
    lens = np.array([len(s) for s in seqs])
    seed_i = int(np.argsort(lens)[len(lens) // 2])
    cur = PackedAlignment.from_records(
        [(names[seed_i], seqs[seed_i])], alphabet=alphabet)
    med_len = float(np.median(lens))

    if len(seqs) > 3 and seed_group > 1:
        # mini-iteration on the seed neighborhood
        prof = _kmer_profiles(codes, alphabet.K)
        sim = prof @ prof[seed_i]
        near = np.argsort(-sim)[:min(seed_group, len(seqs))]
        core0 = quantize_like_text(
            build_hmm(cur.codes, alphabet, molecule, name="bb_seed"))
        g_seqs = [seqs[j] for j in near]
        g_codes = [codes[j] for j in near]
        cols0 = _align_all(core0, g_codes, use_device)
        g_full = _msa_from_alignments(g_seqs, cols0, core0.M, alphabet)
        support = g_full.nongaps_per_column()
        keep = np.flatnonzero(support >= max(2, int(round(0.5 * len(near)))))
        if keep.size >= 0.5 * med_len:
            cur = PackedAlignment(g_full.names, g_full.codes[:, keep],
                                  alphabet)
            if log:
                log("backbone seed group: %d seqs -> %d cols"
                    % (len(near), cur.n_cols))

    return refine_from_seed(cur, names, seqs, molecule, n_iters=n_iters,
                            use_device=use_device, log=log,
                            support_frac=support_frac)


def refine_from_seed(seed_aln: PackedAlignment, names: List[str],
                     seqs: List[str], molecule: str, n_iters: int = 3,
                     use_device: bool = True, log=None,
                     support_frac: float = 0.15) -> PackedAlignment:
    """Iterative HMM-refinement from a seed alignment.

    Each iteration builds a profile from the current match-filtered
    columns, realigns EVERY sequence (posterior-OA), and overlays the
    results into a fresh MSA whose width is bounded by
    M + per-gap max insert runs — private insert columns cannot
    accumulate across iterations (the structural fix for the
    progressive-merge width blowup on hard data)."""
    alphabet = ALPHABETS[molecule]
    seqs = [s.upper() for s in seqs]
    codes = [alphabet.encode(s) for s in seqs]
    med_len = float(np.median([len(s) for s in seqs]))
    cur = seed_aln
    cur_full = cur
    prev_width = None
    for it in range(n_iters):
        core = quantize_like_text(
            build_hmm(cur.codes, alphabet, molecule, name="bb_iter%d" % it))
        cols = _align_all(core, codes, use_device)
        cur_full = _msa_from_alignments(seqs, cols, core.M, alphabet)
        # keep only supported columns as the next profile's match states
        # (symfrac-like architecture selection; low-support columns are
        # insertions and would otherwise blow up the profile length).
        # The unfiltered overlay (cur_full) keeps every residue and is
        # what the final iteration returns.
        n = cur_full.n_seqs
        support = cur_full.nongaps_per_column()
        # symfrac-like: a column is a match state for the next profile
        # only with majority support — a permissive threshold lets the
        # profile accumulate thousands of junk states and the alignment
        # never tightens (every seq escapes into its own inserts)
        thresh = max(2, int(round(support_frac * n)))
        keep = np.flatnonzero(support >= thresh)
        if keep.size < med_len:
            order = np.argsort(-support)[:int(med_len)]
            keep = np.sort(order)
        cur = PackedAlignment(cur_full.names, cur_full.codes[:, keep],
                              alphabet)
        if log:
            log("backbone iteration %d: %d cols (match-filtered %d)"
                % (it, cur_full.n_cols, cur.n_cols))
        if prev_width is not None and \
                abs(prev_width - cur_full.n_cols) < 0.02 * prev_width:
            break
        prev_width = cur_full.n_cols
    return PackedAlignment(names, cur_full.codes, alphabet)


def _align_all(core, codes: List[np.ndarray], use_device: bool):
    try:
        return _align_all_native(core, codes)
    except ImportError:
        pass
    if use_device:
        try:
            return _align_all_device(core, codes)
        except Exception:
            pass
    from .hmm.align_ref import aligned_columns
    from .hmm.profile import configure
    prof = configure(core, multihit=False)
    return [aligned_columns(prof, c) for c in codes]


def _align_all_native(core, codes: List[np.ndarray]):
    """f64 posterior + OA per sequence via the native engine, threaded
    (identical results to the device/numpy paths; no device round-trip)."""
    from concurrent.futures import ThreadPoolExecutor
    from .native import _domaindef
    from .hmm.align_ref import oa_columns_from_pp
    from .hmm.profile import configure

    prof = configure(core, multihit=False)
    args = [np.ascontiguousarray(prof.msc, np.float64)] + [
        np.ascontiguousarray(getattr(prof, a), np.float64)
        for a in ("t_mm", "t_mi", "t_md", "t_im", "t_ii",
                  "t_dm", "t_dd", "bm")]

    def one(c):
        c = np.ascontiguousarray(c, np.int32)
        ppM, ppI, ppN, ppJ, ppC = _domaindef.posterior_pair(
            *args, c, len(c), 0)
        return oa_columns_from_pp(
            prof, dict(M=ppM, I=ppI, N=ppN, J=ppJ, C=ppC))[:len(c)]

    with ThreadPoolExecutor(max_workers=8) as ex:
        return list(ex.map(one, codes))


def _align_all_device(core, codes: List[np.ndarray], chunk: int = 16):
    import jax.numpy as jnp
    from .hmm.bank import build_banks
    from .hmm.align import posterior_pp_pairs_sparse, densify_sparse_pp
    from .hmm.align_ref import oa_columns_from_pp
    from .hmm.profile import configure

    bank = build_banks([core], indices=[0], multihit=False, uniform=True)[0]
    prof = configure(core, multihit=False)
    M = prof.M
    Mp1 = bank.em_odds.shape[1]
    # quantize the batch shapes (P fixed, L to 128) so repeated calls with
    # different clusters/iterations reuse compiled kernels
    Lmax = -(-max(len(c) for c in codes) // 128) * 128
    out = []
    args0 = (bank.em_odds, bank.t_mm, bank.t_mi, bank.t_md, bank.t_im,
             bank.t_ii, bank.t_dm, bank.t_dd, bank.bm)
    for s in range(0, len(codes), chunk):
        batch = codes[s:s + chunk]
        P = chunk
        cmat = np.zeros((P, Lmax), np.int32)
        lens = np.ones(P, np.int32)
        for t, c in enumerate(batch):
            cmat[t, :len(c)] = c
            lens[t] = len(c)
        args = [jnp.asarray(np.repeat(a, P, axis=0)) for a in args0]
        vM, iM, vI, iI, ppN, ppJ, ppC = posterior_pp_pairs_sparse(
            *args, jnp.asarray(cmat), jnp.asarray(lens), multihit=False)
        vM = np.asarray(vM); iM = np.asarray(iM)
        vI = np.asarray(vI); iI = np.asarray(iI)
        ppN = np.asarray(ppN); ppJ = np.asarray(ppJ); ppC = np.asarray(ppC)
        for t in range(len(batch)):
            qlen = int(lens[t])
            dM, dI = densify_sparse_pp(vM[t], iM[t], vI[t], iI[t], Mp1)
            pp = dict(M=dM[:qlen + 1, :M + 1], I=dI[:qlen + 1, :M + 1],
                      N=ppN[t][:qlen + 1].astype(np.float64),
                      J=ppJ[t][:qlen + 1].astype(np.float64),
                      C=ppC[t][:qlen + 1].astype(np.float64))
            out.append(oa_columns_from_pp(prof, pp)[:qlen])
    return out


class BackboneJob:
    """Scenario A/B orchestration (reference BackboneJob equivalent)."""

    def __init__(self, input_path: str, outdir: str,
                 molecule: Optional[str] = None,
                 backbone_size: Optional[int] = None, seed: int = 0,
                 selection_strategy: Optional[str] = None,
                 method: Optional[str] = None, log=None):
        self.input_path = input_path
        self.outdir = outdir
        self.molecule = molecule
        self.backbone_size = backbone_size or 1000
        self.selection_strategy = selection_strategy or "median_length"
        # Default: PASTA-style two-pass consistency alignment. Measured on
        # the shipped example backbone it dominates the single-pass merge
        # (n=500: SP 0.760/0.761 in 1092 s vs 0.725/0.732 in 1693 s;
        # n=150: 0.733/0.728 vs 0.694/0.698) — better and not slower at
        # production scale, so scenario-A users get it by default.
        self.method = method or "pasta"
        self.seed = seed
        self.log = log or (lambda *_: None)

    def run(self):
        """Returns (backbone_aln_path, query_path, tree_path)."""
        import os
        records = [(n, s.upper()) for n, s in read_fasta(self.input_path)]
        if self.molecule is None:
            self.molecule = infer_datatype(records)
        os.makedirs(self.outdir, exist_ok=True)
        bb_path = os.path.join(self.outdir, "backbone.aln.fasta")
        q_path = os.path.join(self.outdir, "queries.fasta")
        tree_path = os.path.join(self.outdir, "backbone.tre")
        if os.path.exists(bb_path) and os.path.exists(q_path) and \
                os.path.exists(tree_path):
            self.log("Reusing existing backbone artifacts")
            return bb_path, q_path, tree_path
        backbone, queries = select_backbone(
            records, self.backbone_size, seed=self.seed,
            strategy=self.selection_strategy)
        self.log("Backbone: %d seqs; queries: %d"
                 % (len(backbone), len(queries)))
        backend = os.environ.get(
            "WITCH_TPU_BACKBONE",
            "consistency" if self.method in ("magus", "pasta", "mafft")
            else "iterhmm")
        if backend == "consistency":
            # production path: probabilistic-consistency aligner
            # (MAGUS/L-INS-i quality class; see backbone_consistency.py).
            # --backbone-method pasta maps to PASTA-style iteration:
            # re-derive neighborhoods/guide tree from the first-pass
            # alignment, realign subsets, remerge (measured n=150:
            # SP 0.733/0.728 at iters=2 vs 0.695/0.712 single pass).
            from .backbone_consistency import align_backbone_consistency
            iters = 2 if self.method == "pasta" else 1
            aln = align_backbone_consistency(
                [n for n, _ in backbone], [s for _, s in backbone],
                self.molecule, seed=self.seed, iters=iters, log=self.log)
        elif backend == "magus":
            # legacy round-1 divide-and-conquer profile merge
            from .backbone_magus import align_backbone_magus
            aln = align_backbone_magus([n for n, _ in backbone],
                                       [s for _, s in backbone],
                                       self.molecule, cluster_size=10,
                                       log=self.log)
        else:
            aln = align_backbone([n for n, _ in backbone],
                                 [s for _, s in backbone],
                                 self.molecule, log=self.log)
        aln.write(bb_path)
        write_fasta(queries, q_path)
        from .tree_estimate import estimate_tree
        estimate_tree(aln, tree_path, ml=True, log=self.log)
        return bb_path, q_path, tree_path
