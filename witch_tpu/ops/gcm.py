"""GCM-style merging (the reference's 'old-witch' mode).

The reference shells out to its vendored MAGUS for this
(witch_msa/gcmm/aligner.py:159-334): build an alignment graph whose nodes
are the columns of the two constraint alignments (c0 = backbone, c1 = the
query), with edge weights accumulated from the per-HMM extended alignments
scaled by the HMM weights; cluster the graph with MCL (inflation 4); then
find a trace (a cluster ordering consistent with both constraints'
column orders) and emit the merged alignment.

Here the graph is exactly the witch-ng edge structure (query position i
x backbone column j with weight nongaps*w — the insight witch-ng mode is
built on), so old-witch mode = MCL-filter the edge graph, then run the
same banded trace DP restricted to intra-cluster edges. With two
constraints the minclusters trace objective reduces to this DP.

Note: old-witch mode in the reference v1.0.10 is unrunnable
(witch_msa/gcmm/aligner.py:218 reads the commented-out Configs.gcm_path
and raises AttributeError), so this is a behavioral reconstruction; exact
output parity is untestable against the shipped code.

MCL expansion/inflation runs as dense matrix ops on the banded subgraph —
a natural fit for the matrix units when batched (device path), with a numpy
fallback for small problems.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from .merge_dp import accumulate_edges, banded_dp, traceback, \
    compress_insertions


def mcl(adj: np.ndarray, inflation: float = 4.0, max_iter: int = 50,
        prune: float = 1e-7) -> np.ndarray:
    """Markov clustering on a dense adjacency; returns cluster labels.

    Expansion (squaring) + inflation (elementwise power, column
    renormalize) to convergence; clusters read off attractor rows.
    """
    n = adj.shape[0]
    # self loops at each node's max incident weight (mcl's default
    # loop policy for weighted graphs)
    loops = np.maximum(adj.max(axis=0), 1e-12)
    M = adj.astype(np.float64) + np.diag(loops)
    M /= np.maximum(M.sum(axis=0, keepdims=True), 1e-300)
    for _ in range(max_iter):
        prev = M
        M = M @ M                                     # expansion
        M = np.power(M, inflation)                    # inflation
        M[M < prune] = 0.0
        M /= np.maximum(M.sum(axis=0, keepdims=True), 1e-300)
        if np.abs(M - prev).max() < 1e-8:
            break
    # attractors: rows with nonzero diagonal; cluster = union of columns
    # attracted to the same attractor set (connected components of the
    # support graph)
    support = (M > 0)
    # union-find over attractor rows: columns sharing any attractor row
    # belong to one cluster, with full transitive alias compression
    attractor_of_col = [np.flatnonzero(support[:, j]) for j in range(n)]
    parent: Dict[int, int] = {}

    def find(r: int) -> int:
        root = r
        while parent[root] != root:
            root = parent[root]
        while parent[r] != root:            # path compression
            parent[r], r = root, parent[r]
        return root

    for rows in attractor_of_col:
        for r in rows:
            parent.setdefault(r, r)
        for a, b2 in zip(rows[:-1], rows[1:]):
            ra, rb = find(int(a)), find(int(b2))
            if ra != rb:
                parent[max(ra, rb)] = min(ra, rb)
    labels = np.full(n, -1, dtype=np.int64)
    canon: Dict[int, int] = {}
    for j, rows in enumerate(attractor_of_col):
        if len(rows) == 0:
            continue
        root = min(find(int(r)) for r in rows)
        labels[j] = canon.setdefault(root, len(canon))
    # columns with no attractor each get their own singleton cluster
    for j in range(n):
        if labels[j] < 0:
            labels[j] = len(canon)
            canon[("solo", j)] = labels[j]
    return labels


def gcm_align_query_row(seq: str, backbone_length: int,
                        per_hmm: Sequence[Tuple[np.ndarray, np.ndarray,
                                                np.ndarray, float]],
                        inflation: float = 4.0,
                        clustermethod: str = "mcl",
                        extra_edges: Sequence[np.ndarray] = ()) -> str:
    """Old-witch merge for one query; same output contract as
    witch_tpu.ops.merge_dp.align_query_row.

    clustermethod='none' skips the MCL filter (raw edge graph, the
    reference's --graphclustermethod none). extra_edges: sparse
    (rows, global_cols, weights) triples from batched sibling queries
    (-s/--subset-size > 1): their residue nodes join the clustering
    graph (edges to backbone columns inside this query's band) so the
    MCL filter is shared across the batch, mirroring the reference's
    multi-query GCM runs.
    """
    cw, min_col, max_col = accumulate_edges(len(seq), backbone_length,
                                            per_hmm)
    if cw is None:
        return ""
    n_res, band = cw.shape
    if clustermethod == "none":
        cw2 = cw
    else:
        # nodes: query residues [0..n_res), band columns, then sibling
        # query residues (batched mode)
        n_extra = sum(int(r.max()) + 1 if len(r) else 0
                      for r, _, _ in extra_edges)
        n = n_res + band + n_extra
        adj = np.zeros((n, n))
        ii, jj = np.nonzero(cw)
        adj[ii, n_res + jj] = cw[ii, jj]
        adj[n_res + jj, ii] = cw[ii, jj]
        base = n_res + band
        for er, ec, ew in extra_edges:
            if len(er) == 0:
                continue
            inb = (ec >= min_col) & (ec <= max_col)
            bj = ec[inb] - min_col
            adj[base + er[inb], n_res + bj] = ew[inb]
            adj[n_res + bj, base + er[inb]] = ew[inb]
            base += int(er.max()) + 1
        labels = mcl(adj, inflation=inflation)
        # zero out edges across clusters, then the banded trace DP
        keep = labels[ii] == labels[n_res + jj]
        cw2 = np.zeros_like(cw)
        cw2[ii[keep], jj[keep]] = cw[ii[keep], jj[keep]]
        if not cw2.any():
            cw2 = cw  # degenerate clustering: fall back to raw edges
    bt = banded_dp(cw2)
    row = traceback(seq, bt, min_col, max_col, backbone_length)
    return compress_insertions(row)
