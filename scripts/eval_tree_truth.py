"""Tree-estimation truth harness: simulated families with KNOWN trees.

VERDICT round-2 item 7: the FastTree-rows proxy saturates (optimizing our
model's likelihood walks away from FastTree's particular optimum, not
toward truth), so validate on a true accuracy metric instead.  This
script simulates DNA families under GTR+Gamma on random birth trees,
estimates a tree from each simulated alignment with (a)
witch_tpu.tree_estimate.estimate_tree (the scenario-B/C path) and (b)
the bundled FastTree2 invoked exactly as the reference does
(`FastTree -gtr -nt`, witch_msa/gcmm/backbone.py:305-319), and reports
normalized Robinson-Foulds distance to the true tree for both.

Usage:
    python scripts/eval_tree_truth.py [n_leaves] [n_sites] [n_reps]
    python scripts/eval_tree_truth.py 100 1000 5
    python scripts/eval_tree_truth.py 100 1000 5 model=gtr

Prints one table row per replicate plus a mean summary.
"""

import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

FASTTREE = "/root/reference/witch_msa/tools/magus/tools/fasttree/FastTree"
ACGT = "ACGT"


def random_tree(n, rng):
    """Random coalescent-style topology over n leaves; exponential branch
    lengths (mean 0.12, the example backbone's scale).  Returns
    (newick, splits) where splits is the set of non-trivial bipartitions
    as frozensets of leaf names."""
    nodes = [("T%d" % i, frozenset(["T%d" % i])) for i in range(n)]
    while len(nodes) > 3:
        i, j = rng.choice(len(nodes), 2, replace=False)
        i, j = (i, j) if i < j else (j, i)
        (nwk_j, s_j) = nodes.pop(j)
        (nwk_i, s_i) = nodes.pop(i)
        bi, bj = rng.exponential(0.12, 2) + 0.01
        nodes.append(("(%s:%.5f,%s:%.5f)" % (nwk_i, bi, nwk_j, bj),
                      s_i | s_j))
    parts = []
    for nwk_i, s_i in nodes:
        b = rng.exponential(0.12) + 0.01
        parts.append("%s:%.5f" % (nwk_i, b))
    newick = "(" + ",".join(parts) + ");"
    return newick, tree_splits(newick, n)


def parse_newick(newick):
    """Minimal newick parser -> (parent, blen, name, children) arrays."""
    parent, blen, name, children = [], [], [], []

    def add(p):
        parent.append(p)
        blen.append(0.0)
        name.append(None)
        children.append([])
        i = len(parent) - 1
        if p >= 0:
            children[p].append(i)
        return i

    pos = [0]
    s = newick.strip().rstrip(";")

    def rec(p):
        i = add(p)
        if s[pos[0]] == "(":
            pos[0] += 1
            while True:
                rec(i)
                if s[pos[0]] == ",":
                    pos[0] += 1
                    continue
                assert s[pos[0]] == ")"
                pos[0] += 1
                break
        j = pos[0]
        while j < len(s) and s[j] not in ",():":
            j += 1
        name[i] = s[pos[0]:j] or None
        pos[0] = j
        if pos[0] < len(s) and s[pos[0]] == ":":
            j = pos[0] + 1
            while j < len(s) and s[j] not in ",()":
                j += 1
            blen[i] = float(s[pos[0] + 1:j])
            pos[0] = j
        return i

    rec(-1)
    return parent, blen, name, children


def tree_splits(newick, n_leaves):
    """Non-trivial bipartitions (as frozensets of the smaller side's
    leaf names, canonicalized by the side containing leaf 'T0')."""
    parent, blen, name, children = parse_newick(newick)
    all_leaves = frozenset(name[i] for i in range(len(name))
                           if not children[i])
    splits = set()
    below = {}

    def rec(i):
        if not children[i]:
            below[i] = frozenset([name[i]])
        else:
            acc = frozenset()
            for c in children[i]:
                rec(c)
                acc |= below[c]
            below[i] = acc
        if 1 < len(below[i]) < n_leaves - 1 and parent[i] >= 0:
            side = below[i]
            if "T0" in side:
                side = all_leaves - side
            splits.add(side)

    rec(0)
    return splits


def rf_distance(nwk_a, nwk_b, n):
    sa, sb = tree_splits(nwk_a, n), tree_splits(nwk_b, n)
    denom = len(sa) + len(sb)
    return (len(sa ^ sb) / denom) if denom else 0.0


def gtr_matrices(rng):
    """Random GTR model: Dirichlet frequencies + lognormal
    exchangeabilities, normalized to 1 expected substitution per unit t."""
    pi = rng.dirichlet([5.0] * 4)
    ex = rng.lognormal(0.0, 0.7, 6)
    ex[5] = 1.0  # GT reference rate
    S = np.zeros((4, 4))
    pairs = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
    for r, (a, b) in zip(ex, pairs):
        S[a, b] = S[b, a] = r
    Q = S * pi[None, :]
    np.fill_diagonal(Q, -Q.sum(1) + np.diag(Q))
    Q /= -(pi * np.diag(Q)).sum()
    return pi, Q


def simulate(newick, n_sites, rng, alpha=0.7):
    """Evolve sequences down the tree under GTR+Gamma(4)."""
    pi, Q = gtr_matrices(rng)
    from scipy.linalg import expm
    from scipy.stats import gamma as _gamma
    qs = (np.arange(4) + 0.5) / 4
    rates = _gamma.ppf(qs, alpha, scale=1.0 / alpha)
    rates /= rates.mean()
    site_rate = rates[rng.integers(0, 4, n_sites)]
    parent, blen, name, children = parse_newick(newick)
    seq = {0: rng.choice(4, n_sites, p=pi)}
    out = {}
    order = list(range(len(parent)))  # parents precede children by parse
    for i in order[1:]:
        P1 = expm(Q * blen[i])
        # per-site rate: group sites by category for 4 matrix exps
        s = np.empty(n_sites, np.int64)
        par = seq[parent[i]]
        for c, r in enumerate(rates):
            m = site_rate == r
            if not m.any():
                continue
            Pr = expm(Q * blen[i] * r)
            cum = Pr.cumsum(1)
            u = rng.random(int(m.sum()))
            rowc = cum[par[m]]
            s[m] = (u[:, None] > rowc).sum(1)
        seq[i] = s
        if not children[i]:
            out[name[i]] = "".join(ACGT[b] for b in s)
        _ = P1
    return out


def run_fasttree(fasta_path):
    with open(fasta_path) as f:
        r = subprocess.run([FASTTREE, "-gtr", "-nt"], stdin=f,
                           capture_output=True, text=True, timeout=1200)
    assert r.returncode == 0, r.stderr[-500:]
    return r.stdout.strip()


def run_ours(fasta_path, model="hky"):
    from witch_tpu.core.alignment import PackedAlignment
    from witch_tpu.tree_estimate import estimate_tree
    aln = PackedAlignment.from_fasta(fasta_path, molecule="dna")
    return estimate_tree(aln, ml=True, model=model)


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 100
    L = int(sys.argv[2]) if len(sys.argv) > 2 else 1000
    reps = int(sys.argv[3]) if len(sys.argv) > 3 else 5
    model = "hky"
    for a in sys.argv[4:]:
        if a.startswith("model="):
            model = a.split("=", 1)[1]
    # force CPU: the harness must not depend on an accelerator
    os.environ["JAX_PLATFORMS"] = "cpu"
    rows = []
    for rep in range(reps):
        rng = np.random.default_rng(1000 + rep)
        true_nwk, _ = random_tree(n, rng)
        seqs = simulate(true_nwk, L, rng)
        with tempfile.NamedTemporaryFile(
                "w", suffix=".fasta", delete=False) as f:
            for k, v in seqs.items():
                f.write(">%s\n%s\n" % (k, v))
            path = f.name
        t0 = time.time()
        ft = run_fasttree(path)
        t_ft = time.time() - t0
        t0 = time.time()
        ours = run_ours(path, model=model)
        t_us = time.time() - t0
        rf_ft = rf_distance(true_nwk, ft, n)
        rf_us = rf_distance(true_nwk, ours, n)
        rows.append((rf_ft, rf_us, t_ft, t_us))
        print("rep %d: RF fasttree=%.4f (%.1fs)  ours[%s]=%.4f (%.1fs)"
              % (rep, rf_ft, t_ft, model, rf_us, t_us), flush=True)
        os.unlink(path)
    arr = np.array(rows)
    print("mean: RF fasttree=%.4f  ours[%s]=%.4f   time %.1fs vs %.1fs"
          % (arr[:, 0].mean(), model, arr[:, 1].mean(),
             arr[:, 2].mean(), arr[:, 3].mean()))


if __name__ == "__main__":
    main()
