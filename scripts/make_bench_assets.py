"""Build the committed bench_assets.npz used by bench.py.

Runs the (slow, host-side) setup once — decompose the example backbone
(reference layout: witch_msa/gcmm/algorithm.py decomposition), build and
quantize the 141 subset HMMs, assemble the 2-bucket ProfileBanks, encode
the 500 fragmentary queries — and persists everything so bench.py can
load in under a second instead of rebuilding for ~4 minutes.

Usage: python scripts/make_bench_assets.py [out.npz]
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from witch_tpu.core.alignment import PackedAlignment, subset_counts  # noqa: E402
from witch_tpu.core.alphabet import DNA  # noqa: E402
from witch_tpu.core.tree import decompose_backbone  # noqa: E402
from witch_tpu.hmm.build import build_hmm, quantize_like_text  # noqa: E402
from witch_tpu.hmm.bank import ProfileBank, build_banks  # noqa: E402
from witch_tpu.io.fasta import read_fasta  # noqa: E402

BANK_FIELDS = ("em_odds", "t_mm", "t_mi", "t_md", "t_im", "t_ii",
               "t_dm", "t_dd", "bm", "M", "nseq", "hmm_indices")


def save_banks(path, banks, extra=None):
    blob = {"n_banks": np.int32(len(banks))}
    for i, b in enumerate(banks):
        for f in BANK_FIELDS:
            blob["bank%d_%s" % (i, f)] = getattr(b, f)
        blob["bank%d_multihit" % i] = np.bool_(b.multihit)
    if extra:
        blob.update(extra)
    np.savez_compressed(path, **blob)


def load_banks(path):
    z = np.load(path)
    banks = []
    for i in range(int(z["n_banks"])):
        kw = {f: z["bank%d_%s" % (i, f)] for f in BANK_FIELDS}
        kw["multihit"] = bool(z["bank%d_multihit" % i])
        banks.append(ProfileBank(**kw))
    return banks, z


def main():
    out = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "bench_assets.npz")
    data = "/root/reference/examples/data"
    bb = PackedAlignment.from_fasta(data + "/backbone.aln.fasta.gz",
                                    molecule="dna")
    subsets = decompose_backbone(data + "/backbone.tre", max_size=10)
    cores = []
    true_states = 0
    for i, leaves in enumerate(subsets):
        rows, ret, _ = subset_counts(bb, leaves)
        core = quantize_like_text(build_hmm(
            bb.codes[rows][:, ret], bb.alphabet, "dna", name="A_0_%d" % i))
        cores.append(core)
        true_states += core.M
    # TWO banks: the production bucketing (pipeline.compute_scores
    # n_buckets=2), which the bench must exercise
    banks = build_banks(cores, indices=list(range(len(cores))),
                        uniform=True, n_buckets=2)

    qcodes = [DNA.encode(s.upper())
              for _, s in read_fasta(data + "/unaligned_frag.fasta")]
    Q = len(qcodes)
    Lmax = max(len(c) for c in qcodes)
    codes = np.zeros((Q, Lmax), np.int32)
    lens = np.zeros(Q, np.int32)
    for i, c in enumerate(qcodes):
        codes[i, :len(c)] = c
        lens[i] = len(c)

    save_banks(out, banks, extra={
        "codes": codes, "lens": lens,
        "true_states": np.int64(true_states)})
    print("wrote", out, "(%.1f MB)" % (os.path.getsize(out) / 1e6))


if __name__ == "__main__":
    main()


class _Prof:
    pass


def load_profile_row(bank, row):
    """Reconstruct a log-space profile view of one bank row (for the
    native domaindef engine): the bank stores odds = exp of the profile
    logs, so log() recovers them exactly."""
    M = int(bank.M[row])
    p = _Prof()
    with np.errstate(divide="ignore"):
        p.msc = np.log(np.asarray(bank.em_odds[row][:M + 1], np.float64))
        for f in ("t_mm", "t_mi", "t_md", "t_im", "t_ii", "t_dm",
                  "t_dd", "bm"):
            setattr(p, f, np.log(np.asarray(
                getattr(bank, f)[row][:M + 1], np.float64)))
    p.M = M
    return p


def load_profile0(path):
    banks, _ = load_banks(path)
    return load_profile_row(banks[0], 0)
