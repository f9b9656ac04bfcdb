"""Device (XLA) pair-HMM forward vs float64 reference.

The batched forward (ops/pairhmm_forward.py) is the device-side scorer
for anchor embeddings / guide distances in the consistency backbone —
one scalar per pair, so little leaves the device. It
must reproduce the native kernel's forward recurrence (here: the
float64 numpy port) through padding, masking, and the associative-scan
Y recurrence.
"""

import numpy as np

from witch_tpu.backbone_consistency import _emission_odds
from witch_tpu.core.alphabet import ALPHABETS
from witch_tpu.ops.pairhmm_forward import (pairhmm_forward_logodds,
                                           pairhmm_forward_logodds_np)


def test_batched_forward_matches_reference():
    al = ALPHABETS["dna"]
    em = _emission_odds(al, 0.12)
    rng = np.random.default_rng(0)
    P, LA, LB = 6, 80, 64
    cA = rng.integers(0, 4, (P, LA)).astype(np.int32)
    cB = rng.integers(0, 4, (P, LB)).astype(np.int32)
    # include degenerate codes
    cA[0, 5] = al.encode("N")[0]
    lA = rng.integers(30, LA + 1, P).astype(np.int32)
    lB = rng.integers(25, LB + 1, P).astype(np.int32)
    dev = np.asarray(pairhmm_forward_logodds(cA, lA, cB, lB, em,
                                             0.01, 0.75))
    for p in range(P):
        ref = pairhmm_forward_logodds_np(cA[p, :lA[p]], cB[p, :lB[p]],
                                         em, 0.01, 0.75)
        assert abs(dev[p] - ref) < 5e-3, (p, dev[p], ref)


def test_identical_vs_shuffled_ordering():
    al = ALPHABETS["dna"]
    em = _emission_odds(al, 0.3)
    rng = np.random.default_rng(1)
    L = 120
    a = rng.integers(0, 4, L).astype(np.int32)
    shuf = a.copy()
    rng.shuffle(shuf)
    cA = np.stack([a, a])
    cB = np.stack([a, shuf])
    lens = np.full(2, L, np.int32)
    out = np.asarray(pairhmm_forward_logodds(cA, lens, cB, lens, em,
                                             0.01, 0.75))
    assert out[0] > out[1] + 5.0  # identity scores far above shuffled


def test_device_embedding_matches_reference_normalization():
    """_device_embedding = forward log-odds / min(len) per (seq, anchor),
    through padding and chunked batching (opt-in embedding backend)."""
    from witch_tpu.backbone_consistency import _device_embedding
    al = ALPHABETS["dna"]
    em = _emission_odds(al, 0.30)
    rng = np.random.default_rng(3)
    codes = [np.ascontiguousarray(rng.integers(0, 4, rng.integers(40, 90)),
                                  np.int32) for _ in range(7)]
    anchors = [0, 4]
    E = _device_embedding(codes, anchors, em, 0.02, 0.75, chunk=4)
    assert E.shape == (7, 2)
    for s in (1, 3, 6):
        for t, ai in enumerate(anchors):
            want = pairhmm_forward_logodds_np(codes[s], codes[ai], em,
                                              0.02, 0.75)
            want /= min(len(codes[s]), len(codes[ai]))
            assert abs(E[s, t] - want) < 2e-4, (s, t, E[s, t], want)
