"""Triton Forward pre-score kernel (ops/pallas_forward.py) against the
f64 log-space reference (hmm/forward_ref.py), in interpret mode on the
CPU and compiled on the card (`gpu` marker, run by chip_smoke.py)."""

import numpy as np
import pytest

from witch_tpu.core.alphabet import ALPHABETS
from witch_tpu.hmm.bank import build_banks
from witch_tpu.hmm.build import build_hmm, quantize_like_text
from witch_tpu.hmm.forward import score_bank
from witch_tpu.hmm.forward_ref import bit_score
from witch_tpu.hmm.profile import configure
from witch_tpu.ops import pallas_forward as pf

TOL_BITS = 1e-3     # f32 odds-domain kernel vs f64 log space


def seeded_case(molecule, ragged, H=3, M=24, Q=40, seed=0):
    """A bank of H seeded subset HMMs of unequal length (padded into one
    bank) and Q queries drawn from the models' consensus-like rows."""
    alpha = ALPHABETS[molecule]
    rng = np.random.default_rng(seed)
    cores, bases = [], []
    for h in range(H):
        m = M + 7 * h
        base = rng.integers(0, alpha.K, m)
        rows = np.where(rng.random((6, m)) < 0.2,
                        rng.integers(0, alpha.K, (6, m)), base)
        rows = np.where(rng.random((6, m)) < 0.1, alpha.gap_code, rows)
        rows[0, (rows == alpha.gap_code).all(axis=0)] = base[0]
        cores.append(quantize_like_text(build_hmm(
            rows.astype(np.uint8), alpha, molecule, name="s%d" % h)))
        bases.append(base)
    bank = build_banks(cores, uniform=True)[0]
    lens = (rng.integers(3, 45, Q) if ragged
            else np.full(Q, 20)).astype(np.int32)
    codes = np.zeros((Q, int(lens.max())), np.int32)
    for q in range(Q):
        src = bases[q % H]
        s = src[rng.integers(0, max(1, len(src) - lens[q]) + 1):][:lens[q]]
        s = np.concatenate([s, rng.integers(0, alpha.K, lens[q] - len(s))])
        codes[q, :lens[q]] = np.where(rng.random(lens[q]) < 0.15,
                                      rng.integers(0, alpha.K, lens[q]), s)
    return bank, cores, codes, lens


def f64_bits(cores, codes, lens):
    profs = [configure(c, multihit=True) for c in cores]
    return np.array([[bit_score(p, codes[q, :lens[q]]) for p in profs]
                     for q in range(len(lens))])


@pytest.mark.parametrize("molecule,ragged", [
    ("dna", False), ("amino", False), ("dna", True), ("amino", True)])
def test_kernel_matches_f64_reference(molecule, ragged):
    bank, cores, codes, lens = seeded_case(molecule, ragged)
    got = pf.forward_bits(bank, codes, lens, interpret=True)
    assert got.shape == (len(lens), len(cores))
    np.testing.assert_allclose(got, f64_bits(cores, codes, lens),
                               atol=TOL_BITS, rtol=0)
    # the XLA scan computes the same recurrence
    np.testing.assert_allclose(got, score_bank(bank, codes, lens,
                                               backend="xla"),
                               atol=TOL_BITS, rtol=0)


def test_query_blocks_layout():
    """Length-sorted blocks of QB queries; the block count and padded
    length are rounded up to powers of two (block count then to a
    multiple of the shard count) with zero-length queries; nres is each
    block's longest query."""
    rng = np.random.default_rng(3)
    lens = rng.integers(1, 90, 70).astype(np.int32)
    codes = rng.integers(0, 4, (70, 90)).astype(np.int32)
    order, cT, ql, nres = pf.query_blocks(codes, lens, n_shards=4)
    assert cT.shape == (4, 128, pf.QB)             # 3 blocks -> 4; L -> 128
    assert ql.shape == (4, pf.QB) and nres.shape == (4,)
    assert np.array_equal(ql.ravel()[:70], lens[order])
    assert (ql.ravel()[70:] == 0).all() and nres[-1] == 0
    assert np.array_equal(nres, ql.max(axis=1))
    assert np.all(np.diff(ql.ravel()[:70]) >= 0)
    q = order[40]
    blk, lane = divmod(40, pf.QB)
    assert np.array_equal(cT[blk, :lens[q], lane], codes[q, :lens[q]])
    for n, shards, nqb in ((130, 1, 8), (130, 3, 9), (20, 1, 1)):
        assert pf.query_blocks(codes[:1].repeat(n, 0), lens[:1].repeat(n),
                               shards)[1].shape[0] == nqb


def test_model_chunking_matches_one_call(monkeypatch):
    """A scratch budget too small for the whole bank splits the models
    over several calls (the last padded with zero-length models);
    scores are unchanged."""
    bank, _, codes, lens = seeded_case("dna", True, H=5)
    whole = pf.forward_bits(bank, codes, lens, interpret=True)
    Ms = pf.bank_kernel_arrays(bank)[0].shape[1]
    assert pf.models_per_call(5, 2, Ms) == 8        # H 5 -> 8, one call
    monkeypatch.setattr(pf, "SCRATCH_BYTES", 2 * 2 * Ms * pf.QB * 4 * 2)
    assert pf.models_per_call(5, 2, Ms) == 2
    np.testing.assert_array_equal(
        pf.forward_bits(bank, codes, lens, interpret=True), whole)


@pytest.mark.gpu
def test_compiled_kernel_on_card(gpu):
    for molecule in ("dna", "amino"):
        bank, cores, codes, lens = seeded_case(molecule, True, H=4, M=200,
                                               Q=70)
        got = score_bank(bank, codes, lens)            # the GPU default
        np.testing.assert_allclose(got, f64_bits(cores, codes, lens),
                                   atol=TOL_BITS, rtol=0)
