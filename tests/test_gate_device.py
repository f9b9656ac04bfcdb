"""Device null2/envelope gate vs the native host engine.

The device null2 (hmm/gate_device.py:_envelope_null2_chunk, plain
JAX) runs on whatever backend JAX has, the CPU here; the oracle is the
native engine's evaluate_targets_rows on identical flank rows (the
comparison the GPU production path relies on,
pipeline.compute_scores use_dev_gate)."""

import numpy as np
import pytest

from witch_tpu.core.alphabet import DNA
from witch_tpu.hmm.bank import build_banks
from witch_tpu.hmm.build import build_hmm, quantize_like_text
from witch_tpu.hmm.profile import configure

try:
    from witch_tpu.native import _domaindef
except ImportError:     # pragma: no cover
    _domaindef = None

LETTERS = np.array(list("ACGT"))


def synth_core(M, n, seed):
    r = np.random.default_rng(seed)
    base = r.integers(0, 4, M)
    rows = []
    for _ in range(n):
        s = base.copy()
        mut = r.random(M) < 0.15
        s[mut] = r.integers(0, 4, mut.sum())
        rows.append(DNA.encode("".join(LETTERS[s])))
    return quantize_like_text(build_hmm(np.array(rows), DNA, "dna"))


def margs(p):
    return [np.ascontiguousarray(p.msc, np.float64)] + [
        np.ascontiguousarray(getattr(p, a), np.float64)
        for a in ("t_mm", "t_mi", "t_md", "t_im", "t_ii",
                  "t_dm", "t_dd", "bm")]


def run_case(cores, queries):
    bank = build_banks(cores, uniform=True, n_buckets=1)[0]
    clist = [np.ascontiguousarray(c, np.int32) for c in queries]
    allargs = {j: margs(configure(c, multihit=True))
               for j, c in enumerate(cores)}
    by_j = {j: list(range(len(clist))) for j in range(len(cores))}
    flank_rows = {}
    oracle = {}
    for j in by_j:
        _, mo, pb, pe = _domaindef.flank_targets_simd(
            *allargs[j], clist, 1)
        flank_rows[j] = (mo, pb, pe)
        oracle[j] = _domaindef.evaluate_targets_rows(
            *allargs[j], clist, 42, 200, 1, 0, mo, pb, pe, 1)
    from witch_tpu.hmm.gate_device import evaluate_gate_device
    results, stats = evaluate_gate_device(
        [bank], {j: (0, j) for j in by_j}, allargs, queries, by_j,
        flank_rows, nthreads=2)
    for j in by_j:
        onreg, onenv, osb, _, osenv, osbs, old = oracle[j]
        dnreg, dnenv, dsb, _, dsenv, dsbs, dld = results[j]
        for t in range(len(clist)):
            # gate integers exact (regions come from the same rows)
            assert onreg[t] == dnreg[t], (j, t)
            assert onenv[t] == dnenv[t], (j, t)
            assert old[t] == dld[t], (j, t)
            # f32 kernel vs f64 engine: within the print guard band
            assert abs(osb[t] - dsb[t]) < 2e-3, (j, t, osb[t], dsb[t])
            assert abs(osenv[t] - dsenv[t]) < 2e-3, (j, t)
            assert abs(osbs[t] - dsbs[t]) < 5e-3, (j, t)
    return stats


@pytest.mark.skipif(_domaindef is None or not hasattr(
    _domaindef, "flank_targets_simd"),
    reason="native AVX-512 engine unavailable")
def test_device_gate_matches_host_small():
    cores = [synth_core(36, 10, 1)]
    r = np.random.default_rng(5)
    queries = []
    for seed in range(4):
        rr = np.random.default_rng(300 + seed)
        L = int(rr.integers(24, 56))
        queries.append(DNA.encode("".join(
            LETTERS[rr.integers(0, 4, L)])))
    # two homologous fragments (real regions/envelopes exercised)
    base = r.integers(0, 4, 36)
    for seed in range(2):
        rr = np.random.default_rng(400 + seed)
        s = base.copy()
        mut = rr.random(36) < 0.1
        s[mut] = rr.integers(0, 4, mut.sum())
        queries.append(DNA.encode("".join(LETTERS[s])))
    stats = run_case(cores, queries)
    assert stats["entries"] >= 1       # device path actually exercised


@pytest.mark.skipif(_domaindef is None or not hasattr(
    _domaindef, "flank_targets_simd"),
    reason="native AVX-512 engine unavailable")
def test_device_gate_matches_host_multi_model():
    cores = [synth_core(40, 10, 1), synth_core(55, 12, 2),
             synth_core(30, 8, 3)]
    queries = []
    for seed in range(6):
        rr = np.random.default_rng(100 + seed)
        L = int(rr.integers(25, 60))
        queries.append(DNA.encode("".join(
            LETTERS[rr.integers(0, 4, L)])))
    for seed in range(6):
        rr = np.random.default_rng(200 + seed)
        M = [40, 55, 30][seed % 3]
        base = np.random.default_rng(seed % 3 + 1).integers(0, 4, M)
        s = base.copy()
        mut = rr.random(M) < 0.1
        s[mut] = rr.integers(0, 4, mut.sum())
        queries.append(DNA.encode("".join(LETTERS[s])))
    run_case(cores, queries)


def test_null2_shapes_come_from_the_ladders():
    from witch_tpu.hmm import gate_device as gd
    assert [gd.ladder_states(m) for m in (1, 128, 129, 192, 193, 1408,
                                          1536, 1537, 2689)] == \
        [128, 128, 192, 192, 256, 1536, 1536, 2048, 3072]
    assert [gd.ladder_width(n) for n in (1, 256, 257, 810, 1024, 1025)] \
        == [256, 256, 1024, 1024, 1024, 4096]
    # two datasets with different counts and lengths compile the same
    # shapes: (width, P) depends on the ladders only
    r = np.random.default_rng(0)
    shapes = []
    for n, hi in ((700, 810), (2300, 1000)):
        lens = r.integers(20, hi, n)
        got = list(gd.null2_chunks(lens, 1537))
        assert sorted(i for c, _, _ in got for i in c) == list(range(n))
        for chunk, w, P in got:
            assert len(chunk) <= P and lens[chunk].max() <= w
            assert P == gd.chunk_rows(w, 1537) and P & (P - 1) == 0
        shapes.append({(w, P) for _, w, P in got})
    assert shapes[0] == shapes[1] == {(256, 1024), (1024, 512)}


def test_null2_padding_states_are_inert():
    """A model's null2 is the same in its own bank and zero-padded into a
    wider one (another ladder step)."""
    import dataclasses

    from witch_tpu.hmm.gate_device import null2_envelopes
    bank = build_banks([synth_core(40, 10, 1), synth_core(55, 12, 2)],
                       uniform=True, n_buckets=1)[0]
    pad = 200
    wide = dataclasses.replace(bank, **{
        f.name: np.pad(getattr(bank, f.name),
                       [(0, 0), (0, pad)] + [(0, 0)] *
                       (getattr(bank, f.name).ndim - 2))
        for f in dataclasses.fields(bank)
        if f.name in ("em_odds", "t_mm", "t_mi", "t_md", "t_im", "t_ii",
                      "t_dm", "t_dd", "bm")})
    r = np.random.default_rng(3)
    entries = [(int(r.integers(2)),
                np.ascontiguousarray(r.integers(0, 4, int(r.integers(5, 70))),
                                     np.int32), 90) for _ in range(9)]
    a = null2_envelopes(bank, entries)
    b = null2_envelopes(wide, entries)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-6)


@pytest.mark.skipif(_domaindef is None or not hasattr(
    _domaindef, "flank_targets_simd"),
    reason="native AVX-512 engine unavailable")
def test_seq_bias_batch_shares_the_gate_null2():
    """The path for hosts without the native engine (hmm/null2.py) rescores
    its trimmed envelopes with the gate's device null2: where its envelope
    is the engine's, the seqbias is the engine's; pairs without a region
    keep 0; elsewhere it stays within the approximation's band."""
    from witch_tpu.hmm.null2 import seq_bias_batch
    cores = [synth_core(40, 10, 1), synth_core(55, 12, 2),
             synth_core(30, 8, 3)]
    queries = []
    for seed in range(6):
        rr = np.random.default_rng(200 + seed)
        M = [40, 55, 30][seed % 3]
        s = np.random.default_rng(seed % 3 + 1).integers(0, 4, M)
        mut = rr.random(M) < 0.1
        s[mut] = rr.integers(0, 4, mut.sum())
        flank = rr.integers(0, 4, 15)
        queries.append(DNA.encode("".join(
            LETTERS[np.concatenate([flank, s, flank])])))
    banks = build_banks(cores, uniform=True, n_buckets=1)
    got = seq_bias_batch(banks, [(j, q) for j in range(3) for q in queries])
    clist = [np.ascontiguousarray(q, np.int32) for q in queries]
    n_exact = 0
    for j, c in enumerate(cores):
        a = margs(configure(c, multihit=True))
        _, mo, pb, pe = _domaindef.flank_targets_simd(*a, clist, 1)
        nreg, _, sbias = _domaindef.evaluate_targets_rows(
            *a, clist, 42, 200, 1, 0, mo, pb, pe, 1)[:3]
        want = np.asarray(sbias) / np.log(2.0)
        mine = got[j * len(queries):(j + 1) * len(queries)]
        assert np.all(mine[np.asarray(nreg) == 0] == 0.0)
        assert np.abs(mine - want).max() < 0.025
        n_exact += int(np.sum((np.abs(mine - want) < 1e-4) & (want > 0)))
    assert n_exact >= 4
