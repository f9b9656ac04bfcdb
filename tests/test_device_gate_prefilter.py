"""The pipeline's device path vs the native host engine.

The device decision (pipeline.on_gpu) is forced on here, so the device
stages run on JAX's CPU backend: the pre-score (XLA scan), the device
gate's null2, and with --full-search-results the flank-row gate
prefilter (hmm/flank_device.py:prefilter_grid), which lets no-region
pairs skip native domain definition. Persisted results and the final
alignment must match the all-native run.
"""

import os

import numpy as np
import pytest

from witch_tpu.cli import init_parser
from witch_tpu.config import build_configs
from witch_tpu.io.fasta import read_fasta, write_fasta


@pytest.fixture()
def tiny_problem(tmp_path):
    rng = np.random.default_rng(23)
    letters = np.array(list("ACGT"))
    base = letters[rng.integers(0, 4, 120)]
    rows = []
    for i in range(24):
        s = base.copy()
        mut = rng.random(120) < 0.12
        s[mut] = letters[rng.integers(0, 4, mut.sum())]
        gap = rng.random(120) < 0.05
        s = np.where(gap, "-", s)
        rows.append((f"t{i}", "".join(s)))
    bb_path = tmp_path / "bb.fasta"
    write_fasta(rows, str(bb_path))
    queries = []
    for i in range(6):
        src = rows[rng.integers(0, 24)][1].replace("-", "")
        a = rng.integers(0, 30)
        queries.append((f"q{i}", src[a:a + 55]))
    # one junk query that should gate out against most models
    queries.append(("junk", "".join(letters[rng.integers(0, 4, 50)])))
    q_path = tmp_path / "q.fasta"
    write_fasta(queries, str(q_path))
    return bb_path, q_path


def _run(args, monkeypatch=None):
    from witch_tpu import pipeline
    if monkeypatch is not None:
        monkeypatch.setattr(pipeline, "on_gpu", lambda: True)
    try:
        build_configs(init_parser(), args)
        return pipeline.main_alignment_process()
    finally:
        if monkeypatch is not None:
            monkeypatch.undo()


def _read_results(outdir):
    res = {}
    droot = os.path.join(str(outdir), "tree_decomp", "root")
    for d in sorted(os.listdir(droot)):
        f = os.path.join(droot, d, "hmmsearch.results.%s.fragment_chunk_0"
                         % d)
        if os.path.exists(f):
            with open(f) as fh:
                res[d] = eval(fh.read())  # reference literal-dict format
    return res


def test_device_prefilter_matches_native(tiny_problem, tmp_path,
                                        monkeypatch):
    bb, q = tiny_problem
    out_n = tmp_path / "native"
    _run(["-b", str(bb), "-q", str(q), "-d", str(out_n),
          "-o", "aligned.fasta", "--full-search-results", "1",
          "--keep-decomposition", "1"])
    out_d = tmp_path / "device"
    _run(["-b", str(bb), "-q", str(q), "-d", str(out_d),
          "-o", "aligned.fasta", "--full-search-results", "1",
          "--keep-decomposition", "1"],
         monkeypatch)
    rn = _read_results(out_n)
    rd = _read_results(out_d)
    assert rn.keys() == rd.keys() and rn
    for d in rn:
        assert set(rn[d]) == set(rd[d]), d
        for taxon, (ev, sc) in rn[d].items():
            assert rd[d][taxon][1] == pytest.approx(sc, abs=0.05), \
                (d, taxon)
    a_n = dict(read_fasta(str(out_n / "aligned.masked.fasta")))
    a_d = dict(read_fasta(str(out_d / "aligned.masked.fasta")))
    assert a_n == a_d
    # the device run must actually have taken the prefilter path
    with open(out_d / "runtime_breakdown.txt") as fh:
        assert "device gate prefilter" in fh.read()


def test_device_path_matches_host(tiny_problem, tmp_path, monkeypatch):
    """Device pre-score + device gate give the host engine's rows and
    weights byte for byte (the CPU-sized form of chip_smoke.py's DNA
    phase)."""
    bb, q = tiny_problem
    outs = {}
    for tag, mp in (("host", None), ("device", monkeypatch)):
        out = tmp_path / tag
        _run(["-b", str(bb), "-q", str(q), "-d", str(out),
              "-o", "aligned.fasta", "--save-weight", "1"], mp)
        outs[tag] = [open(out / f).read() for f in (
            "aligned.fasta", "aligned.masked.fasta", "weights.txt")]
        stages = open(out / "runtime_breakdown.txt").read()
        assert ("scoring: device gate" in stages) == (tag == "device")
        assert ("native Forward pre-rank" in stages) == (tag == "host")
    assert outs["device"] == outs["host"]
