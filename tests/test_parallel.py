"""Multi-chip sharding tests on the virtual 8-device CPU mesh.

The production contract (parallel/dist.py): sharded scoring over the
'data' mesh is BIT-identical to the single-device path, so every
downstream reported-score semantic (tau gate, null2, top-k weighting)
is unchanged — validated here at the score level and end-to-end at the
pipeline level (identical output files with and without the mesh).
"""

import numpy as np
import pytest


def _toy():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "graft_entry", "/root/repo/__graft_entry__.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_sharded_scoring_bit_identical():
    import jax
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual mesh")
    from witch_tpu.hmm.forward import score_bank
    from witch_tpu.parallel.dist import data_mesh

    mod = _toy()
    bank, qcodes, qlens, sizes, _ = mod._toy_bank_and_queries(H=8, Q=19)
    # deliberately ragged Q=19: exercises the pad-to-multiple-of-n path
    mesh = data_mesh(8)
    bits_sh = score_bank(bank, qcodes, qlens, backend="xla", mesh=mesh)
    bits_1 = score_bank(bank, qcodes, qlens, backend="xla")
    assert np.array_equal(bits_sh, bits_1)


def test_sharded_kernel_bit_identical():
    """The GPU pre-score kernel under shard_map (query blocks over
    'data', interpret mode here) equals the one-device kernel bit for
    bit, with the block count padded to the mesh."""
    import jax
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual mesh")
    from witch_tpu.ops.pallas_forward import forward_bits
    from witch_tpu.parallel.dist import data_mesh, sharded_kernel_step

    bank, qcodes, _, _, _ = _toy()._toy_bank_and_queries(H=3, Q=70, L=12)
    qlens = np.random.default_rng(4).integers(3, 13, 70).astype(np.int32)
    one = forward_bits(bank, qcodes, qlens, interpret=True)
    eight = forward_bits(bank, qcodes, qlens, n_shards=8,
                         step=sharded_kernel_step(data_mesh(8),
                                                  interpret=True))
    assert np.array_equal(one, eight)


def test_dryrun_multichip_production_step():
    import jax
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual mesh")
    _toy().dryrun_multichip(8)


def test_mesh_helpers():
    import jax
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual mesh")
    from witch_tpu.parallel.dist import data_mesh, make_mesh
    assert int(data_mesh(8).shape["data"]) == 8
    assert data_mesh(1) is None
    mesh2 = make_mesh(8, model_parallel=4)
    assert mesh2.shape["model"] == 4


def test_pipeline_sharded_end_to_end(tmp_path, monkeypatch):
    """Multi-host query sharding (WITCH_TPU_SHARD emulation): every
    shard runs score->gate->align on its owned query block only; the
    last shard gathers all rows and merges. Output files must be
    byte-identical to the unsharded run (SURVEY §2.4/§5.8)."""
    import jax
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual mesh")
    from witch_tpu.cli import init_parser
    from witch_tpu.config import build_configs
    from witch_tpu.io.fasta import read_fasta, write_fasta
    from witch_tpu.pipeline import main_alignment_process

    rng = np.random.default_rng(11)
    letters = np.array(list("ACGT"))
    base = letters[rng.integers(0, 4, 90)]
    rows = []
    for i in range(20):
        s = base.copy()
        mut = rng.random(90) < 0.12
        s[mut] = letters[rng.integers(0, 4, mut.sum())]
        rows.append((f"t{i}", "".join(s)))
    write_fasta(rows, str(tmp_path / "bb.fasta"))
    queries = []
    for i in range(9):
        src = rows[rng.integers(0, 20)][1]
        a = rng.integers(0, 25)
        queries.append((f"q{i}", src[a:a + 45]))
    write_fasta(queries, str(tmp_path / "q.fasta"))

    def run(outdir, shard_env):
        if shard_env:
            monkeypatch.setenv("WITCH_TPU_SHARD", shard_env)
        else:
            monkeypatch.delenv("WITCH_TPU_SHARD", raising=False)
        parser = init_parser()
        build_configs(parser, [
            "-b", str(tmp_path / "bb.fasta"),
            "-q", str(tmp_path / "q.fasta"),
            "-d", str(outdir), "-o", "aligned.fasta"])
        return main_alignment_process()

    ref_out = run(tmp_path / "out_single", "")
    ref = dict(read_fasta(ref_out))

    out_sh = tmp_path / "out_sharded"
    assert run(out_sh, "0/3") is None        # stages rows, no merge
    assert run(out_sh, "2/3") is None
    merged_out = run(out_sh, "1/3")          # last shard merges
    assert merged_out is not None
    assert dict(read_fasta(merged_out)) == ref
    masked = str(merged_out).replace("aligned.fasta",
                                     "aligned.masked.fasta")
    ref_masked = str(ref_out).replace("aligned.fasta",
                                      "aligned.masked.fasta")
    assert dict(read_fasta(masked)) == dict(read_fasta(ref_masked))
    monkeypatch.delenv("WITCH_TPU_SHARD", raising=False)


def test_pipeline_identical_outputs_with_mesh(tmp_path, monkeypatch):
    """End-to-end: the pipeline run on the 8-device mesh writes the same
    aligned.fasta + weights.txt as the single-device run."""
    import jax
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual mesh")
    from witch_tpu.cli import init_parser
    from witch_tpu.config import build_configs
    from witch_tpu.io.fasta import read_fasta, write_fasta

    rng = np.random.default_rng(7)
    letters = np.array(list("ACGT"))
    base = letters[rng.integers(0, 4, 100)]
    rows = []
    for i in range(24):
        s = base.copy()
        mut = rng.random(100) < 0.12
        s[mut] = letters[rng.integers(0, 4, mut.sum())]
        rows.append((f"t{i}", "".join(s)))
    write_fasta(rows, str(tmp_path / "bb.fasta"))
    queries = []
    for i in range(7):
        src = rows[rng.integers(0, 24)][1]
        a = rng.integers(0, 30)
        queries.append((f"q{i}", src[a:a + 50]))
    write_fasta(queries, str(tmp_path / "q.fasta"))

    outs = {}
    for tag, no_mesh in (("mesh", ""), ("single", "1")):
        monkeypatch.setenv("WITCH_TPU_NO_MESH", no_mesh)
        outdir = tmp_path / ("out_" + tag)
        parser = init_parser()
        build_configs(parser, [
            "-b", str(tmp_path / "bb.fasta"), "-q", str(tmp_path / "q.fasta"),
            "-d", str(outdir), "-o", "aligned.fasta", "--save-weight", "1"])
        from witch_tpu.pipeline import main_alignment_process
        out = main_alignment_process()
        outs[tag] = (dict(read_fasta(out)),
                     open(outdir / "weights.txt").read())
    assert outs["mesh"][0] == outs["single"][0]
    assert outs["mesh"][1] == outs["single"][1]


def test_real_jax_distributed_two_processes():
    """The ACTUAL multi-process DCN all-gather branch of
    parallel/dist.py:gather_rows: 2 jax.distributed CPU processes,
    merged output byte-identical to a single-process run
    (scripts/run_distributed.py)."""
    import pathlib
    import subprocess
    import sys
    script = pathlib.Path(__file__).resolve().parents[1] / "scripts" / \
        "run_distributed.py"
    r = subprocess.run([sys.executable, str(script), "2"],
                       capture_output=True, text=True, timeout=420)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert "byte-identical" in r.stdout, r.stdout
