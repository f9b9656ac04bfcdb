"""Real multi-process distributed run: jax.distributed over N CPU
processes, exercising the ACTUAL DCN all-gather branch of
parallel/dist.py:gather_rows (multihost_utils.process_allgather), not
the single-process file-staged emulation.

Each process discovers its shard via jax.process_index()/process_count()
(parallel/dist.py:process_shard), scores/gates/aligns only its owned
query block, then all processes all-gather the utf-8-packed aligned
rows; process 0 merges and writes the output. The parent asserts the
merged output is byte-identical to a single-process run of the same
dataset.

Usage:
  python scripts/run_distributed.py            # parent: spawns 2 procs
  python scripts/run_distributed.py N          # parent: spawns N procs
  (child mode is internal: --child I N PORT DIR)

Reference analogue: the filesystem task bus + subprocess farm
(witch_msa/gcmm/results_handler.py:91-236, SURVEY.md §5.8); here the
communication backend is JAX collectives over the distributed runtime.
"""

import os
import socket
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def make_dataset(td):
    import numpy as np

    from witch_tpu.io.fasta import write_fasta
    rng = np.random.default_rng(3)
    letters = np.array(list("ACGT"))
    base = letters[rng.integers(0, 4, 80)]
    bb = []
    for i in range(16):
        s = base.copy()
        mut = rng.random(80) < 0.12
        s[mut] = letters[rng.integers(0, 4, mut.sum())]
        bb.append(("t%d" % i, "".join(s)))
    queries = []
    for i in range(7):
        src = bb[int(rng.integers(0, 16))][1]
        a = int(rng.integers(0, 20))
        queries.append(("q%d" % i, src[a:a + 40]))
    write_fasta(bb, os.path.join(td, "bb.fasta"))
    write_fasta(queries, os.path.join(td, "q.fasta"))


def run_pipeline(td, outdir):
    from witch_tpu.cli import init_parser
    from witch_tpu.config import build_configs
    from witch_tpu.pipeline import main_alignment_process
    build_configs(init_parser(), [
        "-b", os.path.join(td, "bb.fasta"),
        "-q", os.path.join(td, "q.fasta"),
        "-d", outdir, "-o", "aligned.fasta"])
    return main_alignment_process()


def child(i, n, port, td):
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address="localhost:%d" % port,
        num_processes=n, process_id=i)
    assert jax.process_count() == n
    out = run_pipeline(td, os.path.join(td, "dist"))
    if i == 0:
        assert out is not None, "process 0 must merge"
        print("child0 merged:", out, flush=True)
    else:
        assert out is None, "only process 0 merges"
    jax.distributed.shutdown()


def main():
    if len(sys.argv) > 1 and sys.argv[1] == "--child":
        i, n, port = int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4])
        child(i, n, port, sys.argv[5])
        return 0

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    import tempfile
    with tempfile.TemporaryDirectory() as td:
        make_dataset(td)
        # single-process reference
        env_base = dict(os.environ, JAX_PLATFORMS="cpu",
                        WITCH_TPU_NO_MESH="1")
        r = subprocess.run(
            [sys.executable, "-c",
             "import sys; sys.path.insert(0, %r); "
             "import jax; jax.config.update('jax_platforms', 'cpu'); "
             "from scripts.run_distributed import run_pipeline; "
             "print(run_pipeline(%r, %r))" % (HERE, td,
                                              os.path.join(td, "single"))],
            env=env_base, capture_output=True, text=True, timeout=600)
        if r.returncode != 0:
            sys.stderr.write(r.stderr[-2000:])
            raise SystemExit("single-process reference failed")

        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--child",
             str(i), str(n), str(port), td],
            env=env_base, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for i in range(n)]
        outs = []
        ok = True
        for i, p in enumerate(procs):
            try:
                out, _ = p.communicate(timeout=600)
            except subprocess.TimeoutExpired:
                p.kill()
                out = "(timeout)"
            outs.append(out)
            ok = ok and p.returncode == 0
        if not ok:
            for i, o in enumerate(outs):
                sys.stderr.write("--- child %d ---\n%s\n" % (i, o[-2000:]))
            raise SystemExit("distributed run failed")

        single = open(os.path.join(td, "single",
                                   "aligned.masked.fasta"), "rb").read()
        dist = open(os.path.join(td, "dist",
                                 "aligned.masked.fasta"), "rb").read()
        assert single == dist, "distributed output differs"
        print("jax.distributed %d processes: DCN all-gather executed, "
              "merged output byte-identical to single-process "
              "(%d bytes)" % (n, len(dist)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
