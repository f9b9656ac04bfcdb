"""Stage timings behind the device-path choices, on one GPU.

    python scripts/compare_paths.py [--json PATH]

Each measurement runs in its own child process, one at a time (a JAX
process reserves most of the card's memory); this process never opens
the card. What it measures:

  prescore  the Forward pre-score stage (hmm/forward.py:score_bank over
            every bank), Triton kernel (K) against the XLA scan (X),
            alternating K X X K in one process after a first call of
            each (compile included), at the example banks of
            bench_assets.npz and at the banks of the DNA 1,000/2,000 set.
  gate      the scenario-D pipeline on two seeded DNA sets of different
            size, HMM count and fragment length: set A with the device
            gate, then set B with the device gate and with the host gate
            (pipeline.DEVICE_GATE). Counts the entries each run adds to
            the persistent compile cache, so set B shows what a new
            dataset compiles once set A has run. Set B's output rows
            must be identical under both gates.

Prints the card's name and power limit, one line per measurement, and
the stage lines of each run; writes everything as JSON to --json.
Generated data and outputs go under .smoke/ (gitignored).
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORK = os.path.join(HERE, ".smoke")
# (n backbone sequences, queries, columns, seed)
SET_A = (1000, 2000, 1536, 20260820)
SET_B = (800, 1500, 1400, 7)


def dataset(spec):
    n, q, cols, seed = spec
    out = os.path.join(WORK, "dna%d_%d_%d_s%d" % spec)
    if not os.path.exists(os.path.join(out, "queries.fasta")):
        subprocess.run(
            [sys.executable, os.path.join(HERE, "scripts",
                                          "make_scale_dataset.py"),
             "--n", str(n), "--queries", str(q), "--cols", str(cols),
             "--seed", str(seed), "--out", out],
            check=True, stdout=subprocess.DEVNULL)
    return out


def witch_args(data, out):
    return ["-b", os.path.join(data, "backbone.aln.fasta.gz"),
            "-e", os.path.join(data, "backbone.tre"),
            "-q", os.path.join(data, "queries.fasta"),
            "-d", out, "-o", "aligned.fasta"]


# ---------------------------------------------------------------- children

def child_prescore():
    import numpy as np
    sys.path.insert(0, os.path.join(HERE, "scripts"))
    from witch_tpu import configure_jax
    from witch_tpu.device import on_gpu
    configure_jax()
    if not on_gpu():
        raise SystemExit("compare_paths: no GPU")
    from make_bench_assets import load_banks

    from witch_tpu.hmm.forward import score_bank

    def stage(banks, codes, lens, label):
        rec = {}
        for be in ("pallas", "xla"):
            t0 = time.time()
            for b in banks:
                score_bank(b, codes, lens, backend=be)
            rec[be + "_first"] = time.time() - t0
        warm = {"pallas": [], "xla": []}
        for be in ("pallas", "xla", "xla", "pallas"):
            t0 = time.time()
            for b in banks:
                score_bank(b, codes, lens, backend=be)
            warm[be].append(time.time() - t0)
        for be in warm:
            rec[be + "_warm"] = warm[be]
        print("RESULT " + json.dumps({"prescore": label, **rec}),
              flush=True)

    banks, z = load_banks(os.path.join(HERE, "bench_assets.npz"))
    stage(banks, z["codes"], z["lens"], "example banks")

    from witch_tpu.cli import init_parser
    from witch_tpu.config import Configs, build_configs
    from witch_tpu.core.alignment import PackedAlignment
    from witch_tpu.core.alphabet import ALPHABETS
    from witch_tpu.ensemble import build_ensemble
    from witch_tpu.hmm.bank import build_banks
    from witch_tpu.pipeline import _encode_queries
    data = dataset(SET_A)
    build_configs(init_parser(),
                  witch_args(data, os.path.join(WORK, "cmp_prescore")))
    bb = PackedAlignment.from_fasta(
        os.path.join(data, "backbone.aln.fasta.gz"), molecule="dna")
    ens = build_ensemble(bb, os.path.join(data, "backbone.tre"),
                         Configs.alignment_size,
                         Configs.alignment_upper_bound, "dna", n_workers=8)
    # the pipeline's banks: two state-count buckets
    dbanks = build_banks([ens.cores[i] for i in ens.indices],
                         indices=ens.indices, uniform=True, n_buckets=2)
    _, _, qcodes, _ = _encode_queries(os.path.join(data, "queries.fasta"),
                                      ALPHABETS["dna"])
    lens = np.array([len(c) for c in qcodes], np.int32)
    codes = np.zeros((len(lens), int(lens.max())), np.int32)
    for i, c in enumerate(qcodes):
        codes[i, :len(c)] = c
    stage(dbanks, codes, lens, "DNA 1000/2000 banks %s" % (
        [tuple(b.em_odds.shape[:2]) for b in dbanks],))


def child_run(data, out, gate):
    from witch_tpu import pipeline, witch_runner
    from witch_tpu.device import on_gpu
    pipeline.DEVICE_GATE = gate == "device"
    shutil.rmtree(out, ignore_errors=True)
    t0 = time.time()
    witch_runner(witch_args(data, out))
    if not on_gpu():
        raise SystemExit("compare_paths: no GPU")
    with open(os.path.join(out, "runtime_breakdown.txt")) as f:
        lines = [ln.rstrip() for ln in f]
    print("RESULT " + json.dumps({"run": out, "gate": gate,
                                  "wall": time.time() - t0,
                                  "stages": lines}), flush=True)


# ------------------------------------------------------------------ parent

def cache_entries():
    from witch_tpu import CACHE_DIR
    d = os.environ.get("JAX_COMPILATION_CACHE_DIR") or CACHE_DIR
    return len(os.listdir(d)) if os.path.isdir(d) else 0


def child(*args):
    """Run one child; returns its RESULT records."""
    p = subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--child", *args], cwd=HERE, text=True,
                       stdout=subprocess.PIPE)
    out = [json.loads(ln[7:]) for ln in p.stdout.splitlines()
           if ln.startswith("RESULT ")]
    if p.returncode != 0 or not out:
        sys.stdout.write(p.stdout)
        raise SystemExit("compare_paths: child %s failed (rc %d)"
                         % (args, p.returncode))
    return out


def same_rows(a, b):
    import filecmp
    return all(filecmp.cmp(os.path.join(a, f), os.path.join(b, f),
                           shallow=False)
               for f in ("aligned.fasta", "aligned.masked.fasta"))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", default=None)
    ap.add_argument("--child", nargs="+", default=None)
    a = ap.parse_args()
    sys.path.insert(0, HERE)
    if a.child:
        if a.child[0] == "prescore":
            return child_prescore()
        return child_run(*a.child[1:])
    os.makedirs(WORK, exist_ok=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print("card: %s" % card, flush=True)
    rec = {"card": card, "prescore": [], "gate": []}
    data_a, data_b = dataset(SET_A), dataset(SET_B)
    for r in child("prescore"):
        rec["prescore"].append(r)
        med = {be: sorted(r[be + "_warm"])[len(r[be + "_warm"]) // 2]
               for be in ("pallas", "xla")}
        print("prescore %s: kernel warm %s s, XLA scan warm %s s "
              "(kernel %.1fx); first calls kernel %.2f s, XLA %.2f s"
              % (r["prescore"], ["%.4f" % t for t in r["pallas_warm"]],
                 ["%.4f" % t for t in r["xla_warm"]],
                 med["xla"] / med["pallas"], r["pallas_first"],
                 r["xla_first"]), flush=True)
    outs = {}
    for tag, data, gate in (("A", data_a, "device"), ("B", data_b, "device"),
                            ("B", data_b, "host")):
        n0 = cache_entries()
        out = os.path.join(WORK, "cmp_%s_%s" % (tag, gate))
        r = child("run", data, out, gate)[0]
        r.update(set=tag, cache_added=cache_entries() - n0)
        rec["gate"].append(r)
        outs[(tag, gate)] = out
        print("set %s, %s gate: %.1f s, compile-cache entries added %d"
              % (tag, gate, r["wall"], r["cache_added"]), flush=True)
        for ln in r["stages"]:
            if "scoring:" in ln or "align:" in ln or "Time to" in ln:
                print("  | " + ln, flush=True)
    rec["set_b_rows_identical"] = same_rows(outs[("B", "device")],
                                            outs[("B", "host")])
    print("set B rows identical under both gates: %s"
          % rec["set_b_rows_identical"], flush=True)
    if a.json:
        os.makedirs(os.path.dirname(os.path.abspath(a.json)), exist_ok=True)
        with open(a.json, "w") as f:
            json.dump(rec, f, indent=1)
    if not rec["set_b_rows_identical"]:
        raise SystemExit("compare_paths: set B rows differ between gates")


if __name__ == "__main__":
    main()
