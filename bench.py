"""Benchmark: all-vs-all Forward pre-score throughput on the example
workload (the reference's dominant cost: 141 HMMs x 500 queries of
`hmmsearch --max`, witch_msa/gcmm/algorithm.py:524-537; reference CPU
baseline: 236.2 CPU-seconds of hmmsearch, i.e. 1194 pairs/s on 4 cores).

Times the pre-score call the pipeline makes on a GPU (hmm/forward.py:
score_bank over the two banks of bench_assets.npz, regenerate with
scripts/make_bench_assets.py), end to end from host arrays to host
scores. It is a device measurement: without a GPU it exits non-zero
and prints no result. Prints the card's name and power limit, then ONE
JSON line.

    python bench.py
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
BASELINE_PAIRS_PER_S = 70500 / (236.2 / 4)


def main(reps: int = 5):
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(HERE, "scripts"))
    import jax

    from witch_tpu import configure_jax
    from witch_tpu.device import on_gpu
    configure_jax()
    if not on_gpu():
        raise SystemExit("bench.py: no GPU (JAX backend %r); a CPU number "
                         "is not this metric" % jax.default_backend())
    from make_bench_assets import load_banks

    from witch_tpu.hmm.forward import score_bank

    dev = jax.devices()[0]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)

    banks, z = load_banks(os.path.join(HERE, "bench_assets.npz"))
    codes, lens = z["codes"], z["lens"]

    def grid():
        return [score_bank(b, codes, lens) for b in banks]

    grid()                                    # compile + first run
    times = []
    for _ in range(reps):
        t0 = time.time()
        grid()                                # host scores: synchronized
        times.append(time.time() - t0)
    dt = float(np.median(times))
    total_pairs = len(lens) * sum(b.H for b in banks)
    true_cells = int(lens.sum()) * int(z["true_states"])
    print(json.dumps({
        "metric": "forward_scoring_pairs_per_s",
        "value": round(total_pairs / dt, 1),
        "unit": "query-HMM pairs/s (141-HMM eHMM x 500 queries, 1 card)",
        "vs_baseline": round(total_pairs / dt / BASELINE_PAIRS_PER_S, 2),
        "gcups_true": round(true_cells / dt / 1e9, 2),
        "seconds_per_full_grid": round(dt, 4),
        "backend": "pallas-triton",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": card,
    }), flush=True)


if __name__ == "__main__":
    main()
