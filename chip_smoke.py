"""End-to-end smoke test of witch-tpu on one NVIDIA GPU.

    python chip_smoke.py           # one card: phases 1-4
    python chip_smoke.py --four    # four cards: sharded scoring and the
                                   # DNA run on 4 cards vs 1, nothing else

Phases (one process holds the card; the CPU reference run is a child
process pinned to the CPU that never opens it):

  1. device: platform, device kind, count, the card's name and power
     limit; the native host engine must have loaded.
  2. kernels at real widths against their plain references, on the
     example banks of bench_assets.npz: the Triton Forward pre-score
     against the f64 Forward (hmm/forward_ref.py, 1e-3 bits) and the XLA
     scan, and the device null2 of the reporting gate against the
     native f64 engine (2e-3 nats of seqbias); the tests marked `gpu`.
  3. amino: `python -m witch_tpu` on the 100-sequence backbone and 500
     queries of tests/golden/ref_amino500.*; all 600 masked rows must
     equal the reference WITCH output.
  4. DNA at deployment size: a seeded 1,000-sequence backbone and 2,000
     fragments (scripts/make_scale_dataset.py) through the pipeline on
     the card and through the host engine on the CPU; aligned.fasta and
     aligned.masked.fasta must match byte for byte, and the stage times
     must show the pre-score and the gate on the device.

Generated data and outputs go under .smoke/ (gitignored). Any failed
phase exits non-zero. The last line of a passing run is one JSON object
naming the device.
"""

import filecmp
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
# the environment as the user gave it, for the CPU reference child (the
# in-process pytest run adjusts os.environ for its own CPU tests)
ENV0 = dict(os.environ)
WORK = os.path.join(HERE, ".smoke")
GOLD = os.path.join(HERE, "tests", "golden")
FWD_TOL_BITS = 1e-3      # f32 Forward vs f64 (validated bound)
NULL2_TOL_NATS = 2e-3    # f32 envelope null2 vs the f64 engine
DNA_SEED = 20260820


def log(msg):
    print("[smoke %7.1fs] %s" % (time.time() - T0, msg), flush=True)


T0 = time.time()


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()


def phase_device():
    import jax

    from witch_tpu import configure_jax
    from witch_tpu.device import on_gpu
    configure_jax()
    if not on_gpu():
        raise SystemExit("chip_smoke: JAX found no GPU (backend %r)"
                         % jax.default_backend())
    devs = jax.devices()
    log("device: platform %s, kind %s, count %d"
        % (devs[0].platform, devs[0].device_kind, len(devs)))
    for line in card_line():
        log("card: %s" % line)
    from witch_tpu.native import _domaindef  # noqa: F401  (must load)
    log("native host engine loaded")
    return devs


def bench_banks():
    sys.path.insert(0, os.path.join(HERE, "scripts"))
    from make_bench_assets import load_banks, load_profile_row
    banks, z = load_banks(os.path.join(HERE, "bench_assets.npz"))
    return banks, z["codes"], z["lens"], load_profile_row


def phase_kernels():
    import jax.numpy as jnp

    from witch_tpu.hmm import gate_device
    from witch_tpu.hmm.forward import score_bank
    from witch_tpu.hmm.forward_ref import bit_score
    from witch_tpu.hmm.profile import Profile
    from witch_tpu.native import _domaindef
    from witch_tpu.ops import pallas_forward as pf

    banks, codes, lens, load_profile_row = bench_banks()
    rng = np.random.default_rng(0)
    for bi, b in enumerate(banks):
        t0 = time.time()
        got = score_bank(b, codes, lens, backend="pallas")
        t_kernel = time.time() - t0
        t0 = time.time()
        xla = score_bank(b, codes, lens, backend="xla")
        t_xla = time.time() - t0
        err = 0.0
        for _ in range(16):
            q, r = int(rng.integers(len(lens))), int(rng.integers(b.H))
            p = load_profile_row(b, r)
            prof = Profile(msc=p.msc, isc=np.zeros_like(p.msc),
                           t_mm=p.t_mm, t_mi=p.t_mi, t_md=p.t_md,
                           t_im=p.t_im, t_ii=p.t_ii, t_dm=p.t_dm,
                           t_dd=p.t_dd, bm=p.bm, multihit=True, M=p.M,
                           molecule="dna")
            ref = bit_score(prof, codes[q, :lens[q]])
            err = max(err, abs(got[q, r] - ref))
        dx = float(np.abs(got - xla).max())
        log("forward bank %d %s: f32 Triton vs f64 max |err| %.2e bits "
            "(16 pairs, tol %.0e), vs XLA scan max %.2e bits over %d "
            "pairs; first calls (compile incl.) kernel %.2fs, XLA %.2fs"
            % (bi, b.em_odds.shape, err, FWD_TOL_BITS, dx, got.size,
               t_kernel, t_xla))
        if not (err < FWD_TOL_BITS and dx < FWD_TOL_BITS):
            raise SystemExit("forward kernel outside tolerance")
    b = banks[0]
    em, trans, mlen = pf.bank_kernel_arrays(b)
    _, cT, ql, nres = pf.query_blocks(codes, lens)
    hc = pf.models_per_call(b.H, cT.shape[0], em.shape[1])

    def first(a):    # the first call's models, zero-padded as in forward_bits
        out = np.zeros((hc,) + a.shape[1:], a.dtype)
        out[:min(hc, len(a))] = a[:hc]
        return jnp.asarray(out)
    ma = pf.forward_nats_blocks.lower(
        jnp.asarray(cT), jnp.asarray(ql), jnp.asarray(nres), first(em),
        first(trans), first(mlen)).compile().memory_analysis()
    log("forward kernel step memory_analysis: %s" % (ma,))

    # device null2 of the gate vs the native engine, real model widths
    for bi, (b, nmod) in enumerate(zip(banks, (6, 2))):
        rows = rng.choice(b.H, min(nmod, b.H), replace=False)
        qsel = rng.choice(len(lens), min(48, len(lens)), replace=False)
        qcodes = [np.ascontiguousarray(codes[q, :lens[q]], np.int32)
                  for q in qsel]
        allargs, flank, oracle = {}, {}, {}
        for j, r in enumerate(rows):
            p = load_profile_row(b, int(r))
            allargs[j] = [np.ascontiguousarray(x, np.float64) for x in (
                p.msc, p.t_mm, p.t_mi, p.t_md, p.t_im, p.t_ii, p.t_dm,
                p.t_dd, p.bm)]
            _, mo, pb, pe = _domaindef.flank_targets_simd(
                *allargs[j], qcodes, 1)
            flank[j] = (mo, pb, pe)
            oracle[j] = _domaindef.evaluate_targets_rows(
                *allargs[j], qcodes, 42, 200, 1, 0, mo, pb, pe, 1)
        by_j = {j: list(range(len(qcodes))) for j in range(len(rows))}
        t0 = time.time()
        res, stats = gate_device.evaluate_gate_device(
            [b], {j: (0, int(r)) for j, r in enumerate(rows)}, allargs,
            qcodes, by_j, flank, nthreads=8)
        t_gate = time.time() - t0
        dmax = 0.0
        for j in by_j:
            o, d = oracle[j], res[j]
            if not (np.array_equal(o[0], d[0]) and np.array_equal(o[1], d[1])
                    and np.array_equal(o[6], d[6])):
                raise SystemExit("device gate: region/envelope counts differ")
            dmax = max(dmax, float(np.abs(np.asarray(o[2]) - d[2]).max()))
        log("null2 bank %d (%d models x %d queries, %d envelopes on "
            "device): max |seqbias device - f64 engine| %.2e nats (tol "
            "%.0e); first call (compile incl.) %.2fs"
            % (bi, len(rows), len(qcodes), stats["entries"], dmax,
               NULL2_TOL_NATS, t_gate))
        if not dmax < NULL2_TOL_NATS:
            raise SystemExit("device null2 outside tolerance")

    import pytest
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(HERE, "tests", "test_pallas_forward.py")])
    if rc != 0:
        raise SystemExit("gpu-marked tests failed (rc=%d)" % rc)
    log("gpu-marked tests passed")


def run_witch(args):
    """One `python -m witch_tpu` run, in this process (it holds the card),
    into a fresh output directory (an old one would be resumed)."""
    from witch_tpu import witch_runner
    shutil.rmtree(args[args.index("-d") + 1], ignore_errors=True)
    return witch_runner(list(args))


def read_fasta_dict(path):
    from witch_tpu.io.fasta import read_fasta
    return dict(read_fasta(path))


def phase_amino():
    out = os.path.join(WORK, "amino500")
    t0 = time.time()
    run_witch(["-b", os.path.join(GOLD, "ref_amino500.backbone.fasta"),
               "-e", os.path.join(GOLD, "ref_amino500.backbone.tre"),
               "-q", os.path.join(GOLD, "ref_amino500.queries.fasta"),
               "-d", out, "-o", "aligned.fasta", "--molecule", "amino"])
    mine = read_fasta_dict(os.path.join(out, "aligned.masked.fasta"))
    oracle = read_fasta_dict(os.path.join(
        GOLD, "ref_amino500.aligned.masked.fasta.gz"))
    bad = [n for n in oracle if mine.get(n) != oracle[n]]
    log("amino500: %d/%d masked rows equal the reference (%.1fs)"
        % (len(oracle) - len(bad), len(oracle), time.time() - t0))
    if len(oracle) != 600 or bad:
        raise SystemExit("amino500 rows diverge: %s" % bad[:8])
    show_stages(out)


def dna_data():
    data = os.path.join(WORK, "dna1000")
    if not os.path.exists(os.path.join(data, "queries.fasta")):
        subprocess.run(
            [sys.executable, os.path.join(HERE, "scripts",
                                          "make_scale_dataset.py"),
             "--n", "1000", "--queries", "2000", "--cols", "1536",
             "--seed", str(DNA_SEED), "--out", data],
            check=True, stdout=subprocess.DEVNULL)
    return data


def dna_args(data, out):
    return ["-b", os.path.join(data, "backbone.aln.fasta.gz"),
            "-e", os.path.join(data, "backbone.tre"),
            "-q", os.path.join(data, "queries.fasta"),
            "-d", out, "-o", "aligned.fasta"]


def stages(out):
    with open(os.path.join(out, "runtime_breakdown.txt")) as f:
        return f.read()


def show_stages(out):
    for line in stages(out).splitlines():
        log("  | " + line)


def same_rows(a, b):
    return all(filecmp.cmp(os.path.join(a, f), os.path.join(b, f),
                           shallow=False)
               for f in ("aligned.fasta", "aligned.masked.fasta"))


def phase_dna():
    data = dna_data()
    gpu_out = os.path.join(WORK, "dna1000_gpu")
    cpu_out = os.path.join(WORK, "dna1000_cpu")
    t0 = time.time()
    run_witch(dna_args(data, gpu_out))
    log("DNA 1000/2000 on the card: %.1fs" % (time.time() - t0))
    show_stages(gpu_out)
    st = stages(gpu_out)
    if "scoring: bank Mp=" not in st or "scoring: device gate" not in st:
        raise SystemExit("DNA run: pre-score or gate did not run on device")
    t0 = time.time()
    env = dict(ENV0, JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="")
    shutil.rmtree(cpu_out, ignore_errors=True)
    subprocess.run([sys.executable, "-m", "witch_tpu"]
                   + dna_args(data, cpu_out),
                   env=env, check=True, cwd=HERE, stdout=subprocess.DEVNULL)
    log("DNA 1000/2000 on the CPU host engine: %.1fs" % (time.time() - t0))
    show_stages(cpu_out)
    if not same_rows(gpu_out, cpu_out):
        raise SystemExit("DNA run: card output differs from host engine")
    n = len(read_fasta_dict(os.path.join(gpu_out, "aligned.fasta")))
    log("DNA 1000/2000: aligned.fasta and aligned.masked.fasta identical "
        "byte for byte (%d rows)" % n)


def phase_four(devs):
    from witch_tpu.hmm.forward import score_bank
    from witch_tpu.parallel.dist import data_mesh
    if len(devs) < 4:
        raise SystemExit("--four needs 4 cards, found %d" % len(devs))
    mesh = data_mesh(4)
    banks, codes, lens, _ = bench_banks()
    for bi, b in enumerate(banks):
        one = score_bank(b, codes, lens)
        four = score_bank(b, codes, lens, mesh=mesh)
        if not np.array_equal(one, four):
            raise SystemExit("sharded scores differ from one card")
        log("bank %d: scores on 4 cards bit-identical to 1 card (%d pairs)"
            % (bi, one.size))
    data = dna_data()
    out4 = os.path.join(WORK, "dna1000_4cards")
    out1 = os.path.join(WORK, "dna1000_1card")
    t0 = time.time()
    run_witch(dna_args(data, out4))
    log("DNA 1000/2000 with 4 cards: %.1fs" % (time.time() - t0))
    show_stages(out4)
    with open(os.path.join(out4, "log.txt")) as f:
        sharded = "on 4-device data mesh" in f.read()
    if not sharded:
        raise SystemExit("DNA run did not shard over 4 cards")
    os.environ["WITCH_TPU_NO_MESH"] = "1"
    t0 = time.time()
    run_witch(dna_args(data, out1))
    del os.environ["WITCH_TPU_NO_MESH"]
    log("DNA 1000/2000 on 1 card: %.1fs" % (time.time() - t0))
    if not same_rows(out4, out1):
        raise SystemExit("DNA run: 4-card output differs from 1 card")
    log("DNA 1000/2000: 4-card rows identical to 1-card rows")


def main():
    four = "--four" in sys.argv[1:]
    sys.path.insert(0, HERE)
    os.makedirs(WORK, exist_ok=True)
    devs = phase_device()
    if four:
        phase_four(devs)
    else:
        for name, phase in (("kernels", phase_kernels),
                            ("amino", phase_amino), ("dna", phase_dna)):
            t0 = time.time()
            phase()
            log("phase %s done (%.1fs)" % (name, time.time() - t0))
    d = devs[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devs)}}), flush=True)


if __name__ == "__main__":
    main()
