"""Main WITCH-TPU pipeline (the reference's mainAlignmentProcess,
witch_msa/gcmm/gcmm.py:93-267, re-designed as array programs).

Stages:
  1. obtain backbone alignment/tree (or reuse a decomposition directory)
  2. decompose -> build the eHMM bank on host, quantized to .hmm precision
  3. score all queries vs all HMMs in one batched Forward pass (device)
  4. rank scores / compute adjusted-bitscore weights
  5. per query: adaptive top-k HMMs -> posterior-OA alignment -> weighted
     merge DP -> aligned row
  6. transitive merge into the backbone; write outputs
"""

from __future__ import annotations

import gzip
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from .config import Configs
from .core.alignment import PackedAlignment
from .core.alphabet import ALPHABETS, infer_datatype
from .device import on_gpu
from .ensemble import (Ensemble, build_ensemble, read_ensemble_dir,
                       write_decomposition, write_search_results)
from .hmm.bank import build_banks
from .hmm.calibrate import (forward_lambda, random_calibration_seqs,
                            tau_from_scores)
from .hmm.forward import OMEGA, score_bank
from .io.fasta import read_fasta, write_fasta
from .merger import merge_rows, remove_insertion_columns
from .weighting import calculate_weights, read_weights, write_weights

BIAS_FLOOR_BITS = float(np.log2(1.0 + OMEGA))
# every observed binary gate-drop sits below -1.7 bits, so pairs at
# >= GATE_SAFE bits are accepted without evaluation (see the note in
# compute_scores)
GATE_SAFE = 0.0
# On a GPU the reporting gate's null2 runs on the card (hmm/gate_device.py)
# when True, and on the native host engine when False. Its compile shapes
# come from fixed ladders, so the persistent compile cache serves every
# dataset after the first (PERF.md, section 6).
DEVICE_GATE = True


def _encode_queries(path: str, alphabet):
    names, seqs, codes = [], [], []
    renamed = {}
    for i, (name, seq) in enumerate(read_fasta(path)):
        seq = seq.upper()
        if "/" in name:
            new = "renamed_query_{}".format(i)
            renamed[name] = new
            name = new
        names.append(name)
        seqs.append(seq)
        codes.append(alphabet.encode(seq))
    return names, seqs, codes, renamed


def _native_args(prof):
    """f64 contiguous (msc + transitions + bm) tuple for the native
    engine, cached on the profile (three call sites per model/run)."""
    a = getattr(prof, "_nat_args", None)
    if a is None:
        a = [np.ascontiguousarray(prof.msc, np.float64)] + \
            [np.ascontiguousarray(getattr(prof, x), np.float64)
             for x in ("t_mm", "t_mi", "t_md", "t_im", "t_ii",
                       "t_dm", "t_dd", "bm")]
        try:
            prof._nat_args = a
        except AttributeError:
            pass
    return a


def _candidate_walk(reported, valid, pre, evaluated, gate_ok,
                    size_arr, owned, TOPT):
    """Walk each query's candidates in weight-rank order, dropping
    gated pairs until num_hmms survivors are found (reference rank
    behavior). Pure function of its inputs; returns the updated copy
    of `valid`."""
    out = valid.copy()
    adj_rep = reported + np.log2(size_arr)[None, :]
    for q in owned:
        top = np.argsort(-adj_rep[q], kind="stable")[:TOPT]
        accepted = 0
        for j in top:
            if pre[q, j] >= GATE_SAFE or not evaluated[q, j] \
                    or gate_ok[q, j]:
                accepted += 1
            else:
                out[q, j] = False
            if accepted >= Configs.num_hmms:
                break
    return out


def compute_scores(ens: Ensemble, qcodes: List[np.ndarray],
                   q_chunk: int = 256, q_owned=None):
    """Forward-score every query against every ensemble HMM.

    Returns (scores [Q, H_total] rounded to 0.1 bit as the reference
    parses them, valid [Q, H], index list). valid=False where the
    pre-score is below the model's calibrated forward tau (the hmmsearch
    reporting behavior WITCH inherits).

    q_owned (multi-host sharding, parallel/dist.py): when given, the
    host stages (native gate evaluation, candidate walks) run only for
    these query indices — rows outside the shard are left at their
    pre-gate values and must not be consumed downstream. Device scoring
    stays whole-grid: on a real multi-process mesh the P('data')
    sharding already gives each host only its local shard's work.
    """
    indices = ens.indices
    # exact-f32 stochastic-trace path in the native gate (alphabet
    # tables are process-global; covers every _domaindef use below)
    from .native import set_trace_alphabet
    set_trace_alphabet(ens.molecule)
    # Guard against pathologically wide models (an insertion-heavy
    # de-novo backbone can push subset HMMs to 10^5 match states, which
    # would blow compile time + memory). Oversized models are excluded
    # from scoring — they simply receive no weight, mirroring the
    # reference's alignment_upper_bound subset skipping
    # (witch_msa/gcmm/algorithm.py:90-101).
    m_cap = int(os.environ.get("WITCH_TPU_MAX_HMM_STATES", "16384"))
    dropped = [i for i in indices if ens.cores[i].M > m_cap]
    if dropped:
        Configs.warning(
            "skipping %d/%d ensemble HMMs with M > %d states "
            "(max %d); de-novo backbone is insertion-heavy"
            % (len(dropped), len(indices), m_cap,
               max(ens.cores[i].M for i in dropped)))
        indices = [i for i in indices if ens.cores[i].M <= m_cap]
        if not indices:
            raise SystemExit(
                "ERROR: every ensemble HMM exceeds the %d-state cap; "
                "raise WITCH_TPU_MAX_HMM_STATES or supply a less "
                "insertion-heavy backbone alignment (-b)" % m_cap)
    cores = [ens.cores[i] for i in indices]

    # The device decision (device.py): on the GPU the pre-score of the
    # full grid and the gate's null2 run on the card. Elsewhere the
    # native engine evaluates the full grid on the host and the device
    # pre-score pass is skipped.
    try:
        from .native import _domaindef  # noqa: F401
        have_native = True
    except ImportError:
        have_native = False
    use_device = on_gpu()
    native_prescore = have_native and not use_device

    t0 = time.time()
    # two state-count buckets: the few backbone-scale models would
    # otherwise set the padded width of every model in the bank
    banks = build_banks(cores, indices=indices, uniform=True,
                        n_buckets=2)
    Configs.runtime("  scoring: bank build/quantize (s): %f"
                    % (time.time() - t0))
    # deferred artifact writer (main_alignment_process): bank
    # quantization wants all host cores; release the writer now, into
    # the device-scoring window where the host mostly waits
    ev = getattr(Configs, "_art_gate_event", None)
    if ev is not None:
        ev.set()
    col_of = {idx: j for j, idx in enumerate(indices)}

    Q = len(qcodes)
    Lmax = max((len(c) for c in qcodes), default=1)
    codes = np.zeros((Q, Lmax), np.int32)
    lens = np.zeros(Q, np.int32)
    for i, c in enumerate(qcodes):
        codes[i, :len(c)] = c
        lens[i] = len(c)

    # The tau calibration pass (Forward-scoring 200 random sequences per
    # model, p7_Tau semantics) only feeds the fallback pre>=tau gate:
    # with the native domaindef engine present, the exact reporting gate
    # replaces it, so the pass is skipped entirely (it costs a device
    # sweep comparable to scoring 40% of the real queries, plus extra
    # kernel shapes).
    cal_codes = cal_lens = None
    if not have_native:
        # calibration seqs share the padding layout; drawn iid from the
        # REAL scoring background (p7_Tau semantics — matters for amino,
        # where bg != uniform)
        from .hmm.priors import get_background
        K = ens.backbone.alphabet.K
        cal = random_calibration_seqs(
            K, bg=get_background(cores[0].molecule) if cores else None)
        cal_w = max(Lmax, cal.shape[1])
        cal_codes = np.zeros((cal.shape[0], cal_w), np.int32)
        cal_codes[:, :cal.shape[1]] = cal
        cal_lens = np.full(cal.shape[0], cal.shape[1], np.int32)

    # multi-device: shard the query batch over the data mesh (production
    # path; bit-identical to single-device, see parallel/dist.py)
    mesh = None
    if not os.environ.get("WITCH_TPU_NO_MESH"):
        from .parallel.dist import data_mesh
        mesh = data_mesh()
        if mesh is not None:
            Configs.log("Scoring on %d-device data mesh"
                        % int(mesh.shape["data"]))

    H = len(indices)
    owned = (np.arange(Q) if q_owned is None
             else np.asarray(q_owned, np.int64))
    pre = np.zeros((Q, H), np.float64)
    tau = np.zeros(H, np.float64)

    def run_native_prescore():
        # Forward-only native pre-ranking of the full grid (exact f64
        # bits, ~2-4x cheaper per pair than full domain definition);
        # the expensive gate evaluation then runs only for each
        # query's weight-rank candidates, like the device path.
        from concurrent.futures import ThreadPoolExecutor
        from .hmm.profile import configure as _configure_f
        from .hmm.profile import null1_score as _null1_f
        from .native import _domaindef as _dd
        t0 = time.time()
        null1b = np.array([_null1_f(int(l)) for l in lens], np.float64)
        codes_list_all = [np.ascontiguousarray(qcodes[q], np.int32)
                          for q in owned]

        # AVX-512 lane-parallel f32 pre-ranker when built with it
        # (~14x the f64 scalar path, max error < 1e-4 bits); exact f64
        # scores for reported pairs still come from evaluate_targets
        _fwd_fn = _dd.forward_targets
        if not os.environ.get("WITCH_TPU_NO_SIMD"):
            _fwd_fn = getattr(_dd, "forward_targets_simd", _fwd_fn)

        def fwd_model(j):
            prof = _configure_f(ens.cores[int(indices[j])],
                                multihit=True)
            args = [np.ascontiguousarray(prof.msc, np.float64)] + \
                [np.ascontiguousarray(getattr(prof, a), np.float64)
                 for a in ("t_mm", "t_mi", "t_md", "t_im", "t_ii",
                           "t_dm", "t_dd", "bm")]
            return j, np.asarray(_fwd_fn(*args, codes_list_all, 1))

        nt0 = max(1, min(8, Configs.num_cpus))
        with ThreadPoolExecutor(max_workers=nt0) as ex:
            for j, fwd in ex.map(fwd_model, range(H)):
                pre[owned, j] = (fwd - null1b[owned]) / np.log(2.0)
        Configs.runtime("  scoring: native Forward pre-rank %d pairs "
                        "(s): %f" % (len(owned) * H, time.time() - t0))

    def run_device_prescore():
        for b in banks:
            t0 = time.time()
            bits = score_bank(b, codes, lens, q_chunk=q_chunk, mesh=mesh)
            t1 = time.time()
            sim = None
            if cal_codes is not None:
                sim = score_bank(b, cal_codes, cal_lens, q_chunk=q_chunk,
                                 mesh=mesh)
            t2 = time.time()
            for j, idx in enumerate(b.hmm_indices):
                col = col_of[int(idx)]
                pre[:, col] = bits[:, j]
                if sim is not None:
                    lam = forward_lambda(ens.cores[int(idx)])
                    tau[col] = tau_from_scores(sim[:, j], lam)
            Configs.runtime(
                "  scoring: bank Mp=%d H=%d queries %.2fs cal %.2fs "
                "tau-fit %.2fs" % (b.em_odds.shape[1], len(b.hmm_indices),
                                   t1 - t0, t2 - t1, time.time() - t2))

    if native_prescore:
        run_native_prescore()
    else:
        run_device_prescore()
    # Exact null2 bias + reporting gate via the native domaindef engine.
    #
    # hmmsearch only prints a target when domain definition yields >= 1
    # region AND >= 1 envelope; WITCH inherits that as the membership of
    # its score lists (witch_msa/gcmm/loader.py:286-297). The engine
    # (native/domaindef_kernel.cpp, spec in hmm/trace_ensemble.py)
    # reproduces regions, the per-region reseeded 200-trace ensembles,
    # clustering, and the ByTrace/ByExpectation null2 — one call per
    # (model, target) returns (nregions, nenvelopes, seqbias).
    #
    # It runs for each query's top weight-ranked candidates (weight rank
    # = score + log2 subset size, the reference's calculateWeights
    # ordering) — every pair that can enter a weight list. Pairs outside
    # the walked set stay valid with the omega-floor score: they only
    # contribute softmax-denominator mass, where the drop/keep
    # distinction is numerically immaterial (validated on the example
    # oracle), and every observed binary drop sits below -1.7 bits, so
    # pairs at >= GATE_SAFE bits are accepted without evaluation
    # (module constant; _candidate_walk shares it).
    valid = np.ones((Q, H), bool)
    reported = pre - BIAS_FLOOR_BITS
    size_arr = np.array([ens.cores[i].nseq for i in indices], np.float64)
    adj = pre + np.log2(size_arr)[None, :]
    if have_native:
        from .native import _domaindef
        from .hmm.profile import configure as _configure
        TOPT = min(H, max(18, int(Configs.num_hmms) + 8))
        NEAR = min(H, int(Configs.num_hmms) + 4)
        t0 = time.time()
        # per-HMM batches of this HMM's candidate pairs. Queries whose
        # NEAR top candidates are all above GATE_SAFE cannot lose a
        # list slot to the gate, so only NEAR candidates need exact
        # evaluation; junk-heavy queries evaluate the full TOPT so that
        # promoted replacements also get exact scores.
        by_j: Dict[int, List[int]] = {}
        drop = None
        rows_dev = None
        if getattr(Configs, "full_search_results", False):
            # --full-search-results: evaluate the complete grid so the
            # persisted hmmsearch.results.* files match what the
            # reference's hmmsearch runs would contain.
            if not native_prescore:
                # device gate prefilter: the batched flank-row scans
                # classify every pair on the device; no-region
                # pairs (the bulk of a full grid) skip native domain
                # definition entirely, and the kept rows let the
                # native engine evaluate survivors without recomputing
                # the full-sequence F+B (hmm/flank_device.py +
                # native evaluate_targets_rows)
                from .hmm.flank_device import prefilter_grid
                t0p = time.time()
                dec, rows_dev = prefilter_grid(banks, codes, lens,
                                               col_of, H,
                                               return_rows=True)
                drop = dec < 0
                Configs.runtime(
                    "  scoring: device gate prefilter dropped %d/%d "
                    "pairs (s): %f" % (int(drop.sum()), Q * H,
                                       time.time() - t0p))
            for j in range(H):
                by_j[j] = [q for q in owned
                           if drop is None or not drop[q, j]]
        else:
            for q in owned:
                top = np.argsort(-adj[q], kind="stable")[:TOPT]
                depth = (NEAR
                         if np.all(pre[q, top[:NEAR]] >= GATE_SAFE)
                         else TOPT)
                for j in top[:depth]:
                    by_j.setdefault(int(j), []).append(q)
        n_pairs = 0
        gate_ok = np.ones((Q, H), bool)
        evaluated = np.zeros((Q, H), bool)
        nthreads = max(1, min(8, Configs.num_cpus))
        from concurrent.futures import ThreadPoolExecutor
        from .hmm.profile import null1_score

        _flank_fn = None
        if not os.environ.get("WITCH_TPU_NO_SIMD"):
            _flank_fn = getattr(_domaindef, "flank_targets_simd", None)

        _gate_profile = bool(os.environ.get("WITCH_TPU_GATE_PROFILE"))

        # Exact-f32 reported-score overlay (native/stoch_f32.h): the
        # binary's own f32 SSE accumulation, applied to print-boundary-
        # adjacent pairs so the persisted/consumed 0.1-bit scores round
        # exactly as hmmsearch prints them (the reference consumes the
        # printed strings, algorithm.py:579-605). WITCH_TPU_EXACT_PRINTS:
        # "0" disables, "full" overlays every evaluated pair.
        from .hmm.gate_device import near_print_boundary as _near_print
        _x32 = getattr(_domaindef, "exact_scores32", None)
        _mode32 = os.environ.get("WITCH_TPU_EXACT_PRINTS", "")
        band32: Dict[int, set] = {}
        band_of: Dict[tuple, float] = {}

        def eval_model(item):
            j, qlist = item
            t_b = time.time() if _gate_profile else 0.0
            prof = _configure(ens.cores[int(indices[j])], multihit=True)
            args = _native_args(prof)
            codes_list = [np.ascontiguousarray(qcodes[q], np.int32)
                          for q in qlist]
            if rows_dev is not None:
                # device-provided flank rows: skip the host F+B
                # (f64 Forward still runs for print-exact scores)
                return j, qlist, _domaindef.evaluate_targets_rows(
                    *args, codes_list, 42, 200, 1, 1,
                    np.ascontiguousarray(rows_dev[0][qlist, j]),
                    np.ascontiguousarray(rows_dev[1][qlist, j]),
                    np.ascontiguousarray(rows_dev[2][qlist, j]), 1)
            if _flank_fn is not None:
                # AVX-512 lane-parallel flank rows replace the host
                # full-sequence F+B inside the engine, and the exact
                # f64 Forward for print-exact reported scores runs
                # lane-parallel too (forward_targets_exact, 8 lanes,
                # same recurrence/rescale semantics, <=2e-14 nats from
                # the scalar)
                _, moccr, ppbr, pper = _flank_fn(*args, codes_list, 1)
                fwd64 = np.asarray(_domaindef.forward_targets_exact(
                    *args, codes_list, 1))
                nreg, nenv, sbias, _fz, senv, sbsum, ldv = \
                    _domaindef.evaluate_targets_rows(
                        *args, codes_list, 42, 200, 1, 0,
                        moccr, ppbr, pper, 1)
                if _gate_profile:
                    print("gate-batch j=%d M=%d n=%d %.3fs"
                          % (j, prof.msc.shape[0], len(qlist),
                             time.time() - t_b), flush=True)
                return j, qlist, (nreg, nenv, sbias, fwd64, senv,
                                  sbsum, ldv)
            return j, qlist, _domaindef.evaluate_targets(
                *args, codes_list, 42, 200, 1, 1)

        def consume(j, qlist, out, t):
            """Fold one evaluated pair into reported/gate_ok; returns
            (reported bits, guard_eps) — guard_eps is the print-guard
            band for the device path: wide (3e-3 bits) when the
            sum-score substitution was decisive or within noise of
            being so (its sbsum accumulation carries the largest f32
            error), narrow (3e-4) for the plain seqbias path whose f32
            error is ~1e-4 bits."""
            nreg, nenv, sbias, fwdn, senv, sbsum, ld = out
            q = qlist[t]
            # f64-exact reported score: the f32 pre-score is a
            # ranker; near 0.05-bit print boundaries its error can
            # flip the rounding. The exact value also replaces the
            # pre-score, so the candidate walk sees the same numbers
            # whichever engine pre-scored.
            Lq = len(qcodes[q])
            null1 = null1_score(Lq)
            pre[q, j] = (fwdn[t] - null1) / np.log(2.0)
            seq = (fwdn[t] - null1 - sbias[t]) / np.log(2.0)
            eps = 3e-4
            if ld[t] > 0:
                # p7_pipeline.c "reconstruction score" substitution:
                # sum of qualifying envelope scores with its own
                # null2, replacing the Forward score when larger
                sum_nats = senv[t] + (Lq - ld[t]) \
                    * np.log(Lq / (Lq + 3.0))
                bias2 = np.logaddexp(
                    0.0, np.log(1.0 / 256.0) + sbsum[t])
                sumsc = (sum_nats - null1 - bias2) / np.log(2.0)
                if abs(sumsc - seq) < 3e-3:
                    eps = float("inf")     # decision itself in noise
                if sumsc > seq:
                    seq = sumsc
                    eps = 3e-3
            reported[q, j] = seq
            gate_ok[q, j] = bool(nreg[t] > 0 and nenv[t] > 0)
            evaluated[q, j] = True
            if _x32 is not None and _mode32 != "0":
                # exact-f32 print overlay candidates: pairs whose f64
                # score sits close enough to a 0.1-bit print boundary
                # that the binary's f32 accumulation could round the
                # other way. Measured |f32 - f64| over 1,440 grid pairs:
                # p90 5.8e-4, p99 1.8e-3, max 5.5e-3 (the tail scales
                # with target length / rescale count), sum-substituted
                # pairs ~1e-5 — hence an L-scaled band.
                # Residual-risk envelope: the band is EMPIRICAL, not a
                # bound — for Lq < ~1200 the L-scaled term sits below
                # the measured p100 (5.5e-3), so a boundary pair
                # outside the band on new data would keep its f64
                # print. The overlay loop below measures |f32-f64| on
                # every re-evaluated pair and warns when the band no
                # longer covers the observed deltas
                # (WITCH_TPU_EXACT_PRINTS=full is the exhaustive
                # escape hatch).
                band = max(2e-3, 4.5e-6 * Lq)
                if _mode32 == "full" or eps == float("inf") \
                        or _near_print(seq, band):
                    band32.setdefault(j, set()).add(q)
                    band_of[(q, j)] = band
            return seq, eps

        # Device gate: the per-envelope null2 expectations (the stage's
        # dominant host cost) run as batched device scans; regions,
        # trace ensembles and the exact f64 Forward stay host. Print
        # exactness is preserved by re-evaluating boundary-adjacent
        # pairs on the host engine (hmm/gate_device.py).
        use_dev_gate = (
            use_device and DEVICE_GATE and rows_dev is None
            and _flank_fn is not None and not getattr(Configs, "full_search_results", False))
        if use_dev_gate:
            from .hmm.gate_device import (evaluate_gate_device,
                                          near_print_boundary)
            items = sorted(by_j.items())

            def run_dev_gate():
                allargs = {}
                flank_rows = {}
                fwd64_by = {}

                def prep_model(item):
                    j, qlist = item
                    prof = _configure(ens.cores[int(indices[j])],
                                      multihit=True)
                    args = _native_args(prof)
                    codes_list = [
                        np.ascontiguousarray(qcodes[q], np.int32)
                        for q in qlist]
                    _, mo, pb, pe = _flank_fn(*args, codes_list, 1)
                    return j, args, (mo, pb, pe), codes_list

                codes_by = {}
                with ThreadPoolExecutor(max_workers=nthreads) as ex:
                    for j, args, rows3, cl in ex.map(prep_model, items):
                        allargs[j] = args
                        flank_rows[j] = rows3
                        codes_by[j] = cl
                t_prep = time.time()

                # The exact f64 Forward (the reported-score column) is
                # only consumed AFTER the gate returns, so it overlaps
                # the device null2 window instead of serializing inside
                # prep.
                import threading as _thr
                f64_exc = []

                def run_f64():
                    try:
                        def one(item):
                            j, _ = item
                            return j, np.asarray(
                                _domaindef.forward_targets_exact(
                                    *allargs[j], codes_by[j], 1))
                        with ThreadPoolExecutor(
                                max_workers=nthreads) as ex:
                            for j, f64 in ex.map(one, items):
                                fwd64_by[j] = f64
                    except BaseException as e:   # noqa: BLE001
                        f64_exc.append(e)

                f64_thread = _thr.Thread(target=run_f64, daemon=True)
                f64_thread.start()
                bankloc_of_col = {}
                for bi, b in enumerate(banks):
                    for r, idx in enumerate(b.hmm_indices):
                        bankloc_of_col[col_of[int(idx)]] = (bi, r)
                results, stats = evaluate_gate_device(
                    banks, bankloc_of_col, allargs, qcodes, by_j,
                    flank_rows, nthreads=nthreads)
                f64_thread.join()
                if f64_exc:
                    raise f64_exc[0]
                return results, stats, fwd64_by, t_prep

            results, stats, fwd64_by, t_prep = run_dev_gate()
            pending: Dict[int, List[int]] = {}
            for j, qlist in items:
                n_pairs += len(qlist)
                out = list(results[j])
                out[3] = fwd64_by[j]
                hmulti = stats["multi_flags"][j]
                for t in range(len(qlist)):
                    seq, eps = consume(j, qlist, out, t)
                    if not hmulti[t] and (
                            eps == float("inf")
                            or near_print_boundary(seq, eps)):
                        pending.setdefault(j, []).append(t)
            n_pend = sum(len(v) for v in pending.values())
            for j, plist in pending.items():
                stats["reeval"](j, plist)
                out = list(results[j])
                out[3] = fwd64_by[j]
                for t in plist:
                    consume(j, by_j[j], out, t)
            Configs.runtime(
                "  scoring: device gate %d pairs (%d env on device, "
                "%d multidomain host, %d margin + %d boundary "
                "re-evals) prep %.2fs device %.2fs multi %.2fs "
                "total (s): %f"
                % (n_pairs, stats["entries"], stats["multi"],
                   stats["guard_margin"], n_pend, t_prep - t0,
                   stats["t_device"], stats["t_multi"],
                   time.time() - t0))
        else:
            # parallelize across models (the engine releases the GIL);
            # each model's batch runs single-threaded inside
            with ThreadPoolExecutor(max_workers=nthreads) as ex:
                for j, qlist, out in ex.map(eval_model,
                                            sorted(by_j.items())):
                    n_pairs += len(qlist)
                    for t in range(len(qlist)):
                        consume(j, qlist, out, t)
            Configs.runtime("  scoring: native domaindef %d pairs (s): %f"
                            % (n_pairs, time.time() - t0))
        if band32:
            t0x = time.time()

            def x32_model(item):
                j, qset = item
                qlist = sorted(qset)
                prof = _configure(ens.cores[int(indices[j])],
                                  multihit=True)
                xargs = _native_args(prof)
                cl = [np.ascontiguousarray(qcodes[q], np.int32)
                      for q in qlist]
                okx, seqx, _prex = _x32(*xargs, cl, 1)
                return j, qlist, okx, seqx

            n32 = ok32 = 0
            band_cover = 0.0       # max observed |f32-f64| / band
            with ThreadPoolExecutor(max_workers=nthreads) as ex:
                for j, qlist, okx, seqx in ex.map(
                        x32_model, sorted(band32.items())):
                    for t, q in enumerate(qlist):
                        n32 += 1
                        if okx[t]:
                            ok32 += 1
                            b = band_of.get((q, j))
                            if b:
                                d = abs(float(seqx[t]) - reported[q, j])
                                band_cover = max(band_cover, d / b)
                            reported[q, j] = float(seqx[t])
            Configs.runtime(
                "  scoring: exact-f32 print overlay %d/%d pairs "
                "(band cover %.2f) (s): %f"
                % (ok32, n32, band_cover, time.time() - t0x))
            if band_cover >= 1.0 and _mode32 != "full":
                Configs.warning(
                    "exact-f32 overlay: observed |f32-f64| delta "
                    "(%.1fx band) exceeds the empirical candidate band "
                    "on this data — out-of-band pairs may keep f64 "
                    "prints; rerun with WITCH_TPU_EXACT_PRINTS=full "
                    "for guaranteed print-exactness" % band_cover)
        # walk each query's candidates in weight-rank order; drop gated
        # pairs until num_hmms survivors are found. With
        # --full-search-results every pair was evaluated, so valid IS
        # the complete reported set (exactly what the reference's
        # hmmsearch output files would contain).
        if getattr(Configs, "full_search_results", False):
            valid = gate_ok.copy()
            if drop is not None:
                valid[drop] = False
            reported = np.round(reported, 1)
            return reported, valid, indices, tau
        valid = _candidate_walk(reported, valid, pre, evaluated,
                                gate_ok, size_arr, owned, TOPT)
    else:
        Configs.warning("native domaindef engine not built; using the "
                        "device null2 approximation")
        from .hmm.null2 import seq_bias_batch
        TOPT = min(H, max(18, int(Configs.num_hmms) + 8))
        pairs = []
        locs = []
        for q in owned:
            top = np.argsort(-adj[q], kind="stable")[:TOPT]
            for j in top:
                pairs.append((int(indices[j]), qcodes[q]))
                locs.append((q, j))
        if pairs:
            t0 = time.time()
            bias = seq_bias_batch(banks, pairs,
                                  chunk=32 * max(1, Configs.chunksize))
            Configs.runtime("  scoring: null2 bias %d pairs (s): %f"
                            % (len(pairs), time.time() - t0))
            for (q, j), bb in zip(locs, bias):
                reported[q, j] = pre[q, j] - bb
    reported = np.round(reported, 1)
    return reported, valid, indices, tau


def rank_and_weight(scores: np.ndarray, valid: np.ndarray,
                    indices: List[int], sizes: Dict[int, int],
                    qnames: List[str]) -> Dict[str, tuple]:
    """Ranked bitscores -> per-query weight tuples (reference
    rankBitscores + writeWeights)."""
    out = {}
    size_arr = np.array([sizes[i] for i in indices], dtype=np.float64)
    for q, name in enumerate(qnames):
        v = np.flatnonzero(valid[q])
        if v.size == 0:
            continue
        order = v[np.argsort(-scores[q, v], kind="stable")]
        idxs = [indices[j] for j in order]
        if Configs.use_weight:
            w = calculate_weights(
                idxs, scores[q, order], size_arr[order], Configs.num_hmms)
            adj = Configs.weight_adjust
            if adj != "none" and w:
                vals = np.array([x for _, x in w], np.float64)
                den = vals.sum() if adj == "normalize" else vals.max()
                if den > 0:
                    w = tuple((i, float(x / den))
                              for (i, _), x in zip(w, vals))
            out[name] = w
        else:
            k = min(Configs.num_hmms, len(order))
            out[name] = tuple((idxs[t], float(scores[q, order[t]]))
                              for t in range(k))
    return out


def align_queries(ens: Ensemble, qnames, qseqs, qcodes,
                  weights: Dict[str, tuple], backbone_length: int,
                  checkpoint_path: Optional[str] = None,
                  done: Optional[Dict[str, str]] = None,
                  n_workers: int = 1, backend: str = "auto"):
    """Per-query adaptive alignment + merge (reference alignSubQueriesNew).

    Returns (rows list[(name, row)], ignored names).
    """
    from .aligner import align_all_queries

    def checkpoint_cb(qname, row):
        if checkpoint_path:
            with gzip.open(checkpoint_path, "ab") as f:
                f.write("{}\t{}\n".format(qname, row).encode("utf-8"))

    return align_all_queries(ens, qnames, qseqs, qcodes, weights,
                             backbone_length,
                             use_weight=Configs.use_weight,
                             backend=backend, n_workers=n_workers,
                             done=done, checkpoint_cb=checkpoint_cb,
                             mode=Configs.mode)


def read_checkpoint(path: str) -> Dict[str, str]:
    out = {}
    if os.path.exists(path) and os.stat(path).st_size > 0:
        with gzip.open(path, "rb") as f:
            for line in f.read().decode("utf-8").split("\n"):
                if not line:
                    continue
                taxon = "\t".join(line.split("\t")[:-1])
                out[taxon] = line.split("\t")[-1]
    return out


def main_alignment_process(args=None):
    t_start = time.time()
    molecule = Configs.molecule
    if molecule is None:
        src = (Configs.backbone_path or Configs.query_path
               or Configs.input_path)
        molecule = infer_datatype(read_fasta(src, remove_gaps=True))
        Configs.log("Inferred molecule type: {}".format(molecule))
    alphabet = ALPHABETS[molecule]

    if not Configs.hmmdir:
        Configs.hmmdir = os.path.join(Configs.outdir, "tree_decomp", "root")

    if not (Configs.backbone_path and os.path.exists(Configs.backbone_path)):
        # scenario A/B: split input into backbone/queries, align the
        # backbone, estimate the tree (reference BackboneJob,
        # witch_msa/gcmm/backbone.py:17-341)
        assert Configs.input_path and os.path.exists(Configs.input_path), \
            "need -i (unaligned input) or -b (backbone alignment)"
        from .backbone import BackboneJob
        s = time.time()
        job = BackboneJob(Configs.input_path,
                          os.path.join(Configs.outdir, "backbone"),
                          molecule=molecule,
                          backbone_size=Configs.backbone_size,
                          selection_strategy=Configs.selection_strategy,
                          method=Configs.backbone_method,
                          log=Configs.log)
        bb_path, q_path, tree_path = job.run()
        Configs.backbone_path = bb_path
        if not Configs.query_path:
            Configs.query_path = q_path
        if not Configs.backbone_tree_path:
            Configs.backbone_tree_path = tree_path
        Configs.runtime("Time for backbone job (s): %f" % (time.time() - s))
    assert Configs.query_path and os.path.exists(Configs.query_path), \
        "query sequences missing"

    backbone = PackedAlignment.from_fasta(Configs.backbone_path,
                                          molecule=molecule)
    backbone_length = backbone.n_cols

    s = time.time()
    art_thread = None
    have_dir = os.path.isdir(Configs.hmmdir) and any(
        d.startswith("A_0_") for d in os.listdir(Configs.hmmdir))
    if have_dir:
        Configs.log("Found existing HMM directory: %s" % Configs.hmmdir)
        ens = read_ensemble_dir(Configs.hmmdir, backbone, molecule)
    else:
        if not (Configs.backbone_tree_path and
                os.path.exists(Configs.backbone_tree_path)):
            # scenario C: estimate the backbone tree (reference runs
            # FastTree2 here; we use device distances + NJ + Fitch NNI
            # + HKY+Gamma ML refinement with leaf-SPR)
            from .tree_estimate import estimate_tree
            tree_dir = os.path.join(Configs.outdir, "tree_decomp")
            os.makedirs(tree_dir, exist_ok=True)
            tree_path = os.path.join(tree_dir, "backbone.est.tre")
            s2 = time.time()
            estimate_tree(backbone, tree_path, ml=True, log=Configs.log)
            Configs.runtime("Time to estimate backbone tree (s): %f"
                            % (time.time() - s2))
            Configs.log("Estimated backbone tree (NJ): %s" % tree_path)
            Configs.backbone_tree_path = tree_path
        ens = build_ensemble(backbone, Configs.backbone_tree_path,
                             Configs.alignment_size,
                             Configs.alignment_upper_bound,
                             molecule,
                             n_workers=min(Configs.num_cpus,
                                           Configs.max_concurrent_jobs))
        if Configs.keep_decomposition:
            # artifact writes (A_0_* dirs) overlap the scoring stage:
            # nothing reads them back in this run (the resume ladder
            # only consults a dir that existed at startup), and the
            # device-bound bank upload/score window leaves the host
            # mostly idle. Joined before hmmsearch-results persistence
            # (same dirs) and before the pipeline returns.
            import threading as _thr
            Configs._art_gate_event = _thr.Event()

            def _write_art():
                # hold until bank quantization is done (compute_scores
                # sets the event) so the writer rides the device-wait
                # window instead of contending for cores here
                Configs._art_gate_event.wait(timeout=60.0)
                write_decomposition(ens, Configs.hmmdir)

            art_thread = _thr.Thread(target=_write_art, daemon=True)
            art_thread.start()
    Configs.runtime("Time to obtain eHMM ensemble (s): %f"
                    % (time.time() - s))
    Configs.log("Ensemble of %d HMMs" % len(ens.cores))

    # uppercased working backbone
    tmp_bb_dir = os.path.join(Configs.outdir, "tree_decomp", "backbone")
    os.makedirs(tmp_bb_dir, exist_ok=True)
    tmp_backbone_path = os.path.join(tmp_bb_dir, "backbone.aln.fasta")
    backbone.write(tmp_backbone_path)

    # queries
    qnames, qseqs, qcodes, renamed = _encode_queries(Configs.query_path,
                                                     alphabet)
    Configs.log("Loaded %d queries" % len(qnames))

    # multi-host query sharding (parallel/dist.py): this host gates and
    # aligns only its owned contiguous query block; aligned rows are
    # gathered for the merge. shard/n_shards come from jax process
    # index/count (real multi-host) or WITCH_TPU_SHARD (emulation).
    from .parallel.dist import gather_rows, process_shard, shard_indices
    shard, n_shards = process_shard()
    q_owned = None
    if n_shards > 1:
        q_owned = shard_indices(len(qnames), shard, n_shards)
        Configs.log("Query shard %d/%d: owns %d/%d queries "
                    "[%s..%s)" % (shard, n_shards, len(q_owned),
                                  len(qnames),
                                  q_owned[0] if len(q_owned) else "-",
                                  q_owned[-1] + 1 if len(q_owned) else "-"))

    # weights (reuse weights.txt, then persisted hmmsearch results, then
    # score on device — the reference's resume ladder: weights.txt
    # (weighting.py:184-194) and -p search-result reuse
    # (gcmm.py:120-169 + loader.readHMMSearch))
    weight_path = os.path.join(Configs.outdir, "weights.txt")
    if os.path.exists(weight_path):
        Configs.log("Found existing weights: %s" % weight_path)
        weights = read_weights(weight_path)
    else:
        s = time.time()
        scores = valid = None
        if have_dir:
            from .ensemble import read_search_results
            search = read_search_results(Configs.hmmdir)
            if search and set(search) == set(ens.indices):
                Configs.log("Reusing %d hmmsearch result files from %s"
                            % (len(search), Configs.hmmdir))
                indices = ens.indices
                name_to_q = {n: q for q, n in enumerate(qnames)}
                Q, H = len(qnames), len(indices)
                scores = np.full((Q, H), -np.inf)
                valid = np.zeros((Q, H), bool)
                for j, idx in enumerate(indices):
                    for taxon, (_, bits) in search[idx].items():
                        q = name_to_q.get(taxon)
                        if q is not None:
                            scores[q, j] = bits
                            valid[q, j] = True
                Configs.runtime("Time to load hmmsearch results (s): %f"
                                % (time.time() - s))
        if scores is None:
            scores, valid, indices, tau = compute_scores(
                ens, qcodes, q_owned=q_owned)
            Configs.runtime("Time for all-vs-all Forward scoring (s): %f"
                            % (time.time() - s))
            if art_thread is not None:
                art_thread.join()
                art_thread = None
            if Configs.keep_decomposition and os.path.isdir(Configs.hmmdir) \
                    and n_shards == 1:
                s2 = time.time()
                for j, idx in enumerate(indices):
                    res = {qnames[q]: (0.0, float(scores[q, j]))
                           for q in np.flatnonzero(valid[:, j])}
                    write_search_results(Configs.hmmdir, int(idx), res)
                Configs.runtime("Time to persist hmmsearch results (s): %f"
                                % (time.time() - s2))
        s = time.time()
        if n_shards > 1:
            # weight only the owned shard (rows outside it were not
            # gate-evaluated on this host)
            weights = rank_and_weight(scores[q_owned], valid[q_owned],
                                      indices, ens.sizes(),
                                      [qnames[q] for q in q_owned])
        else:
            weights = rank_and_weight(scores, valid, indices, ens.sizes(),
                                      qnames)
        Configs.runtime("Time to obtain weights (s): %f" % (time.time() - s))
        if Configs.save_weight and n_shards == 1:
            write_weights(weights, weight_path)

    # per-query alignment (shard-local when n_shards > 1: non-owned
    # queries have no weights on this host and must not be aligned or
    # counted as ignored here)
    ckpt_name = ("checkpoint_alignments.txt.gz" if n_shards == 1 else
                 "checkpoint_alignments.shard%d_of_%d.txt.gz"
                 % (shard, n_shards))
    checkpoint_path = os.path.join(Configs.outdir, ckpt_name)
    done = read_checkpoint(checkpoint_path)
    if q_owned is None:
        a_names, a_seqs, a_codes = qnames, qseqs, qcodes
    else:
        a_names = [qnames[q] for q in q_owned]
        a_seqs = [qseqs[q] for q in q_owned]
        a_codes = [qcodes[q] for q in q_owned]
    s = time.time()
    rows, ignored = align_queries(ens, a_names, a_seqs, a_codes, weights,
                                  backbone_length,
                                  checkpoint_path=checkpoint_path,
                                  done=done,
                                  n_workers=min(Configs.num_cpus,
                                                Configs.max_concurrent_jobs))
    Configs.runtime("Time for per-query alignment (s): %f"
                    % (time.time() - s))

    if n_shards > 1:
        # gather every shard's aligned rows; exactly one host proceeds
        # to the merge (rows arrive in shard order = qnames order, so
        # the merged file is identical to the unsharded run's)
        s = time.time()
        gathered = gather_rows(rows, ignored, shard, n_shards,
                               os.path.join(Configs.outdir, "shards"))
        Configs.runtime("Time to gather shard rows (s): %f"
                        % (time.time() - s))
        if gathered is None:
            Configs.log("Shard %d/%d: rows staged; merge owned by "
                        "another host" % (shard, n_shards))
            if art_thread is not None:
                art_thread.join()
            Configs.runtime("Total runtime (s): %f"
                            % (time.time() - t_start))
            return None
        rows, ignored = gathered

    # merge + outputs (vectorized byte-matrix overlay; merger.py)
    s = time.time()
    from .io.fasta import write_fasta_bytes
    from .merger import merge_rows_bytes
    mnames, mmat, ins_mask = merge_rows_bytes(
        backbone.names, backbone.to_bytes_matrix(), rows,
        collapse_singletons=Configs.collapse_singletons)
    back = {v: k for k, v in renamed.items()}
    mnames = [back.get(n, n) for n in mnames]
    write_fasta_bytes(mnames, mmat, Configs.output_path)
    suffix = Configs.output_path.split(".")[-1]
    if suffix in ("fa", "fasta"):
        masked_path = (".".join(Configs.output_path.split(".")[:-1])
                       + ".masked." + suffix)
    else:
        masked_path = Configs.output_path + ".masked.fasta"
    write_fasta_bytes(mnames, mmat[:, ~ins_mask], masked_path)
    Configs.runtime("Time to merge all outputs (s): %f" % (time.time() - s))

    if ignored:
        ignored_path = os.path.join(Configs.outdir, "ignored_queries.fasta")
        seq_of = dict(zip(qnames, qseqs))
        with open(ignored_path, "w") as f:
            for n in ignored:
                f.write(">{}\n{}\n".format(back.get(n, n), seq_of[n]))
        Configs.log("Wrote %d ignored queries to %s"
                    % (len(ignored), ignored_path))

    if art_thread is not None:
        art_thread.join()
    clear_temp_files()
    Configs.runtime("Total runtime (s): %f" % (time.time() - t_start))
    Configs.log("WITCH-TPU finished; output: %s" % Configs.output_path)
    return Configs.output_path


def clear_temp_files():
    """Remove working artifacts after a successful run (the reference's
    clearTempFiles, witch_msa/gcmm/gcmm.py:39-69): the uppercased
    backbone copy always (unless --keeptemp), the whole tree_decomp
    tree when --keep-decomposition 0."""
    import shutil
    if Configs.keeptemp:
        return
    td = os.path.join(Configs.outdir, "tree_decomp")
    targets = [os.path.join(Configs.outdir, "shards")]
    if not Configs.keep_decomposition:
        targets.append(td)
    else:
        targets.append(os.path.join(td, "backbone"))
    for t in targets:
        if os.path.isdir(t):
            try:
                shutil.rmtree(t)
            except OSError as e:
                Configs.warning("temp cleanup failed for %s: %s" % (t, e))
