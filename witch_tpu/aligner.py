"""Per-query alignment stage: adaptive HMM selection -> posterior-OA
alignment -> weighted merge DP (the reference's alignSubQueriesNew flow,
witch_msa/gcmm/aligner.py:350-538).

Execution paths with identical results:
  * native: the f64 C++ posterior + OA engine (native/_domaindef),
    threaded across pairs — the production path
  * host: float64 numpy Forward/Backward per pair (validated against the
    hmmalign binary) — used for tests and small runs
  * device: batched odds-domain posterior decoding in JAX
    (witch_tpu.hmm.align.posterior_sparse_rows), OA fill/trace on host,
    used when the native engine is not built
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .ensemble import Ensemble
from .hmm.profile import Profile, configure
from .ops.merge_dp import align_query_row
from .weighting import adaptive_top_hmms


def select_pairs(qnames: Sequence[str], weights: Dict[str, tuple],
                 use_weight: bool = True):
    """Adaptive top-HMM selection per query -> list of (qname, [(idx, w)]).
    Queries without weights are returned in `ignored`."""
    selections = {}
    ignored = []
    for qname in qnames:
        w = weights.get(qname, tuple())
        if not w:
            ignored.append(qname)
            continue
        selections[qname] = adaptive_top_hmms(w, use_weight=use_weight)
    return selections, ignored


class HostAligner:
    """float64 numpy per-pair alignment (reference-exact)."""

    def __init__(self, ens: Ensemble):
        self.ens = ens
        self._profiles: Dict[int, Profile] = {}

    def profile(self, idx: int) -> Profile:
        if idx not in self._profiles:
            self._profiles[idx] = configure(self.ens.cores[idx],
                                            multihit=False)
        return self._profiles[idx]

    def aligned_columns(self, idx: int, codes: np.ndarray) -> np.ndarray:
        from .hmm.align_ref import aligned_columns
        return aligned_columns(self.profile(idx), codes)


class DeviceAligner:
    """Batched device posterior decoding + host OA traceback."""

    def __init__(self, ens: Ensemble, pair_chunk: int = 32):
        self.ens = ens
        self.pair_chunk = pair_chunk
        self._profiles: Dict[int, Profile] = {}
        self._banks = None
        self._bank_row: Dict[int, Tuple[int, int]] = {}

    def profile(self, idx: int) -> Profile:
        if idx not in self._profiles:
            self._profiles[idx] = configure(self.ens.cores[idx],
                                            multihit=False)
        return self._profiles[idx]

    def _ensure_banks(self, used: List[int]):
        from .hmm.bank import build_banks
        if self._banks is None:
            indices = sorted(used)
            cores = [self.ens.cores[i] for i in indices]
            self._banks = build_banks(cores, indices=indices,
                                      multihit=False, uniform=True)
            for bi, b in enumerate(self._banks):
                for r, idx in enumerate(b.hmm_indices):
                    self._bank_row[int(idx)] = (bi, r)

    def aligned_columns_batch(self, pairs: List[Tuple[int, np.ndarray]]
                              ) -> List[np.ndarray]:
        """pairs: (hmm_idx, query codes). Returns aligned columns list:
        the native host engine (f64, threaded) when built, else the
        device posteriors with host OA."""
        if not pairs:
            return []
        try:
            from .native import _domaindef  # noqa: F401
            return self._aligned_columns_native(pairs)
        except ImportError:
            pass
        return self._aligned_columns_device(pairs)

    def _aligned_columns_native(self, pairs: List[Tuple[int, np.ndarray]]
                                ) -> List[np.ndarray]:
        """Per-pair f64 unihit posterior (native/_domaindef) + native OA
        traceback, threaded across pairs."""
        import time as _time
        from concurrent.futures import ThreadPoolExecutor
        from .config import Configs
        from .native import _domaindef
        from .hmm.align_ref import oa_columns_from_pp

        t0 = _time.time()
        args_of: Dict[int, list] = {}

        def model_args(idx: int):
            if idx not in args_of:
                prof = self.profile(idx)
                args_of[idx] = [
                    np.ascontiguousarray(prof.msc, np.float64)] + [
                    np.ascontiguousarray(getattr(prof, a), np.float64)
                    for a in ("t_mm", "t_mi", "t_md", "t_im", "t_ii",
                              "t_dm", "t_dd", "bm")]
            return args_of[idx]

        for idx, _ in pairs:
            model_args(idx)
        Configs.runtime("  align: unihit profile build (s): %f"
                        % (_time.time() - t0))

        from .hmm.align_ref import _deltas_u8
        fused = getattr(_domaindef, "posterior_oa_pair", None)
        deltas_of: Dict[int, list] = {}

        def model_deltas(idx: int):
            if idx not in deltas_of:
                deltas_of[idx] = [np.ascontiguousarray(x)
                                  for x in _deltas_u8(self.profile(idx))]
            return deltas_of[idx]

        def one(pair):
            idx, codes = pair
            c = np.ascontiguousarray(codes, np.int32)
            if fused is not None:
                # fused posterior+OA: identical values, no numpy
                # round-trip of the [L,M] planes (memory-bound stage)
                return fused(*model_args(idx), c, len(c), 0,
                             *model_deltas(idx))[:len(c)]
            ppM, ppI, ppN, ppJ, ppC = _domaindef.posterior_pair(
                *model_args(idx), c, len(c), 0)
            return oa_columns_from_pp(
                self.profile(idx),
                dict(M=ppM, I=ppI, N=ppN, J=ppJ, C=ppC))[:len(c)]

        t1 = _time.time()
        from .config import Configs as _C
        workers = max(1, min(8, getattr(_C, "num_cpus", 4)))
        with ThreadPoolExecutor(max_workers=workers) as ex:
            out = list(ex.map(one, pairs))
        Configs.runtime(
            "  align: %d pairs native posterior+OA (s): %f"
            % (len(pairs), _time.time() - t1))
        return out

    def _aligned_columns_device(self, pairs: List[Tuple[int, np.ndarray]]
                                ) -> List[np.ndarray]:
        import jax.numpy as jnp
        from .hmm.align import (posterior_sparse_rows,
                                densify_sparse_pp)
        from .hmm.align_ref import oa_columns_from_pp
        import time as _time
        from .config import Configs
        from .hmm.null2 import _length_chunks
        t0 = _time.time()
        self._ensure_banks([i for i, _ in pairs])
        Configs.runtime("  align: unihit bank build (s): %f"
                        % (_time.time() - t0))
        t_dev = t_xfer = t_host = 0.0
        out: List[Optional[np.ndarray]] = [None] * len(pairs)
        # per bank: ship the bank to device once, select rows on device,
        # and process pairs in length-sorted chunks padded to <= 2
        # quantized widths (padding tracks fragment lengths, not the
        # global maximum)
        by_bucket: Dict[int, List[int]] = {}
        for p, (idx, codes) in enumerate(pairs):
            bi, _ = self._bank_row[idx]
            by_bucket.setdefault(bi, []).append(p)
        for bi, plist in by_bucket.items():
            b = self._banks[bi]
            Mp1 = b.em_odds.shape[1]
            args = tuple(jnp.asarray(a) for a in
                         (b.em_odds, b.t_mm, b.t_mi, b.t_md, b.t_im,
                          b.t_ii, b.t_dm, b.t_dd, b.bm))
            for chunk, width, P in _length_chunks(
                    plist, pairs, Mp1, chunk_max=self.pair_chunk * 4):
                rows = np.zeros(P, np.int32)
                rows[:len(chunk)] = [self._bank_row[pairs[p][0]][1]
                                     for p in chunk]
                codes = np.zeros((P, width), np.int32)
                lens = np.ones(P, np.int32)
                for t, p in enumerate(chunk):
                    c = pairs[p][1]
                    codes[t, :len(c)] = c
                    lens[t] = len(c)
                t1 = _time.time()
                vM, iM, vI, iI, ppN, ppJ, ppC = posterior_sparse_rows(
                    args, jnp.asarray(rows), jnp.asarray(codes),
                    jnp.asarray(lens), multihit=False)
                vM = np.asarray(vM)
                t2 = _time.time()
                iM = np.asarray(iM)
                vI = np.asarray(vI)
                iI = np.asarray(iI)
                ppN = np.asarray(ppN)
                ppJ = np.asarray(ppJ)
                ppC = np.asarray(ppC)
                t3 = _time.time()
                t_dev += t2 - t1
                t_xfer += t3 - t2
                t4 = _time.time()
                for t, p in enumerate(chunk):
                    idx = pairs[p][0]
                    qlen = int(lens[t])
                    prof = self.profile(idx)
                    M = prof.M
                    dM, dI = densify_sparse_pp(vM[t], iM[t], vI[t], iI[t],
                                               Mp1)
                    pp = dict(M=dM[:qlen + 1, :M + 1],
                              I=dI[:qlen + 1, :M + 1],
                              N=np.asarray(ppN[t][:qlen + 1],
                                           dtype=np.float64),
                              J=np.asarray(ppJ[t][:qlen + 1],
                                           dtype=np.float64),
                              C=np.asarray(ppC[t][:qlen + 1],
                                           dtype=np.float64))
                    out[p] = oa_columns_from_pp(prof, pp)[:qlen]
                t_host += _time.time() - t4
        Configs.runtime("  align: %d pairs device %.2fs transfer %.2fs "
                        "host-OA %.2fs" % (len(pairs), t_dev, t_xfer,
                                           t_host))
        return out  # type: ignore


def align_all_queries(ens: Ensemble, qnames, qseqs, qcodes,
                      weights: Dict[str, tuple], backbone_length: int,
                      use_weight: bool = True, backend: str = "auto",
                      n_workers: int = 1, done: Optional[Dict[str, str]] = None,
                      checkpoint_cb=None, mode: str = "witch-ng"):
    """Returns (rows [(name, row)], ignored names).

    mode='old-witch' merges with the GCM/MCL path (ops.gcm) instead of
    the witch-ng banded DP."""
    done = done or {}
    selections, ignored = select_pairs(qnames, weights, use_weight)

    rows: List[Tuple[str, str]] = []
    todo_names = []
    for qname in qnames:
        if qname in done:
            rows.append((qname, done[qname]))
        elif qname in selections:
            todo_names.append(qname)
    name_to_i = {n: i for i, n in enumerate(qnames)}

    if backend == "host":
        aligner = HostAligner(ens)
        cols_of = {}
        for qname in todo_names:
            qi = name_to_i[qname]
            for idx, w in selections[qname]:
                cols_of[(qname, idx)] = aligner.aligned_columns(
                    idx, qcodes[qi])
    else:
        from .config import Configs as _C
        aligner = DeviceAligner(
            ens, pair_chunk=32 * max(1, int(getattr(_C, "chunksize", 1))))
        pair_list = []
        keys = []
        for qname in todo_names:
            qi = name_to_i[qname]
            for idx, w in selections[qname]:
                pair_list.append((idx, qcodes[qi]))
                keys.append((qname, idx))
        cols = aligner.aligned_columns_batch(pair_list)
        cols_of = dict(zip(keys, cols))

    import time as _time
    from .config import Configs
    t_merge0 = _time.time()

    def _per_hmm(qname):
        return [(cols_of[(qname, idx)], ens.retained_columns[idx],
                 ens.nongaps_per_column[idx], float(w))
                for idx, w in selections[qname]]

    if mode == "old-witch":
        from .ops.gcm import gcm_align_query_row
        from .ops.merge_dp import sparse_edges
        # -s/--subset-size queries share one MCL clustering per batch
        # (the reference's multi-query GCM run); --timeout bounds each
        # query's GCM merge, falling back to the witch-ng DP exactly as
        # the reference re-queues timed-out GCM tasks in witch-ng mode
        # (witch_msa/gcmm/results_handler.py:167-180)
        s_size = max(1, int(getattr(Configs, "subset_size", 1)))
        cluster = getattr(Configs, "graphclustermethod", "mcl")
        if cluster in ("mlrmcl", "rg"):
            Configs.warning("graphclustermethod %s not built; using mcl"
                            % cluster)
            cluster = "mcl"
        if getattr(Configs, "graphtracemethod", "minclusters") != \
                "minclusters":
            Configs.log("graphtracemethod %s: all trace methods reduce "
                        "to the exact banded DP with two constraints"
                        % Configs.graphtracemethod)
        if getattr(Configs, "graphtraceoptimize", "false") == "true":
            Configs.log("graphtraceoptimize: trace is already optimal "
                        "for 2-constraint merges; optimization is an "
                        "identity")
        timeout = float(getattr(Configs, "timeout", 120) or 0)

        def merge_one(qname, siblings):
            qi = name_to_i[qname]
            ph = _per_hmm(qname)
            t0 = _time.time()
            row = gcm_align_query_row(
                qseqs[qi], backbone_length, ph,
                inflation=float(getattr(Configs, "inflation_factor", 4.0)),
                clustermethod=cluster,
                extra_edges=[sparse_edges(_per_hmm(s))
                             for s in siblings])
            if timeout and _time.time() - t0 > timeout:
                Configs.warning(
                    "query %s GCM merge exceeded --timeout %.0fs; "
                    "re-running in witch-ng mode" % (qname, timeout))
                row = align_query_row(qseqs[qi], backbone_length, ph)
            return row

        for s0 in range(0, len(todo_names), s_size):
            batch = todo_names[s0:s0 + s_size]
            for qname in batch:
                row = merge_one(qname, [s for s in batch if s != qname])
                if not row:
                    ignored.append(qname)
                    continue
                rows.append((qname, row))
                if checkpoint_cb:
                    checkpoint_cb(qname, row)
    else:
        # the native merge DP releases the GIL; thread across queries
        # (ex.map preserves order, so rows/checkpoint order — and hence
        # the output files — are identical to the serial loop)
        from concurrent.futures import ThreadPoolExecutor
        n_thr = max(1, min(8, int(getattr(Configs, "num_cpus", 4))))

        def _merge_one(qname):
            return align_query_row(qseqs[name_to_i[qname]],
                                   backbone_length, _per_hmm(qname))

        with ThreadPoolExecutor(max_workers=n_thr) as ex:
            for qname, row in zip(todo_names,
                                  ex.map(_merge_one, todo_names)):
                if not row:
                    ignored.append(qname)
                    continue
                rows.append((qname, row))
                if checkpoint_cb:
                    checkpoint_cb(qname, row)
    Configs.runtime("  align: merge DP for %d queries (s): %f"
                    % (len(todo_names), _time.time() - t_merge0))
    return rows, ignored
