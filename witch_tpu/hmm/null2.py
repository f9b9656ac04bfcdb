"""Batched null2 bias correction on device, for hosts without the
native domain-definition engine.

Computes hmmsearch's biased-composition seqbias for a set of
(query, HMM) pairs:

  device: multihit posterior -> flank posteriors ppN/ppJ/ppC [P, L+1]
  host:   mocc -> region detection -> mocc-trimmed envelopes
  device: each envelope rescored in isolation with its null2 usage
          expectations (hmm/gate_device.py:null2_envelopes, the device
          gate's own null2) -> seqbias per pair

Regions holding several domains are not split by trace ensembles as the
native engine does; their trimmed span is rescored as one envelope
(residual deltas quantified in docs/CALIBRATION.md).

The flank pass keeps each bank on the device once per call (row
selection on device) and runs pairs in length-sorted chunks padded to
at most two quantized L shapes.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .align import _posterior_one
from .domaindef import find_regions
from .bank import ProfileBank
from .gate_device import envelope_n2sums, null2_envelopes

TRIM_THETA = 0.5
OMEGA = 1.0 / 256.0


@jax.jit
def _flank_pairs(bank_args, rows, codes, qlens):
    """bank_args: 9 arrays with leading H axis (device-resident);
    rows [P] selects the model per pair (gathered on device)."""
    def one(eo, a, b, c, d, e, f, g, h, cd, ql):
        ppM, ppI, ppN, ppJ, ppC, ppB, ppE = _posterior_one(
            eo, a, b, c, d, e, f, g, h, cd, ql, True)
        return ppN + ppJ + ppC, ppB, ppE
    sel = tuple(a[rows] for a in bank_args)
    return jax.vmap(one, in_axes=(0,) * 9 + (0, 0))(
        *sel, codes, qlens)


def _length_chunks(plist, pairs, Mp1, chunk_max=256, max_shapes=2,
                   elem_budget=150_000_000):
    """Length-sorted chunks of pair indices with <= max_shapes padded
    widths (64-quantized, mirroring the scoring path's grouping) and a
    per-width chunk size bounded so the posterior scan's [P, L, Mp]
    row storage stays within HBM budget."""
    order = sorted(plist, key=lambda p: len(pairs[p][1]))
    # two quantized widths over this bank's pairs
    widths_all = sorted({max(64, -(-len(pairs[p][1]) // 64) * 64)
                         for p in order})
    if len(widths_all) > max_shapes:
        keep = {widths_all[-1]}
        step = len(widths_all) / max_shapes
        for k in range(1, max_shapes):
            keep.add(widths_all[min(len(widths_all) - 1,
                                    int(k * step) - 1)])
        widths = sorted(keep)
    else:
        widths = widths_all

    def width_of(p):
        w = max(64, -(-len(pairs[p][1]) // 64) * 64)
        return min(w2 for w2 in widths if w2 >= w)

    out = []
    by_w: Dict[int, List[int]] = {}
    for p in order:
        by_w.setdefault(width_of(p), []).append(p)
    for w, group in sorted(by_w.items()):
        P = max(32, min(chunk_max,
                        elem_budget // (w * Mp1) // 32 * 32))
        for s in range(0, len(group), P):
            out.append((group[s:s + P], w, P))
    return out


def seq_bias_batch(banks: List[ProfileBank],
                   pairs: List[Tuple[int, np.ndarray]],
                   chunk: int = 256,
                   collect_posteriors: Optional[dict] = None) -> np.ndarray:
    """seqbias (bits) per (hmm_idx, query codes) pair, batched on device.

    banks: the multihit score banks covering all hmm indices in pairs.
    collect_posteriors: optional dict filled with
    pair_index -> (mocc, ppB, ppE) host rows ([L+1] each) so the caller
    can run the reporting gate without a second device pass.
    """
    row_of = {}
    for bi, b in enumerate(banks):
        for r, idx in enumerate(b.hmm_indices):
            row_of[int(idx)] = (bi, r)
    out = np.zeros(len(pairs))
    # group pairs by bank
    by_bank: Dict[int, List[int]] = {}
    for p, (idx, _) in enumerate(pairs):
        by_bank.setdefault(row_of[idx][0], []).append(p)
    for bi, plist in by_bank.items():
        b = banks[bi]
        args = tuple(jnp.asarray(a) for a in (
            b.em_odds, b.t_mm, b.t_mi, b.t_md, b.t_im, b.t_ii,
            b.t_dm, b.t_dd, b.bm))
        Mp1 = b.em_odds.shape[1]
        for sel, width, P in _length_chunks(plist, pairs, Mp1,
                                            chunk_max=chunk):
            rows = np.zeros(P, np.int32)
            rows[:len(sel)] = [row_of[pairs[p][0]][1] for p in sel]
            cm = np.zeros((P, width), np.int32)
            lens = np.ones(P, np.int32)
            for t, p in enumerate(sel):
                c = pairs[p][1]
                cm[t, :len(c)] = c
                lens[t] = len(c)
            rj = jnp.asarray(rows)
            cmj = jnp.asarray(cm)
            lj = jnp.asarray(lens)
            flank_j, ppB_j, ppE_j = _flank_pairs(args, rj, cmj, lj)
            flank = np.asarray(flank_j)
            ppB_h = np.asarray(ppB_j)
            ppE_h = np.asarray(ppE_j)
            entries = []
            owner = []
            for t, p in enumerate(sel):
                L = len(pairs[p][1])
                mocc = 1.0 - flank[t, :L + 1]
                mocc[0] = 0.0
                if collect_posteriors is not None:
                    collect_posteriors[p] = (mocc.copy(),
                                             ppB_h[t, :L + 1].copy(),
                                             ppE_h[t, :L + 1].copy())
                regions = find_regions(mocc, ppB_h[t, :L + 1],
                                       ppE_h[t, :L + 1])
                for (a, bnd) in regions:
                    core = np.flatnonzero(mocc[a:bnd + 1] >= TRIM_THETA)
                    if core.size == 0:
                        continue
                    a2, b2 = a + int(core[0]), a + int(core[-1])
                    entries.append((int(rows[t]), np.ascontiguousarray(
                        pairs[p][1][a2 - 1:b2], np.int32), L))
                    owner.append(p)
            _, n2dot, useI, usetot = null2_envelopes(b, entries)
            n2sum, _ = envelope_n2sums(entries, n2dot, useI, usetot)
            total: Dict[int, float] = {}
            for p, v in zip(owner, n2sum):
                total[p] = total.get(p, 0.0) + float(v)
            # a pair without an envelope keeps seqbias 0, as in the
            # native engine's early return
            for p, v in total.items():
                out[p] = float(np.logaddexp(0.0, np.log(OMEGA) + v)
                               / np.log(2.0))
    return out
