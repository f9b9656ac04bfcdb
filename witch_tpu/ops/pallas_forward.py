"""Pallas Triton kernel: batched profile-HMM Forward pre-scores.

One program scores one HMM against a block of QB queries: the queries
lie across the lanes (one query per thread), and the program walks the
residues and, inside each residue, the model states in order. Walking
the states in order turns the delete chain
(D[k] = D[k-1] * tdd[k-1] + M[k-1] * tmd[k-1]) into a running value in
registers, so the kernel needs no lane shift and no scan. Only two
numbers per state and query cross from one residue row to the next:

    T[k] = M[k] * tmm[k] + I[k] * tim[k] + D[k] * tdm[k]   (feeds M[k+1])
    U[k] = M[k] * tmi[k] + I[k] * tii[k]                   (the next I[k])

They live in a per-program scratch block in device memory, which each
thread reads and overwrites in place for its own query, so no barrier
is needed. The states go in chunks of CK whose loads are all issued
before the chunk's first store, so one memory latency covers CK states
(one state at a time left the kernel latency-bound, slower than the
XLA scan). Rows are kept unscaled; each row's rescale factor (HMMER's
per-row scaling) is applied when the next row reads it. The state loop
stops at the model's own length M, so models padded into a wider bank
cost no padded states. Emission odds come from one indexed load per
query and state: exact, no matrix unit involved.

The recurrence is hmm/forward.py's in the same f32 arithmetic, summed
in another order; tests compare it with hmm/forward_ref.py (f64).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..hmm.bank import ladder_states

QB = 32                    # queries per program: one warp, one per lane
CK = 16                    # states per chunk of loads
SCALE_FLOOR = 1e-35
SCRATCH_BYTES = 1 << 30    # bound on one call's T/U scratch


def _forward_kernel(codes_ref, qlens_ref, nres_ref, em_ref, trans_ref,
                    mlen_ref, out_ref, scr_ref, *, K, CK):
    """Block refs: codes [1, L, QB] i32, qlens [1, QB] i32, nres [1] i32,
    em [1, Ms*K] f32 (state-major emission odds), trans [1, 8, Ms]
    (mm mi md im ii dm dd bm), mlen [1] i32, out [1, 1, QB] nats,
    scr [1, 1, 2, Ms, QB] (T and U rows). Ms >= M + CK, zero past M."""
    M = mlen_ref[0]
    nchunk = (M + CK - 1) // CK
    ql = qlens_ref[0, :]
    lf = ql.astype(jnp.float32)
    pmove = 3.0 / (lf + 3.0)
    ploop = 1.0 - pmove
    zero = jnp.zeros((QB,), jnp.float32)

    def clear(k, c):
        scr_ref[0, 0, 0, k, :] = zero
        scr_ref[0, 0, 1, k, :] = zero
        return c

    jax.lax.fori_loop(0, nchunk * CK + 1, clear, 0)

    def row(i, carry):
        N, B, J, C, logs, inv = carry
        x = codes_ref[0, i, :]

        def chunk(c, carry_c):
            t_prev, m_prev, d_prev, E, mx = carry_c
            k0 = 1 + c * CK
            # every load of the chunk is issued before its first store,
            # so one memory latency covers CK states
            ks = [k0 + j for j in range(CK)]
            t_old = [scr_ref[0, 0, 0, k, :] for k in ks]
            u_old = [scr_ref[0, 0, 1, k, :] for k in ks]
            e = [em_ref[0, k * K + x] for k in ks]
            tr = [[trans_ref[0, r, k] for r in range(8)] for k in ks]
            tmd_prev = trans_ref[0, 2, k0 - 1]
            tdd_prev = trans_ref[0, 6, k0 - 1]
            for j, k in enumerate(ks):
                tmm, tmi, tmd, tim, tii, tdm, tdd, bm = tr[j]
                m = (t_prev + B * bm) * e[j]
                d = d_prev * tdd_prev + m_prev * tmd_prev
                i_k = u_old[j] * inv
                scr_ref[0, 0, 0, k, :] = m * tmm + i_k * tim + d * tdm
                scr_ref[0, 0, 1, k, :] = m * tmi + i_k * tii
                t_prev = t_old[j] * inv
                m_prev, d_prev = m, d
                tmd_prev, tdd_prev = tmd, tdd
                E = E + m + d
                mx = jnp.maximum(mx, m)
            return t_prev, m_prev, d_prev, E, mx

        # node 0 is the virtual begin node: its M, I and D are zero
        _, _, _, E, mx = jax.lax.fori_loop(
            0, nchunk, chunk, (zero, zero, zero, zero, zero))
        Jn = J * ploop + E * 0.5
        Cn = C * ploop + E * 0.5
        Nn = N * ploop
        Bn = Nn * pmove + Jn * pmove
        scale = jnp.maximum(jnp.maximum(mx, Cn),
                            jnp.maximum(Nn, SCALE_FLOOR))
        inv_n = 1.0 / scale
        keep = i < ql
        return (jnp.where(keep, Nn * inv_n, N), jnp.where(keep, Bn * inv_n, B),
                jnp.where(keep, Jn * inv_n, J), jnp.where(keep, Cn * inv_n, C),
                jnp.where(keep, logs + jnp.log(scale), logs), inv_n)

    init = (zero + 1.0, pmove, zero, zero, zero, zero + 1.0)
    N, B, J, C, logs, _ = jax.lax.fori_loop(0, nres_ref[0], row, init)
    out_ref[0, 0, :] = jnp.log(C * pmove) + logs


@functools.partial(jax.jit, static_argnames=("interpret",))
def forward_nats_blocks(codesT, qlens, nres, em, trans, mlen,
                        interpret=False):
    """Forward nats [H, NQB, QB] for H models x NQB query blocks.

    codesT [NQB, L, QB] i32 (residues down, queries across), qlens
    [NQB, QB] i32, nres [NQB] i32 (rows to run per block), em
    [H, Ms, K] f32 emission odds, trans [H, 8, Ms] f32, mlen [H] i32,
    with Ms >= max(mlen) + CK and both tables zero past each model's M.
    Traceable, so it also runs under shard_map."""
    H, Ms, K = em.shape
    NQB, L, _ = codesT.shape
    out, _ = pl.pallas_call(
        functools.partial(_forward_kernel, K=K, CK=CK),
        grid=(H, NQB),
        in_specs=[
            pl.BlockSpec((1, L, QB), lambda h, b: (b, 0, 0)),
            pl.BlockSpec((1, QB), lambda h, b: (b, 0)),
            pl.BlockSpec((1,), lambda h, b: (b,)),
            pl.BlockSpec((1, Ms * K), lambda h, b: (h, 0)),
            pl.BlockSpec((1, 8, Ms), lambda h, b: (h, 0, 0)),
            pl.BlockSpec((1,), lambda h, b: (h,)),
        ],
        out_specs=[
            pl.BlockSpec((1, 1, QB), lambda h, b: (h, b, 0)),
            pl.BlockSpec((1, 1, 2, Ms, QB), lambda h, b: (h, b, 0, 0, 0)),
        ],
        out_shape=[
            jax.ShapeDtypeStruct((H, NQB, QB), jnp.float32),
            jax.ShapeDtypeStruct((H, NQB, 2, Ms, QB), jnp.float32),
        ],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=1, num_stages=1),
        interpret=interpret,
        name="witch_forward_prescore",
    )(codesT, qlens, nres, em.reshape(H, Ms * K), trans, mlen)
    return out


def bank_kernel_arrays(bank):
    """(em [H, Ms, K], trans [H, 8, Ms], mlen [H]) for the kernel, the
    state axis zero-padded to the ladder (bank.ladder_states) plus CK, so
    a chunk never reads past it and the compiled shape does not follow
    the data's bucket width. The state loop stops at each model's M, so
    the padding costs scratch memory only."""
    H, Mp1, K = bank.em_odds.shape
    Ms = ladder_states(Mp1 - 1) + 1 + CK
    em = np.zeros((H, Ms, K), np.float32)
    em[:, :Mp1] = bank.em_odds
    trans = np.zeros((H, 8, Ms), np.float32)
    for r, a in enumerate((bank.t_mm, bank.t_mi, bank.t_md, bank.t_im,
                           bank.t_ii, bank.t_dm, bank.t_dd, bank.bm)):
        trans[:, r, :Mp1] = a
    return em, trans, np.asarray(bank.M, np.int32)


def _pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def query_blocks(codes: np.ndarray, qlens: np.ndarray, n_shards: int = 1):
    """Length-sorted query blocks: (order, codesT [NQB, L, QB],
    qlens [NQB, QB], nres [NQB]). Padding queries have length 0 and run
    no rows, and each block runs only to its own longest query, so NQB
    and L are rounded up to powers of two (NQB then to a multiple of
    n_shards) at almost no cost: runs of similar size share one compiled
    kernel."""
    Q = len(qlens)
    order = np.argsort(qlens, kind="stable")
    nqb = _pow2(-(-max(Q, 1) // QB))
    nqb = -(-nqb // n_shards) * n_shards
    L = max(64, _pow2(int(qlens.max(initial=1))))
    cs = np.zeros((nqb * QB, L), np.int32)
    ls = np.zeros(nqb * QB, np.int32)
    cs[:Q, :codes.shape[1]] = codes[order]
    ls[:Q] = qlens[order]
    codesT = np.ascontiguousarray(cs.reshape(nqb, QB, L).transpose(0, 2, 1))
    lsb = ls.reshape(nqb, QB)
    return order, codesT, lsb, lsb.max(axis=1).astype(np.int32)


def models_per_call(H: int, n_qblocks: int, Ms: int) -> int:
    """Models per kernel call: H rounded up to a power of two, at most
    what keeps the T/U scratch within SCRATCH_BYTES."""
    per_model = n_qblocks * 2 * Ms * QB * 4
    return min(_pow2(H), max(1, SCRATCH_BYTES // per_model))


def null1_bits(qlens: np.ndarray) -> np.ndarray:
    L = qlens.astype(np.float64)
    p1 = L / (L + 1.0)
    return (L * np.log(p1) + np.log(1.0 - p1)) / np.log(2.0)


def forward_bits(bank, codes: np.ndarray, qlens: np.ndarray,
                 interpret: bool = False, step=None,
                 n_shards: int = 1) -> np.ndarray:
    """Null1-corrected pre-score bits [Q, H] for one bank.

    `step` replaces forward_nats_blocks (the sharded caller passes its
    shard_map'ed version; NQB is then padded to a multiple of
    n_shards)."""
    if step is None:
        step = functools.partial(forward_nats_blocks, interpret=interpret)
    codes = np.asarray(codes, np.int32)
    qlens = np.asarray(qlens, np.int32)
    Q = len(qlens)
    em, trans, mlen = bank_kernel_arrays(bank)
    H, Ms, _ = em.shape
    order, codesT, lsb, nres = query_blocks(codes, qlens, n_shards)
    hc = models_per_call(H, codesT.shape[0], Ms)
    hpad = -(-H // hc) * hc
    if hpad > H:
        # zero-length padding models run no states
        em = np.concatenate([em, np.zeros((hpad - H,) + em.shape[1:],
                                          em.dtype)])
        trans = np.concatenate([trans, np.zeros((hpad - H,) + trans.shape[1:],
                                                trans.dtype)])
        mlen = np.concatenate([mlen, np.zeros(hpad - H, np.int32)])
    args = [jnp.asarray(a) for a in (codesT, lsb, nres)]
    outs = [step(*args, jnp.asarray(em[h0:h0 + hc]),
                 jnp.asarray(trans[h0:h0 + hc]),
                 jnp.asarray(mlen[h0:h0 + hc]))
            for h0 in range(0, hpad, hc)]
    nats = np.concatenate([np.asarray(o) for o in outs])[:H]
    nats = nats.reshape(H, -1)[:, :Q].T.astype(np.float64)
    out = np.empty_like(nats)
    out[order] = nats
    return out / np.log(2.0) - null1_bits(qlens)[:, None]
