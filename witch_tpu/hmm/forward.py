"""Batched Forward scoring in JAX.

The device replacement for the reference's all-vs-all process farm of
`hmmsearch --max` jobs (witch_msa/gcmm/algorithm.py:273-337): one dense
[queries x HMMs] scaled-probability Forward DP, scanned over query residues
with the per-row delete chain expressed as an associative scan over states.
On a GPU score_bank runs the Triton kernel of ops/pallas_forward.py
instead, which computes the same recurrence.

Numerics: odds-domain float32 with per-row rescaling (the same strategy
HMMER's vector Forward uses); validated against the float64 log-space
reference in forward_ref.py, which itself matches the binary's reported
bit scores.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..device import on_gpu
from .bank import ProfileBank

OMEGA = 1.0 / 256.0   # null2 prior weight (seqbias floor)


def _dchain_combine(x, y):
    a1, b1 = x
    a2, b2 = y
    return a1 * a2, b1 * a2 + b2


def _forward_one(em_odds, t_mm, t_mi, t_md, t_im, t_ii, t_dm, t_dd, bm,
                 codes, qlen):
    """Forward for one (query, one HMM) pair in odds domain.

    em_odds: [Mp+1, num_codes]; codes: [Lmax] int32; qlen: scalar.
    Returns forward score in nats.
    """
    Mp1 = em_odds.shape[0]
    nj = 1.0
    pmove = (2.0 + nj) / (qlen.astype(jnp.float32) + 2.0 + nj)
    ploop = 1.0 - pmove

    # shifted transition vectors (index k holds t[k-1])
    sh = lambda v: jnp.concatenate([jnp.zeros((1,), v.dtype), v[:-1]])
    t_mm_s, t_im_s, t_dm_s = sh(t_mm), sh(t_im), sh(t_dm)
    t_md_s, t_dd_s = sh(t_md), sh(t_dd)

    def step(carry, x):
        Mv, Iv, Dv, N, B, J, C, logscale = carry
        e = em_odds[:, x]                      # [Mp+1]
        srcM = (sh(Mv * t_mm) + sh(Iv * t_im) + sh(Dv * t_dm) + B * bm)
        Mrow = srcM * e
        Irow = Mv * t_mi + Iv * t_ii
        # delete chain: D[k] = tdd[k-1]*D[k-1] + Mrow[k-1]*tmd[k-1]
        a = t_dd_s
        b = sh(Mrow * t_md)
        _, Drow = jax.lax.associative_scan(_dchain_combine, (a, b))
        E = jnp.sum(Mrow) + jnp.sum(Drow)
        Jn = J * ploop + E * 0.5
        Cn = C * ploop + E * 0.5
        Nn = N * ploop
        Bn = Nn * pmove + Jn * pmove
        # rescale
        scale = jnp.maximum(jnp.max(Mrow), jnp.maximum(Cn, Nn))
        scale = jnp.maximum(scale, 1e-35)
        inv = 1.0 / scale
        new = (Mrow * inv, Irow * inv, Drow * inv, Nn * inv, Bn * inv,
               Jn * inv, Cn * inv, logscale + jnp.log(scale))
        return new, None

    def masked_step(carry, xi):
        x, i = xi
        new, _ = step(carry, x)
        keep = i < qlen
        out = tuple(jnp.where(keep, n, c) for n, c in zip(new, carry))
        return out, None

    z = jnp.zeros((Mp1,), jnp.float32)
    init = (z, z, z, jnp.float32(1.0), pmove, jnp.float32(0.0),
            jnp.float32(0.0), jnp.float32(0.0))
    Lmax = codes.shape[0]
    (Mv, Iv, Dv, N, B, J, C, logscale), _ = jax.lax.scan(
        masked_step, init, (codes, jnp.arange(Lmax)))
    return jnp.log(C * pmove) + logscale


def _null1_bits(qlen):
    L = qlen.astype(jnp.float32)
    p1 = L / (L + 1.0)
    return (L * jnp.log(p1) + jnp.log(1.0 - p1)) / jnp.log(2.0)


@functools.partial(jax.jit, static_argnames=("batch_h",))
def forward_bits_bank(em_odds, t_mm, t_mi, t_md, t_im, t_ii, t_dm, t_dd, bm,
                      codes, qlens, batch_h=None):
    """Pre-scores (bits, null1-corrected, no null2) for all queries vs all
    HMMs in a bank. codes: [Q, Lmax]; returns [Q, H]."""
    f_h = jax.vmap(_forward_one,
                   in_axes=(0, 0, 0, 0, 0, 0, 0, 0, 0, None, None))
    f_qh = jax.vmap(f_h, in_axes=(None,) * 9 + (0, 0))
    fwd = f_qh(em_odds, t_mm, t_mi, t_md, t_im, t_ii, t_dm, t_dd, bm,
               codes, qlens)                       # [Q, H] nats
    bits = fwd / jnp.log(2.0) - _null1_bits(qlens)[:, None]
    return bits


def seq_bits_with_bias_floor(pre_bits: jnp.ndarray) -> jnp.ndarray:
    """Reported-score approximation: subtract the omega-floor seqbias
    (exact when the null2 per-residue sum is 0, the common DNA case)."""
    return pre_bits - jnp.log2(1.0 + OMEGA)


def score_bank(bank: ProfileBank, codes: np.ndarray, qlens: np.ndarray,
               q_chunk: int = 128, backend: str = "auto",
               mesh=None) -> np.ndarray:
    """Score [Q] queries against one bank; returns pre-score bits [Q, H].

    backend="auto" runs the Triton kernel (ops/pallas_forward.py) on a
    GPU, which beats the XLA scan there, and the XLA scan elsewhere;
    "xla" and "pallas" pick one. With a multi-device `mesh`
    (jax.sharding.Mesh with a 'data' axis) queries are sharded across
    devices — bit-identical results, distributed wall-clock.
    """
    if backend == "auto":
        backend = "pallas" if on_gpu() else "xla"
    if mesh is not None and int(mesh.shape.get("data", 1)) > 1:
        from ..parallel.dist import sharded_score_bank
        return sharded_score_bank(mesh, bank, codes.astype(np.int32),
                                  qlens.astype(np.int32), backend=backend)
    if backend == "pallas":
        from ..ops.pallas_forward import forward_bits
        return forward_bits(bank, codes, qlens)
    args = (bank.em_odds, bank.t_mm, bank.t_mi, bank.t_md, bank.t_im,
            bank.t_ii, bank.t_dm, bank.t_dd, bank.bm)
    dev_args = [jnp.asarray(a) for a in args]
    out = []
    Q = codes.shape[0]
    for s in range(0, Q, q_chunk):
        n = min(q_chunk, Q - s)
        # pad the final chunk to the fixed chunk shape: one kernel compile
        c = np.ones((min(q_chunk, Q), codes.shape[1]), np.int32) \
            if Q > q_chunk else codes[s:s + n].astype(np.int32)
        if Q > q_chunk:
            c[:n] = codes[s:s + n]
        l = np.ones(c.shape[0], np.int32)
        l[:n] = qlens[s:s + n]
        bits = np.asarray(forward_bits_bank(
            *dev_args, jnp.asarray(c), jnp.asarray(l)))
        out.append(bits[:n])
    return np.concatenate(out, axis=0)
