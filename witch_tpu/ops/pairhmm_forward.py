"""Batched pair-HMM forward scores on device (XLA).

The consistency backbone engine (backbone_consistency.py) needs two
kinds of pair-HMM quantities:

  * full match posteriors (forward+backward) — computed by the native
    C++ kernel; too large to move off the device per pair;
  * scalar alignment scores for the anchor embedding / guide distances
    — one float per pair, ideal for device batching.

This module implements the second: a jittable, batched forward pass of
the 3-state pair HMM (M / X=gap-in-B / Y=gap-in-A) in emission-odds
space with per-row rescaling, mirroring native/pairhmm_kernel.cpp with
its default (interior) flank parameters. The Y recurrence within a row
is a first-order linear recurrence solved with an associative scan, so
one jit'd program handles [P, LA] x [P, LB] batches with static padded
shapes; per-pair true lengths are handled by masking.

Returns log P(A, B) / (null model) — the total forward odds in nats.
"""

from __future__ import annotations

import numpy as np


def pairhmm_forward_logodds(codesA, lensA, codesB, lensB, em,
                            delta: float, eps: float):
    """[P] forward log-odds of each (A, B) pair.

    codesA [P, LA] int32 (padded), lensA [P], codesB [P, LB], lensB
    [P]; em [C, C] float32 emission odds. jit-compatible.
    """
    import jax
    import jax.numpy as jnp

    codesA = jnp.asarray(codesA, jnp.int32)
    codesB = jnp.asarray(codesB, jnp.int32)
    lensA = jnp.asarray(lensA, jnp.int32)
    lensB = jnp.asarray(lensB, jnp.int32)
    em = jnp.asarray(em, jnp.float32)
    P, LA = codesA.shape
    LB = codesB.shape[1]

    t_mm = jnp.float32(1.0 - 2.0 * delta)
    t_mg = jnp.float32(delta)
    t_gm = jnp.float32(1.0 - eps)
    t_gg = jnp.float32(eps)

    jcol = jnp.arange(LB + 1)[None, :]                     # [1, LB+1]
    maskB = (jcol <= lensB[:, None]).astype(jnp.float32)   # valid cols

    # row 0: fM = delta at j=0; fY[0, j] = t_mg * t_gg^(j-1) for j >= 1
    fM0 = jnp.zeros((P, LB + 1), jnp.float32).at[:, 0].set(1.0)
    fX0 = jnp.zeros((P, LB + 1), jnp.float32)
    geo = t_mg * t_gg ** jnp.arange(LB, dtype=jnp.float32)
    fY0 = jnp.concatenate(
        [jnp.zeros((P, 1), jnp.float32),
         jnp.broadcast_to(geo[None, :], (P, LB))], axis=1) * maskB

    def first_order_scan(b):
        """y_j = t_gg * y_{j-1} + b_j along axis 1, y_0 = b_0."""
        def combine(l, r):
            al, bl = l
            ar, br = r
            return al * ar, bl * ar + br

        a = jnp.full_like(b, t_gg)
        _, y = jax.lax.associative_scan(combine, (a, b), axis=1)
        return y

    def step(carry, xi):
        fMp, fXp, fYp, logs = carry
        codeA_i, i = xi
        active = (i < lensA)[:, None]                      # [P, 1]
        e = em[codeA_i[:, None], codesB]                   # [P, LB]
        e = jnp.concatenate(
            [jnp.zeros((P, 1), jnp.float32), e], axis=1)   # j=0 pad
        prevM_sh = jnp.roll(fMp, 1, axis=1).at[:, 0].set(0.0)
        prevX_sh = jnp.roll(fXp, 1, axis=1).at[:, 0].set(0.0)
        prevY_sh = jnp.roll(fYp, 1, axis=1).at[:, 0].set(0.0)
        m = e * (t_mm * prevM_sh + t_gm * prevX_sh + t_gm * prevY_sh)
        x = t_mg * fMp + t_gg * fXp
        m = m * maskB
        x = x * maskB
        # fY[i, j] = t_mg * m[j-1] + t_gg * fY[i, j-1]; col 0 is 0
        b = t_mg * jnp.roll(m, 1, axis=1).at[:, 0].set(0.0)
        y = first_order_scan(b) * maskB
        # per-row rescale
        mx = jnp.maximum(jnp.maximum(m.max(1), x.max(1)),
                         y.max(1))
        mx = jnp.where(mx <= 0, 1.0, mx)[:, None]
        mN = jnp.where(active, m / mx, fMp)
        xN = jnp.where(active, x / mx, fXp)
        yN = jnp.where(active, y / mx, fYp)
        logs = logs + jnp.where(active[:, 0],
                                jnp.log(mx[:, 0]), 0.0)
        return (mN, xN, yN, logs), None

    init = (fM0, fX0, fY0, jnp.zeros(P, jnp.float32))
    (fM, fX, fY, logs), _ = jax.lax.scan(
        step, init, (codesA.T, jnp.arange(LA, dtype=jnp.int32)))
    tot = jnp.take_along_axis(fM + fX + fY, lensB[:, None],
                              axis=1)[:, 0]
    return jnp.log(jnp.maximum(tot, 1e-30)) + logs


def pairhmm_forward_logodds_np(codeA, codeB, em, delta, eps):
    """float64 numpy reference (direct port of the native forward)."""
    LA, LB = len(codeA), len(codeB)
    t_mm, t_mg = 1.0 - 2.0 * delta, delta
    t_gm, t_gg = 1.0 - eps, eps
    fM = np.zeros((LA + 1, LB + 1))
    fX = np.zeros((LA + 1, LB + 1))
    fY = np.zeros((LA + 1, LB + 1))
    fM[0, 0] = 1.0
    for j in range(1, LB + 1):
        fY[0, j] = t_mg * fM[0, 0] if j == 1 else t_gg * fY[0, j - 1]
    logs = 0.0
    for i in range(1, LA + 1):
        fX[i, 0] = t_mg * fM[i - 1, 0] if i == 1 else t_gg * fX[i - 1, 0]
        for j in range(1, LB + 1):
            e = em[codeA[i - 1], codeB[j - 1]]
            fM[i, j] = e * (t_mm * fM[i - 1, j - 1] +
                            t_gm * fX[i - 1, j - 1] +
                            t_gm * fY[i - 1, j - 1])
            fX[i, j] = t_mg * fM[i - 1, j] + t_gg * fX[i - 1, j]
            fY[i, j] = t_mg * fM[i, j - 1] + t_gg * fY[i, j - 1]
        mx = max(fM[i].max(), fX[i].max(), fY[i].max(), 1e-300)
        fM[i] /= mx
        fX[i] /= mx
        fY[i] /= mx
        logs += np.log(mx)
    return float(np.log(max(fM[LA, LB] + fX[LA, LB] + fY[LA, LB],
                            1e-300)) + logs)
