/* Pair-HMM posterior kernel (host CPU production path).
 *
 * 3-state global pair-HMM (M / X=gap-in-B / Y=gap-in-A), forward +
 * backward in emission-odds space with per-row rescaling, returning
 * the match-state posterior P(a_i ~ b_j) as sparse (i, j, p) cells
 * plus the expected-accuracy score of the posterior-optimal pairwise
 * alignment (used for guide-tree distances).
 *
 * This is the numerical core of the consistency (ProbCons-style)
 * backbone aligner in witch_tpu/backbone_consistency.py — the
 * replacement for the reference's vendored-MAGUS / MAFFT L-INS-i
 * backbone path (witch_msa/gcmm/backbone.py:200-221). It is also the
 * test oracle for the recurrence.
 *
 * CPython C API + numpy only.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#define NPY_NO_DEPRECATED_API NPY_1_7_API_VERSION
#include <numpy/arrayobject.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct PairParams {
    const double *em;   /* [C, C] match emission odds p(a,b)/(q(a)q(b)) */
    npy_intp C;
    double delta;       /* gap open  (M->X, M->Y) */
    double eps;         /* gap extend (X->X, Y->Y) */
};

/* emission policies for the shared pair-HMM recurrence: e(i, j) is the
 * match-emission odds at 1-based match coordinates */
struct CodeEm {
    const double *em;
    npy_intp C;
    const int32_t *A, *B;
    inline double operator()(npy_intp i, npy_intp j) const {
        return em[(size_t)A[i - 1] * C + B[j - 1]];
    }
};

struct DenseEm {
    const double *EM;   /* [LA, LB] row-major */
    npy_intp LB;
    inline double operator()(npy_intp i, npy_intp j) const {
        return EM[(size_t)(i - 1) * LB + (j - 1)];
    }
};

/* forward/backward storage: [ (LA+1) * (LB+1) ] row-major.
 *
 * fo/fe are FLANK (terminal-gap) open/extend probabilities: gap runs
 * along row 0 / column 0 (leading flanks) and row LA / column LB
 * (trailing flanks) use them instead of delta/eps. With fe near 1 the
 * model behaves like an overlap ("glocal") aligner — essential for
 * inputs with +-25% length variation, where interior-priced terminal
 * gaps smear every posterior (the reference gets the same effect from
 * MAFFT --localpair inside MAGUS). */
template <class Em>
static void pairhmm_posterior(npy_intp LA, npy_intp LB, const Em &em,
                              double delta, double eps,
                              double fo, double fe,
                              std::vector<float> &postM,
                              double *ea_score) {
    const double t_mm = 1.0 - 2.0 * delta;
    const double t_mg = delta;           /* M -> X or Y */
    const double t_gm = 1.0 - eps;       /* X/Y -> M */
    const double t_gg = eps;
    const size_t W = (size_t)LB + 1;
    const size_t N = (size_t)(LA + 1) * W;
    std::vector<double> fM(N, 0.0), fX(N, 0.0), fY(N, 0.0);
    std::vector<double> scale((size_t)LA + 1, 1.0);

    /* ---- forward ---- */
    fM[0] = 1.0;
    /* row 0: only Y moves (consume B) — leading flank of B */
    for (npy_intp j = 1; j <= LB; j++) {
        fY[j] = (j == 1 ? fo * fM[0] : fe * fY[j - 1]);
    }
    for (npy_intp i = 1; i <= LA; i++) {
        double *fMi = fM.data() + (size_t)i * W;
        double *fXi = fX.data() + (size_t)i * W;
        double *fYi = fY.data() + (size_t)i * W;
        const double *fMp = fM.data() + (size_t)(i - 1) * W;
        const double *fXp = fX.data() + (size_t)(i - 1) * W;
        const double *fYp = fY.data() + (size_t)(i - 1) * W;
        /* j = 0: only X moves — leading flank of A */
        fXi[0] = (i == 1 ? fo * fMp[0] : fe * fXp[0]);
        double rowmax = fXi[0];
        const double yo = (i == LA) ? fo : t_mg;
        const double ye = (i == LA) ? fe : t_gg;
        for (npy_intp j = 1; j <= LB; j++) {
            const double e = em(i, j);
            const double m = e * (t_mm * fMp[j - 1] + t_gm * fXp[j - 1] +
                                  t_gm * fYp[j - 1]);
            const double xo = (j == LB) ? fo : t_mg;
            const double xe = (j == LB) ? fe : t_gg;
            const double x = xo * fMp[j] + xe * fXp[j];
            const double y = yo * fMi[j - 1] + ye * fYi[j - 1];
            fMi[j] = m;
            fXi[j] = x;
            fYi[j] = y;
            const double mx = m > x ? (m > y ? m : y) : (x > y ? x : y);
            if (mx > rowmax) rowmax = mx;
        }
        if (rowmax <= 0.0) rowmax = 1.0;
        scale[(size_t)i] = rowmax;
        const double inv = 1.0 / rowmax;
        for (npy_intp j = 0; j <= LB; j++) {
            fMi[j] *= inv;
            fXi[j] *= inv;
            fYi[j] *= inv;
        }
    }
    const double totP = fM[N - 1] + fX[N - 1] + fY[N - 1];

    /* ---- backward (same scales) ---- */
    std::vector<double> bM(N, 0.0), bX(N, 0.0), bY(N, 0.0);
    bM[N - 1] = 1.0;
    bX[N - 1] = 1.0;
    bY[N - 1] = 1.0;
    /* last row: only Y moves remain (X cannot reach Y: no X->Y) —
     * trailing flank of B */
    {
        double *bMi = bM.data() + (size_t)LA * W;
        double *bXi = bX.data() + (size_t)LA * W;
        double *bYi = bY.data() + (size_t)LA * W;
        for (npy_intp j = LB - 1; j >= 0; j--) {
            bMi[j] = fo * bYi[j + 1];
            bXi[j] = 0.0;
            bYi[j] = fe * bYi[j + 1];
        }
    }
    for (npy_intp i = LA - 1; i >= 0; i--) {
        double *bMi = bM.data() + (size_t)i * W;
        double *bXi = bX.data() + (size_t)i * W;
        double *bYi = bY.data() + (size_t)i * W;
        const double *bMn = bM.data() + (size_t)(i + 1) * W;
        const double *bXn = bX.data() + (size_t)(i + 1) * W;
        const double *bYn = bY.data() + (size_t)(i + 1) * W;
        const double inv = 1.0 / scale[(size_t)i + 1];
        /* j = LB: only X moves (Y cannot reach X) — trailing flank of A */
        bMi[LB] = fo * bXn[LB] * inv;
        bXi[LB] = fe * bXn[LB] * inv;
        bYi[LB] = 0.0;
        const double yo = (i == 0) ? fo : t_mg;
        const double ye = (i == 0) ? fe : t_gg;
        for (npy_intp j = LB - 1; j >= 0; j--) {
            const double e = em(i + 1, j + 1);
            const double md = e * bMn[j + 1] * inv;  /* diag M arrival */
            const double xd = bXn[j] * inv;          /* down X arrival */
            const double yd = bYi[j + 1];            /* right Y arrival */
            const double xo = (j == 0) ? fo : t_mg;
            const double xe = (j == 0) ? fe : t_gg;
            bMi[j] = t_mm * md + xo * xd + yo * yd;
            bXi[j] = t_gm * md + xe * xd;
            bYi[j] = t_gm * md + ye * yd;
        }
    }

    /* ---- match posterior ---- */
    postM.assign(N, 0.0f);
    if (totP > 0.0) {
        const double invT = 1.0 / totP;
        for (npy_intp i = 1; i <= LA; i++) {
            const double *fMi = fM.data() + (size_t)i * W;
            const double *bMi = bM.data() + (size_t)i * W;
            float *po = postM.data() + (size_t)i * W;
            for (npy_intp j = 1; j <= LB; j++) {
                double p = fMi[j] * bMi[j] * invT;
                po[j] = (float)(p > 1.0 ? 1.0 : p);
            }
        }
    }

    /* ---- expected-accuracy NW over the posterior (gap cost 0) ---- */
    if (ea_score) {
        std::vector<double> prev(W, 0.0), cur(W, 0.0);
        for (npy_intp i = 1; i <= LA; i++) {
            const float *po = postM.data() + (size_t)i * W;
            cur[0] = 0.0;
            for (npy_intp j = 1; j <= LB; j++) {
                double d = prev[j - 1] + po[j];
                double u = prev[j];
                double l = cur[j - 1];
                cur[j] = d > u ? (d > l ? d : l) : (u > l ? u : l);
            }
            std::swap(prev, cur);
        }
        npy_intp mn = LA < LB ? LA : LB;
        *ea_score = mn > 0 ? prev[LB] / (double)mn : 0.0;
    }
}

/* ---- AVX-512 f32 pair-HMM (lane-parallel along j within one pair) --
 *
 * Same recurrence and per-row scaling structure as pairhmm_posterior,
 * in f32 with power-of-2 row scales (exponent ledger, exact). The
 * in-row serial chains (forward Y, backward Y, EA prefix max) use
 * 16-lane Kogge-Stone scans with constant coefficients. The M update
 * sums tgm*(X+Y) so posterior(A,B) and posterior(B,A) stay symmetric
 * by construction at f32. ~4-6x the f64 scalar path; posteriors match
 * it to ~1e-5 (cutoff is 0.01). */
#ifdef __AVX512F__
#include <immintrin.h>

template <int S>
static inline __m512 shr_ps(__m512 v) {   /* res[j] = v[j-S], 0-fill */
    return _mm512_castsi512_ps(_mm512_alignr_epi32(
        _mm512_castps_si512(v), _mm512_setzero_si512(), 16 - S));
}

template <int S>
static inline __m512 shl_ps(__m512 v) {   /* res[j] = v[j+S], 0-fill */
    return _mm512_castsi512_ps(_mm512_alignr_epi32(
        _mm512_setzero_si512(), _mm512_castps_si512(v), S));
}

/* in-block scan v[j] = b[j] + a*v[j-1] (forward along lanes) */
static inline __m512 scan_fwd(__m512 b, float a) {
    __m512 v = b;
    const float a2 = a * a, a4 = a2 * a2, a8 = a4 * a4;
    v = _mm512_fmadd_ps(shr_ps<1>(v), _mm512_set1_ps(a), v);
    v = _mm512_fmadd_ps(shr_ps<2>(v), _mm512_set1_ps(a2), v);
    v = _mm512_fmadd_ps(shr_ps<4>(v), _mm512_set1_ps(a4), v);
    v = _mm512_fmadd_ps(shr_ps<8>(v), _mm512_set1_ps(a8), v);
    return v;
}

static inline __m512 scan_rev(__m512 b, float a) {
    __m512 v = b;
    const float a2 = a * a, a4 = a2 * a2, a8 = a4 * a4;
    v = _mm512_fmadd_ps(shl_ps<1>(v), _mm512_set1_ps(a), v);
    v = _mm512_fmadd_ps(shl_ps<2>(v), _mm512_set1_ps(a2), v);
    v = _mm512_fmadd_ps(shl_ps<4>(v), _mm512_set1_ps(a4), v);
    v = _mm512_fmadd_ps(shl_ps<8>(v), _mm512_set1_ps(a8), v);
    return v;
}

static void pairhmm_posterior_simd(npy_intp LA, npy_intp LB,
                                   const double *em64, npy_intp C,
                                   const int32_t *A, const int32_t *B,
                                   double delta, double eps,
                                   double fo_, double fe_,
                                   std::vector<float> &postM,
                                   npy_intp *stride_out,
                                   double *ea_score) {
    const float t_mm = (float)(1.0 - 2.0 * delta);
    const float t_mg = (float)delta;
    const float t_gm = (float)(1.0 - eps);
    const float t_gg = (float)eps;
    const float fo = (float)fo_, fe = (float)fe_;
    const size_t Wpad = (size_t)(((LB + 1 + 15) / 16) * 16) + 16;
    *stride_out = (npy_intp)Wpad;
    const int nblk = (int)((LB + 15) / 16);   /* blocks over j=1.. */

    /* f32 emission table + B-index vectors */
    std::vector<float> em32((size_t)C * C);
    for (size_t i = 0; i < em32.size(); i++) em32[i] = (float)em64[i];
    std::vector<int32_t> bidx(Wpad, 0), bidx2(Wpad, 0);
    for (npy_intp j = 1; j <= LB; j++) bidx[(size_t)j] = B[j - 1];
    for (npy_intp j = 0; j < LB; j++) bidx2[(size_t)j] = B[j];
    const __mmask16 emmask =
        C >= 16 ? (__mmask16)0xffff : (__mmask16)((1u << C) - 1);
    const __mmask16 emmask2 =
        C > 16 ? (__mmask16)((1u << (C - 16)) - 1) : (__mmask16)0;
    auto em_row = [&](int a, __m512 *z0, __m512 *z1) {
        *z0 = _mm512_maskz_loadu_ps(emmask, em32.data() + (size_t)a * C);
        if (C > 16)
            *z1 = _mm512_maskz_loadu_ps(
                emmask2, em32.data() + (size_t)a * C + 16);
        else
            *z1 = _mm512_setzero_ps();
    };
    auto em_lookup = [&](const __m512i &idx, const __m512 &z0,
                         const __m512 &z1) {
        if (C > 16) return _mm512_permutex2var_ps(z0, idx, z1);
        return _mm512_permutexvar_ps(idx, z0);
    };

    /* ---- forward ---- */
    std::vector<float> fMmat((size_t)(LA + 1) * Wpad, 0.0f);
    std::vector<float> fXp(Wpad, 0.0f), fXc(Wpad, 0.0f);
    std::vector<float> fYp(Wpad, 0.0f), fYc(Wpad, 0.0f);
    std::vector<int> eF((size_t)LA + 1, 0);
    fMmat[0] = 1.0f;
    for (npy_intp j = 1; j <= LB; j++)
        fYp[(size_t)j] = (j == 1) ? fo : fe * fYp[(size_t)j - 1];
    for (npy_intp i = 1; i <= LA; i++) {
        const float *Mp = fMmat.data() + (size_t)(i - 1) * Wpad;
        float *Mc = fMmat.data() + (size_t)i * Wpad;
        fXc[0] = (i == 1) ? fo * Mp[0] : fe * fXp[0];
        Mc[0] = 0.0f;
        fYc[0] = 0.0f;
        __m512 z0, z1;
        em_row(A[i - 1], &z0, &z1);
        const __m512 vtmm = _mm512_set1_ps(t_mm);
        const __m512 vtgm = _mm512_set1_ps(t_gm);
        const float xo_i = t_mg, xe_i = t_gg;   /* interior consts */
        for (int b = 0; b < nblk; b++) {
            const npy_intp j = 1 + (npy_intp)b * 16;
            const __m512 mprev = _mm512_loadu_ps(Mp + j - 1);
            const __m512 xprev1 = _mm512_loadu_ps(fXp.data() + j - 1);
            const __m512 yprev1 = _mm512_loadu_ps(fYp.data() + j - 1);
            const __m512 src = _mm512_fmadd_ps(
                mprev, vtmm,
                _mm512_mul_ps(_mm512_add_ps(xprev1, yprev1), vtgm));
            const __m512i idx = _mm512_loadu_si512(
                (const void *)(bidx.data() + j));
            const __m512 e = em_lookup(idx, z0, z1);
            _mm512_storeu_ps(Mc + j, _mm512_mul_ps(src, e));
            const __m512 x = _mm512_fmadd_ps(
                _mm512_loadu_ps(fXp.data() + j), _mm512_set1_ps(xe_i),
                _mm512_mul_ps(_mm512_loadu_ps(Mp + j),
                              _mm512_set1_ps(xo_i)));
            _mm512_storeu_ps(fXc.data() + j, x);
        }
        fXc[(size_t)LB] = fo * Mp[(size_t)LB] + fe * fXp[(size_t)LB];
        /* zero the pad tail so shifted loads next row stay clean */
        for (size_t j = (size_t)LB + 1; j < Wpad; j++) {
            Mc[j] = 0.0f; fXc[j] = 0.0f;
        }
        /* Y chain */
        const float yo = (i == LA) ? fo : t_mg;
        const float ye = (i == LA) ? fe : t_gg;
        alignas(64) float yapow[16];
        {
            float a = 1.0f;
            for (int l = 0; l < 16; l++) { a *= ye; yapow[l] = a; }
        }
        const __m512 vapow = _mm512_load_ps(yapow);
        float carry = 0.0f;                     /* fYc[0] = 0 */
        const __m512 vyo = _mm512_set1_ps(yo);
        for (int b = 0; b < nblk; b++) {
            const npy_intp j = 1 + (npy_intp)b * 16;
            const __m512 bv =
                _mm512_mul_ps(_mm512_loadu_ps(Mc + j - 1), vyo);
            __m512 v = scan_fwd(bv, ye);
            v = _mm512_fmadd_ps(vapow, _mm512_set1_ps(carry), v);
            _mm512_storeu_ps(fYc.data() + j, v);
            carry = fYc[(size_t)std::min<npy_intp>(j + 15, LB)];
            if (j + 15 > LB)
                carry = fYc[(size_t)LB];
        }
        for (size_t j = (size_t)LB + 1; j < Wpad; j++) fYc[j] = 0.0f;
        /* row max + power-of-2 rescale */
        __m512 vmax = _mm512_set1_ps(fXc[0]);
        for (int b = 0; b < (int)(Wpad / 16); b++) {
            const size_t j = (size_t)b * 16;
            vmax = _mm512_max_ps(vmax, _mm512_loadu_ps(Mc + j));
            vmax = _mm512_max_ps(vmax,
                                 _mm512_loadu_ps(fXc.data() + j));
            vmax = _mm512_max_ps(vmax,
                                 _mm512_loadu_ps(fYc.data() + j));
        }
        const float rowmax = _mm512_reduce_max_ps(vmax);
        int e_i = 0;
        if (rowmax > 0.0f) e_i = ilogbf(rowmax);
        eF[(size_t)i] = e_i;
        if (e_i != 0) {
            const __m512 sc = _mm512_set1_ps(ldexpf(1.0f, -e_i));
            for (int b = 0; b < (int)(Wpad / 16); b++) {
                const size_t j = (size_t)b * 16;
                _mm512_storeu_ps(Mc + j, _mm512_mul_ps(
                    _mm512_loadu_ps(Mc + j), sc));
                _mm512_storeu_ps(fXc.data() + j, _mm512_mul_ps(
                    _mm512_loadu_ps(fXc.data() + j), sc));
                _mm512_storeu_ps(fYc.data() + j, _mm512_mul_ps(
                    _mm512_loadu_ps(fYc.data() + j), sc));
            }
        }
        std::swap(fXp, fXc);
        std::swap(fYp, fYc);
    }
    const double totP =
        (double)fMmat[(size_t)LA * Wpad + LB] + (double)fXp[(size_t)LB]
        + (double)fYp[(size_t)LB];

    /* ---- backward + posterior (two rows live) ---- */
    postM.assign((size_t)(LA + 1) * Wpad, 0.0f);
    std::vector<float> bMn(Wpad, 0.0f), bMc(Wpad, 0.0f);
    std::vector<float> bXn(Wpad, 0.0f), bXc(Wpad, 0.0f);
    std::vector<float> bYn(Wpad, 0.0f), bYc(Wpad, 0.0f);
    std::vector<float> mdr(Wpad, 0.0f);
    const float invT =
        totP > 0.0 ? (float)(1.0 / totP) : 0.0f;
    /* row LA */
    bMn[(size_t)LB] = 1.0f;
    bXn[(size_t)LB] = 1.0f;
    bYn[(size_t)LB] = 1.0f;
    for (npy_intp j = LB - 1; j >= 0; j--) {
        bYn[(size_t)j] = fe * bYn[(size_t)j + 1];
        bMn[(size_t)j] = fo * bYn[(size_t)j + 1];
        bXn[(size_t)j] = 0.0f;
    }
    if (totP > 0.0) {
        const float *MrLA = fMmat.data() + (size_t)LA * Wpad;
        float *po = postM.data() + (size_t)LA * Wpad;
        const __m512 vInv = _mm512_set1_ps(invT);
        const __m512 vone = _mm512_set1_ps(1.0f);
        for (int b = 0; b < nblk; b++) {
            const npy_intp j = 1 + (npy_intp)b * 16;
            __m512 p = _mm512_mul_ps(
                _mm512_mul_ps(_mm512_loadu_ps(MrLA + j),
                              _mm512_loadu_ps(bMn.data() + j)), vInv);
            _mm512_storeu_ps(po + j, _mm512_min_ps(p, vone));
        }
        for (size_t j = (size_t)LB + 1; j < Wpad; j++) po[j] = 0.0f;
        po[0] = 0.0f;
    }
    for (npy_intp i = LA - 1; i >= 0; i--) {
        const float inv = ldexpf(1.0f, -eF[(size_t)i + 1]);
        const __m512 vinv = _mm512_set1_ps(inv);
        bMc[(size_t)LB] = fo * bXn[(size_t)LB] * inv;
        bXc[(size_t)LB] = fe * bXn[(size_t)LB] * inv;
        bYc[(size_t)LB] = 0.0f;
        __m512 z0, z1;
        em_row(A[i], &z0, &z1);
        /* md[j] = e(i+1, j+1) * bMn[j+1] * inv, j = 0..LB-1 */
        for (int b = 0; b < nblk; b++) {
            const npy_intp j = (npy_intp)b * 16;
            const __m512i idx = _mm512_loadu_si512(
                (const void *)(bidx2.data() + j));
            const __m512 e = em_lookup(idx, z0, z1);
            const __m512 v = _mm512_mul_ps(_mm512_mul_ps(
                e, _mm512_loadu_ps(bMn.data() + j + 1)), vinv);
            _mm512_storeu_ps(mdr.data() + j, v);
        }
        for (size_t j = (size_t)LB; j < Wpad; j++) mdr[j] = 0.0f;
        /* bY reverse chain: bY[j] = tgm*md[j] + ye*bY[j+1] */
        const float yo = (i == 0) ? fo : t_mg;
        const float ye = (i == 0) ? fe : t_gg;
        alignas(64) float yrpow[16];
        {
            for (int l = 0; l < 16; l++)
                yrpow[l] = powf(ye, (float)(16 - l));
        }
        const __m512 vrpow = _mm512_load_ps(yrpow);
        const __m512 vtgm = _mm512_set1_ps(t_gm);
        for (int b = nblk - 1; b >= 0; b--) {
            const npy_intp j = (npy_intp)b * 16;
            /* lanes j..j+15 (valid up to LB-1) */
            const __m512 bv = _mm512_mul_ps(
                _mm512_loadu_ps(mdr.data() + j), vtgm);
            __m512 v = scan_rev(bv, ye);
            const float carry =
                bYc[(size_t)std::min<npy_intp>(j + 16, LB)];
            v = _mm512_fmadd_ps(vrpow, _mm512_set1_ps(carry), v);
            _mm512_storeu_ps(bYc.data() + j, v);
        }
        bYc[(size_t)LB] = 0.0f;
        for (size_t j = (size_t)LB + 1; j < Wpad; j++) bYc[j] = 0.0f;
        /* bM / bX rows + posterior */
        const __m512 vtmm = _mm512_set1_ps(t_mm);
        const __m512 vyo = _mm512_set1_ps(yo);
        const __m512 vxo = _mm512_set1_ps(t_mg);
        const __m512 vxe = _mm512_set1_ps(t_gg);
        for (int b = 0; b < nblk; b++) {
            const npy_intp j = (npy_intp)b * 16;
            const __m512 md = _mm512_loadu_ps(mdr.data() + j);
            const __m512 xd = _mm512_mul_ps(
                _mm512_loadu_ps(bXn.data() + j), vinv);
            const __m512 yd = _mm512_loadu_ps(bYc.data() + j + 1);
            __m512 bm = _mm512_fmadd_ps(
                md, vtmm, _mm512_fmadd_ps(xd, vxo,
                                          _mm512_mul_ps(yd, vyo)));
            __m512 bx = _mm512_fmadd_ps(md, vtgm,
                                        _mm512_mul_ps(xd, vxe));
            _mm512_storeu_ps(bMc.data() + j, bm);
            _mm512_storeu_ps(bXc.data() + j, bx);
        }
        /* j = 0 boundary (xo/xe -> flank) and j = LB done above */
        {
            const float md0 = mdr[0];
            const float xd0 = bXn[0] * inv;
            const float yd0 = bYc[1];
            bMc[0] = t_mm * md0 + fo * xd0 + yo * yd0;
            bXc[0] = t_gm * md0 + fe * xd0;
        }
        bMc[(size_t)LB] = fo * bXn[(size_t)LB] * inv;
        bXc[(size_t)LB] = fe * bXn[(size_t)LB] * inv;
        for (size_t j = (size_t)LB + 1; j < Wpad; j++) {
            bMc[j] = 0.0f; bXc[j] = 0.0f;
        }
        if (i >= 1 && totP > 0.0) {
            const float *Mr = fMmat.data() + (size_t)i * Wpad;
            float *po = postM.data() + (size_t)i * Wpad;
            const __m512 vInv = _mm512_set1_ps(invT);
            const __m512 vone = _mm512_set1_ps(1.0f);
            for (int b = 0; b < nblk; b++) {
                const npy_intp j = 1 + (npy_intp)b * 16;
                __m512 p = _mm512_mul_ps(_mm512_mul_ps(
                    _mm512_loadu_ps(Mr + j),
                    _mm512_loadu_ps(bMc.data() + j)), vInv);
                _mm512_storeu_ps(po + j, _mm512_min_ps(p, vone));
            }
            for (size_t j = (size_t)LB + 1; j < Wpad; j++) po[j] = 0.0f;
            po[0] = 0.0f;
        }
        std::swap(bMn, bMc);
        std::swap(bXn, bXc);
        std::swap(bYn, bYc);
    }

    /* ---- EA (prefix-max scan per row) ---- */
    if (ea_score) {
        std::vector<float> prev(Wpad, 0.0f), cur(Wpad, 0.0f);
        for (npy_intp i = 1; i <= LA; i++) {
            const float *po = postM.data() + (size_t)i * Wpad;
            cur[0] = 0.0f;
            float carry = 0.0f;
            for (int b = 0; b < nblk; b++) {
                const npy_intp j = 1 + (npy_intp)b * 16;
                const __m512 d = _mm512_add_ps(
                    _mm512_loadu_ps(prev.data() + j - 1),
                    _mm512_loadu_ps(po + j));
                __m512 v = _mm512_max_ps(
                    d, _mm512_loadu_ps(prev.data() + j));
                v = _mm512_max_ps(v, shr_ps<1>(v));
                v = _mm512_max_ps(v, shr_ps<2>(v));
                v = _mm512_max_ps(v, shr_ps<4>(v));
                v = _mm512_max_ps(v, shr_ps<8>(v));
                v = _mm512_max_ps(v, _mm512_set1_ps(carry));
                _mm512_storeu_ps(cur.data() + j, v);
                carry = cur[(size_t)std::min<npy_intp>(j + 15, LB)];
            }
            for (size_t j = (size_t)LB + 1; j < Wpad; j++)
                cur[j] = 0.0f;
            std::swap(prev, cur);
        }
        npy_intp mn = LA < LB ? LA : LB;
        *ea_score = mn > 0 ? (double)prev[(size_t)LB] / (double)mn : 0.0;
    }
}
#endif  /* __AVX512F__ */

static bool as_i32(PyObject *o, const int32_t **p, npy_intp *n) {
    PyArrayObject *a = (PyArrayObject *)o;
    if (!PyArray_Check(o) || PyArray_TYPE(a) != NPY_INT32 ||
        PyArray_NDIM(a) != 1 || !PyArray_IS_C_CONTIGUOUS(a)) {
        PyErr_SetString(PyExc_TypeError, "expected contiguous int32 1D");
        return false;
    }
    *p = (const int32_t *)PyArray_DATA(a);
    *n = PyArray_DIM(a, 0);
    return true;
}

/* shared sparse-output packaging for the posterior entry points */
static PyObject *sparsify_posterior(const std::vector<float> &postM,
                                    npy_intp LA, npy_intp LB,
                                    double cutoff, double ea,
                                    npy_intp stride = 0) {
    std::vector<int32_t> Is, Js;
    std::vector<float> Ps;
    const size_t W = stride > 0 ? (size_t)stride : (size_t)LB + 1;
    for (npy_intp i = 1; i <= LA; i++) {
        const float *po = postM.data() + (size_t)i * W;
        for (npy_intp j = 1; j <= LB; j++) {
            if (po[j] >= cutoff) {
                Is.push_back((int32_t)(i - 1));
                Js.push_back((int32_t)(j - 1));
                Ps.push_back(po[j]);
            }
        }
    }
    npy_intp n = (npy_intp)Is.size();
    PyArrayObject *Io = (PyArrayObject *)PyArray_SimpleNew(1, &n, NPY_INT32);
    PyArrayObject *Jo = (PyArrayObject *)PyArray_SimpleNew(1, &n, NPY_INT32);
    PyArrayObject *Po =
        (PyArrayObject *)PyArray_SimpleNew(1, &n, NPY_FLOAT32);
    if (!Io || !Jo || !Po) {
        Py_XDECREF(Io);
        Py_XDECREF(Jo);
        Py_XDECREF(Po);
        return NULL;
    }
    if (n) {
        memcpy(PyArray_DATA(Io), Is.data(), (size_t)n * 4);
        memcpy(PyArray_DATA(Jo), Js.data(), (size_t)n * 4);
        memcpy(PyArray_DATA(Po), Ps.data(), (size_t)n * 4);
    }
    return Py_BuildValue("NNNd", Io, Jo, Po, ea);
}

/* posterior(codesA, codesB, em [C,C] float64, delta, eps, cutoff)
 *   -> (I int32, J int32, P float32, ea float) */
static PyObject *posterior(PyObject *, PyObject *args) {
    PyObject *Ao, *Bo, *Eo;
    double delta, eps, cutoff, fo = -1.0, fe = -1.0;
    if (!PyArg_ParseTuple(args, "OOOddd|dd", &Ao, &Bo, &Eo, &delta, &eps,
                          &cutoff, &fo, &fe))
        return NULL;
    if (fo < 0.0) fo = delta;
    if (fe < 0.0) fe = eps;
    const int32_t *A, *B;
    npy_intp LA, LB;
    if (!as_i32(Ao, &A, &LA) || !as_i32(Bo, &B, &LB)) return NULL;
    PyArrayObject *E = (PyArrayObject *)Eo;
    if (!PyArray_Check(Eo) || PyArray_TYPE(E) != NPY_FLOAT64 ||
        PyArray_NDIM(E) != 2 || !PyArray_IS_C_CONTIGUOUS(E) ||
        PyArray_DIM(E, 0) != PyArray_DIM(E, 1)) {
        PyErr_SetString(PyExc_TypeError, "em must be square float64");
        return NULL;
    }
    const double *emp = (const double *)PyArray_DATA(E);
    npy_intp C = PyArray_DIM(E, 0);
    /* validate codes < C */
    for (npy_intp i = 0; i < LA; i++)
        if (A[i] < 0 || A[i] >= C) {
            PyErr_SetString(PyExc_ValueError, "code out of range");
            return NULL;
        }
    for (npy_intp j = 0; j < LB; j++)
        if (B[j] < 0 || B[j] >= C) {
            PyErr_SetString(PyExc_ValueError, "code out of range");
            return NULL;
        }

    std::vector<float> postM;
    double ea = 0.0;
    npy_intp stride = 0;
#ifdef __AVX512F__
    if (C <= 32 && LA > 0 && LB > 0) {
        Py_BEGIN_ALLOW_THREADS
        {
            const unsigned csr = _mm_getcsr();
            _mm_setcsr(csr | 0x8040);   /* FTZ/DAZ for decayed cells */
            pairhmm_posterior_simd(LA, LB, emp, C, A, B, delta, eps,
                                   fo, fe, postM, &stride, &ea);
            _mm_setcsr(csr);
        }
        Py_END_ALLOW_THREADS
        return sparsify_posterior(postM, LA, LB, cutoff, ea, stride);
    }
#endif
    Py_BEGIN_ALLOW_THREADS
    {
        CodeEm em{emp, C, A, B};
        pairhmm_posterior(LA, LB, em, delta, eps, fo, fe, postM, &ea);
    }
    Py_END_ALLOW_THREADS
    return sparsify_posterior(postM, LA, LB, cutoff, ea);
}

/* posterior_dense(EM [LA, LB] float64 match-emission odds, delta, eps,
 * cutoff) -> (I, J, P, ea). Same pair-HMM, precomputed emissions —
 * used for profile-column vs profile-column posteriors (the subset
 * merge stage of backbone_consistency.align_backbone_consistency). */
static PyObject *posterior_dense(PyObject *, PyObject *args) {
    PyObject *Eo;
    double delta, eps, cutoff, fo = -1.0, fe = -1.0;
    if (!PyArg_ParseTuple(args, "Oddd|dd", &Eo, &delta, &eps, &cutoff,
                          &fo, &fe))
        return NULL;
    if (fo < 0.0) fo = delta;
    if (fe < 0.0) fe = eps;
    PyArrayObject *E = (PyArrayObject *)Eo;
    if (!PyArray_Check(Eo) || PyArray_TYPE(E) != NPY_FLOAT64 ||
        PyArray_NDIM(E) != 2 || !PyArray_IS_C_CONTIGUOUS(E)) {
        PyErr_SetString(PyExc_TypeError, "EM must be 2D float64");
        return NULL;
    }
    npy_intp LA = PyArray_DIM(E, 0), LB = PyArray_DIM(E, 1);
    const double *emp = (const double *)PyArray_DATA(E);
    std::vector<float> postM;
    double ea = 0.0;
    Py_BEGIN_ALLOW_THREADS
    {
        DenseEm em{emp, LB};
        pairhmm_posterior(LA, LB, em, delta, eps, fo, fe, postM, &ea);
    }
    Py_END_ALLOW_THREADS
    return sparsify_posterior(postM, LA, LB, cutoff, ea);
}

/* ea_align(S [WA, WB] float64 sparse-accumulated scores) -> ops int8
 * Plain NW, gap cost 0, maximizing total score (expected accuracy).
 * Tie order: diag > up > left. */
static PyObject *ea_align(PyObject *, PyObject *args) {
    PyObject *So;
    if (!PyArg_ParseTuple(args, "O", &So)) return NULL;
    PyArrayObject *S = (PyArrayObject *)So;
    if (!PyArray_Check(So) || PyArray_TYPE(S) != NPY_FLOAT64 ||
        PyArray_NDIM(S) != 2 || !PyArray_IS_C_CONTIGUOUS(S)) {
        PyErr_SetString(PyExc_TypeError, "S must be 2D float64");
        return NULL;
    }
    npy_intp MA = PyArray_DIM(S, 0), MB = PyArray_DIM(S, 1);
    const double *sp = (const double *)PyArray_DATA(S);
    std::vector<signed char> ops;
    Py_BEGIN_ALLOW_THREADS
    size_t W = (size_t)MB + 1;
    std::vector<double> prev(W, 0.0), cur(W, 0.0);
    std::vector<unsigned char> ptr((size_t)(MA + 1) * W, 0);
    for (npy_intp j = 0; j <= MB; j++) ptr[j] = 2;
    for (npy_intp i = 1; i <= MA; i++) {
        unsigned char *pr = ptr.data() + (size_t)i * W;
        pr[0] = 1;
        cur[0] = 0.0;
        const double *Si = sp + (size_t)(i - 1) * MB;
        for (npy_intp j = 1; j <= MB; j++) {
            double d = prev[j - 1] + Si[j - 1];
            double u = prev[j];
            double l = cur[j - 1];
            double best = d;
            unsigned char p = 0;
            if (u > best) { best = u; p = 1; }
            if (l > best) { best = l; p = 2; }
            cur[j] = best;
            pr[j] = p;
        }
        std::swap(prev, cur);
    }
    npy_intp i = MA, j = MB;
    ops.reserve((size_t)(MA + MB));
    while (i > 0 || j > 0) {
        unsigned char p = ptr[(size_t)i * W + j];
        if (i > 0 && j > 0 && p == 0) { ops.push_back(0); i--; j--; }
        else if (i > 0 && (j == 0 || p == 1)) { ops.push_back(1); i--; }
        else { ops.push_back(2); j--; }
    }
    Py_END_ALLOW_THREADS
    npy_intp n = (npy_intp)ops.size();
    PyArrayObject *out =
        (PyArrayObject *)PyArray_SimpleNew(1, &n, NPY_INT8);
    if (!out) return NULL;
    signed char *op = (signed char *)PyArray_DATA(out);
    for (npy_intp t = 0; t < n; t++) op[t] = ops[(size_t)(n - 1 - t)];
    return (PyObject *)out;
}

/* group_score(WA, WB, cal, cbl, Il, Jl, Pl) -> S float64 [WA, WB]
 *
 * Dense scatter-add of cross-group posterior mass: for each pair p,
 * S[ca_p[I_p[k]], cb_p[J_p[k]]] += P_p[k]. The hot inner step of
 * backbone_consistency._group_score (EA merge + bipartition
 * refinement) without numpy concatenate/bincount temporaries.
 * ca/cb/I/J are int64 arrays, P float64 (the memoized COO cache
 * layout); indices are trusted (internal API). */
static PyObject *group_score(PyObject *, PyObject *args) {
    int WA, WB;
    PyObject *cal, *cbl, *Il, *Jl, *Pl;
    if (!PyArg_ParseTuple(args, "iiOOOOO", &WA, &WB, &cal, &cbl, &Il,
                          &Jl, &Pl))
        return NULL;
    PyObject *ls[5] = {cal, cbl, Il, Jl, Pl};
    for (int t = 0; t < 5; t++)
        if (!PyList_Check(ls[t])) {
            PyErr_SetString(PyExc_TypeError, "expected lists");
            return NULL;
        }
    Py_ssize_t P = PyList_GET_SIZE(cal);
    for (int t = 1; t < 5; t++)
        if (PyList_GET_SIZE(ls[t]) != P) {
            PyErr_SetString(PyExc_ValueError, "list length mismatch");
            return NULL;
        }
    struct Ent {
        const int64_t *ca, *cb, *I, *J;
        const double *val;
        npy_intp nnz;
    };
    std::vector<Ent> ents((size_t)P);
    for (Py_ssize_t p = 0; p < P; p++) {
        PyArrayObject *a[5];
        for (int t = 0; t < 5; t++) {
            a[t] = (PyArrayObject *)PyList_GET_ITEM(ls[t], p);
            if (!PyArray_Check((PyObject *)a[t]) ||
                PyArray_NDIM(a[t]) != 1 ||
                !PyArray_IS_C_CONTIGUOUS(a[t]) ||
                PyArray_TYPE(a[t]) != (t == 4 ? NPY_FLOAT64
                                              : NPY_INT64)) {
                PyErr_SetString(PyExc_TypeError,
                                "arrays must be 1D i64 (P: f64)");
                return NULL;
            }
        }
        Ent &e = ents[(size_t)p];
        e.ca = (const int64_t *)PyArray_DATA(a[0]);
        e.cb = (const int64_t *)PyArray_DATA(a[1]);
        e.I = (const int64_t *)PyArray_DATA(a[2]);
        e.J = (const int64_t *)PyArray_DATA(a[3]);
        e.val = (const double *)PyArray_DATA(a[4]);
        e.nnz = PyArray_DIM(a[2], 0);
        if (PyArray_DIM(a[3], 0) != e.nnz ||
            PyArray_DIM(a[4], 0) != e.nnz) {
            PyErr_SetString(PyExc_ValueError, "nnz mismatch");
            return NULL;
        }
    }
    npy_intp dims[2] = {WA, WB};
    PyArrayObject *So =
        (PyArrayObject *)PyArray_ZEROS(2, dims, NPY_FLOAT64, 0);
    if (!So) return NULL;
    double *S = (double *)PyArray_DATA(So);
    Py_BEGIN_ALLOW_THREADS
    for (const Ent &e : ents)
        for (npy_intp k = 0; k < e.nnz; k++)
            S[(size_t)e.ca[e.I[k]] * WB + e.cb[e.J[k]]] += e.val[k];
    Py_END_ALLOW_THREADS
    return (PyObject *)So;
}

/* ---- consistency transform (SpGEMM over all pairs) ----
 *
 * transform(n, ks int32[P], kt int32[P], indptrs, idxs, vals,
 *           lens int32[n], cutoff, nthreads)
 *   -> list of (indptr int64, idx int32, val float32) per input key
 *
 * Computes P'_xz = (2 P_xz + sum_{y != x,z} P_xy P_yz) / n for every
 * input pair (x, z), x < z. indptrs/idxs/vals are Python lists of
 * numpy arrays (CSR rows over the first index). Transposes for the
 * reverse orientation are built internally. Dense row accumulator
 * SpGEMM, std::thread parallel over pairs.
 */


struct CsrMat {
    std::vector<int64_t> indptr;
    std::vector<int32_t> idx;
    std::vector<float> val;
    npy_intp rows = 0, cols = 0;
};

static void transpose_csr(const CsrMat &a, CsrMat &out) {
    out.rows = a.cols;
    out.cols = a.rows;
    out.indptr.assign((size_t)a.cols + 1, 0);
    out.idx.resize(a.val.size());
    out.val.resize(a.val.size());
    for (size_t k = 0; k < a.idx.size(); k++) out.indptr[(size_t)a.idx[k] + 1]++;
    for (size_t c = 0; c < (size_t)a.cols; c++) out.indptr[c + 1] += out.indptr[c];
    std::vector<int64_t> fill(out.indptr.begin(), out.indptr.end() - 1);
    for (npy_intp r = 0; r < a.rows; r++) {
        for (int64_t k = a.indptr[(size_t)r]; k < a.indptr[(size_t)r + 1]; k++) {
            int32_t c = a.idx[(size_t)k];
            int64_t pos = fill[(size_t)c]++;
            out.idx[(size_t)pos] = (int32_t)r;
            out.val[(size_t)pos] = a.val[(size_t)k];
        }
    }
}

static PyObject *transform(PyObject *, PyObject *args) {
    int n, nthreads;
    PyObject *kso, *kto, *ipl, *ixl, *vl, *lenso;
    PyObject *simso = NULL;
    double cutoff;
    if (!PyArg_ParseTuple(args, "iOOOOOOdi|O", &n, &kso, &kto, &ipl, &ixl,
                          &vl, &lenso, &cutoff, &nthreads, &simso))
        return NULL;
    /* optional [n, n] f64 similarity: relay y weighted by
     * sim[x][y]*sim[y][z] (MSAProbs-style weighted consistency);
     * absent/None = unit weights = the original unweighted mean */
    const double *sims = NULL;
    if (simso && simso != Py_None) {
        PyArrayObject *sa = (PyArrayObject *)simso;
        if (!PyArray_Check(simso) || PyArray_TYPE(sa) != NPY_FLOAT64 ||
            PyArray_NDIM(sa) != 2 || PyArray_DIM(sa, 0) != n ||
            PyArray_DIM(sa, 1) != n ||
            !(PyArray_FLAGS(sa) & NPY_ARRAY_C_CONTIGUOUS)) {
            PyErr_SetString(PyExc_TypeError,
                            "sims must be C-contiguous f64 [n, n]");
            return NULL;
        }
        sims = (const double *)PyArray_DATA(sa);
    }
    const int32_t *ks, *kt, *lens;
    npy_intp P, nn;
    if (!as_i32(kso, &ks, &P) || !as_i32(kto, &kt, &nn)) return NULL;
    if (!as_i32(lenso, &lens, &nn) || nn != n) {
        PyErr_SetString(PyExc_ValueError, "lens mismatch");
        return NULL;
    }
    if (!PyList_Check(ipl) || !PyList_Check(ixl) || !PyList_Check(vl) ||
        PyList_Size(ipl) != P || PyList_Size(ixl) != P ||
        PyList_Size(vl) != P) {
        PyErr_SetString(PyExc_TypeError, "CSR lists must match key count");
        return NULL;
    }
    /* load CSR inputs (copy; GIL held) */
    std::vector<CsrMat> mats((size_t)P);
    for (npy_intp p = 0; p < P; p++) {
        PyArrayObject *ip = (PyArrayObject *)PyList_GetItem(ipl, p);
        PyArrayObject *ix = (PyArrayObject *)PyList_GetItem(ixl, p);
        PyArrayObject *va = (PyArrayObject *)PyList_GetItem(vl, p);
        if (PyArray_TYPE(ip) != NPY_INT64 || PyArray_TYPE(ix) != NPY_INT32 ||
            PyArray_TYPE(va) != NPY_FLOAT32) {
            PyErr_SetString(PyExc_TypeError,
                            "CSR arrays must be int64/int32/float32");
            return NULL;
        }
        CsrMat &m = mats[(size_t)p];
        npy_intp nr = PyArray_DIM(ip, 0) - 1;
        npy_intp ne = PyArray_DIM(ix, 0);
        m.rows = nr;
        m.cols = lens[kt[p]];
        if (nr != lens[ks[p]]) {
            PyErr_SetString(PyExc_ValueError, "CSR row count mismatch");
            return NULL;
        }
        const int64_t *ipd = (const int64_t *)PyArray_DATA(ip);
        const int32_t *ixd = (const int32_t *)PyArray_DATA(ix);
        const float *vad = (const float *)PyArray_DATA(va);
        m.indptr.assign(ipd, ipd + nr + 1);
        m.idx.assign(ixd, ixd + ne);
        m.val.assign(vad, vad + ne);
    }

    std::vector<CsrMat> outs((size_t)P);
    Py_BEGIN_ALLOW_THREADS
    {
        /* orientation table M[a][b] -> CsrMat*  */
        std::vector<const CsrMat *> table((size_t)n * n, nullptr);
        std::vector<CsrMat> trans((size_t)P);
        for (npy_intp p = 0; p < P; p++) {
            transpose_csr(mats[(size_t)p], trans[(size_t)p]);
            table[(size_t)ks[p] * n + kt[p]] = &mats[(size_t)p];
            table[(size_t)kt[p] * n + ks[p]] = &trans[(size_t)p];
        }
        std::atomic<npy_intp> next(0);
        auto worker = [&]() {
            std::vector<double> acc;
            std::vector<int32_t> touched;
            std::vector<double> wy;
            for (;;) {
                npy_intp p = next.fetch_add(1);
                if (p >= P) break;
                int x = ks[p], z = kt[p];
                const CsrMat &pxz = mats[(size_t)p];
                npy_intp Lx = lens[x], Lz = lens[z];
                CsrMat &out = outs[(size_t)p];
                out.rows = Lx;
                out.cols = Lz;
                out.indptr.assign((size_t)Lx + 1, 0);
                acc.assign((size_t)Lz, 0.0);
                touched.clear();
                /* relay weights + denominator for this (x, z) */
                wy.assign((size_t)n, 1.0);
                double denom = (double)n;
                if (sims) {
                    denom = 2.0;
                    for (int y = 0; y < n; y++) {
                        if (y == x || y == z) continue;
                        double w = sims[(size_t)x * n + y] *
                                   sims[(size_t)y * n + z];
                        wy[(size_t)y] = w;
                        denom += w;
                    }
                }
                const double invn = 1.0 / denom;
                for (npy_intp i = 0; i < Lx; i++) {
                    /* direct term (x2) */
                    for (int64_t k = pxz.indptr[(size_t)i];
                         k < pxz.indptr[(size_t)i + 1]; k++) {
                        int32_t c = pxz.idx[(size_t)k];
                        if (acc[(size_t)c] == 0.0) touched.push_back(c);
                        acc[(size_t)c] += 2.0 * pxz.val[(size_t)k];
                    }
                    /* sum over intermediates */
                    for (int y = 0; y < n; y++) {
                        if (y == x || y == z) continue;
                        if (sims && wy[(size_t)y] < 1e-3) continue;
                        const CsrMat *pxy = table[(size_t)x * n + y];
                        const CsrMat *pyz = table[(size_t)y * n + z];
                        if (!pxy || !pyz) continue;
                        for (int64_t k = pxy->indptr[(size_t)i];
                             k < pxy->indptr[(size_t)i + 1]; k++) {
                            int32_t j = pxy->idx[(size_t)k];
                            double v = wy[(size_t)y] * pxy->val[(size_t)k];
                            for (int64_t q = pyz->indptr[(size_t)j];
                                 q < pyz->indptr[(size_t)j + 1]; q++) {
                                int32_t c = pyz->idx[(size_t)q];
                                if (acc[(size_t)c] == 0.0)
                                    touched.push_back(c);
                                acc[(size_t)c] += v * pyz->val[(size_t)q];
                            }
                        }
                    }
                    /* emit row */
                    std::sort(touched.begin(), touched.end());
                    for (int32_t c : touched) {
                        double v = acc[(size_t)c] * invn;
                        acc[(size_t)c] = 0.0;
                        if (v >= cutoff) {
                            out.idx.push_back(c);
                            out.val.push_back((float)v);
                        }
                    }
                    touched.clear();
                    out.indptr[(size_t)i + 1] = (int64_t)out.idx.size();
                }
            }
        };
        int nt = nthreads > 0 ? nthreads : 4;
        std::vector<std::thread> pool;
        for (int t = 0; t < nt; t++) pool.emplace_back(worker);
        for (auto &th : pool) th.join();
    }
    Py_END_ALLOW_THREADS

    PyObject *res = PyList_New(P);
    if (!res) return NULL;
    for (npy_intp p = 0; p < P; p++) {
        CsrMat &m = outs[(size_t)p];
        npy_intp nr = m.rows + 1, ne = (npy_intp)m.idx.size();
        PyArrayObject *ip =
            (PyArrayObject *)PyArray_SimpleNew(1, &nr, NPY_INT64);
        PyArrayObject *ix =
            (PyArrayObject *)PyArray_SimpleNew(1, &ne, NPY_INT32);
        PyArrayObject *va =
            (PyArrayObject *)PyArray_SimpleNew(1, &ne, NPY_FLOAT32);
        if (!ip || !ix || !va) {
            Py_XDECREF(ip);
            Py_XDECREF(ix);
            Py_XDECREF(va);
            Py_DECREF(res);
            return NULL;
        }
        memcpy(PyArray_DATA(ip), m.indptr.data(), (size_t)nr * 8);
        if (ne) {
            memcpy(PyArray_DATA(ix), m.idx.data(), (size_t)ne * 4);
            memcpy(PyArray_DATA(va), m.val.data(), (size_t)ne * 4);
        }
        PyList_SET_ITEM(res, p, Py_BuildValue("NNN", ip, ix, va));
    }
    return res;
}

static PyMethodDef methods[] = {
    {"posterior", posterior, METH_VARARGS,
     "pair-HMM match posteriors (sparse) + expected-accuracy score"},
    {"posterior_dense", posterior_dense, METH_VARARGS,
     "pair-HMM posteriors from a precomputed [LA, LB] emission matrix"},
    {"ea_align", ea_align, METH_VARARGS,
     "NW over accumulated posterior scores, gap 0 -> ops"},
    {"transform", transform, METH_VARARGS,
     "consistency transform over all pair posteriors (threaded SpGEMM)"},
    {"group_score", group_score, METH_VARARGS,
     "dense scatter-add of cross-group posterior mass -> S [WA, WB]"},
    {NULL, NULL, 0, NULL}};

static struct PyModuleDef mod = {PyModuleDef_HEAD_INIT, "_pairhmm",
                                 "pair-HMM posterior kernels", -1,
                                 methods};

}  // namespace

PyMODINIT_FUNC PyInit__pairhmm(void) {
    import_array();
    return PyModule_Create(&mod);
}
