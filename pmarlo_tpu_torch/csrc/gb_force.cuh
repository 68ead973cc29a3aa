// The pair function of the GB force sweeps: dE/dr / r of one unordered pair,
// with both Born chain directions, for the dense block sweep and the ordered
// culled sweep of pair_force.cu and the Newton sweep of pair_newton.cu, so
// that all three compute the same pair function.
//
// It is the derivative that born_pair, neck_pair (gb_pair.cuh), gb_f and the
// LJ + Coulomb terms (pair_common.cuh) give, with every special function a
// single special-function-unit result (PTX .approx, flush-to-zero; the
// arguments are positive and far from denormal):
//   1/r and r           rsqrt.approx, r = s * (1/r)      (s = r^2 + 1e-12)
//   1/L, 1/U (HCT x 2)  rcp.approx
//   log(L/U) (HCT x 2)  lg2.approx * ln 2
//   exp(-r^2/4B_iB_j)   ex2.approx, 1/(B_i B_j) from the staged 1/B
//   1/f                 rsqrt.approx
//   1/denom (neck)      rcp.approx
// IEEE division, sqrtf, logf and expf compile to multi-instruction
// sequences on the FMA pipe; these ten results a pair cost one instruction
// each. Their effect, measured together by chip_smoke.py phase 6 on an H100
// (R=8, 3,726 atoms; PERF.md section 6): the whole evaluation's forces
// against a float64 evaluation read 4.57e-7 and 5.08e-7 of max |F| in two
// runs, the plain IEEE float32 evaluation 4.56e-7 and 5.08e-7, so none of
// them moves force_vs_float64 measurably; the force sweep against its IEEE
// plain version reads 1.34e-6 and 1.39e-6 (gate 1e-4).
// gb_pair.cuh keeps the IEEE forms: fused_md.cu includes it and its kernels
// stay as they are.
//
// A staged atom is three float4 (one 16-byte shared-memory load each):
//   p0 = (x, y, z, q), p1 = (sigma, sqrt(eps), rho, sr), p2 = (B, c, 1/B, meta)
// with meta the int bits of orig * 64 + class (orig: the caller's index, for
// the band mask; class: the GBn2 radius class, < kMaxClasses = 64).
#pragma once

#include "pair_common.cuh"

namespace {

__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rsqrt_approx(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float log_approx(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y * 0.6931471805599453f;
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

struct ForceAtom {
  float4 p0, p1, p2;
};

__device__ __forceinline__ int meta_orig(float meta) { return __float_as_int(meta) >> 6; }
__device__ __forceinline__ int meta_class(float meta) { return __float_as_int(meta) & 63; }

// stored atom j of replica row `rbase` (= rep * n) as the force sweeps stage it
__device__ __forceinline__ ForceAtom load_force_atom(const PairArgs& a, size_t rbase, int j) {
  const int n = a.n;
  const float* xj = a.x + (rbase + j) * 3;
  ForceAtom t;
  t.p0 = make_float4(xj[0], xj[1], xj[2], a.atom_p[kQ * n + j]);
  t.p1 = make_float4(a.atom_p[kSig * n + j], a.atom_p[kSeps * n + j], a.atom_p[kRho * n + j],
                     a.atom_p[kSr * n + j]);
  const float B = (a.use_gb && a.B) ? a.B[rbase + j] : 1.0f;
  const float c = (a.use_gb && a.chain) ? a.chain[rbase + j] : 0.0f;
  const int orig = a.orig ? a.orig[j] : j;
  t.p2 = make_float4(B, c, 1.0f / B, __int_as_float(orig * 64 + a.cls[j]));
  return t;
}

// dH/dr of the HCT term H(r; rho_i, sr_j) (born_pair's derivative), zero for
// an inactive pair; branch-free
__device__ __forceinline__ float hct_dr(float r, float inv_r, float inv_r2, float rho_i,
                                        float sr_j) {
  const float u = r + sr_j;
  const float diff = r - sr_j;
  const float absd = fabsf(diff);
  const bool use_rho = absd < rho_i;
  const float L = use_rho ? rho_i : absd;
  // rho_i > 0, so diff == 0 takes use_rho and dL = 0 as born_pair's sign does
  const float dL = use_rho ? 0.0f : copysignf(1.0f, diff);
  const float inv_L = rcp_approx(L);
  const float inv_U = rcp_approx(u);
  const float log_LU = log_approx(L * inv_U);
  const float sr2 = sr_j * sr_j;
  const float quad = r - sr2 * inv_r;
  const float dquad = 1.0f + sr2 * inv_r2;
  const float iL2 = inv_L * inv_L, iU2 = inv_U * inv_U;
  float dh = iU2 - dL * iL2 + 0.25f * dquad * (iU2 - iL2)
             + 0.5f * quad * (dL * iL2 * inv_L - iU2 * inv_U)
             - 0.5f * log_LU * inv_r2 + 0.5f * inv_r * (dL * inv_L - inv_U);
  // atom i engulfed by the descreening sphere of j
  dh = (sr_j - r > rho_i) ? dh + 2.0f * dL * iL2 : dh;
  return (u > rho_i) ? dh : 0.0f;
}

// r-derivative of the GBn2 neck integral m0s / (1 + 100 u^2 + 0.3e6 u^6)
__device__ __forceinline__ float neck_dr(float r, float d0, float m0s) {
  const float u = r - d0;
  const float u2 = u * u;
  const float inv_d = rcp_approx(1.0f + 100.0f * u2 + 0.3e6f * u2 * u2 * u2);
  return -m0s * (200.0f * u + 1.8e6f * u2 * u2 * u) * (inv_d * inv_d);
}

// W / r for the unordered pair (i, j) at s = r^2 + 1e-12: F_i -= (W / r) d,
// F_j += (W / r) d with d = x_i - x_j. W = dE/dr holds LJ + Coulomb (outside
// the index band), the direct GB term at fixed Born radii (both ordered
// directions) and the Born chain c_i dI_i/dr + c_j dI_j/dr.
__device__ __forceinline__ float force_pair(const PairArgs& a, const float* s_neck, float s,
                                            const ForceAtom& ai, const ForceAtom& aj) {
  const float inv_r = rsqrt_approx(s);
  const float r = s * inv_r;
  const float inv_r2 = inv_r * inv_r;
  const float qq = ai.p0.w * aj.p0.w;
  float W = 0.0f;
  if (abs(meta_orig(ai.p2.w) - meta_orig(aj.p2.w)) > a.band) {
    W = nb_dedr(lj_sr6(ai.p1.x, aj.p1.x, inv_r), ai.p1.y * aj.p1.y, a.ke, qq, inv_r);
  }
  if (a.use_gb) {
    // exp(-r^2 / (4 B_i B_j)) = 2^(-r^2 log2(e) / 4 * (1/B_i) (1/B_j))
    const float expu = exp2_approx(s * (-0.25f * 1.4426950408889634f) * (ai.p2.z * aj.p2.z));
    const float inv_f = rsqrt_approx(s + ai.p2.x * aj.p2.x * expu);
    W += (-(a.gb_pref * 2.0f * qq) * inv_f * inv_f) * (r * (1.0f - 0.25f * expu) * inv_f);
    float dI_ij = 0.5f * hct_dr(r, inv_r, inv_r2, ai.p1.z, aj.p1.w);
    float dI_ji = 0.5f * hct_dr(r, inv_r, inv_r2, aj.p1.z, ai.p1.w);
    if (a.use_neck) {
      // the class tables are symmetric (the wrapper checks): one neck
      // derivative serves both directions
      const int k = meta_class(ai.p2.w) * a.n_classes + meta_class(aj.p2.w);
      const float dnv = neck_dr(r, s_neck[k], s_neck[a.n_classes * a.n_classes + k]);
      dI_ij += dnv;
      dI_ji += dnv;
    }
    W += ai.p2.y * dI_ij + aj.p2.y * dI_ji;
  }
  return W * inv_r;
}

}  // namespace
