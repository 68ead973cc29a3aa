// GB pair terms shared by the kernels of fused_md.cu and pair_force.cu:
// the HCT descreening integrand and the GBn2 neck correction, each with its
// r-derivative. Kept in one place so that every kernel integrates the same
// Born radii (the plain twins in md/analytic.py and md/pair_force.py spell
// out the same expressions).
#pragma once

namespace {

constexpr float kEps = 1e-12f;

// HCT descreening term H(r; rho_i, sr_j) and dH/dr, zero for inactive pairs
__device__ __forceinline__ void born_pair(float r, float inv_r, float rho_i, float sr_j,
                                          float* H, float* dH) {
  const float u_raw = r + sr_j;
  // negative (sulfur) screening can give U <= rho_i: the pair is inactive
  if (u_raw <= rho_i) {
    *H = 0.0f;
    *dH = 0.0f;
    return;
  }
  const float diff = r - sr_j;
  const float absd = fabsf(diff);
  const float sgn = (diff > 0.0f) ? 1.0f : ((diff < 0.0f) ? -1.0f : 0.0f);
  const bool use_rho = absd < rho_i;
  const float L = use_rho ? rho_i : absd;
  const float dL = use_rho ? 0.0f : sgn;
  const float inv_L = 1.0f / L;
  const float inv_U = 1.0f / u_raw;
  const float log_LU = logf(L * inv_U);
  const float quad = r - sr_j * sr_j * inv_r;
  float h = inv_L - inv_U + 0.25f * quad * (inv_U * inv_U - inv_L * inv_L) + 0.5f * log_LU * inv_r;
  const float dquad = 1.0f + sr_j * sr_j * (inv_r * inv_r);
  float dh = -dL * inv_L * inv_L + inv_U * inv_U
             + 0.25f * dquad * (inv_U * inv_U - inv_L * inv_L)
             + 0.25f * quad * (-2.0f * inv_U * inv_U * inv_U + 2.0f * dL * inv_L * inv_L * inv_L)
             - 0.5f * log_LU * inv_r * inv_r
             + 0.5f * inv_r * (dL * inv_L - inv_U);
  // atom i engulfed by the descreening sphere of j
  if ((sr_j - r) > rho_i) {
    h += 2.0f * (1.0f / rho_i - inv_L);
    dh += 2.0f * dL * inv_L * inv_L;
  }
  *H = h;
  *dH = dh;
}

// GBn2 neck integral m0s / (1 + 100 u^2 + 0.3e6 u^6), u = r - d0, and its
// r-derivative; m0s already carries the neck scale
__device__ __forceinline__ void neck_pair(float r, float d0, float m0s, float* val, float* dval) {
  const float u = r - d0;
  const float u2 = u * u;
  const float denom = 1.0f + 100.0f * u2 + 0.3e6f * u2 * u2 * u2;
  *val = m0s / denom;
  *dval = -m0s * (200.0f * u + 1.8e6f * u2 * u2 * u) / (denom * denom);
}

}  // namespace
