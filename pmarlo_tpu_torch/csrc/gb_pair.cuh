// The GBn2 neck correction in its IEEE form, with its r-derivative
// (fused_md.cu takes it; the single-SFU pair functions of the sweeps,
// gb_force.cuh, are written against it), and the pair epsilon. The HCT
// descreening term's IEEE form is the plain versions' (md/pair_force.py
// _hct, md/analytic.py born_radii_and_chain), which fused_md.cu's
// born_pair_sel and gb_force.cuh's hct_value and hct_dr follow.
#pragma once

namespace {

constexpr float kEps = 1e-12f;

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
