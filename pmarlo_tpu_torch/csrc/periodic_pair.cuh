// The periodic nonbonded pair term shared by periodic_force.cu and
// cell_force.cu: potential-shifted or switched Lennard-Jones plus
// reaction-field Coulomb (OpenMM CutoffPeriodic) or the shifted real-space
// Ewald term, with dE/dr. One function, so the dense sweep and the
// cell-list sweep compute the same physics, and so each kernel's force is
// the exact gradient of that kernel's energy (the plain twins in
// md/periodic_force.py spell out the same expressions).
#pragma once

namespace {

// -2 / sqrt(pi): d erfc(x) / dx = kErfcSlope * exp(-x^2)
constexpr float kErfcSlope = -1.1283791670955126f;

struct PairPhys {
  float rc2;      // cutoff^2: a pair interacts when r^2 < rc2
  float inv_rc;   // 1 / cutoff (the LJ potential shift)
  float ke;       // Coulomb constant / solute dielectric
  float k_rf;     // reaction field: ke q q (1/r + k_rf r^2 - c_rf)
  float c_rf;
  float alpha;    // Ewald: ke q q (erfc(alpha r)/r - shift_c)
  float shift_c;  // erfcf(alpha rc) / rc, from this library's erfcf
  float r_sw;     // LJ switch distance
  float inv_w;    // 1 / (cutoff - r_sw)
  int ewald;      // 0: reaction field, 1: real-space Ewald
  int use_switch; // 0: shifted LJ, 1: unshifted LJ times the quintic switch
};

// r^2 of a displacement, each product and sum rounded on its own (no fused
// multiply-add): (dx dx + dy dy) + dz dz in float32 as plain PyTorch
// computes it. The potential is only shifted at the cutoff, so its force
// jumps there (up to ~2 kJ/mol/nm for a pair of water oxygens); with r^2
// reproducible, the kernel and its plain twin cut the same pairs.
__device__ __forceinline__ float pair_r2(float dx, float dy, float dz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// phys (host memory): rc, ke, k_rf, c_rf, alpha, shift_c, r_sw (a negative
// r_sw: no switch)
inline PairPhys make_pair_phys(const float* phys, int ewald) {
  PairPhys p = {};
  const float rc = phys[0];
  p.rc2 = rc * rc;
  p.inv_rc = 1.0f / rc;
  p.ke = phys[1];
  p.k_rf = phys[2];
  p.c_rf = phys[3];
  p.alpha = phys[4];
  p.shift_c = phys[5];
  p.use_switch = phys[6] >= 0.0f;
  p.r_sw = phys[6];
  p.inv_w = p.use_switch ? 1.0f / (rc - phys[6]) : 0.0f;
  p.ewald = ewald;
  return p;
}

// Energy of the unordered pair (double: the charge product is exact and
// the row sums cancel to ~1e-3 of their terms) and W = (dE/dr) / r, so that
// the force on i is -W (x_i - x_j). sig = (sig_i + sig_j) / 2,
// eps = sqrt(eps_i) sqrt(eps_j). The caller has checked r2 < rc2.
__device__ __forceinline__ void periodic_pair(const PairPhys& p, float r2, float q_i, float q_j,
                                              float sig, float eps, double* e, float* w) {
  const float inv_r = rsqrtf(r2 + 1e-12f);
  const float r = r2 * inv_r;
  const float s = sig * inv_r;
  const float s2 = s * s;
  const float sr6 = s2 * s2 * s2;
  const float lj = 4.0f * eps * (sr6 * sr6 - sr6);
  float e_lj;
  float w_lj = 4.0f * eps * (-12.0f * sr6 * sr6 + 6.0f * sr6) * inv_r;
  if (p.use_switch) {
    float x = (r - p.r_sw) * p.inv_w;
    x = fminf(fmaxf(x, 0.0f), 1.0f);
    const float sw = 1.0f + x * x * x * (-10.0f + x * (15.0f - x * 6.0f));
    const float dsw = x * x * (-30.0f + x * (60.0f - x * 30.0f)) * p.inv_w;
    e_lj = lj * sw;
    w_lj = w_lj * sw + lj * dsw;   // product rule: the S' term
  } else {
    const float c = sig * p.inv_rc;
    const float c2 = c * c;
    const float sr6c = c2 * c2 * c2;
    e_lj = lj - 4.0f * eps * (sr6c * sr6c - sr6c);
  }
  const float qq = q_i * q_j;
  float bracket, w_el;
  if (p.ewald) {
    const float ar = p.alpha * r;
    const float erfc_ar = erfcf(ar);
    const float derfc = kErfcSlope * expf(-ar * ar);
    bracket = erfc_ar * inv_r - p.shift_c;
    w_el = p.ke * qq * inv_r * (p.alpha * derfc - erfc_ar * inv_r);
  } else {
    bracket = inv_r + p.k_rf * r * r - p.c_rf;
    w_el = p.ke * qq * (-inv_r * inv_r + 2.0f * p.k_rf * r);
  }
  *e = static_cast<double>(e_lj) +
       static_cast<double>(q_i) * static_cast<double>(q_j) * static_cast<double>(p.ke * bracket);
  *w = (w_lj + w_el) * inv_r;
}

}  // namespace
