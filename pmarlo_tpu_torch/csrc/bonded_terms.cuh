// Bond, angle and periodic-torsion terms as one atom sees them: the force
// on the atom in `role` of a term, and the term's energy where role == 0.
// Shared by the fused Langevin kernels (fused_md.cu, positions in shared
// memory) and the bonded kernel (bonded.cu, positions in global memory), so
// both evaluate the expressions of pmarlo_tpu_torch/md/analytic.py: general
// torsions k (1 + cos(n phi - gamma)) through atan2f in the IUPAC sign,
// angles through acosf with cos(theta) clipped to +-(1 - 1e-7) and
// sin(theta) >= 1e-6.
#pragma once

namespace {

constexpr float kBondedEps = 1e-12f;

enum TermType { kBond = 0, kAngle = 1, kTorsion = 2 };

struct BondedTables {
  const int* bond_i;        // (NB, 2)
  const float* bond_p;      // (NB, 2): k, r0
  const int* angle_i;       // (NA, 3)
  const float* angle_p;     // (NA, 2): k, theta0
  const int* tors_i;        // (NT, 4)
  const float* tors_p;      // (NT, 3): k, n, phase
};

__device__ __forceinline__ float dot3(const float a[3], const float b[3]) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

__device__ __forceinline__ void cross3(const float a[3], const float b[3], float c[3]) {
  c[0] = a[1] * b[2] - a[2] * b[1];
  c[1] = a[2] * b[0] - a[0] * b[2];
  c[2] = a[0] * b[1] - a[1] * b[0];
}

__device__ __forceinline__ void load3(const float* sx, int atom, float p[3]) {
  p[0] = sx[3 * atom];
  p[1] = sx[3 * atom + 1];
  p[2] = sx[3 * atom + 2];
}

// force on the atom in `role` of bonded term `term`; energy when role == 0
template <typename Energy>
__device__ void bonded_term(const BondedTables& a, const float* sx, int type, int role,
                            int term, float f[3], Energy* e) {
  if (type == kBond) {
    float p1[3], p2[3], d[3];
    load3(sx, a.bond_i[2 * term], p1);
    load3(sx, a.bond_i[2 * term + 1], p2);
    for (int c = 0; c < 3; ++c) d[c] = p1[c] - p2[c];
    const float k = a.bond_p[2 * term], r0 = a.bond_p[2 * term + 1];
    const float r = sqrtf(dot3(d, d) + kBondedEps);
    const float dr = r - r0;
    const float s = (role == 0 ? -1.0f : 1.0f) * k * dr / r;
    for (int c = 0; c < 3; ++c) f[c] += s * d[c];
    if (role == 0) *e += 0.5f * k * dr * dr;
  } else if (type == kAngle) {
    float pi[3], pj[3], pk[3], u[3], w[3];
    load3(sx, a.angle_i[3 * term], pi);
    load3(sx, a.angle_i[3 * term + 1], pj);
    load3(sx, a.angle_i[3 * term + 2], pk);
    for (int c = 0; c < 3; ++c) {
      u[c] = pi[c] - pj[c];
      w[c] = pk[c] - pj[c];
    }
    const float k = a.angle_p[2 * term], t0 = a.angle_p[2 * term + 1];
    const float lu = sqrtf(dot3(u, u) + kBondedEps);
    const float lw = sqrtf(dot3(w, w) + kBondedEps);
    float nu[3], nw[3];
    for (int c = 0; c < 3; ++c) {
      nu[c] = u[c] / lu;
      nw[c] = w[c] / lw;
    }
    const float cos_t = fminf(fmaxf(dot3(nu, nw), -1.0f + 1e-7f), 1.0f - 1e-7f);
    const float theta = acosf(cos_t);
    const float sin_t = sqrtf(fmaxf(1.0f - cos_t * cos_t, 1e-12f));
    const float dE = k * (theta - t0);
    float fi[3], fk[3];
    for (int c = 0; c < 3; ++c) {
      fi[c] = -dE * (cos_t * nu[c] - nw[c]) / (lu * sin_t);
      fk[c] = -dE * (cos_t * nw[c] - nu[c]) / (lw * sin_t);
    }
    for (int c = 0; c < 3; ++c) {
      f[c] += role == 0 ? fi[c] : (role == 2 ? fk[c] : -(fi[c] + fk[c]));
    }
    if (role == 0) *e += 0.5f * k * (theta - t0) * (theta - t0);
  } else {
    float x1[3], x2[3], x3[3], x4[3], b1[3], b2[3], b3[3], m[3], n[3], mn[3];
    load3(sx, a.tors_i[4 * term], x1);
    load3(sx, a.tors_i[4 * term + 1], x2);
    load3(sx, a.tors_i[4 * term + 2], x3);
    load3(sx, a.tors_i[4 * term + 3], x4);
    for (int c = 0; c < 3; ++c) {
      b1[c] = x2[c] - x1[c];
      b2[c] = x3[c] - x2[c];
      b3[c] = x4[c] - x3[c];
    }
    cross3(b1, b2, m);
    cross3(b2, b3, n);
    const float lb2 = sqrtf(dot3(b2, b2) + kBondedEps);
    const float m2 = dot3(m, m) + kBondedEps;
    const float n2 = dot3(n, n) + kBondedEps;
    // IUPAC sign: phi = atan2((m x n) . b2 / |b2|, m . n)
    cross3(m, n, mn);
    const float yy = dot3(mn, b2) / lb2;
    const float xx = dot3(m, n);
    const float phi = atan2f(yy, xx);
    const float k = a.tors_p[3 * term], per = a.tors_p[3 * term + 1];
    const float phase = a.tors_p[3 * term + 2];
    const float arg = per * phi - phase;
    const float dE = -k * per * sinf(arg);
    const float s12 = dot3(b1, b2) / (lb2 * lb2);
    const float s32 = dot3(b3, b2) / (lb2 * lb2);
    for (int c = 0; c < 3; ++c) {
      const float d1 = -(lb2 / m2) * m[c];
      const float d4 = (lb2 / n2) * n[c];
      float d;
      if (role == 0) d = d1;
      else if (role == 1) d = -(1.0f + s12) * d1 + s32 * d4;
      else if (role == 2) d = s12 * d1 - (1.0f + s32) * d4;
      else d = d4;
      f[c] += -dE * d;
    }
    if (role == 0) *e += k * (1.0f + cosf(arg));
  }
}

}  // namespace
