// The pair functions of the GB sweeps that take special functions as single
// special-function-unit results: force_pair, dE/dr / r of one unordered pair
// with both Born chain directions, for the dense block sweep and the ordered
// culled sweep of pair_force.cu and the Newton sweep of pair_newton.cu, so
// that all three compute the same pair function; and born_pair_values and
// energy_pair, one unordered pair's Born and energy terms, for the dense
// block sweeps and (the row atom's share) the ordered culled sweeps of
// pair_force.cu and the Newton sweeps of pair_newton.cu (at the end of this
// file).
//
// force_pair is the derivative that the HCT term (md/pair_force.py _hct),
// the GBn2 neck term (md/gbn2.py), the GB f-function and the LJ + Coulomb terms
// (pair_common.cuh) give, with every special function a single
// special-function-unit result (PTX .approx,
// flush-to-zero; the arguments are positive and far from denormal):
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
// plain version reads 1.34e-6 and 1.39e-6 (gate 1e-4). The fused kernels
// (fused_md.cu) take the same single results but for IEEE logf.
//
// A force-sweep atom is three float4 (one 16-byte shared-memory load each):
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

// dH/dr of the HCT term H(r; rho_i, sr_j) (_hct's derivative), zero for
// an inactive pair; branch-free
__device__ __forceinline__ float hct_dr(float r, float inv_r, float inv_r2, float rho_i,
                                        float sr_j) {
  const float u = r + sr_j;
  const float diff = r - sr_j;
  const float absd = fabsf(diff);
  const bool use_rho = absd < rho_i;
  const float L = use_rho ? rho_i : absd;
  // rho_i > 0, so diff == 0 takes use_rho and dL = 0 as _hct's sign does
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

// ---- the dense and Newton Born and energy sweeps' pair functions ----
// Each is its IEEE counterpart (_hct's and the neck term's values, the
// plain version's energy_pair_terms in md/pair_force.py) term by term, with the special
// functions of force_pair: 1/r from one rsqrt.approx (the energy terms need
// no r: r^2 is s), 1/L, 1/U and 1/denom by rcp.approx, exp by ex2.approx
// with the staged 1/B, 1/f by rsqrt.approx, and the per atom 1/rho staged;
// the HCT value's log alone is IEEE logf (hct_value says why). Two
// rearrangements, exact in real arithmetic, keep
// float32 rounding from adding up over a protein's millions of pairs (a far
// pair's HCT value as a series, Coulomb + GB with the charge product
// factored out: at each function). The plain versions (md/pair_force.py
// _hct, _neck, energy_pair_terms) keep the row-owned forms. A staged atom
// is two float4, one shared load fewer a pair than the force sweep's
// three:
//   Born:   p0 = (x, y, z, rho), p1 = (sr, 1/rho, class bits, 0)
//   energy: p0 = (x, y, z, q),   p1 = (sigma, sqrt(eps), B, 1/B)
// The dense path stores atoms in the caller's order, so the energy sweep's
// band mask keys on the atoms' indices and needs no staged index; the
// Newton and the ordered culled energy sweeps (Morton order) keep each
// atom's original index in a register and decide the band when they queue
// a pair (pair_newton.cu) or run it (pair_force.cu).
struct BornAtom {
  float4 p0, p1;
};
struct EnergyAtom {
  float4 p0, p1;
};

// stored atom j of replica row `rbase` (= rep * n) as the Born sweeps stage it
__device__ __forceinline__ BornAtom load_born_atom(const PairArgs& a, size_t rbase, int j) {
  const float* xj = a.x + (rbase + j) * 3;
  const float rho = a.atom_p[kRho * a.n + j];
  BornAtom t;
  t.p0 = make_float4(xj[0], xj[1], xj[2], rho);
  t.p1 = make_float4(a.atom_p[kSr * a.n + j], 1.0f / rho, __int_as_float(a.cls[j]), 0.0f);
  return t;
}

// the same for the energy sweeps
__device__ __forceinline__ EnergyAtom load_energy_atom(const PairArgs& a, size_t rbase, int j) {
  const int n = a.n;
  const float* xj = a.x + (rbase + j) * 3;
  const float B = (a.use_gb && a.B) ? a.B[rbase + j] : 1.0f;
  EnergyAtom t;
  t.p0 = make_float4(xj[0], xj[1], xj[2], a.atom_p[kQ * n + j]);
  t.p1 = make_float4(a.atom_p[kSig * n + j], a.atom_p[kSeps * n + j], B, 1.0f / B);
  return t;
}

// H(r; rho_i, sr_j) of _hct, zero for an inactive pair.
//
// Far pairs (|t| <= 0.3 with t = sr_j / r, and r - sr_j >= rho_i, so that
// L = r - sr_j, U = r + sr_j): _hct's terms cancel to ~1e-3 of each
// (1/L - 1/U ~ 0.06 against an H of ~1e-4 at 2 nm), so the errors of the
// single SFU results (rcp.approx up to 1 ulp, lg2.approx ~1e-7 absolute)
// add up over the thousands of far partners of an atom, and I feeds the
// Born radii, the self energies and every force. There the same terms are
// summed in closed form: with
// L = r (1 - t), U = r (1 + t),
//   1/L - 1/U = 2t / (r (1 - t^2)),  (r - sr^2/r)/4 (1/U^2 - 1/L^2) = -t / (r (1 - t^2)),
//   log(L/U) / (2r) = -atanh(t) / r,
// so H = (t / (1 - t^2) - atanh t) / r = (t^3 / r) sum_k>=1 2k/(2k+1) t^(2k-2),
// eight terms (the next is < 1e-8 of the sum at |t| = 0.3), no special
// function and no cancellation. t < 0 (negative screening) is the same
// series. Near pairs take _hct's form with rcp.approx for 1/L and 1/U
// and IEEE logf for log(L/U): lg2.approx's error does not average out over
// the near pairs. With a cutoff 12% of the directions inside it are near
// (0.8% of all at 3,726 atoms without one), and with lg2.approx
// chip_smoke.py phase 15 on an H100 (24,840 atoms, cutoff 1.5 nm) read the
// Newton evaluation's total energy 4.0e-6 to 8.8e-6 from its plain
// version's in two development runs, against a gate of 1e-5 (PERF.md
// section 6 has the readings with logf, and the Born kernel's share of
// them). The engulfed and inactive branches are selects (the discarded
// h may be NaN where U <= 0: a select, not a product).
__device__ __forceinline__ float hct_value(float r, float inv_r, float rho_i, float inv_rho_i,
                                           float sr_j) {
  const float u = r + sr_j;
  const float t = sr_j * inv_r;
  if (fabsf(t) <= 0.3f && r - sr_j >= rho_i) {
    const float t2 = t * t;
    float q = 16.0f / 17;
    q = q * t2 + 14.0f / 15;
    q = q * t2 + 12.0f / 13;
    q = q * t2 + 10.0f / 11;
    q = q * t2 + 8.0f / 9;
    q = q * t2 + 6.0f / 7;
    q = q * t2 + 4.0f / 5;
    q = q * t2 + 2.0f / 3;
    // negative (sulfur) screening can give U <= rho_i: the pair is inactive
    return (u > rho_i) ? t2 * t * inv_r * q : 0.0f;
  }
  const float absd = fabsf(r - sr_j);
  const float L = absd < rho_i ? rho_i : absd;
  const float inv_L = rcp_approx(L);
  const float inv_U = rcp_approx(u);
  const float log_LU = logf(L * inv_U);
  const float quad = r - sr_j * sr_j * inv_r;
  float h = inv_L - inv_U + 0.25f * quad * (inv_U * inv_U - inv_L * inv_L) + 0.5f * log_LU * inv_r;
  // atom i engulfed by the descreening sphere of j
  h = (sr_j - r > rho_i) ? h + 2.0f * (inv_rho_i - inv_L) : h;
  return (u > rho_i) ? h : 0.0f;
}

struct BornPair {
  float h_ij, h_ji, neck;   // H(r; rho_i, sr_j), H(r; rho_j, sr_i), the neck value
};

// one unordered pair's Born terms at s = r^2 + 1e-12: I_i gains h_ij / 2 +
// neck, I_j gains h_ji / 2 + neck (the class tables are symmetric, the
// wrapper checks: one neck value serves both directions)
__device__ __forceinline__ BornPair born_pair_values(const PairArgs& a, const float* s_neck,
                                                     float s, const BornAtom& ai,
                                                     const BornAtom& aj) {
  const float inv_r = rsqrt_approx(s);
  const float r = s * inv_r;
  BornPair p;
  p.h_ij = hct_value(r, inv_r, ai.p0.w, ai.p1.y, aj.p1.x);
  p.h_ji = hct_value(r, inv_r, aj.p0.w, aj.p1.y, ai.p1.x);
  p.neck = 0.0f;
  if (a.use_neck) {
    const int k = meta_class(ai.p1.z) * a.n_classes + meta_class(aj.p1.z);
    const float u = r - s_neck[k];
    const float u2 = u * u;
    p.neck = s_neck[a.n_classes * a.n_classes + k] *
             rcp_approx(1.0f + 100.0f * u2 + 0.3e6f * u2 * u2 * u2);
  }
  return p;
}

struct EnergyPair {
  float e;                // added to both atoms' rows: 0.5 e_nb + e_gb
  float dedb_i, dedb_j;   // d(e_gb)/dB of each atom, the ordered quantity
};

// one unordered pair's energy terms at s = r^2 + 1e-12; `nonbonded`: the
// pair lies outside the index band (LJ + Coulomb counted).
//
// The charge product is taken out of Coulomb + GB: e = qq (ke/(2r) +
// gb_pref/f) + LJ/2. Far apart, the GB cross term screens ~99% of the
// Coulomb term, and both are sums of ~1e5-1e6 kJ/mol over the pairs of a
// protein whose rows total ~8e4. Rounded apart, ke qq and gb_pref qq carry
// float32 rounding errors that repeat for every pair of the same two atom
// types (a few dozen charges), so they add up instead of averaging out,
// against a total energy of ~1% of the components. Factored, the
// cancellation happens in the per-pair factor and the repeated rounding of
// qq scales only what is left of it. The Newton and the ordered culled
// energy sweeps take this function too: chip_smoke.py phase 15 holds both to
// the dense sweeps with a cutoff beyond every pair.
__device__ __forceinline__ EnergyPair energy_pair(const PairArgs& a, float s, const EnergyAtom& ai,
                                                  const EnergyAtom& aj, bool nonbonded) {
  const float inv_r = rsqrt_approx(s);
  const float qq = ai.p0.w * aj.p0.w;
  EnergyPair p = {0.0f, 0.0f, 0.0f};
  float w = 0.0f;   // the pair's energy over qq
  if (nonbonded) {
    const float sr6 = lj_sr6(ai.p1.x, aj.p1.x, inv_r);
    p.e = 2.0f * (ai.p1.y * aj.p1.y) * (sr6 * sr6 - sr6);   // LJ / 2
    w = (0.5f * a.ke) * inv_r;
  }
  if (a.use_gb) {
    // exp(-r^2 / (4 B_i B_j)) as force_pair takes it
    const float expu = exp2_approx(s * (-0.25f * 1.4426950408889634f) * (ai.p1.w * aj.p1.w));
    const float inv_f = rsqrt_approx(s + ai.p1.z * aj.p1.z * expu);
    w += a.gb_pref * inv_f;
    // gb_dedb: (-qq_gb / f^2) expu (B_j + r^2 / (4 B_i)) / (2 f), and with i, j swapped
    const float qq_gb = a.gb_pref * qq;
    const float g = (-qq_gb * inv_f * inv_f) * (expu * (0.5f * inv_f));
    p.dedb_i = g * (aj.p1.z + s * (0.25f * ai.p1.w));
    p.dedb_j = g * (ai.p1.z + s * (0.25f * aj.p1.w));
  }
  p.e += qq * w;
  return p;
}

}  // namespace
