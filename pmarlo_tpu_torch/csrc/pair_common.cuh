// What the GB pair sweeps of pair_force.cu (dense blocks and row-owned
// tile-culled) and pair_newton.cu (each tile block once) share: the launch
// arguments, the per-atom table's rows, the neck tables' load, and the pair
// terms that are symmetric in (i, j) in their IEEE forms: Lennard-Jones +
// Coulomb and the GB f-function. The HCT and neck terms are in gb_pair.cuh,
// the single-SFU forms of the dense sweeps in gb_force.cuh.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "gb_pair.cuh"
#include "pair_r2.cuh"

namespace {

constexpr int kMaxClasses = 64;  // GBn2 radius classes

// rows of the per-atom parameter table (kAtomRows, N)
enum AtomRow { kQ = 0, kSig, kSeps, kRho, kSr, kAtomRows };

// which sweep, and how it walks the pairs
enum Sweep { kBorn = 0, kEnergy, kForce };
enum Mode { kDense = 0, kCulled, kNewton };

struct PairArgs {
  const float* x;        // (R, N, 3), storage order
  const float* atom_p;   // (kAtomRows, N): q, sigma, sqrt(eps), rho, sr
  const int* cls;        // (N,) radius-class index
  const int* orig;       // (N,) caller's index of each stored atom (band mask)
  const float* d0c;      // (C, C) neck d0
  const float* m0c;      // (C, C) neck m0 * neck scale
  const float* B;        // (R, N) Born radii
  const float* chain;    // (R, N) dE/dB dB/dpsi rho
  // (R, G, G) tile blocks to compute (box gap within the cutoff); null: all
  const uint8_t* close;
  float* out0;           // born: I; energy: dE/dB pair sum; force: F (R, N, 3)
  double* rows;          // energy: e_rows (R, N)
  // the dense sweeps' per-slot partials (R, G, N, K) of the sweep's slot
  // type, G = n_tiles (pair_force.cu)
  void* slots;
  // the Newton sweeps' work list: [0] items in it, [1] items taken, then
  // the items: blocks rep << 32 | r << 16 | c (Born, energy) or 32 x 32
  // patches (rep * NG + g) * NG + h (force)
  unsigned long long* work;
  int n;
  int n_classes;
  int band;
  int tile;              // atoms a tile (dense force, culled and Newton sweeps)
  int n_tiles;           // G = ceil(n / tile)
  // pair terms vanish where r^2 + 1e-12 > cut_r2 (has_cut): the wrapper's
  // largest float32 whose root is within the cutoff, so the test decides as
  // sqrt(r^2 + 1e-12) <= cutoff would and a pair that is cut costs no root
  float cut_r2;
  int has_cut;
  float ke;
  float gb_pref;
  int use_gb;
  int use_neck;
};

// loads the (C, C) neck tables into shared memory: d0 then m0s
__device__ __forceinline__ void load_neck(const PairArgs& a, float* s_neck, int tid, int threads) {
  const int cc = a.n_classes * a.n_classes;
  for (int k = tid; k < 2 * cc; k += threads) {
    s_neck[k] = (k < cc) ? a.d0c[k] : a.m0c[k - cc];
  }
}

// (sigma_ij / r)^6 with the Lorentz mean of the two sigmas
__device__ __forceinline__ float lj_sr6(float sig_i, float sig_j, float inv_r) {
  const float s = 0.5f * (sig_i + sig_j) * inv_r;
  const float s2 = s * s;
  return s2 * s2 * s2;
}

// dE/dr of the LJ + Coulomb energy of the unordered pair; eps = sqrt(eps_i) sqrt(eps_j)
__device__ __forceinline__ float nb_dedr(float sr6, float eps, float ke, float qq, float inv_r) {
  return 4.0f * eps * (-12.0f * sr6 * sr6 + 6.0f * sr6) * inv_r - ke * qq * inv_r * inv_r;
}

// GB f-function: exp(-r^2 / 4 B_i B_j) and 1 / sqrt(r^2 + B_i B_j exp(.))
__device__ __forceinline__ void gb_f(float rsq, float BB, float* expu, float* inv_f) {
  *expu = expf(-rsq / (4.0f * BB));
  *inv_f = 1.0f / sqrtf(rsq + BB * (*expu));
}

// d(1/f energy)/dB_i of the ordered pair: dE/df * df/dB_i
__device__ __forceinline__ float gb_dedb(float qq_gb, float inv_f, float expu, float rsq,
                                         float B_i, float B_j) {
  return (-qq_gb * inv_f * inv_f) * (expu * (B_j + rsq / (4.0f * B_i)) * (0.5f * inv_f));
}

// The energy one pair adds to each of its two atoms' rows, 0.5 e_nb + e_gb
// (LJ + Coulomb outside the index band, `nonbonded`, and the GB cross
// term), with IEEE special functions, for the culled and Newton energy
// sweeps; the charge product is factored out of Coulomb + GB as the dense
// sweep's energy_pair (gb_force.cuh) does, which says why. *dedb_i and
// *dedb_j: d(e_gb)/dB of each atom, the ordered quantity.
__device__ __forceinline__ float pair_energy_ieee(float ke, float gb_pref, bool use_gb, float r,
                                                  float inv_r, float qq, float sig_i, float sig_j,
                                                  float eps, float B_i, float B_j, bool nonbonded,
                                                  float* dedb_i, float* dedb_j) {
  float e = 0.0f, w = 0.0f;   // LJ / 2, and the pair's Coulomb + GB energy over qq
  if (nonbonded) {
    const float sr6 = lj_sr6(sig_i, sig_j, inv_r);
    e = 2.0f * eps * (sr6 * sr6 - sr6);
    w = (0.5f * ke) * inv_r;
  }
  *dedb_i = *dedb_j = 0.0f;
  if (use_gb) {
    const float rsq = r * r;
    float expu, inv_f;
    gb_f(rsq, B_i * B_j, &expu, &inv_f);
    w += gb_pref * inv_f;
    const float qq_gb = gb_pref * qq;
    *dedb_i = gb_dedb(qq_gb, inv_f, expu, rsq, B_i, B_j);
    *dedb_j = gb_dedb(qq_gb, inv_f, expu, rsq, B_j, B_i);
  }
  return e + qq * w;
}

// direct GB dE/dr at fixed Born radii, both ordered directions
__device__ __forceinline__ float gb_dedr(float gb_pref, float qq, float r, float inv_f,
                                         float expu) {
  return (-(gb_pref * 2.0f * qq) * inv_f * inv_f) * (r * (1.0f - 0.25f * expu) * inv_f);
}

}  // namespace
