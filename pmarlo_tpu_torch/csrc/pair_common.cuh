// What the GB pair sweeps of pair_force.cu (dense blocks and the ordered
// culled walk) and pair_newton.cu (each unordered pair once) share: the
// launch arguments, the per-atom table's rows, the neck tables' load, and
// the Lennard-Jones + Coulomb terms. The pair epsilon is in gb_pair.cuh, the
// single-SFU pair functions of the sweeps in gb_force.cuh.
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
  // the items, 32 x 32 patches (rep * NG + g) * NG + h of NG = ceil(n / 32)
  // atom groups, then the groups' boxes (pair_newton.cu)
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

}  // namespace
