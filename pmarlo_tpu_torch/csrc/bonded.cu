// Bond, angle and periodic-torsion energies and their analytic gradient for
// large systems: each term once, then each atom's sum in a fixed order.
//
// Replaces: pmarlo_tpu/md/bonded_window.py build_bonded_window (its Pallas
// kernel gathers each term's atoms out of a 2 x stride coordinate window by
// one-hot matrix products, evaluates arccos by a polynomial and the
// torsion's cos/sin(n phi) by a Chebyshev recurrence, scatters gradients by
// the transposed products, and sends terms wider than a window to a gather
// fallback). None of that carries over: this card has indexed loads and
// acosf/atan2f, so a term may span any distance in index (no windows, no
// "far" terms, no fallback) and takes any periodicity n.
//
// What bounds it on an H100: bytes and latency, not arithmetic. The least
// work is each term once (~20-110 flops) with positions and term tables in
// and the gradient out, ~8.7 MB at the 61,824-atom assembly (PERF.md
// section 6). The design it replaces took one thread an atom walking the
// atom's (type, role, term) incidences and recomputing each whole term for
// its own share: ~3x the function's work, the three term types' branches
// one after another in a warp (neighbouring atoms are in different terms at
// the same step), and a chain of dependent gathers an incidence on ~15
// warps an SM.
//
// Design: two passes, no atomics, a launch is bit-reproducible.
// - bonded_term_kernel, one thread a term. The terms are laid out type-major
//   (bonds, then angles, then torsions), each type's range starting on a
//   warp boundary, so a warp never mixes types. A thread loads its term's
//   2-4 atoms once and computes the energy and every role's gradient from
//   one set of intermediates (bonded_terms.cuh bonded_term_all), and writes
//   role k's gradient to its slot: the incidence's position in the per-atom
//   CSR of (type, role, term) incidences (`slot_of`, the CSR's inverse map,
//   from the wrapper), one 16-byte store a role. The terms' energies are
//   summed in float64, over the CTA in a fixed order, into one partial a
//   CTA.
// - bonded_atom_kernel, one thread an atom, adds its CSR range of slots in
//   CSR order (type, then term, then role; one 16-byte load a slot) and
//   writes its gradient row: the order in which the one-pass design summed
//   an atom's shares. Its first warp adds the term pass's partials in a
//   fixed order into the energy. (Staging a CTA's slot range in shared
//   memory by coalesced loads was not faster on the H100: PERF.md section
//   6.)
// The slot buffer is (R, M) float4 (16.7 MB at M = 1,040,704), in L2.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bonded_terms.cuh"

namespace {

constexpr int kThreads = 128;

struct BondedArgs {
  const float* x;        // (R, N, 3)
  BondedTables tables;
  int n_bonds, n_angles, n_torsions;
  // term-pass threads: bonds at [0, angle0), angles at [angle0, torsion0),
  // torsions from torsion0 (each start a multiple of 32)
  int angle0, torsion0;
  const int* slot_of;    // (M,) CSR position of each incidence, terms type-major, roles in order
  const int* csr_ptr;    // (N + 1,) each atom's range of CSR positions
  float4* slots;         // (R, M) each incidence's gradient share (x, y, z, 0)
  float* grad;           // (R, N, 3) dE/dx
  // (R, P + 1): the energy of each of the term pass's P CTAs, then their sum
  double* partial;
  int n, m, term_ctas;
};

int round_up_warp(int k) { return (k + 31) / 32 * 32; }

__global__ void __launch_bounds__(kThreads) bonded_term_kernel(BondedArgs a) {
  __shared__ double s_red[kThreads / 32];
  const int t = blockIdx.x * kThreads + threadIdx.x;
  const size_t rep = blockIdx.y;
  // the term's type, index, width and first incidence (warp-uniform type)
  int type, term, width, first;
  if (t < a.angle0) {
    type = kBond;
    term = t;
    width = 2;
    first = 2 * term;
  } else if (t < a.torsion0) {
    type = kAngle;
    term = t - a.angle0;
    width = 3;
    first = 2 * a.n_bonds + 3 * term;
  } else {
    type = kTorsion;
    term = t - a.torsion0;
    width = 4;
    first = 2 * a.n_bonds + 3 * a.n_angles + 4 * term;
  }
  const int count = type == kBond ? a.n_bonds : (type == kAngle ? a.n_angles : a.n_torsions);
  double energy = 0.0;
  if (term < count) {
    float f[4][3];
    energy = bonded_term_all(a.tables, a.x + rep * a.n * 3, type, term, f);
    float4* out = a.slots + rep * a.m;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (k < width) out[a.slot_of[first + k]] = make_float4(-f[k][0], -f[k][1], -f[k][2], 0.0f);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) energy += __shfl_xor_sync(0xffffffffu, energy, o);
  if ((threadIdx.x & 31) == 0) s_red[threadIdx.x >> 5] = energy;
  __syncthreads();
  if (threadIdx.x == 0) {
    double e = 0.0;
    for (int w = 0; w < kThreads / 32; ++w) e += s_red[w];
    a.partial[rep * (a.term_ctas + 1) + blockIdx.x] = e;
  }
}

__global__ void __launch_bounds__(kThreads) bonded_atom_kernel(BondedArgs a) {
  const size_t rep = blockIdx.y;
  if (blockIdx.x == 0 && threadIdx.x < 32) {
    // the energy: lane l adds partials l, l + 32, ..., then a fixed tree
    double* p = a.partial + rep * (a.term_ctas + 1);
    double e = 0.0;
    for (int k = threadIdx.x; k < a.term_ctas; k += 32) e += p[k];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) e += __shfl_xor_sync(0xffffffffu, e, o);
    if (threadIdx.x == 0) p[a.term_ctas] = e;
  }
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.n) return;
  const float4* s = a.slots + rep * a.m;
  float g0 = 0.0f, g1 = 0.0f, g2 = 0.0f;
  for (int q = a.csr_ptr[i]; q < a.csr_ptr[i + 1]; ++q) {
    const float4 v = s[q];
    g0 += v.x;
    g1 += v.y;
    g2 += v.z;
  }
  float* g = a.grad + (rep * a.n + i) * 3;
  g[0] = g0;
  g[1] = g1;
  g[2] = g2;
}

}  // namespace

extern "C" {

// CTAs of the term pass a replica: `partial` is (R, this + 1)
int pmarlo_bonded_blocks(int n_bonds, int n_angles, int n_torsions) {
  const int threads = round_up_warp(n_bonds) + round_up_warp(n_angles) + round_up_warp(n_torsions);
  return (threads + kThreads - 1) / kThreads;
}

// dE/dx and the energy (`partial`'s last column) of R replicas; `slots` is
// (R, M, 4) float32 scratch, M = 2 n_bonds + 3 n_angles + 4 n_torsions
// incidences, and `slot_of` / `csr_ptr` the per-atom CSR's inverse map and
// ranges (md/bonded_window.py). Returns cudaGetLastError() after the two
// launches on `stream` (0 = launched).
int pmarlo_bonded(const float* x, const int* bond_i, const float* bond_p, const int* angle_i,
                  const float* angle_p, const int* tors_i, const float* tors_p, int n_bonds,
                  int n_angles, int n_torsions, const int* slot_of, const int* csr_ptr,
                  int n_replicas, int n_atoms, float4* slots, float* grad, double* partial,
                  void* stream) {
  const long long m = 2LL * n_bonds + 3LL * n_angles + 4LL * n_torsions;
  if (n_atoms < 1 || n_replicas < 1 || n_replicas > 65535 || n_bonds < 0 || n_angles < 0 ||
      n_torsions < 0 || m < 1 || m > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  BondedArgs a = {};
  a.x = x;
  a.tables.bond_i = bond_i;
  a.tables.bond_p = bond_p;
  a.tables.angle_i = angle_i;
  a.tables.angle_p = angle_p;
  a.tables.tors_i = tors_i;
  a.tables.tors_p = tors_p;
  a.n_bonds = n_bonds;
  a.n_angles = n_angles;
  a.n_torsions = n_torsions;
  a.angle0 = round_up_warp(n_bonds);
  a.torsion0 = a.angle0 + round_up_warp(n_angles);
  a.slot_of = slot_of;
  a.csr_ptr = csr_ptr;
  a.slots = slots;
  a.grad = grad;
  a.partial = partial;
  a.n = n_atoms;
  a.m = static_cast<int>(m);
  a.term_ctas = pmarlo_bonded_blocks(n_bonds, n_angles, n_torsions);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bonded_term_kernel<<<dim3(a.term_ctas, n_replicas), kThreads, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bonded_atom_kernel<<<dim3((n_atoms + kThreads - 1) / kThreads, n_replicas), kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
