// Bond, angle and periodic-torsion energies and their analytic gradient for
// large systems, one thread an atom.
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
// What bounds it on an H100: bytes. It is a gather pass: every term's
// positions, indices and parameters are read once per atom of the term
// (mostly from L2: the terms of neighbouring atoms share their atoms), and a
// gradient row is written per atom. The arithmetic is ~100 flops a
// (term, atom) incidence.
//
// Design, as the bonded phase of fused_md.cu: the gradient is row-owned.
// Each atom walks a CSR list of the (type, role, term) incidences that touch
// it, recomputes the term from its atoms' positions (bonded_terms.cuh) and
// keeps its own share, so no two threads write one address: no atomics, a
// launch is bit-reproducible. A term's energy is counted where role == 0,
// summed in float64 per thread, then over the CTA in a fixed order, and
// written as one partial per CTA; the wrapper adds the partials.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bonded_terms.cuh"

namespace {

constexpr int kThreads = 128;

struct BondedArgs {
  const float* x;        // (R, N, 3)
  BondedTables tables;
  const int* csr_ptr;    // (N + 1,)
  const int* csr_ent;    // (M, 2): (type << 2 | role, term)
  float* grad;           // (R, N, 3) dE/dx
  double* partial;       // (R, gridDim.x) energy of each CTA's atoms' role-0 terms
  int n;
};

__global__ void __launch_bounds__(kThreads) bonded_kernel(BondedArgs a) {
  __shared__ double s_red[kThreads / 32];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const size_t rbase = static_cast<size_t>(blockIdx.y) * a.n;
  const float* xr = a.x + rbase * 3;
  double energy = 0.0;
  if (i < a.n) {
    float f[3] = {0.0f, 0.0f, 0.0f};
    for (int q = a.csr_ptr[i]; q < a.csr_ptr[i + 1]; ++q) {
      const int code = a.csr_ent[2 * q];
      bonded_term(a.tables, xr, code >> 2, code & 3, a.csr_ent[2 * q + 1], f, &energy);
    }
    float* g = a.grad + (rbase + i) * 3;
    g[0] = -f[0];
    g[1] = -f[1];
    g[2] = -f[2];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) energy += __shfl_xor_sync(0xffffffffu, energy, o);
  if ((threadIdx.x & 31) == 0) s_red[threadIdx.x >> 5] = energy;
  __syncthreads();
  if (threadIdx.x == 0) {
    double e = 0.0;
    for (int w = 0; w < kThreads / 32; ++w) e += s_red[w];
    a.partial[static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x] = e;
  }
}

}  // namespace

extern "C" {

// CTAs a replica: the second dimension of `partial`
int pmarlo_bonded_blocks(int n_atoms) { return (n_atoms + kThreads - 1) / kThreads; }

// Returns cudaGetLastError() after the launch on `stream` (0 = launched).
int pmarlo_bonded(const float* x, const int* bond_i, const float* bond_p, const int* angle_i,
                  const float* angle_p, const int* tors_i, const float* tors_p,
                  const int* csr_ptr, const int* csr_ent, int n_replicas, int n_atoms,
                  float* grad, double* partial, void* stream) {
  if (n_atoms < 1 || n_replicas < 1 || n_replicas > 65535) {
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
  a.csr_ptr = csr_ptr;
  a.csr_ent = csr_ent;
  a.grad = grad;
  a.partial = partial;
  a.n = n_atoms;
  const dim3 grid(pmarlo_bonded_blocks(n_atoms), n_replicas);
  bonded_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
