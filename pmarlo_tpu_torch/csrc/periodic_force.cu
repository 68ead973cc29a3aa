// Dense minimum-image sweep for explicit solvent: energy rows and forces of
// the periodic LJ + reaction-field potential in one pass over all pairs.
//
// Replaces: pmarlo_tpu/md/pallas_periodic.py build_periodic_force_fn, its
// one Pallas sweep (kernel at :98, pallas_call at :190). The TPU kernel
// streamed (N, N) exclusion-scale tiles; here LJ and Coulomb are masked
// for |i - j| <= band (an index band that covers every exclusion and 1-4
// pair of a residue, waters included) and md/periodic_force.py adds the
// band and the far scaled pairs back at their wanted value from the pair
// lists, so nothing of size N^2 is stored. The bonded terms are plain
// PyTorch in the wrapper, which also holds this sweep's plain twin.
//
// What bounds it on an H100: arithmetic. A sweep is R * N^2 ordered
// candidate pairs (solvated chignolin, R = 8, N = 2,315: 43 M); a pair
// inside the cutoff costs ~50 float32 operations and one rsqrt, one
// outside ~15. Positions and three per-atom rows are O(N) and stay in L2.
//
// Design (the shape of pair_force.cu):
// - grid (row tiles, replicas); a CTA owns kRows row atoms and has
//   kRows x kSplit threads: thread (tx, ty) owns row atom tx and the
//   columns ty, ty + kSplit, ... of each staged column tile. The kSplit
//   partial sums of a row are added in a fixed order through shared memory:
//   no atomics, a launch is bit-reproducible.
// - column tiles of kThreads atoms in shared memory, structure-of-arrays.
// - orthorhombic minimum image per axis, d - L * rintf(d / L): rintf rounds
//   half to even, as jnp.round does, so a pair at exactly L / 2 picks the
//   same image as the reference. The image and r^2 are computed without
//   fused multiply-adds (periodic_pair.cuh pair_r2), so the plain twin
//   reproduces them bit for bit and decides the cutoff on the same number.
// - energy and force come from one function (periodic_pair.cuh), so the
//   force is the exact gradient of the energy. Energy rows accumulate in
//   float64 and are written as float64 (the Coulomb terms of a water box
//   cancel to ~1e-3 of their magnitudes); forces keep float32 sums.
// - the ragged last row tile and column tile are masked in the kernel; no
//   padding atoms exist, and the self pair falls inside the band.

#include <cuda_runtime.h>
#include <stdint.h>

#include "periodic_pair.cuh"

namespace {

constexpr int kRows = 32;                 // row atoms a CTA
constexpr int kSplit = 8;                 // column lanes a row
constexpr int kThreads = kRows * kSplit;  // threads a CTA = column tile

struct PeriodicArgs {
  const float* x;       // (R, N, 3)
  const float* atom_p;  // (3, N): q, sigma, sqrt(eps)
  double* e_rows;       // (R, N) half-summed row energies
  float* forces;        // (R, N, 3)
  int n;
  int band;
  float box[3];
  PairPhys p;
};

__global__ void __launch_bounds__(kThreads) periodic_force_kernel(PeriodicArgs a) {
  __shared__ float s_x[kThreads], s_y[kThreads], s_z[kThreads];
  __shared__ float s_q[kThreads], s_sig[kThreads], s_seps[kThreads];
  __shared__ double s_e[kSplit][kRows];
  __shared__ float s_f[3][kSplit][kRows];
  const int n = a.n;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kRows + tx;
  const int i = blockIdx.x * kRows + tx;
  const bool own = i < n;
  const size_t rbase = static_cast<size_t>(blockIdx.y) * n;
  const float* xr = a.x + rbase * 3;
  const float bx = a.box[0], by = a.box[1], bz = a.box[2];
  const float inv_bx = 1.0f / bx, inv_by = 1.0f / by, inv_bz = 1.0f / bz;

  float xi = 0.0f, yi = 0.0f, zi = 0.0f, q_i = 0.0f, sig_i = 0.0f, seps_i = 0.0f;
  if (own) {
    xi = xr[3 * i];
    yi = xr[3 * i + 1];
    zi = xr[3 * i + 2];
    q_i = a.atom_p[i];
    sig_i = a.atom_p[n + i];
    seps_i = a.atom_p[2 * n + i];
  }
  double e_acc = 0.0;
  float fx = 0.0f, fy = 0.0f, fz = 0.0f;
  for (int t0 = 0; t0 < n; t0 += kThreads) {
    __syncthreads();
    const int j = t0 + tid;
    if (j < n) {
      s_x[tid] = xr[3 * j];
      s_y[tid] = xr[3 * j + 1];
      s_z[tid] = xr[3 * j + 2];
      s_q[tid] = a.atom_p[j];
      s_sig[tid] = a.atom_p[n + j];
      s_seps[tid] = a.atom_p[2 * n + j];
    }
    __syncthreads();
    const int cnt = min(kThreads, n - t0);
    if (!own) continue;
    for (int jj = ty; jj < cnt; jj += kSplit) {
      if (abs(i - (t0 + jj)) <= a.band) continue;
      float dx = xi - s_x[jj], dy = yi - s_y[jj], dz = zi - s_z[jj];
      dx = __fsub_rn(dx, __fmul_rn(bx, rintf(__fmul_rn(dx, inv_bx))));
      dy = __fsub_rn(dy, __fmul_rn(by, rintf(__fmul_rn(dy, inv_by))));
      dz = __fsub_rn(dz, __fmul_rn(bz, rintf(__fmul_rn(dz, inv_bz))));
      const float r2 = pair_r2(dx, dy, dz);
      if (r2 >= a.p.rc2 || r2 <= 1e-8f) continue;
      double e;
      float w;
      periodic_pair(a.p, r2, q_i, s_q[jj], 0.5f * (sig_i + s_sig[jj]), seps_i * s_seps[jj], &e,
                    &w);
      e_acc += e;
      fx -= w * dx;
      fy -= w * dy;
      fz -= w * dz;
    }
  }
  s_e[ty][tx] = e_acc;
  s_f[0][ty][tx] = fx;
  s_f[1][ty][tx] = fy;
  s_f[2][ty][tx] = fz;
  __syncthreads();
  if (ty == 0 && own) {
    double e = 0.0;
    float f0 = 0.0f, f1 = 0.0f, f2 = 0.0f;
    for (int s = 0; s < kSplit; ++s) {
      e += s_e[s][tx];
      f0 += s_f[0][s][tx];
      f1 += s_f[1][s][tx];
      f2 += s_f[2][s][tx];
    }
    a.e_rows[rbase + i] = 0.5 * e;
    float* fo = a.forces + (rbase + i) * 3;
    fo[0] = f0;
    fo[1] = f1;
    fo[2] = f2;
  }
}

}  // namespace

extern "C" {

// phys: see make_pair_phys (reaction field: the dense sweep has no Ewald mode).
// Returns cudaGetLastError() after the launch on `stream`.
int pmarlo_periodic_force(const float* x, const float* atom_p, int n_replicas, int n_atoms,
                          int band, const float* box, const float* phys,
                          double* e_rows, float* forces, void* stream) {
  if (n_atoms < 1 || n_replicas < 1 || n_replicas > 65535 || band < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PeriodicArgs a = {};
  a.x = x;
  a.atom_p = atom_p;
  a.e_rows = e_rows;
  a.forces = forces;
  a.n = n_atoms;
  a.band = band;
  for (int k = 0; k < 3; ++k) a.box[k] = box[k];
  a.p = make_pair_phys(phys, 0);
  const dim3 grid((n_atoms + kRows - 1) / kRows, n_replicas);
  const dim3 block(kRows, kSplit);
  periodic_force_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
