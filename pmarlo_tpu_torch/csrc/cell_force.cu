// O(N) cell-list sweep for explicit solvent: energy rows and forces of the
// periodic LJ + reaction-field (or real-space Ewald) potential over the
// 27-cell neighbourhood of every atom.
//
// Replaces: pmarlo_tpu/md/pallas_cells.py _build_cell_sweep, its one Pallas
// sweep (kernel at :118, pallas_call at :232). The TPU kernel walked a
// fixed-capacity slot array against nine ghost-padded, pre-shifted neighbour
// runs. None of that layout is carried over: atoms arrive as a permutation
// sorted by cell (ascending atom index within a cell) with CSR offsets,
// which hold any occupancy, so no cell can overflow. What is carried over:
// wrapped coordinates plus a lattice shift per neighbour cell across a face
// (so the kernel does no minimum-image arithmetic, orthorhombic or
// triclinic; r^2 without fused multiply-adds, so the plain twin decides the
// cutoff on the same number), the index-band mask |i - j| <= band on the atom index (the
// wrapper adds the band back at its wanted value), within = r^2 < rc^2, and
// the pair physics of periodic_pair.cuh: the force is the exact gradient of
// the kernel's own energy, in Ewald mode through erfcf and its exact
// derivative.
//
// What bounds it on an H100: arithmetic. A sweep is R * N * 27 * (mean cell
// occupancy) ordered candidate pairs (27,783-atom water box, 7^3 cells of 81
// atoms: 61 M a replica); a pair inside the cutoff costs ~50 float32
// operations and one rsqrt (three special-function results in Ewald mode).
// All inputs are O(N) and stay in L2.
//
// Design:
// - grid (cells, row tiles, replicas), CTA of kRows x kSplit threads. A CTA
//   takes kRows row atoms of its cell at a time: thread (tx, ty) owns row
//   atom tx and the staged columns ty, ty + kSplit, ... The row-tile grid
//   dimension is a provision (the grid's capacity); a CTA strides over its
//   cell's row tiles by that dimension, so a cell fuller than provided for is
//   still covered, and a CTA past its cell's last row tile exits at once.
// - the 27 neighbour cells are one stream of column atoms: the prefix sums of
//   their counts sit in shared memory, and each loading thread finds its
//   cell by a search over 27 entries, gathers the atom through the sort
//   permutation and adds the cell's lattice shift. Tiles of kThreads columns
//   are staged as structure-of-arrays.
// - the kSplit partial sums of a row are added in a fixed order through
//   shared memory: no atomics, a launch is bit-reproducible. Rows are written
//   straight to their atom index (the scatter back through the permutation).
// - energy rows accumulate in float64 and are written as float64; forces
//   keep float32 sums.

#include <cuda_runtime.h>
#include <stdint.h>

#include "periodic_pair.cuh"

namespace {

constexpr int kRows = 32;
constexpr int kSplit = 8;
constexpr int kThreads = kRows * kSplit;
constexpr int kNeighbors = 27;

struct CellArgs {
  const float* xw;        // (R, N, 3) wrapped coordinates, by atom index
  const float* atom_p;    // (3, N): q, sigma, sqrt(eps)
  const int* order;       // (R, N) atom indices sorted by cell
  const int* cell_start;  // (R, n_cells + 1) CSR offsets into order
  double* e_rows;         // (R, N) half-summed row energies, by atom index
  float* forces;          // (R, N, 3), by atom index
  int n;
  int nx, ny, nz;
  int band;
  const float* shifts;    // (27, 3) lattice shift of the wrap (wx, wy, wz) in {-1, 0, 1}^3
  PairPhys p;
};

__device__ __forceinline__ int wrap_cell(int c, int n, int* w) {
  if (c < 0) {
    *w = -1;
    return c + n;
  }
  if (c >= n) {
    *w = 1;
    return c - n;
  }
  *w = 0;
  return c;
}

__global__ void __launch_bounds__(kThreads) cell_force_kernel(CellArgs a) {
  __shared__ float s_x[kThreads], s_y[kThreads], s_z[kThreads];
  __shared__ float s_q[kThreads], s_sig[kThreads], s_seps[kThreads];
  __shared__ int s_idx[kThreads];
  __shared__ int s_nb_start[kNeighbors], s_nb_pre[kNeighbors + 1];
  __shared__ float s_shift[kNeighbors][3];
  __shared__ double s_e[kSplit][kRows];
  __shared__ float s_f[3][kSplit][kRows];
  const int n = a.n;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kRows + tx;
  const int n_cells = a.nx * a.ny * a.nz;
  const int cell = blockIdx.x;
  const size_t rbase = static_cast<size_t>(blockIdx.z) * n;
  const int* cs = a.cell_start + static_cast<size_t>(blockIdx.z) * (n_cells + 1);
  const int* ord = a.order + rbase;
  const float* xr = a.xw + rbase * 3;

  const int row_start = cs[cell];
  const int row_cnt = cs[cell + 1] - row_start;
  if (static_cast<int>(blockIdx.y) * kRows >= row_cnt) return;   // the whole CTA

  if (tid < kNeighbors) {
    const int cz = cell % a.nz;
    const int cy = (cell / a.nz) % a.ny;
    const int cx = cell / (a.nz * a.ny);
    int wx, wy, wz;
    const int ncx = wrap_cell(cx + tid / 9 - 1, a.nx, &wx);
    const int ncy = wrap_cell(cy + (tid / 3) % 3 - 1, a.ny, &wy);
    const int ncz = wrap_cell(cz + tid % 3 - 1, a.nz, &wz);
    const int nc = (ncx * a.ny + ncy) * a.nz + ncz;
    s_nb_start[tid] = cs[nc];
    s_nb_pre[tid + 1] = cs[nc + 1] - cs[nc];
    // a neighbour reached across a face appears displaced by that face's
    // lattice vector (the wrapper's table, so the twin adds the same float)
    const float* sh = a.shifts + 3 * ((wx + 1) * 9 + (wy + 1) * 3 + (wz + 1));
    s_shift[tid][0] = sh[0];
    s_shift[tid][1] = sh[1];
    s_shift[tid][2] = sh[2];
  }
  __syncthreads();
  if (tid == 0) {
    s_nb_pre[0] = 0;
    for (int c = 0; c < kNeighbors; ++c) s_nb_pre[c + 1] += s_nb_pre[c];
  }
  __syncthreads();
  const int total = s_nb_pre[kNeighbors];

  for (int rt = blockIdx.y; rt * kRows < row_cnt; rt += gridDim.y) {
    const int slot = rt * kRows + tx;
    const bool own = slot < row_cnt;
    int ai = 0;
    float xi = 0.0f, yi = 0.0f, zi = 0.0f, q_i = 0.0f, sig_i = 0.0f, seps_i = 0.0f;
    if (own) {
      ai = ord[row_start + slot];
      xi = xr[3 * ai];
      yi = xr[3 * ai + 1];
      zi = xr[3 * ai + 2];
      q_i = a.atom_p[ai];
      sig_i = a.atom_p[n + ai];
      seps_i = a.atom_p[2 * n + ai];
    }
    double e_acc = 0.0;
    float fx = 0.0f, fy = 0.0f, fz = 0.0f;
    for (int t0 = 0; t0 < total; t0 += kThreads) {
      __syncthreads();
      const int f = t0 + tid;
      if (f < total) {
        int c = 0;
        while (f >= s_nb_pre[c + 1]) ++c;
        const int aj = ord[s_nb_start[c] + (f - s_nb_pre[c])];
        s_x[tid] = xr[3 * aj] + s_shift[c][0];
        s_y[tid] = xr[3 * aj + 1] + s_shift[c][1];
        s_z[tid] = xr[3 * aj + 2] + s_shift[c][2];
        s_q[tid] = a.atom_p[aj];
        s_sig[tid] = a.atom_p[n + aj];
        s_seps[tid] = a.atom_p[2 * n + aj];
        s_idx[tid] = aj;
      }
      __syncthreads();
      const int cnt = min(kThreads, total - t0);
      if (!own) continue;
      for (int jj = ty; jj < cnt; jj += kSplit) {
        if (abs(ai - s_idx[jj]) <= a.band) continue;
        const float dx = xi - s_x[jj], dy = yi - s_y[jj], dz = zi - s_z[jj];
        const float r2 = pair_r2(dx, dy, dz);
        if (r2 >= a.p.rc2 || r2 <= 1e-8f) continue;
        double e;
        float w;
        periodic_pair(a.p, r2, q_i, s_q[jj], 0.5f * (sig_i + s_sig[jj]), seps_i * s_seps[jj],
                      &e, &w);
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
      a.e_rows[rbase + ai] = 0.5 * e;
      float* fo = a.forces + (rbase + ai) * 3;
      fo[0] = f0;
      fo[1] = f1;
      fo[2] = f2;
    }
    __syncthreads();   // the sums are read before the next row tile writes them
  }
}

}  // namespace

extern "C" {

// dims: nx, ny, nz (host memory); shifts: (27, 3) device table of the lattice
// shifts wx a + wy b + wz c, indexed (wx + 1) 9 + (wy + 1) 3 + (wz + 1); phys
// as in pmarlo_periodic_force. row_tiles: grid provision of row
// tiles a cell. Returns cudaGetLastError() after the launch on `stream`.
int pmarlo_cell_force(const float* xw, const float* atom_p, const int* order,
                      const int* cell_start, int n_replicas, int n_atoms, const int* dims,
                      int row_tiles, int band, const float* shifts, const float* phys,
                      int ewald, double* e_rows, float* forces, void* stream) {
  if (n_atoms < 1 || n_replicas < 1 || n_replicas > 65535 || band < 0 || row_tiles < 1 ||
      row_tiles > 65535 || dims[0] < 1 || dims[1] < 1 || dims[2] < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CellArgs a = {};
  a.xw = xw;
  a.atom_p = atom_p;
  a.order = order;
  a.cell_start = cell_start;
  a.e_rows = e_rows;
  a.forces = forces;
  a.n = n_atoms;
  a.nx = dims[0];
  a.ny = dims[1];
  a.nz = dims[2];
  a.band = band;
  a.shifts = shifts;
  a.p = make_pair_phys(phys, ewald);
  const dim3 grid(dims[0] * dims[1] * dims[2], row_tiles, n_replicas);
  const dim3 block(kRows, kSplit);
  cell_force_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
