// GB pair sweeps that take each unordered (row tile, column tile) block
// once: both Born / dE/dB attributions and Newton's third law.
//
// Replaces: pmarlo_tpu/md/pallas_pair.py _build_newton_path, its three
// Pallas sweeps over a flat block list (newton=True, the default with
// gb_cutoff):
//   newton_born_kernel   <- sweep1_s / born_sym
//   newton_energy_kernel <- sweep2_s / energy_sym
//   newton_force_kernel  <- sweep3_s / force_sym
// They compute what the row-owned sweeps of pair_force.cu compute (same
// outputs, same glue around them in md/pair_force.py), at about half the
// pair work: the distance, LJ + Coulomb, the GB f-function and the neck are
// evaluated once a pair; only the HCT term is evaluated per direction.
//
// What bounds it on an H100: arithmetic (the special-function unit), as for
// the row-owned sweeps; the per-atom data of a block is 2 x tile atoms.
//
// Design:
// - grid (column tile c, row tile r, replica): a CTA whose block lies under
//   the diagonal (c < r), or whose tile boxes are farther apart than the
//   cutoff (the wrapper's `close` table, recomputed from the live positions
//   on every call), returns at once. The TPU kernel ran a compacted,
//   statically sized block list on a sequential grid and poisoned the
//   result when the list overflowed; here there is no list, so nothing can
//   overflow, and blocks run concurrently.
// - a CTA stages its row tile and its column tile (positions, parameters,
//   Born radii, chain coefficients) in shared memory. A warp takes 32 rows x
//   32 columns at a time: lane l owns row l and at step k the column
//   (l + k) mod 32, so a warp's shared-memory reads never collide. The row
//   sums stay in the lane's registers; the column sums travel with their
//   column, handed to the neighbouring lane by a shuffle after every step,
//   and arrive after 32 steps in the lane whose index is the column's. No
//   atomics inside the 32 x 32 patch.
// - a diagonal block counts each unordered pair once: the strict upper
//   triangle in storage order (column > row), and patches under the
//   diagonal are not visited.
// - patch sums are added to the CTA's per-atom sums in shared memory, and
//   those to the outputs in global memory, with atomicAdd (float for I,
//   dE/dB and F, double for the energy rows): one per atom and CTA. The
//   order of these additions changes from run to run, so results differ in
//   the last bits between runs; the row-owned sweeps are the bit-reproducible
//   path. The wrapper zeroes the outputs before the launch.
// - energy rows: the energy of a pair goes to its row atom (the lower
//   storage index), so the rows sum to the total as the row-owned rows do,
//   though atom by atom they differ from them.
// - the cutoff test, the band mask on original indices, the skipped self
//   and coincident slots and the float64 energy sums are those of
//   pair_force.cu.

#include "pair_common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxTile = 256;   // atoms a tile: shared memory holds two tiles

// one staged tile in shared memory (structure of arrays, `tile` entries each)
struct Side {
  float *x, *y, *z, *q, *sig, *seps, *rho, *sr, *B, *c;
  int *cls, *orig;
  float* acc[3];   // the CTA's per-atom sums for this side
};
constexpr int kSideWords = 15;   // arrays of a Side

__device__ Side carve(float* base, int tile) {
  Side s;
  s.x = base;
  s.y = base + tile;
  s.z = base + 2 * tile;
  s.q = base + 3 * tile;
  s.sig = base + 4 * tile;
  s.seps = base + 5 * tile;
  s.rho = base + 6 * tile;
  s.sr = base + 7 * tile;
  s.B = base + 8 * tile;
  s.c = base + 9 * tile;
  s.cls = reinterpret_cast<int*>(base + 10 * tile);
  s.orig = reinterpret_cast<int*>(base + 11 * tile);
  for (int d = 0; d < 3; ++d) s.acc[d] = base + (12 + d) * tile;
  return s;
}

// stages atoms first .. first + count of replica `rep` and zeroes the sums
__device__ void stage(const PairArgs& a, const Side& s, int rep, int first, int count, int tid) {
  const int n = a.n;
  const size_t rbase = static_cast<size_t>(rep) * n;
  for (int k = tid; k < a.tile; k += kThreads) {
    for (int d = 0; d < 3; ++d) s.acc[d][k] = 0.0f;
    if (k >= count) continue;
    const int j = first + k;
    s.x[k] = a.x[(rbase + j) * 3];
    s.y[k] = a.x[(rbase + j) * 3 + 1];
    s.z[k] = a.x[(rbase + j) * 3 + 2];
    s.q[k] = a.atom_p[kQ * n + j];
    s.sig[k] = a.atom_p[kSig * n + j];
    s.seps[k] = a.atom_p[kSeps * n + j];
    s.rho[k] = a.atom_p[kRho * n + j];
    s.sr[k] = a.atom_p[kSr * n + j];
    s.cls[k] = a.cls[j];
    s.orig[k] = a.orig ? a.orig[j] : j;
    s.B[k] = (a.use_gb && a.B) ? a.B[rbase + j] : 1.0f;
    s.c[k] = (a.use_gb && a.chain) ? a.chain[rbase + j] : 0.0f;
  }
}

// the block this CTA computes, or done = true
struct Block {
  int rep, row0, col0, n_rows, n_cols;
  bool diagonal, done;
  __device__ Block(const PairArgs& a) {
    const int c = blockIdx.x, r = blockIdx.y;
    rep = blockIdx.z;
    done = c < r;
    if (!done && a.close) {
      done = !a.close[(static_cast<size_t>(rep) * a.n_tiles + r) * a.n_tiles + c];
    }
    diagonal = c == r;
    row0 = r * a.tile;
    col0 = c * a.tile;
    n_rows = min(a.tile, a.n - row0);
    n_cols = min(a.tile, a.n - col0);
  }
};

// hands the travelling column sums to the lane that owns the column next
__device__ __forceinline__ float to_next_lane(float v, int lane) {
  return __shfl_sync(0xffffffffu, v, (lane + 1) & 31);
}

// adds the CTA's per-atom sums of `n_out` components to out (R, N, n_out)
__device__ void flush(const PairArgs& a, const Block& b, const Side& rows, const Side& cols,
                      int n_out, int tid) {
  const size_t rbase = static_cast<size_t>(b.rep) * a.n;
  for (int k = tid; k < a.tile; k += kThreads) {
    for (int d = 0; d < n_out; ++d) {
      if (k < b.n_rows) atomicAdd(a.out0 + (rbase + b.row0 + k) * n_out + d, rows.acc[d][k]);
      if (k < b.n_cols) atomicAdd(a.out0 + (rbase + b.col0 + k) * n_out + d, cols.acc[d][k]);
    }
  }
}

// Walks the CTA's 32 x 32 patches. `pair(i, j, r, dx, dy, dz, row_sum, col_sum)`
// adds one pair's terms to the kSums sums of either side (i a row slot, j a
// column slot, both staged); `patch_done(i)` is called for a lane's row i
// after each patch.
template <int kSums, typename Pair, typename PatchDone>
__device__ void walk(const PairArgs& a, const Block& b, const Side& rows, const Side& cols,
                     Pair pair, PatchDone patch_done) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row_groups = (b.n_rows + 31) / 32, col_groups = (b.n_cols + 31) / 32;
  for (int item = warp; item < row_groups * col_groups; item += kWarps) {
    const int g = item / col_groups, h = item % col_groups;
    if (b.diagonal && h < g) continue;   // under the diagonal (uniform in the warp)
    const int i = g * 32 + lane;
    const bool row_ok = i < b.n_rows;
    const float xi = row_ok ? rows.x[i] : 0.0f, yi = row_ok ? rows.y[i] : 0.0f,
                zi = row_ok ? rows.z[i] : 0.0f;
    float row_sum[kSums], col_sum[kSums];
#pragma unroll
    for (int d = 0; d < kSums; ++d) row_sum[d] = col_sum[d] = 0.0f;
    for (int k = 0; k < 32; ++k) {
      const int j = h * 32 + ((lane + k) & 31);
      if (row_ok && j < b.n_cols && (!b.diagonal || j > i)) {
        const float dx = xi - cols.x[j], dy = yi - cols.y[j], dz = zi - cols.z[j];
        const float r2 = pair_r2(dx, dy, dz);
        const float s = __fadd_rn(r2, kEps);
        if (r2 > 1e-8f && (!a.has_cut || s <= a.cut_r2)) {
          pair(i, j, sqrtf(s), dx, dy, dz, row_sum, col_sum);
        }
      }
#pragma unroll
      for (int d = 0; d < kSums; ++d) col_sum[d] = to_next_lane(col_sum[d], lane);
    }
    // after 32 hand-overs lane l holds the sums of column h * 32 + l
    const int jc = h * 32 + lane;
#pragma unroll
    for (int d = 0; d < kSums; ++d) {
      if (row_ok) atomicAdd(&rows.acc[d][i], row_sum[d]);
      if (jc < b.n_cols) atomicAdd(&cols.acc[d][jc], col_sum[d]);
    }
    if (row_ok) patch_done(i);
  }
}

// ---- sweep 1: Born integral, both directions of each pair ----
__global__ void __launch_bounds__(kThreads) newton_born_kernel(PairArgs a) {
  extern __shared__ float smem[];
  const Block b(a);
  if (b.done) return;
  const Side rows = carve(smem, a.tile), cols = carve(smem + kSideWords * a.tile, a.tile);
  float* s_neck = smem + 2 * kSideWords * a.tile;
  const int cc = a.n_classes * a.n_classes;
  if (a.use_neck) load_neck(a, s_neck, threadIdx.x, kThreads);
  stage(a, rows, b.rep, b.row0, b.n_rows, threadIdx.x);
  stage(a, cols, b.rep, b.col0, b.n_cols, threadIdx.x);
  __syncthreads();
  walk<1>(a, b, rows, cols,
          [&](int i, int j, float r, float, float, float, float* row_sum, float* col_sum) {
            const float inv_r = 1.0f / r;
            float H_ij, H_ji, dH;
            born_pair(r, inv_r, rows.rho[i], cols.sr[j], &H_ij, &dH);
            born_pair(r, inv_r, cols.rho[j], rows.sr[i], &H_ji, &dH);
            float nv = 0.0f;
            if (a.use_neck) {
              const int k = rows.cls[i] * a.n_classes + cols.cls[j];
              float dnv;
              neck_pair(r, s_neck[k], s_neck[cc + k], &nv, &dnv);
            }
            row_sum[0] += 0.5f * H_ij + nv;
            col_sum[0] += 0.5f * H_ji + nv;
          },
          [](int) {});
  __syncthreads();
  flush(a, b, rows, cols, 1, threadIdx.x);
}

// ---- sweep 2: pair energy to the row atom, dE/dB to both atoms ----
__global__ void __launch_bounds__(kThreads) newton_energy_kernel(PairArgs a) {
  extern __shared__ float smem[];
  __shared__ double s_energy[kMaxTile];
  const Block b(a);
  if (b.done) return;
  const Side rows = carve(smem, a.tile), cols = carve(smem + kSideWords * a.tile, a.tile);
  for (int k = threadIdx.x; k < a.tile; k += kThreads) s_energy[k] = 0.0;
  stage(a, rows, b.rep, b.row0, b.n_rows, threadIdx.x);
  stage(a, cols, b.rep, b.col0, b.n_cols, threadIdx.x);
  __syncthreads();
  double e_sum = 0.0;   // a lane's float64 energy sum of one patch
  walk<1>(a, b, rows, cols,
          [&](int i, int j, float r, float, float, float, float* row_sum, float* col_sum) {
            const float inv_r = 1.0f / r;
            const float qq = rows.q[i] * cols.q[j];
            if (abs(rows.orig[i] - cols.orig[j]) > a.band) {
              e_sum += nb_energy(lj_sr6(rows.sig[i], cols.sig[j], inv_r),
                                 rows.seps[i] * cols.seps[j], a.ke, qq, inv_r);
            }
            if (a.use_gb) {
              const float B_i = rows.B[i], B_j = cols.B[j];
              const float rsq = r * r;
              float expu, inv_f;
              gb_f(rsq, B_i * B_j, &expu, &inv_f);
              const float qq_gb = a.gb_pref * qq;
              // the unordered pair's cross energy: both ordered directions
              e_sum += 2.0f * qq_gb * inv_f;
              // the ordered quantity on each side; the glue doubles it
              row_sum[0] += gb_dedb(qq_gb, inv_f, expu, rsq, B_i, B_j);
              col_sum[0] += gb_dedb(qq_gb, inv_f, expu, rsq, B_j, B_i);
            }
          },
          [&](int i) {
            atomicAdd(&s_energy[i], e_sum);
            e_sum = 0.0;
          });
  __syncthreads();
  flush(a, b, rows, cols, 1, threadIdx.x);
  const size_t rbase = static_cast<size_t>(b.rep) * a.n;
  for (int k = threadIdx.x; k < b.n_rows; k += kThreads) {
    atomicAdd(a.rows + rbase + b.row0 + k, s_energy[k]);
  }
}

// ---- sweep 3: forces, -W d on the row atom and +W d on the column atom ----
__global__ void __launch_bounds__(kThreads) newton_force_kernel(PairArgs a) {
  extern __shared__ float smem[];
  const Block b(a);
  if (b.done) return;
  const Side rows = carve(smem, a.tile), cols = carve(smem + kSideWords * a.tile, a.tile);
  float* s_neck = smem + 2 * kSideWords * a.tile;
  const int cc = a.n_classes * a.n_classes;
  if (a.use_neck) load_neck(a, s_neck, threadIdx.x, kThreads);
  stage(a, rows, b.rep, b.row0, b.n_rows, threadIdx.x);
  stage(a, cols, b.rep, b.col0, b.n_cols, threadIdx.x);
  __syncthreads();
  walk<3>(a, b, rows, cols,
          [&](int i, int j, float r, float dx, float dy, float dz, float* row_sum,
              float* col_sum) {
            const float inv_r = 1.0f / r;
            const float qq = rows.q[i] * cols.q[j];
            // dE/dr of the unordered pair, as in pair_force_kernel
            float W = 0.0f;
            if (abs(rows.orig[i] - cols.orig[j]) > a.band) {
              W = nb_dedr(lj_sr6(rows.sig[i], cols.sig[j], inv_r), rows.seps[i] * cols.seps[j],
                          a.ke, qq, inv_r);
            }
            if (a.use_gb) {
              float expu, inv_f;
              gb_f(r * r, rows.B[i] * cols.B[j], &expu, &inv_f);
              W += gb_dedr(a.gb_pref, qq, r, inv_f, expu);
              float H, dH_ij, dH_ji;
              born_pair(r, inv_r, rows.rho[i], cols.sr[j], &H, &dH_ij);
              born_pair(r, inv_r, cols.rho[j], rows.sr[i], &H, &dH_ji);
              float dI_ij = 0.5f * dH_ij, dI_ji = 0.5f * dH_ji;
              if (a.use_neck) {
                const int k = rows.cls[i] * a.n_classes + cols.cls[j];
                float nv, dnv;
                neck_pair(r, s_neck[k], s_neck[cc + k], &nv, &dnv);
                dI_ij += dnv;
                dI_ji += dnv;
              }
              W += rows.c[i] * dI_ij + cols.c[j] * dI_ji;
            }
            W *= inv_r;
            row_sum[0] -= W * dx;
            row_sum[1] -= W * dy;
            row_sum[2] -= W * dz;
            col_sum[0] += W * dx;
            col_sum[1] += W * dy;
            col_sum[2] += W * dz;
          },
          [](int) {});
  __syncthreads();
  flush(a, b, rows, cols, 3, threadIdx.x);
}

}  // namespace

extern "C" {

int pmarlo_pair_newton_max_tile() { return kMaxTile; }

// One Newton sweep (`sweep` as in pmarlo_pair_sweep) over the upper triangle
// of tile blocks; `close` null takes every block (no cutoff), `has_cut` 0
// keeps every pair. `out0` (and `rows`) must be zero: the kernels add to
// them. Returns cudaGetLastError() after the launch on `stream`.
int pmarlo_pair_newton_sweep(int sweep, const float* x, const float* atom_p, const int* cls,
                             const int* orig, const float* d0c, const float* m0c,
                             int n_classes, const float* B, const float* chain,
                             const uint8_t* close, int n_replicas, int n_atoms, int tile,
                             int band, float ke, float gb_pref, float cut_r2, int has_cut,
                             int use_gb, int use_neck, float* out0, double* rows,
                             void* stream) {
  if (n_atoms < 1 || n_replicas < 1 || n_replicas > 65535 || n_classes < 1 ||
      n_classes > kMaxClasses || band < 0 || tile < 32 || tile % 32 != 0 || tile > kMaxTile) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PairArgs a = {};
  a.x = x;
  a.atom_p = atom_p;
  a.cls = cls;
  a.orig = orig;
  a.d0c = d0c;
  a.m0c = m0c;
  a.B = B;
  a.chain = chain;
  a.close = close;
  a.out0 = out0;
  a.rows = rows;
  a.n = n_atoms;
  a.n_classes = n_classes;
  a.band = band;
  a.tile = tile;
  a.n_tiles = (n_atoms + tile - 1) / tile;
  a.cut_r2 = cut_r2;
  a.has_cut = has_cut;
  a.ke = ke;
  a.gb_pref = gb_pref;
  a.use_gb = use_gb;
  a.use_neck = use_neck && sweep != kEnergy;
  if (a.n_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  void (*kernel)(PairArgs) = sweep == kBorn     ? newton_born_kernel
                             : sweep == kEnergy ? newton_energy_kernel
                             : sweep == kForce  ? newton_force_kernel
                                                : nullptr;
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const size_t shmem =
      sizeof(float) * (2 * kSideWords * tile + (a.use_neck ? 2 * n_classes * n_classes : 0));
  cudaError_t err = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(kernel), cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(shmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a.n_tiles, a.n_tiles, n_replicas);
  kernel<<<grid, kThreads, shmem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
