// Dense GB pair sweeps for protein-scale implicit solvent (NoCutoff).
//
// Replaces: pmarlo_tpu/md/pallas_pair.py build_pair_force_fn, dense path,
// its three Pallas sweeps:
//   pair_born_kernel   <- sweep1 / born_kernel   (Born integral I_i)
//   pair_energy_kernel <- sweep2 / energy_kernel (pair energy rows, dE/dB_i)
//   pair_force_kernel  <- sweep3 / force_kernel  (pair forces F_i)
// The glue between the sweeps (tanh rescale, 1/B clamp, self and SA terms,
// chain coefficients), the band add-back of the exclusions and the bonded
// terms are plain PyTorch in md/pair_force.py, which also holds each
// sweep's plain twin.
//
// What bounds it on an H100: arithmetic, mostly the special-function unit.
// A force evaluation is three passes over all R * N^2 ordered pairs (R = 8,
// N = 3,726: 111 M pairs a pass), and a pair of the force pass costs two
// HCT derivatives (one log and several divides each), an exp, a sqrt and
// the neck rational. Per-atom data is O(N) and stays in L2; nothing of
// size N^2 is ever stored.
//
// Design:
// - grid (row tiles, replicas); a CTA owns kRows row atoms and has
//   kRows x kSplit threads: thread (tx, ty) owns row atom tx and the
//   columns ty, ty + kSplit, ... of each staged column tile. The kSplit
//   partial sums of a row are added in a fixed order at the end, through
//   shared memory, so a launch is bit-reproducible (no atomics). Splitting
//   the columns gives 8 warps a CTA and ~8 CTAs of a replica's 117 row
//   tiles an SM, where one thread a row would leave the card at ~7 warps
//   an SM.
// - column tiles of kThreads atoms (positions and per-atom parameters) are
//   staged in shared memory, one atom a thread, as structure-of-arrays: a
//   warp reads one column entry at a time, a broadcast.
// - the GBn2 neck's (C, C) radius-class tables sit in shared memory and are
//   indexed by the two atoms' class indices (where the TPU kernel multiplied
//   one-hot class matrices on its matrix unit).
// - exclusions: LJ and Coulomb are masked for |i - j| <= band (index band);
//   the wrapper adds the band back at its wanted scale. GB terms are never
//   masked: Born screening counts bonded pairs.
// - self and coincident slots (r^2 <= 1e-8) are skipped before any 1/r^k.
// - the force pass evaluates the exact derivative of what the Born and
//   energy passes sum: the same expressions, including both Born chain
//   directions c_i dI_i/dr_ij + c_j dI_j/dr_ji, so F = -grad E.
// - the ragged last row tile and column tile are masked in the kernel; no
//   padding atoms exist.
// - pair arithmetic is float32; the Born and energy sums accumulate in
//   float64, and the energy rows are written as float64. A protein's total
//   energy is ~1% of its summed components (3,726 atoms near a minimum:
//   -300 to -1,400 kJ/mol against ~1e5 in each of the pair and GB-self
//   sums), and float32 sums left errors of ~1e-4 of the total. Forces keep
//   float32 sums: they do not cancel that far.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gb_pair.cuh"

namespace {

constexpr int kRows = 32;                 // row atoms a CTA
constexpr int kSplit = 8;                 // column lanes a row
constexpr int kThreads = kRows * kSplit;  // threads a CTA = column tile
constexpr int kMaxClasses = 64;           // GBn2 radius classes

// rows of the per-atom parameter table (kAtomRows, N)
enum AtomRow { kQ = 0, kSig, kSeps, kRho, kSr, kAtomRows };

struct PairArgs {
  const float* x;        // (R, N, 3)
  const float* atom_p;   // (kAtomRows, N): q, sigma, sqrt(eps), rho, sr
  const int* cls;        // (N,) radius-class index
  const float* d0c;      // (C, C) neck d0
  const float* m0c;      // (C, C) neck m0 * neck scale
  const float* B;        // (R, N) Born radii
  const float* chain;    // (R, N) dE/dB dB/dpsi rho
  float* out0;           // born: I; energy: dE/dB pair sum; force: F (R, N, 3)
  double* rows;          // energy: e_rows (R, N)
  int n;
  int n_classes;
  int band;
  float ke;
  float gb_pref;
  int use_gb;
  int use_neck;
};

// loads the (C, C) neck tables into shared memory: d0 then m0s
__device__ __forceinline__ void load_neck(const PairArgs& a, float* s_neck, int tid) {
  const int cc = a.n_classes * a.n_classes;
  for (int k = tid; k < 2 * cc; k += kThreads) {
    s_neck[k] = (k < cc) ? a.d0c[k] : a.m0c[k - cc];
  }
}

// ---- sweep 1: Born integral I_i = 1/2 sum_j H(r; rho_i, sr_j) + sum_j neck ----
__global__ void __launch_bounds__(kThreads) pair_born_kernel(PairArgs a) {
  __shared__ float s_x[kThreads], s_y[kThreads], s_z[kThreads], s_sr[kThreads];
  __shared__ int s_cls[kThreads];
  __shared__ double s_red[2][kSplit][kRows];
  extern __shared__ float s_neck[];
  const int n = a.n;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kRows + tx;
  const int i = blockIdx.x * kRows + tx;
  const bool own = i < n;
  const float* xr = a.x + static_cast<size_t>(blockIdx.y) * n * 3;
  const int cc = a.n_classes * a.n_classes;
  if (a.use_neck) load_neck(a, s_neck, tid);

  float xi = 0.0f, yi = 0.0f, zi = 0.0f, rho_i = 1.0f;
  int ci = 0;
  if (own) {
    xi = xr[3 * i];
    yi = xr[3 * i + 1];
    zi = xr[3 * i + 2];
    rho_i = a.atom_p[kRho * n + i];
    ci = a.cls[i] * a.n_classes;
  }
  double h_acc = 0.0, nk_acc = 0.0;
  for (int t0 = 0; t0 < n; t0 += kThreads) {
    __syncthreads();
    const int j = t0 + tid;
    if (j < n) {
      s_x[tid] = xr[3 * j];
      s_y[tid] = xr[3 * j + 1];
      s_z[tid] = xr[3 * j + 2];
      s_sr[tid] = a.atom_p[kSr * n + j];
      s_cls[tid] = a.cls[j];
    }
    __syncthreads();
    const int cnt = min(kThreads, n - t0);
    if (!own) continue;
    for (int jj = ty; jj < cnt; jj += kSplit) {
      const float dx = xi - s_x[jj], dy = yi - s_y[jj], dz = zi - s_z[jj];
      const float r2 = dx * dx + dy * dy + dz * dz;
      if (r2 <= 1e-8f) continue;
      const float r = sqrtf(r2 + kEps);
      float H, dH;
      born_pair(r, 1.0f / r, rho_i, s_sr[jj], &H, &dH);
      h_acc += H;
      if (a.use_neck) {
        const int k = ci + s_cls[jj];
        float nv, dnv;
        neck_pair(r, s_neck[k], s_neck[cc + k], &nv, &dnv);
        nk_acc += nv;
      }
    }
  }
  s_red[0][ty][tx] = h_acc;
  s_red[1][ty][tx] = nk_acc;
  __syncthreads();
  if (ty == 0 && own) {
    double h = 0.0, nk = 0.0;
    for (int s = 0; s < kSplit; ++s) {
      h += s_red[0][s][tx];
      nk += s_red[1][s][tx];
    }
    a.out0[static_cast<size_t>(blockIdx.y) * n + i] = static_cast<float>(0.5 * h + nk);
  }
}

// ---- sweep 2: pair energy rows and the pairwise part of dE/dB_i ----
__global__ void __launch_bounds__(kThreads) pair_energy_kernel(PairArgs a) {
  __shared__ float s_x[kThreads], s_y[kThreads], s_z[kThreads];
  __shared__ float s_q[kThreads], s_sig[kThreads], s_seps[kThreads], s_B[kThreads];
  __shared__ double s_red[3][kSplit][kRows];
  const int n = a.n;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kRows + tx;
  const int i = blockIdx.x * kRows + tx;
  const bool own = i < n;
  const size_t rbase = static_cast<size_t>(blockIdx.y) * n;
  const float* xr = a.x + rbase * 3;

  float xi = 0.0f, yi = 0.0f, zi = 0.0f, q_i = 0.0f, sig_i = 0.0f, seps_i = 0.0f, B_i = 1.0f;
  if (own) {
    xi = xr[3 * i];
    yi = xr[3 * i + 1];
    zi = xr[3 * i + 2];
    q_i = a.atom_p[kQ * n + i];
    sig_i = a.atom_p[kSig * n + i];
    seps_i = a.atom_p[kSeps * n + i];
    if (a.use_gb) B_i = a.B[rbase + i];
  }
  double e_nb = 0.0, e_gb = 0.0, dedb = 0.0;
  for (int t0 = 0; t0 < n; t0 += kThreads) {
    __syncthreads();
    const int j = t0 + tid;
    if (j < n) {
      s_x[tid] = xr[3 * j];
      s_y[tid] = xr[3 * j + 1];
      s_z[tid] = xr[3 * j + 2];
      s_q[tid] = a.atom_p[kQ * n + j];
      s_sig[tid] = a.atom_p[kSig * n + j];
      s_seps[tid] = a.atom_p[kSeps * n + j];
      s_B[tid] = a.use_gb ? a.B[rbase + j] : 1.0f;
    }
    __syncthreads();
    const int cnt = min(kThreads, n - t0);
    if (!own) continue;
    for (int jj = ty; jj < cnt; jj += kSplit) {
      const float dx = xi - s_x[jj], dy = yi - s_y[jj], dz = zi - s_z[jj];
      const float r2 = dx * dx + dy * dy + dz * dz;
      if (r2 <= 1e-8f) continue;
      const float r = sqrtf(r2 + kEps);
      const float inv_r = 1.0f / r;
      const float qq = q_i * s_q[jj];
      if (abs(i - (t0 + jj)) > a.band) {
        const float sig = 0.5f * (sig_i + s_sig[jj]);
        const float eps = seps_i * s_seps[jj];
        const float s = sig * inv_r;
        const float s2 = s * s;
        const float sr6 = s2 * s2 * s2;
        e_nb += 4.0f * eps * (sr6 * sr6 - sr6) + a.ke * qq * inv_r;
      }
      if (a.use_gb) {
        const float B_j = s_B[jj];
        const float BB = B_i * B_j;
        const float rsq = r * r;
        const float expu = expf(-rsq / (4.0f * BB));
        const float inv_f = 1.0f / sqrtf(rsq + BB * expu);
        const float qq_gb = a.gb_pref * qq;
        e_gb += qq_gb * inv_f;
        dedb += (-qq_gb * inv_f * inv_f) * (expu * (B_j + rsq / (4.0f * B_i)) * (0.5f * inv_f));
      }
    }
  }
  s_red[0][ty][tx] = e_nb;
  s_red[1][ty][tx] = e_gb;
  s_red[2][ty][tx] = dedb;
  __syncthreads();
  if (ty == 0 && own) {
    double nb = 0.0, gb = 0.0, db = 0.0;
    for (int s = 0; s < kSplit; ++s) {
      nb += s_red[0][s][tx];
      gb += s_red[1][s][tx];
      db += s_red[2][s][tx];
    }
    a.rows[rbase + i] = 0.5 * nb + gb;
    a.out0[rbase + i] = static_cast<float>(db);
  }
}

// ---- sweep 3: F_i = -sum_j W_ij (x_i - x_j) / r ----
__global__ void __launch_bounds__(kThreads) pair_force_kernel(PairArgs a) {
  __shared__ float s_x[kThreads], s_y[kThreads], s_z[kThreads];
  __shared__ float s_q[kThreads], s_sig[kThreads], s_seps[kThreads];
  __shared__ float s_B[kThreads], s_c[kThreads], s_rho[kThreads], s_sr[kThreads];
  __shared__ int s_cls[kThreads];
  __shared__ float s_red[3][kSplit][kRows];
  extern __shared__ float s_neck[];
  const int n = a.n;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kRows + tx;
  const int i = blockIdx.x * kRows + tx;
  const bool own = i < n;
  const size_t rbase = static_cast<size_t>(blockIdx.y) * n;
  const float* xr = a.x + rbase * 3;
  const int cc = a.n_classes * a.n_classes;
  if (a.use_neck) load_neck(a, s_neck, tid);

  float xi = 0.0f, yi = 0.0f, zi = 0.0f, q_i = 0.0f, sig_i = 0.0f, seps_i = 0.0f;
  float B_i = 1.0f, c_i = 0.0f, rho_i = 1.0f, sr_i = 0.0f;
  int ci = 0;
  if (own) {
    xi = xr[3 * i];
    yi = xr[3 * i + 1];
    zi = xr[3 * i + 2];
    q_i = a.atom_p[kQ * n + i];
    sig_i = a.atom_p[kSig * n + i];
    seps_i = a.atom_p[kSeps * n + i];
    rho_i = a.atom_p[kRho * n + i];
    sr_i = a.atom_p[kSr * n + i];
    ci = a.cls[i] * a.n_classes;
    if (a.use_gb) {
      B_i = a.B[rbase + i];
      c_i = a.chain[rbase + i];
    }
  }
  float fx = 0.0f, fy = 0.0f, fz = 0.0f;
  for (int t0 = 0; t0 < n; t0 += kThreads) {
    __syncthreads();
    const int j = t0 + tid;
    if (j < n) {
      s_x[tid] = xr[3 * j];
      s_y[tid] = xr[3 * j + 1];
      s_z[tid] = xr[3 * j + 2];
      s_q[tid] = a.atom_p[kQ * n + j];
      s_sig[tid] = a.atom_p[kSig * n + j];
      s_seps[tid] = a.atom_p[kSeps * n + j];
      s_rho[tid] = a.atom_p[kRho * n + j];
      s_sr[tid] = a.atom_p[kSr * n + j];
      s_cls[tid] = a.cls[j];
      s_B[tid] = a.use_gb ? a.B[rbase + j] : 1.0f;
      s_c[tid] = a.use_gb ? a.chain[rbase + j] : 0.0f;
    }
    __syncthreads();
    const int cnt = min(kThreads, n - t0);
    if (!own) continue;
    for (int jj = ty; jj < cnt; jj += kSplit) {
      const float dx = xi - s_x[jj], dy = yi - s_y[jj], dz = zi - s_z[jj];
      const float r2 = dx * dx + dy * dy + dz * dz;
      if (r2 <= 1e-8f) continue;
      const float r = sqrtf(r2 + kEps);
      const float inv_r = 1.0f / r;
      const float qq = q_i * s_q[jj];
      // dE/dr of the unordered pair
      float W = 0.0f;
      if (abs(i - (t0 + jj)) > a.band) {
        const float sig = 0.5f * (sig_i + s_sig[jj]);
        const float eps = seps_i * s_seps[jj];
        const float s = sig * inv_r;
        const float s2 = s * s;
        const float sr6 = s2 * s2 * s2;
        W = 4.0f * eps * (-12.0f * sr6 * sr6 + 6.0f * sr6) * inv_r - a.ke * qq * inv_r * inv_r;
      }
      if (a.use_gb) {
        const float B_j = s_B[jj];
        const float BB = B_i * B_j;
        const float rsq = r * r;
        const float expu = expf(-rsq / (4.0f * BB));
        const float inv_f = 1.0f / sqrtf(rsq + BB * expu);
        // direct GB term at fixed Born radii, both ordered directions
        const float dEdf = -(a.gb_pref * 2.0f * qq) * inv_f * inv_f;
        W += dEdf * (r * (1.0f - 0.25f * expu) * inv_f);
        // Born chain: c_i dI_i/dr_ij + c_j dI_j/dr_ji
        float H, dH_ij, dH_ji;
        born_pair(r, inv_r, rho_i, s_sr[jj], &H, &dH_ij);
        born_pair(r, inv_r, s_rho[jj], sr_i, &H, &dH_ji);
        float dI_ij = 0.5f * dH_ij, dI_ji = 0.5f * dH_ji;
        if (a.use_neck) {
          // the class tables are symmetric (the wrapper checks), so one
          // neck derivative serves both directions
          const int k = ci + s_cls[jj];
          float nv, dnv;
          neck_pair(r, s_neck[k], s_neck[cc + k], &nv, &dnv);
          dI_ij += dnv;
          dI_ji += dnv;
        }
        W += c_i * dI_ij + s_c[jj] * dI_ji;
      }
      W *= inv_r;
      fx -= W * dx;
      fy -= W * dy;
      fz -= W * dz;
    }
  }
  s_red[0][ty][tx] = fx;
  s_red[1][ty][tx] = fy;
  s_red[2][ty][tx] = fz;
  __syncthreads();
  if (ty == 0 && own) {
    float f0 = 0.0f, f1 = 0.0f, f2 = 0.0f;
    for (int s = 0; s < kSplit; ++s) {
      f0 += s_red[0][s][tx];
      f1 += s_red[1][s][tx];
      f2 += s_red[2][s][tx];
    }
    float* fo = a.out0 + (rbase + i) * 3;
    fo[0] = f0;
    fo[1] = f1;
    fo[2] = f2;
  }
}

int launch(void (*kernel)(PairArgs), const PairArgs& a, int n_replicas, bool neck_smem,
           void* stream) {
  if (a.n < 1 || n_replicas < 1 || n_replicas > 65535 || a.n_classes < 1 ||
      a.n_classes > kMaxClasses || a.band < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((a.n + kRows - 1) / kRows, n_replicas);
  const dim3 block(kRows, kSplit);
  const size_t shmem = neck_smem ? 2 * sizeof(float) * a.n_classes * a.n_classes : 0;
  kernel<<<grid, block, shmem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int pmarlo_pair_max_classes() { return kMaxClasses; }

// Each returns cudaGetLastError() after the launch on `stream` (0 = launched).
int pmarlo_pair_born(const float* x, const float* atom_p, const int* cls, const float* d0c,
                     const float* m0c, int n_classes, int n_replicas, int n_atoms,
                     int use_neck, float* born, void* stream) {
  PairArgs a = {};
  a.x = x;
  a.atom_p = atom_p;
  a.cls = cls;
  a.d0c = d0c;
  a.m0c = m0c;
  a.out0 = born;
  a.n = n_atoms;
  a.n_classes = n_classes;
  a.use_neck = use_neck;
  return launch(pair_born_kernel, a, n_replicas, use_neck != 0, stream);
}

int pmarlo_pair_energy(const float* x, const float* atom_p, const float* B, int n_replicas,
                       int n_atoms, int band, float ke, float gb_pref, int use_gb,
                       double* e_rows, float* dedb, void* stream) {
  PairArgs a = {};
  a.x = x;
  a.atom_p = atom_p;
  a.B = B;
  a.rows = e_rows;
  a.out0 = dedb;
  a.n = n_atoms;
  a.n_classes = 1;
  a.band = band;
  a.ke = ke;
  a.gb_pref = gb_pref;
  a.use_gb = use_gb;
  return launch(pair_energy_kernel, a, n_replicas, false, stream);
}

int pmarlo_pair_force(const float* x, const float* atom_p, const int* cls, const float* d0c,
                      const float* m0c, int n_classes, const float* B, const float* chain,
                      int n_replicas, int n_atoms, int band, float ke, float gb_pref,
                      int use_gb, int use_neck, float* forces, void* stream) {
  PairArgs a = {};
  a.x = x;
  a.atom_p = atom_p;
  a.cls = cls;
  a.d0c = d0c;
  a.m0c = m0c;
  a.B = B;
  a.chain = chain;
  a.out0 = forces;
  a.n = n_atoms;
  a.n_classes = n_classes;
  a.band = band;
  a.ke = ke;
  a.gb_pref = gb_pref;
  a.use_gb = use_gb;
  a.use_neck = use_neck;
  return launch(pair_force_kernel, a, n_replicas, use_neck != 0, stream);
}

}  // extern "C"
