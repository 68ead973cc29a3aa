// Row-owned GB pair sweeps for implicit solvent: dense (NoCutoff) and
// tile-culled (gb_cutoff).
//
// Replaces: pmarlo_tpu/md/pallas_pair.py build_pair_force_fn, its three
// dense Pallas sweeps and their ordered tile-culled forms (newton=False):
//   pair_born_kernel   <- sweep1 / born_kernel,   sweep1_c / born_culled
//   pair_energy_kernel <- sweep2 / energy_kernel, sweep2_c / energy_culled
//   pair_force_kernel  <- sweep3 / force_kernel,  sweep3_c / force_culled
// Each kernel is a template on kCull: <false> is the dense sweep, <true> the
// culled one. pair_newton.cu holds the sweeps that take each tile block once.
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
// - culled sweeps (kCull): atoms are stored in tiles of `tile` atoms (a
//   Morton order makes them compact); the wrapper computes each tile's
//   bounding box from the live positions and the (G, G) table of tile pairs
//   whose box gap is within the cutoff, on every call. A CTA's 32 rows lie
//   in one row tile (tile % 32 == 0); it walks the column tiles and skips
//   one that the table excludes: every pair of a skipped tile is farther
//   apart than the cutoff, and every pair term is cut at r > cutoff, so a
//   skip drops exact zeros. There is no list of tiles, so nothing can
//   overflow. The band mask keys on the atoms' original indices (`orig`),
//   since storage order is a permutation. The pair test is
//   r^2 + 1e-12 <= cut_r2 with r^2 free of fused multiply-adds (pair_r2.cuh)
//   and cut_r2 the wrapper's exact threshold (the same pairs as
//   sqrt(r^2 + 1e-12) <= cutoff, no root for a pair that is cut): the force
//   jumps at the cutoff, and the plain twin must cut the same pairs.
// - pair arithmetic is float32; the Born and energy sums accumulate in
//   float64, and the energy rows are written as float64. A protein's total
//   energy is ~1% of its summed components (3,726 atoms near a minimum:
//   -300 to -1,400 kJ/mol against ~1e5 in each of the pair and GB-self
//   sums), and float32 sums left errors of ~1e-4 of the total. Forces keep
//   float32 sums: they do not cancel that far.

#include "pair_common.cuh"

namespace {

constexpr int kRows = 32;                 // row atoms a CTA
constexpr int kSplit = 8;                 // column lanes a row
constexpr int kThreads = kRows * kSplit;  // threads a CTA = staged columns

// The column range a CTA walks: the dense sweep takes [0, n) as one tile,
// the culled sweep the G tiles of `tile` atoms, less those its row tile's
// line of the close table excludes.
template <bool kCull>
struct ColumnTiles {
  const uint8_t* close;
  int n_tiles, tile, n;
  __device__ ColumnTiles(const PairArgs& a)
      : close(nullptr), n_tiles(kCull ? a.n_tiles : 1), tile(kCull ? a.tile : a.n), n(a.n) {
    if (kCull) {
      const int row_tile = (blockIdx.x * kRows) / a.tile;
      close = a.close + (static_cast<size_t>(blockIdx.y) * a.n_tiles + row_tile) * a.n_tiles;
    }
  }
  __device__ bool skip(int t) const { return kCull && !close[t]; }
  __device__ int lo(int t) const { return t * tile; }
  __device__ int hi(int t) const { return min((t + 1) * tile, n); }
};

// A pair's r from two positions, or false for a pair that contributes
// nothing: a self or coincident slot, or (culled) a pair beyond the cutoff.
template <bool kCull>
__device__ __forceinline__ bool pair_distance(const PairArgs& a, float dx, float dy, float dz,
                                              float* r) {
  const float r2 = pair_r2(dx, dy, dz);
  if (r2 <= 1e-8f) return false;
  const float s = __fadd_rn(r2, kEps);
  if (kCull && s > a.cut_r2) return false;
  *r = sqrtf(s);
  return true;
}

// ---- sweep 1: Born integral I_i = 1/2 sum_j H(r; rho_i, sr_j) + sum_j neck ----
template <bool kCull>
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
  if (a.use_neck) load_neck(a, s_neck, tid, kThreads);

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
  const ColumnTiles<kCull> tiles(a);
  for (int t = 0; t < tiles.n_tiles; ++t) {
    if (tiles.skip(t)) continue;
    const int hi = tiles.hi(t);
    for (int t0 = tiles.lo(t); t0 < hi; t0 += kThreads) {
      __syncthreads();
      const int j = t0 + tid;
      if (j < hi) {
        s_x[tid] = xr[3 * j];
        s_y[tid] = xr[3 * j + 1];
        s_z[tid] = xr[3 * j + 2];
        s_sr[tid] = a.atom_p[kSr * n + j];
        s_cls[tid] = a.cls[j];
      }
      __syncthreads();
      const int cnt = min(kThreads, hi - t0);
      if (!own) continue;
      for (int jj = ty; jj < cnt; jj += kSplit) {
        float r;
        if (!pair_distance<kCull>(a, xi - s_x[jj], yi - s_y[jj], zi - s_z[jj], &r)) continue;
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
template <bool kCull>
__global__ void __launch_bounds__(kThreads) pair_energy_kernel(PairArgs a) {
  __shared__ float s_x[kThreads], s_y[kThreads], s_z[kThreads];
  __shared__ float s_q[kThreads], s_sig[kThreads], s_seps[kThreads], s_B[kThreads];
  __shared__ int s_orig[kThreads];
  __shared__ double s_red[3][kSplit][kRows];
  const int n = a.n;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kRows + tx;
  const int i = blockIdx.x * kRows + tx;
  const bool own = i < n;
  const size_t rbase = static_cast<size_t>(blockIdx.y) * n;
  const float* xr = a.x + rbase * 3;

  float xi = 0.0f, yi = 0.0f, zi = 0.0f, q_i = 0.0f, sig_i = 0.0f, seps_i = 0.0f, B_i = 1.0f;
  int orig_i = i;
  if (own) {
    xi = xr[3 * i];
    yi = xr[3 * i + 1];
    zi = xr[3 * i + 2];
    q_i = a.atom_p[kQ * n + i];
    sig_i = a.atom_p[kSig * n + i];
    seps_i = a.atom_p[kSeps * n + i];
    if (a.use_gb) B_i = a.B[rbase + i];
    if (kCull) orig_i = a.orig[i];
  }
  double e_nb = 0.0, e_gb = 0.0, dedb = 0.0;
  const ColumnTiles<kCull> tiles(a);
  for (int t = 0; t < tiles.n_tiles; ++t) {
    if (tiles.skip(t)) continue;
    const int hi = tiles.hi(t);
    for (int t0 = tiles.lo(t); t0 < hi; t0 += kThreads) {
      __syncthreads();
      const int j = t0 + tid;
      if (j < hi) {
        s_x[tid] = xr[3 * j];
        s_y[tid] = xr[3 * j + 1];
        s_z[tid] = xr[3 * j + 2];
        s_q[tid] = a.atom_p[kQ * n + j];
        s_sig[tid] = a.atom_p[kSig * n + j];
        s_seps[tid] = a.atom_p[kSeps * n + j];
        s_B[tid] = a.use_gb ? a.B[rbase + j] : 1.0f;
        if (kCull) s_orig[tid] = a.orig[j];
      }
      __syncthreads();
      const int cnt = min(kThreads, hi - t0);
      if (!own) continue;
      for (int jj = ty; jj < cnt; jj += kSplit) {
        float r;
        if (!pair_distance<kCull>(a, xi - s_x[jj], yi - s_y[jj], zi - s_z[jj], &r)) continue;
        const float inv_r = 1.0f / r;
        const float qq = q_i * s_q[jj];
        // the band keys on the caller's indices: storage order is a permutation
        // of them on the culled path only
        if (abs(orig_i - (kCull ? s_orig[jj] : t0 + jj)) > a.band) {
          e_nb += nb_energy(lj_sr6(sig_i, s_sig[jj], inv_r), seps_i * s_seps[jj], a.ke, qq,
                            inv_r);
        }
        if (a.use_gb) {
          const float B_j = s_B[jj];
          const float rsq = r * r;
          float expu, inv_f;
          gb_f(rsq, B_i * B_j, &expu, &inv_f);
          const float qq_gb = a.gb_pref * qq;
          e_gb += qq_gb * inv_f;
          dedb += gb_dedb(qq_gb, inv_f, expu, rsq, B_i, B_j);
        }
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
template <bool kCull>
__global__ void __launch_bounds__(kThreads) pair_force_kernel(PairArgs a) {
  __shared__ float s_x[kThreads], s_y[kThreads], s_z[kThreads];
  __shared__ float s_q[kThreads], s_sig[kThreads], s_seps[kThreads];
  __shared__ float s_B[kThreads], s_c[kThreads], s_rho[kThreads], s_sr[kThreads];
  __shared__ int s_cls[kThreads], s_orig[kThreads];
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
  if (a.use_neck) load_neck(a, s_neck, tid, kThreads);

  float xi = 0.0f, yi = 0.0f, zi = 0.0f, q_i = 0.0f, sig_i = 0.0f, seps_i = 0.0f;
  float B_i = 1.0f, c_i = 0.0f, rho_i = 1.0f, sr_i = 0.0f;
  int ci = 0, orig_i = i;
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
    if (kCull) orig_i = a.orig[i];
  }
  float fx = 0.0f, fy = 0.0f, fz = 0.0f;
  const ColumnTiles<kCull> tiles(a);
  for (int t = 0; t < tiles.n_tiles; ++t) {
    if (tiles.skip(t)) continue;
    const int hi = tiles.hi(t);
    for (int t0 = tiles.lo(t); t0 < hi; t0 += kThreads) {
      __syncthreads();
      const int j = t0 + tid;
      if (j < hi) {
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
        if (kCull) s_orig[tid] = a.orig[j];
      }
      __syncthreads();
      const int cnt = min(kThreads, hi - t0);
      if (!own) continue;
      for (int jj = ty; jj < cnt; jj += kSplit) {
        const float dx = xi - s_x[jj], dy = yi - s_y[jj], dz = zi - s_z[jj];
        float r;
        if (!pair_distance<kCull>(a, dx, dy, dz, &r)) continue;
        const float inv_r = 1.0f / r;
        const float qq = q_i * s_q[jj];
        // dE/dr of the unordered pair
        float W = 0.0f;
        // the band keys on the caller's indices: storage order is a permutation
        // of them on the culled path only
        if (abs(orig_i - (kCull ? s_orig[jj] : t0 + jj)) > a.band) {
          W = nb_dedr(lj_sr6(sig_i, s_sig[jj], inv_r), seps_i * s_seps[jj], a.ke, qq, inv_r);
        }
        if (a.use_gb) {
          float expu, inv_f;
          gb_f(r * r, B_i * s_B[jj], &expu, &inv_f);
          W += gb_dedr(a.gb_pref, qq, r, inv_f, expu);
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

template <bool kCull>
int launch(int sweep, const PairArgs& a, int n_replicas, void* stream) {
  if (kCull && (a.tile < kRows || a.tile % kRows != 0 || a.close == nullptr ||
                a.orig == nullptr || !a.has_cut)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((a.n + kRows - 1) / kRows, n_replicas);
  const dim3 block(kRows, kSplit);
  const size_t neck = a.use_neck ? 2 * sizeof(float) * a.n_classes * a.n_classes : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sweep == kBorn) {
    pair_born_kernel<kCull><<<grid, block, neck, s>>>(a);
  } else if (sweep == kEnergy) {
    pair_energy_kernel<kCull><<<grid, block, 0, s>>>(a);
  } else if (sweep == kForce) {
    pair_force_kernel<kCull><<<grid, block, neck, s>>>(a);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int pmarlo_pair_max_classes() { return kMaxClasses; }

// One row-owned sweep (`sweep`: 0 Born integral into `out0`, 1 energy rows
// into `rows` and dE/dB into `out0`, 2 forces into `out0`) in `mode` 0
// (dense) or 1 (tile-culled: `orig`, `close`, `tile` and `cut_r2` are read).
// Returns cudaGetLastError() after the launch on `stream` (0 = launched).
int pmarlo_pair_sweep(int sweep, int mode, const float* x, const float* atom_p, const int* cls,
                      const int* orig, const float* d0c, const float* m0c, int n_classes,
                      const float* B, const float* chain, const uint8_t* close, int n_replicas,
                      int n_atoms, int tile, int band, float ke, float gb_pref, float cut_r2,
                      int use_gb, int use_neck, float* out0, double* rows, void* stream) {
  if (n_atoms < 1 || n_replicas < 1 || n_replicas > 65535 || n_classes < 1 ||
      n_classes > kMaxClasses || band < 0 || tile < 1) {
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
  a.has_cut = mode == kCulled;
  a.ke = ke;
  a.gb_pref = gb_pref;
  a.use_gb = use_gb;
  a.use_neck = use_neck && sweep != kEnergy;
  if (mode == kDense) return launch<false>(sweep, a, n_replicas, stream);
  if (mode == kCulled) return launch<true>(sweep, a, n_replicas, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
