// GB pair sweeps for implicit solvent: dense (NoCutoff) and tile-culled
// (gb_cutoff). pair_newton.cu holds the culled sweeps that take each tile
// block once.
//
// Replaces: pmarlo_tpu/md/pallas_pair.py build_pair_force_fn, its three
// dense Pallas sweeps and their ordered tile-culled forms (newton=False):
//   pair_born_kernel<false>   <- sweep1 (:465) / born_kernel
//   pair_energy_kernel<false> <- sweep2 (:486) / energy_kernel
//   pair_force_kernel         <- sweep3 (:513) / force_kernel
//   pair_born_kernel<true>, pair_energy_kernel<true>, pair_force_culled_kernel
//                             <- sweep1_c / sweep2_c / sweep3_c (born_culled,
//                                energy_culled, force_culled)
// The glue between the sweeps (tanh rescale, 1/B clamp, self and SA terms,
// chain coefficients), the band add-back of the exclusions and the bonded
// terms are plain PyTorch in md/pair_force.py, which also holds each
// sweep's plain version.
//
// What bounds them on an H100: arithmetic, not bytes. A force evaluation is
// three passes over the pairs (R = 8, N = 3,726: 55.5 M unordered pairs);
// the force pass's pair function (gb_force.cuh) holds two HCT derivatives,
// the GB f-function, LJ + Coulomb and the neck, ten special-function results
// and ~150 other instructions. Per-atom data is O(N) and stays in L2;
// nothing of size N^2 is ever stored. The dense force sweep takes about
// three times its bound (ten SFU results for each unordered pair once;
// PERF.md section 6): the other instructions of a pair, issued beside them.
//
// Born and energy sweeps (both modes) and the culled force sweep: row-owned.
// - grid (row tiles, replicas); a CTA owns kRows row atoms and has
//   kRows x kSplit threads: thread (tx, ty) owns row atom tx and the
//   columns ty, ty + kSplit, ... of each staged column tile. The kSplit
//   partial sums of a row are added in a fixed order at the end, through
//   shared memory, so a launch is bit-reproducible (no atomics).
// - column tiles of kThreads atoms are staged in shared memory, one atom a
//   thread; a warp reads one column entry at a time, a broadcast.
// - the GBn2 neck's (C, C) radius-class tables sit in shared memory and are
//   indexed by the two atoms' class indices (where the TPU kernel multiplied
//   one-hot class matrices on its matrix unit).
//
// Dense force sweep (pair_force_kernel): each unordered pair once, and
// bit-reproducible. The row-owned design evaluated every unordered pair
// twice, once in each atom's row, and each evaluation already held both
// HCT directions: half its work was repeated. Now:
// - one CTA a block (row tile r, column tile c >= r) of kForceTile atoms
//   each, grid (G (G + 1) / 2, replicas), the block from the CTA's index by
//   arithmetic (triangle_block). Both tiles are staged in shared memory as
//   three float4 an atom (gb_force.cuh).
// - a warp takes 32 x 32 patches: lane l owns row l and at step k the column
//   (l + k) mod 32 (no two lanes read one bank); row sums stay in the lane's
//   registers, column sums travel to the next lane by a shuffle after each
//   step. A diagonal block takes the pairs with column > row only.
// - each patch's row and column sums go to their own slot in shared memory
//   (by partner group), and are added in a fixed group order: no atomics.
// - a block's sums go to the scratch buffer `slots` (R, G, N, 3): atom a of
//   tile r to slot c, atom b of tile c to slot r. Each slot is written by
//   exactly one block; pair_force_slots_kernel then adds an atom's G slots
//   in slot order. Every sum has a fixed order, so two launches give the
//   same bits; float atomics to global memory, the other way to take a pair
//   once, would not (the row-owned sweeps are the port's bit-reproducible
//   path). The scratch is 8 x 30 x 3,726 x 12 B = 10.7 MB at the protein
//   shape, in L2. This was chosen over one CTA a row tile walking c >= r
//   (no scratch, but the column atoms' sums would need atomics).
// - the pair function (gb_force.cuh) takes its special functions as single
//   SFU results: rsqrt.approx, rcp.approx, lg2.approx, ex2.approx. Measured
//   by chip_smoke.py phase 6 on the H100 at R=8, N=3,726: the sweep against
//   its IEEE plain version 1.34-1.39e-6 of max |F|, the whole evaluation
//   against float64 4.57-5.08e-7 (the IEEE plain evaluation: the same).
//
// Common to all sweeps:
// - exclusions: LJ and Coulomb are masked for |i - j| <= band (index band);
//   the wrapper adds the band back at its wanted scale. GB terms are never
//   masked: Born screening counts bonded pairs.
// - self and coincident pairs (r^2 <= 1e-8) are skipped before any 1/r^k.
// - the force pass evaluates the derivative of what the Born and energy
//   passes sum: the same expressions, including both Born chain directions
//   c_i dI_i/dr_ij + c_j dI_j/dr_ji, so F = -grad E.
// - ragged last tiles are masked in the kernel; no padding atoms exist.
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
//   jumps at the cutoff, and the plain version must cut the same pairs.
// - pair arithmetic is float32; the Born and energy sums accumulate in
//   float64, and the energy rows are written as float64. A protein's total
//   energy is ~1% of its summed components (3,726 atoms near a minimum:
//   -300 to -1,400 kJ/mol against ~1e5 in each of the pair and GB-self
//   sums), and float32 sums left errors of ~1e-4 of the total. Forces keep
//   float32 sums: they do not cancel that far.

#include "gb_force.cuh"
#include "pair_common.cuh"

namespace {

constexpr int kRows = 32;                 // row atoms a CTA
constexpr int kSplit = 8;                 // column lanes a row
constexpr int kThreads = kRows * kSplit;  // threads a CTA = staged columns
// the dense force sweep
constexpr int kForceTile = 128;                  // atoms a tile
constexpr int kForceGroups = kForceTile / 32;    // 32-atom groups a tile
constexpr int kForceWarps = 8;
constexpr int kForceThreads = 32 * kForceWarps;  // = 2 x kForceTile: one staged atom a thread

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

// ---- sweep 3, dense: F_i = -sum_j W_ij (x_i - x_j) / r, each unordered pair once ----

// the block (row tile r, column tile c >= r) of index b, the upper triangle
// taken column by column: b = c (c + 1) / 2 + r
__device__ __forceinline__ void triangle_block(long long b, int* r, int* c) {
  long long cc = static_cast<long long>((sqrt(8.0 * static_cast<double>(b) + 1.0) - 1.0) * 0.5);
  while (cc * (cc + 1) / 2 > b) --cc;
  while ((cc + 1) * (cc + 2) / 2 <= b) ++cc;
  *c = static_cast<int>(cc);
  *r = static_cast<int>(b - cc * (cc + 1) / 2);
}

__global__ void __launch_bounds__(kForceThreads, 2) pair_force_kernel(PairArgs a) {
  __shared__ float4 s_atom[2][3][kForceTile];                // rows, columns: p0 p1 p2
  __shared__ float s_part[2][kForceGroups][3][kForceTile];   // side, partner group, axis, atom
  extern __shared__ float s_neck[];
  const int n = a.n;
  int rt, ct;
  triangle_block(blockIdx.x, &rt, &ct);
  const bool diagonal = rt == ct;
  const size_t rbase = static_cast<size_t>(blockIdx.y) * n;
  const int tid = threadIdx.x;
  if (a.use_neck) load_neck(a, s_neck, tid, kForceThreads);
  for (int k = tid; k < 2 * kForceTile; k += kForceThreads) {
    const int side = k / kForceTile, slot = k % kForceTile;
    const int j = (side ? ct : rt) * kForceTile + slot;
    ForceAtom t = {};
    if (j < n) t = load_force_atom(a, rbase, j);
    s_atom[side][0][slot] = t.p0;
    s_atom[side][1][slot] = t.p1;
    s_atom[side][2][slot] = t.p2;
  }
  float* part = &s_part[0][0][0][0];
  for (int k = tid; k < 2 * kForceGroups * 3 * kForceTile; k += kForceThreads) part[k] = 0.0f;
  __syncthreads();

  // warp w takes the 32 x 32 patches w, w + 8, ...: lane l owns row g * 32 + l
  // and at step k the column h * 32 + (l + k) mod 32; the column sums travel
  // to the next lane after each step and arrive, after 32 steps, at the lane
  // whose index is the column's
  const int n_rows = min(kForceTile, n - rt * kForceTile);
  const int n_cols = min(kForceTile, n - ct * kForceTile);
  const int lane = tid & 31, warp = tid >> 5;
  for (int item = warp; item < kForceGroups * kForceGroups; item += kForceWarps) {
    const int g = item / kForceGroups, h = item % kForceGroups;
    if ((diagonal && h < g) || g * 32 >= n_rows || h * 32 >= n_cols) continue;  // warp-uniform
    const bool upper_only = diagonal && g == h;   // each unordered pair once
    const int i = g * 32 + lane;
    const bool row_ok = i < n_rows;
    const ForceAtom ai = {s_atom[0][0][i], s_atom[0][1][i], s_atom[0][2][i]};
    float fr[3] = {0.0f, 0.0f, 0.0f}, fc[3] = {0.0f, 0.0f, 0.0f};
    for (int k = 0; k < 32; ++k) {
      const int j = h * 32 + ((lane + k) & 31);
      const ForceAtom aj = {s_atom[1][0][j], s_atom[1][1][j], s_atom[1][2][j]};
      const float dx = ai.p0.x - aj.p0.x, dy = ai.p0.y - aj.p0.y, dz = ai.p0.z - aj.p0.z;
      const float r2 = pair_r2(dx, dy, dz);
      // self and coincident pairs (r^2 <= 1e-8) are skipped
      if (row_ok && j < n_cols && (!upper_only || j > i) && r2 > 1e-8f) {
        const float w = force_pair(a, s_neck, __fadd_rn(r2, kEps), ai, aj);
        fr[0] -= w * dx;
        fr[1] -= w * dy;
        fr[2] -= w * dz;
        fc[0] += w * dx;
        fc[1] += w * dy;
        fc[2] += w * dz;
      }
#pragma unroll
      for (int d = 0; d < 3; ++d) fc[d] = __shfl_sync(0xffffffffu, fc[d], (lane + 1) & 31);
    }
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      s_part[0][h][d][i] = fr[d];
      s_part[1][g][d][h * 32 + lane] = fc[d];
    }
  }
  __syncthreads();

  // each atom's partial of this block, summed over the partner groups in a
  // fixed order, goes to the slot of the partner tile: the row atoms' to
  // slot c, the column atoms' to slot r (a diagonal block: both to slot r)
  for (int k = tid; k < 2 * kForceTile; k += kForceThreads) {
    const int side = k / kForceTile, slot = k % kForceTile;
    if (slot >= (side ? n_cols : n_rows) || (diagonal && side == 1)) continue;
    float f[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      f[d] = 0.0f;
      for (int p = 0; p < kForceGroups; ++p) f[d] += s_part[side][p][d][slot];
      if (diagonal) {
        for (int p = 0; p < kForceGroups; ++p) f[d] += s_part[1][p][d][slot];
      }
    }
    const int atom = (side ? ct : rt) * kForceTile + slot;
    const int partner = side ? rt : ct;
    float* out = a.slots + ((static_cast<size_t>(blockIdx.y) * a.n_tiles + partner) * n + atom) * 3;
    out[0] = f[0];
    out[1] = f[1];
    out[2] = f[2];
  }
}

// F of each atom: its G slots summed in slot order
__global__ void pair_force_slots_kernel(PairArgs a) {
  const int atom = blockIdx.x * blockDim.x + threadIdx.x;
  if (atom >= a.n) return;
  const size_t rep = blockIdx.y;
  float f0 = 0.0f, f1 = 0.0f, f2 = 0.0f;
  for (int s = 0; s < a.n_tiles; ++s) {
    const float* p = a.slots + ((rep * a.n_tiles + s) * a.n + atom) * 3;
    f0 += p[0];
    f1 += p[1];
    f2 += p[2];
  }
  float* fo = a.out0 + (rep * a.n + atom) * 3;
  fo[0] = f0;
  fo[1] = f1;
  fo[2] = f2;
}

// ---- sweep 3, culled: row-owned, F_i = -sum_j W_ij (x_i - x_j) / r ----
__global__ void __launch_bounds__(kThreads) pair_force_culled_kernel(PairArgs a) {
  __shared__ float4 s_col[3][kThreads];
  __shared__ float s_red[3][kSplit][kRows];
  extern __shared__ float s_neck[];
  const int n = a.n;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kRows + tx;
  const int i = blockIdx.x * kRows + tx;
  const bool own = i < n;
  const size_t rbase = static_cast<size_t>(blockIdx.y) * n;
  if (a.use_neck) load_neck(a, s_neck, tid, kThreads);

  ForceAtom ai = {};
  if (own) ai = load_force_atom(a, rbase, i);
  float fx = 0.0f, fy = 0.0f, fz = 0.0f;
  const ColumnTiles<true> tiles(a);
  for (int t = 0; t < tiles.n_tiles; ++t) {
    if (tiles.skip(t)) continue;
    const int hi = tiles.hi(t);
    for (int t0 = tiles.lo(t); t0 < hi; t0 += kThreads) {
      __syncthreads();
      const int j = t0 + tid;
      if (j < hi) {
        const ForceAtom aj = load_force_atom(a, rbase, j);
        s_col[0][tid] = aj.p0;
        s_col[1][tid] = aj.p1;
        s_col[2][tid] = aj.p2;
      }
      __syncthreads();
      const int cnt = min(kThreads, hi - t0);
      if (!own) continue;
      for (int jj = ty; jj < cnt; jj += kSplit) {
        const ForceAtom aj = {s_col[0][jj], s_col[1][jj], s_col[2][jj]};
        const float dx = ai.p0.x - aj.p0.x, dy = ai.p0.y - aj.p0.y, dz = ai.p0.z - aj.p0.z;
        const float r2 = pair_r2(dx, dy, dz);
        if (r2 <= 1e-8f) continue;
        const float s = __fadd_rn(r2, kEps);
        if (s > a.cut_r2) continue;
        const float w = force_pair(a, s_neck, s, ai, aj);
        fx -= w * dx;
        fy -= w * dy;
        fz -= w * dz;
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

int launch_force(PairArgs a, bool cull, int n_replicas, cudaStream_t s) {
  const int neck = a.use_neck ? 2 * sizeof(float) * a.n_classes * a.n_classes : 0;
  if (cull) {
    pair_force_culled_kernel<<<dim3((a.n + kRows - 1) / kRows, n_replicas), dim3(kRows, kSplit),
                               neck, s>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  if (a.slots == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  a.tile = kForceTile;
  a.n_tiles = (a.n + kForceTile - 1) / kForceTile;
  const long long blocks = static_cast<long long>(a.n_tiles) * (a.n_tiles + 1) / 2;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void*>(pair_force_kernel),
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, neck);
  if (err != cudaSuccess) return static_cast<int>(err);
  pair_force_kernel<<<dim3(static_cast<unsigned>(blocks), n_replicas), kForceThreads, neck, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  pair_force_slots_kernel<<<dim3((a.n + 255) / 256, n_replicas), 256, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
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
    return launch_force(a, kCull, n_replicas, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int pmarlo_pair_max_classes() { return kMaxClasses; }

// atoms a tile of the dense force sweep: its scratch `slots` is
// (R, ceil(N / tile), N, 3) float32
int pmarlo_pair_force_tile() { return kForceTile; }

// One sweep (`sweep`: 0 Born integral into `out0`, 1 energy rows into
// `rows` and dE/dB into `out0`, 2 forces into `out0`) in `mode` 0 (dense;
// the force sweep needs `slots`) or 1 (tile-culled: `orig`, `close`, `tile`
// and `cut_r2` are read). Returns cudaGetLastError() after the launch on
// `stream` (0 = launched).
int pmarlo_pair_sweep(int sweep, int mode, const float* x, const float* atom_p, const int* cls,
                      const int* orig, const float* d0c, const float* m0c, int n_classes,
                      const float* B, const float* chain, const uint8_t* close, int n_replicas,
                      int n_atoms, int tile, int band, float ke, float gb_pref, float cut_r2,
                      int use_gb, int use_neck, float* out0, double* rows, float* slots,
                      void* stream) {
  // (n_atoms < 2^25: the force sweeps pack orig * 64 + class into 32 bits)
  if (n_atoms < 1 || n_atoms >= (1 << 25) || n_replicas < 1 || n_replicas > 65535 ||
      n_classes < 1 || n_classes > kMaxClasses || band < 0 || tile < 1) {
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
  a.slots = slots;
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
