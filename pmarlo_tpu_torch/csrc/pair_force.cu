// GB pair sweeps for implicit solvent: dense (NoCutoff) and tile-culled
// (gb_cutoff). pair_newton.cu holds the culled sweeps that take each
// unordered pair once.
//
// Replaces: pmarlo_tpu/md/pallas_pair.py build_pair_force_fn, its three
// dense Pallas sweeps and their ordered tile-culled forms (newton=False):
//   pair_born_kernel          <- sweep1 (:465) / born_kernel
//   pair_energy_kernel        <- sweep2 (:486) / energy_kernel
//   pair_force_kernel         <- sweep3 (:513) / force_kernel
//   pair_born_culled_kernel, pair_energy_culled_kernel, pair_force_culled_kernel
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
// and ~150 other instructions; the Born pass two HCT values and the neck
// (two special-function results where both directions are far and take the
// series, eight where both are near), the energy pass LJ + Coulomb and the
// GB f-function (three). Per-atom data is O(N) and stays in L2; nothing of
// size N^2 is ever stored. PERF.md section 6 has each sweep's time against
// its bound.
//
// Dense sweeps (pair_born_kernel, pair_energy_kernel, pair_force_kernel):
// each unordered pair once, and bit-reproducible. The row-owned design they
// replace evaluated every unordered pair twice, once in each atom's row,
// though its distance, LJ + Coulomb, GB f-function and neck are symmetric
// (only the HCT term is not, and each evaluation of the force pass already
// held both directions). One skeleton (dense_blocks) walks the pairs for all
// three, with a small per-sweep functor for what a pair adds:
// - one CTA a block (row tile r, column tile c >= r) of kTile atoms each,
//   grid (G (G + 1) / 2, replicas), the block from the CTA's index by
//   arithmetic (triangle_block). Both tiles are staged in shared memory as
//   the sweep's float4s an atom (gb_force.cuh: three for the force sweep,
//   two for Born and energy).
// - a warp takes 32 x 32 patches: lane l owns row l and at step k the column
//   (l + k) mod 32 (no two lanes read one bank); row sums stay in the lane's
//   registers, column sums travel to the next lane by a shuffle after each
//   step. A diagonal block takes the pairs with column > row only.
// - each patch's row and column sums go to their own slot in shared memory
//   (by partner group), and are added in a fixed group order: no atomics.
// - a block's sums go to the scratch buffer `slots` (R, G, N, K) with the
//   sweep's K components: atom a of tile r to slot c, atom b of tile c to
//   slot r. Each slot is written by exactly one block; dense_slots_kernel
//   then adds an atom's G slots in slot order and writes the sweep's
//   outputs. Every sum has a fixed order, so two launches give the same
//   bits; float atomics to global memory, the other way to take a pair once,
//   would not. This was chosen over one CTA a row tile walking c >= r (no
//   scratch, but the column atoms' sums would need atomics).
// - sums: the force sweep's in float32 throughout; the Born and energy
//   sweeps' in float32 within a patch (32 terms) and in float64 from there
//   (block, slots; a protein's total energy is ~1% of its components,
//   below): 32 float32 terms hold phase 6's gates (PERF.md section 6, PR 8),
//   and the conversion to float64 is a low-rate instruction on the H100.
// - slot scratch at R = 8, N = 3,726 (G = 30): force 10.7 MB, Born 7.2 MB,
//   energy 14.3 MB, in L2. The wrapper allocates it and refuses a shape
//   whose scratch exceeds a quarter of the card's memory.
// - the pair functions (gb_force.cuh) take their special functions as
//   single SFU results: rsqrt.approx, rcp.approx, lg2.approx, ex2.approx
//   (the Born sweep's HCT value takes IEEE logf, gb_force.cuh says why).
//   Measured by chip_smoke.py phase 6 on the H100 at R=8, N=3,726 (PERF.md
//   section 6 has the Born and energy sweeps' errors): the force sweep
//   against its IEEE plain version 1.34-1.39e-6 of max |F|, the whole
//   evaluation against float64 4.57-5.08e-7 (the IEEE plain evaluation: the
//   same).
//
// Culled sweeps (pair_born_culled_kernel, pair_energy_culled_kernel,
// pair_force_culled_kernel): row-owned, every ordered pair, IEEE special
// functions in the Born and energy sweeps (gb_pair.cuh, pair_common.cuh).
// - grid (row tiles of kRows, replicas); a CTA owns kRows row atoms and has
//   kRows x kSplit threads: thread (tx, ty) owns row atom tx and the
//   columns ty, ty + kSplit, ... of each staged column tile. The kSplit
//   partial sums of a row are added in a fixed order at the end, through
//   shared memory, so a launch is bit-reproducible (no atomics).
// - atoms are stored in tiles of `tile` atoms (a Morton order makes them
//   compact); the wrapper computes each tile's bounding box from the live
//   positions and the (G, G) table of tile pairs whose box gap is within
//   the cutoff, on every call. A CTA's 32 rows lie in one row tile (tile %
//   32 == 0); it walks the column tiles and skips one that the table
//   excludes: every pair of a skipped tile is farther apart than the cutoff,
//   and every pair term is cut at r > cutoff, so a skip drops exact zeros.
//   There is no list of tiles, so nothing can overflow. The band mask keys
//   on the atoms' original indices (`orig`), since storage order is a
//   permutation. The pair test is r^2 + 1e-12 <= cut_r2 with r^2 free of
//   fused multiply-adds (pair_r2.cuh) and cut_r2 the wrapper's exact
//   threshold (the same pairs as sqrt(r^2 + 1e-12) <= cutoff, no root for a
//   pair that is cut): the force jumps at the cutoff, and the plain version
//   must cut the same pairs.
// - column tiles of kThreads atoms are staged in shared memory, one atom a
//   thread; a warp reads one column entry at a time, a broadcast.
// - the GBn2 neck's (C, C) radius-class tables sit in shared memory and are
//   indexed by the two atoms' class indices (where the TPU kernel multiplied
//   one-hot class matrices on its matrix unit).
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
// - pair arithmetic is float32; the energy rows are summed (past a dense
//   patch's 32 terms) and written as float64. A protein's total energy is
//   ~1% of its summed components (3,726 atoms near a minimum: -300 to -1,400
//   kJ/mol against ~1e5 in each of the pair and GB-self sums), and float32
//   sums over whole rows left errors of ~1e-4 of the total. The culled Born
//   and energy sweeps sum in float64 throughout. Forces keep float32 sums:
//   they do not cancel that far.

#include "gb_force.cuh"
#include "pair_common.cuh"

namespace {

// the culled row-owned sweeps
constexpr int kRows = 32;                 // row atoms a CTA
constexpr int kSplit = 8;                 // column lanes a row
constexpr int kThreads = kRows * kSplit;  // threads a CTA = staged columns
// the dense block sweeps
constexpr int kTile = 128;                       // atoms a tile
constexpr int kGroups = kTile / 32;              // 32-atom groups a tile
constexpr int kDenseWarps = 8;
constexpr int kDenseThreads = 32 * kDenseWarps;  // = 2 x kTile: one staged atom a thread

// ---- dense sweeps: each unordered pair once, in (r, c >= r) tile blocks ----

// the block (row tile r, column tile c >= r) of index b, the upper triangle
// taken column by column: b = c (c + 1) / 2 + r
__device__ __forceinline__ void triangle_block(long long b, int* r, int* c) {
  long long cc = static_cast<long long>((sqrt(8.0 * static_cast<double>(b) + 1.0) - 1.0) * 0.5);
  while (cc * (cc + 1) / 2 > b) --cc;
  while ((cc + 1) * (cc + 2) / 2 <= b) ++cc;
  *c = static_cast<int>(cc);
  *r = static_cast<int>(b - cc * (cc + 1) / 2);
}

// An atom of the sweep's type (a struct of float4s) from shared memory
template <typename Atom>
__device__ __forceinline__ Atom read_atom(float4 (*parts)[kTile], int slot) {
  Atom t;
  float4* p = reinterpret_cast<float4*>(&t);
#pragma unroll
  for (int k = 0; k < static_cast<int>(sizeof(Atom) / sizeof(float4)); ++k) p[k] = parts[k][slot];
  return t;
}

// A sweep functor gives the skeleton below:
//   Atom                 the staged atom (float4s), load(a, rbase, j) builds it
//   Slot, kSums          the slots' type and components (scratch (R, G, N, kSums))
//   Acc                  a lane's sums within a patch: from_lane(src) takes
//                        lane src's (a shuffle), store(part) writes them as
//                        Slot to part[d * kTile]
//   pair(...)            adds one unordered pair's terms to the row's and
//                        the column's Acc
//   finish(a, k, sums)   writes atom k's (k = rep * N + atom) outputs from
//                        the sum of its G slots
//
// dense_blocks: one CTA, block (rt, ct) of blockIdx.x, replica blockIdx.y.
template <typename Sweep>
__device__ __forceinline__ void dense_blocks(const PairArgs& a) {
  using Atom = typename Sweep::Atom;
  using Slot = typename Sweep::Slot;
  using Acc = typename Sweep::Acc;
  constexpr int kParts = sizeof(Atom) / sizeof(float4);
  constexpr int kSums = Sweep::kSums;
  __shared__ float4 s_atom[2][kParts][kTile];              // rows, columns
  __shared__ Slot s_part[2][kGroups][kSums][kTile];        // side, partner group, sum, atom
  extern __shared__ float s_neck[];
  const int n = a.n;
  int rt, ct;
  triangle_block(blockIdx.x, &rt, &ct);
  const bool diagonal = rt == ct;
  const size_t rbase = static_cast<size_t>(blockIdx.y) * n;
  const int tid = threadIdx.x;
  if (a.use_neck) load_neck(a, s_neck, tid, kDenseThreads);
  for (int k = tid; k < 2 * kTile; k += kDenseThreads) {
    const int side = k / kTile, slot = k % kTile;
    const int j = (side ? ct : rt) * kTile + slot;
    Atom t = {};
    if (j < n) t = Sweep::load(a, rbase, j);
    const float4* p = reinterpret_cast<const float4*>(&t);
#pragma unroll
    for (int q = 0; q < kParts; ++q) s_atom[side][q][slot] = p[q];
  }
  Slot* part = &s_part[0][0][0][0];
  for (int k = tid; k < 2 * kGroups * kSums * kTile; k += kDenseThreads) part[k] = Slot(0);
  __syncthreads();

  // warp w takes the 32 x 32 patches w, w + 8, ...: lane l owns row g * 32 + l
  // and at step k the column h * 32 + (l + k) mod 32; the column sums travel
  // to the next lane after each step and arrive, after 32 steps, at the lane
  // whose index is the column's
  const int n_rows = min(kTile, n - rt * kTile);
  const int n_cols = min(kTile, n - ct * kTile);
  const int lane = tid & 31, warp = tid >> 5;
  for (int item = warp; item < kGroups * kGroups; item += kDenseWarps) {
    const int g = item / kGroups, h = item % kGroups;
    if ((diagonal && h < g) || g * 32 >= n_rows || h * 32 >= n_cols) continue;  // warp-uniform
    const bool upper_only = diagonal && g == h;   // each unordered pair once
    const int i = g * 32 + lane;
    const bool row_ok = i < n_rows;
    const Atom ai = read_atom<Atom>(s_atom[0], i);
    Acc row = {}, col = {};
    for (int k = 0; k < 32; ++k) {
      const int j = h * 32 + ((lane + k) & 31);
      const Atom aj = read_atom<Atom>(s_atom[1], j);
      const float dx = ai.p0.x - aj.p0.x, dy = ai.p0.y - aj.p0.y, dz = ai.p0.z - aj.p0.z;
      const float r2 = pair_r2(dx, dy, dz);
      // self and coincident pairs (r^2 <= 1e-8) are skipped
      if (row_ok && j < n_cols && (!upper_only || j > i) && r2 > 1e-8f) {
        Sweep::pair(a, s_neck, __fadd_rn(r2, kEps), dx, dy, dz, ai, aj, rt * kTile + i,
                    ct * kTile + j, row, col);
      }
      col.from_lane((lane + 1) & 31);
    }
    row.store(&s_part[0][h][0][i]);
    col.store(&s_part[1][g][0][h * 32 + lane]);
  }
  __syncthreads();

  // each atom's partial of this block, summed over the partner groups in a
  // fixed order, goes to the slot of the partner tile: the row atoms' to
  // slot c, the column atoms' to slot r (a diagonal block: both to slot r)
  for (int k = tid; k < 2 * kTile; k += kDenseThreads) {
    const int side = k / kTile, slot = k % kTile;
    if (slot >= (side ? n_cols : n_rows) || (diagonal && side == 1)) continue;
    const int atom = (side ? ct : rt) * kTile + slot;
    const int partner = side ? rt : ct;
    Slot* out = static_cast<Slot*>(a.slots) +
                ((static_cast<size_t>(blockIdx.y) * a.n_tiles + partner) * n + atom) * kSums;
#pragma unroll
    for (int d = 0; d < kSums; ++d) {
      Slot v = Slot(0);
      for (int p = 0; p < kGroups; ++p) v += s_part[side][p][d][slot];
      if (diagonal) {
        for (int p = 0; p < kGroups; ++p) v += s_part[1][p][d][slot];
      }
      out[d] = v;
    }
  }
}

// each atom's outputs from its G slots, summed in slot order
template <typename Sweep>
__global__ void dense_slots_kernel(PairArgs a) {
  using Slot = typename Sweep::Slot;
  constexpr int kSums = Sweep::kSums;
  const int atom = blockIdx.x * blockDim.x + threadIdx.x;
  if (atom >= a.n) return;
  const size_t rep = blockIdx.y;
  Slot v[kSums];
#pragma unroll
  for (int d = 0; d < kSums; ++d) v[d] = Slot(0);
  for (int s = 0; s < a.n_tiles; ++s) {
    const Slot* p = static_cast<const Slot*>(a.slots) + ((rep * a.n_tiles + s) * a.n + atom) * kSums;
#pragma unroll
    for (int d = 0; d < kSums; ++d) v[d] += p[d];
  }
  Sweep::finish(a, rep * a.n + atom, v);
}

// ---- sweep 1: Born integral I_i = 1/2 sum_j H(r; rho_i, sr_j) + sum_j neck ----
struct BornSweep {
  using Atom = BornAtom;
  using Slot = double;
  static constexpr int kSums = 1;
  struct Acc {
    float I;
    __device__ void from_lane(int src) { I = __shfl_sync(0xffffffffu, I, src); }
    __device__ void store(Slot* part) const { part[0] = I; }
  };
  __device__ static Atom load(const PairArgs& a, size_t rbase, int j) {
    return load_born_atom(a, rbase, j);
  }
  __device__ static void pair(const PairArgs& a, const float* s_neck, float s, float, float, float,
                              const Atom& ai, const Atom& aj, int, int, Acc& row, Acc& col) {
    const BornPair p = born_pair_values(a, s_neck, s, ai, aj);
    row.I += 0.5f * p.h_ij + p.neck;
    col.I += 0.5f * p.h_ji + p.neck;
  }
  __device__ static void finish(const PairArgs& a, size_t k, const Slot* v) {
    a.out0[k] = static_cast<float>(v[0]);
  }
};

// ---- sweep 2: pair energy rows and the pairwise part of dE/dB_i ----
// each unordered pair adds 0.5 e_nb + e_gb to both atoms' rows, as the
// row-owned rows did (half of each ordered direction), and each atom's own
// dE/dB term to it (energy_pair in gb_force.cuh: Coulomb + GB with the
// charge product factored out)
struct EnergySweep {
  using Atom = EnergyAtom;
  using Slot = double;
  static constexpr int kSums = 2;   // energy row, dE/dB
  struct Acc {
    float e, dedb;
    __device__ void from_lane(int src) {
      e = __shfl_sync(0xffffffffu, e, src);
      dedb = __shfl_sync(0xffffffffu, dedb, src);
    }
    __device__ void store(Slot* part) const {
      part[0] = e;
      part[kTile] = dedb;
    }
  };
  __device__ static Atom load(const PairArgs& a, size_t rbase, int j) {
    return load_energy_atom(a, rbase, j);
  }
  __device__ static void pair(const PairArgs& a, const float*, float s, float, float, float,
                              const Atom& ai, const Atom& aj, int i, int j, Acc& row, Acc& col) {
    // the dense path stores atoms in the caller's order: the band keys on i, j
    const EnergyPair p = energy_pair(a, s, ai, aj, abs(i - j) > a.band);
    row.e += p.e;
    col.e += p.e;
    row.dedb += p.dedb_i;
    col.dedb += p.dedb_j;
  }
  __device__ static void finish(const PairArgs& a, size_t k, const Slot* v) {
    a.rows[k] = v[0];
    a.out0[k] = static_cast<float>(v[1]);
  }
};

// ---- sweep 3: F_i = -sum_j W_ij (x_i - x_j) / r, -W d to the row atom, +W d to the column ----
struct ForceSweep {
  using Atom = ForceAtom;
  using Slot = float;
  static constexpr int kSums = 3;
  struct Acc {
    float f[3];
    __device__ void from_lane(int src) {
#pragma unroll
      for (int d = 0; d < 3; ++d) f[d] = __shfl_sync(0xffffffffu, f[d], src);
    }
    __device__ void store(Slot* part) const {
#pragma unroll
      for (int d = 0; d < 3; ++d) part[d * kTile] = f[d];
    }
  };
  __device__ static Atom load(const PairArgs& a, size_t rbase, int j) {
    return load_force_atom(a, rbase, j);
  }
  __device__ static void pair(const PairArgs& a, const float* s_neck, float s, float dx, float dy,
                              float dz, const Atom& ai, const Atom& aj, int, int, Acc& row,
                              Acc& col) {
    const float w = force_pair(a, s_neck, s, ai, aj);
    row.f[0] -= w * dx;
    row.f[1] -= w * dy;
    row.f[2] -= w * dz;
    col.f[0] += w * dx;
    col.f[1] += w * dy;
    col.f[2] += w * dz;
  }
  __device__ static void finish(const PairArgs& a, size_t k, const Slot* v) {
#pragma unroll
    for (int d = 0; d < 3; ++d) a.out0[k * 3 + d] = v[d];
  }
};

__global__ void __launch_bounds__(kDenseThreads, 2) pair_born_kernel(PairArgs a) {
  dense_blocks<BornSweep>(a);
}

__global__ void __launch_bounds__(kDenseThreads, 2) pair_energy_kernel(PairArgs a) {
  dense_blocks<EnergySweep>(a);
}

__global__ void __launch_bounds__(kDenseThreads, 2) pair_force_kernel(PairArgs a) {
  dense_blocks<ForceSweep>(a);
}

// ---- culled sweeps: row-owned over the column tiles the close table keeps ----

// The column tiles a CTA walks: the G tiles of `tile` atoms, less those its
// row tile's line of the close table excludes.
struct ColumnTiles {
  const uint8_t* close;
  int n_tiles, tile, n;
  __device__ ColumnTiles(const PairArgs& a) : n_tiles(a.n_tiles), tile(a.tile), n(a.n) {
    const int row_tile = (blockIdx.x * kRows) / a.tile;
    close = a.close + (static_cast<size_t>(blockIdx.y) * a.n_tiles + row_tile) * a.n_tiles;
  }
  __device__ bool skip(int t) const { return !close[t]; }
  __device__ int lo(int t) const { return t * tile; }
  __device__ int hi(int t) const { return min((t + 1) * tile, n); }
};

// A pair's r from two positions, or false for a pair that contributes
// nothing: a self or coincident slot, or a pair beyond the cutoff.
__device__ __forceinline__ bool pair_distance(const PairArgs& a, float dx, float dy, float dz,
                                              float* r) {
  const float r2 = pair_r2(dx, dy, dz);
  if (r2 <= 1e-8f) return false;
  const float s = __fadd_rn(r2, kEps);
  if (s > a.cut_r2) return false;
  *r = sqrtf(s);
  return true;
}

// ---- sweep 1, culled: Born integral ----
__global__ void __launch_bounds__(kThreads) pair_born_culled_kernel(PairArgs a) {
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
  const ColumnTiles tiles(a);
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
        if (!pair_distance(a, xi - s_x[jj], yi - s_y[jj], zi - s_z[jj], &r)) continue;
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

// ---- sweep 2, culled: pair energy rows and the pairwise part of dE/dB_i ----
__global__ void __launch_bounds__(kThreads) pair_energy_culled_kernel(PairArgs a) {
  __shared__ float s_x[kThreads], s_y[kThreads], s_z[kThreads];
  __shared__ float s_q[kThreads], s_sig[kThreads], s_seps[kThreads], s_B[kThreads];
  __shared__ int s_orig[kThreads];
  __shared__ double s_red[2][kSplit][kRows];
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
    orig_i = a.orig[i];
  }
  double e_row = 0.0, dedb = 0.0;
  const ColumnTiles tiles(a);
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
        s_orig[tid] = a.orig[j];
      }
      __syncthreads();
      const int cnt = min(kThreads, hi - t0);
      if (!own) continue;
      for (int jj = ty; jj < cnt; jj += kSplit) {
        float r;
        if (!pair_distance(a, xi - s_x[jj], yi - s_y[jj], zi - s_z[jj], &r)) continue;
        float dedb_i, dedb_j;
        // the band keys on the caller's indices: storage order is a permutation of them
        e_row += pair_energy_ieee(a.ke, a.gb_pref, a.use_gb, r, 1.0f / r, q_i * s_q[jj], sig_i,
                                  s_sig[jj], seps_i * s_seps[jj], B_i, s_B[jj],
                                  abs(orig_i - s_orig[jj]) > a.band, &dedb_i, &dedb_j);
        dedb += dedb_i;
      }
    }
  }
  s_red[0][ty][tx] = e_row;
  s_red[1][ty][tx] = dedb;
  __syncthreads();
  if (ty == 0 && own) {
    double e = 0.0, db = 0.0;
    for (int s = 0; s < kSplit; ++s) {
      e += s_red[0][s][tx];
      db += s_red[1][s][tx];
    }
    a.rows[rbase + i] = e;
    a.out0[rbase + i] = static_cast<float>(db);
  }
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
  const ColumnTiles tiles(a);
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

// the block sweep `kernel` of Sweep and its slot sum, on tiles of kTile atoms
template <typename Sweep>
int launch_dense(const void* kernel, PairArgs a, int n_replicas, size_t neck, cudaStream_t s) {
  if (a.slots == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  a.tile = kTile;
  a.n_tiles = (a.n + kTile - 1) / kTile;
  const long long blocks = static_cast<long long>(a.n_tiles) * (a.n_tiles + 1) / 2;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(neck));
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&a};
  err = cudaLaunchKernel(kernel, dim3(static_cast<unsigned>(blocks), n_replicas),
                         dim3(kDenseThreads), args, neck, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dense_slots_kernel<Sweep><<<dim3((a.n + 255) / 256, n_replicas), 256, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int launch(int sweep, int mode, const PairArgs& a, int n_replicas, void* stream) {
  const size_t neck = a.use_neck ? 2 * sizeof(float) * a.n_classes * a.n_classes : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == kDense) {
    switch (sweep) {
      case kBorn:
        return launch_dense<BornSweep>(reinterpret_cast<const void*>(pair_born_kernel), a,
                                       n_replicas, neck, s);
      case kEnergy:
        return launch_dense<EnergySweep>(reinterpret_cast<const void*>(pair_energy_kernel), a,
                                         n_replicas, neck, s);
      case kForce:
        return launch_dense<ForceSweep>(reinterpret_cast<const void*>(pair_force_kernel), a,
                                        n_replicas, neck, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (mode != kCulled || a.tile < kRows || a.tile % kRows != 0 || a.close == nullptr ||
      a.orig == nullptr || !a.has_cut) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((a.n + kRows - 1) / kRows, n_replicas);
  const dim3 block(kRows, kSplit);
  if (sweep == kBorn) {
    pair_born_culled_kernel<<<grid, block, neck, s>>>(a);
  } else if (sweep == kEnergy) {
    pair_energy_culled_kernel<<<grid, block, 0, s>>>(a);
  } else if (sweep == kForce) {
    pair_force_culled_kernel<<<grid, block, neck, s>>>(a);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int pmarlo_pair_max_classes() { return kMaxClasses; }

// atoms a tile of the dense sweeps: their scratch `slots` is (R,
// ceil(N / tile), N, K): K = 1 float32 (Born), 2 float64 (energy: row,
// dE/dB), 3 float32 (force)
int pmarlo_pair_force_tile() { return kTile; }

// One sweep (`sweep`: 0 Born integral into `out0`, 1 energy rows into
// `rows` and dE/dB into `out0`, 2 forces into `out0`) in `mode` 0 (dense;
// needs `slots`) or 1 (tile-culled: `orig`, `close`, `tile` and `cut_r2`
// are read). Returns cudaGetLastError() after the launch on `stream` (0 =
// launched).
int pmarlo_pair_sweep(int sweep, int mode, const float* x, const float* atom_p, const int* cls,
                      const int* orig, const float* d0c, const float* m0c, int n_classes,
                      const float* B, const float* chain, const uint8_t* close, int n_replicas,
                      int n_atoms, int tile, int band, float ke, float gb_pref, float cut_r2,
                      int use_gb, int use_neck, float* out0, double* rows, void* slots,
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
  return launch(sweep, mode, a, n_replicas, stream);
}

}  // extern "C"
