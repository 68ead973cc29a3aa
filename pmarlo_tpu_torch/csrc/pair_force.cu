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
// pair_force_culled_kernel): every ordered pair, no atomics, so a launch is
// bit-reproducible (the Newton sweeps of pair_newton.cu take each pair once
// and add with atomics).
// - atoms are stored in tiles of `tile` atoms (a Morton order makes them
//   compact); the wrapper computes each tile's bounding box from the live
//   positions and the (G, G) table `close` of tile pairs whose box gap is
//   within the cutoff, on every call. A sweep skips a column tile that its
//   row tile's line of the table excludes: every pair of a skipped tile is
//   farther apart than the cutoff, and every pair term is cut at r >
//   cutoff, so a skip drops exact zeros. There is no list of tiles, so
//   nothing can overflow. The band mask keys on the atoms' original indices
//   (`orig`), since storage order is a permutation. The pair test is r^2 +
//   1e-12 <= cut_r2 with r^2 free of fused multiply-adds (pair_r2.cuh) and
//   cut_r2 the wrapper's exact threshold (the same pairs as sqrt(r^2 +
//   1e-12) <= cutoff, no root for a pair that is cut): the force jumps at
//   the cutoff, and the plain version must cut the same pairs.
// - one walk for the three (culled_walk, the Newton walk of pair_newton.cu
//   made ordered), with the sweep's functor for what an ordered pair adds to
//   its row atom. At 61,824 atoms 3.9% of the pairs of the tile blocks
//   within reach lie inside the cutoff, and the pair function is the cost,
//   so lanes run it only on pairs inside the cutoff. One warp an item: a
//   32-atom row group g and a segment s of its column groups (h = s, s +
//   kSegments, ... in increasing order, kSegments items a row group, for
//   warps enough to fill the card). The warp stages its 32 row atoms once
//   and walks the column groups 32 at a time, a lane each: it takes those
//   whose tile `close` keeps and whose box (group_boxes_kernel,
//   pair_groups.cuh) is within the cutoff of g's box (the test of
//   tiles_within at 32-atom groups, so a skip drops only exact zeros). In
//   each such 32 x 32 patch the rows within the cutoff of the column
//   group's box are found by one ballot, each is tested against the 32
//   columns on r^2 (a diagonal patch too: only coincident pairs are left
//   out), and the pairs inside the cutoff are compacted by ballot into the
//   warp's queue; every 32 of them run the pair function on a full warp.
//   The queue carries across patches (the column atoms of two patches are
//   staged), so batches stay full. A row's pairs sit in consecutive lanes
//   of a batch: segmented shuffles add them and the segment's first lane
//   adds the sum to the row's shared sum. Every order is fixed (column
//   groups, rows, columns, batches), the item writes its own slot of a
//   scratch (R, kSegments, N, kSums), and dense_slots_kernel adds an atom's
//   kSegments slots in slot order: no atomics.
// - the pair functions are the dense and Newton sweeps' (gb_force.cuh),
//   the row atom's share of each: force_pair's -W d; born_pair_values'
//   H_ij / 2 + neck (its HCT value a series for a far pair, IEEE logf in the
//   near form); energy_pair's e = 0.5 e_nb + e_gb and dE/dB_i, the charge
//   product factored out. The energy sweep tests the band in the batch, on
//   the caller's indices held in registers (a lane's row atom, and its
//   column atom of each column buffer) and read by shuffles: three a batch,
//   where a test at queueing (the Newton energy sweep's) took one a near row
//   (0.293 -> 0.274 ms at 61,824 atoms on an H100 at 700 W,
//   scripts/time_port_kernels.py; PERF.md section 6). The force sweep reads
//   the band from its atoms' meta.
// - sums: float32 within a batch's row segment (at most 32 terms); the Born
//   and energy sweeps' row sums and slots in float64 from there (a protein's
//   total energy is ~1% of its components, below), the force sweep's in
//   float32.
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
//   patch's or a culled batch's 32 terms) and written as float64. A
//   protein's total energy is ~1% of its summed components (3,726 atoms near
//   a minimum: -300 to -1,400 kJ/mol against ~1e5 in each of the pair and
//   GB-self sums), and float32 sums over whole rows left errors of ~1e-4 of
//   the total. Forces keep float32 sums: they do not cancel that far.

#include "gb_force.cuh"
#include "pair_common.cuh"
#include "pair_groups.cuh"

namespace {

// the culled sweeps' walk
constexpr int kCulledWarps = 3;           // warps (work items) a CTA
constexpr int kSegments = 4;              // items a row group: its column groups split by h mod 4
constexpr int kCulledQueue = 64;          // a warp's queue: < 32 left over + 32 new
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

// A sweep functor gives the skeleton below and the culled walk:
//   Atom                 the staged atom (float4s), load(a, rbase, j) builds it
//   Slot, kSums          the slots' type and components (scratch (R, G, N, kSums))
//   Acc                  a lane's sums within a patch: from_lane(src) takes
//                        lane src's (a shuffle), store(part) writes them as
//                        Slot to part[d * kTile]
//   pair(...)            adds one unordered pair's terms to the row's and
//                        the column's Acc
//   ordered(..., v)      the culled walk's: one ordered pair's kSums terms
//                        to its row atom into v; kBand: it takes the band
//                        test's result, which the walk makes
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
  static constexpr bool kBand = false;
  __device__ static void ordered(const PairArgs& a, const float* s_neck, float s, float, float,
                                 float, const Atom& ai, const Atom& aj, bool, float* v) {
    const BornPair p = born_pair_values(a, s_neck, s, ai, aj);
    v[0] = 0.5f * p.h_ij + p.neck;
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
  // the culled walk stores atoms in a Morton order: the walk tests the band
  // on the atoms' `orig`
  static constexpr bool kBand = true;
  __device__ static void ordered(const PairArgs& a, const float*, float s, float, float, float,
                                 const Atom& ai, const Atom& aj, bool nonbonded, float* v) {
    const EnergyPair p = energy_pair(a, s, ai, aj, nonbonded);
    v[0] = p.e;
    v[1] = p.dedb_i;
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
  static constexpr bool kBand = false;   // force_pair reads the band from the atoms' meta
  __device__ static void ordered(const PairArgs& a, const float* s_neck, float s, float dx,
                                 float dy, float dz, const Atom& ai, const Atom& aj, bool,
                                 float* v) {
    const float w = force_pair(a, s_neck, s, ai, aj);
    v[0] = -w * dx;
    v[1] = -w * dy;
    v[2] = -w * dz;
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

// ---- culled sweeps: the ordered walk on full warps ----

// a warp's shared memory in a culled sweep
template <typename Sweep>
struct CulledWarp {
  using Atom = typename Sweep::Atom;
  static constexpr int kParts = sizeof(Atom) / sizeof(float4);
  float4 row[kParts][32];                       // the row group's atoms
  float4 col[2][kParts][32];                    // the column atoms of this patch and the one before
  typename Sweep::Slot acc[Sweep::kSums][32];   // the row atoms' sums
  // column buffer << 16 | row slot << 8 | column slot
  int queue[kCulledQueue];

  __device__ void put_row(int i, const Atom& t) {
    const float4* p = reinterpret_cast<const float4*>(&t);
#pragma unroll
    for (int q = 0; q < kParts; ++q) row[q][i] = p[q];
  }
  __device__ void put_col(int b, int j, const Atom& t) {
    const float4* p = reinterpret_cast<const float4*>(&t);
#pragma unroll
    for (int q = 0; q < kParts; ++q) col[b][q][j] = p[q];
  }
  __device__ Atom get_row(int i) const {
    Atom t;
    float4* p = reinterpret_cast<float4*>(&t);
#pragma unroll
    for (int q = 0; q < kParts; ++q) p[q] = row[q][i];
    return t;
  }
  __device__ Atom get_col(int b, int j) const {
    Atom t;
    float4* p = reinterpret_cast<float4*>(&t);
#pragma unroll
    for (int q = 0; q < kParts; ++q) p[q] = col[b][q][j];
    return t;
  }
};

// the warps' parts and the largest neck tables within the default 48 KB, so
// that a launch sets no function attribute (a CUDA graph can capture it)
template <typename Sweep>
constexpr size_t culled_smem_most() {
  return kCulledWarps * sizeof(CulledWarp<Sweep>) + 2 * sizeof(float) * kMaxClasses * kMaxClasses;
}
static_assert(culled_smem_most<BornSweep>() <= 48 * 1024, "culled Born sweep: shared > 48 KB");
static_assert(culled_smem_most<EnergySweep>() <= 48 * 1024, "culled energy sweep: shared > 48 KB");
static_assert(culled_smem_most<ForceSweep>() <= 48 * 1024, "culled force sweep: shared > 48 KB");

// A batch of queued pairs, one a lane (`valid` false: no pair), called by
// the whole warp: each pair's terms for its row atom (Sweep::ordered),
// added over the lanes of one (patch, row) segment by a segmented shuffle
// reduction (the queue holds a patch's pairs in row order, so a row's pairs
// of one patch sit in consecutive lanes) and to the row's sum by the
// segment's first lane: one writer a row at a time, no atomics. A batch
// spans at most two patches, so a row heads at most two segments; the older
// patch's (its pairs come first) adds first.
// the caller's indices of the lane's row atom and of its column atom in
// each column buffer (the energy sweep's band test)
struct BandRegs {
  int row, col0, col1;
};

template <typename Sweep>
__device__ __forceinline__ void culled_batch(const PairArgs& a, CulledWarp<Sweep>& w,
                                             const float* s_neck, int entry, bool valid,
                                             const BandRegs& orig) {
  using Slot = typename Sweep::Slot;
  constexpr int kSums = Sweep::kSums;
  const int lane = threadIdx.x & 31;
  const int key = valid ? entry >> 8 : -1;   // column buffer << 8 | row slot
  const int i = key & 0xff, j = entry & 0xff;
  bool nonbonded = false;
  if constexpr (Sweep::kBand) {
    const int oi = __shfl_sync(0xffffffffu, orig.row, i);
    const int o0 = __shfl_sync(0xffffffffu, orig.col0, j);
    const int o1 = __shfl_sync(0xffffffffu, orig.col1, j);
    nonbonded = abs(oi - ((key >> 8) ? o1 : o0)) > a.band;
  }
  float v[kSums];
#pragma unroll
  for (int d = 0; d < kSums; ++d) v[d] = 0.0f;
  if (valid) {
    const typename Sweep::Atom ai = w.get_row(i), aj = w.get_col(key >> 8, j);
    const float dx = ai.p0.x - aj.p0.x, dy = ai.p0.y - aj.p0.y, dz = ai.p0.z - aj.p0.z;
    Sweep::ordered(a, s_neck, __fadd_rn(pair_r2(dx, dy, dz), kEps), dx, dy, dz, ai, aj,
                   nonbonded, v);
  }
  // each lane ends with the sum over its lane and the later lanes of its segment
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int ko = __shfl_down_sync(0xffffffffu, key, off);
#pragma unroll
    for (int d = 0; d < kSums; ++d) {
      const float o = __shfl_down_sync(0xffffffffu, v[d], off);
      if (lane + off < 32 && ko == key) v[d] += o;
    }
  }
  const int key_before = __shfl_up_sync(0xffffffffu, key, 1);
  const bool head = valid && (lane == 0 || key_before != key);
  const bool older = (key >> 8) == (__shfl_sync(0xffffffffu, key, 0) >> 8);
  if (head && older) {
#pragma unroll
    for (int d = 0; d < kSums; ++d) w.acc[d][i] += static_cast<Slot>(v[d]);
  }
  __syncwarp();
  if (head && !older) {
#pragma unroll
    for (int d = 0; d < kSums; ++d) w.acc[d][i] += static_cast<Slot>(v[d]);
  }
}

// One warp an item (row group g, segment s) of replica blockIdx.y: the
// ordered pairs of g's 32 row atoms with the column groups h = s, s +
// kSegments, ... in increasing order whose tile `close` keeps and whose box
// is within the cutoff of g's box; their terms for the row atoms to the
// item's slot of `seg_out` (R, kSegments, N, kSums).
template <typename Sweep>
__device__ __forceinline__ void culled_walk(const PairArgs& a, const float* boxes,
                                            typename Sweep::Slot* seg_out) {
  using Atom = typename Sweep::Atom;
  using Slot = typename Sweep::Slot;
  constexpr int kSums = Sweep::kSums;
  __shared__ CulledWarp<Sweep> s_warp[kCulledWarps];
  extern __shared__ float s_neck[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  if (a.use_neck) load_neck(a, s_neck, threadIdx.x, blockDim.x);
  __syncthreads();
  const long long NG = (a.n + 31) / 32;
  const long long item = static_cast<long long>(blockIdx.x) * kCulledWarps + warp;
  if (item >= NG * kSegments) return;   // warp-uniform
  const int seg = static_cast<int>(item % kSegments);
  const long long g = item / kSegments;
  const long long rep = blockIdx.y;
  CulledWarp<Sweep>& w = s_warp[warp];
  const size_t rbase = static_cast<size_t>(rep) * a.n;
  const int row0 = static_cast<int>(g) * 32, n_rows = min(32, a.n - row0);
  Atom ti = {};
  if (lane < n_rows) ti = Sweep::load(a, rbase, row0 + lane);
  w.put_row(lane, ti);
#pragma unroll
  for (int d = 0; d < kSums; ++d) w.acc[d][lane] = Slot(0);
  // the caller's index of the lane's row atom, for the band
  BandRegs orig = {0, 0, 0};
  if constexpr (Sweep::kBand) {
    if (lane < n_rows) orig.row = a.orig[row0 + lane];
  }
  const float* rep_boxes = boxes + rep * NG * 6;
  const uint8_t* close_row = a.close + (rep * a.n_tiles + row0 / a.tile) * a.n_tiles;
  const int per_tile = a.tile / 32;
  // queue state, the same in every lane: entries queued, those of them
  // from before the current patch, and the column buffer of the patch
  int queued = 0, carried = 0, buf = 0;
  __syncwarp();
  // 32 candidate column groups at a time, one a lane
  for (long long base = seg; base < NG; base += 32LL * kSegments) {
    const long long hl = base + static_cast<long long>(lane) * kSegments;
    const bool take = hl < NG && close_row[hl / per_tile] &&
                      !boxes_apart(a, rep_boxes + g * 6, rep_boxes + hl * 6);
    unsigned groups = __ballot_sync(0xffffffffu, take);
    while (groups) {
      const long long h = base + static_cast<long long>(__ffs(groups) - 1) * kSegments;
      groups &= groups - 1;
      // queued pairs of two patches back refer to the buffer this patch
      // overwrites: run them first, as a short batch
      if (carried > 0) {
        __syncwarp();
        culled_batch(a, w, s_neck, lane < queued ? w.queue[lane] : 0, lane < queued, orig);
        queued = 0;
      }
      carried = queued;
      const int col0 = static_cast<int>(h) * 32, n_cols = min(32, a.n - col0);
      Atom tj = {};
      if (lane < n_cols) tj = Sweep::load(a, rbase, col0 + lane);
      if constexpr (Sweep::kBand) {
        const int o = lane < n_cols ? a.orig[col0 + lane] : 0;
        if (buf) {
          orig.col1 = o;
        } else {
          orig.col0 = o;
        }
      }
      __syncwarp();
      w.put_col(buf, lane, tj);
      // the rows within the cutoff of the column group's box
      unsigned rows =
          __ballot_sync(0xffffffffu, lane < n_rows && near_box(a, ti.p0, rep_boxes + h * 6));
      __syncwarp();
      // each near row against the 32 columns, one column a lane; the pairs
      // inside the cutoff go to the queue, and every 32 of them to the lanes
      while (rows) {
        const int i = __ffs(rows) - 1;
        rows &= rows - 1;
        const float4 pi = w.row[0][i];
        const float r2 = pair_r2(pi.x - tj.p0.x, pi.y - tj.p0.y, pi.z - tj.p0.z);
        // self and coincident pairs (r^2 <= 1e-8) are skipped
        const bool keep = lane < n_cols && r2 > 1e-8f && __fadd_rn(r2, kEps) <= a.cut_r2;
        const int entry = (buf << 16) | (i << 8) | lane;
        const unsigned mask = __ballot_sync(0xffffffffu, keep);
        if (keep) w.queue[queued + __popc(mask & below)] = entry;
        queued += __popc(mask);
        if (queued >= 32) {
          __syncwarp();
          culled_batch(a, w, s_neck, w.queue[lane], true, orig);
          __syncwarp();
          queued -= 32;
          carried = max(carried - 32, 0);
          if (lane < queued) w.queue[lane] = w.queue[32 + lane];
          __syncwarp();
        }
      }
      buf ^= 1;
    }
  }
  __syncwarp();
  if (queued > 0) {
    culled_batch(a, w, s_neck, lane < queued ? w.queue[lane] : 0, lane < queued, orig);
  }
  __syncwarp();
  if (lane < n_rows) {
    Slot* out = seg_out + ((rep * kSegments + seg) * a.n + row0 + lane) * kSums;
#pragma unroll
    for (int d = 0; d < kSums; ++d) out[d] = w.acc[d][lane];
  }
}

// ---- sweep 1, culled: Born integral, the row atom's H_ij / 2 + neck ----
__global__ void __launch_bounds__(32 * kCulledWarps)
    pair_born_culled_kernel(PairArgs a, const float* boxes, double* seg_out) {
  culled_walk<BornSweep>(a, boxes, seg_out);
}

// ---- sweep 2, culled: the row atom's energy 0.5 e_nb + e_gb and dE/dB_i ----
__global__ void __launch_bounds__(32 * kCulledWarps)
    pair_energy_culled_kernel(PairArgs a, const float* boxes, double* seg_out) {
  culled_walk<EnergySweep>(a, boxes, seg_out);
}

// ---- sweep 3, culled: the row atom's force -W d ----
__global__ void __launch_bounds__(32 * kCulledWarps)
    pair_force_culled_kernel(PairArgs a, const float* boxes, float* seg_out) {
  culled_walk<ForceSweep>(a, boxes, seg_out);
}

// A culled sweep: the groups' boxes, the walk `kernel` into per-segment
// slots, and each atom's kSegments slots added in slot order
// (dense_slots_kernel); `a.slots` is the scratch of
// pmarlo_pair_culled_scratch bytes.
template <typename Sweep>
int launch_culled(void (*kernel)(PairArgs, const float*, typename Sweep::Slot*), PairArgs a,
                  int n_replicas, size_t neck, cudaStream_t s) {
  if (a.slots == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const long long NG = (a.n + 31) / 32;
  const long long ctas = (NG * kSegments + kCulledWarps - 1) / kCulledWarps;
  if (ctas > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  float* boxes = static_cast<float*>(a.slots);
  // R NG 6 floats: an even count, so the slots start 8-byte aligned
  auto* seg_out = reinterpret_cast<typename Sweep::Slot*>(boxes + n_replicas * NG * 6);
  group_boxes_kernel<<<static_cast<unsigned>((n_replicas * NG * 32 + 255) / 256), 256, 0, s>>>(
      a, boxes, n_replicas);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(static_cast<unsigned>(ctas), n_replicas), 32 * kCulledWarps, neck, s>>>(
      a, boxes, seg_out);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  PairArgs b = a;
  b.slots = seg_out;
  b.n_tiles = kSegments;
  dense_slots_kernel<Sweep><<<dim3((a.n + 255) / 256, n_replicas), 256, 0, s>>>(b);
  return static_cast<int>(cudaGetLastError());
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
  if (mode != kCulled || a.tile < 32 || a.tile % 32 != 0 || a.close == nullptr ||
      a.orig == nullptr || !a.has_cut) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (sweep) {
    case kBorn: return launch_culled<BornSweep>(pair_born_culled_kernel, a, n_replicas, neck, s);
    case kEnergy:
      return launch_culled<EnergySweep>(pair_energy_culled_kernel, a, n_replicas, neck, s);
    case kForce: return launch_culled<ForceSweep>(pair_force_culled_kernel, a, n_replicas, neck, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

int pmarlo_pair_max_classes() { return kMaxClasses; }

// atoms a tile of the dense sweeps: their scratch `slots` is (R,
// ceil(N / tile), N, K): K = 1 float32 (Born), 2 float64 (energy: row,
// dE/dB), 3 float32 (force)
int pmarlo_pair_force_tile() { return kTile; }

// items a row group of the culled sweeps: their per-atom slots are (R,
// segments, N, K)
int pmarlo_pair_culled_segments() { return kSegments; }

// bytes of a culled sweep's scratch (`slots`): the 32-atom groups' boxes
// (R, ceil(N / 32), 6) float32, then the per-segment slots (R, segments,
// N, K) of the sweep: Born 1 float64, energy 2 float64 (row, dE/dB), force
// 3 float32; -1 for an unknown sweep
long long pmarlo_pair_culled_scratch(int sweep, int n_replicas, int n_atoms) {
  long long slot = 0;
  switch (sweep) {
    case kBorn: slot = sizeof(BornSweep::Slot) * BornSweep::kSums; break;
    case kEnergy: slot = sizeof(EnergySweep::Slot) * EnergySweep::kSums; break;
    case kForce: slot = sizeof(ForceSweep::Slot) * ForceSweep::kSums; break;
    default: return -1;
  }
  const long long groups = (n_atoms + 31) / 32;
  return static_cast<long long>(n_replicas) *
         (groups * 6 * static_cast<long long>(sizeof(float)) + kSegments * slot * n_atoms);
}

// One sweep (`sweep`: 0 Born integral into `out0`, 1 energy rows into
// `rows` and dE/dB into `out0`, 2 forces into `out0`) in `mode` 0 (dense;
// needs `slots`) or 1 (tile-culled: `orig`, `close`, `tile` and `cut_r2`
// are read; `slots`: pmarlo_pair_culled_scratch bytes). Returns
// cudaGetLastError() after the launches on `stream` (0 = launched).
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
