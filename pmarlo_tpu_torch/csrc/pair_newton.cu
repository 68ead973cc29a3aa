// GB pair sweeps that take each unordered (row tile, column tile) block
// once: both Born / dE/dB attributions and Newton's third law.
//
// Replaces: pmarlo_tpu/md/pallas_pair.py _build_newton_path, its three
// Pallas sweeps over a flat block list (newton=True, the default with
// gb_cutoff):
//   newton_born_kernel   <- sweep1_s (:1442) / born_sym
//   newton_energy_kernel <- sweep2_s (:1461) / energy_sym
//   newton_force_kernel  <- sweep3_s (:1479) / force_sym
// They compute what the row-owned sweeps of pair_force.cu compute (same
// outputs, same glue around them in md/pair_force.py), at about half the
// pair work: the distance, LJ + Coulomb, the GB f-function and the neck are
// evaluated once a pair; only the HCT term is evaluated per direction.
//
// What bounds them on an H100: not bytes (the per-atom data of a block is
// 2 x tile atoms) but instructions, and few of them on the pairs that
// count: at 61,824 atoms (tile 128, cutoff 1.5 nm) 2.9% of the pairs of the
// kept tile blocks lie inside the cutoff. The Born and energy sweeps spend
// most of theirs on the pairs outside it; the force sweep on finding the
// pairs inside, on the pair function and on the column sums' shared-memory
// atomics (PERF.md section 6 has the times against the bound).
//
// Design, all three sweeps:
// - a work list instead of a grid of every (r, c) block: a small kernel
//   writes the work items to `work`, warp by warp (ballot, one atomic add a
//   warp), and their count beside them; the sweep runs a persistent grid, as
//   many CTAs as the card holds at once, each taking the next item from an
//   atomic counter until the list is done. No CTA starts only to find its
//   block under the diagonal or out of range (the former (G, G, R) grid
//   launched 233,289 CTAs at G = 483, of which ~94% did so), the host never
//   reads the count, and the list's room is the whole upper triangle, so it
//   cannot overflow. The TPU kernel ran a compacted, statically sized block
//   list on a sequential grid and poisoned the result when the list
//   overflowed.
// - the wrapper's `close` table (tile pairs whose boxes are within the
//   cutoff, recomputed from the live positions on every call; null without
//   a cutoff: every block) decides which blocks have work.
// - results are added to per-atom sums in shared memory, and those to the
//   outputs in global memory, with atomicAdd (float for I, dE/dB and F,
//   double for the energy rows). The order of these additions changes from
//   run to run, so results differ in the last bits between runs; the
//   row-owned sweeps are the bit-reproducible path. The wrapper zeroes the
//   outputs before the launch.
// - a diagonal block counts each unordered pair once: the strict upper
//   triangle in storage order (column > row).
// - energy rows: the energy of a pair goes to its row atom (the lower
//   storage index), so the rows sum to the total as the row-owned rows do,
//   though atom by atom they differ from them.
// - the cutoff test, the band mask on original indices, the skipped self
//   and coincident pairs and the float64 energy sums are those of
//   pair_force.cu.
//
// Born and energy sweeps: a work item is a block (r, c >= r) that `close`
// keeps. A CTA stages its two tiles in shared memory and walks their 32 x 32
// patches, a warp a patch (walk): lane l owns row l and at step k the column
// (l + k) mod 32; the row sums stay in the lane's registers, the column sums
// travel to the next lane by a shuffle after every step and arrive after 32
// steps in the lane whose index is the column's. A warp runs a pair's terms
// whenever one of its lanes has a pair inside the cutoff.
//
// Force sweep (newton_force_kernel), built so that lanes work on pairs
// inside the cutoff only, and warps never wait for each other:
// - a work item is a 32 x 32 patch (row group g, column group h >= g of
//   32-atom groups) of a block that `close` keeps, whose two groups'
//   bounding boxes are within the cutoff. newton_group_boxes_kernel computes
//   the boxes from the live positions; the test on them is tiles_within's
//   (md/pair_force.py) at 32-atom tiles, so a patch left out holds no pair
//   inside the cutoff. At 24,840 atoms 39% of the patches of the kept blocks
//   pass it.
// - a warp takes a patch alone: it stages the 32 row and 32 column atoms in
//   its own shared memory (three float4 an atom), and no barrier joins the
//   warps of a CTA, so a patch with many pairs holds up no other warp.
// - the rows within the cutoff of the column group's box are found by one
//   ballot; each of them is tested against the 32 columns, a column a lane,
//   on r^2 alone. The pairs that pass are compacted (__ballot_sync, __popc)
//   into the warp's queue; whenever 32 are queued, every lane takes one and runs the pair function
//   (gb_force.cuh, the one of the dense force sweep: ten single
//   special-function results from rsqrt.approx, rcp.approx, lg2.approx and
//   ex2.approx; measured error in pair_force.cu's note). The row sums of a
//   batch go by a segmented shuffle reduction (force_batch), the column sums
//   by shared-memory atomicAdd. The rest of the queue is drained at the end
//   of the patch, whose sums then go to the outputs.

#include <mutex>
#include <vector>

#include "gb_force.cuh"
#include "pair_common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxTile = 256;             // atoms a tile: shared memory holds two tiles
constexpr int kQueue = 64;                // a warp's queue: < 32 left over + 32 new

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

// one block of the work list
struct Block {
  int rep, row0, col0, n_rows, n_cols;
  bool diagonal;
};

// The CTA's next block from the work list, or false when the list is done.
// The barrier first: the previous block's shared data is read no more.
__device__ bool take_block(const PairArgs& a, Block* b) {
  __shared__ long long s_item;
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned long long k = atomicAdd(a.work + 1, 1ull);
    s_item = k < a.work[0] ? static_cast<long long>(a.work[2 + k]) : -1;
  }
  __syncthreads();
  if (s_item < 0) return false;
  // (rep, r, c) packed by newton_block_list_kernel: shifts, where a 64-bit
  // division would be a called subroutine whose calls made ptxas spill
  const int r = static_cast<int>((s_item >> 16) & 0xffff), c = static_cast<int>(s_item & 0xffff);
  b->rep = static_cast<int>(s_item >> 32);
  b->diagonal = r == c;
  b->row0 = r * a.tile;
  b->col0 = c * a.tile;
  b->n_rows = min(a.tile, a.n - b->row0);
  b->n_cols = min(a.tile, a.n - b->col0);
  return true;
}

// Appends code(idx) of each index of [0, total) that `keep` takes to
// work[2:], warp by warp (one atomic add a warp), and counts them in
// work[0], which the caller has zeroed. The order of the list changes from
// run to run.
template <typename Keep, typename Code>
__device__ void append_kept(unsigned long long* work, long long total, Keep keep, Code code) {
  const int lane = threadIdx.x & 31;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long base = static_cast<long long>(blockIdx.x) * blockDim.x + (threadIdx.x & ~31);
       base < total; base += stride) {
    const long long idx = base + lane;
    const bool take = idx < total && keep(idx);
    const unsigned mask = __ballot_sync(0xffffffffu, take);
    unsigned long long first = 0;
    if (lane == 0 && mask) first = atomicAdd(work, static_cast<unsigned long long>(__popc(mask)));
    first = __shfl_sync(0xffffffffu, first, 0);
    if (take) work[2 + first + __popc(mask & ((1u << lane) - 1u))] = code(idx);
  }
}

// The Born and energy sweeps' list: the blocks (rep, r, c >= r) that
// `close` keeps (all of them without a table), packed rep << 32 | r << 16 | c
// (G and R < 2^16).
__global__ void newton_block_list_kernel(PairArgs a, int n_replicas) {
  const long long G = a.n_tiles;
  append_kept(
      a.work, n_replicas * G * G,
      [&](long long idx) {
        return idx % G >= (idx / G) % G && (a.close == nullptr || a.close[idx]);
      },
      [&](long long idx) {
        return static_cast<unsigned long long>(idx / (G * G)) << 32 |
               static_cast<unsigned long long>((idx / G) % G) << 16 |
               static_cast<unsigned long long>(idx % G);
      });
}

// true when two boxes (lo xyz, hi xyz) are farther apart than the cutoff,
// tested as tiles_within (md/pair_force.py) tests tiles: the per-axis gap is
// no larger than any pair's |dx| and every later operation is monotonic, so
// no pair of the two boxes lies inside the cutoff
__device__ __forceinline__ bool boxes_apart(const PairArgs& a, const float* bg, const float* bh) {
  const float gx = fmaxf(fmaxf(bg[0] - bh[3], bh[0] - bg[3]), 0.0f);
  const float gy = fmaxf(fmaxf(bg[1] - bh[4], bh[1] - bg[4]), 0.0f);
  const float gz = fmaxf(fmaxf(bg[2] - bh[5], bh[2] - bg[5]), 0.0f);
  return __fadd_rn(pair_r2(gx, gy, gz), kEps) > a.cut_r2;
}

// The bounding box (lo xyz, hi xyz) of each 32-atom group of each replica
// into boxes (R, NG, 6): a warp a group.
__global__ void newton_group_boxes_kernel(PairArgs a, float* boxes, int n_replicas) {
  const long long NG = (a.n + 31) / 32;
  const long long group = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  if (group >= n_replicas * NG) return;   // the same in the whole warp
  const int lane = threadIdx.x & 31;
  const long long atom = (group % NG) * 32 + lane;
  const bool ok = atom < a.n;
  const float* x = a.x + ((group / NG) * a.n + (ok ? atom : 0)) * 3;
  float lo[3], hi[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    lo[d] = ok ? x[d] : __int_as_float(0x7f800000);
    hi[d] = ok ? x[d] : -__int_as_float(0x7f800000);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      lo[d] = fminf(lo[d], __shfl_xor_sync(0xffffffffu, lo[d], off));
      hi[d] = fmaxf(hi[d], __shfl_xor_sync(0xffffffffu, hi[d], off));
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      boxes[group * 6 + d] = lo[d];
      boxes[group * 6 + 3 + d] = hi[d];
    }
  }
}

// The force sweep's list: the 32 x 32 patches (rep * NG + g) * NG + h with
// h >= g whose tile block `close` keeps and whose two group boxes are
// within the cutoff (every patch of the upper triangle without a cutoff).
__global__ void newton_patch_list_kernel(PairArgs a, const float* boxes, int n_replicas) {
  const long long NG = (a.n + 31) / 32, G = a.n_tiles, per = a.tile / 32;
  append_kept(a.work, n_replicas * NG * NG, [&](long long idx) {
    const long long rep = idx / (NG * NG), g = (idx / NG) % NG, h = idx % NG;
    if (h < g) return false;
    if (a.close != nullptr && !a.close[(rep * G + g / per) * G + h / per]) return false;
    return !a.has_cut || !boxes_apart(a, boxes + (rep * NG + g) * 6, boxes + (rep * NG + h) * 6);
  }, [](long long idx) { return static_cast<unsigned long long>(idx); });
}

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

// Walks the block's 32 x 32 patches. `pair(i, j, r, dx, dy, dz, row_sum, col_sum, e)`
// adds one pair's terms to the kSums sums of either side and to the row
// atom's float64 sum e (i a row slot, j a column slot, both staged);
// `patch_done(i, e)` is called for a lane's row i after each patch with the
// patch's e. e lives here, in a register, not in the caller's frame.
template <int kSums, typename Pair, typename PatchDone>
__device__ __forceinline__ void walk(const PairArgs& a, const Block& b, const Side& rows, const Side& cols,
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
    double e = 0.0;
    for (int k = 0; k < 32; ++k) {
      const int j = h * 32 + ((lane + k) & 31);
      if (row_ok && j < b.n_cols && (!b.diagonal || j > i)) {
        const float dx = xi - cols.x[j], dy = yi - cols.y[j], dz = zi - cols.z[j];
        const float r2 = pair_r2(dx, dy, dz);
        const float s = __fadd_rn(r2, kEps);
        if (r2 > 1e-8f && (!a.has_cut || s <= a.cut_r2)) {
          pair(i, j, sqrtf(s), dx, dy, dz, row_sum, col_sum, e);
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
    if (row_ok) patch_done(i, e);
  }
}

// ---- sweep 1: Born integral, both directions of each pair ----
__global__ void __launch_bounds__(kThreads) newton_born_kernel(PairArgs a) {
  extern __shared__ float smem[];
  const Side rows = carve(smem, a.tile), cols = carve(smem + kSideWords * a.tile, a.tile);
  float* s_neck = smem + 2 * kSideWords * a.tile;
  const int cc = a.n_classes * a.n_classes;
  if (a.use_neck) load_neck(a, s_neck, threadIdx.x, kThreads);
  Block b;
  while (take_block(a, &b)) {
    stage(a, rows, b.rep, b.row0, b.n_rows, threadIdx.x);
    stage(a, cols, b.rep, b.col0, b.n_cols, threadIdx.x);
    __syncthreads();
    walk<1>(a, b, rows, cols,
            [&](int i, int j, float r, float, float, float, float* row_sum, float* col_sum,
                double&) {
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
            [](int, double) {});
    __syncthreads();
    flush(a, b, rows, cols, 1, threadIdx.x);
  }
}

// ---- sweep 2: pair energy to the row atom, dE/dB to both atoms ----
__global__ void __launch_bounds__(kThreads) newton_energy_kernel(PairArgs a) {
  extern __shared__ float smem[];
  __shared__ double s_energy[kMaxTile];
  const Side rows = carve(smem, a.tile), cols = carve(smem + kSideWords * a.tile, a.tile);
  Block b;
  while (take_block(a, &b)) {
    for (int k = threadIdx.x; k < a.tile; k += kThreads) s_energy[k] = 0.0;
    stage(a, rows, b.rep, b.row0, b.n_rows, threadIdx.x);
    stage(a, cols, b.rep, b.col0, b.n_cols, threadIdx.x);
    __syncthreads();
    walk<1>(a, b, rows, cols,
            [&](int i, int j, float r, float, float, float, float* row_sum, float* col_sum,
                double& e_sum) {
              float dedb_i, dedb_j;
              const float e = pair_energy_ieee(
                  a.ke, a.gb_pref, a.use_gb, r, 1.0f / r, rows.q[i] * cols.q[j], rows.sig[i],
                  cols.sig[j], rows.seps[i] * cols.seps[j], rows.B[i], cols.B[j],
                  abs(rows.orig[i] - cols.orig[j]) > a.band, &dedb_i, &dedb_j);
              // the unordered pair's energy, both rows' shares, to the row atom
              e_sum += 2.0f * e;
              // the ordered quantity on each side; the glue doubles it
              row_sum[0] += dedb_i;
              col_sum[0] += dedb_j;
            },
            [&](int i, double e_sum) { atomicAdd(&s_energy[i], e_sum); });
    __syncthreads();
    flush(a, b, rows, cols, 1, threadIdx.x);
    const size_t rbase = static_cast<size_t>(b.rep) * a.n;
    for (int k = threadIdx.x; k < b.n_rows; k += kThreads) {
      atomicAdd(a.rows + rbase + b.row0 + k, s_energy[k]);
    }
  }
}

// ---- sweep 3: forces, -W d on the row atom and +W d on the column atom ----

// a warp's shared memory: the patch's 32 row and 32 column atoms (three
// float4 each), their sums, and the queue of pairs inside the cutoff
constexpr int kWarpAtoms = 2 * 3 * 32;   // float4
constexpr int kWarpSums = 2 * 3 * 32;    // float

__host__ __device__ constexpr size_t force_smem_bytes(int neck_floats) {
  return kWarps * (sizeof(float4) * kWarpAtoms + sizeof(float) * kWarpSums +
                   sizeof(int) * kQueue) +
         sizeof(float) * neck_floats;
}

struct WarpSmem {
  float4* atom;   // [side * 3 + part][32]
  float* acc;     // [side * 3 + axis][32]
  int* queue;     // row slot << 8 | column slot
};

// A batch of queued pairs, one a lane (`valid` false: no pair), called by
// the whole warp: each pair's force to both atoms' sums. A batch holds its
// pairs in row order (rows are taken in increasing order, a row's pairs in
// column order), so the pairs of one row sit in consecutive lanes: their
// row sums are added by a segmented shuffle reduction and stored once, by
// the segment's first lane, with no atomic (shared-memory float atomicAdd
// is a compare-and-swap loop on this card, and the lanes of one row would
// all contend for one address). The column sums, whose atoms repeat only
// across rows, use atomicAdd.
__device__ __forceinline__ void force_batch(const PairArgs& a, const WarpSmem& w,
                                            const float* s_neck, int entry, bool valid) {
  const int lane = threadIdx.x & 31;
  const int i = valid ? entry >> 8 : -1;
  float fx = 0.0f, fy = 0.0f, fz = 0.0f;
  if (valid) {
    const int j = entry & 0xff;
    const ForceAtom ai = {w.atom[i], w.atom[32 + i], w.atom[64 + i]};
    const ForceAtom aj = {w.atom[96 + j], w.atom[128 + j], w.atom[160 + j]};
    const float dx = ai.p0.x - aj.p0.x, dy = ai.p0.y - aj.p0.y, dz = ai.p0.z - aj.p0.z;
    const float f = force_pair(a, s_neck, __fadd_rn(pair_r2(dx, dy, dz), kEps), ai, aj);
    fx = f * dx;
    fy = f * dy;
    fz = f * dz;
    atomicAdd(&w.acc[96 + j], fx);
    atomicAdd(&w.acc[128 + j], fy);
    atomicAdd(&w.acc[160 + j], fz);
  }
  // each lane ends with the sum over its lane and the later lanes of its row
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int io = __shfl_down_sync(0xffffffffu, i, off);
    const float ox = __shfl_down_sync(0xffffffffu, fx, off);
    const float oy = __shfl_down_sync(0xffffffffu, fy, off);
    const float oz = __shfl_down_sync(0xffffffffu, fz, off);
    if (lane + off < 32 && io == i) {
      fx += ox;
      fy += oy;
      fz += oz;
    }
  }
  const int i_before = __shfl_up_sync(0xffffffffu, i, 1);
  if (valid && (lane == 0 || i_before != i)) {
    w.acc[i] -= fx;
    w.acc[32 + i] -= fy;
    w.acc[64 + i] -= fz;
  }
}

// One patch (row group g, column group h >= g of replica rep) by one warp.
__device__ void force_patch(const PairArgs& a, const float* boxes, const WarpSmem& w,
                            const float* s_neck, int rep, int g, int h) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const size_t rbase = static_cast<size_t>(rep) * a.n;
  const int row0 = g * 32, col0 = h * 32;
  const int n_rows = min(32, a.n - row0), n_cols = min(32, a.n - col0);
  ForceAtom ti = {}, tj = {};
  if (lane < n_rows) ti = load_force_atom(a, rbase, row0 + lane);
  if (lane < n_cols) tj = load_force_atom(a, rbase, col0 + lane);
  w.atom[lane] = ti.p0;
  w.atom[32 + lane] = ti.p1;
  w.atom[64 + lane] = ti.p2;
  w.atom[96 + lane] = tj.p0;
  w.atom[128 + lane] = tj.p1;
  w.atom[160 + lane] = tj.p2;
#pragma unroll
  for (int k = 0; k < 6; ++k) w.acc[k * 32 + lane] = 0.0f;
  __syncwarp();
  // the rows within the cutoff of the column group's box (tested as
  // boxes_apart tests two boxes): a row beyond it has no pair in the patch
  bool near = lane < n_rows;
  if (a.has_cut && near) {
    const float* bh = boxes + (static_cast<size_t>(rep) * ((a.n + 31) / 32) + h) * 6;
    const float gx = fmaxf(fmaxf(bh[0] - ti.p0.x, ti.p0.x - bh[3]), 0.0f);
    const float gy = fmaxf(fmaxf(bh[1] - ti.p0.y, ti.p0.y - bh[4]), 0.0f);
    const float gz = fmaxf(fmaxf(bh[2] - ti.p0.z, ti.p0.z - bh[5]), 0.0f);
    near = __fadd_rn(pair_r2(gx, gy, gz), kEps) <= a.cut_r2;
  }
  unsigned rows = __ballot_sync(0xffffffffu, near);
  // each near row against the 32 columns, one column a lane; the pairs
  // inside the cutoff go to the queue, and every 32 of them to the lanes
  const bool col_ok = lane < n_cols;
  const bool diagonal = g == h;
  int queued = 0;   // the same in every lane
  while (rows) {
    const int i = __ffs(rows) - 1;
    rows &= rows - 1;
    const float4 pi = w.atom[i];
    const float r2 = pair_r2(pi.x - tj.p0.x, pi.y - tj.p0.y, pi.z - tj.p0.z);
    const bool keep = col_ok && (!diagonal || lane > i) && r2 > 1e-8f &&
                      (!a.has_cut || __fadd_rn(r2, kEps) <= a.cut_r2);
    const unsigned mask = __ballot_sync(0xffffffffu, keep);
    if (keep) w.queue[queued + __popc(mask & below)] = (i << 8) | lane;
    queued += __popc(mask);
    if (queued >= 32) {
      __syncwarp();
      force_batch(a, w, s_neck, w.queue[lane], true);
      __syncwarp();
      queued -= 32;
      if (lane < queued) w.queue[lane] = w.queue[32 + lane];
      __syncwarp();
    }
  }
  __syncwarp();
  force_batch(a, w, s_neck, lane < queued ? w.queue[lane] : 0, lane < queued);
  __syncwarp();
  // the patch's sums to the outputs (an atom with no pair adds nothing)
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float fr = w.acc[d * 32 + lane], fc = w.acc[(3 + d) * 32 + lane];
    if (lane < n_rows && fr != 0.0f) atomicAdd(a.out0 + (rbase + row0 + lane) * 3 + d, fr);
    if (lane < n_cols && fc != 0.0f) atomicAdd(a.out0 + (rbase + col0 + lane) * 3 + d, fc);
  }
  __syncwarp();   // the next patch overwrites the staged atoms
}

// Persistent warps: each takes the next patch of the list from an atomic
// counter (the one after it asked for while this one runs) until the list
// is done. No barrier across the CTA after the neck tables are loaded.
__global__ void __launch_bounds__(kThreads) newton_force_kernel(PairArgs a, const float* boxes) {
  extern __shared__ float4 smem4[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  WarpSmem w;
  w.atom = smem4 + warp * kWarpAtoms;
  float* sums = reinterpret_cast<float*>(smem4 + kWarps * kWarpAtoms);
  w.acc = sums + warp * kWarpSums;
  int* queues = reinterpret_cast<int*>(sums + kWarps * kWarpSums);
  w.queue = queues + warp * kQueue;
  float* s_neck = reinterpret_cast<float*>(queues + kWarps * kQueue);
  if (a.use_neck) load_neck(a, s_neck, threadIdx.x, kThreads);
  __syncthreads();
  const long long NG = (a.n + 31) / 32;
  const unsigned long long count = a.work[0];
  unsigned long long item = 0;
  if (lane == 0) item = atomicAdd(a.work + 1, 1ull);
  item = __shfl_sync(0xffffffffu, item, 0);
  while (item < count) {
    unsigned long long next = 0;
    if (lane == 0) next = atomicAdd(a.work + 1, 1ull);
    const long long idx = static_cast<long long>(a.work[2 + item]);
    force_patch(a, boxes, w, s_neck, static_cast<int>(idx / (NG * NG)),
                static_cast<int>((idx / NG) % NG), static_cast<int>(idx % NG));
    item = __shfl_sync(0xffffffffu, next, 0);
  }
}

// entries of the work list's room: every block (Born, energy) or every 32 x
// 32 patch (force) of the upper triangle of each replica
long long list_room(int sweep, int n_replicas, int n_atoms, int tile) {
  const long long G = sweep == kForce ? (n_atoms + 31) / 32 : (n_atoms + tile - 1) / tile;
  return n_replicas * G * (G + 1) / 2;
}

// CTAs of the list kernels, which stride over `total` indices
unsigned list_ctas(long long total) {
  const long long ctas = (total + 255) / 256;
  return static_cast<unsigned>(ctas < 1024 ? ctas : 1024);
}

// dynamic shared memory of a sweep: two staged tiles (Born, energy) or the
// warps' patches (force), and the neck's tables
size_t sweep_smem(int sweep, int tile, int neck_floats) {
  return sweep == kForce ? force_smem_bytes(neck_floats)
                         : sizeof(float) * (2 * kSideWords * tile + neck_floats);
}

// CTAs of `kernel` (sweep `sweep`) that the current device holds at once
// with `shmem` bytes of dynamic shared memory, into *ctas. The answer
// depends only on the kernel, `shmem` and the device, so it is asked of the
// runtime once and kept (a force evaluation runs three sweeps, on a path
// whose time is already the host's); the first call on a device also raises
// the kernel's dynamic shared-memory limit to the most any call can ask.
cudaError_t resident_ctas(int sweep, const void* kernel, size_t shmem, long long* ctas) {
  struct Entry {
    int device;
    size_t shmem;
    long long ctas;
  };
  static std::mutex mu;
  static std::vector<Entry> known[3];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  bool device_seen = false;
  for (const Entry& e : known[sweep]) {
    if (e.device == device && e.shmem == shmem) {
      *ctas = e.ctas;
      return cudaSuccess;
    }
    device_seen = device_seen || e.device == device;
  }
  if (!device_seen) {
    const size_t most = sweep_smem(sweep, kMaxTile, 2 * kMaxClasses * kMaxClasses);
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(most));
    if (err != cudaSuccess) return err;
  }
  int sms = 0, per_sm = 0;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
          cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, shmem)) !=
          cudaSuccess) {
    return err;
  }
  *ctas = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  known[sweep].push_back({device, shmem, *ctas});
  return cudaSuccess;
}

}  // namespace

extern "C" {

int pmarlo_pair_newton_max_tile() { return kMaxTile; }

// Entries (unsigned 64-bit) of the `work` buffer of one Newton sweep: two
// counters, the list's room, and for the force sweep the 32-atom groups'
// boxes (R, ceil(N / 32), 6) as float32.
long long pmarlo_pair_newton_work_size(int sweep, int n_replicas, int n_atoms, int tile) {
  long long size = 2 + list_room(sweep, n_replicas, n_atoms, tile);
  if (sweep == kForce) size += (n_replicas * ((n_atoms + 31) / 32LL) * 6 + 1) / 2;
  return size;
}

// One Newton sweep (`sweep` as in pmarlo_pair_sweep) over the upper triangle
// of tile blocks; `close` null takes every block (no cutoff), `has_cut` 0
// keeps every pair. `out0` (and `rows`) must be zero: the kernels add to
// them. `work` holds pmarlo_pair_newton_work_size entries: the list and its
// counters are written here. Returns cudaGetLastError() after the launches
// on `stream`.
int pmarlo_pair_newton_sweep(int sweep, const float* x, const float* atom_p, const int* cls,
                             const int* orig, const float* d0c, const float* m0c,
                             int n_classes, const float* B, const float* chain,
                             const uint8_t* close, int n_replicas, int n_atoms, int tile,
                             int band, float ke, float gb_pref, float cut_r2, int has_cut,
                             int use_gb, int use_neck, float* out0, double* rows,
                             unsigned long long* work, void* stream) {
  // (n_atoms < 2^25: the force sweep packs orig * 64 + class into 32 bits)
  if (n_atoms < 1 || n_atoms >= (1 << 25) || n_replicas < 1 || n_replicas > 65535 ||
      n_classes < 1 || n_classes > kMaxClasses || band < 0 || tile < 32 || tile % 32 != 0 ||
      tile > kMaxTile || work == nullptr || sweep < kBorn || sweep > kForce) {
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
  a.work = work;
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
  const int neck = a.use_neck ? 2 * n_classes * n_classes : 0;
  const void* kernel = sweep == kBorn     ? reinterpret_cast<const void*>(newton_born_kernel)
                       : sweep == kEnergy ? reinterpret_cast<const void*>(newton_energy_kernel)
                                          : reinterpret_cast<const void*>(newton_force_kernel);
  const size_t shmem = sweep_smem(sweep, tile, neck);
  long long ctas = 0;
  cudaError_t err = resident_ctas(sweep, kernel, shmem, &ctas);
  if (err != cudaSuccess) return static_cast<int>(err);
  // a persistent grid: as many CTAs as the card holds at once, no more
  // than the list can have work for
  const long long room = list_room(sweep, n_replicas, n_atoms, tile);
  const long long per_cta = sweep == kForce ? kWarps : 1;
  if (ctas > (room + per_cta - 1) / per_cta) ctas = (room + per_cta - 1) / per_cta;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(work, 0, 2 * sizeof(unsigned long long), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (sweep == kForce) {
    const long long NG = (n_atoms + 31) / 32;
    float* boxes = reinterpret_cast<float*>(work + 2 + room);
    if (has_cut) {
      newton_group_boxes_kernel<<<static_cast<unsigned>((n_replicas * NG * 32 + 255) / 256), 256,
                                  0, s>>>(a, boxes, n_replicas);
    }
    newton_patch_list_kernel<<<list_ctas(n_replicas * NG * NG), 256, 0, s>>>(a, boxes,
                                                                              n_replicas);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    newton_force_kernel<<<static_cast<unsigned>(ctas), kThreads, shmem, s>>>(a, boxes);
  } else {
    const long long G = a.n_tiles;
    newton_block_list_kernel<<<list_ctas(n_replicas * G * G), 256, 0, s>>>(a, n_replicas);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    if (sweep == kBorn) {
      newton_born_kernel<<<static_cast<unsigned>(ctas), kThreads, shmem, s>>>(a);
    } else {
      newton_energy_kernel<<<static_cast<unsigned>(ctas), kThreads, shmem, s>>>(a);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
