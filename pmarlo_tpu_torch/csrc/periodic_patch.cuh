// The patch walk shared by the two explicit-solvent sweeps (periodic_force.cu
// and cell_force.cu): one warp takes a 32 x 32 patch of row and column atoms,
// tests every (row, column) candidate on r^2, compacts the pairs inside the
// cutoff onto full warps, and runs the pair function (periodic_pair.cuh) on
// batches of 32 of them. Each pair is an unordered pair taken once: its
// force -W d goes to the row atom and +W d to the column atom, half its
// energy to each atom's row.
//
// What this fixes: the row-owned sweeps that came before gave a warp 32 rows
// against one column, so with 12-13% of the candidates inside the cutoff a
// warp entered the pair function on ~98% of its steps with ~4 of 32 lanes
// busy, and every unordered pair was evaluated twice, once from each row.
//
// - candidate test: lane i holds row i and tests it against the 32 columns
//   (a broadcast read each) in one unrolled loop of independent steps,
//   building its row's mask of kept columns; the band (|i - j| <= band on
//   the atom index), the self and coincident pairs (r^2 <= 1e-8), the
//   columns and rows past the patch's atoms and, on a diagonal patch, the
//   lower triangle (column <= row) are decided there. A warp scan of the
//   rows' counts places each row's pairs in the warp's list (row << 5 |
//   column), in row order and a row's in column order. (A column a lane
//   and a row a step, with a ballot and a queue append a row, took about
//   twice the instructions a candidate on a chain of dependent steps.)
// - each 32 entries of the list are a batch: every lane takes one and runs
//   periodic_pair.
// - sums, in a fixed order, no float atomics (two launches give the same
//   bits):
//   - a batch holds its pairs in row order, so a row's pairs sit in
//     consecutive lanes: a segmented shuffle reduction adds them, and the
//     segment's first lane adds the result to the patch's row sum (racc,
//     one writer a row). (Shuffles from registers in place of these shared
//     reads measured 7-9% slower.)
//   - each lane stages its pair's column terms (W d, e / 2) and sets its bit
//     in its column's mask (an integer atomicOr, whose result does not depend
//     on the order); lane j then adds the staged terms of its column's lanes
//     in lane order, which is row order.
// - forces and energy halves are float32 within a patch (a row or a column
//   of a patch has at most 32 terms) and within a slot (the few patches of
//   one work item); periodic_slots_kernel adds an atom's slots in float64
//   for the energy.
#pragma once

#include "periodic_pair.cuh"

namespace {

// A staged atom: p = (x, y, z, the atom's index as int bits), what the
// candidate test reads; m = (q, sigma, sqrt(eps), 0), what the pair term
// reads besides.
struct PeriodicAtom {
  float4 p;
  float4 m;
};

// A warp's shared scratch for the patch walk.
struct PatchScratch {
  unsigned short list[32 * 32];   // the patch's pairs, row << 5 | column
  float4 stage[32];               // a batch's column terms (W d, e / 2), by lane
  unsigned cmask[32];             // the lanes of the batch that hold each column
  float4 racc[32];                // the patch's row sums (force, e / 2), by row
};

// The displacement of a row atom from a column atom. Every product and sum
// is rounded on its own (no fused multiply-add), as the plain versions
// compute it, so both decide the cutoff on the same r^2.
// Dense sweep: the per-axis minimum image on an orthorhombic box,
// d - L rintf(d / L) (rintf rounds half to even, as torch.round does).
struct MinImage {
  float b[3], inv_b[3];
  __device__ __forceinline__ void operator()(const float4& a, const float4& c, float& dx,
                                             float& dy, float& dz) const {
    dx = __fsub_rn(a.x, c.x);
    dy = __fsub_rn(a.y, c.y);
    dz = __fsub_rn(a.z, c.z);
    dx = __fsub_rn(dx, __fmul_rn(b[0], rintf(__fmul_rn(dx, inv_b[0]))));
    dy = __fsub_rn(dy, __fmul_rn(b[1], rintf(__fmul_rn(dy, inv_b[1]))));
    dz = __fsub_rn(dz, __fmul_rn(b[2], rintf(__fmul_rn(dz, inv_b[2]))));
  }
};

// Cell sweep: the column atoms were staged with their lattice shift added,
// so the displacement is the plain difference xi - (xj + shift).
struct Difference {
  __device__ __forceinline__ void operator()(const float4& a, const float4& c, float& dx,
                                             float& dy, float& dz) const {
    dx = __fsub_rn(a.x, c.x);
    dy = __fsub_rn(a.y, c.y);
    dz = __fsub_rn(a.z, c.z);
  }
};

// One batch of listed pairs, one a lane (`valid` false: no pair), called by
// the whole warp. Row sums to w.racc, column sums to `col` of the lane whose
// index is the column.
template <typename Disp>
__device__ __forceinline__ void run_batch(const PairPhys& p, const Disp& disp,
                                          const PeriodicAtom* rows, const PeriodicAtom* cols,
                                          PatchScratch& w, int entry, bool valid, float4& col) {
  const int lane = threadIdx.x & 31;
  const int i = valid ? entry >> 5 : -1;
  float4 t = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (valid) {
    const int j = entry & 31;
    const PeriodicAtom ai = rows[i], aj = cols[j];
    float dx, dy, dz;
    disp(ai.p, aj.p, dx, dy, dz);
    double e;
    float wt;
    periodic_pair(p, pair_r2(dx, dy, dz), ai.m.x, aj.m.x, 0.5f * (ai.m.y + aj.m.y),
                  ai.m.z * aj.m.z, &e, &wt);
    t = make_float4(wt * dx, wt * dy, wt * dz, static_cast<float>(0.5 * e));
    w.stage[lane] = t;
    atomicOr(&w.cmask[j], 1u << lane);
  }
  // segment heads: the first lane of each row's run (and of the idle tail);
  // bits past lane 31 stop a sum at the warp's end
  const int i_before = __shfl_up_sync(0xffffffffu, i, 1);
  const bool head = lane == 0 || i_before != i;
  const unsigned long long stops =
      (static_cast<unsigned long long>(__ballot_sync(0xffffffffu, head)) | (~0ull << 32)) >>
      (lane + 1);
  // each lane ends with the sum over its lane and the later lanes of its row
  float r[4] = {-t.x, -t.y, -t.z, t.w};
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const bool same = (stops & ((1ull << off) - 1ull)) == 0ull;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float o = __shfl_down_sync(0xffffffffu, r[k], off);
      if (same) r[k] += o;
    }
  }
  if (valid && head) {
    float4 s = w.racc[i];
    s.x += r[0];
    s.y += r[1];
    s.z += r[2];
    s.w += r[3];
    w.racc[i] = s;
  }
  __syncwarp();
  unsigned m = w.cmask[lane];
  w.cmask[lane] = 0u;
  while (m) {
    const int k = __ffs(m) - 1;
    m &= m - 1;
    const float4 s = w.stage[k];
    col.x += s.x;
    col.y += s.y;
    col.z += s.z;
    col.w += s.w;
  }
  __syncwarp();   // the next batch overwrites stage and cmask
}

// One patch by one warp: rows[0, n_rows) against cols[0, n_cols) (shared
// memory the caller has staged; entries past n_rows / n_cols are read but
// never kept; `upper`: the same atoms on both sides, only column > row).
// Returns with the row sums in w.racc[row] and the lane's column sum in
// `col`. w.cmask must be zero on entry, and is on return.
template <typename Disp>
__device__ __forceinline__ void walk_patch(const PairPhys& p, const Disp& disp,
                                           const PeriodicAtom* rows, const PeriodicAtom* cols,
                                           int n_rows, int n_cols, bool upper, int band,
                                           PatchScratch& w, float4& col) {
  const int lane = threadIdx.x & 31;
  w.racc[lane] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  col = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const float4 pi = rows[lane].p;
  // |i - j| > band as one unsigned compare: i + band - j outside [0, 2 band]
  const int ib = __float_as_int(pi.w) + band;
  const unsigned band2 = 2u * static_cast<unsigned>(band);
  unsigned mask = 0u;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const float4 pj = cols[j].p;
    float dx, dy, dz;
    disp(pi, pj, dx, dy, dz);
    const float r2 = pair_r2(dx, dy, dz);
    if (r2 < p.rc2 && r2 > 1e-8f && static_cast<unsigned>(ib - __float_as_int(pj.w)) > band2) {
      mask |= 1u << j;
    }
  }
  unsigned allowed = n_cols < 32 ? (1u << n_cols) - 1u : ~0u;
  if (upper) allowed &= lane < 31 ? ~0u << (lane + 1) : 0u;
  mask &= lane < n_rows ? allowed : 0u;
  // each row's pairs to the list after the rows before it
  const int count = __popc(mask);
  int end = count;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, end, off);
    if (lane >= off) end += o;
  }
  const int total = __shfl_sync(0xffffffffu, end, 31);
  for (int k = end - count; mask; ++k) {
    const int j = __ffs(mask) - 1;
    mask &= mask - 1;
    w.list[k] = static_cast<unsigned short>((lane << 5) | j);
  }
  __syncwarp();
  for (int b0 = 0; b0 < total; b0 += 32) {
    const int k = b0 + lane;
    run_batch(p, disp, rows, cols, w, k < total ? w.list[k] : 0, k < total, col);
  }
  __syncwarp();
}

// Each atom's outputs from its n_slots slots (R, n_slots, N) of (force,
// energy half-sum), added in slot order: the energy row in float64, the
// force in float32. Slot p of a replica belongs to atom order[p] (order
// null: atom p).
__global__ void periodic_slots_kernel(const float4* slots, int n_slots, int n, const int* order,
                                      double* e_rows, float* forces) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const size_t rep = blockIdx.y;
  float fx = 0.0f, fy = 0.0f, fz = 0.0f;
  double e = 0.0;
  for (int s = 0; s < n_slots; ++s) {
    const float4 v = slots[(rep * n_slots + s) * n + p];
    fx += v.x;
    fy += v.y;
    fz += v.z;
    e += v.w;
  }
  const size_t atom = rep * n + (order != nullptr ? order[rep * n + p] : p);
  e_rows[atom] = e;
  forces[3 * atom] = fx;
  forces[3 * atom + 1] = fy;
  forces[3 * atom + 2] = fz;
}

}  // namespace
