// O(N) cell-list sweep for explicit solvent: energy rows and forces of the
// periodic LJ + reaction-field (or real-space Ewald) potential over every
// pair within the cutoff, found through the cells.
//
// Replaces: pmarlo_tpu/md/pallas_cells.py _build_cell_sweep, its one Pallas
// sweep (kernel at :118, pallas_call at :232). The TPU kernel walked a
// fixed-capacity slot array against nine ghost-padded, pre-shifted neighbour
// runs. None of that layout is carried over: atoms arrive as a permutation
// sorted by cell (ascending atom index within a cell) with CSR offsets,
// which hold any occupancy, so no cell can overflow. What is carried over:
// wrapped coordinates plus a lattice shift per neighbour cell across a face
// (so the kernel does no minimum-image arithmetic, orthorhombic or
// triclinic), the index-band mask |i - j| <= band on the atom index (the
// wrapper adds the band back at its wanted value), within = r^2 < rc^2, and
// the pair physics of periodic_pair.cuh: the force is the exact gradient of
// the kernel's own energy, in Ewald mode through erfcf and its exact
// derivative.
//
// What bounds it on an H100: instructions. A sweep is R N 27 (mean cell
// occupancy) / 2 unordered candidate pairs (27,783-atom water box, 7^3 cells
// of 81 atoms: 30 M a replica), each needing its r^2 (~15 instructions), and
// ~13% of them lie inside the cutoff and need the pair term (~55 float32
// operations and one rsqrt, three special-function results in Ewald mode).
// All inputs are O(N) and stay in L2.
//
// Design:
// - half shell: d = 0 is a cell's own pairs, column after row in sorted
//   order; d = 1..13 are the 13 forward neighbour offsets (those after
//   (0, 0, 0) in the order of the wrapper's shift table, offset index
//   13 + d), each neighbour displaced by the lattice shift of the faces it
//   is reached across. The 27-cell neighbourhood finds each ordered image
//   pair (i, j, image) within the cutoff exactly once (the wrapper refuses a
//   box under two cutoffs wide, so of the images a 1- or 2-cell axis puts in
//   the neighbourhood at most one lies inside); its reverse (j, i, -image) is
//   found through the opposite offset, from j's cell, with the negated
//   shift. The half shell keeps the one of the two whose offset is forward,
//   and on the own cell the one whose column comes after its row, so each
//   unordered image pair is taken once, also where an axis has 1 or 2 cells
//   and a direction and its opposite reach the same cell.
// - work items: (replica, cell c, direction d, split s), one warp an item,
//   R C 14 3 items, CTAs of 4 warps (a CTA's slots free as its items end).
//   Split s takes the cell's row groups of 32 atoms s, s + 3, ... against
//   every column group of the neighbour: the water box's cells hold ~81
//   atoms (3 groups: an item is 3 patches of 32 x 32), solvated chignolin's
//   3 x 3 x 2 cells ~129 (5 groups: 2, 2 and 1 row groups a split). A
//   warp a (cell, direction) was too few warps to hide the walk's latency
//   (1.14 waves of them on the water box at R = 1); strided splits keep a
//   cell's ragged last group off one item.
// - one orientation: a pair is displaced once, from its item's side,
//   xi - (xj + shift), and both atoms take that one r^2, so a pair within
//   rounding of the cutoff is kept or cut for both (md/cell_force.py
//   sweep_reference computes it so too).
// - stage once, in sorted order: cell_pack_kernel gathers the atoms through
//   the sort permutation into PeriodicAtom (x, y, z, index | q, sigma,
//   sqrt(eps)) by sorted position; an item stages its row groups and each
//   column group from there in its warp's shared memory (the neighbour's
//   with the shift added), and walks the patches (the own cell: column
//   group >= row group, a diagonal patch column > row) as
//   periodic_patch.cuh does: the pairs inside the cutoff compacted onto
//   full warps before periodic_pair.
// - fixed-order sums, no float atomics: a slot scratch (R, 56, N) of float4
//   (force, energy half-sum) by sorted position: for each direction d a row
//   slot (an atom's sums as a row of the items (c, d)) and a column slot a
//   split (its sums as a column of the item (c - offset, d, s)). Each slot
//   belongs to one item, which writes it once (a column atom the item takes
//   no pair of gets a zero); in a cell of more than 96 atoms a split adds
//   its later row groups' column sums to the slot from the lane that wrote
//   it. periodic_slots_kernel adds an atom's 56 slots in slot order,
//   the energy in float64, and writes the outputs by atom index. Two
//   launches give the same bits.
// - scratch: the packed atoms (32 B) and 56 slots of 16 B an atom, 928 B:
//   25.8 MB at R = 1 and 103 MB at R = 4 on the water box, 17.2 MB at R = 8
//   on solvated chignolin. The wrapper allocates it and refuses a shape
//   whose scratch exceeds a quarter of the card's memory.
// - energy: half of each pair's energy to each atom's row, so the rows are
//   the half-summed rows of the row-owned sweep up to summation order.
// - x-slabs (pmarlo_cell_force_slab; pallas_cells.py's mesh branch, :428-560):
//   a rank of a mesh walks the home cells of its slab of cxl x-layers only,
//   on a slab grid of cxl + 1 layers whose last is the halo: the next slab's
//   first layer (the half shell's dx is 0 or +1, so one halo layer on the +x
//   face covers every pair). The wrapper hands the slab's atoms in sorted
//   order with their global indices and CSR offsets on the slab grid; the
//   x axis of the slab grid does not wrap, except that the last rank's halo
//   is layer 0 reached across the +x face (halo_wrap), whose shift the
//   table gives, so each pair is displaced as the unsharded sweep does.
//   Slots no home item writes are zero; outputs go to the atoms' global
//   rows (the other rows zero), and an all_reduce over the ranks adds them:
//   each home cell lies in one slab, so each pair is counted once. The
//   scratch is sized to the slab's atoms.

#include <cuda_runtime.h>

#include "periodic_patch.cuh"

namespace {

constexpr int kWarps = 4;   // small CTAs: a warp's item ends on its own
constexpr int kThreads = 32 * kWarps;
constexpr int kDirections = 14;   // the own cell and 13 forward neighbours
constexpr int kSplits = 3;        // items a direction: row groups s, s + 3, ... each
constexpr int kSlots = kDirections * (1 + kSplits);   // a row slot and kSplits column slots

struct CellArgs {
  const PeriodicAtom* packed;   // (R, N) by sorted position
  const int* cell_start;        // (R, n_cells + 1) CSR offsets into the sorted order
  float4* slots;                // (R, kSlots, N) by sorted position: force, e / 2
  const float* shifts;          // (27, 3) lattice shift of the wrap (wx, wy, wz) in {-1, 0, 1}^3
  long long n_items;            // R n_home kDirections kSplits
  int n;                        // atoms a replica in sorted order (the slab's)
  int nx, ny, nz;
  int n_home;                   // items walk home cells [0, n_home)
  int halo_wrap;                // the last x-layer is reached across the +x face
  int band;
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

// The atoms by sorted position: packed[rep, p] of atom order[rep, p]
// (PeriodicAtom: x, y, z, index | q, sigma, sqrt(eps)); n sorted positions
// a replica of n_atoms atoms (fewer for a slab).
__global__ void cell_pack_kernel(const float* xw, const float* atom_p, const int* order, int n,
                                 int n_atoms, PeriodicAtom* packed) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const size_t pbase = static_cast<size_t>(blockIdx.y) * n;
  const int atom = order[pbase + p];
  const float* x = xw + (static_cast<size_t>(blockIdx.y) * n_atoms + atom) * 3;
  PeriodicAtom t;
  t.p = make_float4(x[0], x[1], x[2], __int_as_float(atom));
  t.m = make_float4(atom_p[atom], atom_p[n_atoms + atom], atom_p[2 * n_atoms + atom], 0.0f);
  packed[pbase + p] = t;
}

// a slot's first write stores, a later one (a split's later row group in a
// cell of more than 96 atoms) adds
__device__ __forceinline__ void put_slot(float4* slot, const float4& v, bool first) {
  if (first) {
    *slot = v;
    return;
  }
  float4 o = *slot;
  o.x += v.x;
  o.y += v.y;
  o.z += v.z;
  o.w += v.w;
  *slot = o;
}

// (launch bounds of eight CTAs an SM, 32 warps: 64 registers; ten CTAs left
// 48 registers and 24 bytes of spills)
__global__ void __launch_bounds__(kThreads, 8) cell_force_kernel(CellArgs a) {
  __shared__ PeriodicAtom s_rows[kWarps][32], s_cols[kWarps][32];
  __shared__ PatchScratch s_w[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  PatchScratch& w = s_w[warp];
  PeriodicAtom* rows = s_rows[warp];
  PeriodicAtom* cols = s_cols[warp];
  w.cmask[lane] = 0u;
  const long long item = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (item >= a.n_items) return;   // the whole warp; no CTA barrier follows
  const int n = a.n;
  const int n_cells = a.nx * a.ny * a.nz;
  const int split = static_cast<int>(item % kSplits);
  const int d = static_cast<int>((item / kSplits) % kDirections);
  const int cell = static_cast<int>((item / (kSplits * kDirections)) % a.n_home);
  const long long rep = item / (static_cast<long long>(kSplits * kDirections) * a.n_home);
  const int* cs = a.cell_start + rep * (n_cells + 1);

  int nc = cell;
  float sx = 0.0f, sy = 0.0f, sz = 0.0f;
  if (d > 0) {
    const int k = 13 + d;   // the offset (k / 9 - 1, (k / 3) % 3 - 1, k % 3 - 1)
    const int cz = cell % a.nz;
    const int cy = (cell / a.nz) % a.ny;
    const int cx = cell / (a.nz * a.ny);
    int wx, wy, wz;
    const int ncx = wrap_cell(cx + k / 9 - 1, a.nx, &wx);
    const int ncy = wrap_cell(cy + (k / 3) % 3 - 1, a.ny, &wy);
    const int ncz = wrap_cell(cz + k % 3 - 1, a.nz, &wz);
    if (a.halo_wrap && ncx == a.nx - 1) wx = 1;
    nc = (ncx * a.ny + ncy) * a.nz + ncz;
    // the wrapper's table, so the plain version adds the same float
    const float* sh = a.shifts + 3 * ((wx + 1) * 9 + (wy + 1) * 3 + (wz + 1));
    sx = sh[0];
    sy = sh[1];
    sz = sh[2];
  }
  const int r0 = cs[cell], nr = cs[cell + 1] - r0;
  const int c0 = cs[nc], ncl = cs[nc + 1] - c0;
  const PeriodicAtom* pk = a.packed + static_cast<size_t>(rep) * n;
  float4* slots = a.slots + static_cast<size_t>(rep) * kSlots * n;
  float4* row_slot = slots + static_cast<size_t>(d * (1 + kSplits)) * n + r0;
  float4* col_slot = slots + static_cast<size_t>(d * (1 + kSplits) + 1 + split) * n + c0;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  // this split's row groups: split, split + kSplits, ...
  const int g_first = 32 * split;
  // column atoms this split takes no pair of get a zero in its column slot:
  // all of them when it has no rows, on the own cell those before its rows
  const int unpaired = g_first >= nr ? ncl : (d == 0 ? min(g_first, ncl) : 0);
  for (int o = lane; o < unpaired; o += 32) col_slot[o] = zero;
  for (int g0 = g_first; g0 < nr; g0 += 32 * kSplits) {
    const int n_rows = min(32, nr - g0);
    __syncwarp();   // the last patch's readers of the staged rows are done
    if (lane < n_rows) rows[lane] = pk[r0 + g0 + lane];
    float4 racc = zero;
    for (int h0 = d == 0 ? g0 : 0; h0 < ncl; h0 += 32) {
      const int n_cols = min(32, ncl - h0);
      __syncwarp();   // the last patch's readers of the staged columns are done
      if (lane < n_cols) {
        PeriodicAtom t = pk[c0 + h0 + lane];
        t.p.x = __fadd_rn(t.p.x, sx);
        t.p.y = __fadd_rn(t.p.y, sy);
        t.p.z = __fadd_rn(t.p.z, sz);
        cols[lane] = t;
      }
      __syncwarp();
      float4 col;
      walk_patch(a.p, Difference(), rows, cols, n_rows, n_cols, d == 0 && h0 == g0, a.band, w,
                 col);
      const float4 r = w.racc[lane];
      racc.x += r.x;
      racc.y += r.y;
      racc.z += r.z;
      racc.w += r.w;
      // a column atom's first patch in this split is the one of its first row group
      if (lane < n_cols) put_slot(col_slot + h0 + lane, col, g0 == g_first);
    }
    if (lane < n_rows) row_slot[g0 + lane] = racc;
  }
}

}  // namespace

// Both entries: the launches on `stream`, cudaGetLastError() after them.
static int launch_cells(const float* xw, const float* atom_p, const int* order,
                        const int* cell_start, int n_replicas, int n_pos, int n_atoms,
                        const int* dims, int n_home, int halo_wrap, int band, const float* shifts, const float* phys, int ewald,
                 double* e_rows, float* forces, float* scratch, cudaStream_t s) {
  const long long n_items = static_cast<long long>(n_replicas) * n_home * kDirections * kSplits;
  if ((n_items + kWarps - 1) / kWarps > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CellArgs a = {};
  a.packed = reinterpret_cast<const PeriodicAtom*>(scratch);
  a.cell_start = cell_start;
  a.slots = reinterpret_cast<float4*>(scratch + static_cast<size_t>(n_replicas) * n_pos * 8);
  a.shifts = shifts;
  a.n_items = n_items;
  a.n = n_pos;
  a.nx = dims[0];
  a.ny = dims[1];
  a.nz = dims[2];
  a.n_home = n_home;
  a.halo_wrap = halo_wrap;
  a.band = band;
  a.p = make_pair_phys(phys, ewald);
  const dim3 per_pos((n_pos + 255) / 256, n_replicas);
  cell_pack_kernel<<<per_pos, 256, 0, s>>>(xw, atom_p, order, n_pos, n_atoms,
                                           reinterpret_cast<PeriodicAtom*>(scratch));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_items > 0) {
    cell_force_kernel<<<static_cast<unsigned>((n_items + kWarps - 1) / kWarps), kThreads, 0, s>>>(
        a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  periodic_slots_kernel<<<per_pos, 256, 0, s>>>(a.slots, kSlots, n_pos, order, e_rows, forces);
  return static_cast<int>(cudaGetLastError());
}

extern "C" {

// dims: nx, ny, nz (host memory); shifts: (27, 3) device table of the lattice
// shifts wx a + wy b + wz c, indexed (wx + 1) 9 + (wy + 1) 3 + (wz + 1); phys
// as in pmarlo_periodic_force; scratch: R N (8 + 4 kSlots) floats, the packed
// atoms (R, N, 8) and then the slots (R, kSlots, N, 4) (md/cell_force.py
// cell_scratch), written before they are read. Returns cudaGetLastError()
// after the launches on `stream`.
int pmarlo_cell_force(const float* xw, const float* atom_p, const int* order,
                      const int* cell_start, int n_replicas, int n_atoms, const int* dims,
                      int band, const float* shifts, const float* phys, int ewald,
                      double* e_rows, float* forces, float* scratch, void* stream) {
  if (n_atoms < 1 || n_replicas < 1 || n_replicas > 65535 || band < 0 || dims[0] < 1 ||
      dims[1] < 1 || dims[2] < 1 || scratch == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_cells(xw, atom_p, order, cell_start, n_replicas, n_atoms, n_atoms, dims,
                      dims[0] * dims[1] * dims[2], 0, band, shifts, phys, ewald, e_rows, forces,
                      scratch, static_cast<cudaStream_t>(stream));
}

// One replica's x-slab (see the design notes): order (n_slab,) the global
// atom index of each of the slab's sorted positions, cell_start the CSR
// offsets (n_slab_cells + 1) on the slab grid dims (host memory: cxl + 1,
// ny, nz), home cells [0, n_home); xw (n_atoms, 3) and atom_p by global
// index; scratch n_slab (8 + 4 kSlots) floats. e_rows (n_atoms) and forces
// (n_atoms, 3) are zeroed here, then the slab's atoms written.
int pmarlo_cell_force_slab(const float* xw, const float* atom_p, const int* order,
                           const int* cell_start, int n_atoms, int n_slab, const int* dims,
                           int n_home, int halo_wrap, int band, const float* shifts,
                           const float* phys, int ewald, double* e_rows, float* forces,
                           float* scratch, void* stream) {
  if (n_atoms < 1 || n_slab < 1 || n_slab > n_atoms || n_home < 1 || band < 0 ||
      dims[0] < 2 || dims[1] < 1 || dims[2] < 1 || n_home > (dims[0] - 1) * dims[1] * dims[2] ||
      scratch == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(e_rows, 0, sizeof(double) * n_atoms, s);
  if (err == cudaSuccess) err = cudaMemsetAsync(forces, 0, sizeof(float) * 3 * n_atoms, s);
  // the slots no home item writes: the halo's rows and the columns a home
  // cell reaches from outside the slab
  if (err == cudaSuccess) {
    err = cudaMemsetAsync(scratch + static_cast<size_t>(n_slab) * 8, 0,
                          sizeof(float4) * kSlots * static_cast<size_t>(n_slab), s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_cells(xw, atom_p, order, cell_start, 1, n_slab, n_atoms, dims, n_home,
                      halo_wrap, band, shifts, phys, ewald, e_rows, forces, scratch, s);
}

}  // extern "C"
