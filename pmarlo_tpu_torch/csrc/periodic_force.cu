// Dense minimum-image sweep for explicit solvent: energy rows and forces of
// the periodic LJ + reaction-field potential in one pass over all pairs.
//
// Replaces: pmarlo_tpu/md/pallas_periodic.py build_periodic_force_fn, its
// one Pallas sweep (kernel at :98, pallas_call at :190). The TPU kernel
// streamed (N, N) exclusion-scale tiles; here LJ and Coulomb are masked
// for |i - j| <= band (an index band that covers every exclusion and 1-4
// pair of a residue, waters included) and md/periodic_force.py adds the
// band and the far scaled pairs back at their wanted value from the pair
// lists, so nothing of size N^2 is stored. The bonded terms are plain
// PyTorch in the wrapper, which also holds this sweep's plain version.
//
// What bounds it on an H100: instructions. A sweep is R N (N - 1) / 2
// unordered candidate pairs (solvated chignolin, R = 8, N = 2,315: 21 M),
// each of which needs its minimum image and r^2 (~25 instructions), and
// ~12% of them lie inside the cutoff and need the pair term (~55 float32
// operations, one rsqrt, a float64 energy). Positions and three per-atom
// rows are O(N) and stay in L2.
//
// Design:
// - each unordered pair once, in the blocks (row tile r, column tile
//   c >= r) of kTile atoms of the dense GB sweeps (pair_force.cu): one CTA a
//   block, grid (G (G + 1) / 2, replicas), the block from the CTA's index by
//   triangle_block arithmetic; both tiles staged in shared memory as
//   PeriodicAtom (x, y, z, index | q, sigma, sqrt(eps)); the block's shared
//   memory (49.6 KB with the warps' pair lists) is dynamic.
// - inside a block, warp w takes the 32 x 32 patches w and w + 8 of the 16
//   (a diagonal block: the 10 with column group >= row group; a diagonal
//   patch only column > row) and walks each as periodic_patch.cuh does: the
//   pairs inside the cutoff compacted onto full warps before periodic_pair.
//   No patch is culled: at this box size (2.9 nm against a 0.9 nm cutoff)
//   every pair of 32-atom groups has a minimum-image gap under the cutoff.
// - minimum image per axis, d - L rintf(d / L), and r^2 without fused
//   multiply-adds (periodic_patch.cuh MinImage, pair_r2.cuh): the plain
//   version reproduces every r^2 bit for bit and cuts the same pairs (the
//   force jumps at the cutoff). The minimum image is an exact negation, so
//   the orientation in which a pair is taken does not matter.
// - fixed-order sums: a patch's row and column sums (periodic_patch.cuh)
//   go to their own entry of the block's partials (side, partner group,
//   atom), which are added in group order; a block's sums go to the slot
//   scratch (R, G, N): the row atoms' to slot c, the column atoms' to slot
//   r (a diagonal block: both to slot r). Each slot is written by exactly
//   one block, and periodic_slots_kernel adds an atom's G slots in slot
//   order (float64 energy): two launches give the same bits.
// - slot scratch: G = ceil(N / 128) slots an atom of a float4 (force, energy
//   half-sum), 16 B: 5.6 MB at R = 8, N = 2,315 (G = 19). The wrapper
//   allocates it and refuses a shape whose scratch exceeds a quarter of the
//   card's memory.
// - energy: half of each pair's energy to each atom's row, so the rows are
//   the half-summed rows of the row-owned sweep up to summation order.

#include <cuda_runtime.h>

#include <mutex>
#include <vector>

#include "periodic_patch.cuh"

namespace {

constexpr int kTile = 128;                  // atoms a tile
constexpr int kGroups = kTile / 32;         // 32-atom groups a tile
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;       // = 2 x kTile: one staged atom a thread

struct PeriodicArgs {
  const float* x;       // (R, N, 3)
  const float* atom_p;  // (3, N): q, sigma, sqrt(eps)
  float4* slots;        // (R, G, N) per-block partials: force, e / 2
  int n;
  int n_tiles;          // G
  int band;
  MinImage geo;
  PairPhys p;
};

// the block (row tile r, column tile c >= r) of index b, the upper triangle
// taken column by column: b = c (c + 1) / 2 + r
__device__ __forceinline__ void triangle_block(long long b, int* r, int* c) {
  long long cc = static_cast<long long>((sqrt(8.0 * static_cast<double>(b) + 1.0) - 1.0) * 0.5);
  while (cc * (cc + 1) / 2 > b) --cc;
  while ((cc + 1) * (cc + 2) / 2 <= b) ++cc;
  *c = static_cast<int>(cc);
  *r = static_cast<int>(b - cc * (cc + 1) / 2);
}

// a block's shared memory (dynamic: past the 48 KB of static shared memory)
struct BlockSmem {
  PeriodicAtom atom[2][kTile];            // rows, columns
  float4 part[2][kGroups][kTile];         // side, partner group, atom
  PatchScratch warp[kWarps];
};

__global__ void __launch_bounds__(kThreads) periodic_force_kernel(PeriodicArgs a) {
  extern __shared__ float4 smem4[];
  BlockSmem& sm = *reinterpret_cast<BlockSmem*>(smem4);
  auto& s_atom = sm.atom;
  auto& s_part = sm.part;
  PatchScratch* s_w = sm.warp;
  const int n = a.n;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int rt, ct;
  triangle_block(blockIdx.x, &rt, &ct);
  const bool diagonal = rt == ct;
  const size_t rbase = static_cast<size_t>(blockIdx.y) * n;
  for (int k = tid; k < 2 * kTile; k += kThreads) {
    const int side = k / kTile, slot = k % kTile;
    const int j = (side ? ct : rt) * kTile + slot;
    PeriodicAtom t = {};
    if (j < n) {
      const float* xj = a.x + (rbase + j) * 3;
      t.p = make_float4(xj[0], xj[1], xj[2], __int_as_float(j));
      t.m = make_float4(a.atom_p[j], a.atom_p[n + j], a.atom_p[2 * n + j], 0.0f);
    }
    s_atom[side][slot] = t;
  }
  float4* part = &s_part[0][0][0];
  for (int k = tid; k < 2 * kGroups * kTile; k += kThreads) {
    part[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  s_w[warp].cmask[lane] = 0u;
  __syncthreads();

  const int n_rows = min(kTile, n - rt * kTile);
  const int n_cols = min(kTile, n - ct * kTile);
  for (int item = warp; item < kGroups * kGroups; item += kWarps) {
    const int g = item / kGroups, h = item % kGroups;
    if ((diagonal && h < g) || g * 32 >= n_rows || h * 32 >= n_cols) continue;  // warp-uniform
    float4 col;
    walk_patch(a.p, a.geo, &s_atom[0][g * 32], &s_atom[1][h * 32], min(32, n_rows - g * 32),
               min(32, n_cols - h * 32), diagonal && g == h, a.band, s_w[warp], col);
    s_part[0][h][g * 32 + lane] = s_w[warp].racc[lane];
    s_part[1][g][h * 32 + lane] = col;
  }
  __syncthreads();

  // each atom's partial of this block, summed over the partner groups in a
  // fixed order, goes to the slot of the partner tile: the row atoms' to
  // slot c, the column atoms' to slot r (a diagonal block: both to slot r)
  for (int k = tid; k < 2 * kTile; k += kThreads) {
    const int side = k / kTile, slot = k % kTile;
    if (slot >= (side ? n_cols : n_rows) || (diagonal && side == 1)) continue;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int s = side; s < (diagonal ? 2 : side + 1); ++s) {
      for (int pg = 0; pg < kGroups; ++pg) {
        const float4 o = s_part[s][pg][slot];
        v.x += o.x;
        v.y += o.y;
        v.z += o.z;
        v.w += o.w;
      }
    }
    const int atom = (side ? ct : rt) * kTile + slot;
    const int partner = side ? rt : ct;
    a.slots[(static_cast<size_t>(blockIdx.y) * a.n_tiles + partner) * n + atom] = v;
  }
}

// Raises the kernel's dynamic shared-memory limit to a block's, once per
// device.
cudaError_t allow_block_smem() {
  static std::mutex mu;
  static std::vector<int> done;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  for (int d : done) {
    if (d == device) return cudaSuccess;
  }
  err = cudaFuncSetAttribute(periodic_force_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(sizeof(BlockSmem)));
  if (err == cudaSuccess) done.push_back(device);
  return err;
}

}  // namespace

extern "C" {

// phys: see make_pair_phys (reaction field: the dense sweep has no Ewald
// mode). slots: (R, ceil(N / 128), N) float4, written before they are read.
// Returns cudaGetLastError() after the launches on `stream`.
int pmarlo_periodic_force(const float* x, const float* atom_p, int n_replicas, int n_atoms,
                          int band, const float* box, const float* phys, double* e_rows,
                          float* forces, float* slots, void* stream) {
  if (n_atoms < 1 || n_replicas < 1 || n_replicas > 65535 || band < 0 || slots == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PeriodicArgs a = {};
  a.x = x;
  a.atom_p = atom_p;
  a.slots = reinterpret_cast<float4*>(slots);
  a.n = n_atoms;
  a.n_tiles = (n_atoms + kTile - 1) / kTile;
  a.band = band;
  for (int k = 0; k < 3; ++k) {
    a.geo.b[k] = box[k];
    a.geo.inv_b[k] = 1.0f / box[k];
  }
  a.p = make_pair_phys(phys, 0);
  cudaError_t err = allow_block_smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long blocks = static_cast<long long>(a.n_tiles) * (a.n_tiles + 1) / 2;
  periodic_force_kernel<<<dim3(static_cast<unsigned>(blocks), n_replicas), kThreads,
                          sizeof(BlockSmem), s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  periodic_slots_kernel<<<dim3((n_atoms + 255) / 256, n_replicas), 256, 0, s>>>(
      a.slots, a.n_tiles, n_atoms, nullptr, e_rows, forces);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
