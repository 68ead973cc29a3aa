// GB pair sweeps that take each unordered pair once: both Born / dE/dB
// attributions and Newton's third law.
//
// Replaces: pmarlo_tpu/md/pallas_pair.py _build_newton_path, its three
// Pallas sweeps over a flat block list (newton=True, the default with
// gb_cutoff):
//   newton_born_kernel   <- sweep1_s (:1442) / born_sym
//   newton_energy_kernel <- sweep2_s (:1461) / energy_sym
//   newton_force_kernel  <- sweep3_s (:1479) / force_sym
// They compute what the ordered sweeps of pair_force.cu compute (same
// outputs, same glue around them in md/pair_force.py), at about half the
// pair work: the distance, LJ + Coulomb, the GB f-function and the neck are
// evaluated once a pair; only the HCT term is evaluated per direction.
//
// What bounds them on an H100: not bytes (a work item's per-atom data is 64
// atoms) but instructions, and few of them on the pairs that count: at
// 61,824 atoms (tile 128, cutoff 1.5 nm) 2.9% of the pairs of the tile
// blocks within reach lie inside the cutoff. So the three sweeps are built
// so that lanes run pair functions on pairs inside the cutoff only, and
// warps never wait for each other (PERF.md section 6 has the times against
// the bound). One walk (newton_sweep), a functor a sweep for what a pair
// adds and where the sums go:
// - one work list for the three sweeps of an evaluation: the 32 x 32
//   patches (row group g, column group h >= g of 32-atom groups) of the tile
//   blocks that the wrapper's `close` table keeps (tile pairs whose boxes
//   are within the cutoff, from the live positions; null without a cutoff:
//   every block), less those whose two groups' bounding boxes are farther
//   apart than the cutoff. group_boxes_kernel (pair_groups.cuh) computes
//   the boxes, newton_patch_list_kernel writes the patches that pass, warp
//   by warp (ballot, one atomic add a warp), and their count beside them. The test
//   on the boxes is tiles_within's (md/pair_force.py) at 32-atom tiles, so a
//   patch left out holds no pair inside the cutoff. At 24,840 atoms 39% of
//   the patches of the kept blocks pass it. The list's room is the whole
//   upper triangle, so it cannot overflow, and the host never reads the
//   count (the TPU kernel ran a compacted, statically sized block list on a
//   sequential grid and poisoned the result when the list overflowed). The
//   positions and `close` are the same for the three sweeps, so the wrapper
//   builds the list once an evaluation and each sweep zeroes only the
//   counter of items taken.
// - a persistent grid, as many CTAs as the card holds at once; each warp
//   takes the next patch from the atomic counter until the list is done. A
//   warp takes a patch alone: it stages the 32 row and 32 column atoms in
//   its own shared memory (the sweep's float4s an atom, gb_force.cuh: two
//   for Born and energy, three for force), and no barrier joins the warps of
//   a CTA, so a patch with many pairs holds up no other warp.
// - the rows within the cutoff of the column group's box are found by one
//   ballot; each of them is tested against the 32 columns, a column a lane,
//   on r^2 alone (a diagonal patch: the strict upper triangle in storage
//   order, column > row). The pairs that pass are compacted (__ballot_sync,
//   __popc) into the warp's queue; whenever 32 are queued, every lane takes
//   one and runs the sweep's pair function (gb_force.cuh: born_pair_values,
//   energy_pair, force_pair, the dense sweeps' own, with single
//   special-function results). The rest of the queue is drained at the end
//   of the patch, whose sums then go to the outputs.
// - a batch holds its pairs in row order (rows are taken in increasing
//   order, a row's pairs in column order), so the pairs of one row sit in
//   consecutive lanes: their row sums are added by a segmented shuffle
//   reduction and stored once, by the segment's first lane, with no atomic
//   (the warp owns the patch's row slots; shared-memory float atomicAdd is a
//   compare-and-swap loop on this card, and the lanes of one row would all
//   contend for one address). The column sums, whose atoms repeat only
//   across rows, use shared atomicAdd: one float a pair for Born and energy,
//   three for force.
// - the patch's sums go to the outputs by global atomicAdd (float for I,
//   dE/dB and F, double for the energy rows). The order of these additions
//   changes from run to run, so results differ in the last bits between
//   runs; the ordered sweeps are the bit-reproducible path. The wrapper
//   zeroes the outputs before the launch.
// - energy rows: the unordered pair's energy (both rows' shares) goes to its
//   row atom (the lower storage index), so the rows sum to the total as the
//   ordered rows do, though atom by atom they differ from them; summed in
//   float32 within a batch's row segment (at most 32 terms) and in float64
//   from there (the warp's row slots, then the output). dE/dB keeps the
//   ordered quantity on each side; the glue doubles it.
// - the band mask keys on the atoms' original indices (storage is a Morton
//   order): the force sweep stages them in its atoms (meta), the energy
//   sweep holds them in a register a lane and decides the band when it
//   queues a pair (a bit of the queue entry). The cutoff test, the skipped
//   self and coincident pairs (r^2 <= 1e-8) and the neck tables in shared
//   memory are those of pair_force.cu.

#include <mutex>
#include <vector>

#include "gb_force.cuh"
#include "pair_common.cuh"
#include "pair_groups.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kQueue = 64;                // a warp's queue: < 32 left over + 32 new

// ---- the work list ----

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

// The list: the 32 x 32 patches (rep * NG + g) * NG + h with h >= g whose
// tile block `close` keeps and whose two group boxes are within the cutoff
// (every patch of the upper triangle without a cutoff).
__global__ void newton_patch_list_kernel(PairArgs a, const float* boxes, int n_replicas) {
  const long long NG = (a.n + 31) / 32, G = a.n_tiles, per = a.tile / 32;
  append_kept(a.work, n_replicas * NG * NG, [&](long long idx) {
    const long long rep = idx / (NG * NG), g = (idx / NG) % NG, h = idx % NG;
    if (h < g) return false;
    if (a.close != nullptr && !a.close[(rep * G + g / per) * G + h / per]) return false;
    return !a.has_cut || !boxes_apart(a, boxes + (rep * NG + g) * 6, boxes + (rep * NG + h) * 6);
  }, [](long long idx) { return static_cast<unsigned long long>(idx); });
}

// ---- the sweeps ----
// A sweep functor gives:
//   Atom                 the staged atom (float4s, gb_force.cuh), load(a, rbase, j)
//   kOut                 float outputs an atom in out0 (I, dE/dB: 1; F: 3)
//   kEnergy              a float64 energy row besides (row atom only)
//   kBand                its pair function needs the band bit of the queue entry
//   pair(a, s_neck, s, dx, dy, dz, ai, aj, nonbonded, row, col)
//                        one pair's terms: row[0, kOut) to the row atom's
//                        outputs, row[kOut] its energy (kEnergy), col[0,
//                        kOut) to the column atom's outputs

struct NewtonBorn {
  using Atom = BornAtom;
  static constexpr int kOut = 1;
  static constexpr bool kEnergy = false, kBand = false;
  __device__ static Atom load(const PairArgs& a, size_t rbase, int j) {
    return load_born_atom(a, rbase, j);
  }
  __device__ static void pair(const PairArgs& a, const float* s_neck, float s, float, float, float,
                              const Atom& ai, const Atom& aj, bool, float* row, float* col) {
    const BornPair p = born_pair_values(a, s_neck, s, ai, aj);
    row[0] = 0.5f * p.h_ij + p.neck;
    col[0] = 0.5f * p.h_ji + p.neck;
  }
};

struct NewtonEnergy {
  using Atom = EnergyAtom;
  static constexpr int kOut = 1;   // dE/dB
  static constexpr bool kEnergy = true, kBand = true;
  __device__ static Atom load(const PairArgs& a, size_t rbase, int j) {
    return load_energy_atom(a, rbase, j);
  }
  __device__ static void pair(const PairArgs& a, const float*, float s, float, float, float,
                              const Atom& ai, const Atom& aj, bool nonbonded, float* row,
                              float* col) {
    const EnergyPair p = energy_pair(a, s, ai, aj, nonbonded);
    row[0] = p.dedb_i;
    row[1] = 2.0f * p.e;   // the unordered pair's energy, both rows' shares, to the row atom
    col[0] = p.dedb_j;
  }
};

struct NewtonForce {
  using Atom = ForceAtom;
  static constexpr int kOut = 3;
  static constexpr bool kEnergy = false, kBand = false;
  __device__ static Atom load(const PairArgs& a, size_t rbase, int j) {
    return load_force_atom(a, rbase, j);
  }
  __device__ static void pair(const PairArgs& a, const float* s_neck, float s, float dx, float dy,
                              float dz, const Atom& ai, const Atom& aj, bool, float* row,
                              float* col) {
    const float f = force_pair(a, s_neck, s, ai, aj);
    col[0] = f * dx;
    col[1] = f * dy;
    col[2] = f * dz;
    row[0] = -col[0];
    row[1] = -col[1];
    row[2] = -col[2];
  }
};

// a warp's shared memory: the patch's atoms (rows, then columns; part q of
// slot k at [side * kParts + q][k]), the patch's float64 row energies
// (kEnergy), its float sums (rows' kOut, then columns' kOut, 32 each) and
// the queue of pairs inside the cutoff
template <typename S>
struct WarpSmem {
  static constexpr int kParts = sizeof(typename S::Atom) / sizeof(float4);
  static constexpr size_t kBytes = sizeof(float4) * 2 * kParts * 32 +
                                   sizeof(double) * (S::kEnergy ? 32 : 0) +
                                   sizeof(float) * 2 * S::kOut * 32 + sizeof(int) * kQueue;
  static_assert(kBytes % sizeof(float4) == 0, "each warp's part starts 16-byte aligned");
  float4* atom;
  double* e_row;
  float* acc;
  int* queue;   // nonbonded << 16 | row slot << 8 | column slot

  __device__ explicit WarpSmem(char* base) {
    atom = reinterpret_cast<float4*>(base);
    e_row = reinterpret_cast<double*>(atom + 2 * kParts * 32);
    acc = reinterpret_cast<float*>(e_row + (S::kEnergy ? 32 : 0));
    queue = reinterpret_cast<int*>(acc + 2 * S::kOut * 32);
  }
  __device__ void put(int side, int slot, const typename S::Atom& t) const {
    const float4* p = reinterpret_cast<const float4*>(&t);
#pragma unroll
    for (int q = 0; q < kParts; ++q) atom[(side * kParts + q) * 32 + slot] = p[q];
  }
  __device__ typename S::Atom get(int side, int slot) const {
    typename S::Atom t;
    float4* p = reinterpret_cast<float4*>(&t);
#pragma unroll
    for (int q = 0; q < kParts; ++q) p[q] = atom[(side * kParts + q) * 32 + slot];
    return t;
  }
};

// dynamic shared memory of a sweep: the warps' patches and the neck tables
template <typename S>
constexpr size_t sweep_smem(int neck_floats) {
  return kWarps * WarpSmem<S>::kBytes + sizeof(float) * neck_floats;
}

// A batch of queued pairs, one a lane (`valid` false: no pair), called by
// the whole warp: each pair's terms to both atoms' sums. The row sums by a
// segmented shuffle reduction, stored by the segment's first lane; the
// column sums by shared atomicAdd.
template <typename S>
__device__ __forceinline__ void run_batch(const PairArgs& a, const WarpSmem<S>& w,
                                          const float* s_neck, int entry, bool valid) {
  constexpr int kRow = S::kOut + (S::kEnergy ? 1 : 0);
  const int lane = threadIdx.x & 31;
  const int i = valid ? (entry >> 8) & 0xff : -1;
  float row[kRow];
#pragma unroll
  for (int d = 0; d < kRow; ++d) row[d] = 0.0f;
  if (valid) {
    const int j = entry & 0xff;
    const typename S::Atom ai = w.get(0, i), aj = w.get(1, j);
    const float dx = ai.p0.x - aj.p0.x, dy = ai.p0.y - aj.p0.y, dz = ai.p0.z - aj.p0.z;
    float col[S::kOut];
    S::pair(a, s_neck, __fadd_rn(pair_r2(dx, dy, dz), kEps), dx, dy, dz, ai, aj, entry >> 16,
            row, col);
#pragma unroll
    for (int d = 0; d < S::kOut; ++d) atomicAdd(&w.acc[(S::kOut + d) * 32 + j], col[d]);
  }
  // each lane ends with the sum over its lane and the later lanes of its row
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int io = __shfl_down_sync(0xffffffffu, i, off);
#pragma unroll
    for (int d = 0; d < kRow; ++d) {
      const float o = __shfl_down_sync(0xffffffffu, row[d], off);
      if (lane + off < 32 && io == i) row[d] += o;
    }
  }
  const int i_before = __shfl_up_sync(0xffffffffu, i, 1);
  if (valid && (lane == 0 || i_before != i)) {
#pragma unroll
    for (int d = 0; d < S::kOut; ++d) w.acc[d * 32 + i] += row[d];
    if constexpr (S::kEnergy) w.e_row[i] += static_cast<double>(row[S::kOut]);
  }
}

// One patch (row group g, column group h >= g of replica rep) by one warp.
template <typename S>
__device__ __forceinline__ void patch(const PairArgs& a, const float* boxes,
                                      const WarpSmem<S>& w, const float* s_neck, int rep, int g,
                                      int h) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const size_t rbase = static_cast<size_t>(rep) * a.n;
  const int row0 = g * 32, col0 = h * 32;
  const int n_rows = min(32, a.n - row0), n_cols = min(32, a.n - col0);
  typename S::Atom ti = {}, tj = {};
  if (lane < n_rows) ti = S::load(a, rbase, row0 + lane);
  if (lane < n_cols) tj = S::load(a, rbase, col0 + lane);
  w.put(0, lane, ti);
  w.put(1, lane, tj);
#pragma unroll
  for (int k = 0; k < 2 * S::kOut; ++k) w.acc[k * 32 + lane] = 0.0f;
  if constexpr (S::kEnergy) w.e_row[lane] = 0.0;
  // the caller's indices of the lane's row and column atom, for the band
  int orig_i = 0, orig_j = 0;
  if constexpr (S::kBand) {
    if (lane < n_rows) orig_i = a.orig ? a.orig[row0 + lane] : row0 + lane;
    if (lane < n_cols) orig_j = a.orig ? a.orig[col0 + lane] : col0 + lane;
  }
  __syncwarp();
  // the rows within the cutoff of the column group's box (tested as
  // boxes_apart tests two boxes): a row beyond it has no pair in the patch
  bool near = lane < n_rows;
  if (a.has_cut && near) {
    near = near_box(a, ti.p0, boxes + (static_cast<size_t>(rep) * ((a.n + 31) / 32) + h) * 6);
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
    const float4 pi = w.atom[i];   // part 0 of row slot i: x, y, z
    const float r2 = pair_r2(pi.x - tj.p0.x, pi.y - tj.p0.y, pi.z - tj.p0.z);
    const bool keep = col_ok && (!diagonal || lane > i) && r2 > 1e-8f &&
                      (!a.has_cut || __fadd_rn(r2, kEps) <= a.cut_r2);
    int entry = (i << 8) | lane;
    if constexpr (S::kBand) {
      const int oi = __shfl_sync(0xffffffffu, orig_i, i);
      entry |= (abs(oi - orig_j) > a.band) << 16;
    }
    const unsigned mask = __ballot_sync(0xffffffffu, keep);
    if (keep) w.queue[queued + __popc(mask & below)] = entry;
    queued += __popc(mask);
    if (queued >= 32) {
      __syncwarp();
      run_batch(a, w, s_neck, w.queue[lane], true);
      __syncwarp();
      queued -= 32;
      if (lane < queued) w.queue[lane] = w.queue[32 + lane];
      __syncwarp();
    }
  }
  __syncwarp();
  run_batch(a, w, s_neck, lane < queued ? w.queue[lane] : 0, lane < queued);
  __syncwarp();
  // the patch's sums to the outputs (an atom with no pair adds nothing)
#pragma unroll
  for (int d = 0; d < S::kOut; ++d) {
    const float vr = w.acc[d * 32 + lane], vc = w.acc[(S::kOut + d) * 32 + lane];
    if (lane < n_rows && vr != 0.0f) atomicAdd(a.out0 + (rbase + row0 + lane) * S::kOut + d, vr);
    if (lane < n_cols && vc != 0.0f) atomicAdd(a.out0 + (rbase + col0 + lane) * S::kOut + d, vc);
  }
  if constexpr (S::kEnergy) {
    const double e = w.e_row[lane];
    if (lane < n_rows && e != 0.0) atomicAdd(a.rows + rbase + row0 + lane, e);
  }
  __syncwarp();   // the next patch overwrites the staged atoms
}

// Persistent warps: each takes the next patch of the list from an atomic
// counter (the one after it asked for while this one runs) until the list
// is done. No barrier across the CTA after the neck tables are loaded.
template <typename S>
__device__ __forceinline__ void newton_sweep(const PairArgs& a, const float* boxes) {
  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const WarpSmem<S> w(base + warp * WarpSmem<S>::kBytes);
  float* s_neck = reinterpret_cast<float*>(base + kWarps * WarpSmem<S>::kBytes);
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
    patch(a, boxes, w, s_neck, static_cast<int>(idx / (NG * NG)),
          static_cast<int>((idx / NG) % NG), static_cast<int>(idx % NG));
    item = __shfl_sync(0xffffffffu, next, 0);
  }
}

// ---- sweep 1: Born integral, both directions of each pair ----
// (launch bounds of two CTAs an SM: with one, ptxas gave this sweep 40
// registers and 8 bytes of spills; with two, 44 registers and none)
__global__ void __launch_bounds__(kThreads, 2) newton_born_kernel(PairArgs a,
                                                                 const float* boxes) {
  newton_sweep<NewtonBorn>(a, boxes);
}

// ---- sweep 2: pair energy to the row atom, dE/dB to both atoms ----
__global__ void __launch_bounds__(kThreads) newton_energy_kernel(PairArgs a, const float* boxes) {
  newton_sweep<NewtonEnergy>(a, boxes);
}

// ---- sweep 3: forces, -W d on the row atom and +W d on the column atom ----
__global__ void __launch_bounds__(kThreads) newton_force_kernel(PairArgs a, const float* boxes) {
  newton_sweep<NewtonForce>(a, boxes);
}

// entries of the work list's room: every 32 x 32 patch of the upper
// triangle of each replica
long long list_room(int n_replicas, int n_atoms) {
  const long long NG = (n_atoms + 31) / 32;
  return n_replicas * NG * (NG + 1) / 2;
}

// the groups' boxes (R, NG, 6) float32, after the list in `work`
float* list_boxes(unsigned long long* work, int n_replicas, int n_atoms) {
  return reinterpret_cast<float*>(work + 2 + list_room(n_replicas, n_atoms));
}

// CTAs of the list kernels, which stride over `total` indices
unsigned list_ctas(long long total) {
  const long long ctas = (total + 255) / 256;
  return static_cast<unsigned>(ctas < 1024 ? ctas : 1024);
}

// CTAs of `kernel` (sweep `sweep`) that the current device holds at once
// with `shmem` bytes of dynamic shared memory, into *ctas. The answer
// depends only on the kernel, `shmem` and the device, so it is asked of the
// runtime once and kept (a force evaluation runs three sweeps, on a path
// whose time is already the host's); the first call on a device also raises
// the kernel's dynamic shared-memory limit to the most any call can ask
// (`most`: the largest neck tables).
cudaError_t resident_ctas(int sweep, const void* kernel, size_t shmem, size_t most,
                          long long* ctas) {
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

// launches sweep S's `kernel` on a persistent grid over the list in a.work
template <typename S>
int launch_sweep(int sweep, const void* kernel, const PairArgs& a, int n_replicas,
                 cudaStream_t s) {
  const int neck = a.use_neck ? 2 * a.n_classes * a.n_classes : 0;
  const size_t shmem = sweep_smem<S>(neck);
  long long ctas = 0;
  cudaError_t err = resident_ctas(sweep, kernel, shmem,
                                  sweep_smem<S>(2 * kMaxClasses * kMaxClasses), &ctas);
  if (err != cudaSuccess) return static_cast<int>(err);
  // as many CTAs as the card holds at once, no more than the list can have
  // work for (a warp a patch)
  const long long most = (list_room(n_replicas, a.n) + kWarps - 1) / kWarps;
  if (ctas > most) ctas = most;
  // the list stays; the counter of items taken starts again
  err = cudaMemsetAsync(a.work + 1, 0, sizeof(unsigned long long), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* boxes = list_boxes(a.work, n_replicas, a.n);
  void* args[] = {const_cast<PairArgs*>(&a), &boxes};
  err = cudaLaunchKernel(kernel, dim3(static_cast<unsigned>(ctas)), dim3(kThreads), args, shmem,
                         s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Entries (unsigned 64-bit) of the `work` buffer of the Newton sweeps: two
// counters, the list's room, and the 32-atom groups' boxes (R, ceil(N /
// 32), 6) as float32.
long long pmarlo_pair_newton_work_size(int n_replicas, int n_atoms) {
  return 2 + list_room(n_replicas, n_atoms) +
         (n_replicas * ((n_atoms + 31) / 32LL) * 6 + 1) / 2;
}

// Builds the Newton sweeps' work list into `work` (pmarlo_pair_newton_work_size
// entries) from the stored positions x (R, N, 3) and `close` (R, G, G) of
// tiles of `tile` atoms (a multiple of 32; null: every tile block);
// `has_cut` 0 lists every patch of the upper triangle. The three sweeps of
// one evaluation take the same list. Returns cudaGetLastError() after the
// launches on `stream`.
int pmarlo_pair_newton_list(const float* x, const uint8_t* close, int n_replicas, int n_atoms,
                            int tile, float cut_r2, int has_cut, unsigned long long* work,
                            void* stream) {
  if (n_atoms < 1 || n_replicas < 1 || tile < 32 || tile % 32 != 0 || work == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PairArgs a = {};
  a.x = x;
  a.close = close;
  a.work = work;
  a.n = n_atoms;
  a.tile = tile;
  a.n_tiles = (n_atoms + tile - 1) / tile;
  a.cut_r2 = cut_r2;
  a.has_cut = has_cut;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(work, 0, 2 * sizeof(unsigned long long), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long NG = (n_atoms + 31) / 32;
  float* boxes = list_boxes(work, n_replicas, n_atoms);
  if (has_cut) {
    group_boxes_kernel<<<static_cast<unsigned>((n_replicas * NG * 32 + 255) / 256), 256, 0, s>>>(
        a, boxes, n_replicas);
  }
  newton_patch_list_kernel<<<list_ctas(n_replicas * NG * NG), 256, 0, s>>>(a, boxes, n_replicas);
  return static_cast<int>(cudaGetLastError());
}

// One Newton sweep (`sweep` as in pmarlo_pair_sweep) over the list that
// pmarlo_pair_newton_list built into `work` from the same positions and
// `has_cut`; `has_cut` 0 keeps every pair. `out0` (and `rows`) must be zero:
// the kernels add to them. Returns cudaGetLastError() after the launch on
// `stream`.
int pmarlo_pair_newton_sweep(int sweep, const float* x, const float* atom_p, const int* cls,
                             const int* orig, const float* d0c, const float* m0c,
                             int n_classes, const float* B, const float* chain, int n_replicas,
                             int n_atoms, int band, float ke, float gb_pref, float cut_r2,
                             int has_cut, int use_gb, int use_neck, float* out0, double* rows,
                             unsigned long long* work, void* stream) {
  // (n_atoms < 2^25: the force sweep packs orig * 64 + class into 32 bits)
  if (n_atoms < 1 || n_atoms >= (1 << 25) || n_replicas < 1 || n_classes < 1 ||
      n_classes > kMaxClasses || band < 0 || work == nullptr ||
      (sweep == kEnergy && rows == nullptr)) {
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
  a.out0 = out0;
  a.rows = rows;
  a.work = work;
  a.n = n_atoms;
  a.n_classes = n_classes;
  a.band = band;
  a.cut_r2 = cut_r2;
  a.has_cut = has_cut;
  a.ke = ke;
  a.gb_pref = gb_pref;
  a.use_gb = use_gb;
  a.use_neck = use_neck && sweep != kEnergy;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (sweep) {
    case kBorn:
      return launch_sweep<NewtonBorn>(sweep, reinterpret_cast<const void*>(newton_born_kernel), a,
                                      n_replicas, s);
    case kEnergy:
      return launch_sweep<NewtonEnergy>(
          sweep, reinterpret_cast<const void*>(newton_energy_kernel), a, n_replicas, s);
    case kForce:
      return launch_sweep<NewtonForce>(sweep, reinterpret_cast<const void*>(newton_force_kernel),
                                       a, n_replicas, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
