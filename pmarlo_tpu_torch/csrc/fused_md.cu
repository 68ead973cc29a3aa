// Fused multi-step Langevin chunk for implicit-solvent MD (GBn2/OBC2/vacuum).
//
// Replaces: pmarlo_tpu/md/pallas_md.py build_pallas_chunk (kernel body
// `kernel`, forces `_forces_planes`), the unbiased variant. One launch
// advances every replica `n_steps` folded-BAOAB steps (full-dt kick,
// OpenMM LangevinMiddle) and returns the potential energy at the final
// positions, which the REMD Metropolis step needs.
//
// What bounds it on an H100: latency, not bytes or FLOPs. Alanine
// dipeptide has N = 22 atoms and chignolin 138, so a step is N (N - 1) / 2
// pair evaluations per replica in three dependent GB phases, and one step
// cannot start before the last one ended. What sets a step's time is how
// many pairs one lane evaluates in a row in each phase, and how many warps
// an SM has to hide each pair's chain of dependent instructions.
//
// Design:
// - each unordered pair once inside a replica: the atoms fall into groups
//   of `team` atoms (T, a power of two, 2-32); a patch is a (row group g,
//   column group h >= g) block, cut into items of S = T / 2 steps (an
//   off-diagonal patch two items, a diagonal one item of its T / 2 steps
//   above the diagonal). A team of T lanes of one warp takes an item: lane
//   l holds row atom g T + l and at step k meets column h T + (l + k) mod T;
//   its row sum stays in its registers, the column sums travel one lane on
//   by a shuffle after each step (no two lanes meet one column in a step).
//   So a lane evaluates S pairs an item, each pair once, with both atoms'
//   terms (both HCT directions, both neck terms, the force on both).
// - items are dealt to the teams of the replica's cluster in rounds, item
//   m C + rank to team m mod (teams a CTA) of CTA rank; md/fused_md.py
//   pair_items lists them and their slots.
// - slots, no atomics: each item writes its row atoms' sums and its column
//   atoms' sums to one slot each, in the shared memory of the CTA that owns
//   the atom (map_shared_rank: distributed shared memory), or in a global
//   scratch where the slots do not fit; an atom has 2 G slots (G groups),
//   each written by exactly one item, and after the phase's replica barrier
//   its owner adds them in slot order. Every sum has a fixed order, so a
//   launch is bit-reproducible run to run.
// - atom teams: CTA k of the replica's cluster of C CTAs (C in 1, 2, 4, 8)
//   owns atoms [k rows, (k + 1) rows); each owned atom has a team of L
//   lanes that adds its slots, walks its bonded (and bias) terms and meets
//   by __shfl_xor_sync in a fixed order; lane 0 holds the atom's position
//   and velocity, integrates it and writes the new position, the Born
//   radius and the chain factor into every CTA of the cluster.
// - tables where a pair reads them: the wrapper lays the pair parameters
//   out in item order (md/fused_md.py item_tables: LJ A and B, the scaled
//   and the full charge products, the neck tables of (i, j) and of (j, i)),
//   and each CTA copies its items' tables into shared memory once a launch
//   where that costs no residency (read from global memory in the same
//   coalesced order otherwise). The values are the (N, N) tables' own.
// - GB per evaluation, each phase an item sweep, a replica barrier, the
//   owners' slot sums and a second barrier:
//     1. Born integral I_i = sum_j H_ij / 2 + neck -> B_i, dB_i/dpsi_i
//     2. dE/dB_i -> chain_i = dE/dB_i dB_i/dpsi_i rho_i
//     3. pair forces (LJ + Coulomb, direct GB, both Born chain terms)
//   then the bonded terms, each atom's team walking a CSR list of the
//   (term, role) pairs it takes part in.
// - one force evaluation a step: an evaluation's forces and energy serve
//   the next step's kick and the frame or chunk energy at these positions;
//   positions are double-buffered by step parity.
// - launch shape (C, L, T, P): md/fused_md.py launch_shape chooses it from
//   N, the replica count and the card's count of resident replicas of each
//   shape (pmarlo_fused_md_plan), one shape for every kernel of a chunk, so
//   that the windowed and the whole-run paths add in one order and stay
//   bitwise equal. P is the steps a lane takes an iteration: P = 2 overlaps
//   two pairs' chains (the *_kernel builds), P = 1 takes one (the
//   *_single_kernel builds; the biased kernels take one in their one
//   build). All add in the same order and take at most 128 registers a
//   thread: with 64, 80 or 96 ptxas spills.
// - the force is the exact gradient of this kernel's own energy: the same
//   expressions as pmarlo_tpu_torch/md/analytic.py, general torsions
//   k (1 + cos(n phi - gamma)) through atan2f, angles through acosf with the
//   +-(1 - 1e-7) clamp, and dB/dpsi = 0 where 1/B is clamped at 1e-3.
// - noise: Philox4x32-10 keyed by (seed, replica), counter (step low word,
//   step high word, atom, 0), Box-Muller on 24-bit uniforms. The same
//   stream as md/integrate.py gaussian_noise; the caller's step_offset makes
//   successive launches draw fresh noise.
//
// The biased variants and the whole-run kernels (the three remaining
// pallas_call sites of pallas_md.py) share the force routine:
// - CV bias (pallas_md.py _bias_planes, _cv_forward): per force evaluation
//   CTA 0 of the replica computes M dihedrals (cos/sin without atan2),
//   standardises them, runs the tanh MLP with a team of lanes a unit that
//   splits the unit's inputs (every thread of the CTA busy), whitens, takes
//   E = k sum cv^2 or the sum over the hills ledger, back-propagates by
//   hand to dE/dphi and writes dE/dphi into the other CTAs. Each atom's
//   team then walks a CSR list of the (role, dihedral) pairs it takes part
//   in, so the scatter needs no atomics. The weights and all activations
//   live in shared memory; the hills ledger is read from global memory (L2)
//   with a fixed-order block reduction.
// - fused metadynamics (build_pallas_chunk, mtd_deposit_interval): after
//   every deposit window each replica publishes its CVs, the grid meets at
//   a barrier, CTA 0 deposits the R hills serially in replica order (each
//   sees the earlier ones), a second barrier releases the next window, and
//   the forces are evaluated again under the new ledger.
// - fused REMD (build_pallas_remd): each cluster keeps its configuration
//   for the whole run and carries its RUNG (temperature, frame slot, noise
//   key); a swap exchanges the rung assignments of two clusters after one
//   grid barrier on a double-buffered energy array, so no coordinates move
//   between clusters. A frame's energy and kinetic energy are summed in one
//   replica reduction. Outputs are rung-major, as the windowed path writes
//   them.
// - step-phase stamps (tracing): the whole-run kernels have stamped builds
//   (fused_md_stamped.cu: fused_remd_stamped_kernel,
//   fused_remd_single_stamped_kernel, fused_remd_bias_stamped_kernel) that the
//   launch takes when `stamps` is set; the unstamped builds compile as they
//   did (fused_md_body.cuh, the device code both include). In a stamped build
//   thread 0 of CTA rank 0 of each replica's cluster reads clock64() at the
//   StampAt boundaries of one sampled step a report block (the step at
//   report_interval / 2) and writes them with plain stores to
//   stamps[(configuration, block, boundary)]. Only that step runs the stamped
//   instantiations of the step and the force routine; every other step runs
//   the unstamped ones. The arithmetic is the unstamped build's. md/fused_md.py STAMP_PHASES names the interval between each
//   boundary and the next: pairs (the three pair sweeps and the bonded terms),
//   folds (the owners' slot sums and bonded incidences), barriers (waiting in
//   replica_sync and the force routine's last block barrier), bias (the CV
//   bias's dihedrals, MLP and atom forces) and other (integration, the Born
//   radius and chain factor, put_everywhere).
// - the grid barrier is cooperative_groups' this_grid().sync(), which
//   also orders the CTAs' global writes before the reads that follow it;
//   the kernels that use it are launched with the cooperative attribute,
//   which refuses a grid whose CTAs cannot all be resident. Data that
//   crosses CTAs through global memory is read with __ldcg (L2), never
//   through the non-coherent path.

#include "fused_md_body.cuh"

// the stamped builds of the whole-run kernel (fused_md_stamped.cu): biased, or
// unbiased with one (single) or two steps a lane an iteration
const void* pmarlo_fused_remd_stamped_kernel(bool biased, bool single);

namespace {

// Nothing but `n_barriers` grid barriers: what one barrier costs.
__global__ void grid_barrier_probe_kernel(int n_barriers) {
  cg::grid_group grid = cg::this_grid();
  for (int k = 0; k < n_barriers; ++k) grid.sync();
}

// Six kernels, all bounded to kMaxThreads threads a CTA, one CTA an SM at
// most 128 registers a thread: the chunk and the whole-run REMD kernel with
// two steps a lane an iteration (P = 2) and as *_single_kernel builds with
// one (P = 1), and the biased chunk and biased REMD with one step an
// iteration (the bias code leaves no room for two), which both P values
// launch. Lower register bounds (64, 80, 96 a thread) spill. The unbiased
// kernels are compiled without the bias code. The three whole-run builds
// have stamped twins in fused_md_stamped.cu (file header), launched only
// when `stamps` is set.
__global__ void __launch_bounds__(kMaxThreads, 1) fused_md_chunk_kernel(Args a) {
  chunk_body<kUnbiased, 2>(a);
}
__global__ void __launch_bounds__(kMaxThreads, 1) fused_md_bias_kernel(Args a) {
  chunk_body<kAnyBias, 1>(a);
}
__global__ void __launch_bounds__(kMaxThreads, 1) fused_remd_kernel(Args a) {
  remd_body<kUnbiased, 2>(a);
}
__global__ void __launch_bounds__(kMaxThreads, 1) fused_remd_bias_kernel(Args a) {
  remd_body<kHarmonicOnly, 1>(a);
}
__global__ void __launch_bounds__(kMaxThreads, 1) fused_md_chunk_single_kernel(Args a) {
  chunk_body<kUnbiased, 1>(a);
}
__global__ void __launch_bounds__(kMaxThreads, 1) fused_remd_single_kernel(Args a) {
  remd_body<kUnbiased, 1>(a);
}

}  // namespace

extern "C" {

// Order of the pointer, integer and float arguments of pmarlo_fused_md_launch;
// md/fused_md.py lists the same names in the same order.
enum PtrArg {
  kPX = 0, kPV, kPEnergy, kPForces, kPSeeds, kPKT, kPAtomP, kPItems, kPItemTab, kPSlotScratch,
  kPBondI, kPBondP, kPAngleI, kPAngleP, kPTorsI, kPTorsP, kPCsrPtr, kPBondedSlot,
  kPQuads, kPDihPtr, kPDihEnt, kPBiasP, kPMtdCenters, kPMtdHeights, kPMtdCount, kPCvBuf,
  kPXOut, kPVOut, kPSeedsOut, kPLadder, kPBetas, kPIds0, kPFrames, kPFrameE,
  kPFrameKe, kPIdsHist, kPAccept, kPSwapE, kPStamps, kNumPtrArgs
};
enum IntArg {
  kIReplicas = 0, kIAtoms, kISteps, kIUseGb, kIUseNeck, kIBiasKind, kINDih, kINLayers,
  kIWidth0,
  kINCv = kIWidth0 + kMaxLayers + 1, kIUseWhiten, kIBiasPLen, kIMtdCapacity, kIMtdInterval,
  kIAttempts, kIFramesPerAttempt, kIReportInterval, kISwapSeed, kICluster, kILanes,
  kITeam, kIPairs, kIStaged, kISlotsSmem, kINBonds, kINAngles, kINTorsions, kIBondedLd,
  kNumIntArgs
};
enum FloatArg {
  kFDt = 0, kFHalfDt, kFC1, kFC2sq, kFGbPref, kFBiasStrength, kFMtdHeight, kFMtdKbDt,
  kFMtdInvSigma0, kNumFloatArgs = kFMtdInvSigma0 + kMaxCv
};
enum Mode { kModeChunk = 0, kModeFusedMtd = 1, kModeFusedRemd = 2 };
// what pmarlo_fused_md_plan writes: threads a CTA, shared memory bytes of
// the base, the slots and the staged tables, and the replicas resident at
// once with the base alone, with the slots, and with slots and tables
// (0 where the bytes exceed what a CTA may take)
enum PlanOut {
  kOThreads = 0, kOSmemBase, kOSmemSlots, kOSmemTab, kOResident, kOResidentSlots,
  kOResidentAll, kNumPlanOut
};

int pmarlo_fused_md_max_atoms() { return kMaxAtoms; }

// the sizes of the argument arrays and the limits, for the wrapper to
// check against its own: n_ptrs, n_ints, n_floats, max_layers, max_cv,
// max_threads, max_cluster, n_plan_out, pair tables, stamp boundaries
int pmarlo_fused_md_abi(int which) {
  const int v[10] = {kNumPtrArgs, kNumIntArgs, kNumFloatArgs, kMaxLayers, kMaxCv,
                     kMaxThreads, kMaxCluster, kNumPlanOut, kPairTabs, kStampBoundaries};
  return (which >= 0 && which < 10) ? v[which] : -1;
}

const char* pmarlo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

namespace {

const void* kernel_of(int mode, bool biased, int pairs, bool stamped = false) {
  const bool single = pairs == 1;
  if (mode == kModeFusedRemd && stamped) return pmarlo_fused_remd_stamped_kernel(biased, single);
  if (mode == kModeFusedRemd) {
    if (biased) return reinterpret_cast<const void*>(fused_remd_bias_kernel);
    return single ? reinterpret_cast<const void*>(fused_remd_single_kernel)
                  : reinterpret_cast<const void*>(fused_remd_kernel);
  }
  if (biased) return reinterpret_cast<const void*>(fused_md_bias_kernel);
  return single ? reinterpret_cast<const void*>(fused_md_chunk_single_kernel)
                : reinterpret_cast<const void*>(fused_md_chunk_kernel);
}

struct Shape {
  int cluster, lanes, team, pairs, rows, threads, steps, n_items, n_slots, my_items;
  size_t smem_base, smem_slots, smem_tab;   // bytes
};

// Checks the launch shape in `iv` and sizes its block, its items and its
// shared memory; false for a shape the kernels do not take
// (md/fused_md.py LaunchShape derives the same).
bool shape_of(const int* iv, Shape* sh) {
  const int n = iv[kIAtoms], C = iv[kICluster], L = iv[kILanes], T = iv[kITeam];
  const int P = iv[kIPairs];
  if (n < 1 || n > kMaxAtoms || iv[kIReplicas] < 1) return false;
  if (C != 1 && C != 2 && C != 4 && C != 8) return false;
  if (L < 1 || L > 32 || (L & (L - 1)) != 0) return false;
  if (T < 2 || T > 32 || (T & (T - 1)) != 0) return false;
  if (P != 1 && P != 2) return false;
  sh->cluster = C;
  sh->lanes = L;
  sh->team = T;
  sh->pairs = P;
  sh->steps = T / 2;
  if (sh->steps % P != 0) return false;
  sh->rows = (n + C - 1) / C;
  if ((C - 1) * sh->rows >= n) return false;     // a CTA without rows
  sh->threads = (sh->rows * L + 31) / 32 * 32;
  if (sh->threads > kMaxThreads) return false;
  const int groups = (n + T - 1) / T;
  sh->n_items = groups * groups;
  sh->n_slots = 2 * groups;
  sh->my_items = (sh->n_items + C - 1) / C;
  size_t floats = 10 * static_cast<size_t>(n) + 36 + 6 * static_cast<size_t>(sh->rows);
  if (iv[kIBiasKind] != kNoBias) {
    int n_act = 0, max_w = 0;
    for (int l = 0; l <= iv[kINLayers]; ++l) {
      n_act += iv[kIWidth0 + l];
      max_w = max_w > iv[kIWidth0 + l] ? max_w : iv[kIWidth0 + l];
    }
    floats += iv[kIBiasPLen] + n_act + 2 * kMaxCv + 2 * max_w + 3 * iv[kINDih] + 32;
  }
  sh->smem_base = floats * sizeof(float);
  if (iv[kIBondedLd] < 0) return false;
  sh->smem_slots = (static_cast<size_t>(kSlotSums) * sh->n_slots * sh->rows + 3 * iv[kIBondedLd]) *
                   sizeof(float);
  sh->smem_tab = static_cast<size_t>(sh->my_items) * kPairTabs * sh->steps * T * sizeof(float);
  return true;
}

// replicas (clusters of `cluster` CTAs) that can be resident at once
cudaError_t resident_replicas(const void* kernel, const Shape& sh, size_t smem, int* out) {
  int device = 0, sms = 0;
  cudaError_t rc = cudaGetDevice(&device);
  if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (rc != cudaSuccess) return rc;
  if (sh.cluster == 1) {
    int per_sm = 0;
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, sh.threads, smem);
    *out = per_sm * sms;
    return rc;
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = sh.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(sh.cluster);
  cfg.blockDim = dim3(sh.threads);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(out, kernel, &cfg);
}

// lets the kernel take as much dynamic shared memory as the card allows
// a block (idempotent; the occupancy queries and launches need it)
cudaError_t allow_smem(const void* kernel, size_t* optin) {
  int device = 0, bytes = 0;
  cudaError_t rc = cudaGetDevice(&device);
  if (rc == cudaSuccess) {
    rc = cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  }
  if (rc == cudaSuccess) {
    rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  }
  *optin = static_cast<size_t>(bytes);
  return rc;
}

// launches `kernel` on `blocks` CTAs in clusters of `cluster`, cooperative
// (every CTA resident at once, or the launch is refused) when asked
cudaError_t launch_ex(const void* kernel, int blocks, int threads, size_t smem, int cluster,
                      bool cooperative, cudaStream_t st, void** kargs) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[2];
  int n_attr = 0;
  if (cluster > 1) {
    attr[n_attr].id = cudaLaunchAttributeClusterDimension;
    attr[n_attr].val.clusterDim.x = cluster;
    attr[n_attr].val.clusterDim.y = 1;
    attr[n_attr].val.clusterDim.z = 1;
    ++n_attr;
  }
  if (cooperative) {
    attr[n_attr].id = cudaLaunchAttributeCooperative;
    attr[n_attr].val.cooperative = 1;
    ++n_attr;
  }
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = n_attr;
  return cudaLaunchKernelExC(&cfg, kernel, kargs);
}

}  // namespace

extern "C" {

// Sizes the launch of `mode` with the shape in `iv` (kICluster, kILanes,
// kITeam, kIPairs): threads a CTA, the shared memory bytes of the base,
// the slots and the staged tables, and the replicas that can be resident
// at once with each placement (PlanOut). Returns a CUDA error code
// (cudaErrorInvalidValue for a shape the kernels do not take).
int pmarlo_fused_md_plan(int mode, const int* iv, int* out) {
  Shape sh;
  if (!shape_of(iv, &sh)) return static_cast<int>(cudaErrorInvalidValue);
  const void* kernel = kernel_of(mode, iv[kIBiasKind] != kNoBias, sh.pairs);
  size_t optin = 0;
  cudaError_t rc = allow_smem(kernel, &optin);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  out[kOThreads] = sh.threads;
  out[kOSmemBase] = static_cast<int>(sh.smem_base);
  out[kOSmemSlots] = static_cast<int>(sh.smem_slots);
  out[kOSmemTab] = static_cast<int>(sh.smem_tab);
  const size_t bytes[3] = {sh.smem_base, sh.smem_base + sh.smem_slots,
                           sh.smem_base + sh.smem_slots + sh.smem_tab};
  for (int k = 0; k < 3; ++k) {
    out[kOResident + k] = 0;
    if (rc == cudaSuccess && bytes[k] <= optin) {
      rc = resident_replicas(kernel, sh, bytes[k], &out[kOResident + k]);
    }
  }
  return static_cast<int>(rc);
}

// Launches one kernel on `stream`; returns the CUDA error code of the
// launch (0 = launched). kModeChunk: K steps, optionally biased (ledger as
// input). kModeFusedMtd: the same kernel with deposits inside the launch.
// kModeFusedRemd: the whole REMD run (the stamped build where ptr[kPStamps]
// is set: (R, F, kStampBoundaries) int64). The last two need every CTA
// resident at once (they meet at grid barriers): they launch with the
// cooperative attribute, and a grid beyond the card's capacity returns
// cudaErrorCooperativeLaunchTooLarge instead of running. The grid is R
// clusters of iv[kICluster] CTAs.
int pmarlo_fused_md_launch(int mode, void* const* ptr, const int* iv, const float* fv,
                           long long step_offset, long long attempt_offset, void* stream) {
  Shape sh;
  if (!shape_of(iv, &sh) || iv[kISteps] < 0 || iv[kINLayers] > kMaxLayers ||
      iv[kINCv] > kMaxCv) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_replicas = iv[kIReplicas];
  Args a;
  a.x = static_cast<float*>(ptr[kPX]);
  a.v = static_cast<float*>(ptr[kPV]);
  a.energy = static_cast<float*>(ptr[kPEnergy]);
  a.forces = static_cast<float*>(ptr[kPForces]);
  a.seeds = static_cast<const int*>(ptr[kPSeeds]);
  a.kT = static_cast<const float*>(ptr[kPKT]);
  a.atom_p = static_cast<const float*>(ptr[kPAtomP]);
  a.items = static_cast<const int*>(ptr[kPItems]);
  a.item_tab = static_cast<const float*>(ptr[kPItemTab]);
  a.slot_scratch = static_cast<float*>(ptr[kPSlotScratch]);
  a.bonded.bond_i = static_cast<const int*>(ptr[kPBondI]);
  a.bonded.bond_p = static_cast<const float*>(ptr[kPBondP]);
  a.bonded.angle_i = static_cast<const int*>(ptr[kPAngleI]);
  a.bonded.angle_p = static_cast<const float*>(ptr[kPAngleP]);
  a.bonded.tors_i = static_cast<const int*>(ptr[kPTorsI]);
  a.bonded.tors_p = static_cast<const float*>(ptr[kPTorsP]);
  a.csr_ptr = static_cast<const int*>(ptr[kPCsrPtr]);
  a.bonded_slot = static_cast<const int*>(ptr[kPBondedSlot]);
  a.n_terms[0] = iv[kINBonds];
  a.n_terms[1] = iv[kINAngles];
  a.n_terms[2] = iv[kINTorsions];
  a.bonded_ld = iv[kIBondedLd];
  a.n = iv[kIAtoms];
  a.n_steps = iv[kISteps];
  a.step_offset = static_cast<unsigned long long>(step_offset);
  a.dt = fv[kFDt];
  a.half_dt = fv[kFHalfDt];
  a.c1 = fv[kFC1];
  a.c2sq = fv[kFC2sq];
  a.gb_pref = fv[kFGbPref];
  a.use_gb = iv[kIUseGb];
  a.use_neck = iv[kIUseNeck];
  a.cluster = sh.cluster;
  a.lanes = sh.lanes;
  a.rows = sh.rows;
  a.team = sh.team;
  a.steps = sh.steps;
  a.n_items = sh.n_items;
  a.n_slots = sh.n_slots;
  a.my_items = sh.my_items;
  a.staged = iv[kIStaged] != 0;
  a.slots_smem = iv[kISlotsSmem] != 0;
  a.bias_kind = iv[kIBiasKind];
  a.n_dih = iv[kINDih];
  a.n_layers = iv[kINLayers];
  a.n_act = 0;
  a.max_width = 0;
  for (int l = 0; l <= kMaxLayers; ++l) {
    a.widths[l] = iv[kIWidth0 + l];
    if (l <= a.n_layers) {
      a.n_act += a.widths[l];
      a.max_width = a.max_width > a.widths[l] ? a.max_width : a.widths[l];
    }
  }
  a.n_cv = iv[kINCv];
  a.use_whiten = iv[kIUseWhiten];
  a.bias_strength = fv[kFBiasStrength];
  a.quads = static_cast<const int*>(ptr[kPQuads]);
  a.dih_ptr = static_cast<const int*>(ptr[kPDihPtr]);
  a.dih_ent = static_cast<const int*>(ptr[kPDihEnt]);
  a.bias_p = static_cast<const float*>(ptr[kPBiasP]);
  a.bias_p_len = iv[kIBiasPLen];
  a.mtd_centers = static_cast<float*>(ptr[kPMtdCenters]);
  a.mtd_heights = static_cast<float*>(ptr[kPMtdHeights]);
  a.mtd_count = static_cast<int*>(ptr[kPMtdCount]);
  a.mtd_capacity = iv[kIMtdCapacity];
  for (int k = 0; k < kMaxCv; ++k) a.mtd_inv_sigma[k] = fv[kFMtdInvSigma0 + k];
  a.mtd_interval = (mode == kModeFusedMtd) ? iv[kIMtdInterval] : 0;
  a.mtd_height = fv[kFMtdHeight];
  a.mtd_kb_dt = fv[kFMtdKbDt];
  a.cv_buf = static_cast<float*>(ptr[kPCvBuf]);
  a.x_out = static_cast<float*>(ptr[kPXOut]);
  a.v_out = static_cast<float*>(ptr[kPVOut]);
  a.seeds_out = static_cast<int*>(ptr[kPSeedsOut]);
  a.ladder = static_cast<const float*>(ptr[kPLadder]);
  a.betas = static_cast<const float*>(ptr[kPBetas]);
  a.ids0 = static_cast<const int*>(ptr[kPIds0]);
  a.frames = static_cast<float*>(ptr[kPFrames]);
  a.frame_e = static_cast<float*>(ptr[kPFrameE]);
  a.frame_ke = static_cast<float*>(ptr[kPFrameKe]);
  a.ids_hist = static_cast<int*>(ptr[kPIdsHist]);
  a.accept = static_cast<float*>(ptr[kPAccept]);
  a.swap_e = static_cast<float*>(ptr[kPSwapE]);
  a.n_attempts = iv[kIAttempts];
  a.frames_per_attempt = iv[kIFramesPerAttempt];
  a.report_interval = iv[kIReportInterval];
  a.swap_seed = static_cast<unsigned>(iv[kISwapSeed]);
  a.attempt_offset = static_cast<unsigned long long>(attempt_offset);
  // the whole-run mode alone is stamped
  a.stamps = mode == kModeFusedRemd ? static_cast<long long*>(ptr[kPStamps]) : nullptr;
  if (mode == kModeFusedMtd &&
      (a.bias_kind != kMetadynamics || a.mtd_interval < 1 || a.n_steps % a.mtd_interval != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (mode == kModeFusedRemd && a.bias_kind == kMetadynamics) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (a.items == nullptr || a.item_tab == nullptr || (!a.slots_smem && a.slot_scratch == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }

  const size_t shmem = sh.smem_base + (a.slots_smem ? sh.smem_slots : 0) +
                       (a.staged ? sh.smem_tab : 0);
  const void* kernel = kernel_of(mode, a.bias_kind != kNoBias, sh.pairs, a.stamps != nullptr);
  if (shmem > 48 * 1024) {
    size_t optin = 0;
    const cudaError_t rc = allow_smem(kernel, &optin);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    if (shmem > optin) return static_cast<int>(cudaErrorInvalidValue);
  }
  void* kargs[1] = {&a};
  const cudaError_t rc =
      launch_ex(kernel, n_replicas * sh.cluster, sh.threads, shmem, sh.cluster,
                mode != kModeChunk, static_cast<cudaStream_t>(stream), kargs);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}

// Launches `n_blocks` CTAs of `n_threads` threads, in clusters of
// `cluster`, that meet at `n_barriers` grid barriers and do nothing else.
// For timing the barrier the whole-run kernels are built on.
int pmarlo_grid_barrier_probe(int n_blocks, int n_threads, int n_barriers, int cluster,
                              void* stream) {
  void* kargs[1] = {&n_barriers};
  const cudaError_t rc =
      launch_ex(reinterpret_cast<const void*>(grid_barrier_probe_kernel), n_blocks, n_threads,
                0, cluster, true, static_cast<cudaStream_t>(stream), kargs);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
