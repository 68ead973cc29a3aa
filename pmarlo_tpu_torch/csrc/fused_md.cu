// Fused multi-step Langevin chunk for implicit-solvent MD (GBn2/OBC2/vacuum).
//
// Replaces: pmarlo_tpu/md/pallas_md.py build_pallas_chunk (kernel body
// `kernel`, forces `_forces_planes`), the unbiased variant. One launch
// advances every replica `n_steps` folded-BAOAB steps (full-dt kick,
// OpenMM LangevinMiddle) and returns the potential energy at the final
// positions, which the REMD Metropolis step needs.
//
// What bounds it on an H100: latency, not bytes or FLOPs. Alanine
// dipeptide has N = 22 atoms, so a step is ~N^2 = 484 pair evaluations per
// replica in three dependent GB phases, and one step cannot start before
// the last one ended. With one thread an atom (the first design) a replica
// was one warp of 22 live lanes that walked ~63 dependent pair iterations a
// step, 71 us, and 32 replicas used 32 of the 132 SMs. The design below
// spreads each row over a team of lanes and each replica over a cluster of
// CTAs, so a step walks ceil(N / L) pair iterations instead of N.
//
// Design:
// - row teams: atom i's row (its sums over partners j) is split over L
//   lanes of one warp (L a power of two); lane l takes j = l, l + L, ...,
//   and the row sums (Born integral, dE/dB, force, energy) meet by
//   __shfl_xor_sync in a fixed order, so every lane holds the same sum.
//   Lane 0 of the team holds the atom's position and velocity and
//   integrates it. A CTA has round_up(rows x L, 32) <= 512 threads. The
//   unbiased kernels take two partners a lane an iteration, with no branch
//   between them, so that their latency chains overlap (the biased ones,
//   nearer the register bound, take one); the sums add the pairs in the
//   same order either way.
// - several CTAs a replica: a replica is a thread-block cluster of C CTAs
//   (C in 1, 2, 4, 8); CTA k owns rows [k rows, (k + 1) rows). Every CTA
//   keeps all N positions, Born radii and chain factors in its shared
//   memory; after a phase writes its own rows, the CTAs meet at
//   cluster.sync() and copy the other CTAs' rows through distributed shared
//   memory (map_shared_rank). With C = 1 the barriers are __syncthreads().
//   md/fused_md.py launch_shape chooses C and L from N, the replica count
//   and the card's count of resident replicas of each shape
//   (pmarlo_fused_md_plan), one shape for every kernel of a chunk, so that
//   the windowed and the whole-run paths add in one order and stay bitwise
//   equal.
// - tables where they are read: each CTA copies its rows of the (N, N)
//   pair tables (lj_a, lj_b, qq_scaled, qq_full, neck_d0, neck_m0) and its
//   columns of the two neck tables (phase 3 reads them transposed) into
//   shared memory once a launch, with a row stride that keeps the row
//   teams of one warp on different banks, where that fits and costs no
//   residency; otherwise they are read from global memory (L1/L2).
// - GB per step, separated by the replica barrier:
//     1. Born integral I_i = sum_j H_ij (+ neck) -> B_i, dB_i/dpsi_i
//     2. dE/dB_i = sum_j ... -> chain_i = dE/dB_i dB_i/dpsi_i rho_i
//     3. pair forces, row-owned: row i sums over j, including both
//        chain_i dI_i/dr_ij and chain_j dI_j/dr_ji, so no atomics.
// - bonded terms are row-owned too: each atom's team walks a CSR list of
//   the (term, role) pairs it takes part in, one entry a lane, and
//   recomputes the term. No atomics anywhere and fixed-order sums, so a
//   launch is bit-reproducible run to run.
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
//   E = k sum cv^2 or the sum over the hills ledger, and back-propagates by
//   hand to dE/dphi; the other CTAs copy dE/dphi with the Born radii. Each
//   atom's team then walks a CSR list of the (role, dihedral) pairs it
//   takes part in, so the scatter needs no atomics. The weights and all
//   activations live in shared memory; the hills ledger is read from global
//   memory (L2) with a fixed-order block reduction.
// - fused metadynamics (build_pallas_chunk, mtd_deposit_interval): after
//   every deposit window each replica publishes its CVs, the grid meets at
//   a barrier, CTA 0 deposits the R hills serially in replica order (each
//   sees the earlier ones), and a second barrier releases the next window.
// - fused REMD (build_pallas_remd): each cluster keeps its configuration
//   for the whole run and carries its RUNG (temperature, frame slot, noise
//   key); a swap exchanges the rung assignments of two clusters after one
//   grid barrier on a double-buffered energy array, so no coordinates move
//   between clusters. Outputs are rung-major, as the windowed path writes
//   them.
// - the grid barrier is cooperative_groups' this_grid().sync(), which
//   also orders the CTAs' global writes before the reads that follow it;
//   the kernels that use it are launched with the cooperative attribute,
//   which refuses a grid whose CTAs cannot all be resident. Data that
//   crosses CTAs through global memory is read with __ldcg (L2), never
//   through the non-coherent path.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bonded_terms.cuh"
#include "gb_pair.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxAtoms = 512;
constexpr int kMaxThreads = 512;
constexpr int kMaxCluster = 8;
constexpr int kMaxLayers = 6;
constexpr int kMaxCv = 8;
enum BiasKind { kNoBias = 0, kHarmonic = 1, kMetadynamics = 2 };
// second Philox key word of the swap uniforms (the noise streams use the
// replica index there, far below this)
constexpr uint32_t kSwapKey = 0x53574150u;
// rows of the per-atom parameter table
enum AtomRow { kInvM = 0, kQ, kRho, kSr, kRadii, kAlpha, kBeta, kGamma, kSa, kAtomRows };
// (N, N) tables of the pair parameter block
enum PairTable { kLjA = 0, kLjB, kQqScaled, kQqFull, kNeckD0, kNeckM0, kPairTables };
// tables a CTA stages: its rows of the six, then its columns of the two
// neck tables (entry (j, i) for its row i)
enum StagedTable { kNeckD0T = kPairTables, kNeckM0T, kStagedTables };

struct Args {
  float* x;                 // (R, N, 3) in/out
  float* v;                 // (R, N, 3) in/out
  float* energy;            // (R,) out: energy at the final positions
  float* forces;            // (R, N, 3) out, or null
  const int* seeds;         // (R,)
  const float* kT;          // (R,) kB * T per replica
  const float* atom_p;      // (kAtomRows, N)
  const float* pair_p;      // (kPairTables, N, N)
  BondedTables bonded;      // bond, angle and torsion terms
  const int* csr_ptr;       // (N + 1,)
  const int* csr_ent;       // (M, 2): (type << 2 | role, term)
  int n;
  int n_steps;
  unsigned long long step_offset;
  float dt, half_dt, c1, c2sq, gb_pref;
  int use_gb, use_neck;
  // --- launch shape ---
  int cluster;              // CTAs a replica
  int lanes;                // lanes a row
  int rows;                 // rows a CTA, ceil(N / cluster)
  int staged;               // pair tables in shared memory
  int ld;                   // row stride of the staged tables
  // --- CV bias (bias_kind != kNoBias) ---
  int bias_kind;
  int n_dih;                // M dihedrals -> 2M features
  int n_layers;             // linear layers of the MLP
  int widths[kMaxLayers + 1];   // 2M, hidden..., n_cv
  int n_cv;
  int use_whiten;
  float bias_strength;
  const int* quads;         // (M, 4)
  const int* dih_ptr;       // (N + 1,)
  const int* dih_ent;       // (K, 2): (role, dihedral)
  const float* bias_p;      // mu, inv_sigma, [w (in, out), b]..., wmean, wmat
  int bias_p_len;
  // --- metadynamics ledger ---
  float* mtd_centers;       // (H, n_cv)
  float* mtd_heights;       // (H,)
  int* mtd_count;           // (1,) valid prefix
  int mtd_capacity;
  float mtd_inv_sigma[kMaxCv];
  int mtd_interval;         // > 0: deposits inside the launch
  float mtd_height;
  float mtd_kb_dt;          // kB (gamma - 1) T, 0 = not well-tempered
  float* cv_buf;            // (R, n_cv) CVs published for the deposits
  // --- fused REMD ---
  float* x_out;             // (R, N, 3) rung-major final state
  float* v_out;
  int* seeds_out;           // (R,)
  const float* ladder;      // (R,) temperatures
  const float* betas;       // (R,)
  const int* ids0;          // (R,) identity of the configuration per rung
  float* frames;            // (F, R, N, 3)
  float* frame_e;           // (F, R)
  float* frame_ke;          // (F, R)
  int* ids_hist;            // (A + 1, R); row 0 written by the wrapper
  float* accept;            // (A, R)
  float* swap_e;            // (2, R) energies by rung, double-buffered
  int n_attempts, frames_per_attempt, report_interval;
  unsigned swap_seed;
  unsigned long long attempt_offset;
};

// shared-memory views of the bias work space
struct BiasSmem {
  float* P;      // parameter blob
  float* act;    // activations: z (2M), then every layer's output
  float* y;      // (kMaxCv) whitened CVs
  float* g0;     // (max width) gradient ping
  float* g1;     // (max width) gradient pong
  float* dphi;   // (M) dE/dphi
  float* cs;     // (M) cos phi
  float* sn;     // (M) sin phi
  float* red;    // (32) warp partials
};

// Where this thread sits: its CTA's rank in the replica's cluster and rows,
// and its row and lane.
struct Ctx {
  int rank;      // CTA rank in the cluster
  int row0;      // first row of the CTA
  int nrows;     // rows the CTA owns
  int i;         // this thread's row (atom)
  int lane;      // lane in the row team
  bool own;      // the row exists and is this CTA's
  bool lead;     // own and lane 0: holds the atom's position and velocity
};

__device__ __forceinline__ Ctx make_ctx(const Args& a) {
  Ctx t;
  t.rank = blockIdx.x % a.cluster;   // clusters tile the 1-D grid in order
  t.row0 = t.rank * a.rows;
  t.nrows = max(0, min(a.rows, a.n - t.row0));
  const int lr = threadIdx.x / a.lanes;
  t.lane = threadIdx.x & (a.lanes - 1);
  t.i = t.row0 + lr;
  t.own = lr < t.nrows;
  t.lead = t.own && t.lane == 0;
  return t;
}

__device__ __forceinline__ void philox4x32_10(uint32_t c[4], uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int rnd = 0; rnd < 10; ++rnd) {
    if (rnd) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c[0]);
    const uint32_t lo0 = 0xD2511F53u * c[0];
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c[2]);
    const uint32_t lo1 = 0xCD9E8D57u * c[2];
    const uint32_t n0 = hi1 ^ c[1] ^ k0;
    const uint32_t n2 = hi0 ^ c[3] ^ k1;
    c[0] = n0;
    c[1] = lo1;
    c[2] = n2;
    c[3] = lo0;
  }
}

__device__ __forceinline__ float uniform24(uint32_t w) {
  return (static_cast<float>(w >> 8) + 0.5f) * (1.0f / 16777216.0f);
}

// three standard normals for (seed, replica, step, atom)
__device__ __forceinline__ void gaussian3(uint32_t seed, uint32_t replica,
                                          unsigned long long step, uint32_t atom,
                                          float z[3]) {
  uint32_t c[4] = {static_cast<uint32_t>(step), static_cast<uint32_t>(step >> 32), atom, 0u};
  philox4x32_10(c, seed, replica);
  const float two_pi = 6.28318530717958647692f;
  const float ra = sqrtf(-2.0f * logf(uniform24(c[0])));
  const float rb = sqrtf(-2.0f * logf(uniform24(c[2])));
  const float ta = two_pi * uniform24(c[1]);
  const float tb = two_pi * uniform24(c[3]);
  z[0] = ra * cosf(ta);
  z[1] = ra * sinf(ta);
  z[2] = rb * cosf(tb);
}

// Sum of `v` over aligned groups of `width` lanes (a power of two <= 32),
// the same value in every lane of the group: xor shuffles in a fixed order.
// Every lane of the warp must call it.
__device__ __forceinline__ float team_sum(float v, int width) {
  for (int o = width >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum of `v` over the block, the same value in every thread. Fixed order
// (xor shuffles, then the warps' partials in sequence), so a launch is
// reproducible. Every thread of the block must call it.
__device__ float block_sum(float v, float* red) {
  v = team_sum(v, 32);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  __syncthreads();
  float s = 0.0f;
  const int n_warps = blockDim.x >> 5;
  for (int w = 0; w < n_warps; ++w) s += red[w];
  __syncthreads();
  return s;
}

// A barrier of the replica's CTAs: cluster.sync() (which also makes their
// shared-memory writes visible to each other), or __syncthreads().
__device__ __forceinline__ void replica_sync(const Args& a) {
  if (a.cluster > 1) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
}

// After each CTA wrote its own rows of `arr` (`width` floats a row; may be
// null): a replica barrier, then every other CTA's rows copied from its
// shared memory into this CTA's, and, when `extra` is given, `n_extra`
// floats of it from CTA 0. Ends on a block barrier. The copied arrays are
// written again only after the next replica barrier, which no CTA passes
// before all have copied.
__device__ void gather_rows(const Args& a, const Ctx& t, float* arr, int width, float* extra,
                            int n_extra) {
  replica_sync(a);
  if (a.cluster == 1) return;
  cg::cluster_group cl = cg::this_cluster();
  if (arr != nullptr) {
    for (int q = 0; q < a.cluster; ++q) {
      if (q == t.rank) continue;
      const float* rem = cl.map_shared_rank(arr, q);
      const int hi = min(a.n, (q + 1) * a.rows) * width;
      for (int k = q * a.rows * width + threadIdx.x; k < hi; k += blockDim.x) arr[k] = rem[k];
    }
  }
  if (extra != nullptr && t.rank != 0) {
    const float* rem = cl.map_shared_rank(extra, 0);
    for (int k = threadIdx.x; k < n_extra; k += blockDim.x) extra[k] = rem[k];
  }
  __syncthreads();
}

// The replica's sums of two per-CTA totals, in rank order, the same in every
// thread of every CTA. Every thread of the cluster must call it.
__device__ float2 replica_sum2(const Args& a, float* part, float v0, float v1) {
  if (a.cluster == 1) return make_float2(v0, v1);
  cg::cluster_group cl = cg::this_cluster();
  if (threadIdx.x == 0) {
    part[0] = v0;
    part[1] = v1;
  }
  cl.sync();
  float s0 = 0.0f, s1 = 0.0f;
  for (int q = 0; q < a.cluster; ++q) {
    const float* p = cl.map_shared_rank(part, q);
    s0 += p[0];
    s1 += p[1];
  }
  cl.sync();
  return make_float2(s0, s1);
}

// bond vectors, plane normals and the cos/sin pair (xx, yy)/norm of one
// dihedral, with kEps where pallas_md.py _bias_planes has _EPS
struct Dihedral {
  float b1[3], b2[3], b3[3], m[3], n[3];
  float lb2, m2, n2, cph, sph;
};

__device__ __forceinline__ void dihedral_geometry(const float* sx, const int* q, Dihedral* g) {
  float x1[3], x2[3], x3[3], x4[3], mn[3];
  load3(sx, q[0], x1);
  load3(sx, q[1], x2);
  load3(sx, q[2], x3);
  load3(sx, q[3], x4);
  for (int c = 0; c < 3; ++c) {
    g->b1[c] = x2[c] - x1[c];
    g->b2[c] = x3[c] - x2[c];
    g->b3[c] = x4[c] - x3[c];
  }
  cross3(g->b1, g->b2, g->m);
  cross3(g->b2, g->b3, g->n);
  g->lb2 = sqrtf(dot3(g->b2, g->b2) + kEps);
  g->m2 = dot3(g->m, g->m) + kEps;
  g->n2 = dot3(g->n, g->n) + kEps;
  cross3(g->m, g->n, mn);
  const float yy = dot3(mn, g->b2) / g->lb2;   // IUPAC sign
  const float xx = dot3(g->m, g->n);
  const float norm = sqrtf(xx * xx + yy * yy + kEps);
  g->cph = xx / norm;
  g->sph = yy / norm;
}

__device__ BiasSmem bias_smem(const Args& a, float* base) {
  BiasSmem s;
  int n_act = 0, max_w = 0;
  for (int l = 0; l <= a.n_layers; ++l) {
    n_act += a.widths[l];
    max_w = max(max_w, a.widths[l]);
  }
  s.P = base;
  s.act = s.P + a.bias_p_len;
  s.y = s.act + n_act;
  s.g0 = s.y + kMaxCv;
  s.g1 = s.g0 + max_w;
  s.dphi = s.g1 + max_w;
  s.cs = s.dphi + a.n_dih;
  s.sn = s.cs + a.n_dih;
  s.red = s.sn + a.n_dih;
  return s;
}

// lanes a unit for `n_units` units over the block: the largest power of two
// <= 32 that leaves no unit without a team
__device__ __forceinline__ int unit_lanes(int n_units) {
  int s = 1;
  while (s < 32 && 2 * s * n_units <= static_cast<int>(blockDim.x)) s <<= 1;
  return s;
}

// out[j] = b[j] + sum_k in[k] w[k n_out + j] (tanh'd when `act`), a team of
// lanes a unit j splitting k. Block-wide; ends on a barrier.
__device__ void dense_forward(const float* in, const float* w, const float* b, float* out,
                              int n_in, int n_out, bool act) {
  const int S = unit_lanes(n_out);
  const int team = threadIdx.x / S, lane = threadIdx.x & (S - 1);
  const int n_teams = blockDim.x / S;
  for (int base = 0; base < n_out; base += n_teams) {
    const int j = base + team;
    float acc = 0.0f;
    if (j < n_out) {
      for (int k = lane; k < n_in; k += S) acc += in[k] * w[k * n_out + j];
    }
    acc = team_sum(acc, S);
    if (j < n_out && lane == 0) {
      const float z = b[j] + acc;
      out[j] = act ? tanhf(z) : z;
    }
  }
  __syncthreads();
}

// g_in[k] = sum_j g_out[j] w[k n_out + j], times 1 - h_in[k]^2 when the
// input is a tanh output; a team of lanes a unit k splitting j.
// Block-wide; ends on a barrier.
__device__ void dense_backward(const float* g_out, const float* w, const float* h_in,
                               float* g_in, int n_in, int n_out, bool tanh_in) {
  const int S = unit_lanes(n_in);
  const int team = threadIdx.x / S, lane = threadIdx.x & (S - 1);
  const int n_teams = blockDim.x / S;
  for (int base = 0; base < n_in; base += n_teams) {
    const int k = base + team;
    float acc = 0.0f;
    if (k < n_in) {
      for (int j = lane; j < n_out; j += S) acc += g_out[j] * w[k * n_out + j];
    }
    acc = team_sum(acc, S);
    if (k < n_in && lane == 0) g_in[k] = tanh_in ? acc * (1.0f - h_in[k] * h_in[k]) : acc;
  }
  __syncthreads();
}

// positions -> CVs in s.y (pallas_md.py _cv_forward); keeps cos/sin and
// every activation for the backward pass. Block-wide; ends on a barrier.
__device__ void cv_forward(const Args& a, const float* sx, const BiasSmem& s) {
  const int tid = threadIdx.x, T = blockDim.x, M = a.n_dih;
  const float* mu = s.P;
  const float* inv_sigma = s.P + 2 * M;
  for (int d = tid; d < M; d += T) {
    Dihedral g;
    dihedral_geometry(sx, a.quads + 4 * d, &g);
    s.cs[d] = g.cph;
    s.sn[d] = g.sph;
    s.act[d] = (g.cph - mu[d]) * inv_sigma[d];
    s.act[M + d] = (g.sph - mu[M + d]) * inv_sigma[M + d];
  }
  __syncthreads();
  const float* h = s.act;
  const float* w = s.P + 4 * M;
  for (int l = 0; l < a.n_layers; ++l) {
    const int n_in = a.widths[l], n_out = a.widths[l + 1];
    const float* b = w + n_in * n_out;
    float* h_out = const_cast<float*>(h) + n_in;
    dense_forward(h, w, b, h_out, n_in, n_out, l < a.n_layers - 1);
    h = h_out;
    w = b + n_out;
  }
  // h: raw outputs; w: wmean then wmat (n_cv, n_cv)
  const int n_cv = a.n_cv;
  if (tid < n_cv) {
    float acc = h[tid];
    if (a.use_whiten) {
      const float* wmat = w + n_cv;
      acc = 0.0f;
      for (int j = 0; j < n_cv; ++j) acc += (h[j] - w[j]) * wmat[j * n_cv + tid];
    }
    s.y[tid] = acc;
  }
  __syncthreads();
}

// Bias energy of the hills ledger at the CVs in `cv` and, when `grad` is
// non-null, its CV gradient: E = sum_h height_h exp(-1/2 |(cv - c_h)/sigma|^2)
// over the valid prefix. Block-wide; the same values in every thread.
__device__ float hills_energy(const Args& a, const float* cv, int n_hills, float* red,
                              float* grad) {
  const int n_cv = a.n_cv;
  float e = 0.0f, g[kMaxCv];
#pragma unroll
  for (int k = 0; k < kMaxCv; ++k) g[k] = 0.0f;
  for (int h = threadIdx.x; h < n_hills; h += blockDim.x) {
    float d[kMaxCv], d2 = 0.0f;
#pragma unroll
    for (int k = 0; k < kMaxCv; ++k) {
      if (k < n_cv) {
        d[k] = (cv[k] - __ldcg(a.mtd_centers + h * n_cv + k)) * a.mtd_inv_sigma[k];
        d2 += d[k] * d[k];
      }
    }
    const float wg = __ldcg(a.mtd_heights + h) * expf(-0.5f * d2);
    e += wg;
#pragma unroll
    for (int k = 0; k < kMaxCv; ++k) {
      if (k < n_cv) g[k] -= wg * d[k] * a.mtd_inv_sigma[k];
    }
  }
  e = block_sum(e, red);
  if (grad != nullptr) {
#pragma unroll
    for (int k = 0; k < kMaxCv; ++k) {
      if (k < n_cv) grad[k] = block_sum(g[k], red);
    }
  }
  return e;
}

// The CV bias at the positions in sx (pallas_md.py _bias_planes): returns
// the bias energy (the same in every thread) and leaves dE/dphi of every
// dihedral in s.dphi for the per-atom scatter. Block-wide.
__device__ float bias_energy_and_dphi(const Args& a, const float* sx, const BiasSmem& s,
                                      int n_hills) {
  const int tid = threadIdx.x, T = blockDim.x, M = a.n_dih, n_cv = a.n_cv;
  cv_forward(a, sx, s);
  float e_bias = 0.0f, g_cv[kMaxCv];
  if (a.bias_kind == kMetadynamics) {
    float cv[kMaxCv];
#pragma unroll
    for (int k = 0; k < kMaxCv; ++k) cv[k] = k < n_cv ? s.y[k] : 0.0f;
    e_bias = hills_energy(a, cv, n_hills, s.red, g_cv);
  } else {
#pragma unroll
    for (int k = 0; k < kMaxCv; ++k) {
      if (k < n_cv) {
        e_bias += a.bias_strength * s.y[k] * s.y[k];
        g_cv[k] = 2.0f * a.bias_strength * s.y[k];
      }
    }
  }
  // back through the whitening into the gradient of the raw outputs
  const float* w_end = s.P + a.bias_p_len;        // end of the blob
  const float* wmat = w_end - n_cv * n_cv;
  if (tid < n_cv) {
    float acc = 0.0f;
    if (a.use_whiten) {
#pragma unroll
      for (int k = 0; k < kMaxCv; ++k) {
        if (k < n_cv) acc += g_cv[k] * wmat[tid * n_cv + k];
      }
    } else {
#pragma unroll
      for (int k = 0; k < kMaxCv; ++k) {
        if (k == tid) acc = g_cv[k];
      }
    }
    s.g0[tid] = acc;
  }
  __syncthreads();
  // back through the layers: cur holds dE/d(output of layer l)
  float* cur = s.g0;
  float* nxt = s.g1;
  const float* w = wmat - n_cv;                    // wmean
  const float* h_in = s.y;                         // one past the activations
  for (int l = a.n_layers - 1; l >= 0; --l) {
    const int n_in = a.widths[l], n_out = a.widths[l + 1];
    w -= n_in * n_out + n_out;                     // this layer's weights
    h_in -= (l == a.n_layers - 1) ? n_out + n_in : n_in;
    // the input of layer l >= 1 is a tanh output: fold its derivative in
    dense_backward(cur, w, h_in, nxt, n_in, n_out, l > 0);
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  // cur: dE/dz (2M); dE/dphi = -sin g_cos + cos g_sin
  const float* inv_sigma = s.P + 2 * M;
  for (int d = tid; d < M; d += T) {
    const float g_cos = cur[d] * inv_sigma[d];
    const float g_sin = cur[M + d] * inv_sigma[M + d];
    s.dphi[d] = -s.sn[d] * g_cos + s.cs[d] * g_sin;
  }
  __syncthreads();
  return e_bias;
}

// force of the bias on the atom in `role` of dihedral `d`: -dE/dphi dphi/dx
__device__ void bias_atom_force(const Args& a, const float* sx, const BiasSmem& s, int role,
                                int d, float f[3]) {
  Dihedral g;
  dihedral_geometry(sx, a.quads + 4 * d, &g);
  const float dE = s.dphi[d];
  const float s12 = dot3(g.b1, g.b2) / (g.lb2 * g.lb2);
  const float s32 = dot3(g.b3, g.b2) / (g.lb2 * g.lb2);
  for (int c = 0; c < 3; ++c) {
    const float d1 = -(g.lb2 / g.m2) * g.m[c];
    const float d4 = (g.lb2 / g.n2) * g.n[c];
    float dd;
    if (role == 0) dd = d1;
    else if (role == 1) dd = -(1.0f + s12) * d1 + s32 * d4;
    else if (role == 2) dd = s12 * d1 - (1.0f + s32) * d4;
    else dd = d4;
    f[c] += -dE * dd;
  }
}

// shared memory of one CTA: every position, Born radius, chain factor and
// the partners' rho and scaled radius of the replica; the reductions; the
// staged pair tables; then the bias work space
struct Smem {
  float* sx;      // (N, 3)
  float* sB;      // (N,)
  float* sChain;  // (N,)
  float* sr;      // (N,) scaled radii
  float* rho;     // (N,) offset radii
  float* red;     // (32) warp partials
  float* part;    // (2) this CTA's totals for the cluster sum
  float* tab;     // (staged tables, rows, ld) or unused
  BiasSmem bias;
};

__device__ __forceinline__ int staged_tables(const Args& a) {
  return a.use_neck ? static_cast<int>(kStagedTables) : static_cast<int>(kNeckD0);
}

// Carves the shared memory and fills what is constant for the launch: the
// partners' parameters, this CTA's pair tables (when staged) and, in CTA 0,
// the bias parameters. Visible after the next barrier.
__device__ Smem carve_smem(const Args& a, const Ctx& t, float* base) {
  const int n = a.n;
  Smem s;
  s.sx = base;
  s.sB = s.sx + 3 * n;
  s.sChain = s.sB + n;
  s.sr = s.sChain + n;
  s.rho = s.sr + n;
  s.red = s.rho + n;
  s.part = s.red + 32;
  s.tab = s.part + 4;
  float* next = s.tab + (a.staged ? staged_tables(a) * a.rows * a.ld : 0);
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    s.sr[k] = a.atom_p[kSr * n + k];
    s.rho[k] = a.atom_p[kRho * n + k];
  }
  if (a.staged) {
    const int per_table = t.nrows * n;
    const int total = staged_tables(a) * per_table;
    for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
      const int k = idx / per_table;
      const int lr = (idx - k * per_table) / n;
      const int j = idx - k * per_table - lr * n;
      const int i = t.row0 + lr;
      const size_t src = (k < kPairTables)
          ? static_cast<size_t>(k) * n * n + static_cast<size_t>(i) * n + j
          : static_cast<size_t>(k - kNeckD0T + kNeckD0) * n * n + static_cast<size_t>(j) * n + i;
      s.tab[(k * a.rows + lr) * a.ld + j] = a.pair_p[src];
    }
  }
  s.bias = BiasSmem();
  if (a.bias_kind != kNoBias) {
    s.bias = bias_smem(a, next);
    if (t.rank == 0) {
      for (int k = threadIdx.x; k < a.bias_p_len; k += blockDim.x) s.bias.P[k] = a.bias_p[k];
    }
  }
  return s;
}

// Where this thread's row reads its pair parameters: entry (i, j) of row
// table k at row[k kstride + j], entry (j, i) of neck table k at
// col[(k - kNeckD0T) kstride + j jstride]; shared memory when the tables
// are staged, else global memory (no branch in the pair loops).
struct RowTables {
  const float* row;
  const float* col;
  int kstride;
  int jstride;
};

__device__ __forceinline__ RowTables row_tables(const Args& a, const Smem& s, const Ctx& t) {
  RowTables rt;
  if (a.staged) {
    const int lr = t.i - t.row0;
    rt.row = s.tab + lr * a.ld;
    rt.col = s.tab + (kNeckD0T * a.rows + lr) * a.ld;
    rt.kstride = a.rows * a.ld;
    rt.jstride = 1;
  } else {
    rt.row = a.pair_p + t.i * a.n;
    rt.col = a.pair_p + kNeckD0 * a.n * a.n + t.i;
    rt.kstride = a.n * a.n;
    rt.jstride = a.n;
  }
  return rt;
}

// born_pair (gb_pair.cuh) with the same arithmetic and no branch: the
// inactive pair and the engulfed atom are chosen by selects, so that the
// pairs of one iteration stay in one basic block and their chains overlap
__device__ __forceinline__ void born_pair_sel(float r, float inv_r, float rho_i, float sr_j,
                                              float* H, float* dH) {
  const float u_raw = r + sr_j;
  const float diff = r - sr_j;
  const float absd = fabsf(diff);
  const float sgn = (diff > 0.0f) ? 1.0f : ((diff < 0.0f) ? -1.0f : 0.0f);
  const bool use_rho = absd < rho_i;
  const float L = use_rho ? rho_i : absd;
  const float dL = use_rho ? 0.0f : sgn;
  const float inv_L = 1.0f / L;
  const float inv_U = 1.0f / u_raw;
  const float log_LU = logf(L * inv_U);
  const float quad = r - sr_j * sr_j * inv_r;
  float h = inv_L - inv_U + 0.25f * quad * (inv_U * inv_U - inv_L * inv_L) + 0.5f * log_LU * inv_r;
  const float dquad = 1.0f + sr_j * sr_j * (inv_r * inv_r);
  float dh = -dL * inv_L * inv_L + inv_U * inv_U
             + 0.25f * dquad * (inv_U * inv_U - inv_L * inv_L)
             + 0.25f * quad * (-2.0f * inv_U * inv_U * inv_U + 2.0f * dL * inv_L * inv_L * inv_L)
             - 0.5f * log_LU * inv_r * inv_r
             + 0.5f * inv_r * (dL * inv_L - inv_U);
  const bool engulfed = (sr_j - r) > rho_i;
  h = engulfed ? h + 2.0f * (1.0f / rho_i - inv_L) : h;
  dh = engulfed ? dh + 2.0f * dL * inv_L * inv_L : dh;
  const bool active = !(u_raw <= rho_i);
  *H = active ? h : 0.0f;
  *dH = active ? dh : 0.0f;
}

// displacement from partner j to this row's atom, and their distance
__device__ __forceinline__ float pair_geometry(const float* sx, const float xi[3], int j,
                                               float d[3]) {
  float xj[3];
  load3(sx, j, xj);
  for (int c = 0; c < 3; ++c) d[c] = xi[c] - xj[c];
  return sqrtf(dot3(d, d) + kEps);
}

// Forces on atom t.i at the replica's positions (every lane of the row
// team gets them); the atom's energy share in *e when `e` is non-null,
// valid in the team's lead (thread 0 of CTA 0 also carries the bias
// energy). The positions in sx must hold the CTA's own rows (the other
// rows are copied here). Every thread of the cluster must call it: it
// holds the replica barriers between the GB phases and ends with a block
// barrier, so callers may overwrite sx afterwards. `n_hills` is the valid
// prefix of the metadynamics ledger. Lane l of a row team takes partners
// j = l, l + L, ...; the self pair and a slot past the last partner are
// computed on a valid index and left out by a select.
template <bool kBias>
__device__ void compute_forces(const Args& a, const Smem& s, const Ctx& t, int n_hills,
                               float f[3], float* e) {
  // partners a lane takes an iteration: two independent pair chains
  // overlap where the registers allow it (the biased kernels keep one); the
  // sums add the pairs in the same order either way
  constexpr int P = kBias ? 1 : 2;
  const int n = a.n, L = a.lanes;
  const float* atom_p = a.atom_p;
  gather_rows(a, t, s.sx, 3, nullptr, 0);
  float xi[3] = {0.0f, 0.0f, 0.0f};
  if (t.own) load3(s.sx, t.i, xi);
  const RowTables rt = row_tables(a, s, t);
  f[0] = f[1] = f[2] = 0.0f;
  float energy = 0.0f;
  float rho_i = 0.0f, sr_i = 0.0f, B_i = 1.0f, chain_i = 0.0f;
  float e_bias = 0.0f;
  if (kBias && t.rank == 0) e_bias = bias_energy_and_dphi(a, s.sx, s.bias, n_hills);
  float* dphi = kBias ? s.bias.dphi : nullptr;

  if (a.use_gb) {
    // --- phase 1: Born radius of atom i ---
    float Ih = 0.0f, In = 0.0f, dB_dpsi = 0.0f;
    if (t.own) {
      rho_i = s.rho[t.i];
      sr_i = s.sr[t.i];
      for (int j0 = t.lane; j0 < n; j0 += P * L) {
        int jj[P];
        bool ok[P];
        float r[P], H[P], nv[P];
#pragma unroll
        for (int u = 0; u < P; ++u) {
          const int j = j0 + u * L;
          ok[u] = j < n && j != t.i;
          jj[u] = j < n ? j : j0;
          float d[3], dH;
          r[u] = pair_geometry(s.sx, xi, jj[u], d);
          born_pair_sel(r[u], 1.0f / r[u], rho_i, s.sr[jj[u]], &H[u], &dH);
          nv[u] = 0.0f;
        }
        if (a.use_neck) {
#pragma unroll
          for (int u = 0; u < P; ++u) {
            float dnv;
            neck_pair(r[u], rt.row[kNeckD0 * rt.kstride + jj[u]],
                      rt.row[kNeckM0 * rt.kstride + jj[u]], &nv[u], &dnv);
          }
        }
#pragma unroll
        for (int u = 0; u < P; ++u) {
          Ih += ok[u] ? H[u] : 0.0f;
          In += ok[u] ? nv[u] : 0.0f;
        }
      }
    }
    Ih = team_sum(Ih, L);
    In = team_sum(In, L);
    if (t.own) {
      const float I = 0.5f * Ih + In;
      const float al = __ldg(atom_p + kAlpha * n + t.i);
      const float be = __ldg(atom_p + kBeta * n + t.i);
      const float ga = __ldg(atom_p + kGamma * n + t.i);
      const float radii = __ldg(atom_p + kRadii * n + t.i);
      const float psi = I * rho_i;
      const float g = al * psi - be * psi * psi + ga * psi * psi * psi;
      const float th = tanhf(g);
      const float inv_B_raw = 1.0f / rho_i - th / radii;
      const bool clamped = inv_B_raw < 1e-3f;
      B_i = 1.0f / fmaxf(inv_B_raw, 1e-3f);
      const float gprime = al - 2.0f * be * psi + 3.0f * ga * psi * psi;
      dB_dpsi = clamped ? 0.0f : B_i * B_i * (1.0f - th * th) * gprime / radii;
      if (t.lane == 0) s.sB[t.i] = B_i;
    }
    gather_rows(a, t, s.sB, 1, dphi, a.n_dih);
    // --- phase 2: dE/dB_i and the chain factor of atom i ---
    float acc = 0.0f, e_cross = 0.0f;
    if (t.own) {
      for (int j0 = t.lane; j0 < n; j0 += P * L) {
#pragma unroll
        for (int u = 0; u < P; ++u) {
          const int j = j0 + u * L;
          const bool ok = j < n && j != t.i;
          const int jv = j < n ? j : j0;
          float d[3];
          const float r = pair_geometry(s.sx, xi, jv, d);
          const float r2 = r * r;
          const float B_j = s.sB[jv];
          const float BB = B_i * B_j;
          const float expu = expf(-r2 / (4.0f * BB));
          const float inv_f = 1.0f / sqrtf(r2 + BB * expu);
          const float qq = rt.row[kQqFull * rt.kstride + jv];
          const float dEdf = -qq * inv_f * inv_f;
          acc += ok ? dEdf * (expu * (B_j + r2 / (4.0f * B_i)) * (0.5f * inv_f)) : 0.0f;
          e_cross += ok ? qq * inv_f : 0.0f;
        }
      }
    }
    acc = team_sum(acc, L);
    e_cross = team_sum(e_cross, L);
    if (t.own) {
      const float q_i = __ldg(atom_p + kQ * n + t.i);
      const float sa_i = __ldg(atom_p + kSa * n + t.i);
      const float inv_B = 1.0f / B_i;
      const float inv_B2 = inv_B * inv_B;
      const float inv_B6 = inv_B2 * inv_B2 * inv_B2;
      const float dEdB =
          2.0f * acc - a.gb_pref * q_i * q_i * inv_B2 - 6.0f * sa_i * inv_B6 * inv_B;
      chain_i = dEdB * dB_dpsi * rho_i;
      if (t.lane == 0) {
        s.sChain[t.i] = chain_i;
        energy += e_cross + a.gb_pref * q_i * q_i * inv_B + sa_i * inv_B6;
      }
    }
    gather_rows(a, t, s.sChain, 1, nullptr, 0);
  } else if (a.cluster > 1) {
    // no GB phase to meet at: a barrier that keeps the rows copied above
    // unwritten until every CTA has them, and brings dE/dphi from CTA 0
    gather_rows(a, t, nullptr, 0, dphi, a.n_dih);
  }

  // --- phase 3: row-owned pair forces + bonded terms ---
  float e_lane = 0.0f;
  if (t.own) {
    float e_nb = 0.0f;
    for (int j0 = t.lane; j0 < n; j0 += P * L) {
      int jj[P];
      bool ok[P];
      float d[P][3], r[P], inv_r[P], g[P];
#pragma unroll
      for (int u = 0; u < P; ++u) {
        const int j = j0 + u * L;
        ok[u] = j < n && j != t.i;
        jj[u] = j < n ? j : j0;
        r[u] = pair_geometry(s.sx, xi, jj[u], d[u]);
        inv_r[u] = 1.0f / r[u];
        const float inv_r2 = inv_r[u] * inv_r[u];
        const float inv_r6 = inv_r2 * inv_r2 * inv_r2;
        const float inv_r12 = inv_r6 * inv_r6;
        const float la = rt.row[kLjA * rt.kstride + jj[u]];
        const float lb = rt.row[kLjB * rt.kstride + jj[u]];
        const float qs = rt.row[kQqScaled * rt.kstride + jj[u]];
        // dE/dr of the (symmetric) LJ + Coulomb pair, summed over both orders
        g[u] = -12.0f * la * inv_r12 * inv_r[u] + 6.0f * lb * inv_r6 * inv_r[u] - qs * inv_r2;
        const float e_pair = la * inv_r12 - lb * inv_r6 + qs * inv_r[u];
        e_nb += ok[u] ? e_pair : 0.0f;
      }
      if (a.use_gb) {
        float dI_ij[P], dI_ji[P];
#pragma unroll
        for (int u = 0; u < P; ++u) {
          const float r2 = r[u] * r[u];
          const float B_j = s.sB[jj[u]];
          const float BB = B_i * B_j;
          const float expu = expf(-r2 / (4.0f * BB));
          const float inv_f = 1.0f / sqrtf(r2 + BB * expu);
          const float qq = rt.row[kQqFull * rt.kstride + jj[u]];
          // direct GB term at fixed Born radii, both orders
          g[u] += 2.0f * (-qq * inv_f * inv_f) * (r[u] * (1.0f - 0.25f * expu) * inv_f);
          // Born chain: dE/dB_i dB_i/dr_ij + dE/dB_j dB_j/dr_ji
          float H, dH_ij, dH_ji;
          born_pair_sel(r[u], inv_r[u], rho_i, s.sr[jj[u]], &H, &dH_ij);
          born_pair_sel(r[u], inv_r[u], s.rho[jj[u]], sr_i, &H, &dH_ji);
          dI_ij[u] = 0.5f * dH_ij;
          dI_ji[u] = 0.5f * dH_ji;
        }
        if (a.use_neck) {
#pragma unroll
          for (int u = 0; u < P; ++u) {
            float nv, dnv;
            neck_pair(r[u], rt.row[kNeckD0 * rt.kstride + jj[u]],
                      rt.row[kNeckM0 * rt.kstride + jj[u]], &nv, &dnv);
            dI_ij[u] += dnv;
            neck_pair(r[u], rt.col[jj[u] * rt.jstride],
                      rt.col[rt.kstride + jj[u] * rt.jstride], &nv, &dnv);
            dI_ji[u] += dnv;
          }
        }
#pragma unroll
        for (int u = 0; u < P; ++u) g[u] += chain_i * dI_ij[u] + s.sChain[jj[u]] * dI_ji[u];
      }
#pragma unroll
      for (int u = 0; u < P; ++u) {
        const float coef = ok[u] ? g[u] * inv_r[u] : 0.0f;
        for (int c = 0; c < 3; ++c) f[c] -= coef * d[u][c];
      }
    }
    e_lane = 0.5f * e_nb;
    for (int q = a.csr_ptr[t.i] + t.lane; q < a.csr_ptr[t.i + 1]; q += L) {
      const int code = a.csr_ent[2 * q];
      bonded_term(a.bonded, s.sx, code >> 2, code & 3, a.csr_ent[2 * q + 1], f, &e_lane);
    }
    if (kBias) {
      for (int q = a.dih_ptr[t.i] + t.lane; q < a.dih_ptr[t.i + 1]; q += L) {
        bias_atom_force(a, s.sx, s.bias, a.dih_ent[2 * q], a.dih_ent[2 * q + 1], f);
      }
    }
  }
  for (int c = 0; c < 3; ++c) f[c] = team_sum(f[c], L);
  if (e != nullptr) {
    energy += team_sum(e_lane, L);
    if (t.rank == 0 && threadIdx.x == 0) energy += e_bias;
    *e = energy;
  }
  __syncthreads();
}

// one folded-BAOAB step of atom t.i (its lead integrates); the next force
// evaluation's barrier makes the new positions visible
template <bool kBias>
__device__ __forceinline__ void md_step(const Args& a, const Smem& s, const Ctx& t, int n_hills,
                                        uint32_t seed, uint32_t key1, unsigned long long step,
                                        float inv_m, float sigma, float x[3], float v[3]) {
  float f[3];
  compute_forces<kBias>(a, s, t, n_hills, f, nullptr);
  if (t.lead) {
    float z[3];
    gaussian3(seed, key1, step, static_cast<uint32_t>(t.i), z);
    for (int c = 0; c < 3; ++c) {
      v[c] = v[c] + a.dt * f[c] * inv_m;   // B(dt): folded full kick
      x[c] = x[c] + a.half_dt * v[c];      // A(dt/2)
      v[c] = a.c1 * v[c] + sigma * z[c];   // O
      x[c] = x[c] + a.half_dt * v[c];      // A(dt/2)
      s.sx[3 * t.i + c] = x[c];
    }
  }
}

// After a deposit window: CTA 0 adds one hill per replica, in replica
// order, each against the ledger that already holds the earlier ones
// (pallas_md.py fully-fused mode). A full ledger takes no more hills.
__device__ void deposit_hills(const Args& a, const Smem& s) {
  const int n_cv = a.n_cv;
  const int n_replicas = static_cast<int>(gridDim.x) / a.cluster;
  for (int r = 0; r < n_replicas; ++r) {
    const int count = __ldcg(a.mtd_count);
    float cv[kMaxCv];
#pragma unroll
    for (int k = 0; k < kMaxCv; ++k) cv[k] = k < n_cv ? __ldcg(a.cv_buf + r * n_cv + k) : 0.0f;
    float h_new = a.mtd_height;
    if (a.mtd_kb_dt > 0.0f) {
      const float v_here = hills_energy(a, cv, count, s.bias.red, nullptr);
      h_new = a.mtd_height * expf(-v_here / a.mtd_kb_dt);
    }
    if (threadIdx.x == 0 && count < a.mtd_capacity) {
      for (int k = 0; k < n_cv; ++k) a.mtd_centers[count * n_cv + k] = cv[k];
      a.mtd_heights[count] = h_new;
      *a.mtd_count = count + 1;
      __threadfence();
    }
    __syncthreads();
  }
}

template <bool kBias>
__device__ __forceinline__ void chunk_body(const Args& a) {
  extern __shared__ float smem[];
  const int n = a.n;
  const Ctx t = make_ctx(a);
  const Smem s = carve_smem(a, t, smem);
  const int r = blockIdx.x / a.cluster;
  const size_t rbase = static_cast<size_t>(r) * n * 3;
  const size_t base = rbase + static_cast<size_t>(t.i) * 3;

  for (int k = threadIdx.x; k < 3 * n; k += blockDim.x) s.sx[k] = a.x[rbase + k];
  float x[3] = {0.0f, 0.0f, 0.0f}, v[3] = {0.0f, 0.0f, 0.0f};
  float inv_m = 0.0f, sigma = 0.0f;
  if (t.lead) {
    for (int c = 0; c < 3; ++c) {
      x[c] = a.x[base + c];
      v[c] = a.v[base + c];
    }
    inv_m = a.atom_p[kInvM * n + t.i];
    sigma = sqrtf(a.c2sq * a.kT[r] * inv_m);
  }
  const uint32_t seed = static_cast<uint32_t>(a.seeds[r]);

  int n_hills = (a.bias_kind == kMetadynamics) ? __ldcg(a.mtd_count) : 0;
  if (kBias && a.mtd_interval > 0) {
    // fused metadynamics: deposit windows inside the launch
    cg::grid_group grid = cg::this_grid();
    const int n_windows = a.n_steps / a.mtd_interval;
    for (int w = 0; w < n_windows; ++w) {
      for (int k = 0; k < a.mtd_interval; ++k) {
        md_step<kBias>(a, s, t, n_hills, seed, static_cast<uint32_t>(r),
                       a.step_offset + static_cast<unsigned long long>(w) * a.mtd_interval + k,
                       inv_m, sigma, x, v);
      }
      gather_rows(a, t, s.sx, 3, nullptr, 0);
      if (t.rank == 0) {
        cv_forward(a, s.sx, s.bias);
        if (threadIdx.x < a.n_cv) a.cv_buf[r * a.n_cv + threadIdx.x] = s.bias.y[threadIdx.x];
      }
      grid.sync();
      if (blockIdx.x == 0) deposit_hills(a, s);
      grid.sync();
      n_hills = __ldcg(a.mtd_count);
    }
  } else {
    for (int k = 0; k < a.n_steps; ++k) {
      md_step<kBias>(a, s, t, n_hills, seed, static_cast<uint32_t>(r), a.step_offset + k,
                     inv_m, sigma, x, v);
    }
  }

  float f[3];
  float e_i = 0.0f;
  compute_forces<kBias>(a, s, t, n_hills, f, &e_i);
  if (t.lead) {
    for (int c = 0; c < 3; ++c) {
      a.x[base + c] = x[c];
      a.v[base + c] = v[c];
      if (a.forces != nullptr) a.forces[base + c] = f[c];
    }
  }
  const float e_cta = block_sum(t.lead ? e_i : 0.0f, s.red);
  const float e_total = replica_sum2(a, s.part, e_cta, 0.0f).x;
  if (t.rank == 0 && threadIdx.x == 0) a.energy[r] = e_total;
}

// Whole REMD run in one launch (pallas_md.py build_pallas_remd). Cluster c
// holds the configuration that starts on rung c and follows it from rung
// to rung; x/v/seeds/ids come in and go out rung-major.
template <bool kBias>
__device__ __forceinline__ void remd_body(const Args& a) {
  extern __shared__ float smem[];
  const int n = a.n;
  const int R = static_cast<int>(gridDim.x) / a.cluster;
  const Ctx t = make_ctx(a);
  const Smem s = carve_smem(a, t, smem);
  const bool head = t.rank == 0 && threadIdx.x == 0;   // writes the replica's scalars
  int rung = blockIdx.x / a.cluster;

  const size_t rbase = static_cast<size_t>(rung) * n * 3;
  for (int k = threadIdx.x; k < 3 * n; k += blockDim.x) s.sx[k] = a.x[rbase + k];
  float x[3] = {0.0f, 0.0f, 0.0f}, v[3] = {0.0f, 0.0f, 0.0f};
  float inv_m = 0.0f, mass = 0.0f;
  if (t.lead) {
    for (int c = 0; c < 3; ++c) {
      x[c] = a.x[rbase + 3 * t.i + c];
      v[c] = a.v[rbase + 3 * t.i + c];
    }
    inv_m = a.atom_p[kInvM * n + t.i];
    mass = inv_m > 0.0f ? 1.0f / inv_m : 0.0f;
  }
  const uint32_t seed = static_cast<uint32_t>(a.seeds[rung]);
  const int id = a.ids0[rung];

  cg::grid_group grid = cg::this_grid();
  unsigned long long step = a.step_offset;
  float f[3];
  for (int att = 0; att < a.n_attempts; ++att) {
    float energy = 0.0f;
    for (int j = 0; j < a.frames_per_attempt; ++j) {
      const float sigma = t.lead ? sqrtf(a.c2sq * a.kT[rung] * inv_m) : 0.0f;
      for (int k = 0; k < a.report_interval; ++k, ++step) {
        md_step<kBias>(a, s, t, 0, seed, static_cast<uint32_t>(rung), step, inv_m, sigma, x, v);
      }
      float e_i = 0.0f;
      compute_forces<kBias>(a, s, t, 0, f, &e_i);
      const float e_cta = block_sum(t.lead ? e_i : 0.0f, s.red);
      const float ke_cta = block_sum(
          t.lead ? 0.5f * mass * (v[0] * v[0] + v[1] * v[1] + v[2] * v[2]) : 0.0f, s.red);
      const float2 tot = replica_sum2(a, s.part, e_cta, ke_cta);
      energy = tot.x;
      const size_t slot = static_cast<size_t>(att) * a.frames_per_attempt + j;
      if (t.lead) {
        const size_t fb = ((slot * R + rung) * n + t.i) * 3;
        for (int c = 0; c < 3; ++c) a.frames[fb + c] = x[c];
      }
      if (head) {
        a.frame_e[slot * R + rung] = energy;
        a.frame_ke[slot * R + rung] = tot.y;
      }
    }
    // --- parity-alternating neighbour swap of rung assignments ---
    float* ebuf = a.swap_e + (att & 1) * R;
    if (head) ebuf[rung] = energy;
    grid.sync();
    const bool is_left = (rung & 1) == (att & 1);
    const int partner = is_left ? rung + 1 : rung - 1;
    bool accepted = false;
    if (partner >= 0 && partner < R) {
      const int lo = min(rung, partner);
      const unsigned long long ga = a.attempt_offset + att;
      uint32_t ctr[4] = {static_cast<uint32_t>(ga), static_cast<uint32_t>(ga >> 32),
                         static_cast<uint32_t>(lo), 1u};
      philox4x32_10(ctr, a.swap_seed, kSwapKey);
      const float u = uniform24(ctr[0]);
      const float log_acc =
          (a.betas[rung] - a.betas[partner]) * (energy - __ldcg(ebuf + partner));
      accepted = logf(u) < log_acc;
    }
    if (head) a.accept[static_cast<size_t>(att) * R + rung] = accepted ? 1.0f : 0.0f;
    if (accepted) {
      const float scale = sqrtf(a.ladder[partner] / a.ladder[rung]);
      for (int c = 0; c < 3; ++c) v[c] *= scale;
      rung = partner;
    }
    if (head) a.ids_hist[static_cast<size_t>(att + 1) * R + rung] = id;
  }
  if (t.lead) {
    const size_t b = (static_cast<size_t>(rung) * n + t.i) * 3;
    for (int c = 0; c < 3; ++c) {
      a.x_out[b + c] = x[c];
      a.v_out[b + c] = v[c];
    }
  }
  if (head) a.seeds_out[rung] = static_cast<int>(seed);
}

// Nothing but `n_barriers` grid barriers: what one barrier costs.
__global__ void grid_barrier_probe_kernel(int n_barriers) {
  cg::grid_group grid = cg::this_grid();
  for (int k = 0; k < n_barriers; ++k) grid.sync();
}

// All four kernels are bounded to kMaxThreads threads a block, one block an
// SM at most 128 registers a thread; the unbiased chunk is compiled
// without the bias code.
__global__ void __launch_bounds__(kMaxThreads, 1) fused_md_chunk_kernel(Args a) {
  chunk_body<false>(a);
}
__global__ void __launch_bounds__(kMaxThreads, 1) fused_md_bias_kernel(Args a) {
  chunk_body<true>(a);
}
__global__ void __launch_bounds__(kMaxThreads, 1) fused_remd_kernel(Args a) {
  remd_body<false>(a);
}
__global__ void __launch_bounds__(kMaxThreads, 1) fused_remd_bias_kernel(Args a) {
  remd_body<true>(a);
}

}  // namespace

extern "C" {

// Order of the pointer, integer and float arguments of pmarlo_fused_md_launch;
// md/fused_md.py lists the same names in the same order.
enum PtrArg {
  kPX = 0, kPV, kPEnergy, kPForces, kPSeeds, kPKT, kPAtomP, kPPairP, kPBondI, kPBondP,
  kPAngleI, kPAngleP, kPTorsI, kPTorsP, kPCsrPtr, kPCsrEnt,
  kPQuads, kPDihPtr, kPDihEnt, kPBiasP, kPMtdCenters, kPMtdHeights, kPMtdCount, kPCvBuf,
  kPXOut, kPVOut, kPSeedsOut, kPLadder, kPBetas, kPIds0, kPFrames, kPFrameE,
  kPFrameKe, kPIdsHist, kPAccept, kPSwapE, kNumPtrArgs
};
enum IntArg {
  kIReplicas = 0, kIAtoms, kISteps, kIUseGb, kIUseNeck, kIBiasKind, kINDih, kINLayers,
  kIWidth0,
  kINCv = kIWidth0 + kMaxLayers + 1, kIUseWhiten, kIBiasPLen, kIMtdCapacity, kIMtdInterval,
  kIAttempts, kIFramesPerAttempt, kIReportInterval, kISwapSeed, kICluster, kILanes,
  kIStaged, kNumIntArgs
};
enum FloatArg {
  kFDt = 0, kFHalfDt, kFC1, kFC2sq, kFGbPref, kFBiasStrength, kFMtdHeight, kFMtdKbDt,
  kFMtdInvSigma0, kNumFloatArgs = kFMtdInvSigma0 + kMaxCv
};
enum Mode { kModeChunk = 0, kModeFusedMtd = 1, kModeFusedRemd = 2 };
// what pmarlo_fused_md_plan writes
enum PlanOut { kOThreads = 0, kOSmem, kOStageable, kOResident, kOResidentStaged, kNumPlanOut };

int pmarlo_fused_md_max_atoms() { return kMaxAtoms; }

// the sizes of the argument arrays and the limits, for the wrapper to
// check against its own: n_ptrs, n_ints, n_floats, max_layers, max_cv,
// max_threads, max_cluster, n_plan_out
int pmarlo_fused_md_abi(int which) {
  const int v[8] = {kNumPtrArgs, kNumIntArgs, kNumFloatArgs, kMaxLayers,
                    kMaxCv, kMaxThreads, kMaxCluster, kNumPlanOut};
  return (which >= 0 && which < 8) ? v[which] : -1;
}

const char* pmarlo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

namespace {

const void* kernel_of(int mode, bool biased) {
  if (mode == kModeFusedRemd) {
    return biased ? reinterpret_cast<const void*>(fused_remd_bias_kernel)
                  : reinterpret_cast<const void*>(fused_remd_kernel);
  }
  return biased ? reinterpret_cast<const void*>(fused_md_bias_kernel)
                : reinterpret_cast<const void*>(fused_md_chunk_kernel);
}

// row stride of the staged tables: >= n, and (stride mod 32) an odd
// multiple of the lanes a row, so the row teams of a warp read different
// banks in the same iteration (any stride with 32 lanes, one row a warp)
int staged_ld(int n, int lanes) {
  if (lanes >= 32) return n;
  int ld = n;
  while (!((ld % 32) % lanes == 0 && (((ld % 32) / lanes) & 1))) ++ld;
  return ld;
}

struct Shape {
  int cluster, lanes, rows, threads, ld;
  size_t smem_plain, smem_staged;   // bytes without and with the staged tables
};

// Checks the launch shape in `iv` and sizes its block and shared memory;
// false for a shape the kernels do not take.
bool shape_of(const int* iv, Shape* sh) {
  const int n = iv[kIAtoms], C = iv[kICluster], L = iv[kILanes];
  if (n < 1 || n > kMaxAtoms || iv[kIReplicas] < 1) return false;
  if (C != 1 && C != 2 && C != 4 && C != 8) return false;
  if (L < 1 || L > 32 || (L & (L - 1)) != 0) return false;
  sh->cluster = C;
  sh->lanes = L;
  sh->rows = (n + C - 1) / C;
  if ((C - 1) * sh->rows >= n) return false;     // a CTA without rows
  sh->threads = (sh->rows * L + 31) / 32 * 32;
  if (sh->threads > kMaxThreads) return false;
  sh->ld = staged_ld(n, L);
  size_t floats = 7 * static_cast<size_t>(n) + 36;
  if (iv[kIBiasKind] != kNoBias) {
    int n_act = 0, max_w = 0;
    for (int l = 0; l <= iv[kINLayers]; ++l) {
      n_act += iv[kIWidth0 + l];
      max_w = max_w > iv[kIWidth0 + l] ? max_w : iv[kIWidth0 + l];
    }
    floats += iv[kIBiasPLen] + n_act + kMaxCv + 2 * max_w + 3 * iv[kINDih] + 32;
  }
  const int n_tables = iv[kIUseNeck] ? static_cast<int>(kStagedTables) : static_cast<int>(kNeckD0);
  sh->smem_plain = floats * sizeof(float);
  sh->smem_staged =
      (floats + static_cast<size_t>(n_tables) * sh->rows * sh->ld) * sizeof(float);
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

// Sizes the launch of `mode` with the shape in `iv` (kICluster, kILanes):
// threads a CTA, shared memory bytes without the staged tables, whether the
// tables fit (1/0), and the replicas that can be resident at once without
// and with them. Returns a CUDA error code (cudaErrorInvalidValue for a
// shape the kernels do not take).
int pmarlo_fused_md_plan(int mode, const int* iv, int* out) {
  Shape sh;
  if (!shape_of(iv, &sh)) return static_cast<int>(cudaErrorInvalidValue);
  const void* kernel = kernel_of(mode, iv[kIBiasKind] != kNoBias);
  size_t optin = 0;
  cudaError_t rc = allow_smem(kernel, &optin);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  out[kOThreads] = sh.threads;
  out[kOSmem] = static_cast<int>(sh.smem_plain);
  out[kOStageable] = sh.smem_staged <= optin ? 1 : 0;
  rc = resident_replicas(kernel, sh, sh.smem_plain, &out[kOResident]);
  out[kOResidentStaged] = 0;
  if (rc == cudaSuccess && out[kOStageable]) {
    rc = resident_replicas(kernel, sh, sh.smem_staged, &out[kOResidentStaged]);
  }
  return static_cast<int>(rc);
}

// Launches one kernel on `stream`; returns the CUDA error code of the
// launch (0 = launched). kModeChunk: K steps, optionally biased (ledger as
// input). kModeFusedMtd: the same kernel with deposits inside the launch.
// kModeFusedRemd: the whole REMD run. The last two need every CTA
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
  a.pair_p = static_cast<const float*>(ptr[kPPairP]);
  a.bonded.bond_i = static_cast<const int*>(ptr[kPBondI]);
  a.bonded.bond_p = static_cast<const float*>(ptr[kPBondP]);
  a.bonded.angle_i = static_cast<const int*>(ptr[kPAngleI]);
  a.bonded.angle_p = static_cast<const float*>(ptr[kPAngleP]);
  a.bonded.tors_i = static_cast<const int*>(ptr[kPTorsI]);
  a.bonded.tors_p = static_cast<const float*>(ptr[kPTorsP]);
  a.csr_ptr = static_cast<const int*>(ptr[kPCsrPtr]);
  a.csr_ent = static_cast<const int*>(ptr[kPCsrEnt]);
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
  a.staged = iv[kIStaged] != 0;
  a.ld = sh.ld;
  a.bias_kind = iv[kIBiasKind];
  a.n_dih = iv[kINDih];
  a.n_layers = iv[kINLayers];
  for (int l = 0; l <= kMaxLayers; ++l) a.widths[l] = iv[kIWidth0 + l];
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
  if (mode == kModeFusedMtd &&
      (a.bias_kind != kMetadynamics || a.mtd_interval < 1 || a.n_steps % a.mtd_interval != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (mode == kModeFusedRemd && a.bias_kind == kMetadynamics) {
    return static_cast<int>(cudaErrorInvalidValue);
  }

  const size_t shmem = a.staged ? sh.smem_staged : sh.smem_plain;
  const void* kernel = kernel_of(mode, a.bias_kind != kNoBias);
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
