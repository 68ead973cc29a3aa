// The device code of the fused kernels: the launch arguments (Args), the
// force routine, the step and the chunk and whole-run bodies. fused_md.cu
// (the design, the six unstamped kernels, the launch) includes it as it is;
// fused_md_stamped.cu defines PMARLO_FUSED_MD_STAMPED first and builds the
// whole-run kernels with the step-phase stamps (fused_md.cu, file header):
// there the force routine and the step take a trailing `Stamps` and
// STAMP(k) writes boundary k. In fused_md.cu the stamp macros expand to
// nothing, so the unstamped kernels compile from the text they had before
// the stamps: any trace of them there (a no-op call, an argument, an
// instantiation beside them) changed how ptxas allocated their registers.
// Only the sampled step of a stamped build runs the stamped instantiations.

#pragma once

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
// what a kernel build compiles in: no bias, the harmonic CV bias only, or
// the harmonic bias and the hills ledger
enum BiasBuild { kUnbiased = 0, kHarmonicOnly = 1, kAnyBias = 2 };
// second Philox key word of the swap uniforms (the noise streams use the
// replica index there, far below this)
constexpr uint32_t kSwapKey = 0x53574150u;
// rows of the per-atom parameter table
enum AtomRow { kInvM = 0, kQ, kRho, kSr, kRadii, kAlpha, kBeta, kGamma, kSa, kAtomRows };
// tables of a pair in item order (md/fused_md.py item_tables): the LJ and
// charge products, and the neck tables of (row, column) and (column, row)
enum PairTab { kTabLjA = 0, kTabLjB, kTabQqScaled, kTabQqFull, kTabD0, kTabM0, kTabD0T, kTabM0T,
               kPairTabs };
// sums a phase's slots carry: 1 (Born integral, dE/dB) or 3 (force)
constexpr int kSlotSums = 3;
// atoms of a bonded term of type kBond, kAngle, kTorsion
__device__ __forceinline__ int term_atoms(int type) { return type + 2; }
enum Phase { kBornPhase = 0, kDedbPhase, kForcePhase };

struct Args {
  float* x;                 // (R, N, 3) in/out
  float* v;                 // (R, N, 3) in/out
  float* energy;            // (R,) out: energy at the final positions
  float* forces;            // (R, N, 3) out, or null
  const int* seeds;         // (R,)
  const float* kT;          // (R,) kB * T per replica
  const float* atom_p;      // (kAtomRows, N)
  const int* items;         // (n_items, 4): row atom, column atom, first step | diagonal << 16,
                            //   row slot | column slot << 16
  const float* item_tab;    // (n_items, kPairTabs, steps, team)
  float* slot_scratch;      // (R, cluster, slot floats) when the slots are not in shared memory
  BondedTables bonded;      // bond, angle and torsion terms
  const int* csr_ptr;       // (N + 1,) each atom's range of the (term, role) incidences
  const int* bonded_slot;   // (M,) the CSR position of incidence (type, term, role),
                            //   type-major, then term, then role
  int n_terms[3];           // bonds, angles, torsions
  int bonded_ld;            // incidences of the atoms a CTA owns, at most
  int n;
  int n_steps;
  unsigned long long step_offset;
  float dt, half_dt, c1, c2sq, gb_pref;
  int use_gb, use_neck;
  // --- launch shape ---
  int cluster;              // CTAs a replica
  int lanes;                // lanes an atom team
  int rows;                 // atoms a CTA owns, ceil(N / cluster)
  int team;                 // lanes a pair team = atoms a group
  int steps;                // steps an item, team / 2
  int n_items;              // groups^2
  int n_slots;              // slots an atom, 2 groups
  int my_items;             // items a CTA at most, ceil(n_items / cluster)
  int staged;               // the items' tables in shared memory
  int slots_smem;           // the slots in shared memory (else slot_scratch)
  // --- CV bias (bias_kind != kNoBias) ---
  int bias_kind;
  int n_dih;                // M dihedrals -> 2M features
  int n_layers;             // linear layers of the MLP
  int widths[kMaxLayers + 1];   // 2M, hidden..., n_cv
  int n_act;                // sum of the widths: the activations
  int max_width;            // widest layer
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
  long long* stamps;        // (R, F, kStampBoundaries) clock64 stamps, or null (not traced)
};

// shared-memory views of the bias work space
struct BiasSmem {
  float* P;      // parameter blob
  float* act;    // activations: z (2M), then every layer's output
  float* y;      // (kMaxCv) whitened CVs
  float* gcv;    // (kMaxCv) dE/d(CV)
  float* g0;     // (max width) gradient ping
  float* g1;     // (max width) gradient pong
  float* dphi;   // (M) dE/dphi
  float* cs;     // (M) cos phi
  float* sn;     // (M) sin phi
  float* red;    // (32) warp partials
};

// Where this thread sits: its CTA's rank in the replica's cluster and the
// atoms it owns, and its atom team's atom and lane.
struct Ctx {
  int rank;      // CTA rank in the cluster
  int row0;      // first atom the CTA owns
  int nrows;     // atoms the CTA owns
  int i;         // this thread's atom team's atom
  int lane;      // lane in the atom team
  bool own;      // the atom exists and is this CTA's
  bool lead;     // own and lane 0: integrates the atom
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

// Sums of two values over the block, the same in every thread. Fixed order
// (xor shuffles, then the warps' partials in sequence), so a launch is
// reproducible; each component adds as a block sum of it alone would.
// Every thread of the block must call it.
__device__ float2 block_sum2(float v0, float v1, float* red) {
  v0 = team_sum(v0, 32);
  v1 = team_sum(v1, 32);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    red[2 * warp] = v0;
    red[2 * warp + 1] = v1;
  }
  __syncthreads();
  float s0 = 0.0f, s1 = 0.0f;
  const int n_warps = blockDim.x >> 5;
  for (int w = 0; w < n_warps; ++w) {
    s0 += red[2 * w];
    s1 += red[2 * w + 1];
  }
  __syncthreads();
  return make_float2(s0, s1);
}

__device__ float block_sum(float v, float* red) { return block_sum2(v, 0.0f, red).x; }

// A barrier of the replica's CTAs: cluster.sync() (which also makes their
// shared-memory and global writes visible to each other), or
// __syncthreads().
__device__ __forceinline__ void replica_sync(const Args& a) {
  if (a.cluster > 1) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
}

// `p` in the shared memory of CTA `rank` of the replica's cluster
__device__ __forceinline__ float* in_cta(const Args& a, float* p, int rank) {
  if (a.cluster == 1) return p;
  return cg::this_cluster().map_shared_rank(p, rank);
}

// The boundaries of a sampled step at which the stamped builds read
// clock64() (file header); the interval from each to the next is one phase.
enum StampAt {
  kStStart = 0,      // integration, put_everywhere
  kStMoved,          // replica barrier
  kStSynced,         // CV bias: dihedrals, MLP, dE/dphi to the other CTAs (CTA 0)
  kStBiasDone,       // Born sweep
  kStBornSwept,      // replica barrier
  kStBornSynced,     // Born slot sums
  kStBornFolded,     // Born radius, put_everywhere
  kStBornPut,        // replica barrier
  kStDedbStart,      // dE/dB sweep
  kStDedbSwept,      // replica barrier
  kStDedbSynced,     // dE/dB slot sums
  kStDedbFolded,     // chain factor, put_everywhere
  kStChainPut,       // replica barrier
  kStForceStart,     // force sweep and bonded terms
  kStForceSwept,     // replica barrier
  kStForceSynced,    // force slot sums and bonded incidences
  kStFolded,         // CV bias atom forces
  kStBiasForced,     // atom team sums, the force's writes
  kStWritten,        // block barrier
  kStEnd,
  kStampBoundaries
};

#ifdef PMARLO_FUSED_MD_STAMPED
// Where a stamped step writes its boundaries: `p` is null in every thread
// but the stamping one. The force routine and the step take the Stamps as a
// trailing pack of zero or one, so a stamped build runs the sampled step
// through their stamped instantiations and every other step through the
// unstamped ones (stamp(k) with no Stamps does nothing).
struct Stamps {
  long long* p;
};
__device__ __forceinline__ void stamp(int) {}
__device__ __forceinline__ void stamp(const Stamps& st, int k) {
  if (st.p != nullptr) st.p[k] = clock64();
}
#define STAMPS_TPARAM , typename... St
#define STAMPS_PARAM , St... st
#define STAMPS_ARG , st...
#define STAMP(k) stamp(st..., k)
// the boundaries a step without GB skips (kStBornSwept to kStForceStart)
#define STAMP_NO_GB(a) \
  if (!(a).use_gb) {   \
    for (int k_ = kStBornSwept; k_ <= kStForceStart; ++k_) stamp(st..., k_); \
  }
#else
#define STAMPS_TPARAM
#define STAMPS_PARAM
#define STAMPS_ARG
#define STAMP(k)
#define STAMP_NO_GB(a)
#endif

// The replica's sums of two per-CTA totals, in rank order, the same in every
// thread of every CTA, after one replica barrier. `part` is written again
// only after a later barrier, which no CTA passes before all have read it.
// Every thread of the cluster must call it.
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
  s.P = base;
  s.act = s.P + a.bias_p_len;
  s.y = s.act + a.n_act;
  s.gcv = s.y + kMaxCv;
  s.g0 = s.gcv + kMaxCv;
  s.g1 = s.g0 + a.max_width;
  s.dphi = s.g1 + a.max_width;
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

// Bias energy of the hills ledger at the CVs in `cv` (shared memory) and,
// when `grad` is non-null, its CV gradient into grad[0..n_cv) (shared
// memory, visible after the next barrier): E = sum_h height_h exp(-1/2
// |(cv - c_h)/sigma|^2) over the valid prefix. The gradient takes one more
// pass over the hills a CV, so that no CV-sized array lives in registers.
// Block-wide; the energy is the same in every thread.
__device__ float hills_energy(const Args& a, const float* cv, int n_hills, float* red,
                              float* grad) {
  const int n_cv = a.n_cv;
  float e = 0.0f;
  for (int h = threadIdx.x; h < n_hills; h += blockDim.x) {
    float d2 = 0.0f;
    for (int k = 0; k < n_cv; ++k) {
      const float d = (cv[k] - __ldcg(a.mtd_centers + h * n_cv + k)) * a.mtd_inv_sigma[k];
      d2 += d * d;
    }
    e += __ldcg(a.mtd_heights + h) * expf(-0.5f * d2);
  }
  e = block_sum(e, red);
  if (grad != nullptr) {
    for (int j = 0; j < n_cv; ++j) {
      float g = 0.0f;
      for (int h = threadIdx.x; h < n_hills; h += blockDim.x) {
        float d2 = 0.0f, dj = 0.0f;
        for (int k = 0; k < n_cv; ++k) {
          const float d = (cv[k] - __ldcg(a.mtd_centers + h * n_cv + k)) * a.mtd_inv_sigma[k];
          d2 += d * d;
          dj = k == j ? d : dj;
        }
        g -= __ldcg(a.mtd_heights + h) * expf(-0.5f * d2) * dj * a.mtd_inv_sigma[j];
      }
      g = block_sum(g, red);
      if (threadIdx.x == 0) grad[j] = g;
    }
  }
  return e;
}

// The CV bias at the positions in sx (pallas_md.py _bias_planes): returns
// the bias energy (the same in every thread) and leaves dE/dphi of every
// dihedral in s.dphi for the per-atom scatter; kLedger compiles the hills
// ledger in (the whole-run kernels take the harmonic bias only).
// Block-wide.
template <bool kLedger>
__device__ float bias_energy_and_dphi(const Args& a, const float* sx, const BiasSmem& s,
                                      int n_hills) {
  const int tid = threadIdx.x, T = blockDim.x, M = a.n_dih, n_cv = a.n_cv;
  cv_forward(a, sx, s);
  float e_bias = 0.0f;
  if (kLedger && a.bias_kind == kMetadynamics) {
    e_bias = hills_energy(a, s.y, n_hills, s.red, s.gcv);
  } else {
    for (int k = 0; k < n_cv; ++k) e_bias += a.bias_strength * s.y[k] * s.y[k];
    if (tid < n_cv) s.gcv[tid] = 2.0f * a.bias_strength * s.y[tid];
  }
  __syncthreads();
  // back through the whitening into the gradient of the raw outputs
  const float* w_end = s.P + a.bias_p_len;        // end of the blob
  const float* wmat = w_end - n_cv * n_cv;
  if (tid < n_cv) {
    float acc = s.gcv[tid];
    if (a.use_whiten) {
      acc = 0.0f;
      for (int k = 0; k < n_cv; ++k) acc += s.gcv[k] * wmat[tid * n_cv + k];
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

__device__ __forceinline__ int slot_floats(const Args& a) {
  return kSlotSums * a.n_slots * a.rows + 3 * a.bonded_ld;
}

__device__ __forceinline__ int item_floats(const Args& a) {
  return kPairTabs * a.steps * a.team;
}

// the CTA's dynamic shared memory
__device__ __forceinline__ float* g_smem() {
  extern __shared__ float smem[];
  return smem;
}

// shared memory of one CTA: every position (two buffers, by step parity),
// Born radius, chain factor and the atoms' rho and scaled radius of the
// replica; the reductions; the velocities and forces of the atoms the CTA
// owns; their slots (when in shared memory); its items' tables (when
// staged); then the bias work space. Each array's address is computed from
// the launch arguments where it is used, so that no pointer to it stays
// in a register for the whole launch.
struct Smem {
  __device__ float* sx(const Args& a, int b) const { return g_smem() + 3 * a.n * b; }  // (N, 3)
  __device__ float* sB(const Args& a) const { return g_smem() + 6 * a.n; }             // (N,)
  __device__ float* sChain(const Args& a) const { return g_smem() + 7 * a.n; }         // (N,)
  __device__ float* sr(const Args& a) const { return g_smem() + 8 * a.n; }   // scaled radii
  __device__ float* rho(const Args& a) const { return g_smem() + 9 * a.n; }  // offset radii
  __device__ float* red(const Args& a) const { return g_smem() + 10 * a.n; }           // (32)
  __device__ float* part(const Args& a) const { return red(a) + 32; }                // (4)
  __device__ float* sv(const Args& a) const { return part(a) + 4; }                  // (rows, 3)
  __device__ float* sf(const Args& a) const { return sv(a) + 3 * a.rows; }           // (rows, 3)
  // (kSlotSums, n_slots, rows) + (3, bonded_ld), when a.slots_smem
  __device__ float* slots(const Args& a) const { return sf(a) + 3 * a.rows; }
  // (my_items, kPairTabs, steps, team), when a.staged
  __device__ float* tab(const Args& a) const {
    return slots(a) + (a.slots_smem ? slot_floats(a) : 0);
  }
  // the bias work space (bias_smem carves it)
  __device__ float* bias(const Args& a) const {
    return tab(a) + (a.staged ? a.my_items * item_floats(a) : 0);
  }
};

// Fills what is constant for the launch: the atoms' parameters, this CTA's
// items' tables (when staged) and, in CTA 0, the bias parameters. Visible
// after the next barrier.
__device__ Smem carve_smem(const Args& a, const Ctx& t) {
  const int n = a.n;
  const Smem s{};
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    s.sr(a)[k] = a.atom_p[kSr * n + k];
    s.rho(a)[k] = a.atom_p[kRho * n + k];
  }
  if (a.staged) {
    // this CTA's items m C + rank, m = 0, 1, ...
    const int mine = (a.n_items - t.rank + a.cluster - 1) / a.cluster;
    const int per = item_floats(a);
    float* tab = s.tab(a);
    for (int k = threadIdx.x; k < mine * per; k += blockDim.x) {
      const int m = k / per;
      const size_t src = static_cast<size_t>(m * a.cluster + t.rank) * per + (k - m * per);
      tab[k] = __ldg(a.item_tab + src);
    }
  }
  if (a.bias_kind != kNoBias && t.rank == 0) {
    float* p = s.bias(a);
    for (int k = threadIdx.x; k < a.bias_p_len; k += blockDim.x) p[k] = a.bias_p[k];
  }
  return s;
}

// The slots of CTA `owner`'s atoms: its shared memory, or its part of the
// replica's global scratch
__device__ __forceinline__ float* slot_block(const Args& a, const Smem& s, int owner) {
  if (a.slots_smem) return in_cta(a, s.slots(a), owner);
  const size_t replica = blockIdx.x / a.cluster;
  return a.slot_scratch + (replica * a.cluster + owner) * static_cast<size_t>(slot_floats(a));
}

// writes the K sums of one slot of `atom` (in its owner's slot block)
template <int K>
__device__ __forceinline__ void put_slot(const Args& a, const Smem& s, int rank, int atom,
                                         int slot, const float* v) {
  const int owner = atom / a.rows;
  float* blk = (a.slots_smem && owner == rank) ? s.slots(a) : slot_block(a, s, owner);
  const int local = atom - owner * a.rows;
#pragma unroll
  for (int c = 0; c < K; ++c) blk[(c * a.n_slots + slot) * a.rows + local] = v[c];
}

// Sum K of this thread's atom's slots, the atom team's lanes taking slots
// lane, lane + L, ... and meeting by xor shuffles: the same order every
// evaluation. Every lane of the warp must call it.
template <int K>
__device__ __forceinline__ void fold_slots(const Args& a, const Smem& s, const Ctx& t,
                                           float* out) {
  const float* blk = a.slots_smem ? s.slots(a) : slot_block(a, s, t.rank);
  const int local = t.i - t.row0;
#pragma unroll
  for (int c = 0; c < K; ++c) {
    float acc = 0.0f;
    if (t.own) {
      for (int q = t.lane; q < a.n_slots; q += a.lanes) {
        const float* p = blk + (c * a.n_slots + q) * a.rows + local;
        acc += a.slots_smem ? *p : __ldcg(p);
      }
    }
    out[c] = team_sum(acc, a.lanes);
  }
}

// Special functions as single special-function-unit results (PTX .approx,
// flush-to-zero; the arguments are positive and far from denormal), as the
// pair sweeps' gb_force.cuh takes them: IEEE division, sqrtf and expf are
// multi-instruction sequences on each pair's chain. The HCT logarithm stays
// IEEE logf.
__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rsqrt_approx(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// exp(-x) for x >= 0
__device__ __forceinline__ float exp_neg_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(-1.4426950408889634f * x));
  return y;
}

// The HCT term and dH/dr (md/pair_force.py _hct) with no branch: the
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
  const float inv_L = rcp_approx(L);
  const float inv_U = rcp_approx(u_raw);
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
  h = engulfed ? h + 2.0f * (rcp_approx(rho_i) - inv_L) : h;
  dh = engulfed ? dh + 2.0f * dL * inv_L * inv_L : dh;
  const bool active = !(u_raw <= rho_i);
  *H = active ? h : 0.0f;
  *dH = active ? dh : 0.0f;
}

// displacement from atom j to the row atom, their distance and its inverse
// (one rsqrt.approx and a Newton step: 1/r^12 of the LJ energy magnifies
// its error twelvefold)
__device__ __forceinline__ float pair_geometry(const float* sx, const float xi[3], int j,
                                               float d[3], float* inv_r) {
  float xj[3];
  load3(sx, j, xj);
  for (int c = 0; c < 3; ++c) d[c] = xi[c] - xj[c];
  const float r2 = dot3(d, d) + kEps;
  const float y = rsqrt_approx(r2);
  *inv_r = y * (1.5f - 0.5f * r2 * y * y);
  return r2 * *inv_r;
}

// the GBn2 neck integral and its r-derivative (md/gbn2.py) with
// 1/denom one rcp.approx
__device__ __forceinline__ void neck_fast(float r, float d0, float m0s, float* val, float* dval) {
  const float u = r - d0;
  const float u2 = u * u;
  const float inv_d = rcp_approx(1.0f + 100.0f * u2 + 0.3e6f * u2 * u2 * u2);
  *val = m0s * inv_d;
  *dval = -m0s * (200.0f * u + 1.8e6f * u2 * u2 * u) * (inv_d * inv_d);
}

// What a row atom brings to its pairs in a phase
struct RowAtom {
  float x[3];
  float rho, sr, B, inv_B, chain;
};

// One pair's terms in phase `kPhase`: the row atom's sums in rt, the column
// atom's in ct, its energy added to *e (all zero where `ok` is false; a
// masked pair is computed on valid indices and dropped by selects). `tab`
// points at the pair's first table entry, `tstride` apart.
template <int kPhase>
__device__ __forceinline__ void pair_terms(const Args& a, const Smem& s, const float* sx,
                                           const RowAtom& ri, int j, bool ok, const float* tab,
                                           int tstride, float* rt, float* ct, float* e) {
  float d[3], inv_r;
  const float r = pair_geometry(sx, ri.x, j, d, &inv_r);
  if (kPhase == kBornPhase) {
    float H_ij, H_ji, dH;
    born_pair_sel(r, inv_r, ri.rho, s.sr(a)[j], &H_ij, &dH);
    born_pair_sel(r, inv_r, s.rho(a)[j], ri.sr, &H_ji, &dH);
    float n_ij = 0.0f, n_ji = 0.0f, dn;
    if (a.use_neck) {
      neck_fast(r, tab[kTabD0 * tstride], tab[kTabM0 * tstride], &n_ij, &dn);
      neck_fast(r, tab[kTabD0T * tstride], tab[kTabM0T * tstride], &n_ji, &dn);
    }
    rt[0] = ok ? 0.5f * H_ij + n_ij : 0.0f;
    ct[0] = ok ? 0.5f * H_ji + n_ji : 0.0f;
  } else if (kPhase == kDedbPhase) {
    const float r2 = r * r;
    const float B_j = s.sB(a)[j];
    const float inv_Bj = rcp_approx(B_j);
    const float expu = exp_neg_approx(0.25f * r2 * ri.inv_B * inv_Bj);
    const float inv_f = rsqrt_approx(r2 + ri.B * B_j * expu);
    const float qq = tab[kTabQqFull * tstride];
    const float dEdf = -qq * inv_f * inv_f;
    rt[0] = ok ? dEdf * (expu * (B_j + 0.25f * r2 * ri.inv_B) * (0.5f * inv_f)) : 0.0f;
    ct[0] = ok ? dEdf * (expu * (ri.B + 0.25f * r2 * inv_Bj) * (0.5f * inv_f)) : 0.0f;
    *e += ok ? 2.0f * qq * inv_f : 0.0f;   // both orders of the pair
  } else {
    const float inv_r2 = inv_r * inv_r;
    const float inv_r6 = inv_r2 * inv_r2 * inv_r2;
    const float inv_r12 = inv_r6 * inv_r6;
    const float la = tab[kTabLjA * tstride];
    const float lb = tab[kTabLjB * tstride];
    const float qs = tab[kTabQqScaled * tstride];
    // dE/dr of the LJ + Coulomb pair
    float g = -12.0f * la * inv_r12 * inv_r + 6.0f * lb * inv_r6 * inv_r - qs * inv_r2;
    const float e_pair = la * inv_r12 - lb * inv_r6 + qs * inv_r;
    if (a.use_gb) {
      const float r2 = r * r;
      const float B_j = s.sB(a)[j];
      const float expu = exp_neg_approx(0.25f * r2 * ri.inv_B * rcp_approx(B_j));
      const float inv_f = rsqrt_approx(r2 + ri.B * B_j * expu);
      const float qq = tab[kTabQqFull * tstride];
      // direct GB term at fixed Born radii, both orders
      g += 2.0f * (-qq * inv_f * inv_f) * (r * (1.0f - 0.25f * expu) * inv_f);
      // Born chain: dE/dB_i dB_i/dr_ij + dE/dB_j dB_j/dr_ji
      float H, dH_ij, dH_ji;
      born_pair_sel(r, inv_r, ri.rho, s.sr(a)[j], &H, &dH_ij);
      born_pair_sel(r, inv_r, s.rho(a)[j], ri.sr, &H, &dH_ji);
      float dI_ij = 0.5f * dH_ij, dI_ji = 0.5f * dH_ji;
      if (a.use_neck) {
        float nv, dnv;
        neck_fast(r, tab[kTabD0 * tstride], tab[kTabM0 * tstride], &nv, &dnv);
        dI_ij += dnv;
        neck_fast(r, tab[kTabD0T * tstride], tab[kTabM0T * tstride], &nv, &dnv);
        dI_ji += dnv;
      }
      g += ri.chain * dI_ij + s.sChain(a)[j] * dI_ji;
    }
    const float coef = ok ? g * inv_r : 0.0f;
    for (int c = 0; c < 3; ++c) {
      rt[c] = -coef * d[c];
      ct[c] = coef * d[c];
    }
    *e += ok ? e_pair : 0.0f;
  }
}

// One phase's item sweep over the replica's cluster: every unordered pair
// once, its two atoms' sums to their slots. P steps an iteration (their
// pairs' chains overlap; the sums add in step order either way). Every
// thread of the CTA must call it (the shuffles are warp-wide).
template <int kPhase, int P>
__device__ void pair_sweep(const Args& a, const Smem& s, const float* sx, int rank, float* e) {
  constexpr int K = kPhase == kForcePhase ? 3 : 1;
  const int n = a.n, T = a.team, S = a.steps, half = a.team >> 1;
  const int tpc = blockDim.x / T;
  const int team = threadIdx.x / T, l = threadIdx.x & (T - 1);
  const int stride = a.cluster * tpc;
  const int rounds = (a.n_items + stride - 1) / stride;
  const int per = item_floats(a);
  const int4* items = reinterpret_cast<const int4*>(a.items);
  int4 next = make_int4(0, 0, 0, 0);
  if (team * a.cluster + rank < a.n_items) next = __ldg(items + team * a.cluster + rank);
  for (int rd = 0; rd < rounds; ++rd) {
    const int m = rd * tpc + team;            // the CTA's m-th item
    const int it = m * a.cluster + rank;
    const bool item_ok = it < a.n_items;
    const int4 item = next;                   // the next round's item loads meanwhile
    const int it_next = it + tpc * a.cluster;
    if (rd + 1 < rounds && it_next < a.n_items) next = __ldg(items + it_next);
    const int i = item.x + l;
    const int k0 = item.z & 0xffff;
    const bool diag = (item.z >> 16) != 0;
    const bool row_ok = item_ok && i < n;
    const int iv = row_ok ? i : 0;
    const float* tab = (a.staged ? s.tab(a) + static_cast<size_t>(item_ok ? m : 0) * per
                                 : a.item_tab + static_cast<size_t>(item_ok ? it : 0) * per) + l;
    RowAtom ri;
    load3(sx, iv, ri.x);
    ri.rho = s.rho(a)[iv];
    ri.sr = s.sr(a)[iv];
    ri.B = kPhase == kBornPhase ? 1.0f : s.sB(a)[iv];
    ri.inv_B = rcp_approx(ri.B);
    ri.chain = kPhase == kForcePhase ? s.sChain(a)[iv] : 0.0f;
    float racc[K], cacc[K];
#pragma unroll
    for (int c = 0; c < K; ++c) racc[c] = cacc[c] = 0.0f;
    // P steps an iteration, no more: the registers go to more warps
#pragma unroll 1
    for (int k = 0; k < S; k += P) {
      float rt[P][K], ct[P][K];
#pragma unroll
      for (int u = 0; u < P; ++u) {
        const int kk = k0 + k + u;
        const int j = item.y + ((l + kk) & (T - 1));
        // a diagonal item's last step meets each pair from both sides: half the lanes take it
        const bool ok = row_ok && j < n && (!diag || kk < half || l < half);
        pair_terms<kPhase>(a, s, sx, ri, ok ? j : iv, ok, tab + (k + u) * T, S * T, rt[u], ct[u],
                           e);
      }
#pragma unroll
      for (int u = 0; u < P; ++u) {
#pragma unroll
        for (int c = 0; c < K; ++c) {
          racc[c] += rt[u][c];
          cacc[c] = __shfl_sync(0xffffffffu, cacc[c] + ct[u][c], (l + 1) & (T - 1), T);
        }
      }
    }
    // after S steps lane l holds column (l + k0 + S) mod T
    const int jc = item.y + ((l + k0 + S) & (T - 1));
    if (row_ok) put_slot<K>(a, s, rank, i, item.w & 0xffff, racc);
    if (item_ok && jc < n) put_slot<K>(a, s, rank, jc, item.w >> 16, cacc);
  }
}

// Each bonded term once, over every thread of the cluster: every role's
// force (bonded_term_all) to its incidence's slot, the CSR position of
// (term, role) in the owner's block, after the pair slots; the energy to
// *e. Row 10's two passes (bonded.cu), inside the step.
__device__ void bonded_terms_once(const Args& a, const Smem& s, const float* sx, int rank,
                                  float* e) {
  const int stride = a.cluster * blockDim.x;
  const int total = a.n_terms[0] + a.n_terms[1] + a.n_terms[2];
  for (int q = rank * blockDim.x + threadIdx.x; q < total; q += stride) {
    int type = 0, term = q, inc = 0;
    while (term >= a.n_terms[type]) {
      inc += term_atoms(type) * a.n_terms[type];
      term -= a.n_terms[type];
      ++type;
    }
    float fr[4][3];
    *e += bonded_term_all(a.bonded, sx, type, term, fr);
    const int* idx = type == kBond ? a.bonded.bond_i
                     : type == kAngle ? a.bonded.angle_i : a.bonded.tors_i;
    for (int k = 0; k < term_atoms(type); ++k) {
      const int atom = idx[term_atoms(type) * term + k];
      const int owner = atom / a.rows;
      float* blk = (a.slots_smem && owner == rank) ? s.slots(a) : slot_block(a, s, owner);
      const int local =
          a.bonded_slot[inc + term_atoms(type) * term + k] - a.csr_ptr[owner * a.rows];
      float* out = blk + kSlotSums * a.n_slots * a.rows;
      for (int c = 0; c < 3; ++c) out[c * a.bonded_ld + local] = fr[k][c];
    }
  }
}

// `v` into element `k` of `arr` in every CTA of the replica's cluster
__device__ __forceinline__ void put_everywhere(const Args& a, float* arr, int k, float v) {
  for (int q = 0; q < a.cluster; ++q) in_cta(a, arr, q)[k] = v;
}

// Forces on atom t.i at the replica's positions `sx` (into s.sf(a), written by
// the atom team's lead), and this thread's share of the replica's energy
// in *e (pairs, the atom's self terms, bonded terms; thread 0 of CTA 0 also
// carries the bias energy). `sx` must hold every atom's position in every
// CTA, visible after a replica barrier. Every thread of the cluster must
// call it; it ends on a block barrier. `n_hills` is the valid prefix of the
// metadynamics ledger. In a stamped build `st` stamps the boundaries from
// kStSynced on.
template <int kBias, int P STAMPS_TPARAM>
__device__ void compute_forces(const Args& a, const Smem& s, const Ctx& t, const float* sx,
                               int n_hills, float* e STAMPS_PARAM) {
  const int n = a.n;
  const float* atom_p = a.atom_p;
  float energy = 0.0f;
  if (kBias && t.rank == 0) {
    const float e_bias =
        bias_energy_and_dphi<kBias == kAnyBias>(a, sx, bias_smem(a, s.bias(a)), n_hills);
    if (threadIdx.x == 0) energy += e_bias;
    // dE/dphi into the other CTAs, visible after the next barrier
    for (int k = threadIdx.x; k < (a.cluster - 1) * a.n_dih; k += blockDim.x) {
      const int q = 1 + k / a.n_dih, d = k % a.n_dih;
      float* dphi = bias_smem(a, s.bias(a)).dphi;
      in_cta(a, dphi, q)[d] = dphi[d];
    }
  }
  STAMP(kStBiasDone);

  if (a.use_gb) {
    // --- phase 1: Born radius of atom i ---
    pair_sweep<kBornPhase, P>(a, s, sx, t.rank, &energy);
    STAMP(kStBornSwept);
    replica_sync(a);
    STAMP(kStBornSynced);
    float I;
    fold_slots<1>(a, s, t, &I);
    STAMP(kStBornFolded);
    float B_i = 1.0f, dB_dpsi = 0.0f, rho_i = 0.0f;
    if (t.own) {
      rho_i = s.rho(a)[t.i];
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
      if (t.lane == 0) put_everywhere(a, s.sB(a), t.i, B_i);
    }
    STAMP(kStBornPut);
    replica_sync(a);
    STAMP(kStDedbStart);
    // --- phase 2: dE/dB_i and the chain factor of atom i ---
    pair_sweep<kDedbPhase, P>(a, s, sx, t.rank, &energy);
    STAMP(kStDedbSwept);
    replica_sync(a);
    STAMP(kStDedbSynced);
    float acc;
    fold_slots<1>(a, s, t, &acc);
    STAMP(kStDedbFolded);
    if (t.own) {
      const float q_i = __ldg(atom_p + kQ * n + t.i);
      const float sa_i = __ldg(atom_p + kSa * n + t.i);
      const float inv_B = 1.0f / B_i;
      const float inv_B2 = inv_B * inv_B;
      const float inv_B6 = inv_B2 * inv_B2 * inv_B2;
      const float dEdB =
          2.0f * acc - a.gb_pref * q_i * q_i * inv_B2 - 6.0f * sa_i * inv_B6 * inv_B;
      if (t.lane == 0) {
        put_everywhere(a, s.sChain(a), t.i, dEdB * dB_dpsi * rho_i);
        energy += a.gb_pref * q_i * q_i * inv_B + sa_i * inv_B6;
      }
    }
    STAMP(kStChainPut);
    replica_sync(a);
    STAMP(kStForceStart);
  }
  STAMP_NO_GB(a);

  // --- phase 3: pair forces and bonded terms, each once ---
  pair_sweep<kForcePhase, P>(a, s, sx, t.rank, &energy);
  bonded_terms_once(a, s, sx, t.rank, &energy);
  STAMP(kStForceSwept);
  replica_sync(a);
  STAMP(kStForceSynced);
  float f[3];
  fold_slots<3>(a, s, t, f);
  float fb[3] = {0.0f, 0.0f, 0.0f};
  if (t.own) {
    const int L = a.lanes;
    // the atom's incidences in CSR order, lane-strided
    const float* blk = (a.slots_smem ? s.slots(a) : slot_block(a, s, t.rank))
                       + kSlotSums * a.n_slots * a.rows;
    const int base = a.csr_ptr[t.row0];
    for (int q = a.csr_ptr[t.i] + t.lane; q < a.csr_ptr[t.i + 1]; q += L) {
      for (int c = 0; c < 3; ++c) {
        const float* p = blk + c * a.bonded_ld + (q - base);
        fb[c] += a.slots_smem ? *p : __ldcg(p);
      }
    }
    // thread 0 of every CTA owns an atom (a CTA owns at least one)
    STAMP(kStFolded);
    if (kBias) {
      const BiasSmem b = bias_smem(a, s.bias(a));
      for (int q = a.dih_ptr[t.i] + t.lane; q < a.dih_ptr[t.i + 1]; q += L) {
        bias_atom_force(a, sx, b, a.dih_ent[2 * q], a.dih_ent[2 * q + 1], fb);
      }
    }
  }
  STAMP(kStBiasForced);
  for (int c = 0; c < 3; ++c) {
    f[c] += team_sum(fb[c], a.lanes);
    if (t.lead) s.sf(a)[3 * (t.i - t.row0) + c] = f[c];
  }
  *e = energy;
  STAMP(kStWritten);
  __syncthreads();
  STAMP(kStEnd);
}

// one folded-BAOAB step of atom t.i from the forces of the last evaluation
// (its lead integrates the velocity in s.sv(a) and the position in buffer buf,
// and writes the new position into buffer buf ^ 1 of every CTA), then the
// evaluation at the new positions: its forces and energy serve the next
// step and the frame. In a stamped build `st` stamps the step's boundaries.
template <int kBias, int P STAMPS_TPARAM>
__device__ __forceinline__ void md_step(const Args& a, const Smem& s, const Ctx& t, int n_hills,
                                        uint32_t seed, uint32_t key1, unsigned long long step,
                                        float inv_m, float sigma, int* buf,
                                        float* e STAMPS_PARAM) {
  STAMP(kStStart);
  if (t.lead) {
    float z[3];
    gaussian3(seed, key1, step, static_cast<uint32_t>(t.i), z);
    float* v = s.sv(a) + 3 * (t.i - t.row0);
    const float* f = s.sf(a) + 3 * (t.i - t.row0);
    for (int c = 0; c < 3; ++c) {
      float vc = v[c] + a.dt * f[c] * inv_m;     // B(dt): folded full kick
      float xc = s.sx(a, *buf)[3 * t.i + c] + a.half_dt * vc;   // A(dt/2)
      vc = a.c1 * vc + sigma * z[c];             // O
      xc = xc + a.half_dt * vc;                  // A(dt/2)
      v[c] = vc;
      put_everywhere(a, s.sx(a, *buf ^ 1), 3 * t.i + c, xc);
    }
  }
  *buf ^= 1;
  STAMP(kStMoved);
  replica_sync(a);
  STAMP(kStSynced);
  compute_forces<kBias, P>(a, s, t, s.sx(a, *buf), n_hills, e STAMPS_ARG);
}

#ifdef PMARLO_FUSED_MD_STAMPED
// The stamps of the sampled step of report block `block`, written by thread
// 0 of CTA rank 0 of the replica's cluster
__device__ __forceinline__ Stamps step_stamps(const Args& a, const Ctx& t, size_t block) {
  Stamps st = {nullptr};
  if (t.rank == 0 && threadIdx.x == 0) {
    const size_t blocks = static_cast<size_t>(a.n_attempts) * a.frames_per_attempt;
    st.p = a.stamps + ((blockIdx.x / a.cluster) * blocks + block) * kStampBoundaries;
  }
  return st;
}
#endif

// After a deposit window: CTA 0 adds one hill per replica, in replica
// order, each against the ledger that already holds the earlier ones
// (pallas_md.py fully-fused mode). A full ledger takes no more hills.
__device__ void deposit_hills(const Args& a, const Smem& s) {
  const int n_cv = a.n_cv;
  const int n_replicas = static_cast<int>(gridDim.x) / a.cluster;
  const BiasSmem b = bias_smem(a, s.bias(a));
  for (int r = 0; r < n_replicas; ++r) {
    const int count = __ldcg(a.mtd_count);
    if (threadIdx.x < n_cv) b.gcv[threadIdx.x] = __ldcg(a.cv_buf + r * n_cv + threadIdx.x);
    __syncthreads();
    float h_new = a.mtd_height;
    if (a.mtd_kb_dt > 0.0f) {
      const float v_here = hills_energy(a, b.gcv, count, b.red, nullptr);
      h_new = a.mtd_height * expf(-v_here / a.mtd_kb_dt);
    }
    if (threadIdx.x == 0 && count < a.mtd_capacity) {
      for (int k = 0; k < n_cv; ++k) a.mtd_centers[count * n_cv + k] = b.gcv[k];
      a.mtd_heights[count] = h_new;
      *a.mtd_count = count + 1;
      __threadfence();
    }
    __syncthreads();
  }
}

// After a deposit window: every replica publishes its CVs at the positions
// in sx, the grid meets, CTA 0 of replica 0 deposits (deposit_hills), the
// grid meets again; returns the ledger's new count.
__device__ __forceinline__ int deposit_window(const Args& a, const Smem& s, int rank, int r,
                                           const float* sx) {
  cg::grid_group grid = cg::this_grid();
  if (rank == 0) {
    const BiasSmem b = bias_smem(a, s.bias(a));
    cv_forward(a, sx, b);
    if (threadIdx.x < a.n_cv) a.cv_buf[r * a.n_cv + threadIdx.x] = b.y[threadIdx.x];
  }
  grid.sync();
  if (blockIdx.x == 0) deposit_hills(a, s);
  grid.sync();
  return __ldcg(a.mtd_count);
}

// Loads replica `r`'s positions into buffer 0 of this CTA (every atom) and
// meets the other CTAs of the cluster, which must all have started before
// any writes into another's shared memory.
__device__ __forceinline__ void load_positions(const Args& a, const Smem& s, size_t rbase) {
  for (int k = threadIdx.x; k < 3 * a.n; k += blockDim.x) s.sx(a, 0)[k] = a.x[rbase + k];
  replica_sync(a);
}

template <int kBias, int P>
__device__ __forceinline__ void chunk_body(const Args& a) {
  const int n = a.n;
  const Ctx t = make_ctx(a);
  const Smem s = carve_smem(a, t);
  const int r = blockIdx.x / a.cluster;
  const size_t rbase = static_cast<size_t>(r) * n * 3;
  const size_t base = rbase + static_cast<size_t>(t.i) * 3;
  float* sv = s.sv(a) + 3 * (t.i - t.row0);
  const float* sf = s.sf(a) + 3 * (t.i - t.row0);

  float inv_m = 0.0f, sigma = 0.0f;
  if (t.lead) {
    for (int c = 0; c < 3; ++c) sv[c] = a.v[base + c];
    inv_m = a.atom_p[kInvM * n + t.i];
    sigma = sqrtf(a.c2sq * a.kT[r] * inv_m);
  }
  const uint32_t seed = static_cast<uint32_t>(a.seeds[r]);
  load_positions(a, s, rbase);

  int n_hills = (a.bias_kind == kMetadynamics) ? __ldcg(a.mtd_count) : 0;
  int buf = 0;
  float e_lane;
  compute_forces<kBias, P>(a, s, t, s.sx(a, 0), n_hills, &e_lane);
  if (kBias && a.mtd_interval > 0) {
    // fused metadynamics: deposit windows inside the launch
    const int n_windows = a.n_steps / a.mtd_interval;
    for (int w = 0; w < n_windows; ++w) {
      for (int k = 0; k < a.mtd_interval; ++k) {
        md_step<kBias, P>(a, s, t, n_hills, seed, static_cast<uint32_t>(r),
                          a.step_offset + static_cast<unsigned long long>(w) * a.mtd_interval + k,
                          inv_m, sigma, &buf, &e_lane);
      }
      n_hills = deposit_window(a, s, t.rank, r, s.sx(a, buf));
      // the next window's forces (and the final energy) under the new ledger
      compute_forces<kBias, P>(a, s, t, s.sx(a, buf), n_hills, &e_lane);
    }
  } else {
    for (int k = 0; k < a.n_steps; ++k) {
      md_step<kBias, P>(a, s, t, n_hills, seed, static_cast<uint32_t>(r), a.step_offset + k,
                        inv_m, sigma, &buf, &e_lane);
    }
  }

  if (t.lead) {
    for (int c = 0; c < 3; ++c) {
      a.x[base + c] = s.sx(a, buf)[3 * t.i + c];
      a.v[base + c] = sv[c];
      if (a.forces != nullptr) a.forces[base + c] = sf[c];
    }
  }
  const float e_cta = block_sum(e_lane, s.red(a));
  const float e_total = replica_sum2(a, s.part(a), e_cta, 0.0f).x;
  if (t.rank == 0 && threadIdx.x == 0) a.energy[r] = e_total;
  replica_sync(a);   // no CTA leaves while another may still read its shared memory
}

// Whole REMD run in one launch (pallas_md.py build_pallas_remd). Cluster c
// holds the configuration that starts on rung c and follows it from rung
// to rung; x/v/seeds/ids come in and go out rung-major.
template <int kBias, int P>
__device__ __forceinline__ void remd_body(const Args& a) {
  const int n = a.n;
  const int R = static_cast<int>(gridDim.x) / a.cluster;
  const Ctx t = make_ctx(a);
  const Smem s = carve_smem(a, t);
  const bool head = t.rank == 0 && threadIdx.x == 0;   // writes the replica's scalars
  int rung = blockIdx.x / a.cluster;
  float* sv = s.sv(a) + 3 * (t.i - t.row0);

  const size_t rbase = static_cast<size_t>(rung) * n * 3;
  float inv_m = 0.0f;
  if (t.lead) {
    for (int c = 0; c < 3; ++c) sv[c] = a.v[rbase + 3 * t.i + c];
    inv_m = a.atom_p[kInvM * n + t.i];
  }
  load_positions(a, s, rbase);

  cg::grid_group grid = cg::this_grid();
  int steps_done = 0;   // the step's index is a.step_offset + steps_done
  int buf = 0;
  float e_lane;
  compute_forces<kBias, P>(a, s, t, s.sx(a, 0), 0, &e_lane);
  for (int att = 0; att < a.n_attempts; ++att) {
    float energy = 0.0f;
    for (int j = 0; j < a.frames_per_attempt; ++j) {
      const float sigma = t.lead ? sqrtf(a.c2sq * a.kT[rung] * inv_m) : 0.0f;
      for (int k = 0; k < a.report_interval; ++k, ++steps_done) {
        // the configuration's seed and identity stay with it: read where used
#ifdef PMARLO_FUSED_MD_STAMPED
        // the sampled step of the block (k is the same in every thread)
        if (k == a.report_interval / 2) {
          md_step<kBias, P>(a, s, t, 0, static_cast<uint32_t>(a.seeds[blockIdx.x / a.cluster]),
                            static_cast<uint32_t>(rung), a.step_offset + steps_done, inv_m,
                            sigma, &buf, &e_lane,
                            step_stamps(a, t, static_cast<size_t>(att) * a.frames_per_attempt + j));
          continue;
        }
#endif
        md_step<kBias, P>(a, s, t, 0, static_cast<uint32_t>(a.seeds[blockIdx.x / a.cluster]),
                          static_cast<uint32_t>(rung), a.step_offset + steps_done, inv_m, sigma,
                          &buf, &e_lane);
      }
      // the frame's energy is the last evaluation's, at these positions
      float ke = 0.0f;
      if (t.lead) {
        const float m = inv_m > 0.0f ? 1.0f / inv_m : 0.0f;
        ke = 0.5f * m * (sv[0] * sv[0] + sv[1] * sv[1] + sv[2] * sv[2]);
      }
      const float2 cta = block_sum2(e_lane, ke, s.red(a));
      const float2 tot = replica_sum2(a, s.part(a), cta.x, cta.y);
      energy = tot.x;
      const size_t slot = static_cast<size_t>(att) * a.frames_per_attempt + j;
      if (t.lead) {
        const size_t fb = ((slot * R + rung) * n + t.i) * 3;
        for (int c = 0; c < 3; ++c) a.frames[fb + c] = s.sx(a, buf)[3 * t.i + c];
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
      if (t.lead) {
        for (int c = 0; c < 3; ++c) sv[c] *= scale;
      }
      rung = partner;
    }
    if (head) {
      a.ids_hist[static_cast<size_t>(att + 1) * R + rung] = a.ids0[blockIdx.x / a.cluster];
    }
  }
  if (t.lead) {
    const size_t b = (static_cast<size_t>(rung) * n + t.i) * 3;
    for (int c = 0; c < 3; ++c) {
      a.x_out[b + c] = s.sx(a, buf)[3 * t.i + c];
      a.v_out[b + c] = sv[c];
    }
  }
  if (head) a.seeds_out[rung] = a.seeds[blockIdx.x / a.cluster];
  replica_sync(a);   // no CTA leaves while another may still read its shared memory
}

}  // namespace
