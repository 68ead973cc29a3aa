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
// replica in three dependent GB phases, and 32 replicas fill 32 of the 132
// SMs with one warp each. Every step needs three block-wide barriers, so
// the design keeps each replica inside one CTA and the whole K-step loop
// inside the kernel (one launch per exchange window instead of ~100 small
// kernels per step in the plain PyTorch twin).
//
// Design:
// - one CTA per replica, one thread per atom (N <= 512: ptxas gives the
//   kernel ~90 registers a thread, and 512 such threads fit the SM's 64K
//   register file; a block that does not fit fails to launch, and the
//   wrapper raises). Positions, Born
//   radii and the Born chain factors live in shared memory; velocities and
//   forces in registers of the owning thread.
// - the (N, N) tables (lj_a, lj_b, qq_scaled, qq_full, neck_d0, neck_m0)
//   are read from global memory; all replicas share them through L1/L2.
// - GB per step, separated by __syncthreads():
//     1. Born integral I_i = sum_j H_ij (+ neck) -> B_i, dB_i/dpsi_i
//     2. dE/dB_i = sum_j ... -> chain_i = dE/dB_i dB_i/dpsi_i rho_i
//     3. pair forces, row-owned: thread i sums over j, including both
//        chain_i dI_i/dr_ij and chain_j dI_j/dr_ji, so no atomics.
// - bonded terms are row-owned too: each atom walks a CSR list of the
//   (term, role) pairs it takes part in and recomputes the term. No
//   atomics anywhere, so a launch is bit-reproducible run to run.
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
//   the block computes M dihedrals (cos/sin without atan2), standardises
//   them, runs the tanh MLP with one thread per output unit (striding when
//   the block is narrower than a layer), whitens, takes E = k sum cv^2 or
//   the sum over the hills ledger, and back-propagates by hand to
//   dE/dphi. Each atom then walks a CSR list of the (role, dihedral) pairs
//   it takes part in, so the scatter needs no atomics. The weights and all
//   activations live in shared memory; the hills ledger is read from global
//   memory (L2) with a fixed-order block reduction.
// - fused metadynamics (build_pallas_chunk, mtd_deposit_interval): after
//   every deposit window each CTA publishes its CVs, the grid meets at a
//   barrier, CTA 0 deposits the R hills serially in replica order (each
//   sees the earlier ones), and a second barrier releases the next window.
// - fused REMD (build_pallas_remd): each CTA keeps its configuration for
//   the whole run and carries its RUNG (temperature, frame slot, noise
//   key); a swap exchanges the rung assignments of two CTAs after one grid
//   barrier on a double-buffered energy array, so no coordinates move
//   between CTAs. Outputs are rung-major, as the windowed path writes them.
// - the grid barrier is cooperative_groups' this_grid().sync(), which
//   also orders the CTAs' global writes before the reads that follow it;
//   the kernels that use it are launched with cudaLaunchCooperativeKernel,
//   which refuses a grid whose CTAs cannot all be resident. Data that
//   crosses CTAs is read with __ldcg (L2), never through the non-coherent
//   path.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gb_pair.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxAtoms = 512;
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
enum TermType { kBond = 0, kAngle = 1, kTorsion = 2 };

struct Args {
  float* x;                 // (R, N, 3) in/out
  float* v;                 // (R, N, 3) in/out
  float* energy;            // (R,) out: energy at the final positions
  float* forces;            // (R, N, 3) out, or null
  const int* seeds;         // (R,)
  const float* kT;          // (R,) kB * T per replica
  const float* atom_p;      // (kAtomRows, N)
  const float* pair_p;      // (kPairTables, N, N)
  const int* bond_i;        // (NB, 2)
  const float* bond_p;      // (NB, 2): k, r0
  const int* angle_i;       // (NA, 3)
  const float* angle_p;     // (NA, 2): k, theta0
  const int* tors_i;        // (NT, 4)
  const float* tors_p;      // (NT, 3): k, n, phase
  const int* csr_ptr;       // (N + 1,)
  const int* csr_ent;       // (M, 2): (type << 2 | role, term)
  int n;
  int n_steps;
  unsigned long long step_offset;
  float dt, half_dt, c1, c2sq, gb_pref;
  int use_gb, use_neck;
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

__device__ __forceinline__ float dot3(const float a[3], const float b[3]) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

__device__ __forceinline__ void cross3(const float a[3], const float b[3], float c[3]) {
  c[0] = a[1] * b[2] - a[2] * b[1];
  c[1] = a[2] * b[0] - a[0] * b[2];
  c[2] = a[0] * b[1] - a[1] * b[0];
}

__device__ __forceinline__ void load3(const float* sx, int atom, float p[3]) {
  p[0] = sx[3 * atom];
  p[1] = sx[3 * atom + 1];
  p[2] = sx[3 * atom + 2];
}

// force on the atom in `role` of bonded term `term`; energy when role == 0
__device__ void bonded_term(const Args& a, const float* sx, int type, int role, int term,
                            float f[3], float* e) {
  if (type == kBond) {
    float p1[3], p2[3], d[3];
    load3(sx, a.bond_i[2 * term], p1);
    load3(sx, a.bond_i[2 * term + 1], p2);
    for (int c = 0; c < 3; ++c) d[c] = p1[c] - p2[c];
    const float k = a.bond_p[2 * term], r0 = a.bond_p[2 * term + 1];
    const float r = sqrtf(dot3(d, d) + kEps);
    const float dr = r - r0;
    const float s = (role == 0 ? -1.0f : 1.0f) * k * dr / r;
    for (int c = 0; c < 3; ++c) f[c] += s * d[c];
    if (role == 0) *e += 0.5f * k * dr * dr;
  } else if (type == kAngle) {
    float pi[3], pj[3], pk[3], u[3], w[3];
    load3(sx, a.angle_i[3 * term], pi);
    load3(sx, a.angle_i[3 * term + 1], pj);
    load3(sx, a.angle_i[3 * term + 2], pk);
    for (int c = 0; c < 3; ++c) {
      u[c] = pi[c] - pj[c];
      w[c] = pk[c] - pj[c];
    }
    const float k = a.angle_p[2 * term], t0 = a.angle_p[2 * term + 1];
    const float lu = sqrtf(dot3(u, u) + kEps);
    const float lw = sqrtf(dot3(w, w) + kEps);
    float nu[3], nw[3];
    for (int c = 0; c < 3; ++c) {
      nu[c] = u[c] / lu;
      nw[c] = w[c] / lw;
    }
    const float cos_t = fminf(fmaxf(dot3(nu, nw), -1.0f + 1e-7f), 1.0f - 1e-7f);
    const float theta = acosf(cos_t);
    const float sin_t = sqrtf(1.0f - cos_t * cos_t);
    const float dE = k * (theta - t0);
    float fi[3], fk[3];
    for (int c = 0; c < 3; ++c) {
      fi[c] = -dE * (cos_t * nu[c] - nw[c]) / (lu * sin_t);
      fk[c] = -dE * (cos_t * nw[c] - nu[c]) / (lw * sin_t);
    }
    for (int c = 0; c < 3; ++c) {
      f[c] += role == 0 ? fi[c] : (role == 2 ? fk[c] : -(fi[c] + fk[c]));
    }
    if (role == 0) *e += 0.5f * k * (theta - t0) * (theta - t0);
  } else {
    float x1[3], x2[3], x3[3], x4[3], b1[3], b2[3], b3[3], m[3], n[3], mn[3];
    load3(sx, a.tors_i[4 * term], x1);
    load3(sx, a.tors_i[4 * term + 1], x2);
    load3(sx, a.tors_i[4 * term + 2], x3);
    load3(sx, a.tors_i[4 * term + 3], x4);
    for (int c = 0; c < 3; ++c) {
      b1[c] = x2[c] - x1[c];
      b2[c] = x3[c] - x2[c];
      b3[c] = x4[c] - x3[c];
    }
    cross3(b1, b2, m);
    cross3(b2, b3, n);
    const float lb2 = sqrtf(dot3(b2, b2) + kEps);
    const float m2 = dot3(m, m) + kEps;
    const float n2 = dot3(n, n) + kEps;
    // IUPAC sign: phi = atan2((m x n) . b2 / |b2|, m . n)
    cross3(m, n, mn);
    const float yy = dot3(mn, b2) / lb2;
    const float xx = dot3(m, n);
    const float phi = atan2f(yy, xx);
    const float k = a.tors_p[3 * term], per = a.tors_p[3 * term + 1];
    const float phase = a.tors_p[3 * term + 2];
    const float arg = per * phi - phase;
    const float dE = -k * per * sinf(arg);
    const float s12 = dot3(b1, b2) / (lb2 * lb2);
    const float s32 = dot3(b3, b2) / (lb2 * lb2);
    for (int c = 0; c < 3; ++c) {
      const float d1 = -(lb2 / m2) * m[c];
      const float d4 = (lb2 / n2) * n[c];
      float d;
      if (role == 0) d = d1;
      else if (role == 1) d = -(1.0f + s12) * d1 + s32 * d4;
      else if (role == 2) d = s12 * d1 - (1.0f + s32) * d4;
      else d = d4;
      f[c] += -dE * d;
    }
    if (role == 0) *e += k * (1.0f + cosf(arg));
  }
}

// Sum of `v` over the block, the same value in every thread. Fixed order
// (xor shuffles, then the warps' partials in sequence), so a launch is
// reproducible. Every thread of the block must call it.
__device__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  __syncthreads();
  float s = 0.0f;
  const int n_warps = blockDim.x >> 5;
  for (int w = 0; w < n_warps; ++w) s += red[w];
  __syncthreads();
  return s;
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
    for (int j = tid; j < n_out; j += T) {
      float acc = b[j];
      for (int k = 0; k < n_in; ++k) acc += h[k] * w[k * n_out + j];
      h_out[j] = (l < a.n_layers - 1) ? tanhf(acc) : acc;
    }
    __syncthreads();
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
    for (int k = tid; k < n_in; k += T) {
      float acc = 0.0f;
      // start at column k: threads of a warp then read different banks
      int j = k % n_out;
      for (int jj = 0; jj < n_out; ++jj) {
        acc += cur[j] * w[k * n_out + j];
        if (++j == n_out) j = 0;
      }
      // the input of layer l >= 1 is a tanh output: fold its derivative in
      if (l > 0) acc *= 1.0f - h_in[k] * h_in[k];
      nxt[k] = acc;
    }
    __syncthreads();
    float* t = cur;
    cur = nxt;
    nxt = t;
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

// Forces on atom i (thread i) at the positions in sx; the energy share of
// atom i when `e` is non-null (thread 0 also carries the bias energy).
// Every thread of the block must call it: it holds the block-wide barriers
// between the GB phases and ends with one, so callers may overwrite sx
// afterwards. `n_hills` is the valid prefix of the metadynamics ledger.
template <bool kBias>
__device__ void compute_forces(const Args& a, const float* sx, float* sB, float* sChain,
                               const BiasSmem& bs, int n_hills,
                               int i, bool own, float f[3], float* e) {
  const int n = a.n;
  const float* atom_p = a.atom_p;
  const float* lj_a = a.pair_p + kLjA * n * n;
  const float* lj_b = a.pair_p + kLjB * n * n;
  const float* qq_s = a.pair_p + kQqScaled * n * n;
  const float* qq_f = a.pair_p + kQqFull * n * n;
  const float* nk_d0 = a.pair_p + kNeckD0 * n * n;
  const float* nk_m0 = a.pair_p + kNeckM0 * n * n;
  float xi[3] = {0.0f, 0.0f, 0.0f};
  if (own) load3(sx, i, xi);
  f[0] = f[1] = f[2] = 0.0f;
  float energy = 0.0f;
  float rho_i = 0.0f, sr_i = 0.0f, B_i = 1.0f;
  if (kBias) {
    const float e_bias = bias_energy_and_dphi(a, sx, bs, n_hills);
    if (i == 0) energy += e_bias;
  }

  if (a.use_gb) {
    // --- phase 1: Born radius of atom i ---
    float dB_dpsi = 0.0f;
    if (own) {
      rho_i = __ldg(atom_p + kRho * n + i);
      sr_i = __ldg(atom_p + kSr * n + i);
      float I = 0.0f, I_neck = 0.0f;
      for (int j = 0; j < n; ++j) {
        if (j == i) continue;
        float xj[3], d[3];
        load3(sx, j, xj);
        for (int c = 0; c < 3; ++c) d[c] = xi[c] - xj[c];
        const float r = sqrtf(dot3(d, d) + kEps);
        float H, dH;
        born_pair(r, 1.0f / r, rho_i, __ldg(atom_p + kSr * n + j), &H, &dH);
        I += H;
        if (a.use_neck) {
          float nv, dnv;
          neck_pair(r, __ldg(nk_d0 + i * n + j), __ldg(nk_m0 + i * n + j), &nv, &dnv);
          I_neck += nv;
        }
      }
      I = 0.5f * I + I_neck;
      const float al = __ldg(atom_p + kAlpha * n + i);
      const float be = __ldg(atom_p + kBeta * n + i);
      const float ga = __ldg(atom_p + kGamma * n + i);
      const float radii = __ldg(atom_p + kRadii * n + i);
      const float psi = I * rho_i;
      const float g = al * psi - be * psi * psi + ga * psi * psi * psi;
      const float t = tanhf(g);
      const float inv_B_raw = 1.0f / rho_i - t / radii;
      const bool clamped = inv_B_raw < 1e-3f;
      B_i = 1.0f / fmaxf(inv_B_raw, 1e-3f);
      const float gprime = al - 2.0f * be * psi + 3.0f * ga * psi * psi;
      dB_dpsi = clamped ? 0.0f : B_i * B_i * (1.0f - t * t) * gprime / radii;
      sB[i] = B_i;
    }
    __syncthreads();
    // --- phase 2: dE/dB_i and the chain factor of atom i ---
    if (own) {
      const float q_i = __ldg(atom_p + kQ * n + i);
      const float sa_i = __ldg(atom_p + kSa * n + i);
      float acc = 0.0f, e_cross = 0.0f;
      for (int j = 0; j < n; ++j) {
        if (j == i) continue;
        float xj[3], d[3];
        load3(sx, j, xj);
        for (int c = 0; c < 3; ++c) d[c] = xi[c] - xj[c];
        const float r = sqrtf(dot3(d, d) + kEps);
        const float r2 = r * r;
        const float B_j = sB[j];
        const float BB = B_i * B_j;
        const float expu = expf(-r2 / (4.0f * BB));
        const float inv_f = 1.0f / sqrtf(r2 + BB * expu);
        const float qq = __ldg(qq_f + i * n + j);
        const float dEdf = -qq * inv_f * inv_f;
        acc += dEdf * (expu * (B_j + r2 / (4.0f * B_i)) * (0.5f * inv_f));
        e_cross += qq * inv_f;
      }
      const float inv_B = 1.0f / B_i;
      const float inv_B2 = inv_B * inv_B;
      const float inv_B6 = inv_B2 * inv_B2 * inv_B2;
      const float dEdB = 2.0f * acc - a.gb_pref * q_i * q_i * inv_B2 - 6.0f * sa_i * inv_B6 * inv_B;
      sChain[i] = dEdB * dB_dpsi * rho_i;
      energy += e_cross + a.gb_pref * q_i * q_i * inv_B + sa_i * inv_B6;
    }
    __syncthreads();
  }

  // --- phase 3: row-owned pair forces + bonded terms ---
  if (own) {
    const float chain_i = a.use_gb ? sChain[i] : 0.0f;
    float e_nb = 0.0f;
    for (int j = 0; j < n; ++j) {
      if (j == i) continue;
      float xj[3], d[3];
      load3(sx, j, xj);
      for (int c = 0; c < 3; ++c) d[c] = xi[c] - xj[c];
      const float r = sqrtf(dot3(d, d) + kEps);
      const float inv_r = 1.0f / r;
      const float inv_r2 = inv_r * inv_r;
      const float inv_r6 = inv_r2 * inv_r2 * inv_r2;
      const float inv_r12 = inv_r6 * inv_r6;
      const int ij = i * n + j;
      const float la = __ldg(lj_a + ij), lb = __ldg(lj_b + ij), qs = __ldg(qq_s + ij);
      // dE/dr of the (symmetric) LJ + Coulomb pair, summed over both orders
      float g = -12.0f * la * inv_r12 * inv_r + 6.0f * lb * inv_r6 * inv_r - qs * inv_r2;
      e_nb += la * inv_r12 - lb * inv_r6 + qs * inv_r;
      if (a.use_gb) {
        const int ji = j * n + i;
        const float r2 = r * r;
        const float B_j = sB[j];
        const float BB = B_i * B_j;
        const float expu = expf(-r2 / (4.0f * BB));
        const float inv_f = 1.0f / sqrtf(r2 + BB * expu);
        const float qq = __ldg(qq_f + ij);
        // direct GB term at fixed Born radii, both orders
        g += 2.0f * (-qq * inv_f * inv_f) * (r * (1.0f - 0.25f * expu) * inv_f);
        // Born chain: dE/dB_i dB_i/dr_ij + dE/dB_j dB_j/dr_ji
        float H, dH_ij, dH_ji;
        born_pair(r, inv_r, rho_i, __ldg(atom_p + kSr * n + j), &H, &dH_ij);
        born_pair(r, inv_r, __ldg(atom_p + kRho * n + j), sr_i, &H, &dH_ji);
        float dI_ij = 0.5f * dH_ij, dI_ji = 0.5f * dH_ji;
        if (a.use_neck) {
          float nv, dnv;
          neck_pair(r, __ldg(nk_d0 + ij), __ldg(nk_m0 + ij), &nv, &dnv);
          dI_ij += dnv;
          neck_pair(r, __ldg(nk_d0 + ji), __ldg(nk_m0 + ji), &nv, &dnv);
          dI_ji += dnv;
        }
        g += chain_i * dI_ij + sChain[j] * dI_ji;
      }
      const float coef = g * inv_r;
      for (int c = 0; c < 3; ++c) f[c] -= coef * d[c];
    }
    energy += 0.5f * e_nb;
    for (int q = a.csr_ptr[i]; q < a.csr_ptr[i + 1]; ++q) {
      const int code = a.csr_ent[2 * q];
      bonded_term(a, sx, code >> 2, code & 3, a.csr_ent[2 * q + 1], f, &energy);
    }
    if (kBias) {
      for (int q = a.dih_ptr[i]; q < a.dih_ptr[i + 1]; ++q) {
        bias_atom_force(a, sx, bs, a.dih_ent[2 * q], a.dih_ent[2 * q + 1], f);
      }
    }
  }
  if (e != nullptr) *e = energy;
  __syncthreads();
}

// shared memory of one CTA: positions, Born radii, chain factors, the
// energy reduction, then the bias work space
struct Smem {
  float* sx;      // (N, 3)
  float* sB;      // (N,)
  float* sChain;  // (N,)
  float* sRed;    // (blockDim,)
  BiasSmem bias;
};

__device__ Smem carve_smem(const Args& a, float* base) {
  Smem s;
  s.sx = base;
  s.sB = s.sx + 3 * a.n;
  s.sChain = s.sB + a.n;
  s.sRed = s.sChain + a.n;
  s.bias = BiasSmem();
  if (a.bias_kind != kNoBias) {
    s.bias = bias_smem(a, s.sRed + blockDim.x);
    for (int k = threadIdx.x; k < a.bias_p_len; k += blockDim.x) s.bias.P[k] = a.bias_p[k];
  }
  return s;
}

// deterministic tree reduction over the block; the sum in every thread
__device__ float tree_sum(float v, float* sRed) {
  const int i = threadIdx.x;
  sRed[i] = v;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (i < s) sRed[i] += sRed[i + s];
    __syncthreads();
  }
  const float total = sRed[0];
  __syncthreads();
  return total;
}

// one folded-BAOAB step of atom i; ends on a block barrier
template <bool kBias>
__device__ __forceinline__ void md_step(const Args& a, const Smem& s, int n_hills, int i,
                                        bool own, uint32_t seed, uint32_t key1,
                                        unsigned long long step, float inv_m, float sigma,
                                        float x[3], float v[3]) {
  float f[3];
  compute_forces<kBias>(a, s.sx, s.sB, s.sChain, s.bias, n_hills, i, own, f, nullptr);
  if (own) {
    float z[3];
    gaussian3(seed, key1, step, static_cast<uint32_t>(i), z);
    for (int c = 0; c < 3; ++c) {
      v[c] = v[c] + a.dt * f[c] * inv_m;   // B(dt): folded full kick
      x[c] = x[c] + a.half_dt * v[c];      // A(dt/2)
      v[c] = a.c1 * v[c] + sigma * z[c];   // O
      x[c] = x[c] + a.half_dt * v[c];      // A(dt/2)
      s.sx[3 * i + c] = x[c];
    }
  }
  __syncthreads();
}

// After a deposit window: CTA 0 adds one hill per replica, in replica
// order, each against the ledger that already holds the earlier ones
// (pallas_md.py fully-fused mode). A full ledger takes no more hills.
__device__ void deposit_hills(const Args& a, const Smem& s) {
  const int n_cv = a.n_cv;
  for (int r = 0; r < static_cast<int>(gridDim.x); ++r) {
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
  const Smem s = carve_smem(a, smem);
  const int r = blockIdx.x;
  const int i = threadIdx.x;
  const bool own = i < n;
  const size_t base = (static_cast<size_t>(r) * n + i) * 3;

  float x[3] = {0.0f, 0.0f, 0.0f}, v[3] = {0.0f, 0.0f, 0.0f};
  float inv_m = 0.0f, sigma = 0.0f;
  if (own) {
    for (int c = 0; c < 3; ++c) {
      x[c] = a.x[base + c];
      v[c] = a.v[base + c];
      s.sx[3 * i + c] = x[c];
    }
    inv_m = a.atom_p[kInvM * n + i];
    sigma = sqrtf(a.c2sq * a.kT[r] * inv_m);
  }
  const uint32_t seed = static_cast<uint32_t>(a.seeds[r]);
  __syncthreads();

  int n_hills = (a.bias_kind == kMetadynamics) ? __ldcg(a.mtd_count) : 0;
  if (kBias && a.mtd_interval > 0) {
    // fused metadynamics: deposit windows inside the launch
    cg::grid_group grid = cg::this_grid();
    const int n_windows = a.n_steps / a.mtd_interval;
    for (int w = 0; w < n_windows; ++w) {
      for (int k = 0; k < a.mtd_interval; ++k) {
        md_step<kBias>(a, s, n_hills, i, own, seed, static_cast<uint32_t>(r),
                       a.step_offset + static_cast<unsigned long long>(w) * a.mtd_interval + k,
                       inv_m, sigma, x, v);
      }
      cv_forward(a, s.sx, s.bias);
      if (i < a.n_cv) a.cv_buf[r * a.n_cv + i] = s.bias.y[i];
      grid.sync();
      if (r == 0) deposit_hills(a, s);
      grid.sync();
      n_hills = __ldcg(a.mtd_count);
    }
  } else {
    for (int k = 0; k < a.n_steps; ++k) {
      md_step<kBias>(a, s, n_hills, i, own, seed, static_cast<uint32_t>(r),
                     a.step_offset + k, inv_m, sigma, x, v);
    }
  }

  float f[3];
  float e_i = 0.0f;
  compute_forces<kBias>(a, s.sx, s.sB, s.sChain, s.bias, n_hills, i, own, f, &e_i);
  if (own) {
    for (int c = 0; c < 3; ++c) {
      a.x[base + c] = x[c];
      a.v[base + c] = v[c];
      if (a.forces != nullptr) a.forces[base + c] = f[c];
    }
  }
  const float e_total = tree_sum((own || i == 0) ? e_i : 0.0f, s.sRed);
  if (i == 0) a.energy[r] = e_total;
}

// Whole REMD run in one launch (pallas_md.py build_pallas_remd). CTA c
// holds the configuration that starts on rung c and follows it from rung
// to rung; x/v/seeds/ids come in and go out rung-major.
template <bool kBias>
__device__ __forceinline__ void remd_body(const Args& a) {
  extern __shared__ float smem[];
  const int n = a.n;
  const int R = gridDim.x;
  const Smem s = carve_smem(a, smem);
  const int i = threadIdx.x;
  const bool own = i < n;
  int rung = blockIdx.x;

  float x[3] = {0.0f, 0.0f, 0.0f}, v[3] = {0.0f, 0.0f, 0.0f};
  float inv_m = 0.0f, mass = 0.0f;
  if (own) {
    const size_t base = (static_cast<size_t>(rung) * n + i) * 3;
    for (int c = 0; c < 3; ++c) {
      x[c] = a.x[base + c];
      v[c] = a.v[base + c];
      s.sx[3 * i + c] = x[c];
    }
    inv_m = a.atom_p[kInvM * n + i];
    mass = inv_m > 0.0f ? 1.0f / inv_m : 0.0f;
  }
  const uint32_t seed = static_cast<uint32_t>(a.seeds[rung]);
  const int id = a.ids0[rung];
  __syncthreads();

  cg::grid_group grid = cg::this_grid();
  unsigned long long step = a.step_offset;
  float f[3];
  for (int att = 0; att < a.n_attempts; ++att) {
    float energy = 0.0f;
    for (int j = 0; j < a.frames_per_attempt; ++j) {
      const float sigma = sqrtf(a.c2sq * a.kT[rung] * inv_m);
      for (int k = 0; k < a.report_interval; ++k, ++step) {
        md_step<kBias>(a, s, 0, i, own, seed, static_cast<uint32_t>(rung), step, inv_m, sigma,
                       x, v);
      }
      float e_i = 0.0f;
      compute_forces<kBias>(a, s.sx, s.sB, s.sChain, s.bias, 0, i, own, f, &e_i);
      energy = tree_sum((own || i == 0) ? e_i : 0.0f, s.sRed);
      const float ke = tree_sum(0.5f * mass * (v[0] * v[0] + v[1] * v[1] + v[2] * v[2]), s.sRed);
      const size_t slot = static_cast<size_t>(att) * a.frames_per_attempt + j;
      if (own) {
        const size_t fb = ((slot * R + rung) * n + i) * 3;
        for (int c = 0; c < 3; ++c) a.frames[fb + c] = x[c];
      }
      if (i == 0) {
        a.frame_e[slot * R + rung] = energy;
        a.frame_ke[slot * R + rung] = ke;
      }
    }
    // --- parity-alternating neighbour swap of rung assignments ---
    float* ebuf = a.swap_e + (att & 1) * R;
    if (i == 0) ebuf[rung] = energy;
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
    if (i == 0) a.accept[static_cast<size_t>(att) * R + rung] = accepted ? 1.0f : 0.0f;
    if (accepted) {
      const float scale = sqrtf(a.ladder[partner] / a.ladder[rung]);
      for (int c = 0; c < 3; ++c) v[c] *= scale;
      rung = partner;
    }
    if (i == 0) a.ids_hist[static_cast<size_t>(att + 1) * R + rung] = id;
  }
  if (own) {
    const size_t base = (static_cast<size_t>(rung) * n + i) * 3;
    for (int c = 0; c < 3; ++c) {
      a.x_out[base + c] = x[c];
      a.v_out[base + c] = v[c];
    }
  }
  if (i == 0) a.seeds_out[rung] = static_cast<int>(seed);
}

// Nothing but `n_barriers` grid barriers: what one barrier costs.
__global__ void grid_barrier_probe_kernel(int n_barriers) {
  cg::grid_group grid = cg::this_grid();
  for (int k = 0; k < n_barriers; ++k) grid.sync();
}

// The unbiased chunk is compiled without the bias code, so that it keeps
// its register count; the other kernels are bounded to kMaxAtoms threads
// a block (128 registers a thread).
__global__ void fused_md_chunk_kernel(Args a) { chunk_body<false>(a); }
__global__ void __launch_bounds__(kMaxAtoms, 1) fused_md_bias_kernel(Args a) {
  chunk_body<true>(a);
}
__global__ void __launch_bounds__(kMaxAtoms, 1) fused_remd_kernel(Args a) {
  remd_body<false>(a);
}
__global__ void __launch_bounds__(kMaxAtoms, 1) fused_remd_bias_kernel(Args a) {
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
  kIAttempts, kIFramesPerAttempt, kIReportInterval, kISwapSeed, kNumIntArgs
};
enum FloatArg {
  kFDt = 0, kFHalfDt, kFC1, kFC2sq, kFGbPref, kFBiasStrength, kFMtdHeight, kFMtdKbDt,
  kFMtdInvSigma0, kNumFloatArgs = kFMtdInvSigma0 + kMaxCv
};
enum Mode { kModeChunk = 0, kModeFusedMtd = 1, kModeFusedRemd = 2 };

int pmarlo_fused_md_max_atoms() { return kMaxAtoms; }

// the sizes of the argument arrays and the bias limits, for the wrapper to
// check against its own: n_ptrs, n_ints, n_floats, max_layers, max_cv
int pmarlo_fused_md_abi(int which) {
  const int v[5] = {kNumPtrArgs, kNumIntArgs, kNumFloatArgs, kMaxLayers, kMaxCv};
  return (which >= 0 && which < 5) ? v[which] : -1;
}

const char* pmarlo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches one kernel on `stream`; returns the CUDA error code of the
// launch (0 = launched). kModeChunk: K steps, optionally biased (ledger as
// input). kModeFusedMtd: the same kernel with deposits inside the launch.
// kModeFusedRemd: the whole REMD run. The last two need every CTA
// resident at once (they meet at grid barriers): they go through
// cudaLaunchCooperativeKernel, and a grid beyond the card's capacity
// returns cudaErrorCooperativeLaunchTooLarge instead of running.
int pmarlo_fused_md_launch(int mode, void* const* ptr, const int* iv, const float* fv,
                           long long step_offset, long long attempt_offset, void* stream) {
  const int n_replicas = iv[kIReplicas], n_atoms = iv[kIAtoms];
  if (n_atoms < 1 || n_atoms > kMaxAtoms || n_replicas < 1 || iv[kISteps] < 0 ||
      iv[kINLayers] > kMaxLayers || iv[kINCv] > kMaxCv) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  a.x = static_cast<float*>(ptr[kPX]);
  a.v = static_cast<float*>(ptr[kPV]);
  a.energy = static_cast<float*>(ptr[kPEnergy]);
  a.forces = static_cast<float*>(ptr[kPForces]);
  a.seeds = static_cast<const int*>(ptr[kPSeeds]);
  a.kT = static_cast<const float*>(ptr[kPKT]);
  a.atom_p = static_cast<const float*>(ptr[kPAtomP]);
  a.pair_p = static_cast<const float*>(ptr[kPPairP]);
  a.bond_i = static_cast<const int*>(ptr[kPBondI]);
  a.bond_p = static_cast<const float*>(ptr[kPBondP]);
  a.angle_i = static_cast<const int*>(ptr[kPAngleI]);
  a.angle_p = static_cast<const float*>(ptr[kPAngleP]);
  a.tors_i = static_cast<const int*>(ptr[kPTorsI]);
  a.tors_p = static_cast<const float*>(ptr[kPTorsP]);
  a.csr_ptr = static_cast<const int*>(ptr[kPCsrPtr]);
  a.csr_ent = static_cast<const int*>(ptr[kPCsrEnt]);
  a.n = n_atoms;
  a.n_steps = iv[kISteps];
  a.step_offset = static_cast<unsigned long long>(step_offset);
  a.dt = fv[kFDt];
  a.half_dt = fv[kFHalfDt];
  a.c1 = fv[kFC1];
  a.c2sq = fv[kFC2sq];
  a.gb_pref = fv[kFGbPref];
  a.use_gb = iv[kIUseGb];
  a.use_neck = iv[kIUseNeck];
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

  // a power of two >= 32, for the tree reduction of the energy
  int threads = 32;
  while (threads < n_atoms) threads *= 2;
  size_t floats = 5 * static_cast<size_t>(n_atoms) + threads;
  if (a.bias_kind != kNoBias) {
    int n_act = 0, max_w = 0;
    for (int l = 0; l <= a.n_layers; ++l) {
      n_act += a.widths[l];
      max_w = max_w > a.widths[l] ? max_w : a.widths[l];
    }
    floats += a.bias_p_len + n_act + kMaxCv + 2 * max_w + 3 * a.n_dih + 32;
  }
  const size_t shmem = floats * sizeof(float);
  const bool biased = a.bias_kind != kNoBias;
  const void* kernel =
      (mode == kModeFusedRemd)
          ? (biased ? reinterpret_cast<const void*>(fused_remd_bias_kernel)
                    : reinterpret_cast<const void*>(fused_remd_kernel))
          : (biased ? reinterpret_cast<const void*>(fused_md_bias_kernel)
                    : reinterpret_cast<const void*>(fused_md_chunk_kernel));
  cudaError_t rc;
  if (shmem > 48 * 1024) {
    rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(shmem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == kModeChunk) {
    if (biased) {
      fused_md_bias_kernel<<<n_replicas, threads, shmem, st>>>(a);
    } else {
      fused_md_chunk_kernel<<<n_replicas, threads, shmem, st>>>(a);
    }
    return static_cast<int>(cudaGetLastError());
  }
  int device = 0, sms = 0, per_sm = 0;
  rc = cudaGetDevice(&device);
  if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (rc == cudaSuccess) {
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, shmem);
  }
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (n_replicas > per_sm * sms) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  void* kargs[1] = {&a};
  rc = cudaLaunchCooperativeKernel(kernel, dim3(n_replicas), dim3(threads), kargs, shmem, st);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}

// Launches `n_blocks` CTAs of `n_threads` threads that meet at
// `n_barriers` grid barriers and do nothing else. For timing the barrier
// the whole-run kernels are built on.
int pmarlo_grid_barrier_probe(int n_blocks, int n_threads, int n_barriers, void* stream) {
  void* kargs[1] = {&n_barriers};
  const cudaError_t rc = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(grid_barrier_probe_kernel), dim3(n_blocks),
      dim3(n_threads), kargs, 0, static_cast<cudaStream_t>(stream));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
