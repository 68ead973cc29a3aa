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
//   kernel ~80 registers a thread, and 512 such threads fit the SM's 64K
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

#include <cuda_runtime.h>
#include <stdint.h>

#include "gb_pair.cuh"

namespace {

constexpr int kMaxAtoms = 512;
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

// Forces on atom i (thread i) at the positions in sx; the energy share of
// atom i when `e` is non-null. Every thread of the block must call it: it
// holds the block-wide barriers between the GB phases and ends with one, so
// callers may overwrite sx afterwards.
__device__ void compute_forces(const Args& a, const float* sx, float* sB, float* sChain,
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
  }
  if (e != nullptr) *e = energy;
  __syncthreads();
}

__global__ void fused_md_chunk_kernel(Args a) {
  extern __shared__ float smem[];
  const int n = a.n;
  float* sx = smem;              // (N, 3) positions
  float* sB = sx + 3 * n;        // (N,) Born radii
  float* sChain = sB + n;        // (N,) dE/dB dB/dpsi rho
  float* sRed = sChain + n;      // (blockDim,) energy reduction
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
      sx[3 * i + c] = x[c];
    }
    inv_m = a.atom_p[kInvM * n + i];
    sigma = sqrtf(a.c2sq * a.kT[r] * inv_m);
  }
  const uint32_t seed = static_cast<uint32_t>(a.seeds[r]);
  __syncthreads();

  float f[3];
  for (int k = 0; k < a.n_steps; ++k) {
    compute_forces(a, sx, sB, sChain, i, own, f, nullptr);
    if (own) {
      float z[3];
      gaussian3(seed, static_cast<uint32_t>(r), a.step_offset + k, static_cast<uint32_t>(i), z);
      for (int c = 0; c < 3; ++c) {
        v[c] = v[c] + a.dt * f[c] * inv_m;   // B(dt): folded full kick
        x[c] = x[c] + a.half_dt * v[c];      // A(dt/2)
        v[c] = a.c1 * v[c] + sigma * z[c];   // O
        x[c] = x[c] + a.half_dt * v[c];      // A(dt/2)
        sx[3 * i + c] = x[c];
      }
    }
    __syncthreads();
  }

  float e_i = 0.0f;
  compute_forces(a, sx, sB, sChain, i, own, f, &e_i);
  if (own) {
    for (int c = 0; c < 3; ++c) {
      a.x[base + c] = x[c];
      a.v[base + c] = v[c];
      if (a.forces != nullptr) a.forces[base + c] = f[c];
    }
  }
  // deterministic tree reduction of the per-atom energy shares
  sRed[i] = own ? e_i : 0.0f;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (i < s) sRed[i] += sRed[i + s];
    __syncthreads();
  }
  if (i == 0) a.energy[r] = sRed[0];
}

}  // namespace

extern "C" {

int pmarlo_fused_md_max_atoms() { return kMaxAtoms; }

const char* pmarlo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches one chunk on `stream`; returns cudaGetLastError() (0 = launched).
int pmarlo_fused_md_chunk(float* x, float* v, float* energy, float* forces,
                          const int* seeds, const float* kT,
                          const float* atom_p, const float* pair_p,
                          const int* bond_i, const float* bond_p,
                          const int* angle_i, const float* angle_p,
                          const int* tors_i, const float* tors_p,
                          const int* csr_ptr, const int* csr_ent,
                          int n_replicas, int n_atoms, int n_steps,
                          long long step_offset, float dt, float half_dt, float c1,
                          float c2sq, float gb_pref, int use_gb, int use_neck,
                          void* stream) {
  if (n_atoms < 1 || n_atoms > kMaxAtoms || n_replicas < 1 || n_steps < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  a.x = x;
  a.v = v;
  a.energy = energy;
  a.forces = forces;
  a.seeds = seeds;
  a.kT = kT;
  a.atom_p = atom_p;
  a.pair_p = pair_p;
  a.bond_i = bond_i;
  a.bond_p = bond_p;
  a.angle_i = angle_i;
  a.angle_p = angle_p;
  a.tors_i = tors_i;
  a.tors_p = tors_p;
  a.csr_ptr = csr_ptr;
  a.csr_ent = csr_ent;
  a.n = n_atoms;
  a.n_steps = n_steps;
  a.step_offset = static_cast<unsigned long long>(step_offset);
  a.dt = dt;
  a.half_dt = half_dt;
  a.c1 = c1;
  a.c2sq = c2sq;
  a.gb_pref = gb_pref;
  a.use_gb = use_gb;
  a.use_neck = use_neck;
  // a power of two >= 32, for the tree reduction of the energy
  int threads = 32;
  while (threads < n_atoms) threads *= 2;
  const size_t shmem = (5 * static_cast<size_t>(n_atoms) + threads) * sizeof(float);
  fused_md_chunk_kernel<<<n_replicas, threads, shmem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
