// The 32-atom groups of the GB sweeps that walk 32 x 32 patches with a
// cutoff (pair_newton.cu: the Newton sweeps; pair_force.cu: the ordered
// culled sweeps): each group's bounding box from the live positions,
// and the test that leaves out a pair of groups with no pair inside the
// cutoff.
#pragma once

#include "pair_common.cuh"

namespace {

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
__global__ void group_boxes_kernel(PairArgs a, float* boxes, int n_replicas) {
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

// true when position p lies within the cutoff of the box bh (lo xyz, hi
// xyz), tested as boxes_apart tests two boxes: a row atom beyond it has no
// pair with the box's group
__device__ __forceinline__ bool near_box(const PairArgs& a, float4 p, const float* bh) {
  const float gx = fmaxf(fmaxf(bh[0] - p.x, p.x - bh[3]), 0.0f);
  const float gy = fmaxf(fmaxf(bh[1] - p.y, p.y - bh[4]), 0.0f);
  const float gz = fmaxf(fmaxf(bh[2] - p.z, p.z - bh[5]), 0.0f);
  return __fadd_rn(pair_r2(gx, gy, gz), kEps) <= a.cut_r2;
}

}  // namespace
