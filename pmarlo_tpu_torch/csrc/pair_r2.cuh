// r^2 of a displacement with every product and sum rounded on its own (no
// fused multiply-add): (dx dx + dy dy) + dz dz in float32, as plain PyTorch
// computes it. Wherever a potential is truncated (the periodic sweeps'
// cutoff, the GB cutoff of the tile-culled pair sweeps) the force jumps at
// the cutoff; with r^2 reproducible, a kernel and its plain twin cut the
// same pairs.
#pragma once

namespace {

__device__ __forceinline__ float pair_r2(float dx, float dy, float dz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

}  // namespace
