// Pair-force stencil on slot-major cell tables — kernel 1 of the table loop.
//
// Replaces: particlerobotsimulations_tpu/ops/pallas_stencil.py
//   _stencil_forces_pallas (the pallas_call at l.458; kernel body
//   _make_kernel l.329; pair math _pair_block l.171).
//
// Contract: tables px, py, vx, vy, rad (and afac when the scene has a
// payload) are float32 (C, G*G), slot-major (row c*G*G + lane, lane =
// y*G + x).  A row is occupied iff rad > 0.  For every occupied target row
// the kernel sums, over every occupied candidate row in the 3x3 cells
// around it (exact 2-D wrap, the target itself excluded), the DEM contact
// force and the three-piece magnet law, and writes fx, fy, the attraction
// magnitude sum fa and the contact magnitude sum fr.  Empty rows get zeros.
//
// What bounds it on the card: compute.  At 10k bots (G=48, C=16) there are
// 36,864 target rows and 144 candidates each, about 5.3M pair evaluations
// per step with ~40 flops and one divide and one sqrt each (~0.2 GFLOP);
// the tables themselves are 5 x 147 KB and stay in L2 between the
// neighbouring threads that read them.
//
// Design: one thread per target row, all four sums in registers, no shared
// memory.  The TPU kernel halves the pair work with Newton's third law and
// realigns the reactions with lane rolls; on this card the reactions would
// need atomics or a second pass, so each thread gathers its full 3x3
// neighbourhood instead (the non-Newton form the JAX package's
// _make_kernel_ext computes).  There are no atomics, so the result is
// deterministic.  The pair math (pair_math.cuh, shared with kernel 3)
// follows _pair_block term for term, with 1.0f / sqrtf(d2) where the TPU
// used rsqrt, and kernels.py builds with -fmad=false: every product and sum
// rounds as PyTorch's separate elementwise ops round it, so this kernel and
// its plain twin agree to the order of summation.  (The magnet ramp multiplies the rounding error of
// the gap dist - cd by ~1e4; with contracted FMAs a ramp pair's force moved
// by ~3e-4 against the twin.)  Shared-memory cell tiles and Newton halving
// are left for later.

#include <cuda_runtime.h>

#include "pair_math.cuh"

namespace {

__global__ void stencil_forces_kernel(
    const float* __restrict__ px, const float* __restrict__ py,
    const float* __restrict__ vx, const float* __restrict__ vy,
    const float* __restrict__ rad, const float* __restrict__ afac,
    float* __restrict__ fx, float* __restrict__ fy,
    float* __restrict__ fa, float* __restrict__ fr,
    int cap, int g, PairConsts k) {
  const int gg = g * g;
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= cap * gg) return;

  float sx = 0.f, sy = 0.f, sa = 0.f, sr = 0.f;
  const float rt = rad[row];
  if (rt > 0.f) {
    const int lane = row % gg;
    const int x = lane % g;
    const int y = lane / g;
    const float pxt = px[row], pyt = py[row];
    const float vxt = vx[row], vyt = vy[row];
    const float aft = afac ? afac[row] : 1.f;

    for (int oy = -1; oy <= 1; ++oy) {
      const int ny = (y + oy + g) % g;
      for (int ox = -1; ox <= 1; ++ox) {
        const int nl = ny * g + (x + ox + g) % g;
        for (int c = 0; c < cap; ++c) {
          const int j = c * gg + nl;
          if (j == row) continue;
          const float rc = rad[j];
          if (!(rc > 0.f)) continue;

          pair_accumulate(k, px, py, vx, vy, afac, j, rc, pxt, pyt, vxt, vyt,
                          rt, aft, sx, sy, sa, sr);
        }
      }
    }
  }
  fx[row] = sx;
  fy[row] = sy;
  fa[row] = sa;
  fr[row] = sr;
}

}  // namespace

extern "C" int pbot_stencil_forces(
    const void* px, const void* py, const void* vx, const void* vy,
    const void* rad, const void* afac,
    void* fx, void* fy, void* fa, void* fr,
    int cap, int g,
    float cutoff, float spring, float damping, float shear, float attraction,
    float int1, float int2, float min_attr, float inv_int2_sq, float inv_int_span,
    void* stream) {
  const PairConsts k{cutoff, spring, damping, shear, attraction,
                     int1, int2, min_attr, inv_int2_sq, inv_int_span};
  const int rows = cap * g * g;
  const int threads = 128;
  const int blocks = (rows + threads - 1) / threads;
  stencil_forces_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(px), static_cast<const float*>(py),
      static_cast<const float*>(vx), static_cast<const float*>(vy),
      static_cast<const float*>(rad), static_cast<const float*>(afac),
      static_cast<float*>(fx), static_cast<float*>(fy),
      static_cast<float*>(fa), static_cast<float*>(fr), cap, g, k);
  return static_cast<int>(cudaGetLastError());
}
