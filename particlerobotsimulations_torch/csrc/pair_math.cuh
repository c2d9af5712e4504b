// The pair term of the table kernels, shared by kernel 1
// (stencil_forces.cu) and kernel 3 (mega_span.cu).
//
// Replaces, term for term: particlerobotsimulations_tpu/ops/
// pallas_stencil.py _pair_block (l.171), with 1.0f / sqrtf(d2) where the
// TPU used rsqrt.  The library is built with -fmad=false, so every product
// and sum here rounds as the plain PyTorch twin's separate elementwise ops
// round it (see stencil_forces.cu).

#pragma once

#include <cuda_runtime.h>

// float32 constants of the pair law, in the order of
// ops/pallas_stencil.py pair_constants
struct PairConsts {
  float cutoff, spring, damping, shear, attraction;
  float int1, int2, min_attr, inv_int2_sq, inv_int_span;
};

// Adds the force of candidate row j (radius rc > 0, a different row than
// the target) on the target row (pxt, pyt, vxt, vyt, rt, aft) to the four
// sums: fx, fy, the attraction magnitude sum sa and the contact magnitude
// sum sr.  The candidate planes may live in global or shared memory; afac
// is null when the scene has no payload.
static __device__ __forceinline__ void pair_accumulate(
    const PairConsts& k, const float* px, const float* py, const float* vx,
    const float* vy, const float* afac, int j, float rc, float pxt, float pyt,
    float vxt, float vyt, float rt, float aft, float& sx, float& sy,
    float& sa, float& sr) {
  const float eps2 = 1.0e-12f * 1.0e-12f;
  const float dx = px[j] - pxt;
  const float dy = py[j] - pyt;
  const float d2 = dx * dx + dy * dy + eps2;
  const float inv = 1.0f / sqrtf(d2);
  const float dist = d2 * inv;
  const float nx = dx * inv;
  const float ny = dy * inv;
  const float cd = rt + rc;

  if (dist < cd) {
    // DEM spring + dashpot + shear (particlebot_kernel_impl.cuh:560-573)
    const float rvx = vx[j] - vxt;
    const float rvy = vy[j] - vyt;
    const float vn = rvx * nx + rvy * ny;
    const float tx = rvx - vn * nx;
    const float ty = rvy - vn * ny;
    const float fcx = -k.spring * (cd - dist) * nx + k.damping * rvx + k.shear * tx;
    const float fcy = -k.spring * (cd - dist) * ny + k.damping * rvy + k.shear * ty;
    sx += fcx;
    sy += fcy;
    sr += sqrtf(fcx * fcx + fcy * fcy);
  } else if (dist < k.cutoff) {
    // three-piece magnet law (particlebot_kernel_impl.cuh:576-593)
    const float gap = dist - cd;
    const float attr = afac ? k.attraction * aft * afac[j] : k.attraction;
    float mag;
    if (gap < k.int1) {
      mag = k.min_attr;
    } else if (gap < k.int2) {
      mag = k.min_attr + (attr * k.inv_int2_sq - k.min_attr) * k.inv_int_span * (gap - k.int1);
    } else {
      mag = attr / (gap * gap);
    }
    sx += mag * nx;
    sy += mag * ny;
    sa += mag;
  }
}
