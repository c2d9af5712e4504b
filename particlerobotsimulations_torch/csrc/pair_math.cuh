// The pair term of the table kernels, shared by kernels 1 and 4
// (stencil_forces.cu) and kernel 3 (mega_span.cu).
//
// Replaces, term for term: particlerobotsimulations_tpu/ops/
// pallas_stencil.py _pair_block (l.171), with 1.0f / sqrtf(d2) where the
// TPU used rsqrt.  The library is built with -fmad=false, so every product
// and sum here rounds as the plain PyTorch twin's separate elementwise ops
// round it (see stencil_forces.cu).
//
// A term is evaluated by pair_term and added by pair_add, so a kernel that
// evaluates terms in parallel and adds them later in the serial order gets
// the sums of a kernel that adds each term as it goes, bit for bit.

#pragma once

#include <cuda_runtime.h>

// float32 constants of the pair law, in the order of
// ops/pallas_stencil.py pair_constants
struct PairConsts {
  float cutoff, spring, damping, shear, attraction;
  float int1, int2, min_attr, inv_int2_sq, inv_int_span;
};

// which sums a term feeds: none (beyond the cutoff), the contact sum or
// the attraction sum
enum PairKind { kNoForce = 0, kContact = 1, kMagnet = 2 };

// One candidate's force on a target: (fx, fy), its magnitude for the
// contact or attraction sum, and the kind.  16 bytes, so a shared-memory
// buffer of terms is one float4-sized store per term.
struct __align__(16) PairTerm {
  float fx, fy, mag;
  int kind;
};

// The force of candidate row j (radius rc > 0, a different row than the
// target) on the target row (pxt, pyt, vxt, vyt, rt, aft).  The candidate
// planes may live in global or shared memory; afac is null when the scene
// has no payload.  vx[j] and vy[j] are read only on contact.
static __device__ __forceinline__ PairTerm pair_term(
    const PairConsts& k, const float* px, const float* py, const float* vx,
    const float* vy, const float* afac, int j, float rc, float pxt, float pyt,
    float vxt, float vyt, float rt, float aft) {
  const float eps2 = 1.0e-12f * 1.0e-12f;
  const float dx = px[j] - pxt;
  const float dy = py[j] - pyt;
  const float d2 = dx * dx + dy * dy + eps2;
  const float inv = 1.0f / sqrtf(d2);
  const float dist = d2 * inv;
  const float nx = dx * inv;
  const float ny = dy * inv;
  const float cd = rt + rc;

  PairTerm t{0.f, 0.f, 0.f, kNoForce};
  if (dist < cd) {
    // DEM spring + dashpot + shear (particlebot_kernel_impl.cuh:560-573)
    const float rvx = vx[j] - vxt;
    const float rvy = vy[j] - vyt;
    const float vn = rvx * nx + rvy * ny;
    const float tx = rvx - vn * nx;
    const float ty = rvy - vn * ny;
    t.fx = -k.spring * (cd - dist) * nx + k.damping * rvx + k.shear * tx;
    t.fy = -k.spring * (cd - dist) * ny + k.damping * rvy + k.shear * ty;
    t.mag = sqrtf(t.fx * t.fx + t.fy * t.fy);
    t.kind = kContact;
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
    t.fx = mag * nx;
    t.fy = mag * ny;
    t.mag = mag;
    t.kind = kMagnet;
  }
  return t;
}

// True when candidate and target certainly exert no force on each other:
// their squared distance exceeds the larger of the cutoff and the contact
// distance cd = rt + rc by a relative margin (1e-4) far wider than
// pair_term's rounding of dist (a few ulp), so pair_term would take neither
// branch.  dx, dy are pair_term's.  A NaN distance is never out of reach.
static __device__ __forceinline__ bool pair_out_of_reach(
    const PairConsts& k, float dx, float dy, float cd) {
  const float lim = fmaxf(k.cutoff, cd);
  return dx * dx + dy * dy > lim * lim * 1.0001f;
}

// Adds a term to the four sums: fx, fy, the attraction magnitude sum sa
// and the contact magnitude sum sr.  A term beyond the cutoff adds
// nothing (it is skipped, not added as zeros).
static __device__ __forceinline__ void pair_add(
    const PairTerm& t, float& sx, float& sy, float& sa, float& sr) {
  if (t.kind == kContact) {
    sx += t.fx;
    sy += t.fy;
    sr += t.mag;
  } else if (t.kind == kMagnet) {
    sx += t.fx;
    sy += t.fy;
    sa += t.mag;
  }
}
