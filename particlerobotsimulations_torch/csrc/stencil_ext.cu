// Halo-extended pair-force stencil — kernel 4, the sharded table loop's
// force pass.
//
// Replaces: particlerobotsimulations_tpu/ops/pallas_stencil.py
//   stencil_forces_pallas_ext (l.516; the pallas_call at l.570; kernel body
//   _make_kernel_ext l.481; pair math _pair_block l.171 with
//   newton_center=False), called every step from
//   parallel/spatial_table.py l.306.
//
// Contract: seven float32 planes px, py, vx, vy, rad, val, afac of shape
// (S, C, E) — S shards, C force-visible slots, E = H + L0 + H extended lanes
// ([H pad | L0 center | H pad], H and L0 multiples of G, lane = y*G + x).
// Each plane's (C, E) block is contiguous; the shards sit `sstride` floats
// apart (the planes may be views of one stacked tensor).  afac is read only
// when the scene has a payload (null otherwise).  A row is occupied iff its
// val is nonzero (val is 0 or 1).  For every occupied CENTER target row
// (s, c, H + t) the kernel sums, over every occupied candidate row in the
// 3x3 cells around it, the target itself excluded, the DEM contact force
// and the three-piece magnet law, and writes fx, fy, the attraction
// magnitude sum fa and the contact magnitude sum fr to (S, C, L0) outputs.
// Empty rows get zeros.  The neighbour lane of target lane H + t (x = t %
// G) at offset (ox, oy) is H + t + oy*G + ((x + ox + G) % G - x): the exact
// x-wrap of the JAX flat preshift (_preshift_flat l.107) with y read
// linearly into the halo rows — not kernel 1's whole-table 2-D wrap.
//
// What bounds it on the card: the pair arithmetic, as in kernel 1.  At 10k
// bots over 4 shards (G=64, C=16, L0=1024) there are 65,536 target rows and
// 144 candidates each; the planes are 7 x 4 x 16 x 1536 floats (2.75 MB)
// and stay in L2 between the neighbouring threads that read them.
//
// Design: one thread per target row, all four sums in registers, no
// shared memory, no atomics, so the result is deterministic; the S shards
// of a process in one launch (blockIdx.y = shard).  Each term is
// pair_math.cuh's pair_term, added by pair_add in (oy, ox, slot) order —
// the order in which kernel 1 adds the terms it evaluates in parallel — so
// this kernel's centre lanes equal kernel 1's outputs on the same whole
// table bit for bit, and it and its plain twin differ only in summation
// order (-fmad=false).

#include <cuda_runtime.h>

#include "pair_math.cuh"

namespace {

__global__ void stencil_forces_ext_kernel(
    const float* __restrict__ px, const float* __restrict__ py,
    const float* __restrict__ vx, const float* __restrict__ vy,
    const float* __restrict__ rad, const float* __restrict__ val,
    const float* __restrict__ afac,
    float* __restrict__ fx, float* __restrict__ fy,
    float* __restrict__ fa, float* __restrict__ fr,
    int cap, int g, int ext, int h, int center, long long sstride,
    PairConsts k) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= cap * center) return;
  const long long in0 = blockIdx.y * sstride;
  px += in0; py += in0; vx += in0; vy += in0; rad += in0; val += in0;
  if (afac) afac += in0;
  const size_t out = static_cast<size_t>(blockIdx.y) * cap * center + idx;

  const int c = idx / center;
  const int t = idx - c * center;
  const int row = c * ext + h + t;
  float sx = 0.f, sy = 0.f, sa = 0.f, sr = 0.f;
  if (val[row] != 0.f) {
    const int x = t % g;
    const float pxt = px[row], pyt = py[row];
    const float vxt = vx[row], vyt = vy[row];
    const float rt = rad[row];
    const float aft = afac ? afac[row] : 1.f;

    for (int oy = -1; oy <= 1; ++oy) {
      for (int ox = -1; ox <= 1; ++ox) {
        const int nl = h + t + oy * g + ((x + ox + g) % g - x);
        for (int cc = 0; cc < cap; ++cc) {
          const int j = cc * ext + nl;
          if (j == row || val[j] == 0.f) continue;
          pair_add(pair_term(k, px, py, vx, vy, afac, j, rad[j], pxt, pyt,
                             vxt, vyt, rt, aft),
                   sx, sy, sa, sr);
        }
      }
    }
  }
  fx[out] = sx;
  fy[out] = sy;
  fa[out] = sa;
  fr[out] = sr;
}

}  // namespace

extern "C" int pbot_stencil_forces_ext(
    const void* px, const void* py, const void* vx, const void* vy,
    const void* rad, const void* val, const void* afac,
    void* fx, void* fy, void* fa, void* fr,
    int shards, int cap, int g, int ext, int h, int center, long long sstride,
    float cutoff, float spring, float damping, float shear, float attraction,
    float int1, float int2, float min_attr, float inv_int2_sq, float inv_int_span,
    void* stream) {
  const PairConsts k{cutoff, spring, damping, shear, attraction,
                     int1, int2, min_attr, inv_int2_sq, inv_int_span};
  const int threads = 128;
  const dim3 blocks((cap * center + threads - 1) / threads, shards);
  stencil_forces_ext_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(px), static_cast<const float*>(py),
      static_cast<const float*>(vx), static_cast<const float*>(vy),
      static_cast<const float*>(rad), static_cast<const float*>(val),
      static_cast<const float*>(afac),
      static_cast<float*>(fx), static_cast<float*>(fy),
      static_cast<float*>(fa), static_cast<float*>(fr),
      cap, g, ext, h, center, sstride, k);
  return static_cast<int>(cudaGetLastError());
}
