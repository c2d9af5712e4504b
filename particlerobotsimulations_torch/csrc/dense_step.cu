// The DENSE step of the per-bot loop in one launch — the dense step.
//
// Replaces no pallas_call.  The JAX package runs its DENSE backend
// (particlerobotsimulations_tpu/ops/forces.py dense_collide, stepped by
// engine.py's body) as XLA ops, which XLA fuses.  PyTorch runs it as ~357
// launches per step over (B, N, N) pair planes (diff, rel_vel, valid, every
// intermediate of pair_forces, 8-16 MB each at B=8, N=500) and the per-bot
// ops around them; on the card that was all of the step (PERF.md).  This
// kernel runs steps 4-6 of the step (engine.py) for B scenes at once:
//   pre    the radius controller from the previous step's abs_force_a /
//          abs_force_r, then integrate and the world-boundary clamp
//          (row_step.cuh pre_row);
//   pairs  every real pair (i, j), i != j, both rows below n_cells: the
//          contact and magnet force of ops/forces.py pair_forces, op for op
//          (dense_pair below), summed into fx, fy, the attraction and the
//          contact magnitude sums;
//   post   obstacles, stick-slip friction and vx = vy = 0 past n_cells
//          (row_step.cuh post_row).
// The pair planes never exist.  The library is built with -fmad=false, so
// each product and sum rounds as PyTorch's separate elementwise ops round
// it; a tensor divided by a host scalar is, in PyTorch's CUDA kernel, the
// tensor times the scalar's float reciprocal, so those divisions are
// products by reciprocals folded on the host (kernels.py dense_constants).
// Only the order of the j-sums differs from torch.sum's, and it depends on
// the scene alone (not on B or the tile), so runs repeat bit for bit: the
// candidates of a target that pass a squared-distance filter, in ascending
// j, are dealt to its warp's lanes in turn (the k-th to lane k % 32), each
// lane adds the terms of its candidates in that order (a candidate out of
// reach of both laws, dist >= cutoff and dist >= rad_i + rad_j, adds
// nothing: its term is an exact zero in the plain ops too), and the lanes
// are added by a fixed xor butterfly.
//
// Contract: pos and vel are float32 (B, n_pad, 2), rad, phase, aa, ar
// float32 (B, n_pad), dead bool (B, n_pad), all contiguous; row i of scene
// b is real iff i < n_cells, the payload row (or -1) has the attraction,
// friction and mass factors.  Outputs pos', vel', rad', aa', ar' of the
// same shapes, fresh buffers (a launch never writes what it reads, so no
// block sees a row another block has already stepped).  step is a 0-dim
// int64 on the card: the sim time is f32(*step + step_offset) * f32(dt),
// read by the kernel, so a CUDA graph of the launch replays at whatever
// step it then holds.  Constants and obstacles travel by value in the
// launch's parameters.
//
// What bounds it on the card: latency.  B=8 scenes of 500 bots are 2M pairs,
// ~20 of each target's 500 in reach: ~10 operations a pair out of reach (the
// squared distance) and ~40 in reach, ~25 MFLOP, under 1 us at 67 TFLOP/s
// float32; the state is ~100 KB.  What the card waits on is each thread's
// chain: the pre (nine IEEE divisions), the candidate loop, the in-reach
// terms, the post (obstacles and friction).  So the design keeps each chain
// short and every lane of a warp on the same path: forming each in-reach
// term on the lane where its j falls runs the long term path on nearly every
// step of a warp's loop, for one lane or two (PERF.md: ~16 us a launch at
// any B).  A warp per target, tile_rows targets a block, a grid of scenes x
// tiles (kernels.py dense_plan picks from (B, n_pad) the largest tile that
// still leaves a block per ~8 SMs: every block stages its whole scene).
// Each block first computes the pre of every real row of its scene into
// shared memory, kChunk rows at a time (any n_pad runs; a few hundred
// operations a row and no second launch), and a real target of a one-chunk
// scene takes its own pre from there.  The warp tests kUnroll x 32
// candidates at once against the squared cutoff (or the largest contact
// distance, if larger) with a 1e-4 margin, lists those that pass by ballot
// in shared memory, and forms their terms 32 at a time, every lane busy,
// with the plain ops' exact reach test.  After a barrier the block's posts
// run one lane each (not one warp each), and that lane writes.

#include <cuda_runtime.h>

#include "row_step.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kUnroll = 4;        // candidates a lane tests at once
constexpr int kChunk = 1024;      // candidate rows staged in shared memory at once
constexpr int kMaxTile = 32;      // targets (warps) per block
constexpr int kList = 2 * kWarp;  // candidates a warp holds
constexpr int kMaxScenes = 65535;

// the pair law's float32 constants, folded on the host as ops/forces.py
// pair_forces folds them (kernels.py dense_constants order)
struct DensePair {
  float cutoff, neg_spring, damping, shear, attraction, attraction_factor;
  float int1, int2, min_attr, inv_int2_sq, inv_span;
};
constexpr int kNumPair = sizeof(DensePair) / sizeof(float);

struct DenseArgs {
  const float* pos;
  const float* vel;
  const float* rad;
  const float* phase;
  const bool* dead;
  const float* aa;
  const float* ar;
  float* pos_out;
  float* vel_out;
  float* rad_out;
  float* aa_out;
  float* ar_out;
  const long long* step;
  int n_pad, n_cells, payload_row, tile_rows, step_offset;
};

// row j of scene b as row_step.cuh's Row
static __device__ __forceinline__ Row load_row(const DenseArgs& a, long long b, int j) {
  const long long k = b * a.n_pad + j;
  const float2 p = reinterpret_cast<const float2*>(a.pos)[k];
  const float2 v = reinterpret_cast<const float2*>(a.vel)[k];
  Row r{};
  r.px = p.x;
  r.py = p.y;
  r.vx = v.x;
  r.vy = v.y;
  r.rad = a.rad[k];
  r.phase = a.phase[k];
  r.dead = a.dead[k] ? 1.f : 0.f;
  r.aa = a.aa[k];
  r.ar = a.ar[k];
  r.val = j < a.n_cells ? 1.f : 0.f;
  r.pay = j == a.payload_row ? 1.f : 0.f;
  return r;
}

// ops/forces.py pair_forces for target t against candidate (px, py, vx,
// vy, rad) with the pair's attraction constant aij, added to the four sums
// where the pair is in reach of either law (the plain ops' overlap and
// attract masks; their terms are exact zeros elsewhere)
static __device__ __forceinline__ void dense_pair(
    const DensePair& k, const Row& t, float px, float py, float vx, float vy,
    float rad, float aij, float& sx, float& sy, float& sa, float& sr) {
  const float dx = px - t.px;
  const float dy = py - t.py;
  const float dist = norm2(dx, dy);
  const float cd = t.rad + rad;
  const bool overlap = dist < cd;
  if (!overlap && !(dist < k.cutoff)) return;
  const float safe = clamp_min(dist, 1.0e-12f);
  const float nx = dx / safe;
  const float ny = dy / safe;
  if (overlap) {
    // DEM spring + dashpot + shear
    const float rvx = vx - t.vx;
    const float rvy = vy - t.vy;
    const float vn = rvx * nx + rvy * ny;
    const float tx = rvx - vn * nx;
    const float ty = rvy - vn * ny;
    const float fx = k.neg_spring * (cd - dist) * nx + k.damping * rvx + k.shear * tx;
    const float fy = k.neg_spring * (cd - dist) * ny + k.damping * rvy + k.shear * ty;
    sx += fx;
    sy += fy;
    sr += norm2(fx, fy);
  } else {
    // three-piece magnet law
    const float gap = dist - cd;
    float mag;
    if (gap < k.int1) {
      mag = k.min_attr;
    } else if (gap < k.int2) {
      mag = k.min_attr + (aij * k.inv_int2_sq - k.min_attr) * k.inv_span * (gap - k.int1);
    } else {
      mag = aij / (gap * gap);
    }
    const float fx = mag * nx;
    const float fy = mag * ny;
    sx += fx;
    sy += fy;
    sa += norm2(fx, fy);
  }
}

__global__ void __launch_bounds__(kMaxTile * kWarp) dense_step_kernel(
    DenseArgs a, MegaConsts c, DensePair k, Obstacles obs) {
  __shared__ float s_rect[4 * kMaxRect];
  __shared__ float s_circ[3 * kMaxCirc];
  __shared__ float2 s_pos[kChunk], s_vel[kChunk];
  __shared__ float s_rad[kChunk];
  __shared__ int s_list[kMaxTile][kList];
  __shared__ float s_done[kMaxTile][9];  // a target's px py vx vy rad and four sums
  __shared__ unsigned s_rmax;  // the largest staged radius (at least 0), as bits
  stage_obstacles(obs, s_rect, s_circ);
  if (threadIdx.x == 0) s_rmax = 0u;
  const long long b = blockIdx.y;
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int i = blockIdx.x * a.tile_rows + warp;
  int* list = s_list[warp];
  const float time = static_cast<float>(*a.step + a.step_offset) * c.dt;

  // a real target of a scene staged in one chunk reads its pre from there;
  // every other target computes it here
  const bool real = i < a.n_cells;
  const bool staged = real && a.n_cells <= kChunk;
  Row t{};
  if (i < a.n_pad && !staged) {
    t = load_row(a, b, i);
    pre_row(c, t, time);
  }
  const float ati = k.attraction * (i == a.payload_row ? k.attraction_factor : 1.f);
  float sx = 0.f, sy = 0.f, sa = 0.f, sr = 0.f;
  int held = 0;  // candidates in the list
  // the terms of the list's first n entries, entry e by lane e; the rest
  // move to the front
  auto take = [&](int j0, int n) {
    __syncwarp();
    if (lane < n) {
      const int jj = list[lane];
      const float aij = ati * (j0 + jj == a.payload_row ? k.attraction_factor : 1.f);
      const float2 q = s_pos[jj], v = s_vel[jj];
      dense_pair(k, t, q.x, q.y, v.x, v.y, s_rad[jj], aij, sx, sy, sa, sr);
    }
    const int rest = held - n;
    const int moved = lane < rest ? list[n + lane] : 0;
    __syncwarp();
    if (lane < rest) list[lane] = moved;
    __syncwarp();
    held = rest;
  };
  for (int j0 = 0; j0 < a.n_cells; j0 += kChunk) {
    const int jn = min(kChunk, a.n_cells - j0);
    __syncthreads();  // the last chunk's reads are done (and s_rmax, the obstacles set)
    for (int jj = threadIdx.x; jj < jn; jj += blockDim.x) {
      Row r = load_row(a, b, j0 + jj);
      pre_row(c, r, time);
      s_pos[jj] = make_float2(r.px, r.py);
      s_vel[jj] = make_float2(r.vx, r.vy);
      s_rad[jj] = r.rad;
      atomicMax(&s_rmax, __float_as_uint(fmaxf(r.rad, 0.f)));
    }
    __syncthreads();
    if (!real) continue;  // uniform over the warp
    if (staged) {
      const float2 q = s_pos[i], v = s_vel[i];
      t.px = q.x;
      t.py = q.y;
      t.vx = v.x;
      t.vy = v.y;
      t.rad = s_rad[i];
      t.val = 1.f;
      t.pay = i == a.payload_row ? 1.f : 0.f;
    }
    // a distance past the cutoff and every contact distance of the target
    // by a relative 1e-4 (squared), far wider than the distance's rounding
    const float lim = fmaxf(k.cutoff, t.rad + __uint_as_float(s_rmax));
    const float lim2 = lim * lim * 1.0001f;
    for (int base = 0; base < jn; base += kUnroll * kWarp) {
      bool near[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int jj = base + u * kWarp + lane;
        near[u] = false;
        if (jj < jn) {
          const float2 q = s_pos[jj];
          const float dx = q.x - t.px;
          const float dy = q.y - t.py;
          near[u] = !(dx * dx + dy * dy > lim2) && j0 + jj != i;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const unsigned m = __ballot_sync(0xffffffffu, near[u]);
        if (near[u]) list[held + __popc(m & ((1u << lane) - 1u))] = base + u * kWarp + lane;
        held += __popc(m);
        if (held >= kWarp) take(j0, kWarp);
      }
    }
    take(j0, held);
  }
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    sx += __shfl_xor_sync(0xffffffffu, sx, off);
    sy += __shfl_xor_sync(0xffffffffu, sy, off);
    sa += __shfl_xor_sync(0xffffffffu, sa, off);
    sr += __shfl_xor_sync(0xffffffffu, sr, off);
  }
  if (lane == 0) {
    const float done[9] = {t.px, t.py, t.vx, t.vy, t.rad, sx, sy, sa, sr};
#pragma unroll
    for (int q = 0; q < 9; ++q) s_done[warp][q] = done[q];
  }
  __syncthreads();
  // the post of the block's targets, one lane each
  const int q = threadIdx.x;
  const int r = blockIdx.x * a.tile_rows + q;
  if (q >= a.tile_rows || r >= a.n_pad) return;
  const float* d = s_done[q];
  Row u{};
  u.px = d[0];
  u.py = d[1];
  u.vx = d[2];
  u.vy = d[3];
  u.rad = d[4];
  u.val = r < a.n_cells ? 1.f : 0.f;
  u.pay = r == a.payload_row ? 1.f : 0.f;
  post_row(c, s_rect, obs.n_rect, s_circ, obs.n_circ, u, d[5], d[6], d[7], d[8]);
  const long long o = b * a.n_pad + r;
  reinterpret_cast<float2*>(a.pos_out)[o] = make_float2(u.px, u.py);
  reinterpret_cast<float2*>(a.vel_out)[o] = make_float2(u.vx, u.vy);
  a.rad_out[o] = u.rad;
  a.aa_out[o] = u.aa;
  a.ar_out[o] = u.ar;
}

}  // namespace

// One dense-step launch over `scenes` scenes of n_pad rows (see the
// contract above).  in holds pos, vel, rad, phase, dead, aa, ar; out pos',
// vel', rad', aa', ar' (host arrays of 7 and 5 pointers); tile_rows (4, 8,
// 16 or 32) target rows per block, a warp each; consts the row step's constants
// (kernels.py mega_constants), pair the pair law's (dense_constants);
// rects and circs host arrays of n_rect x 4 and n_circ x 3 floats.
// Returns a cudaError_t: cudaErrorInvalidValue for a shape, tile, constant
// count, obstacle count or null pointer the kernel does not take; else the
// launch's own status.
extern "C" int pbot_dense_step(
    const void* const* in, void* const* out, int scenes, int n_pad, int n_cells,
    int payload_row, int tile_rows, const void* step, int step_offset,
    const float* consts, int n_consts, const float* pair, int n_pair,
    const float* rects, int n_rect, const float* circs, int n_circ, void* stream) {
  if (n_consts != kNumConsts || n_pair != kNumPair || scenes < 1 || scenes > kMaxScenes ||
      n_pad < 1 || n_cells < 0 || n_cells > n_pad || payload_row < -1 ||
      payload_row >= n_cells || step == nullptr ||
      (tile_rows != 4 && tile_rows != 8 && tile_rows != 16 && tile_rows != 32)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Obstacles obs;
  if (!load_obstacles(rects, n_rect, circs, n_circ, &obs)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int q = 0; q < 7; ++q) {
    if (in[q] == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int q = 0; q < 5; ++q) {
    if (out[q] == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  }
  DenseArgs a{};
  a.pos = static_cast<const float*>(in[0]);
  a.vel = static_cast<const float*>(in[1]);
  a.rad = static_cast<const float*>(in[2]);
  a.phase = static_cast<const float*>(in[3]);
  a.dead = static_cast<const bool*>(in[4]);
  a.aa = static_cast<const float*>(in[5]);
  a.ar = static_cast<const float*>(in[6]);
  a.pos_out = static_cast<float*>(out[0]);
  a.vel_out = static_cast<float*>(out[1]);
  a.rad_out = static_cast<float*>(out[2]);
  a.aa_out = static_cast<float*>(out[3]);
  a.ar_out = static_cast<float*>(out[4]);
  a.step = static_cast<const long long*>(step);
  a.n_pad = n_pad;
  a.n_cells = n_cells;
  a.payload_row = payload_row;
  a.tile_rows = tile_rows;
  a.step_offset = step_offset;
  MegaConsts c;
  float* dst = reinterpret_cast<float*>(&c);
  for (int q = 0; q < kNumConsts; ++q) dst[q] = consts[q];
  DensePair k;
  dst = reinterpret_cast<float*>(&k);
  for (int q = 0; q < kNumPair; ++q) dst[q] = pair[q];
  const dim3 grid((n_pad + tile_rows - 1) / tile_rows, scenes, 1);
  dense_step_kernel<<<grid, tile_rows * kWarp, 0, static_cast<cudaStream_t>(stream)>>>(
      a, c, k, obs);
  return static_cast<int>(cudaGetLastError());
}
