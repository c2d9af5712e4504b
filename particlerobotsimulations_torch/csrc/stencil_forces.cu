// Pair-force stencil on slot-major cell tables — kernel 1 of the table loop.
//
// Replaces: particlerobotsimulations_tpu/ops/pallas_stencil.py
//   _stencil_forces_pallas (the pallas_call at l.458; kernel body
//   _make_kernel l.329; pair math _pair_block l.171).
//
// Contract: tables px, py, vx, vy, rad (and afac when the scene has a
// payload) are float32 (C, G*G), slot-major (row c*G*G + lane, lane =
// y*G + x), C <= 32.  A row is occupied iff rad > 0.  For every occupied
// target row the kernel sums, over every occupied candidate row in the 3x3
// cells around it (exact 2-D wrap, the target itself excluded), the DEM
// contact force and the three-piece magnet law, and writes fx, fy, the
// attraction magnitude sum fa and the contact magnitude sum fr.  Empty rows
// get zeros.  The terms are added in (oy, ox, slot) order, each offset and
// slot ascending from -1 and 0 — kernel 4's order (stencil_ext.cu), so
// kernel 1's outputs equal kernel 4's centre lanes on the same whole table
// bit for bit, which keeps the sharded loop bitwise equal to this one.
//
// What bounds it on the card: latency and the serial sums, not bytes or
// arithmetic.  At 10k bots (G=48, C=16) 830 of the 2,304 cells are
// occupied, ~12 bots each: ~10k targets with ~108 occupied candidates
// each, 1.09M pair terms of ~40 flops (~44 MFLOP: 0.65 us at 67 TFLOP/s
// float32), and 0.40 us of bytes at 3.35 TB/s (NVIDIA H100 80GB HBM3,
// 700 W).  The first design, one thread per row walking its 144
// candidate slots serially out of global memory, took ~65 us: about 2.4
// busy warps per SM, divergent between empty and occupied lanes and
// between the contact, magnet and no-force branches (PERF.md).  A target's
// terms must be added one after another to keep the order; that chain is
// what no design can spread.
//
// Design: one block of 256 threads per 2x2 tile of cells across all C
// slots (576 blocks at G=48, 1,024 at G=64, 6,400 at G=160).  The block
// stages the tile and its one-cell wrapped halo (4x4 cells x C slots of
// px, py, vx, vy, rad, and afac with a payload: 6 KB at C=16) into shared
// memory once, builds a 32-bit occupancy mask per cell, and hands the rest
// to pair_region.cuh: one work item per (occupied target, neighbour cell)
// finds its candidates from the masks' set bits, drops those certainly
// beyond the cutoff and contact distance (two thirds of them at 10k
// bots: 350k of 1.09M pairs are within reach), and evaluates the rest's
// terms into a shared-memory buffer (4,096 terms) at offsets from
// popcounts; then one thread per target adds its terms sequentially in the
// serial order.  Empty slots and unreachable candidates cost no term, the
// term arithmetic of a target is spread over nine threads, and a dense
// tile's work over as many blocks as there are 2x2 tiles.  No atomics: the result is
// deterministic.  The TPU kernel halves the pair work with Newton's third
// law; on this card the reactions would need atomics or a second pass and
// would change the summation order, so each target gathers its full 3x3
// (the non-Newton form the JAX package's _make_kernel_ext computes).  The
// pair term is pair_math.cuh's, built with -fmad=false (kernels.py), so
// the kernel and its plain twin differ only in summation order: with
// contracted FMAs the magnet ramp turned one rounding into ~3e-4 in fa.

#include <cuda_runtime.h>

#include "pair_region.cuh"

namespace {

constexpr int kTile = 2;        // tile side, cells
constexpr int kThreads = 256;   // threads per block
constexpr int kTermCap = 4096;  // terms in the shared-memory buffer
constexpr int kMaxCap = 32;     // slots a 32-bit mask holds
constexpr int kRegionCells = (kTile + 2) * (kTile + 2);
constexpr int kTileCells = kTile * kTile;

// Dynamic shared memory for C slots: terms, planes, sums, masks, lanes,
// cell bases, target cells / slots / term bases, reach masks, warp totals.  Mirrored by
// kernels.stencil_plan.
size_t smem_bytes(int cap, int has_payload) {
  const size_t max_t = static_cast<size_t>(cap) * kTileCells;
  const size_t planes = static_cast<size_t>(has_payload ? 6 : 5) * cap * kRegionCells;
  return 16 * kTermCap + 4 * (planes + 4 * max_t + 2 * kRegionCells +
                              (kTileCells + 1) + 2 * max_t + (max_t + 1) +
                              9 * max_t + 32);
}

__global__ void __launch_bounds__(kThreads) stencil_forces_kernel(
    const float* __restrict__ px, const float* __restrict__ py,
    const float* __restrict__ vx, const float* __restrict__ vy,
    const float* __restrict__ rad, const float* __restrict__ afac,
    float* __restrict__ fx, float* __restrict__ fy,
    float* __restrict__ fa, float* __restrict__ fr,
    int cap, int g, PairConsts k) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int gg = g * g;
  const int tiles_x = (g + kTile - 1) / kTile;
  const int x0 = (blockIdx.x % tiles_x) * kTile;
  const int y0 = (blockIdx.x / tiles_x) * kTile;
  const int tw = min(kTile, g - x0), th = min(kTile, g - y0);
  const int rw = tw + 2, rh = th + 2, ncell = rh * rw;
  const int max_t = cap * kTileCells;
  const int n_planes = afac ? 6 : 5;

  PairTerm* terms = reinterpret_cast<PairTerm*>(smem);
  float* planes = reinterpret_cast<float*>(terms + kTermCap);
  float* acc = planes + n_planes * cap * kRegionCells;
  unsigned* mask = reinterpret_cast<unsigned*>(acc + 4 * max_t);
  int* lane = reinterpret_cast<int*>(mask + kRegionCells);
  int* cell_base = lane + kRegionCells;
  int* t_cell = cell_base + kTileCells + 1;
  int* t_slot = t_cell + max_t;
  int* t_base = t_slot + max_t;
  unsigned* reach = reinterpret_cast<unsigned*>(t_base + max_t + 1);
  int* warp_tot = reinterpret_cast<int*>(reach + 9 * max_t);

  // stage the tile and its wrapped halo: region cell (ry, rx) is table
  // cell ((y0 + ry - 1) mod G, (x0 + rx - 1) mod G)
  const int plane = cap * ncell;
  for (int e = tid; e < plane; e += kThreads) {
    const int c = e / ncell, cell = e - c * ncell;
    const int ry = cell / rw, rx = cell - ry * rw;
    const int gl = ((y0 + ry - 1 + g) % g) * g + (x0 + rx - 1 + g) % g;
    const int row = c * gg + gl;
    planes[e] = px[row];
    planes[plane + e] = py[row];
    planes[2 * plane + e] = vx[row];
    planes[3 * plane + e] = vy[row];
    planes[4 * plane + e] = rad[row];
    if (afac) planes[5 * plane + e] = afac[row];
    if (c == 0) lane[cell] = gl;
  }
  __syncthreads();
  for (int cell = tid; cell < ncell; cell += kThreads) {
    unsigned m = 0;
    for (int c = 0; c < cap; ++c) {
      if (planes[4 * plane + c * ncell + cell] > 0.f) m |= 1u << c;
    }
    mask[cell] = m;
  }
  __syncthreads();

  const PairRegion r{planes, planes + plane, planes + 2 * plane,
                     planes + 3 * plane, planes + 4 * plane,
                     afac ? planes + 5 * plane : nullptr,
                     mask, lane, rh, rw};
  const PairScratch s{cell_base, t_cell, t_slot, t_base, reach, acc, terms,
                      warp_tot, max_t, kTermCap};
  region_pair_sums(k, r, s);

  // every row of the tile: its target's sums, or zeros when empty
  const int n_tc = th * tw;
  for (int e = tid; e < cap * n_tc; e += kThreads) {
    const int c = e / n_tc, i = e - c * n_tc;
    const int iy = i / tw, ix = i - iy * tw;
    const int row = c * gg + (y0 + iy) * g + x0 + ix;
    float sx = 0.f, sy = 0.f, sa = 0.f, sr = 0.f;
    if (mask[target_cell(r, i)] & (1u << c)) {
      const int t = target_index(r, s, i, c);
      sx = acc[t];
      sy = acc[max_t + t];
      sa = acc[2 * max_t + t];
      sr = acc[3 * max_t + t];
    }
    fx[row] = sx;
    fy[row] = sy;
    fa[row] = sa;
    fr[row] = sr;
  }
}

// the largest dynamic shared memory the kernel has been allowed so far
int g_smem_allowed = 48 * 1024;

}  // namespace

// The launch plan for C slots and side G: out[0] = blocks (2x2 tiles),
// out[1] = dynamic shared memory in bytes.  Returns cudaErrorInvalidValue
// for C outside 1 .. 32 or G < 1.
extern "C" int pbot_stencil_forces_plan(int cap, int g, int has_payload, int* out) {
  if (cap < 1 || cap > kMaxCap || g < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (g + kTile - 1) / kTile;
  out[0] = tiles * tiles;
  out[1] = static_cast<int>(smem_bytes(cap, has_payload));
  return 0;
}

extern "C" int pbot_stencil_forces(
    const void* px, const void* py, const void* vx, const void* vy,
    const void* rad, const void* afac,
    void* fx, void* fy, void* fa, void* fr,
    int cap, int g,
    float cutoff, float spring, float damping, float shear, float attraction,
    float int1, float int2, float min_attr, float inv_int2_sq, float inv_int_span,
    void* stream) {
  int plan[2];
  const int bad = pbot_stencil_forces_plan(cap, g, afac != nullptr, plan);
  if (bad) return bad;
  const PairConsts k{cutoff, spring, damping, shear, attraction,
                     int1, int2, min_attr, inv_int2_sq, inv_int_span};
  if (plan[1] > g_smem_allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        stencil_forces_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, plan[1]);
    if (err != cudaSuccess) return static_cast<int>(err);
    g_smem_allowed = plan[1];
  }
  stencil_forces_kernel<<<plan[0], kThreads, plan[1], static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(px), static_cast<const float*>(py),
      static_cast<const float*>(vx), static_cast<const float*>(vy),
      static_cast<const float*>(rad), static_cast<const float*>(afac),
      static_cast<float*>(fx), static_cast<float*>(fy),
      static_cast<float*>(fa), static_cast<float*>(fr), cap, g, k);
  return static_cast<int>(cudaGetLastError());
}
