// Pair-force stencils on slot-major cell tables — kernel 1 of the table
// loop and kernel 4 of the sharded table loop, one tiled body.
//
// Replaces: particlerobotsimulations_tpu/ops/pallas_stencil.py
//   kernel 1: _stencil_forces_pallas (the pallas_call at l.458; kernel body
//     _make_kernel l.329; pair math _pair_block l.171);
//   kernel 4: stencil_forces_pallas_ext (l.516; the pallas_call at l.570;
//     kernel body _make_kernel_ext l.481; _pair_block with
//     newton_center=False), called every step from
//     parallel/spatial_table.py l.306.
//
// Kernel 1's contract: tables px, py, vx, vy, rad (and afac when the scene
// has a payload) are float32 (C, G*G), slot-major (row c*G*G + lane, lane
// = y*G + x), any C whose plan fits a block's shared memory (C <= 144
// without a payload, <= 136 with one).  A row is occupied iff rad > 0.
// For every occupied target row the kernel sums, over every occupied
// candidate row in the 3x3 cells around it (exact 2-D wrap, the target
// itself excluded), the DEM contact force and the three-piece magnet law,
// and writes fx, fy, the attraction magnitude sum fa and the contact
// magnitude sum fr.  Empty rows get zeros.  One launch may take B such
// tables (the batched table loop of a seed sweep, where the JAX package
// vmaps the pallas_call and so gives its grid a scene axis): scene b's
// planes sit b * sstride floats on and its tiles are blocks b * tiles ..,
// the way kernel 4 takes its shards.
//
// Kernel 4's contract: seven float32 planes px, py, vx, vy, rad, val, afac
// of shape (S, C, E) — S shards, C force-visible slots (as kernel 1), E =
// H + L0 + H extended lanes ([H pad | L0 center | H pad], H and L0
// multiples of G, lane = y*G + x).  Each plane's (C, E) block is contiguous; the shards sit
// `sstride` floats apart (the planes may be views of one stacked tensor).
// afac is read only with a payload (null otherwise).  A row is occupied iff
// its val is nonzero.  The same sums for every occupied CENTER target row
// (s, c, H + t), written to (S, C, L0) outputs.  The neighbour lane of
// target lane H + t (x = t % G) at offset (ox, oy) is H + t + oy*G + ((x +
// ox + G) % G - x): the exact x-wrap of the JAX flat preshift
// (_preshift_flat l.107) with y read linearly into the halo rows.
//
// Both add the terms in (oy, ox, slot) order, each offset and slot
// ascending from -1 and 0, so kernel 4's centre lanes equal kernel 1's
// outputs on the same whole table bit for bit, which keeps the sharded
// loop bitwise equal to the single-table loop.
//
// What bounds them on the card: latency and the serial sums, not bytes or
// arithmetic.  At 10k bots (G=48, C=16) 830 of the 2,304 cells are
// occupied, ~12 bots each: ~10k targets with ~108 occupied candidates
// each, 1.09M pair terms of ~40 flops (~44 MFLOP: 0.65 us at 67 TFLOP/s
// float32), and 0.40 us of bytes at 3.35 TB/s (NVIDIA H100 80GB HBM3,
// 700 W).  The first designs, one thread per target row walking its 144
// candidate slots serially out of global memory, took ~65 us (kernel 1)
// and ~75 us (kernel 4): about 2.4 busy warps per SM, divergent between
// empty and occupied lanes and between the contact, magnet and no-force
// branches (PERF.md).  A target's terms must be added one after another
// to keep the order; that chain is what no design can spread.
//
// Design: one block of 256 threads per 2x2 tile of target cells across all
// C slots, per shard (576 blocks at G=48, 1,024 at G=64 whole or in 4
// shards, 6,400 at G=160).  The block stages the tile and its one-cell
// halo (4x4 cells x C slots of px, py, vx, vy, rad, and afac with a
// payload: 6 KB at C=16) into shared memory once, with ceil(C / 32) 32-bit
// occupancy words per cell, and hands the rest to pair_region.cuh: one
// work item per (occupied target, neighbour cell) finds its candidates
// from the masks' set bits, drops those certainly beyond the cutoff and
// contact distance (two thirds of them at 10k bots: 350k of 1.09M pairs
// are within reach), and evaluates the rest's terms into a shared-memory
// buffer (4,096 terms) at offsets from popcounts; then one thread per
// target adds its terms sequentially in the serial order.  Empty slots and unreachable
// candidates cost no term, the term arithmetic of a target is spread over
// nine threads, and a dense tile's work over as many blocks as there are
// 2x2 tiles.  No atomics on results: they are deterministic.  The two
// kernels differ only in the table policy (TableMap below): where a region
// cell's rows lie, and which rows are occupied.  The TPU kernel halves the
// pair work with Newton's third law; on this card the reactions would need
// atomics or a second pass and would change the summation order, so each
// target gathers its full 3x3 (the non-Newton form the JAX package's
// _make_kernel_ext computes).  The pair term is pair_math.cuh's, built
// with -fmad=false (kernels.py), so the kernels and their plain twins
// differ only in summation order: with contracted FMAs the magnet ramp
// turned one rounding into ~3e-4 in fa.
//
// Past 32 slots a cell's occupancy takes more than one word.  Tables of up
// to 32 slots run the one-word instantiation (kW = 1), whose code is the
// 32-slot kernel's; larger ones the run-time-words one (kW = 0).  Both
// visit the slots in ascending order, so the sums keep the serial order.
// A target has at most 9 * C terms; every C whose plan fits shared memory
// keeps that below the term buffer, so one target always fits a window.

#include <cuda_runtime.h>

#include "pair_region.cuh"

namespace {

constexpr int kTile = 2;        // tile side, cells
constexpr int kThreads = 256;   // threads per block
constexpr int kTermCap = 4096;  // terms in the shared-memory buffer
constexpr int kMaskBits = 32;   // slots per occupancy word
constexpr int kSmemPerBlock = 232448;  // the most a block may opt into
constexpr int kRegionCells = (kTile + 2) * (kTile + 2);
constexpr int kTileCells = kTile * kTile;

// occupancy words per cell for C slots
__host__ __device__ constexpr int cap_words(int cap) {
  return (cap + kMaskBits - 1) / kMaskBits;
}

// Dynamic shared memory for C slots: terms, planes, sums, masks, lanes,
// cell bases, target cells / slots / term bases, reach words, warp totals.
// Mirrored by kernels.stencil_plan.
size_t smem_bytes(int cap, int has_payload) {
  const size_t max_t = static_cast<size_t>(cap) * kTileCells;
  const size_t nw = static_cast<size_t>(cap_words(cap));
  const size_t planes = static_cast<size_t>(has_payload ? 6 : 5) * cap * kRegionCells;
  return 16 * kTermCap + 4 * (planes + 4 * max_t + (nw + 1) * kRegionCells +
                              (kTileCells + 1) + 2 * max_t + (max_t + 1) +
                              9 * max_t * nw + 32);
}

// Where the tables' rows lie.  Grid row y (-1 .. rows) and column x (-1 ..
// G) of a shard's targets are at lane(y, x) of its input planes (row c *
// in_stride + lane) and, for targets, at output row c * rows * G + y * G +
// x.  kExt false: kernel 1, one whole table, exact 2-D wrap, occupancy rad
// > 0.  kExt true: kernel 4, halo-extended shards, x-wrap per row, y read
// linearly into the halo rows from lane h, occupancy val != 0.
template <bool kExt>
struct TableMap {
  int g, rows, h, in_stride;
  long long sstride;
  __device__ int lane(int y, int x) const {
    const int xw = (x + g) % g;
    return kExt ? h + y * g + xw : ((y + g) % g) * g + xw;
  }
};

template <bool kExt, int kW>
__device__ __forceinline__ void stencil_tile(
    const float* __restrict__ px, const float* __restrict__ py,
    const float* __restrict__ vx, const float* __restrict__ vy,
    const float* __restrict__ rad, const float* __restrict__ val,
    const float* __restrict__ afac,
    float* __restrict__ fx, float* __restrict__ fy,
    float* __restrict__ fa, float* __restrict__ fr,
    int cap, const TableMap<kExt> t, const PairConsts& k) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int g = t.g;
  const int tiles_x = (g + kTile - 1) / kTile;
  const int tiles = tiles_x * ((t.rows + kTile - 1) / kTile);
  const int shard = blockIdx.x / tiles, tile = blockIdx.x - shard * tiles;
  const int x0 = (tile % tiles_x) * kTile;
  const int y0 = (tile / tiles_x) * kTile;
  const int tw = min(kTile, g - x0), th = min(kTile, t.rows - y0);
  const int rw = tw + 2, rh = th + 2, ncell = rh * rw;
  const int max_t = cap * kTileCells;
  const int nw = kW ? kW : cap_words(cap);
  const int n_planes = afac ? 6 : 5;
  const long long in0 = shard * t.sstride;
  const size_t out0 = static_cast<size_t>(shard) * cap * t.rows * g;
  const int out_stride = t.rows * g;

  PairTerm* terms = reinterpret_cast<PairTerm*>(smem);
  float* planes = reinterpret_cast<float*>(terms + kTermCap);
  float* acc = planes + n_planes * cap * kRegionCells;
  unsigned* mask = reinterpret_cast<unsigned*>(acc + 4 * max_t);
  int* lane = reinterpret_cast<int*>(mask + kRegionCells * nw);
  int* cell_base = lane + kRegionCells;
  int* t_cell = cell_base + kTileCells + 1;
  int* t_slot = t_cell + max_t;
  int* t_base = t_slot + max_t;
  unsigned* reach = reinterpret_cast<unsigned*>(t_base + max_t + 1);
  int* warp_tot = reinterpret_cast<int*>(reach + 9 * max_t * nw);

  // region cell (ry, rx) is the tables' cell (y0 + ry - 1, x0 + rx - 1)
  for (int cell = tid; cell < ncell; cell += kThreads) {
    const int ry = cell / rw, rx = cell - ry * rw;
    lane[cell] = t.lane(y0 + ry - 1, x0 + rx - 1);
    for (int w = 0; w < nw; ++w) mask[cell * nw + w] = 0u;
  }
  __syncthreads();
  // stage the region's planes and set each occupied row's mask bit
  const int plane = cap * ncell;
  for (int e = tid; e < plane; e += kThreads) {
    const int c = e / ncell, cell = e - c * ncell;
    const long long row = in0 + static_cast<long long>(c) * t.in_stride + lane[cell];
    const float r = rad[row];
    planes[e] = px[row];
    planes[plane + e] = py[row];
    planes[2 * plane + e] = vx[row];
    planes[3 * plane + e] = vy[row];
    planes[4 * plane + e] = r;
    if (afac) planes[5 * plane + e] = afac[row];
    if (kExt ? val[row] != 0.f : r > 0.f) {
      atomicOr(&mask[cell * nw + c / kMaskBits], 1u << (c % kMaskBits));
    }
  }
  __syncthreads();

  const PairRegion reg{planes, planes + plane, planes + 2 * plane,
                       planes + 3 * plane, planes + 4 * plane,
                       afac ? planes + 5 * plane : nullptr,
                       mask, lane, rh, rw, nw};
  const PairScratch s{cell_base, t_cell, t_slot, t_base, reach, acc, terms,
                      warp_tot, max_t, kTermCap};
  region_pair_sums<kW>(k, reg, s);

  // every row of the tile: its target's sums, or zeros when empty
  const int n_tc = th * tw;
  for (int e = tid; e < cap * n_tc; e += kThreads) {
    const int c = e / n_tc, i = e - c * n_tc;
    const int iy = i / tw, ix = i - iy * tw;
    const size_t row = out0 + static_cast<size_t>(c) * out_stride + (y0 + iy) * g + x0 + ix;
    float sx = 0.f, sy = 0.f, sa = 0.f, sr = 0.f;
    if (is_target<kW>(reg, i, c)) {
      const int ti = target_index<kW>(reg, s, i, c);
      sx = acc[ti];
      sy = acc[max_t + ti];
      sa = acc[2 * max_t + ti];
      sr = acc[3 * max_t + ti];
    }
    fx[row] = sx;
    fy[row] = sy;
    fa[row] = sa;
    fr[row] = sr;
  }
}

template <int kW>
__global__ void __launch_bounds__(kThreads) stencil_forces_kernel(
    const float* __restrict__ px, const float* __restrict__ py,
    const float* __restrict__ vx, const float* __restrict__ vy,
    const float* __restrict__ rad, const float* __restrict__ afac,
    float* __restrict__ fx, float* __restrict__ fy,
    float* __restrict__ fa, float* __restrict__ fr,
    int cap, TableMap<false> t, PairConsts k) {
  stencil_tile<false, kW>(px, py, vx, vy, rad, nullptr, afac, fx, fy, fa, fr, cap, t, k);
}

template <int kW>
__global__ void __launch_bounds__(kThreads) stencil_forces_ext_kernel(
    const float* __restrict__ px, const float* __restrict__ py,
    const float* __restrict__ vx, const float* __restrict__ vy,
    const float* __restrict__ rad, const float* __restrict__ val,
    const float* __restrict__ afac,
    float* __restrict__ fx, float* __restrict__ fy,
    float* __restrict__ fa, float* __restrict__ fr,
    int cap, TableMap<true> t, PairConsts k) {
  stencil_tile<true, kW>(px, py, vx, vy, rad, val, afac, fx, fy, fa, fr, cap, t, k);
}

// Lets `kernel` take `bytes` of dynamic shared memory; `allowed` is the
// most it has been allowed so far (48 KB needs no attribute).
int allow_smem(const void* kernel, int bytes, int* allowed) {
  if (bytes <= *allowed) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  *allowed = bytes;
  return 0;
}

// the most each instantiation has been allowed: [kernel 4][words run-time]
int g_smem[2][2] = {{48 * 1024, 48 * 1024}, {48 * 1024, 48 * 1024}};

}  // namespace

// The launch plan for C slots, side G and `rows` grid rows of targets in
// each of `shards` shards (kernel 1: rows = G, one shard): out[0] = blocks
// (2x2 tiles of every shard), out[1] = dynamic shared memory in bytes.
// Returns cudaErrorInvalidValue for C, G, rows or shards below 1, or a C
// whose shared memory exceeds a block's (or whose 9 * C terms of one
// target would outgrow the term buffer, which no such C reaches).
extern "C" int pbot_stencil_forces_plan(int cap, int g, int rows, int shards,
                                        int has_payload, int* out) {
  if (cap < 1 || g < 1 || rows < 1 || shards < 1 || 9 * cap > kTermCap ||
      smem_bytes(cap, has_payload) > static_cast<size_t>(kSmemPerBlock)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  out[0] = ((g + kTile - 1) / kTile) * ((rows + kTile - 1) / kTile) * shards;
  out[1] = static_cast<int>(smem_bytes(cap, has_payload));
  return 0;
}

// Kernel 1 on `scenes` whole tables in one launch: scene b's planes start
// b * sstride floats after the pointers given (a (C, G*G) block each, rows
// G*G apart), its outputs are the b-th contiguous (C, G*G) block.  Scene b
// takes blocks [b * tiles, (b + 1) * tiles) and runs the single table's
// body on them, so its outputs equal a one-scene launch on its planes bit
// for bit.  The table loop's single scene is scenes = 1.
extern "C" int pbot_stencil_forces(
    const void* px, const void* py, const void* vx, const void* vy,
    const void* rad, const void* afac,
    void* fx, void* fy, void* fa, void* fr,
    int scenes, int cap, int g, long long sstride,
    float cutoff, float spring, float damping, float shear, float attraction,
    float int1, float int2, float min_attr, float inv_int2_sq, float inv_int_span,
    void* stream) {
  int plan[2];
  int err = pbot_stencil_forces_plan(cap, g, g, scenes, afac != nullptr, plan);
  if (err) return err;
  const bool wide = cap > kMaskBits;
  auto* kernel = wide ? stencil_forces_kernel<0> : stencil_forces_kernel<1>;
  err = allow_smem(reinterpret_cast<const void*>(kernel), plan[1], &g_smem[0][wide]);
  if (err) return err;
  const PairConsts k{cutoff, spring, damping, shear, attraction,
                     int1, int2, min_attr, inv_int2_sq, inv_int_span};
  const TableMap<false> t{g, g, 0, g * g, sstride};
  kernel<<<plan[0], kThreads, plan[1], static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(px), static_cast<const float*>(py),
      static_cast<const float*>(vx), static_cast<const float*>(vy),
      static_cast<const float*>(rad), static_cast<const float*>(afac),
      static_cast<float*>(fx), static_cast<float*>(fy),
      static_cast<float*>(fa), static_cast<float*>(fr), cap, t, k);
  return static_cast<int>(cudaGetLastError());
}

// Kernel 4 on `shards` halo-extended shard tables; `center` lanes from
// lane h (both multiples of g, h >= g; the wrapper checks them).
extern "C" int pbot_stencil_forces_ext(
    const void* px, const void* py, const void* vx, const void* vy,
    const void* rad, const void* val, const void* afac,
    void* fx, void* fy, void* fa, void* fr,
    int shards, int cap, int g, int ext, int h, int center, long long sstride,
    float cutoff, float spring, float damping, float shear, float attraction,
    float int1, float int2, float min_attr, float inv_int2_sq, float inv_int_span,
    void* stream) {
  int plan[2];
  int err = pbot_stencil_forces_plan(cap, g, center / g, shards, afac != nullptr, plan);
  if (err) return err;
  const bool wide = cap > kMaskBits;
  auto* kernel = wide ? stencil_forces_ext_kernel<0> : stencil_forces_ext_kernel<1>;
  err = allow_smem(reinterpret_cast<const void*>(kernel), plan[1], &g_smem[1][wide]);
  if (err) return err;
  const PairConsts k{cutoff, spring, damping, shear, attraction,
                     int1, int2, min_attr, inv_int2_sq, inv_int_span};
  const TableMap<true> t{g, center / g, h, ext, sstride};
  kernel<<<plan[0], kThreads, plan[1], static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(px), static_cast<const float*>(py),
      static_cast<const float*>(vx), static_cast<const float*>(vy),
      static_cast<const float*>(rad), static_cast<const float*>(val),
      static_cast<const float*>(afac),
      static_cast<float*>(fx), static_cast<float*>(fy),
      static_cast<float*>(fa), static_cast<float*>(fr), cap, t, k);
  return static_cast<int>(cudaGetLastError());
}
