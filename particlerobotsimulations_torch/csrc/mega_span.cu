// One ungated rebuild-to-rebuild span of the table loop in one launch —
// kernel 3, the small-table megakernel, on a thread-block cluster.
//
// Replaces: particlerobotsimulations_tpu/ops/megakernel.py make_mega_span
//   (the pallas_call at l.272; kernel body _make_kernel l.125).
//
// Contract: tbl is float32 (13, C, G*G) — the TABLE_FIELDS planes px py vx
// vy rad val afac phase dead aa ar pay bid, slot-major (row c*G*G + lane,
// lane = y*G + x) — and strip is float32 (13, S, 128), the parking strip's
// n_pad rows in the same field order.  step0 is a 0-dim int64 on the
// card, read by the kernel (so a CUDA graph of spans replays at any step).
// The input is mid-step step0 - 1 (after integrate and rebuild).  The
// span runs post(step0 - 1), k - 1 full steps and pre(step0 + k - 1),
// with no gates and no random draws:
//   post = pair forces (table rows only; a row is occupied iff rad > 0,
//          exact 2-D wrap of the 3x3 cells, pair_math.cuh), aa/ar from
//          them, obstacles, stick-slip friction, vx = vy = 0 where
//          val <= 0.5;
//   pre  = radius controller at time f32(step) * f32(dt), then integrate
//          and the world-boundary clamp.
// Every row takes the same arithmetic — empty, parked and padding rows
// alike.  All expressions follow the plain twin (ops/megakernel.py
// mega_span_plain, built from ops/actuation.py, ops/integrate.py and
// ops/forces.py) operation for operation; kernels.py builds with
// -fmad=false, so each product and sum rounds as PyTorch's separate
// elementwise ops round it.  Only the pair sums' order differs from the
// twin: they are added in kernel 1's (oy, ox, slot) order.  The per-row
// post and pre (post_pre_row) live in row_step.cuh, which the row step
// kernel (row_step.cu) shares.
//
// What bounds it on the card: latency, not bytes or arithmetic.  The
// band's table is at most 4096 rows (G=16, C=16) and its strip at most
// 4096 rows; the card's bound for a K=4 span of 1000 bots is ~0.16 us, set
// by bytes (the span reads and writes ~0.5 MB once).  The first design ran
// the span on one block of 1,024 threads on one SM of the 132, each
// occupied target walking its 144 candidate slots serially: ~613 us of
// device time per span (NVIDIA H100 80GB HBM3, 700 W; PERF.md).  The 1000
// HEX bots fill ~92 cells with ~11 bots each, ~97k pair terms per step;
// what is left is the term arithmetic of the busiest CTA (the swarm's
// middle grid rows) and its targets' ordered sums, while the other CTAs
// wait at the step's barrier.
//
// Design: one cluster of N CTAs of 512 threads (N the largest divisor of
// G up to 16: N=16 at G=16; above 8, the portable size, the kernel is
// allowed non-portable clusters), launched with cudaLaunchKernelEx and the
// cluster-dimension attribute.  CTA r owns grid rows [r*G/N, (r+1)*G/N)
// across every slot plane (256 table rows at G=16, C=16) and every N-th
// block of 512 strip rows.  Its rows' moving planes px, py, vx, vy, rad
// are published in its shared memory, twice (ping-pong by step parity);
// the other fields of its rows live in its shared memory too.  Each step a
// CTA
//   1. copies its region — its own grid rows plus the one above and the
//      one below, which belong to CTAs r-1 and r+1 mod N (the y-wrap),
//      each row widened by the wrapped x-halo — out of the owners'
//      published planes through distributed shared memory
//      (cluster.map_shared_rank), and builds a 32-bit occupancy mask per
//      cell (afac, constant over the span, is staged once);
//   2. computes every owned target's pair sums over its 512 threads
//      (pair_region.cuh, the routine of kernel 1): one item per (target,
//      neighbour cell) evaluates the terms of its occupied candidates
//      within reach into a shared-memory buffer of 8,192 terms, then one
//      thread per target adds them in (oy, ox, slot) order;
//   3. runs post + pre on each owned row and writes its moving planes into
//      the other parity's published planes;
//   4. cluster.sync().
// One cluster barrier per step suffices: step j reads parity j and writes
// parity j + 1, which no CTA reads until every CTA has passed step j's
// barrier, and nobody writes parity j again before every CTA has passed
// that barrier too.  The barrier that ends the last step follows every
// remote read, so no CTA exits while another can still read its shared
// memory.  Strip rows see no pair force and read only their own row: each
// thread runs all k steps of its strip rows in registers after the table
// loop, with no barrier.  A seed sweep's batched span path launches B
// scenes at once, one cluster each (the JAX package vmaps the pallas_call,
// which gives its grid a scene axis): cluster b offsets the tables by scene
// b.  At the band's plan the card holds 7 clusters of 16 CTAs at a time
// (cudaOccupancyMaxActiveClusters), so 8 scenes run in two waves; nothing
// assumes that clusters of different scenes are resident together.
// Nothing falls back: a plan that does not fit
// (more than 32 slots, or more shared memory than a CTA has) is refused,
// and kernels.py raises when no cluster of the plan fits on the card.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "pair_region.cuh"
#include "row_step.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;    // threads per CTA
constexpr int kTermCap = 8192;   // terms in each CTA's shared-memory buffer
constexpr int kMaxCluster = 16;  // the largest cluster Hopper allows
constexpr int kPortableCluster = 8;
// slots a 32-bit mask holds.  Kernels 1 and 4 take more words per cell
// (pair_region.cuh's kW = 0); this kernel keeps one, because the span path
// takes only tables of at most kMaxRows = G*G*C rows with G >= 16
// (ops/megakernel.mega_eligible), so C never passes 16 here.
constexpr int kMaxCap = 32;
constexpr int kMaxRows = 4096;   // table and strip rows (MAX_ROWS)
constexpr int kPubPlanes = 5;    // px, py, vx, vy, rad
constexpr int kRowFields = 6;    // val, phase, dead, pay, aa, ar
constexpr int kFields = 13;
constexpr int kStaticSmem = 4 * (4 * kMaxRect + 3 * kMaxCirc);
constexpr int kSmemPerBlock = 232448;  // 227 KB, the opt-in maximum

__device__ __forceinline__ Row load_row(const float* p, int n, int i) {
  Row r;
  r.px = p[PX * n + i];
  r.py = p[PY * n + i];
  r.vx = p[VX * n + i];
  r.vy = p[VY * n + i];
  r.rad = p[RAD * n + i];
  r.val = p[VAL * n + i];
  r.phase = p[PHASE * n + i];
  r.dead = p[DEAD * n + i];
  r.pay = p[PAY * n + i];
  r.aa = p[AA * n + i];
  r.ar = p[AR * n + i];
  return r;
}

__device__ __forceinline__ void store_moving(float* p, int n, int i, const Row& r) {
  p[PX * n + i] = r.px;
  p[PY * n + i] = r.py;
  p[VX * n + i] = r.vx;
  p[VY * n + i] = r.vy;
  p[RAD * n + i] = r.rad;
  p[AA * n + i] = r.aa;
  p[AR * n + i] = r.ar;
}

// The cluster plan of a (C, G) table; mirrored by kernels.mega_plan.
struct MegaPlan {
  int n;      // CTAs in the cluster
  int th;     // grid rows per CTA
  int rows;   // table rows per CTA
  int ncell;  // cells of a CTA's region: (th + 2) x (G + 2)
  int smem;   // dynamic shared memory per CTA, bytes
};

MegaPlan mega_plan(int cap, int g, int has_payload) {
  MegaPlan p;
  p.n = 1;
  for (int d = kMaxCluster; d >= 1; --d) {
    if (g % d == 0) {
      p.n = d;
      break;
    }
  }
  p.th = g / p.n;
  p.rows = cap * p.th * g;
  p.ncell = (p.th + 2) * (g + 2);
  const long long own = static_cast<long long>(p.th) * g;
  const long long words =
      static_cast<long long>(has_payload ? 6 : 5) * cap * p.ncell  // region
      + 2LL * kPubPlanes * p.rows                                   // published
      + static_cast<long long>(kRowFields) * p.rows                 // row fields
      + 4LL * p.rows                                                // sums
      + 4LL * p.ncell                                               // mask, lane, source
      + (own + 1) + 2LL * p.rows + (p.rows + 1) + 9LL * p.rows + 32;  // scratch
  const long long bytes = 16LL * kTermCap + 4 * words;
  p.smem = bytes > kSmemPerBlock ? kSmemPerBlock + 1 : static_cast<int>(bytes);
  return p;
}

__global__ void __launch_bounds__(kThreads, 1) mega_span_kernel(
    const float* __restrict__ tbl, const float* __restrict__ strip,
    float* __restrict__ tbl_out, float* __restrict__ strip_out,
    int cap, int g, int n_strip, int k_steps,
    const long long* __restrict__ step0_ptr, MegaConsts c, Obstacles obs,
    int has_payload) {
  cg::cluster_group cluster = cg::this_cluster();
  const long long step0 = *step0_ptr;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float s_rect[4 * kMaxRect];
  __shared__ float s_circ[3 * kMaxCirc];
  const int tid = threadIdx.x;
  // one cluster per scene: cluster b holds CTAs [b * n, (b + 1) * n)
  const int n = static_cast<int>(cluster.num_blocks());
  const int me = static_cast<int>(cluster.block_rank());
  const int gg = g * g, rows_all = cap * gg;
  const size_t scene = blockIdx.x / n;
  tbl += scene * kFields * rows_all;
  tbl_out += scene * kFields * rows_all;
  strip += scene * kFields * n_strip;
  strip_out += scene * kFields * n_strip;
  const int th = g / n, y0 = me * th;
  const int own = th * g;        // owned cells: lanes y0*G .. y0*G + own - 1
  const int rows = cap * own;    // owned table rows
  const int rw = g + 2, rh = th + 2, ncell = rh * rw;
  const int plane = cap * ncell;
  const int n_planes = has_payload ? 6 : 5;

  PairTerm* terms = reinterpret_cast<PairTerm*>(smem);
  float* region = reinterpret_cast<float*>(terms + kTermCap);
  float* pub = region + n_planes * plane;          // (2, 5, rows)
  float* rowf = pub + 2 * kPubPlanes * rows;       // (6, rows)
  float* acc = rowf + kRowFields * rows;           // (4, rows)
  unsigned* mask = reinterpret_cast<unsigned*>(acc + 4 * rows);
  int* lane = reinterpret_cast<int*>(mask + ncell);
  int* src_rank = lane + ncell;                    // owner CTA of each region cell
  int* src_off = src_rank + ncell;                 // its offset in the owner's planes
  int* cell_base = src_off + ncell;                // own + 1
  int* t_cell = cell_base + own + 1;               // rows
  int* t_slot = t_cell + rows;                     // rows
  int* t_base = t_slot + rows;                     // rows + 1
  unsigned* reach = reinterpret_cast<unsigned*>(t_base + rows + 1);  // 9 * rows
  int* warp_tot = reinterpret_cast<int*>(reach + 9 * rows);          // 32

  // owned row i = (slot c, cell l) is table row c*G*G + y0*G + l
  stage_obstacles(obs, s_rect, s_circ);
  for (int i = tid; i < rows; i += kThreads) {
    const int cc = i / own;
    const int gr = cc * gg + y0 * g + (i - cc * own);
#pragma unroll
    for (int f = 0; f < kPubPlanes; ++f) pub[f * rows + i] = tbl[f * rows_all + gr];
    rowf[i] = tbl[VAL * rows_all + gr];
    rowf[rows + i] = tbl[PHASE * rows_all + gr];
    rowf[2 * rows + i] = tbl[DEAD * rows_all + gr];
    rowf[3 * rows + i] = tbl[PAY * rows_all + gr];
    rowf[4 * rows + i] = tbl[AA * rows_all + gr];
    rowf[5 * rows + i] = tbl[AR * rows_all + gr];
  }
  // region cell (ry, rx) is table cell ((y0 + ry - 1) mod G, (rx - 1) mod G)
  for (int e = tid; e < plane; e += kThreads) {
    const int cc = e / ncell, cell = e - cc * ncell;
    const int ry = cell / rw, rx = cell - ry * rw;
    const int gl = ((y0 + ry - 1 + g) % g) * g + (rx - 1 + g) % g;
    if (has_payload) region[5 * plane + e] = tbl[AFAC * rows_all + cc * gg + gl];
    if (cc == 0) {
      const int gy = gl / g, owner = gy / th;
      lane[cell] = gl;
      src_rank[cell] = owner;
      src_off[cell] = (gy - owner * th) * g + gl % g;
    }
  }
  cluster.sync();  // every CTA's parity-0 planes are published

  const PairRegion r{region, region + plane, region + 2 * plane,
                     region + 3 * plane, region + 4 * plane,
                     has_payload ? region + 5 * plane : nullptr,
                     mask, lane, rh, rw};
  const PairScratch s{cell_base, t_cell, t_slot, t_base, reach, acc, terms,
                      warp_tot, rows, kTermCap};
  for (int j = 0; j < k_steps; ++j) {
    // iteration j: post(step0 + j - 1), then pre(step0 + j)
    const float time = static_cast<float>(step0 + j) * c.dt;
    float* cur = pub + (j & 1) * kPubPlanes * rows;
    float* nxt = pub + ((j + 1) & 1) * kPubPlanes * rows;

    // 1. the region's moving planes from their owners, local or remote:
    //    five loads in flight per (slot, cell)
    for (int e = tid; e < plane; e += kThreads) {
      const int cc = e / ncell, cell = e - cc * ncell;
      const int owner = src_rank[cell];
      const float* src = (owner == me ? cur : cluster.map_shared_rank(cur, owner)) +
                         cc * own + src_off[cell];
      float v[kPubPlanes];
#pragma unroll
      for (int f = 0; f < kPubPlanes; ++f) v[f] = src[f * rows];
#pragma unroll
      for (int f = 0; f < kPubPlanes; ++f) region[f * plane + e] = v[f];
    }
    __syncthreads();
    for (int cell = tid; cell < ncell; cell += kThreads) {
      unsigned m = 0;
      for (int cc = 0; cc < cap; ++cc) {
        if (region[4 * plane + cc * ncell + cell] > 0.f) m |= 1u << cc;
      }
      mask[cell] = m;
    }
    __syncthreads();

    // 2. pair sums of the owned targets
    region_pair_sums(c.pair, r, s);

    // 3. post + pre of every owned row
    for (int i = tid; i < rows; i += kThreads) {
      const int cc = i / own, l = i - cc * own;
      float sx = 0.f, sy = 0.f, sa = 0.f, sr = 0.f;
      if (mask[target_cell(r, l)] & (1u << cc)) {
        const int t = target_index(r, s, l, cc);
        sx = acc[t];
        sy = acc[rows + t];
        sa = acc[2 * rows + t];
        sr = acc[3 * rows + t];
      }
      Row w;
      w.px = cur[PX * rows + i];
      w.py = cur[PY * rows + i];
      w.vx = cur[VX * rows + i];
      w.vy = cur[VY * rows + i];
      w.rad = cur[RAD * rows + i];
      w.val = rowf[i];
      w.phase = rowf[rows + i];
      w.dead = rowf[2 * rows + i];
      w.pay = rowf[3 * rows + i];
      w.aa = rowf[4 * rows + i];
      w.ar = rowf[5 * rows + i];
      post_pre_row(c, s_rect, obs.n_rect, s_circ, obs.n_circ, w, sx, sy, sa, sr, time);
      nxt[PX * rows + i] = w.px;
      nxt[PY * rows + i] = w.py;
      nxt[VX * rows + i] = w.vx;
      nxt[VY * rows + i] = w.vy;
      nxt[RAD * rows + i] = w.rad;
      rowf[4 * rows + i] = w.aa;
      rowf[5 * rows + i] = w.ar;
    }
    // 4. parity j + 1 is published and parity j read by every CTA; after
    //    the last step this is the barrier before the end
    cluster.sync();
  }

  const float* fin = pub + (k_steps & 1) * kPubPlanes * rows;
  for (int i = tid; i < rows; i += kThreads) {
    const int cc = i / own;
    const int gr = cc * gg + y0 * g + (i - cc * own);
#pragma unroll
    for (int f = 0; f < kPubPlanes; ++f) tbl_out[f * rows_all + gr] = fin[f * rows + i];
    tbl_out[AA * rows_all + gr] = rowf[4 * rows + i];
    tbl_out[AR * rows_all + gr] = rowf[5 * rows + i];
    const int kept[6] = {VAL, AFAC, PHASE, DEAD, PAY, BID};
#pragma unroll
    for (int q = 0; q < 6; ++q) {
      tbl_out[kept[q] * rows_all + gr] = tbl[kept[q] * rows_all + gr];
    }
  }

  // parking strip: no pair force, no neighbour reads, all k steps at once
  for (int si = me * kThreads + tid; si < n_strip; si += n * kThreads) {
    Row w = load_row(strip, n_strip, si);
    for (int j = 0; j < k_steps; ++j) {
      const float time = static_cast<float>(step0 + j) * c.dt;
      post_pre_row(c, s_rect, obs.n_rect, s_circ, obs.n_circ, w, 0.f, 0.f, 0.f, 0.f,
                   time);
    }
    for (int f = 0; f < kFields; ++f) strip_out[f * n_strip + si] = strip[f * n_strip + si];
    store_moving(strip_out, n_strip, si, w);
  }
}

// the largest dynamic shared memory the kernel has been allowed so far,
// and whether it may run clusters beyond the portable size
int g_smem_allowed = 48 * 1024;
bool g_nonportable = false;

// Validates the shape and allows the plan's shared memory; cudaSuccess or
// cudaErrorInvalidValue for a shape the plan refuses.
cudaError_t prepare(int cap, int g, int n_strip, int has_payload, MegaPlan* plan) {
  if (cap < 1 || cap > kMaxCap || g < 1 || cap * g * g > kMaxRows ||
      n_strip < 0 || n_strip > kMaxRows) {
    return cudaErrorInvalidValue;
  }
  *plan = mega_plan(cap, g, has_payload);
  if (plan->smem + kStaticSmem > kSmemPerBlock) return cudaErrorInvalidValue;
  if (plan->smem > g_smem_allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        mega_span_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, plan->smem);
    if (err != cudaSuccess) return err;
    g_smem_allowed = plan->smem;
  }
  if (plan->n > kPortableCluster && !g_nonportable) {
    const cudaError_t err = cudaFuncSetAttribute(
        mega_span_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    g_nonportable = true;
  }
  return cudaSuccess;
}

void launch_config(const MegaPlan& plan, int scenes, cudaStream_t stream,
                   cudaLaunchAttribute* attr, cudaLaunchConfig_t* cfg) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = plan.n;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(plan.n * scenes, 1, 1);
  cfg->blockDim = dim3(kThreads, 1, 1);
  cfg->dynamicSmemBytes = plan.smem;
  cfg->stream = stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

}  // namespace

// The cluster plan of a (C, G) table with an n_strip-row strip, for
// `scenes` scenes in one launch: out[0] = CTAs per cluster, out[1] = table
// rows per CTA, out[2] = dynamic shared memory per CTA in bytes, out[3] =
// cudaOccupancyMaxActiveClusters for that launch (how many of the scenes'
// clusters can be resident at once), out[4] = CTAs in the launch.  Returns
// cudaErrorInvalidValue for a shape the plan refuses, else the occupancy
// query's status.
extern "C" int pbot_mega_span_plan(int cap, int g, int n_strip, int has_payload,
                                   int scenes, int* out) {
  MegaPlan plan;
  if (scenes < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = prepare(cap, g, n_strip, has_payload, &plan);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  launch_config(plan, scenes, nullptr, &attr, &cfg);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(
      &clusters, reinterpret_cast<const void*>(mega_span_kernel), &cfg);
  out[0] = plan.n;
  out[1] = plan.rows;
  out[2] = plan.smem;
  out[3] = clusters;
  out[4] = plan.n * scenes;
  return static_cast<int>(err);
}

// One span of `scenes` scenes in one launch, one cluster each: scene b's
// table and strip are the b-th contiguous (13, C, G*G) and (13, S, 128)
// blocks of tbl and strip (and of the outputs); the obstacles (host
// arrays of n_rect x 4 and n_circ x 3 floats, passed by value in the
// launch's parameters as row_step.cuh's Obstacles), constants and the step
// (*step0, an int64 on the card) are shared, the scenes running in
// lockstep.  A cluster reads
// and syncs only within itself, so each scene's outputs equal a one-scene
// launch on its planes bit for bit, whether or not the clusters of other
// scenes are resident at the same time (the card may run them in waves).
// Returns a cudaError_t: cudaErrorInvalidValue for a shape the plan
// refuses (see prepare), an obstacle list larger than the kernel's fixed
// layout, a constants array of the wrong length or fewer than one scene,
// else the launch's own status.
extern "C" int pbot_mega_span(
    const void* tbl, const void* strip, void* tbl_out, void* strip_out,
    int scenes, int cap, int g, int n_strip, int k_steps, const void* step0,
    const float* consts, int n_consts,
    const float* rects, int n_rect, const float* circs, int n_circ,
    int has_payload, void* stream) {
  Obstacles obs;
  if (n_consts != kNumConsts || !load_obstacles(rects, n_rect, circs, n_circ, &obs) ||
      k_steps < 1 || scenes < 1 || step0 == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  MegaPlan plan;
  cudaError_t err = prepare(cap, g, n_strip, has_payload, &plan);
  if (err != cudaSuccess) return static_cast<int>(err);
  MegaConsts c;
  float* dst = reinterpret_cast<float*>(&c);
  for (int i = 0; i < kNumConsts; ++i) dst[i] = consts[i];
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  launch_config(plan, scenes, static_cast<cudaStream_t>(stream), &attr, &cfg);
  err = cudaLaunchKernelEx(
      &cfg, mega_span_kernel,
      static_cast<const float*>(tbl), static_cast<const float*>(strip),
      static_cast<float*>(tbl_out), static_cast<float*>(strip_out),
      cap, g, n_strip, k_steps, static_cast<const long long*>(step0), c, obs,
      has_payload);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
