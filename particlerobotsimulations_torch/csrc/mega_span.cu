// One ungated rebuild-to-rebuild span of the table loop in one launch —
// kernel 3, the small-table megakernel.
//
// Replaces: particlerobotsimulations_tpu/ops/megakernel.py make_mega_span
//   (the pallas_call at l.272; kernel body _make_kernel l.125).
//
// Contract: tbl is float32 (13, C, G*G) — the TABLE_FIELDS planes px py vx
// vy rad val afac phase dead aa ar pay bid, slot-major (row c*G*G + lane,
// lane = y*G + x) — and strip is float32 (13, S, 128), the parking strip's
// n_pad rows in the same field order.  The input is mid-step step0 - 1
// (after integrate and rebuild).  The span runs post(step0 - 1), k - 1
// full steps and pre(step0 + k - 1), with no gates and no random draws:
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
// twin.
//
// What bounds it on the card: one thread block on one SM.  The band's
// table is at most 4096 rows (G=16, C=16) and its strip at most 4096 rows.
// The card's bound for a K=4 span of 1000 bots is ~0.16 us, set by bytes
// (the span reads and writes ~0.5 MB once; the ~3.5 MFLOP it needs take
// 0.05 us at the float32 rate); the kernel takes ~700 us (PERF.md), issue-
// bound on its one SM.  What the launch removes is the host: the regular
// loop dispatches ~150 PyTorch ops per step.
//
// Design: one block of 1024 threads runs the whole span, its k steps
// looped inside; thread t owns table rows t, t + 1024, t + 2048, t + 3072
// and the strip rows of the same numbers.  The planes that neighbours read
// (px, py, vx, vy, rad, and afac with a payload) live in dynamic shared
// memory, up to 6 x 16 KB; the other fields stay in the output buffer,
// read and written only by the row's owner.  Each step computes every
// owned row's pair sums into registers, then __syncthreads() (post reads
// its neighbours' px, py, vx, vy, rad and then writes its own vx, vy),
// then post + pre per owned row, then __syncthreads() before the next
// step's reads.  Strip rows see no pair force and read only their own
// row: each thread runs all k steps of its strip rows in registers after
// the table loop, with no barrier.  The design maps onto the batched span
// (B scenes, B blocks across the SMs) unchanged.  A cooperative grid over
// several SMs is left for later, if one SM proves too slow.

#include <cuda_runtime.h>

#include "pair_math.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kRowsPerThread = 4;
constexpr int kFields = 13;
constexpr int kMaxRect = 10;
constexpr int kMaxCirc = 10;

// TABLE_FIELDS order
enum Field { PX, PY, VX, VY, RAD, VAL, AFAC, PHASE, DEAD, AA, AR, PAY, BID };

// float32 parameters, in kernels.py mega_constants order (MEGA_CONSTS)
struct MegaConsts {
  PairConsts pair;
  float dt;
  // radius controller (ops/actuation.py)
  float period, rise, min_r, max_r, constraint, max_speed, phase_frozen;
  float constrained, cc;  // constrained_contraction (1 or 0) and its gain
  // integrate (ops/integrate.py)
  float half, bd;
  // obstacles + friction (ops/forces.py)
  float spring, damping, shear, friction, friction_factor, gravity,
      mass_factor, inv_mass_factor;
};
constexpr int kNumConsts = sizeof(MegaConsts) / sizeof(float);

// the fields post + pre read (aa and ar are written by post before pre
// reads them) and write
struct Row {
  float px, py, vx, vy, rad, val, phase, dead, pay, aa, ar;
};

__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;  // torch.clamp(x, min=lo)
}

__device__ __forceinline__ float norm2(float x, float y) {
  return sqrtf(clamp_min(x * x + y * y, 1.0e-30f));
}

// ops/forces.py obstacle_forces_xy: one DEM term against an obstacle
__device__ __forceinline__ void obstacle_dem(
    const MegaConsts& c, const Row& r, float dirx, float diry, float overlap,
    bool hit, float& fx, float& fy, float& mr) {
  const float rvx = -r.vx, rvy = -r.vy;
  const float vn = rvx * dirx + rvy * diry;
  const float tanx = rvx - vn * dirx;
  const float tany = rvy - vn * diry;
  const float s2 = -2.0f * c.spring;
  const float ffx = s2 * overlap * dirx + c.damping * rvx + c.shear * tanx;
  const float ffy = s2 * overlap * diry + c.damping * rvy + c.shear * tany;
  fx = fx + (hit ? ffx : 0.f);
  fy = fy + (hit ? ffy : 0.f);
  mr = mr + (hit ? norm2(ffx, ffy) : 0.f);
}

__device__ void obstacle_forces(
    const MegaConsts& c, const float* rect, int n_rect, const float* circ,
    int n_circ, const Row& r, float& fx, float& fy, float& mr) {
  const float eps = 1.0e-12f;
  fx = 0.f;
  fy = 0.f;
  mr = 0.f;
  for (int i = 0; i < n_circ; ++i) {
    const float cx = circ[3 * i], cy = circ[3 * i + 1], cr = circ[3 * i + 2];
    const float tcx = cx - r.px;
    const float tcy = cy - r.py;
    const float d2 = tcx * tcx + tcy * tcy;
    const float rs = r.rad + cr;
    const bool hit = d2 < rs * rs;
    const float inv = 1.0f / clamp_min(norm2(tcx, tcy), eps);
    const float overlap = rs - sqrtf(clamp_min(d2, eps));
    obstacle_dem(c, r, tcx * inv, tcy * inv, overlap, hit, fx, fy, mr);
  }
  for (int i = 0; i < n_rect; ++i) {
    const float x1 = rect[4 * i], x2 = rect[4 * i + 1];
    const float y1 = rect[4 * i + 2], y2 = rect[4 * i + 3];
    const float px = r.px, py = r.py, rad = r.rad;
    const bool in_y = (py > y1) && (py < y2);
    const bool in_x = (px > x1) && (px < x2);
    const bool left = in_y && (px > x1 - rad) && (px < x2 - rad);
    const bool right = in_y && (px < x2 + rad) && (px > x1 + rad);
    const bool bottom = !in_y && in_x && (py > y1 - rad) && (py < y2 - rad);
    const bool top = !in_y && in_x && (py < y2 + rad) && (py > y1 + rad);
    const bool side_hit = left || right || bottom || top;
    // sides: the reference's sequential ifs, the later one wins
    float sdx = 1.f, sdy = 0.f, side_over = px - x1 + rad;
    if (right) { sdx = -1.f; sdy = 0.f; side_over = -px + x2 + rad; }
    if (bottom) { sdx = 0.f; sdy = 1.f; side_over = py - y1 + rad; }
    if (top) { sdx = 0.f; sdy = -1.f; side_over = -py + y2 + rad; }
    // corners: the reference's elif chain, the first one wins
    bool corner_hit = false;
    float cdx = 0.f, cdy = 0.f, corner_over = 0.f;
    const float corx[4] = {x2, x1, x1, x2};
    const float cory[4] = {y2, y2, y1, y1};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float dvx = px - corx[q];
      const float dvy = py - cory[q];
      const float d = norm2(dvx, dvy);
      const bool hit_c = (d < rad) && !in_y && !in_x && !corner_hit;
      const float inv = 1.0f / clamp_min(d, eps);
      if (hit_c) {
        cdx = -dvx * inv;
        cdy = -dvy * inv;
        corner_over = rad - d;
      }
      corner_hit = corner_hit || hit_c;
    }
    const bool hit = side_hit || corner_hit;
    obstacle_dem(c, r, side_hit ? sdx : cdx, side_hit ? sdy : cdy,
                 side_hit ? side_over : corner_over, hit, fx, fy, mr);
  }
}

// post (obstacles, friction, validity) then pre (radius, integrate) of one
// row whose pair sums are fx, fy, fa, fr (zero for strip rows)
__device__ void post_pre_row(
    const MegaConsts& c, const float* rect, int n_rect, const float* circ,
    int n_circ, Row& r, float fx, float fy, float fa, float fr, float time) {
  const float eps = 1.0e-12f;
  // ---- post: aa/ar, obstacles, friction (ops/forces.py)
  r.aa = fa;
  r.ar = fr;
  if (n_rect + n_circ > 0) {
    float ofx, ofy, om;
    obstacle_forces(c, rect, n_rect, circ, n_circ, r, ofx, ofy, om);
    r.ar = r.ar + om;
    fx = fx + ofx;
    fy = fy + ofy;
  }
  const bool pay = r.pay > 0.5f;
  const float fric = c.friction * (pay ? c.friction_factor : 1.f);
  const float grav = c.gravity * (pay ? c.mass_factor : 1.f);
  const float speed = norm2(r.vx, r.vy);
  const float fmag = norm2(fx, fy);
  if ((speed < 1.0e-6f) && (fmag < 2.0f * fric * grav)) {
    fx = 0.f;
    fy = 0.f;
  }
  const float inv_mass_dt = (pay ? c.inv_mass_factor : 1.f) * c.dt;
  float vx = r.vx + fx * inv_mass_dt;
  float vy = r.vy + fy * inv_mass_dt;
  const float new_speed = norm2(vx, vy);
  const float kin = fric * grav * c.dt;
  const float inv = clamp_min(new_speed, eps);
  const bool stopped = new_speed < kin;
  vx = stopped ? 0.f : vx - kin * (vx / inv);
  vy = stopped ? 0.f : vy - kin * (vy / inv);
  const bool val = r.val > 0.5f;
  r.vx = val ? vx : 0.f;
  r.vy = val ? vy : 0.f;

  // ---- pre: radius controller (ops/actuation.py update_radius)
  const float period = c.period, rise = c.rise;
  const float min_r = c.min_r, max_r = c.max_r;
  float t1 = time + r.phase;
  if (t1 < 0.f) t1 = t1 + 100.0f * period;
  if (t1 >= period) t1 = t1 - period * floorf(t1 / period);
  const bool in_window = t1 < 2.0f * rise;
  const float target = (t1 <= rise)
      ? min_r + (max_r - min_r) / rise * t1
      : max_r + (min_r - max_r) / rise * (t1 - rise);
  const float rad = r.rad;
  const float dr1 = target - rad;
  const float safe_rad = clamp_min(rad, 1.0e-9f);
  float torque = dr1 * c.constraint * rad / c.max_speed / max_r / c.dt;
  torque = torque > c.constraint ? c.constraint : torque;
  const float surplus = torque / safe_rad;
  const float expand = surplus > r.ar
      ? c.max_speed * max_r / c.constraint * (surplus - r.ar) * c.dt
      : 0.f;
  float contract = dr1;
  if (c.constrained > 0.5f) {
    contract = (-c.cc * dr1 > r.aa * rad) ? (c.cc * dr1 + r.aa * rad) / c.cc
                                          : 0.f;
    contract = clamp_min(contract, -max_r * c.dt);
  }
  const float dr = dr1 > 0.f ? expand : contract;
  float new_rad = clamp_min(rad + dr, min_r);
  new_rad = new_rad > max_r ? max_r : new_rad;
  const bool frozen = (r.dead > 0.5f) || (r.phase > c.phase_frozen) ||
                      !in_window || !val;
  r.rad = frozen ? rad : new_rad;

  // ---- pre: integrate + boundary (ops/integrate.py radius_integrate_planes)
  const float hi = c.half - r.rad;
  const float lo = -c.half + r.rad;
  {
    const float np_ = r.px + r.vx * c.dt;
    const bool out = (np_ > hi) || (np_ < lo);
    const float q = np_ < lo ? lo : np_;
    r.px = q > hi ? hi : q;
    r.vx = out ? r.vx * c.bd : r.vx;
  }
  {
    const float np_ = r.py + r.vy * c.dt;
    const bool out = (np_ > hi) || (np_ < lo);
    const float q = np_ < lo ? lo : np_;
    r.py = q > hi ? hi : q;
    r.vy = out ? r.vy * c.bd : r.vy;
  }
}

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

__global__ void __launch_bounds__(kThreads, 1) mega_span_kernel(
    const float* __restrict__ tbl, const float* __restrict__ strip,
    float* __restrict__ tbl_out, float* __restrict__ strip_out,
    int cap, int g, int n_strip, int k_steps, int step0, MegaConsts c,
    const float* __restrict__ rects, int n_rect,
    const float* __restrict__ circs, int n_circ, int has_payload) {
  extern __shared__ float smem[];
  __shared__ float s_rect[4 * kMaxRect];
  __shared__ float s_circ[3 * kMaxCirc];
  const int gg = g * g;
  const int rows = cap * gg;
  const int tid = threadIdx.x;
  float* s_px = smem;
  float* s_py = smem + rows;
  float* s_vx = smem + 2 * rows;
  float* s_vy = smem + 3 * rows;
  float* s_rad = smem + 4 * rows;
  float* s_afac = has_payload ? smem + 5 * rows : nullptr;

  for (int i = tid; i < 4 * n_rect; i += kThreads) s_rect[i] = rects[i];
  for (int i = tid; i < 3 * n_circ; i += kThreads) s_circ[i] = circs[i];
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int r = tid + i * kThreads;
    if (r >= rows) break;
    for (int f = 0; f < kFields; ++f) tbl_out[f * rows + r] = tbl[f * rows + r];
    s_px[r] = tbl[PX * rows + r];
    s_py[r] = tbl[PY * rows + r];
    s_vx[r] = tbl[VX * rows + r];
    s_vy[r] = tbl[VY * rows + r];
    s_rad[r] = tbl[RAD * rows + r];
    if (has_payload) s_afac[r] = tbl[AFAC * rows + r];
  }
  __syncthreads();

  for (int j = 0; j < k_steps; ++j) {
    // iteration j: post(step0 + j - 1), then pre(step0 + j)
    const float time = static_cast<float>(step0 + j) * c.dt;
    float f[kRowsPerThread][4];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int row = tid + i * kThreads;
      float sx = 0.f, sy = 0.f, sa = 0.f, sr = 0.f;
      const float rt = row < rows ? s_rad[row] : 0.f;
      if (rt > 0.f) {
        const int lane = row % gg;
        const int x = lane % g;
        const int y = lane / g;
        const float pxt = s_px[row], pyt = s_py[row];
        const float vxt = s_vx[row], vyt = s_vy[row];
        const float aft = has_payload ? s_afac[row] : 1.f;
        for (int oy = -1; oy <= 1; ++oy) {
          const int ny = (y + oy + g) % g;
          for (int ox = -1; ox <= 1; ++ox) {
            const int nl = ny * g + (x + ox + g) % g;
            for (int cc = 0; cc < cap; ++cc) {
              const int jr = cc * gg + nl;
              if (jr == row) continue;
              const float rc = s_rad[jr];
              if (!(rc > 0.f)) continue;
              pair_accumulate(c.pair, s_px, s_py, s_vx, s_vy, s_afac, jr, rc,
                              pxt, pyt, vxt, vyt, rt, aft, sx, sy, sa, sr);
            }
          }
        }
      }
      f[i][0] = sx;
      f[i][1] = sy;
      f[i][2] = sa;
      f[i][3] = sr;
    }
    __syncthreads();  // every neighbour read of this step is done
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int row = tid + i * kThreads;
      if (row < rows) {
        Row r = load_row(tbl_out, rows, row);
        post_pre_row(c, s_rect, n_rect, s_circ, n_circ, r, f[i][0], f[i][1],
                     f[i][2], f[i][3], time);
        store_moving(tbl_out, rows, row, r);
        s_px[row] = r.px;
        s_py[row] = r.py;
        s_vx[row] = r.vx;
        s_vy[row] = r.vy;
        s_rad[row] = r.rad;
      }
    }
    __syncthreads();  // every write of this step is done
  }

  // parking strip: no pair force, no neighbour reads, all k steps at once
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int s = tid + i * kThreads;
    if (s >= n_strip) break;
    Row r = load_row(strip, n_strip, s);
    for (int j = 0; j < k_steps; ++j) {
      const float time = static_cast<float>(step0 + j) * c.dt;
      post_pre_row(c, s_rect, n_rect, s_circ, n_circ, r, 0.f, 0.f, 0.f, 0.f,
                   time);
    }
    for (int f = 0; f < kFields; ++f) strip_out[f * n_strip + s] = strip[f * n_strip + s];
    store_moving(strip_out, n_strip, s, r);
  }
}

}  // namespace

// Returns a cudaError_t: cudaErrorInvalidValue for a table, strip or
// obstacle list larger than the kernel's fixed layout (or a constants
// array of the wrong length), else the launch's own status.
extern "C" int pbot_mega_span(
    const void* tbl, const void* strip, void* tbl_out, void* strip_out,
    int cap, int g, int n_strip, int k_steps, int step0,
    const float* consts, int n_consts,
    const void* rects, int n_rect, const void* circs, int n_circ,
    int has_payload, void* stream) {
  if (n_consts != kNumConsts || cap * g * g > kThreads * kRowsPerThread ||
      n_strip > kThreads * kRowsPerThread || n_rect > kMaxRect ||
      n_circ > kMaxCirc || k_steps < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  MegaConsts c;
  const float* src = consts;
  float* dst = reinterpret_cast<float*>(&c);
  for (int i = 0; i < kNumConsts; ++i) dst[i] = src[i];
  const size_t smem = static_cast<size_t>(has_payload ? 6 : 5) * cap * g * g * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      mega_span_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  mega_span_kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(tbl), static_cast<const float*>(strip),
      static_cast<float*>(tbl_out), static_cast<float*>(strip_out),
      cap, g, n_strip, k_steps, step0, c,
      static_cast<const float*>(rects), n_rect,
      static_cast<const float*>(circs), n_circ, has_payload);
  return static_cast<int>(cudaGetLastError());
}
