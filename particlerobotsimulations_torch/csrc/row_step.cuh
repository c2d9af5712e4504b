// The table loop's per-row step arithmetic, shared by kernel 3
// (mega_span.cu) and the row step (row_step.cu).
//
// post = obstacles, stick-slip friction and validity of one row whose pair
// sums are given; pre = the radius controller at a sim time, then
// integrate and the world-boundary clamp.  Every expression follows the
// plain PyTorch ops (ops/forces.py obstacle_forces_xy and
// friction_velocity_update_xy, ops/actuation.py update_radius,
// ops/integrate.py radius_integrate_planes) operation for operation; the
// library is built with -fmad=false, so each product and sum rounds as
// PyTorch's separate elementwise ops round it.  A tensor divided by a
// host scalar is, in PyTorch's CUDA kernel, the tensor times the scalar's
// float reciprocal (one bit may differ from the quotient), so the twin's
// divisions by a constant are written x * (1.0f / c) here.  No neighbour
// is read: a row's outputs depend on its own fields alone.

#pragma once

#include <cuda_runtime.h>

#include "pair_math.cuh"

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

// The obstacles, by value in a launch's parameters (nothing to copy to
// the card, at a launch or at a graph's capture): n_rect rectangles (x1,
// x2, y1, y2) and n_circ circles (x, y, r), at most 10 of each, the cap
// config.py's SimParams.validate sets.
constexpr int kMaxRect = 10;
constexpr int kMaxCirc = 10;
struct Obstacles {
  float rect[4 * kMaxRect];
  float circ[3 * kMaxCirc];
  int n_rect, n_circ;
};

// *o from host arrays of n_rect x 4 and n_circ x 3 floats; false where a
// count is outside the layout
static inline bool load_obstacles(const float* rects, int n_rect, const float* circs,
                                  int n_circ, Obstacles* o) {
  if (n_rect < 0 || n_rect > kMaxRect || n_circ < 0 || n_circ > kMaxCirc) return false;
  *o = Obstacles{};
  for (int k = 0; k < 4 * n_rect; ++k) o->rect[k] = rects[k];
  for (int k = 0; k < 3 * n_circ; ++k) o->circ[k] = circs[k];
  o->n_rect = n_rect;
  o->n_circ = n_circ;
  return true;
}

// a block's copy of the obstacles in shared memory (thread 0, constant
// indices, so the parameters stay in the parameter space); the caller
// syncs the block before reading it
static __device__ __forceinline__ void stage_obstacles(const Obstacles& o, float* s_rect,
                                                       float* s_circ) {
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < 4 * kMaxRect; ++k) s_rect[k] = o.rect[k];
#pragma unroll
    for (int k = 0; k < 3 * kMaxCirc; ++k) s_circ[k] = o.circ[k];
  }
}

// the fields post + pre read (aa and ar are written by post before pre
// reads them) and write
struct Row {
  float px, py, vx, vy, rad, val, phase, dead, pay, aa, ar;
};

static __device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;  // torch.clamp(x, min=lo)
}

static __device__ __forceinline__ float norm2(float x, float y) {
  return sqrtf(clamp_min(x * x + y * y, 1.0e-30f));
}

// ops/forces.py obstacle_forces_xy: one DEM term against an obstacle
static __device__ __forceinline__ void obstacle_dem(
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

// circles (x, y, r) and rectangles (x1, x2, y1, y2), circles first
static __device__ void obstacle_forces(
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

// post of one row whose pair sums are fx, fy, fa, fr (zero for rows the
// pair stencil does not see): aa/ar, obstacles, friction, then vx = vy = 0
// where val <= 0.5
static __device__ __forceinline__ void post_row(
    const MegaConsts& c, const float* rect, int n_rect, const float* circ,
    int n_circ, Row& r, float fx, float fy, float fa, float fr) {
  const float eps = 1.0e-12f;
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
}

// pre of one row at sim time `time`: the radius controller
// (ops/actuation.py update_radius) from the previous post's aa/ar, then
// integrate + boundary (ops/integrate.py radius_integrate_planes)
static __device__ __forceinline__ void pre_row(const MegaConsts& c, Row& r,
                                               float time) {
  const bool val = r.val > 0.5f;
  const float period = c.period, rise = c.rise;
  const float min_r = c.min_r, max_r = c.max_r;
  float t1 = time + r.phase;
  if (t1 < 0.f) t1 = t1 + 100.0f * period;
  if (t1 >= period) t1 = t1 - period * floorf(t1 * (1.0f / period));
  const bool in_window = t1 < 2.0f * rise;
  const float target = (t1 <= rise)
      ? min_r + (max_r - min_r) / rise * t1
      : max_r + (min_r - max_r) / rise * (t1 - rise);
  const float rad = r.rad;
  const float dr1 = target - rad;
  const float safe_rad = clamp_min(rad, 1.0e-9f);
  float torque = dr1 * c.constraint * rad * (1.0f / c.max_speed) *
                 (1.0f / max_r) * (1.0f / c.dt);
  torque = torque > c.constraint ? c.constraint : torque;
  const float surplus = torque / safe_rad;
  const float expand = surplus > r.ar
      ? c.max_speed * max_r / c.constraint * (surplus - r.ar) * c.dt
      : 0.f;
  float contract = dr1;
  if (c.constrained > 0.5f) {
    contract = (-c.cc * dr1 > r.aa * rad)
        ? (c.cc * dr1 + r.aa * rad) * (1.0f / c.cc)
        : 0.f;
    contract = clamp_min(contract, -max_r * c.dt);
  }
  const float dr = dr1 > 0.f ? expand : contract;
  float new_rad = clamp_min(rad + dr, min_r);
  new_rad = new_rad > max_r ? max_r : new_rad;
  const bool frozen = (r.dead > 0.5f) || (r.phase > c.phase_frozen) ||
                      !in_window || !val;
  r.rad = frozen ? rad : new_rad;

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

// post then pre of one row (kernel 3's step of a row)
static __device__ void post_pre_row(
    const MegaConsts& c, const float* rect, int n_rect, const float* circ,
    int n_circ, Row& r, float fx, float fy, float fa, float fr, float time) {
  post_row(c, rect, n_rect, circ, n_circ, r, fx, fy, fa, fr);
  pre_row(c, r, time);
}
