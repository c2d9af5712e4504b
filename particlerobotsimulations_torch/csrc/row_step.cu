// The table loop's per-row step glue in one launch — the row step.
//
// Replaces no pallas_call.  The JAX package leaves the table loop's
// elementwise step glue (particlerobotsimulations_tpu/engine_table.py
// step_pre's radius controller and integrate, step_post's zero pad and
// concatenation around the pair kernel, obstacles, friction and validity)
// to XLA, which fuses it.  PyTorch runs it as ~130 separate elementwise
// launches per step, each a pass over the planes; on the card that was
// most of the 10k step (PERF.md).  This kernel runs that glue as one pass:
//   post      kernel 1's sums fx, fy, fa, fr for the first force_rows rows
//             of each scene (zero beyond: spill rows, the parking strip
//             and padding), then aa/ar, obstacles, stick-slip friction and
//             vx = vy = 0 where val <= 0.5;
//   pre       the radius controller at time f32(*step + offset) * f32(dt),
//             then integrate and the world-boundary clamp;
//   post_pre  post of step s, then pre of step s + 1 (*step + offset),
//             for the loop's steps whose successor fires no gate.
// The arithmetic is row_step.cuh's, which kernel 3 shares: the plain
// PyTorch ops operation for operation, built with -fmad=false, so the
// outputs equal the ops' bit for bit.
//
// Contract: in[f] is TABLE_FIELDS plane f (px py vx vy rad val afac phase
// dead aa ar pay bid), row i of scene b at in[f][b * in_stride[f] + i];
// planes the mode does not read may be null.  force[q] holds sum q of
// scene b's row i < force_rows at force[q][b * force_rows + i] (kernel 1's
// (B, C, G*G) outputs).  out[k] is plane k of (px py vx vy rad aa ar),
// row i of scene b at out[k][b * rows + i], null where the mode leaves the
// plane: post writes vx vy aa ar, pre px py vx vy rad, post_pre all seven.
// step is a 0-dim int64 on the card, read by the kernel, so a CUDA graph
// of the launch replays at whatever step it then holds.  The obstacles
// (row_step.cuh's Obstacles, as kernel 3 takes them) and the constants
// (kernels.py mega_constants) travel by value in the launch's parameters,
// so nothing is copied to the card per launch or at capture.
//
// What bounds it on the card: launch latency at the 10k table, then bytes.
// The 10k table and strip hold ~47k rows per scene; post_pre reads 10
// planes and kernel 1's 4 sums and writes 7 planes, ~4 MB per scene, under
// 1.5 us at 3.35 TB/s.  The design is one thread per row and a grid of
// row blocks x scenes, every access coalesced, no shared state but the
// obstacle list; each mode loads only the planes it reads.

#include <cuda_runtime.h>

#include "row_step.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPlanes = 13;
constexpr int kOut = 7;  // px py vx vy rad aa ar
constexpr int kMaxScenes = 65535;
enum Mode { kPost = 1, kPre = 2, kPostPre = 3 };

struct RowArgs {
  const float* in[kPlanes];
  long long in_stride[kPlanes];
  float* out[kOut];
  const float* force[4];
  const long long* step;
  int rows, force_rows, mode, step_offset;
};

__global__ void __launch_bounds__(kThreads) row_step_kernel(RowArgs a, MegaConsts c,
                                                            Obstacles obs) {
  __shared__ float s_rect[4 * kMaxRect];
  __shared__ float s_circ[3 * kMaxCirc];
  stage_obstacles(obs, s_rect, s_circ);
  __syncthreads();
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.rows) return;
  const long long b = blockIdx.y;
  const bool post = a.mode & kPost, pre = a.mode & kPre;
  const bool obstacles = obs.n_rect + obs.n_circ > 0;
#define PLANE(f) a.in[f][b * a.in_stride[f] + i]
  Row r{};
  r.vx = PLANE(VX);
  r.vy = PLANE(VY);
  r.val = PLANE(VAL);
  if (pre || obstacles) {
    r.px = PLANE(PX);
    r.py = PLANE(PY);
    r.rad = PLANE(RAD);
  }
  if (post) r.pay = PLANE(PAY);
  if (pre) {
    r.phase = PLANE(PHASE);
    r.dead = PLANE(DEAD);
    if (!post) {
      r.aa = PLANE(AA);
      r.ar = PLANE(AR);
    }
  }
#undef PLANE
  if (post) {
    float fx = 0.f, fy = 0.f, fa = 0.f, fr = 0.f;
    if (i < a.force_rows) {
      const long long k = b * a.force_rows + i;
      fx = a.force[0][k];
      fy = a.force[1][k];
      fa = a.force[2][k];
      fr = a.force[3][k];
    }
    post_row(c, s_rect, obs.n_rect, s_circ, obs.n_circ, r, fx, fy, fa, fr);
  }
  if (pre) pre_row(c, r, static_cast<float>(*a.step + a.step_offset) * c.dt);
  const long long o = b * a.rows + i;
  const float vals[kOut] = {r.px, r.py, r.vx, r.vy, r.rad, r.aa, r.ar};
#pragma unroll
  for (int k = 0; k < kOut; ++k) {
    if (a.out[k] != nullptr) a.out[k][o] = vals[k];
  }
}

// the planes a mode reads, as a bit mask over TABLE_FIELDS
unsigned reads(int mode, bool obstacles) {
  unsigned m = (1u << VX) | (1u << VY) | (1u << VAL);
  if ((mode & kPre) || obstacles) m |= (1u << PX) | (1u << PY) | (1u << RAD);
  if (mode & kPost) m |= 1u << PAY;
  if (mode & kPre) m |= (1u << PHASE) | (1u << DEAD);
  if (mode == kPre) m |= (1u << AA) | (1u << AR);
  return m;
}

}  // namespace

// One row-step launch over `scenes` scenes of `rows` rows each, in `mode`
// (1 post, 2 pre, 3 post_pre): see the contract above.  in, in_stride and
// out are host arrays of 13, 13 and 7 entries, force one of 4 (unread
// unless the mode posts and force_rows > 0); rects and circs host arrays of
// n_rect x 4 and n_circ x 3 floats.  Returns a cudaError_t:
// cudaErrorInvalidValue for a mode, shape or obstacle count the kernel
// does not take, a constants array of the wrong length, or a plane the
// mode reads or writes that is null; else the launch's own status.
extern "C" int pbot_row_step(
    const void* const* in, const long long* in_stride, void* const* out,
    const void* const* force, int scenes, int rows, int force_rows, int mode,
    const void* step, int step_offset, const float* consts, int n_consts,
    const float* rects, int n_rect, const float* circs, int n_circ,
    void* stream) {
  if (n_consts != kNumConsts || mode < kPost || mode > kPostPre || scenes < 1 ||
      scenes > kMaxScenes || rows < 1 || force_rows < 0 || force_rows > rows ||
      ((mode & kPre) && step == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Obstacles obs;
  if (!load_obstacles(rects, n_rect, circs, n_circ, &obs)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  RowArgs a{};
  const unsigned need = reads(mode, n_rect + n_circ > 0);
  for (int f = 0; f < kPlanes; ++f) {
    if ((need >> f & 1u) && in[f] == nullptr) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    a.in[f] = static_cast<const float*>(in[f]);
    a.in_stride[f] = in_stride[f];
  }
  // post writes vx vy aa ar (outputs 2, 3, 5, 6), pre px py vx vy rad (0-4)
  const unsigned writes = (mode & kPost ? 0x6Cu : 0u) | (mode & kPre ? 0x1Fu : 0u);
  for (int k = 0; k < kOut; ++k) {
    if ((writes >> k & 1u) != (out[k] != nullptr)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    a.out[k] = static_cast<float*>(out[k]);
  }
  if ((mode & kPost) && force_rows > 0) {
    for (int q = 0; q < 4; ++q) {
      if (force[q] == nullptr) return static_cast<int>(cudaErrorInvalidValue);
      a.force[q] = static_cast<const float*>(force[q]);
    }
  }
  a.step = static_cast<const long long*>(step);
  a.rows = rows;
  a.force_rows = force_rows;
  a.mode = mode;
  a.step_offset = step_offset;
  MegaConsts c;
  float* dst = reinterpret_cast<float*>(&c);
  for (int k = 0; k < kNumConsts; ++k) dst[k] = consts[k];
  const dim3 grid((rows + kThreads - 1) / kThreads, scenes, 1);
  row_step_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a, c, obs);
  return static_cast<int>(cudaGetLastError());
}
