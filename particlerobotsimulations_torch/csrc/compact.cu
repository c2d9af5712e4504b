// Incremental slot compaction — kernel 2 of the table loop.
//
// Replaces: particlerobotsimulations_tpu/ops/table_rebuild.py
//   compact_padded (the pallas_call at l.203; kernel body
//   _make_compact_kernel l.63), in both of its uses: the wrap form that
//   _compact l.234 builds for incremental_rebuild_planes l.338, and the
//   halo-padded form of the sharded loop (parallel/spatial_table.py l.170).
//
// Contract: the input stack is float32 (nf + 2, Cs, W): nf data fields,
// then the per-row cell move dx and dy (each in {-1, 0, 1} for occupied
// rows, 99 for empty ones).  For each of the `out_w` target lanes L the
// kernel visits 9 source lanes in OFFSETS9 order — LINEAR lane arithmetic,
// as the JAX halo windows use it — and, within each, the Cs slots in order:
//   wrap form   (W = out_w = G*G): source (L + oy*G + ox) mod G*G; the table
//               loop keeps the wrapped edge columns empty so this equals the
//               2-D wrap;
//   padded form (W = pad + out_w + pad, pad >= G + 1): source
//               pad + L + oy*G + ox, no wrap — the pad carries the wrap or
//               the neighbour shards' halo rows.
// A row whose move is (-ox, -oy) lands in lane L: it is copied to the next
// free slot while one is left, and counted either way.  Unfilled slots are
// zero.  incoming[L] is the count, as float.  The padded form takes S
// independent stacks (the shards one process holds) in one launch, and the
// wrap form B (the scenes of a batched table loop, where the JAX package
// vmaps the pallas_call); each stack is compacted as a one-stack launch
// would compact it.  The
// result is pure data movement, so it equals the JAX kernel and the plain
// twins elementwise (the JAX one-hot sum turns -0.0 into +0.0, which ==
// still treats as equal).  Any Cs: the slots are taken in windows of 32.
//
// What bounds it on the card: latency, not bytes or arithmetic.  At 10k
// bots (G=48, Cs=16, nf=9) one call needs the 11 input planes once and
// writes 9 output planes and the count (~2.9 MB: 0.88 us at 3.35 TB/s,
// NVIDIA H100 80GB HBM3, 700 W).  The first design, one thread per target
// lane with a serial scan of the 9 x Cs candidates and a running count,
// put 2,304 lanes on 18 blocks (2 on the band's G=16 table): each thread a
// chain of ~300 loads whose branches depend on the last, ~42 us a call.
//
// Design: a block takes kLanes consecutive target lanes of one shard.
//   1. One thread per (offset, lane) reads the dx, dy of the source lane's
//      slots — the threads of a warp read neighbouring lanes of one slot
//      plane, all loads independent — into a 32-bit word per window whose
//      bit j says that slot j of the window moves into the lane, and counts
//      them over every window.
//   2. One thread per lane scans the nine counts in OFFSETS9 order: the
//      rank of each offset's first mover, and the lane's count.
//   3. One thread per (slot of the window, lane) tests that slot's bit in
//      the nine words; a mover's rank is its offset's first rank plus the
//      movers below it in its word, exactly the serial counter's order
//      (OFFSETS9, then slot).  Movers of rank < Cs copy their nf fields,
//      and a slot at or past min(count, Cs) is zeroed, by that thread.
// A window after the first is re-read and its offsets' first ranks moved
// past the previous window's movers.  No atomics: deterministic.

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 16;     // target lanes per block
constexpr int kWindow = 32;    // slots per mask word
constexpr int kThreads = kWindow * kLanes;  // one per (window slot, lane)

// OFFSETS9 (ops/grid.py): center, then the 8 neighbours in that order
__constant__ int kOffX[9] = {0, 1, -1, 0, 0, 1, 1, -1, -1};
__constant__ int kOffY[9] = {0, 0, 0, 1, -1, 1, -1, 1, -1};

// source lane of target lane `lane` at offset o; pad < 0: the wrap form
__device__ __forceinline__ int source(int lane, int o, int g, int in_w, int pad) {
  const int d = kOffY[o] * g + kOffX[o];
  if (pad >= 0) return pad + lane + d;
  const int s = (lane + d) % in_w;
  return s < 0 ? s + in_w : s;
}

// bit j: slot c0 + j (j < n <= 32) of source lane `src` moves by (-ox, -oy)
__device__ __forceinline__ unsigned movers(const float* __restrict__ dxp,
                                           const float* __restrict__ dyp,
                                           int src, int in_w, int c0, int n, int o) {
  const float want_x = static_cast<float>(-kOffX[o]);
  const float want_y = static_cast<float>(-kOffY[o]);
  unsigned w = 0;
#pragma unroll 8
  for (int j = 0; j < n; ++j) {
    const size_t s = static_cast<size_t>(c0 + j) * in_w + src;
    const float a = dxp[s], b = dyp[s];
    if ((a == want_x) & (b == want_y)) w |= 1u << j;
  }
  return w;
}

__global__ void __launch_bounds__(kThreads) compact_kernel(
    const float* __restrict__ planes, float* __restrict__ out,
    float* __restrict__ incoming, int nf, int cs, int g, int in_w, int pad,
    int out_w, int lane_blocks) {
  __shared__ unsigned word[9 * kLanes];  // (offset, lane): the window's movers
  __shared__ int first[9 * kLanes];      // (offset, lane): rank of the window's first mover
  __shared__ int total[kLanes];          // movers into each lane
  const int tid = threadIdx.x;
  const size_t shard = blockIdx.x / lane_blocks;
  const int lane0 = (blockIdx.x - static_cast<int>(shard) * lane_blocks) * kLanes;
  planes += shard * (nf + 2) * cs * static_cast<size_t>(in_w);
  out += shard * nf * cs * static_cast<size_t>(out_w);
  incoming += shard * out_w;
  const float* dxp = planes + static_cast<size_t>(nf) * cs * in_w;
  const float* dyp = dxp + static_cast<size_t>(cs) * in_w;
  const int n_win = (cs + kWindow - 1) / kWindow;

  // 1. per (offset, lane): window 0's movers kept, every window's counted
  if (tid < 9 * kLanes) {
    const int o = tid / kLanes, lane = lane0 + tid % kLanes;
    unsigned w0 = 0;
    int n = 0;
    if (lane < out_w) {
      const int src = source(lane, o, g, in_w, pad);
      for (int k = 0; k < n_win; ++k) {
        const unsigned w = movers(dxp, dyp, src, in_w, k * kWindow,
                                  min(kWindow, cs - k * kWindow), o);
        if (k == 0) w0 = w;
        n += __popc(w);
      }
    }
    word[tid] = w0;
    first[tid] = n;
  }
  __syncthreads();

  // 2. per lane: the counts scanned in OFFSETS9 order
  if (tid < kLanes) {
    int s = 0;
    for (int o = 0; o < 9; ++o) {
      const int n = first[o * kLanes + tid];
      first[o * kLanes + tid] = s;
      s += n;
    }
    total[tid] = s;
    if (lane0 + tid < out_w) incoming[lane0 + tid] = static_cast<float>(s);
  }
  __syncthreads();

  // 3. per window, per (slot, lane): its movers copied to their ranks, or
  //    the slot zeroed past the count
  for (int k = 0; k < n_win; ++k) {
    if (k > 0) {
      __syncthreads();
      if (tid < 9 * kLanes) {
        const int o = tid / kLanes, lane = lane0 + tid % kLanes;
        first[tid] += __popc(word[tid]);
        word[tid] = lane < out_w
            ? movers(dxp, dyp, source(lane, o, g, in_w, pad), in_w, k * kWindow,
                     min(kWindow, cs - k * kWindow), o)
            : 0u;
      }
      __syncthreads();
    }
    const int j = tid / kLanes, i = tid % kLanes;
    const int c = k * kWindow + j, lane = lane0 + i;
    if (c >= cs || lane >= out_w) continue;
    const unsigned below = (1u << j) - 1u;
    for (int o = 0; o < 9; ++o) {
      const unsigned w = word[o * kLanes + i];
      if (!((w >> j) & 1u)) continue;
      const int r = first[o * kLanes + i] + __popc(w & below);
      if (r >= cs) continue;
      const int src = source(lane, o, g, in_w, pad);
      for (int f = 0; f < nf; ++f) {
        out[(static_cast<size_t>(f) * cs + r) * out_w + lane] =
            planes[(static_cast<size_t>(f) * cs + c) * in_w + src];
      }
    }
    if (c >= min(total[i], cs)) {
      for (int f = 0; f < nf; ++f) out[(static_cast<size_t>(f) * cs + c) * out_w + lane] = 0.f;
    }
  }
}

}  // namespace

// The launch plan for Cs slots, out_w target lanes and `shards` stacks:
// out[0] = blocks (kLanes lanes of one shard each), out[1] = threads per
// block, out[2] = slot windows.  Returns cudaErrorInvalidValue for Cs,
// out_w or shards below 1.
extern "C" int pbot_compact_plan(int cs, int out_w, int shards, int* out) {
  if (cs < 1 || out_w < 1 || shards < 1) return static_cast<int>(cudaErrorInvalidValue);
  out[0] = (out_w + kLanes - 1) / kLanes * shards;
  out[1] = kThreads;
  out[2] = (cs + kWindow - 1) / kWindow;
  return 0;
}

static int launch(const void* planes, void* out, void* incoming, int shards,
                  int nf, int cs, int g, int in_w, int pad, int out_w,
                  void* stream) {
  int plan[3];
  const int bad = pbot_compact_plan(cs, out_w, shards, plan);
  if (bad) return bad;
  compact_kernel<<<plan[0], plan[1], 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(planes), static_cast<float*>(out),
      static_cast<float*>(incoming), nf, cs, g, in_w, pad, out_w, plan[0] / shards);
  return static_cast<int>(cudaGetLastError());
}

// the wrap form: `scenes` contiguous (nf + 2, Cs, G*G) stacks, one per
// scene of a batch (1 for the single-table loop), each compacted as the
// padded form compacts a shard
extern "C" int pbot_compact(const void* planes, void* out, void* incoming,
                            int scenes, int nf, int cs, int g, void* stream) {
  return launch(planes, out, incoming, scenes, nf, cs, g, g * g, -1, g * g, stream);
}

// the padded form: `shards` stacks of (nf + 2, Cs, pad + out_w + pad),
// pad >= g + 1 (the wrapper checks it)
extern "C" int pbot_compact_padded(const void* planes, void* out,
                                   void* incoming, int shards, int nf, int cs,
                                   int g, int pad, int out_w, void* stream) {
  return launch(planes, out, incoming, shards, nf, cs, g, 2 * pad + out_w,
                pad, out_w, stream);
}
