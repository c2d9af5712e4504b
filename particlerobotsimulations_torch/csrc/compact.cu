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
// independent stacks (the shards one process holds) in one launch,
// blockIdx.y = shard.  The result is pure data movement, so it equals the
// JAX kernel and the plain twins elementwise (the JAX one-hot sum turns
// -0.0 into +0.0, which == still treats as equal).
//
// What bounds it on the card: memory traffic and latency, not arithmetic.
// At 10k bots (G=48, Cs=16, nf=9) one call reads the two move planes for
// 9 x 16 candidates per lane (~2.6 MB, mostly from L2) plus the nf fields
// of the rows that land, and writes the 9 x 16 x 2304 output planes
// (1.3 MB).  2304 lanes is only 18 blocks of 128 threads, so the card is
// far from full; the call runs once every K steps.  The sharded 10k table
// (G=64, 4 shards of 1024 lanes) is 32 blocks.
//
// Design: one thread per target lane, a serial scan over the 9 x Cs
// candidates with a running count — the rank-and-place the TPU kernel
// expresses as a triangular matmul plus a one-hot contraction becomes a
// plain counter here.  Threads of a warp read neighbouring lanes, so every
// plane access is coalesced.  No shared memory, no atomics, deterministic.

#include <cuda_runtime.h>

namespace {

// pad < 0: the wrap form (in_w == out_w == G*G); else the padded form
__global__ void compact_kernel(const float* __restrict__ planes,
                               float* __restrict__ out,
                               float* __restrict__ incoming,
                               int nf, int cs, int g, int in_w, int pad,
                               int out_w) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= out_w) return;
  const size_t shard = blockIdx.y;
  planes += shard * (nf + 2) * cs * static_cast<size_t>(in_w);
  out += shard * nf * cs * static_cast<size_t>(out_w);
  incoming += shard * out_w;
  // OFFSETS9 (ops/grid.py): center, then the 8 neighbours in that order
  const int off_x[9] = {0, 1, -1, 0, 0, 1, 1, -1, -1};
  const int off_y[9] = {0, 0, 0, 1, -1, 1, -1, 1, -1};
  const float* dxp = planes + static_cast<size_t>(nf) * cs * in_w;
  const float* dyp = dxp + static_cast<size_t>(cs) * in_w;

  int count = 0;
#pragma unroll
  for (int o = 0; o < 9; ++o) {
    const int ox = off_x[o], oy = off_y[o];
    int src;
    if (pad < 0) {
      src = (lane + oy * g + ox) % in_w;
      if (src < 0) src += in_w;
    } else {
      src = pad + lane + oy * g + ox;
    }
    const float want_x = static_cast<float>(-ox);
    const float want_y = static_cast<float>(-oy);
    for (int c = 0; c < cs; ++c) {
      const int s = c * in_w + src;
      if (dxp[s] == want_x && dyp[s] == want_y) {
        if (count < cs) {
          for (int f = 0; f < nf; ++f) {
            out[(static_cast<size_t>(f) * cs + count) * out_w + lane] =
                planes[(static_cast<size_t>(f) * cs + c) * in_w + src];
          }
        }
        ++count;
      }
    }
  }
  for (int c = count < cs ? count : cs; c < cs; ++c) {
    for (int f = 0; f < nf; ++f) {
      out[(static_cast<size_t>(f) * cs + c) * out_w + lane] = 0.f;
    }
  }
  incoming[lane] = static_cast<float>(count);
}

}  // namespace

static int launch(const void* planes, void* out, void* incoming, int shards,
                  int nf, int cs, int g, int in_w, int pad, int out_w,
                  void* stream) {
  const int threads = 128;
  const dim3 blocks((out_w + threads - 1) / threads, shards);
  compact_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(planes), static_cast<float*>(out),
      static_cast<float*>(incoming), nf, cs, g, in_w, pad, out_w);
  return static_cast<int>(cudaGetLastError());
}

// the wrap form: one (nf + 2, Cs, G*G) stack
extern "C" int pbot_compact(const void* planes, void* out, void* incoming,
                            int nf, int cs, int g, void* stream) {
  return launch(planes, out, incoming, 1, nf, cs, g, g * g, -1, g * g, stream);
}

// the padded form: `shards` stacks of (nf + 2, Cs, pad + out_w + pad),
// pad >= g + 1 (the wrapper checks it)
extern "C" int pbot_compact_padded(const void* planes, void* out,
                                   void* incoming, int shards, int nf, int cs,
                                   int g, int pad, int out_w, void* stream) {
  return launch(planes, out, incoming, shards, nf, cs, g, 2 * pad + out_w,
                pad, out_w, stream);
}
