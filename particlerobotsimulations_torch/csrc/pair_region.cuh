// Term-parallel pair sums over a region of cells held in shared memory —
// the pair stencil of kernels 1 and 4 (stencil_forces.cu) and kernel 3
// (mega_span.cu).
//
// A region is rh x rw cells: the target cells are its interior (rows 1 ..
// rh - 2, columns 1 .. rw - 2) and its border is their one-cell halo, each
// cell a copy of the table's cell that the kernel's wrap puts there.  The
// planes px, py, vx, vy, rad (and afac with a payload) hold the region's C
// slots, slot-major: value (c, cell) at c * rh * rw + cell.  mask[cell]
// has bit c set iff that row is occupied (rad > 0; kernel 4: val != 0);
// lane[cell] is the cell's lane in the table it came from, so that a cell
// visited twice (a table narrower than 3 cells) is recognised as the
// target's own.
//
// region_pair_sums gives every occupied target row the four sums of
// stencil_forces.cu's contract, in the order of the serial loop
//
//   for oy in -1..1, ox in -1..1, c in 0..C-1:
//     candidate (c, cell + (oy, ox)) if occupied and not the target itself
//
// by three passes over the block's threads:
//   1. the targets, listed cell by cell in slot order;
//   2. one item per (target, neighbour cell) — nine per target — keeps
//      the cell's occupied candidates that pair_out_of_reach does not rule
//      out (at the 10k path's density ~1/3 of ~108 per target), and an
//      exclusive scan of their popcounts gives each target its term
//      offset;
//   3. the items, spread over the threads, evaluate their candidates'
//      terms, in slot order, into a shared-memory buffer of term_cap terms
//      at the target's offset; then one thread per target adds its terms
//      in offset order.  When the block's terms outgrow the buffer,
//      windows of whole targets whose terms fit are done one after
//      another.
// Each term is pair_math.cuh's pair_term and each sum takes pair_add in
// the serial order; a candidate left out would have been a term that
// pair_add skips.  So the sums equal the serial loop's bit for bit.

#pragma once

#include <cuda_runtime.h>

#include "pair_math.cuh"

struct PairRegion {
  const float *px, *py, *vx, *vy, *rad, *afac;  // afac null without payload
  const unsigned* mask;
  const int* lane;
  int rh, rw;
};

// Shared-memory scratch: n_tc + 1 cell bases, max_t targets, 9 * max_t
// reach masks, term_cap terms, 32 warp totals.
struct PairScratch {
  int* cell_base;   // (n_tc + 1) exclusive scan of targets per target cell
  int* t_cell;      // (max_t) region cell of each target
  int* t_slot;      // (max_t) slot of each target
  int* t_base;      // (max_t + 1) exclusive scan of terms per target
  unsigned* reach;  // (9 * max_t) candidates within reach, per (target, cell)
  float* acc;       // (4, max_t) fx, fy, fa, fr of each target
  PairTerm* terms;  // (term_cap)
  int* warp_tot;    // (32)
  int max_t, term_cap;
};

// position of the n-th (0-based) set bit of m
static __device__ __forceinline__ int nth_set_bit(unsigned m, int n) {
  for (; n > 0; --n) m &= m - 1;
  return __ffs(m) - 1;
}

// In-place exclusive scan of a[0 .. n), a[n] = the total, which it returns.
// Every thread of the block calls it; blockDim.x is a multiple of 32.
static __device__ int block_exclusive_scan(int* a, int n, int* warp_tot) {
  __syncthreads();
  const int nt = blockDim.x, tid = threadIdx.x;
  const int per = (n + nt - 1) / nt;
  const int lo = min(n, tid * per), hi = min(n, lo + per);
  int s = 0;
  for (int i = lo; i < hi; ++i) s += a[i];
  const int lane = tid & 31, w = tid >> 5, nw = nt >> 5;
  int v = s;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += u;
  }
  if (lane == 31) warp_tot[w] = v;
  __syncthreads();
  if (w == 0) {
    int t = lane < nw ? warp_tot[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, t, d);
      if (lane >= d) t += u;
    }
    warp_tot[lane] = t;
  }
  __syncthreads();
  int base = v - s + (w ? warp_tot[w - 1] : 0);
  for (int i = lo; i < hi; ++i) {
    const int x = a[i];
    a[i] = base;
    base += x;
  }
  const int total = warp_tot[nw - 1];
  if (tid == 0) a[n] = total;
  __syncthreads();
  return total;
}

// largest i in [0, n) with a[i] <= v (a non-decreasing, a[0] <= v)
static __device__ __forceinline__ int last_at_most(const int* a, int n, int v) {
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (a[mid] <= v) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// region cell of interior (target) cell i
static __device__ __forceinline__ int target_cell(const PairRegion& r, int i) {
  const int tw = r.rw - 2;
  return (i / tw + 1) * r.rw + i % tw + 1;
}

// the neighbour cell of offset o = (oy + 1) * 3 + (ox + 1)
static __device__ __forceinline__ int neighbour(const PairRegion& r, int cell, int o) {
  return cell + (o / 3 - 1) * r.rw + (o % 3 - 1);
}

// Index of target (interior cell i, slot c) in the list that
// region_pair_sums builds; the cell's bit c must be set.
static __device__ __forceinline__ int target_index(
    const PairRegion& r, const PairScratch& s, int i, int c) {
  return s.cell_base[i] + __popc(r.mask[target_cell(r, i)] & ((1u << c) - 1u));
}

// The four sums of every occupied interior row into s.acc (target order:
// interior cells row-major, slots ascending; see target_index).  Every
// thread of the block calls it, after the region's planes, mask and lane
// are written and visible.
static __device__ void region_pair_sums(
    const PairConsts& k, const PairRegion& r, const PairScratch& s) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int n_tc = (r.rh - 2) * (r.rw - 2);
  const int plane = r.rh * r.rw;

  // 1. targets per interior cell, then each target's cell and slot
  for (int i = tid; i < n_tc; i += nt) s.cell_base[i] = __popc(r.mask[target_cell(r, i)]);
  const int n_t = block_exclusive_scan(s.cell_base, n_tc, s.warp_tot);
  for (int t = tid; t < n_t; t += nt) {
    const int i = last_at_most(s.cell_base, n_tc, t);
    const int cell = target_cell(r, i);
    s.t_cell[t] = cell;
    s.t_slot[t] = nth_set_bit(r.mask[cell], t - s.cell_base[i]);
  }
  __syncthreads();

  // 2. one item per (target, neighbour cell): its occupied candidates, the
  //    target itself excluded, less those certainly out of reach (they
  //    would add nothing); then each target's count and term offset
  for (int it = tid; it < n_t * 9; it += nt) {
    const int t = it / 9, o = it - t * 9;
    const int cell = s.t_cell[t], slot = s.t_slot[t];
    const int nc = neighbour(r, cell, o);
    unsigned m = r.mask[nc];
    if (r.lane[nc] == r.lane[cell]) m &= ~(1u << slot);
    unsigned keep = m;
    if (m) {
      const int ti = slot * plane + cell;
      const float pxt = r.px[ti], pyt = r.py[ti], rt = r.rad[ti];
      do {
        const int c = __ffs(m) - 1;
        const int j = c * plane + nc;
        m &= m - 1;
        if (pair_out_of_reach(k, r.px[j] - pxt, r.py[j] - pyt, rt + r.rad[j])) {
          keep &= ~(1u << c);
        }
      } while (m);
    }
    s.reach[it] = keep;
  }
  __syncthreads();
  for (int t = tid; t < n_t; t += nt) {
    int count = 0;
#pragma unroll
    for (int o = 0; o < 9; ++o) count += __popc(s.reach[t * 9 + o]);
    s.t_base[t] = count;
  }
  block_exclusive_scan(s.t_base, n_t, s.warp_tot);

  // 3. windows of whole targets whose terms fit the buffer (one target has
  //    at most 9 * 32 terms, fewer than term_cap)
  for (int t0 = 0; t0 < n_t;) {
    const int w0 = s.t_base[t0];
    const int t1 = last_at_most(s.t_base, n_t + 1, w0 + s.term_cap);
    // one item per (target, neighbour cell): its terms in slot order, at
    // the target's offset plus the earlier cells' counts
    for (int it = t0 * 9 + tid; it < t1 * 9; it += nt) {
      unsigned m = s.reach[it];
      if (!m) continue;
      const int t = it / 9, o = it - t * 9;
      const int cell = s.t_cell[t], slot = s.t_slot[t];
      const int nc = neighbour(r, cell, o);
      int off = s.t_base[t] - w0;
      for (int q = t * 9; q < it; ++q) off += __popc(s.reach[q]);
      const int ti = slot * plane + cell;
      const float pxt = r.px[ti], pyt = r.py[ti], vxt = r.vx[ti], vyt = r.vy[ti];
      const float rt = r.rad[ti], aft = r.afac ? r.afac[ti] : 1.f;
      do {
        const int j = (__ffs(m) - 1) * plane + nc;
        m &= m - 1;
        s.terms[off++] = pair_term(k, r.px, r.py, r.vx, r.vy, r.afac, j, r.rad[j],
                                   pxt, pyt, vxt, vyt, rt, aft);
      } while (m);
    }
    __syncthreads();
    // one thread per target adds its terms in order
    for (int t = t0 + tid; t < t1; t += nt) {
      float sx = 0.f, sy = 0.f, sa = 0.f, sr = 0.f;
      const int hi = s.t_base[t + 1] - w0;
      int u = s.t_base[t] - w0;
      // eight 16-byte loads in flight, then their adds in order
      for (; u + 8 <= hi; u += 8) {
        PairTerm b[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) b[q] = s.terms[u + q];
#pragma unroll
        for (int q = 0; q < 8; ++q) pair_add(b[q], sx, sy, sa, sr);
      }
      for (; u < hi; ++u) pair_add(s.terms[u], sx, sy, sa, sr);
      s.acc[t] = sx;
      s.acc[s.max_t + t] = sy;
      s.acc[2 * s.max_t + t] = sa;
      s.acc[3 * s.max_t + t] = sr;
    }
    __syncthreads();
    t0 = t1;
  }
}
