// bin_slots: the binning's slot enumeration for one view (or one band of tile
// rows), as a pair of kernels: one pass over the gaussians and one over the
// slots, writing each slot's sort key (and on the compact layout its gaussian).
//
// Replaces no TPU kernel: the JAX package enumerates the slots in plain jnp
// (gaussian_splatting_tpu/ops/tiling.py: _tile_rects, _enumerate_slots, the
// key of the flat sort). Added because on the H100 the same chain in PyTorch
// (ops/tiling.py: _tile_rects, compact_slots, _slot_tiles, slot_sort_key) ran
// some 200 elementwise and gather launches a view over the whole (M,) slot
// array, most of the binning's device time (PERF.md).
//
// Contract: ops/tiling.py::bin_slots. Bit for bit the plain code's outputs on
// the card: every float operation is the one PyTorch's elementwise kernel
// does, in the plain code's order, and this source is built with -fmad=false
// (ops/_build.py), so every product and sum rounds alone. A division by a
// Python scalar is PyTorch's multiplication by the scalar's float reciprocal;
// torch.minimum / maximum / clamp propagate NaN; float -> int32 casts
// saturate and take NaN to 0 (cvt.rzi, as PyTorch's cast). Constants are the
// Python doubles rounded to float, as PyTorch rounds a scalar.
//
// bin_rects_kernel, one thread a gaussian: _tile_rects (the valid test, the
// gate Q, the sheared window tx0, ty0, nx, wt clipped to the band [row_lo,
// row_hi), n_tiles, n_capped), the depth's order bits, and on the compact
// layout its footprint class (the classes whose cap is below n_capped; class
// L for an empty footprint). It writes a 48-byte Rect a gaussian and the
// uint8 class, and adds into the int64 stats with integer atomics (one a
// block): stats[0] += n_tiles - n_capped (n_dropped); on the compact layout
// stats[2] += n_capped (the budget drop counts every capped tile first) and
// stats[3 + c] += the gaussians of class c. Nothing is read back to the host.
//
// bin_slots_kernel, one thread a column of the layout, looping over the
// column's slots: dense, column g is gaussian g and slot s * N + g its s-th
// slot, s < max_t; compact, column offset_c' + j is rank j of class c (the
// stable class order, perm, from one torch.sort of the classes between the
// two launches) and slot slot_off_c + s * budget_c + j its s-th slot, s <
// cap_c; its gaussian is perm[start_c + j] (0 past N), in the class while j <
// min(count_c, budget_c). Each slot gets _slot_tiles' tile (row and column of
// the window, the row's conservative base column, the exact min-over-rect
// ellipse cull against Q) or the sentinel T, and writes the int64 key (tile <<
// 32) | order_bits(depth) of the flat exact sort, or the int32 tile for the
// bucket partition and the depth_bits key. stats[1] += the slots with a tile
// (n_isect); a column in its class takes its n_capped back off stats[2], so
// stats[2] ends as the capped tiles of the gaussians past their budget.
//
// Bound on the H100: bytes. The gaussian pass reads 32 B a gaussian and
// writes 49; the slot pass writes 8 B a slot (the exact key; 4 for a tile,
// 4 more for the compact gid) and reads one 48-byte Rect (and on the compact
// layout an 8-byte perm entry) a column. One thread walks a column's slots,
// so a Rect is read once and not once a slot, and a warp's 32 columns are 32
// consecutive slots at each step of the walk: every store is coalesced. Slots
// past n_capped are sentinels and cost only their store.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxClasses = 32;

// The per-gaussian record of the slot pass (48 bytes, three 16-byte words).
struct __align__(16) Rect {
  int tx0, ty0, nx, wt;
  int n_capped;
  unsigned obits;  // the depth's float total order
  float q, mx;
  float my, ca, cb, cc;
};

// The static compact layout: class c has cap[c] slots a column, budget[c]
// columns ending at column col_end[c], and its block of cap * budget slots
// starts at slot_off[c].
struct Layout {
  int n_classes;
  int cap[kMaxClasses];
  long long budget[kMaxClasses];
  long long col_end[kMaxClasses];
  long long slot_off[kMaxClasses];
};

// torch.minimum / torch.maximum on float32: NaN propagates, else fminf/fmaxf.
__device__ __forceinline__ float nan_min(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
// torch.clamp_min(x, lo) and torch.clamp(x, lo, hi) with scalar bounds.
__device__ __forceinline__ float clamp_min_f(float x, float lo) {
  return x != x ? x : fmaxf(x, lo);
}
__device__ __forceinline__ float clamp_f(float x, float lo, float hi) {
  return x != x ? x : fminf(fmaxf(x, lo), hi);
}
// tiling._clip: min(hi, max(lo, x)).
__device__ __forceinline__ float clip_f(float x, float lo, float hi) {
  return nan_min(nan_max(x, lo), hi);
}

// tiling._gate_q: clamp_min(2 (ln(255 clamp_min(op, 1e-12)) + 1e-3), 0).
__device__ __forceinline__ float gate_q(float op) {
  return clamp_min_f(2.0f * (logf(255.0f * clamp_min_f(op, (float)1e-12)) + (float)1e-3),
                     0.0f);
}

__device__ __forceinline__ unsigned order_bits(float x) {
  const unsigned b = __float_as_uint(x);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// The quadratic form of _slot_tiles.q, in its order.
__device__ __forceinline__ float quad(float ca, float cb, float cc, float qx, float qy) {
  return ca * qx * qx + 2.0f * cb * qx * qy + cc * qy * qy;
}

// tiling._slot_tiles for slot s of a gaussian whose capped tile count is
// ncap: its tile, or T when s >= ncap or the tile's pixel rect stays below
// the gate.
__device__ __forceinline__ int slot_tile(const Rect& r, int s, int ncap, int ntx, float fts,
                                         float inv_fts, int T) {
  if (s >= ncap) return T;
  const int wt_safe = max(r.wt, 1);
  const int row = s / wt_safe;
  const int col = s - row * wt_safe;
  const float ca = r.ca, cb = r.cb, cc = r.cc, Q = r.q;
  const float ca_s = clamp_min_f(ca, (float)1e-12);
  const float cc_s = clamp_min_f(cc, (float)1e-12);
  const float det = ca * cc - cb * cb;

  // Conservative leftmost kept x in the row band [dyl, dyl + ts].
  const float dyl = (float)(r.ty0 + row) * fts - r.my;
  const float dyc = dyl + 0.5f * fts;
  const float dym = nan_min(nan_max(0.0f, dyl), dyl + fts);
  const float half_chord = sqrtf(clamp_min_f(ca * Q - det * dym * dym, 0.0f)) / ca_s;
  const float dxlo = (-cb * dyc - 0.5f * fabsf(cb) * fts) / ca_s - half_chord - 0.5f;
  const int txlo = (int)floorf((r.mx + dxlo) * inv_fts);
  const int base = min(max(txlo, r.tx0), r.tx0 + r.nx - wt_safe);

  const int tx = base + col;
  const int ty = r.ty0 + row;
  const int tid = ty * ntx + tx;

  // Exact conservative ellipse-tile cull over the slot's pixel rect.
  const float dxl = (float)tx * fts - r.mx;
  const float dxh = dxl + fts;
  const float dyl_t = (float)ty * fts - r.my;
  const float dyh = dyl_t + fts;
  const float ex_l = quad(ca, cb, cc, dxl, clip_f(-cb * dxl / cc_s, dyl_t, dyh));
  const float ex_h = quad(ca, cb, cc, dxh, clip_f(-cb * dxh / cc_s, dyl_t, dyh));
  const float ey_l = quad(ca, cb, cc, clip_f(-cb * dyl_t / ca_s, dxl, dxh), dyl_t);
  const float ey_h = quad(ca, cb, cc, clip_f(-cb * dyh / ca_s, dxl, dxh), dyh);
  float q_min = nan_min(nan_min(ex_l, ex_h), nan_min(ey_l, ey_h));
  if (dxl <= 0.0f && dxh >= 0.0f && dyl_t <= 0.0f && dyh >= 0.0f) q_min = 0.0f;
  return q_min > Q ? T : tid;
}

// Sums a and b over the block; thread 0 adds them into *pa and *pb (null:
// skipped) with one atomic each.
__device__ __forceinline__ void block_add(long long a, long long b, unsigned long long* pa,
                                          unsigned long long* pb) {
  __shared__ long long sh[2][kWarps];
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_down_sync(kFull, a, o);
    b += __shfl_down_sync(kFull, b, o);
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    sh[0][warp] = a;
    sh[1][warp] = b;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    a = 0;
    b = 0;
    for (int w = 0; w < kWarps; ++w) {
      a += sh[0][w];
      b += sh[1][w];
    }
    if (pa && a) atomicAdd(pa, (unsigned long long)a);
    if (pb && b) atomicAdd(pb, (unsigned long long)b);
  }
}

template <bool kCompact>
__global__ void __launch_bounds__(kThreads)
bin_rects_kernel(int n, const float* __restrict__ means2d, const float* __restrict__ conics,
                 const float* __restrict__ opac, const int* __restrict__ radii,
                 const float* __restrict__ depths, int ntx, int ts, int row_lo, int row_hi,
                 int max_t, Layout lay, Rect* __restrict__ rect, unsigned char* __restrict__ cls,
                 unsigned long long* __restrict__ stats) {
  __shared__ int hist[kMaxClasses + 1];
  const int L = lay.n_classes;
  if (kCompact) {
    for (int i = threadIdx.x; i <= L; i += kThreads) hist[i] = 0;
    __syncthreads();
  }
  const int g = blockIdx.x * kThreads + threadIdx.x;
  long long dropped = 0, capped = 0;
  if (g < n) {
    const float fts = (float)ts;
    const float inv_ts = 1.0f / fts;
    const float mx = __ldg(means2d + 2 * g), my = __ldg(means2d + 2 * g + 1);
    const float ca = __ldg(conics + 3 * g), cb = __ldg(conics + 3 * g + 1),
                cc = __ldg(conics + 3 * g + 2);
    const float op = __ldg(opac + g);
    const int rad = __ldg(radii + g);
    const bool valid = rad > 0 && op >= (float)(1.0 / 255.0);
    const float r = (float)rad;
    const float ca_s = clamp_min_f(ca, (float)1e-12);
    const float det_s = clamp_min_f(ca * cc - cb * cb, (float)1e-20);
    const float Q = gate_q(op);
    const float xe = nan_min(r, sqrtf(Q * clamp_min_f(cc, (float)1e-12) / det_s) + 0.5f);
    const float ye = nan_min(r, sqrtf(Q * ca_s / det_s) + 0.5f);
    const float fx = (float)ntx, lo = (float)row_lo, hi = (float)row_hi;
    const int tx0 = (int)clamp_f(floorf((mx - xe) * inv_ts), 0.0f, fx);
    const int tx1 = (int)clamp_f(ceilf((mx + xe) * inv_ts), 0.0f, fx);
    const int ty0 = (int)clamp_f(floorf((my - ye) * inv_ts), lo, hi);
    const int ty1 = (int)clamp_f(ceilf((my + ye) * inv_ts), lo, hi);
    const int nx = valid ? max(tx1 - tx0, 0) : 0;
    const int ny = valid ? max(ty1 - ty0, 0) : 0;
    const float w_px = (fabsf(cb) * fts + 2.0f * sqrtf(Q * ca_s)) / ca_s + 1.0f;
    // min in float before the int cast: w_px can be huge for near-singular
    // conics.
    const int wt = (int)nan_min(ceilf(w_px * inv_ts) + 1.0f, (float)nx);
    const int n_tiles = ny * wt;
    const int n_capped = min(n_tiles, max_t);
    Rect out;
    out.tx0 = tx0;
    out.ty0 = ty0;
    out.nx = nx;
    out.wt = wt;
    out.n_capped = n_capped;
    out.obits = order_bits(__ldg(depths + g));
    out.q = Q;
    out.mx = mx;
    out.my = my;
    out.ca = ca;
    out.cb = cb;
    out.cc = cc;
    rect[g] = out;
    dropped = n_tiles - n_capped;
    if (kCompact) {
      int c = L;
      if (n_capped > 0) {
        c = 0;
        while (c < L - 1 && lay.cap[c] < n_capped) ++c;
      }
      cls[g] = (unsigned char)c;
      atomicAdd(hist + c, 1);
      capped = n_capped;
    }
  }
  block_add(dropped, capped, stats, kCompact ? stats + 2 : nullptr);
  if (kCompact) {
    for (int i = threadIdx.x; i <= L; i += kThreads)
      if (hist[i]) atomicAdd(stats + 3 + i, (unsigned long long)hist[i]);
  }
}

template <bool kCompact, bool kExact>
__global__ void __launch_bounds__(kThreads)
bin_slots_kernel(long long n_cols, int n, const Rect* __restrict__ rect,
                 const long long* __restrict__ perm, Layout lay, int max_t, int ntx, int ts,
                 int T, void* __restrict__ key_out, int* __restrict__ gid_out,
                 unsigned long long* __restrict__ stats) {
  __shared__ long long start[kMaxClasses], live[kMaxClasses];
  if (kCompact) {
    // Class c's gaussians start at rank start[c] of the class order; the
    // first min(count_c, budget_c) of them have slots.
    if (threadIdx.x == 0) {
      long long acc = 0;
      for (int c = 0; c < lay.n_classes; ++c) {
        const long long k = (long long)stats[3 + c];
        start[c] = acc;
        live[c] = k < lay.budget[c] ? k : lay.budget[c];
        acc += k;
      }
    }
    __syncthreads();
  }
  const long long col = (long long)blockIdx.x * kThreads + threadIdx.x;
  long long kept = 0, in_budget = 0;
  if (col < n_cols) {
    const float fts = (float)ts;
    const float inv_fts = 1.0f / fts;
    int g, cap, ncap;
    long long slot, stride;
    Rect r;
    if (kCompact) {
      int c = 0;
      while (col >= lay.col_end[c]) ++c;
      const long long j = col - (lay.col_end[c] - lay.budget[c]);
      const long long idx = start[c] + j;
      g = idx < n ? (int)__ldg(perm + idx) : 0;
      r = rect[g];
      ncap = j < live[c] ? r.n_capped : 0;
      in_budget = ncap;
      cap = lay.cap[c];
      slot = lay.slot_off[c] + j;
      stride = lay.budget[c];
    } else {
      g = (int)col;
      r = rect[g];
      ncap = r.n_capped;
      cap = max_t;
      slot = col;
      stride = n;
    }
    for (int s = 0; s < cap; ++s, slot += stride) {
      const int tile = slot_tile(r, s, ncap, ntx, fts, inv_fts, T);
      kept += tile < T;
      if (kExact)
        static_cast<long long*>(key_out)[slot] = ((long long)tile << 32) | (long long)r.obits;
      else
        static_cast<int*>(key_out)[slot] = tile;
      if (kCompact) gid_out[slot] = g;
    }
  }
  // stats[2] -= in_budget: two's complement through the unsigned atomic.
  block_add(kept, -in_budget, stats + 1, kCompact ? stats + 2 : nullptr);
}

bool fill_layout(int n_classes, const int* caps, const long long* budgets, Layout* lay) {
  if (n_classes < 0 || n_classes > kMaxClasses) return false;
  lay->n_classes = n_classes;
  long long cols = 0, slots = 0;
  for (int c = 0; c < n_classes; ++c) {
    lay->cap[c] = caps[c];
    lay->budget[c] = budgets ? budgets[c] : 0;
    lay->slot_off[c] = slots;
    cols += lay->budget[c];
    slots += lay->budget[c] * caps[c];
    lay->col_end[c] = cols;
  }
  return true;
}

unsigned blocks_for(long long n) { return (unsigned)((n + kThreads - 1) / kThreads); }

}  // namespace

// The gaussian pass. means2d (n, 2), conics (n, 3), opac (n,), depths (n,)
// float32 and radii (n,) int32, contiguous, on the device; caps: host array
// of the n_classes class caps (0 classes: the dense layout). rect: (n, 12)
// int32, 16-byte aligned; cls: (n,) uint8 (compact only); stats: (4 +
// n_classes,) int64, zeroed here.
extern "C" int gs_bin_rects(int n, const void* means2d, const void* conics, const void* opac,
                            const void* radii, const void* depths, int ntx, int ts, int row_lo,
                            int row_hi, int max_t, int n_classes, const int* caps, void* rect,
                            void* cls, void* stats, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  Layout lay;
  if (!fill_layout(n_classes, caps, nullptr, &lay)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(stats, 0, (4 + n_classes) * sizeof(long long), st);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return (int)cudaGetLastError();
  const float* m = (const float*)means2d;
  const float* c = (const float*)conics;
  const float* o = (const float*)opac;
  const int* r = (const int*)radii;
  const float* d = (const float*)depths;
  Rect* out = (Rect*)rect;
  unsigned char* k = (unsigned char*)cls;
  unsigned long long* s = (unsigned long long*)stats;
  if (n_classes > 0)
    bin_rects_kernel<true><<<blocks_for(n), kThreads, 0, st>>>(
        n, m, c, o, r, d, ntx, ts, row_lo, row_hi, max_t, lay, out, k, s);
  else
    bin_rects_kernel<false><<<blocks_for(n), kThreads, 0, st>>>(
        n, m, c, o, r, d, ntx, ts, row_lo, row_hi, max_t, lay, out, k, s);
  return (int)cudaGetLastError();
}

// The slot pass, after gs_bin_rects on the same rect and stats. perm: (n,)
// int64 stable class order (compact only); budgets: host array of the
// n_classes budgets. key: (M,) int64 when exact, else int32; gid: (M,) int32
// (compact only), M the layout's slots (n * max_t dense).
extern "C" int gs_bin_slots(int n, const void* rect, const void* perm, int max_t, int n_classes,
                            const int* caps, const long long* budgets, int ntx, int ts, int T,
                            int exact, void* key, void* gid, void* stats, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  Layout lay;
  if (!fill_layout(n_classes, caps, budgets, &lay)) return (int)cudaErrorInvalidValue;
  const long long n_cols = n_classes > 0 ? lay.col_end[n_classes - 1] : (long long)n;
  if (n_cols == 0) return (int)cudaGetLastError();
  const Rect* rc = (const Rect*)rect;
  const long long* p = (const long long*)perm;
  int* g = (int*)gid;
  unsigned long long* s = (unsigned long long*)stats;
  const unsigned blocks = blocks_for(n_cols);
  if (n_classes > 0 && exact)
    bin_slots_kernel<true, true><<<blocks, kThreads, 0, st>>>(n_cols, n, rc, p, lay, max_t, ntx,
                                                              ts, T, key, g, s);
  else if (n_classes > 0)
    bin_slots_kernel<true, false><<<blocks, kThreads, 0, st>>>(n_cols, n, rc, p, lay, max_t,
                                                               ntx, ts, T, key, g, s);
  else if (exact)
    bin_slots_kernel<false, true><<<blocks, kThreads, 0, st>>>(n_cols, n, rc, p, lay, max_t,
                                                               ntx, ts, T, key, g, s);
  else
    bin_slots_kernel<false, false><<<blocks, kThreads, 0, st>>>(n_cols, n, rc, p, lay, max_t,
                                                                ntx, ts, T, key, g, s);
  return (int)cudaGetLastError();
}
