// raster_tiles.cuh: the per-chunk bodies of the tiled forward and backward
// sweeps, shared by the loop kernels (rasterize_fwd.cu, rasterize_bwd.cu: one
// block per tile) and the queue kernels (rasterize_fwd_q.cu,
// rasterize_bwd_q.cu: persistent blocks driven by the chunk queue). A block
// has one thread per pixel of its tile (blockDim.x = ts * ts).
//
// One copy of the arithmetic makes the loop and queue forwards bit-identical:
// every float operation on the blend path is an explicit round-to-nearest
// intrinsic (the accumulations are __fmaf_rn, which is what nvcc's default
// contraction made of `acc += w * c`), so neither kernel's compilation can
// contract or reorder it differently.
//
// Design for the H100. Only about one (pixel, entry) pair in eight carries
// anything: binning culls an entry at tile granularity, and a gaussian covers
// a small part of its tiles. So each warp covers a compact 8x4 pixel block
// (tile_pixel), and before a group of 32 staged entries is walked, lane j
// tests entry j against the warp's rectangle of pixel centres (warp_may_hit);
// one __ballot_sync gives the group's mask, and every thread walks only the
// set bits, in order, with the sequential arithmetic of raster_common.cuh.
//
// The test is the binning's exact one (ops/tiling.py, _slot_tiles): the
// minimum of q = ca dx^2 + 2 cb dx dy + cc dy^2 over the rectangle (0 when the
// mean is inside, else the least of the four edges' minima) against the gate
// threshold Q = 2 (ln(255 op) + 1e-3), staged once per entry (cull_gate). Q
// sits 2e-3 above where op e^(-q/2) crosses 1/255, which covers the rounding
// of expf and logf; the comparison adds 1e-5 of the largest magnitude of q's
// terms over the rectangle, which covers the rounding of sigma in
// eval_entry and of q here (each a few float32 ulps of those terms), so the
// test never skips a pair the kernel would find contributing. An entry with
// op < 1/255, a conic that is not positive definite or any non-finite
// payload value gets Q = +inf and is never skipped.
//
// Why skipping is exact: a skipped pair has contrib == false, so alpha = 0 and
// next_prod(prod, 0) == prod exactly. Such an entry always counts, since
// tcar * prod > 1e-4 held after the last counted entry (and tcar > 1e-4 at the
// start of a chunk). Its weight is 0, and __fmaf_rn(0, c, acc) == acc for a
// finite c and an accumulator that is never -0; the backward computes no
// terms for it, and its stream column holds zeros either way. So the forward
// output is the unculled walk's bit for bit, and the backward's sums differ
// only by the order of the warp reduction below.
//
// The backward sums an entry's ten gradient terms over the warp with a
// transposed reduction (warp_sum_scatter): the ten values, padded to 16, are
// halved at each butterfly step (xor 16: 8 values, 8: 4, 4: 2, 2: 1, then 1),
// 16 shuffles instead of ten 5-step reductions' 50. Lane 2r then holds sum r,
// and the ten lanes add their sums into the shared accumulators with one
// atomicAdd instruction; the accumulator rows are an odd number of floats
// apart, so the ten addresses fall in ten banks.
//
// Bound: what these inputs need is the forward's ~32 and the backward's
// ~76 float32 operations for each pair that carries anything (alpha != 0),
// beside the bytes of the SoA, the per-pixel rows and the stream; at the
// bench scenes' density the bytes are the larger (chip_smoke.py counts
// both). The kernels do more: each thread evaluates every entry its warp
// keeps (about 2.5 for each one its pixel takes), and the cull costs ~40
// operations per (warp, entry), one lane's test, against 32 pairs'
// evaluation.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "raster_common.cuh"

namespace gs {
namespace {

constexpr int kGradRows = 10;     // dmx dmy dA dB dC dop dr dg db ddepth
constexpr int kGateRow = 10;      // staged row of the cull threshold Q
constexpr int kFwdStageRows = 11; // SoA rows 0..9, Q
constexpr int kBwdStageRows = 12; // SoA rows 0..9, Q, the id (SoA row 11)
constexpr unsigned kFull = 0xffffffffu;
// Relative slack of the cull against the rounding of q and sigma.
constexpr float kCullSlack = 1e-5f;

// A chunk of up to kMaxStage entries is staged whole in shared memory; a
// longer one (the kernels' kStaged instantiation) kStage entries at a time.
// A stage of 256 keeps the backward's 12 staged rows and 10 rows of sums at
// 22.5 KB a block: stages of 1024 (90 KB) left room for two 256-thread
// blocks an SM, and the backward at chunk 2048 took 1.56 ms against 1.20 at
// chunk 256 on the H100 (PERF.md).
constexpr int kMaxStage = 1024;
constexpr int kStage = 256;

// Dynamic shared memory of the forward and backward chunk bodies.
__host__ __device__ constexpr int stage_len(int chunk) {
  return chunk <= kMaxStage ? chunk : kStage;
}
__host__ __device__ constexpr int acc_stride(int stage) { return stage | 1; }
__host__ __device__ constexpr size_t fwd_smem_bytes(int chunk) {
  return (size_t)kFwdStageRows * stage_len(chunk) * sizeof(float);
}
__host__ __device__ constexpr size_t bwd_smem_bytes(int chunk) {
  return ((size_t)kBwdStageRows * stage_len(chunk) +
          (size_t)kGradRows * acc_stride(stage_len(chunk))) *
         sizeof(float);
}

// The pixel of this thread. Warp w covers the 8x4 block (w % (ts / 8),
// w / (ts / 8)) of its tile, lane l the pixel (l % 8, l / 8) of the block;
// p indexes the tile's pixels in row-major order, as the outputs do.
struct Pixel {
  int p;
  float px, py;          // centre in image coordinates
  float xl, xh, yl, yh;  // outermost pixel centres of the warp's block
};

__device__ __forceinline__ Pixel tile_pixel(int t, int ntx, int ts) {
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31, wpr = ts >> 3;
  const int bx = (w % wpr) * 8, by = (w / wpr) * 4;
  const int x0 = (t % ntx) * ts + bx, y0 = (t / ntx) * ts + by;
  Pixel q;
  q.p = (by + (lane >> 3)) * ts + bx + (lane & 7);
  q.px = (float)(x0 + (lane & 7)) + 0.5f;
  q.py = (float)(y0 + (lane >> 3)) + 0.5f;
  q.xl = (float)x0 + 0.5f;
  q.xh = (float)(x0 + 7) + 0.5f;
  q.yl = (float)y0 + 0.5f;
  q.yh = (float)(y0 + 3) + 0.5f;
  return q;
}

// The cull threshold of one entry from its SoA rows 0..9: Q = 2 (ln(255 op)
// + 1e-3), or +inf (never skipped) unless op >= 1/255, the conic is positive
// definite and every value is finite.
__device__ __forceinline__ float cull_gate(const float (&e)[10]) {
  bool ok = true;
#pragma unroll
  for (int r = 0; r < 10; ++r) ok &= isfinite(e[r]);
  const float ca = e[2], cb = e[3], cc = e[4], op = e[5];
  const float det = __fsub_rn(__fmul_rn(ca, cc), __fmul_rn(cb, cb));
  ok &= op >= kAlphaSkip && ca > 0.f && cc > 0.f && det > 0.f;
  return ok ? __fmul_rn(2.f, __fadd_rn(logf(__fmul_rn(255.f, op)), 1e-3f)) : INFINITY;
}

// ca qx^2 + 2 cb qx qy + cc qy^2, in the binning's order.
__device__ __forceinline__ float quad(float ca, float cb, float cc, float qx, float qy) {
  return __fadd_rn(__fadd_rn(__fmul_rn(__fmul_rn(ca, qx), qx),
                             __fmul_rn(__fmul_rn(__fmul_rn(2.f, cb), qx), qy)),
                   __fmul_rn(__fmul_rn(cc, qy), qy));
}

__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// False only if no pixel centre of the warp's block can make the entry
// contribute (see the header comment). ops/rasterize_cuda.py::warp_cull_plain
// mirrors it operation for operation.
__device__ __forceinline__ bool warp_may_hit(const Pixel& q, float mx, float my, float ca,
                                             float cb, float cc, float gate) {
  const float dxl = __fsub_rn(q.xl, mx), dxh = __fsub_rn(q.xh, mx);
  const float dyl = __fsub_rn(q.yl, my), dyh = __fsub_rn(q.yh, my);
  if (dxl <= 0.f && dxh >= 0.f && dyl <= 0.f && dyh >= 0.f) return true;
  const float ex0 = quad(ca, cb, cc, dxl, clip(__fdiv_rn(__fmul_rn(-cb, dxl), cc), dyl, dyh));
  const float ex1 = quad(ca, cb, cc, dxh, clip(__fdiv_rn(__fmul_rn(-cb, dxh), cc), dyl, dyh));
  const float ey0 = quad(ca, cb, cc, clip(__fdiv_rn(__fmul_rn(-cb, dyl), ca), dxl, dxh), dyl);
  const float ey1 = quad(ca, cb, cc, clip(__fdiv_rn(__fmul_rn(-cb, dyh), ca), dxl, dxh), dyh);
  const float q_min = fminf(fminf(ex0, ex1), fminf(ey0, ey1));
  const float X = fmaxf(fabsf(dxl), fabsf(dxh)), Y = fmaxf(fabsf(dyl), fabsf(dyh));
  const float scale = quad(ca, fabsf(cb), cc, X, Y);
  return !(q_min > __fadd_rn(gate, __fmul_rn(kCullSlack, scale)));
}

// The group's mask: bit j set unless staged entry g + j (< n) is culled for
// this warp; S is the stage's row stride. Every lane of the warp must call it.
__device__ __forceinline__ unsigned group_hits(const Pixel& q, const float* sh, int S, int g,
                                               int n) {
  const int k = g + (threadIdx.x & 31);
  const bool hit = k < n && warp_may_hit(q, sh[k], sh[S + k], sh[2 * S + k], sh[3 * S + k],
                                         sh[4 * S + k], sh[kGateRow * S + k]);
  return __ballot_sync(kFull, hit);
}

// Stage the entries [col0, col0 + n) of the (16, soa_cols) SoA, n <= S:
// rows 0..9 in sh[r * S + k], Q in row kGateRow and, with the id, SoA row 11
// in row 11.
__device__ __forceinline__ void stage_entries(const float* __restrict__ soa, int64_t soa_cols,
                                              int64_t col0, int n, int S, float* sh,
                                              bool with_id) {
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const int64_t col = col0 + k;
    float e[10];
#pragma unroll
    for (int r = 0; r < 10; ++r) {
      e[r] = soa[r * soa_cols + col];
      sh[r * S + k] = e[r];
    }
    sh[kGateRow * S + k] = cull_gate(e);
    if (with_id) sh[11 * S + k] = soa[11 * soa_cols + col];
  }
}

struct FwdAcc {
  float r = 0.f, g = 0.f, b = 0.f, d = 0.f, w = 0.f;
};

// Blend the staged entries [col0, col0 + n), n <= S, into one pixel's
// sums: stage them (sh holds kFwdStageRows * S floats), then walk the
// entries the warp did not cull until the first that fails the stop rule
// against tc, the transmittance at the chunk's start; prod (the running
// product of the chunk's counted entries) and done (the pixel has left the
// chunk) carry in and out. The caller synchronizes before it.
__device__ __forceinline__ void fwd_stage(const float* __restrict__ soa, int64_t soa_cols,
                                          int64_t col0, int n, int S, float* sh,
                                          const Pixel& q, float tc, float* prod_io,
                                          bool* done_io, FwdAcc* acc) {
  stage_entries(soa, soa_cols, col0, n, S, sh, false);
  __syncthreads();

  float prod = *prod_io;
  bool done = *done_io;
  for (int g = 0; g < n && !__all_sync(kFull, done); g += 32) {
    unsigned hits = group_hits(q, sh, S, g, n);
    if (done) continue;  // no warp-wide operation follows in this group
    while (hits) {
      const int k = g + __ffs(hits) - 1;
      hits &= hits - 1;
      const Entry e = eval_entry(q.px, q.py, sh[k], sh[S + k], sh[2 * S + k], sh[3 * S + k],
                                 sh[4 * S + k], sh[5 * S + k]);
      const float prod_next = next_prod(prod, e.alpha);
      if (!entry_counts(tc, prod_next)) {
        done = true;
        break;
      }
      const float w = __fmul_rn(__fmul_rn(e.alpha, tc), prod);
      acc->r = __fmaf_rn(w, sh[6 * S + k], acc->r);
      acc->g = __fmaf_rn(w, sh[7 * S + k], acc->g);
      acc->b = __fmaf_rn(w, sh[8 * S + k], acc->b);
      acc->d = __fmaf_rn(w, sh[9 * S + k], acc->d);
      acc->w = __fadd_rn(acc->w, w);
      prod = prod_next;
    }
  }
  *prod_io = prod;
  *done_io = done;
}

// Blend the chunk [col0, col0 + n) into one pixel's sums: staged whole, or,
// kStaged (chunk > kMaxStage), kStage entries at a time. Each thread leaves
// the chunk at its first entry that fails the stop rule: the chunk's
// running product and that exit carry across its stages and end only with
// the chunk, so a chunk staged in pieces blends as one staged whole; a
// block whose pixels have all left the chunk stages no more of it. tcar,
// the transmittance after the last counted entry, carries from one chunk to
// the next.
template <bool kStaged>
__device__ __forceinline__ void fwd_chunk(const float* __restrict__ soa, int64_t soa_cols,
                                          int64_t col0, int n, int chunk, float* sh,
                                          const Pixel& q, float* tcar, FwdAcc* acc) {
  const float tc = *tcar;
  float prod = 1.0f;  // prod_{j<k}(1 - alpha_j) within this chunk
  bool done = false;
  if (!kStaged) {
    __syncthreads();  // the previous chunk is no longer read
    fwd_stage(soa, soa_cols, col0, n, chunk, sh, q, tc, &prod, &done, acc);
  } else {
    for (int s0 = 0; s0 < n; s0 += kStage) {
      if (s0 == 0)
        __syncthreads();  // the previous chunk is no longer read
      else if (__syncthreads_and(done))
        break;  // the previous stage is no longer read, and no pixel is left in the chunk
      fwd_stage(soa, soa_cols, col0 + s0, min(kStage, n - s0), kStage, sh, q, tc, &prod, &done,
                acc);
    }
  }
  *tcar = __fmul_rn(tc, prod);
}

// out[t] = (8, P) rows [r, g, b, depth, sum_w, 0, 0, 0] at pixel p.
__device__ __forceinline__ void fwd_store(float* __restrict__ out, int t, int p,
                                          const FwdAcc& a) {
  const int P = blockDim.x;
  float* o = out + (int64_t)t * 8 * P + p;
  o[0] = a.r;
  o[P] = a.g;
  o[2 * P] = a.b;
  o[3 * P] = a.d;
  o[4 * P] = a.w;
  o[5 * P] = 0.f;
  o[6 * P] = 0.f;
  o[7 * P] = 0.f;
}

// One butterfly step of the transposed reduction: lanes with bit `o` set keep
// the upper half of a[0, 2h), the others the lower half, each adding the
// partner's copy of the half it keeps; the kept half moves to a[0, h).
template <int H>
__device__ __forceinline__ void scatter_step(float (&a)[16], int lane) {
  const bool up = lane & (2 * H);
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float keep = up ? a[i + H] : a[i];
    const float send = up ? a[i] : a[i + H];
    a[i] = keep + __shfl_xor_sync(kFull, send, 2 * H);
  }
}

// The warp's sums of v[0..kGradRows): lane l returns the sum of v[l >> 1]
// (for l < 2 * kGradRows; other lanes return zero sums of the padding).
__device__ __forceinline__ float warp_sum_scatter(const float (&v)[kGradRows]) {
  const int lane = threadIdx.x & 31;
  float a[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) a[i] = i < kGradRows ? v[i] : 0.f;
  scatter_step<8>(a, lane);
  scatter_step<4>(a, lane);
  scatter_step<2>(a, lane);
  scatter_step<1>(a, lane);
  return a[0] + __shfl_xor_sync(kFull, a[0], 1);
}

// One pixel's cotangent of the forward output rows [r, g, b, depth, sum_w]
// and Q = sum_c gout_c fout_c over the 8 rows.
struct BwdPixel {
  float g_r, g_g, g_b, g_d, g_w, q;
};

__device__ __forceinline__ BwdPixel bwd_pixel(const float* __restrict__ gout,
                                              const float* __restrict__ fout, int t, int p) {
  const int P = blockDim.x;
  const float* g = gout + (int64_t)t * 8 * P + p;
  const float* f = fout + (int64_t)t * 8 * P + p;
  BwdPixel b{g[0], g[P], g[2 * P], g[3 * P], g[4 * P], 0.f};
#pragma unroll
  for (int c = 0; c < 8; ++c) b.q += g[c * P] * f[c * P];
  return b;
}

// The backward of the staged entries [col0, col0 + n), n <= S: stage them
// (sh holds the staged rows, kBwdStageRows * S floats, followed by the sums
// acc[r * acc_stride(S) + k], r < kGradRows), recompute the forward's
// alphas and stop rule against tc over the entries the warp did not cull,
// sum each entry's ten gradient terms over the tile's pixels, and append
// the n columns to grad (16, grad_cap) at a base reserved with one
// atomicAdd on *cursor (s_base is one shared int). prod, done and pc (the
// pixel's running prefix of gw * w) carry in and out.
__device__ __forceinline__ void bwd_stage(const float* __restrict__ soa, int64_t soa_cols,
                                          int64_t col0, int n, int S, float* sh, int* s_base,
                                          const Pixel& q, const BwdPixel& gp, float tc,
                                          float* prod_io, bool* done_io, float* pc_io,
                                          float* __restrict__ grad, int64_t grad_cap,
                                          int* __restrict__ cursor) {
  const int P = blockDim.x;
  const int lane = threadIdx.x & 31;
  const int as = acc_stride(S);
  float* acc = sh + kBwdStageRows * S;
  __syncthreads();  // the previous stage's rows and sums are no longer read
  stage_entries(soa, soa_cols, col0, n, S, sh, true);
  for (int k = threadIdx.x; k < n; k += P) {
#pragma unroll
    for (int r = 0; r < kGradRows; ++r) acc[r * as + k] = 0.f;
  }
  __syncthreads();

  float prod = *prod_io;
  bool done = *done_io;
  float pc = *pc_io;
  for (int g = 0; g < n && !__all_sync(kFull, done); g += 32) {
    unsigned hits = group_hits(q, sh, S, g, n);
    while (hits) {
      const int k = g + __ffs(hits) - 1;
      hits &= hits - 1;
      float v[kGradRows];
#pragma unroll
      for (int r = 0; r < kGradRows; ++r) v[r] = 0.f;
      bool active = false;
      if (!done) {
        const float ca = sh[2 * S + k], cb = sh[3 * S + k], cc = sh[4 * S + k];
        const Entry e = eval_entry(q.px, q.py, sh[k], sh[S + k], ca, cb, cc, sh[5 * S + k]);
        const float prod_next = next_prod(prod, e.alpha);
        if (!entry_counts(tc, prod_next)) {
          done = true;
        } else {
          if (e.contrib) {
            const float t_before = tc * prod;
            const float w = e.alpha * t_before;
            const float gw = gp.g_r * sh[6 * S + k] + gp.g_g * sh[7 * S + k] +
                             gp.g_b * sh[8 * S + k] + gp.g_d * sh[9 * S + k] + gp.g_w;
            pc += gw * w;
            const float d_alpha = gw * t_before - (gp.q - pc) / (1.0f - e.alpha);
            const bool gate = e.araw <= kAlphaClamp;
            const float ds = gate ? -d_alpha * e.araw : 0.f;
            v[0] = -(ca * e.dx + cb * e.dy) * ds;
            v[1] = -(cc * e.dy + cb * e.dx) * ds;
            v[2] = 0.5f * e.dx * e.dx * ds;
            v[3] = e.dx * e.dy * ds;
            v[4] = 0.5f * e.dy * e.dy * ds;
            v[5] = gate ? d_alpha * e.vis : 0.f;
            v[6] = w * gp.g_r;
            v[7] = w * gp.g_g;
            v[8] = w * gp.g_b;
            v[9] = w * gp.g_d;
            active = true;
          }
          prod = prod_next;
        }
      }
      if (__any_sync(kFull, active)) {
        const float s = warp_sum_scatter(v);
        if (!(lane & 1) && (lane >> 1) < kGradRows) atomicAdd(&acc[(lane >> 1) * as + k], s);
      }
      if (__all_sync(kFull, done)) break;
    }
  }
  *prod_io = prod;
  *done_io = done;
  *pc_io = pc;
  __syncthreads();  // every warp's sums are in

  if (threadIdx.x == 0) *s_base = atomicAdd(cursor, n);
  __syncthreads();
  for (int k = threadIdx.x; k < n; k += P) {
    const int64_t pos = (int64_t)*s_base + k;
    if (pos >= grad_cap) continue;
    grad[pos] = sh[11 * S + k];
#pragma unroll
    for (int r = 0; r < kGradRows; ++r) grad[(r + 1) * grad_cap + pos] = acc[r * as + k];
#pragma unroll
    for (int r = 11; r < 16; ++r) grad[r * grad_cap + pos] = 0.f;
  }
}

// The backward of the chunk [col0, col0 + n): staged whole or, kStaged
// (chunk > kMaxStage), kStage entries at a time, each stage appended as it
// is done (the TPU kernel appends every column of a chunk). As in the
// forward, the chunk's running product, each pixel's exit and the warp's
// exit carry across its stages and end only with the chunk. tcar and pcar
// (the running prefix of gw * w) carry from one chunk to the next.
template <bool kStaged>
__device__ __forceinline__ void bwd_chunk(const float* __restrict__ soa, int64_t soa_cols,
                                          int64_t col0, int n, int chunk, float* sh,
                                          int* s_base, const Pixel& q, const BwdPixel& gp,
                                          float* tcar, float* pcar,
                                          float* __restrict__ grad, int64_t grad_cap,
                                          int* __restrict__ cursor) {
  const float tc = *tcar;
  float prod = 1.0f;  // prod_{j<k}(1 - alpha_j) within this chunk
  bool done = false;
  if (!kStaged) {
    bwd_stage(soa, soa_cols, col0, n, chunk, sh, s_base, q, gp, tc, &prod, &done, pcar, grad,
              grad_cap, cursor);
  } else {
    for (int s0 = 0; s0 < n; s0 += kStage)
      bwd_stage(soa, soa_cols, col0 + s0, min(kStage, n - s0), kStage, sh, s_base, q, gp, tc,
                &prod, &done, pcar, grad, grad_cap, cursor);
  }
  *tcar = __fmul_rn(tc, prod);
}

// meta = [n_written, n_dropped, entries appended]: the TPU kernel's
// accounting in whole chunks of `chunk` (a final partial chunk is padded to
// a full one, rasterize_pallas.py:442), whatever the stages the entries
// were appended in, with the pad columns sentinel-filled (id = sentinel,
// zero payload).
__global__ void rasterize_bwd_tail_kernel(float* __restrict__ grad, int64_t grad_cap,
                                          int* __restrict__ meta, int chunk,
                                          float sentinel) {
  const int64_t total = meta[2];
  const int64_t chunks_total = (total + chunk - 1) / chunk;
  const int64_t cap_chunks = grad_cap / chunk;
  const int64_t chunks_kept = chunks_total < cap_chunks ? chunks_total : cap_chunks;
  const int64_t written = chunks_kept * chunk;
  for (int64_t j = total + threadIdx.x; j < written; j += blockDim.x) {
    grad[j] = sentinel;
    for (int r = 1; r < 16; ++r) grad[r * grad_cap + j] = 0.f;
  }
  if (threadIdx.x == 0) {
    meta[0] = (int)written;
    meta[1] = (int)((chunks_total - chunks_kept) * chunk);
  }
}

}  // namespace
}  // namespace gs
