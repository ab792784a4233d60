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

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "raster_common.cuh"

namespace gs {
namespace {

constexpr int kGradRows = 10;   // dmx dmy dA dB dC dop dr dg db ddepth
constexpr int kStageRows = 11;  // SoA rows 0..9 and the id (row 11)
constexpr unsigned kFull = 0xffffffffu;

// Centre of pixel p of tile t, in image coordinates.
__device__ __forceinline__ void pixel_center(int t, int ntx, int ts, int p, float* px,
                                             float* py) {
  *px = (float)((t % ntx) * ts + p % ts) + 0.5f;
  *py = (float)((t / ntx) * ts + p / ts) + 0.5f;
}

struct FwdAcc {
  float r = 0.f, g = 0.f, b = 0.f, d = 0.f, w = 0.f;
};

// Blend the chunk [col0, col0 + n) of the (16, soa_cols) SoA into one
// pixel's sums. The block stages rows 0..9 in sh (10 * chunk floats); each
// thread then walks the chunk and leaves it at its first entry that fails
// the stop rule. tcar, the transmittance after the last counted entry,
// carries from one chunk to the next.
__device__ __forceinline__ void fwd_chunk(const float* __restrict__ soa, int64_t soa_cols,
                                          int64_t col0, int n, int chunk, float* sh,
                                          float px, float py, float* tcar, FwdAcc* acc) {
  const int P = blockDim.x;
  const int p = threadIdx.x;
  __syncthreads();  // the previous chunk is no longer read
  for (int k = p; k < n; k += P) {
#pragma unroll
    for (int r = 0; r < 10; ++r) sh[r * chunk + k] = soa[r * soa_cols + col0 + k];
  }
  __syncthreads();

  const float tc = *tcar;
  float prod = 1.0f;  // prod_{j<k}(1 - alpha_j) within this chunk
  for (int k = 0; k < n; ++k) {
    const Entry e = eval_entry(px, py, sh[k], sh[chunk + k], sh[2 * chunk + k],
                               sh[3 * chunk + k], sh[4 * chunk + k], sh[5 * chunk + k]);
    const float prod_next = next_prod(prod, e.alpha);
    if (!entry_counts(tc, prod_next)) break;
    const float w = __fmul_rn(__fmul_rn(e.alpha, tc), prod);
    acc->r = __fmaf_rn(w, sh[6 * chunk + k], acc->r);
    acc->g = __fmaf_rn(w, sh[7 * chunk + k], acc->g);
    acc->b = __fmaf_rn(w, sh[8 * chunk + k], acc->b);
    acc->d = __fmaf_rn(w, sh[9 * chunk + k], acc->d);
    acc->w = __fadd_rn(acc->w, w);
    prod = prod_next;
  }
  *tcar = __fmul_rn(tc, prod);
}

// out[t] = (8, P) rows [r, g, b, depth, sum_w, 0, 0, 0].
__device__ __forceinline__ void fwd_store(float* __restrict__ out, int t, const FwdAcc& a) {
  const int P = blockDim.x;
  float* o = out + (int64_t)t * 8 * P + threadIdx.x;
  o[0] = a.r;
  o[P] = a.g;
  o[2 * P] = a.b;
  o[3 * P] = a.d;
  o[4 * P] = a.w;
  o[5 * P] = 0.f;
  o[6 * P] = 0.f;
  o[7 * P] = 0.f;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// One pixel's cotangent of the forward output rows [r, g, b, depth, sum_w]
// and Q = sum_c gout_c fout_c over the 8 rows.
struct BwdPixel {
  float g_r, g_g, g_b, g_d, g_w, q;
};

__device__ __forceinline__ BwdPixel bwd_pixel(const float* __restrict__ gout,
                                              const float* __restrict__ fout, int t) {
  const int P = blockDim.x;
  const float* g = gout + (int64_t)t * 8 * P + threadIdx.x;
  const float* f = fout + (int64_t)t * 8 * P + threadIdx.x;
  BwdPixel b{g[0], g[P], g[2 * P], g[3 * P], g[4 * P], 0.f};
#pragma unroll
  for (int c = 0; c < 8; ++c) b.q += g[c * P] * f[c * P];
  return b;
}

// The backward of the chunk [col0, col0 + n): recompute the forward's
// alphas and stop rule, sum each entry's ten gradient terms over the tile's
// pixels, and append the chunk's n columns to grad (16, grad_cap) at a base
// reserved with one atomicAdd on *cursor. sh holds the staged rows
// (kStageRows * chunk floats) followed by the sums (kGradRows * chunk);
// s_base is one shared int. tcar and pcar (the running prefix of gw * w)
// carry from one chunk to the next.
__device__ __forceinline__ void bwd_chunk(const float* __restrict__ soa, int64_t soa_cols,
                                          int64_t col0, int n, int chunk, float* sh,
                                          int* s_base, float px, float py, const BwdPixel& gp,
                                          float* tcar, float* pcar,
                                          float* __restrict__ grad, int64_t grad_cap,
                                          int* __restrict__ cursor) {
  const int P = blockDim.x;
  const int p = threadIdx.x;
  float* acc = sh + kStageRows * chunk;  // sums: acc[r * chunk + k], r < 10
  __syncthreads();  // the previous chunk's rows and sums are no longer read
  for (int k = p; k < n; k += P) {
    const int64_t col = col0 + k;
#pragma unroll
    for (int r = 0; r < 10; ++r) sh[r * chunk + k] = soa[r * soa_cols + col];
    sh[10 * chunk + k] = soa[11 * soa_cols + col];
#pragma unroll
    for (int r = 0; r < kGradRows; ++r) acc[r * chunk + k] = 0.f;
  }
  __syncthreads();

  const float tc = *tcar;
  float pc = *pcar;
  float prod = 1.0f;  // prod_{j<k}(1 - alpha_j) within this chunk
  bool done = false;
  for (int k = 0; k < n; ++k) {
    float v[kGradRows];
#pragma unroll
    for (int r = 0; r < kGradRows; ++r) v[r] = 0.f;
    bool active = false;
    if (!done) {
      const float ca = sh[2 * chunk + k], cb = sh[3 * chunk + k], cc = sh[4 * chunk + k];
      const Entry e = eval_entry(px, py, sh[k], sh[chunk + k], ca, cb, cc, sh[5 * chunk + k]);
      const float prod_next = next_prod(prod, e.alpha);
      if (!entry_counts(tc, prod_next)) {
        done = true;
      } else {
        if (e.contrib) {
          const float t_before = tc * prod;
          const float w = e.alpha * t_before;
          const float gw = gp.g_r * sh[6 * chunk + k] + gp.g_g * sh[7 * chunk + k] +
                           gp.g_b * sh[8 * chunk + k] + gp.g_d * sh[9 * chunk + k] + gp.g_w;
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
#pragma unroll
      for (int r = 0; r < kGradRows; ++r) v[r] = warp_sum(v[r]);
      if ((p & 31) == 0) {
#pragma unroll
        for (int r = 0; r < kGradRows; ++r) atomicAdd(&acc[r * chunk + k], v[r]);
      }
    }
    if (__all_sync(kFull, done)) break;
  }
  *tcar = __fmul_rn(tc, prod);
  *pcar = pc;
  __syncthreads();  // every warp's sums are in

  if (p == 0) *s_base = atomicAdd(cursor, n);
  __syncthreads();
  for (int k = p; k < n; k += P) {
    const int64_t pos = (int64_t)*s_base + k;
    if (pos >= grad_cap) continue;
    grad[pos] = sh[10 * chunk + k];
#pragma unroll
    for (int r = 0; r < kGradRows; ++r) grad[(r + 1) * grad_cap + pos] = acc[r * chunk + k];
#pragma unroll
    for (int r = 11; r < 16; ++r) grad[r * grad_cap + pos] = 0.f;
  }
}

// meta = [n_written, n_dropped, entries appended]: the TPU kernel's
// accounting in whole chunks (a final partial chunk is padded to a full
// one, rasterize_pallas.py:442), with the pad columns sentinel-filled
// (id = sentinel, zero payload).
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
