// rasterize_bwd: per-entry gradients of the tiled blend, appended compactly
// to one gradient stream shared by all tiles.
//
// Replaces: gaussian_splatting_tpu/ops/rasterize_pallas.py::_bwd_kernel.
// Same contract: tile t sweeps its segment [tile_starts[t], +counts[t]) of
// the (16, soa_cols) SoA in chunks of `chunk` entries, recomputing the
// forward's alphas and its chunk-carried stop rule, and appends one column
// per entry to grad (16, grad_cap):
//   row 0 = gaussian id (exact float, SoA row 11), rows 1..10 = [dmx, dmy,
//   dA, dB, dC, dop, dr, dg, db, ddepth] summed over the tile's pixels,
//   rows 11..15 = 0.
// Inputs per pixel: the cotangent gout (n_tiles, 8, P) of the forward output
// rows [r, g, b, depth, sum_w, 0, 0, 0] and that output fout itself.
// Per (pixel, entry) that counts (rasterize_pallas.py:338-390):
//   gw = sum_c gout_c [r, g, b, depth, 1]_c,  w = alpha T_before,
//   prefix += gw w (the pixel's running sum, carried across chunks),
//   Q = sum_c gout_c fout_c,
//   d_alpha = gw T_before - (Q - prefix) / (1 - alpha),
//   d_sigma = -d_alpha araw where the gate passes and araw <= 0.999,
//   dmx = -(ca dx + cb dy) d_sigma, dmy = -(cc dy + cb dx) d_sigma,
//   dA = dx^2 d_sigma / 2, dB = dx dy d_sigma, dC = dy^2 d_sigma / 2,
//   dop = d_alpha e^-sigma (same gate), [dr, dg, db, ddepth] = w gout_c.
// The TPU kernel's moment basis and MXU contractions are TPU artefacts; the
// sums are taken directly here.
//
// Append: the TPU kernel's sequential grid carries one cursor; here each
// block reserves the room for a chunk's entries with one global atomicAdd,
// so the column order changes from run to run. The contract is the
// per-gaussian sums after the reduce and the drop count. Entries past
// grad_cap are dropped and counted. A one-block tail launch then rounds the
// written count up to a whole chunk as the TPU kernel reports it
// (rasterize_pallas.py:442), sentinel-fills that tail (id = n_gaussians,
// zero payload) and writes meta = [n_written, n_dropped].
//
// The transmittance chain comes from raster_common.cuh, shared with the
// forward kernel, so the stop decisions are the forward's bit for bit. Like
// the TPU kernel (whose carried T never falls to 1e-4, ROADMAP queue 3),
// every chunk of every tile is swept.
//
// Bound on the H100: operations, ~76 float32 operations per (pixel, entry)
// pair evaluated (chip_smoke.py lists them), against ~44 bytes of SoA per
// entry shared by the block's 256 pixels. Design: one block per tile, one
// thread per pixel, each chunk's rows staged once in shared memory; each
// thread walks the chunk sequentially (the products and the prefix sum are
// sequential); the ten per-entry sums are reduced over the warp with
// shuffles, skipped when no lane of the warp touches the entry, and added
// into shared-memory accumulators with one float atomic per warp; a warp
// leaves the chunk once all its pixels have stopped.

#include <cuda_runtime.h>
#include <stdint.h>

#include "raster_common.cuh"

namespace {

constexpr int kGradRows = 10;   // dmx dmy dA dB dC dop dr dg db ddepth
constexpr int kStageRows = 11;  // SoA rows 0..9 and the id (row 11)
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__global__ void rasterize_bwd_kernel(const int* __restrict__ tile_starts,
                                     const int* __restrict__ counts,
                                     const float* __restrict__ soa,
                                     int64_t soa_cols,
                                     const float* __restrict__ gout,
                                     const float* __restrict__ fout,
                                     float* __restrict__ grad,
                                     int64_t grad_cap,
                                     int* __restrict__ cursor,
                                     int ts, int ntx, int chunk) {
  extern __shared__ float sh[];   // staged rows: sh[r * chunk + k], r < 11
  float* acc = sh + kStageRows * chunk;  // sums: acc[r * chunk + k], r < 10
  __shared__ int s_base;
  const int t = blockIdx.x;
  const int P = ts * ts;
  const int p = threadIdx.x;
  const int64_t start = tile_starts[t];
  const int count = counts[t];
  const float px = (float)((t % ntx) * ts + p % ts) + 0.5f;
  const float py = (float)((t / ntx) * ts + p / ts) + 0.5f;

  const float* g = gout + (int64_t)t * 8 * P + p;
  const float* f = fout + (int64_t)t * 8 * P + p;
  const float g_r = g[0], g_g = g[P], g_b = g[2 * P], g_d = g[3 * P], g_w = g[4 * P];
  float q = 0.f;  // Q = sum_c gout_c fout_c over the 8 output rows
#pragma unroll
  for (int c = 0; c < 8; ++c) q += g[c * P] * f[c * P];

  float tcar = 1.0f;  // transmittance after the last counted entry
  float pcar = 0.0f;  // running prefix sum of gw * w
  for (int base = 0; base < count; base += chunk) {
    const int n = min(chunk, count - base);
    __syncthreads();  // the previous chunk's rows and sums are no longer read
    for (int k = p; k < n; k += P) {
      const int64_t col = start + base + k;
#pragma unroll
      for (int r = 0; r < 10; ++r) sh[r * chunk + k] = soa[r * soa_cols + col];
      sh[10 * chunk + k] = soa[11 * soa_cols + col];
#pragma unroll
      for (int r = 0; r < kGradRows; ++r) acc[r * chunk + k] = 0.f;
    }
    __syncthreads();

    float prod = 1.0f;  // prod_{j<k}(1 - alpha_j) within this chunk
    bool done = false;
    for (int k = 0; k < n; ++k) {
      float v[kGradRows];
#pragma unroll
      for (int r = 0; r < kGradRows; ++r) v[r] = 0.f;
      bool active = false;
      if (!done) {
        const float ca = sh[2 * chunk + k], cb = sh[3 * chunk + k], cc = sh[4 * chunk + k];
        const gs::Entry e = gs::eval_entry(px, py, sh[k], sh[chunk + k], ca, cb, cc,
                                           sh[5 * chunk + k]);
        const float prod_next = gs::next_prod(prod, e.alpha);
        if (!gs::entry_counts(tcar, prod_next)) {
          done = true;
        } else {
          if (e.contrib) {
            const float t_before = tcar * prod;
            const float w = e.alpha * t_before;
            const float gw = g_r * sh[6 * chunk + k] + g_g * sh[7 * chunk + k] +
                             g_b * sh[8 * chunk + k] + g_d * sh[9 * chunk + k] + g_w;
            pcar += gw * w;
            const float d_alpha = gw * t_before - (q - pcar) / (1.0f - e.alpha);
            const bool gate = e.araw <= gs::kAlphaClamp;
            const float ds = gate ? -d_alpha * e.araw : 0.f;
            v[0] = -(ca * e.dx + cb * e.dy) * ds;
            v[1] = -(cc * e.dy + cb * e.dx) * ds;
            v[2] = 0.5f * e.dx * e.dx * ds;
            v[3] = e.dx * e.dy * ds;
            v[4] = 0.5f * e.dy * e.dy * ds;
            v[5] = gate ? d_alpha * e.vis : 0.f;
            v[6] = w * g_r;
            v[7] = w * g_g;
            v[8] = w * g_b;
            v[9] = w * g_d;
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
    tcar = __fmul_rn(tcar, prod);
    __syncthreads();  // every warp's sums are in

    if (p == 0) s_base = atomicAdd(cursor, n);
    __syncthreads();
    for (int k = p; k < n; k += P) {
      const int64_t pos = (int64_t)s_base + k;
      if (pos >= grad_cap) continue;
      grad[pos] = sh[10 * chunk + k];
#pragma unroll
      for (int r = 0; r < kGradRows; ++r) grad[(r + 1) * grad_cap + pos] = acc[r * chunk + k];
#pragma unroll
      for (int r = 11; r < 16; ++r) grad[r * grad_cap + pos] = 0.f;
    }
  }
}

// meta = [n_written, n_dropped, entries appended]: the TPU kernel's
// accounting in whole chunks (a final partial chunk is padded to a full
// one), with the pad columns sentinel-filled.
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

// tile_starts: (n_tiles + 1,) int32; counts: (n_tiles,) int32;
// soa: (16, soa_cols) float32; gout, fout: (n_tiles, 8, ts * ts) float32;
// grad: (16, grad_cap) float32, grad_cap a multiple of chunk;
// meta: (3,) int32, zeroed here, = [n_written, n_dropped, appended].
extern "C" int gs_rasterize_bwd(const void* tile_starts, const void* counts,
                                const void* soa, int64_t soa_cols,
                                const void* gout, const void* fout, void* grad,
                                int64_t grad_cap, void* meta, int n_tiles, int ts,
                                int ntx, int chunk, float sentinel, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(meta, 0, 3 * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  if (n_tiles > 0) {
    const size_t smem = (size_t)(kStageRows + kGradRows) * chunk * sizeof(float);
    err = cudaFuncSetAttribute(rasterize_bwd_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    rasterize_bwd_kernel<<<n_tiles, ts * ts, smem, s>>>(
        (const int*)tile_starts, (const int*)counts, (const float*)soa, soa_cols,
        (const float*)gout, (const float*)fout, (float*)grad, grad_cap,
        (int*)meta + 2, ts, ntx, chunk);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  rasterize_bwd_tail_kernel<<<1, 256, 0, s>>>((float*)grad, grad_cap, (int*)meta, chunk,
                                              sentinel);
  return (int)cudaGetLastError();
}
