// rasterize_fwd: per-tile front-to-back alpha blending of depth-sorted
// gaussians, one block per tile and one thread per pixel.
//
// Replaces: gaussian_splatting_tpu/ops/rasterize_pallas.py::_fwd_kernel.
// Same contract: tile t sweeps its segment [tile_starts[t], +counts[t]) of
// the (16, soa_cols) SoA (rows mx, my, ca, cb, cc, op, r, g, b, depth) in
// chunks of `chunk` entries and writes out[t] = (8, P) rows
// [r, g, b, depth, sum_w, 0, 0, 0], P = ts * ts pixels in row-major order.
//
// Per (pixel, entry): sigma = 0.5 (ca dx^2 + cc dy^2) + cb dx dy,
// alpha = min(op e^-sigma, 0.999) where sigma >= 0 and op e^-sigma >= 1/255,
// else 0. Stop rule of the TPU kernel, kept exactly: inside a chunk an
// entry counts while T_carry * prod_{j<=k}(1 - alpha_j) > 1e-4 and the first
// entry that fails ends the pixel's chunk; the next chunk starts again from
// the transmittance after the last entry that counted. So a pixel stopped in
// one chunk can take entries of the next, and the chunk length is part of
// the result (ROADMAP queue 3). The TPU kernel's aligned window + roll, lane
// prefix-product scan and MXU blend are TPU artefacts and are not carried
// over: here each thread walks the chunk sequentially.
//
// The transmittance chain (sigma, alpha, the products and the stop test)
// lives in raster_common.cuh, shared with the backward kernel, and is
// written with explicit round-to-nearest intrinsics, so no multiply-add is
// contracted and the stop decisions are bit-identical to the plain PyTorch
// version (fwd_tiles_plain), which does the same float32 operations in the
// same order; only the colour sums may differ in their last bits.
//
// Bound on the H100: operations, ~30 float32 operations (one expf) per
// (pixel, entry) pair evaluated, against ~40 bytes of SoA per entry shared
// by the block's 256 pixels. Design: each chunk is staged once in shared
// memory with coalesced row loads (rows 0-9 only), then every thread reads
// it by broadcast; a thread leaves the chunk at its first failing entry.

#include <cuda_runtime.h>
#include <stdint.h>

#include "raster_common.cuh"

namespace {

__global__ void rasterize_fwd_kernel(const int* __restrict__ tile_starts,
                                     const int* __restrict__ counts,
                                     const float* __restrict__ soa,
                                     int64_t soa_cols,
                                     float* __restrict__ out,
                                     int ts, int ntx, int chunk) {
  extern __shared__ float sh[];  // rows 0..9 of one chunk: sh[r * chunk + k]
  const int t = blockIdx.x;
  const int P = ts * ts;
  const int p = threadIdx.x;
  const int64_t start = tile_starts[t];
  const int count = counts[t];
  const float px = (float)((t % ntx) * ts + p % ts) + 0.5f;
  const float py = (float)((t / ntx) * ts + p / ts) + 0.5f;

  float tcar = 1.0f;
  float acc_r = 0.f, acc_g = 0.f, acc_b = 0.f, acc_d = 0.f, acc_w = 0.f;
  for (int base = 0; base < count; base += chunk) {
    const int n = min(chunk, count - base);
    __syncthreads();  // the previous chunk is no longer read
    for (int k = p; k < n; k += P) {
      const int64_t col = start + base + k;
#pragma unroll
      for (int r = 0; r < 10; ++r) sh[r * chunk + k] = soa[r * soa_cols + col];
    }
    __syncthreads();

    float prod = 1.0f;  // prod_{j<k}(1 - alpha_j) within this chunk
    for (int k = 0; k < n; ++k) {
      const gs::Entry e = gs::eval_entry(px, py, sh[k], sh[chunk + k], sh[2 * chunk + k],
                                         sh[3 * chunk + k], sh[4 * chunk + k],
                                         sh[5 * chunk + k]);
      const float prod_next = gs::next_prod(prod, e.alpha);
      if (!gs::entry_counts(tcar, prod_next)) break;
      const float w = __fmul_rn(__fmul_rn(e.alpha, tcar), prod);
      acc_r += w * sh[6 * chunk + k];
      acc_g += w * sh[7 * chunk + k];
      acc_b += w * sh[8 * chunk + k];
      acc_d += w * sh[9 * chunk + k];
      acc_w += w;
      prod = prod_next;
    }
    tcar = __fmul_rn(tcar, prod);
  }

  float* o = out + (int64_t)t * 8 * P + p;
  o[0] = acc_r;
  o[P] = acc_g;
  o[2 * P] = acc_b;
  o[3 * P] = acc_d;
  o[4 * P] = acc_w;
  o[5 * P] = 0.f;
  o[6 * P] = 0.f;
  o[7 * P] = 0.f;
}

}  // namespace

// tile_starts: (n_tiles + 1,) int32; counts: (n_tiles,) int32;
// soa: (16, soa_cols) float32; out: (n_tiles, 8, ts * ts) float32.
extern "C" int gs_rasterize_fwd(const void* tile_starts, const void* counts,
                                const void* soa, int64_t soa_cols, void* out,
                                int n_tiles, int ts, int ntx, int chunk,
                                void* stream) {
  if (n_tiles == 0) return (int)cudaGetLastError();
  const size_t smem = (size_t)10 * chunk * sizeof(float);
  rasterize_fwd_kernel<<<n_tiles, ts * ts, smem, (cudaStream_t)stream>>>(
      (const int*)tile_starts, (const int*)counts, (const float*)soa, soa_cols,
      (float*)out, ts, ntx, chunk);
  return (int)cudaGetLastError();
}
