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
// same order; only the colour sums may differ in their last bits. The
// per-chunk body lives in raster_tiles.cuh, shared with the queue kernel
// (rasterize_fwd_q.cu), whose output is this kernel's bit for bit.
//
// Bound on the H100: operations, ~30 float32 operations (one expf) per
// (pixel, entry) pair evaluated, against ~40 bytes of SoA per entry shared
// by the block's 256 pixels. Design: each chunk is staged once in shared
// memory with coalesced row loads (rows 0-9 only), then every thread reads
// it by broadcast; a thread leaves the chunk at its first failing entry.

#include <cuda_runtime.h>
#include <stdint.h>

#include "raster_tiles.cuh"

namespace {

__global__ void rasterize_fwd_kernel(const int* __restrict__ tile_starts,
                                     const int* __restrict__ counts,
                                     const float* __restrict__ soa,
                                     int64_t soa_cols,
                                     float* __restrict__ out,
                                     int ts, int ntx, int chunk) {
  extern __shared__ float sh[];  // rows 0..9 of one chunk: sh[r * chunk + k]
  const int t = blockIdx.x;
  const int64_t start = tile_starts[t];
  const int count = counts[t];
  float px, py;
  gs::pixel_center(t, ntx, ts, threadIdx.x, &px, &py);

  float tcar = 1.0f;
  gs::FwdAcc acc;
  for (int base = 0; base < count; base += chunk)
    gs::fwd_chunk(soa, soa_cols, start + base, min(chunk, count - base), chunk, sh, px, py,
                  &tcar, &acc);
  gs::fwd_store(out, t, acc);
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
