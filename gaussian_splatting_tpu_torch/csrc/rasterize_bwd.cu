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
// forward kernel, so the stop decisions are the forward's bit for bit; the
// per-chunk body and the tail launch live in raster_tiles.cuh, shared with
// the queue kernel (rasterize_bwd_q.cu). Like the TPU kernel (whose
// carried T never falls to 1e-4, ROADMAP queue 3), every chunk of every
// tile is swept.
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

#include "raster_tiles.cuh"

namespace {

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
  extern __shared__ float sh[];  // staged rows, then the sums (raster_tiles.cuh)
  __shared__ int s_base;
  const int t = blockIdx.x;
  const int64_t start = tile_starts[t];
  const int count = counts[t];
  float px, py;
  gs::pixel_center(t, ntx, ts, threadIdx.x, &px, &py);
  const gs::BwdPixel gp = gs::bwd_pixel(gout, fout, t);

  float tcar = 1.0f;  // transmittance after the last counted entry
  float pcar = 0.0f;  // running prefix sum of gw * w
  for (int base = 0; base < count; base += chunk)
    gs::bwd_chunk(soa, soa_cols, start + base, min(chunk, count - base), chunk, sh, &s_base,
                  px, py, gp, &tcar, &pcar, grad, grad_cap, cursor);
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
    const size_t smem = (size_t)(gs::kStageRows + gs::kGradRows) * chunk * sizeof(float);
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
  gs::rasterize_bwd_tail_kernel<<<1, 256, 0, s>>>((float*)grad, grad_cap, (int*)meta,
                                                  chunk, sentinel);
  return (int)cudaGetLastError();
}
