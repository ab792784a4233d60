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
// Bound on the H100: bytes at the bench scenes' density: ~40 bytes of SoA
// read once per entry and the 32-byte output per pixel. The ~32 float32
// operations (one expf) per (pixel, entry) pair are needed only for the
// pairs with alpha != 0, about one in eight there, and take less
// (chip_smoke.py counts both; without the cull every pair would need them,
// an operations bound). Design (raster_tiles.cuh): each chunk
// is staged once in shared memory with coalesced row loads (rows 0-9 and
// each entry's cull threshold), a chunk longer than 1024 entries 256 at a
// time, its stop rule carried across the pieces; each warp covers an 8x4 pixel block and
// skips, by an exact ellipse-rectangle test and one ballot per 32 entries,
// the entries that contribute to none of its pixels, which leaves the
// output unchanged bit for bit; a thread leaves the chunk at its first
// failing entry.

#include <cuda_runtime.h>
#include <stdint.h>

#include "raster_tiles.cuh"

namespace {

// kStaged: chunk > gs::kMaxStage, staged in pieces.
template <bool kStaged>
__global__ void rasterize_fwd_kernel(const int* __restrict__ tile_starts,
                                     const int* __restrict__ counts,
                                     const float* __restrict__ soa,
                                     int64_t soa_cols,
                                     float* __restrict__ out,
                                     int ts, int ntx, int chunk) {
  extern __shared__ float sh[];  // the staged rows of one chunk (raster_tiles.cuh)
  const int t = blockIdx.x;
  const int64_t start = tile_starts[t];
  const int count = counts[t];
  const gs::Pixel q = gs::tile_pixel(t, ntx, ts);

  float tcar = 1.0f;
  gs::FwdAcc acc;
  for (int base = 0; base < count; base += chunk)
    gs::fwd_chunk<kStaged>(soa, soa_cols, start + base, min(chunk, count - base), chunk, sh, q, &tcar,
                  &acc);
  gs::fwd_store(out, t, q.p, acc);
}

}  // namespace

// tile_starts: (n_tiles + 1,) int32; counts: (n_tiles,) int32;
// soa: (16, soa_cols) float32; out: (n_tiles, 8, ts * ts) float32.
extern "C" int gs_rasterize_fwd(const void* tile_starts, const void* counts,
                                const void* soa, int64_t soa_cols, void* out,
                                int n_tiles, int ts, int ntx, int chunk,
                                void* stream) {
  if (n_tiles == 0) return (int)cudaGetLastError();
  const size_t smem = gs::fwd_smem_bytes(chunk);
  auto* fn = chunk > gs::kMaxStage ? rasterize_fwd_kernel<true> : rasterize_fwd_kernel<false>;
  cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fn<<<n_tiles, ts * ts, smem, (cudaStream_t)stream>>>(
      (const int*)tile_starts, (const int*)counts, (const float*)soa, soa_cols,
      (float*)out, ts, ntx, chunk);
  return (int)cudaGetLastError();
}
