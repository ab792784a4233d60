// rasterize_bwd_q: the tiled backward driven by the flat chunk queue.
//
// Replaces: gaussian_splatting_tpu/ops/rasterize_pallas.py::_bwd_kernel_q.
// Same contract as rasterize_bwd.cu (one stream column per entry [gaussian
// id, dmx, dmy, dA, dB, dC, dop, dr, dg, db, ddepth, 0 x 5], meta =
// [n_written, n_dropped] in whole chunks), with the work given as the queue
// of tiling.chunk_queue: work item w in [0, n_work) is chunk
// ci = w - cum[wtile[w]] of tile wtile[w], items tile-major.
//
// On the TPU the per-tile carries (T, the prefix of gw * w, Q) live in VMEM
// between consecutive grid steps of one tile. On Hopper blocks run in no
// order, so a tile's chunks stay in one block: a persistent grid sized to
// the SMs, one thread per pixel; a block takes the next tile with one global
// atomicAdd on a cursor that the entry point zeroes, skips a tile whose run
// [cum[t], cum[t+1]) is empty, and walks its work items, reading (tile, ci)
// from the queue, with the carries in registers. The per-chunk body, the
// append (one atomicAdd per chunk reserves its columns, so the column order
// changes from run to run) and the tail launch that rounds n_written up to
// whole chunks are rasterize_bwd.cu's (raster_tiles.cuh). As in
// rasterize_fwd_q.cu, the queue tables are read only to keep the TPU
// kernel's contract: cum alone would give the same walk.
//
// The TPU kernel's two-step-lagged saturation flag is not carried over: it
// can never fire, because the carried T never falls to 1e-4 (see
// rasterize_fwd_q.cu); every chunk's columns are appended, as there.
//
// Bound on the H100: as rasterize_bwd.cu (bytes at the bench scenes'
// density), plus the queue's cum and one wtile entry per work item. The
// per-chunk body, with its warp cull and transposed warp reduction, is
// rasterize_bwd.cu's.

#include <cuda_runtime.h>
#include <stdint.h>

#include "raster_tiles.cuh"

namespace {

// kStaged: chunk > gs::kMaxStage, staged in pieces.
template <bool kStaged>
__global__ void rasterize_bwd_q_kernel(const int* __restrict__ wtile,
                                       const int* __restrict__ cum,
                                       const int* __restrict__ tile_starts,
                                       const int* __restrict__ counts,
                                       const int* __restrict__ n_work, int w_cap,
                                       const float* __restrict__ soa, int64_t soa_cols,
                                       const float* __restrict__ gout,
                                       const float* __restrict__ fout,
                                       float* __restrict__ grad, int64_t grad_cap,
                                       int* __restrict__ cursor, int* __restrict__ next_tile,
                                       int n_tiles, int ts, int ntx, int chunk) {
  extern __shared__ float sh[];  // staged rows, then the sums (raster_tiles.cuh)
  __shared__ int s_base;
  __shared__ int s_tile;
  const int nw = *n_work;
  for (;;) {
    __syncthreads();  // every thread has read the previous s_tile
    if (threadIdx.x == 0) s_tile = atomicAdd(next_tile, 1);
    __syncthreads();
    const int t = s_tile;
    if (t >= n_tiles) break;
    const int w0 = cum[t];
    const int w1 = min(min(cum[t + 1], nw), w_cap);  // wtile holds w_cap items
    if (w0 >= w1) continue;  // an empty tile: not in the queue
    const gs::Pixel q = gs::tile_pixel(t, ntx, ts);
    const gs::BwdPixel gp = gs::bwd_pixel(gout, fout, t, q.p);
    float tcar = 1.0f;  // transmittance after the last counted entry
    float pcar = 0.0f;  // running prefix sum of gw * w
    for (int w = w0; w < w1; ++w) {
      const int tw = wtile[w];
      const int ci = w - cum[tw];
      const int base = ci * chunk;
      gs::bwd_chunk<kStaged>(soa, soa_cols, (int64_t)tile_starts[tw] + base,
                    min(chunk, counts[tw] - base), chunk, sh, &s_base, q, gp, &tcar, &pcar,
                    grad, grad_cap, cursor);
    }
  }
}

}  // namespace

// wtile: (w_cap,) int32, the kernel reads no item at or past w_cap; cum,
// tile_starts: (n_tiles + 1,) int32; counts: (n_tiles,) int32; n_work: (1,)
// int32; soa: (16, soa_cols) float32; gout, fout: (n_tiles, 8, ts * ts)
// float32; grad: (16, grad_cap) float32, grad_cap a multiple of chunk; meta:
// (3,) int32 = [n_written, n_dropped, appended]; next_tile: (1,) int32
// scratch. meta and next_tile are zeroed here.
extern "C" int gs_rasterize_bwd_q(const void* wtile, const void* cum, const void* tile_starts,
                                  const void* counts, const void* n_work, int w_cap,
                                  const void* soa, int64_t soa_cols, const void* gout,
                                  const void* fout, void* grad, int64_t grad_cap, void* meta,
                                  void* next_tile, int n_tiles, int ts, int ntx, int chunk,
                                  float sentinel, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(meta, 0, 3 * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  if ((err = cudaMemsetAsync(next_tile, 0, sizeof(int), s)) != cudaSuccess) return (int)err;
  if (n_tiles > 0) {
    const int threads = ts * ts;
    const size_t smem = gs::bwd_smem_bytes(chunk);
    auto* fn =
        chunk > gs::kMaxStage ? rasterize_bwd_q_kernel<true> : rasterize_bwd_q_kernel<false>;
    if ((err = cudaFuncSetAttribute(fn,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)smem)) != cudaSuccess)
      return (int)err;
    int device = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
        cudaSuccess)
      return (int)err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads, smem)) !=
        cudaSuccess)
      return (int)err;
    int blocks = per_sm * sms;
    if (blocks > n_tiles) blocks = n_tiles;
    if (blocks < 1) blocks = 1;
    fn<<<blocks, threads, smem, s>>>(
        (const int*)wtile, (const int*)cum, (const int*)tile_starts, (const int*)counts,
        (const int*)n_work, w_cap, (const float*)soa, soa_cols, (const float*)gout,
        (const float*)fout, (float*)grad, grad_cap, (int*)meta + 2, (int*)next_tile, n_tiles,
        ts, ntx, chunk);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  gs::rasterize_bwd_tail_kernel<<<1, 256, 0, s>>>((float*)grad, grad_cap, (int*)meta,
                                                  chunk, sentinel);
  return (int)cudaGetLastError();
}
