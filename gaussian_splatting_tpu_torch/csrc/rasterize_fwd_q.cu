// rasterize_fwd_q: the tiled forward blend driven by the flat chunk queue.
//
// Replaces: gaussian_splatting_tpu/ops/rasterize_pallas.py::_fwd_kernel_q.
// Same contract as rasterize_fwd.cu, bit for bit, with the work given as the
// queue of tiling.chunk_queue: work item w in [0, n_work) is chunk
// ci = w - cum[wtile[w]] of tile wtile[w], items tile-major. Tiles with no
// work are never in the queue; the TPU kernel leaves their output blocks
// unwritten and its caller zeroes them (rasterize_pallas.py:948). Here the
// cursor visits every tile anyway, so an empty tile's block is written as
// zeros in the kernel, as rasterize_fwd.cu writes it.
//
// The queue tables are read only to keep the TPU kernel's contract: for the
// tile t a block holds, wtile[w] is t and ci is w - cum[t] by construction,
// so cum alone would give the same walk.
//
// On the TPU the queue exists so that one core pipelines one chunk per grid
// step instead of stalling on a while_loop's data-dependent condition; the
// per-tile carry T lives in VMEM between consecutive steps of one tile. On
// Hopper blocks run in no order, so a tile's chunks must stay in one block:
// a loop inside the block takes the place of the sequential grid. Design: a
// persistent grid sized to the SMs (occupancy x SM count), one thread per
// pixel; a block takes the next tile with one global atomicAdd on a cursor
// that the entry point zeroes, skips a tile whose run [cum[t], cum[t+1]) is
// empty, and walks its work items, reading (tile, ci) from the queue, with
// the carry in a register. The per-chunk body is rasterize_fwd.cu's
// (raster_tiles.cuh), so the outputs are equal bit for bit.
//
// The TPU kernel's saturation flag (skip a chunk's math once every pixel of
// the tile has T <= 1e-4, read two steps late) is not carried over: it can
// never fire. tcar is multiplied only by products whose entries counted,
// and an entry counts only while tcar * prod stays above 1e-4, so tcar never
// falls to 1e-4 (ROADMAP queue 3, "the tile loop never exits early").
//
// Bound on the H100: as rasterize_fwd.cu (bytes at the bench scenes'
// density); the queue adds two int loads per chunk and one atomic per tile.
// The per-chunk body, with its warp cull, is rasterize_fwd.cu's.

#include <cuda_runtime.h>
#include <stdint.h>

#include "raster_tiles.cuh"

namespace {

// kStaged: chunk > gs::kMaxStage, staged in pieces.
template <bool kStaged>
__global__ void rasterize_fwd_q_kernel(const int* __restrict__ wtile,
                                       const int* __restrict__ cum,
                                       const int* __restrict__ tile_starts,
                                       const int* __restrict__ counts,
                                       const int* __restrict__ n_work, int w_cap,
                                       const float* __restrict__ soa, int64_t soa_cols,
                                       float* __restrict__ out, int* __restrict__ next_tile,
                                       int n_tiles, int ts, int ntx, int chunk) {
  extern __shared__ float sh[];  // the staged rows of one chunk (raster_tiles.cuh)
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
    const gs::Pixel q = gs::tile_pixel(t, ntx, ts);
    if (w0 >= w1) {  // an empty tile: not in the queue, its block zero
      gs::fwd_store(out, t, q.p, gs::FwdAcc{});
      continue;
    }
    float tcar = 1.0f;
    gs::FwdAcc acc;
    for (int w = w0; w < w1; ++w) {
      const int tw = wtile[w];
      const int ci = w - cum[tw];
      const int base = ci * chunk;
      gs::fwd_chunk<kStaged>(soa, soa_cols, (int64_t)tile_starts[tw] + base,
                    min(chunk, counts[tw] - base), chunk, sh, q, &tcar, &acc);
    }
    gs::fwd_store(out, t, q.p, acc);
  }
}

}  // namespace

// wtile: (w_cap,) int32, the kernel reads no item at or past w_cap; cum,
// tile_starts: (n_tiles + 1,) int32; counts: (n_tiles,) int32; n_work: (1,)
// int32; soa: (16, soa_cols) float32; out: (n_tiles, 8, ts * ts) float32,
// every block written (zeros for empty tiles); next_tile: (1,) int32
// scratch, zeroed here.
extern "C" int gs_rasterize_fwd_q(const void* wtile, const void* cum, const void* tile_starts,
                                  const void* counts, const void* n_work, int w_cap,
                                  const void* soa, int64_t soa_cols, void* out,
                                  void* next_tile, int n_tiles, int ts, int ntx, int chunk,
                                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(next_tile, 0, sizeof(int), s);
  if (err != cudaSuccess || n_tiles == 0) return (int)err;
  const int threads = ts * ts;
  const size_t smem = gs::fwd_smem_bytes(chunk);
  auto* fn =
      chunk > gs::kMaxStage ? rasterize_fwd_q_kernel<true> : rasterize_fwd_q_kernel<false>;
  if ((err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)) !=
      cudaSuccess)
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
      (const int*)n_work, w_cap, (const float*)soa, soa_cols, (float*)out, (int*)next_tile,
      n_tiles, ts, ntx, chunk);
  return (int)cudaGetLastError();
}
