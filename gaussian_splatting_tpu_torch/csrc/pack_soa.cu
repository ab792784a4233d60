// pack_soa: builds the rasterizer's (16, m_out) float32 SoA from the
// per-gaussian quantities and the depth-sorted slot -> gaussian index.
//
// Replaces: gaussian_splatting_tpu/ops/tiling.py::_pack_kernel (via
// pack_soa). The TPU kernel stacks 11 already-permuted rows; here the
// kernel gathers from the (10, n) per-gaussian table through the sorted
// gaussian id instead, which spares the ten M-long payload permutations
// the sort would otherwise make. The output is the same:
//   column j < m:  rows 0..9 = table[:, gid[j]]  (mx, my, ca, cb, cc, op,
//                  r, g, b, depth), row 10 = 1, row 11 = float(gid[j]),
//                  rows 12..15 = 0;
//   column j >= m: all zero (the pad tail).
//
// Bound on the H100: bytes. Per column it writes 64 bytes and reads a
// 4-byte id plus ten scattered floats of a 40 MB table (1M gaussians) that
// mostly stays in the 50 MB L2. Design: one thread per column, a
// grid-stride loop, every row write coalesced across the warp; the table
// reads are the only scattered traffic and go through the read-only path.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void pack_soa_kernel(const float* __restrict__ table,
                                const int* __restrict__ gid,
                                float* __restrict__ out,
                                int64_t n, int64_t m, int64_t m_out) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < m_out;
       j += stride) {
    if (j < m) {
      const int g = __ldg(gid + j);
#pragma unroll
      for (int r = 0; r < 10; ++r) out[r * m_out + j] = __ldg(table + r * n + g);
      out[10 * m_out + j] = 1.0f;
      out[11 * m_out + j] = (float)g;
    } else {
#pragma unroll
      for (int r = 0; r < 12; ++r) out[r * m_out + j] = 0.0f;
    }
#pragma unroll
    for (int r = 12; r < 16; ++r) out[r * m_out + j] = 0.0f;
  }
}

}  // namespace

// table: (10, n) float32; gid: (m,) int32 in [0, n); out: (16, m_out).
extern "C" int gs_pack_soa(const void* table, const void* gid, void* out,
                           int64_t n, int64_t m, int64_t m_out,
                           void* stream) {
  const int threads = 256;
  int64_t blocks = (m_out + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;  // grid-stride beyond 32 blocks/SM
  if (blocks < 1) blocks = 1;
  pack_soa_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)table, (const int*)gid, (float*)out, n, m, m_out);
  return (int)cudaGetLastError();
}
