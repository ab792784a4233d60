// pack_soa: builds the rasterizer's (16, m_out) float32 SoA from the
// per-gaussian records and the depth-sorted slot -> gaussian index.
//
// Replaces: gaussian_splatting_tpu/ops/tiling.py::_pack_kernel (via
// pack_soa). The TPU kernel stacks 11 already-permuted rows; here the
// kernel gathers from the (n, 10) per-gaussian record table through the
// sorted gaussian id instead, which spares the ten M-long payload
// permutations the sort would otherwise make. The output, with live =
// min(n_live, m) (m without n_live):
//   column j < live:  rows 0..9 = records[gid[j]] (mx, my, ca, cb, cc, op,
//                     r, g, b, depth), row 10 = 1, row 11 = float(gid[j]),
//                     rows 12..15 = 0;
//   column j >= live: all zero (the pad tail past m, and the columns the
//                     dense binning's sentinel slots fill, which no kernel
//                     reads).
//
// Bound on the H100: bytes, and of those the output: 64 B a column, 1.02 GB
// at 16M columns, 0.31 ms at 3.35 TB/s, against 40 MB of records and 4 B a
// live id. A 4-byte gather costs a whole 32-byte sector, so gathering each
// quantity from its own row of a (10, n) table cost ten sectors a column:
// 160M sector reads for the dense binning's 16M columns, of which 11.5 % lie
// in a tile's segment. Design: the dense binning passes its segment end
// tile_starts[T] as n_live, so a column past it loads nothing and is stored
// as zeros; a gaussian's ten quantities are one 40-byte record, five 8-byte
// loads inside two sectors; each thread owns 4 consecutive columns and
// writes them to every row as one 16-byte evict-first store (st.global.cs),
// so the output streams past the 50 MB L2 that keeps the 40 MB of records.
// Measured by chip_smoke.py (NVIDIA H100 80GB HBM3, 700 W; PERF.md) at
// training view 0: 0.39 ms with n_live, 0.51 ms gathering all 16M columns,
// 0.33 ms for writing the output's zeros alone; one thread a column
// gathering from (10, n) with 4-byte stores took 0.91 ms.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void pack_soa_kernel(const float* __restrict__ records,
                                const int* __restrict__ gid,
                                const int* __restrict__ n_live, int64_t m,
                                int64_t m_out, float* __restrict__ out) {
  const int64_t j0 = 4 * ((int64_t)blockIdx.x * blockDim.x + threadIdx.x);
  if (j0 >= m_out) return;
  const int64_t live = n_live != nullptr ? min(m, (int64_t)__ldg(n_live)) : m;
  float v[12][4];
#pragma unroll
  for (int r = 0; r < 12; ++r)
#pragma unroll
    for (int k = 0; k < 4; ++k) v[r][k] = 0.f;
  if (j0 < live) {
    int g[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) g[k] = j0 + k < live ? __ldg(gid + j0 + k) : -1;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (g[k] < 0) continue;
      const float2* rec = reinterpret_cast<const float2*>(records + 10 * (int64_t)g[k]);
#pragma unroll
      for (int i = 0; i < 5; ++i) {
        const float2 t = __ldg(rec + i);
        v[2 * i][k] = t.x;
        v[2 * i + 1][k] = t.y;
      }
      v[10][k] = 1.0f;
      v[11][k] = (float)g[k];
    }
  }
#pragma unroll
  for (int r = 0; r < 12; ++r)
    __stcs(reinterpret_cast<float4*>(out + r * m_out + j0),
           make_float4(v[r][0], v[r][1], v[r][2], v[r][3]));
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int r = 12; r < 16; ++r) __stcs(reinterpret_cast<float4*>(out + r * m_out + j0), zero);
}

}  // namespace

// records: (n, 10) float32, 8-byte aligned; gid: (m,) int32 in [0, n);
// n_live: (1,) int32 on the device or null; out: (16, m_out) float32,
// 16-byte aligned, m_out a multiple of 4 and >= m.
extern "C" int gs_pack_soa(const void* records, const void* gid, const void* n_live,
                           void* out, int64_t m, int64_t m_out, void* stream) {
  const int threads = 256;
  const int64_t blocks = (m_out / 4 + threads - 1) / threads;
  if (blocks < 1) return 0;
  pack_soa_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)records, (const int*)gid, (const int*)n_live, m, m_out, (float*)out);
  return (int)cudaGetLastError();
}
