// pack_rows: builds the segsum-ready (16, m_out) buffer of one slice of the
// backward kernel's gradient stream, in gaussian-id order.
//
// Replaces: gaussian_splatting_tpu/ops/tiling.py::_pack_rows_kernel (via
// pack_rows). The TPU kernel packs R rows that a payload sort already
// permuted. Here only the masked id key is sorted (one stable torch.sort),
// and the kernel gathers the payload rows of the unsorted stream through
// that sort's permutation, sparing R - 1 payload permutations. Output, the
// JAX pack_rows of the permuted rows bit for bit:
//   column j < m:  row 0 = key_sorted[j] (exact float), rows 1..R-1 =
//                  src[r, col0 + perm[j]] if col0 + perm[j] < n_valid
//                  (an entry the backward wrote), else 0;
//   column j >= m: row 0 = sentinel, rows 1..R-1 = 0;
//   rows R..15 = 0.
//
// Bound on the H100: bytes. Per column it reads a 4-byte key and writes 64
// bytes; per entry the backward wrote (the columns below the sentinel), an
// 8-byte index and R - 1 scattered 4-byte payloads. Design:
// one thread per column, a grid-stride loop, every row write coalesced
// across the warp; the payload gathers are the only scattered traffic and
// go through the read-only path.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void pack_rows_kernel(const float* __restrict__ src, int64_t src_cols,
                                 const int64_t* __restrict__ perm,
                                 const int* __restrict__ key_sorted,
                                 const int* __restrict__ n_valid, int64_t col0,
                                 int64_t m, int64_t m_out, int n_rows, float sentinel,
                                 float* __restrict__ out) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t valid = (int64_t)__ldg(n_valid);
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < m_out;
       j += stride) {
    if (j < m) {
      out[j] = (float)__ldg(key_sorted + j);
      const int64_t c = col0 + __ldg(perm + j);
      const bool ok = c < valid;
      for (int r = 1; r < n_rows; ++r)
        out[r * m_out + j] = ok ? __ldg(src + r * src_cols + c) : 0.f;
    } else {
      out[j] = sentinel;
      for (int r = 1; r < n_rows; ++r) out[r * m_out + j] = 0.f;
    }
    for (int r = n_rows; r < 16; ++r) out[r * m_out + j] = 0.f;
  }
}

}  // namespace

// src: (16, src_cols) float32; perm: (m,) int64, indices into the slice
// [col0, col0 + m) of src; key_sorted: (m,) int32; n_valid: (1,) int32 on
// the device; out: (16, m_out) float32, m_out >= m; 1 <= n_rows <= 16.
extern "C" int gs_pack_rows(const void* src, int64_t src_cols, const void* perm,
                            const void* key_sorted, const void* n_valid, int64_t col0,
                            int64_t m, int64_t m_out, int n_rows, float sentinel,
                            void* out, void* stream) {
  const int threads = 256;
  int64_t blocks = (m_out + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;  // grid-stride beyond 32 blocks/SM
  if (blocks < 1) blocks = 1;
  pack_rows_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)src, src_cols, (const int64_t*)perm, (const int*)key_sorted,
      (const int*)n_valid, col0, m, m_out, n_rows, sentinel, (float*)out);
  return (int)cudaGetLastError();
}
