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
// Bound on the H100: bytes. Per column it reads a 4-byte key and an 8-byte
// index and writes 64 bytes (0.51 GB at the 8M-column stream of a 1080p
// view); per entry the backward wrote, R - 1 payloads gathered at random
// from R - 1 rows. A 4-byte gather costs a whole 32-byte sector, so the
// gathers hit the L2 only while the written part of the gathered rows stays
// there: at 1.84M entries and 9 rows that is 66 MB against the 50 MB L2,
// which the output stores also pass through, and the gathers went to HBM.
// Design: each thread owns 4 consecutive columns and writes them to a row
// as one 16-byte evict-first store (st.global.cs); the payload rows are
// gathered 3 at a time, one pass of the sorted columns each (22 MB at that
// shape; passes of 4 and 5 rows, 29 and 37 MB, were slower, as though the
// L2 kept about half its size for lines that every SM reads), with an L2
// evict_last hint on the gathers; the blocks of one pass come before those
// of the next in the grid, and each pass reads the permutation again (64
// MB). Measured
// by chip_smoke.py (NVIDIA H100 80GB HBM3, 700 W; PERF.md), 10 rows at
// training view 0: 0.41 ms, 0.17 ms for writing the output's zeros alone;
// one thread a column gathering all 9 rows in one pass with 4-byte stores
// took 0.67 ms. Of 1, 2, 3, 4, 5 and all 9 rows a pass, 3 was fastest.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowsPerPass = 3;

__device__ __forceinline__ unsigned long long evict_last_policy() {
  unsigned long long p;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(p));
  return p;
}

__device__ __forceinline__ float load_evict_last(const float* a, unsigned long long policy) {
  float v;
  asm("ld.global.nc.L2::cache_hint.f32 %0, [%1], %2;" : "=f"(v) : "l"(a), "l"(policy));
  return v;
}

// Pass p = blockIdx.x / blocks_per_pass writes payload rows [1 + 3p,
// 4 + 3p) of n_rows; pass 0 also writes row 0, the last pass rows
// n_rows..15.
__global__ void pack_rows_kernel(const float* __restrict__ src, int64_t src_cols,
                                 const int64_t* __restrict__ perm,
                                 const int* __restrict__ key_sorted,
                                 const int* __restrict__ n_valid, int64_t col0,
                                 int64_t m, int64_t m_out, int n_rows, int blocks_per_pass,
                                 float sentinel, float* __restrict__ out) {
  const int pass = blockIdx.x / blocks_per_pass;
  const int64_t j0 =
      4 * ((int64_t)(blockIdx.x % blocks_per_pass) * blockDim.x + threadIdx.x);
  if (j0 >= m_out) return;
  const int r_lo = 1 + pass * kRowsPerPass;
  const int r_hi = min(r_lo + kRowsPerPass, n_rows);
  float v[kRowsPerPass][4];
#pragma unroll
  for (int i = 0; i < kRowsPerPass; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) v[i][k] = 0.f;
  if (r_lo < r_hi) {
    const int64_t valid = (int64_t)__ldg(n_valid);
    const unsigned long long policy = evict_last_policy();
    int64_t c[4];
    bool ok[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int64_t j = j0 + k;
      c[k] = j < m ? col0 + __ldg(perm + j) : 0;
      ok[k] = j < m && c[k] < valid;
    }
#pragma unroll
    for (int i = 0; i < kRowsPerPass; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (r_lo + i < r_hi && ok[k])
          v[i][k] = load_evict_last(src + (r_lo + i) * src_cols + c[k], policy);
  }
  if (pass == 0) {
    float4 key;
    key.x = j0 + 0 < m ? (float)__ldg(key_sorted + j0 + 0) : sentinel;
    key.y = j0 + 1 < m ? (float)__ldg(key_sorted + j0 + 1) : sentinel;
    key.z = j0 + 2 < m ? (float)__ldg(key_sorted + j0 + 2) : sentinel;
    key.w = j0 + 3 < m ? (float)__ldg(key_sorted + j0 + 3) : sentinel;
    __stcs(reinterpret_cast<float4*>(out + j0), key);
  }
#pragma unroll
  for (int i = 0; i < kRowsPerPass; ++i)
    if (r_lo + i < r_hi)
      __stcs(reinterpret_cast<float4*>(out + (r_lo + i) * m_out + j0),
             make_float4(v[i][0], v[i][1], v[i][2], v[i][3]));
  if (r_hi >= n_rows) {
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r = n_rows; r < 16; ++r)
      __stcs(reinterpret_cast<float4*>(out + r * m_out + j0), zero);
  }
}

}  // namespace

// src: (16, src_cols) float32; perm: (m,) int64, indices into the slice
// [col0, col0 + m) of src; key_sorted: (m,) int32; n_valid: (1,) int32 on
// the device; out: (16, m_out) float32, 16-byte aligned, m_out >= m a
// multiple of 4; 1 <= n_rows <= 16.
extern "C" int gs_pack_rows(const void* src, int64_t src_cols, const void* perm,
                            const void* key_sorted, const void* n_valid, int64_t col0,
                            int64_t m, int64_t m_out, int n_rows, float sentinel,
                            void* out, void* stream) {
  const int threads = 256;
  const int64_t blocks_per_pass = (m_out / 4 + threads - 1) / threads;
  const int passes = n_rows <= 1 ? 1 : (n_rows - 1 + kRowsPerPass - 1) / kRowsPerPass;
  if (blocks_per_pass < 1) return 0;
  pack_rows_kernel<<<(unsigned)(blocks_per_pass * passes), threads, 0,
                     (cudaStream_t)stream>>>(
      (const float*)src, src_cols, (const int64_t*)perm, (const int*)key_sorted,
      (const int*)n_valid, col0, m, m_out, n_rows, (int)blocks_per_pass, sentinel,
      (float*)out);
  return (int)cudaGetLastError();
}
