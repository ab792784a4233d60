// segsum: column sums of a segment-sorted (16, m) buffer per segment id.
//
// Replaces: gaussian_splatting_tpu/ops/segsum.py::_segsum_kernel (via
// segment_sum_sorted). Same contract: row 0 of the input holds each
// column's segment id as an exact float, ascending; id n_segments is the
// sentinel (zero payload) and is skipped. out (16, n_segments) must be
// zeroed by the caller; column g receives the sum of the input columns with
// id g (row 0: g times their count, which callers ignore). Segments with no
// column stay zero.
//
// The TPU kernel sweeps the buffer sequentially, window by window, and
// scatters with one-hot MXU products; here every thread owns one input
// column, and a thread whose column starts a run (its id differs from the
// previous column's) sums that run in column order and writes it once: no
// atomics, deterministic. Runs are short (a gaussian has at most one entry
// per tile it covers, max_tiles_per_gaussian per view).
//
// Bound on the H100: bytes: the 4-byte id of every input column, the 60
// payload bytes of every column below the sentinel (sentinel columns are
// skipped), 64 per output column written. Design: a grid-stride loop whose
// id reads are coalesced;
// a run's payload reads start at its own column, so neighbouring runs read
// neighbouring addresses.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void segsum_kernel(const float* __restrict__ in, int64_t m, int n,
                              float* __restrict__ out) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < m; i += stride) {
    const float kf = __ldg(in + i);
    if (!(kf < (float)n) || (i > 0 && __ldg(in + i - 1) == kf)) continue;
    const int g = (int)kf;
    float s[15];
#pragma unroll
    for (int r = 0; r < 15; ++r) s[r] = 0.f;
    int64_t j = i;
    do {
#pragma unroll
      for (int r = 0; r < 15; ++r) s[r] += __ldg(in + (int64_t)(r + 1) * m + j);
      ++j;
    } while (j < m && __ldg(in + j) == kf);
    out[g] = kf * (float)(j - i);
#pragma unroll
    for (int r = 0; r < 15; ++r) out[(int64_t)(r + 1) * n + g] = s[r];
  }
}

}  // namespace

// in: (16, m) float32, row 0 ascending ids in [0, n]; out: (16, n) float32,
// zeroed.
extern "C" int gs_segsum(const void* in, int64_t m, int n, void* out, void* stream) {
  const int threads = 256;
  int64_t blocks = (m + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  if (blocks < 1) blocks = 1;
  segsum_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)in, m, n, (float*)out);
  return (int)cudaGetLastError();
}
