// partition: stable B-way bucket partition of a (16, M) column SoA into the
// (16, B, cap) layout of ops/partition.py.
//
// Replaces: gaussian_splatting_tpu/ops/partition.py::_qpart_kernel (via
// partition_soa). Same contract: column j's bucket is
// (int(x[key_row, j]) >> bucket_shift) & (B - 1); a column is kept when
// j < n_valid and (without a threshold, or) x[key_row, j] < drop_key_above,
// and discarded otherwise (no bucket, no count). Every C-column input chunk
// g owns the q output columns [g q, g q + q) of each bucket: its kept
// columns of bucket b go there in input order (stable), rows 0..14 copied
// and row 15 = 1; a column ranked q or later in its chunk and bucket is
// dropped and counted; the rest of the window is pad: the bucket's sentinel
// on the key row, zeros on rows 0..14 otherwise, row 15 = 0. counts[b] and
// drops[b] sum the kept and dropped columns of bucket b.
//
// The TPU kernel's two one-hot MXU matmuls (ranks from a lower-triangular
// matmul, the scatter from a permutation matmul) and its (16, n_chunks,
// B, q) -> (16, B, cap) transpose are TPU artefacts. Here one block takes
// one chunk, one thread per column: ranks within the warp from
// __match_any_sync on the bucket id and a popcount of the lower lanes,
// across the block's warps from a per-bucket exclusive scan of the warp
// counts in shared memory; kept columns are written straight into the
// (16, B, cap) layout and the pads by a block-stride loop over the B q
// window. The counts are integer atomics, so the result is deterministic.
//
// Bound on the H100: bytes. Per input column it reads the 4-byte key; per
// kept column 56 bytes of payload (the 14 rows of 0..14 other than the key
// row: the key is already read, and row 15 is computed, not read); per
// output column it writes 64 bytes. Payload rows are read only for kept
// columns (on the binning path most slots are sentinels that
// drop_key_above discards), and the output, q B / C times the input's
// width, dominates.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void partition_kernel(const float* __restrict__ x, int64_t m,
                                 const int* __restrict__ n_valid,
                                 const float* __restrict__ sentinels, int n_buckets, int q,
                                 int key_row, int bucket_shift, int has_drop,
                                 float drop_key_above, float* __restrict__ out,
                                 int64_t cap, int* __restrict__ counts,
                                 int* __restrict__ drops) {
  extern __shared__ int sm[];  // warp counts sm[w * B + b], then bucket totals
  const int B = n_buckets;
  const int C = blockDim.x;
  const int n_warps = C / 32;
  int* total = sm + n_warps * B;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t g = blockIdx.x;
  const int64_t col = g * C + tid;
  const int64_t out_rows = (int64_t)B * cap;  // stride of one output row

  for (int i = tid; i < n_warps * B; i += C) sm[i] = 0;

  const float key = x[(int64_t)key_row * m + col];
  const int bid = (int)((unsigned)(int)key >> bucket_shift) & (B - 1);
  const bool keep = col < (int64_t)*n_valid && (!has_drop || key < drop_key_above);
  __syncthreads();

  // Rank among the warp's kept columns of the same bucket; discarded lanes
  // all share the tag -1, which no kept lane has.
  const unsigned peers = __match_any_sync(0xffffffffu, keep ? bid : -1);
  const unsigned lower = peers & ((1u << lane) - 1u);
  if (keep && lower == 0) sm[warp * B + bid] = __popc(peers);
  __syncthreads();

  // Exclusive scan of each bucket's warp counts, in warp order.
  for (int b = tid; b < B; b += C) {
    int run = 0;
    for (int w = 0; w < n_warps; ++w) {
      const int c = sm[w * B + b];
      sm[w * B + b] = run;
      run += c;
    }
    total[b] = run;
  }
  __syncthreads();

  if (keep) {
    const int rank = sm[warp * B + bid] + __popc(lower);
    if (rank < q) {
      const int64_t dst = (int64_t)bid * cap + g * q + rank;
#pragma unroll
      for (int r = 0; r < 15; ++r)
        out[r * out_rows + dst] = r == key_row ? key : x[r * m + col];
      out[15 * out_rows + dst] = 1.0f;
    }
  }
  for (int i = tid; i < B * q; i += C) {
    const int b = i / q;
    const int j = i - b * q;
    if (j < min(total[b], q)) continue;
    const int64_t dst = (int64_t)b * cap + g * q + j;
#pragma unroll
    for (int r = 0; r < 16; ++r) out[r * out_rows + dst] = r == key_row ? sentinels[b] : 0.f;
  }
  for (int b = tid; b < B; b += C) {
    const int kept = min(total[b], q);
    if (kept) atomicAdd(counts + b, kept);
    if (total[b] > kept) atomicAdd(drops + b, total[b] - kept);
  }
}

}  // namespace

// x: (16, m) float32, m = n_chunks * chunk; n_valid: (1,) int32 on the
// device; sentinels: (n_buckets,) float32; out: (16, n_buckets, cap) float32
// with cap = n_chunks * q; counts, drops: (n_buckets,) int32, zeroed here.
// chunk is the block size: a multiple of 32, at most 1024.
extern "C" int gs_partition(const void* x, int64_t m, const void* n_valid,
                            const void* sentinels, int n_buckets, int q, int chunk,
                            int key_row, int bucket_shift, int has_drop,
                            float drop_key_above, void* out, void* counts, void* drops,
                            void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(counts, 0, n_buckets * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  if ((err = cudaMemsetAsync(drops, 0, n_buckets * sizeof(int), s)) != cudaSuccess)
    return (int)err;
  const int64_t n_chunks = m / chunk;
  if (n_chunks == 0) return (int)cudaGetLastError();
  const size_t smem = (size_t)(chunk / 32 + 1) * n_buckets * sizeof(int);
  if ((err = cudaFuncSetAttribute(partition_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess)
    return (int)err;
  partition_kernel<<<(unsigned)n_chunks, chunk, smem, s>>>(
      (const float*)x, m, (const int*)n_valid, (const float*)sentinels, n_buckets, q,
      key_row, bucket_shift, has_drop, drop_key_above, (float*)out, n_chunks * q,
      (int*)counts, (int*)drops);
  return (int)cudaGetLastError();
}
