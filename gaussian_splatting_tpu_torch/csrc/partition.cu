// bucket partition: the bucket binning's stable B-way partition of the dense
// slots by tile % B, fused with its input: it reads each slot's tile and
// writes, per output column, the int64 sort key and the gaussian id.
//
// Replaces: gaussian_splatting_tpu/ops/partition.py::_qpart_kernel at its one
// call site (gaussian_splatting_tpu/ops/tiling.py:810: key row 0, sentinel T,
// drop_key_above T, no n_valid, no shift), through bucket_partition. There a
// pack_rows pass gathers a (16, M') input (tile, depth, payload, gid) that the
// partition carries whole into a (16, B, cap) output. The port's batched sort
// needs only the key and the gid of each output column (pack_soa gathers the
// payload through the gid afterwards), so this kernel takes the (M,) slot
// tiles and the (N,) depths and writes just those: slot s holds gaussian
// s % N and is kept when s < M and tile[s] < T; slots in [M, M') (M' = M
// rounded up to 8192, the JAX width) are discarded like sentinels. Chunk g
// (C slots) owns the q output columns [g q, g q + q) of each bucket b = tile
// & (B - 1): its kept slots of bucket b go there in slot order (stable);
// a slot ranked q or later in its (chunk, bucket) is dropped and counted.
//   kept column:  key = (tile << 32) | order_bits(depth[s % N]), gid = s % N
//   pad column:   key = T << 32, gid = 0
// with order_bits the float total order of tiling._float_order_bits.
// counts[b] and drops[b] sum the kept and dropped slots of bucket b.
//
// Bound on the H100: bytes. It reads the 4-byte tile of every slot below M
// and the 4-byte depth of every kept one, and writes 12 bytes (key and gid)
// per output column: at 1M gaussians, max_t 16, B 8, q 96 that is 64 MB +
// 7 MB + 288 MB, ~0.11 ms at 3.35 TB/s. Design: one warp a chunk, in a
// persistent grid, so no block-wide barrier: a lane holds the chunk's C / 32
// slots of its column (one coalesced load each, the next chunk's loaded
// while this one is written). The rank of a kept slot in its (chunk, bucket)
// comes round by round from log2(B) + 1 ballots (the lanes of the same
// bucket) and a running per-bucket count that lane b keeps for bucket b
// (B <= 32). Kept slots are staged as (tile, gid) in the warp's shared
// memory at (bucket, rank); then the warp writes the chunk's B x q window
// of keys and gids, pads and kept columns together, as whole 16-byte
// evict-first stores (q % 4 == 0: B <= 32 and B q a multiple of 128), gathering
// the kept columns' depths (4 MB, L2-resident) as it goes. Counts and
// drops are summed per block in shared memory and added with integer
// atomics once a block, so the result is deterministic. A first design, one
// 512-thread block a chunk with a block-wide scan of the warp counts and
// four barriers a chunk, was slower on the H100 (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;  // warps a block

// Float total order (-0 < +0) as an unsigned 32-bit key.
__device__ __forceinline__ long long order_bits(float x) {
  const unsigned b = __float_as_uint(x);
  return (long long)((b & 0x80000000u) ? ~b : (b | 0x80000000u));
}

__device__ __forceinline__ long long kept_key(int2 st, const float* __restrict__ depths) {
  return ((long long)st.x << 32) | order_bits(__ldg(depths + st.y));
}

// kRounds = C / 32 slots a lane.
template <int kRounds>
__global__ void __launch_bounds__(kWarps * 32)
bucket_partition_kernel(const int* __restrict__ tile, int64_t m, int64_t n_chunks,
                        const float* __restrict__ depths, int n, int T, int B, int log2B,
                        int q, int64_t cap, long long* __restrict__ key_out,
                        int* __restrict__ gid_out, int* __restrict__ counts,
                        int* __restrict__ drops) {
  extern __shared__ int smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int Bq = B * q;
  int2* stage = reinterpret_cast<int2*>(smem) + (int64_t)warp * Bq;  // (B, q) kept (tile, gid)
  int* kept_n = smem + 2 * kWarps * Bq + warp * B;                    // (B,) this chunk's kept
  int* bsum = smem + 2 * kWarps * Bq + kWarps * B;                    // (2, B) block sums
  for (int i = threadIdx.x; i < 2 * B; i += blockDim.x) bsum[i] = 0;
  __syncthreads();

  const int C = 32 * kRounds;
  const int64_t warps = (int64_t)gridDim.x * kWarps;
  const unsigned lower = (1u << lane) - 1u;
  const long long pad_key = (long long)T << 32;
  int kept_acc = 0, drop_acc = 0;  // lane b < B: bucket b over this warp's chunks

  int64_t g = (int64_t)blockIdx.x * kWarps + warp;
  int t[kRounds];
#pragma unroll
  for (int k = 0; k < kRounds; ++k) {
    const int64_t s = g * C + 32 * k + lane;
    t[k] = g < n_chunks && s < m ? __ldcs(tile + s) : T;
  }
  for (; g < n_chunks; g += warps) {
    // Ranks, round by round in slot order. Lane b's `cnt` counts the kept
    // slots of bucket b so far, dropped ones included.
    int cnt = 0;
#pragma unroll
    for (int k = 0; k < kRounds; ++k) {
      const bool keep = t[k] < T;
      const int bid = t[k] & (B - 1);
      unsigned same = __ballot_sync(kFull, keep);  // kept lanes of this lane's bucket
      unsigned mine = same;                        // kept lanes of bucket `lane`
      for (int i = 0; i < log2B; ++i) {
        const unsigned bits = __ballot_sync(kFull, (bid >> i) & 1);
        same &= ((bid >> i) & 1) ? bits : ~bits;
        mine &= ((lane >> i) & 1) ? bits : ~bits;
      }
      const int rank = __shfl_sync(kFull, cnt, bid) + __popc(same & lower);
      if (keep && rank < q)
        stage[bid * q + rank] = make_int2(t[k], (int)((g * C + 32 * k + lane) % n));
      cnt += __popc(mine);
    }
    if (lane < B) {
      const int kept = min(cnt, q);
      kept_n[lane] = kept;
      kept_acc += kept;
      drop_acc += cnt - kept;
    }
    // The next chunk's tiles, in flight while this one is written.
    const int64_t gn = g + warps;
#pragma unroll
    for (int k = 0; k < kRounds; ++k) {
      const int64_t s = gn * C + 32 * k + lane;
      t[k] = gn < n_chunks && s < m ? __ldcs(tile + s) : T;
    }
    __syncwarp();

    // The chunk's window of every bucket: kept columns, then pads.
    const int64_t col0 = g * q;
    const int qk = q / 2;  // two keys a 16-byte store
#pragma unroll 4
    for (int i = lane; i < B * qk; i += 32) {
      const int b = i / qk;
      const int j = 2 * (i - b * qk);
      const int kept = kept_n[b];
      longlong2 v;
      v.x = j < kept ? kept_key(stage[b * q + j], depths) : pad_key;
      v.y = j + 1 < kept ? kept_key(stage[b * q + j + 1], depths) : pad_key;
      __stcs(reinterpret_cast<longlong2*>(key_out + b * cap + col0 + j), v);
    }
    const int qg = q / 4;  // four gids a 16-byte store
#pragma unroll 2
    for (int i = lane; i < B * qg; i += 32) {
      const int b = i / qg;
      const int j = 4 * (i - b * qg);
      const int kept = kept_n[b];
      const int2* st = stage + b * q + j;
      int4 v;
      v.x = j < kept ? st[0].y : 0;
      v.y = j + 1 < kept ? st[1].y : 0;
      v.z = j + 2 < kept ? st[2].y : 0;
      v.w = j + 3 < kept ? st[3].y : 0;
      __stcs(reinterpret_cast<int4*>(gid_out + b * cap + col0 + j), v);
    }
    __syncwarp();
  }
  if (lane < B) {
    atomicAdd(bsum + lane, kept_acc);
    atomicAdd(bsum + B + lane, drop_acc);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < B; b += blockDim.x) {
    if (bsum[b]) atomicAdd(counts + b, bsum[b]);
    if (bsum[B + b]) atomicAdd(drops + b, bsum[B + b]);
  }
}

template <int kRounds>
int launch(const int* tile, int64_t m, int64_t n_chunks, const float* depths, int n, int T,
           int B, int q, long long* key, int* gid, int* counts, int* drops, cudaStream_t st) {
  int log2B = 0;
  while ((1 << log2B) < B) ++log2B;
  const size_t smem = ((size_t)2 * kWarps * B * q + (size_t)(kWarps + 2) * B) * sizeof(int);
  auto* fn = bucket_partition_kernel<kRounds>;
  cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kWarps * 32, smem)) !=
      cudaSuccess)
    return (int)err;
  int64_t blocks = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  const int64_t needed = (n_chunks + kWarps - 1) / kWarps;
  if (blocks > needed) blocks = needed;
  fn<<<(unsigned)blocks, kWarps * 32, smem, st>>>(tile, m, n_chunks, depths, n, T, B, log2B, q,
                                                  n_chunks * q, key, gid, counts, drops);
  return (int)cudaGetLastError();
}

}  // namespace

// tile: (m,) int32 slot tiles, T on a sentinel slot; depths: (n,) float32;
// m_pad >= m a multiple of chunk, the slots in [m, m_pad) discarded; key:
// (n_buckets, cap) int64 and gid: (n_buckets, cap) int32 with cap =
// (m_pad / chunk) * q, 16-byte aligned; counts_drops: (2, n_buckets) int32,
// the counts then the drops, zeroed here. chunk in {32, 64, ..., 1024};
// n_buckets a power of two, at most 32; q a multiple of 4.
extern "C" int gs_bucket_partition(const void* tile, int64_t m, int64_t m_pad,
                                   const void* depths, int n, int T, int n_buckets, int q,
                                   int chunk, void* key, void* gid, void* counts_drops,
                                   void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(counts_drops, 0, 2 * n_buckets * sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  const int64_t n_chunks = m_pad / chunk;
  if (n_chunks == 0) return (int)cudaGetLastError();
  const int* t = (const int*)tile;
  const float* d = (const float*)depths;
  long long* k = (long long*)key;
  int* g = (int*)gid;
  int* c = (int*)counts_drops;
  int* dr = c + n_buckets;
  switch (chunk) {
    case 32: return launch<1>(t, m, n_chunks, d, n, T, n_buckets, q, k, g, c, dr, st);
    case 64: return launch<2>(t, m, n_chunks, d, n, T, n_buckets, q, k, g, c, dr, st);
    case 128: return launch<4>(t, m, n_chunks, d, n, T, n_buckets, q, k, g, c, dr, st);
    case 256: return launch<8>(t, m, n_chunks, d, n, T, n_buckets, q, k, g, c, dr, st);
    case 512: return launch<16>(t, m, n_chunks, d, n, T, n_buckets, q, k, g, c, dr, st);
    case 1024: return launch<32>(t, m, n_chunks, d, n, T, n_buckets, q, k, g, c, dr, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
