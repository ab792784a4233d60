// bucket partition: the bucket binning's stable B-way partition of the slots
// by tile % B, fused with its input: it reads each slot's tile and writes, per
// output column, the int64 sort key and the gaussian id.
//
// Replaces: gaussian_splatting_tpu/ops/partition.py::_qpart_kernel at its one
// call site (gaussian_splatting_tpu/ops/tiling.py:810: key row 0, sentinel T,
// drop_key_above T, no n_valid, no shift), through bucket_partition. There a
// pack_rows pass gathers a (16, M') input (tile, depth, payload, gid) that the
// partition carries whole into a (16, B, cap) output. The port's batched sort
// needs only the key and the gid of each output column (pack_soa gathers the
// payload through the gid afterwards), so this kernel takes the (M,) slot
// tiles and the (N,) depths and writes just those: slot s holds gaussian
// gid(s) = slot_gid[s] on the compact layout (an (M,) array of each slot's
// gaussian) or s % N on the dense (max_t, N) one (slot_gid null), and is
// kept when s < M and tile[s] < T; slots in [M, M') (M' = M
// rounded up to 8192, the JAX width) are discarded like sentinels. Chunk g
// (C slots) owns the q output columns [g q, g q + q) of each bucket b = tile
// & (B - 1): its kept slots of bucket b go there in slot order (stable);
// a slot ranked q or later in its (chunk, bucket) is dropped and counted.
//   kept column:  key = (tile << 32) | order_bits(depth[gid(s)]), gid = gid(s)
//   pad column:   key = T << 32, gid = 0
// with order_bits the float total order of tiling._float_order_bits.
// counts[b] and drops[b] sum the kept and dropped slots of bucket b.
//
// Bound on the H100: bytes. It reads the 4-byte tile of every slot below M
// and the 4-byte depth (and on the compact layout the 4-byte slot_gid) of
// every kept one, and writes 12 bytes (key and gid) per output column: at 1M
// gaussians, dense, max_t 16, B 8, q 96 that is 64 MB + 7 MB + 288 MB, ~0.11
// ms at 3.35 TB/s; at B 2048, q 1 the window is 4C, 768 MB of output, ~0.25
// ms. Design: one warp a chunk, in a persistent grid; a lane holds the
// chunk's C / 32 slots of its column (one coalesced load each, the next
// chunk's loaded while this one is written). Kept slots are staged as
// (tile, gid) in shared memory at (bucket, rank); then the chunk's B x q
// window of keys and gids is written, pads and kept columns together,
// gathering the kept columns' depths (4 MB, L2-resident) as it goes. Counts
// and drops are summed per block in shared memory and added with integer
// atomics once a block, so the result is deterministic. A first design, one
// 512-thread block a chunk with a block-wide scan of the warp counts and
// four barriers a chunk, was slower on the H100 (PERF.md).
//
// B <= 32 (bucket_partition_kernel), no block-wide barrier: the rank of a
// kept slot in its (chunk, bucket) comes round by round from log2(B) + 1
// ballots (the lanes of the same bucket) and a running per-bucket count that
// lane b keeps for bucket b; each warp writes its own chunk's window as
// whole 16-byte evict-first stores (q % 4 == 0: B q is a multiple of 128).
//
// B > 32, up to the 2048 buckets of a window of 4C at C = 512
// (bucket_partition_wide_kernel): the running counts live in shared memory,
// B a warp; __match_any_sync gives the lanes of a slot's bucket, whose rank
// is that count plus the lanes below it, and the lowest of them advances
// the count. A bucket's window is q columns, 1 to 32, and B of them are far
// apart (a row of cap columns each), so a warp writing its own chunk would
// store one short run a row. Instead the block's eight warps rank eight
// consecutive chunks, and the block writes their windows together: bucket
// b's 8 q columns of those chunks are contiguous, so consecutive threads
// write consecutive columns of a row (64-byte key runs at q = 1). Three
// block barriers a group of eight chunks. The stages and counts are laid out
// (bucket, warp, rank) so that the write reads them in order. Shared memory:
// eight (B, q) stages of 8 B a column and 10 B counts: 208 KB at B q = 2048,
// B = 2048, within the 227 KB a block may opt into.

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

// kRounds = C / 32 slots a lane; B <= 32.
template <int kRounds>
__global__ void __launch_bounds__(kWarps * 32)
bucket_partition_kernel(const int* __restrict__ tile, const int* __restrict__ slot_gid,
                        int64_t m, int64_t n_chunks,
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
      if (keep && rank < q) {
        const int64_t s = g * C + 32 * k + lane;
        stage[bid * q + rank] = make_int2(t[k], slot_gid ? __ldg(slot_gid + s) : (int)(s % n));
      }
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

// kRounds = C / 32 slots a lane; B > 32.
template <int kRounds>
__global__ void __launch_bounds__(kWarps * 32)
bucket_partition_wide_kernel(const int* __restrict__ tile, const int* __restrict__ slot_gid,
                             int64_t m, int64_t n_chunks,
                             const float* __restrict__ depths, int n, int T, int B, int q,
                             int64_t cap, long long* __restrict__ key_out,
                             int* __restrict__ gid_out, int* __restrict__ counts,
                             int* __restrict__ drops) {
  extern __shared__ int smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int2* stage = reinterpret_cast<int2*>(smem);  // (B, kWarps, q) kept (tile, gid)
  int* cnt = smem + 2 * kWarps * B * q;          // (B, kWarps) slots of each chunk's bucket
  int* bsum = cnt + kWarps * B;                  // (2, B) block sums
  for (int i = threadIdx.x; i < 2 * B; i += blockDim.x) bsum[i] = 0;

  const int C = 32 * kRounds;
  const int64_t step = (int64_t)gridDim.x * kWarps;
  const unsigned lower = (1u << lane) - 1u;
  const long long pad_key = (long long)T << 32;

  int64_t g = (int64_t)blockIdx.x * kWarps + warp;  // this warp's chunk
  int t[kRounds];
#pragma unroll
  for (int k = 0; k < kRounds; ++k) {
    const int64_t s = g * C + 32 * k + lane;
    t[k] = g < n_chunks && s < m ? __ldcs(tile + s) : T;
  }
  for (int64_t g0 = g - warp; g0 < n_chunks; g0 += step, g += step) {
    __syncthreads();  // the previous group's window is written
    for (int i = threadIdx.x; i < kWarps * B; i += blockDim.x) cnt[i] = 0;
    __syncthreads();
    // Ranks, round by round in slot order: cnt[b][warp] counts the kept
    // slots of bucket b so far, dropped ones included. Slots past n_chunks
    // hold T and are not kept.
#pragma unroll
    for (int k = 0; k < kRounds; ++k) {
      const bool keep = t[k] < T;
      const int bid = t[k] & (B - 1);
      const unsigned same = __match_any_sync(kFull, keep ? bid : -1);
      int* c = cnt + bid * kWarps + warp;
      const int base = keep ? *c : 0;
      __syncwarp();
      if (keep) {
        const int rank = base + __popc(same & lower);
        if (rank < q) {
          const int64_t s = g * C + 32 * k + lane;
          stage[(bid * kWarps + warp) * q + rank] =
              make_int2(t[k], slot_gid ? __ldg(slot_gid + s) : (int)(s % n));
        }
        if (!(same & lower)) *c = base + __popc(same);
      }
      __syncwarp();
    }
    // The next group's tiles, in flight while this one is written.
#pragma unroll
    for (int k = 0; k < kRounds; ++k) {
      const int64_t s = (g + step) * C + 32 * k + lane;
      t[k] = g + step < n_chunks && s < m ? __ldcs(tile + s) : T;
    }
    __syncthreads();  // every warp's stage and counts are in

    // The group's window: bucket b's columns [g0 q, g0 q + w q) of its row,
    // w the group's chunks; element i = (b, chunk, j) in that order.
    const int w = (int)(n_chunks - g0 < kWarps ? n_chunks - g0 : kWarps);
    const int wq = w * q;
    for (int i = threadIdx.x; i < B * wq; i += blockDim.x) {
      const int b = i / wq;
      const int r = i - b * wq;  // chunk (r / q) of the group, column j of its window
      const int j = r - (r / q) * q;
      const int c = cnt[b * kWarps + r / q];
      const int kept = min(c, q);
      const int64_t col = b * cap + g0 * q + r;
      if (j < kept) {
        const int2 st = stage[b * kWarps * q + r];
        key_out[col] = kept_key(st, depths);
        gid_out[col] = st.y;
      } else {
        key_out[col] = pad_key;
        gid_out[col] = 0;
      }
      if (j == 0 && c) {
        atomicAdd(bsum + b, kept);
        if (c > kept) atomicAdd(bsum + B + b, c - kept);
      }
    }
  }
  __syncthreads();
  for (int b = threadIdx.x; b < B; b += blockDim.x) {
    if (bsum[b]) atomicAdd(counts + b, bsum[b]);
    if (bsum[B + b]) atomicAdd(drops + b, bsum[B + b]);
  }
}

// The persistent grid of kernel fn: as many blocks as fit on the card at
// smem bytes each, and no more than the chunks need (one warp a chunk).
template <typename Kernel>
cudaError_t grid_for(Kernel fn, size_t smem, int64_t n_chunks, unsigned* blocks) {
  cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kWarps * 32, smem)) !=
      cudaSuccess)
    return err;
  const int64_t b = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  const int64_t needed = (n_chunks + kWarps - 1) / kWarps;
  *blocks = (unsigned)(b < needed ? b : needed);
  return cudaSuccess;
}

template <int kRounds>
int launch(const int* tile, const int* slot_gid, int64_t m, int64_t n_chunks,
           const float* depths, int n, int T,
           int B, int q, long long* key, int* gid, int* counts, int* drops, cudaStream_t st) {
  const size_t smem = ((size_t)2 * kWarps * B * q + (size_t)(kWarps + 2) * B) * sizeof(int);
  unsigned blocks = 0;
  cudaError_t err;
  if (B <= 32) {
    int log2B = 0;
    while ((1 << log2B) < B) ++log2B;
    auto* fn = bucket_partition_kernel<kRounds>;
    if ((err = grid_for(fn, smem, n_chunks, &blocks)) != cudaSuccess) return (int)err;
    fn<<<blocks, kWarps * 32, smem, st>>>(tile, slot_gid, m, n_chunks, depths, n, T, B, log2B,
                                          q, n_chunks * q, key, gid, counts, drops);
  } else {
    auto* fn = bucket_partition_wide_kernel<kRounds>;
    if ((err = grid_for(fn, smem, n_chunks, &blocks)) != cudaSuccess) return (int)err;
    fn<<<blocks, kWarps * 32, smem, st>>>(tile, slot_gid, m, n_chunks, depths, n, T, B, q,
                                          n_chunks * q, key, gid, counts, drops);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// tile: (m,) int32 slot tiles, T on a sentinel slot; slot_gid: (m,) int32
// gaussian of each slot, or null for gaussian s % n; depths: (n,) float32;
// m_pad >= m a multiple of chunk, the slots in [m, m_pad) discarded; key:
// (n_buckets, cap) int64 and gid: (n_buckets, cap) int32 with cap =
// (m_pad / chunk) * q, 16-byte aligned; counts_drops: (2, n_buckets) int32,
// the counts then the drops, zeroed here. chunk in {32, 64, ..., 1024};
// n_buckets a power of two >= 2, n_buckets * q a multiple of 128 whose
// stages fit in shared memory (ops/partition.py checks both).
extern "C" int gs_bucket_partition(const void* tile, const void* slot_gid, int64_t m,
                                   int64_t m_pad,
                                   const void* depths, int n, int T, int n_buckets, int q,
                                   int chunk, void* key, void* gid, void* counts_drops,
                                   void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(counts_drops, 0, 2 * n_buckets * sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  const int64_t n_chunks = m_pad / chunk;
  if (n_chunks == 0) return (int)cudaGetLastError();
  const int* t = (const int*)tile;
  const int* sg = (const int*)slot_gid;
  const float* d = (const float*)depths;
  long long* k = (long long*)key;
  int* g = (int*)gid;
  int* c = (int*)counts_drops;
  int* dr = c + n_buckets;
  switch (chunk) {
    case 32: return launch<1>(t, sg, m, n_chunks, d, n, T, n_buckets, q, k, g, c, dr, st);
    case 64: return launch<2>(t, sg, m, n_chunks, d, n, T, n_buckets, q, k, g, c, dr, st);
    case 128: return launch<4>(t, sg, m, n_chunks, d, n, T, n_buckets, q, k, g, c, dr, st);
    case 256: return launch<8>(t, sg, m, n_chunks, d, n, T, n_buckets, q, k, g, c, dr, st);
    case 512: return launch<16>(t, sg, m, n_chunks, d, n, T, n_buckets, q, k, g, c, dr, st);
    case 1024: return launch<32>(t, sg, m, n_chunks, d, n, T, n_buckets, q, k, g, c, dr, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
