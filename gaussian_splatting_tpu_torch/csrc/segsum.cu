// segsum: column sums of a segment-sorted (16, m) buffer per segment id.
//
// Replaces: gaussian_splatting_tpu/ops/segsum.py::_segsum_kernel (via
// segment_sum_sorted). Same contract: row 0 of the input holds each
// column's segment id as an exact float, ascending; id n is the sentinel
// (zero payload) and is skipped. Column g of the (16, n) output is the sum
// of the input columns with id g (row 0: g times their count, which callers
// ignore), zero for an id with no column. Rows 1..n_rows-1 are read; rows
// n_rows..15 are written as zero and not read (the caller promises that
// those input rows are zero). The kernel writes every output column exactly
// once, the zero columns too, so the output needs no zeroing first.
//
// The TPU kernel sweeps the buffer sequentially, window by window, and
// scatters with one-hot MXU products. Here each warp takes spans of 128
// consecutive columns, 4 a lane, read as 16-byte loads (every id and payload
// load coalesced, all issued at once), and reduces each row with a segmented
// scan across the warp (5 shuffle steps, head flags at the id changes): the
// lane holding a run's last column in the span has the run's sums. A run
// that continues past the span is finished by the warp in which it starts,
// from the 32 columns after the span that the warp loads with its own (a
// warp sum of the run's prefix of them; lane 31 walks on past those only for
// a run longer than 32 columns), and a run that started before the span is
// skipped. A warp writes the output ids from past the id of the column
// before its span to the last real id in it, runs and the ids between them:
// the sums are staged over zeros in the warp's shared memory and written
// row by row in consecutive ids (a window of 256 ids at a time, 128 for
// more than 11 rows). Ids ascend, so a warp stops at its first span that
// starts with the sentinel; then every warp of the grid takes a share of the
// ids before the buffer's first run and after its last, the first sentinel
// column found by a 32-way search of row 0 (the whole output when the
// buffer holds no entry, as a slice past n_written). No float atomics: each
// output column is written once, by one lane, in a fixed order.
//
// Bound on the H100: bytes. Per column below the first sentinel the 4-byte
// id and the 4 (n_rows - 1) payload bytes; 64 bytes per output column. At
// training view 0 (1.84M entries, n_rows 10, 1M gaussians) that is 74 MB +
// 64 MB, ~0.04 ms at 3.35 TB/s. There 28 % of the gaussians have no entry:
// writing each run's sums straight from its lane, and the gaps' zeros the
// same way, took about twice as long as staging (design probe, NVIDIA H100
// 80GB HBM3, 700 W; PERF.md), and capping the registers for more warps
// spilled and was slower.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSpan = 128;  // columns a warp takes at a time: 4 a lane
constexpr int kWarps = 8;   // warps a block
constexpr unsigned kFull = 0xffffffffu;

// Four consecutive columns of one row from column c on; columns at or past
// m read as `fill`.
__device__ __forceinline__ float4 load4(const float* __restrict__ row, int64_t c, int64_t m,
                                        bool vec, float fill) {
  if (vec && c + 3 < m) return __ldg(reinterpret_cast<const float4*>(row + c));
  float4 v;
  v.x = c + 0 < m ? __ldg(row + c + 0) : fill;
  v.y = c + 1 < m ? __ldg(row + c + 1) : fill;
  v.z = c + 2 < m ? __ldg(row + c + 2) : fill;
  v.w = c + 3 < m ? __ldg(row + c + 3) : fill;
  return v;
}

__device__ __forceinline__ int seg_id(float f, int n) {
  return f < (float)n ? (int)f : n;
}

// Output ids a warp stages at a time, for kRows rows: two blocks of eight
// warps an SM fit in shared memory.
template <int kRows>
__host__ __device__ constexpr int window() { return kRows <= 11 ? 256 : 128; }

// kRows >= n_rows: the rows a lane holds in registers and stages.
template <int kRows>
__global__ void __launch_bounds__(kWarps * 32)
segsum_kernel(const float* __restrict__ in, int64_t m, int n, int n_rows, bool vec,
              int64_t n_spans, float* __restrict__ out) {
  constexpr int kWindow = window<kRows>();
  extern __shared__ float smem[];
  float* stage = smem + (threadIdx.x >> 5) * kRows * kWindow;  // (kRows, kWindow)
  const int lane = threadIdx.x & 31;
  const int64_t warps = (int64_t)gridDim.x * (blockDim.x >> 5);
  for (int64_t sp = (int64_t)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
       sp < n_spans; sp += warps) {
    const int64_t base = sp * kSpan;
    const int64_t c0 = base + 4 * lane;
    // All loads at once: the span's 4 columns a lane, and one column a lane
    // of the 32 after it (to finish a run that continues past the span).
    const int64_t cl = base + kSpan + lane;
    const float4 kv = load4(in, c0, m, vec, (float)n);
    const int la_id = cl < m ? seg_id(__ldg(in + cl), n) : n;
    const int prev0 = lane == 0 && base > 0 ? seg_id(__ldg(in + base - 1), n) : -1;
    float4 xv[kRows];  // row 0 sums ones (the run's count), rows 1.. the payload
    float la[kRows];
    xv[0] = make_float4(1.f, 1.f, 1.f, 1.f);
    la[0] = 1.f;
#pragma unroll
    for (int r = 1; r < kRows; ++r) {
      xv[r] = r < n_rows ? load4(in + (int64_t)r * m, c0, m, vec, 0.f)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
      la[r] = r < n_rows && cl < m ? __ldg(in + (int64_t)r * m + cl) : 0.f;
    }
    int id[4] = {seg_id(kv.x, n), seg_id(kv.y, n), seg_id(kv.z, n), seg_id(kv.w, n)};
    const int first = __shfl_sync(kFull, id[0], 0);
    if (first >= n) break;  // the sentinel tail: nothing here or in later spans

    // Neighbours of the lane's four columns.
    int prev = __shfl_up_sync(kFull, id[3], 1);
    if (lane == 0) prev = prev0;
    int next = __shfl_down_sync(kFull, id[0], 1);
    const int la_first = __shfl_sync(kFull, la_id, 0);
    if (lane == 31) next = la_first;
    bool head[4], end[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      head[j] = id[j] != (j ? id[j - 1] : prev);
      end[j] = id[j] != (j < 3 ? id[j + 1] : next);
    }
    const bool any_head = head[0] || head[1] || head[2] || head[3];

    // The run at the span's start is another warp's when it continues from
    // the previous span; it covers the columns before the span's first head.
    const bool cont = !__shfl_sync(kFull, (int)head[0], 0);
    const bool heads_before = (__ballot_sync(kFull, any_head) & ((1u << lane) - 1u)) != 0;
    bool owned[4];
    bool seen = heads_before;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      seen |= head[j];
      owned[j] = !cont || seen;
    }

    // A run that ends at the span's last column but continues is finished
    // here: its columns among the 32 after the span (a prefix of them) are
    // summed across the warp, and lane 31 walks on column by column past
    // those (a run longer than 32 columns).
    float ext[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) ext[r] = 0.f;
    const int last = __shfl_sync(kFull, id[3], 31);
    const bool carry_on =
        __shfl_sync(kFull, (int)(!end[3] && owned[3] && id[3] < n), 31) != 0;
    if (carry_on) {
      const bool in_run = la_id == last;
      const int k = __popc(__ballot_sync(kFull, in_run));
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float v = in_run && r < n_rows ? la[r] : 0.f;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
        ext[r] = v;
      }
      if (k == 32 && lane == 31) {
        int64_t c = base + kSpan + 32;
        while (c < m && seg_id(__ldg(in + c), n) == last) {
          ext[0] += 1.f;
#pragma unroll
          for (int r = 1; r < kRows; ++r)
            if (r < n_rows) ext[r] += __ldg(in + (int64_t)r * m + c);
          ++c;
        }
      }
      if (lane == 31) end[3] = true;
    }
    bool emit[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) emit[j] = end[j] && owned[j] && id[j] < n;

    // The output ids this span writes, [lo, hi): past the id of the column
    // before the span (from the first id, in span 0) up to the last real id
    // in it. The ids before the buffer's first run and after its last are
    // the grid's (below).
    int top = -1;
#pragma unroll
    for (int j = 0; j < 4; ++j) top = id[j] < n ? id[j] : top;
    const int lo = sp == 0 ? first : __shfl_sync(kFull, prev0, 0) + 1;
    const int hi = __reduce_max_sync(kFull, top) + 1;

    // The segmented scan's pattern, the same for every row: at step d a lane
    // adds the partial of lane - d unless a head lies in between.
    bool add[5];
    {
      bool f = any_head;
#pragma unroll
      for (int k = 0; k < 5; ++k) {
        const int d = 1 << k;
        add[k] = lane >= d && !f;
        const bool fu = __shfl_up_sync(kFull, (int)f, d);
        if (lane >= d) f |= fu;
      }
    }

    // [lo, hi) in windows of kWindow ids: the run sums staged in shared
    // memory over zeros, then written row by row in consecutive ids; a
    // window with no run is written as zeros at once.
    for (int w0 = lo; w0 < hi; w0 += kWindow) {
      const int w1 = min(w0 + kWindow, hi);
      bool here = false;
#pragma unroll
      for (int j = 0; j < 4; ++j) here |= emit[j] && id[j] >= w0 && id[j] < w1;
      if (!__ballot_sync(kFull, here)) {
        for (int g = w0 + lane; g < w1; g += 32)
#pragma unroll
          for (int r = 0; r < 16; ++r) out[(int64_t)r * n + g] = 0.f;
        continue;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (r < n_rows)
          for (int i = lane; i < w1 - w0; i += 32) stage[r * kWindow + i] = 0.f;
      __syncwarp();
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r >= n_rows) continue;
        const float x[4] = {xv[r].x, xv[r].y, xv[r].z, xv[r].w};
        float part = 0.f;  // the lane's last run, from its head in the lane
#pragma unroll
        for (int j = 0; j < 4; ++j) part = (head[j] ? 0.f : part) + x[j];
#pragma unroll
        for (int k = 0; k < 5; ++k) {
          const float up = __shfl_up_sync(kFull, part, 1 << k);
          if (add[k]) part += up;
        }
        float acc = __shfl_up_sync(kFull, part, 1);  // the run entering the lane
        if (lane == 0) acc = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc = (head[j] ? 0.f : acc) + x[j];
          if (emit[j] && id[j] >= w0 && id[j] < w1) {
            const float v = j == 3 && lane == 31 ? acc + ext[r] : acc;
            stage[r * kWindow + id[j] - w0] = r == 0 ? (float)id[j] * v : v;
          }
        }
      }
      __syncwarp();
      for (int g = w0 + lane; g < w1; g += 32)
#pragma unroll
        for (int r = 0; r < 16; ++r)
          out[(int64_t)r * n + g] = r < kRows && r < n_rows ? stage[r * kWindow + g - w0] : 0.f;
      __syncwarp();
    }
  }

  // The ids before the first run and after the last, all warps of the grid
  // together (the whole output when the buffer holds no entry). The first
  // sentinel column p comes from a 32-way search of row 0 (ids ascend).
  const int first = m > 0 ? seg_id(__ldg(in), n) : n;
  int64_t lo = 0, hi = m;  // columns below lo are real; p <= hi
  while (lo < hi) {
    const int64_t step = (hi - lo + 31) / 32;
    const int64_t c = lo + lane * step;
    const unsigned sent = __ballot_sync(kFull, c >= hi || seg_id(__ldg(in + c), n) >= n);
    const int k = __ffs(sent) - 1;
    if (k < 0) {
      lo += 31 * step + 1;
    } else if (k == 0) {
      hi = lo;
    } else {
      const int64_t ck = lo + k * step;
      lo += (k - 1) * step + 1;
      hi = min(hi, ck);
    }
  }
  const int tail = lo > 0 ? seg_id(__ldg(in + lo - 1), n) + 1 : 0;
  const int64_t gw = (int64_t)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  for (int part = 0; part < 2; ++part) {
    const int a = part == 0 ? 0 : tail;
    const int b = part == 0 ? (tail > 0 ? first : 0) : n;
    for (int64_t g0 = a + gw * kSpan; g0 < b; g0 += warps * kSpan)
#pragma unroll
      for (int i = 0; i < kSpan; i += 32) {
        const int64_t g = g0 + i + lane;
        if (g < b)
#pragma unroll
          for (int r = 0; r < 16; ++r) out[(int64_t)r * n + g] = 0.f;
      }
  }
}

template <int kRows>
int launch(const float* in, int64_t m, int n, int n_rows, float* out, cudaStream_t stream) {
  const size_t smem = (size_t)kWarps * kRows * window<kRows>() * sizeof(float);
  auto* fn = segsum_kernel<kRows>;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kWarps * 32, smem)) !=
      cudaSuccess)
    return (int)err;
  const int64_t n_spans = (m + kSpan - 1) / kSpan;
  int64_t blocks = (n_spans + kWarps - 1) / kWarps;
  const int64_t resident = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  if (blocks > resident) blocks = resident;
  if (blocks < 1) blocks = 1;  // an empty buffer: the grid still writes the zeros
  const bool vec = m % 4 == 0 && (uintptr_t)in % 16 == 0;
  fn<<<(unsigned)blocks, kWarps * 32, smem, stream>>>(in, m, n, n_rows, vec, n_spans, out);
  return (int)cudaGetLastError();
}

}  // namespace

// in: (16, m) float32, row 0 ascending ids in [0, n]; out: (16, n) float32,
// every column written here; 1 <= n_rows <= 16.
extern "C" int gs_segsum(const void* in, int64_t m, int n, int n_rows, void* out,
                         void* stream) {
  const float* x = (const float*)in;
  float* o = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  if (n_rows <= 10) return launch<10>(x, m, n, n_rows, o, st);
  if (n_rows <= 11) return launch<11>(x, m, n, n_rows, o, st);
  return launch<16>(x, m, n, n_rows, o, st);
}
