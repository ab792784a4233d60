// adam: one Adam update of many float32 tensors in one launch (a
// multi-tensor apply), in place.
//
// Port only: replaces no Pallas kernel (the JAX package updates each group
// with plain jnp, fused by XLA). In the port's plain code
// (training/optimizer.py::adam_step) every operation of the update is its
// own ATen kernel with a full-size temporary, about fourteen passes over a
// tensor; here each element's gradient, parameter and moments are read once
// and the parameter and moments written once, with no temporary.
//
// Same work, same bits: the update is adam_step's, operation for operation
// in float32, each one rounded as the ATen kernel rounds it (the source is
// built with -fmad=false, and the intrinsics below are never contracted):
//   m = m * b1 + (1 - b1) * g
//   v = v * b2 + ((1 - b2) * g) * g
//   p = p - (lr * (m / c1)) / (sqrt(v / c2) + eps)
// with IEEE-rounded division and square root. b1, 1 - b1, b2, 1 - b2, eps
// and a rate given as a number arrive rounded once to float32 from the
// caller's doubles, as ATen rounds a Python scalar; c1, c2 and a rate given
// as a 0-dim tensor are read through device pointers (c1 and c2 are
// divisors held in device tensors, so ATen divides by them and does not
// multiply by a reciprocal). NaN and infinity propagate as in the plain code.
//
// Work split: the tensors are the segments of a table passed by value in the
// kernel's parameters (at most kMaxSegments a launch). Each segment is cut
// into chunks of kChunk elements and each block updates one chunk: block b
// finds the last segment whose first block is at most b. A chunk whose four
// tensors all start on 16 bytes is read and written as float4, each thread
// holding kUnroll of them of each tensor at once so that enough loads are
// in flight to cover HBM's latency; a float4 that runs past the segment's
// end, and every element of a segment not aligned so, takes scalar code.
//
// Bound on the H100: bytes, 28 a float element (16 read, 12 written): the
// 3.11M cell's buffer of 4.665M slots x 59 floats is 7.71 GB, 2.30 ms at
// 3.35 TB/s.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSegments = 32;
constexpr int kThreads = 256;
constexpr int kUnroll = 4;                           // float4s of each tensor a thread holds
constexpr int64_t kChunk = kThreads * 4 * kUnroll;  // elements a block

// One tensor of the launch. The layout is shared with the caller's ctypes
// structure (training/optimizer.py::_Segment).
struct Segment {
  float* p;
  const float* g;
  float* m;
  float* v;
  const float* lr_ptr;  // a 0-dim device rate, or null: then `lr`
  int64_t n;            // elements
  int64_t first_block;
  float lr;
  int vec;  // all four tensors start on 16 bytes
};
static_assert(sizeof(Segment) == 64, "Segment must match the caller's layout");

struct Table {
  Segment seg[kMaxSegments];
  int n_seg;
  const float* c1;
  const float* c2;
  float b1, omb1, b2, omb2, eps;
};

struct Rates {
  float lr, c1, c2;
};

__device__ __forceinline__ void update(float& p, float g, float& m, float& v, const Rates& r,
                                       const Table& t) {
  m = __fadd_rn(__fmul_rn(m, t.b1), __fmul_rn(t.omb1, g));
  v = __fadd_rn(__fmul_rn(v, t.b2), __fmul_rn(__fmul_rn(t.omb2, g), g));
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, r.c2)), t.eps);
  p = __fsub_rn(p, __fdiv_rn(__fmul_rn(r.lr, __fdiv_rn(m, r.c1)), den));
}

__device__ __forceinline__ void update4(float4& p, const float4& g, float4& m, float4& v,
                                        const Rates& r, const Table& t) {
  update(p.x, g.x, m.x, v.x, r, t);
  update(p.y, g.y, m.y, v.y, r, t);
  update(p.z, g.z, m.z, v.z, r, t);
  update(p.w, g.w, m.w, v.w, r, t);
}

__device__ __forceinline__ void update_at(const Segment& s, int64_t i, const Rates& r,
                                          const Table& t) {
  float p = s.p[i], m = s.m[i], v = s.v[i];
  update(p, __ldg(s.g + i), m, v, r, t);
  s.p[i] = p;
  s.m[i] = m;
  s.v[i] = v;
}

__global__ void __launch_bounds__(kThreads)
adam_kernel(const __grid_constant__ Table t) {
  const int64_t b = blockIdx.x;
  int k = 0;
  for (int i = 1; i < t.n_seg; ++i)
    if (t.seg[i].first_block <= b) k = i;
  const Segment& s = t.seg[k];
  const int64_t lo = (b - s.first_block) * kChunk;
  const int64_t hi = lo + kChunk < s.n ? lo + kChunk : s.n;
  const Rates r{s.lr_ptr != nullptr ? *s.lr_ptr : s.lr, *t.c1, *t.c2};

  if (s.vec && hi - lo == kChunk) {
    // A whole aligned chunk: every load first, then the arithmetic.
    float4 p[kUnroll], g[kUnroll], m[kUnroll], v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = lo + 4 * (threadIdx.x + (int64_t)u * kThreads);
      g[u] = __ldg(reinterpret_cast<const float4*>(s.g + i));
      p[u] = *reinterpret_cast<const float4*>(s.p + i);
      m[u] = *reinterpret_cast<const float4*>(s.m + i);
      v[u] = *reinterpret_cast<const float4*>(s.v + i);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = lo + 4 * (threadIdx.x + (int64_t)u * kThreads);
      update4(p[u], g[u], m[u], v[u], r, t);
      *reinterpret_cast<float4*>(s.p + i) = p[u];
      *reinterpret_cast<float4*>(s.m + i) = m[u];
      *reinterpret_cast<float4*>(s.v + i) = v[u];
    }
  } else if (s.vec) {
    // The segment's last, partial chunk: whole float4s, then a scalar tail.
    for (int64_t i = lo + 4 * (int64_t)threadIdx.x; i < hi; i += 4 * kThreads) {
      if (i + 4 <= hi) {
        float4 p = *reinterpret_cast<const float4*>(s.p + i);
        float4 m = *reinterpret_cast<const float4*>(s.m + i);
        float4 v = *reinterpret_cast<const float4*>(s.v + i);
        const float4 g = __ldg(reinterpret_cast<const float4*>(s.g + i));
        update4(p, g, m, v, r, t);
        *reinterpret_cast<float4*>(s.p + i) = p;
        *reinterpret_cast<float4*>(s.m + i) = m;
        *reinterpret_cast<float4*>(s.v + i) = v;
      } else {
        for (int64_t j = i; j < hi; ++j) update_at(s, j, r, t);
      }
    }
  } else {
    for (int64_t i = lo + threadIdx.x; i < hi; i += kThreads) update_at(s, i, r, t);
  }
}

}  // namespace

// segs: n_seg host segments (first blocks ascending, no empty segment);
// n_blocks: the blocks they take, `chunk` elements each, which must be
// kChunk (the caller's plan of the blocks). b1 .. eps are the caller's
// doubles, rounded here to float32 once.
extern "C" int gs_adam(const void* segs, int n_seg, int64_t n_blocks, int chunk,
                       const void* c1, const void* c2, double b1, double b2, double eps,
                       void* stream) {
  if (chunk != kChunk || n_seg < 1 || n_seg > kMaxSegments || n_blocks < 1 ||
      n_blocks > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  Table t;
  const Segment* src = (const Segment*)segs;
  for (int i = 0; i < n_seg; ++i) t.seg[i] = src[i];
  t.n_seg = n_seg;
  t.c1 = (const float*)c1;
  t.c2 = (const float*)c2;
  t.b1 = (float)b1;
  t.omb1 = (float)(1.0 - b1);
  t.b2 = (float)b2;
  t.omb2 = (float)(1.0 - b2);
  t.eps = (float)eps;
  adam_kernel<<<(unsigned)n_blocks, kThreads, 0, (cudaStream_t)stream>>>(t);
  return (int)cudaGetLastError();
}
