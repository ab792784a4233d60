// hexplane: the HexPlane deformation field of 4D Gaussian Splatting (Wu et
// al., CVPR 2024) as a kernel pair: the forward samples the twelve planes of
// a row and writes its (32,) feature; the backward writes the planes'
// gradients and the row's coordinate gradient.
//
// Port only: replaces no Pallas kernel (the JAX package has no dynamic
// model). In plain PyTorch the field is twelve F.grid_sample calls a view
// each way plus the products and their gradients, each a full-size
// temporary; here a row's coordinates are read once, its feature written
// once, and the backward recomputes the samples instead of saving them.
//
// The field. A row's coordinates q = (x, y, z, t), x, y, z in the box's
// [-1, 1] and t the view's time (one for the launch, read from device
// memory). Scale s (0, 1) has six planes, one a pair (i, j) of the four
// axes in the order xy, xz, xt, yz, yt, zt, each held channel-last as
// (R_j, R_i, 16) float32. Each plane is sampled bilinearly at (q_i, q_j) as
// F.grid_sample(align_corners=True, padding_mode="border") samples it:
//   ix = ((q + 1) / 2) (R - 1), clipped to [0, R - 1]
//   v  = v_nw (x1 - ix)(y1 - iy) + v_ne (ix - x0)(y1 - iy)
//      + v_sw (x1 - ix)(iy - y0) + v_se (ix - x0)(iy - y0)
// with the terms added in that order, and the scale's feature is the
// product 1 * v_0 * v_1 * ... * v_5, multiplied left to right. The feature
// row holds scale 0's 16 channels, then scale 1's.
//
// The backward follows autograd's order through the product (the gradient
// of v_p is the running product of the later planes' values and the
// incoming gradient, times the earlier planes' product) and grid_sample's
// backward: the plane's four corners gain weight x gradient, and the
// coordinate's gradient is the sum over channels of the corner values'
// differences times the gradient, times (R - 1) / 2, zero where the clip
// holds the coordinate on or past an edge. The time axis takes no gradient.
// The source is built with -fmad=false, so that every product and sum is
// rounded as the plain version's PyTorch operations round it
// (ops/hexplane.py::field_plain); the forward equals it to a few ulps
// (floorf and the divisions are exact or correctly rounded in both).
//
// Work split. Four threads a row, each holding 4 of the 16 channels as
// float4s (a plane cell's 16 channels are one 64-byte line). The backward's
// coordinate gradient is summed over the four lanes with shuffles.
//
// The scatter. Every row of a launch shares t, so the three time planes of
// a scale are touched only in their two rows around t: all 1M rows of a
// view add into 2 x R_i cells there, the hottest addresses of the
// backward. Each block keeps those rows of the six time planes in shared
// memory (2 x (64 + 128) x 16 x 3 floats, 72 KB at the published
// resolutions), adds into them with shared-memory atomics over a
// grid-stride loop of rows, and flushes them once with global atomics. The
// spatial planes (64^2 and 128^2 cells) take global atomics directly, a
// corner's four channels in one 16-byte atomic (Hopper's vector atomicAdd).
// The sums are exact up to their order, which the atomics set.
//
// Bound on the H100 (portbench/work_hexplane.py): bytes, the rows'
// coordinates and features and the planes read once; the 768 corner reads
// a row and pass are served by L2 (the 9.5 MB table fits in its 50 MB).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChannels = 16;
constexpr int kLanes = kChannels / 4;  // threads a row
constexpr int kPlanes = 12;            // two scales of six
constexpr int kTimePlanes = 6;         // xt, yt, zt of each scale
constexpr int kThreads = 256;

// The planes of a launch, passed by value.
struct Planes {
  const float* v[kPlanes];
  float* g[kPlanes];        // gradients (backward only)
  int ri[kPlanes];          // columns: the resolution of axis i
  int rj[kPlanes];          // rows: the resolution of axis j
  int slab[kTimePlanes];    // offset of each time plane's two rows in shared memory
  int slab_floats;
};

// The axes (i, j) of plane p of a scale: xy, xz, xt, yz, yt, zt.
__device__ __forceinline__ int axis_i(int p) { return p < 3 ? 0 : (p < 5 ? 1 : 2); }
__device__ __forceinline__ int axis_j(int p) { return p == 0 ? 1 : ((p == 1 || p == 3) ? 2 : 3); }
// Index among the time planes (p = 2, 4, 5 of scale s), or -1.
__device__ __forceinline__ int time_index(int s, int p) {
  return p == 2 ? 3 * s : (p == 4 ? 3 * s + 1 : (p == 5 ? 3 * s + 2 : -1));
}

// One axis of a sample: the clipped unnormalised coordinate's cell, its two
// weights, and the coordinate's gradient factor (0 where clipped).
struct Axis {
  int c0, c1;     // cells (c1 clamped to R - 1; its weight is 0 there)
  float w0, w1;   // (c0 + 1 - x), (x - c0)
  float gmul;     // clip gradient x (R - 1) / 2
  bool in1;       // c0 + 1 < R
};

__device__ __forceinline__ Axis locate(float q, int R) {
  Axis a;
  const float lim = (float)(R - 1);
  float x = __fmul_rn(__fdiv_rn(__fadd_rn(q, 1.0f), 2.0f), lim);
  float clip = 1.0f;
  if (x <= 0.0f) {
    x = 0.0f;
    clip = 0.0f;
  } else if (x >= lim) {
    x = lim;
    clip = 0.0f;
  }
  const float f = floorf(x);
  a.c0 = (int)f;
  a.in1 = a.c0 + 1 < R;
  a.c1 = a.in1 ? a.c0 + 1 : a.c0;
  a.w0 = __fsub_rn(__fadd_rn(f, 1.0f), x);
  a.w1 = __fsub_rn(x, f);
  a.gmul = __fmul_rn(clip, __fdiv_rn(lim, 2.0f));
  return a;
}

__device__ __forceinline__ float4 mul4(float4 a, float4 b) {
  return make_float4(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y), __fmul_rn(a.z, b.z),
                     __fmul_rn(a.w, b.w));
}

__device__ __forceinline__ float4 scale4(float4 a, float s) {
  return make_float4(__fmul_rn(a.x, s), __fmul_rn(a.y, s), __fmul_rn(a.z, s), __fmul_rn(a.w, s));
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                     __fadd_rn(a.w, b.w));
}

__device__ __forceinline__ float4 sub4(float4 a, float4 b) {
  return make_float4(__fsub_rn(a.x, b.x), __fsub_rn(a.y, b.y), __fsub_rn(a.z, b.z),
                     __fsub_rn(a.w, b.w));
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  // Channel order, as a sequential sum over channels.
  float s = __fmul_rn(a.x, b.x);
  s = __fadd_rn(s, __fmul_rn(a.y, b.y));
  s = __fadd_rn(s, __fmul_rn(a.z, b.z));
  return __fadd_rn(s, __fmul_rn(a.w, b.w));
}

__device__ __forceinline__ float4 cell(const float* plane, int ri, int y, int x, int lane) {
  return __ldg(reinterpret_cast<const float4*>(plane + ((int64_t)y * ri + x) * kChannels) + lane);
}

struct Corners {
  float4 nw, ne, sw, se;
};

__device__ __forceinline__ Corners gather(const float* plane, int ri, const Axis& ax,
                                          const Axis& ay, int lane) {
  Corners c;
  c.nw = cell(plane, ri, ay.c0, ax.c0, lane);
  c.ne = cell(plane, ri, ay.c0, ax.c1, lane);
  c.sw = cell(plane, ri, ay.c1, ax.c0, lane);
  c.se = cell(plane, ri, ay.c1, ax.c1, lane);
  return c;
}

__device__ __forceinline__ float4 bilerp(const Corners& c, const Axis& ax, const Axis& ay) {
  const float nw = __fmul_rn(ax.w0, ay.w0), ne = __fmul_rn(ax.w1, ay.w0);
  const float sw = __fmul_rn(ax.w0, ay.w1), se = __fmul_rn(ax.w1, ay.w1);
  float4 v = scale4(c.nw, nw);
  v = add4(v, scale4(c.ne, ne));
  v = add4(v, scale4(c.sw, sw));
  return add4(v, scale4(c.se, se));
}

__device__ __forceinline__ void load_coords(const float* __restrict__ xn, float t, int64_t row,
                                            float q[4]) {
  q[0] = xn[3 * row];
  q[1] = xn[3 * row + 1];
  q[2] = xn[3 * row + 2];
  q[3] = t;
}

__global__ void __launch_bounds__(kThreads)
hexplane_fwd_kernel(const Planes P, const float* __restrict__ xn, const float* __restrict__ t_ptr,
                    int64_t rows, float4* __restrict__ feat) {
  const int64_t tid = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t row = tid / kLanes;
  const int lane = (int)(tid % kLanes);
  if (row >= rows) return;
  float q[4];
  load_coords(xn, __ldg(t_ptr), row, q);
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    float4 acc = make_float4(1.0f, 1.0f, 1.0f, 1.0f);
#pragma unroll
    for (int p = 0; p < 6; ++p) {
      const int k = 6 * s + p;
      const Axis ax = locate(q[axis_i(p)], P.ri[k]);
      const Axis ay = locate(q[axis_j(p)], P.rj[k]);
      acc = mul4(acc, bilerp(gather(P.v[k], P.ri[k], ax, ay, lane), ax, ay));
    }
    feat[row * (2 * kLanes) + s * kLanes + lane] = acc;
  }
}

// A corner's four channels added into shared memory, one atomic each.
__device__ __forceinline__ void add_shared(float* dst, float4 g) {
  atomicAdd(dst, g.x);
  atomicAdd(dst + 1, g.y);
  atomicAdd(dst + 2, g.z);
  atomicAdd(dst + 3, g.w);
}

// A corner's four channels added into global memory (16-byte aligned): one
// 16-byte atomic on Hopper, a quarter of the L2's atomic operations.
__device__ __forceinline__ void add_global(float* dst, float4 g) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
  atomicAdd(reinterpret_cast<float4*>(dst), g);
#else
  add_shared(dst, g);
#endif
}

// The time rows of a launch: the cell t falls in, shared by every row.
struct TimeRows {
  int y0;
  bool in1;
};

// Two blocks an SM: ptxas holds the kernel to 128 registers (a few spills
// to L1) where it would take 172 and run one block an SM; 2.9 against 4.2
// ms a view at 1M rows (NVIDIA H100, 700 W).
__global__ void __launch_bounds__(kThreads, 2)
hexplane_bwd_kernel(const Planes P, const float* __restrict__ xn, const float* __restrict__ t_ptr,
                    const float4* __restrict__ gfeat, int64_t rows, float* __restrict__ gxn) {
  extern __shared__ __align__(16) float slab[];
  const float t = __ldg(t_ptr);
  for (int i = threadIdx.x; i < P.slab_floats; i += kThreads) slab[i] = 0.0f;
  __syncthreads();
  const int lane = threadIdx.x % kLanes;
  const int64_t stride = (int64_t)gridDim.x * (kThreads / kLanes);
  int64_t row = (int64_t)blockIdx.x * (kThreads / kLanes) + threadIdx.x / kLanes;
  // Every lane of a warp takes the trips of the warp's first row, so the
  // full-warp shuffles below always find their partners; a lane past the
  // last row idles through its trip.
  const int64_t first = row - (threadIdx.x % 32) / kLanes;
  const int64_t trips = rows > first ? (rows - first + stride - 1) / stride : 0;
  for (int64_t trip = 0; trip < trips; ++trip, row += stride) {
    const bool active = row < rows;
    float q[4] = {0.0f, 0.0f, 0.0f, t};
    if (active) load_coords(xn, t, row, q);
    float dq[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int s = 0; s < 2 && active; ++s) {
      // The forward's values and running products a_p = 1 * v_0 * .. * v_p.
      float4 v[6], a[6];
#pragma unroll
      for (int p = 0; p < 6; ++p) {
        const int k = 6 * s + p;
        const Axis ax = locate(q[axis_i(p)], P.ri[k]);
        const Axis ay = locate(q[axis_j(p)], P.rj[k]);
        v[p] = bilerp(gather(P.v[k], P.ri[k], ax, ay, lane), ax, ay);
        a[p] = p == 0 ? v[0] : mul4(a[p - 1], v[p]);
      }
      float4 G = __ldg(gfeat + row * (2 * kLanes) + s * kLanes + lane);
#pragma unroll
      for (int p = 5; p >= 0; --p) {
        const float4 gv = p == 0 ? G : mul4(G, a[p - 1]);
        if (p > 0) G = mul4(G, v[p]);
        const int k = 6 * s + p;
        const int i = axis_i(p), j = axis_j(p);
        const Axis ax = locate(q[i], P.ri[k]);
        const Axis ay = locate(q[j], P.rj[k]);
        const Corners c = gather(P.v[k], P.ri[k], ax, ay, lane);
        // grid_sample's coordinate gradient, summed over this lane's channels:
        // the corner values' differences along the axis, each row of corners
        // weighted by the other axis.
        const float gx = __fadd_rn(__fmul_rn(dot4(sub4(c.ne, c.nw), gv), ay.w0),
                                   __fmul_rn(dot4(sub4(c.se, c.sw), gv), ay.w1));
        const float gy = __fadd_rn(__fmul_rn(dot4(sub4(c.sw, c.nw), gv), ax.w0),
                                   __fmul_rn(dot4(sub4(c.se, c.ne), gv), ax.w1));
        dq[i] = __fadd_rn(dq[i], __fmul_rn(ax.gmul, gx));
        if (j < 3) dq[j] = __fadd_rn(dq[j], __fmul_rn(ay.gmul, gy));
        // The plane's four corners.
        const float nw = __fmul_rn(ax.w0, ay.w0), ne = __fmul_rn(ax.w1, ay.w0);
        const float sw = __fmul_rn(ax.w0, ay.w1), se = __fmul_rn(ax.w1, ay.w1);
        const int ti = time_index(s, p);
        if (ti >= 0) {
          // Rows y0 and y0 + 1 of the time plane, in shared memory.
          float* base = slab + P.slab[ti] + lane * 4;
          const int ri = P.ri[k];
          add_shared(base + ax.c0 * kChannels, scale4(gv, nw));
          if (ax.in1) add_shared(base + ax.c1 * kChannels, scale4(gv, ne));
          if (ay.in1) {
            add_shared(base + (ri + ax.c0) * kChannels, scale4(gv, sw));
            if (ax.in1) add_shared(base + (ri + ax.c1) * kChannels, scale4(gv, se));
          }
        } else {
          float* base = P.g[k] + lane * 4;
          const int ri = P.ri[k];
          add_global(base + ((int64_t)ay.c0 * ri + ax.c0) * kChannels, scale4(gv, nw));
          if (ax.in1) add_global(base + ((int64_t)ay.c0 * ri + ax.c1) * kChannels, scale4(gv, ne));
          if (ay.in1) {
            add_global(base + ((int64_t)ay.c1 * ri + ax.c0) * kChannels, scale4(gv, sw));
            if (ax.in1)
              add_global(base + ((int64_t)ay.c1 * ri + ax.c1) * kChannels, scale4(gv, se));
          }
        }
      }
    }
    // The row's four lanes are adjacent in the warp.
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      dq[d] = __fadd_rn(dq[d], __shfl_xor_sync(0xffffffffu, dq[d], 1));
      dq[d] = __fadd_rn(dq[d], __shfl_xor_sync(0xffffffffu, dq[d], 2));
    }
    if (active && lane == 0) {
      gxn[3 * row] = dq[0];
      gxn[3 * row + 1] = dq[1];
      gxn[3 * row + 2] = dq[2];
    }
  }
  __syncthreads();
  // Flush the time planes' rows: row y0, and y0 + 1 where it exists.
#pragma unroll 1
  for (int ti = 0; ti < kTimePlanes; ++ti) {
    const int s = ti / 3;
    const int k = 6 * s + (ti % 3 == 0 ? 2 : (ti % 3 == 1 ? 4 : 5));
    const Axis ay = locate(t, P.rj[k]);
    const int n = (ay.in1 ? 2 : 1) * P.ri[k] * kLanes;  // float4s
    const float4* src = reinterpret_cast<const float4*>(slab + P.slab[ti]);
    float* dst = P.g[k] + (int64_t)ay.c0 * P.ri[k] * kChannels;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const float4 x = src[i];
      if (x.x != 0.0f || x.y != 0.0f || x.z != 0.0f || x.w != 0.0f) add_global(dst + 4 * i, x);
    }
  }
}

int fill_planes(Planes* P, const int64_t* values, const int64_t* grads, const int32_t* dims) {
  int off = 0;
  for (int k = 0; k < kPlanes; ++k) {
    P->v[k] = reinterpret_cast<const float*>(values[k]);
    P->g[k] = grads ? reinterpret_cast<float*>(grads[k]) : nullptr;
    P->ri[k] = dims[2 * k];
    P->rj[k] = dims[2 * k + 1];
    if (P->ri[k] < 1 || P->rj[k] < 1) return (int)cudaErrorInvalidValue;
    const int p = k % 6;
    if (p == 2 || p == 4 || p == 5) {
      const int ti = 3 * (k / 6) + (p == 2 ? 0 : (p == 4 ? 1 : 2));
      P->slab[ti] = off;
      off += 2 * P->ri[k] * kChannels;
    }
  }
  P->slab_floats = off;
  return 0;
}

}  // namespace

extern "C" {

// Shared memory the backward needs a block (bytes), for planes of `dims`.
int64_t gs_hexplane_bwd_shared_bytes(const int32_t* dims) {
  Planes P;
  int64_t zeros[kPlanes] = {0};
  if (fill_planes(&P, zeros, nullptr, dims) != 0) return -1;
  return (int64_t)P.slab_floats * (int64_t)sizeof(float);
}

// feat (rows, 32) of the coordinates xn (rows, 3) at the time *t_ptr.
// values: the twelve planes' device pointers, each (rj, ri, 16) float32
// contiguous; dims: (ri, rj) of each plane.
int gs_hexplane_fwd(const int64_t* values, const int32_t* dims, const float* xn,
                    const float* t_ptr, int64_t rows, float* feat, cudaStream_t stream) {
  Planes P;
  int rc = fill_planes(&P, values, nullptr, dims);
  if (rc != 0) return rc;
  if (rows <= 0) return 0;
  const int64_t threads = rows * kLanes;
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  hexplane_fwd_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
      P, xn, t_ptr, rows, reinterpret_cast<float4*>(feat));
  return (int)cudaGetLastError();
}

// The planes' gradients added into grads (zeroed by the caller, the
// planes' layout) and the coordinates' gradient written to gxn (rows, 3),
// from the features' gradient gfeat (rows, 32).
int gs_hexplane_bwd(const int64_t* values, const int64_t* grads, const int32_t* dims,
                    const float* xn, const float* t_ptr, const float* gfeat, int64_t rows,
                    float* gxn, cudaStream_t stream) {
  Planes P;
  int rc = fill_planes(&P, values, grads, dims);
  if (rc != 0) return rc;
  if (rows <= 0) return 0;
  const size_t shared = (size_t)P.slab_floats * sizeof(float);
  rc = (int)cudaFuncSetAttribute(hexplane_bwd_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
  if (rc != 0) return rc;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, hexplane_bwd_kernel, kThreads,
                                                          shared);
  if (rc != 0) return rc;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int64_t rows_per_block = kThreads / kLanes;
  int64_t blocks = (rows + rows_per_block - 1) / rows_per_block;
  const int64_t resident = (int64_t)sms * per_sm;
  if (blocks > resident) blocks = resident;
  hexplane_bwd_kernel<<<(unsigned)blocks, kThreads, shared, stream>>>(
      P, xn, t_ptr, reinterpret_cast<const float4*>(gfeat), rows, gxn);
  return (int)cudaGetLastError();
}

}  // extern "C"
