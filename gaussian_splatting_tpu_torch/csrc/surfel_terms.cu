// surfel_terms: the two surfel regularizers of one view (2D Gaussian
// Splatting's normal-consistency and depth-distortion means), forward and
// backward, one launch each.
//
// Replaces no TPU kernel: the JAX package has no surfels. In the port's plain
// code (training/loss.py::surfel_terms_plain and depth_to_normal) the terms
// were some 60 ATen kernels a view, each a full pass over an (H, W, 3) or
// (H, W) float32 image, and autograd kept a dozen such temporaries for the
// backward; here each pixel's chain stays in registers and shared memory.
//
// Contract: training/loss.py::surfel_terms. The input is the raster's (H, W,
// 12) map buffer (ops/surfel.py's rows: r g b depth alpha nx ny nz distortion
// median M1 M2), read where it lies through its three strides; the view's
// world-to-camera matrix (4, 4) and intrinsics (3, 3) are read from device
// memory. Per pixel:
//   s   = depth / max(alpha, 1e-10), blended (1 - r) s + r median at r != 0
//   P   = (s (x + 0.5 - cx) / fx, s (y + 0.5 - cy) / fy, s) - t, times R
//   dx  = P[y + 1, x] - P[y - 1, x],  dy = P[y, x + 1] - P[y, x - 1]
//   N_s = cross(dx, dy) / max(|cross(dx, dy)|, 1e-12) * alpha  (0 on the
//         one-pixel border; alpha held fixed)
//   term = 1 - (normal R) . N_s
// and the forward writes mean(term) and mean(distortion). The backward
// takes those means' cotangents from device memory (a null pointer is a zero
// cotangent) and writes the gradient of the whole (H, W, 12) buffer once:
// the depth, alpha, normal and distortion rows, zero in the others (the
// colour's gradient comes from the photometric loss; the median takes none).
//
// Same work, nearly the same bits: every operation of the plain code in its
// order and in float32, rounded as ATen's CUDA kernels round them (the
// source is built with -fmad=false, the few products that ATen's kernels
// fuse are fused here by hand): the 3 x 3 matrix products as cuBLAS sums
// their three terms, the cross product's first product fused, sums over
// three components in ATen's reduction order, and autograd's gradient sums
// in the order its engine adds them. The means are summed in double, in
// a fixed order: partial sums a block, then the block that finishes last
// adds them in block order (an integer ticket, no float atomics), so two
// runs give the same bits.
//
// Bound on the H100: bytes. The forward reads the six rows it uses (24 B a
// pixel), the backward five rows (20 B) and writes the 12-row gradient (48
// B): 92 B a pixel, 0.19 GB a 1920 x 1080 view, 0.057 ms at 3.35 TB/s. The
// stencil's neighbours come from shared memory: a block of 32 x 8 pixels
// stages its world points with a halo (one pixel forward; two backward,
// where each pixel gathers the adjoints of its four neighbours' cross
// products, computed once a pixel of a one-pixel halo and kept in shared
// memory).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTx = 32;
constexpr int kTy = 8;
constexpr int kThreads = kTx * kTy;
constexpr int kWarps = kThreads / 32;
constexpr float kAlphaFloor = 1e-10f;
constexpr float kNormFloor = 1e-12f;

// Rows of the raster's map buffer (ops/surfel.py, OUT_ROWS = 12).
constexpr int kRows = 12;
constexpr int kDepth = 3, kAlpha = 4, kNormal = 5, kDist = 8, kMedian = 9;

struct Maps {
  const float* base;
  int64_t sy, sx, sc;  // strides in elements
  int h, w;
  int blend;           // depth_ratio != 0: the median is read
  float omr, r;        // 1 - depth_ratio and depth_ratio, rounded to float32

  __device__ __forceinline__ float at(int y, int x, int row) const {
    return __ldg(base + y * sy + x * sx + row * sc);
  }
};

struct View {
  float R[9];  // world-to-camera rotation, row-major
  float t[3];
  float fx, fy, cx, cy;
};

__device__ __forceinline__ View load_view(const float* vm, const float* K) {
  View v;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) v.R[3 * i + j] = __ldg(vm + 4 * i + j);
    v.t[i] = __ldg(vm + 4 * i + 3);
  }
  v.fx = __ldg(K + 0);
  v.cx = __ldg(K + 2);
  v.fy = __ldg(K + 4);
  v.cy = __ldg(K + 5);
  return v;
}

__device__ __forceinline__ bool inside(const Maps& m, int y, int x) {
  return y >= 0 && y < m.h && x >= 0 && x < m.w;
}

__device__ __forceinline__ bool interior(const Maps& m, int y, int x) {
  return y >= 1 && y < m.h - 1 && x >= 1 && x < m.w - 1;
}

// torch.clamp_min(v, floor): NaN stays NaN.
__device__ __forceinline__ float clamp_min(float v, float floor) {
  return v < floor ? floor : v;
}

// The ray's x and y of a pixel column or row: (x + 0.5 - cx) / fx.
__device__ __forceinline__ float ray(int i, float c, float f) {
  return __fdiv_rn(__fsub_rn(__fadd_rn((float)i, 0.5f), c), f);
}

__device__ __forceinline__ float surface_depth(const Maps& m, int y, int x) {
  float s = __fdiv_rn(m.at(y, x, kDepth), clamp_min(m.at(y, x, kAlpha), kAlphaFloor));
  if (m.blend) s = __fadd_rn(__fmul_rn(m.omr, s), __fmul_rn(m.r, m.at(y, x, kMedian)));
  return s;
}

// (a0, a1, a2) @ M for a row-major 3 x 3 M (a GEMM's order: k = 0, 1, 2).
__device__ __forceinline__ float row_times(float a0, float a1, float a2, const float* M, int j) {
  return __fmaf_rn(a2, M[6 + j], __fmaf_rn(a1, M[3 + j], __fmul_rn(a0, M[j])));
}

// (a0, a1, a2) @ M^T.
__device__ __forceinline__ float row_times_t(float a0, float a1, float a2, const float* M,
                                             int i) {
  return __fmaf_rn(a2, M[3 * i + 2], __fmaf_rn(a1, M[3 * i + 1], __fmul_rn(a0, M[3 * i])));
}

// The world point of pixel (y, x) at surface depth s.
__device__ __forceinline__ void world_point(const View& v, int y, int x, float s, float* p) {
  const float d0 = __fsub_rn(__fmul_rn(s, ray(x, v.cx, v.fx)), v.t[0]);
  const float d1 = __fsub_rn(__fmul_rn(s, ray(y, v.cy, v.fy)), v.t[1]);
  const float d2 = __fsub_rn(s, v.t[2]);
#pragma unroll
  for (int j = 0; j < 3; ++j) p[j] = row_times(d0, d1, d2, v.R, j);
}

// torch.cross as ATen's CUDA kernel rounds it: a1 b2 - a2 b1 with the first
// product fused.
__device__ __forceinline__ void cross(const float* a, const float* b, float* c) {
  c[0] = __fmaf_rn(a[1], b[2], -__fmul_rn(a[2], b[1]));
  c[1] = __fmaf_rn(a[2], b[0], -__fmul_rn(a[0], b[2]));
  c[2] = __fmaf_rn(a[0], b[1], -__fmul_rn(a[1], b[0]));
}

// A sum over a last dimension of three as ATen's CUDA reduction orders it.
__device__ __forceinline__ float sum3(float v0, float v1, float v2) {
  return __fadd_rn(__fadd_rn(v0, v2), v1);
}

__device__ __forceinline__ float norm3(const float* c) {
  return __fsqrt_rn(sum3(__fmul_rn(c[0], c[0]), __fmul_rn(c[1], c[1]), __fmul_rn(c[2], c[2])));
}

// Stage the world points of the (rows x cols) region whose first pixel is
// (y0, x0) in `pts` (3 floats a pixel); zero outside the image.
template <int kRowsR, int kColsR>
__device__ __forceinline__ void stage_points(const Maps& m, const View& v, int y0, int x0,
                                             float (*pts)[kColsR][3]) {
  for (int i = threadIdx.x; i < kRowsR * kColsR; i += kThreads) {
    const int ly = i / kColsR, lx = i % kColsR;
    const int y = y0 + ly, x = x0 + lx;
    float p[3] = {0.f, 0.f, 0.f};
    if (inside(m, y, x)) world_point(v, y, x, surface_depth(m, y, x), p);
#pragma unroll
    for (int j = 0; j < 3; ++j) pts[ly][lx][j] = p[j];
  }
}

// The sum of `a` over the block, thread 0's value valid (a fixed order).
__device__ __forceinline__ double block_sum(double a, double* scratch) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) a += __shfl_down_sync(0xffffffffu, a, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) scratch[warp] = a;
  __syncthreads();
  double s = 0.0;
  if (threadIdx.x == 0)
    for (int i = 0; i < kWarps; ++i) s += scratch[i];
  return s;
}

__global__ void __launch_bounds__(kThreads)
surfel_terms_fwd_kernel(Maps m, const float* vm, const float* K, double* partial,
                        unsigned int* ticket, float* mean_normal, float* mean_dist) {
  __shared__ float pts[kTy + 2][kTx + 2][3];
  __shared__ double scratch[kWarps];
  __shared__ bool last;
  const View v = load_view(vm, K);
  const int x0 = blockIdx.x * kTx, y0 = blockIdx.y * kTy;
  stage_points<kTy + 2, kTx + 2>(m, v, y0 - 1, x0 - 1, pts);
  __syncthreads();

  const int tx = threadIdx.x % kTx, ty = threadIdx.x / kTx;
  const int x = x0 + tx, y = y0 + ty;
  double term_sum = 0.0, dist_sum = 0.0;
  if (inside(m, y, x)) {
    const float alpha = m.at(y, x, kAlpha);
    float ns[3] = {0.f, 0.f, 0.f};
    if (interior(m, y, x)) {
      float dx[3], dy[3], c[3];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        dx[j] = __fsub_rn(pts[ty + 2][tx + 1][j], pts[ty][tx + 1][j]);
        dy[j] = __fsub_rn(pts[ty + 1][tx + 2][j], pts[ty + 1][tx][j]);
      }
      cross(dx, dy, c);
      const float den = clamp_min(norm3(c), kNormFloor);
#pragma unroll
      for (int j = 0; j < 3; ++j) ns[j] = __fmul_rn(__fdiv_rn(c[j], den), alpha);
    }
    const float n0 = m.at(y, x, kNormal), n1 = m.at(y, x, kNormal + 1),
                n2 = m.at(y, x, kNormal + 2);
    const float dot = sum3(__fmul_rn(row_times(n0, n1, n2, v.R, 0), ns[0]),
                           __fmul_rn(row_times(n0, n1, n2, v.R, 1), ns[1]),
                           __fmul_rn(row_times(n0, n1, n2, v.R, 2), ns[2]));
    term_sum = (double)__fsub_rn(1.f, dot);
    dist_sum = (double)m.at(y, x, kDist);
  }

  const double bt = block_sum(term_sum, scratch);
  const double bd = block_sum(dist_sum, scratch);
  const unsigned int n_blocks = gridDim.x * gridDim.y;
  const unsigned int b = blockIdx.y * gridDim.x + blockIdx.x;
  if (threadIdx.x == 0) {
    partial[2 * b] = bt;
    partial[2 * b + 1] = bd;
    __threadfence();
    last = atomicAdd(ticket, 1u) == n_blocks - 1;
  }
  __syncthreads();
  if (!last) return;
  // The last block: every partial is written; add them in block order.
  __threadfence();
  double st = 0.0, sd = 0.0;
  for (unsigned int i = threadIdx.x; i < n_blocks; i += kThreads) {
    st += __ldcg(partial + 2 * i);
    sd += __ldcg(partial + 2 * i + 1);
  }
  st = block_sum(st, scratch);
  sd = block_sum(sd, scratch);
  if (threadIdx.x == 0) {
    const double count = (double)m.h * (double)m.w;
    *mean_normal = (float)(st / count);
    *mean_dist = (float)(sd / count);
    *ticket = 0u;  // ready for the next launch on this stream
  }
}

__global__ void __launch_bounds__(kThreads)
surfel_terms_bwd_kernel(Maps m, const float* vm, const float* K, const float* g_normal,
                        const float* g_dist, float* grad) {
  __shared__ float pts[kTy + 4][kTx + 4][3];
  // Per pixel of the tile and its one-pixel halo: the adjoints of dx and dy
  // and N_s.
  __shared__ float adj[kTy + 2][kTx + 2][9];
  const View v = load_view(vm, K);
  const int x0 = blockIdx.x * kTx, y0 = blockIdx.y * kTy;
  // d term = g / (H W), which ATen computes as g times the reciprocal of
  // the count; term = 1 - dot.
  const float inv_count = __fdiv_rn(1.f, (float)m.h * (float)m.w);
  const float s = g_normal ? -__fmul_rn(__ldg(g_normal), inv_count) : -0.f;
  const float gd = g_dist ? __fmul_rn(__ldg(g_dist), inv_count) : 0.f;
  stage_points<kTy + 4, kTx + 4>(m, v, y0 - 2, x0 - 2, pts);
  __syncthreads();

  for (int i = threadIdx.x; i < (kTy + 2) * (kTx + 2); i += kThreads) {
    const int ly = i / (kTx + 2), lx = i % (kTx + 2);
    const int y = y0 - 1 + ly, x = x0 - 1 + lx;
    float* a = adj[ly][lx];
#pragma unroll
    for (int j = 0; j < 9; ++j) a[j] = 0.f;
    if (!interior(m, y, x)) continue;
    float dx[3], dy[3], c[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      dx[j] = __fsub_rn(pts[ly + 2][lx + 1][j], pts[ly][lx + 1][j]);
      dy[j] = __fsub_rn(pts[ly + 1][lx + 2][j], pts[ly + 1][lx][j]);
    }
    cross(dx, dy, c);
    const float nrm = norm3(c);
    const float den = clamp_min(nrm, kNormFloor);
    const float alpha = m.at(y, x, kAlpha);
    const float n0 = m.at(y, x, kNormal), n1 = m.at(y, x, kNormal + 1),
                n2 = m.at(y, x, kNormal + 2);
    float n[3], dn[3], dd[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      n[j] = __fdiv_rn(c[j], den);
      a[6 + j] = __fmul_rn(n[j], alpha);
      // d N_s = s (normal R); d n = d N_s alpha.
      dn[j] = __fmul_rn(__fmul_rn(s, row_times(n0, n1, n2, v.R, j)), alpha);
      // d den = sum -dn ((c / den) / den): division's backward.
      dd[j] = __fmul_rn(-dn[j], __fdiv_rn(n[j], den));
    }
    const float dden = sum3(dd[0], dd[1], dd[2]);
    // The floor passes the gradient where |c| >= 1e-12; the norm's backward
    // is c / |c|, zero at |c| = 0.
    const float dnorm_over = nrm >= kNormFloor ? __fdiv_rn(dden, nrm) : 0.f;
    float dc[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) dc[j] = __fadd_rn(__fdiv_rn(dn[j], den), __fmul_rn(c[j], dnorm_over));
    cross(dy, dc, a);      // d dx = dy x dc
    cross(dc, dx, a + 3);  // d dy = dc x dx
  }
  __syncthreads();

  const int tx = threadIdx.x % kTx, ty = threadIdx.x / kTx;
  const int x = x0 + tx, y = y0 + ty;
  if (!inside(m, y, x)) return;
  // P(y, x) enters dx of (y - 1, x) with +, of (y + 1, x) with -, and dy of
  // (y, x - 1) with +, of (y, x + 1) with -; summed in the order autograd
  // adds the four slices' gradients (the last slice taken first).
  float gp[3];
#pragma unroll
  for (int j = 0; j < 3; ++j)
    gp[j] = __fadd_rn(__fsub_rn(__fsub_rn(adj[ty + 1][tx][3 + j], adj[ty + 1][tx + 2][3 + j]),
                                adj[ty + 2][tx + 1][j]),
                      adj[ty][tx + 1][j]);
  const float g0 = row_times_t(gp[0], gp[1], gp[2], v.R, 0);
  const float g1 = row_times_t(gp[0], gp[1], gp[2], v.R, 1);
  const float g2 = row_times_t(gp[0], gp[1], gp[2], v.R, 2);
  // The three stacked columns' gradients, in autograd's order: z, y, x.
  float dsurf = __fadd_rn(__fadd_rn(g2, __fmul_rn(g1, ray(y, v.cy, v.fy))),
                          __fmul_rn(g0, ray(x, v.cx, v.fx)));
  if (m.blend) dsurf = __fmul_rn(dsurf, m.omr);
  const float depth = m.at(y, x, kDepth), alpha = m.at(y, x, kAlpha);
  const float ca = clamp_min(alpha, kAlphaFloor);
  const float d_depth = __fdiv_rn(dsurf, ca);
  const float d_alpha =
      alpha >= kAlphaFloor ? __fmul_rn(-dsurf, __fdiv_rn(__fdiv_rn(depth, ca), ca)) : 0.f;
  const float* ns = adj[ty + 1][tx + 1] + 6;
  const float w0 = __fmul_rn(s, ns[0]), w1 = __fmul_rn(s, ns[1]), w2 = __fmul_rn(s, ns[2]);

  float4* out = reinterpret_cast<float4*>(grad + ((int64_t)y * m.w + x) * kRows);
  out[0] = make_float4(0.f, 0.f, 0.f, d_depth);
  out[1] = make_float4(d_alpha, row_times_t(w0, w1, w2, v.R, 0),
                       row_times_t(w0, w1, w2, v.R, 1), row_times_t(w0, w1, w2, v.R, 2));
  out[2] = make_float4(gd, 0.f, 0.f, 0.f);
}

static_assert(kDepth == 3 && kAlpha == 4 && kNormal == 5 && kDist == 8 && kRows == 12,
              "the backward's float4 stores follow the buffer's rows");

Maps make_maps(const void* maps, int64_t sy, int64_t sx, int64_t sc, int h, int w,
               double depth_ratio) {
  Maps m;
  m.base = (const float*)maps;
  m.sy = sy;
  m.sx = sx;
  m.sc = sc;
  m.h = h;
  m.w = w;
  m.blend = depth_ratio != 0.0;
  m.omr = (float)(1.0 - depth_ratio);
  m.r = (float)depth_ratio;
  return m;
}

dim3 grid_of(int h, int w) { return dim3((w + kTx - 1) / kTx, (h + kTy - 1) / kTy); }

}  // namespace

// The number of double pairs the forward's `partial` scratch holds.
extern "C" int64_t gs_surfel_terms_blocks(int h, int w) {
  const dim3 g = grid_of(h, w);
  return (int64_t)g.x * g.y;
}

// maps: the (h, w, 12) float32 buffer with strides (sy, sx, sc) in elements;
// viewmat (4, 4) and K (3, 3) float32 on the device; partial: 2 x
// gs_surfel_terms_blocks doubles; ticket: one unsigned int, zero before the
// first launch (the last block sets it back to zero); the two means are
// written to mean_normal and mean_dist.
extern "C" int gs_surfel_terms_fwd(const void* maps, int64_t sy, int64_t sx, int64_t sc, int h,
                                   int w, double depth_ratio, const void* viewmat, const void* K,
                                   void* partial, void* ticket, void* mean_normal,
                                   void* mean_dist, void* stream) {
  if (h < 1 || w < 1) return (int)cudaErrorInvalidValue;
  const Maps m = make_maps(maps, sy, sx, sc, h, w, depth_ratio);
  surfel_terms_fwd_kernel<<<grid_of(h, w), kThreads, 0, (cudaStream_t)stream>>>(
      m, (const float*)viewmat, (const float*)K, (double*)partial, (unsigned int*)ticket,
      (float*)mean_normal, (float*)mean_dist);
  return (int)cudaGetLastError();
}

// g_normal, g_dist: the means' cotangents (0-dim float32 on the device, or
// null for zero); grad: the contiguous (h, w, 12) float32 gradient, 16-byte
// aligned, every element written.
extern "C" int gs_surfel_terms_bwd(const void* maps, int64_t sy, int64_t sx, int64_t sc, int h,
                                   int w, double depth_ratio, const void* viewmat, const void* K,
                                   const void* g_normal, const void* g_dist, void* grad,
                                   void* stream) {
  if (h < 1 || w < 1 || ((uintptr_t)grad & 15u)) return (int)cudaErrorInvalidValue;
  const Maps m = make_maps(maps, sy, sx, sc, h, w, depth_ratio);
  surfel_terms_bwd_kernel<<<grid_of(h, w), kThreads, 0, (cudaStream_t)stream>>>(
      m, (const float*)viewmat, (const float*)K, (const float*)g_normal, (const float*)g_dist,
      (float*)grad);
  return (int)cudaGetLastError();
}
