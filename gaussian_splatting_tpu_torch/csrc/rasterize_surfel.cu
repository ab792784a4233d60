// rasterize_surfel: the forward and backward sweeps of 2D Gaussian Splatting
// (surfels, ops/surfel.py), one block per tile and one thread per pixel.
//
// Replaces no TPU kernel: the JAX package has no surfels. Contract:
// ops/surfel.py (surfel_fwd / surfel_bwd and their plain versions). Tile t
// sweeps its segment [tile_starts[t], +counts[t]) of two (16, soa_cols) SoAs
// in chunks of `chunk` entries: soa_a rows [cx, cy, T_u1, T_u2, T_v1, T_v2,
// T_w1, T_w2, T_w3, o, 1, id], soa_b rows [r, g, b, nx, ny, nz, ca, cb, cc]
// (the binning ellipse's conic, which the warp cull tests).
//
// Per (pixel, entry), eval_surfel: with (dx, dy) the pixel centre minus c,
// k = dx T_w - T_u, l = dy T_w - T_v, p = k x l, (u, v) = (p1, p2) / p3,
// rho3 = u^2 + v^2, rho2 = 2 (dx^2 + dy^2) (the screen filter, sigma =
// sqrt(2) / 2), rho = rho3 where rho3 <= rho2 else rho2, alpha = min(o
// e^(-rho / 2), 0.999); the entry's depth z = u T_w1 + v T_w2 + T_w3 where
// rho3 <= rho2, else T_w3; the entry contributes where p3 != 0, z >= 0.2 and
// o e^(-rho / 2) >= 1/255. Every operation of it is an explicit
// round-to-nearest intrinsic, in the plain version's order, so the forward
// and the backward take the same stop decisions bit for bit; the stop rule
// and the running product are raster_common.cuh's, chunk by chunk as the
// static kernels carry them.
//
// The forward writes out[t] = (12, P) rows [r, g, b, sum w z, sum w, sum w
// n (3), the distortion sum_i w_i (m_i^2 A_i + M2_i - 2 m_i M1_i), the
// median depth, M1, M2], A_i, M1_i = sum_{j<i} w_j m_j and M2_i the sums
// before entry i, m = f / (f - n) (1 - n / z) with n 0.2 and f 100; the
// median depth is the z of the last contributing entry whose transmittance
// before it exceeds 0.5.
//
// The backward reads the cotangent of rows 0-8 and, of the forward's
// output, the pixel's final A, M1, M2 (the distortion is A M2 - M1^2, so its
// gradient of w_i is M2 + A m_i^2 - 2 M1 m_i and of m_i 2 w_i (A m_i - M1)),
// recomputes the forward's alphas and stop rule, and appends one column an
// entry to each half of grad (32, grad_cap): rows 0-15 [id, dcx, dcy, dT (7),
// do, 0 x 5], rows 16-31 [id, dr, dg, db, dn (3), 0 x 9], each summed over the
// tile's pixels. Appending, the drop count and the sentinel tail are the
// static backward's (raster_tiles.cuh).
//
// Bound on the H100: at the 1080p cell's density the per-pair arithmetic:
// ~75 float32 operations forward and ~190 backward for each pair that
// carries anything (two divisions and one expf among them), against ~80 B
// of SoA an entry and a tile's per-pixel rows. Design: the static kernels'
// (raster_tiles.cuh) with a stage of up to 256 entries of 20 rows (21 with
// the id), a warp cull by the binning ellipse (exact: the ellipse holds
// every pixel an entry reaches with alpha >= 1/255, ops/surfel.py), and the
// sixteen per-entry sums reduced over the warp by the transposed butterfly
// (16 values, 15 shuffles) before one shared atomicAdd a lane.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "raster_tiles.cuh"

namespace gs {
namespace {

constexpr int kSurfOut = 12;       // output rows a pixel
constexpr int kRowsA = 10;         // staged from soa_a: cx cy T(7) o
constexpr int kRowsB = 9;          // staged from soa_b: r g b n(3) ca cb cc
constexpr int kSGate = kRowsA + kRowsB;  // staged row of the cull threshold
constexpr int kSId = kSGate + 1;   // staged row of the id (backward)
constexpr int kSFwdRows = kSGate + 1;
constexpr int kSBwdRows = kSId + 1;
constexpr int kSGrad = 16;         // per-entry gradient sums
constexpr int kSStage = 256;       // entries staged at a time
constexpr float kNear = 0.2f;
constexpr float kMScale = (float)(100.0 / (100.0 - 0.2));
constexpr float kFilterInvSq = 2.0f;

__host__ __device__ constexpr int s_stage(int chunk) { return chunk < kSStage ? chunk : kSStage; }
__host__ __device__ constexpr size_t s_fwd_smem(int chunk) {
  return (size_t)kSFwdRows * s_stage(chunk) * sizeof(float);
}
__host__ __device__ constexpr size_t s_bwd_smem(int chunk) {
  return ((size_t)kSBwdRows * s_stage(chunk) + (size_t)kSGrad * (s_stage(chunk) | 1)) *
         sizeof(float);
}

struct SEntry {
  float dx, dy, k1, k2, k3, l1, l2, l3, p3, u, v, vis, araw, alpha, z;
  bool disc, contrib;
};

// ops/surfel.py::_eval, operation for operation; e holds the staged rows
// cx cy T_u1 T_u2 T_v1 T_v2 T_w1 T_w2 T_w3 o at stride S.
__device__ __forceinline__ SEntry eval_surfel(float px, float py, const float* e, int S) {
  const float tw1 = e[6 * S], tw2 = e[7 * S], tw3 = e[8 * S];
  SEntry s;
  s.dx = __fsub_rn(px, e[0]);
  s.dy = __fsub_rn(py, e[S]);
  s.k1 = __fsub_rn(__fmul_rn(s.dx, tw1), e[2 * S]);
  s.k2 = __fsub_rn(__fmul_rn(s.dx, tw2), e[3 * S]);
  s.k3 = __fmul_rn(s.dx, tw3);
  s.l1 = __fsub_rn(__fmul_rn(s.dy, tw1), e[4 * S]);
  s.l2 = __fsub_rn(__fmul_rn(s.dy, tw2), e[5 * S]);
  s.l3 = __fmul_rn(s.dy, tw3);
  const float p1 = __fsub_rn(__fmul_rn(s.k2, s.l3), __fmul_rn(s.k3, s.l2));
  const float p2 = __fsub_rn(__fmul_rn(s.k3, s.l1), __fmul_rn(s.k1, s.l3));
  const float p3 = __fsub_rn(__fmul_rn(s.k1, s.l2), __fmul_rn(s.k2, s.l1));
  const bool hit = p3 != 0.f;
  s.p3 = hit ? p3 : 1.f;
  s.u = __fdiv_rn(p1, s.p3);
  s.v = __fdiv_rn(p2, s.p3);
  const float rho3 = __fadd_rn(__fmul_rn(s.u, s.u), __fmul_rn(s.v, s.v));
  const float rho2 =
      __fmul_rn(kFilterInvSq, __fadd_rn(__fmul_rn(s.dx, s.dx), __fmul_rn(s.dy, s.dy)));
  s.disc = hit && rho3 <= rho2;
  const float rho = s.disc ? rho3 : rho2;
  s.vis = expf(__fmul_rn(-0.5f, rho));
  s.araw = __fmul_rn(e[9 * S], s.vis);
  s.z = s.disc ? __fadd_rn(__fadd_rn(__fmul_rn(s.u, tw1), __fmul_rn(s.v, tw2)), tw3) : tw3;
  s.contrib = hit && s.z >= kNear && s.araw >= kAlphaSkip;
  s.alpha = s.contrib ? fminf(s.araw, kAlphaClamp) : 0.f;
  return s;
}

__device__ __forceinline__ float depth_map(float z) {
  return __fmul_rn(kMScale, __fsub_rn(1.0f, __fdiv_rn(kNear, z)));
}

// Stage the entries [col0, col0 + n), n <= S: soa_a rows 0-9, soa_b rows 0-8,
// the cull threshold and, with the id, soa_a row 11. The threshold is
// raster_tiles.cuh's Q of the binning ellipse, +inf (never skipped) unless
// every staged value is finite, o >= 1/255 and the conic is positive
// definite.
__device__ __forceinline__ void stage_surfels(const float* __restrict__ soa_a,
                                              const float* __restrict__ soa_b, int64_t cols,
                                              int64_t col0, int n, int S, float* sh,
                                              bool with_id) {
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const int64_t col = col0 + k;
    bool ok = true;
#pragma unroll
    for (int r = 0; r < kRowsA; ++r) {
      const float v = soa_a[r * cols + col];
      ok &= isfinite(v);
      sh[r * S + k] = v;
    }
#pragma unroll
    for (int r = 0; r < kRowsB; ++r) {
      const float v = soa_b[r * cols + col];
      ok &= isfinite(v);
      sh[(kRowsA + r) * S + k] = v;
    }
    const float op = sh[9 * S + k];
    const float ca = sh[16 * S + k], cb = sh[17 * S + k], cc = sh[18 * S + k];
    const float det = __fsub_rn(__fmul_rn(ca, cc), __fmul_rn(cb, cb));
    ok &= op >= kAlphaSkip && ca > 0.f && cc > 0.f && det > 0.f;
    sh[kSGate * S + k] =
        ok ? __fmul_rn(2.f, __fadd_rn(logf(__fmul_rn(255.f, op)), 1e-3f)) : INFINITY;
    if (with_id) sh[kSId * S + k] = soa_a[11 * cols + col];
  }
}

__device__ __forceinline__ unsigned surfel_hits(const Pixel& q, const float* sh, int S, int g,
                                                int n) {
  const int k = g + (threadIdx.x & 31);
  const bool hit = k < n && warp_may_hit(q, sh[k], sh[S + k], sh[16 * S + k], sh[17 * S + k],
                                         sh[18 * S + k], sh[kSGate * S + k]);
  return __ballot_sync(kFull, hit);
}

struct SurfAcc {
  float r = 0.f, g = 0.f, b = 0.f, d = 0.f, a = 0.f, nx = 0.f, ny = 0.f, nz = 0.f;
  float dist = 0.f, med = 0.f, m1 = 0.f, m2 = 0.f;
};

__device__ __forceinline__ void fwd_stage_s(const float* __restrict__ soa_a,
                                            const float* __restrict__ soa_b, int64_t cols,
                                            int64_t col0, int n, int S, float* sh,
                                            const Pixel& q, float tc, float* prod_io,
                                            bool* done_io, SurfAcc* acc) {
  stage_surfels(soa_a, soa_b, cols, col0, n, S, sh, false);
  __syncthreads();
  float prod = *prod_io;
  bool done = *done_io;
  for (int g = 0; g < n && !__all_sync(kFull, done); g += 32) {
    unsigned hits = surfel_hits(q, sh, S, g, n);
    if (done) continue;
    while (hits) {
      const int k = g + __ffs(hits) - 1;
      hits &= hits - 1;
      const SEntry e = eval_surfel(q.px, q.py, sh + k, S);
      const float prod_next = next_prod(prod, e.alpha);
      if (!entry_counts(tc, prod_next)) {
        done = true;
        break;
      }
      if (e.contrib) {
        const float t_before = __fmul_rn(tc, prod);
        const float w = __fmul_rn(__fmul_rn(e.alpha, tc), prod);
        const float m = depth_map(e.z);
        const float wm = __fmul_rn(w, m);
        acc->dist = __fmaf_rn(w, __fsub_rn(__fadd_rn(__fmul_rn(__fmul_rn(m, m), acc->a), acc->m2),
                                           __fmul_rn(__fmul_rn(2.f, m), acc->m1)),
                              acc->dist);
        acc->r = __fmaf_rn(w, sh[10 * S + k], acc->r);
        acc->g = __fmaf_rn(w, sh[11 * S + k], acc->g);
        acc->b = __fmaf_rn(w, sh[12 * S + k], acc->b);
        acc->nx = __fmaf_rn(w, sh[13 * S + k], acc->nx);
        acc->ny = __fmaf_rn(w, sh[14 * S + k], acc->ny);
        acc->nz = __fmaf_rn(w, sh[15 * S + k], acc->nz);
        acc->d = __fmaf_rn(w, e.z, acc->d);
        acc->a = __fadd_rn(acc->a, w);
        acc->m1 = __fadd_rn(acc->m1, wm);
        acc->m2 = __fmaf_rn(wm, m, acc->m2);
        if (t_before > 0.5f) acc->med = e.z;
      }
      prod = prod_next;
    }
  }
  *prod_io = prod;
  *done_io = done;
}

__global__ void surfel_fwd_kernel(const int* __restrict__ tile_starts,
                                  const int* __restrict__ counts,
                                  const float* __restrict__ soa_a,
                                  const float* __restrict__ soa_b, int64_t cols,
                                  float* __restrict__ out, int ts, int ntx, int chunk) {
  extern __shared__ float sh[];
  const int t = blockIdx.x;
  const int64_t start = tile_starts[t];
  const int count = counts[t];
  const Pixel q = tile_pixel(t, ntx, ts);
  const int S = s_stage(chunk);
  float tcar = 1.0f;
  SurfAcc acc;
  for (int base = 0; base < count; base += chunk) {
    const int n = min(chunk, count - base);
    const float tc = tcar;
    float prod = 1.0f;
    bool done = false;
    for (int s0 = 0; s0 < n; s0 += S) {
      if (s0 == 0)
        __syncthreads();  // the previous chunk is no longer read
      else if (__syncthreads_and(done))
        break;  // the previous stage is no longer read, and no pixel is left in the chunk
      fwd_stage_s(soa_a, soa_b, cols, start + base + s0, min(S, n - s0), S, sh, q, tc, &prod,
                  &done, &acc);
    }
    tcar = __fmul_rn(tc, prod);
  }
  const int P = blockDim.x;
  float* o = out + (int64_t)t * kSurfOut * P + q.p;
  const float v[kSurfOut] = {acc.r,  acc.g,    acc.b,   acc.d,  acc.a,  acc.nx,
                             acc.ny, acc.nz, acc.dist, acc.med, acc.m1, acc.m2};
#pragma unroll
  for (int r = 0; r < kSurfOut; ++r) o[r * P] = v[r];
}

// The warp's sums of v[0..16): lane 2r returns the sum of v[r].
__device__ __forceinline__ float warp_sum16(const float (&v)[kSGrad]) {
  const int lane = threadIdx.x & 31;
  float a[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) a[i] = v[i];
  scatter_step<8>(a, lane);
  scatter_step<4>(a, lane);
  scatter_step<2>(a, lane);
  scatter_step<1>(a, lane);
  return a[0] + __shfl_xor_sync(kFull, a[0], 1);
}

// One pixel's cotangents of rows 0-8, its final A, M1, M2 and Q = sum_k gw_k
// w_k = sum_c<8 gout_c fout_c + 2 g_L (A M2 - M1^2).
struct SBwdPixel {
  float g[9];
  float A, M1, M2, q;
};

__device__ __forceinline__ SBwdPixel s_bwd_pixel(const float* __restrict__ gout,
                                                 const float* __restrict__ fout, int t, int p) {
  const int P = blockDim.x;
  const float* g = gout + (int64_t)t * kSurfOut * P + p;
  const float* f = fout + (int64_t)t * kSurfOut * P + p;
  SBwdPixel b;
#pragma unroll
  for (int c = 0; c < 9; ++c) b.g[c] = g[c * P];
  b.A = f[4 * P];
  b.M1 = f[10 * P];
  b.M2 = f[11 * P];
  float qs = 0.f;
#pragma unroll
  for (int c = 0; c < 8; ++c) qs += b.g[c] * f[c * P];
  b.q = qs + 2.0f * b.g[8] * (b.A * b.M2 - b.M1 * b.M1);
  return b;
}

__device__ __forceinline__ void bwd_stage_s(const float* __restrict__ soa_a,
                                            const float* __restrict__ soa_b, int64_t cols,
                                            int64_t col0, int n, int S, float* sh, int* s_base,
                                            const Pixel& q, const SBwdPixel& gp, float tc,
                                            float* prod_io, bool* done_io, float* pc_io,
                                            float* __restrict__ grad, int64_t grad_cap,
                                            int* __restrict__ cursor) {
  const int P = blockDim.x;
  const int lane = threadIdx.x & 31;
  const int as = S | 1;
  float* acc = sh + kSBwdRows * S;
  __syncthreads();  // the previous stage's rows and sums are no longer read
  stage_surfels(soa_a, soa_b, cols, col0, n, S, sh, true);
  for (int k = threadIdx.x; k < n; k += P) {
#pragma unroll
    for (int r = 0; r < kSGrad; ++r) acc[r * as + k] = 0.f;
  }
  __syncthreads();

  float prod = *prod_io;
  bool done = *done_io;
  float pc = *pc_io;
  for (int g = 0; g < n && !__all_sync(kFull, done); g += 32) {
    unsigned hits = surfel_hits(q, sh, S, g, n);
    while (hits) {
      const int k = g + __ffs(hits) - 1;
      hits &= hits - 1;
      float v[kSGrad];
#pragma unroll
      for (int r = 0; r < kSGrad; ++r) v[r] = 0.f;
      bool active = false;
      if (!done) {
        const SEntry e = eval_surfel(q.px, q.py, sh + k, S);
        const float prod_next = next_prod(prod, e.alpha);
        if (!entry_counts(tc, prod_next)) {
          done = true;
        } else {
          if (e.contrib) {
            const float tw1 = sh[6 * S + k], tw2 = sh[7 * S + k], tw3 = sh[8 * S + k];
            const float cr = sh[10 * S + k], cg = sh[11 * S + k], cb = sh[12 * S + k];
            const float nx = sh[13 * S + k], ny = sh[14 * S + k], nz = sh[15 * S + k];
            const float t_before = tc * prod;
            const float w = e.alpha * t_before;
            const float m = kMScale * (1.0f - kNear / e.z);
            const float f_l = gp.M2 + gp.A * m * m - 2.0f * gp.M1 * m;
            const float gw = gp.g[0] * cr + gp.g[1] * cg + gp.g[2] * cb + gp.g[3] * e.z +
                             gp.g[4] + gp.g[5] * nx + gp.g[6] * ny + gp.g[7] * nz +
                             gp.g[8] * f_l;
            pc += gw * w;
            const float d_alpha = gw * t_before - (gp.q - pc) / (1.0f - e.alpha);
            const bool gate = e.araw <= kAlphaClamp;
            const float d_rho = gate ? -0.5f * d_alpha * e.araw : 0.f;
            const float dz = w * (gp.g[3] + gp.g[8] * 2.0f * (gp.A * m - gp.M1) * kMScale * kNear /
                                                (e.z * e.z));
            float dk1 = 0.f, dk2 = 0.f, dk3 = 0.f, dl1 = 0.f, dl2 = 0.f, dl3 = 0.f;
            float d_rho2 = d_rho, dtw1 = 0.f, dtw2 = 0.f;
            if (e.disc) {
              d_rho2 = 0.f;
              const float du = 2.0f * e.u * d_rho + dz * tw1;
              const float dv = 2.0f * e.v * d_rho + dz * tw2;
              const float dp1 = du / e.p3, dp2 = dv / e.p3;
              const float dp3 = -(du * e.u + dv * e.v) / e.p3;
              dk1 = e.l2 * dp3 - e.l3 * dp2;
              dk2 = e.l3 * dp1 - e.l1 * dp3;
              dk3 = e.l1 * dp2 - e.l2 * dp1;
              dl1 = dp2 * e.k3 - dp3 * e.k2;
              dl2 = dp3 * e.k1 - dp1 * e.k3;
              dl3 = dp1 * e.k2 - dp2 * e.k1;
              dtw1 = dz * e.u;
              dtw2 = dz * e.v;
            }
            const float ddx = tw1 * dk1 + tw2 * dk2 + tw3 * dk3 +
                              2.0f * kFilterInvSq * e.dx * d_rho2;
            const float ddy = tw1 * dl1 + tw2 * dl2 + tw3 * dl3 +
                              2.0f * kFilterInvSq * e.dy * d_rho2;
            v[0] = -ddx;
            v[1] = -ddy;
            v[2] = -dk1;
            v[3] = -dk2;
            v[4] = -dl1;
            v[5] = -dl2;
            v[6] = dtw1 + e.dx * dk1 + e.dy * dl1;
            v[7] = dtw2 + e.dx * dk2 + e.dy * dl2;
            v[8] = dz + e.dx * dk3 + e.dy * dl3;
            v[9] = gate ? d_alpha * e.vis : 0.f;
            v[10] = w * gp.g[0];
            v[11] = w * gp.g[1];
            v[12] = w * gp.g[2];
            v[13] = w * gp.g[5];
            v[14] = w * gp.g[6];
            v[15] = w * gp.g[7];
            active = true;
          }
          prod = prod_next;
        }
      }
      if (__any_sync(kFull, active)) {
        const float s = warp_sum16(v);
        if (!(lane & 1)) atomicAdd(&acc[(lane >> 1) * as + k], s);
      }
      if (__all_sync(kFull, done)) break;
    }
  }
  *prod_io = prod;
  *done_io = done;
  *pc_io = pc;
  __syncthreads();  // every warp's sums are in

  if (threadIdx.x == 0) *s_base = atomicAdd(cursor, n);
  __syncthreads();
  float* grad_b = grad + 16 * grad_cap;
  for (int k = threadIdx.x; k < n; k += P) {
    const int64_t pos = (int64_t)*s_base + k;
    if (pos >= grad_cap) continue;
    const float id = sh[kSId * S + k];
    grad[pos] = id;
    grad_b[pos] = id;
#pragma unroll
    for (int r = 0; r < 10; ++r) grad[(r + 1) * grad_cap + pos] = acc[r * as + k];
#pragma unroll
    for (int r = 11; r < 16; ++r) grad[r * grad_cap + pos] = 0.f;
#pragma unroll
    for (int r = 0; r < 6; ++r) grad_b[(r + 1) * grad_cap + pos] = acc[(10 + r) * as + k];
#pragma unroll
    for (int r = 7; r < 16; ++r) grad_b[r * grad_cap + pos] = 0.f;
  }
}

__global__ void surfel_bwd_kernel(const int* __restrict__ tile_starts,
                                  const int* __restrict__ counts,
                                  const float* __restrict__ soa_a,
                                  const float* __restrict__ soa_b, int64_t cols,
                                  const float* __restrict__ gout,
                                  const float* __restrict__ fout, float* __restrict__ grad,
                                  int64_t grad_cap, int* __restrict__ cursor, int ts, int ntx,
                                  int chunk) {
  extern __shared__ float sh[];
  __shared__ int s_base;
  const int t = blockIdx.x;
  const int64_t start = tile_starts[t];
  const int count = counts[t];
  const Pixel q = tile_pixel(t, ntx, ts);
  const SBwdPixel gp = s_bwd_pixel(gout, fout, t, q.p);
  const int S = s_stage(chunk);
  float tcar = 1.0f;
  float pcar = 0.0f;
  for (int base = 0; base < count; base += chunk) {
    const int n = min(chunk, count - base);
    const float tc = tcar;
    float prod = 1.0f;
    bool done = false;
    for (int s0 = 0; s0 < n; s0 += S)
      bwd_stage_s(soa_a, soa_b, cols, start + base + s0, min(S, n - s0), S, sh, &s_base, q, gp,
                  tc, &prod, &done, &pcar, grad, grad_cap, cursor);
    tcar = __fmul_rn(tc, prod);
  }
}

}  // namespace
}  // namespace gs

// tile_starts: (n_tiles + 1,) int32; counts: (n_tiles,) int32; soa_a, soa_b:
// (16, cols) float32; out: (n_tiles, 12, ts * ts) float32.
extern "C" int gs_surfel_fwd(const void* tile_starts, const void* counts, const void* soa_a,
                             const void* soa_b, int64_t cols, void* out, int n_tiles, int ts,
                             int ntx, int chunk, void* stream) {
  if (n_tiles == 0) return (int)cudaGetLastError();
  const size_t smem = gs::s_fwd_smem(chunk);
  cudaError_t err = cudaFuncSetAttribute(gs::surfel_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  gs::surfel_fwd_kernel<<<n_tiles, ts * ts, smem, (cudaStream_t)stream>>>(
      (const int*)tile_starts, (const int*)counts, (const float*)soa_a, (const float*)soa_b,
      cols, (float*)out, ts, ntx, chunk);
  return (int)cudaGetLastError();
}

// gout, fout: (n_tiles, 12, ts * ts) float32; grad: (32, grad_cap) float32,
// grad_cap a multiple of chunk; meta: (3,) int32, zeroed here, = [n_written,
// n_dropped, appended].
extern "C" int gs_surfel_bwd(const void* tile_starts, const void* counts, const void* soa_a,
                             const void* soa_b, int64_t cols, const void* gout,
                             const void* fout, void* grad, int64_t grad_cap, void* meta,
                             int n_tiles, int ts, int ntx, int chunk, float sentinel,
                             void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(meta, 0, 3 * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  if (n_tiles > 0) {
    const size_t smem = gs::s_bwd_smem(chunk);
    err = cudaFuncSetAttribute(gs::surfel_bwd_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    gs::surfel_bwd_kernel<<<n_tiles, ts * ts, smem, s>>>(
        (const int*)tile_starts, (const int*)counts, (const float*)soa_a, (const float*)soa_b,
        cols, (const float*)gout, (const float*)fout, (float*)grad, grad_cap, (int*)meta + 2,
        ts, ntx, chunk);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  // Both halves' tails: sentinel ids, zero payload, the same meta twice.
  gs::rasterize_bwd_tail_kernel<<<1, 256, 0, s>>>((float*)grad, grad_cap, (int*)meta, chunk,
                                                  sentinel);
  gs::rasterize_bwd_tail_kernel<<<1, 256, 0, s>>>((float*)grad + 16 * grad_cap, grad_cap,
                                                  (int*)meta, chunk, sentinel);
  return (int)cudaGetLastError();
}
