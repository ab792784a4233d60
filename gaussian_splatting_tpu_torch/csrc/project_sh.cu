// project_sh: projection + SH shading of every slot for one view, forward and
// backward (the view held fixed).
//
// Replaces no TPU kernel: the JAX package computes this layer as plain jnp
// under jax.grad (gaussian_splatting_tpu/ops/projection.py::project_gaussians,
// core/sh.py::sh_to_color, the activations in ops/render.py). Added because on
// the H100 the same layer in PyTorch ran some 200 elementwise kernels forward
// and autograd's graph of them backward over every slot of the buffer, each
// reading and writing its (N,) columns, the largest share of a training
// step's device time (PERF.md).
//
// Contract: ops/project_sh.py. The forward writes what project_shade_plain
// returns: means2d (N, 2), depths, conics (N, 3), radii int32, compensations,
// colors (N, 3), opacities, each slot's arithmetic in project_gaussians'
// order. This source is built with -fmad=false (ops/_build.py), so every
// product and sum rounds as PyTorch's elementwise kernels round them and the
// radii, which decide the binning, come out equal. The backward takes the
// cotangents of the six float outputs (a null pointer is a zero cotangent)
// and writes the gradients of means, quats, log-scales, logit opacities and
// the (N, K, 3) SH coefficients, each once: project_shade_bwd_plain's
// formulas, which recompute the forward's intermediates from the inputs.
//
// Bound on the H100: bytes. The forward reads 44 B of a slot's parameters and
// (degree + 1)^2 x 12 B of SH (192 B at degree 3) and writes 48 B; the
// backward reads the parameters, up to 44 B of cotangents and the SH rows of
// the slots whose colour cotangent is not zero, and writes 44 + 12 K B of
// gradients. One thread takes one slot and keeps the whole chain in
// registers. The SH rows, 80 % of the bytes, are not read one row a thread
// (192 B strides): a block of 128 slots stages its rows through shared memory
// with coalesced 16-byte loads, rows padded to an odd stride so that each
// thread's row reads are free of bank conflicts, and the SH gradient rows go
// back out the same way, zeros beyond the active degree included.
//
// Offsets (Deformable 3D Gaussians, models/deform.py): optional (N, 3) dx,
// (N, 4) dr and (N, 3) ds added after the activations, mean + dx, exp(log s)
// + ds and normalize(q) + dr (the rotation normalizes that sum again). A
// template flag kDef takes them: the static instances (no offsets) are the
// code they were. The backward writes the gradients of dr and ds too; the
// gradient of dx is the mean's, which it writes once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr float kEps2d = 0.3f;

constexpr float kC0 = 0.28209479177387814f;
constexpr float kC1 = 0.4886025119029199f;
constexpr float kC20 = 1.0925484305920792f, kC21 = -1.0925484305920792f,
                kC22 = 0.31539156525252005f, kC23 = -1.0925484305920792f,
                kC24 = 0.5462742152960396f;
constexpr float kC30 = -0.5900435899266435f, kC31 = 2.890611442640554f,
                kC32 = -0.4570457994644658f, kC33 = 0.3731763325901154f,
                kC34 = -0.4570457994644658f, kC35 = 1.445305721320277f,
                kC36 = -0.5900435899266435f;

struct Cam {
  float r[9];          // world-to-camera rotation, row-major
  float t[3];
  float fx, fy, cx, cy;
  float lim_x, lim_y;  // the frustum clamp of x/z and y/z
  float pos[3];        // camera centre -R^T t
};

__device__ void load_cam(const float* __restrict__ view, const float* __restrict__ K,
                         float width, float height, Cam& c) {
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) c.r[3 * i + j] = view[4 * i + j];
    c.t[i] = view[4 * i + 3];
  }
  c.fx = K[0];
  c.cx = K[2];
  c.fy = K[4];
  c.cy = K[5];
  // tan_fovx = 0.5 * width / fx evaluates in PyTorch as reciprocal(fx) *
  // (0.5 * width); lim_x = 1.3 * tan_fovx.
  c.lim_x = (1.0f / c.fx) * (0.5f * width) * 1.3f;
  c.lim_y = (1.0f / c.fy) * (0.5f * height) * 1.3f;
  for (int i = 0; i < 3; ++i)
    c.pos[i] = -(c.r[i] * c.t[0] + c.r[3 + i] * c.t[1] + c.r[6 + i] * c.t[2]);
}

// The first kRow floats of the rows [base, base + rows) of the SH array (row
// stride k3 floats) into s, row r at r * kStride; a row whose need[r] is false
// is skipped (need null: every row).
template <int kRow, int kStride>
__device__ __forceinline__ void stage_in(const float* __restrict__ sh, int k3, int base, int rows,
                                         bool vec, const bool* need, float* s) {
  if constexpr (kRow % 4 == 0) {
    if (vec) {
      constexpr int kQ = kRow / 4;  // float4s a row
#pragma unroll
      for (int j = 0; j < kQ; ++j) {
        const int f = threadIdx.x + j * kThreads;
        const int r = f / kQ, q = f - r * kQ;
        if (r < rows && (need == nullptr || need[r])) {
          const float4* src = reinterpret_cast<const float4*>(sh + (int64_t)(base + r) * k3);
          const float4 v = __ldg(src + q);
          float* d = s + r * kStride + 4 * q;
          d[0] = v.x;
          d[1] = v.y;
          d[2] = v.z;
          d[3] = v.w;
        }
      }
      return;
    }
  }
#pragma unroll 4
  for (int j = 0; j < kRow; ++j) {
    const int e = threadIdx.x + j * kThreads;
    const int r = e / kRow, col = e - r * kRow;
    if (r < rows && (need == nullptr || need[r]))
      s[r * kStride + col] = __ldg(sh + (int64_t)(base + r) * k3 + col);
  }
}

// The rows [base, base + rows) of the (n, k3) SH gradient from s (row r at
// r * kStride, its first kRow floats; the rest of a row is zero): the block's
// rows are contiguous in the output, written in consecutive float4s.
template <int kRow, int kStride>
__device__ __forceinline__ void stage_out(float* __restrict__ g, int k3, int base, int rows,
                                          bool vec, const float* s) {
  float* out = g + (int64_t)base * k3;
  if (vec) {
    const int q3 = k3 / 4, total = rows * q3;
    for (int f = threadIdx.x; f < total; f += kThreads) {
      const int r = f / q3, col = 4 * (f - r * q3);
      const float* src = s + r * kStride + col;
      float4 v;
      v.x = col + 0 < kRow ? src[0] : 0.f;
      v.y = col + 1 < kRow ? src[1] : 0.f;
      v.z = col + 2 < kRow ? src[2] : 0.f;
      v.w = col + 3 < kRow ? src[3] : 0.f;
      reinterpret_cast<float4*>(out)[f] = v;
    }
    return;
  }
  const int total = rows * k3;
  for (int e = threadIdx.x; e < total; e += kThreads) {
    const int r = e / k3, col = e - r * k3;
    out[e] = col < kRow ? s[r * kStride + col] : 0.f;
  }
}

// SH basis k of core/sh.py::eval_sh at the unit direction (x, y, z), and its
// gradient.
__device__ __forceinline__ void basis(int k, float x, float y, float z, float& B, float& bx,
                                      float& by, float& bz) {
  const float xx = x * x, yy = y * y, zz = z * z;
  switch (k) {
    case 0: B = kC0; bx = 0.f; by = 0.f; bz = 0.f; break;
    case 1: B = -kC1 * y; bx = 0.f; by = -kC1; bz = 0.f; break;
    case 2: B = kC1 * z; bx = 0.f; by = 0.f; bz = kC1; break;
    case 3: B = -kC1 * x; bx = -kC1; by = 0.f; bz = 0.f; break;
    case 4: B = kC20 * x * y; bx = kC20 * y; by = kC20 * x; bz = 0.f; break;
    case 5: B = kC21 * y * z; bx = 0.f; by = kC21 * z; bz = kC21 * y; break;
    case 6:
      B = kC22 * (2.f * zz - xx - yy); bx = -2.f * kC22 * x; by = -2.f * kC22 * y;
      bz = 4.f * kC22 * z; break;
    case 7: B = kC23 * x * z; bx = kC23 * z; by = 0.f; bz = kC23 * x; break;
    case 8: B = kC24 * (xx - yy); bx = 2.f * kC24 * x; by = -2.f * kC24 * y; bz = 0.f; break;
    case 9:
      B = kC30 * y * (3.f * xx - yy); bx = 6.f * kC30 * x * y; by = 3.f * kC30 * (xx - yy);
      bz = 0.f; break;
    case 10:
      B = kC31 * x * y * z; bx = kC31 * y * z; by = kC31 * x * z; bz = kC31 * x * y; break;
    case 11:
      B = kC32 * y * (4.f * zz - xx - yy); bx = -2.f * kC32 * x * y;
      by = kC32 * (4.f * zz - xx - 3.f * yy); bz = 8.f * kC32 * y * z; break;
    case 12:
      B = kC33 * z * (2.f * zz - 3.f * xx - 3.f * yy); bx = -6.f * kC33 * x * z;
      by = -6.f * kC33 * y * z; bz = kC33 * (6.f * zz - 3.f * xx - 3.f * yy); break;
    case 13:
      B = kC34 * x * (4.f * zz - xx - yy); bx = kC34 * (4.f * zz - 3.f * xx - yy);
      by = -2.f * kC34 * x * y; bz = 8.f * kC34 * x * z; break;
    case 14:
      B = kC35 * z * (xx - yy); bx = 2.f * kC35 * x * z; by = -2.f * kC35 * y * z;
      bz = kC35 * (xx - yy); break;
    default:
      B = kC36 * x * (xx - 3.f * yy); bx = 3.f * kC36 * (xx - yy); by = -6.f * kC36 * x * y;
      bz = 0.f; break;
  }
}

// A slot's 3D covariance from its raw quaternion and log-scales, in
// ops/projection.py::compute_cov3d_cols' order, with what the backward needs.
struct Cov3 {
  float q[4];   // the unit quaternion (w, x, y, z)
  float qn;     // |q| before normalizing
  float qinv;   // 1 / max(|q|, 1e-12)
  float r[9];   // rotation, row-major
  float sc[3];  // activated scales
  float v[3];   // squared scales
  float s[6];   // Sigma3: s00 s01 s02 s11 s12 s22
};

// The 3D covariance from a raw quaternion (w, x, y, z), normalized here, and
// activated scales sc.
__device__ __forceinline__ void cov3_core(float w, float x, float y, float z, const float* sc,
                                          Cov3& g) {
  g.qn = sqrtf(w * w + x * x + y * y + z * z);
  g.qinv = 1.0f / fmaxf(g.qn, 1e-12f);
  w = w * g.qinv;
  x = x * g.qinv;
  y = y * g.qinv;
  z = z * g.qinv;
  g.q[0] = w;
  g.q[1] = x;
  g.q[2] = y;
  g.q[3] = z;
  const float xx = x * x, yy = y * y, zz = z * z;
  const float xy = x * y, xz = x * z, yz = y * z;
  const float wx = w * x, wy = w * y, wz = w * z;
  float* r = g.r;
  r[0] = 1.0f - 2.0f * (yy + zz);
  r[1] = 2.0f * (xy - wz);
  r[2] = 2.0f * (xz + wy);
  r[3] = 2.0f * (xy + wz);
  r[4] = 1.0f - 2.0f * (xx + zz);
  r[5] = 2.0f * (yz - wx);
  r[6] = 2.0f * (xz - wy);
  r[7] = 2.0f * (yz + wx);
  r[8] = 1.0f - 2.0f * (xx + yy);
  for (int k = 0; k < 3; ++k) {
    g.sc[k] = sc[k];
    g.v[k] = sc[k] * sc[k];
  }
  const float* v = g.v;
  g.s[0] = r[0] * r[0] * v[0] + r[1] * r[1] * v[1] + r[2] * r[2] * v[2];
  g.s[1] = r[0] * r[3] * v[0] + r[1] * r[4] * v[1] + r[2] * r[5] * v[2];
  g.s[2] = r[0] * r[6] * v[0] + r[1] * r[7] * v[1] + r[2] * r[8] * v[2];
  g.s[3] = r[3] * r[3] * v[0] + r[4] * r[4] * v[1] + r[5] * r[5] * v[2];
  g.s[4] = r[3] * r[6] * v[0] + r[4] * r[7] * v[1] + r[5] * r[8] * v[2];
  g.s[5] = r[6] * r[6] * v[0] + r[7] * r[7] * v[1] + r[8] * r[8] * v[2];
}

// What the offsets' backward needs of the first normalization q1 =
// normalize(q): q1 and 1 / max(|q|, 1e-12), and whether |q| passed the clamp.
struct Quat1 {
  float q[4];
  float qinv;
  bool unclamped;
};

// A slot's covariance: with kDef, from normalize(q) + dr and exp(log s) + ds
// (q1 kept for the backward); without, from q and exp(log s).
template <bool kDef>
__device__ __forceinline__ void cov3(const float* __restrict__ quat, const float* __restrict__ ls,
                                     const float* __restrict__ dr, const float* __restrict__ ds,
                                     Cov3& g, Quat1& q1) {
  float q[4] = {__ldg(quat), __ldg(quat + 1), __ldg(quat + 2), __ldg(quat + 3)};
  float sc[3];
  for (int k = 0; k < 3; ++k) sc[k] = expf(__ldg(ls + k));
  if constexpr (kDef) {
    const float n1 = sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
    q1.qinv = 1.0f / fmaxf(n1, 1e-12f);
    q1.unclamped = n1 >= 1e-12f;
    for (int k = 0; k < 4; ++k) {
      q1.q[k] = q[k] * q1.qinv;
      q[k] = q1.q[k] + __ldg(dr + k);
    }
    for (int k = 0; k < 3; ++k) sc[k] = sc[k] + __ldg(ds + k);
  }
  cov3_core(q[0], q[1], q[2], q[3], sc, g);
}

// cov_cam = W Sigma3 W^T as B = Sigma3 W^T, then W B (upper triangle c00 c01
// c02 c11 c12 c22), in ops/projection.py's order.
__device__ __forceinline__ void cov_cam(const float* W, const float* s, float* c) {
  const float s00 = s[0], s01 = s[1], s02 = s[2], s11 = s[3], s12 = s[4], s22 = s[5];
  const float b00 = s00 * W[0] + s01 * W[1] + s02 * W[2];
  const float b01 = s00 * W[3] + s01 * W[4] + s02 * W[5];
  const float b02 = s00 * W[6] + s01 * W[7] + s02 * W[8];
  const float b10 = s01 * W[0] + s11 * W[1] + s12 * W[2];
  const float b11 = s01 * W[3] + s11 * W[4] + s12 * W[5];
  const float b12 = s01 * W[6] + s11 * W[7] + s12 * W[8];
  const float b20 = s02 * W[0] + s12 * W[1] + s22 * W[2];
  const float b21 = s02 * W[3] + s12 * W[4] + s22 * W[5];
  const float b22 = s02 * W[6] + s12 * W[7] + s22 * W[8];
  c[0] = W[0] * b00 + W[1] * b10 + W[2] * b20;
  c[1] = W[0] * b01 + W[1] * b11 + W[2] * b21;
  c[2] = W[0] * b02 + W[1] * b12 + W[2] * b22;
  c[3] = W[3] * b01 + W[4] * b11 + W[5] * b21;
  c[4] = W[3] * b02 + W[4] * b12 + W[5] * b22;
  c[5] = W[6] * b02 + W[7] * b12 + W[8] * b22;
}

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// The unit view direction of a mean, and |mean - camera centre|.
__device__ __forceinline__ void view_dir(const Cam& cam, const float* m, float* dn, float& nd) {
  const float d0 = m[0] - cam.pos[0], d1 = m[1] - cam.pos[1], d2 = m[2] - cam.pos[2];
  nd = sqrtf(d0 * d0 + d1 * d1 + d2 * d2);
  const float nc = fmaxf(nd, 1e-12f);
  dn[0] = d0 / nc;
  dn[1] = d1 / nc;
  dn[2] = d2 / nc;
}

template <int D, bool kAA, bool kDef>
__global__ void __launch_bounds__(kThreads)
project_sh_fwd_kernel(int n, int k3, bool vec, float width, float height,
                      const float* __restrict__ means, const float* __restrict__ quats,
                      const float* __restrict__ log_scales, const float* __restrict__ logits,
                      const float* __restrict__ sh, const float* __restrict__ view,
                      const float* __restrict__ Kmat, const float* __restrict__ dx,
                      const float* __restrict__ dr, const float* __restrict__ ds,
                      float2* __restrict__ means2d,
                      float* __restrict__ depths, float* __restrict__ conics,
                      int* __restrict__ radii, float* __restrict__ comps,
                      float* __restrict__ colors, float* __restrict__ opac) {
  constexpr int kNb = (D + 1) * (D + 1), kRow = 3 * kNb, kStride = kRow | 1;
  __shared__ float rows_s[kThreads * kStride];
  __shared__ Cam cam;
  const int base = blockIdx.x * kThreads;
  const int rows = min(kThreads, n - base);
  if (threadIdx.x == 0) load_cam(view, Kmat, width, height, cam);
  stage_in<kRow, kStride>(sh, k3, base, rows, vec, nullptr, rows_s);
  __syncthreads();
  if ((int)threadIdx.x >= rows) return;
  const int64_t i = base + threadIdx.x;

  float m[3];
  for (int k = 0; k < 3; ++k) m[k] = __ldg(means + 3 * i + k);
  if constexpr (kDef)
    for (int k = 0; k < 3; ++k) m[k] = m[k] + __ldg(dx + 3 * i + k);
  const float* W = cam.r;
  const float x = W[0] * m[0] + W[1] * m[1] + W[2] * m[2] + cam.t[0];
  const float y = W[3] * m[0] + W[4] * m[1] + W[5] * m[2] + cam.t[1];
  const float z = W[6] * m[0] + W[7] * m[1] + W[8] * m[2] + cam.t[2];
  const float zs = fabsf(z) < 1e-6f ? 1e-6f : z;
  Cov3 g;
  Quat1 q1;
  cov3<kDef>(quats + 4 * i, log_scales + 3 * i, dr + 4 * i, ds + 3 * i, g, q1);
  float c[6];
  cov_cam(W, g.s, c);
  const float tx = zs * fminf(fmaxf(x / zs, -cam.lim_x), cam.lim_x);
  const float ty = zs * fminf(fmaxf(y / zs, -cam.lim_y), cam.lim_y);
  const float rz = 1.0f / zs;
  const float rz2 = rz * rz;
  const float fx = cam.fx, fy = cam.fy;
  const float j00 = fx * rz, j02 = -fx * tx * rz2, j11 = fy * rz, j12 = -fy * ty * rz2;
  const float a = j00 * (j00 * c[0] + j02 * c[2]) + j02 * (j00 * c[2] + j02 * c[5]);
  const float b = j00 * (j11 * c[1] + j12 * c[2]) + j02 * (j11 * c[4] + j12 * c[5]);
  const float cc = j11 * (j11 * c[3] + j12 * c[4]) + j12 * (j11 * c[4] + j12 * c[5]);
  const float det_orig = a * cc - b * b;
  const float A = a + kEps2d, C = cc + kEps2d;
  const float det = A * C - b * b;
  const float det_safe = det <= 0.0f ? 1.0f : det;
  const float comp = sqrtf(fmaxf(det_orig / det_safe, 0.0f));
  const float inv_det = 1.0f / det_safe;
  const float mid = 0.5f * (A + C);
  const float disc = sqrtf(fmaxf(mid * mid - det, 0.01f));
  const float lambda_max = mid + disc;
  const float op = sigmoid(__ldg(logits + i));
  const float s_cut = logf(fmaxf(op, 1e-12f) * 255.0f);
  const float sigma_mult = fminf(sqrtf(2.0f * fmaxf(s_cut, 1e-12f)), 3.0f);
  const float radius_f = ceilf(sigma_mult * sqrtf(fmaxf(lambda_max, 0.0f)));
  const float mean_x = fx * x * rz + cam.cx;
  const float mean_y = fy * y * rz + cam.cy;
  const bool inside = mean_x + radius_f > 0.0f && mean_x - radius_f < width &&
                      mean_y + radius_f > 0.0f && mean_y - radius_f < height;
  const bool valid = z > 0.01f && z < 1e10f && det > 0.0f && inside && radius_f > 0.0f;

  means2d[i] = make_float2(mean_x, mean_y);
  depths[i] = z;
  conics[3 * i] = C * inv_det;
  conics[3 * i + 1] = -b * inv_det;
  conics[3 * i + 2] = A * inv_det;
  radii[i] = valid ? (int)radius_f : 0;
  comps[i] = comp;
  opac[i] = kAA ? op * comp : op;

  float dn[3], nd;
  view_dir(cam, m, dn, nd);
  const float* row = rows_s + threadIdx.x * kStride;
  float col[3] = {0.5f, 0.5f, 0.5f};
#pragma unroll
  for (int k = 0; k < kNb; ++k) {
    float B, bx, by, bz;
    basis(k, dn[0], dn[1], dn[2], B, bx, by, bz);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) col[ch] += B * row[3 * k + ch];
  }
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) colors[3 * i + ch] = fmaxf(col[ch], 0.0f);
}

template <int D, bool kAA, bool kDef>
__global__ void __launch_bounds__(kThreads)
project_sh_bwd_kernel(int n, int k3, bool vec_in, bool vec_out, float width, float height,
                      const float* __restrict__ means, const float* __restrict__ quats,
                      const float* __restrict__ log_scales, const float* __restrict__ logits,
                      const float* __restrict__ sh, const float* __restrict__ view,
                      const float* __restrict__ Kmat, const float* __restrict__ dx,
                      const float* __restrict__ dr, const float* __restrict__ ds,
                      const float* __restrict__ g_means2d,
                      const float* __restrict__ g_depths, const float* __restrict__ g_conics,
                      const float* __restrict__ g_comps, const float* __restrict__ g_colors,
                      const float* __restrict__ g_opac, float* __restrict__ d_means,
                      float* __restrict__ d_quats, float* __restrict__ d_log_scales,
                      float* __restrict__ d_logits, float* __restrict__ d_sh,
                      float* __restrict__ d_dr, float* __restrict__ d_ds) {
  constexpr int kNb = (D + 1) * (D + 1), kRow = 3 * kNb, kStride = kRow | 1;
  __shared__ float rows_s[kThreads * kStride];
  __shared__ Cam cam;
  __shared__ bool need_s[kThreads];
  const int base = blockIdx.x * kThreads;
  const int rows = min(kThreads, n - base);
  const bool here = (int)threadIdx.x < rows;
  const int64_t i = base + threadIdx.x;

  // The colour cotangent decides whether the slot's SH row is read at all:
  // a zero one gives a zero SH gradient and no view-direction term.
  float gcol[3] = {0.f, 0.f, 0.f};
  if (here && g_colors != nullptr)
    for (int ch = 0; ch < 3; ++ch) gcol[ch] = g_colors[3 * i + ch];
  const bool need = gcol[0] != 0.f || gcol[1] != 0.f || gcol[2] != 0.f;
  need_s[threadIdx.x] = need;
  if (threadIdx.x == 0) load_cam(view, Kmat, width, height, cam);
  __syncthreads();
  stage_in<kRow, kStride>(sh, k3, base, rows, vec_in, need_s, rows_s);
  __syncthreads();

  float m[3] = {0.f, 0.f, 0.f}, gd[3] = {0.f, 0.f, 0.f};
  if (here) {
    for (int k = 0; k < 3; ++k) m[k] = __ldg(means + 3 * i + k);
    if constexpr (kDef)
      for (int k = 0; k < 3; ++k) m[k] = m[k] + __ldg(dx + 3 * i + k);
    float* row = rows_s + threadIdx.x * kStride;
    if (need) {
      float dn[3], nd;
      view_dir(cam, m, dn, nd);
      // The clamp max(raw + 0.5, 0) passes its gradient where raw + 0.5 >= 0.
      float raw[3] = {0.5f, 0.5f, 0.5f};
#pragma unroll
      for (int k = 0; k < kNb; ++k) {
        float B, bx, by, bz;
        basis(k, dn[0], dn[1], dn[2], B, bx, by, bz);
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) raw[ch] += B * row[3 * k + ch];
      }
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) gcol[ch] = raw[ch] >= 0.f ? gcol[ch] : 0.f;
      float gdn[3] = {0.f, 0.f, 0.f};
#pragma unroll
      for (int k = 0; k < kNb; ++k) {
        float B, bx, by, bz;
        basis(k, dn[0], dn[1], dn[2], B, bx, by, bz);
        const float w = row[3 * k] * gcol[0] + row[3 * k + 1] * gcol[1] + row[3 * k + 2] * gcol[2];
        gdn[0] += w * bx;
        gdn[1] += w * by;
        gdn[2] += w * bz;
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) row[3 * k + ch] = B * gcol[ch];
      }
      // dn = d / max(|d|, 1e-12): past the clamp the radial part goes.
      const float nc = fmaxf(nd, 1e-12f);
      const float radial = nd >= 1e-12f ? gdn[0] * dn[0] + gdn[1] * dn[1] + gdn[2] * dn[2] : 0.f;
      for (int k = 0; k < 3; ++k) gd[k] = (gdn[k] - radial * dn[k]) / nc;
    } else {
      for (int e = 0; e < kRow; ++e) row[e] = 0.f;
    }
  }
  __syncthreads();
  stage_out<kRow, kStride>(d_sh, k3, base, rows, vec_out, rows_s);
  if (!here) return;

  const float gmx = g_means2d ? g_means2d[2 * i] : 0.f;
  const float gmy = g_means2d ? g_means2d[2 * i + 1] : 0.f;
  const float gz_out = g_depths ? g_depths[i] : 0.f;
  const float gc0 = g_conics ? g_conics[3 * i] : 0.f;
  const float gc1 = g_conics ? g_conics[3 * i + 1] : 0.f;
  const float gc2 = g_conics ? g_conics[3 * i + 2] : 0.f;
  const float gcomp = g_comps ? g_comps[i] : 0.f;
  const float gop = g_opac ? g_opac[i] : 0.f;
  if (gmx == 0.f && gmy == 0.f && gz_out == 0.f && gc0 == 0.f && gc1 == 0.f && gc2 == 0.f &&
      gcomp == 0.f && gop == 0.f) {
    // No cotangent of the projection: its gradients are zero.
    for (int k = 0; k < 3; ++k) {
      d_means[3 * i + k] = gd[k];
      d_log_scales[3 * i + k] = 0.f;
    }
    for (int k = 0; k < 4; ++k) d_quats[4 * i + k] = 0.f;
    d_logits[i] = 0.f;
    if constexpr (kDef) {
      for (int k = 0; k < 3; ++k) d_ds[3 * i + k] = 0.f;
      for (int k = 0; k < 4; ++k) d_dr[4 * i + k] = 0.f;
    }
    return;
  }

  // The forward again, as far as the gradients need it.
  const float* W = cam.r;
  const float x = W[0] * m[0] + W[1] * m[1] + W[2] * m[2] + cam.t[0];
  const float y = W[3] * m[0] + W[4] * m[1] + W[5] * m[2] + cam.t[1];
  const float z = W[6] * m[0] + W[7] * m[1] + W[8] * m[2] + cam.t[2];
  const bool z_small = fabsf(z) < 1e-6f;
  const float zs = z_small ? 1e-6f : z;
  Cov3 g;
  Quat1 q1;
  cov3<kDef>(quats + 4 * i, log_scales + 3 * i, dr + 4 * i, ds + 3 * i, g, q1);
  float c[6];
  cov_cam(W, g.s, c);
  const float ux_raw = x / zs, uy_raw = y / zs;
  const float ux = fminf(fmaxf(ux_raw, -cam.lim_x), cam.lim_x);
  const float uy = fminf(fmaxf(uy_raw, -cam.lim_y), cam.lim_y);
  const bool in_x = ux_raw >= -cam.lim_x && ux_raw <= cam.lim_x;
  const bool in_y = uy_raw >= -cam.lim_y && uy_raw <= cam.lim_y;
  const float tx = zs * ux, ty = zs * uy;
  const float rz = 1.0f / zs;
  const float rz2 = rz * rz;
  const float fx = cam.fx, fy = cam.fy;
  const float j00 = fx * rz, j02 = -fx * tx * rz2, j11 = fy * rz, j12 = -fy * ty * rz2;
  const float a = j00 * (j00 * c[0] + j02 * c[2]) + j02 * (j00 * c[2] + j02 * c[5]);
  const float b = j00 * (j11 * c[1] + j12 * c[2]) + j02 * (j11 * c[4] + j12 * c[5]);
  const float cc = j11 * (j11 * c[3] + j12 * c[4]) + j12 * (j11 * c[4] + j12 * c[5]);
  const float det_orig = a * cc - b * b;
  const float A = a + kEps2d, C = cc + kEps2d;
  const float det = A * C - b * b;
  const bool pos = det > 0.0f;
  const float det_safe = pos ? det : 1.0f;
  const float inv_det = 1.0f / det_safe;
  const float op = sigmoid(__ldg(logits + i));

  // Opacity and compensation (antialiased: opacity out = sigmoid * comp).
  const float ratio = det_orig / det_safe;
  const float comp = sqrtf(fmaxf(ratio, 0.0f));
  const float g_sig = kAA ? gop * comp : gop;
  const float gcomp_t = kAA ? gcomp + gop * op : gcomp;
  d_logits[i] = g_sig * op * (1.0f - op);
  const float g_ratio = gcomp_t != 0.f && ratio >= 0.f ? gcomp_t / (2.0f * comp) : 0.f;
  const float g_det_orig = g_ratio / det_safe;

  // The conic (C, -b, A) / det_safe, det_safe, then a, b, c.
  const float g_inv = gc0 * C - gc1 * b + gc2 * A;
  const float g_det = pos ? -g_inv * inv_det * inv_det - g_ratio * ratio / det_safe : 0.f;
  const float g_a = gc2 * inv_det + g_det * C + g_det_orig * cc;
  const float g_c = gc0 * inv_det + g_det * A + g_det_orig * a;
  const float g_b = -gc1 * inv_det - 2.0f * b * (g_det + g_det_orig);

  // a, b, c -> the camera covariance's symmetric cotangent gm, and J.
  float gm[9];
  gm[0] = g_a * j00 * j00;
  gm[4] = g_c * j11 * j11;
  gm[8] = g_a * j02 * j02 + g_b * j02 * j12 + g_c * j12 * j12;
  gm[1] = gm[3] = 0.5f * g_b * j00 * j11;
  gm[2] = gm[6] = g_a * j00 * j02 + 0.5f * g_b * j00 * j12;
  gm[5] = gm[7] = 0.5f * g_b * j02 * j11 + g_c * j11 * j12;
  const float g_j00 = 2.0f * g_a * (j00 * c[0] + j02 * c[2]) + g_b * (j11 * c[1] + j12 * c[2]);
  const float g_j02 = 2.0f * g_a * (j00 * c[2] + j02 * c[5]) + g_b * (j11 * c[4] + j12 * c[5]);
  const float g_j11 = g_b * (j00 * c[1] + j02 * c[4]) + 2.0f * g_c * (j11 * c[3] + j12 * c[4]);
  const float g_j12 = g_b * (j00 * c[2] + j02 * c[5]) + 2.0f * g_c * (j11 * c[4] + j12 * c[5]);

  // Sigma3's cotangent H = W^T gm W, its upper triangle mirrored: an
  // isotropic gaussian at the identity rotation then gets exactly zero
  // quaternion gradient, as autograd gives it. Sigma3 = R diag(v) R^T gives
  // dv_k = (R^T H R)_kk and dR = 2 H R diag(v).
  float p[9];  // gm W
#pragma unroll
  for (int r_ = 0; r_ < 3; ++r_)
#pragma unroll
    for (int l = 0; l < 3; ++l)
      p[3 * r_ + l] = gm[3 * r_] * W[l] + gm[3 * r_ + 1] * W[3 + l] + gm[3 * r_ + 2] * W[6 + l];
  float h[9];  // W^T (gm W)
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int l = k; l < 3; ++l)
      h[3 * k + l] = h[3 * l + k] = W[k] * p[l] + W[3 + k] * p[3 + l] + W[6 + k] * p[6 + l];
  const float* r = g.r;
  float gr[9];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float gv = 0.f;
#pragma unroll
    for (int i_ = 0; i_ < 3; ++i_) {
      const float hr = h[3 * i_] * r[k] + h[3 * i_ + 1] * r[3 + k] + h[3 * i_ + 2] * r[6 + k];
      gv += r[3 * i_ + k] * hr;
      gr[3 * i_ + k] = 2.0f * hr * g.v[k];
    }
    if constexpr (kDef) {
      // s' = exp(log s) + ds, v = s'^2.
      const float gs = 2.0f * g.sc[k] * gv;
      d_ds[3 * i + k] = gs;
      d_log_scales[3 * i + k] = gs * expf(__ldg(log_scales + 3 * i + k));
    } else {
      d_log_scales[3 * i + k] = 2.0f * g.v[k] * gv;
    }
  }

  // The rotation of the unit quaternion, then its normalization.
  const float qw = g.q[0], qx = g.q[1], qy = g.q[2], qz = g.q[3];
  float gq[4];
  gq[0] = 2.0f * (-qz * gr[1] + qy * gr[2] + qz * gr[3] - qx * gr[5] - qy * gr[6] + qx * gr[7]);
  gq[1] = 2.0f * (qy * gr[1] + qz * gr[2] + qy * gr[3] - 2.0f * qx * gr[4] - qw * gr[5] +
                  qz * gr[6] + qw * gr[7] - 2.0f * qx * gr[8]);
  gq[2] = 2.0f * (-2.0f * qy * gr[0] + qx * gr[1] + qw * gr[2] + qx * gr[3] + qz * gr[5] -
                  qw * gr[6] + qz * gr[7] - 2.0f * qy * gr[8]);
  gq[3] = 2.0f * (-2.0f * qz * gr[0] - qw * gr[1] + qx * gr[2] + qw * gr[3] - 2.0f * qz * gr[4] +
                  qy * gr[5] + qx * gr[6] + qy * gr[7]);
  const float along = g.qn >= 1e-12f
                          ? gq[0] * qw + gq[1] * qx + gq[2] * qy + gq[3] * qz : 0.f;
  if constexpr (kDef) {
    // The rotation's input is q2 = q1 + dr: its gradient is dr's; q1 =
    // normalize(q) passes it on without its part along q1.
    float g2[4];
    for (int k = 0; k < 4; ++k) {
      g2[k] = (gq[k] - along * g.q[k]) * g.qinv;
      d_dr[4 * i + k] = g2[k];
    }
    const float along1 = q1.unclamped ? g2[0] * q1.q[0] + g2[1] * q1.q[1] + g2[2] * q1.q[2] +
                                            g2[3] * q1.q[3] : 0.f;
    for (int k = 0; k < 4; ++k) d_quats[4 * i + k] = (g2[k] - along1 * q1.q[k]) * q1.qinv;
  } else {
    for (int k = 0; k < 4; ++k) d_quats[4 * i + k] = (gq[k] - along * g.q[k]) * g.qinv;
  }

  // J and the means2d through tx, ty, 1/zs to the camera-frame mean.
  const float g_rz = g_j00 * fx + g_j11 * fy + gmx * fx * x + gmy * fy * y -
                     2.0f * rz * (g_j02 * fx * tx + g_j12 * fy * ty);
  const float g_tx = -g_j02 * fx * rz2;
  const float g_ty = -g_j12 * fy * rz2;
  const float g_ux = in_x ? g_tx * zs : 0.f;
  const float g_uy = in_y ? g_ty * zs : 0.f;
  const float g_zs = -g_rz * rz * rz + g_tx * ux + g_ty * uy - (g_ux * x + g_uy * y) / (zs * zs);
  const float gpx = gmx * fx * rz + g_ux / zs;
  const float gpy = gmy * fy * rz + g_uy / zs;
  const float gpz = gz_out + (z_small ? 0.f : g_zs);
  for (int k = 0; k < 3; ++k)
    d_means[3 * i + k] = W[k] * gpx + W[3 + k] * gpy + W[6 + k] * gpz + gd[k];
}

template <int D, bool kAA, bool kDef>
int launch_fwd(int n, int k3, float width, float height, const float* const* in, void* const* out,
               cudaStream_t stream) {
  constexpr int kRow = 3 * (D + 1) * (D + 1);
  const bool vec = kRow % 4 == 0 && k3 % 4 == 0 && (uintptr_t)in[4] % 16 == 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  project_sh_fwd_kernel<D, kAA, kDef><<<blocks, kThreads, 0, stream>>>(
      n, k3, vec, width, height, in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7], in[8],
      in[9], (float2*)out[0], (float*)out[1], (float*)out[2], (int*)out[3], (float*)out[4],
      (float*)out[5], (float*)out[6]);
  return (int)cudaGetLastError();
}

template <int D, bool kAA, bool kDef>
int launch_bwd(int n, int k3, float width, float height, const float* const* in,
               const float* const* gin, float* const* out, cudaStream_t stream) {
  constexpr int kRow = 3 * (D + 1) * (D + 1);
  const bool vec_in = kRow % 4 == 0 && k3 % 4 == 0 && (uintptr_t)in[4] % 16 == 0;
  const bool vec_out = k3 % 4 == 0 && (uintptr_t)out[4] % 16 == 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  project_sh_bwd_kernel<D, kAA, kDef><<<blocks, kThreads, 0, stream>>>(
      n, k3, vec_in, vec_out, width, height, in[0], in[1], in[2], in[3], in[4], in[5], in[6],
      in[7], in[8], in[9], gin[0], gin[1], gin[2], gin[3], gin[4], gin[5], out[0], out[1],
      out[2], out[3], out[4], out[5], out[6]);
  return (int)cudaGetLastError();
}

template <bool kAA, bool kDef>
int fwd_degree(int degree, int n, int k3, float width, float height, const float* const* in,
               void* const* out, cudaStream_t st) {
  switch (degree) {
    case 0: return launch_fwd<0, kAA, kDef>(n, k3, width, height, in, out, st);
    case 1: return launch_fwd<1, kAA, kDef>(n, k3, width, height, in, out, st);
    case 2: return launch_fwd<2, kAA, kDef>(n, k3, width, height, in, out, st);
    case 3: return launch_fwd<3, kAA, kDef>(n, k3, width, height, in, out, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <bool kAA, bool kDef>
int bwd_degree(int degree, int n, int k3, float width, float height, const float* const* in,
               const float* const* gin, float* const* out, cudaStream_t st) {
  switch (degree) {
    case 0: return launch_bwd<0, kAA, kDef>(n, k3, width, height, in, gin, out, st);
    case 1: return launch_bwd<1, kAA, kDef>(n, k3, width, height, in, gin, out, st);
    case 2: return launch_bwd<2, kAA, kDef>(n, k3, width, height, in, gin, out, st);
    case 3: return launch_bwd<3, kAA, kDef>(n, k3, width, height, in, gin, out, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Inputs: means (n, 3), quats (n, 4), log_scales (n, 3), logits (n,), sh (n,
// kb, 3) float32 contiguous, viewmat (4, 4), K (3, 3); kb >= (degree + 1)^2;
// the offsets dx (n, 3), dr (n, 4), ds (n, 3), all three null (static) or
// none. Outputs: means2d (n, 2), depths (n,), conics (n, 3), radii (n,)
// int32, compensations (n,), colors (n, 3), opacities (n,).
extern "C" int gs_project_sh_fwd(int n, int kb, int degree, int antialiased, float width,
                                 float height, const void* means, const void* quats,
                                 const void* log_scales, const void* logits, const void* sh,
                                 const void* view, const void* K, const void* dx,
                                 const void* dr, const void* ds, void* means2d, void* depths,
                                 void* conics, void* radii, void* comps, void* colors,
                                 void* opac, void* stream) {
  if (n <= 0 || kb < (degree + 1) * (degree + 1)) return (int)cudaErrorInvalidValue;
  const bool def = dx != nullptr;
  if (def != (dr != nullptr) || def != (ds != nullptr)) return (int)cudaErrorInvalidValue;
  const float* in[10] = {(const float*)means, (const float*)quats, (const float*)log_scales,
                         (const float*)logits, (const float*)sh, (const float*)view,
                         (const float*)K, (const float*)dx, (const float*)dr,
                         (const float*)ds};
  void* out[7] = {means2d, depths, conics, radii, comps, colors, opac};
  cudaStream_t st = (cudaStream_t)stream;
  const int k3 = 3 * kb;
  if (def)
    return antialiased ? fwd_degree<true, true>(degree, n, k3, width, height, in, out, st)
                       : fwd_degree<false, true>(degree, n, k3, width, height, in, out, st);
  return antialiased ? fwd_degree<true, false>(degree, n, k3, width, height, in, out, st)
                     : fwd_degree<false, false>(degree, n, k3, width, height, in, out, st);
}

// The forward's inputs; the cotangents of means2d, depths, conics,
// compensations, colors and opacities (a null pointer is zero); the
// gradients of means, quats, log_scales, logits and sh and, with the
// offsets, of dr and ds (dx's is the means'), every element written.
extern "C" int gs_project_sh_bwd(int n, int kb, int degree, int antialiased, float width,
                                 float height, const void* means, const void* quats,
                                 const void* log_scales, const void* logits, const void* sh,
                                 const void* view, const void* K, const void* dx,
                                 const void* dr, const void* ds, const void* g_means2d,
                                 const void* g_depths, const void* g_conics,
                                 const void* g_comps, const void* g_colors, const void* g_opac,
                                 void* d_means, void* d_quats, void* d_log_scales,
                                 void* d_logits, void* d_sh, void* d_dr, void* d_ds,
                                 void* stream) {
  if (n <= 0 || kb < (degree + 1) * (degree + 1)) return (int)cudaErrorInvalidValue;
  const bool def = dx != nullptr;
  if (def != (dr != nullptr) || def != (ds != nullptr) || def != (d_dr != nullptr) ||
      def != (d_ds != nullptr))
    return (int)cudaErrorInvalidValue;
  const float* in[10] = {(const float*)means, (const float*)quats, (const float*)log_scales,
                         (const float*)logits, (const float*)sh, (const float*)view,
                         (const float*)K, (const float*)dx, (const float*)dr,
                         (const float*)ds};
  const float* gin[6] = {(const float*)g_means2d, (const float*)g_depths,
                         (const float*)g_conics, (const float*)g_comps,
                         (const float*)g_colors, (const float*)g_opac};
  float* out[7] = {(float*)d_means, (float*)d_quats, (float*)d_log_scales, (float*)d_logits,
                   (float*)d_sh, (float*)d_dr, (float*)d_ds};
  cudaStream_t st = (cudaStream_t)stream;
  const int k3 = 3 * kb;
  if (def)
    return antialiased ? bwd_degree<true, true>(degree, n, k3, width, height, in, gin, out, st)
                       : bwd_degree<false, true>(degree, n, k3, width, height, in, gin, out, st);
  return antialiased ? bwd_degree<true, false>(degree, n, k3, width, height, in, gin, out, st)
                     : bwd_degree<false, false>(degree, n, k3, width, height, in, gin, out, st);
}

// ---- surfels (2D Gaussian Splatting, ops/surfel.py) ---------------------------
//
// One thread a surfel, as the static pair: the forward writes what
// project_surfels_plain returns, the projected centre c (n, 2), the map T
// centred at c (n, 7: T_u1 T_u2 T_v1 T_v2 T_w1 T_w2 T_w3), the view-space
// normal facing the camera (n, 3), the centre depth, the binning ellipse
// as a conic (n, 3) and its radius (int32, 0 = culled), the colour (n, 3)
// and the opacity, each in the plain code's operation order (this source
// builds with -fmad=false, so the radii come out as the plain code's). The
// backward takes the cotangents of c, T, the normal, the colour and the
// opacity (null = zero) and writes the gradients of means, quats, the two
// log-scales, the logits and the SH rows, each once:
// project_surfels_bwd_plain's formulas. SH is the static pair's code.

namespace {

constexpr float kSurfelNear = 0.2f;
constexpr float kEllipseSlack = 1e-3f;

// The rotation of a raw quaternion (normalized here) with what the
// backward needs.
struct Rot {
  float q[4];
  float qn, qinv;
  float r[9];  // row-major
};

__device__ __forceinline__ void rot_of(const float* __restrict__ quat, Rot& g) {
  float w = __ldg(quat), x = __ldg(quat + 1), y = __ldg(quat + 2), z = __ldg(quat + 3);
  g.qn = sqrtf(w * w + x * x + y * y + z * z);
  g.qinv = 1.0f / fmaxf(g.qn, 1e-12f);
  w = w * g.qinv;
  x = x * g.qinv;
  y = y * g.qinv;
  z = z * g.qinv;
  g.q[0] = w;
  g.q[1] = x;
  g.q[2] = y;
  g.q[3] = z;
  const float xx = x * x, yy = y * y, zz = z * z;
  const float xy = x * y, xz = x * z, yz = y * z;
  const float wx = w * x, wy = w * y, wz = w * z;
  g.r[0] = 1.0f - 2.0f * (yy + zz);
  g.r[1] = 2.0f * (xy - wz);
  g.r[2] = 2.0f * (xz + wy);
  g.r[3] = 2.0f * (xy + wz);
  g.r[4] = 1.0f - 2.0f * (xx + zz);
  g.r[5] = 2.0f * (yz - wx);
  g.r[6] = 2.0f * (xz - wy);
  g.r[7] = 2.0f * (yz + wx);
  g.r[8] = 1.0f - 2.0f * (xx + yy);
}

// What the surfel forward computes before the colour.
struct SurfelGeo {
  float x, y, z, zs;
  bool z_small;
  float wtu[3], wtv[3], ncam[3];  // W t_u, W t_v, W t_w
  float su, sv;
  float U[3], V[3];
  float ux, uy;
  float sign;  // the normal's turn towards the camera
};

__device__ __forceinline__ void surfel_geo(const Cam& cam, const float* m, const Rot& R,
                                           const float* __restrict__ ls, SurfelGeo& s) {
  const float* W = cam.r;
  s.x = W[0] * m[0] + W[1] * m[1] + W[2] * m[2] + cam.t[0];
  s.y = W[3] * m[0] + W[4] * m[1] + W[5] * m[2] + cam.t[1];
  s.z = W[6] * m[0] + W[7] * m[1] + W[8] * m[2] + cam.t[2];
  s.su = expf(__ldg(ls));
  s.sv = expf(__ldg(ls + 1));
  const float* r = R.r;
  for (int i = 0; i < 3; ++i) {
    s.wtu[i] = W[3 * i] * r[0] + W[3 * i + 1] * r[3] + W[3 * i + 2] * r[6];
    s.wtv[i] = W[3 * i] * r[1] + W[3 * i + 1] * r[4] + W[3 * i + 2] * r[7];
    s.ncam[i] = W[3 * i] * r[2] + W[3 * i + 1] * r[5] + W[3 * i + 2] * r[8];
    s.U[i] = s.wtu[i] * s.su;
    s.V[i] = s.wtv[i] * s.sv;
  }
  s.z_small = fabsf(s.z) < 1e-6f;
  s.zs = s.z_small ? 1e-6f : s.z;
  s.ux = s.x / s.zs;
  s.uy = s.y / s.zs;
  const float facing = s.ncam[0] * s.x + s.ncam[1] * s.y + s.ncam[2] * s.z;
  s.sign = facing > 0.0f ? -1.0f : 1.0f;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
project_surfel_fwd_kernel(int n, int k3, bool vec, float width, float height,
                          const float* __restrict__ means, const float* __restrict__ quats,
                          const float* __restrict__ log_scales, const float* __restrict__ logits,
                          const float* __restrict__ sh, const float* __restrict__ view,
                          const float* __restrict__ Kmat, float2* __restrict__ centers,
                          float* __restrict__ tmat, float* __restrict__ normals,
                          float* __restrict__ depths, float* __restrict__ conics,
                          int* __restrict__ radii, float* __restrict__ colors,
                          float* __restrict__ opac) {
  constexpr int kNb = (D + 1) * (D + 1), kRow = 3 * kNb, kStride = kRow | 1;
  __shared__ float rows_s[kThreads * kStride];
  __shared__ Cam cam;
  const int base = blockIdx.x * kThreads;
  const int rows = min(kThreads, n - base);
  if (threadIdx.x == 0) load_cam(view, Kmat, width, height, cam);
  stage_in<kRow, kStride>(sh, k3, base, rows, vec, nullptr, rows_s);
  __syncthreads();
  if ((int)threadIdx.x >= rows) return;
  const int64_t i = base + threadIdx.x;

  float m[3];
  for (int k = 0; k < 3; ++k) m[k] = __ldg(means + 3 * i + k);
  Rot R;
  rot_of(quats + 4 * i, R);
  SurfelGeo s;
  surfel_geo(cam, m, R, log_scales + 2 * i, s);
  const float fx = cam.fx, fy = cam.fy;
  const float tu1 = fx * (s.U[0] - s.ux * s.U[2]);
  const float tu2 = fx * (s.V[0] - s.ux * s.V[2]);
  const float tv1 = fy * (s.U[1] - s.uy * s.U[2]);
  const float tv2 = fy * (s.V[1] - s.uy * s.V[2]);
  const float tw1 = s.U[2], tw2 = s.V[2], tw3 = s.z;
  const float cx = fx * s.ux + cam.cx, cy = fy * s.uy + cam.cy;
  const float op = sigmoid(__ldg(logits + i));

  // The binning ellipse (ops/surfel.py::binning_ellipse, operation for
  // operation).
  const float Q = fmaxf(2.0f * (logf(255.0f * fmaxf(op, 1e-12f)) + 1e-3f), 0.0f);
  const float d11 = Q * (tu1 * tu1 + tu2 * tu2);
  const float d12 = Q * (tu1 * tv1 + tu2 * tv2);
  const float d22 = Q * (tv1 * tv1 + tv2 * tv2);
  const float d13 = Q * (tu1 * tw1 + tu2 * tw2);
  const float d23 = Q * (tv1 * tw1 + tv2 * tw2);
  const float d33 = Q * (tw1 * tw1 + tw2 * tw2) - tw3 * tw3;
  const bool ok = d33 < 0.0f;
  const float f = -1.0f / (ok ? d33 : -1.0f);
  const float mx = -f * d13, my = -f * d23;
  const float s11 = f * d11 + mx * mx;
  const float s12 = f * d12 + mx * my;
  const float s22 = f * d22 + my * my;
  const float mm = mx * mx + my * my;
  const float mlen = sqrtf(mm);
  const float sig = sqrtf(fmaxf(0.5f * (s11 + s22), 1e-12f));
  const float a = 1.0f + mlen / sig;
  const float b = mm + mlen * sig + 0.5f * Q;
  const float grow = 1.0f + kEllipseSlack;
  const float e11 = (a * s11 + b) * grow;
  const float e12 = a * s12 * grow;
  const float e22 = (a * s22 + b) * grow;
  const float det = e11 * e22 - e12 * e12;
  const float det_s = det > 0.0f ? det : 1.0f;
  const float c0 = Q * e22 / det_s, c1 = -Q * e12 / det_s, c2 = Q * e11 / det_s;
  const float rad = ceilf(sqrtf(fmaxf(fmaxf(e11, e22), 0.0f))) + 1.0f;
  const bool inside = cx + rad > 0.0f && cx - rad < width && cy + rad > 0.0f &&
                      cy - rad < height;
  const bool finite = isfinite(c0) && isfinite(c1) && isfinite(c2) && isfinite(rad) &&
                      isfinite(cx) && isfinite(cy);
  const bool valid = ok && tw3 > kSurfelNear && det > 0.0f && inside && finite &&
                     rad < 16777216.0f;

  centers[i] = make_float2(cx, cy);
  float* t = tmat + 7 * i;
  t[0] = tu1;
  t[1] = tu2;
  t[2] = tv1;
  t[3] = tv2;
  t[4] = tw1;
  t[5] = tw2;
  t[6] = tw3;
  for (int k = 0; k < 3; ++k) normals[3 * i + k] = s.sign * s.ncam[k];
  depths[i] = s.z;
  conics[3 * i] = c0;
  conics[3 * i + 1] = c1;
  conics[3 * i + 2] = c2;
  radii[i] = valid ? (int)rad : 0;
  opac[i] = op;

  float dn[3], nd;
  view_dir(cam, m, dn, nd);
  const float* row = rows_s + threadIdx.x * kStride;
  float col[3] = {0.5f, 0.5f, 0.5f};
#pragma unroll
  for (int k = 0; k < kNb; ++k) {
    float B, bx, by, bz;
    basis(k, dn[0], dn[1], dn[2], B, bx, by, bz);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) col[ch] += B * row[3 * k + ch];
  }
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) colors[3 * i + ch] = fmaxf(col[ch], 0.0f);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
project_surfel_bwd_kernel(int n, int k3, bool vec_in, bool vec_out, float width, float height,
                          const float* __restrict__ means, const float* __restrict__ quats,
                          const float* __restrict__ log_scales, const float* __restrict__ logits,
                          const float* __restrict__ sh, const float* __restrict__ view,
                          const float* __restrict__ Kmat, const float* __restrict__ g_centers,
                          const float* __restrict__ g_tmat, const float* __restrict__ g_normals,
                          const float* __restrict__ g_colors, const float* __restrict__ g_opac,
                          float* __restrict__ d_means, float* __restrict__ d_quats,
                          float* __restrict__ d_log_scales, float* __restrict__ d_logits,
                          float* __restrict__ d_sh) {
  constexpr int kNb = (D + 1) * (D + 1), kRow = 3 * kNb, kStride = kRow | 1;
  __shared__ float rows_s[kThreads * kStride];
  __shared__ Cam cam;
  __shared__ bool need_s[kThreads];
  const int base = blockIdx.x * kThreads;
  const int rows = min(kThreads, n - base);
  const bool here = (int)threadIdx.x < rows;
  const int64_t i = base + threadIdx.x;

  float gcol[3] = {0.f, 0.f, 0.f};
  if (here && g_colors != nullptr)
    for (int ch = 0; ch < 3; ++ch) gcol[ch] = g_colors[3 * i + ch];
  const bool need = gcol[0] != 0.f || gcol[1] != 0.f || gcol[2] != 0.f;
  need_s[threadIdx.x] = need;
  if (threadIdx.x == 0) load_cam(view, Kmat, width, height, cam);
  __syncthreads();
  stage_in<kRow, kStride>(sh, k3, base, rows, vec_in, need_s, rows_s);
  __syncthreads();

  float m[3] = {0.f, 0.f, 0.f}, gd[3] = {0.f, 0.f, 0.f};
  if (here) {
    for (int k = 0; k < 3; ++k) m[k] = __ldg(means + 3 * i + k);
    float* row = rows_s + threadIdx.x * kStride;
    if (need) {
      float dn[3], nd;
      view_dir(cam, m, dn, nd);
      float raw[3] = {0.5f, 0.5f, 0.5f};
#pragma unroll
      for (int k = 0; k < kNb; ++k) {
        float B, bx, by, bz;
        basis(k, dn[0], dn[1], dn[2], B, bx, by, bz);
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) raw[ch] += B * row[3 * k + ch];
      }
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) gcol[ch] = raw[ch] >= 0.f ? gcol[ch] : 0.f;
      float gdn[3] = {0.f, 0.f, 0.f};
#pragma unroll
      for (int k = 0; k < kNb; ++k) {
        float B, bx, by, bz;
        basis(k, dn[0], dn[1], dn[2], B, bx, by, bz);
        const float w = row[3 * k] * gcol[0] + row[3 * k + 1] * gcol[1] + row[3 * k + 2] * gcol[2];
        gdn[0] += w * bx;
        gdn[1] += w * by;
        gdn[2] += w * bz;
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) row[3 * k + ch] = B * gcol[ch];
      }
      const float nc = fmaxf(nd, 1e-12f);
      const float radial = nd >= 1e-12f ? gdn[0] * dn[0] + gdn[1] * dn[1] + gdn[2] * dn[2] : 0.f;
      for (int k = 0; k < 3; ++k) gd[k] = (gdn[k] - radial * dn[k]) / nc;
    } else {
      for (int e = 0; e < kRow; ++e) row[e] = 0.f;
    }
  }
  __syncthreads();
  stage_out<kRow, kStride>(d_sh, k3, base, rows, vec_out, rows_s);
  if (!here) return;

  const float gcx = g_centers ? g_centers[2 * i] : 0.f;
  const float gcy = g_centers ? g_centers[2 * i + 1] : 0.f;
  float gt[7], gn[3];
  for (int k = 0; k < 7; ++k) gt[k] = g_tmat ? g_tmat[7 * i + k] : 0.f;
  for (int k = 0; k < 3; ++k) gn[k] = g_normals ? g_normals[3 * i + k] : 0.f;
  const float gop = g_opac ? g_opac[i] : 0.f;
  const float op = sigmoid(__ldg(logits + i));
  d_logits[i] = gop * op * (1.0f - op);

  Rot R;
  rot_of(quats + 4 * i, R);
  SurfelGeo s;
  surfel_geo(cam, m, R, log_scales + 2 * i, s);
  const float* W = cam.r;
  const float fx = cam.fx, fy = cam.fy;

  // T and c to the camera-frame axes, the centre and (ux, uy).
  const float g_ux = fx * gcx - fx * s.U[2] * gt[0] - fx * s.V[2] * gt[1];
  const float g_uy = fy * gcy - fy * s.U[2] * gt[2] - fy * s.V[2] * gt[3];
  const float gU[3] = {fx * gt[0], fy * gt[2], -fx * s.ux * gt[0] - fy * s.uy * gt[2] + gt[4]};
  const float gV[3] = {fx * gt[1], fy * gt[3], -fx * s.ux * gt[1] - fy * s.uy * gt[3] + gt[5]};
  const float g_zs = -(g_ux * s.x + g_uy * s.y) / (s.zs * s.zs);
  const float gpx = g_ux / s.zs;
  const float gpy = g_uy / s.zs;
  const float gpz = gt[6] + (s.z_small ? 0.f : g_zs);

  // U = (W t_u) s_u, V = (W t_v) s_v, n = sign W t_w.
  float g_wtu[3], g_wtv[3], g_nc[3];
  for (int k = 0; k < 3; ++k) {
    g_wtu[k] = gU[k] * s.su;
    g_wtv[k] = gV[k] * s.sv;
    g_nc[k] = s.sign * gn[k];
  }
  const float g_su = s.wtu[0] * gU[0] + s.wtu[1] * gU[1] + s.wtu[2] * gU[2];
  const float g_sv = s.wtv[0] * gV[0] + s.wtv[1] * gV[1] + s.wtv[2] * gV[2];
  d_log_scales[2 * i] = g_su * s.su;
  d_log_scales[2 * i + 1] = g_sv * s.sv;
  float gr[9];
  for (int k = 0; k < 3; ++k) {
    gr[3 * k] = W[k] * g_wtu[0] + W[3 + k] * g_wtu[1] + W[6 + k] * g_wtu[2];
    gr[3 * k + 1] = W[k] * g_wtv[0] + W[3 + k] * g_wtv[1] + W[6 + k] * g_wtv[2];
    gr[3 * k + 2] = W[k] * g_nc[0] + W[3 + k] * g_nc[1] + W[6 + k] * g_nc[2];
  }
  const float qw = R.q[0], qx = R.q[1], qy = R.q[2], qz = R.q[3];
  float gq[4];
  gq[0] = 2.0f * (-qz * gr[1] + qy * gr[2] + qz * gr[3] - qx * gr[5] - qy * gr[6] + qx * gr[7]);
  gq[1] = 2.0f * (qy * gr[1] + qz * gr[2] + qy * gr[3] - 2.0f * qx * gr[4] - qw * gr[5] +
                  qz * gr[6] + qw * gr[7] - 2.0f * qx * gr[8]);
  gq[2] = 2.0f * (-2.0f * qy * gr[0] + qx * gr[1] + qw * gr[2] + qx * gr[3] + qz * gr[5] -
                  qw * gr[6] + qz * gr[7] - 2.0f * qy * gr[8]);
  gq[3] = 2.0f * (-2.0f * qz * gr[0] - qw * gr[1] + qx * gr[2] + qw * gr[3] - 2.0f * qz * gr[4] +
                  qy * gr[5] + qx * gr[6] + qy * gr[7]);
  const float along = R.qn >= 1e-12f ? gq[0] * qw + gq[1] * qx + gq[2] * qy + gq[3] * qz : 0.f;
  for (int k = 0; k < 4; ++k) d_quats[4 * i + k] = (gq[k] - along * R.q[k]) * R.qinv;
  for (int k = 0; k < 3; ++k)
    d_means[3 * i + k] = W[k] * gpx + W[3 + k] * gpy + W[6 + k] * gpz + gd[k];
}

template <int D>
int launch_surfel_fwd(int n, int k3, float width, float height, const float* const* in,
                      void* const* out, cudaStream_t stream) {
  constexpr int kRow = 3 * (D + 1) * (D + 1);
  const bool vec = kRow % 4 == 0 && k3 % 4 == 0 && (uintptr_t)in[4] % 16 == 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  project_surfel_fwd_kernel<D><<<blocks, kThreads, 0, stream>>>(
      n, k3, vec, width, height, in[0], in[1], in[2], in[3], in[4], in[5], in[6],
      (float2*)out[0], (float*)out[1], (float*)out[2], (float*)out[3], (float*)out[4],
      (int*)out[5], (float*)out[6], (float*)out[7]);
  return (int)cudaGetLastError();
}

template <int D>
int launch_surfel_bwd(int n, int k3, float width, float height, const float* const* in,
                      const float* const* gin, float* const* out, cudaStream_t stream) {
  constexpr int kRow = 3 * (D + 1) * (D + 1);
  const bool vec_in = kRow % 4 == 0 && k3 % 4 == 0 && (uintptr_t)in[4] % 16 == 0;
  const bool vec_out = k3 % 4 == 0 && (uintptr_t)out[4] % 16 == 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  project_surfel_bwd_kernel<D><<<blocks, kThreads, 0, stream>>>(
      n, k3, vec_in, vec_out, width, height, in[0], in[1], in[2], in[3], in[4], in[5], in[6],
      gin[0], gin[1], gin[2], gin[3], gin[4], out[0], out[1], out[2], out[3], out[4]);
  return (int)cudaGetLastError();
}

}  // namespace

// Inputs: means (n, 3), quats (n, 4), log_scales (n, 2), logits (n,), sh (n,
// kb, 3) float32 contiguous, viewmat (4, 4), K (3, 3); kb >= (degree + 1)^2.
// Outputs: centers (n, 2), tmat (n, 7), normals (n, 3), depths (n,), conics
// (n, 3), radii (n,) int32, colors (n, 3), opacities (n,).
extern "C" int gs_project_surfel_fwd(int n, int kb, int degree, float width, float height,
                                     const void* means, const void* quats,
                                     const void* log_scales, const void* logits,
                                     const void* sh, const void* view, const void* K,
                                     void* centers, void* tmat, void* normals, void* depths,
                                     void* conics, void* radii, void* colors, void* opac,
                                     void* stream) {
  if (n <= 0 || kb < (degree + 1) * (degree + 1)) return (int)cudaErrorInvalidValue;
  const float* in[7] = {(const float*)means, (const float*)quats, (const float*)log_scales,
                        (const float*)logits, (const float*)sh, (const float*)view,
                        (const float*)K};
  void* out[8] = {centers, tmat, normals, depths, conics, radii, colors, opac};
  cudaStream_t st = (cudaStream_t)stream;
  const int k3 = 3 * kb;
  switch (degree) {
    case 0: return launch_surfel_fwd<0>(n, k3, width, height, in, out, st);
    case 1: return launch_surfel_fwd<1>(n, k3, width, height, in, out, st);
    case 2: return launch_surfel_fwd<2>(n, k3, width, height, in, out, st);
    case 3: return launch_surfel_fwd<3>(n, k3, width, height, in, out, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The forward's inputs; the cotangents of centers, tmat, normals, colors and
// opacities (a null pointer is zero); the gradients of means, quats,
// log_scales, logits and sh, every element written.
extern "C" int gs_project_surfel_bwd(int n, int kb, int degree, float width, float height,
                                     const void* means, const void* quats,
                                     const void* log_scales, const void* logits,
                                     const void* sh, const void* view, const void* K,
                                     const void* g_centers, const void* g_tmat,
                                     const void* g_normals, const void* g_colors,
                                     const void* g_opac, void* d_means, void* d_quats,
                                     void* d_log_scales, void* d_logits, void* d_sh,
                                     void* stream) {
  if (n <= 0 || kb < (degree + 1) * (degree + 1)) return (int)cudaErrorInvalidValue;
  const float* in[7] = {(const float*)means, (const float*)quats, (const float*)log_scales,
                        (const float*)logits, (const float*)sh, (const float*)view,
                        (const float*)K};
  const float* gin[5] = {(const float*)g_centers, (const float*)g_tmat,
                         (const float*)g_normals, (const float*)g_colors,
                         (const float*)g_opac};
  float* out[5] = {(float*)d_means, (float*)d_quats, (float*)d_log_scales, (float*)d_logits,
                   (float*)d_sh};
  cudaStream_t st = (cudaStream_t)stream;
  const int k3 = 3 * kb;
  switch (degree) {
    case 0: return launch_surfel_bwd<0>(n, k3, width, height, in, gin, out, st);
    case 1: return launch_surfel_bwd<1>(n, k3, width, height, in, gin, out, st);
    case 2: return launch_surfel_bwd<2>(n, k3, width, height, in, gin, out, st);
    case 3: return launch_surfel_bwd<3>(n, k3, width, height, in, gin, out, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
