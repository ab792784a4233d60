// raster_common.cuh: the per-(pixel, entry) arithmetic that the forward
// kernel (rasterize_fwd.cu) and the backward kernel (rasterize_bwd.cu) must
// share bit for bit. The backward recomputes the forward's transmittance
// chain; if its stop decisions differed from the forward's in one bit, a
// pixel at the 1e-4 boundary would get a gradient for an entry the forward
// never blended. So sigma, alpha, the running product and the stop test are
// written once, here, with explicit round-to-nearest intrinsics (no
// multiply-add is contracted), in the order the plain PyTorch versions use.

#pragma once

#include <cuda_runtime.h>

namespace gs {

constexpr float kAlphaClamp = 0.999f;
constexpr float kAlphaSkip = 1.0f / 255.0f;
constexpr float kTEarlyStop = 1e-4f;

struct Entry {
  float dx, dy;    // pixel centre minus the gaussian's mean
  float sigma;     // 0.5 (ca dx^2 + cc dy^2) + cb dx dy
  float vis;       // e^-sigma
  float araw;      // op * e^-sigma, before the gate and the clamp
  float alpha;     // min(araw, 0.999) where the gate passes, else 0
  bool contrib;    // sigma >= 0 and araw >= 1/255
};

__device__ __forceinline__ Entry eval_entry(float px, float py, float mx, float my,
                                            float ca, float cb, float cc, float op) {
  Entry e;
  e.dx = __fsub_rn(px, mx);
  e.dy = __fsub_rn(py, my);
  const float quad = __fadd_rn(__fmul_rn(__fmul_rn(ca, e.dx), e.dx),
                               __fmul_rn(__fmul_rn(cc, e.dy), e.dy));
  e.sigma = __fadd_rn(__fmul_rn(0.5f, quad), __fmul_rn(__fmul_rn(cb, e.dx), e.dy));
  e.vis = expf(-e.sigma);
  e.araw = __fmul_rn(op, e.vis);
  e.contrib = e.sigma >= 0.f && e.araw >= kAlphaSkip;
  e.alpha = e.contrib ? fminf(e.araw, kAlphaClamp) : 0.f;
  return e;
}

// The running product prod_{j<=k}(1 - alpha_j) of a chunk after entry k.
__device__ __forceinline__ float next_prod(float prod, float alpha) {
  return __fmul_rn(prod, __fsub_rn(1.0f, alpha));
}

// The chunk-carried stop rule: an entry counts while
// T_carry * prod_{j<=k}(1 - alpha_j) stays above 1e-4.
__device__ __forceinline__ bool entry_counts(float tcar, float prod_next) {
  return __fmul_rn(tcar, prod_next) > kTEarlyStop;
}

}  // namespace gs
