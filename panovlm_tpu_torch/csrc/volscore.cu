// Plane-sweep NCC scoring of candidate planes for PatchMatch MVS.
//
// Replaces the Pallas TPU kernel panovlm_tpu/ops/pallas/volscore.py:_kernel
// (driven by score_candidates), and computes what its oracle, the XLA vol
// path of panovlm_tpu/ops/patchmatch.py:ncc_cost, computes: for each view v,
// candidate plane c and pixel p, over the T texel offsets (dv, du),
//
//   r_t    = ray at (p + off), rows and columns wrapping as jnp.roll does
//   den    = n_c(p) . r_t, clamped: |den| < 1e-6 -> sign(den) * 1e-6 + 1e-12
//   lam    = rho_c(p) / den                 (plane depth along the texel ray)
//   sigma  = clip((1 / max(lam, 1e-6) - inv0) / inv_step, 0, D-1)
//   s      = hat-interpolated vol[v, :, p + off] at sigma
//   i_t    = gray[p + off], w = exp(-(i_t - gray[p])^2 / (2 sigma_c^2)) * (lam > 0)
//
// with rho_c(p) = depth_c(p) * (n_c(p) . r_p), and the weighted NCC of
// (i_t, s) from six moments -> 1 - NCC clipped to [0, 2], or 2.0 where the
// weight sum is <= 1e-3 or the candidate depth lies outside (dmin, dmax).
//
// Design: one thread per output pixel, x fastest, blocks over
// (W tiles, H, V*C); the texel offsets are a small int32 array every thread
// of a block reads in the same order (broadcast loads). The hat sum has at
// most two nonzero weights, so a texel reads only the two bracketing slices
// floor(sigma) and floor(sigma)+1 of the bf16 volume at (p + off), not all D.
// The reference texel table (i_t, w) of the TPU kernel is recomputed from
// the reference gray instead of read from a (T, H, W) table: it is two
// loads and an exp, against 8 bytes per texel per (view, candidate).
// The volume is addressed through its view and slice strides, so a strided
// slice subset (the ranking pass reads vols[:, ::4]) needs no copy.
//
// Bound on this card: the volume reads and the ~36 f32 operations per
// (view, candidate, pixel, texel); both are counted by chip_smoke.py.
// Moments accumulate in f32 registers, in texel order, as the oracle's scan.
//
// Rounding: every product that the plain version adds to something is
// written with __fmul_rn / __fadd_rn / __fsub_rn, which nvcc never contracts
// into an FMA, and the scalar divisions are multiplies by reciprocals that
// the caller computes in double and rounds to float (r_step = 1/inv_step,
// r_sig = 1/(2 sigma^2)), as PyTorch's CUDA kernels evaluate the plain
// version's tensor / python float. Kernel and plain version then round
// alike. Each shortcut broke that at some shape: with contracted FMAs, the
// NCC of near-flat patches (small variance, cancellation) amplified the
// differences past 2e-4 on 25 of 8.3M outputs at the Room shape, and so
// did 1.f / inv_step taken in float at the 16-slice sweep of the MVS stage.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK_X = 128;

__device__ __forceinline__ float clamp_den(float d) {
  if (fabsf(d) < 1e-6f) {
    float sgn = (d > 0.f) ? 1.f : ((d < 0.f) ? -1.f : 0.f);
    return sgn * 1e-6f + 1e-12f;
  }
  return d;
}

// a . b over three components, rounded as sum(a * b) of three products
__device__ __forceinline__ float dot3(float a0, float a1, float a2, float b0,
                                     float b1, float b2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a0, b0), __fmul_rn(a1, b1)),
                   __fmul_rn(a2, b2));
}

// acc + a * b with both operations rounded
__device__ __forceinline__ float add_mul(float acc, float a, float b) {
  return __fadd_rn(acc, __fmul_rn(a, b));
}

__global__ void volscore_kernel(const __nv_bfloat16* __restrict__ vol,
                                long long stride_v, long long stride_d,
                                const float* __restrict__ depth,
                                const float* __restrict__ nrm,
                                const float* __restrict__ rays,
                                const float* __restrict__ gray,
                                const int* __restrict__ offsets, int T,
                                int V, int C, int D, int H, int W,
                                float inv0, float r_step, float dmin,
                                float dmax, float r_sig,
                                float* __restrict__ out) {
  const int x = blockIdx.x * BLOCK_X + threadIdx.x;
  const int y = blockIdx.y;
  const int vc = blockIdx.z;
  if (x >= W) return;
  const int v = vc / C;
  const int c = vc % C;
  const long long HW = (long long)H * W;
  const long long p = (long long)y * W + x;

  const float d_p = depth[c * HW + p];
  const float n0 = nrm[(3LL * c + 0) * HW + p];
  const float n1 = nrm[(3LL * c + 1) * HW + p];
  const float n2 = nrm[(3LL * c + 2) * HW + p];
  const float rho_p = d_p * dot3(n0, n1, n2, rays[p], rays[HW + p], rays[2 * HW + p]);
  const float g_c = gray[p];
  const __nv_bfloat16* vv = vol + v * stride_v;
  const float dmax_idx = (float)(D - 1);

  float sw = 0.f, sx = 0.f, sy = 0.f, sxx = 0.f, syy = 0.f, sxy = 0.f;
  for (int t = 0; t < T; ++t) {
    const int dv = offsets[2 * t];
    const int du = offsets[2 * t + 1];
    int yy = (y + dv) % H;
    if (yy < 0) yy += H;
    int xx = (x + du) % W;
    if (xx < 0) xx += W;
    const long long q = (long long)yy * W + xx;
    const float den = clamp_den(dot3(n0, n1, n2, rays[q], rays[HW + q], rays[2 * HW + q]));
    const float lam = rho_p / den;
    float sigma = (1.f / fmaxf(lam, 1e-6f) - inv0) * r_step;
    sigma = fminf(fmaxf(sigma, 0.f), dmax_idx);
    const float s0 = floorf(sigma);
    const float f = sigma - s0;
    const int i0 = (int)s0;
    float s = __fmul_rn(1.f - f, __bfloat162float(vv[i0 * stride_d + q]));
    if (i0 + 1 < D) s = add_mul(s, f, __bfloat162float(vv[(i0 + 1) * stride_d + q]));
    const float i_t = gray[q];
    const float dg = i_t - g_c;
    const float w = (lam > 0.f) ? expf(-(dg * dg) * r_sig) : 0.f;
    const float w_i = __fmul_rn(w, i_t);
    const float w_s = __fmul_rn(w, s);
    sw = __fadd_rn(sw, w);
    sx = __fadd_rn(sx, w_i);
    sy = __fadd_rn(sy, w_s);
    sxx = add_mul(sxx, w_i, i_t);
    syy = add_mul(syy, w_s, s);
    sxy = add_mul(sxy, w_i, s);
  }
  const float eps = 1e-6f;
  const float sw_e = sw + eps;
  const float mx = sx / sw_e, my = sy / sw_e;
  const float vx = __fsub_rn(sxx / sw_e, __fmul_rn(mx, mx));
  const float vy = __fsub_rn(syy / sw_e, __fmul_rn(my, my));
  const float cov = __fsub_rn(sxy / sw_e, __fmul_rn(mx, my));
  float ncc = cov / sqrtf(fmaxf(vx * vy, 1e-12f));
  ncc = fminf(fmaxf(ncc, -1.f), 1.f);
  const bool valid = (sw > 1e-3f) && (d_p > dmin) && (d_p < dmax);
  out[(long long)vc * HW + p] = valid ? 1.f - ncc : 2.f;
}

}  // namespace

extern "C" int volscore_launch(const void* vol, long long stride_v,
                               long long stride_d, const void* depth,
                               const void* nrm, const void* rays,
                               const void* gray, const void* offsets, int T,
                               int V, int C, int D, int H, int W, float inv0,
                               float r_step, float dmin, float dmax,
                               float r_sig, void* out, void* stream) {
  dim3 block(BLOCK_X);
  dim3 grid((W + BLOCK_X - 1) / BLOCK_X, H, V * C);
  volscore_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)vol, stride_v, stride_d, (const float*)depth,
      (const float*)nrm, (const float*)rays, (const float*)gray,
      (const int*)offsets, T, V, C, D, H, W, inv0, r_step, dmin, dmax,
      r_sig, (float*)out);
  return (int)cudaGetLastError();
}
