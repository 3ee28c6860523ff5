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
// What bounds it on the H100: arithmetic and the scattered two-slice volume
// reads. Each quantity depends on fewer indices than the output does:
//   (p, t)      i_t and the bilateral factor exp(...)
//   (c, p, t)   den, lam, sigma, its floor and fraction, w, and the three
//               moments of the gray alone (sum w, sum w i_t, sum w i_t^2)
//   (v, c, p, t) the hat sample s and the three moments that involve it
// The design computes each one once at its own level; chip_smoke.py counts
// the operations the same way for the bound.
//
// Design: a block owns a 32 x 8 pixel tile, one thread per pixel. The rays
// and the gray of the tile plus its halo (the largest |offset|) are staged
// in shared memory once, with the wrap resolved while loading, together
// with the wrapped global row and column of every halo position; the texel
// loop then uses 32-bit indices and no modulo. The texel offsets arrive as
// a kernel argument (no host-to-device copy per launch) and are copied to
// shared memory. One thread loops over texels outside and over candidates
// and views inside, so the per-(p, t) work is done once per candidate chunk
// and the per-(c, p, t) work once per view chunk. Accumulators live in
// registers: 3 per candidate and 3 per (view, candidate), with candidates
// walked in chunks of CC and views in chunks of VV (4 x 2 when V > 2, 2 x 4
// otherwise), so the 16-candidate ranking launch does not spill. A texel
// reads only the two bracketing slices of the bf16 volume. Where the
// block's slab of it (all views, all slices, the tile plus halo) fits in
// 100 KB of shared memory, as at the MVS stage's fitted 16-slice sweep, the
// slab is staged once per block with coalesced loads and the texel loop
// reads it there: the candidates' slice coordinates scatter across
// neighbouring pixels, so the same reads from device memory touch a cache
// line per thread. Otherwise the slices are read from device memory
// through the view and slice strides (a strided slice subset such as
// vols[:, ::4] needs no copy either way).
//
// Rounding: every accumulator sums its texels in the same order as the
// plain version, with the same products: each product that the plain
// version adds to something is written with __fmul_rn / __fadd_rn /
// __fsub_rn, which nvcc never contracts into an FMA, and the scalar
// divisions are multiplies by reciprocals that the caller computes in
// double and rounds to float (r_step = 1/inv_step, r_sig = 1/(2 sigma^2)),
// as PyTorch's CUDA kernels evaluate the plain version's tensor / python
// float. The moments of the gray do not depend on the view, so computing
// them once per (c, p, t) changes no bit. Kernel and plain version then
// agree bit for bit. Each shortcut broke that at some shape: with
// contracted FMAs, the NCC of near-flat patches (small variance,
// cancellation) amplified the differences past 2e-4 on 25 of 8.3M outputs
// at the Room shape, and so did 1.f / inv_step taken in float at the
// 16-slice sweep of the MVS stage.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TX = 32;          // tile width (one warp per tile row)
constexpr int TY = 8;           // tile height
constexpr int MAX_T = 256;      // texel offsets per launch
constexpr int MAX_HALO = 16;    // largest |dv|, |du|

struct Offsets {
  short dv[MAX_T];
  short du[MAX_T];
};

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

__device__ __forceinline__ int wrap(int i, int n) {
  i %= n;
  return i < 0 ? i + n : i;
}

// SLAB: the block's views of the volume (all V <= VV of them, every slice,
// the tile plus halo) are staged in shared memory, and a texel's two slices
// are read there; otherwise from device memory through the strides.
template <int VV, int CC, bool SLAB>
__global__ void __launch_bounds__(TX * TY)
volscore_kernel(const __nv_bfloat16* __restrict__ vol, long long stride_v,
                int stride_d, const float* __restrict__ depth,
                const float* __restrict__ nrm, const float* __restrict__ rays,
                const float* __restrict__ gray, const Offsets offs, int T,
                int halo, int V, int C, int D, int H, int W, float inv0,
                float r_step, float dmin, float dmax, float r_sig,
                float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  const int SW = TX + 2 * halo;
  const int SH = TY + 2 * halo;
  const int SN = SW * SH;
  float* s_r0 = smem;
  float* s_r1 = s_r0 + SN;
  float* s_r2 = s_r1 + SN;
  float* s_g = s_r2 + SN;
  int* s_row = reinterpret_cast<int*>(s_g + SN);   // wrapped row * W, per halo row
  int* s_col = s_row + SH;                         // wrapped column, per halo column
  int* s_dl = s_col + SW;                          // dv * SW + du, per texel
  short* s_dv = reinterpret_cast<short*>(s_dl + T);
  short* s_du = s_dv + T;
  __nv_bfloat16* s_vol = reinterpret_cast<__nv_bfloat16*>(s_du + T);   // [V][D][SN]

  const int HW = H * W;
  const int x0 = blockIdx.x * TX;
  const int y0 = blockIdx.y * TY;
  const int tid = threadIdx.y * TX + threadIdx.x;
  for (int i = tid; i < SH; i += TX * TY) s_row[i] = wrap(y0 - halo + i, H) * W;
  for (int i = tid; i < SW; i += TX * TY) s_col[i] = wrap(x0 - halo + i, W);
  for (int i = tid; i < T; i += TX * TY) {
    s_dv[i] = offs.dv[i];
    s_du[i] = offs.du[i];
    s_dl[i] = offs.dv[i] * SW + offs.du[i];
  }
  __syncthreads();
  for (int i = tid; i < SN; i += TX * TY) {
    const int ly = i / SW;
    const int q = s_row[ly] + s_col[i - ly * SW];
    s_r0[i] = rays[q];
    s_r1[i] = rays[HW + q];
    s_r2[i] = rays[2 * HW + q];
    s_g[i] = gray[q];
    if (SLAB) {
      for (int v = 0; v < V; ++v) {
        const __nv_bfloat16* src = vol + v * stride_v + q;
        __nv_bfloat16* dst = s_vol + v * D * SN + i;
        for (int d = 0; d < D; ++d) dst[d * SN] = src[d * stride_d];
      }
    }
  }
  __syncthreads();

  const int x = x0 + threadIdx.x;
  const int y = y0 + threadIdx.y;
  if (x >= W || y >= H) return;
  const int p = y * W + x;
  const int ly0 = threadIdx.y + halo;
  const int lx0 = threadIdx.x + halo;
  const int lc = ly0 * SW + lx0;
  const float rp0 = s_r0[lc], rp1 = s_r1[lc], rp2 = s_r2[lc];
  const float g_c = s_g[lc];
  const float dmax_idx = (float)(D - 1);

  for (int v0 = 0; v0 < V; v0 += VV) {
    const __nv_bfloat16* vv[VV];
#pragma unroll
    for (int v = 0; v < VV; ++v) vv[v] = vol + (long long)min(v0 + v, V - 1) * stride_v;
    for (int c0 = 0; c0 < C; c0 += CC) {
      float n0[CC], n1[CC], n2[CC], rho[CC];
      float sw[CC], sx[CC], sxx[CC];
      float sy[VV][CC], syy[VV][CC], sxy[VV][CC];
#pragma unroll
      for (int j = 0; j < CC; ++j) {
        const int c = min(c0 + j, C - 1);
        n0[j] = nrm[(3 * c + 0) * HW + p];
        n1[j] = nrm[(3 * c + 1) * HW + p];
        n2[j] = nrm[(3 * c + 2) * HW + p];
        rho[j] = depth[c * HW + p] * dot3(n0[j], n1[j], n2[j], rp0, rp1, rp2);
        sw[j] = sx[j] = sxx[j] = 0.f;
#pragma unroll
        for (int v = 0; v < VV; ++v) sy[v][j] = syy[v][j] = sxy[v][j] = 0.f;
      }
      for (int t = 0; t < T; ++t) {
        // per (p, t)
        const int li = lc + s_dl[t];
        const int q = SLAB ? 0 : s_row[ly0 + s_dv[t]] + s_col[lx0 + s_du[t]];
        const float rt0 = s_r0[li], rt1 = s_r1[li], rt2 = s_r2[li];
        const float i_t = s_g[li];
        const float dg = i_t - g_c;
        const float e = expf(-(dg * dg) * r_sig);
#pragma unroll
        for (int j = 0; j < CC; ++j) {
          if (c0 + j >= C) continue;   // uniform across the block
          // per (c, p, t)
          const float den = clamp_den(dot3(n0[j], n1[j], n2[j], rt0, rt1, rt2));
          const float lam = rho[j] / den;
          float sigma = (1.f / fmaxf(lam, 1e-6f) - inv0) * r_step;
          sigma = fminf(fmaxf(sigma, 0.f), dmax_idx);
          const float s0 = floorf(sigma);
          const float f = sigma - s0;
          const float f1 = 1.f - f;
          const int i0 = (int)s0;
          const int idx = SLAB ? i0 * SN + li : i0 * stride_d + q;
          const bool has_hi = i0 + 1 < D;
          const float w = (lam > 0.f) ? e : 0.f;
          const float w_i = __fmul_rn(w, i_t);
          sw[j] = __fadd_rn(sw[j], w);
          sx[j] = __fadd_rn(sx[j], w_i);
          sxx[j] = add_mul(sxx[j], w_i, i_t);
#pragma unroll
          for (int v = 0; v < VV; ++v) {
            if (v0 + v >= V) continue;   // uniform across the block
            // per (v, c, p, t)
            float lo, hi = 0.f;
            if (SLAB) {
              const __nv_bfloat16* sv = s_vol + v * D * SN + idx;
              lo = __bfloat162float(sv[0]);
              if (has_hi) hi = __bfloat162float(sv[SN]);
            } else {
              lo = __bfloat162float(vv[v][idx]);
              if (has_hi) hi = __bfloat162float(vv[v][idx + stride_d]);
            }
            float s = __fmul_rn(f1, lo);
            if (has_hi) s = add_mul(s, f, hi);
            const float w_s = __fmul_rn(w, s);
            sy[v][j] = __fadd_rn(sy[v][j], w_s);
            syy[v][j] = add_mul(syy[v][j], w_s, s);
            sxy[v][j] = add_mul(sxy[v][j], w_i, s);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < CC; ++j) {
        const int c = c0 + j;
        if (c >= C) continue;
        const float d_p = depth[c * HW + p];
        const float eps = 1e-6f;
        const float sw_e = sw[j] + eps;
        const float mx = sx[j] / sw_e;
        const float vx = __fsub_rn(sxx[j] / sw_e, __fmul_rn(mx, mx));
        const bool valid = (sw[j] > 1e-3f) && (d_p > dmin) && (d_p < dmax);
#pragma unroll
        for (int v = 0; v < VV; ++v) {
          if (v0 + v >= V) continue;
          const float my = sy[v][j] / sw_e;
          const float vy = __fsub_rn(syy[v][j] / sw_e, __fmul_rn(my, my));
          const float cov = __fsub_rn(sxy[v][j] / sw_e, __fmul_rn(mx, my));
          float ncc = cov / sqrtf(fmaxf(vx * vy, 1e-12f));
          ncc = fminf(fmaxf(ncc, -1.f), 1.f);
          out[((v0 + v) * C + c) * HW + p] = valid ? 1.f - ncc : 2.f;
        }
      }
    }
  }
}

constexpr size_t SLAB_MAX_BYTES = 100 * 1024;   // two blocks per SM

template <int VV, int CC>
cudaError_t launch(const __nv_bfloat16* vol, long long stride_v, int stride_d,
                   const float* depth, const float* nrm, const float* rays,
                   const float* gray, const Offsets& offs, int T, int halo,
                   int V, int C, int D, int H, int W, float inv0, float r_step,
                   float dmin, float dmax, float r_sig, float* out,
                   cudaStream_t stream) {
  const int SW = TX + 2 * halo, SH = TY + 2 * halo;
  const size_t base = (size_t)4 * SW * SH * sizeof(float) +
                      (size_t)(SH + SW + T) * sizeof(int) + (size_t)2 * T * sizeof(short);
  const size_t slab = base + (size_t)V * D * SW * SH * sizeof(__nv_bfloat16);
  const dim3 block(TX, TY);
  const dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY);
  if (V <= VV && slab <= SLAB_MAX_BYTES) {
    const cudaError_t rc = cudaFuncSetAttribute(
        volscore_kernel<VV, CC, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)SLAB_MAX_BYTES);
    if (rc != cudaSuccess) return rc;
    volscore_kernel<VV, CC, true><<<grid, block, slab, stream>>>(
        vol, stride_v, stride_d, depth, nrm, rays, gray, offs, T, halo, V, C, D,
        H, W, inv0, r_step, dmin, dmax, r_sig, out);
  } else {
    volscore_kernel<VV, CC, false><<<grid, block, base, stream>>>(
        vol, stride_v, stride_d, depth, nrm, rays, gray, offs, T, halo, V, C, D,
        H, W, inv0, r_step, dmin, dmax, r_sig, out);
  }
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes. Device pointers of the tensors the Python
// wrapper allocated and checked; offsets is a HOST array of T (dv, du)
// int32 pairs, passed to the kernel by value. Nothing is allocated here and
// the launch goes on the caller's stream without synchronising. Returns
// cudaGetLastError() after the launch.
extern "C" int volscore_launch(const void* vol, long long stride_v,
                               long long stride_d, const void* depth,
                               const void* nrm, const void* rays,
                               const void* gray, const int* offsets, int T,
                               int V, int C, int D, int H, int W, float inv0,
                               float r_step, float dmin, float dmax,
                               float r_sig, void* out, void* stream) {
  if (T <= 0 || T > MAX_T || V <= 0 || C <= 0 || D <= 0 || H <= 0 || W <= 0 ||
      stride_d > INT32_MAX || (long long)(D - 1) * stride_d + (long long)H * W > INT32_MAX ||
      (long long)V * C * H * W > INT32_MAX || (long long)3 * C * H * W > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  Offsets offs;
  int halo = 0;
  for (int t = 0; t < T; ++t) {
    const int dv = offsets[2 * t], du = offsets[2 * t + 1];
    const int reach = dv < 0 ? -dv : dv;
    const int reach_u = du < 0 ? -du : du;
    if (reach > halo) halo = reach;
    if (reach_u > halo) halo = reach_u;
    offs.dv[t] = (short)dv;
    offs.du[t] = (short)du;
  }
  if (halo > MAX_HALO) return (int)cudaErrorInvalidValue;
  const auto* v = (const __nv_bfloat16*)vol;
  const auto s = (cudaStream_t)stream;
  cudaError_t rc;
  if (V <= 2)
    rc = launch<2, 4>(v, stride_v, (int)stride_d, (const float*)depth,
                      (const float*)nrm, (const float*)rays, (const float*)gray,
                      offs, T, halo, V, C, D, H, W, inv0, r_step, dmin, dmax,
                      r_sig, (float*)out, s);
  else
    rc = launch<4, 2>(v, stride_v, (int)stride_d, (const float*)depth,
                      (const float*)nrm, (const float*)rays, (const float*)gray,
                      offs, T, halo, V, C, D, H, W, inv0, r_step, dmin, dmax,
                      r_sig, (float*)out, s);
  return (int)rc;
}
