// Batched masked brute-force KNN for descriptors (SIFT matching, D = 128).
//
// Replaces the Pallas TPU kernel panovlm_tpu/ops/pallas/knn.py:_knn_kernel
// (+ _topk_update), driven by knn_pallas_batched, at descriptor widths: the
// matcher of panovlm_tpu/utils/sift.py:_match_descriptors calls it as
// knn(d1, m1, d2, m2, k=2) and then k=1 the other way. csrc/knn.cu covers
// D <= 4; this file covers 4 < D (D a multiple of 4), k <= 2.
//
// What it computes, per batch element b and query q:
//   d2(q, t) = |q|^2 + |t|^2 - 2 q.t in fp32, clamped at 0; masked rows or
//   columns get 1e30. The k smallest d2 in ascending order, ties to the
//   lower target index; a slot that no valid target fills keeps d2 = 1e30
//   and index 0. The (Q, T) distance matrix is never stored.
//
// What bounds it on the H100: at the Room matching shape (Q = T = 8096,
// D = 128) a pair is 8.4 G multiply-adds over 8 MB of descriptors, so the
// kernel is bound by arithmetic. It uses fp32 FMAs on the SIMT pipes and no
// tensor cores: TF32 keeps ~3 decimal digits, and the ratio test at 0.6^2
// turns that rounding into flipped matches (ROADMAP F2). wgmma with 3xTF32
// and TMA loads are later work.
//
// Design (a classic tiled fp32 SGEMM with a top-k epilogue): a block of 256
// threads owns 64 queries of one batch element and streams the targets
// through shared memory in tiles of 64, the feature axis in chunks of 32.
// Thread (tx, ty) accumulates a 4 x 4 register tile of dot products for
// queries ty + 16 i and targets tx + 16 j. After each target tile every
// thread folds its 16 distances into a per-query top-k held in registers,
// visiting its targets in ascending index order with a strict '<', so ties
// keep the lower index. At the end the 16 partial lists of each query are
// merged through shared memory in (d2, index) order. The squared norms come
// from the same shared-memory tiles: threads 0-63 sum the query rows (first
// target tile only), threads 64-127 the target rows.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr float kBig = 1e30f;
constexpr int kBM = 64;        // queries per block
constexpr int kBN = 64;        // targets per tile
constexpr int kBK = 32;        // feature chunk
constexpr int kThreads = 256;  // 16 x 16
constexpr int kPad = 4;        // keeps the transposed rows 16-byte aligned

template <int K>
__device__ __forceinline__ void insert(float (&bd)[K], int (&bi)[K], float d,
                                       int j) {
  if (d < bd[K - 1]) {
    bd[K - 1] = d;
    bi[K - 1] = j;
#pragma unroll
    for (int c = K - 1; c > 0; --c) {
      if (bd[c] < bd[c - 1]) {
        const float td = bd[c];
        bd[c] = bd[c - 1];
        bd[c - 1] = td;
        const int ti = bi[c];
        bi[c] = bi[c - 1];
        bi[c - 1] = ti;
      }
    }
  }
}

// Loads rows [r0, r0 + 64) x features [k0, k0 + 32) of a (R, D) row-major
// matrix into s[k][r] (transposed), zero outside the matrix.
__device__ __forceinline__ void load_tile(const float* __restrict__ src,
                                          int R, int D, int r0, int k0,
                                          float (*s)[kBM + kPad]) {
#pragma unroll
  for (int rep = 0; rep < 2; ++rep) {
    const int e = threadIdx.x + kThreads * rep;  // 512 float4 per tile
    const int r = e >> 3;
    const int c4 = (e & 7) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < R && k0 + c4 < D)
      v = *reinterpret_cast<const float4*>(src + (size_t)(r0 + r) * D + k0 + c4);
    s[c4 + 0][r] = v.x;
    s[c4 + 1][r] = v.y;
    s[c4 + 2][r] = v.z;
    s[c4 + 3][r] = v.w;
  }
}

template <int K>
__global__ void __launch_bounds__(kThreads)
knn_desc_kernel(const float* __restrict__ q, const uint8_t* __restrict__ q_mask,
                const float* __restrict__ t, const uint8_t* __restrict__ t_mask,
                int Q, int T, int D, float* __restrict__ out_d,
                int* __restrict__ out_i) {
  __shared__ __align__(16) float sQ[kBK][kBM + kPad];
  __shared__ __align__(16) float sT[kBK][kBN + kPad];
  __shared__ float sQn[kBM];
  __shared__ float sTn[kBN];
  __shared__ float sMD[kBM][16][K];
  __shared__ int sMI[kBM][16][K];

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kBM;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const float* qb = q + (size_t)b * Q * D;
  const float* tb = t + (size_t)b * T * D;

  float bd[4][K];
  int bi[4][K];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < K; ++c) {
      bd[i][c] = kBig;
      bi[i][c] = 0;
    }
  float qn_part = 0.f;

  for (int t0 = 0; t0 < T; t0 += kBN) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    float tn_part = 0.f;

    for (int k0 = 0; k0 < D; k0 += kBK) {
      load_tile(qb, Q, D, q0, k0, sQ);
      load_tile(tb, T, D, t0, k0, sT);
      __syncthreads();
      if (tid < kBM) {
        if (t0 == 0) {
#pragma unroll 8
          for (int k = 0; k < kBK; ++k) qn_part = fmaf(sQ[k][tid], sQ[k][tid], qn_part);
        }
      } else if (tid < kBM + kBN) {
        const int c = tid - kBM;
#pragma unroll 8
        for (int k = 0; k < kBK; ++k) tn_part = fmaf(sT[k][c], sT[k][c], tn_part);
      }
#pragma unroll 8
      for (int k = 0; k < kBK; ++k) {
        float a[4], v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = sQ[k][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = sT[k][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], v[j], acc[i][j]);
      }
      __syncthreads();
    }

    if (tid < kBM) {
      if (t0 == 0) {
        const int r = q0 + tid;
        sQn[tid] = (r < Q && q_mask[(size_t)b * Q + r]) ? qn_part : kBig;
      }
    } else if (tid < kBM + kBN) {
      const int c = tid - kBM;
      const int col = t0 + c;
      sTn[c] = (col < T && t_mask[(size_t)b * T + col]) ? tn_part : kBig;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float qn = sQn[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float tn = sTn[c];
        float d2 = fmaxf((qn + tn) - 2.0f * acc[i][j], 0.0f);
        if (qn >= kBig || tn >= kBig) d2 = kBig;
        insert<K>(bd[i], bi[i], d2, t0 + c);
      }
    }
    __syncthreads();   // sTn is rewritten by the next tile
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < K; ++c) {
      sMD[ty + 16 * i][tx][c] = bd[i][c];
      sMI[ty + 16 * i][tx][c] = bi[i][c];
    }
  __syncthreads();

  if (tid < kBM && q0 + tid < Q) {
    float md[K];
    int mi[K];
#pragma unroll
    for (int c = 0; c < K; ++c) {
      md[c] = kBig;
      mi[c] = 0;
    }
    for (int lane = 0; lane < 16; ++lane) {
#pragma unroll
      for (int c = 0; c < K; ++c) {
        const float d = sMD[tid][lane][c];
        const int j = sMI[tid][lane][c];
        if (d >= kBig) continue;
        // insertion in (d2, index) order: an equal distance at a lower
        // index goes first, as the stable plain version orders it
        if (d < md[K - 1] || (d == md[K - 1] && j < mi[K - 1])) {
          md[K - 1] = d;
          mi[K - 1] = j;
#pragma unroll
          for (int s = K - 1; s > 0; --s) {
            if (md[s] < md[s - 1] || (md[s] == md[s - 1] && mi[s] < mi[s - 1])) {
              const float td = md[s];
              md[s] = md[s - 1];
              md[s - 1] = td;
              const int ti = mi[s];
              mi[s] = mi[s - 1];
              mi[s - 1] = ti;
            }
          }
        }
      }
    }
    const size_t o = ((size_t)b * Q + q0 + tid) * K;
#pragma unroll
    for (int c = 0; c < K; ++c) {
      out_d[o + c] = md[c];
      out_i[o + c] = mi[c];
    }
  }
}

}  // namespace

// Plain C entry point for ctypes. Pointers are device pointers of contiguous
// tensors allocated by the Python wrapper (q, t 16-byte aligned, D % 4 == 0);
// nothing is allocated here and the launch goes on the caller's stream
// without synchronising. Returns cudaGetLastError() after the launch.
extern "C" int knn_desc_launch(const float* q, const uint8_t* q_mask,
                               const float* t, const uint8_t* t_mask, int B,
                               int Q, int T, int D, int k, float* out_d,
                               int* out_i, void* stream) {
  if (B <= 0 || Q <= 0) return 0;
  if (D <= 0 || D % 4 != 0 || T < 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((Q + kBM - 1) / kBM, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1:
      knn_desc_kernel<1><<<grid, kThreads, 0, s>>>(q, q_mask, t, t_mask, Q, T,
                                                   D, out_d, out_i);
      break;
    case 2:
      knn_desc_kernel<2><<<grid, kThreads, 0, s>>>(q, q_mask, t, t_mask, Q, T,
                                                   D, out_d, out_i);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
