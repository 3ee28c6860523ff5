// Batched masked brute-force KNN, with optional nearest-per-ring candidates.
//
// Replaces the Pallas TPU kernels in panovlm_tpu/ops/pallas/knn.py:
//   _knn_kernel (+ _topk_update)  -> knn_kernel<K, false>
//   _knn_ring_kernel              -> knn_kernel<K, true>
//
// What it computes, per batch element b and query q:
//   d2(q, t) = |q|^2 + |t|^2 - 2 q.t in fp32, clamped at 0; rows or columns
//   that are masked out get 1e30. The k smallest d2 in ascending order, ties
//   to the lower target index (insertion is strict on '<' and targets are
//   visited in index order, as the Pallas top-k update keeps them). With
//   RING, also the nearest target whose ring id equals q_row + dr for each
//   of four offsets dr; an absent ring keeps d2 = 1e30 and index 0.
//
// What bounds it on the H100: at the association shapes (D = 3, Q = T =
// 1024 for point->line, Q = 512 x T = 4096 for point->plane) one pair reads
// at most 4096 x 16 B of targets, so bytes are small and the kernel is bound
// by FP32 instruction throughput (3 FMAs + the norm terms per distance) plus
// the selection compares. Distances use FMAs on the FP32 pipes and no tensor
// cores: at
// D <= 4 a tensor-core product would need TF32 or padding and would lose the
// fp32 exactness the reference pins (Precision.HIGHEST).
//
// Design (simple and right first): one thread per query keeps its top-k in
// registers (the compare-swap chain is fully unrolled over the template K,
// so the list never leaves registers); the block stages target tiles
// (xyz, |t|^2, ring id) in shared memory and every thread of the block
// reads each staged target as a broadcast. Grid (ceil(Q/threads), B); each
// block walks all target tiles itself, in place of the TPU's sequential T
// grid axis. wgmma, TMA and warp-level selection are left for later work.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr float kBig = 1e30f;
constexpr int kThreads = 128;
constexpr int kTileT = 512;
constexpr int kNoRing = -10000;

template <int K, bool RING>
__global__ void __launch_bounds__(kThreads)
knn_kernel(const float* __restrict__ q, const uint8_t* __restrict__ q_mask,
           const float* __restrict__ t, const uint8_t* __restrict__ t_mask,
           const int* __restrict__ q_row, const int* __restrict__ t_row,
           int Q, int T, int D, int4 drs,
           float* __restrict__ out_d, int* __restrict__ out_i,
           float* __restrict__ ring_d, int* __restrict__ ring_i) {
  __shared__ float4 s_xyz[kTileT];
  __shared__ float s_norm[kTileT];
  __shared__ int s_row[RING ? kTileT : 1];

  const int b = blockIdx.y;
  const int qi = blockIdx.x * kThreads + threadIdx.x;
  const bool active = qi < Q;
  const float* qb = q + (size_t)b * Q * D;
  const float* tb = t + (size_t)b * T * D;

  float qx = 0.f, qy = 0.f, qz = 0.f, qw = 0.f, qn = kBig;
  int qr = kNoRing;
  if (active) {
    const float* p = qb + (size_t)qi * D;
    qx = p[0];
    if (D > 1) qy = p[1];
    if (D > 2) qz = p[2];
    if (D > 3) qw = p[3];
    if (q_mask[(size_t)b * Q + qi]) {
      qn = qx * qx;
      qn = fmaf(qy, qy, qn);
      qn = fmaf(qz, qz, qn);
      qn = fmaf(qw, qw, qn);
    }
    if (RING) qr = q_row[(size_t)b * Q + qi];
  }

  float bd[K];
  int bi[K];
#pragma unroll
  for (int c = 0; c < K; ++c) {
    bd[c] = kBig;
    bi[c] = 0;
  }
  float rd[4] = {kBig, kBig, kBig, kBig};
  int ri[4] = {0, 0, 0, 0};
  const int want[4] = {qr + drs.x, qr + drs.y, qr + drs.z, qr + drs.w};

  for (int t0 = 0; t0 < T; t0 += kTileT) {
    for (int j = threadIdx.x; j < kTileT; j += kThreads) {
      const int tj = t0 + j;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      float n = kBig;
      int r = kNoRing;
      if (tj < T) {
        const float* p = tb + (size_t)tj * D;
        v.x = p[0];
        if (D > 1) v.y = p[1];
        if (D > 2) v.z = p[2];
        if (D > 3) v.w = p[3];
        if (t_mask[(size_t)b * T + tj]) {
          n = v.x * v.x;
          n = fmaf(v.y, v.y, n);
          n = fmaf(v.z, v.z, n);
          n = fmaf(v.w, v.w, n);
        }
        if (RING) r = t_row[(size_t)b * T + tj];
      }
      s_xyz[j] = v;
      s_norm[j] = n;
      if (RING) s_row[j] = r;
    }
    __syncthreads();
    if (active) {
      const int n_tile = min(kTileT, T - t0);
      for (int j = 0; j < n_tile; ++j) {
        const float4 v = s_xyz[j];
        const float tn = s_norm[j];
        float dot = qx * v.x;
        dot = fmaf(qy, v.y, dot);
        dot = fmaf(qz, v.z, dot);
        dot = fmaf(qw, v.w, dot);
        float d2 = fmaxf((qn + tn) - 2.0f * dot, 0.0f);
        if (tn >= kBig || qn >= kBig) d2 = kBig;
        const int gj = t0 + j;
        if (RING) {
          const int tr = s_row[j];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            if (tr == want[c] && d2 < rd[c]) {
              rd[c] = d2;
              ri[c] = gj;
            }
          }
        }
        if (d2 < bd[K - 1]) {
          bd[K - 1] = d2;
          bi[K - 1] = gj;
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
    }
    __syncthreads();
  }

  if (active) {
    const size_t o = ((size_t)b * Q + qi) * K;
#pragma unroll
    for (int c = 0; c < K; ++c) {
      out_d[o + c] = bd[c];
      out_i[o + c] = bi[c];
    }
    if (RING) {
      const size_t r = ((size_t)b * Q + qi) * 4;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        ring_d[r + c] = rd[c];
        ring_i[r + c] = ri[c];
      }
    }
  }
}

template <bool RING>
cudaError_t launch(const float* q, const uint8_t* qm, const float* t,
                   const uint8_t* tm, const int* q_row, const int* t_row,
                   int B, int Q, int T, int D, int k, int4 drs, float* out_d,
                   int* out_i, float* ring_d, int* ring_i,
                   cudaStream_t stream) {
  const dim3 grid((Q + kThreads - 1) / kThreads, B);
  const dim3 block(kThreads);
#define KNN_CASE(KK)                                                         \
  case KK:                                                                   \
    knn_kernel<KK, RING><<<grid, block, 0, stream>>>(                        \
        q, qm, t, tm, q_row, t_row, Q, T, D, drs, out_d, out_i, ring_d,      \
        ring_i);                                                             \
    break;
  switch (k) {
    KNN_CASE(1) KNN_CASE(2) KNN_CASE(3) KNN_CASE(4) KNN_CASE(5) KNN_CASE(6)
    KNN_CASE(7) KNN_CASE(8) KNN_CASE(9) KNN_CASE(10) KNN_CASE(11)
    KNN_CASE(12) KNN_CASE(13) KNN_CASE(14) KNN_CASE(15) KNN_CASE(16)
    default:
      return cudaErrorInvalidValue;
  }
#undef KNN_CASE
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes. Pointers are device pointers of contiguous
// tensors allocated by the Python wrapper; nothing is allocated here and the
// launch goes on the caller's stream without synchronising. ring != 0
// selects the ring variant (q_row, t_row, ring_d, ring_i then required).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int knn_launch(const float* q, const uint8_t* q_mask,
                          const float* t, const uint8_t* t_mask,
                          const int* q_row, const int* t_row, int B, int Q,
                          int T, int D, int k, int ring, int dr0, int dr1,
                          int dr2, int dr3, float* out_d, int* out_i,
                          float* ring_d, int* ring_i, void* stream) {
  if (B <= 0 || Q <= 0) return 0;
  if (D < 1 || D > 4 || T < 0 || B > 65535) return (int)cudaErrorInvalidValue;
  const int4 drs = make_int4(dr0, dr1, dr2, dr3);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      ring ? launch<true>(q, q_mask, t, t_mask, q_row, t_row, B, Q, T, D, k,
                          drs, out_d, out_i, ring_d, ring_i, s)
           : launch<false>(q, q_mask, t, t_mask, q_row, t_row, B, Q, T, D, k,
                           drs, out_d, out_i, ring_d, ring_i, s);
  return (int)err;
}
