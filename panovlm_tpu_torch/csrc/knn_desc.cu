// Batched masked brute-force KNN for descriptors (SIFT matching, D = 128),
// with the reverse top-1 of mutual matching fused in.
//
// Replaces the Pallas TPU kernel panovlm_tpu/ops/pallas/knn.py:_knn_kernel
// (+ _topk_update), driven by knn_pallas_batched, at descriptor widths: the
// matcher of panovlm_tpu/utils/sift.py:_match_descriptors calls it as
// knn(d1, m1, d2, m2, k=2) and then k=1 the other way. csrc/knn.cu covers
// D <= 4; this file covers 4 < D <= 128 (D a multiple of 4), k <= 2.
//
// What it computes, per batch element b, query q and target t:
//   d2(q, t) = |q|^2 + |t|^2 - 2 q.t in fp32, clamped at 0; masked rows or
//   columns get 1e30. Forward: the k smallest d2 of each query in ascending
//   order, ties to the lower target index; a slot that no valid target
//   fills keeps d2 = 1e30 and index 0. Reverse (mutual launch): the
//   smallest d2 of each target over the queries, ties to the lower query
//   index, as a 64-bit key (float bits of d2 << 32 | query index) that the
//   wrapper initialises to (bits(1e30) << 32 | 0) and decodes. The (Q, T)
//   distance matrix is never stored, and one pass over it serves both
//   searches: the two launches it replaces formed it twice.
//
// What bounds it on the H100: at the Room matching shape (B = 16 pairs,
// Q = T = 8096, D = 128) a batch is 134 G multiply-adds over 133 MB of
// descriptors, so the products bound it. They run on the tensor cores in
// 3xTF32: each operand x splits into hi = tf32(x) and lo = tf32(x - hi),
// and each product is lo.hi + hi.lo + hi.hi accumulated in fp32, which is
// as accurate as fp32 FMA (the dropped lo.lo term is below 2^-22 of
// |x||y|). The tensor cores truncate as they accumulate, which over the
// 48 accumulations of a D = 128 dot in one accumulator shifted d2 by
// ~2e-6; so the hi.hi products of each 16 features sum into a fresh tile
// that joins the running sum with a rounded fp32 add, and the cross
// products (~2^-11 of the dot) keep an accumulator of their own. Plain
// TF32 is not used: it keeps ~3 decimal digits and the ratio test at 0.6^2
// turns that into flipped matches (ROADMAP F2). The bound is 3 TF32
// products per fp32 product at the dense TF32 rate, plus
// the per-pair epilogue at the fp32 rate (chip_smoke.py). The products go
// through mma.sync.m16n8k8 (warp-level); wgmma, the path to the full
// tensor rate, is later work.
//
// Design: a block of 512 threads (16 warps, 4 along the queries x 4 along
// the targets, each warp a 32 x 16 tile of 2 x 2 mma tiles) owns 128
// queries of one batch element. Their rows are loaded once with cp.async
// and split into hi / lo in shared memory; targets stream through a
// two-stage cp.async ring of 64-row tiles, split into hi / lo as the
// fragments are read. Fragments come by ldmatrix (four 8 x 4 tf32 matrices
// per instruction); shared rows are padded to 132 floats, so the eight
// rows of each matrix fall in distinct banks. The squared norms come from a
// prologue kernel, once per row per launch. After each target tile every
// thread folds its 16 distances into a per-row top-k held in registers,
// visiting its targets in ascending index order with a strict '<', so ties
// keep the lower index; for the reverse search it takes each column's
// minimum key over its 4 rows, then over the warp (shuffles), then over
// the 4 warps along the queries (shared memory), and issues one 64-bit
// atomicMin per (block, target). Integer minima do not depend on the order
// of the atomics, so the result is the same on every run. At the end the 16
// partial lists of each query merge through shared memory in (d2, index)
// order.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr float kBig = 1e30f;
constexpr int kBM = 128;        // queries per block
constexpr int kBN = 64;         // targets per tile
constexpr int kDmax = 128;      // widest descriptor
constexpr int kLd = kDmax + 4;  // padded shared row, in floats
constexpr int kWarpsN = 4;      // warps along the targets (4 along the queries)
constexpr int kWN = kBN / kWarpsN;          // targets per warp tile
constexpr int kNI = kWN / 8;                // mma n-tiles per warp tile
constexpr int kThreads = 4 * kWarpsN * 32;  // 16 warps
constexpr int kSlots = kWarpsN * 4;         // partial top-k lists per query: warps x lanes
constexpr unsigned long long kNoKey = ~0ull;

// shared memory layout, in floats
constexpr int kAHi = 0;                        // [kBM][kLd] query rows, tf32 hi
constexpr int kALo = kAHi + kBM * kLd;         // [kBM][kLd] query rows, tf32 lo
constexpr int kB = kALo + kBM * kLd;           // [2][kBN][kLd] target rows (raw fp32)
constexpr int kQn = kB + 2 * kBN * kLd;        // [kBM] query norms (1e30: masked)
constexpr int kTn = kQn + kBM;                 // [2][kBN] target norms
constexpr int kRev = kTn + 2 * kBN;            // [4][kBN] column keys (uint64)
constexpr size_t kSmemBytes = (size_t)kRev * 4 + 4 * kBN * sizeof(unsigned long long);
static_assert(kRev % 2 == 0, "the key array needs 8-byte alignment");
static_assert(kBM * kSlots * 2 * 2 <= 2 * kBN * kLd, "the final merge reuses the target ring");
static_assert(kNI % 2 == 0, "B fragments load two n-tiles per ldmatrix");

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// d += a * b, m16n8k8, tf32 inputs, fp32 accumulators
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a * b (a zero accumulator operand), m16n8k8, tf32 inputs
__device__ __forceinline__ void mma_zero(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

// four 8 x (4 x 32-bit) matrices from shared memory; lane i addresses row
// i % 8 of matrix i / 8, and receives element (lane / 4, lane % 4) of each
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows [r0, r0 + R_TILE) of a (rows, D) row-major matrix into s[R_TILE][kLd],
// features [0, Dp), zero outside the matrix
template <int R_TILE>
__device__ __forceinline__ void load_rows(const float* __restrict__ src, int rows,
                                          int D, int Dp, int r0, float* s) {
  const int nchunk = Dp >> 2;
  for (int e = threadIdx.x; e < R_TILE * nchunk; e += kThreads) {
    const int r = e / nchunk;
    const int c4 = (e - r * nchunk) * 4;
    const bool ok = r0 + r < rows && c4 < D;
    cp_async16(s + r * kLd + c4, ok ? src + (size_t)(r0 + r) * D + c4 : src, ok);
  }
}

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

// squared norm of each row of a (rows, D) matrix, one warp per row; 1e30
// where the row is masked
__global__ void norms_kernel(const float* __restrict__ x,
                             const uint8_t* __restrict__ mask, int rows, int D,
                             float* __restrict__ out) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  float s = 0.f;
  for (int k = lane * 4; k < D; k += 128) {
    const float4 v = *reinterpret_cast<const float4*>(x + (size_t)row * D + k);
    s = fmaf(v.x, v.x, s);
    s = fmaf(v.y, v.y, s);
    s = fmaf(v.z, v.z, s);
    s = fmaf(v.w, v.w, s);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane == 0) out[row] = mask[row] ? s : kBig;
}

template <int K, bool REV>
__global__ void __launch_bounds__(kThreads, 1)
knn_desc_kernel(const float* __restrict__ q, const float* __restrict__ t,
                const float* __restrict__ q_norm, const float* __restrict__ t_norm,
                int Q, int T, int D, float* __restrict__ out_d,
                int* __restrict__ out_i, unsigned long long* __restrict__ rev_key) {
  extern __shared__ __align__(16) float smem[];
  float* sAh = smem + kAHi;
  float* sAl = smem + kALo;
  float* sB = smem + kB;
  float* sQn = smem + kQn;
  float* sTn = smem + kTn;
  unsigned long long* sRev = reinterpret_cast<unsigned long long*>(smem + kRev);

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kBM;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wm = (tid >> 5) & 3;   // warp row: queries wm*32 .. +31
  const int wn = tid >> 7;         // warp column: targets wn*kWN .. of a tile
  const int g = lane >> 2;
  const int tig = lane & 3;
  const float* qb = q + (size_t)b * Q * D;
  const float* tb = t + (size_t)b * T * D;
  const float* tnb = t_norm + (size_t)b * T;
  const int Dp = (D + 15) & ~15;   // the k-loop takes 16 features a step
  const int nT = (T + kBN - 1) / kBN;

  load_rows<kBM>(qb, Q, D, Dp, q0, sAh);
  cp_async_commit();
  load_rows<kBN>(tb, T, D, Dp, 0, sB);
  cp_async_commit();
  if (tid < kBM) sQn[tid] = q0 + tid < Q ? q_norm[(size_t)b * Q + q0 + tid] : kBig;
  if (tid < kBN) sTn[tid] = tid < T ? tnb[tid] : kBig;
  cp_async_wait<1>();
  __syncthreads();
  for (int e = tid; e < kBM * Dp; e += kThreads) {   // query rows -> hi, lo
    const int r = e / Dp;
    const int o = r * kLd + (e - r * Dp);
    uint32_t hi, lo;
    split(sAh[o], hi, lo);
    sAh[o] = __uint_as_float(hi);
    sAl[o] = __uint_as_float(lo);
  }

  // per-lane ldmatrix row addresses of the warp's A rows (matrix lane / 8:
  // rows +8 for odd, columns +4 for the upper two)
  const int a_row = wm * 32 + ((lane >> 3) & 1) * 8 + (lane & 7);
  const int a_col = (lane >> 4) * 4;
  const unsigned a_hi = static_cast<unsigned>(__cvta_generic_to_shared(sAh + a_row * kLd + a_col));
  const unsigned a_lo = static_cast<unsigned>(__cvta_generic_to_shared(sAl + a_row * kLd + a_col));

  float bd[4][K];
  int bi[4][K];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < K; ++c) {
      bd[r][c] = kBig;
      bi[r][c] = 0;
    }

  for (int it = 0; it < nT; ++it) {
    const int st = it & 1;
    if (it + 1 < nT) {
      const int t1 = (it + 1) * kBN;
      load_rows<kBN>(tb, T, D, Dp, t1, sB + (st ^ 1) * kBN * kLd);
      cp_async_commit();
      if (tid < kBN) sTn[(st ^ 1) * kBN + tid] = t1 + tid < T ? tnb[t1 + tid] : kBig;
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // The tensor cores truncate as they accumulate, by up to an ulp of the
    // running sum each time. So the hi.hi products of each 16 features sum
    // into a fresh tile (`part`, a small magnitude), which joins `acc` with a
    // rounded fp32 add; the cross products lo.hi + hi.lo, ~2^-11 of the dot,
    // run in their own accumulator `accx`, whose truncation is negligible.
    float acc[2][kNI][4], accx[2][kNI][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < kNI; ++ni)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[mi][ni][r] = accx[mi][ni][r] = 0.f;

    const unsigned b_base = static_cast<unsigned>(__cvta_generic_to_shared(
        sB + (st * kBN + wn * kWN + (lane >> 4) * 8 + (lane & 7)) * kLd + ((lane >> 3) & 1) * 4));
    for (int k0 = 0; k0 < Dp; k0 += 16) {
      float part[2][kNI][4];
#pragma unroll
      for (int kk = 0; kk < 16; kk += 8) {
        const int k = k0 + kk;
        // fragments by ldmatrix: A (16 x 8 per mi) as matrices (rows +0/+8,
        // columns +0/+4), i.e. a0..a3; B two n-tiles at a time as (n-tile,
        // columns +0/+4), i.e. b0, b1 of ni and of ni + 1
        uint32_t ah[2][4], al[2][4], b[kNI / 2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          ldsm_x4(ah[mi], a_hi + (mi * 16 * kLd + k) * 4);
          ldsm_x4(al[mi], a_lo + (mi * 16 * kLd + k) * 4);
        }
#pragma unroll
        for (int np = 0; np < kNI / 2; ++np) ldsm_x4(b[np], b_base + (np * 16 * kLd + k) * 4);
#pragma unroll
        for (int ni = 0; ni < kNI; ++ni) {
          uint32_t bh0, bl0, bh1, bl1;
          split(__uint_as_float(b[ni >> 1][(ni & 1) * 2]), bh0, bl0);
          split(__uint_as_float(b[ni >> 1][(ni & 1) * 2 + 1]), bh1, bl1);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            if (kk == 0)
              mma_zero(part[mi][ni], ah[mi], bh0, bh1);
            else
              mma(part[mi][ni], ah[mi], bh0, bh1);
            mma(accx[mi][ni], al[mi], bh0, bh1);
            mma(accx[mi][ni], ah[mi], bl0, bl1);
          }
        }
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < kNI; ++ni)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[mi][ni][r] = __fadd_rn(acc[mi][ni][r], part[mi][ni][r]);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < kNI; ++ni)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[mi][ni][r] = __fadd_rn(acc[mi][ni][r], accx[mi][ni][r]);

    // epilogue: accumulator r of tile (mi, ni) is row mi*16 + (r >> 1)*8 + g,
    // column ni*8 + tig*2 + (r & 1) of the warp's 32 x kWN tile
    const float* tn = sTn + st * kBN;
    const int t0 = it * kBN;
    unsigned long long ck[kNI][2];
#pragma unroll
    for (int ni = 0; ni < kNI; ++ni) ck[ni][0] = ck[ni][1] = kNoKey;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = wm * 32 + mi * 16 + h * 8 + g;
        const float qn = sQn[row];
#pragma unroll
        for (int ni = 0; ni < kNI; ++ni)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = wn * kWN + ni * 8 + tig * 2 + e;
            const float tnv = tn[col];
            if (qn >= kBig || tnv >= kBig) continue;
            const float d2 = fmaxf((qn + tnv) - 2.0f * acc[mi][ni][h * 2 + e], 0.0f) + 0.0f;
            insert<K>(bd[mi * 2 + h], bi[mi * 2 + h], d2, t0 + col);
            if (REV) {
              const unsigned long long key =
                  ((unsigned long long)__float_as_uint(d2) << 32) | (unsigned)(q0 + row);
              ck[ni][e] = key < ck[ni][e] ? key : ck[ni][e];
            }
          }
      }
    if (REV) {
#pragma unroll
      for (int ni = 0; ni < kNI; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
#pragma unroll
          for (int o = 4; o < 32; o <<= 1) {
            const unsigned long long other = __shfl_xor_sync(0xffffffffu, ck[ni][e], o);
            ck[ni][e] = other < ck[ni][e] ? other : ck[ni][e];
          }
          if (g == 0) sRev[wm * kBN + wn * kWN + ni * 8 + tig * 2 + e] = ck[ni][e];
        }
    }
    __syncthreads();   // sRev complete; ring stage st and sTn[st] free again
    if (REV && tid < kBN) {
      unsigned long long key = sRev[tid];
#pragma unroll
      for (int w = 1; w < 4; ++w) key = sRev[w * kBN + tid] < key ? sRev[w * kBN + tid] : key;
      if (key != kNoKey) atomicMin(rev_key + (size_t)b * T + t0 + tid, key);
    }
  }

  // merge the kSlots partial lists of each query (warps x lanes) in
  // (d2, index) order; the target ring is free after the loop's last sync
  float* sMD = sB;
  int* sMI = reinterpret_cast<int*>(sB + kBM * kSlots * K);
  const int slot = wn * 4 + tig;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = wm * 32 + (r >> 1) * 16 + (r & 1) * 8 + g;
#pragma unroll
    for (int c = 0; c < K; ++c) {
      sMD[(row * kSlots + slot) * K + c] = bd[r][c];
      sMI[(row * kSlots + slot) * K + c] = bi[r][c];
    }
  }
  __syncthreads();
  if (tid < kBM && q0 + tid < Q) {
    float md[K];
    int mi_[K];
#pragma unroll
    for (int c = 0; c < K; ++c) {
      md[c] = kBig;
      mi_[c] = 0;
    }
    for (int s = 0; s < kSlots; ++s) {
#pragma unroll
      for (int c = 0; c < K; ++c) {
        const float d = sMD[(tid * kSlots + s) * K + c];
        const int j = sMI[(tid * kSlots + s) * K + c];
        if (d >= kBig) continue;
        // insertion in (d2, index) order: an equal distance at a lower
        // index goes first, as the stable plain version orders it
        if (d < md[K - 1] || (d == md[K - 1] && j < mi_[K - 1])) {
          md[K - 1] = d;
          mi_[K - 1] = j;
#pragma unroll
          for (int u = K - 1; u > 0; --u) {
            if (md[u] < md[u - 1] || (md[u] == md[u - 1] && mi_[u] < mi_[u - 1])) {
              const float td = md[u];
              md[u] = md[u - 1];
              md[u - 1] = td;
              const int ti = mi_[u];
              mi_[u] = mi_[u - 1];
              mi_[u - 1] = ti;
            }
          }
        }
      }
    }
    const size_t o = ((size_t)b * Q + q0 + tid) * K;
#pragma unroll
    for (int c = 0; c < K; ++c) {
      out_d[o + c] = md[c];
      out_i[o + c] = mi_[c];
    }
  }
}

template <int K, bool REV>
cudaError_t launch_main(const float* q, const float* t, const float* qn,
                        const float* tn, int B, int Q, int T, int D, float* out_d,
                        int* out_i, unsigned long long* rev_key, cudaStream_t s) {
  cudaError_t rc = cudaFuncSetAttribute(knn_desc_kernel<K, REV>,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        (int)kSmemBytes);
  if (rc != cudaSuccess) return rc;
  const dim3 grid((Q + kBM - 1) / kBM, B);
  knn_desc_kernel<K, REV><<<grid, kThreads, kSmemBytes, s>>>(q, t, qn, tn, Q, T, D,
                                                             out_d, out_i, rev_key);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes. Pointers are device pointers of contiguous
// tensors allocated by the Python wrapper (q, t 16-byte aligned, D % 4 == 0,
// D <= 128): norms is scratch for B * (Q + T) floats; rev_key (B, T) uint64
// keys, initialised by the caller, is read only when reverse != 0 (k = 2).
// Nothing is allocated here; the launches (the norm prologue, then the
// main kernel) go on the caller's stream without synchronising. Returns
// cudaGetLastError() after the launches.
extern "C" int knn_desc_launch(const float* q, const uint8_t* q_mask,
                               const float* t, const uint8_t* t_mask, int B,
                               int Q, int T, int D, int k, int reverse,
                               float* norms, float* out_d, int* out_i,
                               unsigned long long* rev_key, void* stream) {
  if (B <= 0 || Q <= 0) return 0;
  if (D <= 0 || D % 4 != 0 || D > kDmax || T <= 0 || B > 65535 ||
      (reverse && k != 2))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows_per_block = 256 / 32;
  const long long nq = (long long)B * Q, nt = (long long)B * T;
  norms_kernel<<<(int)((nq + rows_per_block - 1) / rows_per_block), 256, 0, s>>>(
      q, q_mask, (int)nq, D, norms);
  norms_kernel<<<(int)((nt + rows_per_block - 1) / rows_per_block), 256, 0, s>>>(
      t, t_mask, (int)nt, D, norms + nq);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  if (reverse)
    rc = launch_main<2, true>(q, t, norms, norms + nq, B, Q, T, D, out_d, out_i, rev_key, s);
  else if (k == 1)
    rc = launch_main<1, false>(q, t, norms, norms + nq, B, Q, T, D, out_d, out_i, nullptr, s);
  else if (k == 2)
    rc = launch_main<2, false>(q, t, norms, norms + nq, B, Q, T, D, out_d, out_i, nullptr, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)rc;
}
