// Batched masked brute-force KNN, with optional nearest-per-ring candidates.
//
// Replaces the Pallas TPU kernels in panovlm_tpu/ops/pallas/knn.py:
//   _knn_kernel (+ _topk_update)  -> knn_kernel<K, false, W4>
//   _knn_ring_kernel              -> knn_kernel<K, true, W4>
// (W4: D = 4. D <= 3 leaves out the fourth coordinate's product, which the
// first version of this kernel took on a zero coordinate: the same bits, and
// on the H100 at the odometry stage's inputs K2 ran 8 % faster without it.)
//
// What it computes, per batch element b and query q:
//   d2(q, t) = |q|^2 + |t|^2 - 2 q.t in fp32, clamped at 0; rows or columns
//   that are masked out get 1e30. The k smallest d2 in ascending order, ties
//   to the lower target index; a slot that no valid target fills holds 1e30
//   and index 0. With RING, also the nearest target whose ring id equals
//   q_row + dr for each of four offsets dr; an absent ring keeps 1e30 and 0.
//
// What bounds it on the H100: at the odometry stage's shapes (D = 3;
// point->line Q = T = 1024, k = 5; point->plane Q = 512, T = 4096, k = 10,
// B = a round's ~3,500 pairs) the bytes are small and the work is the
// FP32 instructions per valid (query, target) pair: 3 multiply-adds for the
// product, the norm sum, the top-k filter and, with RING, the ring minimum.
//
// Design:
// - Masked work is skipped. Each block compacts the valid queries of its
//   batch element (each thread reads kScan consecutive mask entries; a
//   shuffle scan and a prefix over the warps give the positions) and
//   takes kThreads * R of them by rank; a masked query costs only its
//   outputs, (1e30, 0), written element by element (coalesced). Targets are
//   staged into shared memory compacted the same way, with their original
//   index, so the loop runs over valid targets only. No per-pair mask test
//   is left.
// - Strided tiles: with nv valid targets, tile u of nt = ceil(nv / kTile)
//   holds targets u, u + nt, u + 2 nt, ... The stage's targets come ordered
//   by ring and, along a ring, by azimuth, so in index order the running
//   k-th distance of a query falls slowly and every target of a sweep that
//   approaches the query gets inserted; a strided tile samples the whole
//   cloud, and the first tile already gives a tight k-th distance. Tiles
//   leave index order, so the lists and the ring minima order entries by
//   (d2, index): the result is the one of the sequential strict '<' in
//   index order.
// - Latency: the pair loop is a short dependent chain per target, so the
//   design buys parallel chains: a step takes kUnroll staged targets (x, y,
//   z, |t|^2 in one float4 each, broadcast reads; at D = 4 the fourth
//   coordinate beside them), and each thread holds R queries (4 at k <= 6;
//   1 above, where k = 10 plus 4 ring slots stay in registers and six
//   blocks share an SM).
// - Selection: every pair writes (d2, tile position) to its query's queue
//   in shared memory and counts it only if it is at or below the k-th
//   distance, so the filter costs no branch. When a warp vote finds a
//   queue nearly full, and at the end of every tile, each lane merges its
//   queues into its register lists (the unrolled compare-swap chain,
//   re-checking each entry against the current k-th): a warp pays for a
//   chain once per batch of candidates, not whenever one of its lanes
//   inserts.
// - Rings: the staged tiles of the stage's targets split into runs of one
//   ring. For each run a query decides once whether that ring fills one of
//   its ring slots, and the loop keeps the run's minimum and its position
//   with a predicated update (three instructions a pair, no per-offset
//   compares); at the run's end the minimum joins its slot. The stage's
//   targets come sorted by ring (gather_masked compacts the range image in
//   row-major order), and a strided tile keeps that order; unsorted rings
//   are still right, as runs of one target.
// - The per-pair arithmetic is that of the first version, in the same order
//   (qx*vx, the fmaf chain, (qn + tn) - 2 dot, fmaxf), so the outputs equal
//   that kernel's bit for bit.
// - No tensor cores: at D <= 4 the product is three FMAs; plain TF32 would
//   lose the fp32 exactness the reference pins (Precision.HIGHEST), and
//   3xTF32 on mma.sync m16n8k8 would pad D = 3 to 8 and triple it, while the
//   selection and the ring minima, not the product, are most of the
//   instructions.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr float kBig = 1e30f;
constexpr float kNever = -1e30f;   // threshold of an empty slot: no d2 is below it
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 256;    // valid targets staged per round
constexpr int kQueue = 8;     // candidates a query holds before a merge
constexpr int kUnroll = 4;    // staged targets per step of the pair loop
constexpr int kScan = 8;      // consecutive mask entries a thread reads per scan round
constexpr unsigned kFull = 0xffffffffu;

// Queries per thread: four at k <= 6 (K1's k = 5: one staged target feeds
// four chains, and its time is its bytes), one above (K2's k = 10 and four
// ring slots: at most 85 registers let six blocks share an SM, and on the
// H100 more warps hid the pair loop's latency better than more queries per
// thread did).
template <int K>
struct Slots {
  static constexpr int R = K <= 6 ? 4 : 1;
  static constexpr int min_blocks = R == 1 ? 6 : 1;   // __launch_bounds__
};

// (d, i) before (e, j) in the order of the result: by distance, ties to the
// lower index.
__device__ __forceinline__ bool before(float d, int i, float e, int j) {
  return d < e || (d == e && i < j);
}

// Insert (d, i) into the ascending list if it comes before the k-th entry.
template <int K>
__device__ __forceinline__ void insert(float (&bd)[K], int (&bi)[K], float d, int i) {
  if (!before(d, i, bd[K - 1], bi[K - 1])) return;
  bd[K - 1] = d;
  bi[K - 1] = i;
#pragma unroll
  for (int c = K - 1; c > 0; --c) {
    if (before(bd[c], bi[c], bd[c - 1], bi[c - 1])) {
      const float td = bd[c];
      bd[c] = bd[c - 1];
      bd[c - 1] = td;
      const int ti = bi[c];
      bi[c] = bi[c - 1];
      bi[c - 1] = ti;
    }
  }
}

// Block-wide exclusive prefix sum of per-thread counts, in thread order:
// returns total plus the counts of the lower threads, and adds the block's
// sum to total (uniform). One __syncthreads; s_cnt alternates between two
// rows (par) so that the next call can write while slower warps still read
// this one.
__device__ __forceinline__ int block_prefix(int c, int (&s_cnt)[2][kWarps], int& par,
                                            int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = c;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_cnt[par][warp] = x;
  __syncthreads();
  int base = 0, tot = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int n = s_cnt[par][w];
    base += w < warp ? n : 0;
    tot += n;
  }
  par ^= 1;
  const int pos = total + base + x - c;
  total += tot;
  return pos;
}

// Per-thread state: R queries, their top-k lists, ring minima and queues.
template <int K, int R>
struct State {
  float qx[R], qy[R], qz[R], qw[R], qn[R];
  int qr[R], qid[R], cnt[R];
  float bd[R][K];
  int bi[R][K];
  float rd[R][4];
  int ri[R][4];
  float cur[R];   // running minimum of the current ring run and its position
  int curj[R];
};

// Merge every queue of the thread into its top-k lists. Queue entries hold
// (d2, position in the staged tile), so a tile's queues are merged before
// the next tile replaces it.
template <int K, int R>
__device__ __forceinline__ void merge(State<K, R>& st, float2 (*s_queue)[R][kThreads],
                                      const int* s_idx) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    for (int e = 0; e < st.cnt[r]; ++e) {
      const float2 v = s_queue[e][r][threadIdx.x];
      insert<K>(st.bd[r], st.bi[r], v.x, s_idx[__float_as_int(v.y)]);
    }
    st.cnt[r] = 0;
  }
}

// Staged targets j .. j + NJ - 1 against the thread's queries: the top-k
// filter and, with RING, the running minimum of the current ring run. NJ
// targets per step give NJ * R independent chains; the warp votes once per
// step, with room for kUnroll more candidates left in every queue.
template <int K, int R, bool RING, bool W4, int NJ>
__device__ __forceinline__ void pair_step(State<K, R>& st, int j, int nr, const float4* s_pt,
                                          const float* s_w, const int* s_idx,
                                          float2 (*s_queue)[R][kThreads]) {
  float4 p[NJ];
  float pw[NJ];
#pragma unroll
  for (int u = 0; u < NJ; ++u) {
    p[u] = s_pt[j + u];
    pw[u] = W4 ? s_w[j + u] : 0.f;
  }
#pragma unroll
  for (int u = 0; u < NJ; ++u) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r < nr) {
        float dot = st.qx[r] * p[u].x;
        dot = fmaf(st.qy[r], p[u].y, dot);
        dot = fmaf(st.qz[r], p[u].z, dot);
        if (W4) dot = fmaf(st.qw[r], pw[u], dot);
        const float raw = (st.qn[r] + p[u].w) - 2.0f * dot;
        const float d2 = fmaxf(raw, 0.0f);
        if (RING && d2 < st.cur[r]) {
          st.cur[r] = d2;
          st.curj[r] = j + u;
        }
        // raw up to the k-th distance: a candidate (the merge re-checks d2
        // and the index; d2 differs from raw only when both are <= 0). The
        // entry is written either way and counted only then: no branch.
        s_queue[st.cnt[r]][r][threadIdx.x] = make_float2(d2, __int_as_float(j + u));
        st.cnt[r] += raw <= st.bd[r][K - 1];
      }
    }
  }
  bool nearly_full = false;
#pragma unroll
  for (int r = 0; r < R; ++r) nearly_full |= st.cnt[r] > kQueue - kUnroll;
  if (__any_sync(kFull, nearly_full)) merge<K, R>(st, s_queue, s_idx);
}

// All staged targets of [j0, j1) against the thread's queries.
template <int K, int R, bool RING, bool W4>
__device__ __forceinline__ void pair_range(State<K, R>& st, int j0, int j1, int nr,
                                           const float4* s_pt, const float* s_w,
                                           const int* s_idx, float2 (*s_queue)[R][kThreads]) {
  int j = j0;
  for (; j + kUnroll <= j1; j += kUnroll)
    pair_step<K, R, RING, W4, kUnroll>(st, j, nr, s_pt, s_w, s_idx, s_queue);
  for (; j < j1; ++j) pair_step<K, R, RING, W4, 1>(st, j, nr, s_pt, s_w, s_idx, s_queue);
}

template <int K, bool RING, bool W4>
__global__ void __launch_bounds__(kThreads, Slots<K>::min_blocks)
knn_kernel(const float* __restrict__ q, const uint8_t* __restrict__ q_mask,
           const float* __restrict__ t, const uint8_t* __restrict__ t_mask,
           const int* __restrict__ q_row, const int* __restrict__ t_row,
           int Q, int T, int D, int4 drs,
           float* __restrict__ out_d, int* __restrict__ out_i,
           float* __restrict__ ring_d, int* __restrict__ ring_i) {
  constexpr int R = Slots<K>::R;
  constexpr int S = kThreads * R;   // query slots of a block
  __shared__ float4 s_pt[kTile];          // x, y, z, |t|^2 of the staged targets
  __shared__ float s_w[W4 ? kTile : 1];   // their 4th coordinate
  __shared__ int s_idx[kTile];            // their index in the batch element
  __shared__ int s_row[RING ? kTile : 1];
  __shared__ int s_run[RING ? kTile + 1 : 1];   // starts of the equal-ring runs
  __shared__ int s_qidx[S];
  __shared__ int s_cnt[2][kWarps];
  __shared__ int s_cut;
  __shared__ float2 s_queue[kQueue][R][kThreads];

  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int first = blockIdx.x * S;   // this block's ranks among the valid queries
  const uint8_t* qmb = q_mask + (size_t)b * Q;
  int par = 0;

  // outputs of the masked queries of the index range [first, first + S),
  // element by element (coalesced: most of K1's queries are masked, and
  // their outputs are most of its bytes)
  const int q_end = min(Q, first + S);
  const size_t o0 = (size_t)b * Q + first;
  for (int e = tid; e < (q_end - first) * K; e += kThreads) {
    if (!qmb[first + e / K]) {
      out_d[o0 * K + e] = kBig;
      out_i[o0 * K + e] = 0;
    }
  }
  if (RING) {
    for (int e = tid; e < (q_end - first) * 4; e += kThreads) {
      if (!qmb[first + e / 4]) {
        ring_d[o0 * 4 + e] = kBig;
        ring_i[o0 * 4 + e] = 0;
      }
    }
  }

  // valid queries of batch element b, by rank
  int nq_all = 0;
  for (int c0 = 0; c0 < Q; c0 += kThreads * kScan) {
    const int q0 = c0 + tid * kScan;
    unsigned bits = 0;
#pragma unroll
    for (int g = 0; g < kScan; ++g)
      if (q0 + g < Q && qmb[q0 + g]) bits |= 1u << g;
    int rank = block_prefix(__popc(bits), s_cnt, par, nq_all) - first;
#pragma unroll
    for (int g = 0; g < kScan; ++g) {
      if (bits >> g & 1u) {
        if (rank >= 0 && rank < S) s_qidx[rank] = q0 + g;
        ++rank;
      }
    }
  }
  const int nq = min(max(nq_all - first, 0), S);
  if (nq == 0) return;   // uniform over the block
  __syncthreads();       // s_qidx
  const int nr = (nq + kThreads - 1) / kThreads;   // slots in use, uniform
  const bool busy = (tid & ~31) < nq;              // this warp has a query

  State<K, R> st;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int rank = r * kThreads + tid;
    const bool has = rank < nq;
    st.qid[r] = has ? s_qidx[rank] : 0;
    st.qx[r] = st.qy[r] = st.qz[r] = st.qw[r] = st.qn[r] = 0.f;
    st.qr[r] = 0;
    if (has) {
      const float* p = q + ((size_t)b * Q + st.qid[r]) * D;
      st.qx[r] = p[0];
      if (D > 1) st.qy[r] = p[1];
      if (D > 2) st.qz[r] = p[2];
      if (D > 3) st.qw[r] = p[3];
      float n = st.qx[r] * st.qx[r];
      n = fmaf(st.qy[r], st.qy[r], n);
      n = fmaf(st.qz[r], st.qz[r], n);
      if (W4) n = fmaf(st.qw[r], st.qw[r], n);
      st.qn[r] = n;
      if (RING) st.qr[r] = q_row[(size_t)b * Q + st.qid[r]];
    }
    // an empty slot's thresholds are kNever: it never takes a target
#pragma unroll
    for (int c = 0; c < K; ++c) {
      st.bd[r][c] = has ? kBig : kNever;
      st.bi[r][c] = 0;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      st.rd[r][c] = has ? kBig : kNever;
      st.ri[r][c] = 0;
    }
    st.cnt[r] = 0;
  }

  const float* tb = t + (size_t)b * T * D;
  const uint8_t* tmb = t_mask + (size_t)b * T;
  // tile u of nt holds targets u, u + nt, u + 2 nt, ...: every tile spans
  // the whole cloud, so the first tiles give each query a tight k-th
  // distance early (index order along rings makes a sweep that approaches
  // a query insert at nearly every step)
  int nv = 0;
  for (int c0 = 0; c0 < T; c0 += kThreads * kScan) {
    const int t0 = c0 + tid * kScan;
    int c = 0;
#pragma unroll
    for (int g = 0; g < kScan; ++g) c += t0 + g < T && tmb[t0 + g];
    block_prefix(c, s_cnt, par, nv);
  }
  const int nt = max(1, (nv + kTile - 1) / kTile);
  for (int u = 0; u < nt; ++u) {
    const int len = (T - u + nt - 1) / nt;   // candidates of tile u
    int m = 0;                                // the next one to stage
    while (m < len) {
      // stage valid targets of tile u, compacted in index order, until the
      // tile is full (the first one left out is where the next round starts)
      int n = 0;
      while (m < len && n < kTile) {
        const int m0 = m + tid * kScan;
        unsigned bits = 0;
#pragma unroll
        for (int g = 0; g < kScan; ++g)
          if (m0 + g < len && tmb[u + nt * (m0 + g)]) bits |= 1u << g;
        int pos = block_prefix(__popc(bits), s_cnt, par, n);
#pragma unroll
        for (int g = 0; g < kScan; ++g) {
          if (!(bits >> g & 1u)) continue;
          if (pos < kTile) {
            const int tj = u + nt * (m0 + g);
            const float* p = tb + (size_t)tj * D;
            float4 c = make_float4(p[0], 0.f, 0.f, 0.f);
            float w = 0.f;
            if (D > 1) c.y = p[1];
            if (D > 2) c.z = p[2];
            if (D > 3) w = p[3];
            float nn = c.x * c.x;
            nn = fmaf(c.y, c.y, nn);
            nn = fmaf(c.z, c.z, nn);
            if (W4) nn = fmaf(w, w, nn);
            c.w = nn;
            s_pt[pos] = c;
            if (W4) s_w[pos] = w;
            s_idx[pos] = tj;
            if (RING) s_row[pos] = t_row[(size_t)b * T + tj];
          } else if (pos == kTile) {
            s_cut = m0 + g;
          }
          ++pos;
        }
        if (n > kTile) {   // uniform: this round overflowed the tile
          __syncthreads();   // s_cut
          m = s_cut;
          n = kTile;
        } else {
          m += kThreads * kScan;
        }
      }
      __syncthreads();   // the staged tile
      if (n == 0) continue;

      if (!RING) {
        if (busy) pair_range<K, R, false, W4>(st, 0, n, nr, s_pt, s_w, s_idx, s_queue);
      } else {
        // starts of the runs of equal ring ids
        int nrun = 0;
        for (int j0 = 0; j0 < n; j0 += kThreads) {
          const int j = j0 + tid;
          const bool start = j < n && (j == 0 || s_row[j] != s_row[j - 1]);
          const int pos = block_prefix(start, s_cnt, par, nrun);
          if (start) s_run[pos] = j;
        }
        if (tid == 0) s_run[nrun] = n;
        __syncthreads();   // s_run
        for (int g = 0; busy && g < nrun; ++g) {
          const int j0 = s_run[g], j1 = s_run[g + 1];
          const int ring = s_row[j0];
#pragma unroll
          for (int r = 0; r < R; ++r) {   // does this run's ring fill a ring slot?
            const int dr = ring - st.qr[r];
            const bool want = dr == drs.x || dr == drs.y || dr == drs.z || dr == drs.w;
            st.cur[r] = want && r * kThreads + tid < nq ? kBig : kNever;
            st.curj[r] = -1;
          }
          pair_range<K, R, true, W4>(st, j0, j1, nr, s_pt, s_w, s_idx, s_queue);
#pragma unroll
          for (int r = 0; r < R; ++r) {   // the run's minimum joins the ring slot
            if (st.curj[r] >= 0) {
              const int dr = ring - st.qr[r];
              const int gi = s_idx[st.curj[r]];
              const float d = st.cur[r];
              if (dr == drs.x && before(d, gi, st.rd[r][0], st.ri[r][0])) { st.rd[r][0] = d; st.ri[r][0] = gi; }
              if (dr == drs.y && before(d, gi, st.rd[r][1], st.ri[r][1])) { st.rd[r][1] = d; st.ri[r][1] = gi; }
              if (dr == drs.z && before(d, gi, st.rd[r][2], st.ri[r][2])) { st.rd[r][2] = d; st.ri[r][2] = gi; }
              if (dr == drs.w && before(d, gi, st.rd[r][3], st.ri[r][3])) { st.rd[r][3] = d; st.ri[r][3] = gi; }
            }
          }
        }
      }
      merge<K, R>(st, s_queue, s_idx);
      __syncthreads();   // before the next tile overwrites this one
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r * kThreads + tid < nq) {
      const size_t o = ((size_t)b * Q + st.qid[r]) * K;
#pragma unroll
      for (int c = 0; c < K; ++c) {
        out_d[o + c] = st.bd[r][c];
        out_i[o + c] = st.bi[r][c];
      }
      if (RING) {
        const size_t o4 = ((size_t)b * Q + st.qid[r]) * 4;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          ring_d[o4 + c] = st.rd[r][c];
          ring_i[o4 + c] = st.ri[r][c];
        }
      }
    }
  }
}

template <bool RING, bool W4>
cudaError_t launch(const float* q, const uint8_t* qm, const float* t,
                   const uint8_t* tm, const int* q_row, const int* t_row,
                   int B, int Q, int T, int D, int k, int4 drs, float* out_d,
                   int* out_i, float* ring_d, int* ring_i, cudaStream_t stream) {
#define KNN_CASE(KK)                                                         \
  case KK: {                                                                 \
    constexpr int S = kThreads * Slots<KK>::R;                               \
    const dim3 grid((Q + S - 1) / S, B);                                     \
    knn_kernel<KK, RING, W4><<<grid, kThreads, 0, stream>>>(                 \
        q, qm, t, tm, q_row, t_row, Q, T, D, drs, out_d, out_i, ring_d,      \
        ring_i);                                                             \
    break;                                                                   \
  }
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
  cudaError_t err;
  if (ring)
    err = D == 4 ? launch<true, true>(q, q_mask, t, t_mask, q_row, t_row, B, Q, T, D, k,
                                      drs, out_d, out_i, ring_d, ring_i, s)
                 : launch<true, false>(q, q_mask, t, t_mask, q_row, t_row, B, Q, T, D, k,
                                       drs, out_d, out_i, ring_d, ring_i, s);
  else
    err = D == 4 ? launch<false, true>(q, q_mask, t, t_mask, q_row, t_row, B, Q, T, D, k,
                                       drs, out_d, out_i, ring_d, ring_i, s)
                 : launch<false, false>(q, q_mask, t, t_mask, q_row, t_row, B, Q, T, D, k,
                                        drs, out_d, out_i, ring_d, ring_i, s);
  return (int)err;
}
