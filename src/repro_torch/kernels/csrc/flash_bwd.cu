// Segment-aware causal flash attention, backward, for Hopper (sm_90a).
//
// The recompute-free two-pass backward from the forward's saved per-row
// lse = m + log(l) and delta = rowsum(dO * O) (computed outside, in fp32):
//
//   P  = exp(scale * q.k - lse)   under the allow-mask, else 0
//   dP = dO . v
//   dS = P * (dP - delta)
//   dQ = scale * sum dS . K       (q-stationary pass)
//   dK = scale * sum dS^T . Q,  dV = sum P^T . dO   (kv-stationary pass)
//
// Four kernels, two template instantiations of each pass:
//
//   flash_bwd_dq  <dense>   replaces repro/kernels/flash_attention.py ::
//                           segment_flash_attention_bwd, dQ pass (_bwd_dq_body,
//                           _recompute_p_ds).  Walks every kv block of its q
//                           block and skips the ones that are causally dead or
//                           segment-disjoint (the _block_live rule).
//   flash_bwd_dkv <dense>   replaces the same function's dK/dV pass
//                           (_bwd_dkv_body).  Walks (group member, q block)
//                           pairs member-major, q blocks ascending, and sums the
//                           GQA group in registers: dK/dV leave at kv-head
//                           resolution, with no atomics.
//   flash_bwd_dq  <pruned>  replaces ::segment_flash_attention_bwd_pruned, dQ
//                           pass (_bwd_dq_prefetch_body): the row tables
//                           kv_idx[b, qb, :kv_count].
//   flash_bwd_dkv <pruned>  replaces its dK/dV pass (_bwd_dkv_prefetch_body):
//                           the column tables q_idx[b, kb, :q_count].
//
// Each pruned kernel visits the live tiles of its dense twin in the same
// order with the same tile routine, and every rounding step is an explicit
// intrinsic, so K5 == K2 and K6 == K3 bit for bit.  There are no row
// reductions in the backward (delta comes in precomputed), so every output
// element is one sequential fma chain.
//
// Masking contract (the forward's): key j is visible to query i iff
// (causal => j <= i, by absolute row position) and segment ids match with the
// key's id > 0.  P is built from the mask, never from exp(S - NEG_INF), so a
// row with no visible key (lse = NEG_INF) gives exactly zero dq and adds
// nothing to dk/dv.
//
// Shared memory and the pinned blocks: a (128 x 128) tile pair at d_head 128
// needs q, dO, k, v and a score tile, ~330 KB in fp32, above the 227 KB a
// block may use.  So a thread block owns kRows = 32 rows of its stationary
// block (a sub-range of the pinned q block for dQ, of the kv block for
// dK/dV) and all rows of the moving block.  Each row's sums are independent
// of the other rows, so the liveness tables, the visiting order and every
// row's arithmetic stay those of the pinned (block_q, block_kv) pair; the
// dense kernels test liveness on the whole pinned blocks.
//
// What bounds it on the H100 at the training shapes (two packed rows of up to
// 6144 tokens, 16 q heads over 8 kv heads, d_head 128, bf16): the live
// tiles' work is ~6 bq.bkv.D FLOPs (dQ) and ~8 bq.bkv.D (dK/dV) per
// (row, q-head, tile), hundreds of GFLOP per layer, so by the card's peak
// rates the passes are bound by operations, not bytes.  These kernels reach
// neither peak: the products run on the CUDA cores in fp32 (no tensor cores,
// no TF32), each thread keeps a 2 x 8 register micro-tile (the stationary
// rows are broadcast from shared memory, the moving rows are read from
// padded rows so the strided reads hit distinct banks), and a ~180 KB block
// runs one per SM.  Tensor-core products (wgmma), TMA loads and a pipelined
// ring of moving tiles are the next steps; they change the summation order,
// so they must land in both kernels of a pair at once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 16;                      // threads along the moving / head-dim axis
constexpr int kGroups = kThreads / kLanes;      // thread rows along the stationary axis
constexpr int kRows = 32;                       // stationary rows per thread block
constexpr int kMaxBlock = 128;
constexpr int kMaxHeadDim = 128;
constexpr int kRowTile = kRows / kGroups;       // stationary rows per thread
constexpr int kColTile = kMaxBlock / kLanes;    // moving rows per thread
constexpr int kDimTile = kMaxHeadDim / kLanes;  // head-dim columns per thread
// The reference's sentinel, -0.7 * f32max computed in double and rounded
// once to float, exactly as the Python side builds it.
constexpr float kNegInf = static_cast<float>(-0.7 * 3.4028234663852886e38);
constexpr int kSegBig = 1 << 30;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Copy `rows` rows of `d` elements (row r at src + r * row_stride) into a
// shared fp32 tile with leading dimension ld.
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* __restrict__ src,
                                          int rows, int d, size_t row_stride,
                                          int ld) {
  for (int idx = threadIdx.x; idx < rows * d; idx += kThreads) {
    const int r = idx / d;
    const int c = idx - r * d;
    dst[r * ld + c] = to_float(src[r * row_stride + c]);
  }
}

// The q rows' per-head residuals: lse and delta are (B, S, H) fp32.
__device__ __forceinline__ void load_residuals(float* lse_s, float* delta_s,
                                               const float* __restrict__ lse,
                                               const float* __restrict__ delta,
                                               size_t pos0, int rows, int H,
                                               int h) {
  for (int i = threadIdx.x; i < rows; i += kThreads) {
    lse_s[i] = lse[(pos0 + i) * H + h];
    delta_s[i] = delta[(pos0 + i) * H + h];
  }
}

// (lo, hi) of the positive segment ids of `n` positions (lo = kSegBig when
// there is none); read by one thread.
__device__ __forceinline__ void seg_range(const int* ids, int n, int& lo,
                                          int& hi) {
  lo = kSegBig;
  hi = 0;
  for (int i = 0; i < n; ++i) {
    const int id = ids[i];
    hi = max(hi, id);
    if (id > 0) lo = min(lo, id);
  }
}

struct Smem {
  float* x0;     // [kRows][D + 1] stationary rows: q (dQ) or k (dK/dV)
  float* x1;     // [kRows][D + 1] stationary rows: dO (dQ) or v (dK/dV)
  float* y0;     // [M][D + 1] moving rows: k (dQ) or q (dK/dV)
  float* y1;     // [M][D + 1] moving rows: v (dQ) or dO (dK/dV)
  float* w;      // [kRows][M + 1] the tile's P or scale * dS
  float* lse;    // [max(kRows, M)] the q rows' lse
  float* delta;  // [max(kRows, M)] the q rows' delta
  int* xseg;     // [kRows]
  int* yseg;     // [M]
};

__host__ __device__ __forceinline__ int residual_len(int M) {
  return M > kRows ? M : kRows;
}

__device__ __forceinline__ Smem carve(float* base, int D, int M) {
  const int ld = D + 1;
  Smem sm;
  sm.x0 = base;
  sm.x1 = sm.x0 + kRows * ld;
  sm.y0 = sm.x1 + kRows * ld;
  sm.y1 = sm.y0 + M * ld;
  sm.w = sm.y1 + M * ld;
  sm.lse = sm.w + kRows * (M + 1);
  sm.delta = sm.lse + residual_len(M);
  sm.xseg = reinterpret_cast<int*>(sm.delta + residual_len(M));
  sm.yseg = sm.xseg + kRows;
  return sm;
}

size_t smem_bytes(int D, int M) {
  const size_t ld = static_cast<size_t>(D) + 1;
  return sizeof(float) * (2 * kRows * ld + 2 * M * ld +
                          static_cast<size_t>(kRows) * (M + 1) +
                          2 * static_cast<size_t>(residual_len(M))) +
         sizeof(int) * static_cast<size_t>(kRows + M);
}

// Recompute one tile's P and dS for this thread's kRowTile x kColTile
// entries: stationary rows ti + 16*rr, moving rows tj + 16*cc.  On exit s
// holds P and dp holds dS (both 0 where the mask forbids).  kKvRows: the
// stationary rows are kv rows (dK/dV pass), else q rows (dQ pass).
template <bool kKvRows>
__device__ __forceinline__ void tile_p_ds(
    const Smem& sm, int R, int M, int D, int x_pos0, int y_pos0, bool causal,
    bool has_seg, float scale, float (&s)[kRowTile][kColTile],
    float (&dp)[kRowTile][kColTile]) {
  const int ti = threadIdx.x / kLanes;
  const int tj = threadIdx.x % kLanes;
  const int ld = D + 1;
#pragma unroll
  for (int rr = 0; rr < kRowTile; ++rr)
#pragma unroll
    for (int cc = 0; cc < kColTile; ++cc) {
      s[rr][cc] = 0.f;
      dp[rr][cc] = 0.f;
    }

  for (int d = 0; d < D; ++d) {
    float a0[kRowTile], a1[kRowTile], b0[kColTile], b1[kColTile];
#pragma unroll
    for (int rr = 0; rr < kRowTile; ++rr) {
      const int r = min(ti + kGroups * rr, R - 1);
      a0[rr] = sm.x0[r * ld + d];
      a1[rr] = sm.x1[r * ld + d];
    }
#pragma unroll
    for (int cc = 0; cc < kColTile; ++cc) {
      const int c = min(tj + kLanes * cc, M - 1);
      b0[cc] = sm.y0[c * ld + d];
      b1[cc] = sm.y1[c * ld + d];
    }
#pragma unroll
    for (int rr = 0; rr < kRowTile; ++rr)
#pragma unroll
      for (int cc = 0; cc < kColTile; ++cc) {
        s[rr][cc] = __fmaf_rn(a0[rr], b0[cc], s[rr][cc]);
        dp[rr][cc] = __fmaf_rn(a1[rr], b1[cc], dp[rr][cc]);
      }
  }

#pragma unroll
  for (int rr = 0; rr < kRowTile; ++rr) {
    const int r = ti + kGroups * rr;
#pragma unroll
    for (int cc = 0; cc < kColTile; ++cc) {
      const int c = tj + kLanes * cc;
      bool ok = r < R && c < M;
      const int q_row = kKvRows ? c : r;  // index of the q row in the tile
      const int q_pos = kKvRows ? y_pos0 + c : x_pos0 + r;
      const int k_pos = kKvRows ? x_pos0 + r : y_pos0 + c;
      if (ok && causal) ok = k_pos <= q_pos;
      if (ok && has_seg) {
        const int ks = kKvRows ? sm.xseg[r] : sm.yseg[c];
        const int qs = kKvRows ? sm.yseg[c] : sm.xseg[r];
        ok = ks > 0 && qs == ks;
      }
      float p = 0.f, ds = 0.f;
      if (ok) {
        p = expf(__fsub_rn(__fmul_rn(s[rr][cc], scale), sm.lse[q_row]));
        ds = __fmul_rn(p, __fsub_rn(dp[rr][cc], sm.delta[q_row]));
      }
      s[rr][cc] = p;
      dp[rr][cc] = ds;
    }
  }
}

// sm.w[r][c] = w[rr][cc] (times `scale` when scaled) for the valid entries.
__device__ __forceinline__ void store_w(const Smem& sm, int R, int M,
                                        const float (&w)[kRowTile][kColTile],
                                        bool scaled, float scale) {
  const int ti = threadIdx.x / kLanes;
  const int tj = threadIdx.x % kLanes;
#pragma unroll
  for (int rr = 0; rr < kRowTile; ++rr) {
    const int r = ti + kGroups * rr;
#pragma unroll
    for (int cc = 0; cc < kColTile; ++cc) {
      const int c = tj + kLanes * cc;
      if (r < R && c < M)
        sm.w[r * (M + 1) + c] = scaled ? __fmul_rn(w[rr][cc], scale) : w[rr][cc];
    }
  }
}

// acc[r][d] += sum over c ascending of w[r][c] * z[c][d]: stationary rows
// ti + 16*rr, head-dim columns tj + 16*dd.
__device__ __forceinline__ void accumulate(const float* w, const float* z,
                                           int R, int M, int D,
                                           float (&acc)[kRowTile][kDimTile]) {
  const int ti = threadIdx.x / kLanes;
  const int tj = threadIdx.x % kLanes;
  const int ld = D + 1;
  const int ldw = M + 1;
  for (int c = 0; c < M; ++c) {
    float wr[kRowTile], zd[kDimTile];
#pragma unroll
    for (int rr = 0; rr < kRowTile; ++rr)
      wr[rr] = w[min(ti + kGroups * rr, R - 1) * ldw + c];
#pragma unroll
    for (int dd = 0; dd < kDimTile; ++dd)
      zd[dd] = z[c * ld + min(tj + kLanes * dd, D - 1)];
#pragma unroll
    for (int rr = 0; rr < kRowTile; ++rr)
#pragma unroll
      for (int dd = 0; dd < kDimTile; ++dd)
        acc[rr][dd] = __fmaf_rn(wr[rr], zd[dd], acc[rr][dd]);
  }
}

template <typename T>
__device__ __forceinline__ void store_rows(T* __restrict__ dst,
                                           size_t row_stride, int R, int D,
                                           const float (&acc)[kRowTile][kDimTile]) {
  const int ti = threadIdx.x / kLanes;
  const int tj = threadIdx.x % kLanes;
#pragma unroll
  for (int rr = 0; rr < kRowTile; ++rr) {
    const int r = ti + kGroups * rr;
    if (r >= R) continue;
#pragma unroll
    for (int dd = 0; dd < kDimTile; ++dd) {
      const int d = tj + kLanes * dd;
      if (d < D) dst[r * row_stride + d] = from_float<T>(acc[rr][dd]);
    }
  }
}

// dQ: one block per (32-row sub-range of a q block, q head, batch row).
template <typename T, bool kPruned>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ seg,
                        const int* __restrict__ kv_idx,
                        const int* __restrict__ kv_count,
                        const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int S, int H, int KV, int D, int bq, int bkv,
                        int causal, float scale) {
  extern __shared__ float smem[];
  __shared__ int live;
  const Smem sm = carve(smem, D, bkv);
  const int nsub = (bq + kRows - 1) / kRows;
  const int qb = blockIdx.x / nsub, sub = blockIdx.x % nsub;
  const int h = blockIdx.y, b = blockIdx.z;
  const int nq = S / bq, nk = S / bkv;
  const int kvh = h / (H / KV);
  const int q0 = qb * bq;            // first row of the pinned q block
  const int x_pos0 = q0 + sub * kRows;  // first row of this block's rows
  const int R = min(kRows, bq - sub * kRows);
  const bool has_seg = seg != nullptr;
  const int tid = threadIdx.x;
  const size_t q_stride = static_cast<size_t>(H) * D;
  const size_t kv_stride = static_cast<size_t>(KV) * D;
  const size_t row0 = static_cast<size_t>(b) * S;
  const int ld = D + 1;

  const size_t x_off = (row0 + x_pos0) * q_stride + h * D;
  load_rows(sm.x0, q + x_off, R, D, q_stride, ld);
  load_rows(sm.x1, dout + x_off, R, D, q_stride, ld);
  load_residuals(sm.lse, sm.delta, lse, delta, row0 + x_pos0, R, H, h);
  if (has_seg)
    for (int i = tid; i < R; i += kThreads) sm.xseg[i] = seg[row0 + x_pos0 + i];

  // The whole pinned q block's segment range, read by thread 0 only (dense
  // liveness).
  int q_lo = kSegBig, q_hi = 0;
  if (!kPruned && has_seg && tid == 0) seg_range(seg + row0 + q0, bq, q_lo, q_hi);
  __syncthreads();

  float acc[kRowTile][kDimTile];
#pragma unroll
  for (int rr = 0; rr < kRowTile; ++rr)
#pragma unroll
    for (int dd = 0; dd < kDimTile; ++dd) acc[rr][dd] = 0.f;

  const int row_tables = b * nq + qb;
  const int n_steps = kPruned ? kv_count[row_tables] : nk;
  for (int t = 0; t < n_steps; ++t) {
    const int kb = kPruned ? kv_idx[static_cast<size_t>(row_tables) * nk + t] : t;
    const int k0 = kb * bkv;
    if (has_seg)
      for (int j = tid; j < bkv; j += kThreads) sm.yseg[j] = seg[row0 + k0 + j];
    if (!kPruned) {
      __syncthreads();
      if (tid == 0) {
        bool ok = !causal || q0 + bq - 1 >= k0;
        if (has_seg) {
          int k_lo, k_hi;
          seg_range(sm.yseg, bkv, k_lo, k_hi);
          ok = ok && q_hi > 0 && k_hi > 0 && q_hi >= k_lo && k_hi >= q_lo;
        }
        live = ok;
      }
      __syncthreads();
      if (!live) continue;
    }
    const size_t kv_off = (row0 + k0) * kv_stride + kvh * D;
    load_rows(sm.y0, k + kv_off, bkv, D, kv_stride, ld);
    load_rows(sm.y1, v + kv_off, bkv, D, kv_stride, ld);
    __syncthreads();

    float p[kRowTile][kColTile], ds[kRowTile][kColTile];
    tile_p_ds<false>(sm, R, bkv, D, x_pos0, k0, causal != 0, has_seg, scale, p, ds);
    store_w(sm, R, bkv, ds, true, scale);
    __syncthreads();
    accumulate(sm.w, sm.y0, R, bkv, D, acc);
    __syncthreads();  // k, v and w may be overwritten by the next tile
  }
  store_rows(dq + x_off, q_stride, R, D, acc);
}

// dK/dV: one block per (32-row sub-range of a kv block, kv head, batch row).
template <typename T, bool kPruned>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const int* __restrict__ seg,
                         const int* __restrict__ q_idx,
                         const int* __restrict__ q_count,
                         const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk,
                         T* __restrict__ dv, int S, int H, int KV, int D,
                         int bq, int bkv, int causal, float scale) {
  extern __shared__ float smem[];
  __shared__ int live;
  const Smem sm = carve(smem, D, bq);
  const int nsub = (bkv + kRows - 1) / kRows;
  const int kb = blockIdx.x / nsub, sub = blockIdx.x % nsub;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int group = H / KV;
  const int nq = S / bq, nk = S / bkv;
  const int k0 = kb * bkv;              // first row of the pinned kv block
  const int x_pos0 = k0 + sub * kRows;  // first row of this block's rows
  const int R = min(kRows, bkv - sub * kRows);
  const bool has_seg = seg != nullptr;
  const int tid = threadIdx.x;
  const size_t q_stride = static_cast<size_t>(H) * D;
  const size_t kv_stride = static_cast<size_t>(KV) * D;
  const size_t row0 = static_cast<size_t>(b) * S;
  const int ld = D + 1;

  const size_t x_off = (row0 + x_pos0) * kv_stride + kvh * D;
  load_rows(sm.x0, k + x_off, R, D, kv_stride, ld);
  load_rows(sm.x1, v + x_off, R, D, kv_stride, ld);
  if (has_seg)
    for (int i = tid; i < R; i += kThreads) sm.xseg[i] = seg[row0 + x_pos0 + i];

  // The whole pinned kv block's segment range, read by thread 0 only (dense
  // liveness).
  int k_lo = kSegBig, k_hi = 0;
  if (!kPruned && has_seg && tid == 0) seg_range(seg + row0 + k0, bkv, k_lo, k_hi);
  __syncthreads();

  float acc_k[kRowTile][kDimTile], acc_v[kRowTile][kDimTile];
#pragma unroll
  for (int rr = 0; rr < kRowTile; ++rr)
#pragma unroll
    for (int dd = 0; dd < kDimTile; ++dd) {
      acc_k[rr][dd] = 0.f;
      acc_v[rr][dd] = 0.f;
    }

  const int col_tables = b * nk + kb;
  const int n_steps = kPruned ? q_count[col_tables] : nq;
  for (int m = 0; m < group; ++m) {
    const int h = kvh * group + m;
    for (int t = 0; t < n_steps; ++t) {
      const int qb = kPruned ? q_idx[static_cast<size_t>(col_tables) * nq + t] : t;
      const int q0 = qb * bq;
      if (has_seg)
        for (int i = tid; i < bq; i += kThreads) sm.yseg[i] = seg[row0 + q0 + i];
      if (!kPruned) {
        __syncthreads();
        if (tid == 0) {
          bool ok = !causal || q0 + bq - 1 >= k0;
          if (has_seg) {
            int q_lo, q_hi;
            seg_range(sm.yseg, bq, q_lo, q_hi);
            ok = ok && q_hi > 0 && k_hi > 0 && q_hi >= k_lo && k_hi >= q_lo;
          }
          live = ok;
        }
        __syncthreads();
        if (!live) continue;
      }
      load_residuals(sm.lse, sm.delta, lse, delta, row0 + q0, bq, H, h);
      const size_t y_off = (row0 + q0) * q_stride + h * D;
      load_rows(sm.y0, q + y_off, bq, D, q_stride, ld);
      load_rows(sm.y1, dout + y_off, bq, D, q_stride, ld);
      __syncthreads();

      float p[kRowTile][kColTile], ds[kRowTile][kColTile];
      tile_p_ds<true>(sm, R, bq, D, x_pos0, q0, causal != 0, has_seg, scale, p, ds);
      store_w(sm, R, bq, p, false, scale);
      __syncthreads();
      accumulate(sm.w, sm.y1, R, bq, D, acc_v);  // dV += P^T dO
      __syncthreads();
      store_w(sm, R, bq, ds, true, scale);
      __syncthreads();
      accumulate(sm.w, sm.y0, R, bq, D, acc_k);  // dK += scale dS^T Q
      __syncthreads();  // q, dO and w may be overwritten by the next tile
    }
  }
  store_rows(dk + x_off, kv_stride, R, D, acc_k);
  store_rows(dv + x_off, kv_stride, R, D, acc_v);
}

bool bad_shape(int S, int H, int KV, int D, int bq, int bkv) {
  return bq < 1 || bkv < 1 || bq > kMaxBlock || bkv > kMaxBlock || D < 1 ||
         D > kMaxHeadDim || S % bq != 0 || S % bkv != 0 || KV < 1 ||
         H % KV != 0;
}

template <typename Kernel>
cudaError_t prepare(int device, Kernel kernel, size_t smem) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename T, bool kPruned>
int launch_dq(int device, const void* q, const void* k, const void* v,
              const int* seg, const int* kv_idx, const int* kv_count,
              const void* dout, const float* lse, const float* delta, void* dq,
              int B, int S, int H, int KV, int D, int bq, int bkv, int causal,
              float scale, void* stream) {
  const size_t smem = smem_bytes(D, bkv);
  auto kernel = flash_bwd_dq_kernel<T, kPruned>;
  cudaError_t err = prepare(device, kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S / bq) * ((bq + kRows - 1) / kRows), H, B);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), seg, kv_idx, kv_count,
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), S, H, KV,
      D, bq, bkv, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kPruned>
int launch_dkv(int device, const void* q, const void* k, const void* v,
               const int* seg, const int* q_idx, const int* q_count,
               const void* dout, const float* lse, const float* delta,
               void* dk, void* dv, int B, int S, int H, int KV, int D, int bq,
               int bkv, int causal, float scale, void* stream) {
  const size_t smem = smem_bytes(D, bq);
  auto kernel = flash_bwd_dkv_kernel<T, kPruned>;
  cudaError_t err = prepare(device, kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S / bkv) * ((bkv + kRows - 1) / kRows), KV, B);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), seg, q_idx, q_count,
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk),
      static_cast<T*>(dv), S, H, KV, D, bq, bkv, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <bool kPruned>
int dispatch_dq(int dtype, int device, const void* q, const void* k,
                const void* v, const int* seg, const int* kv_idx,
                const int* kv_count, const void* dout, const float* lse,
                const float* delta, void* dq, int B, int S, int H, int KV,
                int D, int bq, int bkv, int causal, float scale, void* stream) {
  if (bad_shape(S, H, KV, D, bq, bkv)) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch_dq<float, kPruned>(device, q, k, v, seg, kv_idx, kv_count,
                                     dout, lse, delta, dq, B, S, H, KV, D, bq,
                                     bkv, causal, scale, stream);
  if (dtype == 1)
    return launch_dq<__nv_bfloat16, kPruned>(device, q, k, v, seg, kv_idx,
                                             kv_count, dout, lse, delta, dq,
                                             B, S, H, KV, D, bq, bkv, causal,
                                             scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <bool kPruned>
int dispatch_dkv(int dtype, int device, const void* q, const void* k,
                 const void* v, const int* seg, const int* q_idx,
                 const int* q_count, const void* dout, const float* lse,
                 const float* delta, void* dk, void* dv, int B, int S, int H,
                 int KV, int D, int bq, int bkv, int causal, float scale,
                 void* stream) {
  if (bad_shape(S, H, KV, D, bq, bkv)) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch_dkv<float, kPruned>(device, q, k, v, seg, q_idx, q_count,
                                      dout, lse, delta, dk, dv, B, S, H, KV,
                                      D, bq, bkv, causal, scale, stream);
  if (dtype == 1)
    return launch_dkv<__nv_bfloat16, kPruned>(device, q, k, v, seg, q_idx,
                                              q_count, dout, lse, delta, dk,
                                              dv, B, S, H, KV, D, bq, bkv,
                                              causal, scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q, dout, dq are (B, S, H, D); k, v, dk,
// dv are (B, S, KV, D); lse and delta are (B, S, H) fp32; seg (B, S) int32 may
// be null for the dense kernels (no segment mask).  Each function launches
// one kernel and returns cudaGetLastError() after it (0 = success).
extern "C" int flash_bwd_dq_dense(int dtype, int device, const void* q,
                                  const void* k, const void* v, const int* seg,
                                  const void* dout, const float* lse,
                                  const float* delta, void* dq, int B, int S,
                                  int H, int KV, int D, int bq, int bkv,
                                  int causal, float scale, void* stream) {
  return dispatch_dq<false>(dtype, device, q, k, v, seg, nullptr, nullptr,
                            dout, lse, delta, dq, B, S, H, KV, D, bq, bkv,
                            causal, scale, stream);
}

// As flash_bwd_dq_dense over the row tables kv_idx (B, S/bq, S/bkv) and
// kv_count (B, S/bq); seg is required.
extern "C" int flash_bwd_dq_pruned(int dtype, int device, const void* q,
                                   const void* k, const void* v,
                                   const int* seg, const int* kv_idx,
                                   const int* kv_count, const void* dout,
                                   const float* lse, const float* delta,
                                   void* dq, int B, int S, int H, int KV,
                                   int D, int bq, int bkv, int causal,
                                   float scale, void* stream) {
  if (seg == nullptr || kv_idx == nullptr || kv_count == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch_dq<true>(dtype, device, q, k, v, seg, kv_idx, kv_count,
                           dout, lse, delta, dq, B, S, H, KV, D, bq, bkv,
                           causal, scale, stream);
}

extern "C" int flash_bwd_dkv_dense(int dtype, int device, const void* q,
                                   const void* k, const void* v,
                                   const int* seg, const void* dout,
                                   const float* lse, const float* delta,
                                   void* dk, void* dv, int B, int S, int H,
                                   int KV, int D, int bq, int bkv, int causal,
                                   float scale, void* stream) {
  return dispatch_dkv<false>(dtype, device, q, k, v, seg, nullptr, nullptr,
                             dout, lse, delta, dk, dv, B, S, H, KV, D, bq,
                             bkv, causal, scale, stream);
}

// As flash_bwd_dkv_dense over the column tables q_idx (B, S/bkv, S/bq) and
// q_count (B, S/bkv); seg is required.
extern "C" int flash_bwd_dkv_pruned(int dtype, int device, const void* q,
                                    const void* k, const void* v,
                                    const int* seg, const int* q_idx,
                                    const int* q_count, const void* dout,
                                    const float* lse, const float* delta,
                                    void* dk, void* dv, int B, int S, int H,
                                    int KV, int D, int bq, int bkv,
                                    int causal, float scale, void* stream) {
  if (seg == nullptr || q_idx == nullptr || q_count == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch_dkv<true>(dtype, device, q, k, v, seg, q_idx, q_count, dout,
                            lse, delta, dk, dv, B, S, H, KV, D, bq, bkv,
                            causal, scale, stream);
}

extern "C" const char* flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
