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
// Four entry points, each a template instantiation (dense, pruned) of one
// pass, and each on two routes (below):
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
// intrinsic, so K5 == K2 and K6 == K3 bit for bit on both routes (mma.sync's
// sums are deterministic for the same operands).  There are no row
// reductions in the backward (delta comes in precomputed); on the CUDA-core
// route every output element is one sequential fma chain.
//
// Masking contract (the forward's): key j is visible to query i iff
// (causal => j <= i, by absolute row position) and segment ids match with the
// key's id > 0.  P is built from the mask, never from exp(S - NEG_INF), so a
// row with no visible key (lse = NEG_INF) gives exactly zero dq and adds
// nothing to dk/dv.
//
// Two routes, chosen by the dtype (no switch):
//
// fp32 (all four kernels) runs the CUDA-core loop below, the exact rail
// (2e-5).  A (128 x 128) tile pair at d_head 128 needs q, dO, k, v and a
// score tile, ~330 KB in fp32, above the 227 KB a block may use, so a block
// owns kRows = 32 rows of its stationary block (a sub-range of the pinned q
// block for dQ, of the kv block for dK/dV) and all rows of the moving block;
// each thread keeps a 2 x 8 register micro-tile and every product is an
// fp32 fma chain (no TF32).  Each row's sums are independent of the other
// rows, so the liveness tables, the visiting order and every row's
// arithmetic stay those of the pinned (block_q, block_kv) pair.
//
// bf16 (all four kernels; namespace tc) runs on the tensor cores,
// mma.sync.m16n8k16 bf16 -> fp32, one 256-thread block per whole pinned tile
// (one block per SM), warp w owning its rows 16w .. 16w+15 (warps past a
// ragged tile idle):
//
// * Loads.  Rows are copied by cp.async in 16-byte pieces (so D % 8 == 0 and
//   16-byte aligned operands, which the wrapper checks) into rows of D
//   rounded up to 16 plus 8 bf16, a pitch of 4 banks modulo 32, so ldmatrix
//   reads without bank conflicts.  Shared memory is zeroed once; the copies
//   fill rows < block and columns < D, so the tails up to the MMA
//   granularity stay 0 (masked entries are 0 x 0).  The moving rows of each
//   live step go through a two-stage ring: the next live step's copies are
//   issued before this step's math, and two barriers a step hand the stages
//   over.
// * Products.  Per 32-column chunk of the moving tile, the scores and dP in
//   the accumulator registers, P and scale.dS formed there under the mask;
//   then, FlashAttention-2's reuse, two adjacent n8 accumulator tiles are one
//   k16 A fragment of the second products, whose B operand comes by
//   ldmatrix.trans.  P and dS never touch shared memory; the gradients stay
//   in fp32 registers over the whole walk and are written once, in bf16.  A
//   64-column chunk spills.
// * dQ (K2, K5), q-stationary like the forward.  A block per (q block of up
//   to 128 rows, q head, batch row): 48 x 16 x 2 = 1536 blocks at the
//   training shape, the last q blocks first (the most live tiles under the
//   causal mask, so the longest blocks start in the first wave).  The q and
//   dO rows are copied once and kept in registers as ldmatrix A fragments;
//   each thread keeps lse, delta and the segment id of its two rows in
//   registers.  The ring carries each live kv tile's k and v rows and
//   segment ids (209,920 bytes at d_head 128).  Per chunk: S = Q.K^T and
//   dP = dO.V^T (K, V as the column-major B operand), then dQ +=
//   (scale.dS).K with K by ldmatrix.trans; a chunk wholly above the
//   diagonal of the warp's rows is skipped.  Registers: dQ 64, the q and dO
//   fragments 64, the chunk's S and dP 32.
// * dK/dV (K3, K6), kv-stationary.  A block per (kv tile of up to 128 rows,
//   kv head, batch row): 48 x 8 x 2 = 768 blocks at the training shape.  K
//   and V stay in shared memory; the ring carries each (group member, q
//   block) step's q rows, dO rows, lse, delta and q segment ids (211,968
//   bytes at d_head 128).  Per chunk of the q block: S^T = K.Q^T and
//   dP^T = V.dO^T (K, V as the A operand, the q rows as the column-major B
//   operand), then dV += P^T.dO and dK += (scale.dS)^T.Q with dO and Q by
//   ldmatrix.trans.  The GQA group is summed in registers: dK/dV leave at
//   kv-head resolution, with no atomics.  Registers: 128 for dK/dV and 32
//   for the chunk's S^T/dP^T.
// * Rounding.  P is rounded to bf16 for dV (P is in [0, 1] and dV's terms
//   do not cancel).  scale.dS goes into dQ as one bf16 term, and into dK as
//   two, hi = rn(x) and lo = rn(x - hi), one product each: on a peaked
//   softmax (q x 4) one term leaves the 2e-2 tolerance in dK, whose large
//   terms cancel, but stays within 0.26 of it in dQ (CPU models of both
//   roundings against the JAX backward: tests/test_torch_kernels.py,
//   TestBf16DqRounding and TestBf16DkvRounding).
// * Liveness.  K5 and K6 walk the row and column tables; K2 and K3 test each
//   moving block with the _block_live rule, the segment ranges reduced by
//   each warp with __reduce_min/max_sync (warp_seg_range), so no thread
//   waits on one.
//
// What bounds it on the H100 at the training shapes (two packed rows of up to
// 6144 tokens, 16 q heads over 8 kv heads, d_head 128, bf16): the visible
// (query, key) pairs cost 6 D FLOPs (dQ) and 8 D (dK/dV) per q head,
// hundreds of GFLOP per layer, so by the card's peak rates the passes are
// bound by operations, not bytes.  The CUDA-core route reaches ~1 % of the
// tensor-core rate.  The bf16 route is held back by shared-memory traffic
// (each warp reads the whole moving tile by ldmatrix, so the eight warps
// read it eight times) and by latency: one 8-warp block per SM, synchronous
// ldmatrix -> mma chains.  wgmma with TMA is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_common.cuh"

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
using tc::kSegBig;

// Copy `rows` rows of `d` elements (row r at src + r * row_stride) into a
// shared tile with leading dimension ld.
__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ src,
                                          int rows, int d, size_t row_stride,
                                          int ld) {
  for (int idx = threadIdx.x; idx < rows * d; idx += kThreads) {
    const int r = idx / d;
    const int c = idx - r * d;
    dst[r * ld + c] = src[r * row_stride + c];
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

__device__ __forceinline__ void store_rows(float* __restrict__ dst,
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
      if (d < D) dst[r * row_stride + d] = acc[rr][dd];
    }
  }
}

// dQ: one block per (32-row sub-range of a q block, q head, batch row).
template <bool kPruned>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const int* __restrict__ seg,
                        const int* __restrict__ kv_idx,
                        const int* __restrict__ kv_count,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, float* __restrict__ dq,
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
template <bool kPruned>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const int* __restrict__ seg,
                         const int* __restrict__ q_idx,
                         const int* __restrict__ q_count,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, float* __restrict__ dk,
                         float* __restrict__ dv, int S, int H, int KV, int D,
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

}  // namespace

// ---------------------------------------------------------------------------
// The bf16 passes on the tensor cores (K2, K3, K5 and K6 when the inputs are
// bf16; see the note at the head of the file).  The helpers are in
// tc_common.cuh.
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kChunk = 32;                // moving-tile columns of one register chunk
constexpr int kChunkTiles = kChunk / 8;   // n8 accumulator tiles of a chunk
constexpr int kDimTiles = kMaxHeadDim / 8;  // n8 accumulator tiles of dQ, dK and dV
constexpr int kRowFrags = kMaxHeadDim / 16;  // k16 A fragments of a q or dO row block

// The dK/dV pass's shared memory, in byte offsets: the K and V tiles, then
// two ring stages of stage_bytes each (q rows, dO rows, lse, delta and the
// q rows' segment ids).  Plain scalars, so nothing is indexed at run
// time and nothing lands in local memory.
struct Layout {
  unsigned tile, v, ring, stage_bytes, o, lse, delta, seg, total;
};

__host__ __device__ __forceinline__ Layout layout(int D) {
  Layout L;
  L.tile = kTileRows * pitch(D) * 2;
  const unsigned stat = kTileRows * 4;
  L.v = L.tile;
  L.ring = 2 * L.tile;
  L.o = L.tile;  // within a stage; the q rows start at 0
  L.lse = 2 * L.tile;
  L.delta = L.lse + stat;
  L.seg = L.delta + stat;
  L.stage_bytes = L.seg + stat;
  L.total = L.ring + 2 * L.stage_bytes;
  return L;
}

// One ring stage: what one step of the walk copies in and reads.
struct Stage {
  __nv_bfloat16* q;  // [kTileRows][pitch] the q block's rows of head h
  __nv_bfloat16* o;  // [kTileRows][pitch] the same rows of dO
  float* lse;        // [kTileRows]
  float* delta;      // [kTileRows]
  int* seg;          // [kTileRows] the q rows' segment ids
};

// One (group member, q block) step for this warp's 16 kv rows r0 .. r0+15:
// acc_v += P^T . dO and acc_k += (scale dS)^T . Q, the q block taken in
// chunks of kChunk columns.  Per chunk: S^T = K . Q^T and dP^T = V . dO^T
// on the tensor cores (K, V as the row-major A operand, the q rows as the
// column-major B operand, both by ldmatrix); P^T and scale dS^T in the
// accumulator registers under the mask; then those registers are the A
// operand of the second products (two adjacent n8 accumulator tiles are one
// k16 A fragment) against dO and Q by ldmatrix.trans: P rounded to bf16,
// scale dS as two bf16 terms (hi, lo), one product each.
__device__ __forceinline__ void dkv_step(const __nv_bfloat16* ks, const __nv_bfloat16* vs,
                                         const Stage& st, int pitch_, int dpad, int R, int bq,
                                         int k_pos0, int q_pos0, bool causal, bool has_seg,
                                         const int (&kseg)[2], float scale,
                                         float (&acc_k)[kDimTiles][4],
                                         float (&acc_v)[kDimTiles][4]) {
  const int lane = threadIdx.x % 32;
  const int r0 = (threadIdx.x / 32) * 16;
  const int g = lane / 4, tig = lane % 4;
  // ldmatrix.x4 row addresses.  A operand (and the trans B operand): the four
  // matrices are (rows 0-7, cols 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15).
  // Plain B operand: (rows 0-7, cols 0-7), (0-7, 8-15), (8-15, 0-7), (8-15, 8-15),
  // i.e. the k halves of two n8 tiles.
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + (lane >> 4) * 8, b_col = ((lane >> 3) & 1) * 8;
  const uint32_t k_addr = smem_addr(ks + (r0 + a_row) * pitch_ + a_col);
  const uint32_t v_addr = smem_addr(vs + (r0 + a_row) * pitch_ + a_col);
  const uint32_t q_addr = smem_addr(st.q + b_row * pitch_ + b_col);
  const uint32_t o_addr = smem_addr(st.o + b_row * pitch_ + b_col);
  const uint32_t qt_addr = smem_addr(st.q + a_row * pitch_ + a_col);
  const uint32_t ot_addr = smem_addr(st.o + a_row * pitch_ + a_col);
  const uint32_t row_bytes = 2u * pitch_;
  const float scale_log2 = __fmul_rn(scale, kLog2e);

  for (int c0 = 0; c0 < bq; c0 += kChunk) {
    float s[kChunkTiles][4], dp[kChunkTiles][4];
#pragma unroll
    for (int j = 0; j < kChunkTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = 0.f;
        dp[j][e] = 0.f;
      }

    for (int kk = 0; kk < dpad; kk += 16) {
      uint32_t ak[4], av[4];
      ldsm_x4(ak, k_addr + 2 * kk);
      ldsm_x4(av, v_addr + 2 * kk);
#pragma unroll
      for (int j = 0; j < kChunkTiles / 2; ++j) {
        const uint32_t off = (c0 + 16 * j) * row_bytes + 2 * kk;
        uint32_t bq_frag[4], bo_frag[4];
        ldsm_x4(bq_frag, q_addr + off);
        ldsm_x4(bo_frag, o_addr + off);
        mma_bf16(s[2 * j], ak, bq_frag[0], bq_frag[1]);
        mma_bf16(s[2 * j + 1], ak, bq_frag[2], bq_frag[3]);
        mma_bf16(dp[2 * j], av, bo_frag[0], bo_frag[1]);
        mma_bf16(dp[2 * j + 1], av, bo_frag[2], bo_frag[3]);
      }
    }

    // A warp's 16 x kChunk piece that the mask cannot touch (all its rows
    // and columns inside the blocks, every key at or before every query, one
    // positive segment throughout) skips the per-element test; the
    // arithmetic is the same.
    bool open = r0 + 16 <= R && c0 + kChunk <= bq &&
                (!causal || k_pos0 + r0 + 15 <= q_pos0 + c0);
    if (open && has_seg) {
      const int id = __shfl_sync(0xffffffffu, kseg[0], 0);
      bool same = kseg[0] == id && kseg[1] == id && id > 0;
#pragma unroll
      for (int j = 0; j < kChunkTiles; ++j)
        same = same && st.seg[c0 + 8 * j + 2 * tig] == id && st.seg[c0 + 8 * j + 2 * tig + 1] == id;
      open = __all_sync(0xffffffffu, same);
    }

    // Accumulator element e of tile j: kv row r0 + g (+8 for e >= 2), q
    // column c0 + 8j + 2 tig (+1 for odd e).  P is built from the mask,
    // never from exp(S - NEG_INF).
    auto p_ds = [&](float& s_, float& dp_, int c) {  // a visible entry
      s_ = exp2f(__fmaf_rn(s_, scale_log2, -__fmul_rn(st.lse[c], kLog2e)));
      dp_ = __fmul_rn(__fmul_rn(s_, __fsub_rn(dp_, st.delta[c])), scale);
    };
    if (open) {
#pragma unroll
      for (int j = 0; j < kChunkTiles; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) p_ds(s[j][e], dp[j][e], c0 + 8 * j + 2 * tig + (e & 1));
    } else {
#pragma unroll
      for (int j = 0; j < kChunkTiles; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = r0 + g + (e >> 1) * 8;
          const int c = c0 + 8 * j + 2 * tig + (e & 1);
          bool ok = r < R && c < bq;
          if (causal) ok = ok && k_pos0 + r <= q_pos0 + c;
          if (has_seg) ok = ok && kseg[e >> 1] > 0 && st.seg[c] == kseg[e >> 1];
          if (ok) {
            p_ds(s[j][e], dp[j][e], c);
          } else {
            s[j][e] = 0.f;
            dp[j][e] = 0.f;
          }
        }
    }

#pragma unroll
    for (int j = 0; j < kChunkTiles / 2; ++j) {
      if (c0 + 16 * j >= bq) break;  // the rest of the chunk is past the q block
      const uint32_t ap[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                              pack_bf16(s[2 * j][2], s[2 * j][3]),
                              pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                              pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
      uint32_t ads[4], ads_lo[4];
      split_bf16(dp[2 * j][0], dp[2 * j][1], ads[0], ads_lo[0]);
      split_bf16(dp[2 * j][2], dp[2 * j][3], ads[1], ads_lo[1]);
      split_bf16(dp[2 * j + 1][0], dp[2 * j + 1][1], ads[2], ads_lo[2]);
      split_bf16(dp[2 * j + 1][2], dp[2 * j + 1][3], ads[3], ads_lo[3]);
      const uint32_t off = (c0 + 16 * j) * row_bytes;
#pragma unroll
      for (int n = 0; n < kDimTiles / 2; ++n) {
        if (16 * n < dpad) {
          uint32_t bo_frag[4], bq_frag[4];
          ldsm_x4_trans(bo_frag, ot_addr + off + 32 * n);
          ldsm_x4_trans(bq_frag, qt_addr + off + 32 * n);
          mma_bf16(acc_v[2 * n], ap, bo_frag[0], bo_frag[1]);
          mma_bf16(acc_v[2 * n + 1], ap, bo_frag[2], bo_frag[3]);
          mma_bf16(acc_k[2 * n], ads, bq_frag[0], bq_frag[1]);
          mma_bf16(acc_k[2 * n + 1], ads, bq_frag[2], bq_frag[3]);
          mma_bf16(acc_k[2 * n], ads_lo, bq_frag[0], bq_frag[1]);
          mma_bf16(acc_k[2 * n + 1], ads_lo, bq_frag[2], bq_frag[3]);
        }
      }
    }
  }
}

// dK/dV in bf16: one block per (whole pinned kv tile, kv head, batch row);
// warp w owns kv rows 16w .. 16w+15 of the tile.
template <bool kPruned>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_tc_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v, const int* __restrict__ seg,
                            const int* __restrict__ q_idx, const int* __restrict__ q_count,
                            const __nv_bfloat16* __restrict__ dout,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                            int S, int H, int KV, int D, int bq, int bkv, int causal,
                            float scale) {
  extern __shared__ __align__(128) unsigned char tc_smem[];
  const Layout L = layout(D);
  const int kb = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int group = H / KV;
  const int nq = S / bq, nk = S / bkv;
  const int k0 = kb * bkv;
  const int R = bkv;
  const bool has_seg = seg != nullptr;
  const int tid = threadIdx.x;
  const int pitch_ = pitch(D), dpad = padded_dim(D), d8 = D / 8;
  const size_t q_stride = static_cast<size_t>(H) * D;
  const size_t kv_stride = static_cast<size_t>(KV) * D;
  const size_t row0 = static_cast<size_t>(b) * S;
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(tc_smem);
  __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(tc_smem + L.v);

  // Zero everything once: the copies below fill only rows < bkv (bq) and
  // columns < D, so the tails up to the MMA granularity stay zero (masked
  // entries are then 0 x 0, never 0 x garbage).
  for (unsigned i = tid; i < L.total / 16; i += kThreads)
    reinterpret_cast<uint4*>(tc_smem)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  const size_t kv_off = (row0 + k0) * kv_stride + static_cast<size_t>(kvh) * D;
  for (int idx = tid; idx < R * d8; idx += kThreads) {
    const int r = idx / d8, c = (idx - r * d8) * 8;
    cp_async16(ks + r * pitch_ + c, k + kv_off + r * kv_stride + c);
    cp_async16(vs + r * pitch_ + c, v + kv_off + r * kv_stride + c);
  }

  // This thread's two kv rows' segment ids, and (dense liveness) the whole
  // pinned kv tile's segment range, reduced by each warp.
  const int my_row = (tid / 32) * 16 + (tid % 32) / 4;
  int kseg[2] = {0, 0};
  if (has_seg)
    for (int i = 0; i < 2; ++i)
      if (my_row + 8 * i < R) kseg[i] = seg[row0 + k0 + my_row + 8 * i];
  int k_lo = kSegBig, k_hi = 0;
  if (!kPruned && has_seg) warp_seg_range(seg + row0 + k0, bkv, k_lo, k_hi);

  // The walk: (group member, q block) pairs, members first, q blocks
  // ascending; the dense kernel skips the dead ones by the _block_live rule.
  const int col_tables = b * nk + kb;
  const int n_steps = kPruned ? q_count[col_tables] : nq;
  const int total = group * n_steps;
  auto q_block = [&](int t) {
    const int i = t % n_steps;
    return kPruned ? q_idx[static_cast<size_t>(col_tables) * nq + i] : i;
  };
  auto next_live = [&](int t) {
    if (kPruned) return t;
    for (; t < total; ++t) {
      const int q0 = q_block(t) * bq;
      bool ok = !causal || q0 + bq - 1 >= k0;
      if (ok && has_seg) {
        int q_lo, q_hi;
        warp_seg_range(seg + row0 + q0, bq, q_lo, q_hi);
        ok = q_hi > 0 && k_hi > 0 && q_hi >= k_lo && k_hi >= q_lo;
      }
      if (ok) break;
    }
    return t;
  };
  auto stage = [&](int s) {
    unsigned char* base = tc_smem + L.ring + s * L.stage_bytes;
    return Stage{reinterpret_cast<__nv_bfloat16*>(base),
                 reinterpret_cast<__nv_bfloat16*>(base + L.o),
                 reinterpret_cast<float*>(base + L.lse),
                 reinterpret_cast<float*>(base + L.delta),
                 reinterpret_cast<int*>(base + L.seg)};
  };
  auto issue = [&](int t, int s) {  // cp.async the step's q rows into stage s
    const int h = kvh * group + t / n_steps;
    const int q0 = q_block(t) * bq;
    const Stage st = stage(s);
    const size_t off = (row0 + q0) * q_stride + static_cast<size_t>(h) * D;
    for (int idx = tid; idx < bq * d8; idx += kThreads) {
      const int r = idx / d8, c = (idx - r * d8) * 8;
      cp_async16(st.q + r * pitch_ + c, q + off + r * q_stride + c);
      cp_async16(st.o + r * pitch_ + c, dout + off + r * q_stride + c);
    }
    for (int i = tid; i < bq; i += kThreads) {
      const size_t pos = row0 + q0 + i;
      cp_async4(st.lse + i, lse + pos * H + h);
      cp_async4(st.delta + i, delta + pos * H + h);
      if (has_seg) cp_async4(st.seg + i, seg + pos);
    }
  };

  float acc_k[kDimTiles][4], acc_v[kDimTiles][4];
#pragma unroll
  for (int n = 0; n < kDimTiles; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc_k[n][e] = 0.f;
      acc_v[n][e] = 0.f;
    }

  // A two-stage ring: step t's copies are in flight while step t-1 computes.
  int t = next_live(0);
  if (t < total) issue(t, 0);
  cp_async_commit();  // with the K/V tile
  for (int s = 0; t < total; s ^= 1) {
    const int t_next = next_live(t + 1);
    if (t_next < total) issue(t_next, s ^ 1);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    if ((tid / 32) * 16 < R)
      dkv_step(ks, vs, stage(s), pitch_, dpad, R, bq, k0, q_block(t) * bq, causal != 0, has_seg,
               kseg, scale, acc_k, acc_v);
    __syncthreads();  // stage s is refilled by the next iteration's copies
    t = t_next;
  }
  cp_async_wait_all();

  // dK and dV leave once, in bf16, for the tile's rows only.
  const int g = (tid % 32) / 4, tig = tid % 4;
  const int r0 = (tid / 32) * 16;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + g + 8 * half;
    if (r >= R) continue;
    const size_t row_off = kv_off + r * kv_stride;
#pragma unroll
    for (int n = 0; n < kDimTiles; ++n) {
      const int c = 8 * n + 2 * tig;
      if (c < D) {
        *reinterpret_cast<__nv_bfloat162*>(dk + row_off + c) =
            __floats2bfloat162_rn(acc_k[n][2 * half], acc_k[n][2 * half + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dv + row_off + c) =
            __floats2bfloat162_rn(acc_v[n][2 * half], acc_v[n][2 * half + 1]);
      }
    }
  }
}

// The dQ pass's shared memory: the pinned q and dO tiles (dO at L.tile),
// then the kv ring (tc_common.cuh).
__host__ __device__ __forceinline__ KvRingLayout dq_layout(int D) { return kv_ring_layout(D, 2); }

// One live kv tile for this warp's q rows r0 .. r0+15: dq += (scale dS) . K,
// the tile taken in chunks of kChunk columns.  Per chunk: S = Q . K^T and
// dP = dO . V^T on the tensor cores (the q and dO rows as register A
// fragments, the k and v rows as the column-major B operand by ldmatrix);
// P and scale dS in the accumulator registers under the mask; then those
// registers, scale dS rounded to one bf16 term, are the A operand of
// dQ += (scale dS) . K with K by ldmatrix.trans.  Element e of n8 tile j is
// q row r0 + g (+8 for e >= 2) and column 8j + 2 tig (+1 for odd e);
// nlse[i] = -lse * log2(e) and delta[i] belong to the thread's rows
// r0 + g + 8i.
__device__ __forceinline__ void dq_step(const uint32_t (&qf)[kRowFrags][4],
                                        const uint32_t (&of)[kRowFrags][4],
                                        const __nv_bfloat16* ks, const __nv_bfloat16* vs,
                                        const int* kseg, int pitch_, int dpad, int bq, int bkv,
                                        int q_pos0, int k_pos0, bool causal, bool has_seg,
                                        const int (&qseg)[2], const float (&nlse)[2],
                                        const float (&delta)[2], float scale,
                                        float (&dq)[kDimTiles][4]) {
  const int lane = threadIdx.x % 32;
  const int r0 = (threadIdx.x / 32) * 16;
  const int g = lane / 4, tig = lane % 4;
  // ldmatrix.x4 row addresses.  K and V as the plain B operand: (rows 0-7,
  // cols 0-7), (0-7, 8-15), (8-15, 0-7), (8-15, 8-15), the k halves of two
  // n8 tiles.  K as the trans B operand: (0-7, 0-7), (8-15, 0-7), (0-7,
  // 8-15), (8-15, 8-15).
  const int b_row = (lane & 7) + (lane >> 4) * 8, b_col = ((lane >> 3) & 1) * 8;
  const int t_row = (lane & 7) + ((lane >> 3) & 1) * 8, t_col = (lane >> 4) * 8;
  const uint32_t k_addr = smem_addr(ks + b_row * pitch_ + b_col);
  const uint32_t v_addr = smem_addr(vs + b_row * pitch_ + b_col);
  const uint32_t kt_addr = smem_addr(ks + t_row * pitch_ + t_col);
  const uint32_t row_bytes = 2u * pitch_;
  const float scale_log2 = __fmul_rn(scale, kLog2e);

  for (int c0 = 0; c0 < bkv; c0 += kChunk) {
    // Every key from here on lies after every query of the warp.
    if (causal && k_pos0 + c0 > q_pos0 + r0 + 15) break;

    float s[kChunkTiles][4], dp[kChunkTiles][4];
#pragma unroll
    for (int j = 0; j < kChunkTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = 0.f;
        dp[j][e] = 0.f;
      }
#pragma unroll
    for (int kk = 0; kk < kRowFrags; ++kk) {
      if (16 * kk < dpad) {
#pragma unroll
        for (int jp = 0; jp < kChunkTiles / 2; ++jp) {
          if (c0 + 16 * jp < bkv) {
            const uint32_t off = (c0 + 16 * jp) * row_bytes + 32 * kk;
            uint32_t bk[4], bv[4];
            ldsm_x4(bk, k_addr + off);
            ldsm_x4(bv, v_addr + off);
            mma_bf16(s[2 * jp], qf[kk], bk[0], bk[1]);
            mma_bf16(s[2 * jp + 1], qf[kk], bk[2], bk[3]);
            mma_bf16(dp[2 * jp], of[kk], bv[0], bv[1]);
            mma_bf16(dp[2 * jp + 1], of[kk], bv[2], bv[3]);
          }
        }
      }
    }

    // A piece the mask cannot touch (all its rows and columns inside the
    // blocks, every key at or before every query, one positive segment
    // throughout) skips the per-element test; the arithmetic is the same.
    bool open = r0 + 16 <= bq && c0 + kChunk <= bkv &&
                (!causal || k_pos0 + c0 + kChunk - 1 <= q_pos0 + r0);
    if (open && has_seg) {
      const int id = __shfl_sync(0xffffffffu, qseg[0], 0);
      bool same = qseg[0] == id && qseg[1] == id && id > 0;
#pragma unroll
      for (int j = 0; j < kChunkTiles; ++j) {
        const int2 ids = *reinterpret_cast<const int2*>(kseg + c0 + 8 * j + 2 * tig);
        same = same && ids.x == id && ids.y == id;
      }
      open = __all_sync(0xffffffffu, same);
    }

    // scale dS = scale P (dP - delta), P built from the mask, never from
    // exp(S - NEG_INF); it overwrites dp.
    auto ds = [&](float s_, float& dp_, int i) {  // a visible entry of row half i
      const float p = exp2f(__fmaf_rn(s_, scale_log2, nlse[i]));
      dp_ = __fmul_rn(__fmul_rn(p, __fsub_rn(dp_, delta[i])), scale);
    };
    if (open) {
#pragma unroll
      for (int j = 0; j < kChunkTiles; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) ds(s[j][e], dp[j][e], e >> 1);
    } else {
#pragma unroll
      for (int j = 0; j < kChunkTiles; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = r0 + g + (e >> 1) * 8;
          const int c = c0 + 8 * j + 2 * tig + (e & 1);
          bool ok = r < bq && c < bkv;
          if (causal) ok = ok && k_pos0 + c <= q_pos0 + r;
          if (has_seg) ok = ok && kseg[c] > 0 && kseg[c] == qseg[e >> 1];
          if (ok)
            ds(s[j][e], dp[j][e], e >> 1);
          else
            dp[j][e] = 0.f;
        }
    }

    // dQ += (scale dS) . K, scale dS rounded to bf16.
#pragma unroll
    for (int kk = 0; kk < kChunkTiles / 2; ++kk) {
      if (c0 + 16 * kk < bkv) {
        const uint32_t a[4] = {pack_bf16(dp[2 * kk][0], dp[2 * kk][1]),
                               pack_bf16(dp[2 * kk][2], dp[2 * kk][3]),
                               pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
                               pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
        const uint32_t off = (c0 + 16 * kk) * row_bytes;
#pragma unroll
        for (int n = 0; n < kDimTiles / 2; ++n) {
          if (16 * n < dpad) {
            uint32_t b[4];
            ldsm_x4_trans(b, kt_addr + off + 32 * n);
            mma_bf16(dq[2 * n], a, b[0], b[1]);
            mma_bf16(dq[2 * n + 1], a, b[2], b[3]);
          }
        }
      }
    }
  }
}

// dQ in bf16: one block per (whole pinned q block, q head, batch row), the
// last q blocks first; warp w owns q rows 16w .. 16w+15 of the block.
template <bool kPruned>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_tc_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v, const int* __restrict__ seg,
                           const int* __restrict__ kv_idx, const int* __restrict__ kv_count,
                           const __nv_bfloat16* __restrict__ dout,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           __nv_bfloat16* __restrict__ dq, int S, int H, int KV, int D, int bq,
                           int bkv, int causal, float scale) {
  extern __shared__ __align__(128) unsigned char tc_smem[];
  const KvRingLayout L = dq_layout(D);
  const int nq = S / bq, nk = S / bkv;
  const int heads_rows = gridDim.x / nq;  // H * B
  const int block = blockIdx.x;
  const int qb = nq - 1 - block / heads_rows;
  const int h = block % H, b = (block % heads_rows) / H;
  const int kvh = h / (H / KV);
  const int q0 = qb * bq;
  const bool has_seg = seg != nullptr;
  const int tid = threadIdx.x, lane = tid % 32;
  const int r0 = (tid / 32) * 16, g = lane / 4, tig = lane % 4;
  const int pitch_ = pitch(D), dpad = padded_dim(D), d8 = D / 8;
  const size_t q_stride = static_cast<size_t>(H) * D;
  const size_t kv_stride = static_cast<size_t>(KV) * D;
  const size_t row0 = static_cast<size_t>(b) * S;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(tc_smem);
  __nv_bfloat16* os = reinterpret_cast<__nv_bfloat16*>(tc_smem + L.tile);

  // Zero everything once: the copies below fill only rows < bq (bkv) and
  // columns < D, so the tails up to the MMA granularity stay zero (masked
  // entries are then 0 x 0, never 0 x garbage).
  for (unsigned i = tid; i < L.total / 16; i += kThreads)
    reinterpret_cast<uint4*>(tc_smem)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  const size_t q_off = (row0 + q0) * q_stride + static_cast<size_t>(h) * D;
  for (int idx = tid; idx < bq * d8; idx += kThreads) {
    const int r = idx / d8, c = (idx - r * d8) * 8;
    cp_async16(qs + r * pitch_ + c, q + q_off + r * q_stride + c);
    cp_async16(os + r * pitch_ + c, dout + q_off + r * q_stride + c);
  }
  cp_async_commit();

  // This thread's two q rows: segment ids, -lse * log2(e) and delta; and
  // (dense liveness) the whole pinned q block's segment range, reduced by
  // each warp.
  int qseg[2] = {0, 0};
  float nlse[2] = {0.f, 0.f}, dlt[2] = {0.f, 0.f};
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + g + 8 * i;
    if (r < bq) {
      const size_t pos = row0 + q0 + r;
      nlse[i] = -__fmul_rn(lse[pos * H + h], kLog2e);
      dlt[i] = delta[pos * H + h];
      if (has_seg) qseg[i] = seg[pos];
    }
  }
  int q_lo = kSegBig, q_hi = 0;
  if (!kPruned && has_seg) warp_seg_range(seg + row0 + q0, bq, q_lo, q_hi);

  // The walk: kv blocks ascending; the dense kernel skips the dead ones by
  // the _block_live rule.
  const int row_tables = b * nq + qb;
  const int n_steps = kPruned ? kv_count[row_tables] : nk;
  auto kv_block = [&](int t) {
    return kPruned ? kv_idx[static_cast<size_t>(row_tables) * nk + t] : t;
  };
  auto next_live = [&](int t) {
    return kPruned ? t
                   : next_live_kv(t, n_steps, q0, bq, bkv, causal != 0,
                                  has_seg ? seg + row0 : nullptr, q_lo, q_hi);
  };
  auto stage = [&](int s) { return tc_smem + L.ring + s * L.stage_bytes; };
  auto issue = [&](int t, int s) {  // cp.async the tile's k, v rows and segment ids into stage s
    const int k0 = kv_block(t) * bkv;
    copy_kv_tile(stage(s), L, k, v, (row0 + k0) * kv_stride + static_cast<size_t>(kvh) * D,
                 kv_stride, has_seg ? seg + row0 + k0 : nullptr, bkv, D);
  };

  float acc[kDimTiles][4];
#pragma unroll
  for (int n = 0; n < kDimTiles; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  int t = next_live(0);
  if (t < n_steps) issue(t, 0);
  cp_async_commit();
  cp_async_wait_prev();  // the q and dO tiles have landed
  __syncthreads();
  uint32_t qf[kRowFrags][4], of[kRowFrags][4];
  {
    const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_col = (lane >> 4) * 8;
    const uint32_t q_addr = smem_addr(qs + (r0 + a_row) * pitch_ + a_col);
    const uint32_t o_addr = smem_addr(os + (r0 + a_row) * pitch_ + a_col);
#pragma unroll
    for (int kk = 0; kk < kRowFrags; ++kk) {
      if (16 * kk < dpad) {
        ldsm_x4(qf[kk], q_addr + 32 * kk);
        ldsm_x4(of[kk], o_addr + 32 * kk);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          qf[kk][e] = 0u;
          of[kk][e] = 0u;
        }
      }
    }
  }

  // A two-stage ring: tile t+1's copies are in flight while tile t computes.
  for (int s = 0; t < n_steps; s ^= 1) {
    const int t_next = next_live(t + 1);
    if (t_next < n_steps) issue(t_next, s ^ 1);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    if (r0 < bq) {
      const unsigned char* base = stage(s);
      dq_step(qf, of, reinterpret_cast<const __nv_bfloat16*>(base),
              reinterpret_cast<const __nv_bfloat16*>(base + L.v),
              reinterpret_cast<const int*>(base + L.seg), pitch_, dpad, bq, bkv, q0,
              kv_block(t) * bkv, causal != 0, has_seg, qseg, nlse, dlt, scale, acc);
    }
    __syncthreads();  // stage s is refilled by the next iteration's copies
    t = t_next;
  }
  cp_async_wait_all();

  // dQ leaves once, in bf16, for the block's rows only.
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + g + 8 * half;
    if (r >= bq) continue;
    __nv_bfloat16* dq_row = dq + q_off + r * q_stride;
#pragma unroll
    for (int n = 0; n < kDimTiles; ++n) {
      const int c = 8 * n + 2 * tig;
      if (c < D)
        *reinterpret_cast<__nv_bfloat162*>(dq_row + c) =
            __floats2bfloat162_rn(acc[n][2 * half], acc[n][2 * half + 1]);
    }
  }
}

}  // namespace tc

namespace {

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

// The fp32 passes.
template <bool kPruned>
int launch_dq(int device, const void* q, const void* k, const void* v,
              const int* seg, const int* kv_idx, const int* kv_count,
              const void* dout, const float* lse, const float* delta, void* dq,
              int B, int S, int H, int KV, int D, int bq, int bkv, int causal,
              float scale, void* stream) {
  const size_t smem = smem_bytes(D, bkv);
  auto kernel = flash_bwd_dq_kernel<kPruned>;
  cudaError_t err = prepare(device, kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S / bq) * ((bq + kRows - 1) / kRows), H, B);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), seg, kv_idx, kv_count,
      static_cast<const float*>(dout), lse, delta, static_cast<float*>(dq), S, H, KV,
      D, bq, bkv, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <bool kPruned>
int launch_dkv(int device, const void* q, const void* k, const void* v,
               const int* seg, const int* q_idx, const int* q_count,
               const void* dout, const float* lse, const float* delta,
               void* dk, void* dv, int B, int S, int H, int KV, int D, int bq,
               int bkv, int causal, float scale, void* stream) {
  const size_t smem = smem_bytes(D, bq);
  auto kernel = flash_bwd_dkv_kernel<kPruned>;
  cudaError_t err = prepare(device, kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S / bkv) * ((bkv + kRows - 1) / kRows), KV, B);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), seg, q_idx, q_count,
      static_cast<const float*>(dout), lse, delta, static_cast<float*>(dk),
      static_cast<float*>(dv), S, H, KV, D, bq, bkv, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 dQ pass.
template <bool kPruned>
int launch_dq_tc(int device, const void* q, const void* k, const void* v, const int* seg,
                 const int* kv_idx, const int* kv_count, const void* dout, const float* lse,
                 const float* delta, void* dq, int B, int S, int H, int KV, int D, int bq,
                 int bkv, int causal, float scale, void* stream) {
  const void* ptrs[] = {q, k, v, dout, dq};
  if (!tc::rows_copyable(ptrs, D)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = tc::dq_layout(D).total;
  auto kernel = tc::flash_bwd_dq_tc_kernel<kPruned>;
  cudaError_t err = prepare(device, kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>(S / bq) * H * B;
  using bf16 = __nv_bfloat16;
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), seg,
      kv_idx, kv_count, static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dq), S, H,
      KV, D, bq, bkv, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 dK/dV pass.
template <bool kPruned>
int launch_dkv_tc(int device, const void* q, const void* k, const void* v, const int* seg,
                  const int* q_idx, const int* q_count, const void* dout, const float* lse,
                  const float* delta, void* dk, void* dv, int B, int S, int H, int KV, int D,
                  int bq, int bkv, int causal, float scale, void* stream) {
  const void* ptrs[] = {q, k, v, dout, dk, dv};
  if (!tc::rows_copyable(ptrs, D)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = tc::layout(D).total;
  auto kernel = tc::flash_bwd_dkv_tc_kernel<kPruned>;
  cudaError_t err = prepare(device, kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(S / bkv, KV, B);
  using bf16 = __nv_bfloat16;
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), seg,
      q_idx, q_count, static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), S, H, KV, D, bq, bkv, causal, scale);
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
    return launch_dq<kPruned>(device, q, k, v, seg, kv_idx, kv_count, dout, lse,
                              delta, dq, B, S, H, KV, D, bq, bkv, causal, scale,
                              stream);
  if (dtype == 1)  // bf16: the tensor-core kernel
    return launch_dq_tc<kPruned>(device, q, k, v, seg, kv_idx, kv_count, dout,
                                 lse, delta, dq, B, S, H, KV, D, bq, bkv, causal,
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
    return launch_dkv<kPruned>(device, q, k, v, seg, q_idx, q_count, dout, lse,
                               delta, dk, dv, B, S, H, KV, D, bq, bkv, causal,
                               scale, stream);
  if (dtype == 1)  // bf16: the tensor-core kernel
    return launch_dkv_tc<kPruned>(device, q, k, v, seg, q_idx, q_count, dout,
                                  lse, delta, dk, dv, B, S, H, KV, D, bq, bkv,
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
