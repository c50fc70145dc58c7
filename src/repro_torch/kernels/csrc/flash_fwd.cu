// Segment-aware causal flash attention, forward only, for Hopper (sm_90a).
//
// Two kernels share one tile routine per route, so they apply the same
// arithmetic in the same ascending kv-block order and their outputs are
// bit-identical:
//
//   flash_fwd_dense   replaces repro/kernels/flash_attention.py ::
//                     segment_flash_attention (_flash_body, _block_live,
//                     _tile_mask).  It walks every kv block of its q block
//                     and skips one that is causally dead or whose
//                     segment-id range is disjoint from the q block's.
//   flash_fwd_pruned  replaces ::segment_flash_attention_pruned
//                     (_flash_prefetch_body).  It walks only the live kv
//                     blocks listed in the liveness tables (kv_idx, kv_count)
//                     and loads exactly kv_count[b, qb] k/v tiles.
//
// Masking contract: key j is visible to query i iff (causal => j <= i, by
// absolute row position) and segment_ids match with the key's id > 0.  Rows
// with no visible key give out = 0 and lse = NEG_INF; P is built from the
// mask, never from exp(S - NEG_INF).
//
// What bounds it on the H100: at the training shape (two packed rows of 6144,
// 16 q heads over 8 kv heads, d_head 128, bf16) the live tiles' work is
// 4 bq.bkv.D FLOPs per (row, q-head, tile), ~135 GFLOP a call, so by the
// card's peak rates it is bound by operations (~0.14 ms); at the serving
// shapes (B <= 8 packed rows, S <= 256) one call moves a few MB and is bound
// by bytes at under 8 us.
//
// Two routes, chosen by the dtype (no switch):
//
// fp32 (flash_fwd_kernel) is the exact rail (2e-5): the products are
// fp32 fma chains on the CUDA cores (no TF32).  One 256-thread block per
// (b, h, q-block) stages each tile once in shared memory as fp32 (~195 KB at
// d_head 128, padded rows so the strided reads hit distinct banks), each
// thread keeps an 8x8 register micro-tile of scores and of the output
// accumulator, and the row statistics are reduced with warp shuffles.  It
// reaches ~1 % of the tensor-core rate.
//
// bf16 (namespace tc, flash_fwd_tc_kernel) runs on the tensor cores:
//
// * Ownership.  One 256-thread block per (whole pinned q block of up to 128
//   rows, q head, batch row); warp w owns q rows 16w .. 16w+15 (warps past a
//   ragged block idle).  The grid is one-dimensional with the last q blocks
//   first: under the causal mask they hold the most live tiles, so the
//   longest blocks start in the first wave.
// * Loads.  The q tile is copied once by cp.async and kept in registers as
//   ldmatrix A fragments.  The k and v rows of each live kv tile, with the
//   tile's segment ids, go through a two-stage cp.async ring (16-byte copies;
//   so D % 8 == 0 and 16-byte aligned q, k, v and out, which the wrapper
//   checks): the next live tile's copies are issued before this tile's math.
//   Rows hold D rounded up to 16 plus 8 bf16 (conflict-free ldmatrix), and
//   shared memory is zeroed once, so ragged tails are 0 x 0.  175,104 bytes
//   at d_head 128: one block per SM.
// * Products.  mma.sync.m16n8k16 bf16 -> fp32.  S = Q.K^T with the k rows as
//   the column-major B operand (ldmatrix); the mask, the scale and the online
//   softmax run in the accumulator registers (the four lanes of a row reduce
//   with two shuffles); then P, rounded to bf16, is the A operand of
//   O += P.V (two adjacent n8 accumulator tiles are one k16 A fragment,
//   FlashAttention-2's reuse) with V by ldmatrix.trans.  P never touches
//   shared memory; O stays in fp32 registers and is written once.
// * Registers.  O (64 fp32 a thread at d_head 128), the q fragments (32) and
//   a 128-column score tile (64) would pass the 255 a thread may have, so
//   each pinned kv tile is walked as two 64-column halves, one online-softmax
//   update per half.
// * Numerics.  The scale multiplies the fp32 product in fp32, and l is summed
//   from the fp32 P before P is rounded, so lse keeps the fp32 rail (2e-5);
//   only the output carries P's bf16 rounding (2e-2).
// * Masks.  A warp's 16 x 64 piece that lies inside the blocks, wholly at or
//   below the diagonal and inside one positive segment skips the per-element
//   test; a piece wholly above the diagonal is skipped.
// * Liveness.  K4 walks kv_idx[b, qb, :kv_count]; K1 tests each kv block with
//   the _block_live rule, the segment ranges reduced by each warp with
//   __reduce_min/max_sync, so no thread waits on one.
//
// K4 == K1 holds bit for bit on both routes: the same live tiles in the same
// order through one step routine, and mma.sync's sums are deterministic for
// the same operands.  wgmma with TMA is the next step for the bf16 route.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 16;  // threads that share one set of rows
constexpr int kMaxBlock = 128;
constexpr int kMaxHeadDim = 128;
constexpr int kRows = kMaxBlock / kLanes;    // q rows per thread
constexpr int kCols = kMaxBlock / kLanes;    // kv columns per thread
constexpr int kDims = kMaxHeadDim / kLanes;  // head-dim columns per thread
// The reference's sentinel, -0.7 * f32max computed in double and rounded
// once to float, exactly as the Python side builds it.
constexpr float kNegInf = static_cast<float>(-0.7 * 3.4028234663852886e38);
using tc::kSegBig;

// Max / sum across the 16 lanes that own the same rows.  The xor butterfly
// gives every lane the bit-identical result (IEEE + and max commute).
__device__ __forceinline__ float lanes_max(float x) {
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float lanes_sum(float x) {
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1)
    x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// Copy `rows` rows of `d` elements (row r at src + r * row_stride) into a
// shared tile with leading dimension ld.
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src,
                                          int rows, int d, size_t row_stride,
                                          int ld) {
  for (int idx = threadIdx.x; idx < rows * d; idx += kThreads) {
    const int r = idx / d;
    const int c = idx - r * d;
    dst[r * ld + c] = src[r * row_stride + c];
  }
}

struct Smem {
  float* q;    // [bq][D + 1]
  float* kv;   // [bkv][D + 1]: K for the scores, then V for the product
  float* p;    // [bq][bkv + 1]
  int* qseg;   // [bq]
  int* kseg;   // [bkv]
};

// Online-softmax update of one (q-block, kv-block) tile; the K tile is in
// sm.kv on entry.  Every thread owns rows ti + 16*ii of the q block, kv
// columns tj + 16*jj of the scores and head-dim columns tj + 16*dd of the
// accumulator.
__device__ __forceinline__ void tile_update(
    const Smem& sm, const float* __restrict__ v_rows, size_t row_stride, int q0,
    int k0, int bq, int bkv, int D, bool causal, bool has_seg, float scale,
    float (&m)[kRows], float (&l)[kRows], float (&acc)[kRows][kDims]) {
  const int ti = threadIdx.x / kLanes;
  const int tj = threadIdx.x % kLanes;
  const int ld = D + 1;
  const int ldp = bkv + 1;

  float s[kRows][kCols];
#pragma unroll
  for (int ii = 0; ii < kRows; ++ii)
#pragma unroll
    for (int jj = 0; jj < kCols; ++jj) s[ii][jj] = 0.f;

  for (int d = 0; d < D; ++d) {
    float a[kRows], b[kCols];
#pragma unroll
    for (int ii = 0; ii < kRows; ++ii)
      a[ii] = sm.q[min(ti + kLanes * ii, bq - 1) * ld + d];
#pragma unroll
    for (int jj = 0; jj < kCols; ++jj)
      b[jj] = sm.kv[min(tj + kLanes * jj, bkv - 1) * ld + d];
#pragma unroll
    for (int ii = 0; ii < kRows; ++ii)
#pragma unroll
      for (int jj = 0; jj < kCols; ++jj)
        s[ii][jj] = __fmaf_rn(a[ii], b[jj], s[ii][jj]);
  }

  uint64_t allowed = 0;
#pragma unroll
  for (int ii = 0; ii < kRows; ++ii) {
    const int row = ti + kLanes * ii;
#pragma unroll
    for (int jj = 0; jj < kCols; ++jj) {
      const int col = tj + kLanes * jj;
      bool ok = row < bq && col < bkv;
      if (ok && causal) ok = k0 + col <= q0 + row;
      if (ok && has_seg) {
        const int ks = sm.kseg[col];
        ok = ks > 0 && sm.qseg[row] == ks;
      }
      s[ii][jj] = ok ? __fmul_rn(s[ii][jj], scale) : kNegInf;
      if (ok) allowed |= 1ull << (ii * kCols + jj);
    }
  }

  float alpha[kRows];
#pragma unroll
  for (int ii = 0; ii < kRows; ++ii) {
    const int row = ti + kLanes * ii;
    float mx = kNegInf;
#pragma unroll
    for (int jj = 0; jj < kCols; ++jj) mx = fmaxf(mx, s[ii][jj]);
    const float m_new = fmaxf(m[ii], lanes_max(mx));
    const float safe_m = m_new <= kNegInf ? 0.f : m_new;
    float row_sum = 0.f;
#pragma unroll
    for (int jj = 0; jj < kCols; ++jj) {
      const int col = tj + kLanes * jj;
      const float p = (allowed >> (ii * kCols + jj)) & 1ull
                          ? expf(__fsub_rn(s[ii][jj], safe_m))
                          : 0.f;
      row_sum = __fadd_rn(row_sum, p);
      if (row < bq && col < bkv) sm.p[row * ldp + col] = p;
    }
    alpha[ii] = m[ii] <= kNegInf ? 0.f : expf(__fsub_rn(m[ii], safe_m));
    l[ii] = __fadd_rn(__fmul_rn(alpha[ii], l[ii]), lanes_sum(row_sum));
    m[ii] = m_new;
#pragma unroll
    for (int dd = 0; dd < kDims; ++dd)
      acc[ii][dd] = __fmul_rn(acc[ii][dd], alpha[ii]);
  }

  __syncthreads();  // every thread is done with K; P is complete
  load_tile(sm.kv, v_rows, bkv, D, row_stride, ld);
  __syncthreads();

  for (int j = 0; j < bkv; ++j) {
    float pj[kRows], vj[kDims];
#pragma unroll
    for (int ii = 0; ii < kRows; ++ii)
      pj[ii] = sm.p[min(ti + kLanes * ii, bq - 1) * ldp + j];
#pragma unroll
    for (int dd = 0; dd < kDims; ++dd)
      vj[dd] = sm.kv[j * ld + min(tj + kLanes * dd, D - 1)];
#pragma unroll
    for (int ii = 0; ii < kRows; ++ii)
#pragma unroll
      for (int dd = 0; dd < kDims; ++dd)
        acc[ii][dd] = __fmaf_rn(pj[ii], vj[dd], acc[ii][dd]);
  }
  __syncthreads();  // V and P may be overwritten by the next tile
}

// One block per (q-block, head, batch row).  kPruned selects the loop: every
// kv block with the in-kernel liveness test, or the table's live blocks.
template <bool kPruned>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const int* __restrict__ seg,
                     const int* __restrict__ kv_idx,
                     const int* __restrict__ kv_count, float* __restrict__ out,
                     float* __restrict__ lse, int S, int H, int KV, int D,
                     int bq, int bkv, int causal, float scale) {
  extern __shared__ float smem[];
  __shared__ int live;
  const int ld = D + 1;
  Smem sm;
  sm.q = smem;
  sm.kv = sm.q + bq * ld;
  sm.p = sm.kv + bkv * ld;
  sm.qseg = reinterpret_cast<int*>(sm.p + bq * (bkv + 1));
  sm.kseg = sm.qseg + bq;

  const int qb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nq = gridDim.x, nk = S / bkv;
  const int kvh = h / (H / KV);
  const int q0 = qb * bq;
  const bool has_seg = seg != nullptr;
  const int tid = threadIdx.x;
  const size_t q_stride = static_cast<size_t>(H) * D;
  const size_t kv_stride = static_cast<size_t>(KV) * D;

  load_tile(sm.q, q + (static_cast<size_t>(b) * S + q0) * q_stride + h * D, bq,
            D, q_stride, ld);
  if (has_seg)
    for (int i = tid; i < bq; i += kThreads)
      sm.qseg[i] = seg[static_cast<size_t>(b) * S + q0 + i];
  __syncthreads();

  // The q block's segment range, read by thread 0 only (dense liveness).
  int q_lo = kSegBig, q_hi = 0;
  if (!kPruned && has_seg && tid == 0)
    for (int i = 0; i < bq; ++i) {
      const int id = sm.qseg[i];
      q_hi = max(q_hi, id);
      if (id > 0) q_lo = min(q_lo, id);
    }

  float m[kRows], l[kRows], acc[kRows][kDims];
#pragma unroll
  for (int ii = 0; ii < kRows; ++ii) {
    m[ii] = kNegInf;
    l[ii] = 0.f;
#pragma unroll
    for (int dd = 0; dd < kDims; ++dd) acc[ii][dd] = 0.f;
  }

  const int row_tables = b * nq + qb;
  const int n_steps = kPruned ? kv_count[row_tables] : nk;
  for (int t = 0; t < n_steps; ++t) {
    const int kb = kPruned ? kv_idx[static_cast<size_t>(row_tables) * nk + t] : t;
    const int k0 = kb * bkv;
    if (has_seg)
      for (int j = tid; j < bkv; j += kThreads)
        sm.kseg[j] = seg[static_cast<size_t>(b) * S + k0 + j];
    if (!kPruned) {
      __syncthreads();
      if (tid == 0) {
        bool ok = !causal || q0 + bq - 1 >= k0;
        if (has_seg) {
          int k_lo = kSegBig, k_hi = 0;
          for (int j = 0; j < bkv; ++j) {
            const int id = sm.kseg[j];
            k_hi = max(k_hi, id);
            if (id > 0) k_lo = min(k_lo, id);
          }
          ok = ok && q_hi > 0 && k_hi > 0 && q_hi >= k_lo && k_hi >= q_lo;
        }
        live = ok;
      }
      __syncthreads();
      if (!live) continue;
    }
    const size_t kv_off =
        (static_cast<size_t>(b) * S + k0) * kv_stride + kvh * D;
    load_tile(sm.kv, k + kv_off, bkv, D, kv_stride, ld);
    __syncthreads();
    tile_update(sm, v + kv_off, kv_stride, q0, k0, bq, bkv, D, causal != 0,
                has_seg, scale, m, l, acc);
  }

  const int ti = tid / kLanes, tj = tid % kLanes;
#pragma unroll
  for (int ii = 0; ii < kRows; ++ii) {
    const int row = ti + kLanes * ii;
    if (row >= bq) continue;
    const float denom = l[ii] == 0.f ? 1.f : l[ii];
    const size_t pos = static_cast<size_t>(b) * S + q0 + row;
    float* out_row = out + pos * q_stride + h * D;
#pragma unroll
    for (int dd = 0; dd < kDims; ++dd) {
      const int col = tj + kLanes * dd;
      if (col < D) out_row[col] = __fdiv_rn(acc[ii][dd], denom);
    }
    if (lse != nullptr && tj == 0)
      lse[pos * H + h] = l[ii] > 0.f ? __fadd_rn(m[ii], logf(denom)) : kNegInf;
  }
}

size_t smem_bytes(int D, int bq, int bkv) {
  return sizeof(float) * (static_cast<size_t>(bq) * (D + 1) +
                          static_cast<size_t>(bkv) * (D + 1) +
                          static_cast<size_t>(bq) * (bkv + 1)) +
         sizeof(int) * static_cast<size_t>(bq + bkv);
}

// The fp32 route.
template <bool kPruned>
int launch(int device, const void* q, const void* k, const void* v,
           const int* seg, const int* kv_idx, const int* kv_count, void* out,
           float* lse, int B, int S, int H, int KV, int D, int bq, int bkv,
           int causal, float scale, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = smem_bytes(D, bq, bkv);
  auto kernel = flash_fwd_kernel<kPruned>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(S / bq, H, B);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), seg, kv_idx, kv_count, static_cast<float*>(out),
      lse, S, H, KV, D, bq, bkv, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ---------------------------------------------------------------------------
// The bf16 forward on the tensor cores (K1 and K4 when the inputs are bf16;
// see the note at the head of the file).  The helpers are in tc_common.cuh.
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kHalf = 64;                   // kv columns of one online-softmax update
constexpr int kHalfTiles = kHalf / 8;       // n8 score tiles of a half
constexpr int kOutTiles = kMaxHeadDim / 8;  // n8 tiles of the output rows
constexpr int kQFrags = kMaxHeadDim / 16;   // k16 A fragments of the q rows

// Shared memory: the q tile, then the kv ring (tc_common.cuh).
__host__ __device__ __forceinline__ KvRingLayout fwd_layout(int D) { return kv_ring_layout(D, 1); }

// One live kv tile for this warp's q rows r0 .. r0+15: the online-softmax
// update of (m, l, o), 64 kv columns at a time.  Element e of n8 accumulator
// tile j is q row r0 + g (+8 for e >= 2) and column 8j + 2 tig (+1 for odd
// e); m is in the units of scale.q.k.
__device__ __forceinline__ void fwd_step(const uint32_t (&qf)[kQFrags][4],
                                         const __nv_bfloat16* ks, const __nv_bfloat16* vs,
                                         const int* kseg, int pitch_, int dpad, int bq, int bkv,
                                         int q_pos0, int k_pos0, bool causal, bool has_seg,
                                         const int (&qseg)[2], float scale, float (&m)[2],
                                         float (&l)[2], float (&o)[kOutTiles][4]) {
  const int lane = threadIdx.x % 32;
  const int r0 = (threadIdx.x / 32) * 16;
  const int g = lane / 4, tig = lane % 4;
  // ldmatrix.x4 row addresses.  K as the plain B operand: the matrices are
  // (rows 0-7, cols 0-7), (0-7, 8-15), (8-15, 0-7), (8-15, 8-15), i.e. the k
  // halves of two n8 tiles.  V as the trans B operand: (0-7, 0-7),
  // (8-15, 0-7), (0-7, 8-15), (8-15, 8-15).
  const int b_row = (lane & 7) + (lane >> 4) * 8, b_col = ((lane >> 3) & 1) * 8;
  const int t_row = (lane & 7) + ((lane >> 3) & 1) * 8, t_col = (lane >> 4) * 8;
  const uint32_t k_addr = smem_addr(ks + b_row * pitch_ + b_col);
  const uint32_t v_addr = smem_addr(vs + t_row * pitch_ + t_col);
  const uint32_t row_bytes = 2u * pitch_;

  for (int c0 = 0; c0 < bkv; c0 += kHalf) {
    // Every key from here on lies after every query of the warp.
    if (causal && k_pos0 + c0 > q_pos0 + r0 + 15) break;

    float s[kHalfTiles][4];
#pragma unroll
    for (int j = 0; j < kHalfTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kQFrags; ++kk) {
      if (16 * kk < dpad) {
#pragma unroll
        for (int jp = 0; jp < kHalfTiles / 2; ++jp) {
          if (c0 + 16 * jp < bkv) {
            uint32_t b[4];
            ldsm_x4(b, k_addr + (c0 + 16 * jp) * row_bytes + 32 * kk);
            mma_bf16(s[2 * jp], qf[kk], b[0], b[1]);
            mma_bf16(s[2 * jp + 1], qf[kk], b[2], b[3]);
          }
        }
      }
    }

    // A piece the mask cannot touch (all its rows and columns inside the
    // blocks, every key at or before every query, one positive segment
    // throughout) skips the per-element test; the arithmetic is the same.
    bool open = r0 + 16 <= bq && c0 + kHalf <= bkv &&
                (!causal || k_pos0 + c0 + kHalf - 1 <= q_pos0 + r0);
    if (open && has_seg) {
      const int id = __shfl_sync(0xffffffffu, qseg[0], 0);
      bool same = qseg[0] == id && qseg[1] == id && id > 0;
#pragma unroll
      for (int j = 0; j < kHalfTiles; ++j) {
        const int2 ids = *reinterpret_cast<const int2*>(kseg + c0 + 8 * j + 2 * tig);
        same = same && ids.x == id && ids.y == id;
      }
      open = __all_sync(0xffffffffu, same);
    }
    uint32_t visible = ~0u;  // bit 4j + e: entry (j, e) is visible
    if (!open) {
      visible = 0u;
#pragma unroll
      for (int j = 0; j < kHalfTiles; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = r0 + g + (e >> 1) * 8;
          const int c = c0 + 8 * j + 2 * tig + (e & 1);
          bool ok = r < bq && c < bkv;
          if (causal) ok = ok && k_pos0 + c <= q_pos0 + r;
          if (has_seg) ok = ok && kseg[c] > 0 && kseg[c] == qseg[e >> 1];
          visible |= static_cast<uint32_t>(ok) << (4 * j + e);
        }
    }

    // The online softmax of the half: P from the mask, l from the fp32 P.
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < kHalfTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = (visible >> (4 * j + e)) & 1u;
        s[j][e] = ok ? __fmul_rn(s[j][e], scale) : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float alpha[2], shift[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      const float safe_m = m_new <= kNegInf ? 0.f : m_new;
      alpha[i] = m[i] <= kNegInf ? 0.f : exp2f(__fmul_rn(__fsub_rn(m[i], safe_m), kLog2e));
      shift[i] = -__fmul_rn(safe_m, kLog2e);
      m[i] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kHalfTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = (visible >> (4 * j + e)) & 1u;
        const float p = ok ? exp2f(__fmaf_rn(s[j][e], kLog2e, shift[e >> 1])) : 0.f;
        s[j][e] = p;
        rs[e >> 1] = __fadd_rn(rs[e >> 1], p);
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rs[i] = __fadd_rn(rs[i], __shfl_xor_sync(0xffffffffu, rs[i], 1));
      rs[i] = __fadd_rn(rs[i], __shfl_xor_sync(0xffffffffu, rs[i], 2));
      l[i] = __fadd_rn(__fmul_rn(alpha[i], l[i]), rs[i]);
    }
    if (alpha[0] != 1.f || alpha[1] != 1.f) {
#pragma unroll
      for (int n = 0; n < kOutTiles; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] = __fmul_rn(o[n][e], alpha[e >> 1]);
    }

    // O += P.V, P rounded to bf16.
#pragma unroll
    for (int kk = 0; kk < kHalfTiles / 2; ++kk) {
      if (c0 + 16 * kk < bkv) {
        const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                               pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                               pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                               pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
        const uint32_t off = (c0 + 16 * kk) * row_bytes;
#pragma unroll
        for (int n = 0; n < kOutTiles / 2; ++n) {
          if (16 * n < dpad) {
            uint32_t b[4];
            ldsm_x4_trans(b, v_addr + off + 32 * n);
            mma_bf16(o[2 * n], a, b[0], b[1]);
            mma_bf16(o[2 * n + 1], a, b[2], b[3]);
          }
        }
      }
    }
  }
}

// The bf16 forward: one block per (whole pinned q block, q head, batch row),
// the last q blocks first; warp w owns q rows 16w .. 16w+15 of the block.
template <bool kPruned>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v, const int* __restrict__ seg,
                        const int* __restrict__ kv_idx, const int* __restrict__ kv_count,
                        __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int S, int H,
                        int KV, int D, int bq, int bkv, int causal, float scale) {
  extern __shared__ __align__(128) unsigned char tc_smem[];
  const KvRingLayout L = fwd_layout(D);
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
  }
  cp_async_commit();

  // This thread's two q rows' segment ids, and (dense liveness) the whole
  // pinned q block's segment range, reduced by each warp.
  int qseg[2] = {0, 0};
  if (has_seg)
    for (int i = 0; i < 2; ++i)
      if (r0 + g + 8 * i < bq) qseg[i] = seg[row0 + q0 + r0 + g + 8 * i];
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

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[kOutTiles][4];
#pragma unroll
  for (int n = 0; n < kOutTiles; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  int t = next_live(0);
  if (t < n_steps) issue(t, 0);
  cp_async_commit();
  cp_async_wait_prev();  // the q tile has landed
  __syncthreads();
  uint32_t qf[kQFrags][4];
  {
    const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_col = (lane >> 4) * 8;
    const uint32_t q_addr = smem_addr(qs + (r0 + a_row) * pitch_ + a_col);
#pragma unroll
    for (int kk = 0; kk < kQFrags; ++kk) {
      if (16 * kk < dpad) {
        ldsm_x4(qf[kk], q_addr + 32 * kk);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) qf[kk][e] = 0u;
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
      fwd_step(qf, reinterpret_cast<const __nv_bfloat16*>(base),
               reinterpret_cast<const __nv_bfloat16*>(base + L.v),
               reinterpret_cast<const int*>(base + L.seg), pitch_, dpad, bq, bkv, q0,
               kv_block(t) * bkv, causal != 0, has_seg, qseg, scale, m, l, o);
    }
    __syncthreads();  // stage s is refilled by the next iteration's copies
    t = t_next;
  }
  cp_async_wait_all();

  // out and lse leave once, for the block's rows only.
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + g + 8 * half;
    if (r >= bq) continue;
    const float denom = l[half] == 0.f ? 1.f : l[half];
    const size_t pos = row0 + q0 + r;
    __nv_bfloat16* out_row = out + pos * q_stride + static_cast<size_t>(h) * D;
#pragma unroll
    for (int n = 0; n < kOutTiles; ++n) {
      const int c = 8 * n + 2 * tig;
      if (c < D)
        *reinterpret_cast<__nv_bfloat162*>(out_row + c) = __floats2bfloat162_rn(
            __fdiv_rn(o[n][2 * half], denom), __fdiv_rn(o[n][2 * half + 1], denom));
    }
    if (lse != nullptr && tig == 0)
      lse[pos * H + h] = l[half] > 0.f ? __fadd_rn(m[half], logf(denom)) : kNegInf;
  }
}

}  // namespace tc

namespace {

// The bf16 route.
template <bool kPruned>
int launch_tc(int device, const void* q, const void* k, const void* v, const int* seg,
              const int* kv_idx, const int* kv_count, void* out, float* lse, int B, int S, int H,
              int KV, int D, int bq, int bkv, int causal, float scale, void* stream) {
  const void* ptrs[] = {q, k, v, out};
  if (!tc::rows_copyable(ptrs, D)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = tc::fwd_layout(D).total;
  auto kernel = tc::flash_fwd_tc_kernel<kPruned>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>(S / bq) * H * B;
  using bf16 = __nv_bfloat16;
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), seg,
      kv_idx, kv_count, static_cast<bf16*>(out), lse, S, H, KV, D, bq, bkv, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <bool kPruned>
int dispatch(int dtype, int device, const void* q, const void* k,
             const void* v, const int* seg, const int* kv_idx,
             const int* kv_count, void* out, float* lse, int B, int S, int H,
             int KV, int D, int bq, int bkv, int causal, float scale,
             void* stream) {
  if (bq < 1 || bkv < 1 || bq > kMaxBlock || bkv > kMaxBlock || D < 1 ||
      D > kMaxHeadDim || S % bq != 0 || S % bkv != 0 || H % KV != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch<kPruned>(device, q, k, v, seg, kv_idx, kv_count, out, lse,
                           B, S, H, KV, D, bq, bkv, causal, scale, stream);
  if (dtype == 1)  // bf16: the tensor-core kernel
    return launch_tc<kPruned>(device, q, k, v, seg, kv_idx, kv_count, out, lse,
                              B, S, H, KV, D, bq, bkv, causal, scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  seg may be null (no segment mask); lse
// may be null.  Returns cudaGetLastError() after the launch (0 = success).
extern "C" int flash_fwd_dense(int dtype, int device, const void* q,
                               const void* k, const void* v, const int* seg,
                               void* out, float* lse, int B, int S, int H,
                               int KV, int D, int bq, int bkv, int causal,
                               float scale, void* stream) {
  return dispatch<false>(dtype, device, q, k, v, seg, nullptr, nullptr, out,
                         lse, B, S, H, KV, D, bq, bkv, causal, scale, stream);
}

// As flash_fwd_dense over the liveness tables kv_idx (B, S/bq, S/bkv) and
// kv_count (B, S/bq); seg is required.
extern "C" int flash_fwd_pruned(int dtype, int device, const void* q,
                                const void* k, const void* v, const int* seg,
                                const int* kv_idx, const int* kv_count,
                                void* out, float* lse, int B, int S, int H,
                                int KV, int D, int bq, int bkv, int causal,
                                float scale, void* stream) {
  if (seg == nullptr || kv_idx == nullptr || kv_count == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<true>(dtype, device, q, k, v, seg, kv_idx, kv_count, out,
                        lse, B, S, H, KV, D, bq, bkv, causal, scale, stream);
}

extern "C" const char* flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
