// Segment-aware causal flash attention, forward only, for Hopper (sm_90a).
//
// Two kernels share one tile routine, so they apply the same fp32 arithmetic
// in the same ascending kv-block order and their outputs are bit-identical:
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
// with no visible key give out = 0 and lse = NEG_INF.
//
// What bounds it on the H100 at the serving shapes (B <= 8 packed rows,
// S in {64, 128, 256}, 16 q heads over 8 kv heads, d_head 128, bf16): one
// prefill call moves at most ~25 MB and does a few GFLOP, so by the card's
// peak rates it is memory-bound at under 8 us.  This kernel is bound by
// neither: it runs the two products on the CUDA cores in fp32 (no tensor
// cores, no TF32), one 256-thread block per (b, h, q-block) holds ~195 KB of
// shared memory, so one block (8 warps) runs per SM with little latency
// hidden, and a prefill of 1-8 rows launches only 16-256 blocks for 132 SMs
// (chip_smoke.py on an H100 SXM at 700 W: 0.27 ms at 8 x 256).  What the
// design does about it: every tile is staged once in shared memory as fp32
// (padded rows, so the per-thread strided reads hit distinct banks), each
// thread keeps an 8x8 register micro-tile of scores and of the output
// accumulator (16 reuses per shared-memory load), the row statistics are
// reduced with warp shuffles, and the pruned kernel never touches a dead
// tile.  Tensor-core products (wgmma), TMA loads and a pipelined k/v ring
// are the next steps; they change the summation order, so they must land in
// both kernels at once to keep the bit-exact pair.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
// shared fp32 tile with leading dimension ld.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int rows, int d, size_t row_stride,
                                          int ld) {
  for (int idx = threadIdx.x; idx < rows * d; idx += kThreads) {
    const int r = idx / d;
    const int c = idx - r * d;
    dst[r * ld + c] = to_float(src[r * row_stride + c]);
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
template <typename T>
__device__ __forceinline__ void tile_update(
    const Smem& sm, const T* __restrict__ v_rows, size_t row_stride, int q0,
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
template <typename T, bool kPruned>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ seg,
                     const int* __restrict__ kv_idx,
                     const int* __restrict__ kv_count, T* __restrict__ out,
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
    T* out_row = out + pos * q_stride + h * D;
#pragma unroll
    for (int dd = 0; dd < kDims; ++dd) {
      const int col = tj + kLanes * dd;
      if (col < D) out_row[col] = from_float<T>(__fdiv_rn(acc[ii][dd], denom));
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

template <typename T, bool kPruned>
int launch(int device, const void* q, const void* k, const void* v,
           const int* seg, const int* kv_idx, const int* kv_count, void* out,
           float* lse, int B, int S, int H, int KV, int D, int bq, int bkv,
           int causal, float scale, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = smem_bytes(D, bq, bkv);
  auto kernel = flash_fwd_kernel<T, kPruned>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(S / bq, H, B);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), seg, kv_idx, kv_count, static_cast<T*>(out),
      lse, S, H, KV, D, bq, bkv, causal, scale);
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
    return launch<float, kPruned>(device, q, k, v, seg, kv_idx, kv_count, out,
                                  lse, B, S, H, KV, D, bq, bkv, causal, scale,
                                  stream);
  if (dtype == 1)
    return launch<__nv_bfloat16, kPruned>(device, q, k, v, seg, kv_idx,
                                          kv_count, out, lse, B, S, H, KV, D,
                                          bq, bkv, causal, scale, stream);
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
