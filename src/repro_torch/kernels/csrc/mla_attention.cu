// Multi-head latent attention (MLA) over packed segments, for Hopper (sm_90a):
// the cache-free training attention of DeepSeek-V2 and -V3 in the direct
// form, forward and backward, on the tensor cores.
//
// It replaces no TPU kernel: the JAX package computes MLA with XLA einsums
// (repro/models/attention.py :: mla_attention), and the port's plain path
// (models/attention._mla_block_sdpa) ran it as fp32 blockwise einsums over
// every (query block, whole row) pair, three times a step.  These kernels
// compute the same function over the live tiles only.
//
// Shapes (fixed at compile time, MLA's own): per head, q and k have 192
// columns (nope 128, then rope 64), v and the output 128.  The rope key is
// one (B, S, 64) tensor shared by every head; each kv tile's rows are
// assembled in shared memory from k_nope[b, s, h, :] and k_rope[b, s, :], so
// nothing is expanded to (B, S, H, 64) in device memory.
//
//   mla_fwd_kernel      out (B, S, H, 128) bf16 and lse (B, S, H) fp32;
//   mla_bwd_dq_kernel   dq (B, S, H, 192) bf16, q-stationary;
//   mla_bwd_dkv_kernel  dk_nope and dv (B, S, H, 128) bf16 and each head's
//                       rope part of dk in fp32 (B, S, H, 64), kv-stationary.
//                       The wrapper sums the partials over the heads in fp32
//                       (one reduction, no atomics), since k_rope is shared.
//
// All three walk only the live tiles of the liveness tables
// (kernels/liveness.build_liveness_tables): the row tables kv_idx/kv_count
// for the forward and dQ, the column tables q_idx/q_count for dK/dV, at one
// block pair (bq, bkv) of at most 128 rows.  Masking contract (K1-K6's): key
// j is visible to query i iff (causal => j <= i, by absolute row) and the
// segment ids match with the key's id > 0.  A row with no visible key gives
// out = 0 and lse = NEG_INF, and exactly zero gradients; P is built from the
// mask, never from exp(S - NEG_INF).
//
// Numerics (K4-K6's bf16 route): mma.sync.m16n8k16, bf16 in and fp32 sums;
// the scale multiplies the fp32 score; l is summed from the fp32 P before P
// is rounded to bf16 for P.V and P^T.dO; scale.dS enters dQ as one bf16 term
// and dK as two (hi = rn(x), lo = rn(x - hi)).  Every rounding is an
// explicit intrinsic and no sum uses atomics, so a run repeats bit for bit.
//
// Layout and the split of the work (one 256-thread block, 8 warps, each warp
// owning 16 rows of its block's stationary tile; rows in shared memory hold
// the row's columns plus 8 bf16 of padding, a pitch of 4 banks modulo 32, so
// ldmatrix reads without conflicts; shared memory is zeroed once, so ragged
// tails are 0 x 0):
//
// * Forward, a block per (q block, head, batch row), the last q blocks
//   first.  The q rows are kept as 12 k16 A fragments (48 registers), O as
//   16 n8 tiles (64), and each 128-column kv tile is walked as two halves of
//   64 columns (32 score registers), one online-softmax update each.  Shared
//   memory: the q tile (51,200 bytes) and a two-stage cp.async ring of kv
//   tiles (k rows at pitch 200, v rows at pitch 136, segment ids; 86,528
//   bytes a stage): 224,256 bytes, one block per SM.
// * dQ, a block per (q block, head, batch row), the last q blocks first.  dQ
//   takes 24 n8 tiles (96 registers) and dO's 8 A fragments stay in
//   registers (32); the q rows stay in shared memory and are read by
//   ldmatrix for each 32-column chunk of a kv tile (S and dP: 32 registers).
//   The dO tile is landed in the second ring stage, read into registers, and
//   that stage is zeroed again before the ring starts: 224,256 bytes.
// * dK/dV, the crux: a block per (kv tile, head, batch row), the first kv
//   tiles first.  dK (192 columns: 24 n8 tiles, 96 registers) and dV (16
//   tiles, 64) stay in registers over the whole walk, with a 32-column chunk
//   of S^T and dP^T (32); the K and V rows stay in shared memory (86,016
//   bytes).  The q block's 192-column rows and dO rows would not fit a
//   two-stage ring beside them, so the ring carries each live q block as two
//   steps of 64 rows (q, dO, lse, delta, segment ids: 43,776 bytes a stage):
//   173,568 bytes.  A chunk whose queries all precede the warp's keys is
//   skipped.  The rope columns of dK (tiles 16-23) leave in fp32, per head.
//   ptxas: 255 registers and a 32-byte spill here, 255 in dQ and 227 in the
//   forward with none.
//
// What bounds it on the H100, at the DeepSeek-V2-Lite cell's shape (8 packed
// rows of 3,072 slots of UltraChat samples, 16 heads, ~10.5 M visible pairs):
// per visible pair and head the forward does 2 (192 + 128) FLOPs, dQ
// 2 (2.192 + 128) and dK/dV 4 (192 + 128): 107, 174 and 215 GFLOP a layer,
// against 0.46, 0.61 and 0.66 GB moved once.  By the card's peaks the
// forward and dQ are bound by bytes (0.137 and 0.182 ms) and dK/dV by
// operations (0.217 ms); the kernels take 1.08, 1.23 and 1.59 ms.  The design
// is K4-K6's and shares their limits: shared-memory traffic (each warp reads
// the whole moving tile by ldmatrix) and latency (one 8-warp block per SM,
// synchronous ldmatrix -> mma chains).  wgmma with TMA is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using tc::cp_async16;
using tc::cp_async4;
using tc::cp_async_commit;
using tc::cp_async_wait_all;
using tc::cp_async_wait_prev;
using tc::kLog2e;
using tc::ldsm_x4;
using tc::ldsm_x4_trans;
using tc::mma_bf16;
using tc::pack_bf16;
using tc::smem_addr;
using tc::split_bf16;

constexpr int kThreads = 256;
constexpr int kMaxBlock = 128;        // rows of a tile: 8 warps x 16
constexpr int kNope = 128, kRope = 64, kQk = kNope + kRope, kV = 128;
constexpr int kPitchQk = kQk + 8;     // bf16 a shared row of q or k
constexpr int kPitchV = kV + 8;       // bf16 a shared row of v or dO
constexpr int kQkFrags = kQk / 16;    // k16 A fragments of a q row block
constexpr int kVFrags = kV / 16;      // k16 A fragments of a dO row block
constexpr int kQkTiles = kQk / 8;     // n8 accumulator tiles of dQ, dK
constexpr int kVTiles = kV / 8;       // n8 accumulator tiles of O, dV
constexpr int kQkPieces = kQk / 8, kNopePieces = kNope / 8, kVPieces = kV / 8;  // 16-byte pieces a row
// The reference's sentinel, -0.7 * f32max computed in double and rounded
// once to float, exactly as the Python side builds it.
constexpr float kNegInf = static_cast<float>(-0.7 * 3.4028234663852886e38);

// Shared memory, in bytes.  A tile of 128 rows of q or k, and of v or dO.
constexpr unsigned kTileQk = kMaxBlock * kPitchQk * 2;  // 51,200
constexpr unsigned kTileV = kMaxBlock * kPitchV * 2;    // 34,816
// The forward's and dQ's kv ring stage: k rows, v rows, segment ids.
constexpr unsigned kStageKv = kTileQk + kTileV + kMaxBlock * 4;  // 86,528
constexpr unsigned kQStationarySmem = kTileQk + 2 * kStageKv;    // 224,256
// The dK/dV pass's ring stage: 64 q rows, their dO rows, lse, delta, ids.
constexpr int kStepRows = 64;
constexpr unsigned kStO = kStepRows * kPitchQk * 2;       // 25,600
constexpr unsigned kStLse = kStO + kStepRows * kPitchV * 2;  // 43,008
constexpr unsigned kStDelta = kStLse + kStepRows * 4;
constexpr unsigned kStSeg = kStDelta + kStepRows * 4;
constexpr unsigned kStageQ = kStSeg + kStepRows * 4;       // 43,776
constexpr unsigned kDkvSmem = kTileQk + kTileV + 2 * kStageQ;  // 173,568

__device__ __forceinline__ void zero_smem(unsigned char* smem, unsigned bytes) {
  for (unsigned i = threadIdx.x; i < bytes / 16; i += kThreads)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0u, 0u, 0u, 0u);
}

// cp.async `rows` rows of 192 columns of q (or of dq-shaped data) for head h
// from token tok0 on (rows H * 192 apart) into a shared tile at pitch 200.
__device__ __forceinline__ void copy_q_rows(bf16* dst, const bf16* __restrict__ q, size_t tok0,
                                            int h, int H, int rows) {
  for (int idx = threadIdx.x; idx < rows * kQkPieces; idx += kThreads) {
    const int r = idx / kQkPieces, c = (idx - r * kQkPieces) * 8;
    cp_async16(dst + r * kPitchQk + c, q + ((tok0 + r) * H + h) * kQk + c);
  }
}

// cp.async `rows` rows of 128 columns (v or dO) for head h into a shared
// tile at pitch 136.
__device__ __forceinline__ void copy_v_rows(bf16* dst, const bf16* __restrict__ src, size_t tok0,
                                            int h, int H, int rows) {
  for (int idx = threadIdx.x; idx < rows * kVPieces; idx += kThreads) {
    const int r = idx / kVPieces, c = (idx - r * kVPieces) * 8;
    cp_async16(dst + r * kPitchV + c, src + ((tok0 + r) * H + h) * kV + c);
  }
}

// cp.async `rows` k rows of head h, each assembled from k_nope[tok, h, :]
// (columns 0-127) and the shared k_rope[tok, :] (columns 128-191), into a
// shared tile at pitch 200.
__device__ __forceinline__ void copy_k_rows(bf16* dst, const bf16* __restrict__ k_nope,
                                            const bf16* __restrict__ k_rope, size_t tok0, int h,
                                            int H, int rows) {
  for (int idx = threadIdx.x; idx < rows * kQkPieces; idx += kThreads) {
    const int r = idx / kQkPieces, p = idx - r * kQkPieces;
    const size_t tok = tok0 + r;
    if (p < kNopePieces)
      cp_async16(dst + r * kPitchQk + 8 * p, k_nope + (tok * H + h) * kNope + 8 * p);
    else
      cp_async16(dst + r * kPitchQk + 8 * p, k_rope + tok * kRope + 8 * (p - kNopePieces));
  }
}

// One kv ring stage of the q-stationary kernels: a live kv tile's k rows,
// v rows and segment ids.
__device__ __forceinline__ void copy_kv_stage(unsigned char* base, const bf16* __restrict__ k_nope,
                                              const bf16* __restrict__ k_rope,
                                              const bf16* __restrict__ v,
                                              const int* __restrict__ seg_rows, size_t tok0, int h,
                                              int H, int rows) {
  copy_k_rows(reinterpret_cast<bf16*>(base), k_nope, k_rope, tok0, h, H, rows);
  copy_v_rows(reinterpret_cast<bf16*>(base + kTileQk), v, tok0, h, H, rows);
  for (int i = threadIdx.x; i < rows; i += kThreads)
    cp_async4(reinterpret_cast<int*>(base + kTileQk + kTileV) + i, seg_rows + i);
}

// Every element of a warp's 16-row piece is visible when all its rows and
// columns lie inside the blocks, every key is at or before every query and
// one positive segment runs throughout; the per-element test is then
// skipped (the arithmetic is the same).  `own` are this thread's two
// stationary rows' ids; `other` the piece's moving ids, 2 tig (+1) of each
// n8 tile from `c0` on.
template <int kTiles>
__device__ __forceinline__ bool one_segment(const int (&own)[2], const int* other, int c0) {
  const int tig = threadIdx.x % 4;
  const int id = __shfl_sync(0xffffffffu, own[0], 0);
  bool same = own[0] == id && own[1] == id && id > 0;
#pragma unroll
  for (int j = 0; j < kTiles; ++j) {
    const int2 ids = *reinterpret_cast<const int2*>(other + c0 + 8 * j + 2 * tig);
    same = same && ids.x == id && ids.y == id;
  }
  return __all_sync(0xffffffffu, same);
}

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

constexpr int kHalf = 64;               // kv columns of one online-softmax update
constexpr int kHalfTiles = kHalf / 8;   // n8 score tiles of a half

// One live kv tile for this warp's q rows r0 .. r0+15: the online-softmax
// update of (m, l, o), 64 kv columns at a time.  Element e of n8 accumulator
// tile j is q row r0 + g (+8 for e >= 2) and column 8j + 2 tig (+1 for odd
// e); m is in the units of scale.q.k.
__device__ __forceinline__ void fwd_step(const uint32_t (&qf)[kQkFrags][4], const bf16* ks,
                                         const bf16* vs, const int* kseg, int bq, int bkv,
                                         int q_pos0, int k_pos0, bool causal,
                                         const int (&qseg)[2], float scale, float (&m)[2],
                                         float (&l)[2], float (&o)[kVTiles][4]) {
  const int lane = threadIdx.x % 32;
  const int r0 = (threadIdx.x / 32) * 16;
  const int g = lane / 4, tig = lane % 4;
  // ldmatrix.x4 row addresses.  K as the plain B operand: the matrices are
  // (rows 0-7, cols 0-7), (0-7, 8-15), (8-15, 0-7), (8-15, 8-15), i.e. the k
  // halves of two n8 tiles.  V as the trans B operand: (0-7, 0-7),
  // (8-15, 0-7), (0-7, 8-15), (8-15, 8-15).
  const int b_row = (lane & 7) + (lane >> 4) * 8, b_col = ((lane >> 3) & 1) * 8;
  const int t_row = (lane & 7) + ((lane >> 3) & 1) * 8, t_col = (lane >> 4) * 8;
  const uint32_t k_addr = smem_addr(ks + b_row * kPitchQk + b_col);
  const uint32_t v_addr = smem_addr(vs + t_row * kPitchV + t_col);

  for (int c0 = 0; c0 < bkv; c0 += kHalf) {
    // Every key from here on lies after every query of the warp.
    if (causal && k_pos0 + c0 > q_pos0 + r0 + 15) break;

    float s[kHalfTiles][4];
#pragma unroll
    for (int j = 0; j < kHalfTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kQkFrags; ++kk) {
#pragma unroll
      for (int jp = 0; jp < kHalfTiles / 2; ++jp) {
        if (c0 + 16 * jp < bkv) {
          uint32_t b[4];
          ldsm_x4(b, k_addr + (c0 + 16 * jp) * (2 * kPitchQk) + 32 * kk);
          mma_bf16(s[2 * jp], qf[kk], b[0], b[1]);
          mma_bf16(s[2 * jp + 1], qf[kk], b[2], b[3]);
        }
      }
    }

    bool open = r0 + 16 <= bq && c0 + kHalf <= bkv &&
                (!causal || k_pos0 + c0 + kHalf - 1 <= q_pos0 + r0);
    if (open) open = one_segment<kHalfTiles>(qseg, kseg, c0);
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
          ok = ok && kseg[c] > 0 && kseg[c] == qseg[e >> 1];
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
      for (int n = 0; n < kVTiles; ++n)
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
        const uint32_t off = (c0 + 16 * kk) * (2 * kPitchV);
#pragma unroll
        for (int n = 0; n < kVTiles / 2; ++n) {
          uint32_t b[4];
          ldsm_x4_trans(b, v_addr + off + 32 * n);
          mma_bf16(o[2 * n], a, b[0], b[1]);
          mma_bf16(o[2 * n + 1], a, b[2], b[3]);
        }
      }
    }
  }
}

// The q-stationary grid: one block per (q block, head, batch row), the last
// q blocks first (the most live tiles under the causal mask).
struct QBlock {
  int qb, h, b, q0;
};

__device__ __forceinline__ QBlock q_block_of(int S, int H, int bq) {
  const int nq = S / bq;
  const int heads_rows = gridDim.x / nq;  // H * B
  QBlock w;
  w.qb = nq - 1 - static_cast<int>(blockIdx.x) / heads_rows;
  w.h = blockIdx.x % H;
  w.b = (blockIdx.x % heads_rows) / H;
  w.q0 = w.qb * bq;
  return w;
}

__global__ void __launch_bounds__(kThreads, 1)
    mla_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k_nope,
                   const bf16* __restrict__ k_rope, const bf16* __restrict__ v,
                   const int* __restrict__ seg, const int* __restrict__ kv_idx,
                   const int* __restrict__ kv_count, bf16* __restrict__ out,
                   float* __restrict__ lse, int S, int H, int bq, int bkv, int causal,
                   float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const QBlock w = q_block_of(S, H, bq);
  const int nq = S / bq, nk = S / bkv;
  const int tid = threadIdx.x, lane = tid % 32;
  const int r0 = (tid / 32) * 16, g = lane / 4, tig = lane % 4;
  const size_t row0 = static_cast<size_t>(w.b) * S;
  bf16* qs = reinterpret_cast<bf16*>(smem);

  zero_smem(smem, kQStationarySmem);
  __syncthreads();
  copy_q_rows(qs, q, row0 + w.q0, w.h, H, bq);
  cp_async_commit();

  int qseg[2] = {0, 0};
  for (int i = 0; i < 2; ++i)
    if (r0 + g + 8 * i < bq) qseg[i] = seg[row0 + w.q0 + r0 + g + 8 * i];

  const int row_tables = w.b * nq + w.qb;
  const int n_steps = kv_count[row_tables];
  auto kv_block = [&](int t) { return kv_idx[static_cast<size_t>(row_tables) * nk + t]; };
  auto stage = [&](int s) { return smem + kTileQk + s * kStageKv; };
  auto issue = [&](int t, int s) {
    const int k0 = kv_block(t) * bkv;
    copy_kv_stage(stage(s), k_nope, k_rope, v, seg + row0 + k0, row0 + k0, w.h, H, bkv);
  };

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[kVTiles][4];
#pragma unroll
  for (int n = 0; n < kVTiles; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  int t = 0;
  if (t < n_steps) issue(t, 0);
  cp_async_commit();
  cp_async_wait_prev();  // the q tile has landed
  __syncthreads();
  uint32_t qf[kQkFrags][4];
  {
    const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_col = (lane >> 4) * 8;
    const uint32_t q_addr = smem_addr(qs + (r0 + a_row) * kPitchQk + a_col);
#pragma unroll
    for (int kk = 0; kk < kQkFrags; ++kk) ldsm_x4(qf[kk], q_addr + 32 * kk);
  }

  // A two-stage ring: tile t+1's copies are in flight while tile t computes.
  for (int s = 0; t < n_steps; s ^= 1) {
    if (t + 1 < n_steps) issue(t + 1, s ^ 1);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    if (r0 < bq) {
      const unsigned char* base = stage(s);
      fwd_step(qf, reinterpret_cast<const bf16*>(base), reinterpret_cast<const bf16*>(base + kTileQk),
               reinterpret_cast<const int*>(base + kTileQk + kTileV), bq, bkv, w.q0,
               kv_block(t) * bkv, causal != 0, qseg, scale, m, l, o);
    }
    __syncthreads();  // stage s is refilled by the next iteration's copies
    ++t;
  }
  cp_async_wait_all();

  // out and lse leave once, for the block's rows only.
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + g + 8 * half;
    if (r >= bq) continue;
    const float denom = l[half] == 0.f ? 1.f : l[half];
    const size_t pos = row0 + w.q0 + r;
    bf16* out_row = out + (pos * H + w.h) * kV;
#pragma unroll
    for (int n = 0; n < kVTiles; ++n) {
      const int c = 8 * n + 2 * tig;
      *reinterpret_cast<__nv_bfloat162*>(out_row + c) = __floats2bfloat162_rn(
          __fdiv_rn(o[n][2 * half], denom), __fdiv_rn(o[n][2 * half + 1], denom));
    }
    if (tig == 0) lse[pos * H + w.h] = l[half] > 0.f ? __fadd_rn(m[half], logf(denom)) : kNegInf;
  }
}

// ---------------------------------------------------------------------------
// Backward: P = exp(scale q.k - lse) under the mask, dP = dO.v,
// dS = P (dP - delta), dQ = scale dS.K, dK = scale dS^T.Q, dV = P^T.dO, with
// delta = rowsum(dO * O) in fp32 from the wrapper.
// ---------------------------------------------------------------------------

constexpr int kChunk = 32;               // moving-tile columns of one register chunk
constexpr int kChunkTiles = kChunk / 8;  // n8 accumulator tiles of a chunk

// One live kv tile for this warp's q rows r0 .. r0+15: dq += (scale dS) . K,
// the tile taken in chunks of kChunk columns.  Per chunk: S = Q . K^T (the
// q rows by ldmatrix from shared memory) and dP = dO . V^T (dO's register
// fragments); scale dS in the accumulator registers under the mask; then
// dQ += (scale dS) . K, scale dS rounded to one bf16 term, with K by
// ldmatrix.trans.  nlse[i] = -lse * log2(e) and delta[i] belong to the
// thread's rows r0 + g + 8i.
__device__ __forceinline__ void dq_step(const bf16* qs, const uint32_t (&of)[kVFrags][4],
                                        const bf16* ks, const bf16* vs, const int* kseg, int bq,
                                        int bkv, int q_pos0, int k_pos0, bool causal,
                                        const int (&qseg)[2], const float (&nlse)[2],
                                        const float (&delta)[2], float scale,
                                        float (&dq)[kQkTiles][4]) {
  const int lane = threadIdx.x % 32;
  const int r0 = (threadIdx.x / 32) * 16;
  const int g = lane / 4, tig = lane % 4;
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + (lane >> 4) * 8, b_col = ((lane >> 3) & 1) * 8;
  const int t_row = a_row, t_col = a_col;
  const uint32_t q_addr = smem_addr(qs + (r0 + a_row) * kPitchQk + a_col);
  const uint32_t k_addr = smem_addr(ks + b_row * kPitchQk + b_col);
  const uint32_t v_addr = smem_addr(vs + b_row * kPitchV + b_col);
  const uint32_t kt_addr = smem_addr(ks + t_row * kPitchQk + t_col);
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
    for (int kk = 0; kk < kQkFrags; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, q_addr + 32 * kk);
#pragma unroll
      for (int jp = 0; jp < kChunkTiles / 2; ++jp) {
        if (c0 + 16 * jp < bkv) {
          uint32_t b[4];
          ldsm_x4(b, k_addr + (c0 + 16 * jp) * (2 * kPitchQk) + 32 * kk);
          mma_bf16(s[2 * jp], a, b[0], b[1]);
          mma_bf16(s[2 * jp + 1], a, b[2], b[3]);
        }
      }
    }
#pragma unroll
    for (int kk = 0; kk < kVFrags; ++kk) {
#pragma unroll
      for (int jp = 0; jp < kChunkTiles / 2; ++jp) {
        if (c0 + 16 * jp < bkv) {
          uint32_t b[4];
          ldsm_x4(b, v_addr + (c0 + 16 * jp) * (2 * kPitchV) + 32 * kk);
          mma_bf16(dp[2 * jp], of[kk], b[0], b[1]);
          mma_bf16(dp[2 * jp + 1], of[kk], b[2], b[3]);
        }
      }
    }

    bool open = r0 + 16 <= bq && c0 + kChunk <= bkv &&
                (!causal || k_pos0 + c0 + kChunk - 1 <= q_pos0 + r0);
    if (open) open = one_segment<kChunkTiles>(qseg, kseg, c0);

    // scale dS = scale P (dP - delta), P built from the mask; it overwrites dp.
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
          ok = ok && kseg[c] > 0 && kseg[c] == qseg[e >> 1];
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
        const uint32_t off = (c0 + 16 * kk) * (2 * kPitchQk);
#pragma unroll
        for (int n = 0; n < kQkTiles / 2; ++n) {
          uint32_t b[4];
          ldsm_x4_trans(b, kt_addr + off + 32 * n);
          mma_bf16(dq[2 * n], a, b[0], b[1]);
          mma_bf16(dq[2 * n + 1], a, b[2], b[3]);
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    mla_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k_nope,
                      const bf16* __restrict__ k_rope, const bf16* __restrict__ v,
                      const int* __restrict__ seg, const int* __restrict__ kv_idx,
                      const int* __restrict__ kv_count, const bf16* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      bf16* __restrict__ dq, int S, int H, int bq, int bkv, int causal,
                      float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const QBlock w = q_block_of(S, H, bq);
  const int nq = S / bq, nk = S / bkv;
  const int tid = threadIdx.x, lane = tid % 32;
  const int r0 = (tid / 32) * 16, g = lane / 4, tig = lane % 4;
  const size_t row0 = static_cast<size_t>(w.b) * S;
  bf16* qs = reinterpret_cast<bf16*>(smem);
  auto stage = [&](int s) { return smem + kTileQk + s * kStageKv; };
  // The dO tile lands in stage 1 until its fragments are in registers.
  bf16* os = reinterpret_cast<bf16*>(stage(1));

  zero_smem(smem, kQStationarySmem);
  __syncthreads();
  copy_q_rows(qs, q, row0 + w.q0, w.h, H, bq);
  copy_v_rows(os, dout, row0 + w.q0, w.h, H, bq);
  cp_async_commit();

  // This thread's two q rows: segment ids, -lse * log2(e) and delta.
  int qseg[2] = {0, 0};
  float nlse[2] = {0.f, 0.f}, dlt[2] = {0.f, 0.f};
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + g + 8 * i;
    if (r < bq) {
      const size_t pos = row0 + w.q0 + r;
      nlse[i] = -__fmul_rn(lse[pos * H + w.h], kLog2e);
      dlt[i] = delta[pos * H + w.h];
      qseg[i] = seg[pos];
    }
  }

  const int row_tables = w.b * nq + w.qb;
  const int n_steps = kv_count[row_tables];
  auto kv_block = [&](int t) { return kv_idx[static_cast<size_t>(row_tables) * nk + t]; };
  auto issue = [&](int t, int s) {
    const int k0 = kv_block(t) * bkv;
    copy_kv_stage(stage(s), k_nope, k_rope, v, seg + row0 + k0, row0 + k0, w.h, H, bkv);
  };

  float acc[kQkTiles][4];
#pragma unroll
  for (int n = 0; n < kQkTiles; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  int t = 0;
  if (t < n_steps) issue(t, 0);
  cp_async_commit();
  cp_async_wait_prev();  // the q and dO tiles have landed
  __syncthreads();
  uint32_t of[kVFrags][4];
  {
    const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_col = (lane >> 4) * 8;
    const uint32_t o_addr = smem_addr(os + (r0 + a_row) * kPitchV + a_col);
#pragma unroll
    for (int kk = 0; kk < kVFrags; ++kk) ldsm_x4(of[kk], o_addr + 32 * kk);
  }
  __syncthreads();
  zero_smem(stage(1), kStageKv);  // the ring's ragged tails must read 0 again
  __syncthreads();

  for (int s = 0; t < n_steps; s ^= 1) {
    if (t + 1 < n_steps) issue(t + 1, s ^ 1);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    if (r0 < bq) {
      const unsigned char* base = stage(s);
      dq_step(qs, of, reinterpret_cast<const bf16*>(base), reinterpret_cast<const bf16*>(base + kTileQk),
              reinterpret_cast<const int*>(base + kTileQk + kTileV), bq, bkv, w.q0, kv_block(t) * bkv,
              causal != 0, qseg, nlse, dlt, scale, acc);
    }
    __syncthreads();  // stage s is refilled by the next iteration's copies
    ++t;
  }
  cp_async_wait_all();

  // dQ leaves once, in bf16, for the block's rows only.
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + g + 8 * half;
    if (r >= bq) continue;
    bf16* dq_row = dq + ((row0 + w.q0 + r) * H + w.h) * kQk;
#pragma unroll
    for (int n = 0; n < kQkTiles; ++n) {
      const int c = 8 * n + 2 * tig;
      *reinterpret_cast<__nv_bfloat162*>(dq_row + c) =
          __floats2bfloat162_rn(acc[n][2 * half], acc[n][2 * half + 1]);
    }
  }
}

// One ring stage of the dK/dV pass: 64 rows of a live q block.
struct QStage {
  bf16* q;      // [kStepRows][kPitchQk]
  bf16* o;      // [kStepRows][kPitchV] the same rows of dO
  float* lse;   // [kStepRows]
  float* delta; // [kStepRows]
  int* seg;     // [kStepRows]
};

// One step (64 rows of a live q block) for this warp's kv rows r0 .. r0+15:
// acc_v += P^T . dO and acc_k += (scale dS)^T . Q, in chunks of kChunk q
// rows.  Per chunk: S^T = K . Q^T and dP^T = V . dO^T (K, V as the A operand
// by ldmatrix from shared memory, the q and dO rows as the column-major B
// operand); P^T and scale dS^T under the mask; then those registers are the
// A operand of dV += P^T . dO (P rounded to bf16) and dK += (scale dS)^T . Q
// (scale dS as two bf16 terms, hi and lo), dO and Q by ldmatrix.trans.
// Element e of n8 tile j: kv row r0 + g (+8 for e >= 2), q column
// c0 + 8j + 2 tig (+1 for odd e).
__device__ __forceinline__ void dkv_step(const bf16* ks, const bf16* vs, const QStage& st, int R,
                                         int rows, int k_pos0, int q_pos0, bool causal,
                                         const int (&kseg)[2], float scale,
                                         float (&acc_k)[kQkTiles][4],
                                         float (&acc_v)[kVTiles][4]) {
  const int lane = threadIdx.x % 32;
  const int r0 = (threadIdx.x / 32) * 16;
  const int g = lane / 4, tig = lane % 4;
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + (lane >> 4) * 8, b_col = ((lane >> 3) & 1) * 8;
  const uint32_t k_addr = smem_addr(ks + (r0 + a_row) * kPitchQk + a_col);
  const uint32_t v_addr = smem_addr(vs + (r0 + a_row) * kPitchV + a_col);
  const uint32_t q_addr = smem_addr(st.q + b_row * kPitchQk + b_col);
  const uint32_t o_addr = smem_addr(st.o + b_row * kPitchV + b_col);
  const uint32_t qt_addr = smem_addr(st.q + a_row * kPitchQk + a_col);
  const uint32_t ot_addr = smem_addr(st.o + a_row * kPitchV + a_col);
  const float scale_log2 = __fmul_rn(scale, kLog2e);

  for (int c0 = 0; c0 < rows; c0 += kChunk) {
    // Every query of the chunk lies before every key of the warp.
    if (causal && q_pos0 + c0 + kChunk - 1 < k_pos0 + r0) continue;

    float s[kChunkTiles][4], dp[kChunkTiles][4];
#pragma unroll
    for (int j = 0; j < kChunkTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = 0.f;
        dp[j][e] = 0.f;
      }
#pragma unroll
    for (int kk = 0; kk < kQkFrags; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, k_addr + 32 * kk);
#pragma unroll
      for (int j = 0; j < kChunkTiles / 2; ++j) {
        if (c0 + 16 * j < rows) {
          uint32_t b[4];
          ldsm_x4(b, q_addr + (c0 + 16 * j) * (2 * kPitchQk) + 32 * kk);
          mma_bf16(s[2 * j], a, b[0], b[1]);
          mma_bf16(s[2 * j + 1], a, b[2], b[3]);
        }
      }
    }
#pragma unroll
    for (int kk = 0; kk < kVFrags; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, v_addr + 32 * kk);
#pragma unroll
      for (int j = 0; j < kChunkTiles / 2; ++j) {
        if (c0 + 16 * j < rows) {
          uint32_t b[4];
          ldsm_x4(b, o_addr + (c0 + 16 * j) * (2 * kPitchV) + 32 * kk);
          mma_bf16(dp[2 * j], a, b[0], b[1]);
          mma_bf16(dp[2 * j + 1], a, b[2], b[3]);
        }
      }
    }

    bool open = r0 + 16 <= R && c0 + kChunk <= rows &&
                (!causal || k_pos0 + r0 + 15 <= q_pos0 + c0);
    if (open) open = one_segment<kChunkTiles>(kseg, st.seg, c0);

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
          bool ok = r < R && c < rows;
          if (causal) ok = ok && k_pos0 + r <= q_pos0 + c;
          ok = ok && kseg[e >> 1] > 0 && st.seg[c] == kseg[e >> 1];
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
      if (c0 + 16 * j >= rows) break;  // the rest of the chunk is past the step's rows
      const uint32_t ap[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                              pack_bf16(s[2 * j][2], s[2 * j][3]),
                              pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                              pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
      uint32_t ads[4], ads_lo[4];
      split_bf16(dp[2 * j][0], dp[2 * j][1], ads[0], ads_lo[0]);
      split_bf16(dp[2 * j][2], dp[2 * j][3], ads[1], ads_lo[1]);
      split_bf16(dp[2 * j + 1][0], dp[2 * j + 1][1], ads[2], ads_lo[2]);
      split_bf16(dp[2 * j + 1][2], dp[2 * j + 1][3], ads[3], ads_lo[3]);
#pragma unroll
      for (int n = 0; n < kVTiles / 2; ++n) {
        uint32_t b[4];
        ldsm_x4_trans(b, ot_addr + (c0 + 16 * j) * (2 * kPitchV) + 32 * n);
        mma_bf16(acc_v[2 * n], ap, b[0], b[1]);
        mma_bf16(acc_v[2 * n + 1], ap, b[2], b[3]);
      }
#pragma unroll
      for (int n = 0; n < kQkTiles / 2; ++n) {
        uint32_t b[4];
        ldsm_x4_trans(b, qt_addr + (c0 + 16 * j) * (2 * kPitchQk) + 32 * n);
        mma_bf16(acc_k[2 * n], ads, b[0], b[1]);
        mma_bf16(acc_k[2 * n + 1], ads, b[2], b[3]);
        mma_bf16(acc_k[2 * n], ads_lo, b[0], b[1]);
        mma_bf16(acc_k[2 * n + 1], ads_lo, b[2], b[3]);
      }
    }
  }
}

// dK/dV: one block per (kv tile, head, batch row), the first kv tiles first;
// warp w owns kv rows 16w .. 16w+15 of the tile.  The walk is the column
// table's live q blocks ascending, each as ceil(bq / 64) steps of 64 rows.
__global__ void __launch_bounds__(kThreads, 1)
    mla_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k_nope,
                       const bf16* __restrict__ k_rope, const bf16* __restrict__ v,
                       const int* __restrict__ seg, const int* __restrict__ q_idx,
                       const int* __restrict__ q_count, const bf16* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       bf16* __restrict__ dk_nope, float* __restrict__ dk_rope_heads,
                       bf16* __restrict__ dv, int S, int H, int bq, int bkv, int causal,
                       float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int nq = S / bq, nk = S / bkv;
  const int heads_rows = gridDim.x / nk;  // H * B
  const int kb = blockIdx.x / heads_rows;
  const int h = blockIdx.x % H, b = (blockIdx.x % heads_rows) / H;
  const int k0 = kb * bkv, R = bkv;
  const int tid = threadIdx.x;
  const int r0 = (tid / 32) * 16, g = (tid % 32) / 4, tig = tid % 4;
  const size_t row0 = static_cast<size_t>(b) * S;
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = reinterpret_cast<bf16*>(smem + kTileQk);

  zero_smem(smem, kDkvSmem);
  __syncthreads();
  copy_k_rows(ks, k_nope, k_rope, row0 + k0, h, H, R);
  copy_v_rows(vs, v, row0 + k0, h, H, R);

  int kseg[2] = {0, 0};
  for (int i = 0; i < 2; ++i)
    if (r0 + g + 8 * i < R) kseg[i] = seg[row0 + k0 + r0 + g + 8 * i];

  const int col_tables = b * nk + kb;
  const int halves = (bq + kStepRows - 1) / kStepRows;
  const int total = q_count[col_tables] * halves;
  auto q_row = [&](int t) {  // the step's first q row within the batch row
    return q_idx[static_cast<size_t>(col_tables) * nq + t / halves] * bq + (t % halves) * kStepRows;
  };
  auto step_rows = [&](int t) { return min(kStepRows, bq - (t % halves) * kStepRows); };
  auto stage = [&](int s) {
    unsigned char* base = smem + kTileQk + kTileV + s * kStageQ;
    return QStage{reinterpret_cast<bf16*>(base), reinterpret_cast<bf16*>(base + kStO),
                  reinterpret_cast<float*>(base + kStLse), reinterpret_cast<float*>(base + kStDelta),
                  reinterpret_cast<int*>(base + kStSeg)};
  };
  auto issue = [&](int t, int s) {
    const QStage st = stage(s);
    const size_t tok0 = row0 + q_row(t);
    const int rows = step_rows(t);
    copy_q_rows(st.q, q, tok0, h, H, rows);
    copy_v_rows(st.o, dout, tok0, h, H, rows);
    for (int i = tid; i < rows; i += kThreads) {
      const size_t pos = tok0 + i;
      cp_async4(st.lse + i, lse + pos * H + h);
      cp_async4(st.delta + i, delta + pos * H + h);
      cp_async4(st.seg + i, seg + pos);
    }
  };

  float acc_k[kQkTiles][4], acc_v[kVTiles][4];
#pragma unroll
  for (int n = 0; n < kQkTiles; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = 0.f;
#pragma unroll
  for (int n = 0; n < kVTiles; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_v[n][e] = 0.f;

  // A two-stage ring: step t+1's copies are in flight while step t computes.
  int t = 0;
  if (t < total) issue(t, 0);
  cp_async_commit();  // with the K/V tile
  for (int s = 0; t < total; s ^= 1) {
    if (t + 1 < total) issue(t + 1, s ^ 1);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    if (r0 < R) dkv_step(ks, vs, stage(s), R, step_rows(t), k0, q_row(t), causal != 0, kseg, scale, acc_k, acc_v);
    __syncthreads();  // stage s is refilled by the next iteration's copies
    ++t;
  }
  cp_async_wait_all();

  // dK's nope columns and dV leave once in bf16, dK's rope columns in fp32
  // as this head's partial, for the tile's rows only.
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + g + 8 * half;
    if (r >= R) continue;
    const size_t head_row = (row0 + k0 + r) * H + h;
#pragma unroll
    for (int n = 0; n < kQkTiles; ++n) {
      const int c = 8 * n + 2 * tig;
      if (c < kNope)
        *reinterpret_cast<__nv_bfloat162*>(dk_nope + head_row * kNope + c) =
            __floats2bfloat162_rn(acc_k[n][2 * half], acc_k[n][2 * half + 1]);
      else
        *reinterpret_cast<float2*>(dk_rope_heads + head_row * kRope + c - kNope) =
            make_float2(acc_k[n][2 * half], acc_k[n][2 * half + 1]);
    }
#pragma unroll
    for (int n = 0; n < kVTiles; ++n) {
      const int c = 8 * n + 2 * tig;
      *reinterpret_cast<__nv_bfloat162*>(dv + head_row * kV + c) =
          __floats2bfloat162_rn(acc_v[n][2 * half], acc_v[n][2 * half + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// Launches
// ---------------------------------------------------------------------------

bool bad_shape(int B, int S, int H, int bq, int bkv) {
  return B < 1 || H < 1 || bq < 1 || bkv < 1 || bq > kMaxBlock || bkv > kMaxBlock ||
         S % bq != 0 || S % bkv != 0;
}

// The row tensors (and the fp32 rope partials) are copied or written in
// 16-byte pieces; the int32 tables and fp32 row statistics only need to be
// there.
template <int N, int M>
bool usable(const void* const (&rows)[N], const void* const (&others)[M]) {
  for (const void* p : rows)
    if (p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  for (const void* p : others)
    if (p == nullptr) return false;
  return true;
}

template <typename Kernel>
cudaError_t prepare(int device, Kernel kernel, unsigned smem) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace

// The row tensors must be 16-byte aligned (they are copied in 16-byte
// pieces) and every tensor contiguous: q (B, S, H, 192), k_nope and v
// (B, S, H, 128), k_rope (B, S, 64), all bf16; seg (B, S) int32; the row
// tables kv_idx (B, S/bq, S/bkv) and kv_count (B, S/bq), the column tables
// q_idx (B, S/bkv, S/bq) and q_count (B, S/bkv), int32.  Each returns
// cudaGetLastError() after the launch (0 = success).
extern "C" int mla_fwd(int device, const void* q, const void* k_nope, const void* k_rope,
                       const void* v, const int* seg, const int* kv_idx, const int* kv_count,
                       void* out, float* lse, int B, int S, int H, int bq, int bkv, int causal,
                       float scale, void* stream) {
  const void* rows[] = {q, k_nope, k_rope, v, out};
  const void* others[] = {seg, kv_idx, kv_count, lse};
  if (bad_shape(B, S, H, bq, bkv) || !usable(rows, others)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = prepare(device, mla_fwd_kernel, kQStationarySmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>(S / bq) * H * B;
  mla_fwd_kernel<<<grid, kThreads, kQStationarySmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k_nope), static_cast<const bf16*>(k_rope),
      static_cast<const bf16*>(v), seg, kv_idx, kv_count, static_cast<bf16*>(out), lse, S, H, bq, bkv,
      causal, scale);
  return static_cast<int>(cudaGetLastError());
}

// delta = rowsum(dO * O) in fp32, (B, S, H); dout (B, S, H, 128) bf16; dq
// (B, S, H, 192) bf16.
extern "C" int mla_bwd_dq(int device, const void* q, const void* k_nope, const void* k_rope,
                          const void* v, const int* seg, const int* kv_idx, const int* kv_count,
                          const void* dout, const float* lse, const float* delta, void* dq, int B,
                          int S, int H, int bq, int bkv, int causal, float scale, void* stream) {
  const void* rows[] = {q, k_nope, k_rope, v, dout, dq};
  const void* others[] = {seg, kv_idx, kv_count, lse, delta};
  if (bad_shape(B, S, H, bq, bkv) || !usable(rows, others)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = prepare(device, mla_bwd_dq_kernel, kQStationarySmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>(S / bq) * H * B;
  mla_bwd_dq_kernel<<<grid, kThreads, kQStationarySmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k_nope), static_cast<const bf16*>(k_rope),
      static_cast<const bf16*>(v), seg, kv_idx, kv_count, static_cast<const bf16*>(dout), lse, delta,
      static_cast<bf16*>(dq), S, H, bq, bkv, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

// dk_nope and dv (B, S, H, 128) bf16; dk_rope_heads (B, S, H, 64) fp32, each
// head's rope columns of dK, for the wrapper to sum over the heads.
extern "C" int mla_bwd_dkv(int device, const void* q, const void* k_nope, const void* k_rope,
                           const void* v, const int* seg, const int* q_idx, const int* q_count,
                           const void* dout, const float* lse, const float* delta, void* dk_nope,
                           float* dk_rope_heads, void* dv, int B, int S, int H, int bq, int bkv,
                           int causal, float scale, void* stream) {
  const void* rows[] = {q, k_nope, k_rope, v, dout, dk_nope, dk_rope_heads, dv};
  const void* others[] = {seg, q_idx, q_count, lse, delta};
  if (bad_shape(B, S, H, bq, bkv) || !usable(rows, others)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = prepare(device, mla_bwd_dkv_kernel, kDkvSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>(S / bkv) * H * B;
  mla_bwd_dkv_kernel<<<grid, kThreads, kDkvSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k_nope), static_cast<const bf16*>(k_rope),
      static_cast<const bf16*>(v), seg, q_idx, q_count, static_cast<const bf16*>(dout), lse, delta,
      static_cast<bf16*>(dk_nope), dk_rope_heads, static_cast<bf16*>(dv), S, H, bq, bkv, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mla_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
