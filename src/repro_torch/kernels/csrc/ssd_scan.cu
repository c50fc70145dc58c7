// Mamba-2 SSD chunk scan, forward only, for Hopper (sm_90a).
//
// Replaces repro/kernels/ssd_scan.py :: ssd_scan (the Pallas TPU kernel
// _ssd_kernel): one sequence and one head at a time, chunk by chunk, with an
// fp32 (P x N) state carried from chunk to chunk:
//
//   acs   = cumsum(adt) within the chunk
//   y_i   = sum_{j<=i} exp(acs_i - acs_j) (C_i . B_j) dt_j x_j
//           + exp(acs_i) (C_i . state)
//   state <- exp(acs_last) state + sum_j exp(acs_last - acs_j) dt_j x_j (x) B_j
//
// Inputs: x (B, S, H, P), adt = a*dt and dt (B, S, H) fp32, B and C (B, S, N)
// (ngroups = 1), x/B/C in fp32 or bf16; an optional fp32 initial state
// (B, H, P, N).  Outputs: y (B, S, H, P) in x's dtype and, when asked, the
// fp32 final state (B, H, P, N).  The TPU kernel starts from a zero state and
// drops the last one; those are the two ends of the state it already
// carries, and this kernel exposes both (the model's prefill needs the final
// state for its decode cache).
//
// x, B and C may be column slices of one wider tensor (the model's conv
// output, (B, S, d_inner + 2N)): each is read through its own batch and row
// strides with a contiguous last dimension (x also contiguous over H), so the
// model passes views and copies nothing.  adt, dt, the states and y are
// contiguous.
//
// What bounds it on the H100.  The least work at mamba2-130m's shapes
// (H 24, P 64, N 128, chunk 256): C.B^T once per (b, chunk), and per
// (b, h, chunk) the causal W.x, C.state and state-update products -- 19.9
// GFLOP and 118.5 MB at (B, S) = (8, 2048) in bf16, so by the H100 SXM's
// peaks (989 TFLOP/s, 3.35 TB/s) bytes bound it at 0.035 ms.
//
// Two routes, by dtype.
//
// fp32 (ssd_scan_kernel, the exact rail): one 256-thread block per (b, h)
// walks the chunks in order, the state in shared memory, every product on
// the CUDA cores in fp32 (4 x 4 register micro-tiles, 64-row tiles of the
// chunk, rows padded by one float; ~134 KB).  It fills the card only when
// B*H >> 132 SMs and recomputes C.B^T for every head: 4.85 ms at (8, 2048)
// and 38.7 ms at (1, 32768) in bf16 before the bf16 route below.
//
// bf16 (namespace ssdtc, the `_tc_kernel`s) is the SSD algorithm of the
// Mamba-2 paper (arXiv:2405.21060, section 6): the TPU's sequential chunk
// axis does not exist on Hopper, so the chunk states are computed in
// parallel, passed along the chunks by a short elementwise scan, and the
// outputs are computed in parallel again.  Four launches on one stream:
//
// 0. ssd_scores_tc_kernel, per (b, chunk, 64 x 64 tile pair below the
//    diagonal): C.B^T in fp32 into a scratch (B, nc, Qp, Qp), Qp = Q
//    rounded up to 64.  B and C are shared by every head, so the scores are
//    computed once per (b, chunk), not once per head (~44 % of the products
//    of a per-head design).
// 1. ssd_chunk_state_tc_kernel, per (b, chunk, head), eight warps: acs by
//    a warp scan, then S_c = sum_j exp(acs_last - acs_j) dt_j x_j (x) B_j,
//    a (P x Q).(Q x N) product whose A fragments (x^T) are scaled and split
//    in registers, into the fp32 scratch states (B, nc, H, P, N), and
//    exp(acs_last) into decay (B, nc, H).
// 2. ssd_state_pass_kernel, per (b, h, p, n), on the CUDA cores: the only
//    sequential part, over the chunks: s_enter(c+1) = exp(acs_last(c))
//    s_enter(c) + S_c, written over S_c in place, from the initial state
//    (or 0); the last state is the final state.  Bound by bytes: four
//    elements a thread and eight chunks' loads in flight before the chain.
// 3. ssd_chunk_out_tc_kernel, per (b, chunk, head), four warps walking the
//    chunk's 64-row tiles (warp w owning rows 16w .. 16w+15 of a tile):
//    exp(acs_i) (C_i . s_enter) on the tensor cores, then W.x over the
//    column tiles j0 <= i0, W built in registers from the scores, which each
//    thread loads into registers one step ahead.  One block per head and
//    chunk reads its s_enter once for all its rows.
//
// * Products.  mma.sync.m16n8k16 bf16 -> fp32; ldmatrix (.trans where the
//   stored rows are the k dimension) from rows padded to 72 or 136 bf16
//   (conflict-free); the tensor-core helpers of tc_common.cuh.
// * Loads.  The x, B and C rows go through cp.async, in two-stage rings
//   where a block walks tiles, so the next tile's copies overlap this
//   tile's products; adt, dt and s_enter come with the first tile.
//   16-byte copies need 16-byte aligned rows; an operand whose base,
//   strides or width are not multiples of 8 bf16 is copied by plain loads
//   instead (same kernels, no overlap), so every shape the wrapper takes
//   runs here.  Ragged P, N and chunks are zero-padded to the MMA's 16 in
//   shared memory by the loads themselves (rows past the chunk are zeroed
//   at each load, since a ring stage is reused).
// * Numerics.  Three operands that the TPU kernel keeps in fp32 enter an MMA
//   here: the weights W, the entering state and the scaled inputs
//   exp(acs_last - acs_j) dt_j x_j.  Each goes in as two bf16 terms
//   (hi = rn(v), lo = rn(v - hi), split_bf16): one term leaves the bf16
//   tolerance at mamba2's widths with slow decay (|y| up to ~35 and
//   |state| ~6: the rounding of a sum over 256 or 128 terms shows in
//   atol), two terms keep ~16 mantissa bits (the CPU model
//   tests/test_torch_ssm.py::TestBf16SsdRounding).  C.B^T of bf16 inputs
//   is exact up to the order of the fp32 sum.  The state carried between
//   chunks stays fp32 in device memory.  The decay exp(acs_i - acs_j) is
//   computed only where j <= i and selected to 0 elsewhere: it may overflow
//   there, and inf * 0 would be NaN.
// * Traffic beyond the least work: the states scratch is written, read and
//   written by pass 2, and read (50 MB at (8, 2048), 100 MB at (1, 32768));
//   the scores scratch (16.8 MB, 33.5 MB) is written once and read once per
//   head (~250 MB at (8, 2048)), mostly from L2.
// * Where the time goes (chip_smoke.py's [times] lines, NVIDIA H100 80GB
//   HBM3 at 700 W): ~0.50 ms at (8, 2048) and ~0.96 ms at (1, 32768), of
//   which the output pass ~70 %, the chunk states ~19 %, the state pass
//   ~7 %, the scores ~2 %; about twice the least work in MMAs (every fp32
//   operand split) at ~80 TFLOP/s.
//
// Levers for later: wgmma with the operands fed by TMA; a single fused pass
// with a decoupled look-back over the chunk states (the state pass then
// never leaves the chip); the output pass reading each score tile once for
// several heads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tc_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;       // rows of an output tile, and of a B/x tile
constexpr int kSide = 16;       // threads along each side of a tile
constexpr int kPer = kTile / kSide;  // rows (or columns) per thread: 4
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;
constexpr int kMaxChunk = 1024;
constexpr int kRowN = kMaxN + 1;   // padded row of sState, sC, sB
constexpr int kRowW = kTile + 1;   // padded row of sW
constexpr int kUpdN = kMaxN / kSide;  // state columns per thread in the update: 8

__device__ __forceinline__ float to_float(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}

// rows [t0, t0 + kTile) of a (rows, width) slab -> dst (stride dst_row),
// as fp32; rows at or past `rows` are zero.  src points at the chunk's row 0
// and steps `row_stride` elements per row.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int dst_row,
                                          const T* src, size_t row_stride,
                                          int t0, int rows, int width) {
  for (int idx = threadIdx.x; idx < kTile * width; idx += kThreads) {
    const int r = idx / width, col = idx - r * width;
    const int t = t0 + r;
    dst[r * dst_row + col] =
        t < rows ? to_float(src[static_cast<size_t>(t) * row_stride + col])
                 : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ adt,
                    const float* __restrict__ dt, const T* __restrict__ bm,
                    const T* __restrict__ cm,
                    const float* __restrict__ init_state, T* __restrict__ y,
                    float* __restrict__ final_state, int S, int H, int P,
                    int N, int Q, int x_sb, int x_ss, int b_sb, int b_ss,
                    int c_sb, int c_ss) {
  extern __shared__ float smem[];
  float* sState = smem;                 // kMaxP x kRowN, [p][n]
  float* sC = sState + kMaxP * kRowN;   // kTile x kRowN, [i][n]
  float* sB = sC + kTile * kRowN;       // kTile x kRowN, [j][n]
  float* sX = sB + kTile * kRowN;       // kTile x kMaxP, [j][p]
  float* sW = sX + kTile * kMaxP;       // kTile x kRowW, [i][j]
  float* sAcs = sW + kTile * kRowW;     // Q: cumsum of adt in the chunk
  float* sDt = sAcs + Q;                // Q

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x;
  const int tx = tid % kSide, ty = tid / kSide;
  const int lane = tid % 32, warp = tid / 32;

  for (int idx = tid; idx < kMaxP * kRowN; idx += kThreads) {
    const int p = idx / kRowN, n = idx - p * kRowN;
    float v = 0.f;
    if (init_state != nullptr && p < P && n < N)
      v = init_state[((static_cast<size_t>(b) * H + h) * P + p) * N + n];
    sState[idx] = v;
  }

  const int n_tiles = (Q + kTile - 1) / kTile;
  for (int c0 = 0; c0 < S; c0 += Q) {
    const size_t row0 = static_cast<size_t>(b) * S + c0;  // (b, chunk start)
    const T* xq = x + static_cast<size_t>(b) * x_sb +
                  static_cast<size_t>(c0) * x_ss + static_cast<size_t>(h) * P;
    const T* bq = bm + static_cast<size_t>(b) * b_sb + static_cast<size_t>(c0) * b_ss;
    const T* cq = cm + static_cast<size_t>(b) * c_sb + static_cast<size_t>(c0) * c_ss;

    __syncthreads();  // the previous chunk's last reads of sAcs/sDt are done
    for (int t = tid; t < Q; t += kThreads) {
      sAcs[t] = adt[(row0 + t) * H + h];
      sDt[t] = dt[(row0 + t) * H + h];
    }
    __syncthreads();
    if (warp == 0) {  // inclusive cumsum: each lane a run, then a warp scan
      const int per = (Q + 31) / 32;
      const int lo = min(lane * per, Q), hi = min(lo + per, Q);
      float run = 0.f;
      for (int t = lo; t < hi; ++t) {
        run += sAcs[t];
        sAcs[t] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += v;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) excl = 0.f;
      for (int t = lo; t < hi; ++t) sAcs[t] += excl;
    }
    __syncthreads();

    // ---- outputs, one 64-row tile of the chunk at a time ----------------
    for (int it = 0; it < n_tiles; ++it) {
      const int i0 = it * kTile;
      load_tile(sC, kRowN, cq, static_cast<size_t>(c_ss), i0, Q, N);
      __syncthreads();
      float acc[kPer][kPer];
      // carried-state term: exp(acs_i) * (C_i . state[p])
#pragma unroll
      for (int a = 0; a < kPer; ++a)
#pragma unroll
        for (int c = 0; c < kPer; ++c) acc[a][c] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[kPer], sv[kPer];
#pragma unroll
        for (int a = 0; a < kPer; ++a) cv[a] = sC[(ty + kSide * a) * kRowN + n];
#pragma unroll
        for (int c = 0; c < kPer; ++c) sv[c] = sState[(tx + kSide * c) * kRowN + n];
#pragma unroll
        for (int a = 0; a < kPer; ++a)
#pragma unroll
          for (int c = 0; c < kPer; ++c) acc[a][c] = fmaf(cv[a], sv[c], acc[a][c]);
      }
#pragma unroll
      for (int a = 0; a < kPer; ++a) {
        const int i = i0 + ty + kSide * a;
        const float decay = i < Q ? expf(sAcs[i]) : 0.f;
#pragma unroll
        for (int c = 0; c < kPer; ++c) acc[a][c] *= decay;
      }
      // within-chunk term over the causal column tiles j0 <= i0
      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * kTile;
        load_tile(sB, kRowN, bq, static_cast<size_t>(b_ss), j0, Q, N);
        load_tile(sX, kMaxP, xq, static_cast<size_t>(x_ss), j0, Q, P);
        __syncthreads();
        float sc[kPer][kPer];
#pragma unroll
        for (int a = 0; a < kPer; ++a)
#pragma unroll
          for (int c = 0; c < kPer; ++c) sc[a][c] = 0.f;
#pragma unroll 4
        for (int n = 0; n < N; ++n) {
          float cv[kPer], bv[kPer];
#pragma unroll
          for (int a = 0; a < kPer; ++a) cv[a] = sC[(ty + kSide * a) * kRowN + n];
#pragma unroll
          for (int c = 0; c < kPer; ++c) bv[c] = sB[(tx + kSide * c) * kRowN + n];
#pragma unroll
          for (int a = 0; a < kPer; ++a)
#pragma unroll
            for (int c = 0; c < kPer; ++c) sc[a][c] = fmaf(cv[a], bv[c], sc[a][c]);
        }
#pragma unroll
        for (int a = 0; a < kPer; ++a) {
          const int ri = ty + kSide * a, i = i0 + ri;
#pragma unroll
          for (int c = 0; c < kPer; ++c) {
            const int rj = tx + kSide * c, j = j0 + rj;
            // select, never multiply by a mask: exp may overflow for j > i
            float w = 0.f;
            if (i < Q && j <= i) w = expf(sAcs[i] - sAcs[j]) * sc[a][c] * sDt[j];
            sW[ri * kRowW + rj] = w;
          }
        }
        __syncthreads();
#pragma unroll 4
        for (int j = 0; j < kTile; ++j) {
          float wv[kPer], xv[kPer];
#pragma unroll
          for (int a = 0; a < kPer; ++a) wv[a] = sW[(ty + kSide * a) * kRowW + j];
#pragma unroll
          for (int c = 0; c < kPer; ++c) xv[c] = sX[j * kMaxP + tx + kSide * c];
#pragma unroll
          for (int a = 0; a < kPer; ++a)
#pragma unroll
            for (int c = 0; c < kPer; ++c) acc[a][c] = fmaf(wv[a], xv[c], acc[a][c]);
        }
        __syncthreads();  // sB, sX, sW are overwritten by the next tile
      }
#pragma unroll
      for (int a = 0; a < kPer; ++a) {
        const int i = i0 + ty + kSide * a;
        if (i >= Q) continue;
        T* yrow = y + ((row0 + i) * H + h) * static_cast<size_t>(P);
#pragma unroll
        for (int c = 0; c < kPer; ++c) {
          const int p = tx + kSide * c;
          if (p < P) yrow[p] = from_float<T>(acc[a][c]);
        }
      }
      // the next tile's load of sC follows the barrier that closed the
      // column loop; every read of sState in this tile is done before it
    }

    // ---- state update, after every row's C_i . state (barrier above) -----
    const float acs_last = sAcs[Q - 1];
    float upd[kPer][kUpdN];
#pragma unroll
    for (int a = 0; a < kPer; ++a)
#pragma unroll
      for (int c = 0; c < kUpdN; ++c) upd[a][c] = 0.f;
    for (int jt = 0; jt < n_tiles; ++jt) {
      const int j0 = jt * kTile;
      load_tile(sB, kRowN, bq, static_cast<size_t>(b_ss), j0, Q, N);
      load_tile(sX, kMaxP, xq, static_cast<size_t>(x_ss), j0, Q, P);
      __syncthreads();
      // x_j *= exp(acs_last - acs_j) * dt_j
      for (int idx = tid; idx < kTile * P; idx += kThreads) {
        const int r = idx / P, p = idx - r * P;
        const int j = j0 + r;
        if (j < Q) sX[r * kMaxP + p] *= expf(acs_last - sAcs[j]) * sDt[j];
      }
      __syncthreads();
#pragma unroll 4
      for (int j = 0; j < kTile; ++j) {
        float xv[kPer], bv[kUpdN];
#pragma unroll
        for (int a = 0; a < kPer; ++a) xv[a] = sX[j * kMaxP + ty + kSide * a];
#pragma unroll
        for (int c = 0; c < kUpdN; ++c) bv[c] = sB[j * kRowN + tx + kSide * c];
#pragma unroll
        for (int a = 0; a < kPer; ++a)
#pragma unroll
          for (int c = 0; c < kUpdN; ++c) upd[a][c] = fmaf(xv[a], bv[c], upd[a][c]);
      }
      __syncthreads();
    }
    const float chunk_decay = expf(acs_last);
#pragma unroll
    for (int a = 0; a < kPer; ++a) {
      const int p = ty + kSide * a;
#pragma unroll
      for (int c = 0; c < kUpdN; ++c) {
        const int n = tx + kSide * c;
        if (p >= P || n >= N) continue;  // sX/sB hold stale data past P and N
        float* s = &sState[p * kRowN + n];
        *s = chunk_decay * *s + upd[a][c];  // each thread owns these elements
      }
    }
  }

  __syncthreads();
  if (final_state != nullptr) {
    for (int idx = tid; idx < P * N; idx += kThreads) {
      const int p = idx / N, n = idx - p * N;
      final_state[((static_cast<size_t>(b) * H + h) * P + p) * N + n] =
          sState[p * kRowN + n];
    }
  }
}

size_t smem_bytes(int Q) {
  return sizeof(float) * (static_cast<size_t>(kMaxP) * kRowN +
                          2 * static_cast<size_t>(kTile) * kRowN +
                          static_cast<size_t>(kTile) * kMaxP +
                          static_cast<size_t>(kTile) * kRowW + 2 * static_cast<size_t>(Q));
}

template <typename T>
int launch(int device, const void* x, const float* adt, const float* dt,
           const void* bm, const void* cm, const float* init_state, void* y,
           float* final_state, int B, int S, int H, int P, int N, int Q,
           int x_sb, int x_ss, int b_sb, int b_ss, int c_sb, int c_ss,
           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = smem_bytes(Q);
  auto kernel = ssd_scan_kernel<T>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(H, B);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), adt, dt, static_cast<const T*>(bm),
      static_cast<const T*>(cm), init_state, static_cast<T*>(y), final_state,
      S, H, P, N, Q, x_sb, x_ss, b_sb, b_ss, c_sb, c_ss);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ---------------------------------------------------------------------------
// The bf16 route on the tensor cores (see the note at the head of the file):
// the chunk scores, the chunk states, the state passing and the outputs.
// The helpers are in tc_common.cuh.
// ---------------------------------------------------------------------------

namespace ssdtc {

using bf16 = __nv_bfloat16;
using namespace tc;

constexpr int kThreads = 128;  // four warps; warp w owns rows 16w .. 16w+15 of a tile
constexpr int kRows = 64;      // rows of a tile: output rows, state rows j, score rows
constexpr int kPitchP = 72;    // bf16 row of an x tile: pitch(kMaxP)
constexpr int kPitchN = 136;   // row of a B or C tile (bf16) or of s_enter (fp32): pitch(kMaxN)
constexpr unsigned kTileX = kRows * kPitchP * 2;   // bytes of an x tile
constexpr unsigned kTileN = kRows * kPitchN * 2;   // of a B, C or state tile

// Shared memory of the three tensor-core kernels (bytes): acs and dt of a
// chunk of Q rows first, then the tiles.
__host__ __device__ __forceinline__ unsigned scan_bytes(int Q) { return (8u * Q + 127u) & ~127u; }
constexpr unsigned kScoresSmem = 2 * kTileN;                      // C rows, B rows
constexpr unsigned kStateTiles = 2 * (kTileX + kTileN);  // the x and B ring
constexpr unsigned kOutTiles = 3 * kTileN + 2 * kTileX;  // C, fp32 s_enter, x ring

// Bits of the `vec` flags: the operand's rows can be copied in 16-byte pieces.
constexpr int kVecX = 1, kVecB = 2, kVecC = 4;

// A tile of kRows rows and `width` bf16 columns into shared memory: row r
// from src + r * stride.  Rows [rows, kRows) and columns [width,
// padded_dim(width)) are zeroed, the padding that the MMAs read (a ring
// stage may hold an earlier tile; nothing else is zeroed).  With `vec` by
// cp.async in 16-byte pieces (the caller commits); else by plain loads, for
// rows that are not 16-byte aligned.
__device__ __forceinline__ void load_rows(bf16* dst, int pitch_, const bf16* __restrict__ src,
                                          size_t stride, int rows, int width, bool vec) {
  if (vec) {
    const int w8 = width / 8;
    for (int idx = threadIdx.x; idx < rows * w8; idx += blockDim.x) {
      const int r = idx / w8, c = (idx - r * w8) * 8;
      cp_async16(dst + r * pitch_ + c, src + r * stride + c);
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * width; idx += blockDim.x) {
      const int r = idx / width, c = idx - r * width;
      dst[r * pitch_ + c] = src[r * stride + c];
    }
  }
  const bf16 zero = __float2bfloat16_rn(0.f);
  const int pad = padded_dim(width), tail = pad - width;
  for (int idx = threadIdx.x; idx < (kRows - rows) * pad; idx += blockDim.x)
    dst[(rows + idx / pad) * pitch_ + idx % pad] = zero;
  for (int idx = threadIdx.x; idx < rows * tail; idx += blockDim.x)
    dst[(idx / tail) * pitch_ + width + idx % tail] = zero;
}

// The inclusive cumsum of sAcs[0, rows) in place, by warp 0: each lane a
// run of ceil(Q / 32) rows, then a warp scan.  The runs depend on Q alone,
// so every kernel and every prefix sees the same acs.  The caller
// synchronises before and after.
__device__ __forceinline__ void chunk_scan(float* sAcs, int Q, int rows) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  const int per = (Q + 31) / 32;
  const int lo = min(lane * per, rows), hi = min(lo + per, rows);
  float run = 0.f;
  for (int t = lo; t < hi; ++t) {
    run += sAcs[t];
    sAcs[t] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.f;
  for (int t = lo; t < hi; ++t) sAcs[t] += excl;
}

// acs = cumsum(adt) and dt of head h over the first `rows` of the chunk's Q
// rows (row0 = its first (b, t) row), into sAcs and sDt.
__device__ __forceinline__ void chunk_cumsum(float* sAcs, float* sDt, const float* __restrict__ adt,
                                             const float* __restrict__ dt, size_t row0, int H,
                                             int h, int Q, int rows) {
  for (int t = threadIdx.x; t < rows; t += blockDim.x) {
    sAcs[t] = adt[(row0 + t) * H + h];
    sDt[t] = dt[(row0 + t) * H + h];
  }
  __syncthreads();
  chunk_scan(sAcs, Q, rows);
  __syncthreads();
}

// ldmatrix.x4 row and column (in elements) of this lane, for a 16 x 16
// piece stored row-major: ld_*_a when the stored rows are the A operand's
// rows (or, with .trans, a B operand's k), ld_*_b when they are a B
// operand's columns (or, with .trans, an A operand's k).  See
// flash_fwd.cu's fwd_step for the four matrices.
__device__ __forceinline__ int ld_row_a(int lane) { return (lane & 7) + ((lane >> 3) & 1) * 8; }
__device__ __forceinline__ int ld_col_a(int lane) { return (lane >> 4) * 8; }
__device__ __forceinline__ int ld_row_b(int lane) { return (lane & 7) + (lane >> 4) * 8; }
__device__ __forceinline__ int ld_col_b(int lane) { return ((lane >> 3) & 1) * 8; }

// Pass 0: the scores C_i . B_j of one (b, chunk) and one 64 x 64 tile pair
// (it, jt <= it), fp32, into scores (B, nc, Qp, Qp); Qp = Q rounded up to
// 64, the padding rows and columns 0.  Shared by all H heads.
__global__ void __launch_bounds__(kThreads)
    ssd_scores_tc_kernel(const bf16* __restrict__ bm, const bf16* __restrict__ cm,
                         float* __restrict__ scores, int S, int N, int Q, int b_sb, int b_ss,
                         int c_sb, int c_ss, int vec) {
  // blockIdx.x = c * pairs + pair, pairs = nt (nt + 1) / 2 (it, jt <= it)
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sC = reinterpret_cast<bf16*>(smem);
  bf16* sB = reinterpret_cast<bf16*>(smem + kTileN);
  const int nt = (Q + kRows - 1) / kRows, pairs = nt * (nt + 1) / 2, nc = S / Q;
  const int pair = blockIdx.x % pairs, c = blockIdx.x / pairs, b = blockIdx.y;
  int it = 0;
  while ((it + 1) * (it + 2) / 2 <= pair) ++it;
  const int jt = pair - it * (it + 1) / 2;
  const int i0 = it * kRows, j0 = jt * kRows, c0 = c * Q;
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32, g = lane / 4, tig = lane % 4;
  const int npad = padded_dim(N), qp = (Q + kRows - 1) / kRows * kRows;

  load_rows(sC, kPitchN, cm + static_cast<size_t>(b) * c_sb + static_cast<size_t>(c0 + i0) * c_ss,
            c_ss, min(kRows, Q - i0), N, vec & kVecC);
  load_rows(sB, kPitchN, bm + static_cast<size_t>(b) * b_sb + static_cast<size_t>(c0 + j0) * b_ss,
            b_ss, min(kRows, Q - j0), N, vec & kVecB);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  float acc[kRows / 8][4];
#pragma unroll
  for (int t = 0; t < kRows / 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
  const uint32_t c_addr = smem_addr(sC + (16 * w + ld_row_a(lane)) * kPitchN + ld_col_a(lane));
  const uint32_t b_addr = smem_addr(sB + ld_row_b(lane) * kPitchN + ld_col_b(lane));
#pragma unroll
  for (int kk = 0; kk < kMaxN / 16; ++kk) {
    if (16 * kk < npad) {
      uint32_t a[4];
      ldsm_x4(a, c_addr + 32 * kk);
#pragma unroll
      for (int jp = 0; jp < kRows / 16; ++jp) {
        uint32_t bb[4];
        ldsm_x4(bb, b_addr + jp * 16 * kPitchN * 2 + 32 * kk);
        mma_bf16(acc[2 * jp], a, bb[0], bb[1]);
        mma_bf16(acc[2 * jp + 1], a, bb[2], bb[3]);
      }
    }
  }
  float* out = scores + (static_cast<size_t>(b) * nc + c) * qp * qp;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const size_t row = static_cast<size_t>(i0 + 16 * w + g + 8 * half) * qp;
#pragma unroll
    for (int t = 0; t < kRows / 8; ++t)
      *reinterpret_cast<float2*>(out + row + j0 + 8 * t + 2 * tig) =
          make_float2(acc[t][2 * half], acc[t][2 * half + 1]);
  }
}

// Pass 1: the state contribution of one (b, chunk, head),
//   S_c = sum_j exp(acs_last - acs_j) dt_j x_j (x) B_j    (P x N, fp32),
// as (P x Q).(Q x N) on the tensor cores, the scaled x rounded to two bf16
// terms (hi + lo) in registers, from the A fragment of the raw x rows; and
// the chunk's decay exp(acs_last).  Eight warps: warp w owns state rows
// p = 16 (w % 4) .. +15 and columns n = 64 (w / 4) .. +63; the x and B rows
// come through a two-stage ring.
constexpr int kStateThreads = 256;

__global__ void __launch_bounds__(kStateThreads)
    ssd_chunk_state_tc_kernel(const bf16* __restrict__ x, const float* __restrict__ adt,
                              const float* __restrict__ dt, const bf16* __restrict__ bm,
                              float* __restrict__ states, float* __restrict__ decay, int S,
                              int H, int P, int N, int Q, int x_sb, int x_ss, int b_sb, int b_ss,
                              int vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* sAcs = reinterpret_cast<float*>(smem);
  float* sW = sAcs + Q;  // dt, then the weight exp(acs_last - acs_j) dt_j
  unsigned char* ring = smem + scan_bytes(Q);
  // blockIdx.x = c * H + h
  const int h = blockIdx.x % H, c = blockIdx.x / H, b = blockIdx.y, nc = S / Q;
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32, g = lane / 4, tig = lane % 4;
  const int c0 = c * Q, n_tiles = (Q + kRows - 1) / kRows;
  const int ppad = padded_dim(P), npad = padded_dim(N);
  const size_t row0 = static_cast<size_t>(b) * S + c0;
  const bf16* xq = x + static_cast<size_t>(b) * x_sb + static_cast<size_t>(c0) * x_ss +
                   static_cast<size_t>(h) * P;
  const bf16* bq = bm + static_cast<size_t>(b) * b_sb + static_cast<size_t>(c0) * b_ss;
  auto stage_x = [&](int s) { return reinterpret_cast<bf16*>(ring + s * (kTileX + kTileN)); };
  auto stage_b = [&](int s) {
    return reinterpret_cast<bf16*>(ring + s * (kTileX + kTileN) + kTileX);
  };
  auto issue = [&](int t, int s) {
    const int j0 = t * kRows, rows = min(kRows, Q - j0);
    load_rows(stage_x(s), kPitchP, xq + static_cast<size_t>(j0) * x_ss, x_ss, rows, P, vec & kVecX);
    load_rows(stage_b(s), kPitchN, bq + static_cast<size_t>(j0) * b_ss, b_ss, rows, N, vec & kVecB);
  };

  issue(0, 0);
  cp_async_commit();
  chunk_cumsum(sAcs, sW, adt, dt, row0, H, h, Q, Q);
  const float acs_last = sAcs[Q - 1];
  for (int t = threadIdx.x; t < Q; t += kStateThreads) sW[t] = expf(acs_last - sAcs[t]) * sW[t];
  if (threadIdx.x == 0) decay[(static_cast<size_t>(b) * nc + c) * H + h] = expf(acs_last);

  const int m0 = 16 * (w % 4), n0 = 64 * (w / 4);
  float acc[8][4];
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
  auto weight = [&](int j) { return j < Q ? sW[j] : 0.f; };  // x rows past Q are 0

  for (int t = 0, s = 0; t < n_tiles; ++t, s ^= 1) {
    if (t + 1 < n_tiles) issue(t + 1, s ^ 1);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();  // tile t has landed; sW is written
    const int j0 = t * kRows;
    if (m0 < ppad && n0 < npad) {
      const uint32_t x_addr =
          smem_addr(stage_x(s) + ld_row_b(lane) * kPitchP + m0 + ld_col_b(lane));
      const uint32_t b_addr =
          smem_addr(stage_b(s) + ld_row_a(lane) * kPitchN + n0 + ld_col_a(lane));
#pragma unroll
      for (int ks = 0; ks < kRows / 16; ++ks) {
        if (j0 + 16 * ks >= Q) break;
        // The A fragment of x^T (rows p, columns j), register q holding
        // p = g (+8 for odd q) and j = 2 tig (+1) (+8 for q >= 2), scaled by
        // the weight of its j and split into hi and lo.
        uint32_t raw[4], ah[4], al[4];
        ldsm_x4_trans(raw, x_addr + ks * 16 * kPitchP * 2);
        const int jb = j0 + 16 * ks + 2 * tig;
        const float wj[4] = {weight(jb), weight(jb + 1), weight(jb + 8), weight(jb + 9)};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw[q]));
          split_bf16(v.x * wj[2 * (q >> 1)], v.y * wj[2 * (q >> 1) + 1], ah[q], al[q]);
        }
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          if (n0 + 16 * np < npad) {
            uint32_t bb[4];
            ldsm_x4_trans(bb, b_addr + ks * 16 * kPitchN * 2 + 32 * np);
            mma_bf16(acc[2 * np], ah, bb[0], bb[1]);
            mma_bf16(acc[2 * np], al, bb[0], bb[1]);
            mma_bf16(acc[2 * np + 1], ah, bb[2], bb[3]);
            mma_bf16(acc[2 * np + 1], al, bb[2], bb[3]);
          }
        }
      }
    }
    __syncthreads();  // stage s is refilled next
  }
  cp_async_wait_all();

  float* out = states + ((static_cast<size_t>(b) * nc + c) * H + h) * P * N;
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = m0 + g + 8 * (e >> 1), n = n0 + 8 * t + 2 * tig + (e & 1);
      if (p < P && n < N) out[static_cast<size_t>(p) * N + n] = acc[t][e];
    }
}

// Pass 2: the state entering each chunk, over the chunks in order:
// s_enter(0) = initial state (or 0), s_enter(c+1) = exp(acs_last(c))
// s_enter(c) + S_c, written over S_c; the state after the last chunk is the
// final state.  Bound by bytes: a thread owns V consecutive (p, n) of one
// (b, h) (V = 4 where P*N % 4 == 0) and loads kAhead chunks before it
// chains them, so enough bytes are in flight.
constexpr int kAhead = 8;

template <int V>
__global__ void __launch_bounds__(256)
    ssd_state_pass_kernel(float* __restrict__ states, const float* __restrict__ decay,
                          const float* __restrict__ init_state, float* __restrict__ final_state,
                          int nc, int H, int PN) {
  using Vec = typename std::conditional<V == 4, float4, float>::type;
  const int e = (blockIdx.x * blockDim.x + threadIdx.x) * V;
  const int h = blockIdx.y, b = blockIdx.z;
  if (e >= PN) return;
  const size_t bh = static_cast<size_t>(b) * H + h;
  auto at = [&](float* base, size_t row) { return reinterpret_cast<Vec*>(base + row * PN + e); };
  float s[V];
  for (int v = 0; v < V; ++v) s[v] = init_state != nullptr ? init_state[bh * PN + e + v] : 0.f;
  for (int c0 = 0; c0 < nc; c0 += kAhead) {
    Vec sc[kAhead];
    float d[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      if (c0 + u < nc) {
        const size_t row = (static_cast<size_t>(b) * nc + c0 + u) * H + h;
        sc[u] = *at(states, row);
        d[u] = decay[row];
      }
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      if (c0 + u >= nc) break;
      const size_t row = (static_cast<size_t>(b) * nc + c0 + u) * H + h;
      const float* in = reinterpret_cast<const float*>(&sc[u]);
      Vec keep;
      float* kept = reinterpret_cast<float*>(&keep);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        kept[v] = s[v];
        s[v] = d[u] * s[v] + in[v];
      }
      *at(states, row) = keep;
    }
  }
  if (final_state != nullptr)
    for (int v = 0; v < V; ++v) final_state[bh * PN + e + v] = s[v];
}

// The fp32 state se (P x N, row-major) into rows p of sS (kPitchN floats
// apart), by cp.async where N % 4 == 0 (the caller commits) and plain loads
// else, zero out to the padded P and N.
__device__ __forceinline__ void load_state(float* sS, const float* __restrict__ se, int P, int N) {
  if (N % 4 == 0) {
    const int n4 = N / 4;
    for (int idx = threadIdx.x; idx < P * n4; idx += blockDim.x) {
      const int p = idx / n4, n = (idx - p * n4) * 4;
      cp_async16(sS + p * kPitchN + n, se + p * N + n);
    }
  } else {
    for (int idx = threadIdx.x; idx < P * N; idx += blockDim.x)
      sS[(idx / N) * kPitchN + idx % N] = se[idx];
  }
  const int ppad = padded_dim(P), npad = padded_dim(N);
  for (int idx = threadIdx.x; idx < ppad * npad; idx += blockDim.x) {
    const int p = idx / npad, n = idx - p * npad;
    if (p >= P || n >= N) sS[p * kPitchN + n] = 0.f;
  }
}

// Pass 3: the outputs of one (b, chunk, head),
//   y_i = exp(acs_i) (C_i . s_enter) + sum_{j<=i} W_ij x_j,
//   W_ij = exp(acs_i - acs_j) (C_i . B_j) dt_j, selected to 0 for j > i,
// both products on the tensor cores with s_enter and W as two bf16 terms
// (hi + lo), split in registers.  The block walks the chunk's 64-row tiles
// it in order and, within one, the column tiles jt <= it: a step (it, jt)
// brings the x rows of tile jt through a two-stage ring, the C rows of tile
// it with its first step; each thread loads its own scores (it, jt) from
// pass 0 straight into registers, one step ahead (no shared memory for them,
// so three blocks fit on an SM).  adt, dt and the fp32 s_enter are copied
// once, with the first step, so a block reads its s_enter once for all its
// rows.
__global__ void __launch_bounds__(kThreads)
    ssd_chunk_out_tc_kernel(const bf16* __restrict__ x, const float* __restrict__ adt,
                            const float* __restrict__ dt, const bf16* __restrict__ cm,
                            const float* __restrict__ states, const float* __restrict__ scores,
                            bf16* __restrict__ y, int S, int H, int P, int N, int Q, int x_sb,
                            int x_ss, int c_sb, int c_ss, int vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* sAcs = reinterpret_cast<float*>(smem);
  float* sDt = sAcs + Q;
  bf16* sC = reinterpret_cast<bf16*>(smem + scan_bytes(Q));
  float* sS = reinterpret_cast<float*>(smem + scan_bytes(Q) + kTileN);  // 2 kTileN bytes
  unsigned char* ring = smem + scan_bytes(Q) + 3 * kTileN;
  // blockIdx.x = c * H + h
  const int h = blockIdx.x % H, c = blockIdx.x / H, b = blockIdx.y, nc = S / Q;
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32, g = lane / 4, tig = lane % 4;
  const int c0 = c * Q, r0 = 16 * w;
  const int nt = (Q + kRows - 1) / kRows, n_steps = nt * (nt + 1) / 2;
  const int ppad = padded_dim(P), npad = padded_dim(N), qp = nt * kRows;
  const size_t row0 = static_cast<size_t>(b) * S + c0;
  const bf16* xq = x + static_cast<size_t>(b) * x_sb + static_cast<size_t>(c0) * x_ss +
                   static_cast<size_t>(h) * P;
  const bf16* cq = cm + static_cast<size_t>(b) * c_sb + static_cast<size_t>(c0) * c_ss;
  const float* sq = scores + (static_cast<size_t>(b) * nc + c) * qp * qp;
  auto stage_x = [&](int s) { return reinterpret_cast<bf16*>(ring + s * kTileX); };
  // Step k is (it, jt): the steps of row tile it are it (it + 1) / 2 ..
  auto step_of = [](int k, int& it, int& jt) {
    it = 0;
    while ((it + 1) * (it + 2) / 2 <= k) ++it;
    jt = k - it * (it + 1) / 2;
  };
  auto issue = [&](int k) {
    int it, jt;
    step_of(k, it, jt);
    const int s = k & 1, i0 = it * kRows, j0 = jt * kRows;
    load_rows(stage_x(s), kPitchP, xq + static_cast<size_t>(j0) * x_ss, x_ss,
              min(kRows, Q - j0), P, vec & kVecX);
    if (jt == 0)
      load_rows(sC, kPitchN, cq + static_cast<size_t>(i0) * c_ss, c_ss, min(kRows, Q - i0), N,
                vec & kVecC);
  };

  for (int t = threadIdx.x; t < Q; t += kThreads) {
    cp_async4(sAcs + t, adt + (row0 + t) * H + h);
    cp_async4(sDt + t, dt + (row0 + t) * H + h);
  }
  load_state(sS, states + ((static_cast<size_t>(b) * nc + c) * H + h) * P * N, P, N);
  issue(0);
  cp_async_commit();

  // This thread's scores of a step: rows r0 + g (+8) of the row tile,
  // columns 16 ks + 2 tig (+1) (+8) of the column tile, as the A fragment
  // takes them (q = half + 2 kh).
  auto load_scores = [&](int k, float2 (&buf)[kRows / 16][4]) {
    int it, jt;
    step_of(k, it, jt);
    const float* src = sq + static_cast<size_t>(it * kRows + r0 + g) * qp + jt * kRows + 2 * tig;
#pragma unroll
    for (int ks = 0; ks < kRows / 16; ++ks)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        buf[ks][q] = __ldg(reinterpret_cast<const float2*>(
            src + static_cast<size_t>(8 * (q & 1)) * qp + 16 * ks + 8 * (q >> 1)));
  };
  float2 sc_cur[kRows / 16][4], sc_next[kRows / 16][4];
  load_scores(0, sc_cur);

  float acc[kMaxP / 8][4];
  int irow[2] = {0, 0};
  float acs_i[2] = {0.f, 0.f};
  bool active = false;  // the warp has rows inside the chunk in this row tile
  for (int k = 0; k < n_steps; ++k) {
    int it, jt;
    step_of(k, it, jt);
    const int i0 = it * kRows, j0 = jt * kRows;
    if (k + 1 < n_steps) load_scores(k + 1, sc_next);
    cp_async_wait_all();
    __syncthreads();  // step k (and, at k = 0, adt, dt and s_enter) have landed
    if (k == 0) {
      chunk_scan(sAcs, Q, Q);
      __syncthreads();
    }
    if (jt == 0) {
      active = i0 + r0 < Q;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        irow[half] = i0 + r0 + g + 8 * half;
        acs_i[half] = irow[half] < Q ? sAcs[irow[half]] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kMaxP / 8; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[u][e] = 0.f;
    }
    if (active && jt == 0) {
      // The carried-state term exp(acs_i) (C_i . s_enter), first in acc.  The
      // B fragment of n8 tile u is s_enter[8u + g][k + 2 tig (+1), (+8)].
      const uint32_t c_addr = smem_addr(sC + (r0 + ld_row_a(lane)) * kPitchN + ld_col_a(lane));
      const float* s_frag = sS + g * kPitchN + 2 * tig;
#pragma unroll
      for (int kk = 0; kk < kMaxN / 16; ++kk) {
        if (16 * kk < npad) {
          uint32_t a[4];
          ldsm_x4(a, c_addr + 32 * kk);
#pragma unroll
          for (int u = 0; u < kMaxP / 8; ++u) {
            if (16 * (u / 2) < ppad) {
              const float* f = s_frag + 8 * u * kPitchN + 16 * kk;
              const float2 v0 = *reinterpret_cast<const float2*>(f);
              const float2 v1 = *reinterpret_cast<const float2*>(f + 8);
              uint32_t h0, l0, h1, l1;
              split_bf16(v0.x, v0.y, h0, l0);
              split_bf16(v1.x, v1.y, h1, l1);
              mma_bf16(acc[u], a, h0, h1);
              mma_bf16(acc[u], a, l0, l1);
            }
          }
        }
      }
      const float e0 = irow[0] < Q ? expf(acs_i[0]) : 0.f;
      const float e1 = irow[1] < Q ? expf(acs_i[1]) : 0.f;
#pragma unroll
      for (int u = 0; u < kMaxP / 8; ++u) {
        acc[u][0] *= e0;
        acc[u][1] *= e0;
        acc[u][2] *= e1;
        acc[u][3] *= e1;
      }
    }
    if (jt == 0) __syncthreads();  // the C rows are read: the next step may refill them
    if (k + 1 < n_steps) issue(k + 1);
    cp_async_commit();
    if (active) {
      // W.x over this column tile, up to the warp's last row.
      const uint32_t x_addr =
          smem_addr(stage_x(k & 1) + ld_row_a(lane) * kPitchP + ld_col_a(lane));
#pragma unroll
      for (int ks = 0; ks < kRows / 16; ++ks) {
        const int jc = j0 + 16 * ks;
        if (jc > i0 + r0 + 15 || jc >= Q) break;
        // A fragment: rows g, g+8 and columns 2 tig (+1), 2 tig + 8 (+1).
        uint32_t ah[4], al[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int half = q & 1, kh = q >> 1;
          const int i = irow[half], j = j0 + 16 * ks + 2 * tig + 8 * kh;
          const float2 sc = sc_cur[ks][q];
          // select, never multiply by a mask: exp may overflow for j > i
          float w0 = 0.f, w1 = 0.f;
          if (i < Q && j <= i) w0 = expf(acs_i[half] - sAcs[j]) * sc.x * sDt[j];
          if (i < Q && j + 1 <= i) w1 = expf(acs_i[half] - sAcs[j + 1]) * sc.y * sDt[j + 1];
          split_bf16(w0, w1, ah[q], al[q]);
        }
#pragma unroll
        for (int np = 0; np < kMaxP / 16; ++np) {
          if (16 * np < ppad) {
            uint32_t bb[4];
            ldsm_x4_trans(bb, x_addr + ks * 16 * kPitchP * 2 + 32 * np);
            mma_bf16(acc[2 * np], ah, bb[0], bb[1]);
            mma_bf16(acc[2 * np], al, bb[0], bb[1]);
            mma_bf16(acc[2 * np + 1], ah, bb[2], bb[3]);
            mma_bf16(acc[2 * np + 1], al, bb[2], bb[3]);
          }
        }
      }
    }
    if (jt == it && active) {  // the row tile is done: its y rows leave
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = irow[half];
        if (i >= Q) continue;
        bf16* yrow = y + ((row0 + i) * H + h) * static_cast<size_t>(P);
#pragma unroll
        for (int u = 0; u < kMaxP / 8; ++u) {
          const int p = 8 * u + 2 * tig;
          if (p < P) yrow[p] = __float2bfloat16_rn(acc[u][2 * half]);
          if (p + 1 < P) yrow[p + 1] = __float2bfloat16_rn(acc[u][2 * half + 1]);
        }
      }
    }
    __syncthreads();  // stage k & 1 is refilled by step k + 2
#pragma unroll
    for (int ks = 0; ks < kRows / 16; ++ks)
#pragma unroll
      for (int q = 0; q < 4; ++q) sc_cur[ks][q] = sc_next[ks][q];
  }
}

}  // namespace ssdtc

namespace {

// Rows of an operand copy in 16-byte pieces when its base is 16-byte
// aligned and its batch stride, row stride and width are multiples of 8.
bool rows_vec(const void* p, long long sb, long long ss, int width) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && sb % 8 == 0 && ss % 8 == 0 && width % 8 == 0;
}

// The bf16 route: four launches on one stream (scores, chunk states, state
// passing, outputs).  states (B, nc, H, P, N), decay (B, nc, H) and scores
// (B, nc, Qp, Qp) fp32 are the caller's scratch.  Returns the first error.
int launch_tc(int device, const void* x, const float* adt, const float* dt, const void* bm,
              const void* cm, const float* init_state, void* y, float* final_state,
              float* states, float* decay, float* scores, int B, int S, int H, int P, int N,
              int Q, int x_sb, int x_ss, int b_sb, int b_ss, int c_sb, int c_ss, void* stream) {
  using ssdtc::bf16;
  if (states == nullptr || decay == nullptr || scores == nullptr ||
      reinterpret_cast<uintptr_t>(scores) % 16 != 0 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const struct {
    const void* fn;
    unsigned smem;
  } kernels[] = {
      {reinterpret_cast<const void*>(ssdtc::ssd_scores_tc_kernel), ssdtc::kScoresSmem},
      {reinterpret_cast<const void*>(ssdtc::ssd_chunk_state_tc_kernel),
       ssdtc::scan_bytes(Q) + ssdtc::kStateTiles},
      {reinterpret_cast<const void*>(ssdtc::ssd_chunk_out_tc_kernel),
       ssdtc::scan_bytes(Q) + ssdtc::kOutTiles}};
  for (const auto& k : kernels) {
    err = cudaFuncSetAttribute(k.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(k.smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int vec = (rows_vec(x, x_sb, x_ss, P) ? ssdtc::kVecX : 0) |
                  (rows_vec(bm, b_sb, b_ss, N) ? ssdtc::kVecB : 0) |
                  (rows_vec(cm, c_sb, c_ss, N) ? ssdtc::kVecC : 0);
  const int nc = S / Q, nt = (Q + ssdtc::kRows - 1) / ssdtc::kRows;
  const auto* xb = static_cast<const bf16*>(x);
  const auto* bb = static_cast<const bf16*>(bm);
  const auto* cb = static_cast<const bf16*>(cm);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);

  ssdtc::ssd_scores_tc_kernel<<<dim3(nt * (nt + 1) / 2 * nc, B), ssdtc::kThreads,
                                ssdtc::kScoresSmem, st>>>(bb, cb, scores, S, N, Q, b_sb, b_ss,
                                                          c_sb, c_ss, vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ssdtc::ssd_chunk_state_tc_kernel<<<dim3(nc * H, B), ssdtc::kStateThreads, kernels[1].smem,
                                     st>>>(
      xb, adt, dt, bb, states, decay, S, H, P, N, Q, x_sb, x_ss, b_sb, b_ss, vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int pn = P * N;
  if (pn % 4 == 0)
    ssdtc::ssd_state_pass_kernel<4><<<dim3((pn / 4 + 255) / 256, H, B), 256, 0, st>>>(
        states, decay, init_state, final_state, nc, H, pn);
  else
    ssdtc::ssd_state_pass_kernel<1><<<dim3((pn + 255) / 256, H, B), 256, 0, st>>>(
        states, decay, init_state, final_state, nc, H, pn);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ssdtc::ssd_chunk_out_tc_kernel<<<dim3(H * nc, B), ssdtc::kThreads, kernels[2].smem, st>>>(
      xb, adt, dt, cb, states, scores, static_cast<bf16*>(y), S, H, P, N, Q, x_sb, x_ss, c_sb,
      c_ss, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype of x, B, C and y: 0 = float32 (the CUDA-core kernel, one launch),
// 1 = bfloat16 (the tensor-core passes, four launches, which need the fp32
// scratch states (B, nc, H, P, N), decay (B, nc, H) and scores
// (B, nc, Qp, Qp), Qp = chunk rounded up to 64; null for float32).
// init_state and final_state may be null (zero initial state; final state
// not written).  Strides are in elements.  Returns the first
// cudaGetLastError() after a launch that is not 0, else 0.
extern "C" int ssd_scan_fwd(int dtype, int device, const void* x,
                            const float* adt, const float* dt, const void* bm,
                            const void* cm, const float* init_state, void* y,
                            float* final_state, float* states, float* decay,
                            float* scores, int B, int S, int H, int P, int N,
                            int chunk, int x_sb, int x_ss, int b_sb, int b_ss,
                            int c_sb, int c_ss, void* stream) {
  if (B < 1 || S < 1 || H < 1 || P < 1 || P > kMaxP || N < 1 || N > kMaxN ||
      chunk < 1 || chunk > kMaxChunk || S % chunk != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch<float>(device, x, adt, dt, bm, cm, init_state, y, final_state,
                         B, S, H, P, N, chunk, x_sb, x_ss, b_sb, b_ss, c_sb,
                         c_ss, stream);
  if (dtype == 1)
    return launch_tc(device, x, adt, dt, bm, cm, init_state, y, final_state, states, decay,
                     scores, B, S, H, P, N, chunk, x_sb, x_ss, b_sb, b_ss, c_sb, c_ss,
                     stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* ssd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
