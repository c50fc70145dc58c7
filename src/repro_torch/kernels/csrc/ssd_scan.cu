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
// state for its decode cache).  All arithmetic is fp32.
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
// peaks (989 TFLOP/s, 3.35 TB/s) bytes bound it at 0.035 ms.  This kernel
// is bound by neither: it runs every product on the CUDA cores in fp32
// (no tensor cores, no TF32), recomputes C.B^T for every head (B and C are
// shared by all heads: a lever for later), loads each tile with no
// overlap, and with one block per (b, h) walking its chunks in order it
// fills the card only when B*H >> 132 SMs (one long sequence runs 24
// blocks; a later design could compute the chunk states in parallel, scan
// them, then the outputs).  chip_smoke.py on an NVIDIA H100 80GB HBM3 at
// 700 W: 4.87 ms at (8, 2048), 38.7 ms at (1, 32768).
//
// What the design does.  One 256-thread block per (b, h); the loop over
// chunks takes the place of the TPU's sequential grid axis, and the state
// lives in shared memory for the whole sequence.  The TPU kernel holds the
// whole chunk in VMEM, with 256 x 256 score, decay and weight matrices --
// over 900 KB in fp32; a block may use 227 KB.  So the chunk is cut into
// 64-row tiles: for each tile of output rows i, the block computes the
// carried-state term C_i.state, then walks the column tiles j <= i (the
// causal half only), building the 64 x 64 scores C_i.B_j^T, the weights W in
// shared memory, and W.x_j.  Each thread keeps a 4 x 4 register micro-tile
// (4 x 8 for the state update), and the shared rows of N are padded by one
// float so the strided reads of a warp hit distinct banks (~134 KB in all).
// The decay exp(acs_i - acs_j) is computed only where j <= i and selected to
// 0 elsewhere: it may overflow there, and inf * 0 would be NaN.  Every
// output row's C_i.state is finished before a barrier, and only then does
// the state update write the state.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// dtype of x, B, C and y: 0 = float32, 1 = bfloat16.  init_state and
// final_state may be null (zero initial state; final state not written).
// Strides are in elements.  Returns cudaGetLastError() after the launch
// (0 = success).
extern "C" int ssd_scan_fwd(int dtype, int device, const void* x,
                            const float* adt, const float* dt, const void* bm,
                            const void* cm, const float* init_state, void* y,
                            float* final_state, int B, int S, int H, int P,
                            int N, int chunk, int x_sb, int x_ss, int b_sb,
                            int b_ss, int c_sb, int c_ss, void* stream) {
  if (B < 1 || S < 1 || H < 1 || P < 1 || P > kMaxP || N < 1 || N > kMaxN ||
      chunk < 1 || chunk > kMaxChunk || S % chunk != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch<float>(device, x, adt, dt, bm, cm, init_state, y, final_state,
                         B, S, H, P, N, chunk, x_sb, x_ss, b_sb, b_ss, c_sb,
                         c_ss, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(device, x, adt, dt, bm, cm, init_state, y,
                                 final_state, B, S, H, P, N, chunk, x_sb, x_ss,
                                 b_sb, b_ss, c_sb, c_ss, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* ssd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
