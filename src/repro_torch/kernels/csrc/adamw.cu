// Multi-tensor AdamW with global-norm clipping, for Hopper (sm_90a).
//
// Replaces no TPU kernel.  The JAX package's optimizer
// (repro/train/optimizer.py) is plain jnp over the leaves, which XLA fuses
// under jit into a few passes over the weights; eager PyTorch runs each op of
// the same code as a kernel of its own: ~30 launches a leaf, ~9,300 a
// Qwen3-0.6B step (311 leaves), each fp32 temporary a full pass over its leaf.
// These three kernels do the clip and the update of every leaf in a few
// launches, and read and write each byte once.
//
// What bounds it on the H100.  Bytes: the update reads p, g, m and v and
// writes p, m and v, and the clip's norm reads g once more -- 24 B a weight
// with bf16 weights and gradients and fp32 moments (18.05 GB, 5.39 ms at
// 3.35 TB/s for Qwen3-0.6B's 751.9 M weights), against ~30 FLOPs a weight,
// far below the card's ~295 FLOP/byte line.  So the design moves each byte
// once, in 16-byte vectors, and keeps every intermediate in registers.
//
// 1. adamw_sqnorm_kernel: the clip's sum of squares.  One 256-thread block a
//    chunk of `chunk` elements of one leaf (the host's plan, kernels/adamw.py,
//    gives each leaf its first block, `chunk0`; a block finds its leaf by a
//    binary search over the launch's table), fp32 accumulation over 16-byte
//    loads (8 bf16 or 2 x 4 fp32 a thread and step), a fixed shuffle tree and
//    one fp32 partial a block.  No float atomics, and a fixed mapping from
//    block to chunk: a run repeats bit for bit.
// 2. adamw_finish_kernel: one block sums the partials in a fixed order and
//    computes, in fp32 and in the plain version's order of operations
//    (train/optimizer.py), the pre-clip norm, the clip scale
//    min(max_norm * (1 / max(norm, 1e-9)), 1), the step counter + 1 (in
//    place), the cosine learning rate at that step and the bias corrections
//    1 - b1^t, 1 - b2^t, into five device scalars.  Nothing goes to the host.
// 3. adamw_update_kernel: per element, in fp32 registers:
//      g' = round_to_grad_dtype(g * scale)
//      m  = b1 m + (1 - b1) g'
//      v  = b2 v + (1 - b2) g'^2
//      p  = p - lr ((m / bc1) / (sqrt(v / bc2) + eps) + wd p)
//    each stored in its own dtype, with the plain version's roundings: every
//    operation is an explicit round-to-nearest intrinsic (no FMA
//    contraction, IEEE division and square root), so given the same norm
//    the kernel's p, m and v equal the plain version's bit for bit.
//
// The leaf table (the pointers of p, g, m, v, the element count and the
// first block, 48 B a leaf) travels as the launch's parameters, at most
// kMaxLeaves = 80 leaves (3,840 B, under the 4 KB limit) a launch; the
// gradients are new tensors every step, so the host builds the table anew
// each step and nothing is copied to the card for it.  Element counts and
// offsets are 64-bit (one expert slab of DeepSeek-V3 passes 2^31 elements).
// Dtypes are template parameters: weights and gradients fp32 or bf16, moments
// fp32 or bf16; the host groups a tree by dtypes, one launch a group.  A leaf
// whose four pointers are not 16-byte aligned (a view into a flat buffer) is
// walked one element at a time, by the same arithmetic.
//
// Every entry point returns cudaGetLastError() after its launch (0 when it
// succeeded); the wrapper raises on anything else.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFinishThreads = 1024;
constexpr int kVec = 8;  // elements a thread and step: 16 B of bf16
constexpr int kMaxLeaves = 80;
constexpr int kRowWords = 6;  // a host table row: p, g, m, v, n, chunk0

// Device scalars written by the finish kernel (kernels/adamw.py: SCALARS).
enum { kNorm = 0, kLr = 1, kScale = 2, kBc1 = 3, kBc2 = 4 };

struct Leaf {
  void* p;
  const void* g;
  void* m;
  void* v;
  long long n;       // elements
  long long chunk0;  // the leaf's first block in this launch
};

struct Leaves {
  Leaf leaf[kMaxLeaves];
  int count;
};

// The finish kernel's constants, as the plain version rounds them to fp32.
struct FinishHyper {
  float max_norm, lr, warmup, span, min_lr, cos_coef, pi, b1, b2;
};

struct UpdateHyper {
  float b1, c1, b2, c2, eps, wd;  // c1 = 1 - b1, c2 = 1 - b2
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T and widened again: the plain version's `.to(g.dtype)`.
template <typename T>
__device__ __forceinline__ float round_as(float x) { return to_f32(from_f32<T>(x)); }

__device__ __forceinline__ void load8(const float* src, float (&x)[kVec]) {
  const float4 a = reinterpret_cast<const float4*>(src)[0];
  const float4 b = reinterpret_cast<const float4*>(src)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* src, float (&x)[kVec]) {
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* dst, const float (&x)[kVec]) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(x[4], x[5], x[6], x[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* dst, const float (&x)[kVec]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i) h[i] = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
  *reinterpret_cast<uint4*>(dst) = u;
}

__device__ __forceinline__ bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

// torch.clamp's bounds, which pass NaN through.
__device__ __forceinline__ float clamp_min(float x, float lo) { return isnan(x) ? x : fmaxf(x, lo); }
__device__ __forceinline__ float clamp_max(float x, float hi) { return isnan(x) ? x : fminf(x, hi); }

// The sum over the block, in a fixed order; valid in thread 0.
template <int kN>
__device__ __forceinline__ float block_sum(float x) {
  __shared__ float warp_sums[kN / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = x;
  __syncthreads();
  x = 0.f;
  if (warp == 0) {
    x = lane < kN / 32 ? warp_sums[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
  }
  return x;
}

// The leaf of block b: the last one whose first block is at most b (the
// host's plan gives every leaf at least one block, in ascending order).
__device__ __forceinline__ const Leaf& leaf_of(const Leaves& table, long long b) {
  int lo = 0, hi = table.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (table.leaf[mid].chunk0 <= b) lo = mid;
    else hi = mid - 1;
  }
  return table.leaf[lo];
}

template <typename TG>
__global__ void __launch_bounds__(kThreads)
adamw_sqnorm_kernel(const __grid_constant__ Leaves table, const long long chunk,
                    float* __restrict__ partials) {
  const long long b = blockIdx.x;
  const Leaf& leaf = leaf_of(table, b);
  const long long start = (b - leaf.chunk0) * chunk;
  const long long len = leaf.n - start < chunk ? leaf.n - start : chunk;
  const TG* g = static_cast<const TG*>(leaf.g) + start;
  float acc = 0.f;
  long long done = 0;
  if (aligned16(leaf.g)) {
    const long long nvec = len / kVec;
#pragma unroll 4
    for (long long k = threadIdx.x; k < nvec; k += kThreads) {
      float x[kVec];
      load8(g + kVec * k, x);
#pragma unroll
      for (int j = 0; j < kVec; ++j) acc = fmaf(x[j], x[j], acc);
    }
    done = nvec * kVec;
  }
  for (long long e = done + threadIdx.x; e < len; e += kThreads) {
    const float x = to_f32(g[e]);
    acc = fmaf(x, x, acc);
  }
  acc = block_sum<kThreads>(acc);
  if (threadIdx.x == 0) partials[b] = acc;
}

__global__ void __launch_bounds__(kFinishThreads)
adamw_finish_kernel(const float* __restrict__ partials, const int n, int* __restrict__ step,
                    float* __restrict__ scalars, const FinishHyper h) {
  float acc = 0.f;
  for (int i = threadIdx.x; i < n; i += kFinishThreads) acc += partials[i];
  acc = block_sum<kFinishThreads>(acc);
  if (threadIdx.x != 0) return;
  // clip_by_global_norm: the pre-clip norm, and max_norm / clamp(norm, 1e-9)
  // as torch evaluates it (the reciprocal, times max_norm), at most 1.
  const float norm = __fsqrt_rn(acc);
  const float scale = clamp_max(__fmul_rn(__frcp_rn(clamp_min(norm, 1e-9f)), h.max_norm), 1.f);
  // The step counter, then cosine_lr and the bias corrections at it.
  const int t = *step + 1;
  *step = t;
  const float tf = __int2float_rn(t);
  const float warm = __fdiv_rn(tf, h.warmup);
  const float progress = clamp_max(clamp_min(__fdiv_rn(__fsub_rn(tf, h.warmup), h.span), 0.f), 1.f);
  const float cosv = __fadd_rn(__fmul_rn(__fadd_rn(cosf(__fmul_rn(progress, h.pi)), 1.f), h.cos_coef),
                               h.min_lr);
  scalars[kNorm] = norm;
  scalars[kLr] = __fmul_rn(tf < h.warmup ? warm : cosv, h.lr);
  scalars[kScale] = scale;
  scalars[kBc1] = __fsub_rn(1.f, powf(h.b1, tf));
  scalars[kBc2] = __fsub_rn(1.f, powf(h.b2, tf));
}

struct StepScalars {
  float lr, scale, bc1, bc2;
};

// One element of the update, in the plain version's order of operations.
template <typename TG>
__device__ __forceinline__ void adamw_elem(float& p, float g, float& m, float& v,
                                           const StepScalars& s, const UpdateHyper& h) {
  g = round_as<TG>(__fmul_rn(g, s.scale));
  m = __fadd_rn(__fmul_rn(m, h.b1), __fmul_rn(g, h.c1));
  v = __fadd_rn(__fmul_rn(v, h.b2), __fmul_rn(__fmul_rn(g, g), h.c2));
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, s.bc2)), h.eps);
  const float delta = __fadd_rn(__fdiv_rn(__fdiv_rn(m, s.bc1), den), __fmul_rn(p, h.wd));
  p = __fsub_rn(p, __fmul_rn(s.lr, delta));
}

template <typename TP, typename TG, typename TM>
__global__ void __launch_bounds__(kThreads)
adamw_update_kernel(const __grid_constant__ Leaves table, const long long chunk,
                    const float* __restrict__ scalars, const UpdateHyper h) {
  const long long b = blockIdx.x;
  const Leaf& leaf = leaf_of(table, b);
  const long long start = (b - leaf.chunk0) * chunk;
  const long long len = leaf.n - start < chunk ? leaf.n - start : chunk;
  TP* p = static_cast<TP*>(leaf.p) + start;
  const TG* g = static_cast<const TG*>(leaf.g) + start;
  TM* m = static_cast<TM*>(leaf.m) + start;
  TM* v = static_cast<TM*>(leaf.v) + start;
  const StepScalars s{scalars[kLr], scalars[kScale], scalars[kBc1], scalars[kBc2]};
  long long done = 0;
  if (aligned16(leaf.p) && aligned16(leaf.g) && aligned16(leaf.m) && aligned16(leaf.v)) {
    const long long nvec = len / kVec;
#pragma unroll 2
    for (long long k = threadIdx.x; k < nvec; k += kThreads) {
      float xp[kVec], xg[kVec], xm[kVec], xv[kVec];
      load8(p + kVec * k, xp);
      load8(g + kVec * k, xg);
      load8(m + kVec * k, xm);
      load8(v + kVec * k, xv);
#pragma unroll
      for (int j = 0; j < kVec; ++j) adamw_elem<TG>(xp[j], xg[j], xm[j], xv[j], s, h);
      store8(p + kVec * k, xp);
      store8(m + kVec * k, xm);
      store8(v + kVec * k, xv);
    }
    done = nvec * kVec;
  }
  for (long long e = done + threadIdx.x; e < len; e += kThreads) {
    float xp = to_f32(p[e]), xm = to_f32(m[e]), xv = to_f32(v[e]);
    adamw_elem<TG>(xp, to_f32(g[e]), xm, xv, s, h);
    p[e] = from_f32<TP>(xp);
    m[e] = from_f32<TM>(xm);
    v[e] = from_f32<TM>(xv);
  }
}

// The launch's table from the host's rows; false when the launch is not one
// the kernels take.
bool read_table(const long long* rows, int n_leaves, int n_blocks, long long chunk, Leaves* table) {
  if (n_leaves < 1 || n_leaves > kMaxLeaves || n_blocks < 1 || chunk < kVec || chunk % kVec != 0)
    return false;
  for (int i = 0; i < n_leaves; ++i) {
    const long long* row = rows + static_cast<size_t>(i) * kRowWords;
    Leaf& leaf = table->leaf[i];
    leaf.p = reinterpret_cast<void*>(static_cast<uintptr_t>(row[0]));
    leaf.g = reinterpret_cast<const void*>(static_cast<uintptr_t>(row[1]));
    leaf.m = reinterpret_cast<void*>(static_cast<uintptr_t>(row[2]));
    leaf.v = reinterpret_cast<void*>(static_cast<uintptr_t>(row[3]));
    leaf.n = row[4];
    leaf.chunk0 = row[5];
    if (leaf.n < 1 || leaf.chunk0 < 0 || leaf.chunk0 >= n_blocks) return false;
  }
  table->count = n_leaves;
  return true;
}

template <typename TP, typename TG, typename TM>
int launch_update(const Leaves& table, int n_blocks, long long chunk, const float* scalars,
                  const UpdateHyper& h, cudaStream_t stream) {
  adamw_update_kernel<TP, TG, TM><<<n_blocks, kThreads, 0, stream>>>(table, chunk, scalars, h);
  return static_cast<int>(cudaGetLastError());
}

template <typename TP, typename TG>
int update_by_moments(int m_dtype, const Leaves& table, int n_blocks, long long chunk,
                      const float* scalars, const UpdateHyper& h, cudaStream_t stream) {
  if (m_dtype == 0) return launch_update<TP, TG, float>(table, n_blocks, chunk, scalars, h, stream);
  if (m_dtype == 1)
    return launch_update<TP, TG, __nv_bfloat16>(table, n_blocks, chunk, scalars, h, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename TP>
int update_by_grads(int g_dtype, int m_dtype, const Leaves& table, int n_blocks, long long chunk,
                    const float* scalars, const UpdateHyper& h, cudaStream_t stream) {
  if (g_dtype == 0)
    return update_by_moments<TP, float>(m_dtype, table, n_blocks, chunk, scalars, h, stream);
  if (g_dtype == 1)
    return update_by_moments<TP, __nv_bfloat16>(m_dtype, table, n_blocks, chunk, scalars, h, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16.  `rows` is the host table of the
// launch: n_leaves rows of (p, g, m, v, elements, first block), as int64.

extern "C" int adamw_sqnorm(int g_dtype, int device, const long long* rows, int n_leaves,
                            int n_blocks, long long chunk, float* partials, void* stream) {
  Leaves table;
  if (!read_table(rows, n_leaves, n_blocks, chunk, &table))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (g_dtype == 0)
    adamw_sqnorm_kernel<float><<<n_blocks, kThreads, 0, st>>>(table, chunk, partials);
  else if (g_dtype == 1)
    adamw_sqnorm_kernel<__nv_bfloat16><<<n_blocks, kThreads, 0, st>>>(table, chunk, partials);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// hyper: max_norm, lr, warmup, span, min_lr, cos_coef, pi, b1, b2 (fp32).
extern "C" int adamw_finish(int device, const float* partials, int n_partials, int* step,
                            float* scalars, const float* hyper, void* stream) {
  if (n_partials < 0) return static_cast<int>(cudaErrorInvalidValue);
  const FinishHyper h{hyper[0], hyper[1], hyper[2], hyper[3], hyper[4],
                      hyper[5], hyper[6], hyper[7], hyper[8]};
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  adamw_finish_kernel<<<1, kFinishThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      partials, n_partials, step, scalars, h);
  return static_cast<int>(cudaGetLastError());
}

// hyper: b1, 1 - b1, b2, 1 - b2, eps, weight decay (fp32).
extern "C" int adamw_update(int p_dtype, int g_dtype, int m_dtype, int device,
                            const long long* rows, int n_leaves, int n_blocks, long long chunk,
                            const float* scalars, const float* hyper, void* stream) {
  Leaves table;
  if (!read_table(rows, n_leaves, n_blocks, chunk, &table))
    return static_cast<int>(cudaErrorInvalidValue);
  const UpdateHyper h{hyper[0], hyper[1], hyper[2], hyper[3], hyper[4], hyper[5]};
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p_dtype == 0)
    return update_by_grads<float>(g_dtype, m_dtype, table, n_blocks, chunk, scalars, h, st);
  if (p_dtype == 1)
    return update_by_grads<__nv_bfloat16>(g_dtype, m_dtype, table, n_blocks, chunk, scalars, h, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* adamw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
