// Tensor-core helpers shared by the bf16 flash-attention kernels on Hopper
// (sm_90a): the forward pair in flash_fwd.cu and the dQ and dK/dV pairs in
// flash_bwd.cu.  cp.async copies into shared memory, ldmatrix fragment loads,
// mma.sync.m16n8k16 (bf16 in, fp32 sum), bf16 packing, the per-warp
// segment-range reduction of the _block_live rule, and the kv ring and dense
// walk of the q-stationary kernels.
//
// Shared tiles hold one row per token, D rounded up to the MMA depth (16)
// plus 8 bf16 of padding: the row pitch is then 4 banks modulo 32, so the
// eight 16-byte rows of one ldmatrix matrix hit eight distinct bank quads.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tc {

constexpr int kSegBig = 1 << 30;  // "no positive segment id" sentinel
constexpr int kTileRows = 128;    // rows of a pinned or moving tile: a whole block
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ __forceinline__ int padded_dim(int D) { return (D + 15) & ~15; }
__host__ __device__ __forceinline__ int pitch(int D) { return padded_dim(D) + 8; }

// The kernels copy rows in 16-byte pieces: D % 8 == 0 and every operand
// 16-byte aligned (the wrappers check both and raise first).
template <int N>
inline bool rows_copyable(const void* const (&ptrs)[N], int D) {
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  return D % 8 == 0;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most one committed group (the one just issued) is in flight.
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// d += a (16 x 16, row-major) . b (16 x 8, column-major): bf16 in, fp32 sum.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two fp32 values rounded to nearest bf16, x in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// (x, y) as two bf16 pairs whose sum carries 16 mantissa bits: hi rounds
// (x, y) to nearest, lo rounds what hi left over.
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(__fsub_rn(x, hf.x), __fsub_rn(y, hf.y));
}

// (lo, hi) of the positive segment ids of `n` positions, reduced over the
// warp (lo = kSegBig when there is none): every lane gets the same result.
__device__ __forceinline__ void warp_seg_range(const int* __restrict__ ids, int n, int& lo,
                                               int& hi) {
  int l = kSegBig, h = 0;
  for (int i = threadIdx.x % 32; i < n; i += 32) {
    const int id = ids[i];
    h = max(h, id);
    if (id > 0) l = min(l, id);
  }
  lo = __reduce_min_sync(0xffffffffu, l);
  hi = __reduce_max_sync(0xffffffffu, h);
}

// The kv side of the q-stationary kernels (the forward and the dQ pass):
// `pinned` tiles of the q block's rows, then two ring stages of stage_bytes
// each, which carry a live kv tile's k rows, v rows and segment ids.
struct KvRingLayout {
  unsigned tile, ring, v, seg, stage_bytes, total;
};

__host__ __device__ __forceinline__ KvRingLayout kv_ring_layout(int D, int pinned) {
  KvRingLayout L;
  L.tile = kTileRows * pitch(D) * 2;
  L.ring = pinned * L.tile;
  L.v = L.tile;  // within a stage; the k rows start at 0
  L.seg = 2 * L.tile;
  L.stage_bytes = L.seg + kTileRows * 4;
  L.total = L.ring + 2 * L.stage_bytes;
  return L;
}

// cp.async one kv tile into the ring stage at `base`: bkv rows of one kv
// head's k and v (the first at k + off, v + off, rows kv_stride apart) and,
// unless `seg_rows` is null, their bkv segment ids.
__device__ __forceinline__ void copy_kv_tile(unsigned char* base, const KvRingLayout& L,
                                             const __nv_bfloat16* __restrict__ k,
                                             const __nv_bfloat16* __restrict__ v, size_t off,
                                             size_t kv_stride, const int* __restrict__ seg_rows,
                                             int bkv, int D) {
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(base);
  __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(base + L.v);
  const int d8 = D / 8, pitch_ = pitch(D);
  for (int idx = threadIdx.x; idx < bkv * d8; idx += blockDim.x) {
    const int r = idx / d8, c = (idx - r * d8) * 8;
    cp_async16(ks + r * pitch_ + c, k + off + r * kv_stride + c);
    cp_async16(vs + r * pitch_ + c, v + off + r * kv_stride + c);
  }
  if (seg_rows != nullptr)
    for (int i = threadIdx.x; i < bkv; i += blockDim.x)
      cp_async4(reinterpret_cast<int*>(base + L.seg) + i, seg_rows + i);
}

// The dense q-stationary walk: the first kv block at or after t that the
// _block_live rule keeps for the pinned q block [q0, q0 + bq), whose
// positive segment ids span [q_lo, q_hi]; n_steps when none is left.
// seg_row is the batch row's segment ids, or null (no segment mask).  Each
// warp reduces the kv block's range itself, so no thread waits on another.
__device__ __forceinline__ int next_live_kv(int t, int n_steps, int q0, int bq, int bkv,
                                            bool causal, const int* __restrict__ seg_row,
                                            int q_lo, int q_hi) {
  for (; t < n_steps; ++t) {
    const int k0 = t * bkv;
    bool ok = !causal || q0 + bq - 1 >= k0;
    if (ok && seg_row != nullptr) {
      int k_lo, k_hi;
      warp_seg_range(seg_row + k0, bkv, k_lo, k_hi);
      ok = q_hi > 0 && k_hi > 0 && q_hi >= k_lo && k_hi >= q_lo;
    }
    if (ok) break;
  }
  return t;
}

}  // namespace tc
