// Helpers shared by the kernels: 16-byte vector loads converted to f32,
// the f32 -> storage-type conversion (T is float or __nv_bfloat16), the
// tensor-core building blocks (cp.async, ldmatrix, mma.sync), and the bf16
// flash kernels' tile loads and P.V product.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

constexpr float NEG_INF = -1e30f;   // the reference's mask value
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// 16 bytes of T held in registers, converted to 16 / sizeof(T) floats.
template <typename T>
__device__ __forceinline__ void cvt16(const uint4& raw, float* dst);

template <>
__device__ __forceinline__ void cvt16<float>(const uint4& raw, float* dst) {
  dst[0] = __uint_as_float(raw.x);
  dst[1] = __uint_as_float(raw.y);
  dst[2] = __uint_as_float(raw.z);
  dst[3] = __uint_as_float(raw.w);
}

template <>
__device__ __forceinline__ void cvt16<__nv_bfloat16>(const uint4& raw,
                                                     float* dst) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

// One 16-byte read-only load; `src` must be 16-byte aligned.
template <typename T>
__device__ __forceinline__ uint4 ld16(const T* src) {
  return __ldg(reinterpret_cast<const uint4*>(src));
}

// One element of T widened to f32 (scalar loads of ragged tiles).
template <typename T>
__device__ __forceinline__ float to_float(T x);

template <>
__device__ __forceinline__ float to_float<float>(float x) { return x; }

template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);

template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }

template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);   // round to nearest even, as torch's .to()
}

// ---------------------------------------------------------------------------
// Tensor-core building blocks (sm_80+ PTX, used on sm_90a): 16-byte
// asynchronous copies into shared memory, ldmatrix and the bf16
// mma.sync.m16n8k16 with f32 accumulation.
//
// Fragment layouts of m16n8k16 for lane l (PTX ISA, "mma.m16n8k16"):
//   A 16x16: a[0] = (l/4, 2(l%4)+{0,1}), a[1] = row + 8, a[2] = col + 8,
//            a[3] = row + 8 and col + 8
//   B 16x8:  b[0] = (k 2(l%4)+{0,1}, n l/4), b[1] = k + 8
//   C 16x8:  c[0..1] = (l/4, 2(l%4)+{0,1}), c[2..3] = row + 8
// so the C tiles of two neighbouring n8 columns are, packed to bf16, the A
// fragment of one 16-deep slice (pack_a): a product's output feeds the
// next product from registers.
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, or 16 zero bytes where !live (`src` must
// still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(live ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared, or 4 zero bytes where !live.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool live) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(live ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices from shared memory; lane l gives the address of
// row l%8 of matrix l/8, and r[i] receives matrix i in the A/B fragment
// layout.  ldsm4_t transposes each matrix on the way.
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// c += a . b on the tensor cores: bf16 operands, f32 accumulation.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x by the SFU (ex2.approx.ftz: about 2 ulp; results below 2^-126 are 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two f32 -> one bf16x2 register (round to nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// The C tiles c[2kk], c[2kk+1] (16 rows x 16 columns) as the bf16 A
// fragment of one 16-deep slice.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// ---------------------------------------------------------------------------
// Tiles of the bf16 flash kernels (csrc/flash_fwd.cu, csrc/flash_bwd.cu),
// blocks of NT threads.  A row is one (query, group-head) pair of a
// (B, Sq, H, D) tensor, row = query * G + group-head; a key is one position
// of a (B, Sk, K, D) tensor.
// ---------------------------------------------------------------------------

// Rows of a bf16 tile in shared memory are D + 8 elements apart: the
// 16-byte pad puts the 8 rows one ldmatrix reads in 8 bank groups, as a
// row is an odd number of 16-byte units at every head dim taken (9, 11,
// 17 and 33 at D = 64, 80, 128, 256).
template <int D>
constexpr int PITCH = D + 8;

// cp.async of rows [row0, row0 + R) of a (B, Sq, H, D) tensor for kv head
// `kvh`; rows past `nrows` are zero.
template <int R, int D, int NT>
__device__ __forceinline__ void rows_async(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src, int b,
                                           int kvh, int row0, int nrows,
                                           int Sq, int H, int G) {
  constexpr int CPR = D / 8;    // 16-byte chunks per row
  static_assert(R * CPR % NT == 0, "whole chunks per thread");
#pragma unroll
  for (int i = 0; i < R * CPR / NT; ++i) {
    const int c = threadIdx.x + i * NT;
    const int r = c / CPR, ch = c % CPR;
    const int fr = row0 + r;
    const bool live = fr < nrows;
    const __nv_bfloat16* s =
        live ? src + (((size_t)b * Sq + fr / G) * H + kvh * G + fr % G) * D
                   + ch * 8
             : src;
    cp_async16(dst + r * PITCH<D> + ch * 8, s, live);
  }
}

// cp.async of keys [k0, k0 + R) of a (B, Sk, K, D) tensor for kv head
// `kvh`; keys past Sk are zero.
template <int R, int D, int NT>
__device__ __forceinline__ void keys_async(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src, int b,
                                           int kvh, int k0, int Sk, int K) {
  constexpr int CPR = D / 8;
  static_assert(R * CPR % NT == 0, "whole chunks per thread");
#pragma unroll
  for (int i = 0; i < R * CPR / NT; ++i) {
    const int c = threadIdx.x + i * NT;
    const int r = c / CPR, ch = c % CPR;
    const int key = k0 + r;
    const bool live = key < Sk;
    const __nv_bfloat16* s =
        live ? src + (((size_t)b * Sk + key) * K + kvh) * D + ch * 8 : src;
    cp_async16(dst + r * PITCH<D> + ch * 8, s, live);
  }
}

// c[n] += A . B over KB 16-deep slices, for all N / 8 n8 tiles of c: A in
// registers (the packed p or ds of the warp's 16 rows), B the first
// 16 * KB rows and N columns of a row-major (., D) tile in shared memory
// (N < D: a slice of the columns, Bm pointing at its first).
template <int D, int KB, int N = D>
__device__ __forceinline__ void mma_ab(float (&c)[N / 8][4],
                                       const uint32_t (&a)[KB][4],
                                       const __nv_bfloat16* Bm, int lane) {
  constexpr int P = PITCH<D>;
#pragma unroll
  for (int kk = 0; kk < KB; ++kk)
#pragma unroll
    for (int n = 0; n < N / 16; ++n) {
      uint32_t bm[4];
      ldsm4_t(bm, Bm + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * P
                      + n * 16 + (lane / 16) * 8);
      mma_bf16(c[2 * n], a[kk], bm[0], bm[1]);
      mma_bf16(c[2 * n + 1], a[kk], bm[2], bm[3]);
    }
}

}  // namespace repro
