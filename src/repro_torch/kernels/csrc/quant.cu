// Per-block symmetric int8 quantize and dequantize.
//
// Replaces repro/kernels/quant/quant.py::_quant_kernel and ::_dequant_kernel.
// Wrapper and plain PyTorch version: repro_torch/kernels/quant/quant.py.
//
// For each block b of `block` elements of x (f32 or bf16, read as f32):
//   s[b] = max(max|x_b| / 127, 1e-30)
//   q_b  = clip(round(x_b / s[b]), -127, 127) as int8
// and the inverse x_b = q_b * s[b].  The numbers are the reference kernel's
// as XLA runs it (interpret mode), bit for bit: the max is exact in any order
// and propagates a NaN (as jnp.max does; fmaxf would drop it); `/ 127` is a
// product with the f32 constant 1/127, as XLA rewrites a division by a
// constant; x / s is an IEEE division (__fdiv_rn); rounding is rintf (half to
// even, as jnp.round); the clip comes before the cast; a NaN quotient becomes
// 0, as XLA's float-to-int conversion makes it.
//
// What bounds it on an H100: bytes.  Quantize reads 4 (or 2) bytes and writes
// 1 per element, dequantize the reverse, for a handful of operations each.
// On the TPU the grid walks the blocks in order with one block in VMEM.  Here
// two cases:
//  - small blocks (the reference's default 256, up to SMALL_BLOCK): one warp
//    per block reads it twice, once for the abs-max (warp shuffles) and once
//    to write q; the second read hits L1/L2.
//  - large blocks (the gradient compressor's per-tensor case, up to 2.5e8
//    elements): one CTA cannot stream a block at the card's rate, and blocks
//    cannot carry a sum across the grid.  Pass 1 cuts each block into `parts`
//    slices and writes one abs-max partial per (block, slice); pass 2 has
//    each CTA reduce its block's partials to s (the same value in every CTA,
//    since max is exact) and quantize its slice, and slice 0 writes s[b].
//    No atomics: the result is deterministic.
// Accesses are 4 elements wide (16 bytes of f32) where the block and the
// pointers allow it, else scalar.

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int NT = 256;               // threads per CTA
constexpr long long SMALL_BLOCK = 4096;

// max that keeps a NaN from either side (jnp.max / torch.amax semantics)
__device__ __forceinline__ float nanmax(float a, float b) {
  return (a != a || a > b) ? a : b;
}

__device__ __forceinline__ float warp_nanmax(float m) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = nanmax(m, __shfl_xor_sync(0xffffffffu, m, off));
  return m;
}

// the reference's scale from a block's abs-max
__device__ __forceinline__ float scale_of(float amax) {
  const float s = amax * (1.f / 127.f);     // XLA's `amax / 127`
  return s < 1e-30f ? 1e-30f : s;     // a NaN compares false and stays
}

__device__ __forceinline__ signed char quant1(float x, float s) {
  const float v = rintf(__fdiv_rn(x, s));
  if (v != v) return 0;               // NaN -> 0, as XLA converts it
  return static_cast<signed char>(static_cast<int>(fminf(fmaxf(v, -127.f),
                                                         127.f)));
}

template <typename T, int VEC>
__device__ __forceinline__ void load(const T* p, float* v);

template <>
__device__ __forceinline__ void load<float, 1>(const float* p, float* v) {
  v[0] = p[0];
}

template <>
__device__ __forceinline__ void load<__nv_bfloat16, 1>(const __nv_bfloat16* p,
                                                       float* v) {
  v[0] = __bfloat162float(p[0]);
}

template <>
__device__ __forceinline__ void load<float, 4>(const float* p, float* v) {
  const float4 r = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = r.x;
  v[1] = r.y;
  v[2] = r.z;
  v[3] = r.w;
}

template <>
__device__ __forceinline__ void load<__nv_bfloat16, 4>(const __nv_bfloat16* p,
                                                       float* v) {
  const uint2 r = __ldg(reinterpret_cast<const uint2*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
  const float2 a = __bfloat1622float2(h[0]);
  const float2 b = __bfloat1622float2(h[1]);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}

template <int VEC>
__device__ __forceinline__ void store_q(signed char* q, const float* v,
                                        float s) {
  if constexpr (VEC == 4) {
    char4 c;
    c.x = quant1(v[0], s);
    c.y = quant1(v[1], s);
    c.z = quant1(v[2], s);
    c.w = quant1(v[3], s);
    *reinterpret_cast<char4*>(q) = c;
  } else {
    q[0] = quant1(v[0], s);
  }
}

// One warp per block: abs-max, then q; lane 0 writes s.
template <typename T, int VEC>
__global__ void quant_small_kernel(const T* __restrict__ x,
                                   signed char* __restrict__ q,
                                   float* __restrict__ s, long long nb,
                                   int block) {
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * (NT / 32);
  for (long long b = blockIdx.x * (long long)(NT / 32) + threadIdx.x / 32;
       b < nb; b += warps) {
    const T* xb = x + b * block;
    signed char* qb = q + b * block;
    float m = 0.f;
    for (int i = lane * VEC; i < block; i += 32 * VEC) {
      float v[VEC];
      load<T, VEC>(xb + i, v);
#pragma unroll
      for (int e = 0; e < VEC; ++e) m = nanmax(m, fabsf(v[e]));
    }
    const float sc = scale_of(warp_nanmax(m));
    for (int i = lane * VEC; i < block; i += 32 * VEC) {
      float v[VEC];
      load<T, VEC>(xb + i, v);
      store_q<VEC>(qb + i, v, sc);
    }
    if (lane == 0) s[b] = sc;
  }
}

// CTA-wide NaN-propagating max; every thread gets the result.
__device__ float cta_nanmax(float m, float* red) {
  m = warp_nanmax(m);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x / 32] = m;
  __syncthreads();
  m = threadIdx.x < NT / 32 ? red[threadIdx.x] : 0.f;
  m = warp_nanmax(m);
  if (threadIdx.x == 0) red[0] = m;
  __syncthreads();
  m = red[0];
  __syncthreads();
  return m;
}

// The slice [lo, hi) of block b that CTA `part` owns; `chunk` is a multiple
// of VEC, so every slice starts aligned.
__device__ __forceinline__ void slice_of(long long block, long long chunk,
                                         int part, long long* lo,
                                         long long* hi) {
  *lo = part * chunk;
  *hi = min(block, *lo + chunk);
}

// Pass 1: partial[b * parts + part] = max |x| over the slice.
template <typename T, int VEC>
__global__ void absmax_partial_kernel(const T* __restrict__ x,
                                      float* __restrict__ partial,
                                      long long block, long long chunk,
                                      int parts) {
  __shared__ float red[NT / 32];
  const long long b = blockIdx.x / parts;
  long long lo, hi;
  slice_of(block, chunk, blockIdx.x % parts, &lo, &hi);
  const T* xb = x + b * block;
  float m = 0.f;
  for (long long i = lo + threadIdx.x * VEC; i < hi; i += NT * VEC) {
    float v[VEC];
    load<T, VEC>(xb + i, v);
#pragma unroll
    for (int e = 0; e < VEC; ++e) m = nanmax(m, fabsf(v[e]));
  }
  m = cta_nanmax(m, red);
  if (threadIdx.x == 0) partial[blockIdx.x] = m;
}

// Pass 2: s from the block's partials, then q over the slice.
template <typename T, int VEC>
__global__ void quant_large_kernel(const T* __restrict__ x,
                                   signed char* __restrict__ q,
                                   float* __restrict__ s,
                                   const float* __restrict__ partial,
                                   long long block, long long chunk,
                                   int parts) {
  __shared__ float red[NT / 32];
  const long long b = blockIdx.x / parts;
  const int part = blockIdx.x % parts;
  float m = 0.f;
  for (int i = threadIdx.x; i < parts; i += NT)
    m = nanmax(m, partial[b * parts + i]);
  const float sc = scale_of(cta_nanmax(m, red));
  long long lo, hi;
  slice_of(block, chunk, part, &lo, &hi);
  const T* xb = x + b * block;
  signed char* qb = q + b * block;
  for (long long i = lo + threadIdx.x * VEC; i < hi; i += NT * VEC) {
    float v[VEC];
    load<T, VEC>(xb + i, v);
    store_q<VEC>(qb + i, v, sc);
  }
  if (part == 0 && threadIdx.x == 0) s[b] = sc;
}

template <int VEC>
__global__ void dequant_kernel(const signed char* __restrict__ q,
                               const float* __restrict__ s,
                               float* __restrict__ x, long long n_vec,
                               long long block) {
  const long long stride = (long long)gridDim.x * NT;
  for (long long i = blockIdx.x * (long long)NT + threadIdx.x; i < n_vec;
       i += stride) {
    const long long e0 = i * VEC;
    const float sc = s[e0 / block];   // a vector never straddles two blocks
    if constexpr (VEC == 4) {
      const char4 c = __ldg(reinterpret_cast<const char4*>(q) + i);
      reinterpret_cast<float4*>(x)[i] =
          make_float4(c.x * sc, c.y * sc, c.z * sc, c.w * sc);
    } else {
      x[i] = q[i] * sc;
    }
  }
}

int grid_for(long long work, int sms) {
  const long long want = (work + NT - 1) / NT;
  return (int)std::max(1LL, std::min(want, (long long)sms * 16));
}

template <typename T, int VEC>
cudaError_t quant_launch(const T* x, signed char* q, float* s,
                         float* partial, long long T_, long long block,
                         int parts, int sms, cudaStream_t st) {
  const long long nb = T_ / block;
  if (block <= SMALL_BLOCK) {
    const long long ctas = (nb + NT / 32 - 1) / (NT / 32);
    const int grid = (int)std::min(ctas, (long long)sms * 32);
    quant_small_kernel<T, VEC><<<grid, NT, 0, st>>>(x, q, s, nb, (int)block);
    return cudaGetLastError();
  }
  if (nb * parts > 0x7fffffffLL) return cudaErrorInvalidValue;
  long long chunk = (block + parts - 1) / parts;
  chunk = (chunk + VEC - 1) / VEC * VEC;
  const unsigned grid = (unsigned)(nb * parts);   // (block, slice) pairs
  absmax_partial_kernel<T, VEC><<<grid, NT, 0, st>>>(x, partial, block, chunk,
                                                    parts);
  cudaError_t err = cudaGetLastError();
  if (err) return err;
  quant_large_kernel<T, VEC><<<grid, NT, 0, st>>>(x, q, s, partial, block,
                                                 chunk, parts);
  return cudaGetLastError();
}

template <typename T>
cudaError_t quant_dispatch(const void* x, signed char* q, float* s,
                           float* partial, long long T_, long long block,
                           int parts, int sms, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const bool vec = block % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % (4 * sizeof(T)) == 0 &&
                   reinterpret_cast<uintptr_t>(q) % 4 == 0;
  if (vec)
    return quant_launch<T, 4>(xt, q, s, partial, T_, block, parts, sms, st);
  return quant_launch<T, 1>(xt, q, s, partial, T_, block, parts, sms, st);
}

}  // namespace

// x (T,) f32 (is_bf16 = 0) or bf16 (1), contiguous -> q (T,) int8, s
// (T / block,) f32.  `partial` holds (T / block) * parts floats, used when
// block > 4096 (pass 1's abs-max per slice); `parts` slices per block, at
// least 1.  `sms` sizes the grids.  Returns the launches' cudaError_t.
extern "C" int repro_quant(const void* x, signed char* q, float* s,
                           float* partial, long long T, long long block,
                           int parts, int is_bf16, int sms, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (T <= 0 || block <= 0 || T % block || parts < 1 || sms < 1)
    return cudaErrorInvalidValue;
  if (is_bf16)
    return quant_dispatch<__nv_bfloat16>(x, q, s, partial, T, block, parts,
                                         sms, st);
  return quant_dispatch<float>(x, q, s, partial, T, block, parts, sms, st);
}

// q (T,) int8, s (T / block,) f32 -> x (T,) f32 = q * s[i / block].
extern "C" int repro_dequant(const signed char* q, const float* s, float* x,
                             long long T, long long block, int sms,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (T <= 0 || block <= 0 || T % block || sms < 1)
    return cudaErrorInvalidValue;
  const bool vec = block % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(q) % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (vec) {
    dequant_kernel<4><<<grid_for(T / 4, sms), NT, 0, st>>>(q, s, x, T / 4,
                                                          block);
  } else {
    dequant_kernel<1><<<grid_for(T, sms), NT, 0, st>>>(q, s, x, T, block);
  }
  return cudaGetLastError();
}
