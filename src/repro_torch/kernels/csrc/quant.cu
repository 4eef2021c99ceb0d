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
//    No atomics: the result is deterministic.  Each thread keeps two
//    16-byte loads in flight, and pass 2 walks each slice from the top
//    down, where pass 1 ended, so that its last reads are still in L2.
// Accesses are 4 elements wide (16 bytes of f32) where the block and the
// pointers allow it, else scalar.
//
// The gradient compressor's error-feedback encode (repro_ef_absmax,
// repro_ef_requant, repro_ef_decode below) is the same arithmetic at one
// block per tensor, split around the compressor's two collectives so that
// each pass reads what it needs once.

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
// Both passes run 8 CTAs an SM (CTAS_PER_SM in the wrapper): 32 registers.
template <typename T, int VEC>
__global__ void __launch_bounds__(NT, 8)
    absmax_partial_kernel(const T* __restrict__ x,
                          float* __restrict__ partial, long long block,
                          long long chunk, int parts) {
  __shared__ float red[NT / 32];
  const long long b = blockIdx.x / parts;
  long long lo, hi;
  slice_of(block, chunk, blockIdx.x % parts, &lo, &hi);
  const T* xb = x + b * block;
  float m = 0.f;
  // two independent loads in flight per thread and iteration
  for (long long i = lo + threadIdx.x * VEC; i < hi; i += 2 * NT * VEC) {
    float v[VEC], w[VEC] = {};
    load<T, VEC>(xb + i, v);
    if (i + NT * VEC < hi) load<T, VEC>(xb + i + NT * VEC, w);
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      m = nanmax(nanmax(m, fabsf(v[e])), fabsf(w[e]));
  }
  m = cta_nanmax(m, red);
  if (threadIdx.x == 0) partial[blockIdx.x] = m;
}

// Pass 2: s from the block's partials, then q over the slice.
template <typename T, int VEC>
__global__ void __launch_bounds__(NT, 8)
    quant_large_kernel(const T* __restrict__ x, signed char* __restrict__ q,
                       float* __restrict__ s,
                       const float* __restrict__ partial, long long block,
                       long long chunk, int parts) {
  __shared__ float red[NT / 32];
  const long long b = blockIdx.x / parts;
  const int part = blockIdx.x % parts;
  float m = 0.f;
  for (int i = threadIdx.x; i < parts; i += NT)
    m = nanmax(m, partial[b * parts + i]);
  const float sc = scale_of(cta_nanmax(m, red));
  long long lo, hi;
  slice_of(block, chunk, part, &lo, &hi);
  const T* xb = x + b * block + lo;
  signed char* qb = q + b * block + lo;
  // the slice's vectors from the top down, two loads in flight a thread:
  // pass 1 read the top of each slice last, so that part is still in L2
  const long long nv = (hi - lo) / VEC;
  for (long long k = threadIdx.x; k < nv; k += 2 * NT) {
    const long long u = (nv - 1 - k) * VEC, u2 = u - NT * VEC;
    const bool two = k + NT < nv;
    float v[VEC], w[VEC];
    load<T, VEC>(xb + u, v);
    if (two) load<T, VEC>(xb + u2, w);
    store_q<VEC>(qb + u, v, sc);
    if (two) store_q<VEC>(qb + u2, w, sc);
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

// ---------------------------------------------------------------------------
// The error-feedback encode of the gradient compressor
// (optim/grad_compress.py::compressed_psum), one gradient leaf of n elements
// per call; wrappers and plain versions: kernels/quant/quant.py::ef_*.  It
// is quantize's arithmetic (repro/kernels/quant/quant.py:22) at one block
// per tensor and dequantize's, with the passes around them that the
// reference's jnp encode (repro/optim/grad_compress.py) has XLA fuse:
//
//   K1 ef_absmax   s = scale_of(max |x + err|)            reads x, err (8 B)
//      MAX all-reduce of s over the group -> smax       (NCCL, outside)
//   K2 ef_requant  xf = x + err, q = quant1(xf, s), deq = q*s,
//                  q2 = clip(rint(deq / smax), +-127), a NaN -> 0,
//                  err <- ((xf - deq) + deq) - q2*smax, q2 as int32
//                                          reads x, err; writes err, q2 (16 B)
//      SUM all-reduce of q2 -> total                    (NCCL, outside)
//   K3 ef_decode   g <- total*smax [/ world], in g's dtype  (8 B)
//
// What bounds it on an H100: bytes, 32 per element (the eager passes it
// replaces moved ~150).  A per-tensor scale needs the max over the whole
// leaf (up to 1 GB) before the first q, so the max is taken in the pass
// that must read x and err anyway, and K2 recomputes xf rather than store
// it.  K1 writes one partial per CTA and, with more than one CTA, a
// one-CTA launch reduces them (the max is exact: the result does not
// depend on the order; no atomics).  K2 walks the elements from the top
// down, so the last tens of MB that K1 read are still in L2 when it starts,
// and K3 from the bottom up, where K2 ended.
//
// Every operation rounds as the eager path's torch ops on the card do, so
// the two are equal bit for bit: __fadd_rn / __fsub_rn / __fmul_rn keep
// nvcc from contracting x - q*s into one FMA; both divisions are IEEE
// (__fdiv_rn: torch's CUDA division by a 0-d CUDA tensor divides); rintf
// rounds half to even as torch.round; the clip comes before the cast; the
// f32 -> bf16 store is __float2bfloat16, torch's own conversion on sm_80+.
// err may be null (no carried error: xf = x) and may alias err_out (the
// same thread reads an element, then writes it), so neither is __restrict__.
// ---------------------------------------------------------------------------

namespace {

// xf = x (+ err) for VEC elements starting at vector i.
template <typename T, int VEC>
__device__ __forceinline__ void load_xf(const T* x, const float* err,
                                        long long i, float* v) {
  load<T, VEC>(x + i * VEC, v);
  if (err == nullptr) return;
  float e[VEC];
  if constexpr (VEC == 4) {
    const float4 r = reinterpret_cast<const float4*>(err)[i];
    e[0] = r.x;
    e[1] = r.y;
    e[2] = r.z;
    e[3] = r.w;
  } else {
    e[0] = err[i];
  }
#pragma unroll
  for (int k = 0; k < VEC; ++k) v[k] = __fadd_rn(v[k], e[k]);
}

// K1: the CTA's abs-max of xf over a grid-stride share; one CTA writes s.
template <typename T, int VEC>
__global__ void __launch_bounds__(NT)
    ef_absmax_kernel(const T* __restrict__ x, const float* err,
                     float* __restrict__ partial, float* __restrict__ s,
                     long long n_vec) {
  __shared__ float red[NT / 32];
  const long long stride = (long long)gridDim.x * NT;
  float m = 0.f;
  for (long long i = blockIdx.x * (long long)NT + threadIdx.x; i < n_vec;
       i += stride) {
    float v[VEC];
    load_xf<T, VEC>(x, err, i, v);
#pragma unroll
    for (int k = 0; k < VEC; ++k) m = nanmax(m, fabsf(v[k]));
  }
  m = cta_nanmax(m, red);
  if (threadIdx.x == 0) {
    if (gridDim.x == 1)
      s[0] = scale_of(m);
    else
      partial[blockIdx.x] = m;
  }
}

__global__ void __launch_bounds__(NT)
    ef_absmax_final_kernel(const float* __restrict__ partial,
                           float* __restrict__ s, int parts) {
  __shared__ float red[NT / 32];
  float m = 0.f;
  for (int i = threadIdx.x; i < parts; i += NT) m = nanmax(m, partial[i]);
  m = cta_nanmax(m, red);
  if (threadIdx.x == 0) s[0] = scale_of(m);
}

// K2: requantize against smax, the int32 wire value and the new error.
template <typename T, int VEC>
__global__ void __launch_bounds__(NT)
    ef_requant_kernel(const T* __restrict__ x, const float* err,
                      float* err_out, int* __restrict__ q2,
                      const float* __restrict__ s,
                      const float* __restrict__ smax, long long n_vec) {
  const float sc = *s, sm = *smax;
  const long long stride = (long long)gridDim.x * NT;
  for (long long k = blockIdx.x * (long long)NT + threadIdx.x; k < n_vec;
       k += stride) {
    const long long i = n_vec - 1 - k;           // top down
    float v[VEC], e[VEC];
    int w[VEC];
    load_xf<T, VEC>(x, err, i, v);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float deq = __fmul_rn(static_cast<float>(quant1(v[j], sc)), sc);
      const float r = rintf(__fdiv_rn(deq, sm));
      w[j] = r != r ? 0 : static_cast<int>(fminf(fmaxf(r, -127.f), 127.f));
      e[j] = __fsub_rn(__fadd_rn(__fsub_rn(v[j], deq), deq),
                       __fmul_rn(static_cast<float>(w[j]), sm));
    }
    if constexpr (VEC == 4) {
      reinterpret_cast<int4*>(q2)[i] = make_int4(w[0], w[1], w[2], w[3]);
      reinterpret_cast<float4*>(err_out)[i] =
          make_float4(e[0], e[1], e[2], e[3]);
    } else {
      q2[i] = w[0];
      err_out[i] = e[0];
    }
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_out(T* out, long long i,
                                          const float* v);

template <>
__device__ __forceinline__ void store_out<float, 1>(float* out, long long i,
                                                    const float* v) {
  out[i] = v[0];
}

template <>
__device__ __forceinline__ void store_out<float, 4>(float* out, long long i,
                                                    const float* v) {
  reinterpret_cast<float4*>(out)[i] = make_float4(v[0], v[1], v[2], v[3]);
}

template <>
__device__ __forceinline__ void store_out<__nv_bfloat16, 1>(
    __nv_bfloat16* out, long long i, const float* v) {
  out[i] = repro::from_float<__nv_bfloat16>(v[0]);
}

template <>
__device__ __forceinline__ void store_out<__nv_bfloat16, 4>(
    __nv_bfloat16* out, long long i, const float* v) {
  __nv_bfloat162 h[2];
  h[0] = __halves2bfloat162(repro::from_float<__nv_bfloat16>(v[0]),
                            repro::from_float<__nv_bfloat16>(v[1]));
  h[1] = __halves2bfloat162(repro::from_float<__nv_bfloat16>(v[2]),
                            repro::from_float<__nv_bfloat16>(v[3]));
  reinterpret_cast<uint2*>(out)[i] = *reinterpret_cast<const uint2*>(h);
}

// K3: the reduced gradient from the int32 sum; world 0 skips the mean.
template <typename T, int VEC>
__global__ void __launch_bounds__(NT)
    ef_decode_kernel(const int* __restrict__ total,
                     const float* __restrict__ smax, T* __restrict__ out,
                     int world, long long n_vec) {
  const float sm = *smax;
  const float div = static_cast<float>(world);
  const long long stride = (long long)gridDim.x * NT;
  for (long long i = blockIdx.x * (long long)NT + threadIdx.x; i < n_vec;
       i += stride) {
    int t[VEC];
    if constexpr (VEC == 4) {
      const int4 r = __ldg(reinterpret_cast<const int4*>(total) + i);
      t[0] = r.x;
      t[1] = r.y;
      t[2] = r.z;
      t[3] = r.w;
    } else {
      t[0] = total[i];
    }
    float v[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      v[j] = __fmul_rn(static_cast<float>(t[j]), sm);
      if (world) v[j] = __fdiv_rn(v[j], div);
    }
    store_out<T, VEC>(out, i, v);
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// One resident wave of an elementwise kernel: as many CTAs as fit on the
// card at once (from its registers), fewer for a small leaf.
template <typename K>
int wave(K kernel, long long n_vec, int sms) {
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT, 0)
      || per_sm < 1)
    per_sm = 1;
  const long long want = (n_vec + NT - 1) / NT;
  return (int)std::max(1LL, std::min(want, (long long)sms * per_sm));
}

template <typename T>
cudaError_t ef_absmax_dispatch(const T* x, const float* err, float* partial,
                               float* s, long long n, int parts,
                               cudaStream_t st) {
  const bool vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(x)
                   % (4 * sizeof(T)) == 0 && (!err || aligned16(err));
  if (vec)
    ef_absmax_kernel<T, 4><<<parts, NT, 0, st>>>(x, err, partial, s, n / 4);
  else
    ef_absmax_kernel<T, 1><<<parts, NT, 0, st>>>(x, err, partial, s, n);
  cudaError_t e = cudaGetLastError();
  if (e || parts == 1) return e;
  ef_absmax_final_kernel<<<1, NT, 0, st>>>(partial, s, parts);
  return cudaGetLastError();
}

template <typename T>
cudaError_t ef_requant_dispatch(const T* x, const float* err, float* err_out,
                                int* q2, const float* s, const float* smax,
                                long long n, int sms, cudaStream_t st) {
  const bool vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(x)
                   % (4 * sizeof(T)) == 0 && (!err || aligned16(err))
                   && aligned16(err_out) && aligned16(q2);
  if (vec) {
    ef_requant_kernel<T, 4>
        <<<wave(ef_requant_kernel<T, 4>, n / 4, sms), NT, 0, st>>>(
            x, err, err_out, q2, s, smax, n / 4);
  } else {
    ef_requant_kernel<T, 1>
        <<<wave(ef_requant_kernel<T, 1>, n, sms), NT, 0, st>>>(
            x, err, err_out, q2, s, smax, n);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t ef_decode_dispatch(const int* total, const float* smax, T* out,
                               int world, long long n, int sms,
                               cudaStream_t st) {
  const bool vec = n % 4 == 0 && aligned16(total)
                   && reinterpret_cast<uintptr_t>(out) % (4 * sizeof(T)) == 0;
  if (vec) {
    ef_decode_kernel<T, 4>
        <<<wave(ef_decode_kernel<T, 4>, n / 4, sms), NT, 0, st>>>(
            total, smax, out, world, n / 4);
  } else {
    ef_decode_kernel<T, 1>
        <<<wave(ef_decode_kernel<T, 1>, n, sms), NT, 0, st>>>(
            total, smax, out, world, n);
  }
  return cudaGetLastError();
}

}  // namespace

// x (n,) f32 (is_bf16 = 0) or bf16 (1), err (n,) f32 or null -> s (1,) f32
// = scale_of(max |x + err|).  `parts` CTAs (at least 1); with more than
// one, `partial` holds `parts` floats.
extern "C" int repro_ef_absmax(const void* x, const float* err,
                               float* partial, float* s, long long n,
                               int parts, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0 || parts < 1) return cudaErrorInvalidValue;
  if (is_bf16)
    return ef_absmax_dispatch(static_cast<const __nv_bfloat16*>(x), err,
                              partial, s, n, parts, st);
  return ef_absmax_dispatch(static_cast<const float*>(x), err, partial, s, n,
                            parts, st);
}

// x (n,), err (n,) f32 or null, s and smax (1,) f32 -> q2 (n,) int32 and
// err_out (n,) f32 (which may be err itself).
extern "C" int repro_ef_requant(const void* x, const float* err,
                                float* err_out, int* q2, const float* s,
                                const float* smax, long long n, int is_bf16,
                                int sms, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0 || sms < 1) return cudaErrorInvalidValue;
  if (is_bf16)
    return ef_requant_dispatch(static_cast<const __nv_bfloat16*>(x), err,
                               err_out, q2, s, smax, n, sms, st);
  return ef_requant_dispatch(static_cast<const float*>(x), err, err_out, q2,
                             s, smax, n, sms, st);
}

// total (n,) int32, smax (1,) f32 -> out (n,) f32 or bf16 = total * smax,
// divided by `world` unless it is 0.
extern "C" int repro_ef_decode(const int* total, const float* smax,
                               void* out, long long n, int world, int is_bf16,
                               int sms, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0 || world < 0 || sms < 1) return cudaErrorInvalidValue;
  if (is_bf16)
    return ef_decode_dispatch(total, smax, static_cast<__nv_bfloat16*>(out),
                              world, n, sms, st);
  return ef_decode_dispatch(total, smax, static_cast<float*>(out), world, n,
                            sms, st);
}
