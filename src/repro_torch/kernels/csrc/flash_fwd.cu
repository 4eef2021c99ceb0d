// Flash attention forward for prefill: blocked online-softmax GQA attention.
//
// Replaces the TPU kernel repro/kernels/flash_attention/flash.py::
// _flash_fwd_kernel (Pallas).  Wrapper and plain PyTorch version:
// repro_torch/kernels/flash_attention/flash.py.
//
// What bounds it on an H100: the arithmetic.  A causal prefill of S tokens
// does ~2*S^2*H*D FLOPs (half of them masked away by the causal wedge) on
// O(S*H*D) bytes, far above the card's ~295 FLOP/byte balance point.  This
// first version runs that arithmetic on the f32 FMA pipes, not the tensor
// cores, so it sits well under the bf16 tensor-core bound; the design keeps
// it from being bound by anything worse:
//  - one block per (batch, kv head, tile of 64 rows), where a row is one
//    (query, group-head) pair: the G query heads that share a kv head are
//    packed as rows, so every K/V tile loaded into shared memory serves
//    G x (64/G) queries -- the GQA reuse the TPU kernel gets from its
//    (B, S, K, G*D) layout;
//  - the kv loop runs inside the block (on the TPU it was a sequential grid
//    dimension) and stops at the causal wedge: tiles wholly after the
//    block's last query are never loaded;
//  - K/V tiles are read with 16-byte loads and converted to f32 once in
//    shared memory; each thread computes a 4x8 register tile of scores and
//    a 4x(D/8) tile of the output, so each shared-memory read feeds 2-3
//    FMAs;
//  - the softmax state (m, l, acc) stays in registers; bf16 inputs are
//    accumulated in f32 and the output is rounded to the input type once.
// Ragged tails (S not a multiple of the tile) are masked, not required away.

#include "common.cuh"

namespace {

using repro::NEG_INF;

constexpr int BR = 64;    // rows (query, group-head) per block
constexpr int BK = 64;    // keys per tile
constexpr int NT = 128;   // threads: 16 row groups x 8 key/dim groups

template <int D>
constexpr int smem_bytes() {
  return (BR * (D + 1) + 2 * BK * (D + 1) + BR * (BK + 1)) * 4;
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int Sq, int Sk, int H, int K,
                 int causal, float scale) {
  constexpr int VEC = 16 / sizeof(T);   // elements per 16-byte load
  constexpr int CPR = D / VEC;          // 16-byte chunks per row
  constexpr int DP = D + 1;             // padded row stride (no bank conflicts)
  constexpr int PP = BK + 1;
  constexpr int DJ = D / 8;             // output dims per thread
  extern __shared__ float smem[];
  float* Qs = smem;                     // BR x DP, pre-scaled
  float* Ks = Qs + BR * DP;             // BK x DP
  float* Vs = Ks + BK * DP;             // BK x DP
  float* Ps = Vs + BK * DP;             // BR x PP

  const int G = H / K;
  const int b = blockIdx.z, kvh = blockIdx.y;
  const int row0 = blockIdx.x * BR;     // first row of this block
  const int nrows = Sq * G;
  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;

  for (int c = tid; c < BR * CPR; c += NT) {
    const int r = c / CPR, dc = (c % CPR) * VEC;
    const int fr = row0 + r;
    float t[VEC];
    if (fr < nrows) {
      const int qi = fr / G, g = fr % G;
      repro::cvt16<T>(
          repro::ld16(q + (((size_t)b * Sq + qi) * H + kvh * G + g) * D + dc),
          t);
#pragma unroll
      for (int e = 0; e < VEC; ++e) t[e] *= scale;
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) t[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) Qs[r * DP + dc + e] = t[e];
  }

  float m[4], l[4], acc[4][DJ];
  int qpos[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
    qpos[i] = (row0 + ty * 4 + i) / G;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  int kend = Sk;
  if (causal) {   // the wedge: keys after the block's last query are masked
    const int last_q = (min(row0 + BR, nrows) - 1) / G;
    kend = min(Sk, last_q + 1);
  }

  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();   // the previous tile's K, V and P are consumed
    for (int c = tid; c < BK * CPR; c += NT) {
      const int r = c / CPR, dc = (c % CPR) * VEC;
      const int key = k0 + r;
      float tk[VEC], tv[VEC];
      if (key < Sk) {
        const size_t off = (((size_t)b * Sk + key) * K + kvh) * D + dc;
        repro::cvt16<T>(repro::ld16(k + off), tk);
        repro::cvt16<T>(repro::ld16(v + off), tv);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) tk[e] = tv[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        Ks[r * DP + dc + e] = tk[e];
        Vs[r * DP + dc + e] = tv[e];
      }
    }
    __syncthreads();

    // scores for rows ty*4+i and keys tx+8*j
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * DP + d];
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = Ks[(tx + 8 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // online softmax; a row's 64 keys live in the 8 lanes sharing ty
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int key = k0 + tx + 8 * j;
        if (key >= Sk || (causal && key > qpos[i])) s[i][j] = NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int w = 1; w < 8; w <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
#pragma unroll
      for (int w = 1; w < 8; w <<= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, w);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= corr;
#pragma unroll
      for (int j = 0; j < 8; ++j) Ps[(ty * 4 + i) * PP + tx + 8 * j] = s[i][j];
    }
    __syncthreads();

    // acc[i][j] += P[row][:] . V[:, tx+8*j]
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * PP + kk];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = Vs[kk * DP + tx + 8 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int fr = row0 + ty * 4 + i;
    if (fr >= nrows) continue;
    const int qi = fr / G, g = fr % G;
    const float lc = fmaxf(l[i], 1e-30f);
    T* dst = o + (((size_t)b * Sq + qi) * H + kvh * G + g) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      dst[tx + 8 * j] = repro::from_float<T>(acc[i][j] / lc);
    if (tx == 0)
      lse[(((size_t)b * Sq + qi) * K + kvh) * G + g] = m[i] + logf(lc);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int Sq, int Sk, int H, int K,
                   int causal, cudaStream_t stream) {
  auto kern = flash_fwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<D>());
  if (err != cudaSuccess) return err;
  const int G = H / K;
  dim3 grid((Sq * G + BR - 1) / BR, K, B);
  const float scale = (float)(1.0 / sqrt((double)D));
  kern<<<grid, NT, smem_bytes<D>(), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, Sq, Sk, H, K, causal,
      scale);
  return cudaGetLastError();
}

}  // namespace

// q (B,Sq,H,D), k/v (B,Sk,K,D) -> o (B,Sq,H,D), lse (B,Sq,K,H/K) f32.
// bf16 != 0 selects __nv_bfloat16, else float.  Returns the launch's
// cudaError_t; an unsupported head dim returns cudaErrorInvalidValue.
extern "C" int repro_flash_fwd(const void* q, const void* k, const void* v,
                               void* o, float* lse, int B, int Sq, int Sk,
                               int H, int K, int D, int causal, int bf16,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    if (D == 64)
      return launch<__nv_bfloat16, 64>(q, k, v, o, lse, B, Sq, Sk, H, K,
                                       causal, s);
    if (D == 128)
      return launch<__nv_bfloat16, 128>(q, k, v, o, lse, B, Sq, Sk, H, K,
                                        causal, s);
  } else {
    if (D == 64)
      return launch<float, 64>(q, k, v, o, lse, B, Sq, Sk, H, K, causal, s);
    if (D == 128)
      return launch<float, 128>(q, k, v, o, lse, B, Sq, Sk, H, K, causal, s);
  }
  return cudaErrorInvalidValue;
}

// Library-wide: the text of a cudaError_t, for the wrappers' exceptions.
extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
