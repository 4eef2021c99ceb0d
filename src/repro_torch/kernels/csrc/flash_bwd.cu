// Flash attention backward: dq, and dk/dv, as two kernels.
//
// Replaces the TPU kernels repro/kernels/flash_attention/flash.py::
// _flash_bwd_dq_kernel and ::_flash_bwd_dkv_kernel (Pallas).  Wrappers and
// the plain PyTorch version: repro_torch/kernels/flash_attention/flash.py.
//
// Both kernels recompute the score tile s = tau * q.k from (q, k) and the
// forward's per-row lse, so no (Sq, Sk) tensor ever exists:
//   p  = exp(s - lse)          (0 where masked, as exp(-1e30 - lse) is)
//   dp = do . v
//   ds = p * (dp - delta)      delta = rowsum(do * o), computed outside
//   dq = tau * sum_k ds k      dk = tau * sum_q ds q      dv = sum_q p do
//
// What bounds them on an H100: the arithmetic.  A causal backward needs
// 10 * pairs * H * D FLOPs for its five products (the two-kernel recompute
// does 14) on O(S * H * D) bytes.  Like the forward kernel, this first
// version runs on the f32 FMA pipes, not the tensor cores; the design keeps
// anything worse from bounding it:
//  - Blocks on Hopper run in no order, so each block owns its output tile
//    and loops over the other axis: no atomics, and the gradients come out
//    the same on every run.
//  - dq: one block per (batch, kv head, 64 rows), a row being one (query,
//    group-head) pair as in the forward kernel, so each K/V tile loaded into
//    shared memory serves the G query heads of its kv head.  The kv loop
//    stops at the causal wedge.
//  - dk/dv: one block per (batch, kv head, 64 keys); it streams every row
//    at or after its first key (the reference's i0 = floor(j*bk/bq)), and
//    the sum over the G query heads sharing the kv head happens inside the
//    block, since those heads are rows of the same tile.
//  - Tiles come in with 16-byte loads and are widened to f32 once in
//    shared memory; each thread holds a 4x8 register tile of scores and a
//    4x(D/8) tile of each gradient.  bf16 is rounded once on the way out.
// Ragged tails (S not a multiple of 64) are masked, not required away.

#include "common.cuh"

namespace {

constexpr int BR = 64;    // rows (query, group-head) per tile
constexpr int BK = 64;    // keys per tile
constexpr int NT = 128;   // threads: 16 row groups x 8 key/dim groups

template <int D>
constexpr int dq_smem_bytes() {
  return (2 * BR * (D + 1) + 2 * BK * (D + 1) + BR * (BK + 1)) * 4;
}

template <int D>
constexpr int dkv_smem_bytes() {
  return (2 * BK * (D + 1) + 2 * BR * (D + 1) + 2 * BR * (BK + 1) + 2 * BR)
         * 4;
}

// Rows [row0, row0 + BR) of a (B, Sq, H, D) tensor for kv head `kvh`
// (row = query * G + group-head) into dst (BR x (D+1)) times `mul`; rows
// past `nrows` are zero.
template <typename T, int D>
__device__ __forceinline__ void load_rows(float* dst, const T* __restrict__ src,
                                          int b, int kvh, int row0, int nrows,
                                          int Sq, int H, int G, float mul) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CPR = D / VEC;
  constexpr int DP = D + 1;
  for (int c = threadIdx.x; c < BR * CPR; c += NT) {
    const int r = c / CPR, dc = (c % CPR) * VEC;
    const int fr = row0 + r;
    float t[VEC];
    if (fr < nrows) {
      const int qi = fr / G, g = fr % G;
      repro::cvt16<T>(
          repro::ld16(src + (((size_t)b * Sq + qi) * H + kvh * G + g) * D + dc),
          t);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) t[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) dst[r * DP + dc + e] = t[e] * mul;
  }
}

// Keys [k0, k0 + BK) of a (B, Sk, K, D) tensor for kv head `kvh` into dst
// (BK x (D+1)); keys past Sk are zero.
template <typename T, int D>
__device__ __forceinline__ void load_keys(float* dst, const T* __restrict__ src,
                                          int b, int kvh, int k0, int Sk,
                                          int K) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CPR = D / VEC;
  constexpr int DP = D + 1;
  for (int c = threadIdx.x; c < BK * CPR; c += NT) {
    const int r = c / CPR, dc = (c % CPR) * VEC;
    const int key = k0 + r;
    float t[VEC];
    if (key < Sk) {
      repro::cvt16<T>(
          repro::ld16(src + (((size_t)b * Sk + key) * K + kvh) * D + dc), t);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) t[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) dst[r * DP + dc + e] = t[e];
  }
}

// s[i][j] = A[ty*4+i] . B[tx+8j] over D, both tiles (64 x (D+1)) in smem.
template <int D>
__device__ __forceinline__ void tile_dot(const float* A, const float* Bm,
                                         int tx, int ty, float (&s)[4][8]) {
  constexpr int DP = D + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float av[4], bv[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = A[(ty * 4 + i) * DP + d];
#pragma unroll
    for (int j = 0; j < 8; ++j) bv[j] = Bm[(tx + 8 * j) * DP + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
  }
}

// ---------------------------------------------------------------------------
// dq: per (batch, kv head, 64 rows), loop kv tiles up to the causal wedge
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int Sq, int Sk, int H, int K, int causal, float scale) {
  constexpr int DP = D + 1;
  constexpr int PP = BK + 1;
  constexpr int DJ = D / 8;             // gradient dims per thread
  extern __shared__ float smem[];
  float* Qs = smem;                     // BR x DP, pre-scaled by tau
  float* dOs = Qs + BR * DP;            // BR x DP
  float* Ks = dOs + BR * DP;            // BK x DP
  float* Vs = Ks + BK * DP;             // BK x DP
  float* dSs = Vs + BK * DP;            // BR x PP: p, then ds

  const int G = H / K;
  const int b = blockIdx.z, kvh = blockIdx.y;
  const int row0 = blockIdx.x * BR;
  const int nrows = Sq * G;
  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;

  load_rows<T, D>(Qs, q, b, kvh, row0, nrows, Sq, H, G, scale);
  load_rows<T, D>(dOs, dout, b, kvh, row0, nrows, Sq, H, G, 1.f);

  float lse_r[4], dlt[4], acc[4][DJ];
  int qpos[4];
  bool live[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int fr = row0 + ty * 4 + i;
    live[i] = fr < nrows;
    qpos[i] = fr / G;
    const size_t idx =
        live[i] ? (((size_t)b * Sq + fr / G) * K + kvh) * G + fr % G : 0;
    lse_r[i] = live[i] ? lse[idx] : 0.f;
    dlt[i] = live[i] ? delta[idx] : 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  int kend = Sk;
  if (causal) {   // the wedge: keys after the block's last query are masked
    const int last_q = (min(row0 + BR, nrows) - 1) / G;
    kend = min(Sk, last_q + 1);
  }

  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();   // the previous tile's K, V and dS are consumed
    load_keys<T, D>(Ks, k, b, kvh, k0, Sk, K);
    load_keys<T, D>(Vs, v, b, kvh, k0, Sk, K);
    __syncthreads();

    float s[4][8];
    tile_dot<D>(Qs, Ks, tx, ty, s);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int key = k0 + tx + 8 * j;
        const bool on = live[i] && key < Sk && !(causal && key > qpos[i]);
        dSs[(ty * 4 + i) * PP + tx + 8 * j] =
            on ? expf(s[i][j] - lse_r[i]) : 0.f;
      }
    tile_dot<D>(dOs, Vs, tx, ty, s);   // dp, into the same registers
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float* cell = &dSs[(ty * 4 + i) * PP + tx + 8 * j];
        *cell = *cell * (s[i][j] - dlt[i]);      // the thread's own p
      }
    __syncthreads();

    // acc[i][j] += dS[row][:] . K[:, tx+8j]
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float dv_[4], kv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) dv_[i] = dSs[(ty * 4 + i) * PP + kk];
#pragma unroll
      for (int j = 0; j < DJ; ++j) kv[j] = Ks[kk * DP + tx + 8 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(dv_[i], kv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (!live[i]) continue;
    const int fr = row0 + ty * 4 + i;
    const int qi = fr / G, g = fr % G;
    T* dst = dq + (((size_t)b * Sq + qi) * H + kvh * G + g) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      dst[tx + 8 * j] = repro::from_float<T>(acc[i][j] * scale);
  }
}

// ---------------------------------------------------------------------------
// dk/dv: per (batch, kv head, 64 keys), loop row tiles from the first key on
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int Sq, int Sk, int H, int K,
                     int causal, float scale) {
  constexpr int DP = D + 1;
  constexpr int PP = BK + 1;
  constexpr int DJ = D / 8;
  extern __shared__ float smem[];
  float* Ks = smem;                     // BK x DP
  float* Vs = Ks + BK * DP;             // BK x DP
  float* Qs = Vs + BK * DP;             // BR x DP, pre-scaled by tau
  float* dOs = Qs + BR * DP;            // BR x DP
  float* Ps = dOs + BR * DP;            // BR x PP
  float* dSs = Ps + BR * PP;            // BR x PP
  float* Ls = dSs + BR * PP;            // BR
  float* Ds = Ls + BR;                  // BR

  const int G = H / K;
  const int b = blockIdx.z, kvh = blockIdx.y;
  const int key0 = blockIdx.x * BK;
  const int nrows = Sq * G;
  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;

  load_keys<T, D>(Ks, k, b, kvh, key0, Sk, K);
  load_keys<T, D>(Vs, v, b, kvh, key0, Sk, K);

  // keys ty*4+i of the tile, dims tx+8j
  float dk_acc[4][DJ], dv_acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  // causal: rows before key0 * G all belong to queries before the tile's
  // first key, so every entry they would add is masked
  const int row_begin = causal ? min(key0 * G, nrows) : 0;

  for (int row0 = row_begin; row0 < nrows; row0 += BR) {
    __syncthreads();   // the previous tile's Q, dO, P and dS are consumed
    load_rows<T, D>(Qs, q, b, kvh, row0, nrows, Sq, H, G, scale);
    load_rows<T, D>(dOs, dout, b, kvh, row0, nrows, Sq, H, G, 1.f);
    for (int c = tid; c < BR; c += NT) {
      const int fr = row0 + c;
      const bool live = fr < nrows;
      const size_t idx =
          live ? (((size_t)b * Sq + fr / G) * K + kvh) * G + fr % G : 0;
      Ls[c] = live ? lse[idx] : 0.f;
      Ds[c] = live ? delta[idx] : 0.f;
    }
    __syncthreads();

    // scores for rows ty*4+i and keys tx+8j
    float s[4][8];
    tile_dot<D>(Qs, Ks, tx, ty, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      const int fr = row0 + r;
      const int qp = fr / G;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int key = key0 + tx + 8 * j;
        const bool on = fr < nrows && key < Sk && !(causal && key > qp);
        Ps[r * PP + tx + 8 * j] = on ? expf(s[i][j] - Ls[r]) : 0.f;
      }
    }
    tile_dot<D>(dOs, Vs, tx, ty, s);   // dp, into the same registers
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        dSs[r * PP + tx + 8 * j] =
            Ps[r * PP + tx + 8 * j] * (s[i][j] - Ds[r]);   // own p
    }
    __syncthreads();

    // dv[key][d] += P[:, key] . dO[:, d];  dk[key][d] += dS[:, key] . Q[:, d]
#pragma unroll 4
    for (int r = 0; r < BR; ++r) {
      float pv[4], sv[4], ov[DJ], qv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = Ps[r * PP + ty * 4 + i];
        sv[i] = dSs[r * PP + ty * 4 + i];
      }
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        ov[j] = dOs[r * DP + tx + 8 * j];
        qv[j] = Qs[r * DP + tx + 8 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          dv_acc[i][j] = fmaf(pv[i], ov[j], dv_acc[i][j]);
          dk_acc[i][j] = fmaf(sv[i], qv[j], dk_acc[i][j]);
        }
    }
  }

  // Q was pre-scaled by tau, so dk already carries it
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = key0 + ty * 4 + i;
    if (key >= Sk) continue;
    const size_t off = (((size_t)b * Sk + key) * K + kvh) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      dk[off + tx + 8 * j] = repro::from_float<T>(dk_acc[i][j]);
      dv[off + tx + 8 * j] = repro::from_float<T>(dv_acc[i][j]);
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  int B, Sq, Sk, H, K, causal;
  cudaStream_t stream;
};

template <typename T, int D>
cudaError_t launch_dq(const Args& a, void* dq) {
  auto kern = flash_bwd_dq_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, dq_smem_bytes<D>());
  if (err != cudaSuccess) return err;
  const int G = a.H / a.K;
  dim3 grid((a.Sq * G + BR - 1) / BR, a.K, a.B);
  const float scale = (float)(1.0 / sqrt((double)D));
  kern<<<grid, NT, dq_smem_bytes<D>(), a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(dq), a.Sq, a.Sk, a.H, a.K, a.causal, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const Args& a, void* dk, void* dv) {
  auto kern = flash_bwd_dkv_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, dkv_smem_bytes<D>());
  if (err != cudaSuccess) return err;
  dim3 grid((a.Sk + BK - 1) / BK, a.K, a.B);
  const float scale = (float)(1.0 / sqrt((double)D));
  kern<<<grid, NT, dkv_smem_bytes<D>(), a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(dk), static_cast<T*>(dv), a.Sq, a.Sk, a.H,
      a.K, a.causal, scale);
  return cudaGetLastError();
}

Args make_args(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, int B, int Sq, int Sk,
               int H, int K, int causal, void* stream) {
  return Args{q, k, v, dout, lse, delta, B, Sq, Sk, H, K, causal,
              static_cast<cudaStream_t>(stream)};
}

}  // namespace

// q/do (B,Sq,H,D), k/v (B,Sk,K,D), lse/delta (B,Sq,K,H/K) f32 -> dq like q.
// bf16 != 0 selects __nv_bfloat16, else float.  Returns the launch's
// cudaError_t; an unsupported head dim returns cudaErrorInvalidValue.
extern "C" int repro_flash_bwd_dq(const void* q, const void* k, const void* v,
                                  const void* dout, const float* lse,
                                  const float* delta, void* dq, int B, int Sq,
                                  int Sk, int H, int K, int D, int causal,
                                  int bf16, void* stream) {
  const Args a = make_args(q, k, v, dout, lse, delta, B, Sq, Sk, H, K, causal,
                           stream);
  if (bf16) {
    if (D == 64) return launch_dq<__nv_bfloat16, 64>(a, dq);
    if (D == 128) return launch_dq<__nv_bfloat16, 128>(a, dq);
  } else {
    if (D == 64) return launch_dq<float, 64>(a, dq);
    if (D == 128) return launch_dq<float, 128>(a, dq);
  }
  return cudaErrorInvalidValue;
}

// The same inputs -> dk, dv like k and v.
extern "C" int repro_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                   const void* dout, const float* lse,
                                   const float* delta, void* dk, void* dv,
                                   int B, int Sq, int Sk, int H, int K, int D,
                                   int causal, int bf16, void* stream) {
  const Args a = make_args(q, k, v, dout, lse, delta, B, Sq, Sk, H, K, causal,
                           stream);
  if (bf16) {
    if (D == 64) return launch_dkv<__nv_bfloat16, 64>(a, dk, dv);
    if (D == 128) return launch_dkv<__nv_bfloat16, 128>(a, dk, dv);
  } else {
    if (D == 64) return launch_dkv<float, 64>(a, dk, dv);
    if (D == 128) return launch_dkv<float, 128>(a, dk, dv);
  }
  return cudaErrorInvalidValue;
}
