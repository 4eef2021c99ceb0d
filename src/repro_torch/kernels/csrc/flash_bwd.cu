// Flash attention backward: dq, and dk/dv, as two kernels.
//
// Replaces the TPU kernels repro/kernels/flash_attention/flash.py:109
// _flash_bwd_dq_kernel and flash.py:155 _flash_bwd_dkv_kernel (Pallas).
// Wrappers and the plain PyTorch version:
// repro_torch/kernels/flash_attention/flash.py.
//
// Both kernels recompute the score tile s = tau * q.k from (q, k) and the
// forward's per-row lse, so no (Sq, Sk) tensor ever exists:
//   p  = exp(s - lse)          (0 where masked, as exp(-1e30 - lse) is)
//   dp = do . v
//   ds = p * (dp - delta)      delta = rowsum(do * o), computed outside
//   dq = tau * sum_k ds k      dk = tau * sum_q ds q      dv = sum_q p do
//
// What bounds them on an H100: the arithmetic.  A causal backward needs
// 10 * pairs * H * D FLOPs for its five products on O(S * H * D) bytes;
// the two-kernel recompute does 14 (dq: s, dp, dq; dk/dv: s, dp, dv, dk).
// Both kernels keep these designs:
//  - Blocks on Hopper run in no order, so each block owns its output tile
//    and loops over the other axis: no atomics, and a second launch on the
//    same inputs gives the same bits.
//  - A row is one (query, group-head) pair, so each K/V tile serves the G
//    query heads of its kv head, and dk/dv sum over those heads inside the
//    block.
//  - Causal: the dq kernel's kv loop ends at its row tile's last query;
//    the dk/dv kernel's row loop starts at key0 * G (the reference's
//    i0 = floor(j*bk/bq)).  Only tiles that straddle the diagonal or a
//    ragged tail (S not a multiple of the tile) pay for the mask.
//  - Blocks are numbered longest first (the dq kernel's last row tiles,
//    the dk/dv kernel's first keys), so the short ones fill the tail.
//
// The dtype selects the kernel; this is a dispatch, not a fallback:
//  - bf16 (the training path): mma.sync.m16n8k16 on the tensor cores,
//    bf16 operands and f32 accumulation, 4 warps of 16 rows (dq) or 16
//    keys (dk/dv).  Tiles stay bf16 in shared memory, rows padded by 16
//    bytes so the 8 rows an ldmatrix reads fall in 8 bank groups.  The
//    streamed tiles (K/V for dq; Q, dO, lse, delta for dk/dv) sit in a
//    2-stage ring filled by 16-byte cp.async: tile j+1 loads while tile j
//    computes, behind one barrier per tile.  s and dp stay in f32
//    registers; s is scaled by tau there (q is not pre-scaled, which in
//    bf16 would round twice), exp runs on the SFU (ex2.approx), and p and
//    ds are rounded to bf16 once, as every tensor-core flash backward does,
//    to enter the next product from registers as its A operand:
//      dq:    S = Q.K^T, dP = dO.V^T, then dQ += dS.K;
//      dk/dv: the transposed tiles S^T = K.Q^T, dP^T = V.dO^T, whose
//             accumulators the warps owning the keys hold, then
//             dV += P^T.dO and dK += dS^T.Q, with lse and delta of the
//             streamed rows broadcast along columns from shared memory.
//    dq and dk are scaled by tau once, at the end.  mma.sync, not wgmma:
//    the same registers-to-registers chaining at a lower peak, without
//    shared-memory descriptors that could only be debugged on the card.
//  - f32: the FMA kernels of the first port, tiles widened to f32 in
//    shared memory and 4x8 register tiles a thread; the f32 tolerance
//    (2e-4) would not survive bf16 or TF32 rounding.
// Head dims 64, 80, 128 and 256.  At 256 the dk/dv kernels of both dtypes
// split D: a block owns 128 of the output dims and recomputes s and dp for
// them (6 products of 2·pairs·H·D in place of 4), so its two accumulators
// fit as at D = 128; the f32 tiles shrink to fit 227 KB (DQ_KEYS,
// DKV_ROWS_F32), the bf16 dq kernel streams 32 keys a tile.
// Ragged tails are masked, not required away.

#include "common.cuh"

namespace {

constexpr int NT = 128;   // threads in every block: 4 warps

// ---------------------------------------------------------------------------
// f32: FMA kernels
// ---------------------------------------------------------------------------

constexpr int BR = 64;    // dq: rows (query, group-head) per block
constexpr int BK = 64;    // dk/dv: keys per block

// The tiles shrink at D = 256, where 64 x (D + 1) floats are 65.8 KB:
//  - dq streams 32 keys a tile (64 below): Q, dO and two stages of K, V
//    at 64 would take 279,808 B, over the 232,448 a block may have;
//  - dk/dv streams 32 rows a tile (64 below), 296,960 B at 64, and each
//    block owns DS = 128 of the D output dims (the D split: a (key tile,
//    dim slice) pair a block, s and dp recomputed for each slice), so its
//    two accumulators stay at 4 x 16 floats a thread each, as at D = 128.
template <int D>
constexpr int DQ_KEYS = D > 128 ? 32 : 64;
template <int D>
constexpr int DKV_ROWS_F32 = D > 128 ? 32 : 64;
template <int D>
constexpr int DS = D > 128 ? 128 : D;   // output dims of a block (both dtypes)

template <int D>
constexpr int dq_smem_bytes() {
  return (2 * BR * (D + 1) + 2 * DQ_KEYS<D> * (D + 1)
          + BR * (DQ_KEYS<D> + 1)) * 4;
}

template <int D>
constexpr int dkv_smem_bytes() {
  constexpr int R = DKV_ROWS_F32<D>;
  return (2 * BK * (D + 1) + 2 * R * (D + 1) + 2 * R * (BK + 1) + 2 * R) * 4;
}

// Rows [row0, row0 + R) of a (B, Sq, H, D) tensor for kv head `kvh`
// (row = query * G + group-head) into dst (R x (D+1)) times `mul`; rows
// past `nrows` are zero.
template <int D, int R>
__device__ __forceinline__ void load_rows(float* dst,
                                          const float* __restrict__ src,
                                          int b, int kvh, int row0, int nrows,
                                          int Sq, int H, int G, float mul) {
  constexpr int CPR = D / 4;
  constexpr int DP = D + 1;
  for (int c = threadIdx.x; c < R * CPR; c += NT) {
    const int r = c / CPR, dc = (c % CPR) * 4;
    const int fr = row0 + r;
    float t[4] = {0.f, 0.f, 0.f, 0.f};
    if (fr < nrows) {
      const int qi = fr / G, g = fr % G;
      repro::cvt16<float>(
          repro::ld16(src + (((size_t)b * Sq + qi) * H + kvh * G + g) * D + dc),
          t);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) dst[r * DP + dc + e] = t[e] * mul;
  }
}

// Keys [k0, k0 + R) of a (B, Sk, K, D) tensor for kv head `kvh` into dst
// (R x (D+1)); keys past Sk are zero.
template <int D, int R>
__device__ __forceinline__ void load_keys(float* dst,
                                          const float* __restrict__ src,
                                          int b, int kvh, int k0, int Sk,
                                          int K) {
  constexpr int CPR = D / 4;
  constexpr int DP = D + 1;
  for (int c = threadIdx.x; c < R * CPR; c += NT) {
    const int r = c / CPR, dc = (c % CPR) * 4;
    const int key = k0 + r;
    float t[4] = {0.f, 0.f, 0.f, 0.f};
    if (key < Sk)
      repro::cvt16<float>(
          repro::ld16(src + (((size_t)b * Sk + key) * K + kvh) * D + dc), t);
#pragma unroll
    for (int e = 0; e < 4; ++e) dst[r * DP + dc + e] = t[e];
  }
}

// s[i][j] = A[ty*RI+i] . B[tx+8j] over D, both tiles ((., D+1) rows) in
// smem: RI rows of A and KJ rows of B a thread.
template <int D, int RI, int KJ>
__device__ __forceinline__ void tile_dot(const float* A, const float* Bm,
                                         int tx, int ty, float (&s)[RI][KJ]) {
  constexpr int DP = D + 1;
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < KJ; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float av[RI], bv[KJ];
#pragma unroll
    for (int i = 0; i < RI; ++i) av[i] = A[(ty * RI + i) * DP + d];
#pragma unroll
    for (int j = 0; j < KJ; ++j) bv[j] = Bm[(tx + 8 * j) * DP + d];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < KJ; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
  }
}

// dq: per (batch, kv head, 64 rows), loop kv tiles up to the causal wedge
template <int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_fma_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq, int Sq, int Sk, int H, int K,
                        int causal, float scale) {
  constexpr int TK = DQ_KEYS<D>;        // keys per tile
  constexpr int KJ = TK / 8;            // keys per thread
  constexpr int DP = D + 1;
  constexpr int PP = TK + 1;
  constexpr int DJ = D / 8;             // gradient dims per thread
  extern __shared__ float smem[];
  float* Qs = smem;                     // BR x DP, pre-scaled by tau
  float* dOs = Qs + BR * DP;            // BR x DP
  float* Ks = dOs + BR * DP;            // TK x DP
  float* Vs = Ks + TK * DP;             // TK x DP
  float* dSs = Vs + TK * DP;            // BR x PP: p, then ds

  const int G = H / K;
  const int b = blockIdx.z, kvh = blockIdx.y;
  const int row0 = blockIdx.x * BR;
  const int nrows = Sq * G;
  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;

  load_rows<D, BR>(Qs, q, b, kvh, row0, nrows, Sq, H, G, scale);
  load_rows<D, BR>(dOs, dout, b, kvh, row0, nrows, Sq, H, G, 1.f);

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

  for (int k0 = 0; k0 < kend; k0 += TK) {
    __syncthreads();   // the previous tile's K, V and dS are consumed
    load_keys<D, TK>(Ks, k, b, kvh, k0, Sk, K);
    load_keys<D, TK>(Vs, v, b, kvh, k0, Sk, K);
    __syncthreads();

    float s[4][KJ];
    tile_dot<D, 4, KJ>(Qs, Ks, tx, ty, s);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const int key = k0 + tx + 8 * j;
        const bool on = live[i] && key < Sk && !(causal && key > qpos[i]);
        dSs[(ty * 4 + i) * PP + tx + 8 * j] =
            on ? expf(s[i][j] - lse_r[i]) : 0.f;
      }
    tile_dot<D, 4, KJ>(dOs, Vs, tx, ty, s);   // dp, into the same registers
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        float* cell = &dSs[(ty * 4 + i) * PP + tx + 8 * j];
        *cell = *cell * (s[i][j] - dlt[i]);      // the thread's own p
      }
    __syncthreads();

    // acc[i][j] += dS[row][:] . K[:, tx+8j]
#pragma unroll 4
    for (int kk = 0; kk < TK; ++kk) {
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
    float* dst = dq + (((size_t)b * Sq + qi) * H + kvh * G + g) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) dst[tx + 8 * j] = acc[i][j] * scale;
  }
}

// dk/dv: per (batch, kv head, 64 keys, DS output dims), loop row tiles from
// the first key on
template <int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_fma_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv,
                         int Sq, int Sk, int H, int K, int causal,
                         float scale) {
  constexpr int R = DKV_ROWS_F32<D>;    // rows per tile
  constexpr int RI = R / 16;            // rows per thread in the scores
  constexpr int NS = D / DS<D>;         // dim slices
  constexpr int DP = D + 1;
  constexpr int PP = BK + 1;
  constexpr int DJ = DS<D> / 8;         // gradient dims per thread
  extern __shared__ float smem[];
  float* Ks = smem;                     // BK x DP
  float* Vs = Ks + BK * DP;             // BK x DP
  float* Qs = Vs + BK * DP;             // R x DP, pre-scaled by tau
  float* dOs = Qs + R * DP;             // R x DP
  float* Ps = dOs + R * DP;             // R x PP
  float* dSs = Ps + R * PP;             // R x PP
  float* Ls = dSs + R * PP;             // R
  float* Ds = Ls + R;                   // R

  const int G = H / K;
  const int b = blockIdx.z, kvh = blockIdx.y;
  const int key0 = blockIdx.x / NS * BK;
  const int d0 = blockIdx.x % NS * DS<D>;   // this block's output dims
  const int nrows = Sq * G;
  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;

  load_keys<D, BK>(Ks, k, b, kvh, key0, Sk, K);
  load_keys<D, BK>(Vs, v, b, kvh, key0, Sk, K);

  // keys ty*4+i of the tile, dims d0+tx+8j
  float dk_acc[4][DJ], dv_acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  // causal: rows before key0 * G all belong to queries before the tile's
  // first key, so every entry they would add is masked
  const int row_begin = causal ? min(key0 * G, nrows) : 0;

  for (int row0 = row_begin; row0 < nrows; row0 += R) {
    __syncthreads();   // the previous tile's Q, dO, P and dS are consumed
    load_rows<D, R>(Qs, q, b, kvh, row0, nrows, Sq, H, G, scale);
    load_rows<D, R>(dOs, dout, b, kvh, row0, nrows, Sq, H, G, 1.f);
    for (int c = tid; c < R; c += NT) {
      const int fr = row0 + c;
      const bool live = fr < nrows;
      const size_t idx =
          live ? (((size_t)b * Sq + fr / G) * K + kvh) * G + fr % G : 0;
      Ls[c] = live ? lse[idx] : 0.f;
      Ds[c] = live ? delta[idx] : 0.f;
    }
    __syncthreads();

    // scores for rows ty*RI+i and keys tx+8j
    float s[RI][8];
    tile_dot<D, RI, 8>(Qs, Ks, tx, ty, s);
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = ty * RI + i;
      const int fr = row0 + r;
      const int qp = fr / G;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int key = key0 + tx + 8 * j;
        const bool on = fr < nrows && key < Sk && !(causal && key > qp);
        Ps[r * PP + tx + 8 * j] = on ? expf(s[i][j] - Ls[r]) : 0.f;
      }
    }
    tile_dot<D, RI, 8>(dOs, Vs, tx, ty, s);   // dp, into the same registers
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = ty * RI + i;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        dSs[r * PP + tx + 8 * j] =
            Ps[r * PP + tx + 8 * j] * (s[i][j] - Ds[r]);   // own p
    }
    __syncthreads();

    // dv[key][d] += P[:, key] . dO[:, d];  dk[key][d] += dS[:, key] . Q[:, d]
#pragma unroll 4
    for (int r = 0; r < R; ++r) {
      float pv[4], sv[4], ov[DJ], qv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = Ps[r * PP + ty * 4 + i];
        sv[i] = dSs[r * PP + ty * 4 + i];
      }
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        ov[j] = dOs[r * DP + d0 + tx + 8 * j];
        qv[j] = Qs[r * DP + d0 + tx + 8 * j];
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
    const size_t off = (((size_t)b * Sk + key) * K + kvh) * D + d0;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      dk[off + tx + 8 * j] = dk_acc[i][j];
      dv[off + tx + 8 * j] = dv_acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor-core kernels
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
using repro::keys_async;
using repro::LOG2E;
using repro::mma_ab;
using repro::PITCH;
using repro::rows_async;
constexpr int MR = 64;    // dq: rows per block, 16 per warp
constexpr int MK = 64;    // dk/dv: keys per block, 16 per warp

// dq: keys per streamed tile, DQ_KEYS<D> (32 at D = 256, where the
// accumulator takes 128 registers a lane beside the S and dP tiles).
// dk/dv: rows per streamed tile.  At D >= 128 the two 16 x 128
// accumulators take 128 registers a thread, so the S^T and dP^T tiles are
// halved; at D = 256 a block owns DS = 128 of the output dims (the D
// split, as in the f32 kernel), so its accumulators are D = 128's.
template <int D>
constexpr int DKV_ROWS = D <= 80 ? 64 : 32;

template <int D>
constexpr int dq_mma_smem_bytes() {   // Q, dO; 2 stages of (K, V)
  return (2 * MR + 4 * DQ_KEYS<D>) * PITCH<D> * 2;
}

template <int D>
constexpr int dkv_mma_smem_bytes() {  // K, V; 2 stages of (Q, dO, lse, delta)
  return (2 * MK + 4 * DKV_ROWS<D>) * PITCH<D> * 2 + 4 * DKV_ROWS<D> * 4;
}

// cp.async of lse or delta (B, Sq, K, G) for rows [row0, row0 + R); rows
// past `nrows` are zero.
template <int R>
__device__ __forceinline__ void stats_async(float* dst, const float* src,
                                            int b, int kvh, int row0,
                                            int nrows, int Sq, int K, int G) {
  for (int r = threadIdx.x; r < R; r += NT) {
    const int fr = row0 + r;
    const bool live = fr < nrows;
    const float* s =
        live ? src + (((size_t)b * Sq + fr / G) * K + kvh) * G + fr % G : src;
    repro::cp_async4(dst + r, s, live);
  }
}

// c[n] += A . B^T over D for N = 2 * NB n8 tiles: A is the warp's 16 rows
// of a (., D) tile, B the first 16 * NB rows of another, both row-major
// in shared memory (S = Q.K^T, dP = dO.V^T and their transposes).
template <int D, int NB>
__device__ __forceinline__ void mma_abt(float (&c)[2 * NB][4], const bf16* A,
                                        const bf16* Bm, int lane) {
  constexpr int P = PITCH<D>;
#pragma unroll
  for (int kd = 0; kd < D / 16; ++kd) {
    uint32_t a[4];
    repro::ldsm4(a, A + (lane % 16) * P + kd * 16 + (lane / 16) * 8);
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      uint32_t bm[4];
      repro::ldsm4(bm, Bm + (n * 16 + lane % 8 + (lane / 16) * 8) * P
                           + kd * 16 + ((lane / 8) % 2) * 8);
      repro::mma_bf16(c[2 * n], a, bm[0], bm[1]);
      repro::mma_bf16(c[2 * n + 1], a, bm[2], bm[3]);
    }
  }
}

// 16 rows of N f32 accumulators (c[n] holds columns 8n..8n+7) times
// `mul` as bf16, where row r of the warp's 16 goes to dst(r) (null: skip).
template <int N, typename Dst>
__device__ __forceinline__ void store_rows(const float (&c)[N / 8][4],
                                           float mul, int lane, Dst dst) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    bf16* row = dst(lane / 4 + 8 * h);
    if (row == nullptr) continue;
#pragma unroll
    for (int n = 0; n < N / 8; ++n)
      *reinterpret_cast<uint32_t*>(row + n * 8 + (lane % 4) * 2) =
          repro::pack_bf16(c[n][2 * h] * mul, c[n][2 * h + 1] * mul);
  }
}

// dq: per (batch, kv head, 64 rows), loop kv tiles up to the causal wedge.
// Warp w owns rows 16w..16w+15; lane l holds rows l/4 and l/4 + 8 of them.
template <int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        bf16* __restrict__ dq, int B, int Sq, int Sk, int H,
                        int K, int causal, float scale) {
  constexpr int P = PITCH<D>;
  constexpr int TK = DQ_KEYS<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);   // MR x P
  bf16* dOs = Qs + MR * P;                        // MR x P
  bf16* ring = dOs + MR * P;                      // 2 x (K, V), TK x P each

  const int G = H / K, nrows = Sq * G;
  const int ntiles = (nrows + MR - 1) / MR;
  const int bk = blockIdx.x % (B * K);
  const int b = bk / K, kvh = bk % K;
  // the last row tiles see the most keys: they launch first
  const int row0 = (ntiles - 1 - blockIdx.x / (B * K)) * MR;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  int kend = Sk;
  if (causal) kend = min(Sk, (min(row0 + MR, nrows) - 1) / G + 1);
  const int nk = (kend + TK - 1) / TK;
  const int q_first = row0 / G;

  auto load_kv = [&](int j) {   // kv tile j into stage j & 1
    bf16* dst = ring + (j & 1) * 2 * TK * P;
    keys_async<TK, D, NT>(dst, k, b, kvh, j * TK, Sk, K);
    keys_async<TK, D, NT>(dst + TK * P, v, b, kvh, j * TK, Sk, K);
    repro::cp_async_commit();
  };
  rows_async<MR, D, NT>(Qs, q, b, kvh, row0, nrows, Sq, H, G);
  rows_async<MR, D, NT>(dOs, dout, b, kvh, row0, nrows, Sq, H, G);
  load_kv(0);

  float lse2[2], dlt[2];
  int qpos[2];
  bool live[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int fr = row0 + warp * 16 + lane / 4 + 8 * h;
    live[h] = fr < nrows;
    qpos[h] = fr / G;
    const size_t idx =
        live[h] ? (((size_t)b * Sq + fr / G) * K + kvh) * G + fr % G : 0;
    lse2[h] = live[h] ? lse[idx] * LOG2E : 0.f;
    dlt[h] = live[h] ? delta[idx] : 0.f;
  }
  const float tau2 = scale * LOG2E;

  float acc[D / 8][4] = {};
  const bf16* Qw = Qs + warp * 16 * P;
  const bf16* dOw = dOs + warp * 16 * P;

  for (int j = 0; j < nk; ++j) {
    // tile j has landed, and every warp is past tile j - 1, whose stage
    // takes tile j + 1 while tile j computes: one barrier per tile
    repro::cp_async_wait<0>();
    __syncthreads();
    if (j + 1 < nk) load_kv(j + 1);
    const bf16* Ks = ring + (j & 1) * 2 * TK * P;
    const bf16* Vs = Ks + TK * P;
    const int k0 = j * TK;

    float s[TK / 8][4] = {}, dp[TK / 8][4] = {};
    mma_abt<D, TK / 16>(s, Qw, Ks, lane);
    mma_abt<D, TK / 16>(dp, dOw, Vs, lane);

    // ds = p * (dp - delta), p = exp(tau s - lse); the mask only where the
    // tile straddles the diagonal or a ragged tail
    const bool edge = (causal && k0 + TK - 1 > q_first) || k0 + TK > Sk
                      || row0 + MR > nrows;
#pragma unroll
    for (int n = 0; n < TK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2;
        float p = repro::ex2(fmaf(s[n][e], tau2, -lse2[h]));
        if (edge) {
          const int key = k0 + n * 8 + (lane % 4) * 2 + (e & 1);
          if (!live[h] || key >= Sk || (causal && key > qpos[h])) p = 0.f;
        }
        dp[n][e] = p * (dp[n][e] - dlt[h]);
      }
    uint32_t dsa[TK / 16][4];
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk)
      repro::pack_a(dsa[kk], dp[2 * kk], dp[2 * kk + 1]);
    mma_ab<D, TK / 16>(acc, dsa, Ks, lane);
  }

  const int rw = row0 + warp * 16;
  store_rows<D>(acc, scale, lane, [&](int r) -> bf16* {
    const int fr = rw + r;
    if (fr >= nrows) return nullptr;
    return dq + (((size_t)b * Sq + fr / G) * H + kvh * G + fr % G) * D;
  });
}

// dk/dv: per (batch, kv head, 64 keys, DS output dims), loop row tiles
// from the first key on.  Warp w owns keys 16w..16w+15; lane l holds keys
// l/4 and l/4 + 8.
template <int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_mma_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int B,
                         int Sq, int Sk, int H, int K, int causal,
                         float scale) {
  constexpr int P = PITCH<D>;
  constexpr int BN = DKV_ROWS<D>;
  constexpr int N = DS<D>, NS = D / N;       // output dims a block, slices
  constexpr int STAGE = 2 * BN * P;          // Q and dO of one stage
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);   // MK x P
  bf16* Vs = Ks + MK * P;                         // MK x P
  bf16* ring = Vs + MK * P;                       // 2 x (Q, dO), BN x P each
  float* stats = reinterpret_cast<float*>(ring + 2 * STAGE);   // 2 x (l, d)

  const int G = H / K, nrows = Sq * G;
  const int d0 = blockIdx.x % NS * N;        // this block's output dims
  const int bid = blockIdx.x / NS;
  const int bk = bid % (B * K);
  const int b = bk / K, kvh = bk % K;
  // the first keys see the most rows: they launch first
  const int key0 = bid / (B * K) * MK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // causal: rows before key0 * G all belong to queries before the tile's
  // first key, so every entry they would add is masked
  const int row_begin = causal ? min(key0 * G, nrows) : 0;
  const int nt = (nrows - row_begin + BN - 1) / BN;

  auto load_qdo = [&](int j) {   // row tile j into stage j & 1
    const int row0 = row_begin + j * BN;
    bf16* dst = ring + (j & 1) * STAGE;
    float* sd = stats + (j & 1) * 2 * BN;
    rows_async<BN, D, NT>(dst, q, b, kvh, row0, nrows, Sq, H, G);
    rows_async<BN, D, NT>(dst + BN * P, dout, b, kvh, row0, nrows, Sq, H, G);
    stats_async<BN>(sd, lse, b, kvh, row0, nrows, Sq, K, G);
    stats_async<BN>(sd + BN, delta, b, kvh, row0, nrows, Sq, K, G);
    repro::cp_async_commit();
  };

  if (nt > 0) {   // K and V ride in row tile 0's copy group
    keys_async<MK, D, NT>(Ks, k, b, kvh, key0, Sk, K);
    keys_async<MK, D, NT>(Vs, v, b, kvh, key0, Sk, K);
    load_qdo(0);
  }

  int key[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) key[h] = key0 + warp * 16 + lane / 4 + 8 * h;
  const float tau2 = scale * LOG2E;

  float dk_acc[N / 8][4] = {}, dv_acc[N / 8][4] = {};
  const bf16* Kw = Ks + warp * 16 * P;
  const bf16* Vw = Vs + warp * 16 * P;

  for (int j = 0; j < nt; ++j) {
    const int row0 = row_begin + j * BN;
    // tile j has landed, and every warp is past tile j - 1, whose stage
    // takes tile j + 1 while tile j computes: one barrier per tile
    repro::cp_async_wait<0>();
    __syncthreads();
    if (j + 1 < nt) load_qdo(j + 1);
    const bf16* Qs = ring + (j & 1) * STAGE;
    const bf16* dOs = Qs + BN * P;
    const float* Ls = stats + (j & 1) * 2 * BN;
    const float* Ds = Ls + BN;

    // the transposed tiles: keys down, rows across
    float st[BN / 8][4] = {}, dpt[BN / 8][4] = {};
    mma_abt<D, BN / 16>(st, Kw, Qs, lane);
    mma_abt<D, BN / 16>(dpt, Vw, dOs, lane);

    const bool edge = (causal && key0 + MK - 1 > row0 / G) || key0 + MK > Sk
                      || row0 + BN > nrows;
#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2;
        const int c = n * 8 + (lane % 4) * 2 + (e & 1);
        float p = repro::ex2(fmaf(st[n][e], tau2, -Ls[c] * LOG2E));
        if (edge) {
          const int fr = row0 + c;
          if (fr >= nrows || key[h] >= Sk || (causal && key[h] > fr / G))
            p = 0.f;
        }
        st[n][e] = p;
        dpt[n][e] = p * (dpt[n][e] - Ds[c]);
      }
    uint32_t pa[BN / 16][4], dsa[BN / 16][4];
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      repro::pack_a(pa[kk], st[2 * kk], st[2 * kk + 1]);
      repro::pack_a(dsa[kk], dpt[2 * kk], dpt[2 * kk + 1]);
    }
    mma_ab<D, BN / 16, N>(dv_acc, pa, dOs + d0, lane);
    mma_ab<D, BN / 16, N>(dk_acc, dsa, Qs + d0, lane);
  }

  const int kw = key0 + warp * 16;
  auto key_row = [&](bf16* base) {
    return [=](int r) -> bf16* {
      return kw + r < Sk ? base + (((size_t)b * Sk + kw + r) * K + kvh) * D
                         : nullptr;
    };
  };
  store_rows<N>(dk_acc, scale, lane, key_row(dk + d0));
  store_rows<N>(dv_acc, 1.f, lane, key_row(dv + d0));
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  int B, Sq, Sk, H, K, causal;
  cudaStream_t stream;
  float scale;
};

template <typename Kern, typename... A>
cudaError_t launch(Kern kern, dim3 grid, int smem, cudaStream_t stream,
                   A... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, NT, smem, stream>>>(args...);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const Args& a, void* dq, bool bf16_in) {
  const int G = a.H / a.K;
  if (bf16_in) {
    const int tiles = (a.Sq * G + MR - 1) / MR;
    return launch(flash_bwd_dq_mma_kernel<D>, dim3(tiles * a.B * a.K),
                  dq_mma_smem_bytes<D>(), a.stream,
                  static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
                  static_cast<const bf16*>(a.v),
                  static_cast<const bf16*>(a.dout), a.lse, a.delta,
                  static_cast<bf16*>(dq), a.B, a.Sq, a.Sk, a.H, a.K, a.causal,
                  a.scale);
  }
  return launch(flash_bwd_dq_fma_kernel<D>,
                dim3((a.Sq * G + BR - 1) / BR, a.K, a.B), dq_smem_bytes<D>(),
                a.stream, static_cast<const float*>(a.q),
                static_cast<const float*>(a.k), static_cast<const float*>(a.v),
                static_cast<const float*>(a.dout), a.lse, a.delta,
                static_cast<float*>(dq), a.Sq, a.Sk, a.H, a.K, a.causal,
                a.scale);
}

template <int D>
cudaError_t launch_dkv(const Args& a, void* dk, void* dv, bool bf16_in) {
  // (key tile, dim slice) pairs; MK == BK: both dtypes take 64 keys a block
  static_assert(MK == BK, "one key tiling for both kernels");
  const int tiles = (a.Sk + MK - 1) / MK * (D / DS<D>);
  if (bf16_in)
    return launch(flash_bwd_dkv_mma_kernel<D>, dim3(tiles * a.B * a.K),
                  dkv_mma_smem_bytes<D>(), a.stream,
                  static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
                  static_cast<const bf16*>(a.v),
                  static_cast<const bf16*>(a.dout), a.lse, a.delta,
                  static_cast<bf16*>(dk), static_cast<bf16*>(dv), a.B, a.Sq,
                  a.Sk, a.H, a.K, a.causal, a.scale);
  return launch(flash_bwd_dkv_fma_kernel<D>, dim3(tiles, a.K, a.B),
                dkv_smem_bytes<D>(), a.stream, static_cast<const float*>(a.q),
                static_cast<const float*>(a.k), static_cast<const float*>(a.v),
                static_cast<const float*>(a.dout), a.lse, a.delta,
                static_cast<float*>(dk), static_cast<float*>(dv), a.Sq, a.Sk,
                a.H, a.K, a.causal, a.scale);
}

Args make_args(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, int B, int Sq, int Sk,
               int H, int K, int D, int causal, void* stream) {
  return Args{q, k, v, dout, lse, delta, B, Sq, Sk, H, K, causal,
              static_cast<cudaStream_t>(stream),
              (float)(1.0 / sqrt((double)D))};
}

}  // namespace

// q/do (B,Sq,H,D), k/v (B,Sk,K,D), lse/delta (B,Sq,K,H/K) f32 -> dq like q.
// is_bf16 != 0 selects __nv_bfloat16 (the tensor-core kernel), else float
// (the FMA kernel).  Returns the launch's cudaError_t; an unsupported head
// dim returns cudaErrorInvalidValue.
extern "C" int repro_flash_bwd_dq(const void* q, const void* k, const void* v,
                                  const void* dout, const float* lse,
                                  const float* delta, void* dq, int B, int Sq,
                                  int Sk, int H, int K, int D, int causal,
                                  int is_bf16, void* stream) {
  const Args a = make_args(q, k, v, dout, lse, delta, B, Sq, Sk, H, K, D,
                           causal, stream);
  if (D == 64) return launch_dq<64>(a, dq, is_bf16);
  if (D == 80) return launch_dq<80>(a, dq, is_bf16);
  if (D == 128) return launch_dq<128>(a, dq, is_bf16);
  if (D == 256) return launch_dq<256>(a, dq, is_bf16);
  return cudaErrorInvalidValue;
}

// The same inputs -> dk, dv like k and v.
extern "C" int repro_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                   const void* dout, const float* lse,
                                   const float* delta, void* dk, void* dv,
                                   int B, int Sq, int Sk, int H, int K, int D,
                                   int causal, int is_bf16, void* stream) {
  const Args a = make_args(q, k, v, dout, lse, delta, B, Sq, Sk, H, K, D,
                           causal, stream);
  if (D == 64) return launch_dkv<64>(a, dk, dv, is_bf16);
  if (D == 80) return launch_dkv<80>(a, dk, dv, is_bf16);
  if (D == 128) return launch_dkv<128>(a, dk, dv, is_bf16);
  if (D == 256) return launch_dkv<256>(a, dk, dv, is_bf16);
  return cudaErrorInvalidValue;
}
