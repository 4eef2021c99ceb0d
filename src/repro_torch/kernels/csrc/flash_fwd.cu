// Flash attention forward for prefill: blocked online-softmax GQA attention.
//
// Replaces the TPU kernel repro/kernels/flash_attention/flash.py:52
// _flash_fwd_kernel (Pallas, called at flash.py:240).  Wrapper and plain
// PyTorch version: repro_torch/kernels/flash_attention/flash.py.
//
// What bounds it on an H100: the arithmetic.  A causal forward does
// 4 * pairs * H * D FLOPs for its two products (pairs = the live (query,
// key) pairs) on O(S * H * D) bytes: 68.7 GFLOP at the training shape (B=4,
// S=2048, 32 q heads over 4 kv heads, D=64), 0.0695 ms at the bf16
// tensor-core peak.  Designs both dtypes share:
//  - A row is one (query, group-head) pair: the G query heads that share a
//    kv head are packed as rows, so every K/V tile loaded into shared memory
//    serves G x (64/G) queries -- the GQA reuse the TPU kernel gets from its
//    (B, S, K, G*D) layout.
//  - Each block owns a tile of 64 rows and loops over the kv tiles (a
//    sequential grid dimension on the TPU), stopping at the causal wedge:
//    tiles wholly after the block's last query are never loaded.  No
//    atomics, so a second launch gives the same bits.
//  - The softmax state (m, l, acc) stays in registers; the output is
//    rounded to the input type once.  Ragged tails (S not a multiple of the
//    tile) are masked, not required away.
//
// The dtype selects the kernel; this is a dispatch, not a fallback:
//  - bf16 (the training and serving path): the FlashAttention-2 forward on
//    the tensor cores, mma.sync.m16n8k16 with bf16 operands and f32
//    accumulation, 4 warps of 16 rows.  Each warp loads its Q fragments
//    once (ldmatrix) and keeps them in registers, up to D = 128; at D = 256
//    (128 accumulator registers a lane) it reads them from shared memory
//    at each 16-dim step and streams tiles of 32 keys.  K/V tiles of 64
//    keys stay bf16 in shared memory, rows padded by 16 bytes so the 8 rows an
//    ldmatrix reads fall in 8 bank groups, and come through a 2-stage ring
//    of 16-byte cp.async: tile j+1 loads while tile j computes, behind one
//    barrier per tile.  S = Q.K^T reads K as B with ldmatrix; s is scaled
//    by tau in f32 registers (q is not pre-scaled, which in bf16 would
//    round twice) and the running (m, l) is kept in the log2 domain, the
//    exponentials on the SFU (ex2.approx); lse = m ln2 + log l, in f32.
//    p is rounded to bf16 once, to enter P.V from registers as its A
//    operand (V read as B with ldmatrix.trans); l sums the f32 p.  Only
//    tiles that straddle the diagonal or a ragged tail pay for the mask.
//    Blocks are numbered longest first (the last row tiles see the most
//    keys), so the short ones fill the tail.  o = acc / l goes out through
//    the warp's own Q rows in shared memory as 16-byte stores.
//  - f32: the FMA kernel of the first port: K/V tiles widened to f32 in
//    shared memory, a 4x8 register tile of scores and a 4x(D/8) tile of the
//    output a thread, so each shared-memory read feeds 2-3 FMAs; q is
//    pre-scaled by tau.  At D = 256 its tiles take 214,016 B of shared
//    memory, one block an SM.  The f32 tolerance (2e-5) would not survive
//    bf16 or TF32 rounding.
// Head dims 64, 80, 128 and 256: 80 is 5 k-steps of 16 and 10 n8 tiles,
// every loop here steps 16 dims at a time.

#include "common.cuh"

namespace {

using repro::NEG_INF;

constexpr int NT = 128;   // threads of the FMA kernel's blocks: 4 warps

// ---------------------------------------------------------------------------
// f32: FMA kernel
// ---------------------------------------------------------------------------

constexpr int BR = 64;    // rows (query, group-head) per block
constexpr int BK = 64;    // keys per tile

template <int D>
constexpr int smem_bytes() {
  return (BR * (D + 1) + 2 * BK * (D + 1) + BR * (BK + 1)) * 4;
}

template <int D>
__global__ void __launch_bounds__(NT)
flash_fwd_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int Sq, int Sk, int H, int K,
                     int causal, float scale) {
  constexpr int VEC = 4;                // floats per 16-byte load
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
      repro::cvt16<float>(
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
        repro::cvt16<float>(repro::ld16(k + off), tk);
        repro::cvt16<float>(repro::ld16(v + off), tv);
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
    float* dst = o + (((size_t)b * Sq + qi) * H + kvh * G + g) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) dst[tx + 8 * j] = acc[i][j] / lc;
    if (tx == 0)
      lse[(((size_t)b * Sq + qi) * K + kvh) * G + g] = m[i] + logf(lc);
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor-core kernel
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
using repro::keys_async;
using repro::LOG2E;
using repro::PITCH;
using repro::rows_async;
constexpr int MR = 64;    // rows per block, 16 per warp
constexpr int MNT = MR / 16 * 32;

// Keys per streamed tile: 64, and 32 at D = 256, where the output
// accumulator alone takes 128 registers a lane (and two 32-key stages
// leave room for two blocks an SM).
template <int D>
constexpr int MK = D > 128 ? 32 : 64;

// The warp's Q fragments stay in registers up to D = 128 (32 a lane); at
// D = 256 they would take 64 beside the accumulator's 128, so each
// 16-dim step reads its fragment from shared memory (ldmatrix) instead.
template <int D>
constexpr bool Q_IN_REGS = D <= 128;

template <int D>
constexpr int mma_smem_bytes() {   // Q; 2 stages of (K, V)
  return (MR + 4 * MK<D>) * PITCH<D> * 2;
}

// Per (batch, kv head, 64 rows), loop kv tiles up to the causal wedge.  Warp
// w owns rows 16w..16w+15; lane l holds rows l/4 and l/4 + 8 of them, and in
// each n8 tile of keys the columns 2(l%4) and 2(l%4) + 1.
template <int D>
__global__ void __launch_bounds__(MNT)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     float* __restrict__ lse, int B, int Sq, int Sk, int H,
                     int K, int causal, float scale) {
  constexpr int P = PITCH<D>;
  constexpr int TK = MK<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);   // MR x P; then the output
  bf16* ring = Qs + MR * P;                       // 2 x (K, V), TK x P each

  const int G = H / K, nrows = Sq * G;
  const int ntiles = (nrows + MR - 1) / MR;
  const int bk = blockIdx.x % (B * K);
  const int b = bk / K, kvh = bk % K;
  // the last row tiles see the most keys: they launch first
  const int row0 = (ntiles - 1 - blockIdx.x / (B * K)) * MR;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  int kend = Sk;
  if (causal) kend = min(Sk, (min(row0 + MR, nrows) - 1) / G + 1);
  const int nk = (kend + TK - 1) / TK;   // >= 1
  const int q_first = row0 / G;

  auto load_kv = [&](int j) {   // kv tile j into stage j & 1
    bf16* dst = ring + (j & 1) * 2 * TK * P;
    keys_async<TK, D, MNT>(dst, k, b, kvh, j * TK, Sk, K);
    keys_async<TK, D, MNT>(dst + TK * P, v, b, kvh, j * TK, Sk, K);
    repro::cp_async_commit();
  };
  rows_async<MR, D, MNT>(Qs, q, b, kvh, row0, nrows, Sq, H, G);
  load_kv(0);   // Q rides in kv tile 0's copy group

  int qpos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    qpos[h] = (row0 + warp * 16 + lane / 4 + 8 * h) / G;
  const float tau2 = scale * LOG2E;

  bf16* Qw = Qs + warp * 16 * P;
  repro::cp_async_wait<0>();
  __syncthreads();
  // the warp's Q as A fragments, one per 16 dims (Q_IN_REGS)
  uint32_t qa[Q_IN_REGS<D> ? D / 16 : 1][4];
  if constexpr (Q_IN_REGS<D>) {
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd)
      repro::ldsm4(qa[kd], Qw + (lane % 16) * P + kd * 16 + (lane / 16) * 8);
  }

  float m2[2] = {NEG_INF, NEG_INF};   // running max of tau*s*log2(e), per row
  float l[2] = {0.f, 0.f};            // this lane's share of the row's sum
  float acc[D / 8][4] = {};

  for (int j = 0; j < nk; ++j) {
    if (j > 0) {
      // tile j has landed, and every warp is past tile j - 1, whose stage
      // takes tile j + 1 while tile j computes: one barrier per tile
      repro::cp_async_wait<0>();
      __syncthreads();
    }
    if (j + 1 < nk) load_kv(j + 1);
    const bf16* Ks = ring + (j & 1) * 2 * TK * P;
    const bf16* Vs = Ks + TK * P;
    const int k0 = j * TK;

    // S = Q.K^T: K's rows (keys) are B's columns
    float s[TK / 8][4] = {};
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd) {
      uint32_t qf[4];
      if constexpr (Q_IN_REGS<D>) {
#pragma unroll
        for (int e = 0; e < 4; ++e) qf[e] = qa[kd][e];
      } else {
        repro::ldsm4(qf, Qw + (lane % 16) * P + kd * 16 + (lane / 16) * 8);
      }
#pragma unroll
      for (int n = 0; n < TK / 16; ++n) {
        uint32_t bm[4];
        repro::ldsm4(bm, Ks + (n * 16 + lane % 8 + (lane / 16) * 8) * P
                             + kd * 16 + ((lane / 8) % 2) * 8);
        repro::mma_bf16(s[2 * n], qf, bm[0], bm[1]);
        repro::mma_bf16(s[2 * n + 1], qf, bm[2], bm[3]);
      }
    }

    // online softmax in the log2 domain; the mask only where the tile
    // straddles the diagonal or the ragged end of the keys
    const bool edge = (causal && k0 + TK - 1 > q_first) || k0 + TK > Sk;
    float mx[2] = {m2[0], m2[1]};
#pragma unroll
    for (int n = 0; n < TK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * tau2;
        if (edge) {
          const int key = k0 + n * 8 + (lane % 4) * 2 + (e & 1);
          if (key >= Sk || (causal && key > qpos[e / 2])) x = NEG_INF;
        }
        s[n][e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {   // a row's TK keys sit in the lane's quad
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      corr[h] = repro::ex2(m2[h] - mx[h]);
      m2[h] = mx[h];
      l[h] *= corr[h];
    }
#pragma unroll
    for (int n = 0; n < TK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = repro::ex2(s[n][e] - m2[e / 2]);
        l[e / 2] += p;
        s[n][e] = p;
      }
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e / 2];

    uint32_t pa[TK / 16][4];
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk)
      repro::pack_a(pa[kk], s[2 * kk], s[2 * kk + 1]);
    repro::mma_ab<D, TK / 16>(acc, pa, Vs, lane);
  }

  // o = acc / l into the warp's own Q rows (no other warp reads them), then
  // out as 16-byte stores; lse = m ln2 + log l
  const int rw = row0 + warp * 16;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const float lc = fmaxf(l[h], 1e-30f);
    const float inv = 1.f / lc;
    const int r = lane / 4 + 8 * h;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(Qw + r * P + n * 8 + (lane % 4) * 2) =
          repro::pack_bf16(acc[n][2 * h] * inv, acc[n][2 * h + 1] * inv);
    const int fr = rw + r;
    if (lane % 4 == 0 && fr < nrows)
      lse[(((size_t)b * Sq + fr / G) * K + kvh) * G + fr % G] =
          m2[h] * repro::LN2 + logf(lc);
  }
  __syncwarp();
  constexpr int CPR = D / 8;   // 16-byte chunks per row
#pragma unroll
  for (int c = lane; c < 16 * CPR; c += 32) {
    const int r = c / CPR, ch = c % CPR;
    const int fr = rw + r;
    if (fr < nrows)
      *reinterpret_cast<uint4*>(
          o + (((size_t)b * Sq + fr / G) * H + kvh * G + fr % G) * D
          + ch * 8) = *reinterpret_cast<const uint4*>(Qw + r * P + ch * 8);
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <typename Kern, typename... A>
cudaError_t launch(Kern kern, dim3 grid, int threads, int smem,
                   cudaStream_t stream, A... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       float* lse, int B, int Sq, int Sk, int H, int K,
                       int causal, bool bf16_in, cudaStream_t stream) {
  const int G = H / K;
  const float scale = (float)(1.0 / sqrt((double)D));
  if (bf16_in) {
    const int tiles = (Sq * G + MR - 1) / MR;
    return launch(flash_fwd_mma_kernel<D>, dim3(tiles * B * K), MNT,
                  mma_smem_bytes<D>(), stream, static_cast<const bf16*>(q),
                  static_cast<const bf16*>(k), static_cast<const bf16*>(v),
                  static_cast<bf16*>(o), lse, B, Sq, Sk, H, K, causal, scale);
  }
  return launch(flash_fwd_fma_kernel<D>, dim3((Sq * G + BR - 1) / BR, K, B),
                NT, smem_bytes<D>(), stream, static_cast<const float*>(q),
                static_cast<const float*>(k), static_cast<const float*>(v),
                static_cast<float*>(o), lse, Sq, Sk, H, K, causal, scale);
}

}  // namespace

// q (B,Sq,H,D), k/v (B,Sk,K,D) -> o (B,Sq,H,D), lse (B,Sq,K,H/K) f32.
// is_bf16 != 0 selects __nv_bfloat16 (the tensor-core kernel), else float
// (the FMA kernel).  Returns the launch's cudaError_t; an unsupported head
// dim returns cudaErrorInvalidValue.
extern "C" int repro_flash_fwd(const void* q, const void* k, const void* v,
                               void* o, float* lse, int B, int Sq, int Sk,
                               int H, int K, int D, int causal, int is_bf16,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch_fwd<64>(q, k, v, o, lse, B, Sq, Sk, H, K, causal, is_bf16,
                          s);
  if (D == 80)
    return launch_fwd<80>(q, k, v, o, lse, B, Sq, Sk, H, K, causal, is_bf16,
                          s);
  if (D == 128)
    return launch_fwd<128>(q, k, v, o, lse, B, Sq, Sk, H, K, causal, is_bf16,
                           s);
  if (D == 256)
    return launch_fwd<256>(q, k, v, o, lse, B, Sq, Sk, H, K, causal, is_bf16,
                           s);
  return cudaErrorInvalidValue;
}

// Library-wide: the text of a cudaError_t, for the wrappers' exceptions.
extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
