// Fused softmax cross-entropy forward over a vocab-tiled LM head.
//
// Replaces the TPU kernel repro/kernels/xent/xent.py:36 _xent_kernel
// (Pallas, called at xent.py:98).  Wrapper and plain PyTorch version:
// repro_torch/kernels/xent/xent.py.
//
// For hidden h (T, E), head W (E, V) and labels (T,) it returns per token
//   lse = log sum_v exp(h.W[:, v])  over the real columns v < vocab
//   nll = lse - h.W[:, label]
// without ever writing the (T, V) logits: each logits tile lives in
// registers only, and is folded into a running (max m, sum-exp l, label
// logit c) per row.
//
// What bounds it on an H100: the arithmetic, 2*T*E*V FLOPs (a (T x E) by
// (E x V) product) on O(T*E + E*V) bytes: 1.07 TFLOP at the training shape
// (T = 4*2047, E = 2048, V = 32000), 1.085 ms at the bf16 tensor-core peak.
// Designs both dtypes share:
//  - The TPU kernel carries (m, l, c) across the vocab axis of its grid in
//    its output refs, since a TPU grid runs the minor axis in order.  On a
//    GPU blocks run in no order, so here each block owns a tile of token
//    rows and sweeps its vocab columns in its own loop, keeping (m, l, c)
//    in registers.
//  - The vocab is split into `nseg` segments, one block per (token tile,
//    segment), each writing a partial (m, l, c), and a second small kernel
//    merges the segments: m = max m_s, l = sum l_s exp(m_s - m),
//    c = sum c_s.  The wrapper picks nseg so that the grid's waves fill the
//    SMs (xent.py: segments).  No atomics: a second launch gives the same
//    bits.
//  - A token tile of h (64 f32 or 128 bf16 rows) is 512 KB at E = 2048,
//    more than a block's shared memory, so h is not kept resident: both
//    operands stream through shared memory along E, and h's chunks are
//    re-read from L2 for every vocab tile.
//  - Columns >= vocab (the padded head, xent.py:48) and past V are masked to
//    -1e30; ragged token rows and E are masked too.
//
// The dtype selects the kernel; this is a dispatch, not a fallback:
//  - bf16 (the training path): mma.sync.m16n8k16 on the tensor cores, bf16
//    operands and f32 accumulation.  A block of 8 warps owns 128 token rows
//    and sweeps 128-column vocab tiles; warp (wr, wc) holds the 32 x 64
//    accumulator tile of rows 32wr.. and columns 64wc..  h and W stream
//    along E in 64-deep bf16 chunks through a 3-stage ring of 16-byte
//    cp.async (zero-filled past T, E and V), one barrier per chunk; rows
//    are padded by 16 bytes so the 8 rows an ldmatrix reads fall in 8 bank
//    groups.  h is read as A with ldmatrix, W (V contiguous) as B with
//    ldmatrix.trans.  bf16 x bf16 products are exact in f32, so the logits
//    differ from an f32 product only in the order of the sum.  After a
//    tile's last chunk each thread folds its 4 rows x 16 columns into its
//    own running (m, l, c): no shuffle and no barrier per tile.  The block
//    merges its threads' partials once, at the end (the quad by shuffles,
//    the two column warps through shared memory).
//  - f32: the FMA kernel of the first port: 64 x 64 tiles, operands widened
//    in shared memory in chunks of 32 along E, a 4x8 register tile a
//    thread.  The f32 path keeps its own tiles (xent.py: FWD_TILE).

#include "common.cuh"

namespace {

using repro::LOG2E;
using repro::NEG_INF;

// Fold the partial (m2, l2, c2) into (m, l, c), natural-log max.  Partials
// whose columns were all masked carry m = -1e30 and weigh nothing.
__device__ __forceinline__ void merge_stats(float& m, float& l, float& c,
                                            float m2, float l2, float c2) {
  const float mm = fmaxf(m, m2);
  l = l * expf(m - mm) + l2 * expf(m2 - mm);
  c += c2;
  m = mm;
}

// ---------------------------------------------------------------------------
// f32: FMA kernel
// ---------------------------------------------------------------------------

constexpr int BT = 64;    // token rows per block
constexpr int BV = 64;    // vocab columns per tile
constexpr int BE = 32;    // hidden dims per chunk
constexpr int NT = 128;   // threads: 16 row groups x 8 column groups

__global__ void __launch_bounds__(NT)
xent_fwd_fma_kernel(const float* __restrict__ h, const float* __restrict__ w,
                    const int* __restrict__ labels, float* __restrict__ part,
                    int Tn, int E, int V, int vocab, int tiles_per_seg) {
  constexpr int HP = BE + 1;
  constexpr int WP = BV + 1;
  __shared__ float Hs[BT * HP];     // rows x chunk of h
  __shared__ float Ws[BE * WP];     // chunk x columns of W

  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;
  const int row0 = blockIdx.x * BT;
  const int seg = blockIdx.y;
  const int nvt = (V + BV - 1) / BV;
  const int vt_begin = seg * tiles_per_seg;
  const int vt_end = min(nvt, vt_begin + tiles_per_seg);

  int lab[4];
  float m[4], l[4], c[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty * 4 + i;
    lab[i] = row < Tn ? labels[row] : -1;
    m[i] = NEG_INF;
    l[i] = 0.f;
    c[i] = 0.f;
  }

  for (int vt = vt_begin; vt < vt_end; ++vt) {
    const int col0 = vt * BV;
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    for (int e0 = 0; e0 < E; e0 += BE) {
      __syncthreads();   // the previous chunk is consumed
      for (int x = tid; x < BT * BE; x += NT) {
        const int r = x / BE, e = x % BE;
        const int gr = row0 + r, ge = e0 + e;
        Hs[r * HP + e] = (gr < Tn && ge < E) ? h[(size_t)gr * E + ge] : 0.f;
      }
      for (int x = tid; x < BE * BV; x += NT) {
        const int e = x / BV, cc = x % BV;
        const int ge = e0 + e, gc = col0 + cc;
        Ws[e * WP + cc] = (ge < E && gc < V) ? w[(size_t)ge * V + gc] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int e = 0; e < BE; ++e) {
        float hv[4], wv[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) hv[i] = Hs[(ty * 4 + i) * HP + e];
#pragma unroll
        for (int j = 0; j < 8; ++j) wv[j] = Ws[e * WP + tx + 8 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(hv[i], wv[j], acc[i][j]);
      }
    }

    // fold the tile into (m, l, c); a row's 64 columns live in the 8 lanes
    // sharing ty
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = col0 + tx + 8 * j;
        if (col >= V || col >= vocab) acc[i][j] = NEG_INF;
        if (col < V && col == lab[i]) c[i] += acc[i][j];
        mx = fmaxf(mx, acc[i][j]);
      }
#pragma unroll
      for (int s = 1; s < 8; s <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, s));
      const float m_new = fmaxf(m[i], mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) rs += expf(acc[i][j] - m_new);
#pragma unroll
      for (int s = 1; s < 8; s <<= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, s);
      l[i] = l[i] * expf(m[i] - m_new) + rs;
      m[i] = m_new;
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int s = 1; s < 8; s <<= 1)
      c[i] += __shfl_xor_sync(0xffffffffu, c[i], s);
    const int row = row0 + ty * 4 + i;
    if (tx == 0 && row < Tn) {
      float* dst = part + ((size_t)seg * Tn + row) * 3;
      dst[0] = m[i];
      dst[1] = l[i];
      dst[2] = c[i];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor-core kernel
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int XT = 128;             // token rows per block
constexpr int XV = 128;             // vocab columns per tile
constexpr int XE = 64;              // hidden dims per streamed chunk
constexpr int XSTAGES = 3;          // chunks in the cp.async ring
constexpr int XWR = 4, XWC = 2;     // warps: row groups x column groups
constexpr int XNT = XWR * XWC * 32;
constexpr int XMI = XT / XWR / 16;  // a warp's 16-row A tiles
constexpr int XNI = XV / XWC / 16;  // a warp's 16-column B tiles
constexpr int XBLOCKS = 2;          // resident blocks an SM
constexpr int HPITCH = XE + 8;      // bf16 elements between rows of h's chunk
constexpr int WPITCH = XV + 8;      // ... of W's chunk
constexpr int XSTAGE = XT * HPITCH + XE * WPITCH;   // one stage, in elements
constexpr int XSMEM = XSTAGES * XSTAGE * 2;         // bytes

// XBLOCKS blocks an SM: registers capped at 65536 / (XBLOCKS * XNT).
__global__ void __launch_bounds__(XNT, XBLOCKS)
xent_fwd_mma_kernel(const bf16* __restrict__ h, const bf16* __restrict__ w,
                    const int* __restrict__ labels, float* __restrict__ part,
                    int Tn, int E, int V, int vocab, int tiles_per_seg) {
  constexpr int WROWS = 16 * XMI, WCOLS = 16 * XNI;   // a warp's tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);   // stage: h chunk, W chunk
  __shared__ float red[XWC][XT][3];   // per column warp: (m, l, c) of a row

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = warp / XWC, wc = warp % XWC;
  const int row0 = blockIdx.x * XT;
  const int seg = blockIdx.y;
  const int nvt = (V + XV - 1) / XV;
  const int vt_begin = seg * tiles_per_seg;
  const int ntile = max(0, min(nvt, vt_begin + tiles_per_seg) - vt_begin);
  const int ne = (E + XE - 1) / XE;
  const int n_it = ntile * ne;       // (vocab tile, E chunk) steps

  auto load = [&](int it) {   // step it into stage it % XSTAGES
    bf16* hs = ring + (it % XSTAGES) * XSTAGE;
    bf16* ws = hs + XT * HPITCH;
    const int e0 = (it % ne) * XE;
    const int col0 = (vt_begin + it / ne) * XV;
    constexpr int HC = XE / 8, WC = XV / 8;   // 16-byte chunks per row
    static_assert(XT * HC % XNT == 0 && XE * WC % XNT == 0, "whole chunks");
#pragma unroll
    for (int i = 0; i < XT * HC / XNT; ++i) {
      const int x = threadIdx.x + i * XNT;
      const int r = x / HC, ch = x % HC;
      const int gr = row0 + r, ge = e0 + ch * 8;
      const bool live = gr < Tn && ge < E;
      repro::cp_async16(hs + r * HPITCH + ch * 8,
                        live ? h + (size_t)gr * E + ge : h, live);
    }
#pragma unroll
    for (int i = 0; i < XE * WC / XNT; ++i) {
      const int x = threadIdx.x + i * XNT;
      const int r = x / WC, ch = x % WC;
      const int ge = e0 + r, gc = col0 + ch * 8;
      const bool live = ge < E && gc < V;
      repro::cp_async16(ws + r * WPITCH + ch * 8,
                        live ? w + (size_t)ge * V + gc : w, live);
    }
  };
  for (int it = 0; it < XSTAGES - 1; ++it) {
    if (it < n_it) load(it);
    repro::cp_async_commit();   // empty groups keep the count uniform
  }

  // this thread's rows: WROWS wr + 16 mi + lane/4 + 8 hh
  int lab[XMI][2];
  float m[XMI][2], l[XMI][2], c[XMI][2];
#pragma unroll
  for (int mi = 0; mi < XMI; ++mi)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row0 + wr * WROWS + mi * 16 + lane / 4 + 8 * hh;
      lab[mi][hh] = row < Tn ? labels[row] : -1;
      m[mi][hh] = NEG_INF;
      l[mi][hh] = 0.f;
      c[mi][hh] = 0.f;
    }

  float acc[XMI][2 * XNI][4] = {};
  for (int it = 0; it < n_it; ++it) {
    // step it has landed, and every warp is past step it - 1, whose stage
    // takes step it + XSTAGES - 1: one barrier per step
    repro::cp_async_wait<XSTAGES - 2>();
    __syncthreads();
    if (it + XSTAGES - 1 < n_it) load(it + XSTAGES - 1);
    repro::cp_async_commit();
    const bf16* hs = ring + (it % XSTAGES) * XSTAGE + wr * WROWS * HPITCH;
    const bf16* ws = ring + (it % XSTAGES) * XSTAGE + XT * HPITCH + wc * WCOLS;
#pragma unroll
    for (int ks = 0; ks < XE / 16; ++ks) {
      uint32_t a[XMI][4];
#pragma unroll
      for (int mi = 0; mi < XMI; ++mi)
        repro::ldsm4(a[mi], hs + (mi * 16 + lane % 16) * HPITCH + ks * 16
                                + (lane / 16) * 8);
#pragma unroll
      for (int n = 0; n < XNI; ++n) {
        uint32_t b[4];
        repro::ldsm4_t(b, ws + (ks * 16 + lane % 8 + ((lane / 8) % 2) * 8)
                                   * WPITCH
                              + n * 16 + (lane / 16) * 8);
#pragma unroll
        for (int mi = 0; mi < XMI; ++mi) {
          repro::mma_bf16(acc[mi][2 * n], a[mi], b[0], b[1]);
          repro::mma_bf16(acc[mi][2 * n + 1], a[mi], b[2], b[3]);
        }
      }
    }
    if (it % ne != ne - 1) continue;

    // the tile's last chunk: fold its logits into this thread's own (m, l,
    // c); columns >= vocab (and so >= V) are masked only in the last tiles
    const int tcol = (vt_begin + it / ne) * XV;
    const int col0 = tcol + wc * WCOLS + (lane % 4) * 2;
    const bool edge = tcol + XV > vocab;
#pragma unroll
    for (int mi = 0; mi < XMI; ++mi)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float mx = m[mi][hh];
#pragma unroll
        for (int n = 0; n < 2 * XNI; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = col0 + n * 8 + e;
            float x = acc[mi][n][2 * hh + e];
            if (edge && col >= vocab) x = NEG_INF;
            if (col == lab[mi][hh]) c[mi][hh] += x;
            acc[mi][n][2 * hh + e] = x;
            mx = fmaxf(mx, x);
          }
        // (x - mx) is exact near the max, and 0, not NaN, where both are
        // -1e30: a wholly masked partial counts its columns but weighs 0
        float rs = 0.f;
#pragma unroll
        for (int n = 0; n < 2 * XNI; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            rs += repro::ex2((acc[mi][n][2 * hh + e] - mx) * LOG2E);
        l[mi][hh] = l[mi][hh] * repro::ex2((m[mi][hh] - mx) * LOG2E) + rs;
        m[mi][hh] = mx;
      }
#pragma unroll
    for (int mi = 0; mi < XMI; ++mi)
#pragma unroll
      for (int n = 0; n < 2 * XNI; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][n][e] = 0.f;
  }

  // merge the quad (lanes sharing a row) by shuffles, then the column
  // warps through shared memory
#pragma unroll
  for (int mi = 0; mi < XMI; ++mi)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mq = m[mi][hh], lq = l[mi][hh], cq = c[mi][hh];
#pragma unroll
      for (int s = 1; s < 4; s <<= 1)
        merge_stats(mq, lq, cq, __shfl_xor_sync(0xffffffffu, mq, s),
                    __shfl_xor_sync(0xffffffffu, lq, s),
                    __shfl_xor_sync(0xffffffffu, cq, s));
      if (lane % 4 == 0) {
        float* dst = red[wc][wr * WROWS + mi * 16 + lane / 4 + 8 * hh];
        dst[0] = mq;
        dst[1] = lq;
        dst[2] = cq;
      }
    }
  __syncthreads();
  static_assert(XT <= XNT, "a thread per row merges the column warps");
  const int r = threadIdx.x;
  if (r < XT && row0 + r < Tn) {
    float mm = red[0][r][0], ll = red[0][r][1], cc = red[0][r][2];
#pragma unroll
    for (int j = 1; j < XWC; ++j)
      merge_stats(mm, ll, cc, red[j][r][0], red[j][r][1], red[j][r][2]);
    float* dst = part + ((size_t)seg * Tn + row0 + r) * 3;
    dst[0] = mm;
    dst[1] = ll;
    dst[2] = cc;
  }
}

// Merge the segments' (m, l, c) per token and finish as xent.py:71-73 does.
__global__ void xent_merge_kernel(const float* __restrict__ part,
                                  float* __restrict__ nll,
                                  float* __restrict__ lse, int Tn, int nseg) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= Tn) return;
  float m = NEG_INF;
  for (int s = 0; s < nseg; ++s)
    m = fmaxf(m, part[((size_t)s * Tn + t) * 3]);
  float l = 0.f, c = 0.f;
  for (int s = 0; s < nseg; ++s) {
    const float* p = part + ((size_t)s * Tn + t) * 3;
    l += p[1] * expf(p[0] - m);
    c += p[2];
  }
  const float out = logf(fmaxf(l, 1e-30f)) + m;
  lse[t] = out;
  nll[t] = out - c;
}

cudaError_t launch(const void* h, const void* w, const int* labels,
                   float* part, float* nll, float* lse, int Tn, int E, int V,
                   int vocab, int nseg, bool bf16_in, cudaStream_t stream) {
  if (bf16_in) {
    const int nvt = (V + XV - 1) / XV;
    cudaError_t err = cudaFuncSetAttribute(
        xent_fwd_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        XSMEM);
    if (err != cudaSuccess) return err;
    xent_fwd_mma_kernel<<<dim3((Tn + XT - 1) / XT, nseg), XNT, XSMEM,
                          stream>>>(
        static_cast<const bf16*>(h), static_cast<const bf16*>(w), labels,
        part, Tn, E, V, vocab, (nvt + nseg - 1) / nseg);
  } else {
    const int nvt = (V + BV - 1) / BV;
    xent_fwd_fma_kernel<<<dim3((Tn + BT - 1) / BT, nseg), NT, 0, stream>>>(
        static_cast<const float*>(h), static_cast<const float*>(w), labels,
        part, Tn, E, V, vocab, (nvt + nseg - 1) / nseg);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  xent_merge_kernel<<<(Tn + 255) / 256, 256, 0, stream>>>(part, nll, lse, Tn,
                                                           nseg);
  return cudaGetLastError();
}

}  // namespace

// hidden (T,E), head_w (E,V) of one type, labels (T,) int32 -> nll, lse (T,)
// f32.  part: scratch of nseg*T*3 floats.  is_bf16 != 0 selects
// __nv_bfloat16 (the tensor-core kernel; E and V multiples of 8, 16-byte
// aligned rows), else float (the FMA kernel).  Returns the launches'
// cudaError_t.
extern "C" int repro_xent_fwd(const void* h, const void* w, const int* labels,
                              float* part, float* nll, float* lse, int Tn,
                              int E, int V, int vocab, int nseg, int is_bf16,
                              void* stream) {
  if (Tn <= 0 || E <= 0 || V <= 0 || nseg <= 0) return cudaErrorInvalidValue;
  if (is_bf16 && (E % 8 || V % 8)) return cudaErrorInvalidValue;
  return launch(h, w, labels, part, nll, lse, Tn, E, V, vocab, nseg, is_bf16,
                static_cast<cudaStream_t>(stream));
}
