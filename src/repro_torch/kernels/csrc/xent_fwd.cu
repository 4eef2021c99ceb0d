// Fused softmax cross-entropy forward over a vocab-tiled LM head.
//
// Replaces the TPU kernel repro/kernels/xent/xent.py::_xent_kernel
// (Pallas).  Wrapper and plain PyTorch version:
// repro_torch/kernels/xent/xent.py.
//
// For hidden h (T, E), head W (E, V) and labels (T,) it returns per token
//   lse = log sum_v exp(h.W[:, v])  over the real columns v < vocab
//   nll = lse - h.W[:, label]
// without ever writing the (T, V) logits: each 64x64 logits tile lives in
// registers only, and is folded into a running (max m, sum-exp l, label
// logit c) per row.
//
// What bounds it on an H100: the arithmetic, 2*T*E*V FLOPs (a (T x E) by
// (E x V) product) on O(T*E + E*V) bytes.  This first version runs that
// product on the f32 FMA pipes, not the tensor cores.  Its design:
//  - The TPU kernel carries (m, l, c) across the vocab axis of its grid in
//    its output refs, since a TPU grid runs the minor axis in order.  On a
//    GPU blocks run in no order, so here each block owns a tile of 64 token
//    rows and sweeps its vocab columns in its own loop, keeping (m, l, c)
//    in registers.
//  - One block per token tile would give only 128 blocks at the training
//    path's T = 4 * 2047 rows on 132 SMs; so the vocab is split into
//    `nseg` segments, one block per (token tile, segment), each writing a
//    partial (m, l, c), and a second small kernel merges the segments:
//    m = max m_s, l = sum l_s exp(m_s - m), c = sum c_s.
//  - A 64-row h tile is 256 KB in bf16 at E = 2048, more than a block's
//    shared memory, so h is not kept resident: both operands stream through
//    shared memory in chunks of 32 along E (h chunks are re-read from L2 for
//    every vocab tile), widened to f32 once.  Each thread accumulates a 4x8
//    register tile, so each shared-memory read feeds 2-3 FMAs.
//  - Columns >= vocab (the padded head, xent.py:48) and past V are masked to
//    -1e30; ragged token rows and E are masked too.

#include "common.cuh"

namespace {

using repro::NEG_INF;

constexpr int BT = 64;    // token rows per block
constexpr int BV = 64;    // vocab columns per tile
constexpr int BE = 32;    // hidden dims per chunk
constexpr int NT = 128;   // threads: 16 row groups x 8 column groups

template <typename T>
__global__ void __launch_bounds__(NT)
xent_fwd_kernel(const T* __restrict__ h, const T* __restrict__ w,
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
        Hs[r * HP + e] = (gr < Tn && ge < E)
                             ? repro::to_float<T>(h[(size_t)gr * E + ge])
                             : 0.f;
      }
      for (int x = tid; x < BE * BV; x += NT) {
        const int e = x / BV, cc = x % BV;
        const int ge = e0 + e, gc = col0 + cc;
        Ws[e * WP + cc] = (ge < E && gc < V)
                              ? repro::to_float<T>(w[(size_t)ge * V + gc])
                              : 0.f;
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

template <typename T>
cudaError_t launch(const void* h, const void* w, const int* labels,
                   float* part, float* nll, float* lse, int Tn, int E, int V,
                   int vocab, int nseg, cudaStream_t stream) {
  const int nvt = (V + BV - 1) / BV;
  const int tps = (nvt + nseg - 1) / nseg;
  dim3 grid((Tn + BT - 1) / BT, nseg);
  xent_fwd_kernel<T><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(w), labels, part, Tn, E,
      V, vocab, tps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  xent_merge_kernel<<<(Tn + 255) / 256, 256, 0, stream>>>(part, nll, lse, Tn,
                                                           nseg);
  return cudaGetLastError();
}

}  // namespace

// hidden (T,E), head_w (E,V) of one type, labels (T,) int32 -> nll, lse (T,)
// f32.  part: scratch of nseg*T*3 floats.  bf16 != 0 selects __nv_bfloat16,
// else float.  Returns the launches' cudaError_t.
extern "C" int repro_xent_fwd(const void* h, const void* w, const int* labels,
                              float* part, float* nll, float* lse, int Tn,
                              int E, int V, int vocab, int nseg, int bf16,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Tn <= 0 || E <= 0 || V <= 0 || nseg <= 0) return cudaErrorInvalidValue;
  if (bf16)
    return launch<__nv_bfloat16>(h, w, labels, part, nll, lse, Tn, E, V,
                                 vocab, nseg, s);
  return launch<float>(h, w, labels, part, nll, lse, Tn, E, V, vocab, nseg, s);
}
