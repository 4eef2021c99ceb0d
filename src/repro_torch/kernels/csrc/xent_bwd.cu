// Fused elementwise pass of the cross-entropy backward, in place on one
// f32 vocab chunk of recomputed logits.
//
// Replaces the elementwise part of repro/kernels/xent/ops.py::_bwd_lse (jnp
// in the reference; the chunk's three products stay matmuls, as there).
// Wrapper and plain PyTorch version: repro_torch/kernels/xent/xent.py.
//
// For logits x (T, C) of vocab columns [col0, col0 + C), per token lse,
// label and cotangents (g_nll, g_lse):
//   p = exp(x - lse) for columns < vocab, else 0
//   x <- g_nll * (p - onehot(label)) + g_lse * p
// One launch instead of the six or so elementwise operations PyTorch would
// issue, each reading and writing the whole chunk.
//
// What bounds it on an H100: bytes.  The chunk is read once and written once
// (8 bytes per element) for ~5 FLOPs per element.  Each block walks rows
// (one per grid row, strided), reads the row's four scalars once, and
// streams the row's columns with 16-byte accesses where the chunk's width
// allows.

#include "common.cuh"

namespace {

template <int VEC>
__global__ void xent_bwd_kernel(float* __restrict__ x,
                                const float* __restrict__ lse,
                                const int* __restrict__ labels,
                                const float* __restrict__ g_nll,
                                const float* __restrict__ g_lse, int Tn,
                                int C, int col0, int vocab) {
  const int nvec = C / VEC;
  for (int row = blockIdx.y; row < Tn; row += gridDim.y) {
    const float L = lse[row], gn = g_nll[row], gl = g_lse[row];
    const int lab = labels[row];
    float* xr = x + (size_t)row * C;
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < nvec;
         i += gridDim.x * blockDim.x) {
      float t[VEC];
      if constexpr (VEC == 4) {
        const float4 raw = reinterpret_cast<const float4*>(xr)[i];
        t[0] = raw.x;
        t[1] = raw.y;
        t[2] = raw.z;
        t[3] = raw.w;
      } else {
        t[0] = xr[i];
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const int col = col0 + i * VEC + e;
        const float p = col < vocab ? expf(t[e] - L) : 0.f;
        const float onehot = col == lab ? 1.f : 0.f;
        t[e] = gn * (p - onehot) + gl * p;
      }
      if constexpr (VEC == 4) {
        reinterpret_cast<float4*>(xr)[i] = make_float4(t[0], t[1], t[2], t[3]);
      } else {
        xr[i] = t[0];
      }
    }
  }
}

template <int VEC>
cudaError_t launch(float* x, const float* lse, const int* labels,
                   const float* g_nll, const float* g_lse, int Tn, int C,
                   int col0, int vocab, cudaStream_t stream) {
  constexpr int NT = 256;
  const int nvec = C / VEC;
  dim3 grid(min((nvec + NT - 1) / NT, 64), min(Tn, 65535));
  xent_bwd_kernel<VEC><<<grid, NT, 0, stream>>>(x, lse, labels, g_nll, g_lse,
                                                Tn, C, col0, vocab);
  return cudaGetLastError();
}

}  // namespace

// x (T, C) f32 contiguous, the logits of vocab columns [col0, col0 + C),
// rewritten in place as d logits; lse, g_nll, g_lse (T,) f32, labels (T,)
// int32.  Returns the launch's cudaError_t.
extern "C" int repro_xent_bwd(float* x, const float* lse, const int* labels,
                              const float* g_nll, const float* g_lse, int Tn,
                              int C, int col0, int vocab, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Tn <= 0 || C <= 0) return cudaErrorInvalidValue;
  if (C % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0)
    return launch<4>(x, lse, labels, g_nll, g_lse, Tn, C, col0, vocab, s);
  return launch<1>(x, lse, labels, g_nll, g_lse, Tn, C, col0, vocab, s);
}
