// Paged flash-decode: one decode step of GQA attention over a paged KV
// cache, reading KV pages through a block table.
//
// Replaces the TPU kernel repro/kernels/flash_attention/paged.py::
// _paged_decode_kernel (Pallas).  Wrapper and plain PyTorch version:
// repro_torch/kernels/flash_attention/paged.py.
//
// What bounds it on an H100: memory.  Each (slot, kv head) reads its live
// keys and values once and does ~4*G*D FLOPs per key row of 2*D elements
// -- a few FLOPs per byte, far below the card's balance point.  So the
// design is about moving only the live bytes, in wide loads, with enough
// of them in flight:
//  - one block per (slot, kv head).  The block reads block_table[b, :] and
//    pos[b] itself (the TPU kernel had them scalar-prefetched into SMEM)
//    and walks only keys 0..pos[b]: the TPU kernel's sweep over every page
//    with masking gives the same result, since a masked key adds
//    exp(-1e30 - m) = 0, but reads the gap pages for nothing;
//  - a key row is read by a group of D*sizeof(T)/16 lanes with one 16-byte
//    load each, and scored against all G query heads of the kv head while
//    it sits in registers, so K and V are read once for the whole group;
//  - each lane group keeps its own f32 online softmax (m, l, acc) over a
//    strided subset of the keys, UNROLL keys per step with all their loads
//    issued before use; the groups' states are merged in shared memory at
//    the end.  Output acc / max(l, 1e-30), rounded to the input type once.
// Inactive slots (block-table row all 0, pos 0) read trash page 0 -- all
// zero -- and produce a finite output; a physical page id outside the pool
// is read as page 0, so a bad table can never read out of bounds.

#include "common.cuh"

namespace {

using repro::NEG_INF;

constexpr int NT = 128;      // threads per block
constexpr int UNROLL = 4;    // keys per lane group per step

template <typename T, int D, int G>
__global__ void __launch_bounds__(NT)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                    const T* __restrict__ v_pool,
                    const int* __restrict__ block_table,
                    const int* __restrict__ pos, T* __restrict__ out, int H,
                    int K, int P, int ps, int max_pages, float scale) {
  constexpr int VEC = 16 / sizeof(T);   // elements per lane per key row
  constexpr int LPK = D / VEC;          // lanes per key row
  static_assert(LPK <= 32 && 32 % LPK == 0, "a key row must fit one warp");
  constexpr int KPW = 32 / LPK;         // key rows per warp per load
  constexpr int NSLOT = (NT / 32) * KPW;   // lane groups per block
  __shared__ float sm_m[NSLOT][G], sm_l[NSLOT][G];
  __shared__ float sm_acc[NSLOT][G][D];

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sub = lane / LPK, d0 = (lane % LPK) * VEC;
  const int slot = warp * KPW + sub;

  float qr[G][VEC], m[G], l[G], acc[G][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    repro::cvt16<T>(repro::ld16(q + ((size_t)b * H + kvh * G + g) * D + d0),
                    qr[g]);
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      qr[g][e] *= scale;
      acc[g][e] = 0.f;
    }
  }

  const int n = min(max(pos[b] + 1, 0), max_pages * ps);   // live keys
  const int* bt = block_table + (size_t)b * max_pages;
  // every lane of a warp runs the same iterations (the shuffles need it);
  // keys past n are loaded from nowhere and masked out of the update
  for (int base = warp * KPW; base < n; base += NSLOT * UNROLL) {
    uint4 kraw[UNROLL], vraw[UNROLL];
    bool valid[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int key = base + u * NSLOT + sub;
      valid[u] = key < n;
      kraw[u] = vraw[u] = make_uint4(0, 0, 0, 0);
      if (valid[u]) {
        const int page = key / ps;
        int phys = bt[page];
        if (phys < 0 || phys >= P) phys = 0;
        const size_t off =
            (((size_t)phys * ps + (key - page * ps)) * K + kvh) * D + d0;
        kraw[u] = repro::ld16(k_pool + off);
        vraw[u] = repro::ld16(v_pool + off);
      }
    }
    float s[G][UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      float kf[VEC];
      repro::cvt16<T>(kraw[u], kf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) part = fmaf(qr[g][e], kf[e], part);
#pragma unroll
        for (int w = 1; w < LPK; w <<= 1)
          part += __shfl_xor_sync(0xffffffffu, part, w);
        s[g][u] = part;
      }
    }
    float vf[UNROLL][VEC];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) repro::cvt16<T>(vraw[u], vf[u]);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float m_new = m[g];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        if (valid[u]) m_new = fmaxf(m_new, s[g][u]);
      const float corr = expf(m[g] - m_new);
      float p[UNROLL], ps_sum = 0.f;
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        p[u] = valid[u] ? expf(s[g][u] - m_new) : 0.f;
        ps_sum += p[u];
      }
      l[g] = l[g] * corr + ps_sum;
      m[g] = m_new;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        float a = acc[g][e] * corr;
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) a = fmaf(p[u], vf[u][e], a);
        acc[g][e] = a;
      }
    }
  }

  // merge the lane groups' softmax states
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (d0 == 0) {
      sm_m[slot][g] = m[g];
      sm_l[slot][g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) sm_acc[slot][g][d0 + e] = acc[g][e];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * D; idx += NT) {
    const int g = idx / D, d = idx % D;
    float mx = NEG_INF;
#pragma unroll
    for (int s = 0; s < NSLOT; ++s) mx = fmaxf(mx, sm_m[s][g]);
    float lsum = 0.f, o = 0.f;
#pragma unroll
    for (int s = 0; s < NSLOT; ++s) {
      const float w = expf(sm_m[s][g] - mx);
      lsum += sm_l[s][g] * w;
      o += sm_acc[s][g][d] * w;
    }
    out[((size_t)b * H + kvh * G + g) * D + d] =
        repro::from_float<T>(o / fmaxf(lsum, 1e-30f));
  }
}

template <typename T, int D, int G>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const int* bt, const int* pos, void* out, int B, int H,
                   int K, int P, int ps, int max_pages, cudaStream_t stream) {
  const float scale = (float)(1.0 / sqrt((double)D));
  paged_decode_kernel<T, D, G><<<dim3(K, B), NT, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), bt, pos, static_cast<T*>(out), H, K, P,
      ps, max_pages, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t by_group(int G, const void* q, const void* k_pool,
                     const void* v_pool, const int* bt, const int* pos,
                     void* out, int B, int H, int K, int P, int ps,
                     int max_pages, cudaStream_t s) {
  switch (G) {
    case 1: return launch<T, D, 1>(q, k_pool, v_pool, bt, pos, out, B, H, K,
                                   P, ps, max_pages, s);
    case 2: return launch<T, D, 2>(q, k_pool, v_pool, bt, pos, out, B, H, K,
                                   P, ps, max_pages, s);
    case 4: return launch<T, D, 4>(q, k_pool, v_pool, bt, pos, out, B, H, K,
                                   P, ps, max_pages, s);
    case 8: return launch<T, D, 8>(q, k_pool, v_pool, bt, pos, out, B, H, K,
                                   P, ps, max_pages, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// q (B,H,D), k/v pools (P,ps,K,D), block_table (B,max_pages) int32,
// pos (B,) int32 -> out (B,H,D).  bf16 != 0 selects __nv_bfloat16, else
// float.  Returns the launch's cudaError_t; an unsupported head dim or
// group returns cudaErrorInvalidValue.
extern "C" int repro_paged_decode(const void* q, const void* k_pool,
                                  const void* v_pool, const int* block_table,
                                  const int* pos, void* out, int B, int H,
                                  int K, int D, int P, int ps, int max_pages,
                                  int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int G = H / K;
  if (bf16) {
    if (D == 64)
      return by_group<__nv_bfloat16, 64>(G, q, k_pool, v_pool, block_table,
                                         pos, out, B, H, K, P, ps, max_pages,
                                         s);
    if (D == 128)
      return by_group<__nv_bfloat16, 128>(G, q, k_pool, v_pool, block_table,
                                          pos, out, B, H, K, P, ps, max_pages,
                                          s);
  } else {
    if (D == 64)
      return by_group<float, 64>(G, q, k_pool, v_pool, block_table, pos, out,
                                 B, H, K, P, ps, max_pages, s);
    if (D == 128)
      return by_group<float, 128>(G, q, k_pool, v_pool, block_table, pos, out,
                                  B, H, K, P, ps, max_pages, s);
  }
  return cudaErrorInvalidValue;
}
