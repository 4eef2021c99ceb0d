// The Mamba2 SSD (state-space duality) chunked scan, forward only.
//
// Replaces repro/kernels/ssd/ssd.py::_ssd_kernel.  Wrapper and plain
// PyTorch version: repro_torch/kernels/ssd/ssd.py.
//
// x (B, S, H, P) and B/C (B, S, G, N) in T (float or bf16), dt (B, S, H)
// and A (H,) f32; y (B, S, H, P) and the final state (B, H, P, N) f32.
// Per chunk of Q positions, with cum = inclusive cumsum of dt*A over the
// chunk and xs = dt * x:
//   y[i]  = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) xs_j   (intra-chunk)
//         + exp(cum_i) (C_i . h)                          (carried state)
//   h'    = exp(cum_Q) h + sum_j exp(cum_Q - cum_j) xs_j (x) B_j
// with h the state *before* the chunk.  Head h reads group g = h / (H/G);
// the groups are never repeated per head.
//
// Design.  The TPU kernel walks a grid (B, H, L) whose chunk axis L runs in
// order, keeping h in VMEM scratch across steps.  Hopper blocks run in no
// order, so one block owns a (batch, head, 32-column slice of P) and loops
// over the chunks itself, the state slice h[32 x N] held in shared memory.
// The P columns are independent (y[:, p] and h[p, :] read only x[:, p]), so
// slicing P gives B*H*P/32 blocks: 128 at the serving shape (B=1, H=64,
// P=64) for 132 SMs, where whole heads would give 64.  The price is that
// each slice recomputes C.B^T for its head (twice the least work at P=64).
// A 256 x 256 f32 score tile (256 KB) and f32 copies of a chunk's B and C
// (128 KB each at N=128) do not fit in the 227 KB a block has, so the
// chunk is cut into 64-row query tiles times 64-row key tiles, tiles above
// the diagonal skipped; the causal mask is a select applied before the
// product (exp(cum_i - cum_j) overflows above the diagonal, and inf*0 is
// NaN).  Rows past a ragged chunk (Q < 64) load as zeros.
//
// What bounds it on an H100: operations.  At the serving shape it does
// ~0.9 GFLOP of f32 FMAs per 512-token layer against ~12 MB moved.  Every
// product runs on the FMA pipes from shared memory with 16 x 16 threads
// owning register tiles (4 x 4 of the scores, 4 x 2 of y, N/16 x 2 of h);
// B and C are read from L2 (they are 128 KB for all 64 heads).  Tensor
// cores, TMA and computing C.B^T once per group (G=1 here, so once for all
// 64 heads) are the next steps.

#include "common.cuh"

namespace {

constexpr int NT = 256;       // threads per block: a 16 x 16 grid
constexpr int TILE = 64;      // query and key sub-tile of a chunk
constexpr int PB = 32;        // columns of P per block
constexpr int QMAX = NT;      // longest chunk: one position per thread
constexpr int LD = TILE + 4;  // row stride of the n-major C and B tiles

// The C tile n-major, or (in the state update) the B tile key-major.
template <int N>
__host__ __device__ constexpr int ct_floats() {
  return N * LD > TILE * (N + 4) ? N * LD : TILE * (N + 4);
}

template <int N>
__host__ __device__ constexpr int smem_floats() {
  return ct_floats<N>() + N * LD + TILE * LD + QMAX * PB + N * PB + 2 * QMAX
         + NT / 32;
}

// R consecutive floats of shared memory (16-byte aligned for R >= 4).
template <int R>
__device__ __forceinline__ void lds(const float* p, float* r) {
  if constexpr (R == 1) {
    r[0] = p[0];
  } else if constexpr (R == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    r[0] = v.x;
    r[1] = v.y;
  } else {
#pragma unroll
    for (int i = 0; i < R; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + i);
      r[i] = v.x;
      r[i + 1] = v.y;
      r[i + 2] = v.z;
      r[i + 3] = v.w;
    }
  }
}

// acc[i][j] += sum_k a[k * lda + ty * RM + i] * b[k * ldb + tx * RN + j]:
// a (K x 16 RM) times b (K x 16 RN), both k-major in shared memory.
template <int RM, int RN>
__device__ __forceinline__ void mma_smem(float (&acc)[RM][RN],
                                         const float* a, int lda,
                                         const float* b, int ldb, int K,
                                         int ty, int tx) {
  a += ty * RM;
  b += tx * RN;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float ra[RM], rb[RN];
    lds<RM>(a + k * lda, ra);
    lds<RN>(b + k * ldb, rb);
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(ra[i], rb[j], acc[i][j]);
  }
}

// TILE rows of N values (row stride rs elements) into f32 shared memory,
// rows >= nrows as zeros: n-major dst[n * LD + r] when N_MAJOR, else
// row-major dst[r * (N + 4) + n].
template <typename T, int N, bool N_MAJOR>
__device__ __forceinline__ void load_tile(const T* src, size_t rs, int nrows,
                                          float* dst) {
  constexpr int V = 16 / sizeof(T);     // elements per 16-byte load
  constexpr int CPR = N / V;            // loads per row
  for (int i = threadIdx.x; i < TILE * CPR; i += NT) {
    // n-major: neighbouring threads take neighbouring rows, so their
    // transposed stores land in distinct banks
    const int r = N_MAJOR ? i % TILE : i / CPR;
    const int c = N_MAJOR ? i / TILE : i % CPR;
    float v[V];
    if (r < nrows) {
      repro::cvt16<T>(repro::ld16(src + r * rs + c * V), v);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) v[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < V; ++e) {
      if constexpr (N_MAJOR)
        dst[(c * V + e) * LD + r] = v[e];
      else
        dst[r * (N + 4) + c * V + e] = v[e];
    }
  }
}

// Inclusive prefix sum of one value per thread over the block.
__device__ __forceinline__ float block_scan(float v, float* wsum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float n = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += n;
  }
  if (lane == 31) wsum[warp] = v;
  __syncthreads();
  float off = 0.f;
  for (int w = 0; w < warp; ++w) off += wsum[w];
  __syncthreads();
  return v + off;
}

template <typename T, int N>
__global__ void __launch_bounds__(NT)
    ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const T* __restrict__ Bm,
                    const T* __restrict__ Cm, float* __restrict__ y,
                    float* __restrict__ h_out, int S, int H, int P, int G,
                    int Q) {
  extern __shared__ __align__(16) float smem[];
  float* ct = smem;                    // C tile [N][LD]; B key-major later
  float* bt = ct + ct_floats<N>();     // B tile [N][LD]
  float* slt = bt + N * LD;            // masked scores, key-major [TILE][LD]
  float* xs = slt + TILE * LD;         // dt * x of the chunk [QMAX][PB]
  float* ht = xs + QMAX * PB;          // the state slice, n-major [N][PB]
  float* cum = ht + N * PB;            // [QMAX]
  float* dts = cum + QMAX;             // [QMAX]
  float* wsum = dts + QMAX;            // [NT / 32]

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int p0 = blockIdx.x * PB, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / G);
  const float a_h = A[h];
  const int ntiles = (Q + TILE - 1) / TILE;
  const size_t bc_rs = (size_t)G * N;  // row stride of B and C
  const size_t x_rs = (size_t)H * P;   // row stride of x and y

  for (int i = tid; i < N * PB; i += NT) ht[i] = 0.f;

  for (int q0 = 0; q0 < S; q0 += Q) {
    const size_t row0 = (size_t)b * S + q0;          // (b, q0) row index
    const float d = tid < Q ? dt[(row0 + tid) * H + h] : 0.f;
    const float cs = block_scan(d * a_h, wsum);      // past Q: cum[Q - 1]
    cum[tid] = cs;
    dts[tid] = d;
    __syncthreads();

    // xs = dt * x for this block's columns, rows past Q zero
    {
      constexpr int V = 16 / sizeof(T), CPR = PB / V;
      const T* xr = x + row0 * x_rs + (size_t)h * P + p0;
      for (int i = tid; i < ntiles * TILE * CPR; i += NT) {
        const int j = i / CPR, c = i % CPR;
        float v[V];
        if (j < Q) {
          repro::cvt16<T>(repro::ld16(xr + j * x_rs + c * V), v);
        } else {
#pragma unroll
          for (int e = 0; e < V; ++e) v[e] = 0.f;
        }
#pragma unroll
        for (int e = 0; e < V; ++e) xs[j * PB + c * V + e] = v[e] * dts[j];
      }
    }
    __syncthreads();

    const T* Bc = Bm + row0 * bc_rs + (size_t)g * N;
    const T* Cc = Cm + row0 * bc_rs + (size_t)g * N;
    for (int it = 0; it < ntiles; ++it) {
      const int i0 = it * TILE;
      load_tile<T, N, true>(Cc + i0 * bc_rs, bc_rs, Q - i0, ct);
      __syncthreads();
      // the carried state: exp(cum_i) (C_i . h), h from before the chunk
      float acc[4][2] = {};
      mma_smem<4, 2>(acc, ct, LD, ht, PB, N, ty, tx);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float e = expf(cum[i0 + ty * 4 + a]);
        acc[a][0] *= e;
        acc[a][1] *= e;
      }
      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * TILE;
        load_tile<T, N, true>(Bc + j0 * bc_rs, bc_rs, Q - j0, bt);
        __syncthreads();
        float s[4][4] = {};
        mma_smem<4, 4>(s, ct, LD, bt, LD, N, ty, tx);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int i = i0 + ty * 4 + a;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int j = j0 + tx * 4 + c;
            // mask first: above the diagonal the exponential may overflow
            slt[(tx * 4 + c) * LD + ty * 4 + a] =
                i >= j ? s[a][c] * expf(cum[i] - cum[j]) : 0.f;
          }
        }
        __syncthreads();
        mma_smem<4, 2>(acc, slt, LD, xs + j0 * PB, PB, TILE, ty, tx);
        __syncthreads();
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = i0 + ty * 4 + a;
        if (i < Q)
          *reinterpret_cast<float2*>(y + (row0 + i) * x_rs + (size_t)h * P +
                                     p0 + tx * 2) =
              make_float2(acc[a][0], acc[a][1]);
      }
    }

    // the state update: xs_j *= exp(cum_Q - cum_j), then h' = exp(cum_Q) h
    // + sum_j xs_j (x) B_j, B streamed key-major through the C buffer
    const float total = cum[Q - 1];
    for (int i = tid; i < ntiles * TILE * PB; i += NT)
      xs[i] *= expf(total - cum[i / PB]);
    __syncthreads();
    float hacc[N / 16][2] = {};
    for (int jt = 0; jt < ntiles; ++jt) {
      const int j0 = jt * TILE;
      load_tile<T, N, false>(Bc + j0 * bc_rs, bc_rs, Q - j0, ct);
      __syncthreads();
      mma_smem<N / 16, 2>(hacc, ct, N + 4, xs + j0 * PB, PB, TILE, ty, tx);
      __syncthreads();
    }
    const float decay = expf(total);
#pragma unroll
    for (int m = 0; m < N / 16; ++m)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float* hp = ht + (ty * (N / 16) + m) * PB + tx * 2 + c;
        *hp = decay * *hp + hacc[m][c];
      }
    __syncthreads();
  }

  float* ho = h_out + (((size_t)b * H + h) * P + p0) * N;
  for (int i = tid; i < N * PB; i += NT) ho[i] = ht[(i % N) * PB + i / N];
}

template <typename T, int N>
cudaError_t launch(const void* x, const float* dt, const float* A,
                   const void* Bm, const void* Cm, float* y, float* h_out,
                   int Bsz, int S, int H, int P, int G, int Q,
                   cudaStream_t stream) {
  const int smem = smem_floats<N>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  dim3 grid(P / PB, H, Bsz);
  ssd_scan_kernel<T, N><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), y, h_out, S, H, P, G, Q);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const float* dt, const float* A,
                     const void* Bm, const void* Cm, float* y, float* h_out,
                     int Bsz, int S, int H, int P, int G, int N, int Q,
                     cudaStream_t s) {
  switch (N) {
    case 16:
      return launch<T, 16>(x, dt, A, Bm, Cm, y, h_out, Bsz, S, H, P, G, Q, s);
    case 32:
      return launch<T, 32>(x, dt, A, Bm, Cm, y, h_out, Bsz, S, H, P, G, Q, s);
    case 64:
      return launch<T, 64>(x, dt, A, Bm, Cm, y, h_out, Bsz, S, H, P, G, Q, s);
    case 128:
      return launch<T, 128>(x, dt, A, Bm, Cm, y, h_out, Bsz, S, H, P, G, Q,
                            s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// x (B, S, H, P) and Bm/Cm (B, S, G, N) in bf16 (bf16 = 1) or f32, dt
// (B, S, H) and A (H,) f32, all contiguous; y (B, S, H, P) and h_out
// (B, H, P, N) f32.  Q is the chunk: 1 <= Q <= 256 and S % Q == 0; P % 32
// == 0, H % G == 0, N in {16, 32, 64, 128}.  Returns the launch's
// cudaError_t.
extern "C" int repro_ssd_scan(const void* x, const float* dt, const float* A,
                              const void* Bm, const void* Cm, float* y,
                              float* h_out, int Bsz, int S, int H, int P,
                              int G, int N, int Q, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Bsz <= 0 || S <= 0 || Q <= 0 || Q > QMAX || S % Q || P <= 0 ||
      P % PB || G <= 0 || H <= 0 || H % G)
    return cudaErrorInvalidValue;
  if (bf16)
    return dispatch<__nv_bfloat16>(x, dt, A, Bm, Cm, y, h_out, Bsz, S, H, P,
                                   G, N, Q, s);
  return dispatch<float>(x, dt, A, Bm, Cm, y, h_out, Bsz, S, H, P, G, N, Q,
                         s);
}
