// The Mamba2 SSD (state-space duality) chunked scan, forward only.
//
// Replaces repro/kernels/ssd/ssd.py::_ssd_kernel.  Wrapper and plain
// PyTorch version: repro_torch/kernels/ssd/ssd.py.
//
// x (B, S, H, P) and B/C (B, S, G, N) in bf16 or f32, dt (B, S, H)
// and A (H,) f32; y (B, S, H, P) and the final state (B, H, P, N) f32.
// Per chunk of Q positions, with cum = inclusive cumsum of dt*A over the
// chunk and xs = dt * x:
//   y[i]  = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) xs_j   (intra-chunk)
//         + exp(cum_i) (C_i . h)                          (carried state)
//   h'    = exp(cum_Q) h + sum_j exp(cum_Q - cum_j) xs_j (x) B_j
// with h the state *before* the chunk.  Head h reads group g = h / (H/G);
// the groups are never repeated per head.
//
// Design both dtypes share.  The TPU kernel walks a grid (B, H, L) whose
// chunk axis L runs in order, keeping h in VMEM scratch across steps.
// Hopper blocks run in no order, so one block owns a (batch, head, slice of
// P columns) and loops over the chunks itself, carrying its slice of the
// state.  The P columns are independent (y[:, p] and h[p, :] read only
// x[:, p]), so slicing P into 32 columns gives B*H*P/32 blocks: 128 at
// the serving shape (B=1, H=64, P=64), for 132 SMs.  The price is that
// each slice recomputes C.B^T for its head.  The causal mask is a select
// applied before the exponential (exp(cum_i - cum_j) overflows above the
// diagonal, and inf*0 is NaN).  Rows past a ragged chunk load as zeros.
//
// The dtype selects the kernel; this is a dispatch, not a fallback:
//  - bf16 (the serving path): the three products on the tensor cores,
//    mma.sync.m16n8k16 with bf16 operands and f32 accumulation, 8 warps of
//    16 query rows.  A chunk's B rows (up to 256 x N) stay bf16 in shared
//    memory for the whole chunk; C comes in two passes of 128 rows, each
//    warp taking its 16 rows' C fragments into registers (ldmatrix) so the
//    next pass's C lands by cp.async while this one computes (pass 1 hands
//    the rows out in reverse, so every warp sees about as many keys).
//    S = C.B^T is exact per product (bf16 inputs, f32 sums), as the
//    reference's f32 dot over the same values.  S o L is formed in f32
//    registers in the accumulator layout, masked before the exponential,
//    only over 16-key blocks at or below the warp's rows.  Every other
//    operand is f32 (S o L, xs, h, xs * exp(cum_Q - cum)), and one bf16
//    rounding of it misses the 5e-4 tolerance, as would TF32; so each is
//    split a = hi + lo, hi = bf16(a), lo = bf16(a - hi) in f32, and the
//    products sum the bf16 parts (relative error ~2^-17):
//      (S o L).xs   hi.xh + hi.xl + lo.xh  (S o L fed from registers)
//      C.h          C.hh + C.hl            (C exact)
//      (xs o w)^T.B  xwh^T.B + xwl^T.B      (B exact)
//    The state slice stays in registers (f32) in the warps that own its
//    N/16 column blocks; after each chunk they write its hi/lo split, as
//    the next chunk's C.h operand, into shared memory.  32 columns a
//    block: 64-column blocks (half the C.B^T work, half the blocks) were
//    slower on the card at S=512 and S=2048.  What bounds it: at the
//    serving shape ~15 MB moved against ~1.6 GFLOP of least work at the
//    bf16 peak, so bytes; in practice the chain of dependent products
//    per chunk.
//  - f32: the FMA kernel of the first port.  A 256 x 256 f32 score tile
//    (256 KB) and f32 copies of a chunk's B and C (128 KB each at N=128) do
//    not fit in the 227 KB a block has, so the chunk is cut into 64-row
//    query tiles times 64-row key tiles, tiles above the diagonal skipped.
//    Every product runs on the FMA pipes from shared memory with 16 x 16
//    threads owning register tiles (4 x 4 of the scores, 4 x 2 of y, N/16
//    x 2 of h); B and C are read from L2.

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
template <int N, bool N_MAJOR>
__device__ __forceinline__ void load_tile(const float* src, size_t rs,
                                          int nrows, float* dst) {
  constexpr int V = 4;                  // floats per 16-byte load
  constexpr int CPR = N / V;            // loads per row
  for (int i = threadIdx.x; i < TILE * CPR; i += NT) {
    // n-major: neighbouring threads take neighbouring rows, so their
    // transposed stores land in distinct banks
    const int r = N_MAJOR ? i % TILE : i / CPR;
    const int c = N_MAJOR ? i / TILE : i % CPR;
    float v[V];
    if (r < nrows) {
      repro::cvt16<float>(repro::ld16(src + r * rs + c * V), v);
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

template <int N>
__global__ void __launch_bounds__(NT)
    ssd_scan_fma_kernel(const float* __restrict__ x,
                        const float* __restrict__ dt,
                        const float* __restrict__ A,
                        const float* __restrict__ Bm,
                        const float* __restrict__ Cm, float* __restrict__ y,
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
      constexpr int V = 4, CPR = PB / V;
      const float* xr = x + row0 * x_rs + (size_t)h * P + p0;
      for (int i = tid; i < ntiles * TILE * CPR; i += NT) {
        const int j = i / CPR, c = i % CPR;
        float v[V];
        if (j < Q) {
          repro::cvt16<float>(repro::ld16(xr + j * x_rs + c * V), v);
        } else {
#pragma unroll
          for (int e = 0; e < V; ++e) v[e] = 0.f;
        }
#pragma unroll
        for (int e = 0; e < V; ++e) xs[j * PB + c * V + e] = v[e] * dts[j];
      }
    }
    __syncthreads();

    const float* Bc = Bm + row0 * bc_rs + (size_t)g * N;
    const float* Cc = Cm + row0 * bc_rs + (size_t)g * N;
    for (int it = 0; it < ntiles; ++it) {
      const int i0 = it * TILE;
      load_tile<N, true>(Cc + i0 * bc_rs, bc_rs, Q - i0, ct);
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
        load_tile<N, true>(Bc + j0 * bc_rs, bc_rs, Q - j0, bt);
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
      load_tile<N, false>(Bc + j0 * bc_rs, bc_rs, Q - j0, ct);
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

template <int N>
cudaError_t launch_fma(const float* x, const float* dt, const float* A,
                       const float* Bm, const float* Cm, float* y,
                       float* h_out, int Bsz, int S, int H, int P, int G,
                       int Q, cudaStream_t stream) {
  const int smem = smem_floats<N>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_fma_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  dim3 grid(P / PB, H, Bsz);
  ssd_scan_fma_kernel<N><<<grid, NT, smem, stream>>>(x, dt, A, Bm, Cm, y,
                                                     h_out, S, H, P, G, Q);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: tensor-core kernel
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int QT = 128;   // query rows per pass: 8 warps of 16
constexpr int KT = 64;    // keys per score tile

// Byte offsets of the bf16 kernel's shared memory.  Rows of the bf16 tiles
// are padded by 16 bytes, so the 8 rows one ldmatrix reads fall in 8 bank
// groups.
template <int N>
struct MmaSmem {
  static constexpr int NP = N + 8;      // pitch of the B and C tiles
  static constexpr int XP = PB + 8;     // pitch of the x and h tiles
  static constexpr int B_OFF = 0;                          // [QMAX][NP]
  static constexpr int C_OFF = B_OFF + QMAX * NP * 2;      // [QT][NP]
  static constexpr int XH_OFF = C_OFF + QT * NP * 2;       // [QMAX][XP]
  static constexpr int XL_OFF = XH_OFF + QMAX * XP * 2;    // [QMAX][XP]
  static constexpr int HH_OFF = XL_OFF + QMAX * XP * 2;    // [N][XP]
  static constexpr int HL_OFF = HH_OFF + N * XP * 2;       // [N][XP]
  static constexpr int CUM_OFF = HL_OFF + N * XP * 2;      // [QMAX] f32
  static constexpr int DT_OFF = CUM_OFF + QMAX * 4;        // [QMAX] f32
  static constexpr int WS_OFF = DT_OFF + QMAX * 4;         // [NT / 32] f32
  static constexpr int BYTES = WS_OFF + NT / 32 * 4;
  static_assert(BYTES <= 232448, "fits the 227 KB a block can have");
};

// a0, a1 = hi + lo, hi = bf16(a) and lo = bf16(a - hi) computed in f32;
// each pair packed as one bf16x2 register, a0 in the low half.
__device__ __forceinline__ void split2(float a0, float a1, uint32_t& hi,
                                       uint32_t& lo) {
  hi = repro::pack_bf16(a0, a1);
  // a bf16 is the high half of the f32 with the same value
  lo = repro::pack_bf16(a0 - __uint_as_float(hi << 16),
                        a1 - __uint_as_float(hi & 0xffff0000u));
}

// The C tiles c0, c1 (16 rows x 16 columns, f32) as the hi and lo bf16 A
// fragments of one 16-deep slice (repro::pack_a's layout).
__device__ __forceinline__ void split_a(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                        const float (&c0)[4],
                                        const float (&c1)[4]) {
  split2(c0[0], c0[1], hi[0], lo[0]);
  split2(c0[2], c0[3], hi[1], lo[1]);
  split2(c1[0], c1[1], hi[2], lo[2]);
  split2(c1[2], c1[3], hi[3], lo[3]);
}

// cp.async of rows [r0, r1) of a bf16 (., N) operand at row stride rs into
// dst rows 0.. (pitch N + 8); rows >= nrows are zero.
template <int N>
__device__ __forceinline__ void tile_async(bf16* dst, const bf16* src,
                                           size_t rs, int r0, int r1,
                                           int nrows) {
  constexpr int CPR = N / 8;   // 16-byte chunks per row
  for (int c = threadIdx.x; c < (r1 - r0) * CPR; c += NT) {
    const int r = r0 + c / CPR, ch = c % CPR;
    const bool live = r < nrows;
    repro::cp_async16(dst + (r - r0) * (N + 8) + ch * 8,
                      live ? src + r * rs + ch * 8 : src, live);
  }
}

// xs_j = dt_j * x_j, times w_j = exp(total - cum_j) where `decay`, for rows
// [0, nr) of the block's PB columns of x (row stride rs), split into the
// bf16 tiles Xh and Xl [j][p]; rows >= Q are zero.
__device__ __forceinline__ void split_x(bf16* Xh, bf16* Xl, const bf16* xr,
                                        size_t rs, int nr, int Q,
                                        const float* dts, const float* cum,
                                        bool decay, float total) {
  constexpr int CPR = PB / 8, XP = PB + 8;
  for (int i = threadIdx.x; i < nr * CPR; i += NT) {
    const int j = i / CPR, c = i % CPR;
    uint32_t hi[4] = {}, lo[4] = {};
    if (j < Q) {
      float v[8];
      repro::cvt16<bf16>(repro::ld16(xr + j * rs + c * 8), v);
      const float w = decay ? expf(total - cum[j]) : 1.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float a0 = v[2 * e] * dts[j], a1 = v[2 * e + 1] * dts[j];
        if (decay) {
          a0 *= w;
          a1 *= w;
        }
        split2(a0, a1, hi[e], lo[e]);
      }
    }
    *reinterpret_cast<uint4*>(Xh + j * XP + c * 8) =
        make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(Xl + j * XP + c * 8) =
        make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
}

// One block per (PB columns of P, head, batch); 8 warps.  In a pass warp
// w owns query rows r0..r0+15; lane l holds rows r0 + l/4 and r0 + l/4 + 8
// and, in each n8 tile, columns 2(l%4) and 2(l%4) + 1.  Warp w < N/16 owns
// the state's columns n = 16w..16w+15 for all PB rows p.
template <int N>
__global__ void __launch_bounds__(NT, 1)
    ssd_scan_mma_kernel(const bf16* __restrict__ x,
                        const float* __restrict__ dt,
                        const float* __restrict__ A,
                        const bf16* __restrict__ Bm,
                        const bf16* __restrict__ Cm, float* __restrict__ y,
                        float* __restrict__ h_out, int S, int H, int P, int G,
                        int Q) {
  using L = MmaSmem<N>;
  constexpr int NP = L::NP, XP = L::XP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Bs = reinterpret_cast<bf16*>(smem_raw + L::B_OFF);
  bf16* Cs = reinterpret_cast<bf16*>(smem_raw + L::C_OFF);
  bf16* Xh = reinterpret_cast<bf16*>(smem_raw + L::XH_OFF);
  bf16* Xl = reinterpret_cast<bf16*>(smem_raw + L::XL_OFF);
  bf16* Hh = reinterpret_cast<bf16*>(smem_raw + L::HH_OFF);
  bf16* Hl = reinterpret_cast<bf16*>(smem_raw + L::HL_OFF);
  float* cum = reinterpret_cast<float*>(smem_raw + L::CUM_OFF);
  float* dts = reinterpret_cast<float*>(smem_raw + L::DT_OFF);
  float* wsum = reinterpret_cast<float*>(smem_raw + L::WS_OFF);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int p0 = blockIdx.x * PB, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / G);
  const float a_h = A[h];
  const int Qk = (Q + 15) & ~15;       // rows the products read
  const int npass = (Qk + QT - 1) / QT;
  const size_t bc_rs = (size_t)G * N;  // row stride of B and C
  const size_t x_rs = (size_t)H * P;   // row stride of x and y

  // the warp's state columns, f32; the first chunk skips C.h, and every
  // chunk leaves the split of its state in Hh and Hl for the next
  float hs[PB / 16][2][4] = {};

  for (int q0 = 0; q0 < S; q0 += Q) {
    const size_t row0 = (size_t)b * S + q0;          // (b, q0) row index
    const bf16* Bc = Bm + row0 * bc_rs + (size_t)g * N;
    const bf16* Cc = Cm + row0 * bc_rs + (size_t)g * N;
    const bf16* xr = x + row0 * x_rs + (size_t)h * P + p0;
    tile_async<N>(Bs, Bc, bc_rs, 0, Qk, Q);
    tile_async<N>(Cs, Cc, bc_rs, 0, min(QT, Qk), Q);
    repro::cp_async_commit();

    const float d = tid < Q ? dt[(row0 + tid) * H + h] : 0.f;
    const float cs = block_scan(d * a_h, wsum);      // past Q: cum[Q - 1]
    cum[tid] = cs;
    dts[tid] = d;
    __syncthreads();
    split_x(Xh, Xl, xr, x_rs, Qk, Q, dts, cum, false, 0.f);
    repro::cp_async_wait<0>();

    for (int pass = 0; pass < npass; ++pass) {
      if (pass > 0) repro::cp_async_wait<0>();
      __syncthreads();   // this pass's C rows (on pass 0: B, X too) landed
      const int r0 =
          pass * QT + 16 * (pass ? NT / 32 - 1 - warp : warp);
      const bool active = r0 < Q;
      uint32_t ca[N / 16][4];   // the warp's C rows as A fragments
      if (active) {
#pragma unroll
        for (int kk = 0; kk < N / 16; ++kk)
          repro::ldsm4(ca[kk], Cs + (r0 - pass * QT + lane % 16) * NP
                                   + kk * 16 + (lane / 16) * 8);
      }
      __syncthreads();   // every warp holds its fragments: Cs is free
      if (pass + 1 < npass) {
        tile_async<N>(Cs, Cc, bc_rs, QT, Qk, Q);
        repro::cp_async_commit();
      }
      if (!active) continue;

      const int ri[2] = {r0 + lane / 4, r0 + lane / 4 + 8};
      const float ci[2] = {cum[ri[0]], cum[ri[1]]};
      float acc[PB / 8][4] = {};
      // the carried state: exp(cum_i) (C_i . h), h from before the chunk
      if (q0 > 0) {
#pragma unroll
        for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
          for (int n = 0; n < PB / 16; ++n) {
            const int off = (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * XP
                            + n * 16 + (lane / 16) * 8;
            uint32_t bh[4], bl[4];
            repro::ldsm4_t(bh, Hh + off);
            repro::ldsm4_t(bl, Hl + off);
            repro::mma_bf16(acc[2 * n], ca[kk], bh[0], bh[1]);
            repro::mma_bf16(acc[2 * n + 1], ca[kk], bh[2], bh[3]);
            repro::mma_bf16(acc[2 * n], ca[kk], bl[0], bl[1]);
            repro::mma_bf16(acc[2 * n + 1], ca[kk], bl[2], bl[3]);
          }
        const float e[2] = {expf(ci[0]), expf(ci[1])};
#pragma unroll
        for (int n = 0; n < PB / 8; ++n)
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[n][k] *= e[k / 2];
      }

      // intra-chunk, over 16-key blocks at or below the warp's rows
      for (int k0 = 0; k0 <= r0; k0 += KT) {
        const int nb = min(KT / 16, (r0 - k0) / 16 + 1);
        float s[KT / 8][4] = {};
#pragma unroll
        for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
          for (int n = 0; n < KT / 16; ++n) {
            if (n >= nb) continue;
            uint32_t bm[4];
            repro::ldsm4(bm, Bs + (k0 + n * 16 + lane % 8 + (lane / 16) * 8)
                                     * NP
                                 + kk * 16 + ((lane / 8) % 2) * 8);
            repro::mma_bf16(s[2 * n], ca[kk], bm[0], bm[1]);
            repro::mma_bf16(s[2 * n + 1], ca[kk], bm[2], bm[3]);
          }
        // S o L; mask first: above the diagonal the exponential may overflow
#pragma unroll
        for (int n = 0; n < KT / 8; ++n)
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int i = ri[k / 2];
            const int j = k0 + n * 8 + (lane % 4) * 2 + (k & 1);
            s[n][k] = i >= j ? s[n][k] * expf(ci[k / 2] - cum[j]) : 0.f;
          }
#pragma unroll
        for (int kb = 0; kb < KT / 16; ++kb) {
          if (kb >= nb) continue;
          uint32_t ah[4], al[4];
          split_a(ah, al, s[2 * kb], s[2 * kb + 1]);
#pragma unroll
          for (int n = 0; n < PB / 16; ++n) {
            const int off =
                (k0 + kb * 16 + lane % 8 + ((lane / 8) % 2) * 8) * XP
                + n * 16 + (lane / 16) * 8;
            uint32_t xh[4], xl[4];
            repro::ldsm4_t(xh, Xh + off);
            repro::ldsm4_t(xl, Xl + off);
            repro::mma_bf16(acc[2 * n], ah, xh[0], xh[1]);
            repro::mma_bf16(acc[2 * n + 1], ah, xh[2], xh[3]);
            repro::mma_bf16(acc[2 * n], ah, xl[0], xl[1]);
            repro::mma_bf16(acc[2 * n + 1], ah, xl[2], xl[3]);
            repro::mma_bf16(acc[2 * n], al, xh[0], xh[1]);
            repro::mma_bf16(acc[2 * n + 1], al, xh[2], xh[3]);
          }
        }
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        if (ri[hh] >= Q) continue;
        float* yr = y + (row0 + ri[hh]) * x_rs + (size_t)h * P + p0
                    + (lane % 4) * 2;
#pragma unroll
        for (int n = 0; n < PB / 8; ++n)
          *reinterpret_cast<float2*>(yr + n * 8) =
              make_float2(acc[n][2 * hh], acc[n][2 * hh + 1]);
      }
    }

    // the state update: h' = exp(cum_Q) h + (xs o w)^T . B, w_j =
    // exp(cum_Q - cum_j); X is re-read from global memory (L2) and split
    __syncthreads();   // every warp is done with Xh and Xl
    const float total = cum[Q - 1];
    split_x(Xh, Xl, xr, x_rs, Qk, Q, dts, cum, true, total);
    __syncthreads();
    if (warp < N / 16) {
      float hn[PB / 16][2][4] = {};
      for (int kb = 0; kb < Qk / 16; ++kb) {
        uint32_t bm[4];
        repro::ldsm4_t(bm, Bs + (kb * 16 + lane % 8 + ((lane / 8) % 2) * 8)
                                   * NP
                               + warp * 16 + (lane / 16) * 8);
#pragma unroll
        for (int m = 0; m < PB / 16; ++m) {
          const int off = (kb * 16 + lane % 8 + (lane / 16) * 8) * XP
                          + m * 16 + ((lane / 8) % 2) * 8;
          uint32_t ah[4], al[4];
          repro::ldsm4_t(ah, Xh + off);
          repro::ldsm4_t(al, Xl + off);
          repro::mma_bf16(hn[m][0], ah, bm[0], bm[1]);
          repro::mma_bf16(hn[m][1], ah, bm[2], bm[3]);
          repro::mma_bf16(hn[m][0], al, bm[0], bm[1]);
          repro::mma_bf16(hn[m][1], al, bm[2], bm[3]);
        }
      }
      const float decay = expf(total);
      // the next chunk's C.h operand: h split into bf16 hi and lo, [n][p]
#pragma unroll
      for (int m = 0; m < PB / 16; ++m)
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float v = decay * hs[m][t][k] + hn[m][t][k];
            hs[m][t][k] = v;
            const int p = m * 16 + lane / 4 + 8 * (k / 2);
            const int n = warp * 16 + t * 8 + (lane % 4) * 2 + (k & 1);
            const bf16 hi = __float2bfloat16(v);
            Hh[n * XP + p] = hi;
            Hl[n * XP + p] = __float2bfloat16(v - __bfloat162float(hi));
          }
    }
    __syncthreads();   // Hh, Hl written; Bs, Xh, Xl and cum free again
  }

  if (warp < N / 16) {
    float* ho = h_out + (((size_t)b * H + h) * P + p0) * N;
#pragma unroll
    for (int m = 0; m < PB / 16; ++m)
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int p = m * 16 + lane / 4 + 8 * hh;
          const int n = warp * 16 + t * 8 + (lane % 4) * 2;
          *reinterpret_cast<float2*>(ho + (size_t)p * N + n) =
              make_float2(hs[m][t][2 * hh], hs[m][t][2 * hh + 1]);
        }
  }
}

template <int N>
cudaError_t launch_mma(const void* x, const float* dt, const float* A,
                       const void* Bm, const void* Cm, float* y,
                       float* h_out, int Bsz, int S, int H, int P, int G,
                       int Q, cudaStream_t stream) {
  constexpr int smem = MmaSmem<N>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_mma_kernel<N>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(P / PB, H, Bsz);
  ssd_scan_mma_kernel<N><<<grid, NT, smem, stream>>>(
      static_cast<const bf16*>(x), dt, A, static_cast<const bf16*>(Bm),
      static_cast<const bf16*>(Cm), y, h_out, S, H, P, G, Q);
  return cudaGetLastError();
}

cudaError_t dispatch_mma(const void* x, const float* dt, const float* A,
                         const void* Bm, const void* Cm, float* y,
                         float* h_out, int Bsz, int S, int H, int P, int G,
                         int N, int Q, cudaStream_t s) {
  switch (N) {
    case 16:
      return launch_mma<16>(x, dt, A, Bm, Cm, y, h_out, Bsz, S, H, P, G, Q,
                            s);
    case 32:
      return launch_mma<32>(x, dt, A, Bm, Cm, y, h_out, Bsz, S, H, P, G, Q,
                            s);
    case 64:
      return launch_mma<64>(x, dt, A, Bm, Cm, y, h_out, Bsz, S, H, P, G, Q,
                            s);
    case 128:
      return launch_mma<128>(x, dt, A, Bm, Cm, y, h_out, Bsz, S, H, P, G, Q,
                             s);
  }
  return cudaErrorInvalidValue;
}

cudaError_t dispatch_fma(const float* x, const float* dt, const float* A,
                         const float* Bm, const float* Cm, float* y,
                         float* h_out, int Bsz, int S, int H, int P, int G,
                         int N, int Q, cudaStream_t s) {
  switch (N) {
    case 16:
      return launch_fma<16>(x, dt, A, Bm, Cm, y, h_out, Bsz, S, H, P, G,
                            Q, s);
    case 32:
      return launch_fma<32>(x, dt, A, Bm, Cm, y, h_out, Bsz, S, H, P, G,
                            Q, s);
    case 64:
      return launch_fma<64>(x, dt, A, Bm, Cm, y, h_out, Bsz, S, H, P, G,
                            Q, s);
    case 128:
      return launch_fma<128>(x, dt, A, Bm, Cm, y, h_out, Bsz, S, H, P, G,
                             Q, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// x (B, S, H, P) and Bm/Cm (B, S, G, N) in bf16 (bf16 = 1: the tensor-core
// kernel) or f32 (the FMA kernel), dt (B, S, H) and A (H,) f32, all
// contiguous; y (B, S, H, P) and h_out (B, H, P, N) f32.  Q is the chunk:
// 1 <= Q <= 256 and S % Q == 0; P % 32 == 0, H % G == 0, N in {16, 32,
// 64, 128}.  Returns the launch's cudaError_t.
extern "C" int repro_ssd_scan(const void* x, const float* dt, const float* A,
                              const void* Bm, const void* Cm, float* y,
                              float* h_out, int Bsz, int S, int H, int P,
                              int G, int N, int Q, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Bsz <= 0 || S <= 0 || Q <= 0 || Q > QMAX || S % Q || P <= 0 ||
      P % PB || G <= 0 || H <= 0 || H % G)
    return cudaErrorInvalidValue;
  if (bf16)
    return dispatch_mma(x, dt, A, Bm, Cm, y, h_out, Bsz, S, H, P, G, N, Q, s);
  return dispatch_fma(static_cast<const float*>(x), dt, A,
                      static_cast<const float*>(Bm),
                      static_cast<const float*>(Cm), y, h_out, Bsz, S, H, P,
                      G, N, Q, s);
}
