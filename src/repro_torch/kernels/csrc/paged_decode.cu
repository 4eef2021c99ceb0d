// Paged flash-decode: one decode step of GQA attention over a paged KV
// cache, reading KV pages through a block table.
//
// Replaces the TPU kernel repro/kernels/flash_attention/paged.py::
// _paged_decode_kernel (Pallas).  Wrapper and plain PyTorch version:
// repro_torch/kernels/flash_attention/paged.py.
//
// What bounds it on an H100: memory.  Each (slot, kv head) reads its live
// keys and values once and does ~4*G*D FLOPs per key row of 2*D elements
// -- a few FLOPs per byte, far below the card's balance point.  At serving
// sizes (8 slots, ~600 live keys each) the bytes are ~1.2 MB, so what the
// kernel must beat is latency: enough loads in flight at once, and one
// launch.  The TPU kernel's grid (B, K, max_pages) runs its page axis in
// order; here that axis runs in parallel:
//  - a thread-block cluster of SPLIT = 8 blocks per (slot, kv head): grid
//    (SPLIT, K, B), cluster dims (SPLIT, 1, 1), so 8 x 4 x 8 = 256 blocks at
//    the serving shape where one block per (slot, kv head) gave 32.  Rank r
//    owns a contiguous run of the slot's live keys, ceil(tiles / SPLIT)
//    tiles of TK keys (bf16: 64 keys, one page of the serving cache; f32:
//    near 8 KB of K and of V, Shape<D>).  The block reads
//    block_table[b, :] and pos[b] itself (the row prefetched to L2 beside
//    pos[b], as the TPU kernel scalar-prefetched both) and walks only keys
//    0..pos[b];
//  - a tile comes into shared memory by 16-byte cp.async through the block
//    table, in a 2-stage ring: tile t+1 loads while tile t is scored.  Keys
//    past pos[b] are zero-filled and masked; a physical page id outside the
//    pool is read as page 0, so a bad table never reads out of bounds;
//  - the dtype selects how a tile is scored (a dispatch, not a fallback):
//    bf16 (the serving path) on the tensor cores, as a flash-decode step:
//    the kv head's G query heads are the M rows of mma.sync.m16n8k16
//    (padded to 16, the pad rows zero), each of the 4 warps takes 16 keys
//    of a 64-key tile, S = q.K^T (K read with ldmatrix) is scaled in f32
//    and folded into the warp's online softmax in the log2 domain (ex2 on
//    the SFU), and p is rounded to bf16 once to enter P.V from registers
//    (V read with ldmatrix.trans), as the flash forward does; l sums the
//    f32 p.  On the FMA pipes, scoring the tiles was the largest cost of
//    a launch at the serving shape after its fixed one.  At D = 256 the
//    accumulator takes 128 registers a lane, so q's fragments are read
//    from shared memory each tile instead of kept.  f32: a key row is read from shared memory
//    by a group of 16 or 32 lanes, 16 bytes at a time (Shape<D>: at D = 80
//    12 lanes of 32 idle, at 256 two chunks a lane), and scored against
//    all G query heads on the FMA pipes, each lane
//    group keeping its own f32 online softmax (m, l, acc) over UNROLL keys
//    of every tile (the f32 tolerance, 2e-5, would not survive bf16 p).
//    Either
//    way K and V are read once for the whole group, and the block merges
//    its partial states in shared memory into one (m, l, acc[G][D]);
//  - after cluster.sync() each rank merges a share of the (g, d) outputs
//    from all SPLIT ranks' states through distributed shared memory, in
//    rank order, and writes acc / max(l, 1e-30) rounded once to the input
//    type; a final cluster.sync() keeps every rank's shared memory alive
//    until the reads are done.  Deterministic: no atomics, no workspace, no
//    second launch.
// A rank with no keys contributes m = -1e30, l = 0.  Inactive slots
// (block-table row all 0, pos 0) read trash page 0 -- all zero -- and
// produce a finite output.

#include <cooperative_groups.h>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;
using repro::NEG_INF;

constexpr int NT = 128;      // threads per block: 4 warps
constexpr int SPLIT = 8;     // blocks per cluster: the portable maximum
constexpr int MK = 64;       // keys per bf16 tile: 16 per warp

// The keys [begin, end) of the slot's live keys [0, pos[b]] that this
// rank owns: a run of ceil(tiles / SPLIT) tiles of TK keys.
template <int TK>
struct RankKeys {
  int begin, end, tiles;
  // bt is the slot's block-table row: its 128-byte lines go to L2 while
  // pos[b] is in flight, so the first page ids are one trip nearer
  __device__ RankKeys(const int* bt, const int* pos_b, int max_pages, int ps,
                      int rank) {
    for (int i = threadIdx.x * 32; i < max_pages; i += NT * 32)
      asm volatile("prefetch.global.L2 [%0];" ::"l"(bt + i));
    const int n = min(max(*pos_b + 1, 0), max_pages * ps);
    const int per = ((n + TK - 1) / TK + SPLIT - 1) / SPLIT;
    begin = min(rank * per * TK, n);
    end = min(begin + per * TK, n);
    tiles = (end - begin + TK - 1) / TK;
  }
};

// cp.async of keys [key0, key0 + TK) of kv head `kvh` through the block
// table `bt` into dst rows of `pitch` elements, K at ks and V at vs; keys
// past `end` are zero, and a physical page id outside the pool reads page 0.
template <typename T, int TK, int D>
__device__ __forceinline__ void tile_async(T* ks, T* vs, int pitch,
                                           const T* k_pool, const T* v_pool,
                                           const int* bt, int key0, int end,
                                           int ps, int P, int K, int kvh) {
  constexpr int VEC = 16 / sizeof(T), CPR = D / VEC;
  static_assert(TK * CPR % NT == 0, "whole chunks per thread");
#pragma unroll
  for (int i = 0; i < TK * CPR / NT; ++i) {
    const int c = threadIdx.x + i * NT;
    const int r = c / CPR, ch = c % CPR;
    const int key = key0 + r;
    const bool live = key < end;
    size_t off = 0;
    if (live) {
      const int page = key / ps;
      int phys = bt[page];
      if (phys < 0 || phys >= P) phys = 0;
      off = (((size_t)phys * ps + (key - page * ps)) * K + kvh) * D
            + ch * VEC;
    }
    repro::cp_async16(ks + r * pitch + ch * VEC, k_pool + off, live);
    repro::cp_async16(vs + r * pitch + ch * VEC, v_pool + off, live);
  }
  repro::cp_async_commit();
}

// The block's NS partial states (m in natural-log units, l, acc [NS][G][D]
// in shared memory) merged in order into this rank's state st_*; sm_m is
// overwritten with the weights.
template <int NS, int G, int D>
__device__ __forceinline__ void merge_block(float (&sm_m)[NS][G],
                                            const float (&sm_l)[NS][G],
                                            const float* sm_acc,
                                            float (&st_m)[G], float (&st_l)[G],
                                            float (&st_acc)[G][D]) {
  __syncthreads();
  if (threadIdx.x < G) {   // each state's weight exp(m - max m), and l
    const int g = threadIdx.x;
    float mx = NEG_INF, lsum = 0.f;
#pragma unroll
    for (int s = 0; s < NS; ++s) mx = fmaxf(mx, sm_m[s][g]);
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      sm_m[s][g] = expf(sm_m[s][g] - mx);
      lsum += sm_l[s][g] * sm_m[s][g];
    }
    st_m[g] = mx;
    st_l[g] = lsum;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * D; idx += NT) {
    const int g = idx / D, d = idx % D;
    float o = 0.f;
#pragma unroll
    for (int s = 0; s < NS; ++s) o += sm_acc[(s * G + g) * D + d] * sm_m[s][g];
    st_acc[g][d] = o;
  }
}

// The SPLIT ranks' states merged through distributed shared memory, in
// rank order: rank r writes outputs r*NT + tid, r*NT + tid + SPLIT*NT, ...
// of out_bk (the G heads of one (slot, kv head)), acc / max(l, 1e-30)
// rounded once to T.  Every thread of every rank must call it.
template <typename T, int G, int D>
__device__ __forceinline__ void merge_ranks(cg::cluster_group& cluster,
                                            int rank, float (&st_m)[G],
                                            float (&st_l)[G],
                                            float (&st_acc)[G][D], T* out_bk) {
  cluster.sync();
  for (int idx = rank * NT + threadIdx.x; idx < G * D; idx += SPLIT * NT) {
    const int g = idx / D, d = idx % D;
    float rm[SPLIT], mx = NEG_INF;
#pragma unroll
    for (int r = 0; r < SPLIT; ++r) {
      rm[r] = *cluster.map_shared_rank(&st_m[g], r);
      mx = fmaxf(mx, rm[r]);
    }
    float lsum = 0.f, o = 0.f;
#pragma unroll
    for (int r = 0; r < SPLIT; ++r) {
      const float w = expf(rm[r] - mx);
      lsum += *cluster.map_shared_rank(&st_l[g], r) * w;
      o += *cluster.map_shared_rank(&st_acc[g][d], r) * w;
    }
    out_bk[idx] = repro::from_float<T>(o / fmaxf(lsum, 1e-30f));
  }
  cluster.sync();   // no rank exits while another still reads its state
}

// ---------------------------------------------------------------------------
// f32: FMA kernel
// ---------------------------------------------------------------------------

// A key row of D floats is CH = D/4 16-byte chunks, read by a group of
// LPK lanes (16, or 32 above 64 dims), CPL chunks a lane: one at D = 64
// and 128, two at 256; at D = 80 (20 chunks) lanes 20..31 of the group
// hold none and stay idle.  Each group scores UNROLL keys of a tile, the
// tile near 8 KB of K, its chunks whole a thread (TK * CH % NT == 0).
constexpr int unroll_for(int D, int nslot) {
  int u = 8192 / (nslot * D * 4);
  u = u > 0 ? u : 1;
  while (nslot * u * (D / 4) % NT) ++u;
  return u;
}

template <int D>
struct Shape {
  static constexpr int VEC = 4;                 // floats per 16-byte chunk
  static constexpr int CH = D / VEC;            // chunks per key row
  static constexpr int LPK = CH <= 16 ? 16 : 32;   // lanes per key row
  static constexpr int CPL = (CH + LPK - 1) / LPK; // chunks per lane
  static constexpr int KPW = 32 / LPK;          // key rows per warp
  static constexpr int NSLOT = (NT / 32) * KPW; // lane groups per block
  static constexpr int UNROLL = unroll_for(D, NSLOT);   // keys a group
  static constexpr int TK = NSLOT * UNROLL;     // keys per tile
  static constexpr int TILE_BYTES = TK * D * 4; // one tile of K (or V)
  static_assert(D % VEC == 0 && CH <= 2 * 32, "a key row in one warp");
};

template <int D, int G>
__global__ void __cluster_dims__(SPLIT, 1, 1) __launch_bounds__(NT)
paged_decode_fma_kernel(const float* __restrict__ q,
                        const float* __restrict__ k_pool,
                        const float* __restrict__ v_pool,
                        const int* __restrict__ block_table,
                        const int* __restrict__ pos, float* __restrict__ out,
                        int H, int K, int P, int ps, int max_pages,
                        float scale) {
  using S = Shape<D>;
  constexpr int VEC = S::VEC, CH = S::CH, LPK = S::LPK, CPL = S::CPL;
  constexpr int KPW = S::KPW, NSLOT = S::NSLOT, UNROLL = S::UNROLL;
  constexpr int TK = S::TK, TILE = S::TILE_BYTES, W = CPL * VEC;
  // 2 stages of (K, V); after the tile loop the lane groups' acc (NSLOT x
  // G x D floats, at most 32 KB) reuses it
  __shared__ __align__(16) unsigned char ring[4 * TILE];
  static_assert(NSLOT * G * D * 4 <= 4 * TILE, "merge fits the ring");
  __shared__ float sm_m[NSLOT][G], sm_l[NSLOT][G];
  __shared__ float st_m[G], st_l[G], st_acc[G][D];   // this rank's state

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sub = lane / LPK, li = lane % LPK;
  const int slot = warp * KPW + sub;
  // chunk c of this lane: li + c * LPK, live where inside the row
  auto live = [&](int c) { return CH % LPK == 0 || li + c * LPK < CH; };

  float qr[G][W], m[G], l[G], acc[G][W];
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      if (live(c)) {
        repro::cvt16<float>(
            repro::ld16(q + ((size_t)b * H + kvh * G + g) * D
                        + (li + c * LPK) * VEC), qr[g] + c * VEC);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) qr[g][c * VEC + e] = 0.f;
      }
    }
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < W; ++e) {
      qr[g][e] *= scale;
      acc[g][e] = 0.f;
    }
  }

  const int* bt = block_table + (size_t)b * max_pages;
  const RankKeys<TK> keys(bt, pos + b, max_pages, ps, rank);
  float* ring_t = reinterpret_cast<float*>(ring);
  auto load = [&](int t) {   // tile t into stage t & 1
    float* ks = ring_t + (t & 1) * 2 * TK * D;
    tile_async<float, TK, D>(ks, ks + TK * D, D, k_pool, v_pool, bt,
                         keys.begin + t * TK, keys.end, ps, P, K, kvh);
  };

  if (keys.tiles > 0) load(0);
  for (int t = 0; t < keys.tiles; ++t) {
    if (t + 1 < keys.tiles) {
      load(t + 1);
      repro::cp_async_wait<1>();
    } else {
      repro::cp_async_wait<0>();
    }
    __syncthreads();
    const float* ks = ring_t + (t & 1) * 2 * TK * D;
    const float* vs = ks + TK * D;
    const int key0 = keys.begin + t * TK;
    float s[G][UNROLL], vf[UNROLL][W];
    bool valid[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int r = u * NSLOT + slot;
      valid[u] = key0 + r < keys.end;
      float kf[W];
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int off = r * D + (li + c * LPK) * VEC;
        if (live(c)) {
          repro::cvt16<float>(*reinterpret_cast<const uint4*>(ks + off),
                              kf + c * VEC);
          repro::cvt16<float>(*reinterpret_cast<const uint4*>(vs + off),
                              vf[u] + c * VEC);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            kf[c * VEC + e] = vf[u][c * VEC + e] = 0.f;
        }
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < W; ++e) part = fmaf(qr[g][e], kf[e], part);
#pragma unroll
        for (int w = 1; w < LPK; w <<= 1)
          part += __shfl_xor_sync(0xffffffffu, part, w);
        s[g][u] = part;
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float m_new = m[g];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        if (valid[u]) m_new = fmaxf(m_new, s[g][u]);
      const float corr = expf(m[g] - m_new);
      float p[UNROLL], p_sum = 0.f;
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        p[u] = valid[u] ? expf(s[g][u] - m_new) : 0.f;
        p_sum += p[u];
      }
      l[g] = l[g] * corr + p_sum;
      m[g] = m_new;
#pragma unroll
      for (int e = 0; e < W; ++e) {
        float a = acc[g][e] * corr;
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) a = fmaf(p[u], vf[u][e], a);
        acc[g][e] = a;
      }
    }
    __syncthreads();   // stage t & 1 is free for tile t + 2
  }

  float* sm_acc = reinterpret_cast<float*>(ring);   // [NSLOT][G][D]
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (li == 0) {
      sm_m[slot][g] = m[g];
      sm_l[slot][g] = l[g];
    }
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      if (!live(c)) continue;
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        sm_acc[(slot * G + g) * D + (li + c * LPK) * VEC + e] =
            acc[g][c * VEC + e];
    }
  }
  merge_block<NSLOT, G, D>(sm_m, sm_l, sm_acc, st_m, st_l, st_acc);
  merge_ranks<float, G, D>(cluster, rank, st_m, st_l, st_acc,
                           out + ((size_t)b * H + kvh * G) * D);
}

// ---------------------------------------------------------------------------
// bf16: tensor-core kernel
// ---------------------------------------------------------------------------

using repro::LOG2E;
using repro::PITCH;

template <int D>
__host__ __device__ constexpr int mma_smem_bytes() {   // 2 x (K, V), MK rows
  return 4 * MK * PITCH<D> * 2;
}

// Warp w scores keys 16w..16w+15 of each tile.  Lane l holds the head
// (row) l/4 -- rows G..15 are zero pad (grok's group of 6 leaves rows 6
// and 7 of the live half as pad too) -- and, in each n8 tile, keys (or
// dims) 2(l%4) and 2(l%4) + 1.
template <int D, int G>
__global__ void __cluster_dims__(SPLIT, 1, 1) __launch_bounds__(NT)
paged_decode_mma_kernel(const bf16* __restrict__ q,
                        const bf16* __restrict__ k_pool,
                        const bf16* __restrict__ v_pool,
                        const int* __restrict__ block_table,
                        const int* __restrict__ pos, bf16* __restrict__ out,
                        int H, int K, int P, int ps, int max_pages,
                        float scale) {
  static_assert(G <= 8, "the G heads fit the first 8 rows of a tile");
  constexpr int NW = NT / 32;
  constexpr int PT = PITCH<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);   // 2 x (K, V), MK x PT
  static_assert(NW * G * D * 4 <= mma_smem_bytes<D>(), "merge fits");
  __shared__ float sm_m[NW][G], sm_l[NW][G];
  __shared__ float st_m[G], st_l[G], st_acc[G][D];   // this rank's state

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane / 4;   // this lane's head row

  // q as the A fragment of the 16-dim slice kd: rows 8..15 (a[1], a[3])
  // are pad.  Up to D = 128 the D/16 fragments are loaded once and kept;
  // at D = 256 they would take 32 registers beside the accumulator's 128,
  // so warp 0 stages their live halves in shared memory (4 KB) and each
  // tile reads them back (the barrier between tiles keeps the compiler
  // from hoisting the reads into registers again).
  constexpr bool Q_IN_REGS = D <= 128;
  __shared__ uint2 sq[Q_IN_REGS ? 1 : D / 16][32];
  const bf16* qg = q + ((size_t)b * H + kvh * G + g) * D + (lane % 4) * 2;
  auto q_frag = [&](int kd, uint32_t (&a)[4]) {
    a[0] = g < G ? __ldg(reinterpret_cast<const uint32_t*>(qg + kd * 16))
                 : 0u;
    a[2] = g < G ? __ldg(reinterpret_cast<const uint32_t*>(qg + kd * 16 + 8))
                 : 0u;
    a[1] = a[3] = 0u;
  };
  uint32_t qa[Q_IN_REGS ? D / 16 : 1][4];
  if constexpr (Q_IN_REGS) {
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd) q_frag(kd, qa[kd]);
  } else if (warp == 0) {   // read after the first tile's barrier
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd) {
      q_frag(kd, qa[0]);
      sq[kd][lane] = make_uint2(qa[0][0], qa[0][2]);
    }
  }

  const int* bt = block_table + (size_t)b * max_pages;
  const RankKeys<MK> keys(bt, pos + b, max_pages, ps, rank);
  auto load = [&](int t) {   // tile t into stage t & 1
    bf16* ks = ring + (t & 1) * 2 * MK * PT;
    tile_async<bf16, MK, D>(ks, ks + MK * PT, PT, k_pool, v_pool, bt,
                            keys.begin + t * MK, keys.end, ps, P, K, kvh);
  };

  const float tau2 = scale * LOG2E;
  float m2 = NEG_INF;            // running max of tau*s*log2(e), row g
  float l = 0.f;                 // this lane's share of the row's sum
  float acc[D / 8][4] = {};      // rows g (and pad g + 8) x D
  if (keys.tiles > 0) load(0);
  for (int t = 0; t < keys.tiles; ++t) {
    if (t + 1 < keys.tiles) {
      load(t + 1);
      repro::cp_async_wait<1>();
    } else {
      repro::cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Ks = ring + (t & 1) * 2 * MK * PT + warp * 16 * PT;
    const bf16* Vs = Ks + MK * PT;
    const int k0 = keys.begin + t * MK + warp * 16;

    // S = q.K^T over the warp's 16 keys: K's rows are B's columns
    float s[2][4] = {};
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd) {
      uint32_t bm[4], qf[4];
      if constexpr (Q_IN_REGS) {
#pragma unroll
        for (int e = 0; e < 4; ++e) qf[e] = qa[kd][e];
      } else {
        const uint2 f = sq[kd][lane];
        qf[0] = f.x;
        qf[2] = f.y;
        qf[1] = qf[3] = 0u;
      }
      repro::ldsm4(bm, Ks + (lane % 8 + (lane / 16) * 8) * PT + kd * 16
                           + ((lane / 8) % 2) * 8);
      repro::mma_bf16(s[0], qf, bm[0], bm[1]);
      repro::mma_bf16(s[1], qf, bm[2], bm[3]);
    }
    bool valid[2][2];
    float mx = m2;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        valid[n][e] = k0 + n * 8 + (lane % 4) * 2 + e < keys.end;
        s[n][e] *= tau2;
        if (valid[n][e]) mx = fmaxf(mx, s[n][e]);
      }
    // the row's 16 keys sit in the lane's quad
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float corr = repro::ex2(m2 - mx);
    m2 = mx;
    l *= corr;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = valid[n][e] ? repro::ex2(s[n][e] - m2) : 0.f;
        l += p;
        s[n][e] = p;
      }
      s[n][2] = s[n][3] = 0.f;   // the pad rows
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= corr;
      acc[n][1] *= corr;
    }
    uint32_t pa[1][4];
    repro::pack_a(pa[0], s[0], s[1]);
    repro::mma_ab<D, 1>(acc, pa, Vs, lane);
    __syncthreads();   // stage t & 1 is free for tile t + 2
  }

  // the warps' states into shared memory, m in natural-log units
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  float* sm_acc = reinterpret_cast<float*>(smem_raw);   // [NW][G][D]
  if (g < G) {
    if (lane % 4 == 0) {
      sm_m[warp][g] = m2 * repro::LN2;
      sm_l[warp][g] = l;
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(sm_acc + (warp * G + g) * D + n * 8
                                 + (lane % 4) * 2) =
          make_float2(acc[n][0], acc[n][1]);
  }
  merge_block<NW, G, D>(sm_m, sm_l, sm_acc, st_m, st_l, st_acc);
  merge_ranks<bf16, G, D>(cluster, rank, st_m, st_l, st_acc,
                          out + ((size_t)b * H + kvh * G) * D);
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <int D, int G>
cudaError_t launch_mma(const void* q, const void* k_pool, const void* v_pool,
                       const int* bt, const int* pos, void* out, int B,
                       int H, int K, int P, int ps, int max_pages,
                       float scale, cudaStream_t stream) {
  constexpr int smem = mma_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_mma_kernel<D, G>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  paged_decode_mma_kernel<D, G><<<dim3(SPLIT, K, B), NT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k_pool),
      static_cast<const bf16*>(v_pool), bt, pos, static_cast<bf16*>(out), H,
      K, P, ps, max_pages, scale);
  return cudaGetLastError();
}

template <int D, int G>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const int* bt, const int* pos, void* out, int B, int H,
                   int K, int P, int ps, int max_pages, bool bf16_in,
                   cudaStream_t stream) {
  const float scale = (float)(1.0 / sqrt((double)D));
  if (bf16_in)
    return launch_mma<D, G>(q, k_pool, v_pool, bt, pos, out, B, H, K, P, ps,
                            max_pages, scale, stream);
  paged_decode_fma_kernel<D, G><<<dim3(SPLIT, K, B), NT, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k_pool),
      static_cast<const float*>(v_pool), bt, pos, static_cast<float*>(out), H,
      K, P, ps, max_pages, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t by_group(int G, const void* q, const void* k_pool,
                     const void* v_pool, const int* bt, const int* pos,
                     void* out, int B, int H, int K, int P, int ps,
                     int max_pages, bool bf16_in, cudaStream_t s) {
  switch (G) {
    case 1: return launch<D, 1>(q, k_pool, v_pool, bt, pos, out, B, H, K, P,
                                ps, max_pages, bf16_in, s);
    case 2: return launch<D, 2>(q, k_pool, v_pool, bt, pos, out, B, H, K, P,
                                ps, max_pages, bf16_in, s);
    case 4: return launch<D, 4>(q, k_pool, v_pool, bt, pos, out, B, H, K, P,
                                ps, max_pages, bf16_in, s);
    case 6: return launch<D, 6>(q, k_pool, v_pool, bt, pos, out, B, H, K, P,
                                ps, max_pages, bf16_in, s);
    case 8: return launch<D, 8>(q, k_pool, v_pool, bt, pos, out, B, H, K, P,
                                ps, max_pages, bf16_in, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// q (B,H,D), k/v pools (P,ps,K,D), block_table (B,max_pages) int32,
// pos (B,) int32 -> out (B,H,D).  bf16 != 0 selects __nv_bfloat16 (the
// tensor-core kernel), else float (the FMA kernel).  Returns the launch's
// cudaError_t (a refused cluster launch included); an unsupported head dim
// or group returns cudaErrorInvalidValue.
extern "C" int repro_paged_decode(const void* q, const void* k_pool,
                                  const void* v_pool, const int* block_table,
                                  const int* pos, void* out, int B, int H,
                                  int K, int D, int P, int ps, int max_pages,
                                  int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int G = H / K;
  if (D == 64)
    return by_group<64>(G, q, k_pool, v_pool, block_table, pos, out, B, H, K,
                        P, ps, max_pages, bf16 != 0, s);
  if (D == 80)
    return by_group<80>(G, q, k_pool, v_pool, block_table, pos, out, B, H, K,
                        P, ps, max_pages, bf16 != 0, s);
  if (D == 128)
    return by_group<128>(G, q, k_pool, v_pool, block_table, pos, out, B, H,
                         K, P, ps, max_pages, bf16 != 0, s);
  if (D == 256)
    return by_group<256>(G, q, k_pool, v_pool, block_table, pos, out, B, H,
                         K, P, ps, max_pages, bf16 != 0, s);
  return cudaErrorInvalidValue;
}
