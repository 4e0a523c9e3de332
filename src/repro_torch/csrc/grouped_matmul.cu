// Grouped (per-expert) matmul, for Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/grouped_matmul.py
// (grouped_matmul -> _kernel): out[g] = x[g] @ w[g] for (G,M,K) x
// (G,K,N) -> (G,M,N), accumulated in f32 and cast to x's dtype.
// kernels/ops.py composes three of these into the grouped expert MLP.
//
// Bound: bytes.  At decode M is one micro-batch's capacity (C = T rows in
// capacity_mode "full": 4 at batch 8, 64 at batch 128, in 2
// micro-batches), so each weight element is used by at most M rows: ~2*M
// flops per 2-byte bf16 weight, below the card's ~295 flops/byte balance
// point.  Every call streams its weights from HBM once: at Mixtral width
// one projection reads 8*6144*16384*2 B = 1.61 GB, 0.48 ms at 3.35 TB/s.
// Reaching that needs ~20-30 KB of loads in flight on every one of the
// 132 SMs at both of the path's shapes, N = 16384 (up) and N = 6144
// (down).
//
// Design:
//  * A block owns TN output columns (128 in bf16, 64 in f32: 16 lanes of
//    16-byte vectors) of one BM-row strip of one expert, so the down
//    projection launches 48 * 8 = 384 blocks and the up projection 1024.
//  * The block walks K in stages of KT = 32 rows.  A ring of STAGES
//    stages in shared memory is filled with 16-byte cp.async copies of
//    the (KT x TN) weight tile and the (BM x KT) x tile, so STAGES - 1
//    stages (~27 KB per block) are in flight while one is consumed; one
//    __syncthreads per stage.
//  * K is split inside the block: in the FMA body each thread owns two
//    neighbouring rows of every stage (a warp owns four) and 8 columns,
//    with BM x 8 f32 accumulators; in the tensor-core body each warp owns
//    one 16-row half of every stage and 32 columns.  The per-warp partial
//    sums are reduced through shared memory in a fixed order at the end,
//    so the result is the same bit for bit from launch to launch (no
//    atomics).
//  * Two compute bodies share that pipeline.  FMA: f32 FMAs on weights
//    converted from the stage, for f32 and for bf16 at small M.  MMA
//    (bf16 only): mma.sync.m16n8k16 with x (M padded to 16 rows) as A
//    from ldmatrix and the weight tile as B from ldmatrix.trans, in
//    strips of 16 rows.  At bf16 M <= 8 both bodies
//    launch the same blocks, but from M = 3 on the FMA body's registers
//    fit two blocks on an SM where the MMA body fits three, so the entry point
//    takes the body whose last wave of blocks is fuller on this card
//    (measured on the H100: FMA at N = 16384, 1024 blocks; MMA at
//    N = 6144, 384 blocks).  A function of the shapes and the compiled
//    kernels only.  Above 8 rows bf16 takes the live-row body below.
//    The caller may force either strip body to time it.
//  * Ragged edges (rows k >= K, columns n >= N, rows m >= M) are filled
//    with zeros in the stage and masked at the store.  When N or K is not
//    a multiple of the 16-byte vector, the rows are not 16-byte aligned:
//    the stages are then filled with element loads (a choice by shape;
//    misaligned base pointers are refused).
//
// Live rows.  A decode micro-batch gives every expert C = T slots
// (capacity mode "full": 64 rows at batch 128 in 2 micro-batches), but
// only the slots its tokens were routed to hold data: ~16 of 64 on
// Mixtral, and ~1 on the ~63% of Arctic's 128 experts that hold a token
// at all.  With the dispatch table idx (G, M) int32 of gating_dispatch
// (the sentinel, the token count, marks an empty slot), each block first
// reads its expert's M entries and takes live = 1 + the last slot that is
// not the sentinel; rows at and past live are stored as exact zeros (what
// the full product gives, since gather_tokens fills sentinel slots with
// zeros).  In the live-row body a row group with no live row zero-fills
// its output and loads nothing; the strips above only mask the store.
// Without idx every row is live.
//
// Live-row body (bf16, M > 8; grouped_matmul_kernel_live).  The strips
// above each stream the expert's whole K x TN weight tile again, 4x the
// bytes at M = 64, so a launch ran at a quarter of its bound.  Here one
// block owns (column tile, expert, 64-row group): it streams its K x TN
// weight tile once for all the group's live rows, which at decode is the
// whole expert (one row group).
//  * Each warpgroup owns 64 columns and runs wgmma.m64n64k16 (A: the x
//    tile, K-major; B: the weight tile, MN-major through the transpose
//    bit; f32 accumulators in registers).  Each output element is summed
//    by one warpgroup in K order, with no split and no atomics: two
//    launches are bit-identical.
//  * All threads fill a ring of WSTAGES stages of WKT = 64 K rows with
//    16-byte cp.async copies (elements where N or K is not a multiple of
//    8), in wgmma's 128-byte swizzle: 8 consecutive threads copy 128
//    contiguous bytes of a row into one 128-byte shared-memory row.  (The
//    unswizzled layout ran at 41-51% of the bound: a row of B spread over
//    8 core matrices 128 bytes apart, whose reads conflict.)  3 stages (48
//    or 24 KB of weights) stay in flight per block, in ~97 or ~65 KB of
//    dynamic shared memory (opt-in above 48 KB), two or three blocks an SM.
//  * Only the live rows of x are loaded; the x tile's other rows keep
//    whatever the ring held, which reaches only output rows that are
//    stored as zeros.
//  * TN is 128 (two warpgroups) or 64 columns (one), whichever leaves the
//    last wave of blocks fuller on this card (Mixtral's up projection,
//    N = 16384: 128, 1024 blocks; its down projection, N = 6144: 64, 768
//    blocks).  A function of the shapes and the compiled kernels only.

#include "common.cuh"

#include <cmath>
#include <cstdint>

namespace {

constexpr int NT = 256;      // threads per block (8 warps)
constexpr int CG = 16;       // 16-byte column vectors per tile row
constexpr int KT = 32;       // K rows per stage
constexpr int STAGES = 4;    // stages in the shared-memory ring
constexpr int FMA_MAX_M = 8; // bf16 M-strips of up to 8 rows may take FMA

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy (each 256-byte row segment is fetched into L2
// at once); src_bytes = 0 fills the 16 bytes with zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float& d0, float& d1, float& d2, float& d3,
                                         const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d0), "+f"(d1), "+f"(d2), "+f"(d3)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes of T -> 16 / sizeof(T) floats
__device__ __forceinline__ void unpack(const uint4& u, float* f, float) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float* f, __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}
// x[m][k], x[m][k + 1] (k even)
__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// 1 + the last of expert g's M slots that is not the sentinel (0: no live
// row); M without a table.  Every thread of the block calls it and gets
// the same value (a max: no order to fix).
__device__ __forceinline__ int live_rows(const int* __restrict__ idx, int sentinel,
                                         int g, int M) {
  if (idx == nullptr) return M;
  __shared__ int part[32];
  int last = -1;
  for (int c = threadIdx.x; c < M; c += blockDim.x)
    if (idx[(size_t)g * M + c] != sentinel) last = c;
  last = __reduce_max_sync(0xffffffffu, last);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = last;
  __syncthreads();
  for (int i = 0; i < (int)(blockDim.x >> 5); ++i) last = max(last, part[i]);
  return last + 1;
}

// zeros into rows [r0, r1) and columns [n0, n0 + tn) of expert g's output
template <typename T>
__device__ void zero_rows(T* __restrict__ out, int g, int M, int N, int r0, int r1,
                          int n0, int tn) {
  const int nc = min(tn, N - n0);
  for (int i = threadIdx.x; i < (r1 - r0) * nc; i += blockDim.x)
    out[((size_t)g * M + r0 + i / nc) * N + n0 + i % nc] = repro::from_f<T>(0.f);
}

template <typename T, int BM, bool MMA>
struct Tile {
  static constexpr int VEC = 16 / sizeof(T);      // elements per 16-byte vector
  static constexpr int TN = CG * VEC;             // columns per block
  static constexpr int WS = TN + VEC;             // weight tile row stride (+16 B: no bank conflicts)
  static constexpr int XS = KT + VEC;             // x tile row stride
  static constexpr int STAGE = KT * WS + BM * XS; // elements per stage
  static constexpr int NKG = MMA ? 2 : 8;         // K groups reduced at the end
  static constexpr int RING_BYTES = STAGES * STAGE * (int)sizeof(T);
  static constexpr int RED_BYTES = NKG * BM * TN * 4;
  static constexpr int SMEM = RING_BYTES > RED_BYTES ? RING_BYTES : RED_BYTES;
  static_assert(SMEM <= 48 * 1024, "dynamic shared memory above 48 KB needs an opt-in");
};

template <typename T, int BM, bool MMA, bool ALIGNED>
__global__ void __launch_bounds__(NT, 2) grouped_matmul_kernel(
    const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
    const int* __restrict__ idx, int sentinel, int M, int K, int N) {
  using L = Tile<T, BM, MMA>;
  constexpr int VEC = L::VEC, TN = L::TN, WS = L::WS, XS = L::XS;
  extern __shared__ __align__(16) unsigned char smem[];  // L::SMEM bytes
  T* ring = reinterpret_cast<T*>(smem);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = blockIdx.z, m0 = blockIdx.y * BM, n0 = blockIdx.x * TN;
  const T* xg = x + ((size_t)g * M + m0) * K;
  const T* wg = w + (size_t)g * K * N + n0;

  // fill ring slot `slot` with stage `s` (rows s*KT ..) of w and x
  auto load_stage = [&](int slot, int s) {
    T* ws = ring + slot * L::STAGE;
    T* xs = ws + KT * WS;
    const int k0 = s * KT;
    if constexpr (ALIGNED) {
#pragma unroll
      for (int i = tid; i < KT * CG; i += NT) {
        const int r = i / CG, c = i % CG;
        const bool ok = k0 + r < K && n0 + c * VEC < N;
        cp_async16(ws + r * WS + c * VEC, ok ? wg + (size_t)(k0 + r) * N + c * VEC : w, ok);
      }
      constexpr int XV = BM * (KT / VEC);
      for (int i = tid; i < XV; i += NT) {
        const int r = i / (KT / VEC), c = i % (KT / VEC);
        const bool ok = m0 + r < M && k0 + c * VEC < K;
        cp_async16(xs + r * XS + c * VEC, ok ? xg + (size_t)r * K + k0 + c * VEC : x, ok);
      }
    } else {
      for (int i = tid; i < KT * TN; i += NT) {
        const int r = i / TN, c = i % TN;
        const bool ok = k0 + r < K && n0 + c < N;
        ws[r * WS + c] = ok ? wg[(size_t)(k0 + r) * N + c] : repro::from_f<T>(0.f);
      }
      for (int i = tid; i < BM * KT; i += NT) {
        const int r = i / KT, c = i % KT;
        const bool ok = m0 + r < M && k0 + c < K;
        xs[r * XS + c] = ok ? xg[(size_t)r * K + k0 + c] : repro::from_f<T>(0.f);
      }
    }
  };

  // per-thread accumulators: FMA body BM x VEC, MMA body 4 n8 tiles x 4
  constexpr int NACC = MMA ? 16 : BM * VEC;
  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;

  // FMA body: thread (cg, kl) owns columns cg*VEC.. and rows 2kl, 2kl+1
  const int cg = tid % CG, kl = tid / CG;
  // MMA body: warp (kg, ng) owns rows kg*16.. and columns ng*32..
  const int kg = warp & 1, ng = warp >> 1;

  const int nk = (K + KT - 1) / KT;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage(s, s);
    cp_async_commit();
  }
  for (int s = 0; s < nk; ++s) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage s landed; everyone is done with stage s - 1
    if (s + STAGES - 1 < nk) load_stage((s + STAGES - 1) % STAGES, s + STAGES - 1);
    cp_async_commit();

    const T* ws = ring + (s % STAGES) * L::STAGE;
    const T* xs = ws + KT * WS;
    if constexpr (MMA) {
      unsigned a[4], b[2][4];
      const int row = (lane & 7) + ((lane >> 3) & 1) * 8, hi = (lane >> 4) * 8;
      ldmatrix_x4(a, xs + row * XS + kg * 16 + hi);
#pragma unroll
      for (int h = 0; h < 2; ++h)
        ldmatrix_x4_trans(b[h], ws + (kg * 16 + row) * WS + ng * 32 + h * 16 + hi);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        mma_bf16(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3], a,
                 b[j >> 1][(j & 1) * 2], b[j >> 1][(j & 1) * 2 + 1]);
    } else {
      float w0[VEC], w1[VEC];
      unpack(*reinterpret_cast<const uint4*>(ws + (2 * kl) * WS + cg * VEC), w0, T());
      unpack(*reinterpret_cast<const uint4*>(ws + (2 * kl + 1) * WS + cg * VEC), w1, T());
#pragma unroll
      for (int m = 0; m < BM; ++m) {
        const float2 xv = load_pair(xs + m * XS + 2 * kl);
#pragma unroll
        for (int c = 0; c < VEC; ++c) {
          float a = fmaf(xv.x, w0[c], acc[m * VEC + c]);
          acc[m * VEC + c] = fmaf(xv.y, w1[c], a);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: reuse it for the K-group partials

  float* red = reinterpret_cast<float*>(smem);  // [NKG][BM][TN]
  if constexpr (MMA) {
    const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = ng * 32 + j * 8 + tig * 2;
      float* r0 = red + (kg * BM + gid) * TN + n;
      float* r1 = red + (kg * BM + gid + 8) * TN + n;
      r0[0] = acc[4 * j];
      r0[1] = acc[4 * j + 1];
      r1[0] = acc[4 * j + 2];
      r1[1] = acc[4 * j + 3];
    }
  } else {
    // rows 2kl.. of lanes l and l + 16 of one warp: add the pair first
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], 16);
    if (lane < 16) {
#pragma unroll
      for (int m = 0; m < BM; ++m)
#pragma unroll
        for (int c = 0; c < VEC; ++c) red[(warp * BM + m) * TN + cg * VEC + c] = acc[m * VEC + c];
    }
  }
  __syncthreads();
  // the live count is read here: read before the main loop (to skip an
  // empty strip), it cost the MMA body the registers of a third block on
  // an SM (80 -> 90), 18% at Mixtral's down projection at M = 4
  const int live = live_rows(idx, sentinel, g, M);
  for (int i = tid; i < BM * TN; i += NT) {
    const int m = i / TN, n = i % TN;
    if (m0 + m >= M || n0 + n >= N) continue;
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < L::NKG; ++q) s += red[(q * BM + m) * TN + n];
    out[((size_t)g * M + m0 + m) * N + n0 + n] = repro::from_f<T>(m0 + m < live ? s : 0.f);
  }
}


// ------------------------------------------------------ live-row body
constexpr int WROWS = 64;    // rows of a row group: wgmma's M
constexpr int WKT = 64;      // K rows per stage: one 128-byte row of the x tile
constexpr int WSTAGES = 4;   // stages in the ring
constexpr int WN = 64;       // columns per warpgroup: one 128-byte row of the weight tile

// Shared memory of a block of WGS warpgroups (TN = 64 * WGS columns).  Both
// tiles are in wgmma's 128-byte swizzle: 8 rows of 128 bytes (1 KB, 1 KB
// aligned) with 16-byte chunk c of row r stored at chunk c ^ r.  Weight
// tile: the warpgroups' 64-column slabs one after the other, each KT / 8
// such 8-row groups of K; x tile: 8 groups of 8 rows of 64 K.
template <int WGS>
struct LiveTile {
  static constexpr int TN = WN * WGS;
  static constexpr int NT = 128 * WGS;
  static constexpr int SLAB = WKT * WN * 2;           // one warpgroup's weight columns
  static constexpr int W_BYTES = SLAB * WGS;
  static constexpr int X_BYTES = WROWS * WKT * 2;
  static constexpr int STAGE = W_BYTES + X_BYTES;
  static constexpr int SMEM = WSTAGES * STAGE + 1024;  // + room to align the ring to 1 KB
};

// byte offset of 16-byte chunk c of row r in a 128-byte-swizzled tile
__device__ __forceinline__ int swz(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }

// wgmma's shared-memory matrix descriptor in the 128-byte swizzle: start,
// the byte offset between 8-row groups (stride) and, for an MN-major
// operand, between 64-element slabs (leading)
__device__ __forceinline__ uint64_t smem_desc(unsigned addr, unsigned lead, unsigned stride) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)((lead >> 4) & 0x3FFF) << 16 |
         (uint64_t)((stride >> 4) & 0x3FFF) << 32 | 1ull << 62;
}

// d (64 x 64, f32) += A (64 x 16, K-major) * B (16 x 64, MN-major), bf16 in
__device__ __forceinline__ void wgmma_64x64x16(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int WGS, bool ALIGNED>
__global__ void __launch_bounds__(128 * WGS, 2) grouped_matmul_kernel_live(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
    __nv_bfloat16* __restrict__ out, const int* __restrict__ idx, int sentinel,
    int M, int K, int N) {
  using T = __nv_bfloat16;
  using L = LiveTile<WGS>;
  constexpr int TN = L::TN, NT = L::NT, NC = TN / 8;  // NC: 16-byte chunks of a weight row
  extern __shared__ __align__(1024) unsigned char lsmem[];  // L::SMEM bytes

  const int tid = threadIdx.x;
  const int g = blockIdx.z, m0 = blockIdx.y * WROWS, n0 = blockIdx.x * TN;
  const int rows = live_rows(idx, sentinel, g, M) - m0;  // live rows of the group
  if (rows <= 0) {
    zero_rows(out, g, M, N, m0, min(m0 + WROWS, M), n0, TN);
    return;
  }
  const int xrows = min(rows, WROWS);
  const T* xg = x + ((size_t)g * M + m0) * K;
  const T* wg = w + (size_t)g * K * N + n0;
  const unsigned base = (smem_u32(lsmem) + 1023) & ~1023u;
  unsigned char* ring = lsmem + (base - smem_u32(lsmem));

  // Ring slot `slot` <- stage `s` (K rows s*WKT ..).  Consecutive threads
  // take consecutive 16-byte chunks of a row: 128 contiguous bytes of
  // device memory per 8 threads, and one 128-byte shared-memory row.
  auto load_stage = [&](int slot, int s) {
    unsigned char* ws = ring + slot * L::STAGE;
    unsigned char* xs = ws + L::W_BYTES;
    const int k0 = s * WKT;
#pragma unroll
    for (int i = tid; i < WKT * NC; i += NT) {
      const int c = i % NC, r = i / NC, k = k0 + r, n = c * 8;
      void* dst = ws + (c >> 3) * L::SLAB + swz(r, c & 7);
      if constexpr (ALIGNED) {
        const bool ok = k < K && n0 + n < N;
        cp_async16(dst, ok ? wg + (size_t)k * N + n : w, ok);
      } else {
        T* d = reinterpret_cast<T*>(dst);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          d[e] = k < K && n0 + n + e < N ? wg[(size_t)k * N + n + e] : repro::from_f<T>(0.f);
      }
    }
    for (int i = tid; i < xrows * (WKT / 8); i += NT) {
      const int c = i % (WKT / 8), m = i / (WKT / 8), k = k0 + c * 8;
      void* dst = xs + swz(m, c);
      if constexpr (ALIGNED) {
        const bool ok = k < K;
        cp_async16(dst, ok ? xg + (size_t)m * K + k : x, ok);
      } else {
        T* d = reinterpret_cast<T*>(dst);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          d[e] = k + e < K ? xg[(size_t)m * K + k + e] : repro::from_f<T>(0.f);
      }
    }
  };

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  const int wgid = tid >> 7;  // the warpgroup's columns: wgid*WN ..

  const int nk = (K + WKT - 1) / WKT;
#pragma unroll
  for (int s = 0; s < WSTAGES - 1; ++s) {
    if (s < nk) load_stage(s, s);
    cp_async_commit();
  }
  for (int s = 0; s < nk; ++s) {
    cp_async_wait<WSTAGES - 2>();
    // this thread's copies of stage s are done: make them visible to the
    // tensor cores' (async-proxy) reads, then wait for every thread's
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // ... and everyone is done with stage s - 1
    if (s + WSTAGES - 1 < nk) load_stage((s + WSTAGES - 1) % WSTAGES, s + WSTAGES - 1);
    cp_async_commit();

    const unsigned wbase = base + (s % WSTAGES) * L::STAGE;
    const unsigned xbase = wbase + L::W_BYTES;
    fence_acc(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int j = 0; j < WKT / 16; ++j) {
      // A: 32 bytes of K further along the swizzled rows; B: two 8-row groups further
      const uint64_t da = smem_desc(xbase + j * 32, 16, 1024);
      const uint64_t db = smem_desc(wbase + wgid * L::SLAB + j * 2048, L::SLAB, 1024);
      wgmma_64x64x16(acc, da, db);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(acc);
  }

  // accumulator layout: warp q of the warpgroup holds rows 16q..; lane l
  // rows l/4 and l/4 + 8, columns 8j + 2(l%4) and the next
  const int q = (tid >> 5) & 3, lane = tid & 31;
#pragma unroll
  for (int j = 0; j < WN / 8; ++j) {
    const int n = n0 + wgid * WN + j * 8 + (lane & 3) * 2;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q * 16 + (lane >> 2) + h * 8;
      if (m0 + row >= M || n >= N) continue;
      const bool on = row < rows;
      const float v0 = on ? acc[4 * j + 2 * h] : 0.f, v1 = on ? acc[4 * j + 2 * h + 1] : 0.f;
      T* o = out + ((size_t)g * M + m0 + row) * N + n;
      if constexpr (ALIGNED) {
        *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
      } else {
        o[0] = repro::from_f<T>(v0);
        if (n + 1 < N) o[1] = repro::from_f<T>(v1);
      }
    }
  }
}

// Blocks an SM holds at once of a kernel, once per kernel.
template <typename F>
int blocks_per_sm(F* kernel, int threads, int smem) {
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, smem);
  return n > 0 ? n : 1;
}

// The share of the last wave of `blocks` blocks that is full when every
// SM holds `fit` of them.
inline double last_wave_fill(double blocks, int fit) {
  int dev = 0, sms = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const double slots = (double)fit * sms;
  return blocks / (slots * std::ceil(blocks / slots));
}

// One grid of the kernel: its launch, and the share of its last wave of
// blocks that is full when all SMs hold as many blocks as fit at once.
template <typename T, int BM, bool MMA>
struct Grid {
  using L = Tile<T, BM, MMA>;
  static auto kernel(bool aligned) {
    return aligned ? grouped_matmul_kernel<T, BM, MMA, true>
                   : grouped_matmul_kernel<T, BM, MMA, false>;
  }
  static dim3 dims(int G, int M, int N) {
    return dim3((N + L::TN - 1) / L::TN, (M + BM - 1) / BM, G);
  }
  static double wave_fill(int G, int M, int N, bool aligned) {
    static int per_sm[2] = {-1, -1};  // per compiled kernel
    int& fit = per_sm[aligned];
    if (fit < 0) fit = blocks_per_sm(kernel(aligned), NT, L::SMEM);
    const dim3 d = dims(G, M, N);
    return last_wave_fill((double)d.x * d.y * d.z, fit);
  }
  static void launch(const void* x, const void* w, void* out, const int* idx, int sentinel,
                     int G, int M, int K, int N, bool aligned, cudaStream_t s) {
    kernel(aligned)<<<dims(G, M, N), NT, L::SMEM, s>>>((const T*)x, (const T*)w, (T*)out,
                                                       idx, sentinel, M, K, N);
  }
};

template <int WGS>
struct LiveGrid {
  using L = LiveTile<WGS>;
  static auto kernel(bool aligned) {
    return aligned ? grouped_matmul_kernel_live<WGS, true> : grouped_matmul_kernel_live<WGS, false>;
  }
  static dim3 dims(int G, int M, int N) {
    return dim3((N + L::TN - 1) / L::TN, (M + WROWS - 1) / WROWS, G);
  }
  // the opt-in above 48 KB of dynamic shared memory, once per kernel
  static cudaError_t prepare(bool aligned) {
    static cudaError_t done[2] = {cudaErrorNotReady, cudaErrorNotReady};
    if (done[aligned] == cudaErrorNotReady)
      done[aligned] = cudaFuncSetAttribute(
          kernel(aligned), cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
    return done[aligned];
  }
  static double wave_fill(int G, int M, int N, bool aligned) {
    static int per_sm[2] = {-1, -1};
    int& fit = per_sm[aligned];
    if (fit < 0) {
      prepare(aligned);
      fit = blocks_per_sm(kernel(aligned), L::NT, L::SMEM);
    }
    const dim3 d = dims(G, M, N);
    return last_wave_fill((double)d.x * d.y * d.z, fit);
  }
  static cudaError_t launch(const void* x, const void* w, void* out, const int* idx,
                            int sentinel, int G, int M, int K, int N, bool aligned,
                            cudaStream_t s) {
    const cudaError_t e = prepare(aligned);
    if (e != cudaSuccess) return e;
    kernel(aligned)<<<dims(G, M, N), L::NT, L::SMEM, s>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)w, (__nv_bfloat16*)out, idx, sentinel,
        M, K, N);
    return cudaSuccess;
  }
};

// The live-row body at the column tile (128 or 64) whose last wave is
// fuller; 128 on a tie.
cudaError_t launch_live(const void* x, const void* w, void* out, const int* idx, int sentinel,
                        int G, int M, int K, int N, bool aligned, cudaStream_t s) {
  if (LiveGrid<1>::wave_fill(G, M, N, aligned) > LiveGrid<2>::wave_fill(G, M, N, aligned))
    return LiveGrid<1>::launch(x, w, out, idx, sentinel, G, M, K, N, aligned, s);
  return LiveGrid<2>::launch(x, w, out, idx, sentinel, G, M, K, N, aligned, s);
}

// FMA body at the smallest strip that holds M rows (at most 8); with
// `vs_mma`, the tensor-core body instead when its grid fills the last
// wave better (both grids have the same blocks; the bodies differ in how
// many fit on an SM).
template <typename T, int BM>
void launch_small(const void* x, const void* w, void* out, const int* idx, int sentinel,
                  int G, int M, int K, int N, bool aligned, bool vs_mma, cudaStream_t s) {
  if (vs_mma && Grid<__nv_bfloat16, 16, true>::wave_fill(G, M, N, aligned) >
                    Grid<T, BM, false>::wave_fill(G, M, N, aligned))
    Grid<__nv_bfloat16, 16, true>::launch(x, w, out, idx, sentinel, G, M, K, N, aligned, s);
  else
    Grid<T, BM, false>::launch(x, w, out, idx, sentinel, G, M, K, N, aligned, s);
}

template <typename T>
void launch_fma(const void* x, const void* w, void* out, const int* idx, int sentinel,
                int G, int M, int K, int N, bool aligned, bool vs_mma, cudaStream_t s) {
  if (M <= 1) launch_small<T, 1>(x, w, out, idx, sentinel, G, M, K, N, aligned, vs_mma, s);
  else if (M <= 2) launch_small<T, 2>(x, w, out, idx, sentinel, G, M, K, N, aligned, vs_mma, s);
  else if (M <= 4) launch_small<T, 4>(x, w, out, idx, sentinel, G, M, K, N, aligned, vs_mma, s);
  else launch_small<T, 8>(x, w, out, idx, sentinel, G, M, K, N, aligned, vs_mma, s);
}

}  // namespace

// x (G,M,K), w (G,K,N), out (G,M,N), one dtype, contiguous, 16-byte
// aligned; idx (G,M) int32 or null, `sentinel` its empty slot.  body:
// 0 = by shape, 1 = FMA strips, 2 = tensor-core strips (bf16 only).
// Returns cudaGetLastError().
extern "C" int grouped_matmul(const void* x, const void* w, void* out, const int* idx,
                              int G, int M, int K, int N, int sentinel, int dtype, int body,
                              void* stream) {
  if (G <= 0 || G > 65535 || M <= 0 || K <= 0 || N <= 0 || body < 0 || body > 2)
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)x | (uintptr_t)w | (uintptr_t)out) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    if (body == 2) return (int)cudaErrorInvalidValue;
    launch_fma<float>(x, w, out, idx, sentinel, G, M, K, N, N % 4 == 0 && K % 4 == 0, false, s);
  } else if (dtype == 1) {
    const bool aligned = N % 8 == 0 && K % 8 == 0;
    if (body == 0 && M > FMA_MAX_M) {
      const cudaError_t e = launch_live(x, w, out, idx, sentinel, G, M, K, N, aligned, s);
      if (e != cudaSuccess) return (int)e;
    } else if (body == 2) {
      Grid<__nv_bfloat16, 16, true>::launch(x, w, out, idx, sentinel, G, M, K, N, aligned, s);
    } else {
      launch_fma<__nv_bfloat16>(x, w, out, idx, sentinel, G, M, K, N, aligned, body == 0, s);
    }
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
