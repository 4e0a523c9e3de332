// Grouped (per-expert) matmul, for Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/grouped_matmul.py
// (grouped_matmul -> _kernel): out[g] = x[g] @ w[g] for (G,M,K) x
// (G,K,N) -> (G,M,N), accumulated in f32 and cast to x's dtype.
// kernels/ops.py composes three of these into the grouped expert MLP.
//
// Bound: bytes.  At decode M is one micro-batch's capacity (C = T <= 8
// rows in capacity_mode "full"), so each weight element is used by at
// most 8 rows: ~2*M flops per 2-byte bf16 weight, far below the card's
// ~295 flops/byte balance point.  Every call streams its weights from
// HBM once: at Mixtral width one projection reads 8*6144*16384*2 B =
// 1.61 GB, 0.48 ms at 3.35 TB/s.  Reaching that needs ~20-30 KB of loads
// in flight on every one of the 132 SMs at both of the path's shapes,
// N = 16384 (up) and N = 6144 (down).
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
//    from ldmatrix and the weight tile as B from ldmatrix.trans; it takes
//    bf16 at M > 8, in strips of 16 rows.  At bf16 M <= 8 both bodies
//    launch the same blocks, but from M = 3 on the FMA body's registers
//    fit two blocks on an SM where the MMA body fits three, so the entry point
//    takes the body whose last wave of blocks is fuller on this card
//    (measured on the H100: FMA at N = 16384, 1024 blocks; MMA at
//    N = 6144, 384 blocks).  A function of the shapes and the compiled
//    kernels only.  The caller may force either body to time both.
//  * Ragged edges (rows k >= K, columns n >= N, rows m >= M) are filled
//    with zeros in the stage and masked at the store.  When N or K is not
//    a multiple of the 16-byte vector, the rows are not 16-byte aligned:
//    the stages are then filled with element loads (a choice by shape;
//    misaligned base pointers are refused).

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
    int M, int K, int N) {
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
  for (int i = tid; i < BM * TN; i += NT) {
    const int m = i / TN, n = i % TN;
    if (m0 + m >= M || n0 + n >= N) continue;
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < L::NKG; ++q) s += red[(q * BM + m) * TN + n];
    out[((size_t)g * M + m0 + m) * N + n0 + n] = repro::from_f<T>(s);
  }
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
    static int per_sm[2] = {-1, -1};  // resident blocks per SM, per compiled kernel
    int& fit = per_sm[aligned];
    if (fit < 0) {
      int n = 0;
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel(aligned), NT, L::SMEM);
      fit = n > 0 ? n : 1;
    }
    int dev = 0, sms = 1;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const dim3 d = dims(G, M, N);
    const double blocks = (double)d.x * d.y * d.z, slots = (double)fit * sms;
    return blocks / (slots * std::ceil(blocks / slots));
  }
  static void launch(const void* x, const void* w, void* out, int G, int M, int K,
                     int N, bool aligned, cudaStream_t s) {
    kernel(aligned)<<<dims(G, M, N), NT, L::SMEM, s>>>((const T*)x, (const T*)w, (T*)out, M, K, N);
  }
};

// FMA body at the smallest strip that holds M rows (at most 8); with
// `vs_mma`, the tensor-core body instead when its grid fills the last
// wave better (both grids have the same blocks; the bodies differ in how
// many fit on an SM).
template <typename T, int BM>
void launch_small(const void* x, const void* w, void* out, int G, int M, int K, int N,
                  bool aligned, bool vs_mma, cudaStream_t s) {
  if (vs_mma && Grid<__nv_bfloat16, 16, true>::wave_fill(G, M, N, aligned) >
                    Grid<T, BM, false>::wave_fill(G, M, N, aligned))
    Grid<__nv_bfloat16, 16, true>::launch(x, w, out, G, M, K, N, aligned, s);
  else
    Grid<T, BM, false>::launch(x, w, out, G, M, K, N, aligned, s);
}

template <typename T>
void launch_fma(const void* x, const void* w, void* out, int G, int M, int K,
                int N, bool aligned, bool vs_mma, cudaStream_t s) {
  if (M <= 1) launch_small<T, 1>(x, w, out, G, M, K, N, aligned, vs_mma, s);
  else if (M <= 2) launch_small<T, 2>(x, w, out, G, M, K, N, aligned, vs_mma, s);
  else if (M <= 4) launch_small<T, 4>(x, w, out, G, M, K, N, aligned, vs_mma, s);
  else launch_small<T, 8>(x, w, out, G, M, K, N, aligned, vs_mma, s);
}

}  // namespace

// x (G,M,K), w (G,K,N), out (G,M,N), one dtype, contiguous, 16-byte
// aligned.  body: 0 = by shape, 1 = FMA, 2 = tensor cores (bf16 only).
// Returns cudaGetLastError().
extern "C" int grouped_matmul(const void* x, const void* w, void* out, int G,
                              int M, int K, int N, int dtype, int body,
                              void* stream) {
  if (G <= 0 || G > 65535 || M <= 0 || K <= 0 || N <= 0 || body < 0 || body > 2)
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)x | (uintptr_t)w | (uintptr_t)out) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    if (body == 2) return (int)cudaErrorInvalidValue;
    launch_fma<float>(x, w, out, G, M, K, N, N % 4 == 0 && K % 4 == 0, false, s);
  } else if (dtype == 1) {
    const bool aligned = N % 8 == 0 && K % 8 == 0;
    if (body == 2 || (body == 0 && M > FMA_MAX_M))
      Grid<__nv_bfloat16, 16, true>::launch(x, w, out, G, M, K, N, aligned, s);
    else
      launch_fma<__nv_bfloat16>(x, w, out, G, M, K, N, aligned, body == 0, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
