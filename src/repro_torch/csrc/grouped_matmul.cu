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
// ~295 flops/byte balance point.  The weights must stream from HBM once
// per call (at Mixtral width one grouped MLP reads 8*3*6144*16384*2 B,
// about 4.83 GB).  Design: each thread owns one output column n and a
// BM-row strip of accumulators in registers (BM = the smallest power of
// two >= M, at most 16), so every weight element is loaded exactly once
// per strip, by one thread, coalesced across the warp along N.  The x
// strip is staged through shared memory in BK-deep slices and read as a
// broadcast.  Plain FMA in f32: tensor cores (mma/wgmma) and TMA
// pipelining are later work; the rows of a small M would leave most of
// an mma tile empty anyway.

#include "common.cuh"

namespace {

constexpr int NT = 256;  // threads per block = output columns per block
constexpr int BK = 64;   // x slice depth staged in shared memory

template <typename T, int BM>
__global__ void __launch_bounds__(NT) grouped_matmul_kernel(
    const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
    int M, int K, int N) {
  __shared__ float xs[BM][BK];
  const int g = blockIdx.z, m0 = blockIdx.y * BM;
  const int n = blockIdx.x * NT + threadIdx.x;
  const T* xg = x + (size_t)g * M * K;
  const T* wg = w + (size_t)g * K * N;
  float acc[BM];
#pragma unroll
  for (int r = 0; r < BM; ++r) acc[r] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = threadIdx.x; i < BM * BK; i += NT) {
      const int r = i / BK, c = i % BK, m = m0 + r, kk = k0 + c;
      xs[r][c] = (m < M && kk < K) ? repro::to_f(xg[(size_t)m * K + kk]) : 0.f;
    }
    __syncthreads();
    if (n < N) {
      const int kmax = min(BK, K - k0);
      const T* wp = wg + (size_t)k0 * N + n;
#pragma unroll 8
      for (int c = 0; c < kmax; ++c) {
        const float wv = repro::to_f(wp[(size_t)c * N]);
#pragma unroll
        for (int r = 0; r < BM; ++r) acc[r] += xs[r][c] * wv;
      }
    }
    __syncthreads();
  }
  if (n < N) {
#pragma unroll
    for (int r = 0; r < BM; ++r)
      if (m0 + r < M) out[((size_t)g * M + m0 + r) * N + n] = repro::from_f<T>(acc[r]);
  }
}

template <typename T, int BM>
void launch(const void* x, const void* w, void* out, int G, int M, int K,
            int N, cudaStream_t s) {
  const dim3 grid((N + NT - 1) / NT, (M + BM - 1) / BM, G);
  grouped_matmul_kernel<T, BM><<<grid, NT, 0, s>>>((const T*)x, (const T*)w,
                                                   (T*)out, M, K, N);
}

}  // namespace

// x (G,M,K), w (G,K,N), out (G,M,N), one dtype, contiguous.
extern "C" int grouped_matmul(const void* x, const void* w, void* out, int G,
                              int M, int K, int N, int dtype, void* stream) {
  if (G <= 0 || G > 65535 || M <= 0 || K <= 0 || N <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  REPRO_DISPATCH_DTYPE(dtype, T, {
    if (M <= 1) launch<T, 1>(x, w, out, G, M, K, N, s);
    else if (M <= 2) launch<T, 2>(x, w, out, G, M, K, N, s);
    else if (M <= 4) launch<T, 4>(x, w, out, G, M, K, N, s);
    else if (M <= 8) launch<T, 8>(x, w, out, G, M, K, N, s);
    else launch<T, 16>(x, w, out, G, M, K, N, s);
  });
  return (int)cudaGetLastError();
}
