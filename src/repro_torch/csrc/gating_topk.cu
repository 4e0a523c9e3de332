// Fused router -> softmax -> top-k -> per-expert counts, for Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/gating_topk.py
// (gating_topk -> _kernel, _topk_core): router GEMM in f32 (x and w cast
// to f32), softmax, k rounds of argmax over the probabilities,
// normalized gates (T, K) f32, expert ids (T, K) int32 and per-expert
// routed-token counts (E,) int32.  The top-k follows jax.lax.top_k (the
// JAX oracle kernels/ref.py gating_topk_ref), not the TPU kernel's
// multiply-mask, which repeats expert 0 when the other probabilities
// underflow (route.cuh).
//
// Bound: bytes.  The call reads x (T x d) and the router (d x E) once
// and does 2 * T * d * E flops, ~0.5 flop per byte of the router.  At
// decode T is one micro-batch (4 rows at the serving shape), so the work
// is ~245 KB (0.07 us of HBM time) and the time is latency: the launch,
// one round trip to memory and the dependent steps after it.
//
// Design: gating_dispatch.cu's front end (route.cuh's
// router_cluster_topk), so one call spreads the router over 8 SMs.
//  * Grid: a thread-block cluster of 8 blocks per tile of up to 16
//    tokens.  Block r of a cluster sums rows [r * per, (r + 1) * per) of
//    d (the wrapper's chunk_plan, the one gating_dispatch uses) from
//    shared-memory tiles filled by 16-byte cp.async; block 0 sums the
//    partials in chunk order through distributed shared memory and one
//    warp per token does the softmax and top-k into shared memory.  The
//    gates and experts are those of gating_dispatch on the same inputs,
//    bit for bit, and two launches agree bit for bit.
//  * Epilogue: block 0 of each cluster writes its tile's gates and expert
//    ids.
//  * Counts, T <= 16 (one cluster, the decode shape): block 0 counts them
//    from shared memory, one thread per expert, in token order.  The
//    call is one launch and one device op: no memset, no atomics.
//  * Counts, T > 16: a second, one-block launch counts the (T, K) expert
//    ids the clusters wrote, in a shared-memory histogram of integer
//    atomics (exact in any order), and writes every count, so the buffer
//    needs no zeroing: two device ops (the wrapper's topk_launches).
#include "route.cuh"

#include <cstdint>

namespace {

constexpr int NT = repro::ROUTE_NT;
constexpr int CLUSTER = repro::ROUTE_CLUSTER;
constexpr int TOK = repro::ROUTE_TOK;

template <typename X>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(NT)
    gating_topk_kernel(const X* __restrict__ x, const float* __restrict__ w,
                       float* __restrict__ gates, int* __restrict__ experts,
                       int* __restrict__ counts, int T, int d, int E, int K, int per,
                       int rt) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float gate_s[TOK * repro::ROUTE_MAX_K];
  __shared__ int expert_s[TOK * repro::ROUTE_MAX_K];
  repro::router_cluster_topk<X>(x, w, nullptr, T, d, E, K, per, rt, smem, gate_s,
                                expert_s);
  if (cooperative_groups::this_cluster().block_rank() != 0) return;
  const int t0 = (int)(blockIdx.x / CLUSTER) * TOK, n = min(TOK, T - t0) * K;
  for (int i = threadIdx.x; i < n; i += NT) {
    gates[(size_t)t0 * K + i] = gate_s[i];
    experts[(size_t)t0 * K + i] = expert_s[i];
  }
  if (T > TOK) return;  // gating_topk_counts_kernel counts
  for (int e = threadIdx.x; e < E; e += NT) {
    int c = 0;
    for (int i = 0; i < n; ++i) c += expert_s[i] == e;
    counts[e] = c;
  }
}

// the second launch of the T > TOK path: counts (E,) of the n = T * K
// expert ids
__global__ void __launch_bounds__(NT) gating_topk_counts_kernel(
    const int* __restrict__ experts, int* __restrict__ counts, int n, int E) {
  __shared__ int hist[repro::ROUTE_MAX_E];
  for (int e = threadIdx.x; e < E; e += NT) hist[e] = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += NT) atomicAdd(&hist[experts[i]], 1);
  __syncthreads();
  for (int e = threadIdx.x; e < E; e += NT) counts[e] = hist[e];
}

}  // namespace

// x (T,d) f32|bf16 and w_router (d,E) f32, both 16-byte aligned; outputs
// gates (T,K) f32, experts (T,K) int32, counts (E,) int32.  per: rows of
// d per block, a multiple of 8 with 8 * per >= d.  All contiguous.
// Returns cudaGetLastError().
extern "C" int gating_topk(const void* x, const void* w, void* gates, void* experts,
                           void* counts, int T, int d, int E, int K, int per,
                           int dtype, void* stream) {
  if (repro::route_check(T, d, E, K, per) != cudaSuccess)
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)x | (uintptr_t)w) % 16 != 0) return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned blocks = (unsigned)((T + TOK - 1) / TOK * CLUSTER);
  const int TT = T < TOK ? T : TOK;
  REPRO_DISPATCH_DTYPE(dtype, X, {
    const int rt = repro::route_tile_rows<X>(TT, E, per);
    const size_t bytes = repro::route_smem_bytes<X>(TT, E, rt);
    gating_topk_kernel<X><<<blocks, NT, bytes, s>>>(
        (const X*)x, (const float*)w, (float*)gates, (int*)experts, (int*)counts, T,
        d, E, K, per, rt);
  });
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || T <= TOK) return (int)err;
  gating_topk_counts_kernel<<<1, NT, 0, s>>>((const int*)experts, (int*)counts, T * K,
                                             E);
  return (int)cudaGetLastError();
}
