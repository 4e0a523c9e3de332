// Fused router -> softmax -> top-k -> per-expert counts, for Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/gating_topk.py
// (gating_topk -> _kernel, _topk_core): router GEMM in f32 (x and w cast
// to f32), softmax, k rounds of argmax over the probabilities,
// normalized gates (T, K) f32, expert ids (T, K) int32 and per-expert
// routed-token counts (E,) int32.  The top-k is route.cuh's, shared with
// gating_dispatch.cu: it follows jax.lax.top_k (the JAX oracle
// kernels/ref.py gating_topk_ref), not the TPU kernel's multiply-mask,
// which repeats expert 0 when the other probabilities underflow.
//
// Bound: bytes.  The call reads x (T x d) and the router (d x E) once
// and does 2 * T * d * E flops, ~0.5 flop per byte of the router.  At
// decode T is one micro-batch, so the work is a few hundred KB and the
// launch dominates.  Design: one block per token; its warps compute the
// E logits (route.cuh's router_logits_block), then warp 0 does the
// softmax and top-k with the experts across its lanes (softmax_topk_warp,
// shared with gating_dispatch.cu).  The counts are one atomicAdd per
// (token, k) on an int32 (E,) buffer zeroed on the same stream before the
// launch; integer atomics are exact, so their order does not matter.

#include "route.cuh"

namespace {

constexpr int NT = 256;

template <typename T>
__global__ void __launch_bounds__(NT) gating_topk_kernel(
    const T* __restrict__ x, const float* __restrict__ w,
    float* __restrict__ gates, int* __restrict__ experts,
    int* __restrict__ counts, int d, int E, int K) {
  __shared__ float logit_s[repro::ROUTE_MAX_E];
  const int t = blockIdx.x, lane = threadIdx.x & 31;
  int* ex = experts + (size_t)t * K;
  repro::router_logits_block<T, NT>(x + (size_t)t * d, w, d, E, logit_s);
  if (threadIdx.x >= 32) return;
  float v[repro::ROUTE_LANE_E];
#pragma unroll
  for (int j = 0; j < repro::ROUTE_LANE_E; ++j)
    v[j] = lane + 32 * j < E ? logit_s[lane + 32 * j] : 0.f;
  repro::softmax_topk_warp(v, E, K, gates + (size_t)t * K, ex);
  if (lane == 0) {
    for (int k = 0; k < K; ++k) atomicAdd(&counts[ex[k]], 1);
  }
}

}  // namespace

// x (T,d) f32|bf16; w_router (d,E) f32; outputs gates (T,K) f32, experts
// (T,K) int32, counts (E,) int32.  All contiguous.  Returns
// cudaGetLastError().
extern "C" int gating_topk(const void* x, const void* w, void* gates,
                           void* experts, void* counts, int T, int d, int E,
                           int K, int dtype, void* stream) {
  if (T <= 0 || d <= 0 || E <= 0 || E > repro::ROUTE_MAX_E || K <= 0 ||
      K > repro::ROUTE_MAX_K || K > E)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(counts, 0, sizeof(int) * (size_t)E, s);
  if (err != cudaSuccess) return (int)err;
  REPRO_DISPATCH_DTYPE(dtype, X, {
    gating_topk_kernel<X><<<T, NT, 0, s>>>((const X*)x, (const float*)w,
                                           (float*)gates, (int*)experts,
                                           (int*)counts, d, E, K);
  });
  return (int)cudaGetLastError();
}
