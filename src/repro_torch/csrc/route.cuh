// Router logits and softmax -> top-k, shared by gating_topk.cu and
// gating_dispatch.cu.
//
// router_logits_block: a whole block computes the E router logits of one
// token (x . w in f32, x cast to f32; each warp takes experts in turn and
// reduces over d with its lanes).  gating_topk.cu computes its logits
// so; gating_dispatch.cu splits d over a thread-block cluster instead.
//
// softmax_topk_warp: one warp takes one token's logits, the experts
// across its lanes, and does the softmax and k rounds of strict argmax
// over the probabilities.  The lowest index wins a tie and a chosen
// expert is set to -1, so it is never chosen again: this is
// jax.lax.top_k's choice, the JAX oracle's (kernels/ref.py) and the
// port's plain moe.route.  The TPU kernels' _topk_core masks a chosen
// expert by multiplying it to 0 instead, and so picks index 0 again
// when the other probabilities underflow to 0; that is not copied.
#pragma once

#include "common.cuh"

#include <climits>

namespace repro {

constexpr int ROUTE_MAX_E = 256;
constexpr int ROUTE_MAX_K = 16;
constexpr int ROUTE_LANE_E = ROUTE_MAX_E / 32;  // experts per lane

// Call with every thread of a block of NT threads.  logit_s: shared, >= E
// floats; holds the logits (no bias) after the call, which ends with a
// __syncthreads.
template <typename T, int NT>
__device__ void router_logits_block(const T* __restrict__ xr,
                                    const float* __restrict__ w, int d, int E,
                                    float* logit_s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int e = warp; e < E; e += NT / 32) {
    float acc = 0.f;
    for (int i = lane; i < d; i += 32) acc += to_f(xr[i]) * w[(size_t)i * E + e];
    acc = warp_sum(acc);
    if (lane == 0) logit_s[e] = acc;
  }
  __syncthreads();
}

// Call with all 32 lanes of a warp.  v[j] holds the logit of expert
// lane + 32 j (entries at or past E are ignored) and is overwritten.
// Lane 0 writes the K normalized gates and expert ids of the token to
// gates[0..K) and experts[0..K) (shared or global memory).  The lane
// reductions span the lanes that hold an expert (8 lanes at E = 8); the
// lanes they skip would only add zeros, so the values are those of a
// 32-lane reduction.
__device__ __forceinline__ void softmax_topk_warp(float (&v)[ROUTE_LANE_E], int E,
                                                  int K, float* gates, int* experts) {
  const int lane = threadIdx.x & 31;
  const int J = (E + 31) / 32;  // experts per lane in use; the loops stop there
  int span = 1;  // first xor offset: half the lanes in use, a power of 2
  while (2 * span < E && span < 16) span *= 2;
  if (E == 1) span = 0;
  float mx = -3.402823466e38f;
#pragma unroll
  for (int j = 0; j < ROUTE_LANE_E && j < J; ++j)
    if (lane + 32 * j < E) mx = fmaxf(mx, v[j]);
  for (int o = span; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < ROUTE_LANE_E && j < J; ++j) {
    if (lane + 32 * j < E) {
      v[j] = expf(v[j] - mx);
      sum += v[j];
    }
  }
  for (int o = span; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
#pragma unroll
  for (int j = 0; j < ROUTE_LANE_E && j < J; ++j)
    v[j] = lane + 32 * j < E ? v[j] / sum : -2.f;  // -2: never picked
  float gsum = 0.f;
  for (int k = 0; k < K; ++k) {
    // strict argmax over the lane's experts in index order, then across
    // lanes: the larger value wins, the lower index wins a tie
    float best = -1.f;
    int bi = INT_MAX;
#pragma unroll
    for (int j = 0; j < ROUTE_LANE_E && j < J; ++j) {
      if (v[j] > best) {
        best = v[j];
        bi = lane + 32 * j;
      }
    }
    for (int o = span; o > 0; o >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      if (ob > best || (ob == best && oi < bi)) {
        best = ob;
        bi = oi;
      }
    }
#pragma unroll
    for (int j = 0; j < ROUTE_LANE_E && j < J; ++j)
      if (lane + 32 * j == bi) v[j] = -1.f;  // probabilities are >= 0: never again
    gsum += best;
    if (lane == 0) {
      gates[k] = best;
      experts[k] = bi;
    }
  }
  __syncwarp();
  if (lane == 0)
    for (int k = 0; k < K; ++k) gates[k] = gates[k] / gsum;
  __syncwarp();
}

}  // namespace repro
