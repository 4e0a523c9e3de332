// Router -> softmax -> top-k for one token, shared by gating_dispatch.cu
// and gating_topk.cu.
//
// The whole block computes the E router logits (x . w in f32, x cast to
// f32; each warp takes experts in turn and reduces over d with its
// lanes), then thread 0 does the softmax and k rounds of strict argmax
// over the probabilities.  The lowest index wins a tie and a chosen
// expert is set to -1, so it is never chosen again: this is
// jax.lax.top_k's choice, the JAX oracle's (kernels/ref.py) and the
// port's plain moe.route.  The TPU kernels' _topk_core masks a chosen
// expert by multiplying it to 0 instead, and so picks index 0 again
// when the other probabilities underflow to 0; that is not copied.
#pragma once

#include "common.cuh"

namespace repro {

constexpr int ROUTE_MAX_E = 256;
constexpr int ROUTE_MAX_K = 16;

// Call with every thread of a block of NT threads.  prob_s: shared,
// >= E floats.  bias may be null.  Thread 0 writes the K normalized
// gates and expert ids of the token to gates[0..K) and experts[0..K).
template <typename T, int NT>
__device__ void route_token(const T* __restrict__ xr,
                            const float* __restrict__ w,
                            const float* __restrict__ bias, int d, int E,
                            int K, float* prob_s, float* gates, int* experts) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int e = warp; e < E; e += NT / 32) {
    float acc = 0.f;
    for (int i = lane; i < d; i += 32) acc += to_f(xr[i]) * w[(size_t)i * E + e];
    acc = warp_sum(acc);
    if (lane == 0) prob_s[e] = acc + (bias != nullptr ? bias[e] : 0.f);
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  float mx = prob_s[0];
  for (int e = 1; e < E; ++e) mx = fmaxf(mx, prob_s[e]);
  float sum = 0.f;
  for (int e = 0; e < E; ++e) {
    prob_s[e] = expf(prob_s[e] - mx);
    sum += prob_s[e];
  }
  for (int e = 0; e < E; ++e) prob_s[e] = prob_s[e] / sum;
  float g[ROUTE_MAX_K];
  int idx[ROUTE_MAX_K];
  float gsum = 0.f;
  for (int k = 0; k < K; ++k) {
    float best = -1.f;
    int bi = 0;
    for (int e = 0; e < E; ++e) {
      if (prob_s[e] > best) {  // strict: the lowest index wins a tie
        best = prob_s[e];
        bi = e;
      }
    }
    prob_s[bi] = -1.f;  // probabilities are >= 0: never picked again
    g[k] = best;
    idx[k] = bi;
    gsum += best;
  }
  for (int k = 0; k < K; ++k) {
    gates[k] = g[k] / gsum;
    experts[k] = idx[k];
  }
}

}  // namespace repro
