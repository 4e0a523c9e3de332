// Fused router -> softmax -> top-k -> capacity dispatch, for Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/gating_topk.py
// (gating_dispatch -> _dispatch_kernel, _topk_core): router GEMM in f32
// plus a logit bias, softmax, k rounds of argmax over the probabilities
// (lowest index wins ties, as lax.top_k), normalized gates, per-expert
// counts weighted by count_weights, and first-come-first-served capacity
// slots in token-major, k-minor order, scattered straight into the
// (E, C) index buffer (sentinel T = empty, drops at slot >= C) and gate
// buffer.  The placement-table and owner-filter branches of the TPU
// kernel are not ported yet; the Python wrapper refuses them.
//
// Bound: bytes.  The call reads x (T x d) and the router (d x E) once;
// at decode T is one micro-batch (<= 8 rows), so the work is a few
// hundred KB and the launch overhead dominates.  Design: two launches.
// route_kernel runs one block per token: each warp takes experts in
// turn and reduces the dot product over d with its lanes, then one
// thread does the softmax and the k argmax rounds over E (<= 256)
// probabilities.  dispatch_kernel is a single block: its threads fill
// the buffers with the sentinel, then one thread walks the T*K entries
// in order, keeping the per-expert occupancy, so slot order and drops
// are exactly those of the sequential definition.  An in-kernel scatter
// is cheap on the GPU, so no (T*K, E) one-hot cumsum is built.

#include "common.cuh"

namespace {

constexpr int NT = 256;
constexpr int MAX_E = 256;
constexpr int MAX_K = 16;

template <typename T>
__global__ void __launch_bounds__(NT) route_kernel(
    const T* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ bias, float* __restrict__ gates,
    int* __restrict__ experts, int d, int E, int K) {
  __shared__ float prob_s[MAX_E];
  const int t = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const T* xr = x + (size_t)t * d;
  for (int e = warp; e < E; e += NT / 32) {
    float acc = 0.f;
    for (int i = lane; i < d; i += 32) acc += repro::to_f(xr[i]) * w[(size_t)i * E + e];
    acc = repro::warp_sum(acc);
    if (lane == 0) prob_s[e] = acc + bias[e];
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
  float g[MAX_K];
  int idx[MAX_K];
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
    gates[(size_t)t * K + k] = g[k] / gsum;
    experts[(size_t)t * K + k] = idx[k];
  }
}

__global__ void __launch_bounds__(NT) dispatch_kernel(
    const float* __restrict__ gates, const int* __restrict__ experts,
    const float* __restrict__ count_weights, int* __restrict__ idx_buf,
    float* __restrict__ gate_buf, float* __restrict__ counts, int T, int E,
    int K, int C) {
  __shared__ int occ_s[MAX_E];
  __shared__ float cnt_s[MAX_E];
  for (int i = threadIdx.x; i < E * C; i += NT) {
    idx_buf[i] = T;
    gate_buf[i] = 0.f;
  }
  for (int e = threadIdx.x; e < E; e += NT) {
    occ_s[e] = 0;
    cnt_s[e] = 0.f;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int t = 0; t < T; ++t) {
      const float cw = count_weights[t];
      for (int k = 0; k < K; ++k) {
        const int e = experts[(size_t)t * K + k];
        cnt_s[e] += cw;
        const int slot = occ_s[e]++;
        if (slot < C) {
          idx_buf[(size_t)e * C + slot] = t;
          gate_buf[(size_t)e * C + slot] = gates[(size_t)t * K + k];
        }
      }
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < E; e += NT) counts[e] = cnt_s[e];
}

}  // namespace

// x (T,d) f32|bf16; w_router (d,E), bias (E,), count_weights (T,) f32;
// scratch gates (T,K) f32 and experts (T,K) int32; outputs idx_buf
// (E,C) int32, gate_buf (E,C) f32, counts (E,) f32.  All contiguous.
extern "C" int gating_dispatch(const void* x, const void* w, const void* bias,
                               const void* count_weights, void* gates,
                               void* experts, void* idx_buf, void* gate_buf,
                               void* counts, int T, int d, int E, int K, int C,
                               int dtype, void* stream) {
  if (T <= 0 || d <= 0 || E <= 0 || E > MAX_E || K <= 0 || K > MAX_K ||
      K > E || C <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  REPRO_DISPATCH_DTYPE(dtype, X, {
    route_kernel<X><<<T, NT, 0, s>>>((const X*)x, (const float*)w,
                                     (const float*)bias, (float*)gates,
                                     (int*)experts, d, E, K);
  });
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dispatch_kernel<<<1, NT, 0, s>>>((const float*)gates, (const int*)experts,
                                   (const float*)count_weights, (int*)idx_buf,
                                   (float*)gate_buf, (float*)counts, T, E, K, C);
  return (int)cudaGetLastError();
}
