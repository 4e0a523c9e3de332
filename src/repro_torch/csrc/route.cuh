// The router front end shared by gating_topk.cu and gating_dispatch.cu:
// router logits over a thread-block cluster, then softmax -> top-k.
//
// router_cluster_topk: a cluster of ROUTE_CLUSTER blocks routes one tile
// of up to ROUTE_TOK tokens.  Block r sums rows [r * per, (r + 1) * per)
// of d (per a multiple of 8, from the wrappers' chunk_plan) from
// shared-memory tiles filled by 16-byte cp.async, its threads splitting
// the (token, expert) logits and, when there are fewer logits than
// threads, the rows too (row groups summed in group order).  After
// cluster.sync() block 0 reads the blocks' partial logits through
// distributed shared memory, sums them in chunk order 0..7 and adds the
// bias, so the sum order is fixed: two launches on the same inputs agree
// bit for bit, and the two kernels, which share this code and the
// wrappers' chunk plan, give the same gates and experts.  One warp per
// token then runs softmax_topk_warp.
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
#include <cooperative_groups.h>
#include <cstdint>

namespace repro {

namespace cg = cooperative_groups;

constexpr int ROUTE_MAX_E = 256;
constexpr int ROUTE_MAX_K = 16;
constexpr int ROUTE_LANE_E = ROUTE_MAX_E / 32;  // experts per lane
constexpr int ROUTE_NT = 256;                   // threads per block
constexpr int ROUTE_CLUSTER = 8;                // blocks per cluster: d is split 8 ways
constexpr int ROUTE_TOK = 16;                   // tokens per cluster
constexpr int ROUTE_ALIGN_ROWS = 8;             // chunk and tile starts: multiples of 8 rows
constexpr int ROUTE_SMEM_BYTES = 40 * 1024;     // the tiles' dynamic shared memory

__host__ __device__ __forceinline__ size_t align16(size_t n) {
  return (n + 15) & ~(size_t)15;
}

// floats of the row groups' sums: G * TT * E <= max(NT, TT * E)
__host__ __device__ __forceinline__ int route_acc_floats(int TT, int E) {
  return TT * E > ROUTE_NT ? TT * E : ROUTE_NT;
}

// rows of d per shared-memory tile: as many as the budget holds beside
// the row groups' sums, at most the chunk
template <typename X>
int route_tile_rows(int TT, int E, int per) {
  const size_t fixed = align16((size_t)route_acc_floats(TT, E) * 4);
  const size_t row = (size_t)E * 4 + (size_t)TT * sizeof(X);
  const int rt =
      (int)((ROUTE_SMEM_BYTES - fixed) / row) / ROUTE_ALIGN_ROWS * ROUTE_ALIGN_ROWS;
  return rt < per ? rt : per;
}

// the front end's dynamic shared memory at TT tokens a tile, rt rows
template <typename X>
size_t route_smem_bytes(int TT, int E, int rt) {
  return align16((size_t)route_acc_floats(TT, E) * 4) + (size_t)rt * E * 4 +
         (size_t)TT * rt * sizeof(X);
}

// The arguments every router kernel checks: the shape, the chunk rows
// per (a multiple of 8 covering d in ROUTE_CLUSTER chunks) and the tiles'
// grid.  Returns cudaSuccess or cudaErrorInvalidValue.
inline cudaError_t route_check(int T, int d, int E, int K, int per) {
  const long long tiles = (T + ROUTE_TOK - 1) / ROUTE_TOK;
  if (T <= 0 || d <= 0 || E <= 0 || E > ROUTE_MAX_E || K <= 0 || K > ROUTE_MAX_K ||
      K > E || per <= 0 || per % ROUTE_ALIGN_ROWS != 0 ||
      (long long)per * ROUTE_CLUSTER < d || tiles * ROUTE_CLUSTER > 0x7fffffffLL ||
      (long long)T * K > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// 8 consecutive elements of x from shared memory, as f32 (16 or 32 bytes)
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* f) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}
__device__ __forceinline__ void load8(const float* p, float* f) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w;
  f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
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

// Call with every thread of every block of a cluster of ROUTE_CLUSTER
// blocks of ROUTE_NT threads, in a one-dimensional grid: the cluster of
// block b routes tokens [t0, t0 + nt), t0 = b / ROUTE_CLUSTER * ROUTE_TOK.
// x (T, d), w (d, E) f32, both 16-byte aligned; bias (E,) f32 or null
// (zeros).  per: rows of d per block (route_check); rt: rows per tile,
// route_tile_rows<X>(min(T, ROUTE_TOK), E, per); smem: the kernel's
// dynamic shared memory, route_smem_bytes<X>(min(T, ROUTE_TOK), E, rt)
// bytes at its start used here.  Block 0 writes token t0 + t's K
// normalized gates and expert ids to gates[t * K ..] and experts[t * K ..]
// (shared or global memory).  Ends with a cluster.sync(), after which
// those writes are visible to every thread of block 0 and the other
// blocks may exit.
template <typename X>
__device__ __forceinline__ void router_cluster_topk(
    const X* __restrict__ x, const float* __restrict__ w, const float* __restrict__ bias,
    int T, int d, int E, int K, int per, int rt, unsigned char* smem, float* gates,
    int* experts) {
  constexpr int NT = ROUTE_NT, CLUSTER = ROUTE_CLUSTER, TOK = ROUTE_TOK;
  constexpr int VX = 16 / sizeof(X);  // elements of x per 16-byte copy
  __shared__ float bias_s[ROUTE_MAX_E];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), tid = threadIdx.x;
  const int TT = min(T, TOK);
  const int t0 = (int)(blockIdx.x / CLUSTER) * TOK, nt = min(TOK, T - t0);
  if (rank == 0)  // block 0's bias, loaded while the others work
    for (int e = tid; e < E; e += NT) bias_s[e] = bias != nullptr ? bias[e] : 0.f;
  // (G, nt, E) row groups' sums; group 0's become the partial logits
  float* acc_s = reinterpret_cast<float*>(smem);
  float* w_s =
      reinterpret_cast<float*>(smem + align16((size_t)route_acc_floats(TT, E) * 4));
  X* x_s = reinterpret_cast<X*>(w_s + (size_t)rt * E);  // (nt, rt) slice of x

  // logit o = t * E + e.  G groups of threads split the rows: group g
  // takes the 8-row blocks g, g + G, ... of a tile (one 16-byte load of
  // x and 8 independent loads of w each) and sums into acc_s[g * nout +
  // o].  With fewer logits than threads G = NT / nout and each thread
  // has one logit; otherwise G = 1 and each thread sums logits tid, tid
  // + NT, ...  Each slot starts at 0, has one writer and adds each
  // tile's sum.
  const int nout = nt * E;
  const int G = nout >= NT ? 1 : NT / nout;
  const int g = tid / nout;  // 0 when G == 1
  for (int i = tid; i < G * nout; i += NT) acc_s[i] = 0.f;

  const int r_begin = min(d, rank * per), r_end = min(d, r_begin + per);
  for (int r0 = r_begin; r0 < r_end; r0 += rt) {
    const int rows = min(rt, r_end - r0);
    const float* wsrc = w + (size_t)r0 * E;
    const int nw = rows * E, nw4 = nw / 4;
    for (int i = tid; i < nw4; i += NT) cp_async16(w_s + 4 * i, wsrc + 4 * i);
    for (int i = 4 * nw4 + tid; i < nw; i += NT) w_s[i] = wsrc[i];
    if (d % VX == 0) {  // every row of x starts on a 16-byte boundary
      const int nv = rows / VX;
      for (int i = tid; i < nt * nv; i += NT) {
        const int t = i / nv, c = i % nv;
        cp_async16(x_s + (size_t)t * rt + c * VX,
                   x + (size_t)(t0 + t) * d + r0 + c * VX);
      }
    } else {
      for (int i = tid; i < nt * rows; i += NT) {
        const int t = i / rows, c = i % rows;
        x_s[(size_t)t * rt + c] = x[(size_t)(t0 + t) * d + r0 + c];
      }
    }
    cp_async_wait_all();
    __syncthreads();
#pragma unroll 1
    for (int o = tid % nout; g < G && o < nout; o += NT) {
      const int t = o / E, e = o % E;
      const X* xr = x_s + (size_t)t * rt;
      float a = 0.f;
      for (int b = g; b < rows / 8; b += G) {
        float xf[8], wf[8];
        load8(xr + b * 8, xf);
#pragma unroll
        for (int i = 0; i < 8; ++i) wf[i] = w_s[(b * 8 + i) * E + e];
#pragma unroll
        for (int i = 0; i < 8; ++i) a = fmaf(xf[i], wf[i], a);
      }
      if (g == 0)  // the ragged end of d (d % 8 != 0)
        for (int i = rows / 8 * 8; i < rows; ++i)
          a = fmaf(to_f(xr[i]), w_s[i * E + e], a);
      acc_s[g * nout + o] += a;
    }
    __syncthreads();
  }
  __syncthreads();  // a block with no rows has only zeroed its sums
  for (int o = tid; o < nout; o += NT) {  // the groups' sums, in group order
    float s = acc_s[o];
    for (int q = 1; q < G; ++q) s += acc_s[q * nout + o];
    acc_s[o] = s;
  }
  cluster.sync();  // every block's partials are visible to block 0

  if (rank == 0) {
    const int lane = tid & 31, J = (E + 31) / 32;
    for (int t = tid >> 5; t < nt; t += NT / 32) {
      float v[ROUTE_LANE_E];
#pragma unroll
      for (int j = 0; j < ROUTE_LANE_E && j < J; ++j) {
        const int e = lane + 32 * j;
        v[j] = 0.f;
        if (e < E) {
          float pr[CLUSTER];
#pragma unroll
          for (int r = 0; r < CLUSTER; ++r)
            pr[r] = cluster.map_shared_rank(acc_s, r)[t * E + e];
          float s = pr[0];
#pragma unroll
          for (int r = 1; r < CLUSTER; ++r) s += pr[r];
          v[j] = s + bias_s[e];
        }
      }
      softmax_topk_warp(v, E, K, gates + t * K, experts + t * K);
    }
  }
  cluster.sync();  // block 0 is done reading; the other blocks may exit
}

}  // namespace repro
