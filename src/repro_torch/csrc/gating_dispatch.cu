// Fused router -> softmax -> top-k -> capacity dispatch, for Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/gating_topk.py
// (gating_dispatch -> _dispatch_kernel, _topk_core, and the buffer
// scatter after it): router GEMM in f32 plus a logit bias, softmax, k
// rounds of argmax over the probabilities (lowest index wins ties, as
// lax.top_k), normalized gates, per-expert counts weighted by
// count_weights, and first-come-first-served capacity slots in
// token-major, k-minor order, scattered straight into the (rows, C)
// index buffer (sentinel T = empty, drops at slot >= C) and gate buffer.
// Both branches of the TPU kernel are here:
//  * placement tables (live expert placement): rep_node / rep_slot /
//    rep_cum (E, R) map each (token, k) entry to one replica of its
//    expert.  The replica is the first r with u < rep_cum[e, r], u the
//    token-index hash in [0, 1) (moe.token_hash01, bit for bit: uint32
//    multiplies, then __uint2float_rn(h) * 2^-32; a hash that rounds to
//    1.0 clamps to the last replica), and the entry's bucket is the
//    virtual slot node * S + slot of the (N*S, ...) placed weights;
//  * owner filter (m2n): only the entries whose node (the table's, or
//    bucket / S without tables) is the owner take a slot, and the
//    buffers are that node's S rows.
// Without owner the rows are the n_buckets buckets (E, N*S with tables,
// or N*e_loc > E when m2n pads the experts).  counts stays per routed
// expert (E,) and covers every entry, before the replica split and the
// owner filter.
//
// Bound: bytes.  The call reads x (T x d), the router (d x E) and the
// tables (3 E R x 4 B) once; at decode T is one micro-batch (4 rows at
// the serving shape), so the work is ~245 KB (0.07 us of HBM time) and
// the time is latency: the launch, one round trip to memory, and the
// dependent steps after it, each run once per call on cold caches,
// instructions included.
//
// Design: one launch of a thread-block cluster of CLUSTER = 8 blocks per
// tile of up to TOK = 16 tokens (blocks tile * CLUSTER .. + 7 of a
// one-dimensional grid).
//  * The front end, up to the top-k, is route.cuh's router_cluster_topk,
//    shared with gating_topk.cu: block r of the cluster sums rows
//    [r * per, (r + 1) * per) of d (the wrapper's chunk_plan) from
//    shared-memory tiles filled by 16-byte cp.async, its threads
//    splitting the logits and, below 256 logits, the rows (G row groups);
//    after cluster.sync() block 0 sums the partials in chunk order through
//    distributed shared memory, adds the bias, and one warp per token
//    does the softmax and the top-k.  The sum order is fixed, so two
//    launches on the same inputs agree bit for bit, with no global
//    scratch, atomics or counters, and gating_topk gives the same gates
//    and experts.  At the decode shape (32 logits, G = 8) the call took
//    0.0110 ms against 0.0123 ms with one logit per thread (G = 1), L2
//    flushed, on an NVIDIA H100 80GB HBM3 at 700 W
//    (scripts/time_route_kernels.py).  Block 0 loads the count weights and
//    the placement tables for its epilogue before it (the tables after
//    the front end's tiles in shared memory, so the tile plan, and with
//    it the logits, do not depend on them).
//  * T <= TOK (one cluster, the decode path): block 0 goes on to the
//    dispatch.  Warp j takes output row j and expert j.  It scans the
//    T*K entries in token order, 32 at a time: each lane maps its entry
//    to its bucket (through the tables and the hash) and its node, and
//    two ballots find the entries of row j (those the owner keeps) and
//    the entries routed to expert j.  Slot order, drops and the weighted
//    count (summed in token order) are exactly those of the sequential
//    definition.  One launch in all.
//  * T > TOK: one cluster per tile of TOK tokens writes the gates and
//    expert ids to a (T, K) scratch, and a second, one-block launch does
//    the dispatch scan over all T tokens (the hash takes the token's row
//    in the call, as in the one-launch path).
//  * Each step runs once per call, so the code it runs is kept short:
//    per-thread loops rather than unrolled register arrays, and the
//    per-lane loops stop at the experts in use (one slot per lane at
//    E <= 32).
#include "route.cuh"

#include <cstdint>

namespace {

constexpr int NT = repro::ROUTE_NT;
constexpr int CLUSTER = repro::ROUTE_CLUSTER;
constexpr int TOK = repro::ROUTE_TOK;
constexpr int MAX_E = repro::ROUTE_MAX_E;
constexpr int MAX_K = repro::ROUTE_MAX_K;
constexpr int MAX_ROWS = 256;         // rows of the output buffers
constexpr int MAX_TABLE = 4096;       // E * R entries of each placement table

// The placement tables (E, R) in shared memory; node == nullptr: none.
struct Tables {
  const int* node;
  const int* slot;
  const float* cum;
  int R;
};

// moe.token_hash01: token index -> [0, 1) (splitmix-style), bit for bit
__device__ __forceinline__ float hash01(unsigned t) {
  unsigned h = t * 2654435761u;
  h ^= h >> 16;
  h *= 2246822519u;
  h ^= h >> 13;
  return __uint2float_rn(h) * 0x1p-32f;
}

// The bucket of an entry of expert e and token tok, and its node: the
// expert itself (node e / S, found only for an owner) without tables;
// with them the virtual slot node * S + slot of the replica the token
// hash picks.
__device__ __forceinline__ int entry_bucket(int e, int tok, const Tables& tb, int S,
                                            int owner, int& node) {
  if (tb.node == nullptr) {
    node = owner >= 0 ? e / S : 0;
    return e;
  }
  const float u = hash01((unsigned)tok);
  const int row = e * tb.R;
  int r = 0;
  for (int j = 0; j < tb.R; ++j) r += u >= tb.cum[row + j];
  r = min(r, tb.R - 1);  // u rounded to 1.0 passes every cum
  node = tb.node[row + r];
  return node * S + tb.slot[row + r];
}

// Call with every thread of a block.  gates / experts: (T, K) in shared
// or global memory, cw: (T,) or null (all ones).  Warp j takes output
// row j (j < rows: bucket j, or the owner's local slot j) and expert j
// (j < E: its count).  It scans the T*K entries in token-major, k-minor
// order, 32 at a time: a ballot finds the entries of its row, each takes
// the running count plus its rank in the ballot as its slot (first come,
// dropped at slot >= C), and a second ballot finds the entries routed to
// its expert, whose weights the count adds in token order; the slots
// left empty get the sentinel T.  Each row and each count has one
// writer, so no barrier is needed.
__device__ __forceinline__ void dispatch_block(
    const float* gates, const int* experts, const float* cw, const Tables& tb,
    int S, int owner, int rows, int* __restrict__ idx_buf,
    float* __restrict__ gate_buf, float* __restrict__ counts, int T, int E, int K,
    int C) {
  const int lane = threadIdx.x & 31, n = T * K;
  const int base = owner >= 0 ? owner * S : 0, J = max(rows, E);
  for (int j = threadIdx.x >> 5; j < J; j += blockDim.x >> 5) {
    const bool has_row = j < rows, has_count = j < E;
    int* idx_row = idx_buf + (size_t)j * C;
    float* gate_row = gate_buf + (size_t)j * C;
    int occ = 0;
    float cnt = 0.f;
    for (int b0 = 0; b0 < n; b0 += 32) {
      const int i = b0 + lane;
      bool mine = false, counted = false;
      if (i < n) {
        const int e = experts[i];
        int node;
        const int bucket = entry_bucket(e, i / K, tb, S, owner, node);
        mine = has_row && (owner < 0 || node == owner) && bucket == base + j;
        counted = has_count && e == j;
      }
      const float wt = counted ? (cw != nullptr ? cw[i / K] : 1.f) : 0.f;
      const unsigned m = __ballot_sync(0xffffffffu, mine);
      const unsigned mc = __ballot_sync(0xffffffffu, counted);
      if (mine) {
        const int slot = occ + __popc(m & ((1u << lane) - 1u));
        if (slot < C) {
          idx_row[slot] = i / K;
          gate_row[slot] = gates[i];
        }
      }
      for (unsigned r = mc; r != 0; r &= r - 1)  // in entry (token) order
        cnt += __shfl_sync(0xffffffffu, wt, __ffs(r) - 1);
      occ += __popc(m);
    }
    if (has_row)
      for (int s = min(occ, C) + lane; s < C; s += 32) {
        idx_row[s] = T;
        gate_row[s] = 0.f;
      }
    if (has_count && lane == 0) counts[j] = cnt;
  }
}

// Copy the (E, R) tables to shared memory (node, slot, cum back to back)
// with the calling block's threads; returns their view there.
__device__ __forceinline__ Tables load_tables(const int* rep_node, const int* rep_slot,
                                              const float* rep_cum, int ER, int R,
                                              void* dst) {
  int* node_s = reinterpret_cast<int*>(dst);
  int* slot_s = node_s + ER;
  float* cum_s = reinterpret_cast<float*>(slot_s + ER);
  for (int i = threadIdx.x; i < ER; i += blockDim.x) {
    node_s[i] = rep_node[i];
    slot_s[i] = rep_slot[i];
    cum_s[i] = rep_cum[i];
  }
  return Tables{node_s, slot_s, cum_s, R};
}

template <typename X>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(NT)
    gating_dispatch_kernel(const X* __restrict__ x, const float* __restrict__ w,
                           const float* __restrict__ bias,
                           const float* __restrict__ cw,
                           const int* __restrict__ rep_node,
                           const int* __restrict__ rep_slot,
                           const float* __restrict__ rep_cum, float* __restrict__ gates,
                           int* __restrict__ experts, int* __restrict__ idx_buf,
                           float* __restrict__ gate_buf,
                           float* __restrict__ counts, int T, int d, int E, int K,
                           int C, int per, int rt, int R, int S, int owner,
                           int n_rows, int tbl_off) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float gate_s[TOK * MAX_K];
  __shared__ int expert_s[TOK * MAX_K];
  __shared__ float cw_s[TOK];
  const int rank = (int)cooperative_groups::this_cluster().block_rank(), tid = threadIdx.x;
  const int t0 = (int)(blockIdx.x / CLUSTER) * TOK;
  const bool fused = T <= TOK;
  Tables tb{nullptr, nullptr, nullptr, 0};
  if (rank == 0) {  // block 0's epilogue inputs, loaded while the others work
    if (fused && tid < T) cw_s[tid] = cw != nullptr ? cw[tid] : 1.f;
    if (fused && rep_node != nullptr)  // after the tiles: visible at cluster.sync()
      tb = load_tables(rep_node, rep_slot, rep_cum, E * R, R, smem + tbl_off);
  }
  repro::router_cluster_topk<X>(x, w, bias, T, d, E, K, per, rt, smem,
                                fused ? gate_s : gates + (size_t)t0 * K,
                                fused ? expert_s : experts + (size_t)t0 * K);
  if (rank != 0 || !fused) return;
  dispatch_block(gate_s, expert_s, cw_s, tb, S, owner, n_rows, idx_buf, gate_buf,
                 counts, T, E, K, C);
}

// the second launch of the T > TOK path: the dispatch scan over all T
// tokens' (T, K) gates and expert ids, the tables in dynamic shared memory
__global__ void __launch_bounds__(NT) gating_dispatch_slots_kernel(
    const float* __restrict__ gates, const int* __restrict__ experts,
    const float* __restrict__ cw, const int* __restrict__ rep_node,
    const int* __restrict__ rep_slot, const float* __restrict__ rep_cum,
    int* __restrict__ idx_buf, float* __restrict__ gate_buf,
    float* __restrict__ counts, int T, int E, int K, int C, int R, int S, int owner,
    int rows) {
  extern __shared__ __align__(16) unsigned char tbl_s[];
  Tables tb{nullptr, nullptr, nullptr, 0};
  if (rep_node != nullptr) {
    tb = load_tables(rep_node, rep_slot, rep_cum, E * R, R, tbl_s);
    __syncthreads();
  }
  dispatch_block(gates, experts, cw, tb, S, owner, rows, idx_buf, gate_buf, counts, T,
                 E, K, C);
}

// Raise a kernel's dynamic shared-memory limit to `bytes` when it is
// above the default 48 KB (large placement tables), once per kernel.
template <typename F>
cudaError_t allow_smem(F* kernel, size_t bytes, size_t& granted) {
  if (bytes <= granted) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) granted = bytes;
  return e;
}

}  // namespace

// x (T,d) f32|bf16 and w_router (d,E) f32, both 16-byte aligned; bias
// (E,) and count_weights (T,) f32 or null (zeros / ones); rep_node,
// rep_slot (E,R) int32 and rep_cum (E,R) f32, all three or none (no
// placement tables); outputs idx_buf (rows,C) int32, gate_buf (rows,C)
// f32, counts (E,) f32.  gates (T,K) f32 and experts (T,K) int32 are
// scratch for T > 16 and may be null otherwise.  per: rows of d per
// block, a multiple of 8 with 8 * per >= d.  S: slots per node (> 0);
// owner: -1, or the node whose S rows are the output (rows == S).  Every
// bucket an entry maps to must lie in [0, rows) without owner, every
// local slot in [0, S) with it.  All contiguous.  Returns
// cudaGetLastError().
extern "C" int gating_dispatch(const void* x, const void* w, const void* bias,
                               const void* count_weights, const void* rep_node,
                               const void* rep_slot, const void* rep_cum, void* gates,
                               void* experts, void* idx_buf, void* gate_buf,
                               void* counts, int T, int d, int E, int K, int C,
                               int per, int R, int S, int owner, int rows, int dtype,
                               void* stream) {
  const bool tables = rep_node != nullptr;
  if (repro::route_check(T, d, E, K, per) != cudaSuccess || C <= 0 || S <= 0 ||
      rows <= 0 || rows > MAX_ROWS || owner < -1 || (owner >= 0 && rows != S) ||
      (tables && (rep_slot == nullptr || rep_cum == nullptr || R <= 0 ||
                  (long long)E * R > MAX_TABLE)))
    return (int)cudaErrorInvalidValue;
  const bool fused = T <= TOK;
  if (!fused && (gates == nullptr || experts == nullptr))
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)x | (uintptr_t)w) % 16 != 0) return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned blocks = (unsigned)((T + TOK - 1) / TOK * CLUSTER);
  const int TT = T < TOK ? T : TOK;
  const size_t tbl_bytes = tables ? (size_t)E * R * 12 : 0;
  REPRO_DISPATCH_DTYPE(dtype, X, {
    const int rt = repro::route_tile_rows<X>(TT, E, per);
    const size_t tbl_off = repro::align16(repro::route_smem_bytes<X>(TT, E, rt));
    const size_t bytes = tbl_off + (fused ? tbl_bytes : 0);
    static size_t granted = 48 * 1024;
    const cudaError_t e = allow_smem(gating_dispatch_kernel<X>, bytes, granted);
    if (e != cudaSuccess) return (int)e;
    gating_dispatch_kernel<X><<<blocks, NT, bytes, s>>>(
        (const X*)x, (const float*)w, (const float*)bias, (const float*)count_weights,
        (const int*)rep_node, (const int*)rep_slot, (const float*)rep_cum,
        (float*)gates, (int*)experts, (int*)idx_buf, (float*)gate_buf,
        (float*)counts, T, d, E, K, C, per, rt, R, S, owner, rows, (int)tbl_off);
  });
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || fused) return (int)err;
  static size_t granted_slots = 48 * 1024;
  err = allow_smem(gating_dispatch_slots_kernel, tbl_bytes, granted_slots);
  if (err != cudaSuccess) return (int)err;
  gating_dispatch_slots_kernel<<<1, NT, tbl_bytes, s>>>(
      (const float*)gates, (const int*)experts, (const float*)count_weights,
      (const int*)rep_node, (const int*)rep_slot, (const float*)rep_cum,
      (int*)idx_buf, (float*)gate_buf, (float*)counts, T, E, K, C, R, S, owner, rows);
  return (int)cudaGetLastError();
}
