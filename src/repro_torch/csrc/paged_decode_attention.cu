// Flash-decode GQA attention over a paged KV pool, read through a block
// table, for Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention.py
// (paged_decode_attention -> _paged_kernel).  The pool holds P pages of
// ps slots; row b's logical ring slot w lives in physical page
// block_table[b, w / ps] (-1 = unmapped) at offset w % ps.  The math is
// that of decode_attention.cu: the mask pos_pages >= 0 && pos_pages <=
// pos (and > pos - window when a window is set), scale hd**-0.5, an
// optional logit softcap, an online softmax in f32 with the same -1e30
// fill, masked p zeroed and the denominator clamped at 1e-30.
//
// Bound: bytes.  A call must read the K/V of each row's valid slots once
// (2 * Hkv * hd elements per slot) and does ~4 flops per element per
// query head, far below the card's ~295 flops/byte balance point.
// Design: the structure of decode_attention.cu, one block per (kv head,
// batch row), each K/V tile loaded once into shared memory for all
// rep = H / Hkv query heads of the group.  A tile is 32 logical slots,
// which spans 32 / ps pages (or part of one page when ps > 32); each
// slot's page comes from the block table, read here on the device, so
// no dense copy of the cache is ever made.  A tile none of whose slots
// is valid (unmapped pages, slots past pos) is skipped whole, loads
// included: that is exact, since such a tile leaves the running max,
// the denominator and the accumulator unchanged.  K/V of masked slots
// in a tile that is kept are not loaded either (read as 0, weight 0).
// A row with no valid slot at all comes out as zeros, as in the Pallas
// kernel and the contiguous kernel (the dense softmax reference would
// average V there); a decoding row always holds its own token.

#include "common.cuh"

namespace {

constexpr int NT = 128;      // threads per block
constexpr int TW = 32;       // logical slots per tile (= one warp's lanes)
constexpr int MAX_REP = 16;  // query heads per KV head

template <typename T, int HD>
__global__ void __launch_bounds__(NT) paged_decode_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ pos_pages, const int* __restrict__ block_table,
    const int* __restrict__ pos, T* __restrict__ out, int H, int Hkv, int ps,
    int n_logical, int window, float softcap, float scale) {
  const int g = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int rep = H / Hkv;
  const int W = n_logical * ps;

  __shared__ float q_s[MAX_REP][HD];
  __shared__ float k_s[TW][HD + 1];  // +1: no bank conflicts across slots
  __shared__ float v_s[TW][HD];
  __shared__ float p_s[MAX_REP][TW];
  __shared__ float m_s[MAX_REP], l_s[MAX_REP], alpha_s[MAX_REP];
  __shared__ int ok_s[TW];
  __shared__ long long slot_s[TW];   // pool slot (page * ps + offset), -1 = masked

  const T* qb = q + ((size_t)b * H + (size_t)g * rep) * HD;
  for (int i = tid; i < rep * HD; i += NT) q_s[i / HD][i % HD] = repro::to_f(qb[i]);
  for (int r = tid; r < rep; r += NT) {
    m_s[r] = -1e30f;
    l_s[r] = 0.f;
  }

  constexpr int ACC = MAX_REP * HD / NT;
  float acc[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = 0.f;

  const int pos_b = pos[b];
  const int* bt = block_table + (size_t)b * n_logical;
  for (int w0 = 0; w0 < W; w0 += TW) {
    // one lane per slot: its page from the table, its position, its mask
    int ok = 0;
    if (tid < TW) {
      const int w = w0 + tid;
      long long slot = -1;
      if (w < W) {
        const int page = bt[w / ps];
        if (page >= 0) {
          const long long s = (long long)page * ps + (w % ps);
          const int cp = pos_pages[s];
          ok = cp >= 0 && cp <= pos_b && (window <= 0 || cp > pos_b - window);
          if (ok) slot = s;
        }
      }
      ok_s[tid] = ok;
      slot_s[tid] = slot;
    }
    if (!__syncthreads_or(ok)) continue;  // block-uniform: nothing valid here

    for (int i = tid; i < TW * HD; i += NT) {
      const int j = i / HD, d = i % HD;
      const long long s = slot_s[j];
      float kv = 0.f, vv = 0.f;
      if (s >= 0) {
        const size_t off = ((size_t)s * Hkv + g) * HD + d;
        kv = repro::to_f(k[off]);
        vv = repro::to_f(v[off]);
      }
      k_s[j][d] = kv;
      v_s[j][d] = vv;
    }
    __syncthreads();

    // scores s[r][j] = q_r . k_j * scale (softcapped, masked to -1e30)
    for (int i = tid; i < rep * TW; i += NT) {
      const int r = i / TW, j = i % TW;
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < HD; ++d) s += q_s[r][d] * k_s[j][d];
      s *= scale;
      if (softcap > 0.f) s = softcap * tanhf(s / softcap);
      p_s[r][j] = ok_s[j] ? s : -1e30f;
    }
    __syncthreads();

    // online softmax update, one warp per query head, one lane per slot
    for (int r = warp; r < rep; r += NT / 32) {
      const float s = p_s[r][lane];
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, repro::warp_max(s));
      const float p = expf(s - m_new) * (float)ok_s[lane];
      const float psum = repro::warp_sum(p);
      p_s[r][lane] = p;
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        alpha_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + psum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc[r][d] = acc * alpha + sum_j p[r][j] * v[j][d]
#pragma unroll
    for (int i = 0; i < ACC; ++i) {
      const int idx = tid + i * NT, r = idx / HD, d = idx % HD;
      if (r < rep) {
        float a = acc[i] * alpha_s[r];
#pragma unroll 8
        for (int j = 0; j < TW; ++j) a += p_s[r][j] * v_s[j][d];
        acc[i] = a;
      }
    }
    __syncthreads();
  }

  T* ob = out + ((size_t)b * H + (size_t)g * rep) * HD;
#pragma unroll
  for (int i = 0; i < ACC; ++i) {
    const int idx = tid + i * NT, r = idx / HD;
    if (r < rep) ob[idx] = repro::from_f<T>(acc[i] / fmaxf(l_s[r], 1e-30f));
  }
}

}  // namespace

// q (B,H,hd), k/v pages (P,ps,Hkv,hd) of one dtype; pos_pages (P,ps),
// block_table (B,n_logical), pos (B,) int32; out (B,H,hd).  All
// contiguous; every table entry is -1 or a page below P.  Returns
// cudaGetLastError().
extern "C" int paged_decode_attention(const void* q, const void* k,
                                      const void* v, const void* pos_pages,
                                      const void* block_table, const void* pos,
                                      void* out, int B, int H, int Hkv, int ps,
                                      int n_logical, int hd, int window,
                                      float softcap, float scale, int dtype,
                                      void* stream) {
  if (B <= 0 || Hkv <= 0 || H % Hkv != 0 || H / Hkv > MAX_REP || ps <= 0 ||
      n_logical <= 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(Hkv, B);
  cudaStream_t s = (cudaStream_t)stream;
  REPRO_DISPATCH_DTYPE(dtype, T, {
    if (hd == 64) {
      paged_decode_attention_kernel<T, 64><<<grid, NT, 0, s>>>(
          (const T*)q, (const T*)k, (const T*)v, (const int*)pos_pages,
          (const int*)block_table, (const int*)pos, (T*)out, H, Hkv, ps,
          n_logical, window, softcap, scale);
    } else if (hd == 128) {
      paged_decode_attention_kernel<T, 128><<<grid, NT, 0, s>>>(
          (const T*)q, (const T*)k, (const T*)v, (const int*)pos_pages,
          (const int*)block_table, (const int*)pos, (T*)out, H, Hkv, ps,
          n_logical, window, softcap, scale);
    } else {
      return (int)cudaErrorInvalidValue;
    }
  });
  return (int)cudaGetLastError();
}
