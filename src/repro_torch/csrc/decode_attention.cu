// Flash-decode GQA attention over a ring-buffer KV cache, for Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention.py
// (decode_attention -> _kernel): one query token per request attends
// over its cache, with the mask cache_pos >= 0 && cache_pos <= pos (and
// cache_pos > pos - window when a window is set), scale hd**-0.5, an
// optional logit softcap, and an online softmax in f32 with the same
// -1e30 fill, masked p zeroed and the denominator clamped at 1e-30.
//
// Bound: bytes.  Each call must read the whole K/V cache once
// (2 * B * W * Hkv * hd elements) and does ~4 flops per element read
// per query head, far below the card's ~295 flops/byte balance point.
// Design: one block per (kv head, batch row).  The block walks W in
// tiles of 32 slots; each K/V tile is loaded once into shared memory
// (coalesced along hd) and used by all rep = H / Hkv query heads of the
// group, so the cache is read exactly once.  The running max,
// denominator and the (rep, hd) accumulator stay on chip for the whole
// walk.  At decode batch sizes B * Hkv blocks underfill the 132 SMs
// (Mixtral: Hkv = 8, B <= 8 per micro-batch gives <= 64 blocks);
// splitting W across blocks with a log-sum-exp merge is later work.

#include "common.cuh"

namespace {

constexpr int NT = 128;      // threads per block
constexpr int TW = 32;       // KV slots per tile (= one warp's lanes)
constexpr int MAX_REP = 16;  // query heads per KV head

template <typename T, int HD>
__global__ void __launch_bounds__(NT) decode_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ cache_pos, const int* __restrict__ pos,
    T* __restrict__ out, int H, int Hkv, int W, int window, float softcap,
    float scale) {
  using repro::to_f;
  const int g = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int rep = H / Hkv;

  __shared__ float q_s[MAX_REP][HD];
  __shared__ float k_s[TW][HD + 1];  // +1: no bank conflicts across slots
  __shared__ float v_s[TW][HD];
  __shared__ float p_s[MAX_REP][TW];
  __shared__ float m_s[MAX_REP], l_s[MAX_REP], alpha_s[MAX_REP];
  __shared__ int ok_s[TW];

  const T* qb = q + ((size_t)b * H + (size_t)g * rep) * HD;
  for (int i = tid; i < rep * HD; i += NT) q_s[i / HD][i % HD] = to_f(qb[i]);
  for (int r = tid; r < rep; r += NT) {
    m_s[r] = -1e30f;
    l_s[r] = 0.f;
  }

  constexpr int ACC = MAX_REP * HD / NT;
  float acc[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = 0.f;

  const int pos_b = pos[b];
  for (int w0 = 0; w0 < W; w0 += TW) {
    for (int i = tid; i < TW * HD; i += NT) {
      const int j = i / HD, d = i % HD, w = w0 + j;
      float kv = 0.f, vv = 0.f;
      if (w < W) {
        const size_t off = (((size_t)b * W + w) * Hkv + g) * HD + d;
        kv = to_f(k[off]);
        vv = to_f(v[off]);
      }
      k_s[j][d] = kv;
      v_s[j][d] = vv;
    }
    if (tid < TW) {
      const int w = w0 + tid;
      int ok = 0;
      if (w < W) {
        const int cp = cache_pos[(size_t)b * W + w];
        ok = cp >= 0 && cp <= pos_b && (window <= 0 || cp > pos_b - window);
      }
      ok_s[tid] = ok;
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

// q (B,H,hd), k/v (B,W,Hkv,hd) of one dtype; cache_pos (B,W), pos (B,)
// int32; out (B,H,hd).  All contiguous.  Returns cudaGetLastError().
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* cache_pos, const void* pos,
                                void* out, int B, int H, int Hkv, int W,
                                int hd, int window, float softcap, float scale,
                                int dtype, void* stream) {
  if (B <= 0 || Hkv <= 0 || H % Hkv != 0 || H / Hkv > MAX_REP || W <= 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(Hkv, B);
  cudaStream_t s = (cudaStream_t)stream;
  REPRO_DISPATCH_DTYPE(dtype, T, {
    if (hd == 64) {
      decode_attention_kernel<T, 64><<<grid, NT, 0, s>>>(
          (const T*)q, (const T*)k, (const T*)v, (const int*)cache_pos,
          (const int*)pos, (T*)out, H, Hkv, W, window, softcap, scale);
    } else if (hd == 128) {
      decode_attention_kernel<T, 128><<<grid, NT, 0, s>>>(
          (const T*)q, (const T*)k, (const T*)v, (const int*)cache_pos,
          (const int*)pos, (T*)out, H, Hkv, W, window, softcap, scale);
    } else {
      return (int)cudaErrorInvalidValue;
    }
  });
  return (int)cudaGetLastError();
}
