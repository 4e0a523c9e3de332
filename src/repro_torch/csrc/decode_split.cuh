// The flash-decoding split kernel and its merge kernel, shared by
// decode_attention.cu (a ring-buffer cache) and paged_decode_attention.cu
// (a page pool read through a block table).
//
// One query token per request attends over W logical slots, with the mask
// slot_pos >= 0 && slot_pos <= pos (and slot_pos > pos - window when a
// window is set), scale hd**-0.5, an optional logit softcap, and an online
// softmax in f32 with the -1e30 fill, masked p zeroed and the denominator
// clamped at 1e-30, as the Pallas TPU kernels.
//
// The two callers differ only in where logical slot w of row b lives.  A
// slot map (RingSlots, PagedSlots) turns (b, w) into a memory slot s, or
// -1 for a slot that is masked and never loaded; K/V of slot s are the
// rows [s, g, :] of a (slots, Hkv, hd) array and its position is
// slot_pos[s].  Everything else (the split plan, the tile order, every
// arithmetic step) is the same code, so the paged kernel over a pool and
// the ring kernel over PagePool.gather's view of it (W = n_logical * ps,
// unmapped pages read pos = -1) compute the same values in the same
// order and agree bit for bit.
//
// Bound: bytes, in principle.  Each call must read the K/V of the valid
// slots once and does ~4 flops per element read per query head, far
// below the card's ~295 flops/byte balance point.  At decode sizes that
// is a few MB (0.2-1.3 us of HBM time), so the time is latency: how many
// dependent steps the longest block takes, and how many blocks share it.
//
// Design (flash-decoding):
//  * W is split across blocks.  A block owns one (kv head, row, split)
//    and walks its split's tiles of TW = 32 slots; the wrapper picks the
//    split count from the shapes (B, Hkv, W) alone, so the arithmetic
//    never depends on the data.  At B = 4, Hkv = 8, W = 256 that is 8
//    splits of one tile, 256 blocks instead of 32.
//  * A tile none of whose slots is valid is skipped before its loads
//    (__syncthreads_or on the per-slot mask), which is exact.  The mask
//    lanes read the slot map (for a page pool: the block table) once per
//    tile; a tile may span several pages (ps < 32) or part of one.
//  * K/V are read with 16-byte loads along hd, all of a tile's loads
//    issued before the first is used; each tile is read once for all rep
//    query heads of the group, and q is staged once per block.  Each
//    warp computes one query head's 32 scores and its softmax update in
//    registers: three barriers per tile.  256 threads: at rep = 6 all
//    heads' scores and the whole (rep x hd) accumulator update take one
//    pass of the block.
//  * Each split writes its partial (acc, m, l) to a scratch buffer the
//    wrapper allocates; a second kernel, launched by the same entry
//    point, merges the splits in a fixed order with the log-sum-exp rule,
//    one block per (query head, row) and one thread per channel.
//    A split with no valid slot holds m = -1e30, l = 0, acc = 0, so a row
//    with no valid slot at all comes out as 0, as in the Pallas kernel.
//  * head_dim 64, 128 and 256 (recurrentgemma-2b's local attention).  The
//    f32 tiles (q, K, V, p) live in dynamic shared memory, sized by HD
//    (SplitTiles<HD>): 20.5 KB at 64, 43 KB at 128, 84.5 KB at 256, past
//    the 48 KB a block may declare statically, so the 256 instantiation
//    raises its dynamic limit with cudaFuncSetAttribute before its first
//    launch.  Two such blocks fit on one SM (228 KB).
#pragma once

#include "common.cuh"

#include <cstdint>

namespace {

constexpr int NT = 256;      // threads per block of the split kernel
constexpr int MAX_SPLITS = 64;  // splits of the ring (<= hd: one merge thread each)
constexpr int TW = 32;       // KV slots per tile (= one warp's lanes)
constexpr int MAX_REP = 16;  // query heads per KV head

// ring buffer: row b's slot w is memory slot b * W + w
struct RingSlots {
  int W;
  __device__ __forceinline__ long long operator()(int b, int w) const {
    return (long long)b * W + w;
  }
};

// page pool: row b's slot w lives in page block_table[b, w / ps] (-1 =
// unmapped: masked, never loaded) at offset w % ps
struct PagedSlots {
  const int* __restrict__ table;
  int n_logical, ps;
  __device__ __forceinline__ long long operator()(int b, int w) const {
    const int page = table[(size_t)b * n_logical + w / ps];
    return page < 0 ? -1 : (long long)page * ps + w % ps;
  }
};

__device__ __forceinline__ void unpack(const uint4& u, float* f, float) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float* f, __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// the f32 tiles of one block of the split kernel, in dynamic shared memory
template <int HD>
struct alignas(16) SplitTiles {
  float q[MAX_REP][HD];
  float k[TW][HD + 4];  // +4: float4 rows without bank conflicts
  float v[TW][HD];
  float p[MAX_REP][TW];
};

// scratch layout (at most MAX_SPLITS splits):
// part[((b * Hkv + g) * nsplit + split) * rep + r][0..HD) holds acc,
// [HD] the running max m and [HD + 1] the denominator l
template <typename T, int HD, typename Slots>
__global__ void __launch_bounds__(NT) decode_attention_split_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ slot_pos, Slots slots, const int* __restrict__ pos,
    float* __restrict__ part, int H, int Hkv, int W, int nsplit, int split_tiles,
    int window, float softcap, float scale) {
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int HV = HD / VEC;         // 16-byte loads per slot row
  constexpr int LD = TW * HV / NT;     // K (and V) loads per thread per tile
  constexpr int D4 = HD / 4;           // float4 columns of a head
  constexpr int ACC = MAX_REP * D4 / NT;
  static_assert(TW * HV % NT == 0 && MAX_REP * D4 % NT == 0, "tile shape");
  const int g = blockIdx.x, b = blockIdx.y, sp = blockIdx.z, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int rep = H / Hkv;

  extern __shared__ __align__(16) unsigned char split_smem[];
  SplitTiles<HD>& tiles = *reinterpret_cast<SplitTiles<HD>*>(split_smem);
  float(*q_s)[HD] = tiles.q;
  float(*k_s)[HD + 4] = tiles.k;
  float(*v_s)[HD] = tiles.v;
  float(*p_s)[TW] = tiles.p;
  __shared__ float m_s[MAX_REP], l_s[MAX_REP], alpha_s[MAX_REP];
  __shared__ long long slot_s[TW];  // memory slot of each valid slot, -1 = masked

  const T* qb = q + ((size_t)b * H + (size_t)g * rep) * HD;
  for (int i = tid; i < rep * HV; i += NT) {
    float f[VEC];
    unpack(reinterpret_cast<const uint4*>(qb)[i], f, T());
#pragma unroll
    for (int e = 0; e < VEC; ++e) (&q_s[0][0])[i * VEC + e] = f[e];
  }
  for (int r = tid; r < rep; r += NT) {
    m_s[r] = -1e30f;
    l_s[r] = 0.f;
  }
  float4 acc[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  const int pos_b = pos[b];
  const int t_end = min((W + TW - 1) / TW, (sp + 1) * split_tiles);
  for (int t = sp * split_tiles; t < t_end; ++t) {
    const int w0 = t * TW;
    int ok = 0;
    if (tid < TW) {
      const int w = w0 + tid;
      long long s = -1;
      if (w < W) s = slots(b, w);
      if (s >= 0) {
        const int cp = slot_pos[s];
        ok = cp >= 0 && cp <= pos_b && (window <= 0 || cp > pos_b - window);
      }
      slot_s[tid] = ok ? s : -1;
    }
    // block-uniform: a tile with no valid slot changes nothing
    if (!__syncthreads_or(ok)) continue;

    uint4 kr[LD], vr[LD];
#pragma unroll
    for (int u = 0; u < LD; ++u) {
      const int i = tid + u * NT, j = i / HV, c = i % HV;
      kr[u] = vr[u] = make_uint4(0u, 0u, 0u, 0u);
      const long long s = slot_s[j];
      if (s >= 0) {
        const size_t off = ((size_t)s * Hkv + g) * HD + c * VEC;
        kr[u] = *reinterpret_cast<const uint4*>(k + off);
        vr[u] = *reinterpret_cast<const uint4*>(v + off);
      }
    }
#pragma unroll
    for (int u = 0; u < LD; ++u) {
      const int i = tid + u * NT, j = i / HV, c = i % HV;
      float kf[VEC], vf[VEC];
      unpack(kr[u], kf, T());
      unpack(vr[u], vf, T());
#pragma unroll
      for (int e = 0; e < VEC; e += 4) {
        *reinterpret_cast<float4*>(&k_s[j][c * VEC + e]) =
            make_float4(kf[e], kf[e + 1], kf[e + 2], kf[e + 3]);
        *reinterpret_cast<float4*>(&v_s[j][c * VEC + e]) =
            make_float4(vf[e], vf[e + 1], vf[e + 2], vf[e + 3]);
      }
    }
    __syncthreads();

    // one warp per query head, one lane per slot: score, softcap, mask,
    // and the online softmax update of the head's running max / sum
    for (int r = warp; r < rep; r += NT / 32) {
      const float4* qr = reinterpret_cast<const float4*>(q_s[r]);
      const float4* kj = reinterpret_cast<const float4*>(k_s[lane]);
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < D4; ++d) {
        const float4 a = qr[d], c = kj[d];
        s = fmaf(a.x, c.x, s);
        s = fmaf(a.y, c.y, s);
        s = fmaf(a.z, c.z, s);
        s = fmaf(a.w, c.w, s);
      }
      s *= scale;
      if (softcap > 0.f) s = softcap * tanhf(s / softcap);
      const int okj = slot_s[lane] >= 0;
      s = okj ? s : -1e30f;
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, repro::warp_max(s));
      const float p = expf(s - m_new) * (float)okj;
      const float psum = repro::warp_sum(p);
      p_s[r][lane] = p;
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        alpha_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + psum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc[r][d4] = acc * alpha + sum_j p[r][j] * v[j][d4]; the next
    // tile's __syncthreads_or orders these reads before its stores
#pragma unroll
    for (int i = 0; i < ACC; ++i) {
      const int idx = tid + i * NT, r = idx / D4, d4 = idx % D4;
      if (r < rep) {
        const float al = alpha_s[r];
        float4 a = acc[i];
        a.x *= al;
        a.y *= al;
        a.z *= al;
        a.w *= al;
#pragma unroll 8
        for (int j = 0; j < TW; ++j) {
          const float pj = p_s[r][j];
          const float4 vv = reinterpret_cast<const float4*>(v_s[j])[d4];
          a.x = fmaf(pj, vv.x, a.x);
          a.y = fmaf(pj, vv.y, a.y);
          a.z = fmaf(pj, vv.z, a.z);
          a.w = fmaf(pj, vv.w, a.w);
        }
        acc[i] = a;
      }
    }
  }
  __syncthreads();

  float* pb = part + ((size_t)(b * Hkv + g) * nsplit + sp) * rep * (HD + 2);
#pragma unroll
  for (int i = 0; i < ACC; ++i) {
    const int idx = tid + i * NT, r = idx / D4, d4 = idx % D4;
    if (r < rep) {
      float* o = pb + r * (HD + 2) + d4 * 4;
      o[0] = acc[i].x;
      o[1] = acc[i].y;
      o[2] = acc[i].z;
      o[3] = acc[i].w;
    }
  }
  for (int r = tid; r < rep; r += NT) {
    pb[r * (HD + 2) + HD] = m_s[r];
    pb[r * (HD + 2) + HD + 1] = l_s[r];
  }
}

// One block per (query head, row), one thread per channel d:
// out[b, h, d] = sum_s e_s acc_s[d] / max(sum_s e_s l_s, 1e-30) with
// e_s = exp(m_s - max_s m_s), summed over the splits in order.
template <typename T>
__global__ void decode_attention_merge_kernel(const float* __restrict__ part,
                                    T* __restrict__ out, int H, int Hkv, int hd,
                                    int nsplit) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int rep = H / Hkv, g = h / rep;
  const size_t stride = (size_t)rep * (hd + 2);  // from one split to the next
  const float* pb = part + ((size_t)(b * Hkv + g) * nsplit * rep + h % rep) * (hd + 2);
  __shared__ float m_s[MAX_SPLITS], l_s[MAX_SPLITS];
  if (d < nsplit) {
    m_s[d] = pb[d * stride + hd];
    l_s[d] = pb[d * stride + hd + 1];
  }
  __syncthreads();
  float mx = -1e30f;
  for (int s = 0; s < nsplit; ++s) mx = fmaxf(mx, m_s[s]);
  float a = 0.f, l = 0.f;
#pragma unroll 8
  for (int s = 0; s < nsplit; ++s) {
    const float e = expf(m_s[s] - mx);
    a = fmaf(e, pb[s * stride + d], a);
    l = fmaf(e, l_s[s], l);
  }
  out[((size_t)b * H + h) * hd + d] = repro::from_f<T>(a / fmaxf(l, 1e-30f));
}

// Launches the split kernel at head_dim HD with its tiles in dynamic
// shared memory; above the 48 KB default the function's limit is raised
// first (once per instantiation).
template <typename T, int HD, typename Slots>
cudaError_t launch_split(dim3 grid, cudaStream_t s, const T* q, const T* k,
                         const T* v, const int* slot_pos, Slots slots,
                         const int* pos, float* part, int H, int Hkv, int W,
                         int nsplit, int split_tiles, int window, float softcap,
                         float scale) {
  constexpr int smem = (int)sizeof(SplitTiles<HD>);
  if (smem > 48 * 1024) {
    static bool raised = false;
    if (!raised) {
      const cudaError_t e = cudaFuncSetAttribute(
          decode_attention_split_kernel<T, HD, Slots>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return e;
      raised = true;
    }
  }
  decode_attention_split_kernel<T, HD, Slots><<<grid, NT, smem, s>>>(
      q, k, v, slot_pos, slots, pos, part, H, Hkv, W, nsplit, split_tiles,
      window, softcap, scale);
  return cudaGetLastError();
}

// Checks the shapes and the split plan, launches the split kernel and the
// merge kernel on the stream and returns cudaGetLastError().  The nsplit
// splits of split_tiles tiles of 32 slots must cover W exactly; q, k and
// v must start on a 16-byte boundary; hd is 64, 128 or 256.
template <typename Slots>
int launch_decode_split(const void* q, const void* k, const void* v,
                        const void* slot_pos, Slots slots, const void* pos,
                        void* part, void* out, int B, int H, int Hkv, int W,
                        int hd, int nsplit, int split_tiles, int window,
                        float softcap, float scale, int dtype, cudaStream_t s) {
  const int tiles = (W + TW - 1) / TW;
  if (B <= 0 || B > 65535 || H > 65535 || Hkv <= 0 || H % Hkv != 0 ||
      H / Hkv > MAX_REP || W <= 0 || nsplit <= 0 || nsplit > MAX_SPLITS ||
      split_tiles <= 0 || (nsplit - 1) * split_tiles >= tiles ||
      nsplit * split_tiles < tiles)
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  const dim3 grid(Hkv, B, nsplit);
  float* pt = (float*)part;
#define REPRO_SPLIT(HDV)                                                      \
  launch_split<T, HDV, Slots>(grid, s, (const T*)q, (const T*)k, (const T*)v, \
                              (const int*)slot_pos, slots, (const int*)pos,   \
                              pt, H, Hkv, W, nsplit, split_tiles, window,     \
                              softcap, scale)
  REPRO_DISPATCH_DTYPE(dtype, T, {
    cudaError_t e;
    if (hd == 64)
      e = REPRO_SPLIT(64);
    else if (hd == 128)
      e = REPRO_SPLIT(128);
    else if (hd == 256)
      e = REPRO_SPLIT(256);
    else
      return (int)cudaErrorInvalidValue;
    if (e != cudaSuccess) return (int)e;
    decode_attention_merge_kernel<T><<<dim3(H, B), hd, 0, s>>>(pt, (T*)out, H, Hkv, hd, nsplit);
  });
#undef REPRO_SPLIT
  return (int)cudaGetLastError();
}

}  // namespace
