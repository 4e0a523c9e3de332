// Flash-decode GQA attention over a ring-buffer KV cache, for Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention.py
// (decode_attention -> _kernel): one query token per request attends
// over its cache, with the mask cache_pos >= 0 && cache_pos <= pos (and
// cache_pos > pos - window when a window is set), scale hd**-0.5, an
// optional logit softcap, and an online softmax in f32 with the same
// -1e30 fill, masked p zeroed and the denominator clamped at 1e-30.
//
// The split kernel, the merge kernel, the bound and the design are in
// decode_split.cuh, shared with paged_decode_attention.cu; here row b's
// ring slot w is memory slot b * W + w.  The partial branch (a non-null
// lse) serves a rank that holds a block of the ring's slots: it returns
// the row over those slots with its log-sum-exp, for a cross-rank merge.

#include "decode_split.cuh"

// q (B,H,hd), k/v (B,W,Hkv,hd) of one dtype, 16-byte aligned; cache_pos
// (B,W), pos (B,) int32; part: f32 scratch of B*Hkv*nsplit*(H/Hkv)*(hd+2);
// out (B,H,hd) in q's dtype, or with a non-null lse (the partial branch)
// out f32 (B,H,hd) and lse f32 (B,H), each row's log-sum-exp over the
// slots given (-inf where none is valid).  All contiguous.  The nsplit
// splits of split_tiles tiles of 32 slots must cover W exactly.  Returns
// cudaGetLastError().
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* cache_pos, const void* pos, void* part,
                                void* out, void* lse, int B, int H, int Hkv, int W,
                                int hd, int nsplit, int split_tiles, int window,
                                float softcap, float scale, int dtype,
                                void* stream) {
  return launch_decode_split(q, k, v, cache_pos, RingSlots{W}, pos, part, out,
                             (float*)lse, B, H, Hkv, W, hd, nsplit, split_tiles,
                             window, softcap, scale, dtype, (cudaStream_t)stream);
}
