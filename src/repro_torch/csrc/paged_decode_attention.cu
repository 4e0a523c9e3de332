// Flash-decode GQA attention over a paged KV pool, read through a block
// table, for Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention.py
// (paged_decode_attention -> _paged_kernel).  The pool holds P pages of
// ps slots; row b's logical slot w lives in physical page
// block_table[b, w / ps] (-1 = unmapped) at offset w % ps.  The math is
// that of decode_attention.cu: the mask pos_pages >= 0 && pos_pages <=
// pos (and > pos - window when a window is set), scale hd**-0.5, an
// optional logit softcap, an online softmax in f32 with the same -1e30
// fill, masked p zeroed and the denominator clamped at 1e-30.
//
// Bound: bytes (see decode_split.cuh).  Design: the split kernel and the
// merge kernel of decode_split.cuh, shared with decode_attention.cu, with
// W = n_logical * ps logical slots split as decode_attention splits a
// ring of that width.  The mask lanes of each 32-slot tile read the
// block table on the device (a tile spans 32 / ps pages when ps < 32,
// part of one page when ps > 32), so no dense copy of the cache is made;
// an unmapped page's slots are masked and never loaded.  Over the same
// pool, this kernel and decode_attention over PagePool.gather's view
// compute the same values in the same order: their outputs are
// bit-identical.  A row with no valid slot at all comes out as zeros, as
// in the Pallas kernel; a decoding row always holds its own token.

#include "decode_split.cuh"

// q (B,H,hd), k/v pages (P,ps,Hkv,hd) of one dtype, 16-byte aligned;
// pos_pages (P,ps), block_table (B,n_logical), pos (B,) int32; part: f32
// scratch of B*Hkv*nsplit*(H/Hkv)*(hd+2); out (B,H,hd).  All contiguous;
// every table entry is -1 or a page below P.  The nsplit splits of
// split_tiles tiles of 32 slots must cover W = n_logical * ps exactly.
// Returns cudaGetLastError().
extern "C" int paged_decode_attention(const void* q, const void* k,
                                      const void* v, const void* pos_pages,
                                      const void* block_table, const void* pos,
                                      void* part, void* out, int B, int H,
                                      int Hkv, int ps, int n_logical, int hd,
                                      int nsplit, int split_tiles, int window,
                                      float softcap, float scale, int dtype,
                                      void* stream) {
  if (ps <= 0 || n_logical <= 0 || (long long)ps * n_logical > (1 << 30))
    return (int)cudaErrorInvalidValue;
  return launch_decode_split(q, k, v, pos_pages,
                             PagedSlots{(const int*)block_table, n_logical, ps},
                             pos, part, out, B, H, Hkv, n_logical * ps, hd, nsplit,
                             split_tiles, window, softcap, scale, dtype,
                             (cudaStream_t)stream);
}
