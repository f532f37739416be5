// One-token GQA decode attention over pooled KV pages, for Hopper (sm_90a).
//
// Replaces src/repro/kernels/paged_attention.py::paged_decode_attention_pallas.
//
// What bounds it (bytes), and the design: see decode_tiles.cuh.  The
// grid is (kv head, slot, split); each block stages whole pages of a
// slot's live tokens ([kv_len - window, kv_len)) through its block table,
// so no clamped or padded table entry is ever read, and a second kernel
// merges the splits.
//
// Dead slots ride the step with every table entry on trash page 0 and
// kv_len equal to the whole span: they read page 0 repeatedly, which is
// always allocated and holds finite values, so they neither fault nor
// produce NaN; their output is discarded by the caller.

#include "decode_tiles.cuh"

extern "C" int paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool, const void* block_tab,
    const void* kv_len, const void* k_scale, const void* v_scale, void* out,
    void* partial, int B, int H, int KV, int D, int page, int nmax, int num_pages,
    float scale, int window, float softcap, int nsplit, int split_len, int q_dtype,
    int kv_dtype, void* stream) {
  Args a{q, k_pool, v_pool, static_cast<const int32_t*>(block_tab),
         static_cast<const int32_t*>(kv_len), static_cast<const float*>(k_scale),
         static_cast<const float*>(v_scale), out, static_cast<float*>(partial), H, KV, D,
         page, nmax, num_pages, scale, window, softcap, nsplit, split_len};
  return decode_dispatch<false>(a, B, q_dtype, kv_dtype, static_cast<cudaStream_t>(stream));
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
