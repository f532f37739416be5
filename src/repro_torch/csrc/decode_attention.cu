// One-token GQA decode attention over a dense KV cache, for Hopper (sm_90a).
//
// Replaces src/repro/kernels/decode_attention.py::decode_attention_pallas:
// q (B, H, D) against a (B, S, KV, D) cache, masked to k_pos < kv_len and,
// with a window, k_pos >= kv_len - window (the same masks as the paged
// kernel), with a tanh softcap, in an fp32 online softmax.
//
// What bounds it on the H100: bytes, as for the paged kernel: the live
// K/V rows of every sequence are read once, at 4 flops a byte in bf16.
//
// Design: the device code of the paged kernel (decode_tiles.cuh), with a
// row address of b * S + t in place of the block-table lookup.  The Pallas
// grid's innermost kv axis, which carried the softmax state in VMEM from
// one grid step to the next and visited every block of the cache (the
// masked ones predicated off), becomes split-K over the live tokens only:
// blocks over (kv head, sequence, split), each staging its split's rows
// through a cp.async ring, and a merge of the splits' states.  The split
// count comes from S (and the window).  Dead rows of a slot table ride
// the step like live ones: their cache rows hold finite values.

#include "decode_tiles.cuh"

extern "C" int decode_attention(
    const void* q, const void* k_cache, const void* v_cache, const void* kv_len,
    void* out, void* partial, int B, int S, int H, int KV, int D, float scale,
    int window, float softcap, int nsplit, int split_len, int q_dtype, int kv_dtype,
    void* stream) {
  Args a{q, k_cache, v_cache, nullptr, static_cast<const int32_t*>(kv_len),
         nullptr, nullptr, out, static_cast<float*>(partial), H, KV, D, /*page=*/S,
         /*nmax=*/1, /*num_pages=*/B, scale, window, softcap, nsplit, split_len};
  return decode_dispatch<true>(a, B, q_dtype, kv_dtype, static_cast<cudaStream_t>(stream));
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
