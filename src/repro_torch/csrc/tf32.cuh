// fp32-exact products on Hopper's tensor cores (sm_90a): the 3xTF32 split
// that CUTLASS calls OpMultiplyAddFastF32, on mma.sync m16n8k8, and the
// cp.async copies that stage its operands.  Inline PTX; each helper is
// named after the instruction it issues.
//
// A TF32 operand keeps 10 of fp32's 23 mantissa bits, so one TF32 product
// moves an attention score by about 1e-3.  Split each operand instead,
// a = hi + lo with hi = tf32(a) and lo = tf32(a - hi) (round to nearest,
// ties away), and take hi * hi' + hi * lo' + lo * hi' in fp32: the
// dropped lo * lo' and the rounding of lo leave about 2**-21 of |a * a'|
// a product.  Three mma.sync a product, each accumulating in fp32.
//
// Fragments of mma.sync.m16n8k8 .tf32 (PTX ISA), lane = 4 * g + t:
//   A (16 x 8): a0 = (g, t), a1 = (g + 8, t), a2 = (g, t + 4),
//               a3 = (g + 8, t + 4)
//   B (8 x 8):  b0 = (k t, n g), b1 = (k t + 4, n g)
//   C (16 x 8): c0, c1 = (g, 2t), (g, 2t + 1); c2, c3 = the same at g + 8
// The reduction index k of A and B may be permuted as long as both use
// one permutation: callers map k = t to column 2t and k = t + 4 to 2t + 1,
// so a lane's two A (or B) values of a row are adjacent (one 8-byte load),
// and the C fragment of S is, as it stands, the A fragment of P V.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32 {

// x = hi + lo, each in an fp32 register: hi is x rounded to TF32 (to
// nearest, ties away: half of the 13 dropped bits added to the magnitude,
// then cleared), lo = x - hi (exact) with its 13 low bits cleared, the
// truncation the tensor core would make of it.  Integer and fp32 ALU
// operations only: cvt.rna.tf32.f32 runs on the conversion pipe, at a
// fraction of the rate, and a split feeds every fragment.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

// c += a * b, m16n8k8, TF32 in, fp32 accumulation
__device__ __forceinline__ void mma(float* c, const uint32_t* a, const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The split product: the small terms into `small`, the big one into `big`
// (two accumulators: two chains of dependent mma, not one of three)
__device__ __forceinline__ void mma3(float* big, float* small, const uint32_t* ah,
                                     const uint32_t* al, const uint32_t* bh,
                                     const uint32_t* bl) {
  mma(small, al, bh);
  mma(small, ah, bl);
  mma(big, ah, bh);
}

// Fragment loads from fp32 tiles in shared memory, split on the way.  A
// tile is rows of `ld` floats, ld = width + 8 (pad below): a half-warp's
// 8-byte loads of rows g (0..3) at columns 2t (0..7) then fall on 32
// distinct banks, and the 4-byte loads down rows 2t and 2t + 1 at column g
// meet two lanes a bank.
__host__ __device__ constexpr int pad(int width) { return width + 8; }

// A (16 x 8) of k-step kk from a tile holding A's rows: `p` points at row
// g, column 2t of the 16 rows; columns 8kk + 2t, + 1 of rows g and g + 8.
__device__ __forceinline__ void load_a(const float* p, int ld, int kk, uint32_t* ah,
                                       uint32_t* al) {
  const float2 x = *reinterpret_cast<const float2*>(p + 8 * kk);
  const float2 y = *reinterpret_cast<const float2*>(p + 8 * ld + 8 * kk);
  split(x.x, ah[0], al[0]);
  split(y.x, ah[1], al[1]);
  split(x.y, ah[2], al[2]);
  split(y.y, ah[3], al[3]);
}

// B (8 x 8) of k-step kk from a tile holding B's columns as rows (B = T^T:
// K of S = Q K^T): `p` points at row g, column 2t of the 8 rows.
__device__ __forceinline__ void load_b_rows(const float* p, int kk, uint32_t* bh,
                                            uint32_t* bl) {
  const float2 x = *reinterpret_cast<const float2*>(p + 8 * kk);
  split(x.x, bh[0], bl[0]);
  split(x.y, bh[1], bl[1]);
}

// B (8 x 8) from a tile holding B's rows (V of O = P V): `p` points at row
// 2t, column g of the k-step and n-tile; rows 2t and 2t + 1.
__device__ __forceinline__ void load_b_cols(const float* p, int ld, uint32_t* bh,
                                            uint32_t* bl) {
  split(p[0], bh[0], bl[0]);
  split(p[ld], bh[1], bl[1]);
}

// A from the C fragment of a product whose columns are the next product's
// k index (S's keys for P V): under the k = t -> 2t, t + 4 -> 2t + 1
// order c0, c2, c1, c3 are a0..a3.
__device__ __forceinline__ void c_as_a(const float* c, uint32_t* ah, uint32_t* al) {
  split(c[0], ah[0], al[0]);
  split(c[2], ah[1], al[1]);
  split(c[1], ah[2], al[2]);
  split(c[3], ah[3], al[3]);
}

// 16 bytes global -> shared, asynchronously; `bytes` < 16 fills the rest
// with zeros (0: all zeros, src is not read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}

// 4 bytes global -> shared, asynchronously (cp.async.ca); `bytes` 0 writes
// a zero (src is not read)
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

}  // namespace tf32
