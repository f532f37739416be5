// Causal GQA flash attention (prefill), for Hopper (sm_90a).
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention_pallas:
// q (B, Sq, H, D) against k, v (B, Sk, KV, D), query row i of batch b at
// position q_offset[b] + i, keys masked to k_pos < kv_len[b], and (causal)
// k_pos <= q_pos and (window) k_pos > q_pos - window, scores tanh-capped
// before the mask, online softmax with fp32 state.  Unlike the Pallas
// kernel, q_offset may differ per batch row (the chunked prefill's
// offsets), and Sq, Sk need not divide the tiles: the ragged edges are
// zero-filled and masked here.
//
// What bounds it on the H100: operations.  One-shot llama3-8b prefill
// (B = 8, Sq = Sk = 1024, 32/8 heads x 128) does 4 * D flops per unmasked
// (query, key) pair and head, about 69 GFLOP against 168 MB of q, k, v and
// o, some 400 flops a byte: above the ~295 at which bf16 tensor cores,
// not memory, bind.
//
// Design.  The Pallas grid (batch, head, q block, kv block) carried the
// online softmax in VMEM scratch across its innermost, sequential kv axis,
// and predicated fully masked tiles off with pl.when.  Hopper blocks run
// in parallel and in no order, so here one block owns (batch, q head, q
// tile) and loops over the kv tiles itself, in order, with the softmax
// state (m, l, acc) in fp32 registers.  The loop visits only the tiles
// that the q tile's causal and window reach can touch, computed from that
// batch row's own q_offset (this replaces pl.when).  The kv head is
// h / (H / KV): K and V are never repeated.  Two variants:
//
// * bf16 (the serving path): 4 warps, 16 query rows each (a 64-row q
//   tile), over 64-key tiles of K and V staged in shared memory as 16-byte
//   vectors (2 x 64 x (D + 8) bf16, 34 KB at D = 128: static shared
//   memory, single-buffered).  Both products run on the tensor cores
//   through mma.sync.m16n8k16 (bf16 in, fp32 accumulation), issued as
//   inline PTX: Q's fragments stay in registers for the whole loop, S = QK^T
//   comes out in the accumulator layout that is also the A-operand layout
//   of P for PV, so P never leaves registers.  Two roundings differ from
//   the plain version, which computes in fp32: the score is scaled in fp32
//   after the product (q * scale would have to be rounded to bf16 to enter
//   it), and P is rounded to bf16 for PV (the row sums use the fp32 P).
//   The second bounds the difference per element by 2**-9 times the
//   softmax-weighted mean of |v|.  No wgmma, TMA or warp specialisation
//   yet: later work.
// * fp32 (the reduced models and the CPU-parity checks on the card): CUDA
//   cores, the JAX order exactly (q * scale in fp32, then the product,
//   then the softcap, then the -1e30 mask).  4 warps own 8 rows each of a
//   32-row q tile; the q tile (pre-scaled) and 32-key K and V tiles sit in
//   dynamic shared memory (K rows padded by one float against bank
//   conflicts).  Lane j scores key j of the tile; each lane accumulates
//   D/32 columns of the output.
//
// Masked scores are -1e30, as in the JAX tiers, so a row whose visited
// keys are all masked averages V over them (exp(-1e30 - -1e30) = 1) and
// stays finite; a row with no tile visited at all gives 0.  Neither
// arises on a generator path (every row sees key 0).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kNegInit = -1e30f;
enum DType { kF32 = 0, kBF16 = 1 };

struct Args {
  const void* q;           // (B, Sq, H, D)
  const void* k;           // (B, Sk, KV, D)
  const void* v;
  const int32_t* kv_len;   // (B,) or null: Sk
  const int32_t* q_off;    // (B,) or null: q_off0 for every row
  void* out;               // (B, Sq, H, D), q's dtype
  int Sq, Sk, H, KV, D;
  int q_off0;
  float scale;
  int causal;
  int window;              // <= 0: none
  float softcap;           // <= 0: none
};

__device__ __forceinline__ int valid_len(const Args& a, int b) {
  return a.kv_len != nullptr ? min(a.kv_len[b], a.Sk) : a.Sk;
}

__device__ __forceinline__ int row_offset(const Args& a, int b) {
  return a.q_off != nullptr ? a.q_off[b] : a.q_off0;
}

// First tile start and end of the keys that query positions
// [q_lo, q_hi] can reach: tiles outside are never visited.
__device__ __forceinline__ void key_span(const Args& a, int len, int q_lo, int q_hi,
                                         int tile, int* first, int* end) {
  int hi = len;
  if (a.causal) hi = min(hi, q_hi + 1);
  int lo = 0;
  if (a.window > 0) lo = max(0, q_lo - a.window + 1);
  *first = (lo / tile) * tile;
  *end = hi;
}

// softcap, then the mask: the JAX tiers' order
__device__ __forceinline__ float cap_and_mask(const Args& a, float s, int q_pos, int k_pos,
                                              int len) {
  if (a.softcap > 0.f) s = a.softcap * tanhf(s / a.softcap);
  bool ok = k_pos < len;
  if (a.causal) ok = ok && k_pos <= q_pos;
  if (a.window > 0) ok = ok && k_pos > q_pos - a.window;
  return ok ? s : kNegInit;
}

// ---------------------------------------------------------------- fp32
constexpr int kSimtWarps = 4;
constexpr int kSimtRows = 32;                       // q rows a block
constexpr int kSimtKeys = 32;                       // keys a tile: one a lane
constexpr int kSimtRowsPerWarp = kSimtRows / kSimtWarps;

size_t simt_smem(int D) {
  return sizeof(float) * (static_cast<size_t>(kSimtRows) * D
                          + static_cast<size_t>(kSimtKeys) * (D + 1)
                          + static_cast<size_t>(kSimtKeys) * D);
}

// EPL: output columns per lane (lane holds d = e * 32 + lane).
template <int EPL>
__global__ void __launch_bounds__(kSimtWarps * 32) flash_fp32_kernel(Args a) {
  extern __shared__ float smem[];
  const int D = a.D;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (a.H / a.KV);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* qs = smem;                                 // kSimtRows x D
  float* ks = qs + kSimtRows * D;                   // kSimtKeys x (D + 1)
  float* vs = ks + kSimtKeys * (D + 1);             // kSimtKeys x D
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  const int row0 = qt * kSimtRows;
  const int nrows = min(kSimtRows, a.Sq - row0);
  const int off = row_offset(a, b);
  const int len = valid_len(a, b);

  for (int i = threadIdx.x; i < kSimtRows * D; i += blockDim.x) {
    const int r = i / D, d = i % D;
    qs[i] = r < nrows
        ? q[((static_cast<size_t>(b) * a.Sq + row0 + r) * a.H + h) * D + d] * a.scale
        : 0.f;
  }
  float m[kSimtRowsPerWarp], l[kSimtRowsPerWarp], acc[kSimtRowsPerWarp][EPL];
#pragma unroll
  for (int r = 0; r < kSimtRowsPerWarp; ++r) {
    m[r] = kNegInit;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[r][e] = 0.f;
  }
  int first, end;
  key_span(a, len, off + row0, off + row0 + nrows - 1, kSimtKeys, &first, &end);
  for (int k0 = first; k0 < end; k0 += kSimtKeys) {
    __syncthreads();              // the last tile is consumed, q is staged
    for (int i = threadIdx.x; i < kSimtKeys * D; i += blockDim.x) {
      const int j = i / D, d = i % D, t = k0 + j;
      float kx = 0.f, vx = 0.f;
      if (t < a.Sk) {
        const size_t src = ((static_cast<size_t>(b) * a.Sk + t) * a.KV + kh) * D + d;
        kx = k[src];
        vx = v[src];
      }
      ks[j * (D + 1) + d] = kx;
      vs[j * D + d] = vx;
    }
    __syncthreads();
    const float* kr = ks + lane * (D + 1);
#pragma unroll
    for (int r = 0; r < kSimtRowsPerWarp; ++r) {
      const int row = warp * kSimtRowsPerWarp + r;
      if (row >= nrows) continue;                   // warp-uniform
      const float* qr = qs + row * D;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s += qr[d] * kr[d];
      s = cap_and_mask(a, s, off + row0 + row, k0 + lane, len);
      float mx = s;
#pragma unroll
      for (int o = 16; o >= 1; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
      const float mn = fmaxf(m[r], mx);
      const float c = expf(m[r] - mn);
      const float p = expf(s - mn);
      float ps = p;
#pragma unroll
      for (int o = 16; o >= 1; o >>= 1) ps += __shfl_xor_sync(kFull, ps, o);
      l[r] = l[r] * c + ps;
      m[r] = mn;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[r][e] *= c;
      for (int j = 0; j < kSimtKeys; ++j) {
        const float pj = __shfl_sync(kFull, p, j);
#pragma unroll
        for (int e = 0; e < EPL; ++e) {
          const int d = e * 32 + lane;
          if (d < D) acc[r][e] += pj * vs[j * D + d];
        }
      }
    }
  }
  float* out = static_cast<float*>(a.out);
#pragma unroll
  for (int r = 0; r < kSimtRowsPerWarp; ++r) {
    const int row = warp * kSimtRowsPerWarp + r;
    if (row >= nrows) continue;
    const size_t base = ((static_cast<size_t>(b) * a.Sq + row0 + row) * a.H + h) * D;
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      const int d = e * 32 + lane;
      if (d < D) out[base + d] = acc[r][e] / fmaxf(l[r], 1e-30f);
    }
  }
}

// ---------------------------------------------------------------- bf16
constexpr int kMmaWarps = 4;
constexpr int kMmaRows = 16 * kMmaWarps;            // q rows a block
constexpr int kMmaKeys = 64;                        // keys a tile

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two bf16 in one register, the lower column in the low half
__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(uint16_t lo, uint16_t hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

// Fragment layouts of mma.m16n8k16 (PTX ISA), lane = 4 * g + t:
//   A (16 x 16, row): reg 0 = (row g, cols 2t, 2t+1), reg 1 = (row g+8, same),
//                     reg 2 = (row g, cols 2t+8, 2t+9), reg 3 = (row g+8, same);
//   B (16 x 8, col):  reg 0 = (rows 2t, 2t+1, col g), reg 1 = (rows 2t+8, 2t+9, col g);
//   C (16 x 8, fp32): c0, c1 = (row g, cols 2t, 2t+1), c2, c3 = (row g+8, same).
template <int D>
__global__ void __launch_bounds__(kMmaWarps * 32) flash_bf16_kernel(Args a) {
  constexpr int KS = D / 16;            // k-steps of QK^T
  constexpr int NT = kMmaKeys / 8;      // key n-tiles of S
  constexpr int PS = kMmaKeys / 16;     // k-steps of PV
  constexpr int DN = D / 8;             // column n-tiles of O
  constexpr int LD = D + 8;             // shared row stride: 16 bytes of padding
  constexpr int VPR = D / 8;            // 16-byte vectors a row
  // bf16 bit patterns: the tiles are only moved and packed, never converted
  __shared__ __align__(16) uint16_t ks[kMmaKeys * LD];
  __shared__ __align__(16) uint16_t vs[kMmaKeys * LD];

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (a.H / a.KV);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = qt * kMmaRows;
  const int nrows = min(kMmaRows, a.Sq - row0);
  const int off = row_offset(a, b);
  const int len = valid_len(a, b);
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q);
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(a.k);
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(a.v);

  // this lane's two rows of the warp's 16
  const int r0 = row0 + warp * 16 + g, r1 = r0 + 8;
  const uint32_t* q0 = reinterpret_cast<const uint32_t*>(
      q + ((static_cast<size_t>(b) * a.Sq + r0) * a.H + h) * D);
  const uint32_t* q1 = reinterpret_cast<const uint32_t*>(
      q + ((static_cast<size_t>(b) * a.Sq + r1) * a.H + h) * D);
  uint32_t qa[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const int w = (kk * 16 + 2 * t) / 2;             // word of columns 2t, 2t+1
    qa[kk][0] = r0 < a.Sq ? q0[w] : 0u;
    qa[kk][1] = r1 < a.Sq ? q1[w] : 0u;
    qa[kk][2] = r0 < a.Sq ? q0[w + 4] : 0u;
    qa[kk][3] = r1 < a.Sq ? q1[w + 4] : 0u;
  }

  float acc[DN][4];
#pragma unroll
  for (int n = 0; n < DN; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = kNegInit, m1 = kNegInit;   // running maxima of rows r0, r1
  float l0 = 0.f, l1 = 0.f;             // this lane's share of their sums
  const int qp0 = off + r0, qp1 = off + r1;

  int first, end;
  key_span(a, len, off + row0, off + row0 + nrows - 1, kMmaKeys, &first, &end);
  for (int k0 = first; k0 < end; k0 += kMmaKeys) {
    __syncthreads();                    // every warp is done with the last tile
    for (int i = threadIdx.x; i < kMmaKeys * VPR; i += blockDim.x) {
      const int j = i / VPR, c = i % VPR, tk = k0 + j;
      uint4 kx = make_uint4(0u, 0u, 0u, 0u), vx = kx;
      if (tk < a.Sk) {
        const size_t src = ((static_cast<size_t>(b) * a.Sk + tk) * a.KV + kh) * D + c * 8;
        kx = *reinterpret_cast<const uint4*>(k + src);
        vx = *reinterpret_cast<const uint4*>(v + src);
      }
      *reinterpret_cast<uint4*>(&ks[j * LD + c * 8]) = kx;
      *reinterpret_cast<uint4*>(&vs[j * LD + c * 8]) = vx;
    }
    __syncthreads();

    // S = Q K^T on the tensor cores
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const uint16_t* kr = &ks[(n * 8 + g) * LD + kk * 16 + 2 * t];
        const uint32_t bf[2] = {*reinterpret_cast<const uint32_t*>(kr),
                                *reinterpret_cast<const uint32_t*>(kr + 8)};
        mma_bf16(s[n], qa[kk], bf);
      }
    }
    // scale, softcap, mask; the rows' maxima over the tile
    float mx0 = kNegInit, mx1 = kNegInit;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = k0 + n * 8 + 2 * t + (e & 1);
        const float x = cap_and_mask(a, s[n][e] * a.scale, e < 2 ? qp0 : qp1, kp, len);
        s[n][e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
      }
    }
    // the 4 lanes of a row group share its rows
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, o));
      mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, o));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float c0 = expf(m0 - mn0), c1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    // P, already in the A layout of PV: n-tiles 2j and 2j+1 are k-step j
    uint32_t pa[PS][4];
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float p0 = expf(s[n][0] - mn0), p1 = expf(s[n][1] - mn0);
      const float p2 = expf(s[n][2] - mn1), p3 = expf(s[n][3] - mn1);
      ps0 += p0 + p1;
      ps1 += p2 + p3;
      pa[n / 2][(n % 2) * 2 + 0] = pack_f32(p0, p1);
      pa[n / 2][(n % 2) * 2 + 1] = pack_f32(p2, p3);
    }
    l0 = l0 * c0 + ps0;
    l1 = l1 * c1 + ps1;
#pragma unroll
    for (int n = 0; n < DN; ++n) {
      acc[n][0] *= c0;
      acc[n][1] *= c0;
      acc[n][2] *= c1;
      acc[n][3] *= c1;
    }
    // O += P V on the tensor cores
#pragma unroll
    for (int j = 0; j < PS; ++j) {
      const int key = j * 16 + 2 * t;
#pragma unroll
      for (int n = 0; n < DN; ++n) {
        const int d = n * 8 + g;
        const uint32_t bf[2] = {
            pack_raw(vs[key * LD + d], vs[(key + 1) * LD + d]),
            pack_raw(vs[(key + 8) * LD + d], vs[(key + 9) * LD + d])};
        mma_bf16(acc[n], pa[j], bf);
      }
    }
  }

#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    l0 += __shfl_xor_sync(kFull, l0, o);
    l1 += __shfl_xor_sync(kFull, l1, o);
  }
  const float i0 = 1.f / fmaxf(l0, 1e-30f), i1 = 1.f / fmaxf(l1, 1e-30f);
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out);
  uint32_t* o0 = reinterpret_cast<uint32_t*>(
      out + ((static_cast<size_t>(b) * a.Sq + r0) * a.H + h) * D);
  uint32_t* o1 = reinterpret_cast<uint32_t*>(
      out + ((static_cast<size_t>(b) * a.Sq + r1) * a.H + h) * D);
#pragma unroll
  for (int n = 0; n < DN; ++n) {
    const int w = (n * 8 + 2 * t) / 2;
    if (r0 < a.Sq) o0[w] = pack_f32(acc[n][0] * i0, acc[n][1] * i0);
    if (r1 < a.Sq) o1[w] = pack_f32(acc[n][2] * i1, acc[n][3] * i1);
  }
}

template <typename K>
cudaError_t launch(K kern, dim3 grid, int threads, size_t smem, const Args& a,
                   cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kern<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Only the head dims a port config or a card test reaches are
// instantiated: D = 128 (llama3-8b) and D = 16 (the reduced configs), and
// D = 64 for bf16.  Others return cudaErrorInvalidValue.
extern "C" int flash_attention(
    const void* q, const void* k, const void* v, const void* kv_len, const void* q_off,
    void* out, int B, int Sq, int Sk, int H, int KV, int D, int q_off0, float scale,
    int causal, int window, float softcap, int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KV <= 0 || H % KV != 0) return cudaErrorInvalidValue;
  const Args a{q, k, v, static_cast<const int32_t*>(kv_len),
               static_cast<const int32_t*>(q_off), out, Sq, Sk, H, KV, D, q_off0,
               scale, causal, window, softcap};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) {
    const dim3 grid((Sq + kMmaRows - 1) / kMmaRows, H, B);
    switch (D) {
      case 16: return launch(flash_bf16_kernel<16>, grid, kMmaWarps * 32, 0, a, s);
      case 64: return launch(flash_bf16_kernel<64>, grid, kMmaWarps * 32, 0, a, s);
      case 128: return launch(flash_bf16_kernel<128>, grid, kMmaWarps * 32, 0, a, s);
      default: return cudaErrorInvalidValue;
    }
  }
  if (dtype == kF32) {
    const dim3 grid((Sq + kSimtRows - 1) / kSimtRows, H, B);
    const size_t smem = simt_smem(D);
    if (D <= 32) return launch(flash_fp32_kernel<1>, grid, kSimtWarps * 32, smem, a, s);
    if (D <= 128) return launch(flash_fp32_kernel<4>, grid, kSimtWarps * 32, smem, a, s);
    return cudaErrorInvalidValue;
  }
  return cudaErrorInvalidValue;
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
