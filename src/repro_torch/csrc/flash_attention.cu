// Causal GQA flash attention (prefill), for Hopper (sm_90a).
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention_pallas:
// q (B, Sq, H, D) against k (B, Sk, KV, D) and v (B, Sk, KV, DV), the
// output (B, Sq, H, DV); DV = D but for MLA (deepseek-v2: q and k of 192
// columns, 128 nope and 64 rope, v of 128).  Query row i of batch b at
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
// not memory, bind.  Only wgmma reaches the tensor cores' full rate.  In
// fp32 the chunked prefill's chunk reads its K and V once for all its q
// tiles' products (gemma2's deep int8 chunk: 8.6 GFLOP against 50 MB),
// so operations bind there too, at 3xTF32's 165 TFLOP/s.
//
// Design.  The Pallas grid (batch, head, q block, kv block) carried the
// online softmax in VMEM scratch across its innermost, sequential kv axis,
// and predicated fully masked tiles off with pl.when.  Hopper blocks run
// in parallel and in no order, so here one block (fp32: of one split of
// the keys) or one work item of a persistent block (bf16) owns (q head,
// batch, q tile) and loops over the kv tiles itself, in order, with the
// softmax state (m, l, acc) in fp32 registers.  The loop visits only the tiles
// that the q tile's causal and window reach can touch, computed from that
// batch row's own q_offset (this replaces pl.when).  The kv head is
// h / (H / KV): K and V are never repeated.  Two variants:
//
// * bf16 (the serving path): a persistent, warp-specialised kernel.  One
//   block an SM walks a list of work items, (q tile, head, batch) in
//   descending causal cost, so the heaviest tiles start first and the
//   light ones fill the tail.  One producer warpgroup, of which one thread
//   issues TMA tensor loads (4-D maps over (B, Sq, H, D) and (B, Sk, KV,
//   D), made on the host; ragged rows arrive as zeros and never from the
//   next batch row): an item's q rows, then its 128-key K and V tiles
//   into a ring of 3 stages (64-key tiles and 2 stages at D = 256, see
//   Geo) that runs on from one item to the next,
//   completion counted in bytes on mbarriers; a K slot is released as soon
//   as S is computed, a V slot once PV is.  One or two consumer warpgroups
//   of 64 q rows each (setmaxnreg moves the producer's registers to them)
//   run S = QK^T as wgmma m64n128k16 (m64n64k16 at D = 256) with Q and K
//   from shared memory (128-byte swizzle, 32-byte at D = 16, as the TMA
//   boxes write it) and O += PV as wgmma m64nDk16 (two m64n128k16 at D =
//   256) with P from registers (the S accumulator,
//   packed to bf16, is already the A operand's layout) and V from shared
//   memory as the transposed B operand.  The two products are software-
//   pipelined: S of tile j and PV of tile j - 1 are in flight together,
//   and the softmax of tile j runs under PV; two consumers take turns to
//   issue their products (named barriers), so one's softmax also runs
//   under the other's products.  Two roundings differ from
//   the plain version, which computes in fp32: the score is scaled in fp32
//   after the product (q * scale would have to be rounded to bf16 to enter
//   it), and P is rounded to bf16 for PV (the row sums use the fp32 P).
//   The second bounds the difference per element by 2**-9 times the
//   softmax-weighted mean of |v|.  Items of 128 rows (two consumers
//   sharing each K/V tile) when there are two for every SM, else of 64
//   rows (a 256-row prefill chunk of 32 heads: 128 items, not 64).
// * fp32 (the int8 pages' chunked prefill, which attends over the fp32
//   dequantized gather; the fp32 models and their training forward):
//   fp32-exact products on the tensor cores, in the JAX order (q * scale
//   in fp32, then the product, then the softcap, then the -1e30 mask).
//   TF32 alone keeps 10 mantissa bits and moves a score by about 1e-3, so
//   each operand is split into two TF32 halves and each product is three
//   (3xTF32, tf32.cuh): fp32 to about 2**-21 a product, at a third of the
//   TF32 peak (494.7 / 3 TFLOP/s, against 67 on the CUDA cores).  The
//   instruction is mma.sync m16n8k8, not wgmma: its fragments load from
//   shared memory lane by lane, so V needs no transpose (wgmma takes TF32
//   operands only K-major, which would stage V with the keys contiguous,
//   a transpose TMA cannot make), and the S accumulator is, under a
//   permutation of the reduction index, P's A fragment (P stays in
//   registers, as in the bf16 kernel).  A block is 4 warps, 64 q rows of
//   one head (16 a warp) held pre-scaled in shared memory, over 32-key K
//   and V tiles staged by 16-byte cp.async copies into a ring of 2 stages
//   (the next tile's copies run under this one's products); rows padded
//   (D + 8, DV + 4 floats) so the fragment loads meet no bank conflict.
//   Operands are split where they are loaded.  A serving chunk is short
//   (256 rows: 32-128 work items of 64 rows for 132 SMs) and its rows see
//   up to 4096 keys, so each q tile's key reach is cut into splits of
//   whole tiles (the wrapper picks their count from shapes, to fill the
//   blocks the card holds at once; the last split runs to the reach's
//   end), each split's block writes its
//   unnormalised (m, l, acc) to fp32 scratch, and a second kernel merges
//   the splits in split order, as the decode kernels do (decode_tiles.cuh):
//   no atomics, so two calls give the same bits.  Grid: one block a (q
//   tile, head, batch, split), the q tiles heaviest first.
//
// MLA's head dims (D = 192, DV = 128): S = QK^T reduces over 192 columns
// (12 k16 steps, three 64-column TMA boxes), O and PV are the DV = 128
// case's, so the S and O accumulators are as large as at D = 128.  A
// 128-key stage is 48 KB of K and 32 KB of V beside 48 KB of two
// warpgroups' q rows: two stages fit the 227 KB a block has (three would
// need 288 KB).
//
// Masked scores are -1e30, as in the JAX tiers, so a row whose visited
// keys are all masked averages V over them (exp(-1e30 - -1e30) = 1) and
// stays finite; a row with no tile visited at all gives 0.  Neither
// arises on a generator path (every row sees key 0).
//
// Training asks for each row's log-sum-exp too (`lse`, (B, H, Sq) fp32,
// natural log: m + log(l) of the fp32 softmax state, which the bf16
// kernel keeps in log2 units), which the backward pass
// (flash_attention_bwd.cu) recomputes the probabilities from.  A null
// `lse` writes nothing: the serving paths launch what they did before.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <limits.h>
#include <type_traits>

#include "tf32.cuh"
#include "wgmma.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kNegInit = -1e30f;
enum DType { kF32 = 0, kBF16 = 1 };

struct Args {
  const void* q;           // (B, Sq, H, D)
  const void* k;           // (B, Sk, KV, D)
  const void* v;           // (B, Sk, KV, DV)
  const int32_t* kv_len;   // (B,) or null: Sk
  const int32_t* q_off;    // (B,) or null: q_off0 for every row
  void* out;               // (B, Sq, H, DV), q's dtype
  float* lse;              // (B, H, Sq) log-sum-exp of each row's scores,
                           // natural log; null: not written (serving)
  int Sq, Sk, H, KV, D, DV;
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
// 3xTF32 on mma.sync (tf32.cuh).  A block: 4 warps, 64 q rows of one head
// (16 a warp), over the kv tiles of one split of their key reach.
constexpr int kF32Warps = 4;
constexpr int kF32Threads = 32 * kF32Warps;
constexpr int kF32Rows = 16 * kF32Warps;            // q rows a block
constexpr int kF32Keys = 32;                        // keys a kv tile
constexpr int kF32Stages = 2;                       // cp.async ring
constexpr int kF32CombineThreads = 64;

// Row strides in floats: D + 8 keeps a half-warp's 8-byte loads of Q and
// K rows g (0..3) and columns 2t (0..7) on 32 banks; DV + 4 puts V rows 2t
// and 2t + 1 of the 8 lanes g on distinct banks.
__host__ __device__ __forceinline__ int f32_qk_stride(int D) { return D + 8; }
__host__ __device__ __forceinline__ int f32_v_stride(int DV) { return DV + 4; }

size_t f32_smem(int D, int DV) {
  return sizeof(float) * (static_cast<size_t>(kF32Rows) * f32_qk_stride(D)
                          + static_cast<size_t>(kF32Stages) * kF32Keys
                                * (f32_qk_stride(D) + f32_v_stride(DV)));
}

// The split scratch: acc (B * H * nsplit * Sq, DV), then (m, l) of each row
struct Split {
  int nqt, B, nsplit, split_len;
  float* part;
};

// NT: output n-tiles of 8 columns a warp holds (DV <= 8 * NT).  DQK: the
// q/k head dim fixed at compile time (then DV = 8 * NT), so the S loop
// unrolls whole and every shared address is a constant offset; 0 takes
// D and DV from the arguments (any pair the contract allows).
template <int NT, int DQK>
__global__ void __launch_bounds__(kF32Threads) flash_tf32_kernel(Args a, Split sp_) {
  extern __shared__ float4 f32_smem_raw[];
  float* smem = reinterpret_cast<float*>(f32_smem_raw);
  constexpr bool kFixed = DQK > 0;
  const int D = kFixed ? DQK : a.D, DV = kFixed ? 8 * NT : a.DV;
  const int qs = f32_qk_stride(D), vst = f32_v_stride(DV);
  float* sq = smem;                                  // kF32Rows x qs
  float* sk = sq + kF32Rows * qs;                    // stages x keys x qs
  float* sv = sk + kF32Stages * kF32Keys * qs;       // stages x keys x vst
  // work item: q tiles heaviest first, then head, batch, split
  int i = blockIdx.x;
  const int per = a.H * sp_.B * sp_.nsplit;
  const int qt = sp_.nqt - 1 - i / per;
  i %= per;
  const int sp = i % sp_.nsplit;
  i /= sp_.nsplit;
  const int h = i % a.H, b = i / a.H;
  const int kh = h / (a.H / a.KV);
  const int row0 = qt * kF32Rows;
  const int nrows = min(kF32Rows, a.Sq - row0);
  const int off = row_offset(a, b);
  const int len = valid_len(a, b);
  int first, end;
  key_span(a, len, off + row0, off + row0 + nrows - 1, kF32Keys, &first, &end);
  // the last split runs to the end of the reach, whatever split_len
  // covers: no key of the reach is left out
  const int lo = first + sp * sp_.split_len;
  const int hi = sp == sp_.nsplit - 1 ? end : min(end, lo + sp_.split_len);
  const int ntiles = hi > lo ? (hi - lo + kF32Keys - 1) / kF32Keys : 0;
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  // kv tile `it` into ring slot it % stages; keys past Sk arrive as zeros
  auto issue = [&](int it) {
    const int slot = it % kF32Stages, k0 = lo + it * kF32Keys;
    const uint32_t dk = hopper::smem_u32(sk + slot * kF32Keys * qs);
    const uint32_t dv = hopper::smem_u32(sv + slot * kF32Keys * vst);
    const int kc = D / 4, vc = DV / 4;
    for (int c = tid; c < kF32Keys * kc; c += kF32Threads) {
      const int j = c / kc, x = c % kc, key = k0 + j;
      const size_t row = (static_cast<size_t>(b) * a.Sk + min(key, a.Sk - 1)) * a.KV + kh;
      tf32::cp_async16(dk + 4u * (j * qs + 4 * x), k + row * D + 4 * x, key < a.Sk ? 16 : 0);
    }
    for (int c = tid; c < kF32Keys * vc; c += kF32Threads) {
      const int j = c / vc, x = c % vc, key = k0 + j;
      const size_t row = (static_cast<size_t>(b) * a.Sk + min(key, a.Sk - 1)) * a.KV + kh;
      tf32::cp_async16(dv + 4u * (j * vst + 4 * x), v + row * DV + 4 * x, key < a.Sk ? 16 : 0);
    }
  };
  if (ntiles > 0) issue(0);
  tf32::cp_async_commit();
  // q * scale in fp32, as the JAX tiers scale it; rows past Sq are zeros
  for (int c = tid; c < kF32Rows * (D / 4); c += kF32Threads) {
    const int r = c / (D / 4), x = c % (D / 4);
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < nrows) {
      val = reinterpret_cast<const float4*>(
          q + ((static_cast<size_t>(b) * a.Sq + row0 + r) * a.H + h) * D)[x];
      val.x *= a.scale;
      val.y *= a.scale;
      val.z *= a.scale;
      val.w *= a.scale;
    }
    *reinterpret_cast<float4*>(sq + r * qs + 4 * x) = val;
  }

  float o[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  // rows g and g + 8 of this warp: running maxima, this lane's share of
  // the sums
  float m0 = kNegInit, m1 = kNegInit, l0 = 0.f, l1 = 0.f;
  const int qp0 = off + row0 + warp * 16 + g, qp1 = qp0 + 8;
  const float* qw = sq + (warp * 16 + g) * qs + 2 * t;
  // a warp whose 16 rows all lie past Sq only stages and waits (a short
  // chunk or a 16-row prompt fills one warp of the four)
  const bool live = warp * 16 < nrows;

  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) issue(it + 1);
    tf32::cp_async_commit();
    tf32::cp_async_wait<1>();                        // tile it has landed
    __syncthreads();                                 // (and q is staged)
    if (live) {
      const int slot = it % kF32Stages, k0 = lo + it * kF32Keys;
      const float* kw = sk + slot * kF32Keys * qs + g * qs + 2 * t;
      const float* vw = sv + slot * kF32Keys * vst + 2 * t * vst + g;

      // S = (q * scale) K^T over the tile's 32 keys: 4 n-tiles of 8
      float s[4][4], sl[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = sl[n][e] = 0.f;
      auto qk_step = [&](int kk) {
        const float2 qa = *reinterpret_cast<const float2*>(qw + kk * 8);
        const float2 qb = *reinterpret_cast<const float2*>(qw + 8 * qs + kk * 8);
        uint32_t ah[4], al[4];
        tf32::split(qa.x, ah[0], al[0]);
        tf32::split(qb.x, ah[1], al[1]);
        tf32::split(qa.y, ah[2], al[2]);
        tf32::split(qb.y, ah[3], al[3]);
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const float2 kb = *reinterpret_cast<const float2*>(kw + n * 8 * qs + kk * 8);
          uint32_t bh[2], bl[2];
          tf32::split(kb.x, bh[0], bl[0]);
          tf32::split(kb.y, bh[1], bl[1]);
          tf32::mma3(s[n], sl[n], ah, al, bh, bl);
        }
      };
      if constexpr (kFixed) {
#pragma unroll
        for (int kk = 0; kk < DQK / 8; ++kk) qk_step(kk);
      } else {
#pragma unroll 2
        for (int kk = 0; kk < D / 8; ++kk) qk_step(kk);
      }

      // softcap, mask, online softmax: lane holds keys 8n + 2t (+1) of rows
      // g (e = 0, 1) and g + 8 (e = 2, 3)
      float mx0 = kNegInit, mx1 = kNegInit;
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = k0 + 8 * n + 2 * t + (e & 1);
          const float x = cap_and_mask(a, s[n][e] + sl[n][e], e < 2 ? qp0 : qp1, kp, len);
          s[n][e] = x;
          if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
        }
#pragma unroll
      for (int sh = 1; sh <= 2; sh <<= 1) {           // the 4 lanes of a row
        mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, sh));
        mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, sh));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float c0 = __expf(m0 - mn0), c1 = __expf(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        s[n][0] = __expf(s[n][0] - mn0);
        s[n][1] = __expf(s[n][1] - mn0);
        s[n][2] = __expf(s[n][2] - mn1);
        s[n][3] = __expf(s[n][3] - mn1);
        ps0 += s[n][0] + s[n][1];
        ps1 += s[n][2] + s[n][3];
      }
      l0 = l0 * c0 + ps0;
      l1 = l1 * c1 + ps1;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        o[j][0] *= c0;
        o[j][1] *= c0;
        o[j][2] *= c1;
        o[j][3] *= c1;
      }

      // O += P V: k-step kk is S's n-tile kk, whose C fragment is the A
      // fragment under the k = t -> key 2t, k = t + 4 -> key 2t + 1 order;
      // so B takes V rows 2t and 2t + 1 of the k-step, column g of n-tile j
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t ah[4], al[4];
        tf32::split(s[kk][0], ah[0], al[0]);
        tf32::split(s[kk][2], ah[1], al[1]);
        tf32::split(s[kk][1], ah[2], al[2]);
        tf32::split(s[kk][3], ah[3], al[3]);
        const float* vk = vw + kk * 8 * vst;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          if (j * 8 < DV) {
            uint32_t bh[2], bl[2];
            tf32::split(vk[j * 8], bh[0], bl[0]);
            tf32::split(vk[vst + j * 8], bh[1], bl[1]);
            tf32::mma3(o[j], o[j], ah, al, bh, bl);
          }
        }
      }
    }
    __syncthreads();                                 // slot free for tile it + 2
  }
  tf32::cp_async_wait<0>();

#pragma unroll
  for (int sh = 1; sh <= 2; sh <<= 1) {
    l0 += __shfl_xor_sync(kFull, l0, sh);
    l1 += __shfl_xor_sync(kFull, l1, sh);
  }
  const int r0 = row0 + warp * 16 + g, r1 = r0 + 8;
  if (sp_.nsplit == 1) {
    const float i0 = 1.f / fmaxf(l0, 1e-30f), i1 = 1.f / fmaxf(l1, 1e-30f);
    float* out = static_cast<float*>(a.out);
    float* o0 = out + ((static_cast<size_t>(b) * a.Sq + r0) * a.H + h) * DV + 2 * t;
    float* o1 = out + ((static_cast<size_t>(b) * a.Sq + r1) * a.H + h) * DV + 2 * t;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j * 8 >= DV) continue;
      if (r0 < a.Sq)
        *reinterpret_cast<float2*>(o0 + 8 * j) = make_float2(o[j][0] * i0, o[j][1] * i0);
      if (r1 < a.Sq)
        *reinterpret_cast<float2*>(o1 + 8 * j) = make_float2(o[j][2] * i1, o[j][3] * i1);
    }
    if (a.lse != nullptr && t == 0) {
      float* lse = a.lse + (static_cast<size_t>(b) * a.H + h) * a.Sq;
      if (r0 < a.Sq) lse[r0] = m0 + logf(fmaxf(l0, 1e-30f));
      if (r1 < a.Sq) lse[r1] = m1 + logf(fmaxf(l1, 1e-30f));
    }
    return;
  }
  // the split's unnormalised state; an empty split writes (-1e30, 0, 0)
  const size_t base = (static_cast<size_t>(b) * a.H + h) * sp_.nsplit + sp;
  const size_t nrow_all = static_cast<size_t>(sp_.B) * a.H * sp_.nsplit * a.Sq;
  float* acc = sp_.part;
  float* ml = sp_.part + nrow_all * DV;
  const size_t p0 = base * a.Sq + r0, p1 = base * a.Sq + r1;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j * 8 >= DV) continue;
    if (r0 < a.Sq)
      *reinterpret_cast<float2*>(acc + p0 * DV + 8 * j + 2 * t) = make_float2(o[j][0], o[j][1]);
    if (r1 < a.Sq)
      *reinterpret_cast<float2*>(acc + p1 * DV + 8 * j + 2 * t) = make_float2(o[j][2], o[j][3]);
  }
  if (t == 0) {
    if (r0 < a.Sq) *reinterpret_cast<float2*>(ml + 2 * p0) = make_float2(m0, l0);
    if (r1 < a.Sq) *reinterpret_cast<float2*>(ml + 2 * p1) = make_float2(m1, l1);
  }
}

// The splits of row (b, blockIdx.x, h) merged by log-sum-exp in split
// order (no atomics: two calls give the same bits); then the output and
// the row's log-sum-exp.
__global__ void __launch_bounds__(kF32CombineThreads) flash_tf32_combine_kernel(Args a, Split sp_) {
  const int r = blockIdx.x, h = blockIdx.y, b = blockIdx.z, ns = sp_.nsplit;
  const size_t nrow_all = static_cast<size_t>(sp_.B) * a.H * ns * a.Sq;
  const float* acc = sp_.part;
  const float* ml = sp_.part + nrow_all * a.DV;
  const size_t base = (static_cast<size_t>(b) * a.H + h) * ns * a.Sq + r;
  float mx = kNegInit;
  for (int s = 0; s < ns; ++s) mx = fmaxf(mx, ml[2 * (base + s * a.Sq)]);
  float l = 0.f;
  for (int s = 0; s < ns; ++s) {
    const float2 st = *reinterpret_cast<const float2*>(ml + 2 * (base + s * a.Sq));
    l += st.y * expf(st.x - mx);
  }
  const float inv = 1.f / fmaxf(l, 1e-30f);
  float* out = static_cast<float*>(a.out) + ((static_cast<size_t>(b) * a.Sq + r) * a.H + h) * a.DV;
  for (int c = threadIdx.x; c < a.DV; c += blockDim.x) {
    float o = 0.f;
    for (int s = 0; s < ns; ++s)
      o += acc[(base + s * a.Sq) * a.DV + c] * expf(ml[2 * (base + s * a.Sq)] - mx);
    out[c] = o * inv;
  }
  if (a.lse != nullptr && threadIdx.x == 0)
    a.lse[(static_cast<size_t>(b) * a.H + h) * a.Sq + r] = mx + logf(fmaxf(l, 1e-30f));
}

// ---------------------------------------------------------------- bf16
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Q, K and V tiles are hopper::Geo's layout (wgmma.cuh).  A kv tile holds
// KEYS keys (N of S = QK^T, K of O += PV); Tiles below picks KEYS and the
// ring's stages.
using hopper::Geo;
using hopper::kWgRows;
using hopper::fast_exp2;
using hopper::pack_f32;
using hopper::make_map;
using hopper::sm_count;

// dynamic shared bytes a block: alignment slack, q rows, the ring, barriers
constexpr size_t ring_smem(int nwg, int stages, int q_bytes, int k_bytes, int v_bytes) {
  return 1024 + static_cast<size_t>(nwg) * q_bytes
         + static_cast<size_t>(stages) * (k_bytes + v_bytes) + 8 * (2 + 4 * stages);
}

// The tiles of a (DQK, DV) pair: Q and K tiles DQK wide, V tiles DV wide.
// 128 keys a kv tile, and the ring as many stages (3 at most) as fit the
// 227 KB of shared memory a block has beside two warpgroups' q rows: 3 up
// to D = 128; 2 at (192, 128).  At D = 256 a 128-key K or V tile is 64 KB
// and even two stages of both would leave no room for the q rows, so 64
// keys and 2 stages (128 KB, beside 32 KB of q rows a consumer warpgroup).
template <int DQK, int DV>
struct Tiles {
  static_assert(DV <= DQK, "value head dim");
  static constexpr int kKeys = DQK + DV > 320 ? 64 : 128;
  using QK = Geo<DQK, kKeys>;
  using V = Geo<DV, kKeys>;
  static constexpr int kQBytes = kWgRows * DQK * 2;    // a warpgroup's q rows
  static constexpr int kKBytes = QK::kTileBytes;        // one K tile
  static constexpr int kVBytes = V::kTileBytes;         // one V tile
  static constexpr int kStages =
      ring_smem(2, 3, kQBytes, kKBytes, kVBytes) <= 227 * 1024 ? 3 : 2;
  static constexpr size_t smem(int nwg) {
    return ring_smem(nwg, kStages, kQBytes, kKBytes, kVBytes);
  }
};

// One block an SM: the launch takes every register (168 a thread with two
// consumer warpgroups, 255 with one), and setmaxnreg moves the producer
// warpgroup's share to the consumers.  The ring fills what shared memory
// the q rows leave (3 x 64 KB beside 32 KB at D = 128; Tiles::kStages).
// At D = 256 the 64 x 256 fp32 O accumulator is 128 registers a thread of
// the 240.
template <int NWG>
struct Pipe {
  static constexpr int kThreads = (NWG + 1) * 128;           // + a producer warpgroup
  static constexpr int kConsumerRegs = NWG == 2 ? 240 : 256;
  static constexpr int kProducerRegs = 24;
};

template <int DQK, int DV, int NWG>
constexpr size_t wgmma_smem() {
  static_assert(Tiles<DQK, DV>::smem(NWG) <= 227 * 1024, "shared memory");
  return Tiles<DQK, DV>::smem(NWG);
}

// S = Q K^T's k-step kk, n = KEYS
template <int KEYS>
__device__ __forceinline__ void qk_mma(float* sc, uint64_t dq, uint64_t dk, int acc) {
  if constexpr (KEYS == 64) hopper::wgmma_ss_n64(sc, dq, dk, acc);
  else hopper::wgmma_ss_n128(sc, dq, dk, acc);
}

// The work of one q tile: which (q head, batch, rows) and which kv tiles.
struct Item {
  int h, b, kh, row0, off, len, first, ntiles;
};

// Work items in descending cost: item i is q tile (nqt - 1 - i / (H * B))
// of head i % H, batch (i / H) % B, so under the causal mask the heaviest
// tiles start first and the light ones fill the tail.
template <int KEYS, int NWG>
__device__ __forceinline__ Item make_item(const Args& a, int i, int nqt, int B) {
  constexpr int kKeys = KEYS;
  Item w;
  const int per = a.H * B;
  const int qt = nqt - 1 - i / per;
  w.h = i % a.H;
  w.b = (i / a.H) % B;
  w.kh = w.h / (a.H / a.KV);
  w.row0 = qt * NWG * kWgRows;
  const int nrows = min(NWG * kWgRows, a.Sq - w.row0);
  w.off = row_offset(a, w.b);
  w.len = valid_len(a, w.b);
  int end;
  key_span(a, w.len, w.off + w.row0, w.off + w.row0 + nrows - 1, kKeys, &w.first, &end);
  w.ntiles = end > w.first ? (end - w.first + kKeys - 1) / kKeys : 0;
  return w;
}

// A persistent kernel: one block an SM walks the work items i = blockIdx.x,
// + gridDim.x, ...  NWG consumer warpgroups of 64 q rows each, and one
// producer warpgroup of which one thread issues every TMA load; the K/V
// ring and its barriers run on across items, so the next item's q rows and
// first tiles load while this one finishes.  Register layouts (PTX ISA,
// wgmma m64nNk16), warp w of a warpgroup, lane = 4 * g + t:
//   accumulator: d[4j + 0, 1] = (row 16w + g, cols 8j + 2t, +1),
//                d[4j + 2, 3] = (row 16w + g + 8, same cols);
//   A from registers (16 x 16 a warp): reg 0 = (row g, k 2t, +1),
//                reg 1 = (row g + 8, same), reg 2 = (row g, k 2t + 8, +9),
//                reg 3 = (row g + 8, same).
// So the S accumulator of key chunks 2kk and 2kk + 1 is, once packed to
// bf16, the A operand of PV's k-step kk: P never leaves registers.
template <int DQK, int DV, int NWG>
__global__ void __launch_bounds__(Pipe<NWG>::kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap, Args a, int B, int nqt) {
  using T = Tiles<DQK, DV>;
  using Gq = typename T::QK;              // Q and K tiles
  using Gv = typename T::V;               // V tiles
  constexpr int ST = T::kStages;
  constexpr int kKeys = T::kKeys;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = (hopper::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sk = sq + NWG * T::kQBytes;
  const uint32_t sv = sk + ST * T::kKBytes;
  const uint32_t bars = sv + ST * T::kVBytes;
  // barriers: q full, q empty, then per stage K full, V full, K empty, V
  // empty (K and V slots are released apart: a K slot once S is computed)
  const uint32_t q_full = bars, q_empty = bars + 8u;
  auto k_full = [&](int s) { return bars + 8u * (2 + s); };
  auto v_full = [&](int s) { return bars + 8u * (2 + ST + s); };
  auto k_empty = [&](int s) { return bars + 8u * (2 + 2 * ST + s); };
  auto v_empty = [&](int s) { return bars + 8u * (2 + 3 * ST + s); };
  const int n_items = nqt * a.H * B;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    hopper::mbar_init(q_empty, NWG * 128);
    for (int s = 0; s < ST; ++s) {
      hopper::mbar_init(k_full(s), 1);
      hopper::mbar_init(v_full(s), 1);
      hopper::mbar_init(k_empty(s), NWG * 128);
      hopper::mbar_init(v_empty(s), NWG * 128);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == NWG) {
    // ---- producer: per item the q rows, then K and V tiles through the ring
    hopper::regs_dealloc<Pipe<NWG>::kProducerRegs>();
    if (threadIdx.x == NWG * 128) {
      hopper::prefetch_map(&qmap);
      hopper::prefetch_map(&kmap);
      hopper::prefetch_map(&vmap);
      int gt = 0;                                   // kv tiles so far, all items
      int n = 0;                                    // items so far
      for (int i = blockIdx.x; i < n_items; i += gridDim.x, ++n) {
        const Item w = make_item<kKeys, NWG>(a, i, nqt, B);
        if (n > 0) hopper::mbar_wait(q_empty, (n - 1) & 1);
        hopper::mbar_expect_tx(q_full, NWG * T::kQBytes);
        for (int r = 0; r < NWG; ++r)
          for (int c = 0; c < Gq::kChunks; ++c)
            hopper::tma_load_4d(sq + r * T::kQBytes + c * kWgRows * Gq::kSw, &qmap, q_full,
                                c * Gq::kChunk, w.h, w.row0 + r * kWgRows, w.b);
        for (int it = 0; it < w.ntiles; ++it, ++gt) {
          const int s = gt % ST, round = gt / ST;
          const int k0 = w.first + it * kKeys;
          if (round > 0) hopper::mbar_wait(k_empty(s), (round - 1) & 1);
          hopper::mbar_expect_tx(k_full(s), T::kKBytes);
          for (int c = 0; c < Gq::kChunks; ++c)
            hopper::tma_load_4d(sk + s * T::kKBytes + c * kKeys * Gq::kSw, &kmap,
                                k_full(s), c * Gq::kChunk, w.kh, k0, w.b);
          if (round > 0) hopper::mbar_wait(v_empty(s), (round - 1) & 1);
          hopper::mbar_expect_tx(v_full(s), T::kVBytes);
          for (int c = 0; c < Gv::kChunks; ++c)
            hopper::tma_load_4d(sv + s * T::kVBytes + c * kKeys * Gv::kSw, &vmap,
                                v_full(s), c * Gv::kChunk, w.kh, k0, w.b);
        }
      }
    }
  } else {
    // ---- consumers: S = QK^T and O += PV on wgmma, the softmax between.
    // Software-pipelined: the product S of tile it and the product PV of
    // tile it - 1 are in flight together, and the softmax of tile it runs
    // while PV is.
    hopper::regs_alloc<Pipe<NWG>::kConsumerRegs>();
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const uint32_t q_tile = sq + wg * T::kQBytes;
    const float scale2 = a.scale * kLog2e;
    float o[DV / 2];
    float sc[kKeys / 2];
    uint32_t pa[kKeys / 16][4];          // P in bf16, the A operand of PV
#pragma unroll
    for (int i = 0; i < kKeys / 2; ++i) sc[i] = 0.f;

    // With two consumers, they take turns to issue their products (named
    // barriers 1 and 2, one a consumer): one warpgroup's softmax runs
    // while the other's products hold the tensor cores.  Both walk the
    // same items and tiles, so their turns pair up; the second consumer
    // hands the first its first turn.
    auto my_turn = [&]() {
      if constexpr (NWG == 2) hopper::named_sync(1 + wg, 256);
    };
    auto your_turn = [&]() {
      if constexpr (NWG == 2) hopper::named_arrive(2 - wg, 256);
    };
    if (NWG == 2 && wg == 1) hopper::named_arrive(1, 256);

    int gt = 0;
    int n = 0;
    for (int i = blockIdx.x; i < n_items; i += gridDim.x, ++n) {
      const Item w = make_item<kKeys, NWG>(a, i, nqt, B);
      const int r0 = w.row0 + wg * kWgRows + warp * 16 + g, r1 = r0 + 8;
      const int qp0 = w.off + r0, qp1 = w.off + r1;
      const int wq_lo = w.off + w.row0 + wg * kWgRows, wq_hi = wq_lo + kWgRows - 1;
#pragma unroll
      for (int j = 0; j < DV / 2; ++j) o[j] = 0.f;
      // running maxima of rows r0, r1 (log2 units) and this lane's share
      // of their sums
      float m0 = kNegInit, m1 = kNegInit, l0 = 0.f, l1 = 0.f;

      // S = Q K^T of tile it (the first k-step overwrites the accumulator)
      auto issue_qk = [&](int it) {
        const int s = (gt + it) % ST;
        hopper::mbar_wait(k_full(s), ((gt + it) / ST) & 1);
        hopper::fence_regs<kKeys / 2>(sc);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DQK / 16; ++kk)
          qk_mma<kKeys>(sc, Gq::kmajor(q_tile, kWgRows, kk),
                        Gq::kmajor(sk + s * T::kKBytes, kKeys, kk), kk > 0);
        hopper::wgmma_commit();
        hopper::fence_regs<kKeys / 2>(sc);
      };
      // O += P V of tile it, P from registers
      auto issue_pv = [&](int it) {
        const int s = (gt + it) % ST;
        hopper::mbar_wait(v_full(s), ((gt + it) / ST) & 1);
        hopper::fence_regs<DV / 2>(o);
        hopper::fence_regs<kKeys / 4>(&pa[0][0]);
        hopper::wgmma_fence();
#pragma unroll
        for (int j = 0; j < kKeys / 16; ++j)
          hopper::rs_mma<DV, Gv>(o, pa[j], sv + s * T::kVBytes, j);
        hopper::wgmma_commit();
        hopper::fence_regs<DV / 2>(o);
        hopper::fence_regs<kKeys / 4>(&pa[0][0]);
      };
      // Softmax of tile it's scores, in place: scale, softcap, mask (only
      // where a key of the tile can be masked for a row of this
      // warpgroup), new maxima, P in fp32, the row sums; returns the
      // corrections of the earlier state in *c0, *c1.  It runs while the
      // PV of the previous tile is in flight, so it writes no register
      // that PV reads: P is packed to bf16 (take_p) only once that PV is
      // done, or ptxas serialises every wgmma of the kernel.
      auto softmax = [&](int it, float* c0, float* c1) {
        const int k0 = w.first + it * kKeys;
        const bool masked = k0 + kKeys > w.len || (a.causal && k0 + kKeys - 1 > wq_lo)
                            || (a.window > 0 && k0 <= wq_hi - a.window);
        float mx0 = kNegInit, mx1 = kNegInit;
        // most tiles: the raw scores' maxima (scale > 0 keeps the order);
        // the scale enters with the exponent's argument, one FFMA
        const bool plain = !masked && a.softcap <= 0.f && a.scale > 0.f;
        if (plain) {
#pragma unroll
          for (int j = 0; j < kKeys / 8; ++j) {
            mx0 = fmaxf(mx0, fmaxf(sc[4 * j + 0], sc[4 * j + 1]));
            mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
          }
          mx0 *= scale2;
          mx1 *= scale2;
        } else {
          // the keys each row may see: [lo, hi), as cap_and_mask decides
          const int hi0 = a.causal ? min(w.len, qp0 + 1) : w.len;
          const int hi1 = a.causal ? min(w.len, qp1 + 1) : w.len;
          const int lo0 = a.window > 0 ? qp0 - a.window + 1 : INT_MIN;
          const int lo1 = a.window > 0 ? qp1 - a.window + 1 : INT_MIN;
#pragma unroll
          for (int j = 0; j < kKeys / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float x = sc[4 * j + e] * a.scale;
              if (a.softcap > 0.f) x = a.softcap * tanhf(x / a.softcap);
              const int kp = k0 + 8 * j + 2 * t + (e & 1);
              const bool ok = e < 2 ? (kp >= lo0 && kp < hi0) : (kp >= lo1 && kp < hi1);
              x = ok ? x * kLog2e : kNegInit;
              sc[4 * j + e] = x;
              if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
            }
          }
        }
#pragma unroll
        for (int sh = 1; sh <= 2; sh <<= 1) {          // the 4 lanes of a row
          mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, sh));
          mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, sh));
        }
        const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
        *c0 = fast_exp2(m0 - mn0);
        *c1 = fast_exp2(m1 - mn1);
        m0 = mn0;
        m1 = mn1;
        // p = 2**(x - m): x = s * scale2 on plain tiles (one FFMA)
        const float f = plain ? scale2 : 1.f;
        float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
        for (int j = 0; j < kKeys / 8; ++j) {
          const float p0 = fast_exp2(fmaf(sc[4 * j + 0], f, -mn0));
          const float p1 = fast_exp2(fmaf(sc[4 * j + 1], f, -mn0));
          const float p2 = fast_exp2(fmaf(sc[4 * j + 2], f, -mn1));
          const float p3 = fast_exp2(fmaf(sc[4 * j + 3], f, -mn1));
          ps0 += p0 + p1;
          ps1 += p2 + p3;
          sc[4 * j + 0] = p0;
          sc[4 * j + 1] = p1;
          sc[4 * j + 2] = p2;
          sc[4 * j + 3] = p3;
        }
        l0 = l0 * *c0 + ps0;
        l1 = l1 * *c1 + ps1;
      };
      // P of key chunks 2j and 2j + 1 is the A operand of PV's k-step j
      auto take_p = [&]() {
#pragma unroll
        for (int j = 0; j < kKeys / 8; ++j) {
          pa[j / 2][(j % 2) * 2 + 0] = pack_f32(sc[4 * j + 0], sc[4 * j + 1]);
          pa[j / 2][(j % 2) * 2 + 1] = pack_f32(sc[4 * j + 2], sc[4 * j + 3]);
        }
      };

      hopper::mbar_wait(q_full, n & 1);
      if (w.ntiles > 0) {
        float c0, c1;
        my_turn();
        issue_qk(0);
        your_turn();
        hopper::wgmma_wait<0>();
        hopper::fence_regs<kKeys / 2>(sc);
        hopper::mbar_arrive(k_empty(gt % ST));
        softmax(0, &c0, &c1);                 // O is still 0: no correction
        take_p();
        for (int it = 1; it < w.ntiles; ++it) {
          my_turn();
          issue_qk(it);
          issue_pv(it - 1);
          your_turn();
          hopper::wgmma_wait<1>();            // S of tile it is in
          hopper::fence_regs<kKeys / 2>(sc);
          hopper::mbar_arrive(k_empty((gt + it) % ST));
          softmax(it, &c0, &c1);
          hopper::wgmma_wait<0>();            // PV of tile it - 1 is in
          hopper::fence_regs<DV / 2>(o);
          hopper::fence_regs<kKeys / 4>(&pa[0][0]);   // live until here
          hopper::mbar_arrive(v_empty((gt + it - 1) % ST));
#pragma unroll
          for (int j = 0; j < DV / 8; ++j) {
            o[4 * j + 0] *= c0;
            o[4 * j + 1] *= c0;
            o[4 * j + 2] *= c1;
            o[4 * j + 3] *= c1;
          }
          take_p();
        }
        hopper::mbar_arrive(q_empty);         // every S of this item is done
        my_turn();
        issue_pv(w.ntiles - 1);
        your_turn();
        hopper::wgmma_wait<0>();
        hopper::fence_regs<DV / 2>(o);
        hopper::fence_regs<kKeys / 4>(&pa[0][0]);
        hopper::mbar_arrive(v_empty((gt + w.ntiles - 1) % ST));
      } else {
        hopper::mbar_arrive(q_empty);
      }
      gt += w.ntiles;

#pragma unroll
      for (int sh = 1; sh <= 2; sh <<= 1) {
        l0 += __shfl_xor_sync(kFull, l0, sh);
        l1 += __shfl_xor_sync(kFull, l1, sh);
      }
      const float i0 = 1.f / fmaxf(l0, 1e-30f), i1 = 1.f / fmaxf(l1, 1e-30f);
      __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out);
      uint32_t* o0 = reinterpret_cast<uint32_t*>(
          out + ((static_cast<size_t>(w.b) * a.Sq + r0) * a.H + w.h) * DV);
      uint32_t* o1 = reinterpret_cast<uint32_t*>(
          out + ((static_cast<size_t>(w.b) * a.Sq + r1) * a.H + w.h) * DV);
#pragma unroll
      for (int j = 0; j < DV / 8; ++j) {
        const int c = (8 * j + 2 * t) / 2;
        if (r0 < a.Sq) o0[c] = pack_f32(o[4 * j + 0] * i0, o[4 * j + 1] * i0);
        if (r1 < a.Sq) o1[c] = pack_f32(o[4 * j + 2] * i1, o[4 * j + 3] * i1);
      }
      // the log-sum-exp in natural units: the maxima are in log2 units
      if (a.lse != nullptr && t == 0) {
        float* lse = a.lse + (static_cast<size_t>(w.b) * a.H + w.h) * a.Sq;
        if (r0 < a.Sq) lse[r0] = m0 * kLn2 + logf(fmaxf(l0, 1e-30f));
        if (r1 < a.Sq) lse[r1] = m1 * kLn2 + logf(fmaxf(l1, 1e-30f));
      }
    }
  }
}

template <typename K, typename... P>
cudaError_t launch(K kern, dim3 grid, int threads, size_t smem, cudaStream_t stream,
                   const P&... args) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kern<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

template <int DQK, int DV, int NWG>
cudaError_t launch_wgmma(const Args& a, int B, cudaStream_t s) {
  constexpr int kKeys = Tiles<DQK, DV>::kKeys;
  CUtensorMap qm, km, vm;
  if (!make_map<DQK>(&qm, a.q, a.H, a.Sq, B, kWgRows)
      || !make_map<DQK>(&km, a.k, a.KV, a.Sk, B, kKeys)
      || !make_map<DV>(&vm, a.v, a.KV, a.Sk, B, kKeys))
    return cudaErrorInvalidValue;
  const int rows = NWG * kWgRows;
  const int nqt = (a.Sq + rows - 1) / rows;
  const int items = nqt * a.H * B;
  const int grid = items < sm_count() ? items : sm_count();
  return launch(flash_wgmma_kernel<DQK, DV, NWG>, dim3(grid), Pipe<NWG>::kThreads,
                wgmma_smem<DQK, DV, NWG>(), s, qm, km, vm, a, B, nqt);
}

// Two consumer warpgroups (128-row work items) when that still gives two
// items for every SM, else one (64-row items), so a short prefill chunk
// still spreads over the card.
int consumers(int B, int Sq, int H) {
  const long tiles2 = static_cast<long>((Sq + 2 * kWgRows - 1) / (2 * kWgRows)) * H * B;
  return tiles2 >= 2L * sm_count() ? 2 : 1;
}

template <int DQK, int DV>
cudaError_t dispatch_wgmma(const Args& a, int B, cudaStream_t s) {
  if (consumers(B, a.Sq, a.H) == 2) return launch_wgmma<DQK, DV, 2>(a, B, s);
  return launch_wgmma<DQK, DV, 1>(a, B, s);
}

// The only head-dim pairs (D, DV) instantiated for bf16: those a port
// config or a card test reaches.  D = DV = 16 (the reduced configs), 64
// (granite), 128 (llama3-8b, chatglm3-6b) and 256 (gemma2-2b, gemma-7b),
// and D = 192, DV = 128 (deepseek-v2-lite's MLA).
constexpr int kBf16Pairs[][2] = {{16, 16}, {64, 64}, {128, 128}, {256, 256}, {192, 128}};
constexpr int kNumBf16Pairs = sizeof(kBf16Pairs) / sizeof(kBf16Pairs[0]);

// Calls f(integral_constant<D>, integral_constant<DV>) for the built pair
// equal to (D, DV); false if none is.
template <int I = 0, typename F>
bool with_bf16_pair(int D, int DV, F&& f) {
  if constexpr (I == kNumBf16Pairs) {
    return false;
  } else {
    constexpr int kD = kBf16Pairs[I][0], kDV = kBf16Pairs[I][1];
    if (D != kD || DV != kDV) return with_bf16_pair<I + 1>(D, DV, f);
    f(std::integral_constant<int, kD>{}, std::integral_constant<int, kDV>{});
    return true;
  }
}

// The fp32 kernel for head dims (D, DV): the pairs the port's configs
// serve and train at, (16, 16), (64, 64), (128, 128), (256, 256) and
// (192, 128), built with their dims fixed; any other pair runs the
// kernel that reads them, in the n-tile count that holds DV.
using F32Kernel = void (*)(Args, Split);

F32Kernel f32_kernel(int D, int DV) {
  if (D == 16 && DV == 16) return flash_tf32_kernel<2, 16>;
  if (D == 64 && DV == 64) return flash_tf32_kernel<8, 64>;
  if (D == 128 && DV == 128) return flash_tf32_kernel<16, 128>;
  if (D == 256 && DV == 256) return flash_tf32_kernel<32, 256>;
  if (D == 192 && DV == 128) return flash_tf32_kernel<16, 192>;
  if (DV <= 16) return flash_tf32_kernel<2, 0>;
  if (DV <= 32) return flash_tf32_kernel<4, 0>;
  if (DV <= 64) return flash_tf32_kernel<8, 0>;
  if (DV <= 128) return flash_tf32_kernel<16, 0>;
  return flash_tf32_kernel<32, 0>;
}

}  // namespace

// bf16 takes the pairs of kBf16Pairs, fp32 any D up to 256 and any DV up
// to D, multiples of 16.  Others return cudaErrorInvalidValue.  The bf16
// kernel takes 16-byte aligned q, k, v (TMA); so does fp32 (cp.async).
// `lse` (B, H, Sq) fp32, or null, takes each row's log-sum-exp for the
// backward pass (training).  fp32 cuts each q tile's key reach into
// `nsplit` splits of `split_len` keys, the last to the reach's end (a
// multiple of 32; with one split,
// at least Sk); with more than one, `part` is fp32 scratch of
// B * H * nsplit * Sq * (DV + 2) floats and a second kernel merges the
// splits.
extern "C" int flash_attention(
    const void* q, const void* k, const void* v, const void* kv_len, const void* q_off,
    void* out, void* lse, void* part, int B, int Sq, int Sk, int H, int KV, int D, int DV,
    int q_off0, float scale, int causal, int window, float softcap, int nsplit, int split_len,
    int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KV <= 0 || H % KV != 0) return cudaErrorInvalidValue;
  const Args a{q, k, v, static_cast<const int32_t*>(kv_len),
               static_cast<const int32_t*>(q_off), out, static_cast<float*>(lse), Sq, Sk, H, KV, D, DV, q_off0,
               scale, causal, window, softcap};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) {
    cudaError_t err = cudaErrorInvalidValue;
    with_bf16_pair(D, DV, [&](auto d, auto dv) {
      err = dispatch_wgmma<decltype(d)::value, decltype(dv)::value>(a, B, s);
    });
    return err;
  }
  if (dtype == kF32) {
    if (D % 16 || DV % 16 || D > 256 || DV <= 0 || DV > D) return cudaErrorInvalidValue;
    if (nsplit < 1 || split_len < kF32Keys || split_len % kF32Keys
        || (nsplit == 1 && split_len < Sk) || (nsplit > 1 && part == nullptr))
      return cudaErrorInvalidValue;
    const int nqt = (Sq + kF32Rows - 1) / kF32Rows;
    const Split sp{nqt, B, nsplit, split_len, static_cast<float*>(part)};
    const cudaError_t e = launch(f32_kernel(D, DV), dim3(nqt * H * B * nsplit), kF32Threads,
                                 f32_smem(D, DV), s, a, sp);
    if (e != cudaSuccess || nsplit == 1) return e;
    return launch(flash_tf32_combine_kernel, dim3(Sq, H, B), kF32CombineThreads, 0, s, a, sp);
  }
  return cudaErrorInvalidValue;
}

// The fp32 kernel's launch for head dims (D, DV), into info: keys a kv
// tile, q rows a block, threads and dynamic shared bytes a block, blocks
// an SM can hold; false (0) for dims it does not take.
extern "C" int flash_attention_fp32_shape(int D, int DV, int* info) {
  if (D % 16 || DV % 16 || D > 256 || DV <= 0 || DV > D) return 0;
  const size_t smem = f32_smem(D, DV);
  int per_sm = 0;
  const F32Kernel kern = f32_kernel(D, DV);
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kF32Threads, smem);
  if (e != cudaSuccess) return 0;
  info[0] = kF32Keys;
  info[1] = kF32Rows;
  info[2] = kF32Threads;
  info[3] = static_cast<int>(smem);
  info[4] = per_sm;
  return 1;
}

// The launch shape the bf16 kernel takes for these sizes (for reports; no
// launch): consumer warpgroups, q rows a work item, K/V ring stages,
// threads and dynamic shared memory a block, work items, blocks.  A pair
// (D, DV) that is not built gives zero stages and shared bytes.
extern "C" void flash_attention_shape(int B, int Sq, int H, int D, int DV, int* info) {
  const int nwg = consumers(B, Sq, H);
  info[0] = nwg;
  info[1] = nwg * kWgRows;
  int stages = 0;
  size_t smem = 0;
  with_bf16_pair(D, DV, [&](auto d, auto dv) {
    constexpr int kD = decltype(d)::value, kDV = decltype(dv)::value;
    stages = Tiles<kD, kDV>::kStages;
    smem = nwg == 2 ? wgmma_smem<kD, kDV, 2>() : wgmma_smem<kD, kDV, 1>();
  });
  info[2] = stages;
  info[3] = nwg == 2 ? Pipe<2>::kThreads : Pipe<1>::kThreads;
  info[4] = static_cast<int>(smem);
  info[5] = (Sq + info[1] - 1) / info[1] * H * B;
  info[6] = info[5] < sm_count() ? info[5] : sm_count();
}

// The bf16 pairs, (D, DV) after (D, DV), into `pairs` (room for 2 * n
// ints); returns how many are built.
extern "C" int flash_attention_bf16_pairs(int* pairs, int n) {
  for (int i = 0; i < kNumBf16Pairs && i < n; ++i) {
    pairs[2 * i] = kBf16Pairs[i][0];
    pairs[2 * i + 1] = kBf16Pairs[i][1];
  }
  return kNumBf16Pairs;
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
