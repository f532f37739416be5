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
// not memory, bind.  Only wgmma reaches the tensor cores' full rate.
//
// Design.  The Pallas grid (batch, head, q block, kv block) carried the
// online softmax in VMEM scratch across its innermost, sequential kv axis,
// and predicated fully masked tiles off with pl.when.  Hopper blocks run
// in parallel and in no order, so here one block (fp32) or one work item
// of a persistent block (bf16) owns (q head, batch, q tile) and loops over
// the kv tiles itself, in order, with the softmax state (m, l, acc) in
// fp32 registers.  The loop visits only the tiles
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
//   into a ring of 3 stages that runs on from one item to the next,
//   completion counted in bytes on mbarriers; a K slot is released as soon
//   as S is computed, a V slot once PV is.  One or two consumer warpgroups
//   of 64 q rows each (setmaxnreg moves the producer's registers to them)
//   run S = QK^T as wgmma m64n128k16 with Q and K from shared memory
//   (128-byte swizzle, 32-byte at D = 16, as the TMA boxes write it) and
//   O += PV as wgmma m64nDk16 with P from registers (the S accumulator,
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

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <limits.h>

#include "wgmma.cuh"

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
constexpr int kKeys = 128;           // keys a kv tile: N of S = QK^T, K of O += PV
constexpr int kWgRows = 64;          // q rows a consumer warpgroup: M of wgmma
constexpr float kLog2e = 1.4426950408889634f;

// Shared layout of a (rows x D) bf16 operand tile, as TMA writes it: D is
// cut into chunks of kChunk columns, one TMA box each; a chunk is a
// (rows x kSw bytes) slab, swizzled over kSw bytes (128, or 32 at D = 16,
// whose rows are 32 bytes), so 8 rows make one swizzle atom of 8 * kSw
// bytes.  Slabs start 1024-byte aligned.
template <int D>
struct Geo {
  static_assert(D % 16 == 0 && D <= 128, "head dim");
  static constexpr int kSw = D >= 64 ? 128 : 32;
  static constexpr int kChunk = kSw / 2;
  static constexpr int kChunks = D / kChunk;
  static constexpr uint32_t kLayout = kSw == 128 ? 1 : 3;   // wgmma swizzle code
  static constexpr int kQBytes = kWgRows * D * 2;            // a warpgroup's q rows
  static constexpr int kKvBytes = kKeys * D * 2;             // one K or V tile

  // Q or K, K-major (D contiguous): k-step kk covers columns 16kk..16kk+15.
  // Within a 128-byte atom the step moves the start address by 32 bytes;
  // the leading offset is unused, the stride offset is one 8-row atom.
  static __device__ __forceinline__ uint64_t kmajor(uint32_t tile, int rows, int kk) {
    const int col = kk * 16;
    const uint32_t addr = tile + (col / kChunk) * rows * kSw + (col % kChunk) * 2;
    return hopper::make_desc(addr, 16, 8 * kSw, kLayout);
  }

  // V, MN-major (D contiguous, keys the K of PV): k-step j covers keys
  // 16j..16j+15, two 8-row atoms; the leading offset steps from one
  // column chunk to the next, the stride offset from one atom to the next.
  static __device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int j) {
    return hopper::make_desc(tile + j * 16 * kSw, kKeys * kSw, 8 * kSw, kLayout);
  }
};

// One block an SM: the launch takes every register (168 a thread with two
// consumer warpgroups, 255 with one), and setmaxnreg moves the producer
// warpgroup's share to the consumers.  The ring fills what shared memory
// the q rows leave (3 x 64 KB beside 32 KB at D = 128).
template <int NWG>
struct Pipe {
  static constexpr int kStages = 3;                          // K/V ring depth
  static constexpr int kThreads = (NWG + 1) * 128;           // + a producer warpgroup
  static constexpr int kConsumerRegs = NWG == 2 ? 240 : 256;
  static constexpr int kProducerRegs = 24;
};

template <int D, int NWG>
constexpr size_t wgmma_smem() {
  using Gm = Geo<D>;
  return 1024 + static_cast<size_t>(NWG) * Gm::kQBytes
         + 2 * static_cast<size_t>(Pipe<NWG>::kStages) * Gm::kKvBytes
         + 8 * (2 + 4 * Pipe<NWG>::kStages);
}

template <int D>
__device__ __forceinline__ void pv_mma(float* o, const uint32_t* p, uint64_t desc) {
  if constexpr (D == 128) hopper::wgmma_rs_n128(o, p, desc);
  else if constexpr (D == 64) hopper::wgmma_rs_n64(o, p, desc);
  else hopper::wgmma_rs_n16(o, p, desc);
}

// 2**x (ex2.approx.ftz: about 2 ulp; -1e30 and below give 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two bf16 in one register, the lower column in the low half
__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The work of one q tile: which (q head, batch, rows) and which kv tiles.
struct Item {
  int h, b, kh, row0, off, len, first, ntiles;
};

// Work items in descending cost: item i is q tile (nqt - 1 - i / (H * B))
// of head i % H, batch (i / H) % B, so under the causal mask the heaviest
// tiles start first and the light ones fill the tail.
template <int NWG>
__device__ __forceinline__ Item make_item(const Args& a, int i, int nqt, int B) {
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
template <int D, int NWG>
__global__ void __launch_bounds__(Pipe<NWG>::kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap, Args a, int B, int nqt) {
  using Gm = Geo<D>;
  constexpr int ST = Pipe<NWG>::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = (hopper::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sk = sq + NWG * Gm::kQBytes;
  const uint32_t sv = sk + ST * Gm::kKvBytes;
  const uint32_t bars = sv + ST * Gm::kKvBytes;
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
        const Item w = make_item<NWG>(a, i, nqt, B);
        if (n > 0) hopper::mbar_wait(q_empty, (n - 1) & 1);
        hopper::mbar_expect_tx(q_full, NWG * Gm::kQBytes);
        for (int r = 0; r < NWG; ++r)
          for (int c = 0; c < Gm::kChunks; ++c)
            hopper::tma_load_4d(sq + r * Gm::kQBytes + c * kWgRows * Gm::kSw, &qmap, q_full,
                                c * Gm::kChunk, w.h, w.row0 + r * kWgRows, w.b);
        for (int it = 0; it < w.ntiles; ++it, ++gt) {
          const int s = gt % ST, round = gt / ST;
          const int k0 = w.first + it * kKeys;
          if (round > 0) hopper::mbar_wait(k_empty(s), (round - 1) & 1);
          hopper::mbar_expect_tx(k_full(s), Gm::kKvBytes);
          for (int c = 0; c < Gm::kChunks; ++c)
            hopper::tma_load_4d(sk + s * Gm::kKvBytes + c * kKeys * Gm::kSw, &kmap,
                                k_full(s), c * Gm::kChunk, w.kh, k0, w.b);
          if (round > 0) hopper::mbar_wait(v_empty(s), (round - 1) & 1);
          hopper::mbar_expect_tx(v_full(s), Gm::kKvBytes);
          for (int c = 0; c < Gm::kChunks; ++c)
            hopper::tma_load_4d(sv + s * Gm::kKvBytes + c * kKeys * Gm::kSw, &vmap,
                                v_full(s), c * Gm::kChunk, w.kh, k0, w.b);
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
    const uint32_t q_tile = sq + wg * Gm::kQBytes;
    const float scale2 = a.scale * kLog2e;
    float o[D / 2];
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
      const Item w = make_item<NWG>(a, i, nqt, B);
      const int r0 = w.row0 + wg * kWgRows + warp * 16 + g, r1 = r0 + 8;
      const int qp0 = w.off + r0, qp1 = w.off + r1;
      const int wq_lo = w.off + w.row0 + wg * kWgRows, wq_hi = wq_lo + kWgRows - 1;
#pragma unroll
      for (int j = 0; j < D / 2; ++j) o[j] = 0.f;
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
        for (int kk = 0; kk < D / 16; ++kk)
          hopper::wgmma_ss_n128(sc, Gm::kmajor(q_tile, kWgRows, kk),
                                Gm::kmajor(sk + s * Gm::kKvBytes, kKeys, kk), kk > 0);
        hopper::wgmma_commit();
        hopper::fence_regs<kKeys / 2>(sc);
      };
      // O += P V of tile it, P from registers
      auto issue_pv = [&](int it) {
        const int s = (gt + it) % ST;
        hopper::mbar_wait(v_full(s), ((gt + it) / ST) & 1);
        hopper::fence_regs<D / 2>(o);
        hopper::fence_regs<kKeys / 4>(&pa[0][0]);
        hopper::wgmma_fence();
#pragma unroll
        for (int j = 0; j < kKeys / 16; ++j)
          pv_mma<D>(o, pa[j], Gm::mnmajor(sv + s * Gm::kKvBytes, j));
        hopper::wgmma_commit();
        hopper::fence_regs<D / 2>(o);
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
          hopper::fence_regs<D / 2>(o);
          hopper::fence_regs<kKeys / 4>(&pa[0][0]);   // live until here
          hopper::mbar_arrive(v_empty((gt + it - 1) % ST));
#pragma unroll
          for (int j = 0; j < D / 8; ++j) {
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
        hopper::fence_regs<D / 2>(o);
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
          out + ((static_cast<size_t>(w.b) * a.Sq + r0) * a.H + w.h) * D);
      uint32_t* o1 = reinterpret_cast<uint32_t*>(
          out + ((static_cast<size_t>(w.b) * a.Sq + r1) * a.H + w.h) * D);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int c = (8 * j + 2 * t) / 2;
        if (r0 < a.Sq) o0[c] = pack_f32(o[4 * j + 0] * i0, o[4 * j + 1] * i0);
        if (r1 < a.Sq) o1[c] = pack_f32(o[4 * j + 2] * i1, o[4 * j + 3] * i1);
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

// cuTensorMapEncodeTiled, taken from the driver through the runtime, so
// the library needs no link against libcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-D map over a row-major bf16 (d3, d2, d1, D) tensor whose boxes are
// (1, rows, 1, chunk): one chunk of D columns of `rows` consecutive rows
// of dim 2, for one index of dims 1 and 3.  Rows past d2 read as zeros, and
// never as the next index of dim 3.
template <int D>
bool make_map(CUtensorMap* map, const void* ptr, int d1, int d2, int d3, int rows) {
  using Gm = Geo<D>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(d1),
                              static_cast<cuuint64_t>(d2), static_cast<cuuint64_t>(d3)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(d1) * D * 2,
                                 static_cast<cuuint64_t>(d2) * d1 * D * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(Gm::kChunk), 1u,
                             static_cast<cuuint32_t>(rows), 1u};
  const cuuint32_t elem[4] = {1u, 1u, 1u, 1u};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                Gm::kSw == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess
        || cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      n = 132;
  }
  return n;
}

template <int D, int NWG>
cudaError_t launch_wgmma(const Args& a, int B, cudaStream_t s) {
  CUtensorMap qm, km, vm;
  if (!make_map<D>(&qm, a.q, a.H, a.Sq, B, kWgRows)
      || !make_map<D>(&km, a.k, a.KV, a.Sk, B, kKeys)
      || !make_map<D>(&vm, a.v, a.KV, a.Sk, B, kKeys))
    return cudaErrorInvalidValue;
  const int rows = NWG * kWgRows;
  const int nqt = (a.Sq + rows - 1) / rows;
  const int items = nqt * a.H * B;
  const int grid = items < sm_count() ? items : sm_count();
  return launch(flash_wgmma_kernel<D, NWG>, dim3(grid), Pipe<NWG>::kThreads,
                wgmma_smem<D, NWG>(), s, qm, km, vm, a, B, nqt);
}

// Two consumer warpgroups (128-row work items) when that still gives two
// items for every SM, else one (64-row items), so a short prefill chunk
// still spreads over the card.
template <int D>
cudaError_t dispatch_wgmma(const Args& a, int B, cudaStream_t s) {
  const long tiles2 = static_cast<long>((a.Sq + 2 * kWgRows - 1) / (2 * kWgRows)) * a.H * B;
  if (tiles2 >= 2L * sm_count()) return launch_wgmma<D, 2>(a, B, s);
  return launch_wgmma<D, 1>(a, B, s);
}

}  // namespace

// Only the head dims a port config or a card test reaches are
// instantiated: D = 128 (llama3-8b) and D = 16 (the reduced configs), and
// D = 64 for bf16.  Others return cudaErrorInvalidValue.  The bf16 kernel
// takes 16-byte aligned q, k, v (TMA).
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
    switch (D) {
      case 16: return dispatch_wgmma<16>(a, B, s);
      case 64: return dispatch_wgmma<64>(a, B, s);
      case 128: return dispatch_wgmma<128>(a, B, s);
      default: return cudaErrorInvalidValue;
    }
  }
  if (dtype == kF32) {
    const dim3 grid((Sq + kSimtRows - 1) / kSimtRows, H, B);
    const size_t smem = simt_smem(D);
    if (D <= 32) return launch(flash_fp32_kernel<1>, grid, kSimtWarps * 32, smem, s, a);
    if (D <= 128) return launch(flash_fp32_kernel<4>, grid, kSimtWarps * 32, smem, s, a);
    return cudaErrorInvalidValue;
  }
  return cudaErrorInvalidValue;
}

// The launch shape the bf16 kernel takes for these sizes (for reports; no
// launch): consumer warpgroups, q rows a work item, K/V ring stages,
// threads and dynamic shared memory a block, work items, blocks.
extern "C" void flash_attention_shape(int B, int Sq, int H, int D, int* info) {
  const long tiles2 = static_cast<long>((Sq + 2 * kWgRows - 1) / (2 * kWgRows)) * H * B;
  const int nwg = tiles2 >= 2L * sm_count() ? 2 : 1;
  info[0] = nwg;
  info[1] = nwg * kWgRows;
  info[2] = nwg == 2 ? Pipe<2>::kStages : Pipe<1>::kStages;
  info[3] = nwg == 2 ? Pipe<2>::kThreads : Pipe<1>::kThreads;
  size_t smem = 0;
  switch (D) {
    case 16: smem = nwg == 2 ? wgmma_smem<16, 2>() : wgmma_smem<16, 1>(); break;
    case 64: smem = nwg == 2 ? wgmma_smem<64, 2>() : wgmma_smem<64, 1>(); break;
    default: smem = nwg == 2 ? wgmma_smem<128, 2>() : wgmma_smem<128, 1>(); break;
  }
  info[4] = static_cast<int>(smem);
  info[5] = (Sq + info[1] - 1) / info[1] * H * B;
  info[6] = info[5] < sm_count() ? info[5] : sm_count();
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
