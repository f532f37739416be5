// The backward pass of GQA flash attention, for Hopper (sm_90a).
//
// The gradient of src/repro_torch/csrc/flash_attention.cu's forward, as
// src/repro/kernels/flash_vjp.py's _bwd_rule computes it (no Pallas kernel
// there: plain jnp): from q, k, v, the output o, its gradient do and the
// forward's log-sum-exp lse (natural log), recompute each score s =
// (q . k) * scale, its capped value sc = cap * tanh(s / cap) (or s), the
// probability p = exp(sc - lse) where the mask keeps the key (else 0), and
//   delta = rowsum(do * o)
//   dv   += p^T do
//   dp    = do v^T
//   ds    = p * (dp - delta) * (1 - (sc / cap)^2)    (the softcap's chain)
//   dq   += ds k * scale
//   dk   += ds^T q * scale
// with the forward's masks: keys past kv_len[b], and (causal) k_pos >
// q_pos, and (window) k_pos <= q_pos - window, q_pos = q_off + i.  Under
// GQA each dk/dv row sums over the G query heads of its kv head.
//
// q, do (B, Sq, H, D / DV); k, v (B, Sk, KV, D / DV); o (B, Sq, H, DV);
// lse, delta (B, H, Sq) fp32; the gradients in the inputs' type.  Built at
// the forward's head-dim pairs (D, DV): (16, 16), (64, 64), (128, 128),
// (256, 256) and (192, 128), MLA's.
//
// What bounds it: operations.  Per unmasked (query, key) pair and head it
// does 7 products of the forward's size (S and dP twice, once in each
// kernel below, then dV, dK, dQ): 8 D + 6 DV flops; FlashAttention-2's
// schedule does 5 (6 D + 4 DV) by adding dQ with atomics, in an order that
// changes from call to call.  Here every sum has one fixed order, so two
// calls give bit-equal gradients (a checkpoint resume replays a step
// exactly).  Three launches:
//   1. delta: a warp a row.
//   2. dK, dV: a block a (64 keys, kv head, batch).
//   3. dQ: a block a (64 or 128 q rows, head, batch).
//
// bf16: the products on the tensor cores (wgmma), from tiles that TMA
// loads into shared memory (wgmma.cuh's Geo layout: 128-byte swizzle, 32
// at D = 16).  A producer warpgroup feeds a ring of stages through
// mbarriers; consumer warpgroups run the products, setmaxnreg giving them
// the producer's registers.
//   dK/dV kernel: K and V of the block's 64 keys load once; the ring
//   streams, for each of the G heads, the 64-row q tiles the mask reaches:
//   Q, dO, and their rows' lse (in log2 units) and delta, which a producer
//   warp copies in.  Two consumer warpgroups split the block's work and
//   its accumulators, so that one warpgroup never holds both dK and dV
//   (at D = 256 each is 64 x 256 fp32, 128 registers a thread):
//     warpgroup 0: S^T = K Q^T (SS), P^T from it, dV += P^T dO (RS: P^T
//                  from registers, dO the MN-major B);
//     warpgroup 1: dP^T = V dO^T (SS), dS^T = P^T (dP^T - delta) (its P^T
//                  times the softcap's chain from warpgroup 0, through a
//                  double-buffered fp32 tile in shared memory), dK +=
//                  dS^T Q (RS).
//   The two accumulators' layouts match element for element (both are
//   64 keys x 64 q rows), so the exchange is one float a register, read
//   and written by consecutive threads.  Warpgroup 0 runs up to two q
//   tiles ahead of warpgroup 1.
//   dQ kernel: each consumer warpgroup owns 64 q rows (two warpgroups
//   share each K/V stage; one at D = 256, whose dQ is 128 registers):
//   S = Q K^T and dP = dO V^T (SS), P and dS in registers, dQ += dS K (RS,
//   K the MN-major B), over the 64-key tiles its mask reaches.
// The score is scaled in fp32 after the product, as the bf16 forward does,
// and P and dS enter their products rounded to bf16; every sum is fp32.
//
// fp32: exact to fp32 in the JAX order (q * scale in fp32 before its
// products, the softcap, its chain 1 - (sc/cap)^2, the mask, dq = (dS K) *
// scale, dk = dS^T (q * scale)), on the tensor cores.  One TF32 product
// moves a gradient by 3-9e-4 of its largest value, past the 1e-4 the fp32
// backward is held to, so each product is three mma.sync m16n8k8 of
// operands split into two TF32 halves (3xTF32, tf32.cuh): about 1e-6.  The
// bound is then operations at 3xTF32's rate, a third of the TF32 peak
// (494.7 / 3 = 164.9 TFLOP/s against 67 on the CUDA cores).  The design:
//   * Fragments: mma.sync's A and B load from shared memory lane by lane,
//     so one tile serves along its rows (A, and B of S = Q K^T) and down
//     its columns (B of P^T dO, dS^T Q, dS K) with no transpose (wgmma
//     takes TF32 operands only K-major); rows padded to width + 8 floats.
//     The k index of each product is permuted (tf32.cuh), so the C
//     fragment of S^T or dP^T (S, dP in dQ) is, as it stands, the A
//     fragment of the next product: P and dS stay in registers.
//   * dK/dV block (f32_kv_role): 8 warps, 64 keys; warps 0-3 (role 0) run
//     S^T, P^T and dV, warps 4-7 (role 1) dP^T, dS^T and dK, each warp on
//     16 keys, so no warp holds both dK and dV (128 registers each at D =
//     256).  P^T times the softcap's chain passes from role 0's warp w to
//     role 1's through a shared tile, one float a register, and a 64-
//     thread named barrier.  The q tiles (Q, dO, lse, delta) stream through
//     a 2-stage cp.async ring, the next tile's copies under this one's
//     products; q * scale and lse in log2 units once per tile, in place.
//   * dQ block: 64 or 128 q rows, Q (times scale) and dO staged once, the
//     key tiles (K, V) through a 2-stage cp.async ring; a warp a 16 rows,
//     or at (192, 128) and (256, 256) two (f32_q_half: one S and P, one
//     dP and dS, through a shared tile; dQ's columns split between them),
//     so that 8 warps share an SM where 4 of 255 registers would.
//   * Tiles per pair (F32Bwd): the widths set the shared bytes, so the q
//     tile of dK/dV is 64 rows at D <= 128, 32 at (192, 128) and (64, 64)
//     (two blocks an SM), 16 at D = 256; the dQ key tile 64, 32, 16.
//   * Both grids run the heaviest blocks first under the causal mask
//     (dK/dV: the first key blocks; dQ: the last q tiles), across heads and
//     batches; a warp whose keys (rows) the mask drops for a whole tile
//     skips its products.
//   * Sums: mma.sync adds into its accumulator with truncation, so dK
//     carried in it through every q row of G heads (32768 at G = 8, S =
//     4096) was off by 1.9e-3 where the largest |dk| is 7.7 on an H100
//     (the SIMT kernel: 9.9e-5 at most); each step's dV, dK or dQ product
//     is taken in a fresh accumulator and added in fp32, round to nearest
//     (f32_add_step): 3.5e-5 at most.
// No atomics: every gradient element is one warp's fp32 sum over q tiles
// (heads, in order) or key tiles, in a fixed order.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <type_traits>

#include "tf32.cuh"
#include "wgmma.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;
enum DType { kF32 = 0, kBF16 = 1 };

struct Args {
  const void* q;           // (B, Sq, H, D)
  const void* k;           // (B, Sk, KV, D)
  const void* v;           // (B, Sk, KV, DV)
  const void* o;           // (B, Sq, H, DV)
  const void* dout;        // (B, Sq, H, DV)
  const float* lse;        // (B, H, Sq)
  float* delta;            // (B, H, Sq) workspace
  const int32_t* kv_len;   // (B,) or null: Sk
  void* dq;                // (B, Sq, H, D)
  void* dk;                // (B, Sk, KV, D)
  void* dv;                // (B, Sk, KV, DV)
  int B, Sq, Sk, H, KV, D, DV;
  int q_off;
  float scale;
  int causal;
  int window;              // <= 0: none
  float softcap;           // <= 0: none
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ int valid_len(const Args& a, int b) {
  return a.kv_len != nullptr ? min(a.kv_len[b], a.Sk) : a.Sk;
}

__device__ __forceinline__ bool keep(const Args& a, int q_pos, int k_pos, int len) {
  bool ok = k_pos < len;
  if (a.causal) ok = ok && k_pos <= q_pos;
  if (a.window > 0) ok = ok && k_pos > q_pos - a.window;
  return ok;
}

// p = exp(sc - lse) of one scaled score x (0 where the mask drops the
// key), lse2 in log2 units; *f takes the softcap's chain factor 1 -
// (sc/cap)^2.
__device__ __forceinline__ float prob(const Args& a, float x, float lse2, bool ok, float* f) {
  *f = 1.f;
  if (a.softcap > 0.f) {
    x = a.softcap * tanhf(x / a.softcap);
    *f = 1.f - (x / a.softcap) * (x / a.softcap);
  }
  return ok ? hopper::fast_exp2(fmaf(x, kLog2e, -lse2)) : 0.f;
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

// ------------------------------------------------------------- 1. delta
template <typename T>
__global__ void __launch_bounds__(256) delta_kernel(Args a) {
  const int warp = (blockIdx.x * 256 + threadIdx.x) / 32, lane = threadIdx.x % 32;
  const int rows = a.B * a.Sq * a.H;
  if (warp >= rows) return;                 // warp-uniform
  const int h = warp % a.H, i = (warp / a.H) % a.Sq, b = warp / (a.H * a.Sq);
  const size_t base = static_cast<size_t>(warp) * a.DV;   // (B, Sq, H) row-major
  const T* o = static_cast<const T*>(a.o);
  const T* g = static_cast<const T*>(a.dout);
  float acc = 0.f;
  for (int d = lane; d < a.DV; d += 32) acc += to_f(g[base + d]) * to_f(o[base + d]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(kFull, acc, off);
  if (lane == 0) a.delta[(static_cast<size_t>(b) * a.H + h) * a.Sq + i] = acc;
}

template <typename T>
cudaError_t launch_delta(const Args& a, cudaStream_t s) {
  const long rows = static_cast<long>(a.B) * a.Sq * a.H;
  delta_kernel<T><<<static_cast<unsigned>((rows * 32 + 255) / 256), 256, 0, s>>>(a);
  return cudaGetLastError();
}

// ============================================================= bf16: wgmma
constexpr int kTile = hopper::kWgRows;     // 64: keys of a dK/dV block, q rows of
                                           // a step; q rows of a dQ warpgroup,
                                           // keys of a step
constexpr size_t kSmemMax = 227 * 1024;
constexpr int kProducerRegs = 40;
constexpr int kXBytes = kTile * kTile * 4;     // one fp32 exchange tile
constexpr int kLBytes = kTile * 4;             // a stage's lse or delta

// Shared bytes of a dK/dV block: alignment slack, K and V, a ring of `st`
// stages of (Q, dO, lse, delta), two fp32 exchange tiles, barriers.
constexpr size_t kv_smem(int k_bytes, int v_bytes, int st) {
  return 1024 + static_cast<size_t>(k_bytes + v_bytes)
         + static_cast<size_t>(st) * (k_bytes + v_bytes + 2 * kLBytes) + 2 * kXBytes
         + 8 * (5 + 2 * st);
}

// Shared bytes of a dQ block: slack, its nwg warpgroups' Q and dO rows, a
// ring of `st` stages of (K, V), barriers.
constexpr size_t q_smem(int k_bytes, int v_bytes, int nwg, int st) {
  return 1024 + static_cast<size_t>(nwg + st) * (k_bytes + v_bytes) + 8 * (1 + 3 * st);
}

// as many stages as fit, 4 at most
constexpr int kv_stages(int k, int v) {
  return kv_smem(k, v, 4) <= kSmemMax ? 4 : kv_smem(k, v, 3) <= kSmemMax ? 3 : 2;
}
constexpr int q_stages(int k, int v, int nwg) {
  return q_smem(k, v, nwg, 4) <= kSmemMax ? 4 : q_smem(k, v, nwg, 3) <= kSmemMax ? 3 : 2;
}

// The tiles and shared memory of a (D, DV) pair.
template <int D, int DV>
struct Bwd {
  using Gk = hopper::Geo<D, kTile>;        // Q and K tiles
  using Gv = hopper::Geo<DV, kTile>;       // dO and V tiles
  static constexpr int kKBytes = Gk::kTileBytes;
  static constexpr int kVBytes = Gv::kTileBytes;
  static constexpr int kKvStages = kv_stages(kKBytes, kVBytes);
  static constexpr size_t kKvSmem = kv_smem(kKBytes, kVBytes, kKvStages);
  // dQ: one consumer warpgroup at D = 256 (its dQ is 128 registers), else two
  static constexpr int kQWgs = D + DV > 384 ? 1 : 2;
  static constexpr int kQStages = q_stages(kKBytes, kVBytes, kQWgs);
  static constexpr size_t kQSmem = q_smem(kKBytes, kVBytes, kQWgs, kQStages);
  static_assert(kKvSmem <= kSmemMax && kQSmem <= kSmemMax, "shared memory");
};

// Consumer registers (setmaxnreg): two consumer warpgroups beside the
// producer share 3 x 168 a thread as 2 x 232 + 40; one takes its 255.
template <int NWG>
__host__ __device__ constexpr int consumer_regs() { return NWG == 2 ? 232 : 256; }

// The q tiles of a dK/dV block: step i is q head kh * G + i / nq, rows
// lo + (i % nq) * 64; n = G * nq steps (0 when no key of the block is kept).
struct KvWork {
  int b, kh, k0, len, G, lo, nq, n;
};

__device__ __forceinline__ KvWork kv_work(const Args& a) {
  KvWork w;
  w.k0 = blockIdx.x * kTile;
  w.kh = blockIdx.y;
  w.b = blockIdx.z;
  w.G = a.H / a.KV;
  w.len = valid_len(a, w.b);
  // the q rows whose mask can keep a key of this block: [lo, hi)
  int lo = 0, hi = a.Sq;
  if (a.causal) lo = max(lo, w.k0 - a.q_off);
  if (a.window > 0) hi = min(hi, w.k0 + kTile - 1 + a.window - a.q_off);
  w.lo = (lo / kTile) * kTile;
  w.nq = (w.k0 < w.len && lo < hi) ? (hi - w.lo + kTile - 1) / kTile : 0;
  w.n = w.G * w.nq;
  return w;
}

// S^T of the accumulator layout as the A operand: key rows stay, q columns
// 16j..16j+15 (accumulator chunks 2j and 2j + 1) are the k-step j.
__device__ __forceinline__ void take_a(const float* x, uint32_t (*pa)[4]) {
#pragma unroll
  for (int j = 0; j < kTile / 8; ++j) {
    pa[j / 2][(j % 2) * 2 + 0] = hopper::pack_f32(x[4 * j + 0], x[4 * j + 1]);
    pa[j / 2][(j % 2) * 2 + 1] = hopper::pack_f32(x[4 * j + 2], x[4 * j + 3]);
  }
}

// Rows row0 (thread's g) and row0 + 8 of a 64-row accumulator, times
// `mul`, as bf16 into a (rows, W)-strided tensor: columns 8j + 2t, + 1.
template <int W>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, size_t stride, int r0,
                                           int nrows, const float* acc, float mul, int t) {
  const int r1 = r0 + 8;
  uint32_t* o0 = reinterpret_cast<uint32_t*>(out + static_cast<size_t>(r0) * stride);
  uint32_t* o1 = reinterpret_cast<uint32_t*>(out + static_cast<size_t>(r1) * stride);
#pragma unroll
  for (int j = 0; j < W / 8; ++j) {
    const int c = (8 * j + 2 * t) / 2;
    if (r0 < nrows) o0[c] = hopper::pack_f32(acc[4 * j + 0] * mul, acc[4 * j + 1] * mul);
    if (r1 < nrows) o1[c] = hopper::pack_f32(acc[4 * j + 2] * mul, acc[4 * j + 3] * mul);
  }
}

// ------------------------------------------------------------- 2. dK, dV
// Threads 0-127: warpgroup 0 (S^T, P^T, dV); 128-255: warpgroup 1 (dP^T,
// dS^T, dK); 256-383: the producer (thread 256 the TMA loads, warp 9 the
// lse and delta rows).  Register layouts (wgmma m64nNk16), warp w of a
// warpgroup, lane = 4 * g + t: accumulator d[4j + 0, 1] = (row 16w + g,
// cols 8j + 2t, +1), d[4j + 2, 3] = (row 16w + g + 8, same cols); rows
// are keys here, columns q rows.
template <int D, int DV>
__global__ void __launch_bounds__(384, 1)
dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                  const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap,
                  const __grid_constant__ CUtensorMap gmap, Args a) {
  using T = Bwd<D, DV>;
  using Gk = typename T::Gk;
  using Gv = typename T::Gv;
  constexpr int ST = T::kKvStages;
  constexpr int kN = kTile / 2;            // S^T / dP^T registers a thread
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const sm = smem_raw + (base - raw);
  // byte offsets from base: K, V, the Q and dO stages, the exchange
  // tiles, the lse and delta stages, the barriers
  constexpr uint32_t oK = 0, oV = oK + T::kKBytes, oQ = oV + T::kVBytes;
  constexpr uint32_t oG = oQ + ST * T::kKBytes, oX = oG + ST * T::kVBytes;
  constexpr uint32_t oL = oX + 2 * kXBytes, oD = oL + ST * kLBytes;
  constexpr uint32_t oB = oD + ST * kLBytes;
  float* const xbuf = reinterpret_cast<float*>(sm + oX);
  float* const lse_s = reinterpret_cast<float*>(sm + oL);
  float* const del_s = reinterpret_cast<float*>(sm + oD);
  // barriers: K and V in; per stage full (TMA bytes + the lse warp's 32
  // arrivals) and empty (both consumers); per exchange tile full, empty
  const uint32_t bars = base + oB;
  const uint32_t kv_full = bars;
  auto full = [&](int s) { return bars + 8u * (1 + s); };
  auto empty = [&](int s) { return bars + 8u * (1 + ST + s); };
  auto x_full = [&](int x) { return bars + 8u * (1 + 2 * ST + x); };
  auto x_empty = [&](int x) { return bars + 8u * (3 + 2 * ST + x); };
  const KvWork w = kv_work(a);

  if (threadIdx.x == 0) {
    hopper::mbar_init(kv_full, 1);
    for (int s = 0; s < ST; ++s) {
      hopper::mbar_init(full(s), 1 + 32);
      hopper::mbar_init(empty(s), 256);
    }
    for (int x = 0; x < 2; ++x) {
      hopper::mbar_init(x_full(x), 128);
      hopper::mbar_init(x_empty(x), 128);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer
    hopper::regs_dealloc<kProducerRegs>();
    const int ptid = threadIdx.x - 256;
    if (ptid == 0) {
      hopper::prefetch_map(&qmap);
      hopper::prefetch_map(&kmap);
      hopper::prefetch_map(&vmap);
      hopper::prefetch_map(&gmap);
      if (w.n > 0) {
        hopper::mbar_expect_tx(kv_full, T::kKBytes + T::kVBytes);
        for (int c = 0; c < Gk::kChunks; ++c)
          hopper::tma_load_4d(base + oK + c * kTile * Gk::kSw, &kmap, kv_full,
                              c * Gk::kChunk, w.kh, w.k0, w.b);
        for (int c = 0; c < Gv::kChunks; ++c)
          hopper::tma_load_4d(base + oV + c * kTile * Gv::kSw, &vmap, kv_full,
                              c * Gv::kChunk, w.kh, w.k0, w.b);
      }
      for (int i = 0; i < w.n; ++i) {
        const int s = i % ST, round = i / ST;
        const int h = w.kh * w.G + i / w.nq, q0 = w.lo + (i % w.nq) * kTile;
        if (round > 0) hopper::mbar_wait(empty(s), (round - 1) & 1);
        hopper::mbar_expect_tx(full(s), T::kKBytes + T::kVBytes);
        for (int c = 0; c < Gk::kChunks; ++c)
          hopper::tma_load_4d(base + oQ + s * T::kKBytes + c * kTile * Gk::kSw, &qmap,
                              full(s), c * Gk::kChunk, h, q0, w.b);
        for (int c = 0; c < Gv::kChunks; ++c)
          hopper::tma_load_4d(base + oG + s * T::kVBytes + c * kTile * Gv::kSw, &gmap,
                              full(s), c * Gv::kChunk, h, q0, w.b);
      }
    } else if (ptid >= 32 && ptid < 64) {
      // the stage's lse (log2 units) and delta; a row past Sq gets p = 0
      const int lane = ptid - 32;
      for (int i = 0; i < w.n; ++i) {
        const int s = i % ST, round = i / ST;
        const int h = w.kh * w.G + i / w.nq, q0 = w.lo + (i % w.nq) * kTile;
        if (round > 0) hopper::mbar_wait(empty(s), (round - 1) & 1);
        const size_t at = (static_cast<size_t>(w.b) * a.H + h) * a.Sq;
        for (int r = lane; r < kTile; r += 32) {
          const int row = q0 + r;
          lse_s[s * kTile + r] = row < a.Sq ? a.lse[at + row] * kLog2e : 1e30f;
          del_s[s * kTile + r] = row < a.Sq ? a.delta[at + row] : 0.f;
        }
        hopper::mbar_arrive(full(s));
      }
    }
  } else {
    hopper::regs_alloc<consumer_regs<2>()>();
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int kp0 = w.k0 + warp * 16 + g, kp1 = kp0 + 8;   // this thread's keys
    if (w.n > 0) hopper::mbar_wait(kv_full, 0);
    if (wg == 0) {
      // ---- S^T = K Q^T, P^T, dV += P^T dO
      float dv[DV / 2];
      float sc[kN];
      uint32_t pa[kTile / 16][4];
#pragma unroll
      for (int j = 0; j < DV / 2; ++j) dv[j] = 0.f;
#pragma unroll
      for (int j = 0; j < kN; ++j) sc[j] = 0.f;
      for (int i = 0; i < w.n; ++i) {
        const int s = i % ST, x = i & 1;
        const int qp = a.q_off + w.lo + (i % w.nq) * kTile;   // the tile's first q position
        const uint32_t qt = base + oQ + s * T::kKBytes, gt = base + oG + s * T::kVBytes;
        hopper::mbar_wait(full(s), (i / ST) & 1);
        hopper::fence_regs<kN>(sc);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          hopper::wgmma_ss_n64(sc, Gk::kmajor(base + oK, kTile, kk), Gk::kmajor(qt, kTile, kk),
                               kk > 0);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs<kN>(sc);
        // P^T; P^T times the softcap's chain into the exchange tile x
        if (i >= 2) hopper::mbar_wait(x_empty(x), ((i >> 1) - 1) & 1);
        float* xb = xbuf + x * kTile * kTile;
        const float* ls = lse_s + s * kTile;
        const bool masked = w.k0 + kTile > w.len || (a.causal && w.k0 + kTile - 1 > qp)
                            || (a.window > 0 && w.k0 <= qp + kTile - 1 - a.window);
#pragma unroll
        for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = 8 * j + 2 * t + (e & 1);
            const bool ok = !masked || keep(a, qp + col, e < 2 ? kp0 : kp1, w.len);
            float f;
            const float p = prob(a, sc[4 * j + e] * a.scale, ls[col], ok, &f);
            sc[4 * j + e] = p;
            xb[(4 * j + e) * 128 + tid] = p * f;
          }
        }
        hopper::mbar_arrive(x_full(x));
        take_a(sc, pa);
        hopper::fence_regs<DV / 2>(dv);
        hopper::fence_regs<kTile / 4>(&pa[0][0]);
        hopper::wgmma_fence();
#pragma unroll
        for (int j = 0; j < kTile / 16; ++j) hopper::rs_mma<DV, Gv>(dv, pa[j], gt, j);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs<DV / 2>(dv);
        hopper::fence_regs<kTile / 4>(&pa[0][0]);
        hopper::mbar_arrive(empty(s));
      }
      __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.dv)
                           + ((static_cast<size_t>(w.b) * a.Sk) * a.KV + w.kh) * DV;
      store_rows<DV>(out, static_cast<size_t>(a.KV) * DV, kp0, a.Sk, dv, 1.f, t);
    } else {
      // ---- dP^T = V dO^T, dS^T, dK += dS^T Q
      float dk[D / 2];
      float dp[kN];
      uint32_t da[kTile / 16][4];
#pragma unroll
      for (int j = 0; j < D / 2; ++j) dk[j] = 0.f;
#pragma unroll
      for (int j = 0; j < kN; ++j) dp[j] = 0.f;
      for (int i = 0; i < w.n; ++i) {
        const int s = i % ST, x = i & 1;
        const uint32_t qt = base + oQ + s * T::kKBytes, gt = base + oG + s * T::kVBytes;
        hopper::mbar_wait(full(s), (i / ST) & 1);
        hopper::fence_regs<kN>(dp);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DV / 16; ++kk)
          hopper::wgmma_ss_n64(dp, Gv::kmajor(base + oV, kTile, kk), Gv::kmajor(gt, kTile, kk),
                               kk > 0);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs<kN>(dp);
        hopper::mbar_wait(x_full(x), (i >> 1) & 1);
        const float* xb = xbuf + x * kTile * kTile;
        const float* dl = del_s + s * kTile;
#pragma unroll
        for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = 8 * j + 2 * t + (e & 1);
            dp[4 * j + e] = xb[(4 * j + e) * 128 + tid] * (dp[4 * j + e] - dl[col]);
          }
        }
        hopper::mbar_arrive(x_empty(x));
        take_a(dp, da);
        hopper::fence_regs<D / 2>(dk);
        hopper::fence_regs<kTile / 4>(&da[0][0]);
        hopper::wgmma_fence();
#pragma unroll
        for (int j = 0; j < kTile / 16; ++j) hopper::rs_mma<D, Gk>(dk, da[j], qt, j);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs<D / 2>(dk);
        hopper::fence_regs<kTile / 4>(&da[0][0]);
        hopper::mbar_arrive(empty(s));
      }
      __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.dk)
                           + ((static_cast<size_t>(w.b) * a.Sk) * a.KV + w.kh) * D;
      store_rows<D>(out, static_cast<size_t>(a.KV) * D, kp0, a.Sk, dk, a.scale, t);
    }
  }
}

// ------------------------------------------------------------- 3. dQ
// A block: NWG consumer warpgroups of 64 q rows (the rows of their
// accumulators; columns are keys for S, dP, dS and D for dQ), then the
// producer warpgroup (its first thread the TMA loads).  Blocks run the
// heaviest causal q tiles first.
template <int D, int DV, int NWG>
__global__ void __launch_bounds__((NWG + 1) * 128, 1)
dq_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap,
                const __grid_constant__ CUtensorMap gmap, Args a) {
  using T = Bwd<D, DV>;
  using Gk = typename T::Gk;
  using Gv = typename T::Gv;
  constexpr int ST = T::kQStages;
  constexpr int kN = kTile / 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (hopper::smem_u32(smem_raw) + 1023u) & ~1023u;
  // byte offsets from base: the consumers' Q and dO rows, the K and V
  // stages, the barriers (q in; per stage K in, V in, both free)
  constexpr uint32_t oQ = 0, oG = oQ + NWG * T::kKBytes, oK = oG + NWG * T::kVBytes;
  constexpr uint32_t oV = oK + ST * T::kKBytes, oB = oV + ST * T::kVBytes;
  const uint32_t bars = base + oB;
  const uint32_t q_full = bars;
  auto k_full = [&](int s) { return bars + 8u * (1 + s); };
  auto v_full = [&](int s) { return bars + 8u * (1 + ST + s); };
  auto empty = [&](int s) { return bars + 8u * (1 + 2 * ST + s); };
  const int row0 = (gridDim.x - 1 - blockIdx.x) * NWG * kTile;
  const int h = blockIdx.y, b = blockIdx.z, kh = h / (a.H / a.KV);
  const int len = valid_len(a, b);
  // the keys this block's rows can keep: tiles from `first`, up to `end`
  const int q_lo = a.q_off + row0, q_hi = a.q_off + min(row0 + NWG * kTile, a.Sq) - 1;
  int end = len;
  if (a.causal) end = min(end, q_hi + 1);
  int first = 0;
  if (a.window > 0) first = max(0, q_lo - a.window + 1);
  first = (first / kTile) * kTile;
  const int ntiles = end > first ? (end - first + kTile - 1) / kTile : 0;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < ST; ++s) {
      hopper::mbar_init(k_full(s), 1);
      hopper::mbar_init(v_full(s), 1);
      hopper::mbar_init(empty(s), NWG * 128);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == NWG) {
    // ---- producer
    hopper::regs_dealloc<kProducerRegs>();
    if (threadIdx.x == NWG * 128) {
      hopper::prefetch_map(&qmap);
      hopper::prefetch_map(&kmap);
      hopper::prefetch_map(&vmap);
      hopper::prefetch_map(&gmap);
      hopper::mbar_expect_tx(q_full, NWG * (T::kKBytes + T::kVBytes));
      for (int r = 0; r < NWG; ++r) {
        for (int c = 0; c < Gk::kChunks; ++c)
          hopper::tma_load_4d(base + oQ + r * T::kKBytes + c * kTile * Gk::kSw, &qmap, q_full,
                              c * Gk::kChunk, h, row0 + r * kTile, b);
        for (int c = 0; c < Gv::kChunks; ++c)
          hopper::tma_load_4d(base + oG + r * T::kVBytes + c * kTile * Gv::kSw, &gmap, q_full,
                              c * Gv::kChunk, h, row0 + r * kTile, b);
      }
      for (int it = 0; it < ntiles; ++it) {
        const int s = it % ST, round = it / ST;
        const int k0 = first + it * kTile;
        if (round > 0) hopper::mbar_wait(empty(s), (round - 1) & 1);
        hopper::mbar_expect_tx(k_full(s), T::kKBytes);
        for (int c = 0; c < Gk::kChunks; ++c)
          hopper::tma_load_4d(base + oK + s * T::kKBytes + c * kTile * Gk::kSw, &kmap, k_full(s),
                              c * Gk::kChunk, kh, k0, b);
        hopper::mbar_expect_tx(v_full(s), T::kVBytes);
        for (int c = 0; c < Gv::kChunks; ++c)
          hopper::tma_load_4d(base + oV + s * T::kVBytes + c * kTile * Gv::kSw, &vmap, v_full(s),
                              c * Gv::kChunk, kh, k0, b);
      }
    }
  } else {
    // ---- S = Q K^T, dP = dO V^T, dS, dQ += dS K
    hopper::regs_alloc<consumer_regs<NWG>()>();
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int r0 = row0 + wg * kTile + warp * 16 + g, r1 = r0 + 8;
    const int wq = a.q_off + row0 + wg * kTile;          // this warpgroup's first q position
    const size_t at = (static_cast<size_t>(b) * a.H + h) * a.Sq;
    // a row past Sq: p = 0 (its q and dO arrive as zeros)
    const float l0 = r0 < a.Sq ? a.lse[at + r0] * kLog2e : 1e30f;
    const float l1 = r1 < a.Sq ? a.lse[at + r1] * kLog2e : 1e30f;
    const float d0 = r0 < a.Sq ? a.delta[at + r0] : 0.f;
    const float d1 = r1 < a.Sq ? a.delta[at + r1] : 0.f;
    const uint32_t qt = base + oQ + wg * T::kKBytes, gt = base + oG + wg * T::kVBytes;
    float dq[D / 2];
    float sc[kN], dp[kN];
    uint32_t da[kTile / 16][4];
#pragma unroll
    for (int j = 0; j < D / 2; ++j) dq[j] = 0.f;
#pragma unroll
    for (int j = 0; j < kN; ++j) sc[j] = dp[j] = 0.f;
    hopper::mbar_wait(q_full, 0);
    for (int it = 0; it < ntiles; ++it) {
      const int s = it % ST, ph = (it / ST) & 1;
      const int k0 = first + it * kTile;
      const uint32_t kt = base + oK + s * T::kKBytes, vt = base + oV + s * T::kVBytes;
      hopper::mbar_wait(k_full(s), ph);
      hopper::mbar_wait(v_full(s), ph);
      hopper::fence_regs<kN>(sc);
      hopper::fence_regs<kN>(dp);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hopper::wgmma_ss_n64(sc, Gk::kmajor(qt, kTile, kk), Gk::kmajor(kt, kTile, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < DV / 16; ++kk)
        hopper::wgmma_ss_n64(dp, Gv::kmajor(gt, kTile, kk), Gv::kmajor(vt, kTile, kk), kk > 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs<kN>(sc);
      hopper::fence_regs<kN>(dp);
      const bool masked = k0 + kTile > len || (a.causal && k0 + kTile - 1 > wq)
                          || (a.window > 0 && k0 <= wq + kTile - 1 - a.window);
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = k0 + 8 * j + 2 * t + (e & 1);
          const bool ok = !masked || keep(a, a.q_off + (e < 2 ? r0 : r1), kp, len);
          float f;
          const float p = prob(a, sc[4 * j + e] * a.scale, e < 2 ? l0 : l1, ok, &f);
          sc[4 * j + e] = p * f * (dp[4 * j + e] - (e < 2 ? d0 : d1));
        }
      }
      take_a(sc, da);
      hopper::fence_regs<D / 2>(dq);
      hopper::fence_regs<kTile / 4>(&da[0][0]);
      hopper::wgmma_fence();
#pragma unroll
      for (int j = 0; j < kTile / 16; ++j) hopper::rs_mma<D, Gk>(dq, da[j], kt, j);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs<D / 2>(dq);
      hopper::fence_regs<kTile / 4>(&da[0][0]);
      hopper::mbar_arrive(empty(s));
    }
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.dq)
                         + (static_cast<size_t>(b) * a.Sq * a.H + h) * D;
    store_rows<D>(out, static_cast<size_t>(a.H) * D, r0, a.Sq, dq, a.scale, t);
  }
}

template <int D, int DV>
cudaError_t run_bf16(const Args& a, cudaStream_t s) {
  using T = Bwd<D, DV>;
  constexpr int NWG = T::kQWgs;
  cudaError_t e = launch_delta<__nv_bfloat16>(a, s);
  if (e != cudaSuccess) return e;
  CUtensorMap qm, km, vm, gm;
  if (!hopper::make_map<D>(&qm, a.q, a.H, a.Sq, a.B, kTile)
      || !hopper::make_map<D>(&km, a.k, a.KV, a.Sk, a.B, kTile)
      || !hopper::make_map<DV>(&vm, a.v, a.KV, a.Sk, a.B, kTile)
      || !hopper::make_map<DV>(&gm, a.dout, a.H, a.Sq, a.B, kTile))
    return cudaErrorInvalidValue;
  e = launch(dkdv_wgmma_kernel<D, DV>, dim3((a.Sk + kTile - 1) / kTile, a.KV, a.B), 384,
             T::kKvSmem, s, qm, km, vm, gm, a);
  if (e != cudaSuccess) return e;
  return launch(dq_wgmma_kernel<D, DV, NWG>,
                dim3((a.Sq + NWG * kTile - 1) / (NWG * kTile), a.H, a.B), (NWG + 1) * 128,
                T::kQSmem, s, qm, km, vm, gm, a);
}

// ============================================================= fp32: 3xTF32
// Every product as three mma.sync m16n8k8 of split operands (tf32.cuh),
// accumulating in fp32; operand tiles in shared memory at tf32::pad rows.
// Tiles of a (D, DV) pair:
//   dK/dV: 64 keys a block (K and V staged once), q tiles of kBq rows
//   streamed through a ring of 2 stages (Q, dO, lse, delta by cp.async);
//   dQ: kRows q rows a block (Q and dO staged once), key tiles of kBk
//   keys streamed through a ring of 2 stages (K, V by cp.async).
// The q tile and key tile shrink as the rows widen, so that a block's
// tiles fit the 227 KB of shared memory a block has: at D = 256 a
// dK/dV block's K and V alone take 132 KB.
constexpr int kF32Keys = 64;                 // keys a dK/dV block
constexpr int kF32KvThreads = 256;           // two roles of 4 warps
constexpr int kF32Stages = 2;                // cp.async ring

template <int D, int DV>
struct F32Bwd {
  static constexpr int kLk = tf32::pad(D), kLv = tf32::pad(DV);   // row strides
  // dK/dV: q rows a step; 2 blocks an SM at (64, 64), else 1
  static constexpr int kBq = D + DV >= 512 ? 16 : (D + DV >= 320 || D + DV == 128) ? 32 : 64;
  static constexpr int kKvBlocks = D + DV <= 128 ? 2 : 1;
  // a stage: Q, dO, lse, delta (floats)
  static constexpr int kStage = kBq * (kLk + kLv) + 2 * kBq;
  static constexpr int oK = 0, oV = kF32Keys * kLk, oS = oV + kF32Keys * kLv;
  static constexpr int oX = oS + kF32Stages * kStage;     // the exchange tile
  static constexpr size_t kKvSmem = sizeof(float) * (oX + kF32Keys * kBq);
  // dQ: q rows a block, keys a tile; from D + DV = 320 on, two warps of
  // 16 rows each (kPairQ: one S, one dP, dQ's columns split), else one
  static constexpr int kRows = D + DV == 256 ? 128 : 64;
  static constexpr int kBk = D + DV <= 128 ? 64 : D + DV <= 320 ? 32 : 16;
  static constexpr bool kPairQ = D + DV >= 320;
  static constexpr int kQThreads = (kPairQ ? 4 : 2) * kRows;
  static constexpr int oQ = 0, oG = kRows * kLk, oR = oG + kRows * kLv;
  static constexpr int kTile = kBk * (kLk + kLv);           // a stage: K, V
  static constexpr int oXq = oR + kF32Stages * kTile;       // the pairs' exchange
  static constexpr size_t kQSmem = sizeof(float) * (oXq + (kPairQ ? kRows * kBk : 0));
  static_assert(kKvSmem <= kSmemMax && kQSmem <= kSmemMax, "shared memory");
};

// The q tiles of a dK/dV block (blocks in descending causal cost: the
// first key blocks see the most rows): step i is q head kh * G + i / nq,
// rows lo + (i % nq) * BQ; n = G * nq steps (0 when no key is kept).
template <int BQ>
__device__ __forceinline__ KvWork f32_kv_work(const Args& a) {
  KvWork w;
  int i = blockIdx.x;
  w.k0 = (i / (a.KV * a.B)) * kF32Keys;
  i %= a.KV * a.B;
  w.kh = i % a.KV;
  w.b = i / a.KV;
  w.G = a.H / a.KV;
  w.len = valid_len(a, w.b);
  int lo = 0, hi = a.Sq;
  if (a.causal) lo = max(lo, w.k0 - a.q_off);
  if (a.window > 0) hi = min(hi, w.k0 + kF32Keys - 1 + a.window - a.q_off);
  w.lo = (lo / BQ) * BQ;
  w.nq = (w.k0 < w.len && lo < hi) ? (hi - w.lo + BQ - 1) / BQ : 0;
  w.n = w.G * w.nq;
  return w;
}

// Rows [row0, row0 + n) of head h, batch b of a (B, S, heads, W) fp32
// tensor into shared rows of stride ld, by 16-byte cp.async: thread tid
// copies chunks tid, tid + nthreads, ... (4 floats each, row-major over
// the rows); rows past S arrive as zeros.
template <int W>
__device__ __forceinline__ void f32_stage(float* dst, int ld, const float* src, int b, int row0,
                                          int n, int S, int heads, int h, int nthreads) {
  for (int c = threadIdx.x; c < n * (W / 4); c += nthreads) {
    const int r = c / (W / 4), x = c % (W / 4), row = row0 + r;
    const size_t at = (static_cast<size_t>(b) * S + min(row, S - 1)) * heads + h;
    tf32::cp_async16(hopper::smem_u32(dst + r * ld + 4 * x), src + at * W + 4 * x,
                     row < S ? 16 : 0);
  }
}

// Copies of step i (if any) into its ring slot, then a commit: q rows
// past Sq arrive as zeros (their lse and delta too).
template <int D, int DV>
__device__ __forceinline__ void f32_kv_issue(const Args& a, const KvWork& w, float* sm, int i) {
  using T = F32Bwd<D, DV>;
  constexpr int BQ = T::kBq;
  if (i < w.n) {
    const int h = w.kh * w.G + i / w.nq, q0 = w.lo + (i % w.nq) * BQ;
    float* sq = sm + T::oS + (i % kF32Stages) * T::kStage;
    float* sg = sq + BQ * T::kLk;
    float* sl = sg + BQ * T::kLv;
    f32_stage<D>(sq, T::kLk, static_cast<const float*>(a.q), w.b, q0, BQ, a.Sq, a.H, h,
                 kF32KvThreads);
    f32_stage<DV>(sg, T::kLv, static_cast<const float*>(a.dout), w.b, q0, BQ, a.Sq, a.H, h,
                  kF32KvThreads);
    for (int c = threadIdx.x; c < 2 * BQ; c += kF32KvThreads) {
      const int r = c % BQ, row = q0 + r;
      const size_t at = (static_cast<size_t>(w.b) * a.H + h) * a.Sq + min(row, a.Sq - 1);
      tf32::cp_async4(hopper::smem_u32(sl + c), (c < BQ ? a.lse : a.delta) + at,
                      row < a.Sq ? 4 : 0);
    }
  }
  tf32::cp_async_commit();
}

// S = A B^T over a step, big and small terms apart (tf32::mma3): 16 rows
// of A (`arow` at row g, column 2t; stride la) against 8 NK rows of B
// (`brow` likewise, stride lb), KS columns; the k-steps unrolled by U.
template <int KS, int NK, int U>
__device__ __forceinline__ void f32_scores(float (*s)[4], float (*sl)[4], const float* arow,
                                           int la, const float* brow, int lb) {
#pragma unroll
  for (int n = 0; n < NK; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = sl[n][e] = 0.f;
#pragma unroll (U)
  for (int kk = 0; kk < KS / 8; ++kk) {
    uint32_t ah[4], al[4];
    tf32::load_a(arow, la, kk, ah, al);
#pragma unroll
    for (int n = 0; n < NK; ++n) {
      uint32_t bh[2], bl[2];
      tf32::load_b_rows(brow + n * 8 * lb, kk, bh, bl);
      tf32::mma3(s[n], sl[n], ah, al, bh, bl);
    }
  }
}

// acc (16 rows x 8 NW columns) += C B over one step: C the step's S-like
// accumulator (16 rows x 8 NK, its columns the k index, as A), B read down
// the rows of a tile (`p` at row 2t, column g; row stride ld).  The
// step's sum is taken in a fresh accumulator (3 NK mma deep; mma.sync
// truncates as it accumulates, see Sums above) and added to acc in fp32,
// round to nearest, 8 n-tiles at a time.
template <int NK, int NW>
__device__ __forceinline__ void f32_add_step(float (*acc)[4], const float (*c)[4],
                                             const float* p, int ld) {
  constexpr int CW = NW < 8 ? NW : 8;
#pragma unroll
  for (int j0 = 0; j0 < NW; j0 += CW) {
    float tmp[CW][4];
#pragma unroll
    for (int j = 0; j < CW; ++j) tmp[j][0] = tmp[j][1] = tmp[j][2] = tmp[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      uint32_t ah[4], al[4];
      tf32::c_as_a(c[kk], ah, al);
#pragma unroll
      for (int j = 0; j < CW; ++j) {
        uint32_t bh[2], bl[2];
        tf32::load_b_cols(p + kk * 8 * ld + 8 * (j0 + j), ld, bh, bl);
        tf32::mma3(tmp[j], tmp[j], ah, al, bh, bl);
      }
    }
#pragma unroll
    for (int j = 0; j < CW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j0 + j][e] += tmp[j][e];
  }
}

// One role of a dK/dV block, 4 warps of 16 keys each (warp w: keys k0 +
// 16w + g and + 8).  Role 0: S^T = K (q * scale)^T, P^T, dV += P^T dO;
// role 1: dP^T = V dO^T, dS^T = P^T (dP^T - delta) (P^T times the
// softcap's chain from role 0's warp w, through the exchange tile), dK +=
// dS^T (q * scale).  Each role holds one of the two accumulators, so
// neither holds both (at D = 256 each is 128 registers a thread).  All 8
// warps stage the ring: named barrier 1 (the block) once a step, one
// 64-thread barrier a warp pair (ids 2-5) for the exchange.
template <int ROLE, int D, int DV>
__device__ __forceinline__ void f32_kv_role(const Args& a, const KvWork& w, float* sm) {
  using T = F32Bwd<D, DV>;
  constexpr int BQ = T::kBq, NQ = BQ / 8;
  constexpr int W = ROLE == 0 ? DV : D;              // dV or dK columns
  constexpr int KS = ROLE == 0 ? D : DV;             // S^T or dP^T reduction
  constexpr int LA = ROLE == 0 ? T::kLk : T::kLv;    // K or V rows (A)
  constexpr int LB = ROLE == 0 ? T::kLk : T::kLv;    // Q or dO rows (B of S^T, dP^T)
  constexpr int LW = ROLE == 0 ? T::kLv : T::kLk;    // dO or Q rows (B of dV, dK)
  const int tid = threadIdx.x, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kw = w.k0 + warp * 16;                   // the warp's first key
  const int kp0 = kw + g, kp1 = kp0 + 8;             // this thread's keys
  const float* arow = sm + (ROLE == 0 ? T::oK : T::oV) + (warp * 16 + g) * LA + 2 * t;
  float* xb = sm + T::oX + warp * (BQ / 2) * 32 + lane;
  float acc[W / 8][4];
#pragma unroll
  for (int j = 0; j < W / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int i = 0; i < w.n; ++i) {
    const int q0 = w.lo + (i % w.nq) * BQ;
    float* sq = sm + T::oS + (i % kF32Stages) * T::kStage;
    float* sg = sq + BQ * T::kLk;
    float* sl = sg + BQ * T::kLv;
    const float* sd = sl + BQ;
    // each thread's own copies of step i have landed: q * scale in fp32
    // (the JAX order: scaled before both of its products) and the lse in
    // log2 units, in place, over the chunks f32_stage gave this thread;
    // a row past Sq: p = 0
    tf32::cp_async_wait<kF32Stages - 2>();
    for (int c = tid; c < BQ * (D / 4); c += kF32KvThreads) {
      float4* p = reinterpret_cast<float4*>(sq + (c / (D / 4)) * T::kLk) + c % (D / 4);
      float4 v = *p;
      v.x *= a.scale;
      v.y *= a.scale;
      v.z *= a.scale;
      v.w *= a.scale;
      *p = v;
    }
    for (int r = tid; r < BQ; r += kF32KvThreads)
      sl[r] = q0 + r < a.Sq ? sl[r] * kLog2e : 1e30f;
    hopper::named_sync(1, kF32KvThreads);           // step i in; step i - 1 read
    f32_kv_issue<D, DV>(a, w, sm, i + kF32Stages - 1);
    // the warp's 16 keys against the step's BQ q positions
    const int qp = a.q_off + q0;
    if (kw >= w.len || (a.causal && kw > qp + BQ - 1)
        || (a.window > 0 && kw + 15 <= qp - a.window))
      continue;                                      // all masked: both roles skip
    const bool masked = kw + 16 > w.len || (a.causal && kw + 15 > qp)
                        || (a.window > 0 && kw <= qp + BQ - 1 - a.window);

    // S^T (role 0) or dP^T (role 1): keys x the step's q rows; the
    // k-steps unrolled by 2 only, so that the two roles' code stays in the
    // instruction cache (fully unrolled, dK/dV took 10.7 ms at llama's
    // shape on an H100, not 6.3)
    float s[NQ][4], sl2[NQ][4];
    f32_scores<KS, NQ, 2>(s, sl2, arow, LA, (ROLE == 0 ? sq : sg) + g * LB + 2 * t, LB);
    // lane holds keys g (e = 0, 1) and g + 8 (e = 2, 3) of q columns
    // 8n + 2t (+1)
    if constexpr (ROLE == 0) {
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * n + 2 * t + (e & 1);
          const bool ok = !masked || keep(a, qp + col, e < 2 ? kp0 : kp1, w.len);
          float f;
          const float p = prob(a, s[n][e] + sl2[n][e], sl[col], ok, &f);
          s[n][e] = p;
          xb[(4 * n + e) * 32] = p * f;
        }
      hopper::named_arrive(2 + warp, 64);
    } else {
      hopper::named_sync(2 + warp, 64);
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * n + 2 * t + (e & 1);
          s[n][e] = xb[(4 * n + e) * 32] * ((s[n][e] + sl2[n][e]) - sd[col]);
        }
    }
    // dV += P^T dO (role 0), dK += dS^T (q * scale) (role 1): the q rows
    // are the k index, B read down them; the step's product in a fresh
    // accumulator, added to the running sum in fp32 (f32_add_step)
    const float* wrow = (ROLE == 0 ? sg : sq) + 2 * t * LW + g;
    f32_add_step<NQ, W / 8>(acc, s, wrow, LW);
  }
  tf32::cp_async_wait<0>();
  float* out = static_cast<float*>(ROLE == 0 ? a.dv : a.dk);
  const size_t r0 = (static_cast<size_t>(w.b) * a.Sk + kp0) * a.KV + w.kh;
  const size_t r1 = (static_cast<size_t>(w.b) * a.Sk + kp1) * a.KV + w.kh;
#pragma unroll
  for (int j = 0; j < W / 8; ++j) {
    if (kp0 < a.Sk)
      *reinterpret_cast<float2*>(out + r0 * W + 8 * j + 2 * t) = make_float2(acc[j][0], acc[j][1]);
    if (kp1 < a.Sk)
      *reinterpret_cast<float2*>(out + r1 * W + 8 * j + 2 * t) = make_float2(acc[j][2], acc[j][3]);
  }
}

// ------------------------------------------------------------- 2. dK, dV
// A block: 64 keys of one kv head and batch, warps 0-3 role 0 and 4-7
// role 1 (f32_kv_role); the key blocks heaviest first across heads and
// batches.
template <int D, int DV>
__global__ void __launch_bounds__(kF32KvThreads, F32Bwd<D, DV>::kKvBlocks)
dkdv_tf32_kernel(Args a) {
  using T = F32Bwd<D, DV>;
  extern __shared__ float4 f32_smem_raw[];
  float* sm = reinterpret_cast<float*>(f32_smem_raw);
  const KvWork w = f32_kv_work<T::kBq>(a);
  if (w.n > 0) {
    // K and V of the block's keys (past Sk: zeros), in step 0's group
    f32_stage<D>(sm + T::oK, T::kLk, static_cast<const float*>(a.k), w.b, w.k0, kF32Keys,
                 a.Sk, a.KV, w.kh, kF32KvThreads);
    f32_stage<DV>(sm + T::oV, T::kLv, static_cast<const float*>(a.v), w.b, w.k0, kF32Keys,
                  a.Sk, a.KV, w.kh, kF32KvThreads);
  }
  for (int i = 0; i < kF32Stages - 1; ++i) f32_kv_issue<D, DV>(a, w, sm, i);
  if (threadIdx.x < 128) f32_kv_role<0, D, DV>(a, w, sm);
  else f32_kv_role<1, D, DV>(a, w, sm);
}

// ------------------------------------------------------------- 3. dQ
// The work of a dQ block: kRows q rows of head h from row0 (the q tiles
// heaviest first across heads and batches), over the key tiles its mask
// reaches: ntiles of BK keys from `first`.
struct QWork {
  int row0, h, b, kh, len, first, ntiles;
};

template <int R, int BK>
__device__ __forceinline__ QWork f32_q_work(const Args& a) {
  QWork w;
  int bi = blockIdx.x;
  const int nqt = (a.Sq + R - 1) / R;
  w.row0 = (nqt - 1 - bi / (a.H * a.B)) * R;
  bi %= a.H * a.B;
  w.h = bi % a.H;
  w.b = bi / a.H;
  w.kh = w.h / (a.H / a.KV);
  w.len = valid_len(a, w.b);
  const int q_lo = a.q_off + w.row0, q_hi = a.q_off + min(w.row0 + R, a.Sq) - 1;
  int end = w.len;
  if (a.causal) end = min(end, q_hi + 1);
  int first = 0;
  if (a.window > 0) first = max(0, q_lo - a.window + 1);
  w.first = (first / BK) * BK;
  w.ntiles = end > w.first ? (end - w.first + BK - 1) / BK : 0;
  return w;
}

// Whether 16 rows from q position wq keep no key of the tile at k0 (the
// warp skips it), and whether they keep only some (the mask is applied
// element by element).
template <int BK>
__device__ __forceinline__ bool q_dead(const Args& a, int len, int k0, int wq) {
  return k0 >= len || (a.causal && k0 > wq + 15) || (a.window > 0 && k0 + BK - 1 <= wq - a.window);
}

template <int BK>
__device__ __forceinline__ bool q_masked(const Args& a, int len, int k0, int wq) {
  return k0 + BK > len || (a.causal && k0 + BK - 1 > wq) || (a.window > 0 && k0 <= wq + 15 - a.window);
}


// dq (16 rows x NC columns from C0) times scale into the output
template <int D, int NC>
__device__ __forceinline__ void f32_store_dq(const Args& a, const QWork& w, int r0, int c0,
                                             const float (*dq)[4], int t) {
  float* out = static_cast<float*>(a.dq);
  const int r1 = r0 + 8;
  float* o0 = out + ((static_cast<size_t>(w.b) * a.Sq + r0) * a.H + w.h) * D + c0 + 2 * t;
  float* o1 = out + ((static_cast<size_t>(w.b) * a.Sq + r1) * a.H + w.h) * D + c0 + 2 * t;
#pragma unroll
  for (int j = 0; j < NC / 8; ++j) {
    if (r0 < a.Sq)
      *reinterpret_cast<float2*>(o0 + 8 * j) = make_float2(dq[j][0] * a.scale, dq[j][1] * a.scale);
    if (r1 < a.Sq)
      *reinterpret_cast<float2*>(o1 + 8 * j) = make_float2(dq[j][2] * a.scale, dq[j][3] * a.scale);
  }
}

// A warp of 16 q rows alone (D + DV < 320): S = (q * scale) K^T and dP =
// dO V^T (keys as columns), dS in registers, dQ += dS K (K read down the
// keys).
template <int D, int DV, typename Issue>
__device__ __forceinline__ void f32_q_warp(const Args& a, const QWork& w, float* sm,
                                           const Issue& issue) {
  using T = F32Bwd<D, DV>;
  constexpr int BK = T::kBk, NK = BK / 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = w.row0 + warp * 16 + g, r1 = r0 + 8;
  const size_t at = (static_cast<size_t>(w.b) * a.H + w.h) * a.Sq;
  // a row past Sq: p = 0 (its q and dO are zeros)
  const float l0 = r0 < a.Sq ? a.lse[at + r0] * kLog2e : 1e30f;
  const float l1 = r1 < a.Sq ? a.lse[at + r1] * kLog2e : 1e30f;
  const float d0 = r0 < a.Sq ? a.delta[at + r0] : 0.f;
  const float d1 = r1 < a.Sq ? a.delta[at + r1] : 0.f;
  const int wq = a.q_off + w.row0 + warp * 16;      // the warp's first q position
  const float* qrow = sm + T::oQ + (warp * 16 + g) * T::kLk + 2 * t;
  const float* grow = sm + T::oG + (warp * 16 + g) * T::kLv + 2 * t;
  float dq[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;

  for (int it = 0; it < w.ntiles; ++it) {
    tf32::cp_async_wait<kF32Stages - 2>();
    __syncthreads();                                 // tile it landed; it - 1 read
    issue(it + kF32Stages - 1);
    const int k0 = w.first + it * BK;
    if (q_dead<BK>(a, w.len, k0, wq)) continue;      // the warp's rows keep no key
    const bool masked = q_masked<BK>(a, w.len, k0, wq);
    const float* sk = sm + T::oR + (it % kF32Stages) * T::kTile;
    const float* sv = sk + BK * T::kLk;
    float s[NK][4], sl[NK][4], dp[NK][4], dpl[NK][4];
    f32_scores<D, NK, D / 8>(s, sl, qrow, T::kLk, sk + g * T::kLk + 2 * t, T::kLk);
    f32_scores<DV, NK, DV / 8>(dp, dpl, grow, T::kLv, sv + g * T::kLv + 2 * t, T::kLv);
    // dS = P (dP - delta) times the softcap's chain: lane holds rows g (e
    // = 0, 1) and g + 8 (e = 2, 3) of keys 8n + 2t (+1)
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = k0 + 8 * n + 2 * t + (e & 1);
        const bool ok = !masked || keep(a, a.q_off + (e < 2 ? r0 : r1), kp, w.len);
        float f;
        const float p = prob(a, s[n][e] + sl[n][e], e < 2 ? l0 : l1, ok, &f);
        s[n][e] = p * f * ((dp[n][e] + dpl[n][e]) - (e < 2 ? d0 : d1));
      }
    // dQ += dS K: keys are the k index, K read down them
    f32_add_step<NK, D / 8>(dq, s, sk + 2 * t * T::kLk + g, T::kLk);
  }
  tf32::cp_async_wait<0>();
  f32_store_dq<D, D>(a, w, r0, 0, dq, t);
}

// One of the two warps on 16 q rows (D + DV >= 320, where one warp's S,
// dP and dQ would not fit its registers beside each other): warp rg of
// half 0 runs S = (q * scale) K^T and P (times the softcap's chain) for
// rows 16 rg.., warp rg of half 1 dP = dO V^T and dS = P (dP - delta),
// through an exchange tile (64-thread named barriers 2 + rg: P is in; 6 +
// rg: dS is in); then each adds dS K into its own columns of dQ, DV / 2
// for half 0 and D - DV / 2 for half 1, which evens the two halves' work.
template <int HALF, int D, int DV, typename Issue>
__device__ __forceinline__ void f32_q_half(const Args& a, const QWork& w, float* sm,
                                           const Issue& issue) {
  using T = F32Bwd<D, DV>;
  constexpr int BK = T::kBk, NK = BK / 8, NT = T::kQThreads;
  constexpr int C0 = HALF == 0 ? 0 : DV / 2;          // dQ columns [C0, C0 + NC)
  constexpr int NC = HALF == 0 ? DV / 2 : D - DV / 2;
  constexpr int KS = HALF == 0 ? D : DV;              // S or dP's reduction
  constexpr int LA = HALF == 0 ? T::kLk : T::kLv;     // q or dO rows; K or V rows
  const int rg = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = w.row0 + rg * 16 + g, r1 = r0 + 8;
  const size_t at = (static_cast<size_t>(w.b) * a.H + w.h) * a.Sq;
  float x0, x1;                    // half 0: lse in log2 units; half 1: delta
  if constexpr (HALF == 0) {
    x0 = r0 < a.Sq ? a.lse[at + r0] * kLog2e : 1e30f;
    x1 = r1 < a.Sq ? a.lse[at + r1] * kLog2e : 1e30f;
  } else {
    x0 = r0 < a.Sq ? a.delta[at + r0] : 0.f;
    x1 = r1 < a.Sq ? a.delta[at + r1] : 0.f;
  }
  const int wq = a.q_off + w.row0 + rg * 16;
  const float* arow = sm + (HALF == 0 ? T::oQ : T::oG) + (rg * 16 + g) * LA + 2 * t;
  float* xp = sm + T::oXq + rg * (BK / 2) * 32 + lane;
  float dq[NC / 8][4];
#pragma unroll
  for (int j = 0; j < NC / 8; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;

  for (int it = 0; it < w.ntiles; ++it) {
    tf32::cp_async_wait<kF32Stages - 2>();
    hopper::named_sync(1, NT);                       // tile it landed; it - 1 read
    issue(it + kF32Stages - 1);
    const int k0 = w.first + it * BK;
    if (q_dead<BK>(a, w.len, k0, wq)) continue;      // both halves skip
    const float* sk = sm + T::oR + (it % kF32Stages) * T::kTile;
    const float* b0 = (HALF == 0 ? sk : sk + BK * T::kLk) + g * LA + 2 * t;
    float s[NK][4], sl[NK][4];
    f32_scores<KS, NK, KS / 8>(s, sl, arow, LA, b0, LA);
    if constexpr (HALF == 0) {
      const bool masked = q_masked<BK>(a, w.len, k0, wq);
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = k0 + 8 * n + 2 * t + (e & 1);
          const bool ok = !masked || keep(a, a.q_off + (e < 2 ? r0 : r1), kp, w.len);
          float f;
          xp[(4 * n + e) * 32] = prob(a, s[n][e] + sl[n][e], e < 2 ? x0 : x1, ok, &f) * f;
        }
      hopper::named_arrive(2 + rg, 64);
      hopper::named_sync(6 + rg, 64);
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = xp[(4 * n + e) * 32];
    } else {
      hopper::named_sync(2 + rg, 64);
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] = xp[(4 * n + e) * 32] * ((s[n][e] + sl[n][e]) - (e < 2 ? x0 : x1));
          xp[(4 * n + e) * 32] = s[n][e];
        }
      hopper::named_arrive(6 + rg, 64);
    }
    f32_add_step<NK, NC / 8>(dq, s, sk + 2 * t * T::kLk + g + C0, T::kLk);
  }
  tf32::cp_async_wait<0>();
  f32_store_dq<D, NC>(a, w, r0, C0, dq, t);
}

// A block: Q (times scale) and dO of its kRows rows staged once, the key
// tiles (K, V) through a 2-stage cp.async ring; its warps as above.
template <int D, int DV>
__global__ void __launch_bounds__(F32Bwd<D, DV>::kQThreads, 1) dq_tf32_kernel(Args a) {
  using T = F32Bwd<D, DV>;
  constexpr int R = T::kRows, BK = T::kBk, NT = T::kQThreads;
  extern __shared__ float4 f32_smem_raw[];
  float* sm = reinterpret_cast<float*>(f32_smem_raw);
  const QWork w = f32_q_work<R, BK>(a);
  const int tid = threadIdx.x;

  // key tile `it` into ring slot it % stages; keys past Sk arrive as zeros
  auto issue = [&](int it) {
    if (it < w.ntiles) {
      float* sk = sm + T::oR + (it % kF32Stages) * T::kTile;
      const int k0 = w.first + it * BK;
      f32_stage<D>(sk, T::kLk, static_cast<const float*>(a.k), w.b, k0, BK, a.Sk, a.KV, w.kh,
                   NT);
      f32_stage<DV>(sk + BK * T::kLk, T::kLv, static_cast<const float*>(a.v), w.b, k0, BK,
                    a.Sk, a.KV, w.kh, NT);
    }
    tf32::cp_async_commit();
  };
  for (int i = 0; i < kF32Stages - 1; ++i) issue(i);
  // q * scale in fp32 and dO of the block's rows; rows past Sq are zeros
  const float* q = static_cast<const float*>(a.q);
  const float* go = static_cast<const float*>(a.dout);
  for (int c = tid; c < R * (D / 4); c += NT) {
    const int r = c / (D / 4), x = c % (D / 4), row = w.row0 + r;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < a.Sq) {
      val = reinterpret_cast<const float4*>(
          q + ((static_cast<size_t>(w.b) * a.Sq + row) * a.H + w.h) * D)[x];
      val.x *= a.scale;
      val.y *= a.scale;
      val.z *= a.scale;
      val.w *= a.scale;
    }
    *reinterpret_cast<float4*>(sm + T::oQ + r * T::kLk + 4 * x) = val;
  }
  for (int c = tid; c < R * (DV / 4); c += NT) {
    const int r = c / (DV / 4), x = c % (DV / 4), row = w.row0 + r;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < a.Sq)
      val = reinterpret_cast<const float4*>(
          go + ((static_cast<size_t>(w.b) * a.Sq + row) * a.H + w.h) * DV)[x];
    *reinterpret_cast<float4*>(sm + T::oG + r * T::kLv + 4 * x) = val;
  }
  if constexpr (T::kPairQ) {
    if (tid < NT / 2) f32_q_half<0, D, DV>(a, w, sm, issue);
    else f32_q_half<1, D, DV>(a, w, sm, issue);
  } else {
    f32_q_warp<D, DV>(a, w, sm, issue);
  }
}

template <int D, int DV>
cudaError_t run_fp32(const Args& a, cudaStream_t s) {
  using T = F32Bwd<D, DV>;
  cudaError_t e = launch_delta<float>(a, s);
  if (e != cudaSuccess) return e;
  const unsigned nkb = (a.Sk + kF32Keys - 1) / kF32Keys;
  e = launch(dkdv_tf32_kernel<D, DV>, dim3(nkb * a.KV * a.B), kF32KvThreads, T::kKvSmem, s, a);
  if (e != cudaSuccess) return e;
  const unsigned nqt = (a.Sq + T::kRows - 1) / T::kRows;
  return launch(dq_tf32_kernel<D, DV>, dim3(nqt * a.H * a.B), T::kQThreads, T::kQSmem, s, a);
}

// The head-dim pairs (D, DV) built, in both dtypes: the bf16 forward's
// (csrc/flash_attention.cu's kBf16Pairs).
constexpr int kPairs[][2] = {{16, 16}, {64, 64}, {128, 128}, {256, 256}, {192, 128}};
constexpr int kNumPairs = sizeof(kPairs) / sizeof(kPairs[0]);

// Calls f(integral_constant<D>, integral_constant<DV>) for the built pair
// equal to (D, DV); false if none is.
template <int I = 0, typename F>
bool with_pair(int D, int DV, F&& f) {
  if constexpr (I == kNumPairs) {
    return false;
  } else {
    constexpr int kD = kPairs[I][0], kDV = kPairs[I][1];
    if (D != kD || DV != kDV) return with_pair<I + 1>(D, DV, f);
    f(std::integral_constant<int, kD>{}, std::integral_constant<int, kDV>{});
    return true;
  }
}

}  // namespace

// The built pairs, (D, DV) after (D, DV), into `pairs` (room for 2 * n
// ints); returns how many are built.
extern "C" int flash_attention_bwd_pairs(int* pairs, int n) {
  for (int i = 0; i < kNumPairs && i < n; ++i) {
    pairs[2 * i] = kPairs[i][0];
    pairs[2 * i + 1] = kPairs[i][1];
  }
  return kNumPairs;
}

// dq, dk, dv of flash attention (shapes above); `delta` is a (B, H, Sq)
// fp32 workspace.  dtype 0 fp32, 1 bf16 (16-byte aligned q, k, v, dout:
// TMA); (D, DV) one of kPairs, else cudaErrorInvalidValue.
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const void* lse, void* delta, const void* kv_len, void* dq, void* dk, void* dv, int B,
    int Sq, int Sk, int H, int KV, int D, int DV, int q_off, float scale, int causal,
    int window, float softcap, int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KV <= 0 || H % KV != 0) return cudaErrorInvalidValue;
  const Args a{q, k, v, o, dout, static_cast<const float*>(lse), static_cast<float*>(delta),
               static_cast<const int32_t*>(kv_len), dq, dk, dv, B, Sq, Sk, H, KV, D, DV, q_off,
               scale, causal, window, softcap};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == kBF16) {
    with_pair(D, DV, [&](auto d, auto dv_) {
      err = run_bf16<decltype(d)::value, decltype(dv_)::value>(a, s);
    });
  } else if (dtype == kF32) {
    with_pair(D, DV, [&](auto d, auto dv_) {
      err = run_fp32<decltype(d)::value, decltype(dv_)::value>(a, s);
    });
  }
  return err;
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
