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
// fp32: the CUDA cores in fp32, the exact anchor the CPU is held to (TF32
// would not keep 1e-4): the same three launches with tiles of 32 q rows x
// 64 keys staged in shared memory; a warp owns 8 keys (dK/dV) or 4 rows
// (dQ), a lane the columns lane, lane + 32, ... below D (lanes past D = 16
// idle).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <type_traits>

#include "wgmma.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kNegInf = -1e30f;
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

// p = exp(sc - lse) of one raw score (0 where the mask drops the key),
// lse2 in log2 units; *f takes the softcap's chain factor 1 - (sc/cap)^2.
__device__ __forceinline__ float prob(const Args& a, float s, float lse2, bool ok, float* f) {
  float x = s * a.scale;
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
            const float p = prob(a, sc[4 * j + e], ls[col], ok, &f);
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
          const float p = prob(a, sc[4 * j + e], e < 2 ? l0 : l1, ok, &f);
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

// ============================================================= fp32: SIMT
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsQ = 32;              // q rows a tile
constexpr int kKeys = 64;               // keys a tile

// `rows` rows of one head of a (B, S, heads, W) tensor into shared memory
// with row stride LD, times `mul`; rows past S read as zeros.  K and V
// rows take LD = W + 1: lane j reads row j.  Q, do, P and dS rows are read
// by a whole warp at once or along the row: LD = their width.
template <int W, int LD>
__device__ __forceinline__ void stage(float* dst, const float* src, int b, int row0, int rows,
                                      int S, int heads, int h, float mul) {
  for (int i = threadIdx.x; i < rows * W; i += kThreads) {
    const int r = i / W, d = i % W, t = row0 + r;
    float x = 0.f;
    if (t < S) x = src[((static_cast<size_t>(b) * S + t) * heads + h) * W + d] * mul;
    dst[r * LD + d] = x;
  }
}

// Scores, probabilities and score gradients of one (q tile, k tile) pair
// into shared memory: P[i][j] and dS[i][j] (row stride kKeys), from
// qs (pre-scaled), gs (do), ks, vs staged above.  Thread t takes key
// j = t % 64 for rows i = t / 64 + 4 r.
template <int D, int DV>
__device__ __forceinline__ void scores(const Args& a, const float* qs, const float* gs,
                                       const float* ks, const float* vs, const float* lse_s,
                                       const float* del_s, float* ps, float* dss, int q0,
                                       int k0, int len) {
  const int j = threadIdx.x % kKeys, i0 = threadIdx.x / kKeys;
  constexpr int kGroups = kThreads / kKeys;          // 4
  constexpr int kPer = kRowsQ / kGroups;             // 8 rows a thread
  float s[kPer], dp[kPer];
#pragma unroll
  for (int r = 0; r < kPer; ++r) s[r] = dp[r] = 0.f;
  const float* kr = ks + j * (D + 1);
  const float* vr = vs + j * (DV + 1);
  for (int d = 0; d < D; ++d) {
    const float kx = kr[d];
#pragma unroll
    for (int r = 0; r < kPer; ++r) s[r] = fmaf(qs[(i0 + kGroups * r) * D + d], kx, s[r]);
  }
  for (int d = 0; d < DV; ++d) {
    const float vx = vr[d];
#pragma unroll
    for (int r = 0; r < kPer; ++r) dp[r] = fmaf(gs[(i0 + kGroups * r) * DV + d], vx, dp[r]);
  }
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int i = i0 + kGroups * r;
    float sc = s[r];
    if (a.softcap > 0.f) sc = a.softcap * tanhf(sc / a.softcap);
    const bool ok = keep(a, a.q_off + q0 + i, k0 + j, len);
    const float p = expf((ok ? sc : kNegInf) - lse_s[i]);
    float ds = p * (dp[r] - del_s[i]);
    if (a.softcap > 0.f) ds *= 1.f - (sc / a.softcap) * (sc / a.softcap);
    ps[i * kKeys + j] = ok ? p : 0.f;
    dss[i * kKeys + j] = ok ? ds : 0.f;
  }
}

template <int D, int DV>
constexpr size_t simt_smem() {
  // q and do tiles, k and v tiles, P and dS, lse and delta: 213.75 KB at
  // D = DV = 256, one block an SM
  return sizeof(float) * (kRowsQ * D + kRowsQ * DV + kKeys * (D + 1) + kKeys * (DV + 1)
                          + 2 * kRowsQ * kKeys + 2 * kRowsQ);
}

// the stage of q rows [q0, q0 + 32) of head h: q (pre-scaled), do, lse, delta
template <int D, int DV>
__device__ __forceinline__ void stage_rows(const Args& a, float* qs, float* gs, float* lse_s,
                                           float* del_s, int b, int h, int q0) {
  stage<D, D>(qs, static_cast<const float*>(a.q), b, q0, kRowsQ, a.Sq, a.H, h, a.scale);
  stage<DV, DV>(gs, static_cast<const float*>(a.dout), b, q0, kRowsQ, a.Sq, a.H, h, 1.f);
  if (threadIdx.x < kRowsQ) {
    const int i = q0 + threadIdx.x;
    const size_t at = (static_cast<size_t>(b) * a.H + h) * a.Sq + i;
    // a row past Sq: p = exp(-1e30 - 1e30) = 0 and its q and do are 0
    lse_s[threadIdx.x] = i < a.Sq ? a.lse[at] : 1e30f;
    del_s[threadIdx.x] = i < a.Sq ? a.delta[at] : 0.f;
  }
}

// columns a lane owns of a width-W row: lane + 32 e, for e < cols(W)
__host__ __device__ constexpr int cols(int w) { return (w + 31) / 32; }

// ------------------------------------------------------------- 2. dk, dv
template <int D, int DV>
__global__ void __launch_bounds__(kThreads) dkdv_simt_kernel(Args a) {
  extern __shared__ float sm[];
  float* qs = sm;
  float* gs = qs + kRowsQ * D;
  float* ks = gs + kRowsQ * DV;
  float* vs = ks + kKeys * (D + 1);
  float* ps = vs + kKeys * (DV + 1);
  float* dss = ps + kRowsQ * kKeys;
  float* lse_s = dss + kRowsQ * kKeys;
  float* del_s = lse_s + kRowsQ;
  const int k0 = blockIdx.x * kKeys, kh = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.KV;
  const int len = valid_len(a, b);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  constexpr int kKeysPerWarp = kKeys / kWarps;       // 8
  constexpr int kCK = cols(D), kCV = cols(DV);
  float dk[kKeysPerWarp][kCK], dv[kKeysPerWarp][kCV];
#pragma unroll
  for (int jj = 0; jj < kKeysPerWarp; ++jj) {
#pragma unroll
    for (int e = 0; e < kCK; ++e) dk[jj][e] = 0.f;
#pragma unroll
    for (int e = 0; e < kCV; ++e) dv[jj][e] = 0.f;
  }

  // the q rows whose mask can keep a key of this tile: [lo, hi)
  int lo = 0, hi = a.Sq;
  if (a.causal) lo = max(lo, k0 - a.q_off);
  if (a.window > 0) hi = min(hi, k0 + kKeys - 1 + a.window - a.q_off);
  lo = (lo / kRowsQ) * kRowsQ;
  if (k0 < len && lo < hi) {
    stage<D, D + 1>(ks, static_cast<const float*>(a.k), b, k0, kKeys, a.Sk, a.KV, kh, 1.f);
    stage<DV, DV + 1>(vs, static_cast<const float*>(a.v), b, k0, kKeys, a.Sk, a.KV, kh, 1.f);
    for (int h = kh * G; h < (kh + 1) * G; ++h) {
      for (int q0 = lo; q0 < hi; q0 += kRowsQ) {
        __syncthreads();                 // the last pair's tiles are read
        stage_rows<D, DV>(a, qs, gs, lse_s, del_s, b, h, q0);
        __syncthreads();
        scores<D, DV>(a, qs, gs, ks, vs, lse_s, del_s, ps, dss, q0, k0, len);
        __syncthreads();
        for (int i = 0; i < kRowsQ; ++i) {
          float gx[kCV], qx[kCK];
#pragma unroll
          for (int e = 0; e < kCV; ++e)
            gx[e] = e * 32 + lane < DV ? gs[i * DV + e * 32 + lane] : 0.f;
#pragma unroll
          for (int e = 0; e < kCK; ++e)
            qx[e] = e * 32 + lane < D ? qs[i * D + e * 32 + lane] : 0.f;
#pragma unroll
          for (int jj = 0; jj < kKeysPerWarp; ++jj) {
            const int j = warp * kKeysPerWarp + jj;
            const float p = ps[i * kKeys + j], ds = dss[i * kKeys + j];
#pragma unroll
            for (int e = 0; e < kCV; ++e) dv[jj][e] = fmaf(p, gx[e], dv[jj][e]);
#pragma unroll
            for (int e = 0; e < kCK; ++e) dk[jj][e] = fmaf(ds, qx[e], dk[jj][e]);
          }
        }
      }
    }
  }
  float* dko = static_cast<float*>(a.dk);
  float* dvo = static_cast<float*>(a.dv);
#pragma unroll
  for (int jj = 0; jj < kKeysPerWarp; ++jj) {
    const int t = k0 + warp * kKeysPerWarp + jj;
    if (t >= a.Sk) continue;
    const size_t row = (static_cast<size_t>(b) * a.Sk + t) * a.KV + kh;
#pragma unroll
    for (int e = 0; e < kCK; ++e)
      if (e * 32 + lane < D) dko[row * D + e * 32 + lane] = dk[jj][e];
#pragma unroll
    for (int e = 0; e < kCV; ++e)
      if (e * 32 + lane < DV) dvo[row * DV + e * 32 + lane] = dv[jj][e];
  }
}

// ------------------------------------------------------------- 3. dq
template <int D, int DV>
__global__ void __launch_bounds__(kThreads) dq_simt_kernel(Args a) {
  extern __shared__ float sm[];
  float* qs = sm;
  float* gs = qs + kRowsQ * D;
  float* ks = gs + kRowsQ * DV;
  float* vs = ks + kKeys * (D + 1);
  float* ps = vs + kKeys * (DV + 1);
  float* dss = ps + kRowsQ * kKeys;
  float* lse_s = dss + kRowsQ * kKeys;
  float* del_s = lse_s + kRowsQ;
  const int q0 = blockIdx.x * kRowsQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (a.H / a.KV);
  const int len = valid_len(a, b);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  constexpr int kRowsPerWarp = kRowsQ / kWarps;      // 4
  constexpr int kCK = cols(D);
  float dq[kRowsPerWarp][kCK];
#pragma unroll
  for (int ii = 0; ii < kRowsPerWarp; ++ii)
#pragma unroll
    for (int e = 0; e < kCK; ++e) dq[ii][e] = 0.f;

  stage_rows<D, DV>(a, qs, gs, lse_s, del_s, b, h, q0);
  // the keys this q tile's mask can keep: [first, end)
  const int q_lo = a.q_off + q0, q_hi = a.q_off + min(q0 + kRowsQ, a.Sq) - 1;
  int end = len;
  if (a.causal) end = min(end, q_hi + 1);
  int first = 0;
  if (a.window > 0) first = max(0, q_lo - a.window + 1);
  first = (first / kKeys) * kKeys;
  for (int k0 = first; k0 < end; k0 += kKeys) {
    __syncthreads();                     // the last tile's dS is read
    stage<D, D + 1>(ks, static_cast<const float*>(a.k), b, k0, kKeys, a.Sk, a.KV, kh, 1.f);
    stage<DV, DV + 1>(vs, static_cast<const float*>(a.v), b, k0, kKeys, a.Sk, a.KV, kh, 1.f);
    __syncthreads();
    scores<D, DV>(a, qs, gs, ks, vs, lse_s, del_s, ps, dss, q0, k0, len);
    __syncthreads();
    for (int j = 0; j < kKeys; ++j) {
      float kx[kCK];
#pragma unroll
      for (int e = 0; e < kCK; ++e) kx[e] = e * 32 + lane < D ? ks[j * (D + 1) + e * 32 + lane] : 0.f;
#pragma unroll
      for (int ii = 0; ii < kRowsPerWarp; ++ii) {
        const float ds = dss[(warp * kRowsPerWarp + ii) * kKeys + j];
#pragma unroll
        for (int e = 0; e < kCK; ++e) dq[ii][e] = fmaf(ds, kx[e], dq[ii][e]);
      }
    }
  }
  float* dqo = static_cast<float*>(a.dq);
#pragma unroll
  for (int ii = 0; ii < kRowsPerWarp; ++ii) {
    const int i = q0 + warp * kRowsPerWarp + ii;
    if (i >= a.Sq) continue;
    const size_t base = ((static_cast<size_t>(b) * a.Sq + i) * a.H + h) * D;
#pragma unroll
    for (int e = 0; e < kCK; ++e)
      if (e * 32 + lane < D) dqo[base + e * 32 + lane] = dq[ii][e] * a.scale;
  }
}

template <int D, int DV>
cudaError_t run_fp32(const Args& a, cudaStream_t s) {
  cudaError_t e = launch_delta<float>(a, s);
  if (e != cudaSuccess) return e;
  constexpr size_t smem = simt_smem<D, DV>();
  static_assert(smem <= kSmemMax, "shared memory");
  e = launch(dkdv_simt_kernel<D, DV>, dim3((a.Sk + kKeys - 1) / kKeys, a.KV, a.B), kThreads,
             smem, s, a);
  if (e != cudaSuccess) return e;
  return launch(dq_simt_kernel<D, DV>, dim3((a.Sq + kRowsQ - 1) / kRowsQ, a.H, a.B), kThreads,
                smem, s, a);
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
