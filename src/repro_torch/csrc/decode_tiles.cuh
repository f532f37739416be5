// One-token GQA decode attention, for Hopper (sm_90a): the device code
// shared by the paged kernel (paged_attention.cu) and the dense-cache
// kernel (decode_attention.cu).  Each source keeps its own entry point;
// this header holds the blocks' work, which differs between the two only
// in where token t of sequence b lives:
//
//   paged: page tab[b][t / page], offset t % page of a (P, page, KV, D) pool;
//   dense: row b, offset t of a (B, S, KV, D) cache (page = S, pg = b).
//
// Replaces src/repro/kernels/paged_attention.py::paged_decode_attention_pallas
// (paged) and src/repro/kernels/decode_attention.py::decode_attention_pallas
// (dense).
//
// What bounds it on the H100: bytes.  Each step reads every live row's
// K and V once (B * kv_len * KV * D * 2 elements) against
// 4 * B * H * kv_len * D flops, about 4 * G / (2 * bytes per element)
// flops a byte (G = H / KV = 4 for llama3-8b: 4 flops a byte in bf16),
// far below the ~295 the card needs before compute binds.  So the design
// is about keeping enough bytes in flight on every SM.
//
// Design: split-K ("flash-decoding").  The grid is (kv head, sequence,
// split): a sequence's live tokens ([kv_len - window, kv_len)) are cut
// into splits of whole pages (split_len tokens, counted from the page that
// holds the first live token; the wrapper picks the count from shapes
// alone, about four blocks for every SM), so a step of 8 sequences x 8 kv
// heads over 66 pages runs 9 splits, 576 blocks, where one block per
// (kv head, sequence) ran 64 on 132 SMs.  A block holds the G query heads
// that share the kv head, so each K/V row is read from device memory once
// for all G heads, and it reads only live rows: no clamped or padded
// position is ever read.  A block whose split lies outside the live
// tokens writes an empty state and exits.
//
// Inside a block, the split's block-table entries are read once into
// shared memory; then 4 warps stage 32-token units of the split's K and V
// rows (and, for int8 pages, their scales) into shared memory with 16-byte
// cp.async copies through a ring of 3 stages: the copies of the next two
// units are in flight while the warps work on this one.  Rows are padded
// by 16 bytes in shared memory.  A block holds at most 128 registers a
// thread and 53 KB of shared memory (bf16, D = 128): four fit an SM.  Each warp takes one tile of T tokens of
// a unit (T * G = 32 (token, head) pairs for G >= 4): a lane holds D/32
// elements of every query head and of each of the tile's K and V rows in
// registers (a lane's elements are 32 apart, d = e * 32 + lane, so a warp
// reads contiguous spans of a row).  The warp reduces the tile's 32
// partial dot products in one butterfly that scatters as it sums (31
// shuffles, after which lane i holds the score of pair i), so softmax work
// is spread over the lanes: one exp per lane and tile for the
// probabilities, per-head tile maxima and sums over 3 more shuffle levels,
// one correction per head and tile.  Each warp keeps its own fp32 online
// softmax (running max and sum per head, (G, D/32) accumulator in
// registers); the warps' states are merged once, through shared memory,
// at the end.  Int8 pages are dequantized by their per-page, per-head
// scale: the K scale multiplies the score, the V scale the probability.
//
// With one split the block writes the output.  With more, it writes its
// unnormalised state (m, l, acc) to fp32 scratch that the wrapper
// allocates, and a second kernel (*_decode_combine_kernel) merges the
// splits by log-sum-exp in split order: no atomics, so two calls on the
// same inputs give the same bits.  An empty split's state is (-1e30, 0,
// 0), which weighs nothing in the merge and cannot make a NaN.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 3;                 // cp.async ring depth, in units
constexpr int kUnit = 32;                  // tokens a stage: one tile a warp
constexpr int kRowPad = 16;                // bytes after each staged row
constexpr int kCombineThreads = 512;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNegInit = -1e30f;

// Tile shape for G query heads and EPL head-dim elements per lane.
template <int G, int EPL>
struct Tile {
  static constexpr int kTok = 32 / G < 8 ? 32 / G : 8;
  static constexpr int kPairs = kTok * G;      // (token, head) pairs, <= 32
  static constexpr int kRep = 32 / kPairs;     // lanes that end up holding each pair
  static_assert(kTok * kWarps == kUnit, "a unit is one tile for each warp");
};

// One level of a butterfly over the warp that sums n values per lane and
// scatters them: at lane bit o, a lane keeps the half of its values that
// its bit selects and adds its partner's copy of that half.  After the
// levels o = 16 .. 1, v[0] of lane i holds the warp-wide sum of value
// i / (32 / N).
template <int N, int O>
__device__ __forceinline__ void reduce_scatter(float* v, int lane) {
  if constexpr (O >= 1) {
    if constexpr (N > 1) {
      constexpr int H = N / 2;
      const bool up = (lane & O) != 0;
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const float send = up ? v[i] : v[i + H];
        const float keep = up ? v[i + H] : v[i];
        v[i] = keep + __shfl_xor_sync(kFull, send, O);
      }
      reduce_scatter<H, O / 2>(v, lane);
    } else {
      v[0] += __shfl_xor_sync(kFull, v[0], O);
      reduce_scatter<1, O / 2>(v, lane);
    }
  }
}

enum DType { kF32 = 0, kBF16 = 1, kI8 = 2 };

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <> __device__ __forceinline__ float to_f32<int8_t>(int8_t x) {
  return static_cast<float>(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Args {
  const void* q;         // (B, H, D)
  const void* k_pool;    // paged: (P, page, KV, D); dense: (B, S, KV, D)
  const void* v_pool;
  const int32_t* tab;    // paged: (B, nmax); dense: null
  const int32_t* kv_len; // (B,)
  const float* k_scale;  // (P, KV) or null
  const float* v_scale;
  void* out;             // (B, H, D)
  float* partial;        // nsplit > 1: m, l (B, KV, nsplit, G) and acc (.., D)
  int H, KV, D, page, nmax, num_pages;   // dense: page = S, nmax = 1, num_pages = B
  float scale;
  int window;            // <= 0: none
  float softcap;         // <= 0: none
  int nsplit, split_len; // splits a sequence, tokens a split
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}

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

// Shared bytes of one stage: kUnit K rows, kUnit V rows, their scales.
__host__ __device__ __forceinline__ int stage_bytes(int row_bytes) {
  return 2 * kUnit * (row_bytes + kRowPad) + 2 * kUnit * 4;
}

// The token range [*s_lo, *s_hi) of split sp of sequence b.
template <bool kDense>
__device__ __forceinline__ void split_range(const Args& a, int b, int sp, int* s_lo,
                                            int* s_hi) {
  const int L = a.kv_len[b];
  const int hi = min(L, a.nmax * a.page);
  const int lo = a.window > 0 ? max(L - a.window, 0) : 0;
  const int base = kDense ? lo : lo / a.page * a.page;     // whole pages
  *s_lo = max(lo, base + sp * a.split_len);
  *s_hi = min(hi, base + (sp + 1) * a.split_len);
}

// EPL: elements of the head dim per lane (lane holds d = e * 32 + lane).
template <typename QT, typename KT, int G, int EPL, bool kDense>
__device__ __forceinline__ void decode_split(const Args& a) {
  using T = Tile<G, EPL>;
  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int sp = blockIdx.z;
  const int D = a.D;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const size_t q_base = (static_cast<size_t>(b) * a.H + static_cast<size_t>(kh) * G) * D;
  // this block's state in the scratch: row of head 0, then one per head
  const size_t part_row = ((static_cast<size_t>(b) * a.KV + kh) * a.nsplit + sp) * G;
  const size_t part_n = static_cast<size_t>(gridDim.y) * a.KV * a.nsplit * G;

  int s_lo, s_hi;
  split_range<kDense>(a, b, sp, &s_lo, &s_hi);
  if (s_lo >= s_hi) {                         // nothing live: an empty state
    for (int i = threadIdx.x; i < G * D; i += kThreads) {
      if (a.nsplit == 1) {
        static_cast<QT*>(a.out)[q_base + i] = from_f32<QT>(0.f);
      } else {
        a.partial[2 * part_n + part_row * D + i] = 0.f;
        if (i % D == 0) {
          a.partial[part_row + i / D] = kNegInit;
          a.partial[part_n + part_row + i / D] = 0.f;
        }
      }
    }
    return;
  }

  const QT* q = static_cast<const QT*>(a.q);
  const char* kp = static_cast<const char*>(a.k_pool);
  const char* vp = static_cast<const char*>(a.v_pool);
  const int row_bytes = D * static_cast<int>(sizeof(KT));
  const int rs = row_bytes + kRowPad;                 // staged row stride
  const int cpr = row_bytes / 16;                     // 16-byte copies a row
  const int sb = stage_bytes(row_bytes);
  const bool quant = a.k_scale != nullptr;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t smem0 = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  // the split's block-table entries, read once into shared memory (after
  // the staging ring): its pages are [pg0, pg0 + split_len / page)
  int32_t* tab = reinterpret_cast<int32_t*>(smem + kStages * sb);
  const int pg0 = s_lo / a.page;
  if constexpr (!kDense) {
    const int32_t* row_tab = a.tab + static_cast<size_t>(b) * a.nmax;
    const int n = (s_hi - 1) / a.page - pg0 + 1;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const int pg = row_tab[pg0 + i];
      if (pg < 0 || pg >= a.num_pages) __trap();       // corrupt block table
      tab[i] = pg;
    }
    __syncthreads();
  }

  // Issue the copies of unit u of the split into stage slot.  Tokens past
  // the split arrive as zeros (a zero-byte source).
  auto stage = [&](int slot, int u) {
    const int t_base = s_lo + u * kUnit;
    const uint32_t dst0 = smem0 + slot * sb;
    for (int i = threadIdx.x; i < 2 * kUnit * cpr; i += kThreads) {
      const int kv = i / (kUnit * cpr);
      const int r = (i / cpr) % kUnit;
      const int c = i % cpr;
      const int t = t_base + r;
      const uint32_t dst = dst0 + (kv * kUnit + r) * rs + c * 16;
      const char* pool = kv == 0 ? kp : vp;
      if (t < s_hi) {
        int pg = b;
        if constexpr (!kDense) pg = tab[t / a.page - pg0];
        const size_t row = (static_cast<size_t>(pg) * a.page + t % a.page) * a.KV + kh;
        cp_async16(dst, pool + row * row_bytes + c * 16, 16);
      } else {
        cp_async16(dst, pool, 0);
      }
    }
    if (quant && threadIdx.x < 2 * kUnit) {
      const int kv = threadIdx.x / kUnit, r = threadIdx.x % kUnit;
      const int t = t_base + r;
      const float* sc = kv == 0 ? a.k_scale : a.v_scale;
      const uint32_t dst = dst0 + 2 * kUnit * rs + (kv * kUnit + r) * 4;
      if (t < s_hi) {
        const int pg = tab[t / a.page - pg0];
        cp_async4(dst, sc + static_cast<size_t>(pg) * a.KV + kh, 4);
      } else {
        cp_async4(dst, sc, 0);
      }
    }
  };

  float qr[G][EPL];              // pre-scaled queries
  float acc[G][EPL];
  float m[G], l[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInit;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      const int d = e * 32 + lane;
      qr[g][e] = d < D ? to_f32(q[q_base + g * D + d]) * a.scale : 0.f;
      acc[g][e] = 0.f;
    }
  }
  // the pair this lane holds after the reduction: token jj, head gg
  const int pair = lane / T::kRep;
  const int jj = pair / G;
  const int gg = pair % G;

  const int units = (s_hi - s_lo + kUnit - 1) / kUnit;
#pragma unroll
  for (int u = 0; u < kStages - 1; ++u) {
    if (u < units) stage(u, u);
    cp_async_commit();
  }
  for (int u = 0; u < units; ++u) {
    if (u + kStages - 1 < units) stage((u + kStages - 1) % kStages, u + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();                 // unit u has landed
    __syncthreads();
    const int t0 = s_lo + u * kUnit + warp * T::kTok;
    if (t0 < s_hi) {                              // warp-uniform
      const unsigned char* st = smem + (u % kStages) * sb;
      const unsigned char* krow = st + warp * T::kTok * rs;
      const unsigned char* vrow = krow + kUnit * rs;
      const float* ksm = reinterpret_cast<const float*>(st + 2 * kUnit * rs) + warp * T::kTok;
      const float* vsm = ksm + kUnit;
      float kx[T::kTok][EPL], ksc[T::kTok];
#pragma unroll
      for (int j = 0; j < T::kTok; ++j) {
        const KT* kr = reinterpret_cast<const KT*>(krow + j * rs);
        ksc[j] = quant ? ksm[j] : 1.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) {
          const int d = e * 32 + lane;
          kx[j][e] = d < D ? to_f32(kr[d]) : 0.f;
        }
      }
      // scores of the tile's pairs: partial dots, then one scattering sum
      float part[T::kPairs];
#pragma unroll
      for (int j = 0; j < T::kTok; ++j) {
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float sum = 0.f;
#pragma unroll
          for (int e = 0; e < EPL; ++e) sum += qr[g][e] * kx[j][e];
          part[j * G + g] = sum * ksc[j];
        }
      }
      reduce_scatter<T::kPairs, 16>(part, lane);
      float s = part[0];
      if (a.softcap > 0.f) s = a.softcap * tanhf(s / a.softcap);
      if (t0 + jj >= s_hi) s = -INFINITY;
      // per-head maximum and probability sum over the tile's tokens: the
      // lanes of one head differ in the bits above kRep * G
      float tmax = s;
#pragma unroll
      for (int o = T::kRep * G; o < 32; o <<= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(kFull, tmax, o));
      float m_own = m[0];
#pragma unroll
      for (int g = 1; g < G; ++g)
        if (gg == g) m_own = m[g];
      const float mn_own = fmaxf(m_own, tmax);
      const float p = expf(s - mn_own);
      float psum = p;
#pragma unroll
      for (int o = T::kRep * G; o < 32; o <<= 1)
        psum += __shfl_xor_sync(kFull, psum, o);
#pragma unroll
      for (int g = 0; g < G; ++g) {              // lane g * kRep holds (token 0, head g)
        const float mn = __shfl_sync(kFull, mn_own, g * T::kRep);
        const float ps = __shfl_sync(kFull, psum, g * T::kRep);
        const float c = expf(m[g] - mn);
        l[g] = l[g] * c + ps;
        m[g] = mn;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] *= c;
      }
#pragma unroll
      for (int j = 0; j < T::kTok; ++j) {
        const KT* vr = reinterpret_cast<const KT*>(vrow + j * rs);
        float vx[EPL];
#pragma unroll
        for (int e = 0; e < EPL; ++e) {
          const int d = e * 32 + lane;
          vx[e] = d < D ? to_f32(vr[d]) : 0.f;
        }
        const float vsc = quant ? vsm[j] : 1.f;
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float pv = __shfl_sync(kFull, p, (j * G + g) * T::kRep) * vsc;
#pragma unroll
          for (int e = 0; e < EPL; ++e) acc[g][e] += pv * vx[e];
        }
      }
    }
    __syncthreads();                              // the slot may be refilled
  }
  cp_async_wait<0>();

  // merge the warps' softmax states, in the (now idle) staging memory
  float* sm_m = reinterpret_cast<float*>(smem);  // kWarps * G
  float* sm_l = sm_m + kWarps * G;               // kWarps * G
  float* sm_acc = sm_l + kWarps * G;             // kWarps * G * D
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      sm_m[warp * G + g] = m[g];
      sm_l[warp * G + g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      const int d = e * 32 + lane;
      if (d < D) sm_acc[(warp * G + g) * D + d] = acc[g][e];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * D; i += kThreads) {
    const int g = i / D;
    float mx = kNegInit;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w * G + g]);
    float lsum = 0.f, o = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(sm_m[w * G + g] - mx);
      lsum += c * sm_l[w * G + g];
      o += c * sm_acc[w * G * D + i];
    }
    if (a.nsplit == 1) {
      static_cast<QT*>(a.out)[q_base + i] = from_f32<QT>(o / fmaxf(lsum, 1e-30f));
    } else {
      a.partial[2 * part_n + part_row * D + i] = o;
      if (i % D == 0) {
        a.partial[part_row + g] = mx;
        a.partial[part_n + part_row + g] = lsum;
      }
    }
  }
}

// The splits' states of one (kv head, sequence), merged in split order:
// the (m, l) of every split and head are read at once into shared memory,
// each head's weights exp(m - max) and sum follow, then each thread sums
// its output element over the splits.
template <typename QT>
__device__ __forceinline__ void combine_splits(const Args& a, int G) {
  const int kh = blockIdx.x, b = blockIdx.y;
  const int D = a.D, ns = a.nsplit;
  const size_t part_n = static_cast<size_t>(gridDim.y) * a.KV * ns * G;
  const size_t row0 = (static_cast<size_t>(b) * a.KV + kh) * ns * G;
  const size_t q_base = (static_cast<size_t>(b) * a.H + static_cast<size_t>(kh) * G) * D;
  const float* pacc = a.partial + 2 * part_n;
  extern __shared__ float wsm[];        // weights (ns * G), then sums (G)
  float* lsm = wsm + ns * G;
  for (int i = threadIdx.x; i < ns * G; i += blockDim.x) {
    wsm[i] = a.partial[row0 + i];
    lsm[G + i] = a.partial[part_n + row0 + i];
  }
  __syncthreads();
  if (threadIdx.x < G) {
    const int g = threadIdx.x;
    float mx = kNegInit;
    for (int s = 0; s < ns; ++s) mx = fmaxf(mx, wsm[s * G + g]);
    float lsum = 0.f;
    for (int s = 0; s < ns; ++s) {
      const float c = expf(wsm[s * G + g] - mx);
      wsm[s * G + g] = c;
      lsum += c * lsm[G + s * G + g];
    }
    lsm[g] = lsum;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * D; i += blockDim.x) {
    const int g = i / D;
    float o = 0.f;
#pragma unroll 4
    for (int s = 0; s < ns; ++s) o += wsm[s * G + g] * pacc[(row0 + s * G) * D + i];
    static_cast<QT*>(a.out)[q_base + i] = from_f32<QT>(o / fmaxf(lsm[g], 1e-30f));
  }
}

// The entry kernels: distinct names, so a profile tells them apart.
template <typename QT, typename KT, int G, int EPL>
__global__ void __launch_bounds__(kThreads, 4) paged_decode_kernel(Args a) {
  decode_split<QT, KT, G, EPL, false>(a);
}

template <typename QT, typename KT, int G, int EPL>
__global__ void __launch_bounds__(kThreads, 4) dense_decode_kernel(Args a) {
  decode_split<QT, KT, G, EPL, true>(a);
}

template <typename QT>
__global__ void __launch_bounds__(kCombineThreads) paged_decode_combine_kernel(Args a, int G) {
  combine_splits<QT>(a, G);
}

template <typename QT>
__global__ void __launch_bounds__(kCombineThreads) dense_decode_combine_kernel(Args a, int G) {
  combine_splits<QT>(a, G);
}

template <typename QT, typename KT, int G, int EPL, bool kDense>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  void (*kern)(Args);
  void (*merge)(Args, int);
  if constexpr (kDense) {
    kern = dense_decode_kernel<QT, KT, G, EPL>;
    merge = dense_decode_combine_kernel<QT>;
  } else {
    kern = paged_decode_kernel<QT, KT, G, EPL>;
    merge = paged_decode_combine_kernel<QT>;
  }
  // the ring, then the split's table entries
  const size_t ring = static_cast<size_t>(kStages) * stage_bytes(a.D * sizeof(KT))
                      + sizeof(int32_t) * (a.split_len / a.page + 1);
  const size_t merge_bytes = sizeof(float) * kWarps * G * (a.D + 2);
  const size_t smem = ring > merge_bytes ? ring : merge_bytes;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kern<<<dim3(a.KV, B, a.nsplit), kThreads, smem, stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || a.nsplit == 1) return e;
  const size_t merge_smem = sizeof(float) * (2 * static_cast<size_t>(a.nsplit) * G + G);
  if (merge_smem > 48 * 1024) return cudaErrorInvalidValue;
  merge<<<dim3(a.KV, B), kCombineThreads, merge_smem, stream>>>(a, G);
  return cudaGetLastError();
}

// Only the shapes a port config or a card test reaches are instantiated:
// G = 4, D = 128 (llama3-8b) and G = 2, D = 16 (the reduced configs), and
// their crossings.  Others return cudaErrorInvalidValue until a config
// that needs them is ported with a card test.
template <typename QT, typename KT, int G, bool kDense>
cudaError_t dispatch_dim(const Args& a, int B, cudaStream_t stream) {
  if ((a.D * static_cast<int>(sizeof(KT))) % 16 != 0) return cudaErrorInvalidValue;
  if (a.D <= 32) return launch<QT, KT, G, 1, kDense>(a, B, stream);
  if (a.D <= 128) return launch<QT, KT, G, 4, kDense>(a, B, stream);
  return cudaErrorInvalidValue;
}

template <typename QT, typename KT, bool kDense>
cudaError_t dispatch_group(const Args& a, int B, cudaStream_t stream) {
  switch (a.H / a.KV) {
    case 2: return dispatch_dim<QT, KT, 2, kDense>(a, B, stream);
    case 4: return dispatch_dim<QT, KT, 4, kDense>(a, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

// Checks the shapes the kernels take and launches the split blocks, then
// (with more than one split) the merge, on the given stream.
template <bool kDense>
cudaError_t decode_dispatch(const Args& a, int B, int q_dtype, int kv_dtype,
                            cudaStream_t stream) {
  if (B <= 0 || a.KV <= 0 || a.H % a.KV != 0 || a.D <= 0 || a.page <= 0 || a.nmax <= 0)
    return cudaErrorInvalidValue;
  if (a.nsplit <= 0 || a.split_len <= 0 || (a.nsplit > 1 && a.partial == nullptr))
    return cudaErrorInvalidValue;
  if (!kDense && a.split_len % a.page != 0) return cudaErrorInvalidValue;
  const int G = a.H / a.KV;
  if ((G != 2 && G != 4) || a.D > 128) return cudaErrorInvalidValue;
  if ((kv_dtype == kI8) != (a.k_scale != nullptr && a.v_scale != nullptr))
    return cudaErrorInvalidValue;
  if (kDense && kv_dtype == kI8) return cudaErrorInvalidValue;
  switch (q_dtype * 3 + kv_dtype) {
    case kF32 * 3 + kF32: return dispatch_group<float, float, kDense>(a, B, stream);
    case kF32 * 3 + kBF16: return dispatch_group<float, __nv_bfloat16, kDense>(a, B, stream);
    case kBF16 * 3 + kF32: return dispatch_group<__nv_bfloat16, float, kDense>(a, B, stream);
    case kBF16 * 3 + kBF16:
      return dispatch_group<__nv_bfloat16, __nv_bfloat16, kDense>(a, B, stream);
    case kF32 * 3 + kI8:
      if constexpr (!kDense) return dispatch_group<float, int8_t, kDense>(a, B, stream);
      return cudaErrorInvalidValue;
    case kBF16 * 3 + kI8:
      if constexpr (!kDense) return dispatch_group<__nv_bfloat16, int8_t, kDense>(a, B, stream);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The launch shape of both decode kernels: warps a block, staging ring
// stages, tokens a stage (for reports; no launch).
extern "C" void decode_launch_shape(int* info) {
  info[0] = kWarps;
  info[1] = kStages;
  info[2] = kUnit;
}
