// One-token GQA decode attention, for Hopper (sm_90a): the device code
// shared by the paged kernel (paged_attention.cu) and the dense-cache
// kernel (decode_attention.cu).  Each source keeps its own entry point;
// this header holds the block's work, which differs between the two only
// in where token t of sequence b lives:
//
//   paged: page tab[b][t / page], offset t % page of a (P, page, KV, D) pool;
//   dense: row b, offset t of a (B, S, KV, D) cache (page = S, pg = b).
//
// What bounds it on the H100: bytes.  Each step reads every live row's
// K and V once (B * kv_len * KV * D * 2 elements) against
// 4 * B * H * kv_len * D flops, about 4 * G / (2 * bytes per element)
// flops a byte (G = H / KV = 4 for llama3-8b: 4 flops a byte in bf16),
// far below the ~295 the card needs before compute binds.
//
// Design: one thread block per (kv head, sequence).  The block holds the G
// query heads that share the kv head, so each K/V row is read from device
// memory once for all G heads.  It walks only the sequence's live tokens
// ([kv_len - window, kv_len)), so no clamped or padded position is ever
// read: the index-map clamp the TPU grid needed has no counterpart here.
// Inside the block, each of the 8 warps takes its own tiles of T tokens
// (T * G = 32 (token, head) pairs for G >= 4): a lane holds D/32 elements
// of every query head and of each of the tile's K and V rows in registers
// (all 2T rows are loaded before any is used).  A lane's elements are 32
// apart (d = e * 32 + lane), so each load instruction of a warp reads one
// contiguous span; giving a lane adjacent elements read as one vector made
// bf16 and int8 pages slower on the H100, not faster.  The warp reduces
// the tile's 32 partial dot products in one butterfly that scatters as it
// sums (31 shuffles, after which lane i holds the score of pair i), so
// softmax work is spread over the lanes: one exp per lane and tile for the
// probabilities, per-head tile maxima and sums over 3 more shuffle levels,
// one correction per head and tile.  Each warp keeps its own fp32 online
// softmax (running max and sum per head, (G, D/32) accumulator in
// registers); the warps' states are merged once, through shared memory,
// at the end.  No barrier inside the token loop.  Int8 pages are
// dequantized by their per-page, per-head scale: the K scale multiplies
// the score, the V scale the probability.  Every block is independent:
// nothing carries across blocks, so no second pass is needed.
//
// Occupancy: a llama3-8b step at 8 sequences launches 8 * 8 = 64 blocks
// for 132 SMs.  Splitting a sequence's tokens across blocks (split-K with
// a second merge pass) is the next step for speed, not done here.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNegInit = -1e30f;

// Tile shape for G query heads and EPL head-dim elements per lane.
template <int G, int EPL>
struct Tile {
  static constexpr int kTok = 32 / G < 8 ? 32 / G : 8;
  static constexpr int kPairs = kTok * G;      // (token, head) pairs, <= 32
  static constexpr int kRep = 32 / kPairs;     // lanes that end up holding each pair
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
  int H, KV, D, page, nmax, num_pages;   // dense: page = S, nmax = 1, num_pages = B
  float scale;
  int window;            // <= 0: none
  float softcap;         // <= 0: none
};

// EPL: elements of the head dim per lane (lane holds d = e * 32 + lane).
template <typename QT, typename KT, int G, int EPL, bool kDense>
__device__ __forceinline__ void decode_tiles(const Args& a) {
  using T = Tile<G, EPL>;
  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int D = a.D;
  const int page = a.page;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  const QT* q = static_cast<const QT*>(a.q);
  const KT* kp = static_cast<const KT*>(a.k_pool);
  const KT* vp = static_cast<const KT*>(a.v_pool);
  const size_t q_base = (static_cast<size_t>(b) * a.H + static_cast<size_t>(kh) * G) * D;

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

  const int L = a.kv_len[b];
  const int hi = min(L, a.nmax * page);
  const int lo = a.window > 0 ? max(L - a.window, 0) : 0;
  const int32_t* tab = kDense ? nullptr : a.tab + static_cast<size_t>(b) * a.nmax;
  // the pair this lane holds after the reduction: token jj, head gg
  const int pair = lane / T::kRep;
  const int jj = pair / G;
  const int gg = pair % G;

  for (int t0 = lo + warp * T::kTok; t0 < hi; t0 += kWarps * T::kTok) {
    float kx[T::kTok][EPL], vx[T::kTok][EPL], ksc[T::kTok], vsc[T::kTok];
#pragma unroll
    for (int j = 0; j < T::kTok; ++j) {
      const int t = t0 + j;
      ksc[j] = 1.f;
      vsc[j] = 1.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        kx[j][e] = 0.f;
        vx[j][e] = 0.f;
      }
      if (t < hi) {                             // warp-uniform
        int pg = b;
        if constexpr (!kDense) {
          pg = tab[t / page];
          if (pg < 0 || pg >= a.num_pages) __trap();   // corrupt block table
        }
        const size_t row = ((static_cast<size_t>(pg) * page + t % page) * a.KV + kh) * D;
        if (a.k_scale != nullptr) {
          ksc[j] = a.k_scale[static_cast<size_t>(pg) * a.KV + kh];
          vsc[j] = a.v_scale[static_cast<size_t>(pg) * a.KV + kh];
        }
#pragma unroll
        for (int e = 0; e < EPL; ++e) {
          const int d = e * 32 + lane;
          if (d < D) {
            kx[j][e] = to_f32(kp[row + d]);
            vx[j][e] = to_f32(vp[row + d]);
          }
        }
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
    if (t0 + jj >= hi) s = -INFINITY;
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
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float pv = __shfl_sync(kFull, p, (j * G + g) * T::kRep) * vsc[j];
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] += pv * vx[j][e];
      }
    }
  }

  // merge the warps' softmax states
  extern __shared__ float smem[];
  float* sm_m = smem;                    // kWarps * G
  float* sm_l = sm_m + kWarps * G;       // kWarps * G
  float* sm_acc = sm_l + kWarps * G;     // kWarps * G * D
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
  QT* out = static_cast<QT*>(a.out);
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
    out[q_base + i] = from_f32<QT>(o / fmaxf(lsum, 1e-30f));
  }
}

// The two entry kernels: distinct names, so a profile tells them apart.
template <typename QT, typename KT, int G, int EPL>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(Args a) {
  decode_tiles<QT, KT, G, EPL, false>(a);
}

template <typename QT, typename KT, int G, int EPL>
__global__ void __launch_bounds__(kThreads) dense_decode_kernel(Args a) {
  decode_tiles<QT, KT, G, EPL, true>(a);
}

template <typename QT, typename KT, int G, int EPL, bool kDense>
cudaError_t launch(const Args& a, int B, size_t smem, cudaStream_t stream) {
  void (*kern)(Args);
  if constexpr (kDense) {
    kern = dense_decode_kernel<QT, KT, G, EPL>;
  } else {
    kern = paged_decode_kernel<QT, KT, G, EPL>;
  }
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kern<<<dim3(a.KV, B), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// Only the shapes a port config or a card test reaches are instantiated:
// G = 4, D = 128 (llama3-8b) and G = 2, D = 16 (the reduced configs), and
// their crossings.  Others return cudaErrorInvalidValue until a config
// that needs them is ported with a card test.
template <typename QT, typename KT, int G, bool kDense>
cudaError_t dispatch_dim(const Args& a, int B, size_t smem, cudaStream_t stream) {
  if (a.D <= 32) return launch<QT, KT, G, 1, kDense>(a, B, smem, stream);
  if (a.D <= 128) return launch<QT, KT, G, 4, kDense>(a, B, smem, stream);
  return cudaErrorInvalidValue;
}

template <typename QT, typename KT, bool kDense>
cudaError_t dispatch_group(const Args& a, int B, size_t smem, cudaStream_t stream) {
  switch (a.H / a.KV) {
    case 2: return dispatch_dim<QT, KT, 2, kDense>(a, B, smem, stream);
    case 4: return dispatch_dim<QT, KT, 4, kDense>(a, B, smem, stream);
    default: return cudaErrorInvalidValue;
  }
}

// Checks the shapes the kernels take and launches one block per
// (kv head, sequence) on the given stream.
template <bool kDense>
cudaError_t decode_dispatch(const Args& a, int B, int q_dtype, int kv_dtype,
                            cudaStream_t stream) {
  if (B <= 0 || a.KV <= 0 || a.H % a.KV != 0 || a.D <= 0 || a.page <= 0 || a.nmax <= 0)
    return cudaErrorInvalidValue;
  const int G = a.H / a.KV;
  if ((G != 2 && G != 4) || a.D > 128) return cudaErrorInvalidValue;
  if ((kv_dtype == kI8) != (a.k_scale != nullptr && a.v_scale != nullptr))
    return cudaErrorInvalidValue;
  if (kDense && kv_dtype == kI8) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * kWarps * static_cast<size_t>(G) * (a.D + 2);
  switch (q_dtype * 3 + kv_dtype) {
    case kF32 * 3 + kF32: return dispatch_group<float, float, kDense>(a, B, smem, stream);
    case kF32 * 3 + kBF16: return dispatch_group<float, __nv_bfloat16, kDense>(a, B, smem, stream);
    case kBF16 * 3 + kF32: return dispatch_group<__nv_bfloat16, float, kDense>(a, B, smem, stream);
    case kBF16 * 3 + kBF16:
      return dispatch_group<__nv_bfloat16, __nv_bfloat16, kDense>(a, B, smem, stream);
    case kF32 * 3 + kI8:
      if constexpr (!kDense) return dispatch_group<float, int8_t, kDense>(a, B, smem, stream);
      return cudaErrorInvalidValue;
    case kBF16 * 3 + kI8:
      if constexpr (!kDense) return dispatch_group<__nv_bfloat16, int8_t, kDense>(a, B, smem, stream);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
