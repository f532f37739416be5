// RMSNorm, alone or fused with the residual add before it, for Hopper
// (sm_90a).
//
// Replaces src/repro/kernels/rmsnorm.py::rmsnorm_pallas.
//
//   rmsnorm:      y = x * rsqrt(mean(x^2) + eps) * w
//   add_rmsnorm:  s = x + r (rounded to x's type), y = rmsnorm(s)
//
// What bounds it: bytes, and at a decode step's 8 rows the launch.  A row
// is one fp32 reduction and one elementwise pass, about 4 flops an element
// against 4-10 bytes, so the floor is reading x (and r) and w once and
// writing y (and s) once.  A transformer layer adds each sublayer's output
// to the residual stream right before the next norm; doing the add here
// saves that add's launch and its trip through memory (64 of a forward's
// 65 norms follow an add).  Design: one block a row, every element held in
// registers (16-byte vector loads, one a thread up to 1024 threads, at
// most 2), so x, r and w are read once; the weight loads are issued first, s is
// stored as soon as it is formed (before the reduction), and the reduction
// is fp32: a warp butterfly, one shared-memory step, a second butterfly.  s rounds to x's type before it
// is squared, as the eager `x + r` then the norm does, so s is bit-equal
// to `x + r` and y follows from it.  Built as a plain C library (ctypes):
// the launch is one foreign call, cheaper on the host than a Triton launch.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxVecs = 2;   // vectors a thread holds: few registers, so
                              // two blocks of 512 fit an SM

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <> __device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half(v);
}

template <typename T, int N>
struct alignas(sizeof(T) * N) Pack {
  T v[N];
};

// a pack of 16 or 32 bytes moves as 128-bit accesses, a smaller one as is
template <typename P>
__device__ __forceinline__ P load(const P* p) {
  P out;
  if constexpr (sizeof(P) % 16 == 0) {
#pragma unroll
    for (int i = 0; i < static_cast<int>(sizeof(P) / 16); ++i)
      reinterpret_cast<uint4*>(&out)[i] = reinterpret_cast<const uint4*>(p)[i];
  } else {
    out = *p;
  }
  return out;
}

template <typename P>
__device__ __forceinline__ void store(P* p, const P& v) {
  if constexpr (sizeof(P) % 16 == 0) {
#pragma unroll
    for (int i = 0; i < static_cast<int>(sizeof(P) / 16); ++i)
      reinterpret_cast<uint4*>(p)[i] = reinterpret_cast<const uint4*>(&v)[i];
  } else {
    *p = v;
  }
}

// kVec elements of T a vector (16 bytes, or 1 where rows are not aligned)
template <typename T, typename W, bool kResidual, int kVec>
__global__ void __launch_bounds__(kMaxThreads)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ r,
               const W* __restrict__ w, T* __restrict__ s_out, T* __restrict__ y,
               int d, float eps) {
  using VT = Pack<T, kVec>;
  using VW = Pack<W, kVec>;
  const int nvec = d / kVec;
  const size_t row = static_cast<size_t>(blockIdx.x) * d;
  const VT* xv = reinterpret_cast<const VT*>(x + row);
  const VW* wv = reinterpret_cast<const VW*>(w);

  VW wr[kMaxVecs];
#pragma unroll
  for (int i = 0; i < kMaxVecs; ++i) {
    const int v = threadIdx.x + i * blockDim.x;
    if (v < nvec) wr[i] = load(wv + v);
  }
  float sv[kMaxVecs][kVec];
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxVecs; ++i) {
    const int v = threadIdx.x + i * blockDim.x;
    if (v < nvec) {
      const VT a = load(xv + v);
      if constexpr (kResidual) {
        const VT b = load(reinterpret_cast<const VT*>(r + row) + v);
        VT sum;
#pragma unroll
        for (int e = 0; e < kVec; ++e) sum.v[e] = from_f<T>(to_f(a.v[e]) + to_f(b.v[e]));
        store(reinterpret_cast<VT*>(s_out + row) + v, sum);
#pragma unroll
        for (int e = 0; e < kVec; ++e) sv[i][e] = to_f(sum.v[e]);
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) sv[i][e] = to_f(a.v[e]);
      }
#pragma unroll
      for (int e = 0; e < kVec; ++e) sq = fmaf(sv[i][e], sv[i][e], sq);
    }
  }

  // warp sums, then every warp sums the warps' sums: one barrier, and the
  // same order (so the same bits) in every thread
  __shared__ float red[kMaxThreads / 32];
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, off);
  if (lane == 0) red[threadIdx.x >> 5] = sq;
  __syncthreads();
  float total = lane < static_cast<int>(blockDim.x >> 5) ? red[lane] : 0.f;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) total += __shfl_xor_sync(0xffffffffu, total, off);
  const float inv = rsqrtf(total / d + eps);

#pragma unroll
  for (int i = 0; i < kMaxVecs; ++i) {
    const int v = threadIdx.x + i * blockDim.x;
    if (v < nvec) {
      VT out;
#pragma unroll
      for (int e = 0; e < kVec; ++e) out.v[e] = from_f<T>(sv[i][e] * inv * to_f(wr[i].v[e]));
      store(reinterpret_cast<VT*>(y + row) + v, out);
    }
  }
}

template <typename T, typename W, bool kResidual, int kVec>
cudaError_t launch(const void* x, const void* r, const void* w, void* s, void* y,
                   int rows, int d, float eps, cudaStream_t stream) {
  const int nvec = d / kVec;
  // a vector a thread where a row allows it: the shortest chain of loads
  int threads = (nvec + 31) / 32 * 32;
  threads = threads < 32 ? 32 : (threads > kMaxThreads ? kMaxThreads : threads);
  if ((nvec + threads - 1) / threads > kMaxVecs) return cudaErrorInvalidValue;
  rmsnorm_kernel<T, W, kResidual, kVec><<<rows, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(r), static_cast<const W*>(w),
      static_cast<T*>(s), static_cast<T*>(y), d, eps);
  return cudaGetLastError();
}

template <typename T, typename W, bool kResidual>
cudaError_t pick_vec(const void* x, const void* r, const void* w, void* s, void* y,
                     int rows, int d, float eps, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  uintptr_t bits = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y) |
                   reinterpret_cast<uintptr_t>(r) | reinterpret_cast<uintptr_t>(s);
  const bool vec = d % kVec == 0 && bits % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % (sizeof(W) * kVec) == 0;
  return vec ? launch<T, W, kResidual, kVec>(x, r, w, s, y, rows, d, eps, stream)
             : launch<T, W, kResidual, 1>(x, r, w, s, y, rows, d, eps, stream);
}

template <typename T, typename W>
cudaError_t pick_residual(const void* x, const void* r, const void* w, void* s, void* y,
                          int rows, int d, float eps, cudaStream_t stream) {
  return r != nullptr ? pick_vec<T, W, true>(x, r, w, s, y, rows, d, eps, stream)
                      : pick_vec<T, W, false>(x, r, w, s, y, rows, d, eps, stream);
}

template <typename T>
cudaError_t pick_weight(int wdtype, int dtype, const void* x, const void* r, const void* w,
                        void* s, void* y, int rows, int d, float eps, cudaStream_t stream) {
  if (wdtype == 0) return pick_residual<T, float>(x, r, w, s, y, rows, d, eps, stream);
  if (wdtype != dtype) return cudaErrorInvalidValue;
  return pick_residual<T, T>(x, r, w, s, y, rows, d, eps, stream);
}

}  // namespace

// x (rows, d) and, for the fused form, r (rows, d) of type dtype (0 fp32,
// 1 bf16, 2 fp16); w (d,) of type wdtype (fp32 or dtype) -> y (rows, d)
// and, for the fused form, s = x + r.  r == s == nullptr: plain rmsnorm.
extern "C" int rmsnorm_launch(const void* x, const void* r, const void* w, void* s,
                              void* y, int rows, int d, float eps, int dtype,
                              int wdtype, void* stream) {
  if (rows <= 0 || d <= 0 || (r == nullptr) != (s == nullptr)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return pick_weight<float>(wdtype, dtype, x, r, w, s, y, rows, d, eps, st);
    case 1: return pick_weight<__nv_bfloat16>(wdtype, dtype, x, r, w, s, y, rows, d, eps, st);
    case 2: return pick_weight<__half>(wdtype, dtype, x, r, w, s, y, rows, d, eps, st);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
