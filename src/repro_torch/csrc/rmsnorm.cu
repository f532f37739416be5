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
// most 2, or 4 where a row needs them), so x, r and w are read once; the
// weight loads are issued first, s is
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
// vectors a thread holds: 2, few registers, so two blocks of 512 fit an
// SM; 4 only for rows that 1024 threads of 2 do not hold (jamba's Mamba
// gate norm over d_inner 16384 in fp32)
constexpr int kMaxVecs = 4;

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
template <typename T, typename W, bool kResidual, int kVec, int kVecs>
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

  VW wr[kVecs];
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int v = threadIdx.x + i * blockDim.x;
    if (v < nvec) wr[i] = load(wv + v);
  }
  float sv[kVecs][kVec];
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
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
  for (int i = 0; i < kVecs; ++i) {
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
  const int vecs = (nvec + threads - 1) / threads;
  if (vecs > kMaxVecs) return cudaErrorInvalidValue;
  if (vecs <= 2) {
    rmsnorm_kernel<T, W, kResidual, kVec, 2><<<rows, threads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(r), static_cast<const W*>(w),
        static_cast<T*>(s), static_cast<T*>(y), d, eps);
  } else {
    rmsnorm_kernel<T, W, kResidual, kVec, kMaxVecs><<<rows, threads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(r), static_cast<const W*>(w),
        static_cast<T*>(s), static_cast<T*>(y), d, eps);
  }
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

// ------------------------------------------------------------- backward
//
// y = s * inv * w with inv = rsqrt(mean(s^2) + eps) and s = x (plain) or
// x + r (fused, rounded to x's type: the saved forward output).  With
// g = dy * w in fp32:
//   ds = inv * g - s * inv^3 * mean(g * s)     (+ the stream's own gradient
//                                               ds_in for the fused form)
//   dw = sum over rows of dy * s * inv
// dx = ds (and dr = ds for the fused form), rounded once to x's type.  It
// reads s, dy (and ds_in) and writes dx: bytes bound, as the forward.  A
// block takes rows blockIdx.x, + gridDim.x, ...: for each it sums s^2 and
// g * s (pass 1), then reads the row again (from L1/L2) for ds (pass 2),
// so no width is too wide for its registers; each thread keeps the dw
// partial of its columns in registers across its rows, and writes it as
// the block's fp32 partial row.  A second kernel sums the partials of a
// column in block order, so dw's bits do not depend on scheduling; dw
// stays fp32 (the caller rounds it to w's type, if at all, once).
constexpr int kBwdThreads = 256;

template <typename T, typename W, int kCols>
__global__ void __launch_bounds__(kBwdThreads)
rmsnorm_bwd_kernel(const T* __restrict__ s, const T* __restrict__ dy,
                   const T* __restrict__ ds_in, const W* __restrict__ w,
                   T* __restrict__ dx, float* __restrict__ partial, int rows, int d,
                   float eps) {
  float dw[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) dw[c] = 0.f;
  __shared__ float red[2][kBwdThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    const size_t base = static_cast<size_t>(row) * d;
    float ss = 0.f, gs = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = threadIdx.x + c * kBwdThreads;
      if (col < d) {
        const float sv = to_f(s[base + col]);
        const float g = to_f(dy[base + col]) * to_f(w[col]);
        ss = fmaf(sv, sv, ss);
        gs = fmaf(g, sv, gs);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
      gs += __shfl_xor_sync(0xffffffffu, gs, off);
    }
    __syncthreads();                    // the last row's sums are read
    if (lane == 0) {
      red[0][warp] = ss;
      red[1][warp] = gs;
    }
    __syncthreads();
    ss = lane < kBwdThreads / 32 ? red[0][lane] : 0.f;
    gs = lane < kBwdThreads / 32 ? red[1][lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
      gs += __shfl_xor_sync(0xffffffffu, gs, off);
    }
    const float inv = rsqrtf(ss / d + eps);
    const float corr = inv * inv * inv * (gs / d);
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = threadIdx.x + c * kBwdThreads;
      if (col < d) {
        const float sv = to_f(s[base + col]);
        const float dyv = to_f(dy[base + col]);
        float g = inv * dyv * to_f(w[col]) - sv * corr;
        if (ds_in != nullptr) g += to_f(ds_in[base + col]);
        dx[base + col] = from_f<T>(g);
        dw[c] = fmaf(dyv * sv, inv, dw[c]);
      }
    }
  }
  float* part = partial + static_cast<size_t>(blockIdx.x) * d;
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const int col = threadIdx.x + c * kBwdThreads;
    if (col < d) part[col] = dw[c];
  }
}

__global__ void rmsnorm_dw_kernel(const float* __restrict__ partial, float* __restrict__ dw,
                                  int blocks, int d) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= d) return;
  float acc = 0.f;
  for (int b = 0; b < blocks; ++b) acc += partial[static_cast<size_t>(b) * d + col];
  dw[col] = acc;
}

template <typename T, typename W>
cudaError_t bwd_launch(const void* s, const void* dy, const void* ds_in, const void* w,
                       void* dx, void* dw, void* partial, int blocks, int rows, int d,
                       float eps, cudaStream_t st) {
  const int cols = (d + kBwdThreads - 1) / kBwdThreads;
  const T* sp = static_cast<const T*>(s);
  const T* dyp = static_cast<const T*>(dy);
  const T* dsp = static_cast<const T*>(ds_in);
  const W* wp = static_cast<const W*>(w);
  T* dxp = static_cast<T*>(dx);
  float* pp = static_cast<float*>(partial);
  if (cols <= 4)
    rmsnorm_bwd_kernel<T, W, 4><<<blocks, kBwdThreads, 0, st>>>(sp, dyp, dsp, wp, dxp, pp,
                                                                 rows, d, eps);
  else if (cols <= 16)
    rmsnorm_bwd_kernel<T, W, 16><<<blocks, kBwdThreads, 0, st>>>(sp, dyp, dsp, wp, dxp, pp,
                                                                  rows, d, eps);
  else if (cols <= 64)
    rmsnorm_bwd_kernel<T, W, 64><<<blocks, kBwdThreads, 0, st>>>(sp, dyp, dsp, wp, dxp, pp,
                                                                  rows, d, eps);
  else if (cols <= 128)     // the forward's widest rows: 32768 in bf16
    rmsnorm_bwd_kernel<T, W, 128><<<blocks, kBwdThreads, 0, st>>>(sp, dyp, dsp, wp, dxp, pp,
                                                                   rows, d, eps);
  else
    return cudaErrorInvalidValue;
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  rmsnorm_dw_kernel<<<(d + 255) / 256, 256, 0, st>>>(pp, static_cast<float*>(dw), blocks, d);
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd_weight(int wdtype, int dtype, const void* s, const void* dy, const void* ds_in,
                       const void* w, void* dx, void* dw, void* partial, int blocks, int rows,
                       int d, float eps, cudaStream_t st) {
  if (wdtype == 0)
    return bwd_launch<T, float>(s, dy, ds_in, w, dx, dw, partial, blocks, rows, d, eps, st);
  if (wdtype != dtype) return cudaErrorInvalidValue;
  return bwd_launch<T, T>(s, dy, ds_in, w, dx, dw, partial, blocks, rows, d, eps, st);
}

}  // namespace

// The backward pass of both forms: s (rows, d) the norm's input (the fused
// form's saved sum), dy (rows, d) the gradient of y, ds_in (rows, d) the
// gradient of the fused form's s output or null; w (d,).  Writes dx (rows,
// d; equal to dr for the fused form) and dw (d,) in fp32, through
// `partial`, an fp32 (blocks, d) workspace; blocks <= rows.  d up to
// 32768 (128 columns a thread), every width the forward takes.
extern "C" int rmsnorm_bwd_launch(const void* s, const void* dy, const void* ds_in,
                                  const void* w, void* dx, void* dw, void* partial,
                                  int blocks, int rows, int d, float eps, int dtype,
                                  int wdtype, void* stream) {
  if (rows <= 0 || d <= 0 || blocks <= 0 || blocks > rows) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return bwd_weight<float>(wdtype, dtype, s, dy, ds_in, w, dx, dw, partial, blocks,
                                     rows, d, eps, st);
    case 1: return bwd_weight<__nv_bfloat16>(wdtype, dtype, s, dy, ds_in, w, dx, dw, partial,
                                             blocks, rows, d, eps, st);
    case 2: return bwd_weight<__half>(wdtype, dtype, s, dy, ds_in, w, dx, dw, partial, blocks,
                                      rows, d, eps, st);
    default: return cudaErrorInvalidValue;
  }
}

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
