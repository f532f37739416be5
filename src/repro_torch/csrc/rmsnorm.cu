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
// reads s, dy (and ds_in) and writes dx, each once: bytes bound, as the
// forward (at the fused bf16 (8192, 4096) shape, 268 MB, 0.080 ms).
//
// Design: one pass.  A persistent block (a few an SM, as many as the
// card holds at once) walks rows blockIdx.x, + gridDim.x, ...; its
// threads own the same columns on every row (vectors of 8 elements, 16 or
// 32 bytes in 16-byte loads, in every dtype, so the fp32 kernel on a
// 16-bit row's upcast values forms the same sums bit for bit), so each
// thread loads its w once and keeps its dw partial in registers across
// the rows.  A row's s, dy and ds_in are loaded into registers at once
// (bytes in flight: 24 KB a row at the fused bf16 shape, times the blocks
// an SM), both sums reduced with one barrier (the warps' sums go to one
// of two shared slots by row parity), and dx formed from the registers:
// HBM sees each byte once.  Rows wider than a block of 512 holds in two
// vectors a thread (over 8192 elements, up to the forward's widest,
// 32768) run with 1024 threads of 2 vectors (4 over 16384; in fp32 those
// spill, and only the fp32 reference of a 16-bit row that wide takes
// them): s and dy stay in registers, w and ds_in are read where they are
// used, and the dw partial sits in shared memory.  Each block writes its
// fp32 dw partial row; a column kernel sums the partials of 32 columns a
// block in a fixed tree (8 strided slices, then halving), so dw's bits do
// not depend on scheduling; dw stays fp32 (the caller rounds it to w's
// type, if at all, once).
constexpr int kBwdThreads = 512;         // two vectors a thread
constexpr int kBwdWideThreads = 1024;    // up to four
constexpr int kDwCols = 32, kDwSlices = 8;

template <typename T, typename W, int kVec, int kVecs, bool kWide>
__global__ void __launch_bounds__(kWide ? kBwdWideThreads : kBwdThreads)
rmsnorm_bwd_kernel(const T* __restrict__ s, const T* __restrict__ dy,
                   const T* __restrict__ ds_in, const W* __restrict__ w,
                   T* __restrict__ dx, float* __restrict__ partial, int rows, int d,
                   float eps) {
  using VT = Pack<T, kVec>;
  using VW = Pack<W, kVec>;
  using VF = Pack<float, kVec>;
  extern __shared__ float dw_smem[];                 // wide: d floats
  __shared__ float red[2][2][kBwdWideThreads / 32];  // [row parity][sum][warp]
  const int nvec = d / kVec;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const VW* wv = reinterpret_cast<const VW*>(w);
  VW wr[kWide ? 1 : kVecs];
  float dw[kWide ? 1 : kVecs][kVec];
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int v = threadIdx.x + i * blockDim.x;
    if (v >= nvec) continue;
    if constexpr (kWide) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) dw_smem[v * kVec + e] = 0.f;
    } else {
      wr[i] = load(wv + v);
#pragma unroll
      for (int e = 0; e < kVec; ++e) dw[i][e] = 0.f;
    }
  }
  int parity = 0;
  for (int row = blockIdx.x; row < rows; row += gridDim.x, parity ^= 1) {
    const size_t base = static_cast<size_t>(row) * d;
    const VT* sv = reinterpret_cast<const VT*>(s + base);
    const VT* gv = reinterpret_cast<const VT*>(dy + base);
    const VT* dv = reinterpret_cast<const VT*>(ds_in + base);
    VT sr[kVecs], gr[kVecs], dr[kWide ? 1 : kVecs];
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      const int v = threadIdx.x + i * blockDim.x;
      if (v >= nvec) continue;
      sr[i] = load(sv + v);
      gr[i] = load(gv + v);
      if constexpr (!kWide) {
        if (ds_in != nullptr) dr[i] = load(dv + v);
      }
    }
    float ss = 0.f, gs = 0.f;
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      const int v = threadIdx.x + i * blockDim.x;
      if (v >= nvec) continue;
      VW wi;
      if constexpr (kWide) wi = load(wv + v); else wi = wr[i];
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const float sf = to_f(sr[i].v[e]);
        const float g = to_f(gr[i].v[e]) * to_f(wi.v[e]);
        ss = fmaf(sf, sf, ss);
        gs = fmaf(g, sf, gs);
      }
    }
    // warp sums, then every warp sums the warps' sums: one barrier a row
    // (the slots alternate by row, so the next row's writes never meet
    // this row's reads), the same order in every thread
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
      gs += __shfl_xor_sync(0xffffffffu, gs, o);
    }
    if (lane == 0) {
      red[parity][0][warp] = ss;
      red[parity][1][warp] = gs;
    }
    __syncthreads();
    ss = lane < nwarps ? red[parity][0][lane] : 0.f;
    gs = lane < nwarps ? red[parity][1][lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
      gs += __shfl_xor_sync(0xffffffffu, gs, o);
    }
    const float inv = rsqrtf(ss / d + eps);
    const float corr = inv * inv * inv * (gs / d);
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      const int v = threadIdx.x + i * blockDim.x;
      if (v >= nvec) continue;
      VW wi;
      VT di;
      if constexpr (kWide) {
        wi = load(wv + v);
        if (ds_in != nullptr) di = load(dv + v);
      } else {
        wi = wr[i];
        if (ds_in != nullptr) di = dr[i];
      }
      VT out;
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const float sf = to_f(sr[i].v[e]);
        const float dyf = to_f(gr[i].v[e]);
        float g = inv * dyf * to_f(wi.v[e]) - sf * corr;
        if (ds_in != nullptr) g += to_f(di.v[e]);
        out.v[e] = from_f<T>(g);
        if constexpr (kWide) {
          dw_smem[v * kVec + e] = fmaf(dyf * sf, inv, dw_smem[v * kVec + e]);
        } else {
          dw[i][e] = fmaf(dyf * sf, inv, dw[i][e]);
        }
      }
      store(reinterpret_cast<VT*>(dx + base) + v, out);
    }
  }
  VF* part = reinterpret_cast<VF*>(partial + static_cast<size_t>(blockIdx.x) * d);
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int v = threadIdx.x + i * blockDim.x;
    if (v >= nvec) continue;
    VF out;
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      if constexpr (kWide) out.v[e] = dw_smem[v * kVec + e]; else out.v[e] = dw[i][e];
    }
    store(part + v, out);
  }
}

// dw[c] = the sum of the blocks' partials of column c: a block a 32
// columns, 8 slices of 32 lanes each summing every 8th partial row in
// row order, then the slices halved in a fixed tree.
__global__ void __launch_bounds__(kDwCols * kDwSlices)
rmsnorm_dw_kernel(const float* __restrict__ partial, float* __restrict__ dw, int blocks, int d) {
  __shared__ float acc[kDwSlices][kDwCols];
  const int cx = threadIdx.x % kDwCols, sy = threadIdx.x / kDwCols;
  const int col = blockIdx.x * kDwCols + cx;
  float sum = 0.f;
  if (col < d)
    for (int b = sy; b < blocks; b += kDwSlices) sum += partial[static_cast<size_t>(b) * d + col];
  acc[sy][cx] = sum;
  __syncthreads();
#pragma unroll
  for (int h = kDwSlices / 2; h >= 1; h >>= 1) {
    if (sy < h) acc[sy][cx] += acc[sy + h][cx];
    __syncthreads();
  }
  if (sy == 0 && col < d) dw[col] = acc[0][cx];
}

// The row kernel for rows of d (kVec elements a vector), its threads and
// dynamic shared bytes: two vectors a thread where 512 threads hold the
// row, else 1024 of up to four (the forward's widest rows); null kern for
// wider rows.
template <typename T_, typename W_>
struct BwdPlan {
  using T = T_;
  using W = W_;
  void (*kern)(const T*, const T*, const T*, const W*, T*, float*, int, int, float);
  int threads;
  size_t smem;
};

template <typename T, typename W, int kVec>
BwdPlan<T, W> bwd_plan(int d) {
  const int nvec = d / kVec;
  const size_t wide = sizeof(float) * static_cast<size_t>(d);
  if (nvec <= 2 * kBwdThreads) {
    // at least 128 threads, or a vector each where a row has fewer
    const int one = (nvec + 31) / 32 * 32, two = ((nvec + 1) / 2 + 31) / 32 * 32;
    const int threads = two > (one < 128 ? one : 128) ? two : (one < 128 ? one : 128);
    return {rmsnorm_bwd_kernel<T, W, kVec, 2, false>, threads, 0};
  }
  if (nvec <= 2 * kBwdWideThreads)
    return {rmsnorm_bwd_kernel<T, W, kVec, 2, true>, kBwdWideThreads, wide};
  if (nvec <= 4 * kBwdWideThreads)
    return {rmsnorm_bwd_kernel<T, W, kVec, 4, true>, kBwdWideThreads, wide};
  return {nullptr, 0, 0};
}

// Calls f(plan) with the plan for these dtypes (0 fp32, 1 bf16, 2 fp16; w
// in fp32 or dtype) and vectors of 8 elements (vec) or 1; returns what f
// does, or cudaErrorInvalidValue where there is no plan.
template <typename T, typename W, typename F>
cudaError_t with_plan(int d, bool vec, F&& f) {
  const BwdPlan<T, W> p = vec ? bwd_plan<T, W, 8>(d) : bwd_plan<T, W, 1>(d);
  return p.kern == nullptr ? cudaErrorInvalidValue : f(p);
}

template <typename T, typename F>
cudaError_t with_weight(int d, int dtype, int wdtype, bool vec, F&& f) {
  if (wdtype == 0) return with_plan<T, float>(d, vec, f);
  if (wdtype != dtype) return cudaErrorInvalidValue;
  return with_plan<T, T>(d, vec, f);
}

template <typename F>
cudaError_t with_bwd_plan(int d, int dtype, int wdtype, bool vec, F&& f) {
  if (d <= 0 || (vec && d % 8)) return cudaErrorInvalidValue;
  switch (dtype) {
    case 0: return with_weight<float>(d, dtype, wdtype, vec, f);
    case 1: return with_weight<__nv_bfloat16>(d, dtype, wdtype, vec, f);
    case 2: return with_weight<__half>(d, dtype, wdtype, vec, f);
    default: return cudaErrorInvalidValue;
  }
}

template <typename P>
cudaError_t allow_smem(const P& p) {
  if (p.smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(p.kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(p.smem));
}

// the backward's persistent blocks: at most this many an SM, so the dw
// partial stays a few rows an SM
constexpr int kBwdBlocksPerSm = 4;

}  // namespace

// The backward's row kernel blocks for rows of d in these dtypes, vectors
// of 8 (vec) or 1: as many as the current card holds at once, at most
// kBwdBlocksPerSm an SM; 0 where no kernel takes the rows.  The dw
// partial has this many rows (or the rows, if fewer).
extern "C" int rmsnorm_bwd_blocks(int d, int dtype, int wdtype, int vec) {
  int blocks = 0;
  const cudaError_t e = with_bwd_plan(d, dtype, wdtype, vec != 0, [&](auto p) {
    int per_sm = 0, dev = 0, sms = 0;
    cudaError_t err = allow_smem(p);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, p.kern, p.threads, p.smem);
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    blocks = (per_sm < kBwdBlocksPerSm ? per_sm : kBwdBlocksPerSm) * sms;
    return err;
  });
  return e == cudaSuccess ? blocks : 0;
}

// The backward pass of both forms: s (rows, d) the norm's input (the fused
// form's saved sum), dy (rows, d) the gradient of y, ds_in (rows, d) the
// gradient of the fused form's s output or null; w (d,).  Writes dx (rows,
// d; equal to dr for the fused form) and dw (d,) in fp32, through
// `partial`, an fp32 (blocks, d) workspace: the row kernel runs `blocks`
// blocks (at most rows; rmsnorm_bwd_blocks's count for a persistent
// grid), then the dw sum.  vec: vectors of 8 elements, which takes d a
// multiple of 8 and every pointer 16-byte aligned.  d up to 32768 (4096
// vectors of 8), every width the forward takes.
extern "C" int rmsnorm_bwd_launch(const void* s, const void* dy, const void* ds_in,
                                  const void* w, void* dx, void* dw, void* partial, int blocks,
                                  int rows, int d, float eps, int dtype, int wdtype, int vec,
                                  void* stream) {
  if (rows <= 0 || blocks <= 0 || blocks > rows) return cudaErrorInvalidValue;
  const uintptr_t bits = reinterpret_cast<uintptr_t>(s) | reinterpret_cast<uintptr_t>(dy) |
                         reinterpret_cast<uintptr_t>(ds_in) | reinterpret_cast<uintptr_t>(w) |
                         reinterpret_cast<uintptr_t>(dx) | reinterpret_cast<uintptr_t>(partial);
  if (vec && bits % 16) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_bwd_plan(d, dtype, wdtype, vec != 0, [&](auto p) {
    using T = typename decltype(p)::T;
    using W = typename decltype(p)::W;
    cudaError_t e = allow_smem(p);
    if (e != cudaSuccess) return e;
    p.kern<<<blocks, p.threads, p.smem, st>>>(
        static_cast<const T*>(s), static_cast<const T*>(dy), static_cast<const T*>(ds_in),
        static_cast<const W*>(w), static_cast<T*>(dx), static_cast<float*>(partial), rows, d,
        eps);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    rmsnorm_dw_kernel<<<(d + kDwCols - 1) / kDwCols, kDwCols * kDwSlices, 0, st>>>(
        static_cast<const float*>(partial), static_cast<float*>(dw), blocks, d);
    return cudaGetLastError();
  });
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
