// The backward pass of GQA flash attention, for Hopper (sm_90a).
//
// The gradient of src/repro_torch/csrc/flash_attention.cu's forward, as
// src/repro/kernels/flash_vjp.py's _bwd_rule computes it: from q, k, v, the
// output o, its gradient do and the forward's log-sum-exp lse, recompute
// each score s = (q * scale) . k, its capped value sc = cap * tanh(s / cap)
// (or s), the probability p = exp(sc - lse) where the mask keeps the key
// (else 0), and
//   delta = rowsum(do * o)
//   dv   += p^T do
//   dp    = do v^T
//   ds    = p * (dp - delta) * (1 - (sc / cap)^2)    (the softcap's chain)
//   dq   += ds k * scale
//   dk   += ds^T (q * scale)
// with the forward's masks: keys past kv_len[b], and (causal) k_pos >
// q_pos, and (window) k_pos <= q_pos - window, q_pos = q_off + i.  Under
// GQA each dk/dv row sums over the G query heads of its kv head.
//
// q, o, do (B, Sq, H, D); k, v (B, Sk, KV, D); lse, delta (B, H, Sq) fp32;
// bf16 or fp32 in, the gradients in the inputs' type, every product and
// sum in fp32.  D = DV in {64, 128}.
//
// What bounds it: operations, about 2.5 times the forward's products for
// FlashAttention-2's schedule.  This first design is simple and plain:
// three launches, the products on the CUDA cores in fp32, no atomics.
//   1. delta: a warp a row.
//   2. dk, dv: a block a (k tile of 64 keys, kv head, batch) walks the q
//      tiles of 32 rows that its mask reaches, for each of the G heads,
//      with the tiles staged in shared memory as fp32 and dk, dv in
//      registers (a warp owns 8 keys, a lane D/32 columns).
//   3. dq: a block a (q tile of 32 rows, head, batch) walks the k tiles its
//      mask reaches and keeps dq in registers (a warp owns 4 rows).
// Both recompute s and dp: 7 products of the forward's size where
// FlashAttention-2 does 5, and the tensor cores stay idle.  It is a
// correct start for a later redesign on wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsQ = 32;              // q rows a tile
constexpr int kKeys = 64;               // keys a tile
enum DType { kF32 = 0, kBF16 = 1 };

struct Args {
  const void* q;           // (B, Sq, H, D)
  const void* k;           // (B, Sk, KV, D)
  const void* v;           // (B, Sk, KV, D)
  const void* o;           // (B, Sq, H, D)
  const void* dout;        // (B, Sq, H, D)
  const float* lse;        // (B, H, Sq)
  float* delta;            // (B, H, Sq) workspace
  const int32_t* kv_len;   // (B,) or null: Sk
  void* dq;                // (B, Sq, H, D)
  void* dk;                // (B, Sk, KV, D)
  void* dv;                // (B, Sk, KV, D)
  int B, Sq, Sk, H, KV;
  int q_off;
  float scale;
  int causal;
  int window;              // <= 0: none
  float softcap;           // <= 0: none
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ int valid_len(const Args& a, int b) {
  return a.kv_len != nullptr ? min(a.kv_len[b], a.Sk) : a.Sk;
}

__device__ __forceinline__ bool keep(const Args& a, int q_pos, int k_pos, int len) {
  bool ok = k_pos < len;
  if (a.causal) ok = ok && k_pos <= q_pos;
  if (a.window > 0) ok = ok && k_pos > q_pos - a.window;
  return ok;
}

// `rows` rows of one head of a (B, S, heads, D) tensor into shared memory
// as fp32 with row stride LD, times `mul`; rows past S read as zeros.
// K and V rows take LD = D + 1: lane j reads row j.  Q, do, P and dS rows
// are read by a whole warp at once or along the row: LD = their width.
template <typename T, int D, int LD>
__device__ __forceinline__ void stage(float* dst, const T* src, int b, int row0, int rows,
                                      int S, int heads, int h, float mul) {
  for (int i = threadIdx.x; i < rows * D; i += kThreads) {
    const int r = i / D, d = i % D, t = row0 + r;
    float x = 0.f;
    if (t < S) x = to_f(src[((static_cast<size_t>(b) * S + t) * heads + h) * D + d]) * mul;
    dst[r * LD + d] = x;
  }
}

// ------------------------------------------------------------- 1. delta
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) delta_kernel(Args a) {
  const int warp = (blockIdx.x * kThreads + threadIdx.x) / 32, lane = threadIdx.x % 32;
  const int rows = a.B * a.Sq * a.H;
  if (warp >= rows) return;                 // warp-uniform
  const int h = warp % a.H, i = (warp / a.H) % a.Sq, b = warp / (a.H * a.Sq);
  const size_t base = static_cast<size_t>(warp) * D;   // (B, Sq, H) row-major
  const T* o = static_cast<const T*>(a.o);
  const T* g = static_cast<const T*>(a.dout);
  float acc = 0.f;
#pragma unroll
  for (int e = 0; e < D / 32; ++e) acc += to_f(g[base + e * 32 + lane]) * to_f(o[base + e * 32 + lane]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(kFull, acc, off);
  if (lane == 0) a.delta[(static_cast<size_t>(b) * a.H + h) * a.Sq + i] = acc;
}

// Scores, probabilities and score gradients of one (q tile, k tile) pair
// into shared memory: P[i][j] and dS[i][j] (row stride kKeys), from
// qs (pre-scaled), gs (do), ks, vs staged above.  Thread t takes key
// j = t % 64 for rows i = t / 64 + 4 r.
template <int D>
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
  const float* vr = vs + j * (D + 1);
  for (int d = 0; d < D; ++d) {
    const float kx = kr[d], vx = vr[d];
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int i = i0 + kGroups * r;
      s[r] = fmaf(qs[i * D + d], kx, s[r]);
      dp[r] = fmaf(gs[i * D + d], vx, dp[r]);
    }
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

template <int D>
constexpr size_t smem_floats() {
  // q and do tiles, k and v tiles, P and dS, lse and delta: 112.75 KB at
  // D = 128, so two blocks share an SM
  return static_cast<size_t>(2 * kRowsQ * D + 2 * kKeys * (D + 1) + 2 * kRowsQ * kKeys
                             + 2 * kRowsQ);
}

// ------------------------------------------------------------- 2. dk, dv
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) dkdv_kernel(Args a) {
  extern __shared__ float sm[];
  float* qs = sm;
  float* gs = qs + kRowsQ * D;
  float* ks = gs + kRowsQ * D;
  float* vs = ks + kKeys * (D + 1);
  float* ps = vs + kKeys * (D + 1);
  float* dss = ps + kRowsQ * kKeys;
  float* lse_s = dss + kRowsQ * kKeys;
  float* del_s = lse_s + kRowsQ;
  const int k0 = blockIdx.x * kKeys, kh = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.KV;
  const int len = valid_len(a, b);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  constexpr int kKeysPerWarp = kKeys / kWarps;       // 8
  constexpr int kCols = D / 32;
  float dk[kKeysPerWarp][kCols], dv[kKeysPerWarp][kCols];
#pragma unroll
  for (int jj = 0; jj < kKeysPerWarp; ++jj)
#pragma unroll
    for (int e = 0; e < kCols; ++e) dk[jj][e] = dv[jj][e] = 0.f;

  // the q rows whose mask can keep a key of this tile: [lo, hi)
  int lo = 0, hi = a.Sq;
  if (a.causal) lo = max(lo, k0 - a.q_off);
  if (a.window > 0) hi = min(hi, k0 + kKeys - 1 + a.window - a.q_off);
  lo = (lo / kRowsQ) * kRowsQ;
  if (k0 < len && lo < hi) {
    stage<T, D, D + 1>(ks, static_cast<const T*>(a.k), b, k0, kKeys, a.Sk, a.KV, kh, 1.f);
    stage<T, D, D + 1>(vs, static_cast<const T*>(a.v), b, k0, kKeys, a.Sk, a.KV, kh, 1.f);
    for (int h = kh * G; h < (kh + 1) * G; ++h) {
      for (int q0 = lo; q0 < hi; q0 += kRowsQ) {
        __syncthreads();                 // the last pair's tiles are read
        stage<T, D, D>(qs, static_cast<const T*>(a.q), b, q0, kRowsQ, a.Sq, a.H, h, a.scale);
        stage<T, D, D>(gs, static_cast<const T*>(a.dout), b, q0, kRowsQ, a.Sq, a.H, h, 1.f);
        if (threadIdx.x < kRowsQ) {
          const int i = q0 + threadIdx.x;
          const size_t at = (static_cast<size_t>(b) * a.H + h) * a.Sq + i;
          // a row past Sq: p = exp(-1e30 - 1e30) = 0 and its q and do are 0
          lse_s[threadIdx.x] = i < a.Sq ? a.lse[at] : 1e30f;
          del_s[threadIdx.x] = i < a.Sq ? a.delta[at] : 0.f;
        }
        __syncthreads();
        scores<D>(a, qs, gs, ks, vs, lse_s, del_s, ps, dss, q0, k0, len);
        __syncthreads();
        for (int i = 0; i < kRowsQ; ++i) {
          float gx[kCols], qx[kCols];
#pragma unroll
          for (int e = 0; e < kCols; ++e) {
            gx[e] = gs[i * D + e * 32 + lane];
            qx[e] = qs[i * D + e * 32 + lane];
          }
#pragma unroll
          for (int jj = 0; jj < kKeysPerWarp; ++jj) {
            const int j = warp * kKeysPerWarp + jj;
            const float p = ps[i * kKeys + j], ds = dss[i * kKeys + j];
#pragma unroll
            for (int e = 0; e < kCols; ++e) {
              dv[jj][e] = fmaf(p, gx[e], dv[jj][e]);
              dk[jj][e] = fmaf(ds, qx[e], dk[jj][e]);
            }
          }
        }
      }
    }
  }
  T* dko = static_cast<T*>(a.dk);
  T* dvo = static_cast<T*>(a.dv);
#pragma unroll
  for (int jj = 0; jj < kKeysPerWarp; ++jj) {
    const int t = k0 + warp * kKeysPerWarp + jj;
    if (t >= a.Sk) continue;
    const size_t base = ((static_cast<size_t>(b) * a.Sk + t) * a.KV + kh) * D;
#pragma unroll
    for (int e = 0; e < kCols; ++e) {
      dko[base + e * 32 + lane] = from_f<T>(dk[jj][e]);
      dvo[base + e * 32 + lane] = from_f<T>(dv[jj][e]);
    }
  }
}

// ------------------------------------------------------------- 3. dq
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) dq_kernel(Args a) {
  extern __shared__ float sm[];
  float* qs = sm;
  float* gs = qs + kRowsQ * D;
  float* ks = gs + kRowsQ * D;
  float* vs = ks + kKeys * (D + 1);
  float* ps = vs + kKeys * (D + 1);
  float* dss = ps + kRowsQ * kKeys;
  float* lse_s = dss + kRowsQ * kKeys;
  float* del_s = lse_s + kRowsQ;
  const int q0 = blockIdx.x * kRowsQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (a.H / a.KV);
  const int len = valid_len(a, b);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  constexpr int kRowsPerWarp = kRowsQ / kWarps;      // 4
  constexpr int kCols = D / 32;
  float dq[kRowsPerWarp][kCols];
#pragma unroll
  for (int ii = 0; ii < kRowsPerWarp; ++ii)
#pragma unroll
    for (int e = 0; e < kCols; ++e) dq[ii][e] = 0.f;

  stage<T, D, D>(qs, static_cast<const T*>(a.q), b, q0, kRowsQ, a.Sq, a.H, h, a.scale);
  stage<T, D, D>(gs, static_cast<const T*>(a.dout), b, q0, kRowsQ, a.Sq, a.H, h, 1.f);
  if (threadIdx.x < kRowsQ) {
    const int i = q0 + threadIdx.x;
    const size_t at = (static_cast<size_t>(b) * a.H + h) * a.Sq + i;
    lse_s[threadIdx.x] = i < a.Sq ? a.lse[at] : 1e30f;
    del_s[threadIdx.x] = i < a.Sq ? a.delta[at] : 0.f;
  }
  // the keys this q tile's mask can keep: [first, end)
  const int q_lo = a.q_off + q0, q_hi = a.q_off + min(q0 + kRowsQ, a.Sq) - 1;
  int end = len;
  if (a.causal) end = min(end, q_hi + 1);
  int first = 0;
  if (a.window > 0) first = max(0, q_lo - a.window + 1);
  first = (first / kKeys) * kKeys;
  for (int k0 = first; k0 < end; k0 += kKeys) {
    __syncthreads();                     // the last tile's dS is read
    stage<T, D, D + 1>(ks, static_cast<const T*>(a.k), b, k0, kKeys, a.Sk, a.KV, kh, 1.f);
    stage<T, D, D + 1>(vs, static_cast<const T*>(a.v), b, k0, kKeys, a.Sk, a.KV, kh, 1.f);
    __syncthreads();
    scores<D>(a, qs, gs, ks, vs, lse_s, del_s, ps, dss, q0, k0, len);
    __syncthreads();
    for (int j = 0; j < kKeys; ++j) {
      float kx[kCols];
#pragma unroll
      for (int e = 0; e < kCols; ++e) kx[e] = ks[j * (D + 1) + e * 32 + lane];
#pragma unroll
      for (int ii = 0; ii < kRowsPerWarp; ++ii) {
        const float ds = dss[(warp * kRowsPerWarp + ii) * kKeys + j];
#pragma unroll
        for (int e = 0; e < kCols; ++e) dq[ii][e] = fmaf(ds, kx[e], dq[ii][e]);
      }
    }
  }
  T* dqo = static_cast<T*>(a.dq);
#pragma unroll
  for (int ii = 0; ii < kRowsPerWarp; ++ii) {
    const int i = q0 + warp * kRowsPerWarp + ii;
    if (i >= a.Sq) continue;
    const size_t base = ((static_cast<size_t>(b) * a.Sq + i) * a.H + h) * D;
#pragma unroll
    for (int e = 0; e < kCols; ++e) dqo[base + e * 32 + lane] = from_f<T>(dq[ii][e] * a.scale);
  }
}

template <typename K>
cudaError_t launch(K kern, dim3 grid, size_t smem, cudaStream_t s, const Args& a) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kern<<<grid, kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t run(const Args& a, cudaStream_t s) {
  const long rows = static_cast<long>(a.B) * a.Sq * a.H;
  delta_kernel<T, D><<<static_cast<unsigned>((rows * 32 + kThreads - 1) / kThreads), kThreads,
                       0, s>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const size_t smem = smem_floats<D>() * sizeof(float);
  e = launch(dkdv_kernel<T, D>, dim3((a.Sk + kKeys - 1) / kKeys, a.KV, a.B), smem, s, a);
  if (e != cudaSuccess) return e;
  return launch(dq_kernel<T, D>, dim3((a.Sq + kRowsQ - 1) / kRowsQ, a.H, a.B), smem, s, a);
}

template <typename T>
cudaError_t by_dim(const Args& a, int D, cudaStream_t s) {
  if (D == 64) return run<T, 64>(a, s);
  if (D == 128) return run<T, 128>(a, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// The head dims built: D = DV, one of these.
extern "C" int flash_attention_bwd_head_dims(int* dims, int n) {
  constexpr int kDims[] = {64, 128};
  for (int i = 0; i < 2 && i < n; ++i) dims[i] = kDims[i];
  return 2;
}

// dq, dk, dv of flash attention (shapes above); `delta` is a (B, H, Sq)
// fp32 workspace.  dtype 0 fp32, 1 bf16; D = DV in {64, 128}, else
// cudaErrorInvalidValue.
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const void* lse, void* delta, const void* kv_len, void* dq, void* dk, void* dv, int B,
    int Sq, int Sk, int H, int KV, int D, int DV, int q_off, float scale, int causal,
    int window, float softcap, int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KV <= 0 || H % KV != 0 || D != DV)
    return cudaErrorInvalidValue;
  const Args a{q, k, v, o, dout, static_cast<const float*>(lse), static_cast<float*>(delta),
               static_cast<const int32_t*>(kv_len), dq, dk, dv, B, Sq, Sk, H, KV, q_off,
               scale, causal, window, softcap};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return by_dim<float>(a, D, s);
  if (dtype == kBF16) return by_dim<__nv_bfloat16>(a, D, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
