// Exact inner-product top-k and the masked multi-partition merge, for
// Hopper (sm_90a).
//
// Replaces src/repro/kernels/topk_retrieval.py::topk_pallas and
// ::topk_merge_pallas.
//
// Order contract (both kernels): score descending, then lower position
// first on ties -- jax.lax.top_k's order.  For the top-k that position is
// the global database row; for the merge it is the flat (partition, rank)
// position.  Fewer than k candidates leave a (-1e30, -1) tail.
//
// retrieval_topk -- what bounds it: bytes.  Q queries against an N x D
// fp32 partition do 2*Q*N*D flops on 4*N*D bytes, Q/2 flops a byte (4 at
// the main path's Q = 8), so streaming the partition once is the floor.
// The TPU kernel carried a running (bq, k) scoreboard across sequential
// grid steps; blocks here run in parallel, so it is two passes:
//   1. grid (row chunk, query tile): a block stages its QT queries in
//      shared memory, scores its CHUNK database rows (one warp per row,
//      lanes stride over D so each row is one coalesced read, QT partial
//      sums in registers), then one warp per query selects that chunk's
//      top-k into a (Q, chunks, k) candidate buffer.
//   2. the merge kernel below, unmasked, reduces the candidates to (Q, k).
//      Chunks are in row order and each chunk's list is in (score, row)
//      order, so ascending flat position among equal scores is ascending
//      row: the ties come out as lax.top_k's.
//
// retrieval_topk_merge -- what bounds it: bytes and launch latency; the
// (Q, P, k) boards are a few KB.  One warp per query walks the P*k flat
// entries k times, each round taking the first entry (in the order
// above) that comes strictly after the previous pick: no sort, no
// scratch, and masked entries enter as (-1e30, -1).

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kQueryTile = 8;     // queries a top-k block scores at once
constexpr int kChunk = 128;       // database rows a top-k block scores
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ bool before(float sa, int pa, float sb, int pb) {
  return sa > sb || (sa == sb && pa < pb);
}

__device__ __forceinline__ void warp_first(float& s, int& p) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float so = __shfl_xor_sync(0xffffffffu, s, off);
    const int po = __shfl_xor_sync(0xffffffffu, p, off);
    if (before(so, po, s, p)) {
      s = so;
      p = po;
    }
  }
}

// One warp: the first k of entries [0, n) in (score desc, position asc)
// order.  score(i) gives entry i's score.  Calls emit(r, score, pos) for
// r in [0, k) on lane 0; pos is -1 where fewer than k entries exist.
template <typename Score, typename Emit>
__device__ void warp_select(int n, int k, Score score, Emit emit) {
  const int lane = threadIdx.x & 31;
  float last_s = INFINITY;
  int last_p = -1;
  for (int r = 0; r < k; ++r) {
    float bs = -INFINITY;
    int bp = INT_MAX;
    for (int i = lane; i < n; i += 32) {
      const float v = score(i);
      if (before(last_s, last_p, v, i) && before(v, i, bs, bp)) {
        bs = v;
        bp = i;
      }
    }
    warp_first(bs, bp);
    if (lane == 0) emit(r, bs, bp == INT_MAX ? -1 : bp);
    last_s = bs;
    last_p = bp;
  }
}

__global__ void __launch_bounds__(kThreads)
topk_chunk_kernel(const float* __restrict__ q, const float* __restrict__ db,
                  float* __restrict__ cand_s, int32_t* __restrict__ cand_i,
                  int Q, int N, int D, int k) {
  const int chunk = blockIdx.x;
  const int nchunks = gridDim.x;
  const int q0 = blockIdx.y * kQueryTile;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  extern __shared__ float smem[];
  float* qs = smem;                      // kQueryTile * D
  float* ss = qs + kQueryTile * D;       // kQueryTile * kChunk

  for (int i = tid; i < kQueryTile * D; i += kThreads) {
    const int qi = q0 + i / D;
    qs[i] = qi < Q ? q[static_cast<size_t>(q0) * D + i] : 0.f;
  }
  __syncthreads();

  const int r0 = chunk * kChunk;
  const int rows = min(kChunk, N - r0);
  for (int r = warp; r < rows; r += kWarps) {
    const float* row = db + static_cast<size_t>(r0 + r) * D;
    float acc[kQueryTile];
#pragma unroll
    for (int j = 0; j < kQueryTile; ++j) acc[j] = 0.f;
#pragma unroll 4
    for (int d = lane; d < D; d += 32) {
      const float x = __ldg(row + d);
#pragma unroll
      for (int j = 0; j < kQueryTile; ++j) acc[j] += qs[j * D + d] * x;
    }
#pragma unroll
    for (int j = 0; j < kQueryTile; ++j) {
      float v = acc[j];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == j) ss[j * kChunk + r] = v;
    }
  }
  __syncthreads();

  if (warp < kQueryTile && q0 + warp < Q) {
    const int qi = q0 + warp;
    const float* sc = ss + warp * kChunk;
    const size_t base = (static_cast<size_t>(qi) * nchunks + chunk) * k;
    warp_select(rows, k, [&](int i) { return sc[i]; },
                [&](int r, float s, int pos) {
                  cand_s[base + r] = pos < 0 ? kNegInf : s;
                  cand_i[base + r] = pos < 0 ? -1 : r0 + pos;
                });
  }
}

// (Q, M) scores/ids with M = P * k, optional (Q, P) mask -> (Q, k).
__global__ void __launch_bounds__(kThreads)
merge_kernel(const float* __restrict__ s, const int32_t* __restrict__ ids,
             const uint8_t* __restrict__ mask, float* __restrict__ out_s,
             int32_t* __restrict__ out_i, int Q, int P, int kk, int k) {
  const int qi = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (qi >= Q) return;
  const int M = P * kk;
  const float* row_s = s + static_cast<size_t>(qi) * M;
  const int32_t* row_i = ids + static_cast<size_t>(qi) * M;
  const uint8_t* row_m = mask == nullptr ? nullptr : mask + static_cast<size_t>(qi) * P;
  auto live = [&](int i) { return row_m == nullptr || row_m[i / kk] != 0; };
  warp_select(M, k, [&](int i) { return live(i) ? row_s[i] : kNegInf; },
              [&](int r, float sc, int pos) {
                out_s[static_cast<size_t>(qi) * k + r] = pos < 0 ? kNegInf : sc;
                out_i[static_cast<size_t>(qi) * k + r] =
                    (pos < 0 || !live(pos)) ? -1 : row_i[pos];
              });
}

cudaError_t launch_merge(const float* s, const int32_t* ids, const uint8_t* mask,
                         float* out_s, int32_t* out_i, int Q, int P, int kk, int k,
                         cudaStream_t stream) {
  const int blocks = (Q + kWarps - 1) / kWarps;
  merge_kernel<<<blocks, kThreads, 0, stream>>>(s, ids, mask, out_s, out_i, Q, P, kk, k);
  return cudaGetLastError();
}

}  // namespace

extern "C" int topk_chunks(int N) { return (N + kChunk - 1) / kChunk; }

// queries (Q, D) fp32, database (N, D) fp32 -> (Q, k) fp32 scores and
// int32 row ids; cand_s/cand_i are (Q, topk_chunks(N), k) scratch.
extern "C" int retrieval_topk(const void* queries, const void* database, void* cand_s,
                              void* cand_i, void* out_s, void* out_i, int Q, int N,
                              int D, int k, void* stream) {
  if (Q <= 0 || N <= 0 || D <= 0 || k <= 0) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * kQueryTile * (static_cast<size_t>(D) + kChunk);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        topk_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int nchunks = topk_chunks(N);
  dim3 grid(nchunks, (Q + kQueryTile - 1) / kQueryTile);
  topk_chunk_kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const float*>(queries), static_cast<const float*>(database),
      static_cast<float*>(cand_s), static_cast<int32_t*>(cand_i), Q, N, D, k);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return launch_merge(static_cast<const float*>(cand_s),
                      static_cast<const int32_t*>(cand_i), nullptr,
                      static_cast<float*>(out_s), static_cast<int32_t*>(out_i), Q,
                      nchunks, k, k, s);
}

// part_scores (Q, P, k) fp32, part_ids (Q, P, k) int32, mask (Q, P) uint8
// -> (Q, k) fp32 scores, int32 ids.
extern "C" int retrieval_topk_merge(const void* part_scores, const void* part_ids,
                                    const void* mask, void* out_s, void* out_i, int Q,
                                    int P, int k, void* stream) {
  if (Q <= 0 || P <= 0 || k <= 0) return cudaErrorInvalidValue;
  return launch_merge(static_cast<const float*>(part_scores),
                      static_cast<const int32_t*>(part_ids),
                      static_cast<const uint8_t*>(mask), static_cast<float*>(out_s),
                      static_cast<int32_t*>(out_i), Q, P, k, k,
                      static_cast<cudaStream_t>(stream));
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
