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
// the main path's Q = 8), so streaming the partition once at the memory's
// rate is the floor.  The TPU kernel carried a running (bq, k) scoreboard
// across sequential grid steps.  Here one launch streams the partition:
//   * Bytes in flight.  One block of 16 warps an SM (grid.x <= kMaxBlocks)
//     takes an even, contiguous run of 64-row tiles; each warp scores 4
//     rows of a tile.  A lane loads its float4 columns of those rows
//     straight into registers (evict-first: the partition is read once),
//     kColumns float4 columns of all 4 rows issued together, then
//     multiplied: 96 KB an SM in flight where about 25 KB keep the memory
//     busy.
//   * fp32 FFMA, register-blocked.  A lane multiplies each database float4
//     by the 8 queries' float4s (read through L1, where the 8 query rows
//     stay) and keeps the 4 x 8 partial sums in registers.  A
//     reduce-scatter butterfly (31 shuffles) leaves lane l with the full
//     score of (row l / 8, query l % 8); the same tree for every row, so
//     equal rows give equal bits.  Not TF32: ids are held exactly where
//     scores are 1e-5 apart.
//   * Selection that costs nothing once warm.  Warp q keeps query q's
//     running top-64 list in registers (2 entries a lane, sorted) and its
//     k-th entry as a threshold: a tile's rows enter only if they beat it
//     (one ballot a 32 rows), one by one when few do, else by one
//     warp-wide merge (bitonic sort of the 32, binary search, gather).
//   * One launch.  Each block writes its sorted list rank-major to scratch;
//     the last block to take a ticket (after __threadfence) merges the
//     lists (past 32 lists two warps a query, half the lists each, then
//     one merge of the halves) rank by rank with the same offers, from a
//     floor: no entry after the best of the lists' k-th entries can be
//     among the k best.  A warp stops at the first rank where no entry
//     beats its threshold (lists are sorted, so no deeper entry can).
//     The block resets the ticket for the next launch on the stream.
//     Ties compare global rows, so the order is lax.top_k's whatever the
//     blocks' order.
//
// retrieval_topk_merge -- what bounds it: latency.  The (Q, P, k) boards
// are a few KB (20 KB at the main path's (8, 64, 5)), so the byte bound is
// nanoseconds and the floor is a launch plus one dependent load.  The TPU
// kernel fused the boards in one block.  Here one warp takes a query:
//   * One load round trip.  A lane loads its 16 entries of a 512-entry
//     chunk of the row at once, as four 16-byte loads each of scores and
//     ids where the row allows it (else 16 scalar loads), and the warp
//     stages the chunk's mask bytes in shared memory, one byte a
//     partition.  Entries stay in registers; a row longer than one chunk
//     is taken chunk by chunk.
//   * Selection on registers.  kRounds: k rounds, each a lane's best
//     entry after the previous pick, then one warp_first (ids ride
//     along), for rows of one chunk and k <= kRoundsMaxK.  Otherwise the
//     entries are offered to the sorted WarpList of the streaming top-k
//     (threshold ballots, a bitonic merge when many enter), and the k
//     picks' ids are read back at the end (the row is in L1).  Measured
//     on the H100 (chip_smoke.py) at 8 queries: the rounds are faster at
//     k = 5, 16 and 32, the list at k = 64.
//   * Queries spread over blocks of kMergeWarps warps, one SM each.
// Masked entries enter as (-1e30, -1) at their flat position, so the order
// is the plain version's exactly.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kNegInf = -1e30f;

// streaming top-k
constexpr int kStreamThreads = 512;
constexpr int kStreamWarps = kStreamThreads / 32;
constexpr int kQueryTile = 8;       // queries a block scores (one warp each)
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kStreamWarps * kRowsPerWarp;   // 64 rows a tile
constexpr int kColumns = 3;         // float4 columns of 4 rows a lane loads at once
constexpr int kMaxK = 64;           // two list entries a lane
constexpr int kMaxBlocks = 128;     // <= 4 lanes' worth of lists to merge
constexpr int kScoreStride = kRows + 4;   // conflict-free score transpose
constexpr int kFewInserts = 4;      // more candidates than this: one merge
constexpr int kRoundsMaxK = 32;     // merge: k rounds up to this k (else the list)

__device__ __forceinline__ bool before(float sa, int pa, float sb, int pb) {
  return sa > sb || (sa == sb && pa < pb);
}

__device__ __forceinline__ void warp_first(float& s, int& p) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float so = __shfl_xor_sync(kFull, s, off);
    const int po = __shfl_xor_sync(kFull, p, off);
    if (before(so, po, s, p)) {
      s = so;
      p = po;
    }
  }
}

// A warp's sorted list of kMaxK (score, row) entries: entry i lives in
// lane i % 32, register i / 32.  Empty entries are (-inf, INT_MAX), which
// no real entry comes after.  (ts, tr) is entry k - 1, or the floor
// (fs, fr) where that comes before it: only what comes before (ts, tr)
// can still enter the first k.
struct WarpList {
  float s0, s1, ts, fs;
  int r0, r1, tr, fr;

  __device__ __forceinline__ void reset() {
    s0 = s1 = ts = fs = -INFINITY;
    r0 = r1 = tr = fr = INT_MAX;
  }

  // Nothing that comes after (s, r) can be among the first k.
  __device__ __forceinline__ void set_floor(float s, int r, int k) {
    fs = s;
    fr = r;
    retarget(k);
  }

  __device__ __forceinline__ void retarget(int k) {
    const int t = k - 1;
    ts = __shfl_sync(kFull, t < 32 ? s0 : s1, t & 31);
    tr = __shfl_sync(kFull, t < 32 ? r0 : r1, t & 31);
    if (before(fs, fr, ts, tr)) {
      ts = fs;
      tr = fr;
    }
  }

  __device__ __forceinline__ void insert(float cs, int cr, int lane, int k) {
    const int pos = __popc(__ballot_sync(kFull, before(s0, r0, cs, cr))) +
                    __popc(__ballot_sync(kFull, before(s1, r1, cs, cr)));
    float u0s = __shfl_up_sync(kFull, s0, 1);
    int u0r = __shfl_up_sync(kFull, r0, 1);
    float u1s = __shfl_up_sync(kFull, s1, 1);
    int u1r = __shfl_up_sync(kFull, r1, 1);
    const float w_s = __shfl_sync(kFull, s0, 31);   // entry 31 moves to 32
    const int w_r = __shfl_sync(kFull, r0, 31);
    if (lane == 0) {
      u1s = w_s;
      u1r = w_r;
    }
    if (lane == pos) {
      s0 = cs;
      r0 = cr;
    } else if (lane > pos) {
      s0 = u0s;
      r0 = u0r;
    }
    if (lane + 32 == pos) {
      s1 = cs;
      r1 = cr;
    } else if (lane + 32 > pos) {
      s1 = u1s;
      r1 = u1r;
    }
    retarget(k);
  }

  // Merges one candidate a lane (empty: (-inf, INT_MAX)) into the list at
  // once: a bitonic sort of the 32 candidates, each one's place in the
  // list by binary search, then every list slot gathers its entry.
  __device__ __forceinline__ void merge(float cs, int cr, int lane, int k) {
#pragma unroll
    for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
      for (int stride = size / 2; stride > 0; stride >>= 1) {
        const float os = __shfl_xor_sync(kFull, cs, stride);
        const int orr = __shfl_xor_sync(kFull, cr, stride);
        const bool first = (lane & stride) == 0;        // keeps the better
        const bool desc = (lane & size) == 0;           //   in a desc run
        if (first == desc ? before(os, orr, cs, cr) : before(cs, cr, os, orr)) {
          cs = os;
          cr = orr;
        }
      }
    }
    // lane j holds the j-th best candidate
    if (__shfl_sync(kFull, r0, 0) == INT_MAX) {     // an empty list: take them
      s0 = cs;
      r0 = cr;
      retarget(k);
      return;
    }
    // its place among the list
    int below = 0;                     // list entries that come before it
#pragma unroll
    for (int step = 32; step > 0; step >>= 1) {
      const int i = below + step - 1;
      const float a = __shfl_sync(kFull, s0, i & 31), b = __shfl_sync(kFull, s1, i & 31);
      const int c = __shfl_sync(kFull, r0, i & 31), d = __shfl_sync(kFull, r1, i & 31);
      if (i < 64 && before(i < 32 ? a : b, i < 32 ? c : d, cs, cr)) below += step;
    }
    const int pos = cr == INT_MAX ? kMaxK : lane + below;
    const unsigned lo = __reduce_or_sync(kFull, pos < 32 ? 1u << pos : 0u);
    const unsigned hi = __reduce_or_sync(kFull, pos >= 32 && pos < 64 ? 1u << (pos - 32) : 0u);
    const unsigned mine = (1u << lane) - 1;
    // slot lane: candidate j or list entry i; slot lane + 32 likewise
    const int cand0 = __popc(lo & mine), cand1 = __popc(lo) + __popc(hi & mine);
    const bool from_c0 = (lo >> lane) & 1, from_c1 = (hi >> lane) & 1;
    const float c0s = __shfl_sync(kFull, cs, cand0 & 31), c1s = __shfl_sync(kFull, cs, cand1 & 31);
    const int c0r = __shfl_sync(kFull, cr, cand0 & 31), c1r = __shfl_sync(kFull, cr, cand1 & 31);
    float l0s, l1s;
    int l0r, l1r;
    at_lane(lane - cand0, l0s, l0r);
    at_lane(lane + 32 - cand1, l1s, l1r);
    s0 = from_c0 ? c0s : l0s;
    r0 = from_c0 ? c0r : l0r;
    s1 = from_c1 ? c1s : l1s;
    r1 = from_c1 ? c1r : l1r;
    retarget(k);
  }

  // Entry i of the list, i per lane (0 <= i < 64).
  __device__ __forceinline__ void at_lane(int i, float& s, int& r) const {
    const float a = __shfl_sync(kFull, s0, i & 31), b = __shfl_sync(kFull, s1, i & 31);
    const int c = __shfl_sync(kFull, r0, i & 31), d = __shfl_sync(kFull, r1, i & 31);
    s = i < 32 ? a : b;
    r = i < 32 ? c : d;
  }

  // Offers one entry a lane (valid lanes only): a few that beat the
  // threshold go in one by one, more in one merge.  Returns whether any
  // lane beat the threshold when the warp looked (warp-uniform).
  __device__ __forceinline__ bool offer(float s, int r, bool valid, int lane, int k) {
    unsigned m = __ballot_sync(kFull, valid && before(s, r, ts, tr));
    if (__popc(m) > kFewInserts) {
      const bool in = (m >> lane) & 1;
      merge(in ? s : -INFINITY, in ? r : INT_MAX, lane, k);
      return true;
    }
    const bool any = m != 0;
    while (m) {
      const int j = __ffs(m) - 1;
      insert(__shfl_sync(kFull, s, j), __shfl_sync(kFull, r, j), lane, k);
      m &= m - 1;
      m &= __ballot_sync(kFull, valid && before(s, r, ts, tr));
    }
    return any;
  }

  // Writes entries [0, k) to out[i * stride]; empty ones as the sentinel.
  __device__ __forceinline__ void store(float* out_s, int32_t* out_i, size_t stride,
                                        int lane, int k, bool sentinel) const {
    const float ss[2] = {s0, s1};
    const int rr[2] = {r0, r1};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = lane + 32 * h;
      if (i < k) {
        const bool empty = sentinel && rr[h] == INT_MAX;
        out_s[i * stride] = empty ? kNegInf : ss[h];
        out_i[i * stride] = empty ? -1 : rr[h];
      }
    }
  }
};

__global__ void __launch_bounds__(kStreamThreads, 1)
topk_stream_kernel(const float* __restrict__ q, const float* __restrict__ db,
                   float* __restrict__ part_s, int32_t* __restrict__ part_i,
                   unsigned* __restrict__ tickets, float* __restrict__ out_s,
                   int32_t* __restrict__ out_i, int Q, int N, int D, int k) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int G = gridDim.x;
  const int b = blockIdx.x;
  const int q0 = blockIdx.y * kQueryTile;
  const int qn = min(kQueryTile, Q - q0);
  const int nf = D >> 2;                      // float4s a row

  // scores of a tile, double-buffered: the next tile's writes never meet
  // this tile's reads, so one barrier a tile suffices
  __shared__ float scores[2][kQueryTile * kScoreStride];
  __shared__ float half_s[kQueryTile][kMaxK];     // the final merge's halves
  __shared__ int32_t half_i[kQueryTile][kMaxK];
  __shared__ int last;

  // this block's contiguous run of row tiles, as even as the grid allows
  const int tiles = (N + kRows - 1) / kRows;
  const int t_begin = static_cast<int>(static_cast<int64_t>(b) * tiles / G);
  const int t_end = static_cast<int>(static_cast<int64_t>(b + 1) * tiles / G);

  // query rows past Q repeat the last one; their scores are never offered
  const float4* q4 = reinterpret_cast<const float4*>(q + static_cast<size_t>(q0) * D);
  int qoff[kQueryTile];
#pragma unroll
  for (int j = 0; j < kQueryTile; ++j) qoff[j] = min(j, qn - 1) * nf;

  // A lane walks its float4 columns f = c * 32 + lane of its warp's 4 rows,
  // tile after tile: item it is column c = it % cols of tile t_begin +
  // it / cols (cols rounded up to a multiple of kColumns; columns past D
  // load as zeros and cost no memory traffic).  kColumns items' loads are
  // issued together, then multiplied.
  const int cols = ((nf + 31) / 32 + kColumns - 1) / kColumns * kColumns;
  const int items = (t_end - t_begin) * cols;
  const float4* db4 = reinterpret_cast<const float4*>(db);
  auto load = [&](int it, float4 (&a)[kRowsPerWarp]) {
    const int f = (it % cols) * 32 + lane;
    const int row0 = (t_begin + it / cols) * kRows + warp * kRowsPerWarp;
    const bool live = it < items && f < nf;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const size_t row = min(row0 + r, N - 1);    // rows past N: never offered
      a[r] = live ? __ldcs(db4 + row * nf + f) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  float acc[kRowsPerWarp][kQueryTile];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int j = 0; j < kQueryTile; ++j) acc[r][j] = 0.f;
  auto multiply = [&](int it, const float4 (&a)[kRowsPerWarp]) {
    const int f = min((it % cols) * 32 + lane, nf - 1);   // a is 0 past nf
#pragma unroll
    for (int j = 0; j < kQueryTile; ++j) {
      const float4 bq = __ldg(q4 + qoff[j] + f);
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        acc[r][j] = fmaf(a[r].x, bq.x, acc[r][j]);
        acc[r][j] = fmaf(a[r].y, bq.y, acc[r][j]);
        acc[r][j] = fmaf(a[r].z, bq.z, acc[r][j]);
        acc[r][j] = fmaf(a[r].w, bq.w, acc[r][j]);
      }
    }
  };

  WarpList list;
  list.reset();
  for (int it = 0; it < items; it += kColumns) {
    float4 a[kColumns][kRowsPerWarp];
#pragma unroll
    for (int c = 0; c < kColumns; ++c) load(it + c, a[c]);
#pragma unroll
    for (int c = 0; c < kColumns; ++c) multiply(it + c, a[c]);
    if ((it + kColumns) % cols != 0) continue;

    // the tile's last columns: reduce-scatter, so that lane l ends with the
    // score of (row l / 8, query l % 8)
    const int tile = t_begin + it / cols;
    float v[kRowsPerWarp * kQueryTile];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
      for (int j = 0; j < kQueryTile; ++j) {
        v[r * kQueryTile + j] = acc[r][j];
        acc[r][j] = 0.f;
      }
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1) {
      const bool up = lane & off;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        if (i < off) {
          const float send = up ? v[i] : v[i + off];
          const float keep = up ? v[i + off] : v[i];
          v[i] = keep + __shfl_xor_sync(kFull, send, off);
        }
      }
    }
    float* sc = scores[tile & 1];
    sc[(lane % kQueryTile) * kScoreStride + warp * kRowsPerWarp + lane / kQueryTile] = v[0];
    __syncthreads();
    if (warp < qn) {                   // warp q offers the tile's rows
#pragma unroll 1
      for (int c = 0; c < kRows / 32; ++c) {
        const int row = tile * kRows + c * 32 + lane;
        list.offer(sc[warp * kScoreStride + c * 32 + lane], row, row < N, lane, k);
      }
    }
  }

  const size_t qg = static_cast<size_t>(q0 + warp);
  if (G == 1) {                        // nothing to merge
    if (warp < qn) list.store(out_s + qg * k, out_i + qg * k, 1, lane, k, true);
    return;
  }
  // rank-major partial lists: entry (query, rank i, block b)
  if (warp < qn)
    list.store(part_s + qg * k * G + b, part_i + qg * k * G + b, G, lane, k, false);
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(&tickets[blockIdx.y], 1u) == static_cast<unsigned>(G - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();

  // the last block merges: warp q (and, past 32 lists, warp q + 8) takes
  // query q's lists (half each), rank by rank, each rank's entries loaded
  // while the previous rank is merged; then warp q merges warp q + 8's
  const int j = warp % kQueryTile;
  const int half = warp / kQueryTile;
  const int halves = G > 32 ? 2 : 1;          // a warp takes <= 64 lists
  const int per_half = (G + halves - 1) / halves;
  const int lo = half * per_half;
  const int width = max(0, min(G, lo + per_half) - lo);
  const size_t qj = static_cast<size_t>(q0 + j);
  if (j < qn && half < halves) {
    const float* ps = part_s + qj * k * G;
    const int32_t* pi = part_i + qj * k * G;
    constexpr int kLoads = kMaxBlocks / 64;
    float cs[kLoads], ns[kLoads];
    int cr[kLoads], nr[kLoads];
#pragma unroll
    for (int h = 0; h < kLoads; ++h) {
      const int bb = h * 32 + lane;
      cs[h] = bb < width ? __ldcg(ps + lo + bb) : -INFINITY;
      cr[h] = bb < width ? __ldcg(pi + lo + bb) : INT_MAX;
    }
    // the best k-th entry of any list: the k best overall come no later
    float fs = -INFINITY;
    int fr = INT_MAX;
#pragma unroll
    for (int h = 0; h < kMaxBlocks / 32; ++h) {
      const int bb = h * 32 + lane;
      const float s = bb < G ? __ldcg(ps + static_cast<size_t>(k - 1) * G + bb) : -INFINITY;
      const int r = bb < G ? __ldcg(pi + static_cast<size_t>(k - 1) * G + bb) : INT_MAX;
      if (before(s, r, fs, fr)) {
        fs = s;
        fr = r;
      }
    }
    warp_first(fs, fr);
    list.reset();
    if (fr != INT_MAX) list.set_floor(fs, fr + 1, k);   // (fs, fr) itself enters
    for (int i = 0; i < k; ++i) {
#pragma unroll
      for (int h = 0; h < kLoads; ++h) {
        const int bb = h * 32 + lane;
        const bool live = i + 1 < k && bb < width;
        const size_t at = static_cast<size_t>(i + 1) * G + lo + bb;
        ns[h] = live ? __ldcg(ps + at) : -INFINITY;
        nr[h] = live ? __ldcg(pi + at) : INT_MAX;
      }
      bool any = false;
#pragma unroll 1
      for (int h = 0; h * 32 < width; ++h) any |= list.offer(cs[h], cr[h], true, lane, k);
      // each list is sorted: if none of rank i beat the threshold, no
      // deeper entry can (and an empty rank means every list ran out)
      if (!any) break;
#pragma unroll
      for (int h = 0; h < kLoads; ++h) {
        cs[h] = ns[h];
        cr[h] = nr[h];
      }
    }
    if (half == 1) list.store(half_s[j], half_i[j], 1, lane, kMaxK, false);
  }
  __syncthreads();
  if (j < qn && half == 0) {
#pragma unroll 1
    for (int c = 0; c < 2 && halves == 2; ++c)
      list.offer(half_s[j][c * 32 + lane], half_i[j][c * 32 + lane], true, lane, k);
    list.store(out_s + qj * k, out_i + qj * k, 1, lane, k, true);
  }
  if (tid == 0) tickets[blockIdx.y] = 0;      // ready for the next launch
}

constexpr int kMergeWarps = 2;       // queries a merge block takes
constexpr int kPerLane = 16;         // entries a lane holds of a chunk
constexpr int kChunk = 32 * kPerLane;
constexpr int kMaskBytes = kChunk + 8;   // partitions a chunk can span

__device__ __forceinline__ void warp_first3(float& s, int& p, int& id) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float so = __shfl_xor_sync(kFull, s, off);
    const int po = __shfl_xor_sync(kFull, p, off);
    const int io = __shfl_xor_sync(kFull, id, off);
    if (before(so, po, s, p)) {
      s = so;
      p = po;
      id = io;
    }
  }
}

// (Q, M) scores/ids with M = P * kk, optional (Q, P) mask -> (Q, k).
// kRounds needs M <= kChunk.
template <bool kRounds>
__global__ void __launch_bounds__(kMergeWarps * 32)
merge_kernel(const float* __restrict__ s, const int32_t* __restrict__ ids,
             const uint8_t* __restrict__ mask, float* __restrict__ out_s,
             int32_t* __restrict__ out_i, int Q, int P, int kk, int k) {
  __shared__ uint8_t smask[kMergeWarps][kMaskBytes];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int qi = blockIdx.x * kMergeWarps + warp;
  if (qi >= Q) return;
  const int M = P * kk;
  const float* row_s = s + static_cast<size_t>(qi) * M;
  const int32_t* row_i = ids + static_cast<size_t>(qi) * M;
  const uint8_t* row_m = mask == nullptr ? nullptr : mask + static_cast<size_t>(qi) * P;
  const bool vec = M % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(row_s) | reinterpret_cast<uintptr_t>(row_i)) & 15) == 0;
  float* res_s = out_s + static_cast<size_t>(qi) * k;
  int32_t* res_i = out_i + static_cast<size_t>(qi) * k;

  WarpList list;
  list.reset();
  for (int c0 = 0; c0 < M; c0 += kChunk) {
    float sc[kPerLane];
    int id[kPerLane], pos[kPerLane];
    // entry j of this lane: 16-byte groups g = lane + 32 * (j / 4), or
    // scalars lane + 32 * j; past M it is (-inf, INT_MAX), after all
    if (vec) {
#pragma unroll
      for (int v = 0; v < kPerLane / 4; ++v) {
        const int e = c0 + 4 * (lane + 32 * v);
        float4 a = make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
        int4 b = make_int4(-1, -1, -1, -1);
        if (e < M) {
          a = __ldg(reinterpret_cast<const float4*>(row_s + e));
          b = __ldg(reinterpret_cast<const int4*>(row_i + e));
        }
        sc[4 * v] = a.x, sc[4 * v + 1] = a.y, sc[4 * v + 2] = a.z, sc[4 * v + 3] = a.w;
        id[4 * v] = b.x, id[4 * v + 1] = b.y, id[4 * v + 2] = b.z, id[4 * v + 3] = b.w;
#pragma unroll
        for (int t = 0; t < 4; ++t) pos[4 * v + t] = e < M ? e + t : INT_MAX;
      }
    } else {
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) {
        const int e = c0 + lane + 32 * j;
        sc[j] = e < M ? __ldg(row_s + e) : -INFINITY;
        id[j] = e < M ? __ldg(row_i + e) : -1;
        pos[j] = e < M ? e : INT_MAX;
      }
    }
    if (row_m != nullptr) {         // the chunk's partitions' mask bytes
      const int p_lo = c0 / kk;
      const int p_n = (min(M, c0 + kChunk) - 1) / kk - p_lo + 1;
      __syncwarp();                 // the previous chunk's reads are done
      for (int i = lane; i < p_n; i += 32) smask[warp][i] = __ldg(row_m + p_lo + i);
      __syncwarp();
#pragma unroll
      for (int j = 0; j < kPerLane; ++j)
        if (pos[j] != INT_MAX && !smask[warp][pos[j] / kk - p_lo]) {
          sc[j] = kNegInf;
          id[j] = -1;
        }
    }
    if constexpr (kRounds) {
      // k rounds: each lane's best entry after the last pick, then the
      // warp's; lane r % 32 keeps round r's pick
      float ls = INFINITY, o0s = kNegInf, o1s = kNegInf;
      int lp = -1, o0i = -1, o1i = -1;
      for (int r = 0; r < k; ++r) {
        float bs = -INFINITY;
        int bp = INT_MAX, bi = -1;
#pragma unroll
        for (int j = 0; j < kPerLane; ++j)
          if (before(ls, lp, sc[j], pos[j]) && before(sc[j], pos[j], bs, bp)) {
            bs = sc[j];
            bp = pos[j];
            bi = id[j];
          }
        warp_first3(bs, bp, bi);
        if (lane == (r & 31)) {
          const float fs = bp == INT_MAX ? kNegInf : bs;
          const int fi = bp == INT_MAX ? -1 : bi;
          if (r < 32) o0s = fs, o0i = fi;
          else o1s = fs, o1i = fi;
        }
        ls = bs;
        lp = bp;
      }
      if (lane < k) res_s[lane] = o0s, res_i[lane] = o0i;
      if (lane + 32 < k) res_s[lane + 32] = o1s, res_i[lane + 32] = o1i;
      return;
    } else {
#pragma unroll
      for (int j = 0; j < kPerLane; ++j)
        list.offer(sc[j], pos[j], pos[j] != INT_MAX, lane, k);
    }
  }
  if constexpr (!kRounds) {
    // the picks' ids: the entry's own, or -1 past M or under the mask
    const float ss[2] = {list.s0, list.s1};
    const int rr[2] = {list.r0, list.r1};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = lane + 32 * h;
      if (i < k) {
        const int p = rr[h];
        const bool none = p == INT_MAX;
        const bool masked = !none && row_m != nullptr && !__ldg(row_m + p / kk);
        res_s[i] = none ? kNegInf : ss[h];
        res_i[i] = none || masked ? -1 : __ldg(row_i + p);
      }
    }
  }
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return kMaxBlocks;
  return sms;
}

// As many blocks as SMs, no more than row tiles or kMaxBlocks.
int stream_blocks(int N) {
  return std::min((N + kRows - 1) / kRows, std::min(kMaxBlocks, sm_count()));
}

}  // namespace

// The scratch retrieval_topk needs: (Q, k, topk_max_blocks()) entries each
// of part_s and part_i, and ceil(Q / 8) tickets, zero before the first
// launch on a stream (each launch leaves them zero).
extern "C" int topk_max_blocks() { return kMaxBlocks; }

// The launch shape retrieval_topk takes for (Q, D) x (N, D): out =
// blocks, query tiles, threads, rows a tile.
extern "C" void topk_launch_shape(int Q, int N, int D, int* out) {
  (void)D;
  out[0] = stream_blocks(N);
  out[1] = (Q + kQueryTile - 1) / kQueryTile;
  out[2] = kStreamThreads;
  out[3] = kRows;
}

// queries (Q, D) fp32, database (N, D) fp32, both 16-byte aligned with
// D % 4 == 0 -> (Q, k) fp32 scores and int32 row ids, k <= 64.
extern "C" int retrieval_topk(const void* queries, const void* database, void* part_s,
                              void* part_i, void* tickets, void* out_s, void* out_i,
                              int Q, int N, int D, int k, void* stream) {
  if (Q <= 0 || N <= 0 || D <= 0 || D % 4 != 0 || k <= 0 || k > kMaxK)
    return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(queries) | reinterpret_cast<uintptr_t>(database)) % 16)
    return cudaErrorMisalignedAddress;
  dim3 grid(stream_blocks(N), (Q + kQueryTile - 1) / kQueryTile);
  topk_stream_kernel<<<grid, kStreamThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(queries), static_cast<const float*>(database),
      static_cast<float*>(part_s), static_cast<int32_t*>(part_i),
      static_cast<unsigned*>(tickets), static_cast<float*>(out_s),
      static_cast<int32_t*>(out_i), Q, N, D, k);
  return cudaGetLastError();
}

// The merge's selection for a row of M = P * k entries: 1 = k rounds over
// registers, 2 = the sorted warp list.
static int merge_variant(int M, int k) { return M <= kChunk && k <= kRoundsMaxK ? 1 : 2; }

// part_scores (Q, P, k) fp32, part_ids (Q, P, k) int32, mask (Q, P) uint8
// or null -> (Q, k) fp32 scores, int32 ids.  variant 0 picks by shape
// (merge_variant); 1 or 2 forces one (1 needs P * k <= 512).
extern "C" int retrieval_topk_merge(const void* part_scores, const void* part_ids,
                                    const void* mask, void* out_s, void* out_i, int Q,
                                    int P, int k, int variant, void* stream) {
  if (Q <= 0 || P <= 0 || k <= 0 || k > kMaxK) return cudaErrorInvalidValue;
  if (variant == 0) variant = merge_variant(P * k, k);
  if (variant == 1 && P * k > kChunk) return cudaErrorInvalidValue;
  const int blocks = (Q + kMergeWarps - 1) / kMergeWarps;
  auto kernel = variant == 1 ? merge_kernel<true> : merge_kernel<false>;
  kernel<<<blocks, kMergeWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part_scores), static_cast<const int32_t*>(part_ids),
      static_cast<const uint8_t*>(mask), static_cast<float*>(out_s),
      static_cast<int32_t*>(out_i), Q, P, k, k);
  return cudaGetLastError();
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
