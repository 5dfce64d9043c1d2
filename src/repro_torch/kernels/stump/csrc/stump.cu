// Weighted decision-stump scores for Hopper (sm_90a): the contraction
// behind every (feature, threshold, sign) stump's weighted error.
//
//   S[b, f, q] = sum over i of wy[b, i] * 1[x[b, i, f] >= theta[b, f, q]]
//
// x [B, c, F], wy [B, c], theta [B, F, Q] and S [B, F, Q], all float32
// and contiguous; B = 1 is the unbatched form.  The errors follow in
// closed form, err+- = (W -+ (2 S - sum wy)) / 2 (ops.stump_errors).
//
// Replaces the TPU kernels src/repro/kernels/stump/kernel.py:54
// (stump_scores_pallas) and :91 (stump_scores_batched_pallas).  Those
// walk a (F/8, Q/128, c/128) grid in order, accumulating a compare tile
// into the output block across the c steps: a compare and an add for
// every (point, threshold) pair, 5.5e11 pairs at the scenario path's
// OPT shape (B = 16, c = 65536, F = 8, Q = 65537), whose float32 floor on
// the H100 is 16.4 ms.
//
// Bound: bytes.  The function needs no more than sorting each (task,
// feature) column, prefix-summing wy along it and binary-searching each
// threshold, O((c + Q) log c) per column: about 2.8e8 operations at the
// OPT shape, 0.004 ms at the 67 TFLOP/s of float32 outside the tensor
// cores (NVIDIA's H100 SXM data sheet, 700 W), under the 0.031 ms its
// 105 MB of inputs and output take at 3.35 TB/s.  A sort moves each
// column several times, so this design sits above that bound by the
// sort's passes.
//
// Design: a chain of small kernels on one stream, each over tiles of
// 4096 keys of every (task, feature) column at once, so a launch fills
// the card whatever the number of columns; atomics only on integer
// digit counts, none on values, so every run gives the same bits.
//
// 1. stump_keys: reads x in rows of F floats (a tile of points by
//    features through shared memory, coalesced both ways) and writes one
//    order-preserving uint32 key per (task, feature, point), column-major,
//    with wy beside it.  -0.0 takes +0.0's key (-0.0 >= +0.0 in IEEE);
//    NaN takes the largest key, after +inf, with weight 0, so no
//    threshold counts it.
// 2. An LSD radix sort of (key, wy) by 8-bit digits, four passes of
//    three kernels: sort_count counts each tile's digits, sort_offsets
//    turns one column's counts into each tile's first slot per digit (in
//    tile order; a pass whose digit is the same for every key of the
//    column is skipped), and sort_scatter moves each key to its slot.
//    Within a tile each warp ranks its 512 keys with __match_any_sync
//    and the warps' counts are taken in warp order, so the scatter is
//    stable and places every point the same in every run; the tile is
//    put in digit order in shared memory first, so each digit's run is
//    written by consecutive threads.
// 3. scan_tiles, scan_columns and scan_records take the exclusive prefix
//    P of the sorted wy in float64 in a fixed fold order (16 values a
//    thread, then the warp, the block and the column's tiles in order),
//    and write one record per sorted point i, {key i, S of point i + 1},
//    S = total - P rounded once to float32: the score of a threshold
//    whose lower bound is that point (0 past the last).  Rows are padded
//    to 8 records with keys above every threshold's.  Every 2^sl-th key
//    is kept as a top level of the search.
// 4. stump_search: one thread per threshold: lower_bound of key(theta)
//    over the column's sampled keys in shared memory, then over every
//    8th key of the sample's group, then within one aligned group of 8
//    records (64 bytes) read whole; the record before the lower bound
//    holds its S (the total when no key is below).  Each thread walks
//    16 thresholds' searches level by level.  theta = NaN gives 0; -inf
//    counts every point but NaN; the 3.4e38 pad counts the points at or
//    above it, +inf included.
//
// Sums of +-1 or dyadic weights are exact in float64, so S equals the
// dense plain version (ref.py) bit for bit there; float weights differ
// from it by rounding only.  Left for later: sorting small columns in
// shared memory in one kernel, and fewer passes (a wider digit).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr uint32_t kFull = 0xffffffffu;

// key pass: a tile of kTileElems (point, feature) entries
constexpr int kKeyThreads = 256;
constexpr int kTileElems = 1024;

__device__ __forceinline__ uint32_t order_key(float v) {
  uint32_t u = __float_as_uint(v);
  if ((u & 0x7fffffffu) > 0x7f800000u) return 0xffffffffu;  // NaN
  if ((u << 1) == 0u) u = 0u;                                // -0.0 -> +0.0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// ---------------------------------------------------------------- keys
// Tile of tp points by tf features (tp * tf = kTileElems, tf a power of
// two >= F up to 32), read row by row and written column by column.
__global__ void __launch_bounds__(kKeyThreads)
stump_keys(const float* __restrict__ x, const float* __restrict__ wy,
           uint32_t* __restrict__ keys, float* __restrict__ vals, int c,
           int F, int tf_log2) {
  // tp rows of pitch tf + 1: at most 2 * kTileElems entries (tf = 1)
  __shared__ uint32_t tk[2 * kTileElems];
  __shared__ float tv[2 * kTileElems];
  const int tf = 1 << tf_log2;
  const int tp = kTileElems >> tf_log2;
  const int pitch = tf + 1;
  const int64_t b = blockIdx.z;
  const int64_t i0 = static_cast<int64_t>(blockIdx.x) * tp;
  const int f0 = blockIdx.y * tf;
  for (int t = threadIdx.x; t < kTileElems; t += kKeyThreads) {
    const int p = t >> tf_log2, f = t & (tf - 1);
    const int64_t i = i0 + p;
    if (i < c && f0 + f < F) {
      const float v = x[(b * c + i) * F + f0 + f];
      const uint32_t k = order_key(v);
      tk[p * pitch + f] = k;
      tv[p * pitch + f] = k == 0xffffffffu ? 0.0f : wy[b * c + i];
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < kTileElems; t += kKeyThreads) {
    const int f = t / tp, p = t - f * tp;
    const int64_t i = i0 + p;
    if (i < c && f0 + f < F) {
      const int64_t o = (b * F + f0 + f) * static_cast<int64_t>(c) + i;
      keys[o] = tk[p * pitch + f];
      vals[o] = tv[p * pitch + f];
    }
  }
}

// ---------------------------------------------------------------- sort
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / kWarp;
constexpr int kItems = 16;
constexpr int kSeg = kWarp * kItems;       // keys of one warp in a tile
constexpr int kTile = kThreads * kItems;   // keys of one tile: 4096
constexpr int kRadix = 256;
constexpr int kPasses = 4;
static_assert(kThreads == kRadix, "one thread per digit after ranking");

// Scratch of one call, shared by every kernel after the key pass.
// (Kernels pick keys[0] or keys[1] with a ternary, never a runtime index
// into the parameter array, which would copy it to local memory.)
struct Cols {
  uint32_t* keys[2];  // [cols, c] each: the sort's double buffer
  float* vals[2];
  int* counts;        // [cols, ntiles, 256] a pass's digit counts, then slots
  int* sel;           // [kPasses + 1, cols] buffer holding pass p's input
  int* triv;          // [kPasses, cols] pass p leaves the column as it is
  double* tsum;       // [cols, ntiles] tile sums, then tile bases
  double* total;      // [cols]
  uint2* rec;         // [cols, cpad] {key, S bits of the next point}
  uint32_t* samples;  // [cols, nsamp] every 2^sl-th sorted key
  int c, cpad, ntiles, cols, sl, nsamp;
};

__device__ __forceinline__ uint32_t lanemask_lt() {
  uint32_t m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

__device__ __forceinline__ int64_t col_of_grid() {
  return static_cast<int64_t>(blockIdx.z) * gridDim.y + blockIdx.y;
}

// The tile's keys of this thread: item j at tile offset
// warp * kSeg + j * 32 + lane (each load coalesced across the warp).
__device__ __forceinline__ int item_index(int tile, int j) {
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  return tile * kTile + warp * kSeg + j * kWarp + lane;
}

// Stable ranks of a warp's keys by one digit: rank[j] counts the keys of
// the warp's segment before item j with its digit; wc (the warp's 256
// counters, zero on entry) ends holding the segment's count per digit.
__device__ __forceinline__ void warp_rank(const uint32_t (&k)[kItems],
                                          int tile, int c, int shift,
                                          int* wc, int (&rank)[kItems]) {
  const int lane = threadIdx.x % kWarp;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const bool valid = item_index(tile, j) < c;
    const uint32_t d = (k[j] >> shift) & 0xffu;
    // past the edge: a value no valid lane holds
    const uint32_t peers = __match_any_sync(kFull, valid ? d : kRadix + lane);
    const int old = valid ? wc[d] : 0;
    __syncwarp();
    if (valid && lane == __ffs(peers) - 1) wc[d] = old + __popc(peers);
    __syncwarp();
    rank[j] = old + __popc(peers & lanemask_lt());
  }
}

__device__ __forceinline__ void load_keys(const uint32_t* src, int tile,
                                          int c, uint32_t (&k)[kItems]) {
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int i = item_index(tile, j);
    k[j] = i < c ? src[i] : 0u;
  }
}

__global__ void __launch_bounds__(kThreads)
sort_count(Cols t, int p) {
  __shared__ int wc[kWarps][kRadix];
  const int64_t col = col_of_grid();
  const int tile = blockIdx.x, warp = threadIdx.x / kWarp;
  for (int i = threadIdx.x; i < kWarps * kRadix; i += kThreads)
    (&wc[0][0])[i] = 0;
  __syncthreads();
  const int s = p == 0 ? 0 : t.sel[p * t.cols + col];
  uint32_t k[kItems];
  load_keys((s ? t.keys[1] : t.keys[0]) + col * t.c, tile, t.c, k);
#pragma unroll
  for (int j = 0; j < kItems; ++j)  // integer counts: any order, same sum
    if (item_index(tile, j) < t.c)
      atomicAdd(&wc[warp][(k[j] >> (8 * p)) & 0xffu], 1);
  __syncthreads();
  int n = 0;
  for (int w = 0; w < kWarps; ++w) n += wc[w][threadIdx.x];
  t.counts[(col * t.ntiles + tile) * kRadix + threadIdx.x] = n;
}

// One block of 256 threads per column, thread d for digit d: the
// column's count of d over its tiles, the exclusive scan over digits,
// then each tile's first slot for d, in tile order.
__global__ void __launch_bounds__(kRadix)
sort_offsets(Cols t, int p) {
  __shared__ int wsum[kRadix / kWarp];
  const int64_t col = static_cast<int64_t>(blockIdx.y) * gridDim.x +
                      blockIdx.x;
  const int d = threadIdx.x, lane = d % kWarp, warp = d / kWarp;
  int* cnt = t.counts + col * t.ntiles * kRadix + d;
  int tot = 0;
  for (int tile = 0; tile < t.ntiles; ++tile) tot += cnt[tile * kRadix];
  int incl = tot;
#pragma unroll
  for (int off = 1; off < kWarp; off *= 2) {
    const int y = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == kWarp - 1) wsum[warp] = incl;
  const int same = __syncthreads_or(tot == t.c);
  int run = incl - tot;
  for (int w = 0; w < warp; ++w) run += wsum[w];
  const int s = p == 0 ? 0 : t.sel[p * t.cols + col];
  if (d == 0) {
    if (p == 0) t.sel[col] = 0;
    t.triv[p * t.cols + col] = same;
    t.sel[(p + 1) * t.cols + col] = same ? s : s ^ 1;
  }
  if (same) return;
  for (int tile = 0; tile < t.ntiles; ++tile) {
    const int n = cnt[tile * kRadix];
    cnt[tile * kRadix] = run;
    run += n;
  }
}

// The tile is first put in digit order in shared memory (stable: warp,
// then item, then lane order within a digit), then written out so that
// consecutive threads write consecutive slots of a digit's run.
__global__ void __launch_bounds__(kThreads)
sort_scatter(Cols t, int p) {
  __shared__ int wc[kWarps][kRadix];
  __shared__ int start[kRadix];   // the digit's first place in the tile
  __shared__ int delta[kRadix];   // its slot in the column minus that place
  __shared__ int wtot[kWarps];
  __shared__ uint32_t sk[kTile];
  __shared__ float sv[kTile];
  const int64_t col = col_of_grid();
  if (t.triv[p * t.cols + col]) return;  // uniform across the block
  const int tile = blockIdx.x, lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp, shift = 8 * p;
  for (int i = threadIdx.x; i < kWarps * kRadix; i += kThreads)
    (&wc[0][0])[i] = 0;
  __syncthreads();
  const int s = t.sel[p * t.cols + col];
  const uint32_t* src_k = (s ? t.keys[1] : t.keys[0]) + col * t.c;
  const float* src_v = (s ? t.vals[1] : t.vals[0]) + col * t.c;
  uint32_t* dst_k = (s ? t.keys[0] : t.keys[1]) + col * t.c;
  float* dst_v = (s ? t.vals[0] : t.vals[1]) + col * t.c;
  uint32_t k[kItems];
  float v[kItems];
  int rank[kItems];
  load_keys(src_k, tile, t.c, k);
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int i = item_index(tile, j);
    v[j] = i < t.c ? src_v[i] : 0.0f;
  }
  warp_rank(k, tile, t.c, shift, wc[warp], rank);
  __syncthreads();
  {  // digit d = thread: warp-ordered places within the tile's run of d
    const int d = threadIdx.x;
    int n = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int x = wc[w][d];
      wc[w][d] = n;
      n += x;
    }
    int incl = n;  // exclusive scan of the tile's digit counts
#pragma unroll
    for (int off = 1; off < kWarp; off *= 2) {
      const int y = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += y;
    }
    if (lane == kWarp - 1) wtot[warp] = incl;
    __syncthreads();
    int first = incl - n;
    for (int w = 0; w < warp; ++w) first += wtot[w];
    start[d] = first;
    delta[d] = t.counts[(col * t.ntiles + tile) * kRadix + d] - first;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (item_index(tile, j) < t.c) {
      const uint32_t d = (k[j] >> shift) & 0xffu;
      const int at = start[d] + wc[warp][d] + rank[j];
      sk[at] = k[j];
      sv[at] = v[j];
    }
  }
  __syncthreads();
  const int n = min(kTile, t.c - tile * kTile);
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const uint32_t key = sk[i];
    const int pos = i + delta[(key >> shift) & 0xffu];
    dst_k[pos] = key;
    dst_v[pos] = sv[i];
  }
}

// ---------------------------------------------------------------- scan
// Thread t folds the tile's 16 consecutive sorted values from 16 t on;
// they pass through shared memory, loaded and stored coalesced, at
// index i + i / 16 so the thread's 16 reads fall in 16 distinct banks
// and the warp's in 32.
constexpr int kPadded = kTile + kTile / kItems;

__device__ __forceinline__ int padded(int i) { return i + i / kItems; }

// Loads the tile's sorted values into `stage` and returns this thread's
// 16 in float64 and their sum, folded left to right.
__device__ __forceinline__ double thread_values(const float* v, int tile,
                                                int c, float* stage,
                                                double (&x)[kItems]) {
  const int base = tile * kTile;
  for (int i = threadIdx.x; i < kTile; i += kThreads)
    stage[padded(i)] = base + i < c ? v[base + i] : 0.0f;
  __syncthreads();
  double sum = 0.0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    x[j] = static_cast<double>(stage[padded(threadIdx.x * kItems + j)]);
    sum = sum + x[j];
  }
  return sum;
}

__global__ void __launch_bounds__(kThreads)
scan_tiles(Cols t) {
  __shared__ float stage[kPadded];
  __shared__ double wsum[kWarps];
  const int64_t col = col_of_grid();
  const int tile = blockIdx.x, lane = threadIdx.x % kWarp;
  const int s = t.sel[kPasses * t.cols + col];
  double x[kItems];
  double sum = thread_values((s ? t.vals[1] : t.vals[0]) + col * t.c, tile,
                             t.c, stage, x);
#pragma unroll
  for (int off = kWarp / 2; off > 0; off /= 2)
    sum = sum + __shfl_down_sync(kFull, sum, off);
  if (lane == 0) wsum[threadIdx.x / kWarp] = sum;
  __syncthreads();
  if (threadIdx.x == 0) {
    double tot = 0.0;
    for (int w = 0; w < kWarps; ++w) tot = tot + wsum[w];
    t.tsum[col * t.ntiles + tile] = tot;
  }
}

// One thread per column: the tiles' sums become their bases, in order.
__global__ void scan_columns(Cols t) {
  const int64_t col = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (col >= t.cols) return;
  double* ts = t.tsum + col * t.ntiles;
  double run = 0.0;
  for (int tile = 0; tile < t.ntiles; ++tile) {
    const double x = ts[tile];
    ts[tile] = run;
    run = run + x;
  }
  t.total[col] = run;
}

__global__ void __launch_bounds__(kThreads)
scan_records(Cols t) {
  __shared__ float stage[kPadded];
  __shared__ double wsum[kWarps];
  const int64_t col = col_of_grid();
  const int tile = blockIdx.x, lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int s = t.sel[kPasses * t.cols + col];
  double x[kItems];
  const double sum = thread_values((s ? t.vals[1] : t.vals[0]) + col * t.c,
                                   tile, t.c, stage, x);
  double incl = sum;
#pragma unroll
  for (int off = 1; off < kWarp; off *= 2) {
    const double y = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl = incl + y;
  }
  double excl = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) excl = 0.0;
  if (lane == kWarp - 1) wsum[warp] = incl;
  __syncthreads();
  double run = t.tsum[col * t.ntiles + tile];
  for (int w = 0; w < warp; ++w) run = run + wsum[w];
  run = run + excl;
  const double total = t.total[col];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {  // the next point's S in their place
    run = run + x[j];
    stage[padded(threadIdx.x * kItems + j)] =
        static_cast<float>(total - run);
  }
  __syncthreads();
  const uint32_t* K = (s ? t.keys[1] : t.keys[0]) + col * t.c;
  uint2* rec = t.rec + col * t.cpad;
  const int base = tile * kTile;
  const int n = min(kTile, t.cpad - base);
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int at = base + i;
    if (at < t.c) {  // past the last point nothing counts: S = 0 exactly
      const uint32_t key = K[at];
      rec[at] = make_uint2(
          key, at == t.c - 1 ? 0u : __float_as_uint(stage[padded(i)]));
      if ((at & ((1 << t.sl) - 1)) == 0)
        t.samples[col * t.nsamp + (at >> t.sl)] = key;
    } else {  // the row's pad: above every threshold's key
      rec[at] = make_uint2(0xffffffffu, 0u);
    }
  }
}

// -------------------------------------------------------------- search
constexpr int kSearchThreads = 256;
constexpr int kSearchItems = 16;
constexpr int kSearchTile = kSearchThreads * kSearchItems;
constexpr int kMaxSamples = 8192;  // 32 KB of shared memory
constexpr int kGroupLog2 = 3;  // the last level: 2^3 records, 64 bytes
constexpr int kGroup = 1 << kGroupLog2;

// Each thread takes 16 thresholds 256 apart and walks their searches
// level by level, so 16 independent probes are in flight at each level
// (branch-free: the same steps for every lane).  The last level reads
// one aligned group of kGroup records whole.
__global__ void __launch_bounds__(kSearchThreads)
stump_search(const uint2* __restrict__ rec,
             const uint32_t* __restrict__ samples,
             const double* __restrict__ total,
             const float* __restrict__ thetas, float* __restrict__ s, int c,
             int cpad, int Q, int sl, int nsamp) {
  extern __shared__ uint32_t top[];
  const int64_t col = col_of_grid();
  for (int j = threadIdx.x; j < nsamp; j += kSearchThreads)
    top[j] = samples[col * nsamp + j];
  __syncthreads();
  const uint2* R = rec + col * cpad;
  const float all = c > 0 ? static_cast<float>(total[col]) : 0.0f;
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * kSearchTile +
                     threadIdx.x;
  uint32_t kt[kSearchItems];
  int a[kSearchItems];
  bool live[kSearchItems];
#pragma unroll
  for (int j = 0; j < kSearchItems; ++j) {
    const int64_t q = q0 + j * kSearchThreads;
    const float th = q < Q ? thetas[col * Q + q] : 0.0f;
    live[j] = q < Q && th == th;  // a NaN threshold counts nothing
    kt[j] = order_key(th);
    a[j] = 0;
  }
  // a[j]: the number of samples below kt[j]
  int step = 1;
  while (step * 2 <= nsamp) step *= 2;
  for (; step > 0; step >>= 1) {
#pragma unroll
    for (int j = 0; j < kSearchItems; ++j) {
      const int next = a[j] + step;
      if (next <= nsamp && top[next - 1] < kt[j]) a[j] = next;
    }
  }
  // None below: every point counts.  Else the sample group a - 1 holds
  // the last key below; a[j] becomes the last kGroup-aligned point below
  // kt within it (2^sl / kGroup - 1 more steps; points past c hold the
  // pad).
#pragma unroll
  for (int j = 0; j < kSearchItems; ++j)
    a[j] = a[j] == 0 ? -1 : (a[j] - 1) << sl;
  for (int half = sl > kGroupLog2 ? 1 << (sl - kGroupLog2 - 1) : 0;
       half > 0; half >>= 1) {
#pragma unroll
    for (int j = 0; j < kSearchItems; ++j) {
      const int next = a[j] + kGroup * half;
      if (a[j] >= 0 && next < cpad && R[next].x < kt[j]) a[j] = next;
    }
  }
  // lower_bound(kt) = a + m, m >= 1 the group's keys below kt; the
  // record before it holds S of the lower bound
#pragma unroll
  for (int j = 0; j < kSearchItems; ++j) {
    float out = all;
    if (a[j] >= 0) {
      const uint4* g = reinterpret_cast<const uint4*>(R + a[j]);
      uint4 grp[kGroup / 2];
#pragma unroll
      for (int r = 0; r < kGroup / 2; ++r) grp[r] = g[r];
      int m = 0;
#pragma unroll
      for (int r = 0; r < kGroup / 2; ++r)
        m += (grp[r].x < kt[j]) + (grp[r].z < kt[j]);
      uint32_t bits = grp[0].y;
#pragma unroll
      for (int r = 0; r < kGroup / 2; ++r) {
        bits = m - 1 == 2 * r ? grp[r].y : bits;
        bits = m - 1 == 2 * r + 1 ? grp[r].w : bits;
      }
      out = __uint_as_float(bits);
    }
    const int64_t q = q0 + j * kSearchThreads;
    if (q < Q) s[col * Q + q] = live[j] ? out : 0.0f;
  }
}

// Where each scratch array of one call lies, 128-byte aligned.
struct Layout {
  int64_t keys, vals, counts, sel, triv, tsum, total, rec, samples, bytes;
};

int64_t align128(int64_t n) {
  return (n + 127) & ~static_cast<int64_t>(127);
}

Layout layout(int B, int c, int F, int sl) {
  const int64_t cols = static_cast<int64_t>(B) * F;
  const int64_t ntiles = (static_cast<int64_t>(c) + kTile - 1) / kTile;
  const int64_t nsamp = (static_cast<int64_t>(c) + (1 << sl) - 1) >> sl;
  Layout l{};
  int64_t at = 0;
  l.keys = at; at += align128(2 * cols * c * 4);
  l.vals = at; at += align128(2 * cols * c * 4);
  l.counts = at; at += align128(cols * ntiles * kRadix * 4);
  l.sel = at; at += align128((kPasses + 1) * cols * 4);
  l.triv = at; at += align128(kPasses * cols * 4);
  l.tsum = at; at += align128(cols * ntiles * 8);
  l.total = at; at += align128(cols * 8);
  l.rec = at; at += align128(cols * ((c + kGroup - 1LL) & -kGroup) * 8);
  l.samples = at; at += align128(cols * nsamp * 4);
  l.bytes = at;
  return l;
}

}  // namespace

// The scratch bytes one call on x [B, c, F] with sample stride 2^sl takes.
extern "C" int64_t stump_scratch_bytes(int B, int c, int F, int sl) {
  return layout(B, c, F, sl).bytes;
}

// x [B, c, F], wy [B, c], thetas and s [B, F, Q]: float32.  scratch:
// stump_scratch_bytes(B, c, F, sl) bytes, 128-byte aligned.  tf_log2:
// log2 of the key pass's feature tile (a power of two >= F, at most 32);
// sl: log2 of the search's sample stride.  Enqueues every kernel on
// `stream` and returns the first CUDA error (1 for a shape or plan the
// kernels do not take).
extern "C" int stump_launch(const void* x, const void* wy, const void* thetas,
                            void* s, void* scratch, int B, int c, int F,
                            int Q, int tf_log2, int sl, void* stream) {
  const int64_t nsamp = (static_cast<int64_t>(c) + (1 << sl) - 1) >> sl;
  if (tf_log2 < 0 || tf_log2 > 5 || sl < kGroupLog2 || sl > 30 ||
      nsamp > kMaxSamples || c < 0 || B < 1 || F < 1 || Q < 1 ||
      B > 65535 || F > 65535 || static_cast<int64_t>(B) * F > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Layout l = layout(B, c, F, sl);
  char* base = static_cast<char*>(scratch);
  Cols t;
  const int64_t cols = static_cast<int64_t>(B) * F;
  t.keys[0] = reinterpret_cast<uint32_t*>(base + l.keys);
  t.keys[1] = t.keys[0] + cols * c;
  t.vals[0] = reinterpret_cast<float*>(base + l.vals);
  t.vals[1] = t.vals[0] + cols * c;
  t.counts = reinterpret_cast<int*>(base + l.counts);
  t.sel = reinterpret_cast<int*>(base + l.sel);
  t.triv = reinterpret_cast<int*>(base + l.triv);
  t.tsum = reinterpret_cast<double*>(base + l.tsum);
  t.total = reinterpret_cast<double*>(base + l.total);
  t.rec = reinterpret_cast<uint2*>(base + l.rec);
  t.samples = reinterpret_cast<uint32_t*>(base + l.samples);
  t.c = c;
  t.cpad = (c + kGroup - 1) & -kGroup;
  t.ntiles = static_cast<int>((static_cast<int64_t>(c) + kTile - 1) / kTile);
  t.cols = static_cast<int>(cols);
  t.sl = sl;
  t.nsamp = static_cast<int>(nsamp);
  if (c > 0) {
    const int tp = kTileElems >> tf_log2;
    stump_keys<<<dim3((c + tp - 1) / tp,
                      (F + (1 << tf_log2) - 1) >> tf_log2, B),
                 kKeyThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(wy),
        t.keys[0], t.vals[0], c, F, tf_log2);
    const dim3 tiles(t.ntiles, F, B), columns(F, B);
    for (int p = 0; p < kPasses; ++p) {
      sort_count<<<tiles, kThreads, 0, st>>>(t, p);
      sort_offsets<<<columns, kRadix, 0, st>>>(t, p);
      sort_scatter<<<tiles, kThreads, 0, st>>>(t, p);
    }
    scan_tiles<<<tiles, kThreads, 0, st>>>(t);
    scan_columns<<<static_cast<unsigned>((cols + 127) / 128), 128, 0, st>>>(
        t);
    scan_records<<<tiles, kThreads, 0, st>>>(t);
  }
  const int search_smem = static_cast<int>(nsamp * sizeof(uint32_t));
  const dim3 sgrid(static_cast<unsigned>((Q + kSearchTile - 1) / kSearchTile),
                   F, B);
  stump_search<<<sgrid, kSearchThreads, search_smem, st>>>(
      t.rec, t.samples, t.total, static_cast<const float*>(thetas),
      static_cast<float*>(s), c, t.cpad, Q, sl, static_cast<int>(nsamp));
  return static_cast<int>(cudaGetLastError());
}
