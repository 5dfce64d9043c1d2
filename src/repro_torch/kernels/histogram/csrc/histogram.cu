// Weighted per-node feature histograms for Hopper (sm_90a): the split
// finding of the histogram-tree weak learner.
//
//   hist_w [g, n, f, q] = sum over i of w [g, n, i] * 1[bin(x[g, i, f]) == q]
//   hist_wy[g, n, f, q] = sum over i of wy[g, n, i] * 1[bin(x[g, i, f]) == q]
//   bin(v) = clip(floor(v * Q), 0, Q - 1), NaN -> 0
//
// Replaces the TPU kernels src/repro/kernels/histogram/kernel.py:60
// (hist_pallas) and :106 (hist_batched_pallas): g is one task (G = 1),
// one task of a batch (G = B), or one (task, player) pair of the
// distributed growers (G = B * k).  The Pallas kernels tile (c, F, Q) in
// a sequential grid and contract a one-hot block on the MXU; nothing of
// that grid carries over.
//
// The float order is part of the function: each entry sums its points
// in k-blocks of `block` points (each block left to right from +0, the
// block sums added in order), the order XLA:CPU's dot uses for the
// reference's histogram, and ref.py repeats it, so the card, the CPU and
// the reference agree bit for bit.  No atomics and no tensor cores (TF32
// would drop mantissa bits).
//
// Bound: at the engine's shapes (B = 16, c = 400, F = 8, Q = 32, N <= 2)
// the kernel reads about 0.2 MB and writes 0.13 MB, a fraction of a
// microsecond at 3.35 TB/s, and does one add per (point, node, feature):
// far below one launch.  What it costs is latency: the chain of adds
// each output waits on, and the steps of the launch itself.
//
// Route "sort" (every shape whose per-column state fits in shared
// memory; the engine's shapes): one CTA per (g, f) column.  The CTA
// bins the column's c points once into shared memory and stages the
// weights of its task's N nodes.  A stable counting sort orders the
// point indices by bin: each warp takes a run of consecutive points and
// counts them by bin (__match_any_sync groups the lanes of a bin, the
// group's last lane adds its size); a scan over the warps and the bins
// turns the counts into each warp's first slot per bin; a second walk
// ranks each point by its slot plus the lanes of its group below it,
// which keeps index order within a bin.  Then one thread per (n, q)
// output walks its bin's run in index order, restarting its partial
// from +0 at each k-block boundary and adding the partial to the total
// when a block ends, for w and wy side by side.  The chain is a bin's
// points, about c / Q, not c.  Skipping the points outside the bin
// keeps the bits: a partial that starts at +0 is never -0 under
// round-to-nearest ((+0) + (-0) = +0, x + (-x) = +0), so adding the
// +0.0 the other points contribute leaves it as it is, for NaN and
// +-inf weights too, and an empty block adds +0 to a total that is
// never -0.
//
// Route "tiled" (the kernel's first design, for shapes whose column
// state does not fit: large Q or N): one CTA per (g, n) pair and per 256
// outputs, one thread per (f, q) output; the CTA stages a tile of
// points' bin ids (int16) and both weights in shared memory, then each
// thread walks all c points in index order and adds the weights of the
// points in its bin.
//
// Route "chunked" (the streaming tier: the reference's
// _chunked_histograms, src/repro/kernels/histogram/ops.py:44, a
// lax.scan of the kernel over point tiles): the function is the tiles'
// histograms, each in its own k-block order, folded in tile order into
// an accumulator that starts at +0.0.  Two launches, whatever the
// number of tiles: one CTA per (f, tile, g) sorts its tile's column by
// bin as route "sort" does and writes the tile's partials to a scratch
// [G, T, N, F, Q]; then one thread per output folds its T partials in
// order.  The weights stay in device memory (a tile of N nodes' weights
// does not fit in shared memory at the tier's tiles: 590 KB at 16384
// points and N = 4), so the walk reads them through L2.  Bound at the
// tier's roofline shape [N = 4, c = 10^6, F = 8, Q = 32]: about 64 MB
// read (x 32 MB, w and wy 32 MB), ~0.02 ms at 3.35 TB/s.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int16_t bin_of(float v, int bins) {
  float t = floorf(__fmul_rn(v, static_cast<float>(bins)));
  if (isnan(t)) return 0;
  t = fminf(fmaxf(t, 0.0f), static_cast<float>(bins - 1));
  return static_cast<int16_t>(t);
}

// ---------------------------------------------------------------------
// route "sort"
// ---------------------------------------------------------------------
namespace sorted {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Shared memory of one CTA, in order: w and wy float32 [N][c], the
// per-warp bin slots int32 [kWarps][bins], the bins' first slots int32
// [bins + 1], the points' bins and the sorted point indices uint16 [c]
// each.
size_t smem_bytes(int N, int c, int bins) {
  return 4 * (2 * static_cast<size_t>(N) * c +
              static_cast<size_t>(kWarps) * bins + bins + 1) +
         2 * 2 * static_cast<size_t>(c);
}

// A stable counting sort of a column's c points by bin: `order` gets
// the point indices grouped by bin in index order, `first[q]` the first
// slot of bin q (first[bins] = c).  Each warp takes a run of consecutive
// points and counts them by bin (__match_any_sync groups the lanes of a
// bin, the group's last lane adds its size); a scan over the warps and
// the bins turns the counts into each warp's first slot per bin; a
// second walk ranks each point by its slot plus the lanes of its group
// below it.  `slot` [kWarps][bins] must be zero on entry; every thread
// of the block calls it.
__device__ void sort_by_bin(const uint16_t* bin_s, uint16_t* order,
                            int* slot, int* first, int c, int bins) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // warp `warp` owns points [i0, i1), whole 32-point steps but the last
  const int per = ((c + 31) / 32 + kWarps - 1) / kWarps * 32;
  const int i0 = min(c, warp * per), i1 = min(c, i0 + per);
  int* const mine = slot + warp * bins;
  for (int s = i0; s < i1; s += 32) {          // count by bin
    const int i = s + lane;
    const bool live = i < i1;
    const uint32_t b = live ? bin_s[i] : 0xffffu;
    const uint32_t same = __match_any_sync(0xffffffffu, b);
    if (live && lane == 31 - __clz(same)) mine[b] += __popc(same);
    __syncwarp();
  }
  __syncthreads();
  // each warp's first slot per bin, bins counted from 0: warp 0 scans
  // the bins, each lane a run of `span` bins
  if (warp == 0) {
    const int span = (bins + 31) / 32;
    const int q0 = min(bins, lane * span), q1 = min(bins, q0 + span);
    int run = 0;
    for (int q = q0; q < q1; ++q) {
      int tot = 0;
      for (int v = 0; v < kWarps; ++v) {
        const int n = slot[v * bins + q];
        slot[v * bins + q] = tot;
        tot += n;
      }
      first[q] = run;                           // within this lane's span
      run += tot;
    }
    int incl = run;                             // scan the lanes' spans
#pragma unroll
    for (int off = 1; off < 32; off *= 2) {
      const int y = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += y;
    }
    const int before = incl - run;
    for (int q = q0; q < q1; ++q) first[q] += before;
    if (lane == 31) first[bins] = incl;
  }
  __syncthreads();
  for (int e = tid; e < kWarps * bins; e += kThreads)
    slot[e] += first[e % bins];
  __syncthreads();
  for (int s = i0; s < i1; s += 32) {          // stable ranks
    const int i = s + lane;
    const bool live = i < i1;
    const uint32_t b = live ? bin_s[i] : 0xffffu;
    const uint32_t same = __match_any_sync(0xffffffffu, b);
    const int below = __popc(same & ((1u << lane) - 1u));
    if (live) order[mine[b] + below] = static_cast<uint16_t>(i);
    __syncwarp();
    if (live && lane == 31 - __clz(same)) mine[b] += __popc(same);
    __syncwarp();
  }
  __syncthreads();
}

// One thread per (n, q) output: its bin's points in index order, in
// k-blocks of `block` points (each block from +0, the block sums added
// in order).  w and wy are [N][stride] (shared or device memory); the
// output of node n lies at out_w[n * out_stride + q].
__device__ void walk_bins(const uint16_t* order, const int* first,
                          const float* w, const float* wy, int64_t stride,
                          int N, int bins, int block, float* out_w,
                          float* out_wy, int64_t out_stride) {
  for (int o = threadIdx.x; o < N * bins; o += kThreads) {
    const int n = o / bins, q = o - n * bins;
    const float* wn = w + n * stride;
    const float* wyn = wy + n * stride;
    const int r0 = first[q], r1 = first[q + 1];
    float tot_w = 0.0f, tot_wy = 0.0f, part_w = 0.0f, part_wy = 0.0f;
    int next = r0 < r1 ? (order[r0] / block + 1) * block : 0;  // block end
    for (int r = r0; r < r1; ++r) {
      const int i = order[r];
      if (i >= next) {                          // a k-block ends
        tot_w = tot_w + part_w;
        tot_wy = tot_wy + part_wy;
        part_w = 0.0f;
        part_wy = 0.0f;
        next = (i / block + 1) * block;
      }
      part_w = part_w + wn[i];
      part_wy = part_wy + wyn[i];
    }
    out_w[n * out_stride + q] = tot_w + part_w;
    out_wy[n * out_stride + q] = tot_wy + part_wy;
  }
}

__global__ void __launch_bounds__(kThreads)
hist_sort(const float* __restrict__ x, const float* __restrict__ w,
          const float* __restrict__ wy, float* __restrict__ hw,
          float* __restrict__ hwy, int N, int c, int F, int bins,
          int block) {
  extern __shared__ float smem[];
  float* const w_s = smem;                                  // [N][c]
  float* const wy_s = w_s + static_cast<size_t>(N) * c;     // [N][c]
  int* const slot = reinterpret_cast<int*>(wy_s + static_cast<size_t>(N) * c);
  int* const first = slot + kWarps * bins;                  // [bins + 1]
  uint16_t* const bin_s = reinterpret_cast<uint16_t*>(first + bins + 1);
  uint16_t* const order = bin_s + c;

  const int f = blockIdx.x;
  const int64_t g = blockIdx.y;
  const int tid = threadIdx.x;
  const float* xg = x + g * c * F;
  const float* wg = w + g * N * c;
  const float* wyg = wy + g * N * c;
  for (int e = tid; e < N * c; e += kThreads) {
    w_s[e] = wg[e];
    wy_s[e] = wyg[e];
  }
  for (int i = tid; i < c; i += kThreads)
    bin_s[i] = static_cast<uint16_t>(
        bin_of(xg[static_cast<int64_t>(i) * F + f], bins));
  for (int e = tid; e < kWarps * bins; e += kThreads) slot[e] = 0;
  __syncthreads();

  sort_by_bin(bin_s, order, slot, first, c, bins);
  walk_bins(order, first, w_s, wy_s, c, N, bins, block,
            hw + (g * N * F + f) * bins, hwy + (g * N * F + f) * bins,
            static_cast<int64_t>(F) * bins);
}


// ---------------------------------------------------------------------
// route "chunked": the streaming tier's tile-by-tile histogram
// ---------------------------------------------------------------------

// Shared memory of one partials CTA: the per-warp bin slots int32
// [kWarps][bins], the bins' first slots int32 [bins + 1], the tile's
// bins and sorted point indices uint16 [tile] each.
size_t chunk_smem_bytes(int tile, int bins) {
  return 4 * (static_cast<size_t>(kWarps) * bins + bins + 1) +
         2 * 2 * static_cast<size_t>(tile);
}

// Launch 1: one CTA per (f, tile, g).  The tile's points [i0, i0 + ct)
// are sorted by bin as in route "sort"; the weights stay in device
// memory (a tile of N nodes does not fit in shared memory); one thread
// per (n, q) sums its bin's points in k-blocks of `block` and writes
// the tile's partial to part[g, tile, n, f, q].  Points of the padded
// last tile past c are not read: each adds +0.0 to bin 0, and a partial
// that starts at +0 never changes under a +0.
__global__ void __launch_bounds__(kThreads)
hist_chunk_partials(const float* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ wy, float* __restrict__ part_w,
                    float* __restrict__ part_wy, int N, int c, int F,
                    int bins, int tile, int block) {
  extern __shared__ int ismem[];
  int* const slot = ismem;                                  // [kWarps][bins]
  int* const first = slot + kWarps * bins;                  // [bins + 1]
  uint16_t* const bin_s = reinterpret_cast<uint16_t*>(first + bins + 1);
  uint16_t* const order = bin_s + tile;

  const int f = blockIdx.x;
  const int64_t t = blockIdx.y, T = gridDim.y;
  const int64_t g = blockIdx.z;
  const int i0 = static_cast<int>(t) * tile;   // < c < 2^31
  const int ct = min(tile, c - i0);
  const float* xg = x + (g * c + i0) * F;
  for (int i = threadIdx.x; i < ct; i += kThreads)
    bin_s[i] = static_cast<uint16_t>(
        bin_of(xg[static_cast<int64_t>(i) * F + f], bins));
  for (int e = threadIdx.x; e < kWarps * bins; e += kThreads) slot[e] = 0;
  __syncthreads();

  sort_by_bin(bin_s, order, slot, first, ct, bins);
  const int64_t out = ((g * T + t) * N * F + f) * bins;
  walk_bins(order, first, w + g * N * c + i0, wy + g * N * c + i0, c, N,
            bins, block, part_w + out, part_wy + out,
            static_cast<int64_t>(F) * bins);
}

// Launch 2: one thread per output (g, n, f, q) folds the T tile
// partials in tile order into an accumulator that starts at +0.0, the
// reference's lax.scan over tiles.
__global__ void __launch_bounds__(kThreads)
hist_chunk_fold(const float* __restrict__ part_w,
                const float* __restrict__ part_wy, float* __restrict__ hw,
                float* __restrict__ hwy, int T, int64_t per, int64_t total) {
  const int64_t o = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (o >= total) return;
  const int64_t g = o / per, r = o - g * per;
  const float* pw = part_w + g * T * per + r;
  const float* pwy = part_wy + g * T * per + r;
  float acc_w = 0.0f, acc_wy = 0.0f;
  for (int t = 0; t < T; ++t) {
    acc_w = acc_w + pw[t * per];
    acc_wy = acc_wy + pwy[t * per];
  }
  hw[o] = acc_w;
  hwy[o] = acc_wy;
}

}  // namespace sorted

// ---------------------------------------------------------------------
// route "tiled"
// ---------------------------------------------------------------------
namespace tiled {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
hist_tiled(const float* __restrict__ x, const float* __restrict__ w,
           const float* __restrict__ wy, float* __restrict__ hw,
           float* __restrict__ hwy, int N, int c, int F, int bins,
           int block, int tile) {
  extern __shared__ float smem[];
  float* w_s = smem;
  float* wy_s = smem + tile;
  int16_t* b_s = reinterpret_cast<int16_t*>(smem + 2 * tile);

  const int64_t gn = blockIdx.x;  // g * N + n
  const int64_t g = gn / N;
  const int fq = F * bins;
  const int out = blockIdx.y * kThreads + threadIdx.x;  // f * bins + q
  const bool mine = out < fq;
  const int f = mine ? out / bins : 0;
  const int q = mine ? out % bins : 0;
  const float* xg = x + g * c * F;
  const float* wg = w + gn * c;
  const float* wyg = wy + gn * c;

  float tot_w = 0.0f, tot_wy = 0.0f, part_w = 0.0f, part_wy = 0.0f;
  int left = block;  // points left in the current k-block
  for (int i0 = 0; i0 < c; i0 += tile) {
    const int rows = min(tile, c - i0);
    __syncthreads();  // the previous tile is consumed
    for (int e = threadIdx.x; e < rows * F; e += kThreads) {
      b_s[e] = bin_of(xg[static_cast<int64_t>(i0) * F + e], bins);
    }
    for (int r = threadIdx.x; r < rows; r += kThreads) {
      w_s[r] = wg[i0 + r];
      wy_s[r] = wyg[i0 + r];
    }
    __syncthreads();
    if (mine) {
      for (int r = 0; r < rows; ++r) {
        if (b_s[r * F + f] == q) {
          part_w = part_w + w_s[r];
          part_wy = part_wy + wy_s[r];
        }
        if (--left == 0 || i0 + r + 1 == c) {  // a k-block ends
          tot_w = tot_w + part_w;
          tot_wy = tot_wy + part_wy;
          part_w = 0.0f;
          part_wy = 0.0f;
          left = block;
        }
      }
    }
  }
  if (mine) {
    hw[gn * fq + out] = tot_w;
    hwy[gn * fq + out] = tot_wy;
  }
}

}  // namespace tiled

}  // namespace

// x: float32 [G, c, F]; w, wy: float32 [G, N, c]; hw, hwy: float32
// [G, N, F, bins]; `block` the k-block width of the summation order.
// route 0 ("sort"): `smem` must be sorted::smem_bytes(N, c, bins) (the
// layout kernel.py's plan computes), c < 65536; route 1 ("tiled"):
// `tile` points staged per pass, `smem` tile * (8 + 2F) bytes.
// Enqueues one launch on `stream` and returns cudaGetLastError()
// (cudaErrorInvalidValue for a plan it does not take).
extern "C" int histogram_launch(const void* x, const void* w,
                                const void* wy, void* hw, void* hwy, int G,
                                int N, int c, int F, int bins, int block,
                                int route, int tile, long long smem,
                                void* stream) {
  if (G <= 0 || N <= 0 || c <= 0 || F <= 0 || bins < 2 || block <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  const float* wp = static_cast<const float*>(w);
  const float* wyp = static_cast<const float*>(wy);
  float* hwp = static_cast<float*>(hw);
  float* hwyp = static_cast<float*>(hwy);
  if (route == 0) {
    if (c >= 65536 || G > 65535 ||
        smem != static_cast<long long>(sorted::smem_bytes(N, c, bins)))
      return cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          sorted::hist_sort, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return err;
    }
    sorted::hist_sort<<<dim3(F, G), sorted::kThreads, smem, s>>>(
        xp, wp, wyp, hwp, hwyp, N, c, F, bins, block);
  } else if (route == 1) {
    if (tile <= 0 ||
        smem != static_cast<long long>(tile) *
                    (2 * sizeof(float) + F * sizeof(int16_t)))
      return cudaErrorInvalidValue;
    const int fq = F * bins;
    const dim3 grid(static_cast<unsigned>(G) * static_cast<unsigned>(N),
                    (fq + tiled::kThreads - 1) / tiled::kThreads);
    tiled::hist_tiled<<<grid, tiled::kThreads, smem, s>>>(
        xp, wp, wyp, hwp, hwyp, N, c, F, bins, block, tile);
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

// The streaming tier's chunked histogram: x, w, wy, hw, hwy as above;
// part_w, part_wy float32 [G, T, N, F, bins] scratch with T =
// ceil(c / tile); `block` the k-block width inside a tile
// (ref.xla_cpu_block(tile, N)); `smem` must be
// sorted::chunk_smem_bytes(tile, bins), tile < 65536.  Enqueues two
// launches on `stream` (the tiles' partials, then their fold in tile
// order) and returns the first nonzero cudaGetLastError().
extern "C" int histogram_chunked_launch(const void* x, const void* w,
                                        const void* wy, void* part_w,
                                        void* part_wy, void* hw, void* hwy,
                                        int G, int N, int c, int F, int bins,
                                        int tile, int block, long long smem,
                                        void* stream) {
  if (G <= 0 || N <= 0 || c <= 0 || F <= 0 || bins < 2 || block <= 0 ||
      tile <= 0 || tile >= 65536 || G > 65535 ||
      smem != static_cast<long long>(sorted::chunk_smem_bytes(tile, bins)))
    return cudaErrorInvalidValue;
  const int T = (c + tile - 1) / tile;
  if (T > 65535) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sorted::hist_chunk_partials,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  float* pw = static_cast<float*>(part_w);
  float* pwy = static_cast<float*>(part_wy);
  sorted::hist_chunk_partials<<<dim3(F, T, G), sorted::kThreads, smem, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(wy), pw, pwy, N, c, F, bins, tile, block);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t per = static_cast<int64_t>(N) * F * bins;
  const int64_t total = per * G;
  const unsigned grid =
      static_cast<unsigned>((total + sorted::kThreads - 1) / sorted::kThreads);
  sorted::hist_chunk_fold<<<grid, sorted::kThreads, 0, s>>>(
      pw, pwy, static_cast<float*>(hw), static_cast<float*>(hwy), T, per,
      total);
  return static_cast<int>(cudaGetLastError());
}
