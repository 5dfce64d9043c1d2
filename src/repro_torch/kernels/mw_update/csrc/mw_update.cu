// Fused multiplicative-weights update for Hopper (sm_90a): the protocol's
// step 2(f) hit update plus the step 2(b) weight sum of the next round.
//
//   new_hits[r, i] = hits[r, i] + 1[correct[r, i] && alive[r, i]]
//   wsum[r]        = sum over alive i of 2^(shift[r] - new_hits[r, i])
//
// The caller passes each row's least alive hit count as shift[r], as
// the reference shifts by the row's largest log-weight before it sums:
// the terms stay in float32's normal range however many rounds a run
// takes, and scaling by a power of two is exact, so shift 0 gives the
// unshifted sum's bits wherever that sum is in range.
//
// Replaces the TPU kernel src/repro/kernels/mw_update/kernel.py:36
// (mw_update_pallas, body _mw_kernel at :25), which walks one row in
// sequential grid steps and leaves the partials to the caller's sum.
//
// Bound: memory.  Each element moves 10 bytes (read hits 4 + correct 1 +
// alive 1, write new_hits 4) for a handful of integer and float
// operations; the shift adds 4 bytes a row.  At the engine's main shape
// (R = 64 player rows of mloc = 2^18) that is 168 MB per round, about
// 50 us at the H100's 3.35 TB/s; at the tree path's [64, 2^14], 10.5 MB
// and 3 us, where one launch's fixed cost is most of the time.
//
// Design: one launch.  A tile of 2048 elements of one row is 64 threads.
// ref.py fixes the sum's order over 256 lanes: lane L adds the tile's
// elements L, L + 256, ... left to right, a shuffle-down tree folds each
// warp of 32 lanes, the 8 warp sums are added left to right into the
// tile's partial, and one warp folds a row's tile partials the same way
// (lane j adds partials j, j + 32, ...).  Thread t of a tile owns lanes
// 4t .. 4t + 3: at each of its 8 steps it moves elements 256 i + 4t ..
// + 3 with one int4 of hits, one of new_hits and one 4-byte word of
// correct and of alive flags, so a warp touches 512 contiguous bytes of
// hits and 128 of each flag array per step (a uint4 of 16 flags would
// pair with hits 64 bytes apart a thread, and leave each warp's 16-byte
// loads strided), and each lane's sum stays in its thread's registers.
// A warp of lanes is 8 threads: the tree's steps of 16, 8 and 4 lanes
// are shuffles of 4, 2 and 1 threads within each group of 8, its steps
// of 2 and 1 lanes adds inside the thread.
// Where m % 4 != 0 (or a pointer is not aligned) the same threads load
// one element at a time.  2^(shift - h) is built from its exponent bits,
// exact into the subnormals (ref.pow2_neg).
//
// A thread issues all 8 steps' loads before it uses any (192 bytes in
// flight), since one CTA per row leaves a 2^14-element row's 164 KB to
// one SM.  A CTA is up to 8 tiles of one row (512 threads).  A row of at
// most 8 tiles is one CTA, which folds the tile partials from shared
// memory itself.  A longer row is several CTAs: each writes its tiles'
// partials to a workspace, fences, and counts itself in at the row's
// arrival counter; the row's last CTA folds the row's partials in tile
// order (from L2), writes wsum and resets the counter to 0 for the next
// launch.  The fold order does not depend on which CTA arrives last, so
// every run gives the same bits, and the CPU's plain version gives them
// too.  The counters and partials are a workspace the wrapper keeps per
// (device, stream): two launches that overlapped would count into one
// counter, and launches on one stream never overlap.
// Left for later: fusing the hypothesis predict that produces `correct`.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 256;            // lanes of the summation order
constexpr int kItems = 8;              // elements a lane adds, kLanes apart
constexpr int kBlock = kLanes * kItems;  // elements per tile partial
constexpr int kTile = kLanes / 4;      // threads of a tile: 4 lanes each
constexpr int kMaxTiles = 8;           // tiles of one CTA (512 threads)
constexpr int kWarp = 32;

__device__ __forceinline__ float warp_fold(float v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off /= 2) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

// 2^-(h - shift) as float32 from its bits, the difference taken with
// int32 wrap-around and clamped to [0, 150]: normal down to 2^-126,
// subnormal to 2^-149, then 0 (ref.pow2_neg).
__device__ __forceinline__ float pow2_neg(int32_t h, int32_t shift) {
  int32_t d = static_cast<int32_t>(static_cast<uint32_t>(h) -
                                   static_cast<uint32_t>(shift));
  d = min(max(d, 0), 150);
  if (d <= 126) return __int_as_float((127 - d) << 23);
  return d <= 149 ? __int_as_float(1 << (149 - d)) : 0.0f;
}

// One update: new hit count and weight of an element.
__device__ __forceinline__ void update(int32_t& h, float& w, uint32_t c,
                                       uint32_t a, int32_t shift) {
  h += (a & c) ? 1 : 0;
  w = a ? pow2_neg(h, shift) : 0.0f;
}

template <bool kVec>
__global__ void __launch_bounds__(kMaxTiles * kTile)
mw_update_kernel(const int32_t* __restrict__ hits,
                 const uint8_t* __restrict__ correct,
                 const uint8_t* __restrict__ alive,
                 const int32_t* __restrict__ shift,
                 int32_t* __restrict__ new_hits, float* __restrict__ wsum,
                 float* __restrict__ partials, int* __restrict__ arrivals,
                 int m, int nb) {
  __shared__ float warp_sums[kMaxTiles][kItems];
  __shared__ float tile_sums[kMaxTiles];
  __shared__ bool last;
  const int r = blockIdx.y;
  const int sub = threadIdx.x / kTile, t = threadIdx.x % kTile;
  const int tile = blockIdx.x * (blockDim.x / kTile) + sub;
  const int64_t row = static_cast<int64_t>(r) * m;
  const int32_t sh = shift[r];

  float lane[4] = {0.0f, 0.0f, 0.0f, 0.0f};   // lanes 4t .. 4t + 3
  const int j0 = tile * kBlock + 4 * t;        // step i: j0 + i·kLanes
  if (kVec) {                                  // m % 4 == 0: all 4 or none
    int4 h[kItems];
    uint32_t c[kItems], a[kItems];
#pragma unroll
    for (int i = 0; i < kItems; ++i) {         // every load first
      const int j = j0 + i * kLanes;
      if (j < m) {
        h[i] = *reinterpret_cast<const int4*>(hits + row + j);
        c[i] = *reinterpret_cast<const uint32_t*>(correct + row + j);
        a[i] = *reinterpret_cast<const uint32_t*>(alive + row + j);
      } else {
        h[i] = make_int4(0, 0, 0, 0);
        c[i] = a[i] = 0u;                      // weight 0, never stored
      }
    }
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      float w[4];
      update(h[i].x, w[0], c[i] & 0xffu, a[i] & 0xffu, sh);
      update(h[i].y, w[1], (c[i] >> 8) & 0xffu, (a[i] >> 8) & 0xffu, sh);
      update(h[i].z, w[2], (c[i] >> 16) & 0xffu, (a[i] >> 16) & 0xffu, sh);
      update(h[i].w, w[3], c[i] >> 24, a[i] >> 24, sh);
      const int j = j0 + i * kLanes;
      if (j < m) *reinterpret_cast<int4*>(new_hits + row + j) = h[i];
#pragma unroll
      for (int e = 0; e < 4; ++e) lane[e] = lane[e] + w[e];
    }
  } else {
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int j = j0 + i * kLanes;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float w = 0.0f;
        if (j + e < m) {
          const int64_t at = row + j + e;
          int32_t h = hits[at];
          update(h, w, correct[at], alive[at], sh);
          new_hits[at] = h;
        }
        lane[e] = lane[e] + w;
      }
    }
  }
  // the shuffle-down tree of each warp of 32 lanes (8 threads): 16, 8
  // and 4 lanes are 4, 2 and 1 threads, 2 and 1 lanes inside the thread
#pragma unroll
  for (int off = 4; off > 0; off /= 2) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      lane[e] += __shfl_down_sync(0xffffffffu, lane[e], off, 8);
  }
  lane[0] += lane[2];
  lane[1] += lane[3];
  if (t % 8 == 0) warp_sums[sub][t / 8] = lane[0] + lane[1];
  __syncthreads();
  const int tiles = blockDim.x / kTile;
  if (threadIdx.x < tiles) {                   // one thread per tile
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kItems; ++w) s = s + warp_sums[threadIdx.x][w];
    tile_sums[threadIdx.x] = s;
    const int my = blockIdx.x * tiles + threadIdx.x;
    if (gridDim.x > 1 && my < nb) {
      partials[static_cast<int64_t>(r) * nb + my] = s;
      __threadfence();                         // the partial before the count
    }
  }
  __syncthreads();
  const float* p = tile_sums;
  if (gridDim.x > 1) {
    if (threadIdx.x == 0)
      last = atomicAdd(arrivals + r, 1) == static_cast<int>(gridDim.x) - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    p = partials + static_cast<int64_t>(r) * nb;
  }
  // the row's fold, in tile order: lane j adds partials j, j + 32, ...
  if (threadIdx.x < kWarp) {
    float acc = 0.0f;
    for (int j = threadIdx.x; j < nb; j += kWarp)
      acc = acc + (gridDim.x > 1 ? __ldcg(p + j) : p[j]);
    acc = warp_fold(acc);
    if (threadIdx.x == 0) {
      wsum[r] = acc;
      if (gridDim.x > 1) arrivals[r] = 0;      // ready for the next launch
    }
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

}  // namespace

// Tiles of one row: the length of the row's run of partials in the
// workspace.
extern "C" int mw_update_tiles(int m) { return (m + kBlock - 1) / kBlock; }

// hits, new_hits: int32 [rows, m]; correct, alive: uint8 (torch.bool)
// [rows, m]; shift: int32 [rows], at most each row's least alive hit
// count; wsum: float32 [rows].  Workspace: partials float32 [rows,
// mw_update_tiles(m)], arrivals int32 [rows], all 0 before the first
// launch and left 0 by every launch (read only where a row is longer
// than 8 tiles).  Enqueues one launch on `stream` and returns
// cudaGetLastError().
extern "C" int mw_update_launch(const void* hits, const void* correct,
                                const void* alive, const void* shift,
                                void* new_hits, void* wsum, void* partials,
                                void* arrivals, int rows, int m,
                                void* stream) {
  if (rows <= 0 || rows > 65535 || m <= 0) return cudaErrorInvalidValue;
  const int nb = mw_update_tiles(m);
  const int per_cta = nb < kMaxTiles ? nb : kMaxTiles;
  const dim3 grid((nb + per_cta - 1) / per_cta, rows);
  const bool vec = m % 4 == 0 && aligned(hits, 16) && aligned(new_hits, 16) &&
                   aligned(correct, 4) && aligned(alive, 4);
  auto kern = vec ? mw_update_kernel<true> : mw_update_kernel<false>;
  kern<<<grid, per_cta * kTile, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(hits), static_cast<const uint8_t*>(correct),
      static_cast<const uint8_t*>(alive), static_cast<const int32_t*>(shift),
      static_cast<int32_t*>(new_hits), static_cast<float*>(wsum),
      static_cast<float*>(partials), static_cast<int*>(arrivals), m, nb);
  return static_cast<int>(cudaGetLastError());
}
