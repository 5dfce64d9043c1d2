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
// 50 us at the H100's 3.35 TB/s.
//
// Design, simple first: pass 1 runs one block per (2048-element tile,
// row); each of 256 threads reads 8 elements 256 apart (coalesced),
// writes new_hits and sums its weights left to right, a shuffle-down tree
// folds each warp, and thread 0 adds the 8 warp sums left to right into
// the tile's partial.  Pass 2 folds each row's partials with one warp in
// the same way.  No atomics, so every run gives the same bits, and
// ref.py repeats this exact order so the CPU and the card agree bit for
// bit.  Left for later: 16-byte vector loads, and fusing the hypothesis
// predict that produces `correct`.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kBlock = kThreads * kItems;
constexpr int kWarp = 32;

__device__ __forceinline__ float warp_fold(float v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off /= 2) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
mw_tiles(const int32_t* __restrict__ hits, const uint8_t* __restrict__ correct,
         const uint8_t* __restrict__ alive, const int32_t* __restrict__ shift,
         int32_t* __restrict__ new_hits, float* __restrict__ partials,
         int m) {
  const int64_t row_off = static_cast<int64_t>(blockIdx.y) * m;
  const int base = blockIdx.x * kBlock;
  const int32_t row_shift = shift[blockIdx.y];
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int j = base + i * kThreads + threadIdx.x;
    float w = 0.0f;
    if (j < m) {
      const int64_t e = row_off + j;
      const uint8_t a = alive[e];
      const int32_t h = hits[e] + ((correct[e] & a) ? 1 : 0);
      new_hits[e] = h;
      w = a ? ldexpf(1.0f, row_shift - h) : 0.0f;  // 2^(shift-h) exactly
    }
    acc = acc + w;
  }
  __shared__ float warp_sums[kThreads / kWarp];
  acc = warp_fold(acc);
  if (threadIdx.x % kWarp == 0) warp_sums[threadIdx.x / kWarp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.0f;
    for (int w = 0; w < kThreads / kWarp; ++w) s = s + warp_sums[w];
    partials[static_cast<int64_t>(blockIdx.y) * gridDim.x + blockIdx.x] = s;
  }
}

__global__ void __launch_bounds__(kWarp)
mw_rows(const float* __restrict__ partials, float* __restrict__ wsum, int nb) {
  const float* row = partials + static_cast<int64_t>(blockIdx.x) * nb;
  float acc = 0.0f;
  for (int j = threadIdx.x; j < nb; j += kWarp) acc = acc + row[j];
  acc = warp_fold(acc);
  if (threadIdx.x == 0) wsum[blockIdx.x] = acc;
}

}  // namespace

// hits, new_hits: int32 [rows, m]; correct, alive: uint8 (torch.bool)
// [rows, m]; shift: int32 [rows], at most each row's least alive hit
// count; partials: float32 [rows, ceil(m / 2048)]; wsum: float32 [rows].
// Enqueues both passes on `stream` and returns cudaGetLastError().
extern "C" int mw_update_launch(const void* hits, const void* correct,
                                const void* alive, const void* shift,
                                void* new_hits, void* partials, void* wsum,
                                int rows, int m, void* stream) {
  const int nb = (m + kBlock - 1) / kBlock;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  mw_tiles<<<dim3(nb, rows), kThreads, 0, s>>>(
      static_cast<const int32_t*>(hits), static_cast<const uint8_t*>(correct),
      static_cast<const uint8_t*>(alive), static_cast<const int32_t*>(shift),
      static_cast<int32_t*>(new_hits), static_cast<float*>(partials), m);
  mw_rows<<<rows, kWarp, 0, s>>>(static_cast<const float*>(partials),
                                 static_cast<float*>(wsum), nb);
  return static_cast<int>(cudaGetLastError());
}
