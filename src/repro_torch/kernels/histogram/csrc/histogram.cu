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
// Bound: at the engine's shapes (B = 16, c = 400, F = 8, Q = 32, N <= 2)
// the kernel reads about 0.2 MB and writes 0.13 MB, a fraction of a
// microsecond at 3.35 TB/s, and does c * F * Q compares per (g, n): far
// below one launch.  It is launch-bound; the engine launches it once per
// tree level per round.
//
// Design, simple and exact about order: one CTA per (g, n) pair and per
// 256 outputs; one thread per (f, q) output.  The CTA stages a tile of
// points' bin ids (int16) and both weights in shared memory, then each
// thread walks the points in index order and adds the weights of the
// points in its bin.  The sum runs in k-blocks of `block` points (each
// block left to right from +0, the block sums added in order), the order
// XLA:CPU's dot uses for the reference's histogram, and ref.py repeats
// it: the card, the CPU and the reference agree bit for bit.  No atomics
// and no tensor cores (TF32 would drop mantissa bits).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int16_t bin_of(float v, int bins) {
  float t = floorf(__fmul_rn(v, static_cast<float>(bins)));
  if (isnan(t)) return 0;
  t = fminf(fmaxf(t, 0.0f), static_cast<float>(bins - 1));
  return static_cast<int16_t>(t);
}

__global__ void __launch_bounds__(kThreads)
hist_kernel(const float* __restrict__ x, const float* __restrict__ w,
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

}  // namespace

// x: float32 [G, c, F]; w, wy: float32 [G, N, c]; hw, hwy: float32
// [G, N, F, bins]; `block` the k-block width of the summation order,
// `tile` the points staged per pass (shared memory: tile * (8 + 2F)
// bytes).  Enqueues one launch on `stream` and returns
// cudaGetLastError().
extern "C" int histogram_launch(const void* x, const void* w,
                                const void* wy, void* hw, void* hwy, int G,
                                int N, int c, int F, int bins, int block,
                                int tile, void* stream) {
  const int fq = F * bins;
  const dim3 grid(static_cast<unsigned>(G) * static_cast<unsigned>(N),
                  (fq + kThreads - 1) / kThreads);
  const size_t smem = static_cast<size_t>(tile) *
                      (2 * sizeof(float) + F * sizeof(int16_t));
  hist_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(wy), static_cast<float*>(hw),
      static_cast<float*>(hwy), N, c, F, bins, block, tile);
  return static_cast<int>(cudaGetLastError());
}
