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
// into the output block across the c steps, on inputs the wrapper pads
// to the blocks with 3.4e38 thresholds.  Here nothing is padded: the
// kernel masks the ragged c, F and Q edges itself.
//
// Bound: bytes.  The function needs no more than sorting each column,
// prefix-summing wy along it and binary-searching each threshold,
// O((c + Q) log c) per (task, feature): at the scenario path's OPT shape
// (B = 16, c = 65536, F = 8, Q = 65537) about 2.8e8 operations, 0.004 ms
// at the 67 TFLOP/s of float32 outside the tensor cores that NVIDIA's
// H100 SXM data sheet gives at the full 700 W, under the 0.031 ms its
// 105 MB of inputs and output take at 3.35 TB/s.  This dense design does
// a compare and an add per (point, threshold) pair instead, 5.5e11 pairs
// or 1.1e12 FLOP, whose floor on those cores is 16.4 ms.
//
// Design, simple first: one CTA per (task, feature, 256 thresholds),
// one threshold per thread, held in a register.  The CTA stages tiles of
// the feature's column x[b, :, f] and of wy[b, :] in shared memory; every
// thread reads the same entries (broadcasts, four at a time) and adds wy
// where x >= theta, in point-index order, into one float32 register.  No
// atomics and no tensor cores (TF32 would drop mantissa bits).  With
// integer or dyadic weights whose partial sums stay inside 24 bits the
// result is exact, so it equals ref.py bit for bit; with general weights
// it differs from another summation order by rounding only.  Left for
// later: several thresholds per thread, a sort-based or tensor-core form.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 2048;  // points staged per pass: 16 KiB of x and wy

__global__ void __launch_bounds__(kThreads)
stump_kernel(const float* __restrict__ x, const float* __restrict__ wy,
             const float* __restrict__ thetas, float* __restrict__ s, int c,
             int F, int Q) {
  __shared__ __align__(16) float sx[kTile];
  __shared__ __align__(16) float sw[kTile];
  const int q = blockIdx.x * kThreads + threadIdx.x;
  const int f = blockIdx.y;
  const int64_t b = blockIdx.z;
  const float* xb = x + b * c * F + f;  // column f of task b, stride F
  const float* wb = wy + b * c;
  const int64_t out = (b * F + f) * Q + q;
  const float th = q < Q ? thetas[out] : 0.0f;
  float acc = 0.0f;
  for (int base = 0; base < c; base += kTile) {
    const int n = min(kTile, c - base);
    __syncthreads();  // every thread is done with the previous tile
    for (int i = threadIdx.x; i < kTile; i += kThreads) {
      // past the edge: weight 0, which adds +0 and leaves acc as it is
      const bool in = i < n;
      sx[i] = in ? xb[static_cast<int64_t>(base + i) * F] : 0.0f;
      sw[i] = in ? wb[base + i] : 0.0f;
    }
    __syncthreads();
    const float4* sx4 = reinterpret_cast<const float4*>(sx);
    const float4* sw4 = reinterpret_cast<const float4*>(sw);
    const int n4 = (n + 3) / 4;
#pragma unroll 4
    for (int j = 0; j < n4; ++j) {
      const float4 xv = sx4[j];
      const float4 wv = sw4[j];
      acc = acc + (xv.x >= th ? wv.x : 0.0f);
      acc = acc + (xv.y >= th ? wv.y : 0.0f);
      acc = acc + (xv.z >= th ? wv.z : 0.0f);
      acc = acc + (xv.w >= th ? wv.w : 0.0f);
    }
  }
  if (q < Q) s[out] = acc;
}

}  // namespace

extern "C" int stump_launch(const void* x, const void* wy, const void* thetas,
                            void* s, int B, int c, int F, int Q,
                            void* stream) {
  const dim3 grid((Q + kThreads - 1) / kThreads, F, B);
  stump_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(wy),
      static_cast<const float*>(thetas), static_cast<float*>(s), c, F, Q);
  return static_cast<int>(cudaGetLastError());
}
