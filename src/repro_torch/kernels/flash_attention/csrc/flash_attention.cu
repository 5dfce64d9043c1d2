// Causal flash attention with GQA and an optional sliding window, for
// Hopper (sm_90a).
//
// Replaces src/repro/kernels/flash_attention/kernel.py::
// flash_attention_pallas (the TPU kernel _flash_kernel): the same
// function, o[b, i, h] = Σ_j softmax_j(q_i·k_j / √hd) v_j over the keys
// j ≤ i (and j > i − window with a window), query head h reading KV
// head h / (H / KV), positions counted from 0 for queries and keys.
// Masked scores are −1e30, the running max, denominator and
// accumulator are float32 whatever the input type, the denominator is
// floored at 1e−30 and the output is cast to the input type.
//
// Bound on the H100: operations.  A causal prefill of S tokens does
// S²·hd multiply-adds per head (half of QKᵀ and half of PV): at S =
// 2048, hd = 128 in bf16 that is 512 FLOP per byte of q, k, v and o,
// above the card's ridge of about 295.  This first version runs them
// as float32 FMAs on the CUDA cores, not on the tensor cores, so it sits
// far above that bound; wgmma, TMA and a pipelined K/V ring are for a
// later change.
//
// Design.  The Pallas kernel walks its (bh, iq, ik) grid in order and
// carries m, l and acc in VMEM from one ik step to the next; on the GPU
// that sequential axis becomes a loop inside one CTA.
// * One CTA per (b·h, tile of BQ = 64 queries), 256 threads as 16 × 16:
//   ty owns 4 query rows, tx 4 keys of each score tile and the hd
//   columns tx, tx + 16, … of the output.  Query tiles are issued
//   longest first (the late tiles walk the most keys).
// * The query tile stays in shared memory as float32; K and V tiles of
//   BK = 64 keys are staged after it, converted to float32, and walked
//   only from the first tile the window reaches up to the causal
//   diagonal.  Rows past S and keys past T are zero-filled and masked,
//   so the wrapper pads nothing.
// * Scores: a 4 × 4 register tile per thread from float4 reads (rows of
//   ld = hd + 4 floats keep those reads free of bank conflicts).  The
//   16 lanes that share a query row are one half-warp, so the row max
//   and sum are four shuffles, and the row's probabilities, written
//   over the K tile as Pᵀ, are read back by that warp alone.
// * m, l and the 4 × DPT accumulator slice stay in registers.
// Dynamic shared memory, (BQ·ld + max(BK·ld, BK·(BQ + 4)) + BK·16·DPT)
// floats: 98 KiB at hd = 128 (room for two CTAs per SM), 194 KiB at
// hd = 256.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;           // queries per CTA
constexpr int BK = 64;           // keys per staged tile
constexpr int THREADS = 256;     // 16 × 16
constexpr int LDP = BQ + 4;      // row stride of Pᵀ [BK][LDP]
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Stage rows [r0, r0 + BQ/BK) of one head of a [rows, heads, hd] slab
// (row stride `stride` elements) into dst[r·ld + d] as float32; rows at
// or past n_rows become zeros.
template <typename T, int ROWS>
__device__ __forceinline__ void stage(float* dst, int ld, const T* src,
                                      int64_t stride, int r0, int n_rows,
                                      int hd) {
  const int chunks = hd / 8;
  for (int idx = threadIdx.x; idx < ROWS * chunks; idx += THREADS) {
    const int r = idx / chunks;
    const int c = (idx - r * chunks) * 8;
    float v[8];
    if (r0 + r < n_rows) {
      load8(src + (int64_t)(r0 + r) * stride + c, v);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = 0.f;
    }
    float4* d4 = reinterpret_cast<float4*>(dst + r * ld + c);
    d4[0] = make_float4(v[0], v[1], v[2], v[3]);
    d4[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

size_t smem_floats(int hd, int dpt) {
  const int ld = hd + 4;
  const int kp = BK * ld > BK * LDP ? BK * ld : BK * LDP;
  return (size_t)BQ * ld + kp + (size_t)BK * 16 * dpt;
}

// q, o [B, S, H, hd]; k, v [B, T, KV, hd], contiguous.  Grid (B·H,
// ceil(S / BQ)); DPT = output columns per thread, 16·DPT ≥ hd.
template <typename T, int DPT>
__global__ void __launch_bounds__(THREADS)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int S, int Tk, int H,
          int KV, int hd, int window, float scale) {
  extern __shared__ float4 smem4[];
  float* const Qs = reinterpret_cast<float*>(smem4);   // [BQ][ld]
  const int ld = hd + 4;
  constexpr int HDP = 16 * DPT;                         // V row stride
  float* const Ks = Qs + BQ * ld;                       // [BK][ld]
  float* const Ps = Ks;                                 // Pᵀ [BK][LDP]
  float* const Vs = Ks + (BK * ld > BK * LDP ? BK * ld : BK * LDP);

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;     // longest first
  const int b = bh / H, h = bh - b * H;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int64_t q_stride = (int64_t)H * hd, kv_stride = (int64_t)KV * hd;
  const T* const qb = q + ((int64_t)b * S * H + h) * hd;
  const T* const kb = k + ((int64_t)b * Tk * KV + kvh) * hd;
  const T* const vb = v + ((int64_t)b * Tk * KV + kvh) * hd;

  // V's padding columns [hd, HDP) stay zero: the tiles write d < hd only
  for (int i = tid; i < BK * HDP; i += THREADS) Vs[i] = 0.f;
  stage<T, BQ>(Qs, ld, qb, q_stride, q0, S, hd);

  float m[4], l[4], acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < DPT; ++e) acc[i][e] = 0.f;
  }

  const int q_last = min(q0 + BQ, S) - 1;
  const int k_first = window > 0 ? max(0, q0 - window + 1) / BK * BK : 0;
  const int k_stop = min(q_last + 1, Tk);
  const float* const qrow = Qs + ty * 4 * ld;

  for (int k0 = k_first; k0 < k_stop; k0 += BK) {
    __syncthreads();             // the last tile's Pᵀ and V reads are done
    stage<T, BK>(Ks, ld, kb, kv_stride, k0, Tk, hd);
    stage<T, BK>(Vs, HDP, vb, kv_stride, k0, Tk, hd);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.f;
    const float* const krow = Ks + tx * ld;
    for (int d = 0; d < hd; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qrow + i * ld + d);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        kv[c] = *reinterpret_cast<const float4*>(krow + 16 * c * ld + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float t = s[i][c];
          t = fmaf(qv[i].x, kv[c].x, t);
          t = fmaf(qv[i].y, kv[c].y, t);
          t = fmaf(qv[i].z, kv[c].z, t);
          s[i][c] = fmaf(qv[i].w, kv[c].w, t);
        }
    }
    __syncthreads();             // every warp is done with K: Pᵀ goes there

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      bool live[4];
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kpos = k0 + tx + 16 * c;
        live[c] = kpos <= qpos && kpos < Tk &&
                  (window <= 0 || kpos > qpos - window);
        s[i][c] = live[c] ? s[i][c] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][c]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[i][c] = live[c] ? expf(s[i][c] - m_new) : 0.f;
        rs += s[i][c];
      }
      l[i] = l[i] * alpha + half_warp_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < DPT; ++e) acc[i][e] *= alpha;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
      *reinterpret_cast<float4*>(Ps + (tx + 16 * c) * LDP + ty * 4) =
          make_float4(s[0][c], s[1][c], s[2][c], s[3][c]);
    __syncwarp();                // a row's Pᵀ is written and read by one warp

    for (int j = 0; j < BK; ++j) {
      const float4 p = *reinterpret_cast<const float4*>(Ps + j * LDP + ty * 4);
      const float* const vr = Vs + j * HDP + tx;
#pragma unroll
      for (int e = 0; e < DPT; ++e) {
        const float vv = vr[16 * e];
        acc[0][e] = fmaf(p.x, vv, acc[0][e]);
        acc[1][e] = fmaf(p.y, vv, acc[1][e]);
        acc[2][e] = fmaf(p.z, vv, acc[2][e]);
        acc[3][e] = fmaf(p.w, vv, acc[3][e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty * 4 + i;
    if (qpos >= S) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    T* const orow = o + (((int64_t)b * S + qpos) * H + h) * hd;
#pragma unroll
    for (int e = 0; e < DPT; ++e) {
      const int d = tx + 16 * e;
      if (d < hd) store1(orow + d, acc[i][e] * inv);
    }
  }
}

template <typename T, int DPT>
cudaError_t launch_typed(const void* q, const void* k, const void* v,
                         void* o, int B, int S, int Tk, int H, int KV,
                         int hd, int window, float scale,
                         cudaStream_t stream) {
  const size_t bytes = smem_floats(hd, DPT) * sizeof(float);
  auto kern = flash_fwd<T, DPT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(B * H), (unsigned)((S + BQ - 1) / BQ));
  kern<<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, Tk, H, KV, hd,
      window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dpt(const void* q, const void* k, const void* v, void* o,
                       int B, int S, int Tk, int H, int KV, int hd,
                       int window, float scale, cudaStream_t stream) {
  const int need = (hd + 15) / 16;
  if (need <= 1)
    return launch_typed<T, 1>(q, k, v, o, B, S, Tk, H, KV, hd, window,
                              scale, stream);
  if (need <= 2)
    return launch_typed<T, 2>(q, k, v, o, B, S, Tk, H, KV, hd, window,
                              scale, stream);
  if (need <= 4)
    return launch_typed<T, 4>(q, k, v, o, B, S, Tk, H, KV, hd, window,
                              scale, stream);
  if (need <= 8)
    return launch_typed<T, 8>(q, k, v, o, B, S, Tk, H, KV, hd, window,
                              scale, stream);
  return launch_typed<T, 16>(q, k, v, o, B, S, Tk, H, KV, hd, window,
                             scale, stream);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  Returns the launch's
// cudaGetLastError() (cudaErrorInvalidValue for a shape it does not
// take: hd a multiple of 8 up to 256, H a multiple of KV, B·H and the
// query tiles within the grid's limits).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int S,
                                      int Tk, int H, int KV, int hd,
                                      int window, float scale, int dtype,
                                      void* stream) {
  if (B <= 0 || S <= 0 || Tk <= 0 || H <= 0 || KV <= 0 || H % KV ||
      hd <= 0 || hd % 8 || hd > 256 || (S + BQ - 1) / BQ > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)launch_dpt<float>(q, k, v, o, B, S, Tk, H, KV, hd,
                                    window, scale, st);
    case 1:
      return (int)launch_dpt<__nv_bfloat16>(q, k, v, o, B, S, Tk, H, KV,
                                            hd, window, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
