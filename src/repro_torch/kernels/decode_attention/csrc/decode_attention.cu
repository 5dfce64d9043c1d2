// Decode attention over a bf16 ring cache, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's decode attention
// (src/repro/models/attention.py::decode_attention) is a jnp einsum
// that XLA fuses.  The port's einsum path cast each layer's whole cache
// to float32 and permuted it into the layouts of its products on every
// step (nine tenths of a deepseek-7b decode step at 32 × 2048 slots),
// so this kernel reads the cache in place instead.
//
// The function, as the plain version (kernels/decode_attention/ref.py):
// one token per sequence b, query head h reading KV head h / G,
//   o[b, h] = Σ_j softmax_j(q·k_j / √hd) v_j
// over the live slots j of the cache and the token itself (its own k
// and v), live meaning the last min(len, C) positions, and with a
// window only positions p > len − window; position p sits at slot
// p mod C (a ring).  Scores are bf16 × bf16 products summed in float32,
// the softmax is float32, the weights stay float32 in the weighted sum
// (the plain version rounds them to bf16), and o is rounded to bf16
// once, in the [B, 1, H·hd] layout the output projection takes.  Slots
// that are not live carry a weight of exactly 0 in the plain version,
// so skipping them gives the same sum.  After every read of the cache,
// the token's k and v are written at slot len mod C (the oldest live
// position once len ≥ C, so the write follows the reads: see below).
//
// Bound on the H100: bytes.  With G = H / KV ≤ 8 query heads on each
// KV head, a decode token does 4·G·hd FLOPs for the 4·hd bytes of a
// slot's K and V, G FLOPs a byte (1 to 8), against the card's ridge of
// about 295: the kernel is as fast as it streams the live K/V once.
//
// Design:
// * One CTA per (split, KV head, sequence).  Each K/V tile is loaded
//   once and serves all G query heads of the group.  The live length is
//   read on the device (no host sync), and the live positions are split
//   evenly over the plan's splits (kernel.py::plan, chosen from B·KV
//   against the card's 132 SMs and the slot count).
// * 128 threads stream tiles of BN = 32 slots through a ring of 4
//   stages with 16-byte cp.async copies (a slot's row of one KV head is
//   hd·2 contiguous bytes; rows past the split's end are zero-filled).
//   Rows in shared memory are padded by one 16-byte chunk, so the eight
//   rows a quarter warp reads at one column fall in eight bank groups.
// * The products are float32 FMAs on the CUDA cores (tensor cores buy
//   nothing below the ridge).  q·k: four lanes share a row, each a
//   quarter of its chunks, summed by two shuffles; the queries sit in
//   shared memory as float32 and are read as broadcasts.  Then an
//   online softmax in the log2 domain (one lane a slot: BN is the warp
//   size), and P·V with each thread holding one 16-byte column chunk of
//   every query head for a group of rows, rescaled per tile; the row
//   groups are summed through shared memory at the end.
// * The token itself enters split 0 as its first row (weight 1 at its
//   own score), so every split's running max is either finite or has
//   no rows, and the denominator is never below 1.
// * Splits > 1 write float32 partials (acc, max, sum) to scratch that
//   the wrapper allocates, and a second small launch folds them.  A
//   second launch rather than the last CTA under an atomic ticket: a
//   ticket needs counters that outlive the call, zeroed before the first
//   launch, which would be state held beside the caller's tensors; the
//   combine is one more enqueue, only where the shapes split.
// * The write of the token's K/V at slot len mod C is folded in: an
//   unsplit CTA is the only reader of its (sequence, KV head) rows and
//   writes them after its last tile; with splits the combine writes
//   them, after the whole first launch has read the cache.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int BN = 32;           // slots per tile: one a lane in the softmax
constexpr int STAGES = 4;        // cp.async ring depth
constexpr int G_MAX = 8;         // query heads per KV head

template <int HD>
struct Geo {
  static constexpr int CH = HD / 8;           // 16-byte chunks of a row
  static constexpr int LD = CH + 1;           // row stride, chunks (odd)
  static constexpr int TILE = BN * LD * 16;   // bytes of a K or V tile
  static constexpr int RING = STAGES * 2 * TILE;
  static constexpr int RG = THREADS / CH;     // row groups of P·V
  static constexpr int SMEM =
      RING + 4 * (G_MAX * HD + G_MAX * BN + 3 * G_MAX);
  static_assert(HD % 16 == 0 && CH <= THREADS, "head dim");
  static_assert(BN == 32 && WARPS * 8 == BN, "a lane a slot, 8 rows a warp");
  static_assert(LD % 2 == 1, "odd row stride: conflict-free columns");
  static_assert(RG * G_MAX * HD * 4 <= RING, "the fold of the row groups "
                "reuses the ring");
};

struct Args {
  const __nv_bfloat16* q;       // [B, H, hd]
  const __nv_bfloat16* k_new;   // [B, KV, hd]
  const __nv_bfloat16* v_new;
  __nv_bfloat16* k;             // (b, slot, kv, d) at b·sb + slot·ss + kv·hd + d
  __nv_bfloat16* v;
  const int* lens;              // [B]
  __nv_bfloat16* out;           // [B, H, hd]
  float* part;                  // [B, KV, S, G, hd] then [B, KV, S, G, 2]
  long long sb, ss;
  int B, C, KV, G, window, splits;
  float scale_log2;             // log2(e) / √hd
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void unpack8(const uint4& raw, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The live positions of sequence b: [len − n, len), n = min(len, C,
// window − 1 with a window).
__device__ __forceinline__ int live_count(const Args& a, int len) {
  int n = min(len, a.C);
  if (a.window > 0) n = min(n, a.window - 1);
  return max(n, 0);
}

// The token's k and v of (b, kv) into slot len mod C, 16 bytes a thread.
template <int HD>
__device__ __forceinline__ void write_slot(const Args& a, int b, int kv,
                                           int len) {
  const int slot = len % a.C;
  const long long dst = (long long)b * a.sb + (long long)slot * a.ss +
                        (long long)kv * HD;
  const long long src = ((long long)b * a.KV + kv) * HD;
  for (int c = threadIdx.x; c < 2 * Geo<HD>::CH; c += THREADS) {
    const bool is_v = c >= Geo<HD>::CH;
    const int e = (is_v ? c - Geo<HD>::CH : c) * 8;
    const uint4 val = *reinterpret_cast<const uint4*>(
        (is_v ? a.v_new : a.k_new) + src + e);
    *reinterpret_cast<uint4*>((is_v ? a.v : a.k) + dst + e) = val;
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 3) decode_attn(Args a) {
  using Gm = Geo<HD>;
  constexpr int CH = Gm::CH, LD = Gm::LD, RG = Gm::RG;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem + Gm::RING);   // [G_MAX][HD]
  float* ps = qs + G_MAX * HD;                              // [G_MAX][BN]
  float* alpha = ps + G_MAX * BN;
  float* ms = alpha + G_MAX;
  float* ls = ms + G_MAX;

  const int split = blockIdx.x, kv = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = a.G;
  const int len = a.lens[b];
  const int n = live_count(a, len);
  const int j0 = (int)((long long)n * split / a.splits);
  const int j1 = (int)((long long)n * (split + 1) / a.splits);
  const int tiles = (j1 - j0 + BN - 1) / BN;
  const int first = len - n;           // the oldest live position, ≥ 0
  const __nv_bfloat16* kbase = a.k + (long long)b * a.sb + (long long)kv * HD;
  const __nv_bfloat16* vbase = a.v + (long long)b * a.sb + (long long)kv * HD;

  // tile t (live positions j0 + t·BN …) into stage t mod STAGES
  auto issue = [&](int t) {
    unsigned char* kst = smem + (t % STAGES) * 2 * Gm::TILE;
    unsigned char* vst = kst + Gm::TILE;
    const int base = j0 + t * BN;
    const int rows = min(BN, j1 - base);
    const int slot0 = (first + base) % a.C;
    for (int i = tid; i < BN * CH; i += THREADS) {
      const int r = i / CH, c = i - r * CH;
      long long off = 0;
      if (r < rows) {
        int slot = slot0 + r;          // r < rows ≤ C: one wrap at most
        if (slot >= a.C) slot -= a.C;
        off = (long long)slot * a.ss + c * 8;
      }
      const int bytes = r < rows ? 16 : 0;
      cp_async16(kst + (r * LD + c) * 16, kbase + off, bytes);
      cp_async16(vst + (r * LD + c) * 16, vbase + off, bytes);
    }
  };

#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < tiles) issue(t);
    cp_async_commit();
  }

  const __nv_bfloat16* qg = a.q + ((long long)b * a.KV * G + kv * G) * HD;
  for (int i = tid; i < G * HD; i += THREADS) qs[i] = __bfloat162float(qg[i]);
  __syncthreads();

  // P·V role: one 16-byte column chunk pc of a row group prg
  const int pc = tid % CH, prg = tid / CH;
  float acc[G_MAX][8];
#pragma unroll
  for (int g = 0; g < G_MAX; ++g)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;

  if (split == 0) {
    // the token itself, with weight 1 at its own score
    const __nv_bfloat16* kn = a.k_new + ((long long)b * a.KV + kv) * HD;
    for (int g = warp; g < G; g += WARPS) {
      float s = 0.f;
      for (int d = lane; d < HD; d += 32)
        s = fmaf(qs[g * HD + d], __bfloat162float(kn[d]), s);
      s = warp_sum(s);
      if (lane == 0) {
        ms[g] = s * a.scale_log2;
        ls[g] = 1.f;
      }
    }
    if (prg == 0) {
      float vf[8];
      unpack8(*reinterpret_cast<const uint4*>(
                  a.v_new + ((long long)b * a.KV + kv) * HD + pc * 8),
              vf);
#pragma unroll
      for (int g = 0; g < G_MAX; ++g)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[g][e] = g < G ? vf[e] : 0.f;
    }
  } else if (tid < G) {
    ms[tid] = -INFINITY;
    ls[tid] = 0.f;
  }

  // q·k role: row qr of the tile, a quarter qp of its chunks
  const int qr = warp * 8 + (lane & 7), qp = lane >> 3;
  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();   // tile t landed; every thread is done with t − 1
    if (t + STAGES - 1 < tiles) issue(t + STAGES - 1);
    cp_async_commit();
    const unsigned char* kst = smem + (t % STAGES) * 2 * Gm::TILE;
    const unsigned char* vst = kst + Gm::TILE;
    const int rows = min(BN, j1 - j0 - t * BN);

    float dot[G_MAX];
#pragma unroll
    for (int g = 0; g < G_MAX; ++g) dot[g] = 0.f;
    const uint4* krow = reinterpret_cast<const uint4*>(kst) + qr * LD;
#pragma unroll
    for (int i = 0; i < (CH + 3) / 4; ++i) {
      const int c = qp + 4 * i;
      if (c < CH) {
        float kf[8];
        unpack8(krow[c], kf);
#pragma unroll
        for (int g = 0; g < G_MAX; ++g) {
          if (g < G) {
            const float4* qv = reinterpret_cast<const float4*>(
                qs + g * HD + c * 8);
            const float4 q0 = qv[0], q1 = qv[1];
            float d = dot[g];
            d = fmaf(q0.x, kf[0], d);
            d = fmaf(q0.y, kf[1], d);
            d = fmaf(q0.z, kf[2], d);
            d = fmaf(q0.w, kf[3], d);
            d = fmaf(q1.x, kf[4], d);
            d = fmaf(q1.y, kf[5], d);
            d = fmaf(q1.z, kf[6], d);
            d = fmaf(q1.w, kf[7], d);
            dot[g] = d;
          }
        }
      }
    }
#pragma unroll
    for (int g = 0; g < G_MAX; ++g) {
      if (g < G) {
        float d = dot[g];
        d += __shfl_xor_sync(0xffffffffu, d, 8);
        d += __shfl_xor_sync(0xffffffffu, d, 16);
        if (qp == 0) ps[g * BN + qr] = qr < rows ? d * a.scale_log2 : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax: one lane a slot; every tile holds a live row
    for (int g = warp; g < G; g += WARPS) {
      const float s = ps[g * BN + lane];
      const float m_old = ms[g];
      const float m_new = fmaxf(m_old, warp_max(s));
      const float p = exp2f(s - m_new);
      const float sum = warp_sum(p);
      ps[g * BN + lane] = p;
      if (lane == 0) {
        const float al = exp2f(m_old - m_new);
        alpha[g] = al;
        ms[g] = m_new;
        ls[g] = ls[g] * al + sum;
      }
    }
    __syncthreads();

    if (prg < RG) {
#pragma unroll
      for (int g = 0; g < G_MAX; ++g) {
        if (g < G) {
          const float al = alpha[g];
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[g][e] *= al;
        }
      }
      const uint4* vt = reinterpret_cast<const uint4*>(vst);
      for (int r = prg; r < rows; r += RG) {
        float vf[8];
        unpack8(vt[r * LD + pc], vf);
#pragma unroll
        for (int g = 0; g < G_MAX; ++g) {
          if (g < G) {
            const float w = ps[g * BN + r];
#pragma unroll
            for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(w, vf[e], acc[g][e]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();     // the ring is free: it holds the row groups' sums

  float* red = reinterpret_cast<float*>(smem);      // [RG][G_MAX][HD]
  if (prg < RG) {
#pragma unroll
    for (int g = 0; g < G_MAX; ++g) {
      if (g < G) {
        float4* dst = reinterpret_cast<float4*>(
            red + (prg * G_MAX + g) * HD + pc * 8);
        dst[0] = make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
        dst[1] = make_float4(acc[g][4], acc[g][5], acc[g][6], acc[g][7]);
      }
    }
  }
  __syncthreads();
  const long long pair = (long long)b * a.KV + kv;
  for (int i = tid; i < G * HD; i += THREADS) {
    const int g = i / HD, d = i - g * HD;
    float o = 0.f;
#pragma unroll
    for (int r = 0; r < RG; ++r) o += red[(r * G_MAX + g) * HD + d];
    if (a.splits == 1) {
      a.out[(pair * G + g) * HD + d] = __float2bfloat16(o / ls[g]);
    } else {
      a.part[((pair * a.splits + split) * G + g) * HD + d] = o;
    }
  }
  if (a.splits == 1) {
    write_slot<HD>(a, b, kv, len);
  } else if (tid < G) {
    float* ml = a.part + (long long)a.B * a.KV * a.splits * G * HD;
    ml[((pair * a.splits + split) * G + tid) * 2] = ms[tid];
    ml[((pair * a.splits + split) * G + tid) * 2 + 1] = ls[tid];
  }
}

// Fold the splits' partials of one (KV head, sequence): with M the
// largest running max, o = Σ_s acc_s 2^(m_s − M) / Σ_s l_s 2^(m_s − M)
// (split 0 holds the token, so M is finite); then write the token's
// K/V into the cache, which the first launch has finished reading.
template <int HD>
__global__ void __launch_bounds__(THREADS) decode_combine(Args a) {
  const int kv = blockIdx.x, b = blockIdx.y, G = a.G, S = a.splits;
  const long long pair = (long long)b * a.KV + kv;
  const float* po = a.part + pair * S * G * HD;
  const float* ml = a.part + (long long)a.B * a.KV * S * G * HD +
                    pair * S * G * 2;
  for (int i = threadIdx.x; i < G * HD; i += THREADS) {
    const int g = i / HD, d = i - g * HD;
    float M = -INFINITY;
    for (int s = 0; s < S; ++s) M = fmaxf(M, ml[(s * G + g) * 2]);
    float l = 0.f, o = 0.f;
    for (int s = 0; s < S; ++s) {
      const float w = exp2f(ml[(s * G + g) * 2] - M);
      l = fmaf(ml[(s * G + g) * 2 + 1], w, l);
      o = fmaf(po[(s * G + g) * HD + d], w, o);
    }
    a.out[(pair * G + g) * HD + d] = __float2bfloat16(o / l);
  }
  write_slot<HD>(a, b, kv, a.lens[b]);
}

template <int HD>
cudaError_t launch_hd(const Args& a, long long smem, cudaStream_t st) {
  if (smem != Geo<HD>::SMEM) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      decode_attn<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  decode_attn<HD><<<dim3(a.splits, a.KV, a.B), THREADS, (size_t)smem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return err;
  decode_combine<HD><<<dim3(a.KV, a.B), THREADS, 0, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// q [B, 1, H, hd], k_new and v_new [B, 1, KV, hd] and out [B, 1, H·hd]
// contiguous bf16; the cache k, v [B, C, KV, hd] bf16 with strides
// (sb, ss, hd, 1) in elements; lens int32 [B]; part float32 scratch
// of B·KV·splits·G·(hd + 2) values when splits > 1 (else unused).
// scale_log2 is log2(e)/√hd, smem_bytes the plan's (kernel.py::plan).
// Returns the launches' cudaGetLastError() (cudaErrorInvalidValue for
// a shape or plan it does not take: hd in {64, 80, 128, 160}, H a
// multiple of KV with at most 8 query heads a KV head, 16-byte aligned
// strides, the grid within its limits).
extern "C" int decode_attention_launch(
    const void* q, const void* k_new, const void* v_new, void* k, void* v,
    const void* lens, void* out, void* part, int B, int C, int H, int KV,
    int hd, int window, int splits, long long sb, long long ss,
    float scale_log2, long long smem_bytes, void* stream) {
  if (B <= 0 || B > 65535 || C <= 0 || KV <= 0 || KV > 65535 || H % KV ||
      H / KV > G_MAX || window < 0 || splits <= 0 || splits > 65535 ||
      (splits > 1 && part == nullptr) || sb < 0 || ss < 0 || sb % 8 ||
      ss % 8)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k_new = static_cast<const __nv_bfloat16*>(k_new);
  a.v_new = static_cast<const __nv_bfloat16*>(v_new);
  a.k = static_cast<__nv_bfloat16*>(k);
  a.v = static_cast<__nv_bfloat16*>(v);
  a.lens = static_cast<const int*>(lens);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.part = static_cast<float*>(part);
  a.sb = sb;
  a.ss = ss;
  a.B = B;
  a.C = C;
  a.KV = KV;
  a.G = H / KV;
  a.window = window;
  a.splits = splits;
  a.scale_log2 = scale_log2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64:
      return (int)launch_hd<64>(a, smem_bytes, st);
    case 80:
      return (int)launch_hd<80>(a, smem_bytes, st);
    case 128:
      return (int)launch_hd<128>(a, smem_bytes, st);
    case 160:
      return (int)launch_hd<160>(a, smem_bytes, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
