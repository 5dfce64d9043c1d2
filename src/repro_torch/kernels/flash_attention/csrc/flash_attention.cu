// Causal flash attention with GQA and an optional sliding window, for
// Hopper (sm_90a).
//
// Replaces src/repro/kernels/flash_attention/kernel.py::
// flash_attention_pallas (the TPU kernel _flash_kernel): the same
// function, o[b, i, h] = Σ_j softmax_j(q_i·k_j / √hd) v_j over the keys
// j ≤ i (and j > i − window with a window), query head h reading KV
// head h / (H / KV), positions counted from 0 for queries and keys.
// Masked scores are −1e30 (−inf here: a masked key adds exactly 0),
// the running max, denominator and accumulator are float32 whatever
// the input type, the denominator is floored at 1e−30 and the output is
// cast to the input type.
//
// Bound on the H100: operations.  A causal prefill of S tokens does
// S²·hd multiply-adds per head (half of QKᵀ and half of PV): at S =
// 2048, hd = 128 in bf16 that is 512 FLOP per byte of q, k, v and o,
// above the card's ridge of about 295, so the products belong on the
// tensor cores.
//
// Two routes, chosen by the input type; the tile plan of each (tiles,
// stages, threads, shared-memory bytes) is computed in Python
// (kernels/flash_attention/kernel.py::plan) and checked here.
//
// Route "wgmma", bf16 (the LM prefill's), after FlashAttention-3:
// * One CTA per (b·h, tile of BQ = 128 queries).  The grid runs groups
//   of head_group (b, h) pairs, each group's query tiles longest first,
//   so the K/V a group streams stay in L2 while all its tiles read them
//   (all B·H pairs at once stream 128 MB through the 50 MB L2 at the LM
//   slice's shape).  384 threads in three warpgroups: a producer, whose
//   one elected thread starts every TMA load and which gives its
//   registers away (setmaxnreg 24), and two consumers of 64 query rows
//   each (setmaxnreg 240).  ptxas still compiles every thread within the
//   launch bound's 168 registers (a 288-thread block, one producer warp,
//   gets no more: its ninth warp shares an SM sub-partition's 16,384
//   registers with two others), so a consumer runs S, softmax and P·V
//   in turn (no second S buffer), BC keys at a time whatever the
//   stage's BK: 64 (16 at hd 256, where O alone takes 128 registers),
//   which keeps S and P to BC / 2 registers beside O, so every plan
//   builds without spills; the two consumers overlap each other.
// * TMA over the model layout: tensor maps of dims (hd, heads, S, B),
//   boxes of 64 head-dim columns (128 bytes, one 128-byte swizzle row) ×
//   1 head × BQ or BK rows.  Rows past S or T and columns past hd come
//   in as zeros, so the wrapper pads nothing; zero columns add nothing
//   to q·k and the output's are never stored.
// * Shared memory: the Q tile, then a ring of STAGES K/V stages, each
//   with a full mbarrier (the producer's expect_tx, completed by the
//   TMA bytes) and an empty one (256 consumer arrivals).
// * S = QKᵀ over BC keys of the stage at a time: wgmma m64nBCk16
//   with Q and K both K-major in shared memory; the descriptors use the
//   128-byte swizzle the tensor maps write, on 1024-byte aligned bases.
// * Online softmax in registers in the log2 domain (the scale times
//   log2 e folded into one FMA before ex2).  The causal and window
//   masks are applied only on tiles that hold a masked key; a tile no
//   row of a consumer can see is skipped by that consumer.
// * O += P·V with P kept at float32 precision, as the reference keeps
//   it: each p splits into hi = bf16(p) and lo = bf16(p − hi) (p − hi
//   is exact), and both products go into the float32 accumulator, O +=
//   P_hi·V + P_lo·V.  V is bf16 already, so the products are exact and
//   hi + lo carries about 16 bits of p: a term errs by about 2^−17 of
//   itself, not the 2^−9 of P rounded to bf16.  Both are A fragments
//   straight from S's accumulator layout; V is the B operand read
//   MN-major (the transpose bit), one m64nHDPk16 per 16 keys for each
//   of hi and lo, all in one commit group.  The fragments take the
//   registers S leaves (8 values of S make 4 + 4 packed words), so the
//   live set stays S's and every plan builds without spills.
// * Epilogue: acc / max(l, 1e−30) in float32, cast to bf16 into the
//   consumer's own rows of the Q tile (swizzled), and a TMA store that
//   clips rows at or past S and columns at or past hd.
// Shared memory at hd = 128: 32 KiB of Q and 3 stages of 64 KiB.
//
// Route "cuda_cores", float32 (wgmma has no float32 form and TF32
// cannot meet the 2e−5 tolerance), the first port's design: one CTA per
// (b·h, 64 queries), 256 threads as 16 × 16, tiles staged through
// registers into shared memory, both products as float32 FMAs; not on
// the LM path.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------
// route "cuda_cores": float32
// ---------------------------------------------------------------------
namespace cores {

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

// Stage rows [r0, r0 + ROWS) of one head of a [rows, heads, hd] slab
// (row stride `stride` elements) into dst[r·ld + d]; rows at or past
// n_rows become zeros.
template <int ROWS>
__device__ __forceinline__ void stage(float* dst, int ld, const float* src,
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

// (BQ·ld + max(BK·ld, BK·LDP) + BK·16·DPT) floats, ld = hd + 4: the
// query tile, K (or Pᵀ over it) and V
size_t smem_bytes(int hd, int dpt) {
  const int ld = hd + 4;
  const int kp = BK * ld > BK * LDP ? BK * ld : BK * LDP;
  return ((size_t)BQ * ld + kp + (size_t)BK * 16 * dpt) * sizeof(float);
}

// q, o [B, S, H, hd]; k, v [B, T, KV, hd], contiguous.  Grid (B·H,
// ceil(S / BQ)); DPT = output columns per thread, 16·DPT ≥ hd.  ty owns
// 4 query rows, tx 4 keys of each score tile and the hd columns tx,
// tx + 16, … of the output; the 16 lanes of a query row are one
// half-warp, so row max and sum are four shuffles.
template <int DPT>
__global__ void __launch_bounds__(THREADS)
flash_fwd(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, float* __restrict__ o, int S, int Tk,
          int H, int KV, int hd, int window, float scale) {
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
  const float* const qb = q + ((int64_t)b * S * H + h) * hd;
  const float* const kb = k + ((int64_t)b * Tk * KV + kvh) * hd;
  const float* const vb = v + ((int64_t)b * Tk * KV + kvh) * hd;

  // V's padding columns [hd, HDP) stay zero: the tiles write d < hd only
  for (int i = tid; i < BK * HDP; i += THREADS) Vs[i] = 0.f;
  stage<BQ>(Qs, ld, qb, q_stride, q0, S, hd);

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
    stage<BK>(Ks, ld, kb, kv_stride, k0, Tk, hd);
    stage<BK>(Vs, HDP, vb, kv_stride, k0, Tk, hd);
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
    float* const orow = o + (((int64_t)b * S + qpos) * H + h) * hd;
#pragma unroll
    for (int e = 0; e < DPT; ++e) {
      const int d = tx + 16 * e;
      if (d < hd) orow[d] = acc[i][e] * inv;
    }
  }
}

template <int DPT>
cudaError_t launch_dpt(const void* q, const void* k, const void* v, void* o,
                       int B, int S, int Tk, int H, int KV, int hd,
                       int window, float scale, size_t smem,
                       cudaStream_t stream) {
  if (smem != smem_bytes(hd, DPT)) return cudaErrorInvalidValue;
  auto kern = flash_fwd<DPT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(B * H), (unsigned)((S + BQ - 1) / BQ));
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, Tk, H, KV,
      hd, window, scale);
  return cudaGetLastError();
}

cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int Tk, int H, int KV, int hd, int window,
                   float scale, int block_k, size_t smem,
                   cudaStream_t stream) {
  if (block_k != BK || (S + BQ - 1) / BQ > 65535)
    return cudaErrorInvalidValue;
  const int need = (hd + 15) / 16;
  if (need <= 1)
    return launch_dpt<1>(q, k, v, o, B, S, Tk, H, KV, hd, window, scale,
                         smem, stream);
  if (need <= 2)
    return launch_dpt<2>(q, k, v, o, B, S, Tk, H, KV, hd, window, scale,
                         smem, stream);
  if (need <= 4)
    return launch_dpt<4>(q, k, v, o, B, S, Tk, H, KV, hd, window, scale,
                         smem, stream);
  if (need <= 8)
    return launch_dpt<8>(q, k, v, o, B, S, Tk, H, KV, hd, window, scale,
                         smem, stream);
  return launch_dpt<16>(q, k, v, o, B, S, Tk, H, KV, hd, window, scale,
                        smem, stream);
}

}  // namespace cores

// ---------------------------------------------------------------------
// route "wgmma": bf16
// ---------------------------------------------------------------------
namespace hopper {

constexpr int BQ = 128;          // queries per CTA: two consumers of 64
constexpr int THREADS = 384;     // producer + two consumer warpgroups
constexpr int CHUNK = 64;        // head-dim columns per TMA box (128 bytes)
constexpr int ALIGN = 1024;      // a 128-byte swizzle atom: 8 rows × 128 B
constexpr int BAR_BYTES = 128;   // q_full, full[stages], empty[stages]
constexpr int CONSUMER_ARRIVALS = 256;
// A wait that outlasts this many SM clocks (about 2 s) is a broken
// pipeline: trap, so the launch fails instead of hanging the card.
constexpr long long WATCHDOG_CLOCKS = 1ll << 32;

__host__ __device__ constexpr size_t smem_bytes(int hdp, int bk,
                                                int stages) {
  return ALIGN + (size_t)BQ * hdp * 2 + (size_t)stages * 2 * bk * hdp * 2 +
         BAR_BYTES;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait for the completion of the barrier's phase of this parity.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > WATCHDOG_CLOCKS) __trap();
}

// One box of a 4-d tensor map into shared memory, completing `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          uint32_t src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte swizzled operand, layout
// type 1 (SWIZZLE_128B).  The stride byte offset is 1024, from one
// 8-row group (of M or N rows for a K-major operand, of K rows for an
// MN-major one) to the next.  The leading byte offset is used by
// MN-major operands wider than 64 columns only: the stride from one
// 64-column block to the next (K-major operands span 32 bytes of a
// swizzle row per k-step and ignore it).  Bases are 1024-byte aligned,
// so the base offset field is 0.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr,
                                               uint32_t lbo = ALIGN) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(ALIGN >> 4) << 32) | (1ull << 62);
}

// 2^x on the special-function unit, subnormals flushed (2^−inf = 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving a register across a wgmma launch or wait
// (the hardware reads and writes it asynchronously in between).
__device__ __forceinline__ void reg_fence(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}
__device__ __forceinline__ void reg_fence(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}

// D[64, 16] += A·Bᵀ, A [64, 16] and B [16, 16] K-major in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[8], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(1));
}

// D[64, 64] += A·Bᵀ, A [64, 16] and B [64, 16] K-major in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// D[64, 64] += A·B, A [64, 16] bf16 in registers (the accumulator
// layout), B [16, 64] MN-major in shared memory (the transpose bit).
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64, 128] += A·B, A [64, 16] bf16 in registers (the accumulator
// layout), B [16, 128] MN-major in shared memory (the transpose bit).
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64, 192] += A·B, A [64, 16] bf16 in registers (the accumulator
// layout), B [16, 192] MN-major in shared memory (the transpose bit).
__device__ __forceinline__ void wgmma_rs(float (&d)[96],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
      "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95 "
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64, 256] += A·B, A [64, 16] bf16 in registers (the accumulator
// layout), B [16, 256] MN-major in shared memory (the transpose bit).
__device__ __forceinline__ void wgmma_rs(float (&d)[128],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
      "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, "
      "%109, %110, %111, %112, %113, %114, %115, %116, %117, %118, "
      "%119, %120, %121, %122, %123, %124, %125, %126, %127 "
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


// D[64, 16] = A·Bᵀ (D not read: its old value need not stay live).
__device__ __forceinline__ void wgmma_ss_first(float (&d)[8], uint64_t da,
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7 "
      "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]),
        "=f"(d[5]), "=f"(d[6]), "=f"(d[7])
      : "l"(da), "l"(db), "r"(0));
}

// D[64, 64] = A·Bᵀ (D not read: its old value need not stay live).
__device__ __forceinline__ void wgmma_ss_first(float (&d)[32], uint64_t da,
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]),
        "=f"(d[5]), "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]),
        "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]),
        "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]),
        "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]),
        "=f"(d[30]), "=f"(d[31])
      : "l"(da), "l"(db), "r"(0));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// (a, b) as two packed bf16 words: hi = bf16(a, b) and lo = bf16 of
// what hi leaves out, (a − hi_a, b − hi_b), both differences exact.
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(a - __low2float(h), b - __high2float(h));
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// q, o [B, S, H, hd] and k, v [B, T, KV, hd] bf16 through their tensor
// maps.  Grid (ceil(S / BQ)·hg, ceil(B·H / hg)): each group of hg
// (b, h) pairs runs its query tiles longest first, so the K/V the
// group streams stays in L2 while every tile of it reads them.  HDP =
// hd rounded up to 64 (the TMA boxes), BK keys per stage, STAGES
// stages in the ring.  sl2 = log2(e) / √hd.
template <int HDP, int BK, int STAGES>
__global__ void __launch_bounds__(THREADS, 1)
flash_wgmma(const __grid_constant__ CUtensorMap qmap,
            const __grid_constant__ CUtensorMap kmap,
            const __grid_constant__ CUtensorMap vmap,
            const __grid_constant__ CUtensorMap omap, int BH, int S, int Tk,
            int H, int KV, int window, int hg, float sl2) {
  constexpr int NCH = HDP / CHUNK;                  // 64-column chunks
  constexpr uint32_t QCH = BQ * 128, KCH = BK * 128;   // bytes per chunk
  constexpr uint32_t Q_BYTES = NCH * QCH, KV_BYTES = NCH * KCH;
  // keys a consumer computes at a time: S and P take BC / 2 registers a
  // thread beside O's HDP / 2, within ptxas's 168
  constexpr int BC = HDP > 192 ? 16 : 64;
  static_assert(BK % BC == 0, "a stage is whole steps of BC keys");
  static_assert(smem_bytes(HDP, BK, STAGES) <= 232448, "shared memory");

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + ALIGN - 1) & ~(uint32_t)(ALIGN - 1);
  uint8_t* const base_ptr = smem_raw + (base - raw);
  const uint32_t q_s = base;                        // [NCH][BQ][64]
  const uint32_t k_s = q_s + Q_BYTES;               // [STAGES][NCH][BK][64]
  const uint32_t v_s = k_s + STAGES * KV_BYTES;     // the same
  const uint32_t q_full = v_s + STAGES * KV_BYTES;
  const uint32_t full0 = q_full + 8, empty0 = full0 + 8 * STAGES;

  const int t = blockIdx.x / hg;                    // rank, longest first
  const int bh = blockIdx.y * hg + (blockIdx.x - t * hg);
  if (bh >= BH) return;                             // the last group's rest
  const int b = bh / H, h = bh - b * H;
  const int kvh = h / (H / KV);
  const int q0 = (gridDim.x / hg - 1 - t) * BQ;
  const int q_last = min(q0 + BQ, S) - 1;
  const int k_first = window > 0 ? max(0, q0 - window + 1) / BK * BK : 0;
  const int k_stop = min(q_last + 1, Tk);
  const int n_tiles = k_stop > k_first ? (k_stop - k_first + BK - 1) / BK
                                       : 0;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full0 + 8 * st, 1);
      mbar_init(empty0 + 8 * st, CONSUMER_ARRIVALS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, Q_BYTES);
      for (int cc = 0; cc < NCH; ++cc)
        tma_load(q_s + cc * QCH, &qmap, q_full, cc * CHUNK, h, q0, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % STAGES;
        if (it >= STAGES)                   // the consumers freed it
          mbar_wait(empty0 + 8 * st, (it / STAGES - 1) & 1);
        const uint32_t full = full0 + 8 * st;
        const int k0 = k_first + it * BK;
        mbar_expect_tx(full, 2 * KV_BYTES);
        for (int cc = 0; cc < NCH; ++cc) {
          tma_load(k_s + st * KV_BYTES + cc * KCH, &kmap, full, cc * CHUNK,
                   kvh, k0, b);
          tma_load(v_s + st * KV_BYTES + cc * KCH, &vmap, full, cc * CHUNK,
                   kvh, k0, b);
        }
      }
    }
  } else {
    // consumer cw: query rows [64·cw, 64·cw + 64) of the tile.  Thread
    // (warp w, lane) holds rows ra = 16w + lane/4 and rb = ra + 8 and,
    // of every 8 columns of an accumulator, the pair cp, cp + 1.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int cw = wg - 1;
    const int wt = threadIdx.x - 128 * wg;
    const int ra = 16 * (wt / 32) + (wt % 32) / 4, rb = ra + 8;
    const int cp = 2 * (wt % 4);
    const int qw0 = q0 + 64 * cw;                   // first query row
    const int qa = qw0 + ra, qb = qw0 + rb;

    // O [64, HDP] and S [64, BC] in the wgmma accumulator layout: of
    // every 8 columns, entries 0-1 are row ra's pair, 2-3 row rb's
    float o[HDP / 2];
#pragma unroll
    for (int i = 0; i < HDP / 2; ++i) o[i] = 0.f;
    float s[BC / 2];
    uint32_t ph[BC / 16][4], pl[BC / 16][4];   // P's hi and lo fragments
    float m_a = -1e30f, m_b = -1e30f, l_a = 0.f, l_b = 0.f;
    const float neg_inf = __int_as_float(0xff800000);

    mbar_wait(q_full, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int st = it % STAGES;
      mbar_wait(full0 + 8 * st, (it / STAGES) & 1);
#pragma unroll
      for (int hc = 0; hc < BK / BC; ++hc) {
        // keys [k0, k0 + BC) of the stage, rows hc·BC.. of its K and V
        const int k0 = k_first + it * BK + hc * BC;
        // no row of this consumer sees them: skip (uniform over the
        // warpgroup, as wgmma needs)
        if (k0 > qw0 + 63 || (window > 0 && k0 + BC - 1 <= qw0 - window))
          continue;
        const uint32_t ks = k_s + st * KV_BYTES + hc * BC * 128;
        const uint32_t vs = v_s + st * KV_BYTES + hc * BC * 128;
        // S = Q Kᵀ over HDP / 16 k-steps; the first overwrites S, so
        // the last step's S is dead while P·V runs
        wgmma_fence();
        wgmma_ss_first(s, sw128_desc(q_s + cw * 64 * 128), sw128_desc(ks));
#pragma unroll
        for (int kst = 1; kst < HDP / 16; ++kst) {
          const uint32_t cc = kst / 4, in = (kst % 4) * 32;
          wgmma_ss(s, sw128_desc(q_s + cc * QCH + cw * 64 * 128 + in),
                   sw128_desc(ks + cc * KCH + in));
        }
        wgmma_commit();
        wgmma_wait_all();
#pragma unroll
        for (int i = 0; i < BC / 2; ++i) reg_fence(s[i]);

        // masks, only where the keys hold a masked one for some row
        if (k0 + BC - 1 > qw0 || k0 + BC > Tk ||
            (window > 0 && k0 <= qw0 + 63 - window)) {
#pragma unroll
          for (int i = 0; i < BC / 2; ++i) {
            const int kpos = k0 + 8 * (i / 4) + cp + (i & 1);
            const int qpos = (i & 2) ? qb : qa;
            const bool live = kpos <= qpos && kpos < Tk &&
                              (window <= 0 || kpos > qpos - window);
            if (!live) s[i] = neg_inf;
          }
        }
        // online softmax, log2 domain
        float mx_a = neg_inf, mx_b = neg_inf;
#pragma unroll
        for (int i = 0; i < BC / 2; i += 4) {
          mx_a = fmaxf(mx_a, fmaxf(s[i], s[i + 1]));
          mx_b = fmaxf(mx_b, fmaxf(s[i + 2], s[i + 3]));
        }
        const float mn_a = fmaxf(m_a, quad_max(mx_a) * sl2);
        const float mn_b = fmaxf(m_b, quad_max(mx_b) * sl2);
        const float al_a = ex2(m_a - mn_a), al_b = ex2(m_b - mn_b);
        m_a = mn_a;
        m_b = mn_b;
        float rs_a = 0.f, rs_b = 0.f;
#pragma unroll
        for (int i = 0; i < BC / 2; i += 4) {
          s[i] = ex2(fmaf(s[i], sl2, -mn_a));
          s[i + 1] = ex2(fmaf(s[i + 1], sl2, -mn_a));
          s[i + 2] = ex2(fmaf(s[i + 2], sl2, -mn_b));
          s[i + 3] = ex2(fmaf(s[i + 3], sl2, -mn_b));
          rs_a += s[i] + s[i + 1];
          rs_b += s[i + 2] + s[i + 3];
        }
        l_a = l_a * al_a + rs_a;            // this thread's part of the row
        l_b = l_b * al_b + rs_b;
#pragma unroll
        for (int i = 0; i < HDP / 2; i += 4) {
          o[i] *= al_a;
          o[i + 1] *= al_a;
          o[i + 2] *= al_b;
          o[i + 3] *= al_b;
        }
        // P = hi + lo as bf16 A fragments: keys 16kk.. of S's
        // accumulator are exactly the m64nNk16 A layout
#pragma unroll
        for (int kk = 0; kk < BC / 16; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            split_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1], ph[kk][e],
                       pl[kk][e]);
        // O += P_hi V + P_lo V over BC / 16 k-steps, two m64nHDPk16
        // each: V's 64-column chunks lie KCH apart
        wgmma_fence();
#pragma unroll
        for (int i = 0; i < HDP / 2; ++i) reg_fence(o[i]);
#pragma unroll
        for (int kk = 0; kk < BC / 16; ++kk) {
          const uint64_t dv = sw128_desc(vs + kk * 16 * 128, KCH);
          wgmma_rs(o, ph[kk], dv);
          wgmma_rs(o, pl[kk], dv);
        }
        wgmma_commit();
        wgmma_wait_all();
#pragma unroll
        for (int i = 0; i < HDP / 2; ++i) reg_fence(o[i]);
#pragma unroll
        for (int kk = 0; kk < BC / 16; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            reg_fence(ph[kk][e]);
            reg_fence(pl[kk][e]);
          }
      }
      mbar_arrive(empty0 + 8 * st);         // the stage may be refilled
    }

    // epilogue: o / l as bf16 into this consumer's rows of the Q tile,
    // in the 128-byte swizzle the output's tensor map reads
    const float inv_a = 1.f / fmaxf(quad_sum(l_a), 1e-30f);
    const float inv_b = 1.f / fmaxf(quad_sum(l_b), 1e-30f);
    const int row_a = 64 * cw + ra, row_b = 64 * cw + rb;
#pragma unroll
    for (int cc = 0; cc < NCH; ++cc) {
      uint8_t* const chunk = base_ptr + cc * QCH;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        *reinterpret_cast<uint32_t*>(
            chunk + row_a * 128 + ((j ^ (row_a & 7)) << 4) + cp * 2) =
            pack_bf16(o[32 * cc + 4 * j] * inv_a,
                      o[32 * cc + 4 * j + 1] * inv_a);
        *reinterpret_cast<uint32_t*>(
            chunk + row_b * 128 + ((j ^ (row_b & 7)) << 4) + cp * 2) =
            pack_bf16(o[32 * cc + 4 * j + 2] * inv_b,
                      o[32 * cc + 4 * j + 3] * inv_b);
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
    if (wt == 0 && qw0 < S) {
      for (int cc = 0; cc < NCH; ++cc)
        tma_store(&omap, q_s + cc * QCH + cw * 64 * 128, cc * CHUNK, h, qw0,
                  b);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, which the process has loaded
// for the CUDA runtime already (no link against it).
EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (!lib) lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib)
      fn = reinterpret_cast<EncodeTiled>(
          dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// A bf16 [batch, rows, heads, hd] tensor as dims (hd, heads, rows,
// batch), boxes of 64 columns × 1 head × box_rows rows, 128-byte swizzle,
// out-of-bounds elements read as zeros and never written.
bool encode(CUtensorMap* map, const void* base, int hd, int heads, int rows,
            int batch, int box_rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads,
                              (cuuint64_t)rows, (cuuint64_t)batch};
  const cuuint64_t row = (cuuint64_t)hd * 2;
  const cuuint64_t strides[3] = {row, row * heads, row * heads * rows};
  const cuuint32_t box[4] = {CHUNK, 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode_fn()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                     const_cast<void*>(base), dims, strides, box, unit,
                     CU_TENSOR_MAP_INTERLEAVE_NONE,
                     CU_TENSOR_MAP_SWIZZLE_128B,
                     CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                     CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HDP, int BK, int STAGES>
cudaError_t launch_plan(const void* q, const void* k, const void* v, void* o,
                        int B, int S, int Tk, int H, int KV, int hd,
                        int window, float scale, int block_k, int stages,
                        int head_group, size_t smem, cudaStream_t stream) {
  const int hg = min(head_group, B * H), n_qt = (S + BQ - 1) / BQ;
  if (block_k != BK || stages != STAGES ||
      smem != smem_bytes(HDP, BK, STAGES) || hg <= 0 ||
      (long long)n_qt * hg > 0x7fffffff || (B * H + hg - 1) / hg > 65535)
    return cudaErrorInvalidValue;
  if (!encode_fn()) return cudaErrorSymbolNotFound;
  CUtensorMap qm, km, vm, om;
  if (!encode(&qm, q, hd, H, S, B, BQ) || !encode(&km, k, hd, KV, Tk, B, BK) ||
      !encode(&vm, v, hd, KV, Tk, B, BK) || !encode(&om, o, hd, H, S, B, 64))
    return cudaErrorInvalidValue;
  auto kern = flash_wgmma<HDP, BK, STAGES>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(n_qt * hg), (unsigned)((B * H + hg - 1) / hg));
  kern<<<grid, THREADS, smem, stream>>>(qm, km, vm, om, B * H, S, Tk, H, KV,
                                        window, hg,
                                        scale * 1.4426950408889634f);
  return cudaGetLastError();
}

cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int Tk, int H, int KV, int hd, int window,
                   float scale, int block_k, int stages, int head_group,
                   size_t smem, cudaStream_t stream) {
  switch ((hd + CHUNK - 1) / CHUNK) {
    case 1:
      return launch_plan<64, 128, 4>(q, k, v, o, B, S, Tk, H, KV, hd, window,
                                     scale, block_k, stages, head_group, smem,
                                     stream);
    case 2:
      return launch_plan<128, 128, 3>(q, k, v, o, B, S, Tk, H, KV, hd,
                                      window, scale, block_k, stages,
                                      head_group, smem, stream);
    case 3:
      return launch_plan<192, 64, 3>(q, k, v, o, B, S, Tk, H, KV, hd, window,
                                     scale, block_k, stages, head_group, smem,
                                     stream);
    case 4:
      return launch_plan<256, 64, 2>(q, k, v, o, B, S, Tk, H, KV, hd, window,
                                     scale, block_k, stages, head_group, smem,
                                     stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace hopper

}  // namespace

// dtype: 0 float32 (route "cuda_cores"), 1 bfloat16 (route "wgmma").
// block_k, stages, head_group and smem_bytes are the tile plan
// kernel.py computed for (hd, dtype); a plan this source does not
// build is refused.
// Returns the launch's cudaGetLastError() (cudaErrorInvalidValue for a
// shape or plan it does not take: hd a multiple of 8 up to 256, H a
// multiple of KV, the query tiles within the grid's limits;
// cudaErrorSymbolNotFound when libcuda has no cuTensorMapEncodeTiled).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int S,
                                      int Tk, int H, int KV, int hd,
                                      int window, float scale, int dtype,
                                      int block_k, int stages, int head_group,
                                      long long smem_bytes, void* stream) {
  if (B <= 0 || S <= 0 || Tk <= 0 || H <= 0 || KV <= 0 || H % KV ||
      hd <= 0 || hd % 8 || hd > 256 || smem_bytes <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)cores::launch(q, k, v, o, B, S, Tk, H, KV, hd, window,
                                scale, block_k, (size_t)smem_bytes, st);
    case 1:
      return (int)hopper::launch(q, k, v, o, B, S, Tk, H, KV, hd, window,
                                 scale, block_k, stages, head_group,
                                 (size_t)smem_bytes, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
