// Flash attention forward (GQA, causal with q_offset, online softmax) for
// Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// `_flash_kernel` (called by `flash_attention`), and computes the same
// function: s = (q * D^-0.5) k^T in f32, masked with -1e30 where
// q_offset + i < j under `causal`, an online softmax with f32 running max,
// running sum and output accumulator, o = acc / l with l == 0 -> 1, q head
// h reading kv head h / (Hq / Hkv), output in the input's dtype; any Sq
// and Skv, causal or not.  Requires q_offset >= 0, so that key 0 is
// visible to every row and the first kv tile already sets a finite
// running max.
//
// Layout.  Every kernel reads q, k, v and writes o through (batch, head,
// row) strides with a dense last dimension, so the model's [B, S, H, D]
// tensors go in as transposed views and o comes out in that layout, with
// no copies.
//
// Routes (chosen in kernels/flash_attention.py `route` from dtype and D):
//   wgmma     bf16, D in {64, 128}: persistent, warp-specialised wgmma
//             kernel fed by TMA (below);
//   mma_sync  bf16, D in {16, 32}: one block per (64-row q tile, head,
//             batch), 4 warps of mma.sync m16n8k16;
//   f32       float32, D in {16, 32, 64, 128}: IEEE FMA, no tensor cores
//             and so no TF32 rounding; one warp per q row.
//
// What bounds it on an H100: at the qwen3-8b prefill's largest shape
// (B=1, Hq=32, Hkv=8, S=2048, D=128, causal) the visible work is about
// 34 GFLOP against about 42 MB read and written, some 800 FLOP per byte,
// far above the card's ~295 FLOP/byte ridge: the tensor cores are the
// limit.
//
// wgmma design.  One block of 384 threads a SM, persistent: work items
// (q tile of 128 rows, q head, batch) are ordered from the last q tile
// (the most kv tiles under `causal`) to the first, and dealt to the blocks
// in rounds that run forwards and backwards in turn ("snake"), so each
// block gets about the same number of kv tiles.
//   - Producer warpgroup (setmaxnreg.dec to 40): one thread loads the
//     item's Q tile once (when both consumers are done with the last one)
//     and keeps TMA loads of K and V tiles of 128 keys in flight through a
//     2-stage ring with a full and an empty mbarrier for K and for V.
//   - Two consumer warpgroups (setmaxnreg.inc to 232); warpgroup c owns q
//     rows [64 c, 64 c + 64) of the item.  Per kv tile: S = Q K^T by
//     wgmma m64n128k16 with both operands in shared memory (K's rows are
//     D-contiguous: the K-major B operand, no transpose); the online
//     softmax on the S accumulators in registers, in the log2 domain
//     (scale * log2(e) folded into one FMA before exp2f), masking only
//     tiles that cross the causal diagonal or the end of the keys, and
//     skipping tiles above the diagonal; then O += P V by wgmma with P in
//     registers: the f32 accumulator of an m64n128 product is, k16 step by
//     k16 step, the bf16 A fragment of the next product, so P never
//     touches shared memory.  V [keys, D] is the N-major B operand
//     (transpose-B), read through 64-column TMA boxes with the 128-byte
//     swizzle, as gmm.cu reads rhs.
//   - P keeps ~16 bits: it goes into P V as a bf16 high part and a low
//     part (p - hi), two wgmmas a k16 step, as the mma.sync kernel of the
//     first port did; one bf16 P rounds at 2^-9 (kernels/probe_flash.py
//     times both).
//   - TMA maps are 4D over (D, S, H, B) with the tensors' own strides, so
//     a ragged last tile reads zeros and its store is clipped inside its
//     own batch and head: it never reads or writes the next one's rows.
//   - Epilogue: o = acc / l rounded once to bf16 into a swizzled staging
//     buffer per warpgroup, then one TMA store of its 64 rows (clipped at
//     Sq); the producer is already loading the next item.
//
// C interface (loaded with ctypes): each entry point launches on `stream`
// and returns cudaGetLastError() of the launch; flash_attention_bf16_wgmma
// returns -CUresult when a tensor map cannot be encoded.  `strides` holds
// 12 element strides: (batch, head, row) of q, k, v and o, in that order.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr float kNegInf = -1e30f;

struct Strides {
  long long b, h, s;  // elements between batches, heads and rows
};

// (batch, head) -> the head's first element
template <typename T>
__device__ __forceinline__ T* head_ptr(T* base, const Strides& st, int b,
                                       int h) {
  return base + (long long)b * st.b + (long long)h * st.h;
}

// ---------------------------------------------------------------------------
// bf16, D in {16, 32}: mma.sync tensor-core path
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;             // q rows per block
constexpr int kBK = 64;             // kv rows per tile
constexpr int kWarps = kBQ / 16;    // one warp per 16 q rows
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;             // bf16 per smem row of padding (16 bytes)

__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// p0, p1 -> registers `hi` = bf16(p) and `lo` = bf16(p - hi), so that
// hi + lo carries ~16 bits of p's mantissa where bf16 alone carries 8
__device__ __forceinline__ void split_f32(float p0, float p1, uint32_t& hi,
                                          uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(p0 - hf.x, p1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// two bf16 from shared memory -> one register, `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// rows [row0, row0 + 64) of a head (rows `ld` elements apart, D dense)
// into smem [64][D + kPad]; rows at or past S are zero-filled
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* sm,
                                          const __nv_bfloat16* g, long long ld,
                                          int row0, int S) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < kBK * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int col = (c % kChunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < S) {
      val = *reinterpret_cast<const uint4*>(g + (row0 + r) * ld + col);
    }
    *reinterpret_cast<uint4*>(sm + r * (D + kPad) + col) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_bf16(const __nv_bfloat16* __restrict__ Q,
               const __nv_bfloat16* __restrict__ K,
               const __nv_bfloat16* __restrict__ V,
               __nv_bfloat16* __restrict__ O, Strides qs, Strides ks,
               Strides vs, Strides os, int Hq, int Hkv, int Sq, int Skv,
               int causal, int q_offset, float scale) {
  constexpr int LD = D + kPad;
  __shared__ __align__(16) __nv_bfloat16 sK[kBK * LD];
  __shared__ __align__(16) __nv_bfloat16 sV[kBK * LD];

  const int nq = (Sq + kBQ - 1) / kBQ;
  const int q0 = (nq - 1 - (int)blockIdx.x) * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread within the group

  const __nv_bfloat16* Qh = head_ptr(Q, qs, b, h);
  const __nv_bfloat16* Kh = head_ptr(K, ks, b, hk);
  const __nv_bfloat16* Vh = head_ptr(V, vs, b, hk);
  __nv_bfloat16* Oh = head_ptr(O, os, b, h);

  // Q tile through sK into A fragments held for the whole kv loop.
  load_tile<D>(sK, Qh, qs.s, q0, Sq);
  __syncthreads();
  const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const __nv_bfloat16* p0 = sK + r0 * LD + kk * 16 + t * 2;
    const __nv_bfloat16* p1 = p0 + 8 * LD;
    qa[kk][0] = ld32(p0);
    qa[kk][1] = ld32(p1);
    qa[kk][2] = ld32(p0 + 8);
    qa[kk][3] = ld32(p1 + 8);
  }
  __syncthreads();

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  }
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums
  const int qpos[2] = {q_offset + q0 + r0, q_offset + q0 + r0 + 8};

  int nk = (Skv + kBK - 1) / kBK;
  if (causal) {
    const int last_q = q_offset + min(q0 + kBQ, Sq) - 1;
    nk = min(nk, last_q / kBK + 1);
  }

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kBK;
    load_tile<D>(sK, Kh, ks.s, k0, Skv);
    load_tile<D>(sV, Vh, vs.s, k0, Skv);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[kBK / 8][4];
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const __nv_bfloat16* kp = sK + (n * 8 + g) * LD + kk * 16 + t * 2;
        mma_16816(s[n], qa[kk], ld32(kp), ld32(kp + 8));
      }
    }

    // scale, mask, tile row max
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = k0 + n * 8 + t * 2 + (e & 1);
        const int r = e >> 1;
        const bool ok = j < Skv && (!causal || qpos[r] >= j);
        s[n][e] = ok ? s[n][e] * scale : kNegInf;
        mx[r] = fmaxf(mx[r], s[n][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        s[n][e] = expf(s[n][e] - m[r]);
        l[r] += s[n][e];
      }
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // O += P V: the accumulators of key columns [16kk, 16kk + 16) are the
    // A fragment of the kk-th k-step.  P goes in as two bf16 terms (high
    // and low part), so PV keeps close to the f32 P that the reference
    // multiplies; one bf16 P would round it at 2^-9.
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t ph[4], pl[4];
      split_f32(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split_f32(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split_f32(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split_f32(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const __nv_bfloat16* vp = sV + (kk * 16 + t * 2) * LD + n * 8 + g;
        const uint32_t b0 = pack_bf16(vp[0], vp[LD]);
        const uint32_t b1 = pack_bf16(vp[8 * LD], vp[9 * LD]);
        mma_16816(acc[n], ph, b0, b1);
        mma_16816(acc[n], pl, b0, b1);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (l[r] == 0.f) l[r] = 1.f;  // fully masked row -> zeros
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + 8 * r;
    if (row >= Sq) continue;
    __nv_bfloat16* op = Oh + row * os.s + t * 2;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(op + n * 8) = __floats2bfloat162_rn(
          acc[n][2 * r] / l[r], acc[n][2 * r + 1] / l[r]);
    }
  }
}

// ---------------------------------------------------------------------------
// f32: IEEE FMA path (no tensor cores, so no TF32 rounding)
// ---------------------------------------------------------------------------

constexpr int kRowsF = 8;   // q rows per block, one warp each
constexpr int kBKF = 32;    // kv rows per tile, one per lane

template <int D>
__global__ void __launch_bounds__(kRowsF * 32)
flash_fwd_f32(const float* __restrict__ Q, const float* __restrict__ K,
              const float* __restrict__ V, float* __restrict__ O, Strides qs,
              Strides ks, Strides vs, Strides os, int Hq, int Hkv, int Sq,
              int Skv, int causal, int q_offset, float scale) {
  // output columns a lane owns: lane, lane + 32, ... (< D: at D = 16 the
  // upper half-warp owns none)
  constexpr int kCols = (D + 31) / 32;
  __shared__ float sQ[kRowsF][D];
  __shared__ float sK[kBKF][D + 1];  // +1: lanes read down a column
  __shared__ float sV[kBKF][D];

  const int nq = (Sq + kRowsF - 1) / kRowsF;
  const int q0 = (nq - 1 - (int)blockIdx.x) * kRowsF;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nthreads = kRowsF * 32;

  const float* Qh = head_ptr(Q, qs, b, h);
  const float* Kh = head_ptr(K, ks, b, hk);
  const float* Vh = head_ptr(V, vs, b, hk);
  float* Oh = head_ptr(O, os, b, h);

  for (int i = threadIdx.x; i < kRowsF * D; i += nthreads) {
    const int r = i / D;
    const int c = i % D;
    sQ[r][c] = (q0 + r < Sq) ? Qh[(q0 + r) * qs.s + c] * scale : 0.f;
  }

  const int row = q0 + warp;
  const int qpos = q_offset + row;
  float acc[kCols];
#pragma unroll
  for (int i = 0; i < kCols; ++i) acc[i] = 0.f;
  float m = kNegInf;
  float l = 0.f;

  int nk = (Skv + kBKF - 1) / kBKF;
  if (causal) {
    const int last_q = q_offset + min(q0 + kRowsF, Sq) - 1;
    nk = min(nk, last_q / kBKF + 1);
  }

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kBKF;
    __syncthreads();  // sQ written / previous tile consumed
    for (int i = threadIdx.x; i < kBKF * D; i += nthreads) {
      const int r = i / D;
      const int c = i % D;
      const bool in = k0 + r < Skv;
      sK[r][c] = in ? Kh[(k0 + r) * ks.s + c] : 0.f;
      sV[r][c] = in ? Vh[(k0 + r) * vs.s + c] : 0.f;
    }
    __syncthreads();

    const int j = k0 + lane;
    float s = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) s = fmaf(sQ[warp][d], sK[lane][d], s);
    const bool ok = j < Skv && (!causal || qpos >= j);
    s = ok ? s : kNegInf;

    float mx = s;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    }
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    const float p = expf(s - m_new);
    float ps = p;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      ps += __shfl_xor_sync(0xffffffffu, ps, o);
    }
    l = alpha * l + ps;
    m = m_new;
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      const int d = min(lane + 32 * i, D - 1);  // lanes past D: a copy
      float pv = 0.f;
#pragma unroll 8
      for (int jj = 0; jj < kBKF; ++jj) {
        pv = fmaf(__shfl_sync(0xffffffffu, p, jj), sV[jj][d], pv);
      }
      acc[i] = acc[i] * alpha + pv;
    }
  }

  if (row < Sq) {
    const float denom = (l == 0.f) ? 1.f : l;  // fully masked row -> zeros
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      const int d = lane + 32 * i;
      if (d < D) Oh[row * os.s + d] = acc[i] / denom;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16, D in {64, 128}: persistent, warp-specialised wgmma fed by TMA
// ---------------------------------------------------------------------------

constexpr int wBM = 128;        // q rows of a work item: two 64-row halves
constexpr int wBN = 128;        // keys of a kv tile
constexpr int wThreads = 384;   // producer warpgroup + 2 consumer warpgroups
constexpr int wStages = 2;      // K and V ring stages

// shared memory of the wgmma kernel, from a 1 KB-aligned base (the 128-byte
// swizzle repeats every 1 KB); every tile is made of 64-column boxes (64
// bf16 = one 128-byte swizzled row) laid one after the other
template <int D>
struct Smem {
  static constexpr int kQ = 0;                       // Q: 128 rows x D
  static constexpr int kQBox = wBM * 128;            // 16 KB a 64 columns
  static constexpr int kKVBox = wBN * 128;           // 16 KB a 64 columns
  static constexpr int kKVBytes = (D / 64) * kKVBox; // one K or V tile
  static constexpr int kK = kQ + (D / 64) * kQBox;   // K ring
  static constexpr int kV = kK + wStages * kKVBytes; // V ring
  static constexpr int kOBox = 64 * 128;             // 8 KB: 64 rows x 64
  static constexpr int kO = kV + wStages * kKVBytes; // 2 x 64 rows x D
  static constexpr int kBar = kO + 2 * (D / 64) * kOBox;
  // q_full, q_empty, k_full[2], k_empty[2], v_full[2], v_empty[2]
  static constexpr int kBytes = kBar + 10 * 8 + 1024;  // + alignment slack
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
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

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// wait until the committed TMA stores have read (READ) or also written
// their shared-memory source
template <bool READ>
__device__ __forceinline__ void bulk_wait() {
  if (READ)
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  else
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// generic-proxy writes to shared memory become visible to TMA
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void st_shared_b32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A shared-memory matrix descriptor of wgmma: start address, leading and
// stride byte offsets (given in bytes, kept in 16-byte units), 128-byte
// swizzle.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr >> 4) & 0x3FFF) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across the instructions that fence it.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(d[i][j])::"memory");
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64]: A in registers (the bf16 fragment
// of mma.sync m16n8k16 a warp), B N-major in shared memory (transpose-B
// immediate 1; O += P V with V [keys, D] row-major); f32 sums.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128]: A and B K-major in shared memory
// (S = Q K^T); f32 sums.  scale_d == 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
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
      : "l"(a), "l"(b), "r"(scale_d));
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128]: A in registers (the bf16 fragment
// of mma.sync m16n8k16 a warp), B N-major in shared memory (transpose-B
// immediate 1; O += P V with V [keys, D] row-major); f32 sums.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
  if constexpr (N == 64)
    wgmma_rs_n64(d, a, b, scale_d);
  else
    wgmma_rs_n128(d, a, b, scale_d);
}

// v from lane 0: the same in every lane, and known to be so by the
// compiler, which otherwise serialises wgmma under branches on it
__device__ __forceinline__ int warp_uniform(int v) {
  return __shfl_sync(0xffffffffu, v, 0);
}

struct Item {
  int b, h, q0;  // batch, q head, first q row
  int nk;        // kv tiles to visit
};

// The launch's work: items (q tile, q head, batch), the last q tile first;
// round r of the persistent blocks takes items [r G, r G + G) (G blocks),
// block x the x-th of them in even rounds and the (G-1-x)-th in odd ones.
struct Work {
  int B, Hq, Hkv, Sq, Skv, causal, q_offset;
  int nq, total;  // q tiles of wBM rows; items

  __device__ int item_at(int round) const {
    const int x = (round & 1) ? (int)gridDim.x - 1 - (int)blockIdx.x
                              : (int)blockIdx.x;
    const long long item = (long long)round * gridDim.x + x;
    return item < total ? (int)item : total;
  }

  __device__ Item decode(int item) const {
    Item it;
    const int per = Hq * B;
    const int back = item / per;  // 0: the last q tile
    const int rem = item - back * per;
    it.h = rem % Hq;
    it.b = rem / Hq;
    it.q0 = (nq - 1 - back) * wBM;
    it.nk = (Skv + wBN - 1) / wBN;
    if (causal)
      it.nk = min(it.nk, (q_offset + min(it.q0 + wBM, Sq) - 1) / wBN + 1);
    return it;
  }
};

template <int D>
__global__ void __launch_bounds__(wThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                   const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v,
                   const __grid_constant__ CUtensorMap map_o, Work w,
                   float scale_log2) {
  using L = Smem<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = raw + ((1024u - (raw & 1023u)) & 1023u);
  const uint32_t sq = base + L::kQ, sk = base + L::kK, sv = base + L::kV;
  const uint32_t q_full = base + L::kBar, q_empty = q_full + 8;
  const uint32_t k_full = q_full + 16, k_empty = k_full + 8 * wStages;
  const uint32_t v_full = k_empty + 8 * wStages;
  const uint32_t v_empty = v_full + 8 * wStages;
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(q_full, 1);   // the producer's expect_tx
    mbar_init(q_empty, 8);  // lane 0 of each consumer warp
    for (int s = 0; s < wStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, 8);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(v_empty + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = warp_uniform(tid / 128), warp = (tid % 128) / 32;
  const int lane = tid % 32;

  if (wg == 0) {
    // producer warpgroup: one thread keeps Q and the K/V ring loaded
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == 0 && lane == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&map_q))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&map_k))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&map_v))
                   : "memory");
      int stage = 0;
      uint32_t phase = 0, qphase = 0;
      for (int r = 0;; ++r) {
        const int item = w.item_at(r);
        if (item >= w.total) break;
        const Item it = w.decode(item);
        const int hk = it.h / (w.Hq / w.Hkv);
        // the Q tile, once both consumers are done with the last one
        mbar_wait(q_empty, qphase ^ 1);
        mbar_expect_tx(q_full, (D / 64) * L::kQBox);
        for (int j = 0; j < D / 64; ++j)
          tma_load_4d(sq + j * L::kQBox, &map_q, q_full, 64 * j, it.q0, it.h,
                      it.b);
        qphase ^= 1;
        for (int kt = 0; kt < it.nk; ++kt) {
          const uint32_t kf = k_full + 8 * stage, vf = v_full + 8 * stage;
          mbar_wait(k_empty + 8 * stage, phase ^ 1);
          mbar_expect_tx(kf, L::kKVBytes);
          for (int j = 0; j < D / 64; ++j)
            tma_load_4d(sk + stage * L::kKVBytes + j * L::kKVBox, &map_k, kf,
                        64 * j, kt * wBN, hk, it.b);
          mbar_wait(v_empty + 8 * stage, phase ^ 1);
          mbar_expect_tx(vf, L::kKVBytes);
          for (int j = 0; j < D / 64; ++j)
            tma_load_4d(sv + stage * L::kKVBytes + j * L::kKVBox, &map_v, vf,
                        64 * j, kt * wBN, hk, it.b);
          if (++stage == wStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // consumer warpgroups: warpgroup c computes q rows [64 c, 64 c + 64) of
  // each item; this thread holds rows 16 warp + lane / 4 (+ 8) of those,
  // columns 8 i + 2 (lane % 4) (+ 1) of the i-th 8-column group
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int c = wg - 1, wtid = tid % 128;
  const uint32_t epi = base + L::kO + c * (D / 64) * L::kOBox;
  float acc[D / 2];           // O: 64 rows x D
  float s[wBN / 2];           // S, then P: 64 rows x 128 keys
  uint32_t ph[wBN / 16][4];   // P's bf16 high part, A fragments by k16 step
  uint32_t pl[wBN / 16][4];   // and its low part
  int stage = 0;
  uint32_t phase = 0, qphase = 0;
  for (int r = 0;; ++r) {
    const int item = warp_uniform(w.item_at(r));
    if (item >= w.total) break;
    const Item it = w.decode(item);
    const int nk = warp_uniform(it.nk);
    const int row0 = it.q0 + 64 * c;  // this warpgroup's first q row
    const int qpos0 = w.q_offset + row0 + 16 * warp + lane / 4;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m[2] = {kNegInf, kNegInf};  // running max, in log2 units
    float l[2] = {0.f, 0.f};          // this thread's share of the row sums
    mbar_wait(q_full, qphase);
    qphase ^= 1;
    for (int kt = 0; kt < nk; ++kt) {
      const uint32_t kb = sk + stage * L::kKVBytes;
      const uint32_t vb = sv + stage * L::kKVBytes;
      // S = Q K^T: Q and K K-major, +32 bytes a k16 step inside the
      // swizzled 128-byte rows, 64-column boxes apart, rows 8 apart by 1 KB
      mbar_wait(k_full + 8 * stage, phase);
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n128(
            s,
            smem_desc(sq + (kk / 4) * L::kQBox + c * 8192 + (kk % 4) * 32, 16,
                      1024),
            smem_desc(kb + (kk / 4) * L::kKVBox + (kk % 4) * 32, 16, 1024),
            kk != 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      if (lane == 0) {
        mbar_arrive(k_empty + 8 * stage);
        if (kt == nk - 1) mbar_arrive(q_empty);
      }

      // online softmax on the accumulators; mask only the tiles that cross
      // the end of the keys or the causal diagonal of these 64 rows
      const int k0 = kt * wBN;
      if (k0 + wBN > w.Skv ||
          (w.causal && k0 + wBN - 1 > w.q_offset + row0)) {
#pragma unroll
        for (int i = 0; i < wBN / 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = k0 + 8 * i + 2 * (lane % 4) + (e & 1);
            const int qpos = qpos0 + 8 * (e >> 1);
            if (j >= w.Skv || (w.causal && qpos < j)) s[4 * i + e] = kNegInf;
          }
      }
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int i = 0; i < wBN / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * i + e]);
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m[h], mx[h] * scale_log2);
        alpha[h] = exp2f(m[h] - m_new);
        m[h] = m_new;
        l[h] *= alpha[h];
      }
#pragma unroll
      for (int i = 0; i < wBN / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // exp(s D^-0.5 - max) as exp2(s D^-0.5 log2(e) - max'): one FMA
          const float p = exp2f(fmaf(s[4 * i + e], scale_log2, -m[e >> 1]));
          s[4 * i + e] = p;
          l[e >> 1] += p;
        }
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        acc[4 * i] *= alpha[0];
        acc[4 * i + 1] *= alpha[0];
        acc[4 * i + 2] *= alpha[1];
        acc[4 * i + 3] *= alpha[1];
      }
      // P's k16 step kk is key columns [16 kk, 16 kk + 16): accumulators
      // 8 kk .. 8 kk + 7, in the order of the bf16 A fragment
#pragma unroll
      for (int kk = 0; kk < wBN / 16; ++kk)
#pragma unroll
        for (int f = 0; f < 4; ++f)
          split_f32(s[8 * kk + 2 * f], s[8 * kk + 2 * f + 1], ph[kk][f],
                    pl[kk][f]);

      // O += P V: V N-major (transpose-B), +2 KB a k16 step (16 keys of 128
      // bytes), 8 keys apart by 1 KB, 64-column boxes 16 KB apart; the high
      // and the low part of P, two products a step
      mbar_wait(v_full + 8 * stage, phase);
      fence_regs(acc);
      fence_regs(ph);
      fence_regs(pl);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < wBN / 16; ++kk) {
        const uint64_t vd = smem_desc(vb + 2048 * kk, L::kKVBox, 1024);
        wgmma_rs<D>(acc, ph[kk], vd, 1);
        wgmma_rs<D>(acc, pl[kk], vd, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(ph);
      fence_regs(pl);
      if (lane == 0) mbar_arrive(v_empty + 8 * stage);
      if (++stage == wStages) {
        stage = 0;
        phase ^= 1;
      }
    }

    // epilogue: o = acc / l, rounded once to bf16 into this warpgroup's
    // staging buffer (64 rows of D, 64-column boxes with the 128-byte
    // swizzle, as TMA stores them), then one TMA store clipped at Sq
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      if (l[h] == 0.f) l[h] = 1.f;  // fully masked row -> zeros
    }
    if (wtid == 0) bulk_wait<true>();  // the last TMA store has read it
    named_bar_sync(1 + c, 128);
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rr = 16 * warp + lane / 4 + 8 * h;
        st_shared_b32(epi + (i / 8) * L::kOBox + rr * 128 +
                          (((i % 8) ^ (rr % 8)) << 4) + (lane % 4) * 4,
                      pack_bf16x2(acc[4 * i + 2 * h] / l[h],
                                  acc[4 * i + 2 * h + 1] / l[h]));
      }
    fence_proxy_async();
    named_bar_sync(1 + c, 128);
    if (wtid == 0 && row0 < w.Sq) {
      for (int j = 0; j < D / 64; ++j)
        tma_store_4d(&map_o, epi + j * L::kOBox, 64 * j, row0, it.h, it.b);
      bulk_commit();
    }
  }
  if (wtid == 0) bulk_wait<false>();
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, found through the CUDA runtime,
// so the library links no -lcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A bf16 tensor map over (D, S, H, B) with the tensor's own strides and
// boxes of 64 columns x `rows` rows of one head (64 bf16: 128 bytes, the
// 128-byte swizzle); elements out of bounds read as zero and are not
// stored.
CUresult encode_map(CUtensorMap* map, const void* base, int D, int S, int H,
                    int B, const Strides& st, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st.s * 2, (cuuint64_t)st.h * 2,
                                 (cuuint64_t)st.b * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

int sm_count() {
  static int count[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return 132;
  if (count[dev] == 0)
    cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev);
  return count[dev] > 0 ? count[dev] : 132;
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, int B,
                 int Hq, int Hkv, int Sq, int Skv, int causal, int q_offset,
                 const Strides* st, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Smem<D>::kBytes);
  if (attr != cudaSuccess) return (int)attr;
  CUtensorMap mq, mk, mv, mo;
  CUresult res = encode_map(&mq, q, D, Sq, Hq, B, st[0], wBM);
  if (res == CUDA_SUCCESS) res = encode_map(&mk, k, D, Skv, Hkv, B, st[1], wBN);
  if (res == CUDA_SUCCESS) res = encode_map(&mv, v, D, Skv, Hkv, B, st[2], wBN);
  if (res == CUDA_SUCCESS) res = encode_map(&mo, o, D, Sq, Hq, B, st[3], 64);
  if (res != CUDA_SUCCESS) return -(int)res;
  Work w;
  w.B = B;
  w.Hq = Hq;
  w.Hkv = Hkv;
  w.Sq = Sq;
  w.Skv = Skv;
  w.causal = causal;
  w.q_offset = q_offset;
  w.nq = (Sq + wBM - 1) / wBM;
  const long long total = (long long)w.nq * Hq * B;
  if (total >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  w.total = (int)total;
  const int grid = (int)std::min<long long>(sm_count(), total);
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)D);
  flash_wgmma_kernel<D><<<grid, wThreads, Smem<D>::kBytes, stream>>>(
      mq, mk, mv, mo, w, scale_log2);
  return (int)cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        int B, int Hq, int Hkv, int Sq, int Skv, int causal,
                        int q_offset, const Strides* st, cudaStream_t stream) {
  const dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
  flash_fwd_bf16<D><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      st[0], st[1], st[2], st[3], Hq, Hkv, Sq, Skv, causal, q_offset,
      1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       int B, int Hq, int Hkv, int Sq, int Skv, int causal,
                       int q_offset, const Strides* st, cudaStream_t stream) {
  const dim3 grid((Sq + kRowsF - 1) / kRowsF, Hq, B);
  flash_fwd_f32<D><<<grid, kRowsF * 32, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), st[0], st[1],
      st[2], st[3], Hq, Hkv, Sq, Skv, causal, q_offset,
      1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

// the 12 strides as (q, k, v, o) x (batch, head, row); false if any is not
// a positive multiple of `align` elements
bool read_strides(const long long* in, Strides* st, long long align) {
  for (int t = 0; t < 4; ++t) {
    st[t] = Strides{in[3 * t], in[3 * t + 1], in[3 * t + 2]};
    for (int i = 0; i < 3; ++i)
      if (in[3 * t + i] <= 0 || in[3 * t + i] % align != 0) return false;
  }
  return true;
}

}  // namespace

// q: [B, Hq, Sq, D]; k, v: [B, Hkv, Skv, D]; o: [B, Hq, Sq, D]; all bf16
// with a dense last dimension and the element strides in `strides`, which
// are multiples of 8 (16 bytes), as are the base addresses.  The wgmma
// route: D in {64, 128}.  Anything else is refused with
// cudaErrorInvalidValue, not run otherwise.
extern "C" int flash_attention_bf16_wgmma(const void* q, const void* k,
                                          const void* v, void* o, int B,
                                          int Hq, int Hkv, int Sq, int Skv,
                                          int D, int causal, int q_offset,
                                          const long long* strides,
                                          void* stream) {
  Strides st[4];
  if (!read_strides(strides, st, 8) || !aligned16(q) || !aligned16(k) ||
      !aligned16(v) || !aligned16(o) || q_offset < 0)
    return (int)cudaErrorInvalidValue;
  if (encode_tiled() == nullptr) return (int)cudaErrorNotSupported;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch_wgmma<64>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal,
                            q_offset, st, s);
  if (D == 128)
    return launch_wgmma<128>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal,
                             q_offset, st, s);
  return (int)cudaErrorInvalidValue;
}

// The same function on the mma.sync route: bf16, D in {16, 32, 64, 128},
// strides and bases as for the wgmma route (16-byte rows).
extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* o, int B, int Hq,
                                    int Hkv, int Sq, int Skv, int D,
                                    int causal, int q_offset,
                                    const long long* strides, void* stream) {
  Strides st[4];
  if (!read_strides(strides, st, 8) || !aligned16(q) || !aligned16(k) ||
      !aligned16(v) || !aligned16(o) || q_offset < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch_bf16<16>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal,
                             q_offset, st, s);
    case 32:
      return launch_bf16<32>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal,
                             q_offset, st, s);
    case 64:
      return launch_bf16<64>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal,
                             q_offset, st, s);
    case 128:
      return launch_bf16<128>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal,
                              q_offset, st, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The same for float32 (IEEE FMA), D in {16, 32, 64, 128}, any positive
// strides.
extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* o, int B, int Hq,
                                   int Hkv, int Sq, int Skv, int D, int causal,
                                   int q_offset, const long long* strides,
                                   void* stream) {
  Strides st[4];
  if (!read_strides(strides, st, 1) || q_offset < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch_f32<16>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal,
                            q_offset, st, s);
    case 32:
      return launch_f32<32>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal,
                            q_offset, st, s);
    case 64:
      return launch_f32<64>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal,
                            q_offset, st, s);
    case 128:
      return launch_f32<128>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal,
                             q_offset, st, s);
  }
  return (int)cudaErrorInvalidValue;
}
