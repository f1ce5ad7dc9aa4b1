// Flash attention forward (GQA, causal with q_offset, online softmax) for
// Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// `_flash_kernel` (called by `flash_attention`), and computes the same
// function: s = (q * D^-0.5) k^T in f32, masked with -1e30 where
// q_offset + i < j under `causal`, an online softmax with f32 running max,
// running sum and output accumulator, o = acc / l with l == 0 -> 1, q head
// h reading kv head h / (Hq / Hkv), output in the input's dtype.
//
// What bounds it on an H100: at the serving path's largest prefill
// (B=1, Hq=32, Hkv=8, S=2048, D=128, causal) the unmasked work is about
// 34 GFLOP against about 42 MB read and written, some 800 FLOP per byte,
// far above the card's ~295 FLOP/byte ridge: the tensor cores are the
// limit, and every byte is read from device memory once per q tile.
//
// Design (the TPU's sequential grid axis becomes a loop inside a block):
//  * one thread block per (q tile of 64 rows, q head, batch); the tiles
//    are issued from the last (the most kv tiles under `causal`) to the
//    first, so the long blocks start first;
//  * bf16: 4 warps, each owning 16 q rows whose A fragments stay in
//    registers; K and V tiles of 64 rows are staged in shared memory and
//    QK^T and PV run on mma.sync m16n8k16 (bf16 in, f32 accumulate); the
//    probabilities are re-packed from the QK^T accumulators into the PV A
//    operand without leaving registers, as a bf16 high and low part each,
//    so that PV keeps ~16 bits of the f32 probabilities (1.5x the mma
//    work of a single bf16 P);
//  * f32: IEEE FMA only (no tensor cores, no TF32), one warp per q row and
//    one key per lane within a 32-key tile;
//  * under `causal` the kv loop stops at the tile that holds the block's
//    last query position (the reference visits every kv block; the tiles
//    skipped are fully masked and add exactly 0);
//  * ragged last tiles (any Sq, Skv) are zero-filled in shared memory and
//    masked inside the kernel.
// Requires q_offset >= 0, so that key 0 is visible to every row and the
// first kv tile already sets a finite running max.
//
// This is the simple first version: no TMA, no wgmma, no warp
// specialisation, no double buffering.
//
// C interface (loaded with ctypes): each entry point launches on `stream`
// and returns cudaGetLastError() of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// bf16: mma.sync tensor-core path
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

// rows [row0, row0 + 64) of a [S, D] head into smem [64][D + kPad];
// rows at or past S are zero-filled
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* sm,
                                          const __nv_bfloat16* g, int row0,
                                          int S) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < kBK * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int col = (c % kChunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < S) {
      val = *reinterpret_cast<const uint4*>(g + (size_t)(row0 + r) * D + col);
    }
    *reinterpret_cast<uint4*>(sm + r * (D + kPad) + col) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_bf16(const __nv_bfloat16* __restrict__ Q,
               const __nv_bfloat16* __restrict__ K,
               const __nv_bfloat16* __restrict__ V,
               __nv_bfloat16* __restrict__ O, int Hq, int Hkv, int Sq, int Skv,
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

  const __nv_bfloat16* Qh = Q + (size_t)(b * Hq + h) * Sq * D;
  const __nv_bfloat16* Kh = K + (size_t)(b * Hkv + hk) * Skv * D;
  const __nv_bfloat16* Vh = V + (size_t)(b * Hkv + hk) * Skv * D;
  __nv_bfloat16* Oh = O + (size_t)(b * Hq + h) * Sq * D;

  // Q tile through sK into A fragments held for the whole kv loop.
  load_tile<D>(sK, Qh, q0, Sq);
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
    load_tile<D>(sK, Kh, k0, Skv);
    load_tile<D>(sV, Vh, k0, Skv);
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
    __nv_bfloat16* op = Oh + (size_t)row * D + t * 2;
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
              const float* __restrict__ V, float* __restrict__ O, int Hq,
              int Hkv, int Sq, int Skv, int causal, int q_offset,
              float scale) {
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

  const float* Qh = Q + (size_t)(b * Hq + h) * Sq * D;
  const float* Kh = K + (size_t)(b * Hkv + hk) * Skv * D;
  const float* Vh = V + (size_t)(b * Hkv + hk) * Skv * D;
  float* Oh = O + (size_t)(b * Hq + h) * Sq * D;

  for (int i = threadIdx.x; i < kRowsF * D; i += nthreads) {
    const int r = i / D;
    const int c = i % D;
    sQ[r][c] = (q0 + r < Sq) ? Qh[(size_t)(q0 + r) * D + c] * scale : 0.f;
  }

  const int row = q0 + warp;
  const int qpos = q_offset + row;
  float acc[D / 32];
#pragma unroll
  for (int i = 0; i < D / 32; ++i) acc[i] = 0.f;
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
      sK[r][c] = in ? Kh[(size_t)(k0 + r) * D + c] : 0.f;
      sV[r][c] = in ? Vh[(size_t)(k0 + r) * D + c] : 0.f;
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
    for (int i = 0; i < D / 32; ++i) {
      const int d = lane + 32 * i;
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
    for (int i = 0; i < D / 32; ++i) {
      Oh[(size_t)row * D + lane + 32 * i] = acc[i] / denom;
    }
  }
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        int B, int Hq, int Hkv, int Sq, int Skv, int causal,
                        int q_offset, cudaStream_t stream) {
  const dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
  flash_fwd_bf16<D><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), Hq,
      Hkv, Sq, Skv, causal, q_offset, 1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       int B, int Hq, int Hkv, int Sq, int Skv, int causal,
                       int q_offset, cudaStream_t stream) {
  const dim3 grid((Sq + kRowsF - 1) / kRowsF, Hq, B);
  flash_fwd_f32<D><<<grid, kRowsF * 32, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Hq, Hkv, Sq, Skv,
      causal, q_offset, 1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

}  // namespace

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* o, int B, int Hq,
                                    int Hkv, int Sq, int Skv, int D,
                                    int causal, int q_offset, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) {
    return launch_bf16<64>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, q_offset, st);
  }
  if (D == 128) {
    return launch_bf16<128>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, q_offset, st);
  }
  return cudaErrorInvalidValue;
}

extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* o, int B, int Hq,
                                   int Hkv, int Sq, int Skv, int D, int causal,
                                   int q_offset, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) {
    return launch_f32<64>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, q_offset, st);
  }
  if (D == 128) {
    return launch_f32<128>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, q_offset, st);
  }
  return cudaErrorInvalidValue;
}
