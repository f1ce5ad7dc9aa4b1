// Chunk-parallel WKV6 scan (RWKV6 "Finch" time mixing) for sm_90a, float32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rwkv6_scan.py
// `_wkv_kernel` (called through `rwkv6_scan`).  Same function:
//   r, k, v, w: [B, H, S, D] f32 (w is the per-token decay in (0, 1]),
//   u: [H, D] f32 bonus, y: [B, H, S, D] f32.  The [B, H, S, D] tensors
//   are read and written through their strides (the last one is 1), so
//   the model's [B, S, H, D] activations go in as transposed views, with
//   no copies.  Per (b, h), with chunks of C = 64 tokens and the state
//   E_c [D, D] entering chunk c (E_0 = 0):
//     L_t  = sum_{j<=t} log max(w_j, 1e-37)  (chunk-local), L_{-1} = 0
//     y_t  = (r_t * e^{L_{t-1}}) E_c + sum_{s<=t} A[t, s] v_s
//     A    = [s < t] sum_d r[t,d] k[s,d] e^{L_{t-1,d} - L_{s,d}}
//            + [s == t] sum_d r[t,d] u[d] k[t,d]
//     E_{c+1} = diag(e^{L_{C-1}}) E_c + U_c,
//     U_c  = (k * e^{L_{C-1} - L})^T v
//
// Design.  The TPU kernel walks its chunks in order on one core and keeps
// E in VMEM.  Here one block of 256 threads takes one chunk of one (b, h):
// 1,280 blocks at B = 1, H = 40, S = 2048 for the 132 SMs.  A block
// computes everything of its chunk that does not need E_c (the chunk-local
// pass: A, U_c and e^{L_{C-1}}), then takes E_c from the block of chunk
// c - 1 through device memory (the state pass: a chain of one multiply-add
// per state entry and chunk), hands E_{c+1} on, and sums y (the
// inter-chunk pass).  A block takes its chunk from a ticket counter, chunk
// by chunk over all (b, h): the block it waits for took an earlier
// ticket, so it is running, and the chain cannot deadlock.  Each E_c
// stays in a device buffer of B H (NC - 1) D D floats, so a caller may
// keep the state entering any chunk.
//
// Exponentials.  Every exponent is <= 0, because L does not increase: a
// factored e^{L_{t-1}} e^{-L_s} across a whole chunk overflows once its log
// decay passes -88 (w = 1e-6 gives about -884).  The chunk is cut into
// four sub-chunks of 16 tokens.  In a diagonal 16 x 16 block of A the
// decay is taken pair by pair, as the product of w between s and t (no
// exponential at all).  A block with s in an earlier sub-chunk j than t's
// sub-chunk i factors through b_i = 16 i - 1, the last token before t's
// sub-chunk, and b_{j+1}, the last of s's:
//   e^{L_{t-1} - L_s} = e^{L_{t-1} - L_{b_i}} e^{L_{b_i} - L_{b_{j+1}}}
//                       e^{L_{b_{j+1}} - L_s},
// three factors <= 1, so that block is a plain product of the tiles
// rq = r * e^{L_{t-1} - L_{b_i}} and kl = k * e^{L_{b_{j+1}} - L_s} with a
// per-channel gain g_ij in between; U_c takes kl with the gain
// e^{L_{C-1} - L_{b_{j+1}}}.  The log cumsum runs 16-token chains on 4 D
// threads and adds the sub-chunk offsets, not a 64-step chain.  The
// kernel keeps L in base 2 and takes 2^x and log2 on the special-function
// unit (ex2.approx, lg2.approx, relative error ~2^-22); all other
// arithmetic is IEEE f32 FMA.  No tensor cores: a 3xTF32 mma.sync form of
// the y product measured no faster than f32 FMA on the H100.
//
// What bounds it.  At B = 4, S = 2048, H = 40, D = 64 the function needs
// ~0.125 ms of bytes (5 tensors of 84 MB); this kernel adds the states
// (84 MB written, read twice soon after, mostly from L2).  Its f32
// work is ~0.9 M multiply-adds a chunk ((r e^{L_{t-1}}) E_c, A v, U_c, the
// off-diagonal blocks), ~0.14 ms at the card's f32 peak; the shared-memory
// loads that feed them and the block's barriers take the rest.  The
// kernel holds 74 KB of shared memory at D = 64, so three blocks share an
// SM and one block's loads and barriers overlap the others' arithmetic.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int C = 64;           // chunk length
constexpr int SUB = 16;         // sub-chunk length
constexpr int NSUB = C / SUB;
constexpr int NT = 256;         // threads per block
constexpr int NPAIR = NSUB * (NSUB - 1) / 2;   // off-diagonal blocks of A
constexpr int SPIN_LIMIT = 1 << 24;  // polls of a flag before a trap

// 2^x and log2 x on the special-function unit (ex2.approx, lg2.approx:
// relative error ~2^-22).  ex2 flushes a result below 2^-126 to 0, which
// only drops terms that small; lg2 sees w >= 1e-37, a normal float.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float lg2(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// rows t < n of a chunk of a [B, H, S, D] tensor (row t at
// base + t * xs) into a [C][P] shared tile; rows t >= n get `pad`.  With
// FLOOR (the decay w) each value loaded is raised to at least 1e-37.
template <int D, int P, bool FLOOR = false>
__device__ void load_rows(float* dst, const float* __restrict__ src,
                          long long base, long long xs, int n, float pad,
                          bool vec) {
  const auto floor = [](float x) { return FLOOR ? fmaxf(x, 1e-37f) : x; };
  if (vec) {
    for (int e = threadIdx.x; e < C * D / 4; e += NT) {
      const int t = e / (D / 4), d = 4 * (e % (D / 4));
      float4 x = make_float4(pad, pad, pad, pad);
      if (t < n) {
        x = *reinterpret_cast<const float4*>(src + base + t * xs + d);
        x = make_float4(floor(x.x), floor(x.y), floor(x.z), floor(x.w));
      }
      *reinterpret_cast<float4*>(dst + t * P + d) = x;
    }
  } else {
    for (int e = threadIdx.x; e < C * D; e += NT) {
      const int t = e / D, d = e % D;
      dst[t * P + d] = t < n ? floor(src[base + t * xs + d]) : pad;
    }
  }
}

// sL holds w (floored at 1e-37) in rows 1..C; leaves L_{t} in row t + 1
// and 0 in row 0, so row t is L_{t-1} and row 16 i is L_{b_i}.  Thread
// (i, d) runs the 16-token chain of sub-chunk i, then adds the totals of
// the sub-chunks before it.
template <int D, int P>
__device__ void log_cumsum(float* sL) {
  const int i = threadIdx.x / D, d = threadIdx.x % D;
  if (threadIdx.x < D) sL[d] = 0.f;
  if (i < NSUB) {
    float run = 0.f;
    for (int t = SUB * i + 1; t <= SUB * (i + 1); ++t) {
      run += lg2(sL[t * P + d]);
      sL[t * P + d] = run;
    }
  }
  __syncthreads();
  float off = 0.f;
  if (i < NSUB)
    for (int q = 0; q < i; ++q) off += sL[SUB * (q + 1) * P + d];
  __syncthreads();
  if (i > 0 && i < NSUB)
    for (int t = SUB * i + 1; t <= SUB * (i + 1); ++t) sL[t * P + d] += off;
  __syncthreads();
}

// acc[m][.] += sum_{q<4} a[m * as + q] * b[q * bs + .] for TM rows and 4
// columns; a and b are 16-byte aligned shared addresses
template <int TM>
__device__ __forceinline__ void mac4(float (&acc)[TM][4], const float* a,
                                     int as, const float* b, int bs) {
  float4 bq[4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
    bq[q] = *reinterpret_cast<const float4*>(b + q * bs);
#pragma unroll
  for (int m = 0; m < TM; ++m) {
    const float4 x = *reinterpret_cast<const float4*>(a + m * as);
    const float xa[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      acc[m][0] = fmaf(xa[q], bq[q].x, acc[m][0]);
      acc[m][1] = fmaf(xa[q], bq[q].y, acc[m][1]);
      acc[m][2] = fmaf(xa[q], bq[q].z, acc[m][2]);
      acc[m][3] = fmaf(xa[q], bq[q].w, acc[m][3]);
    }
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

__device__ __forceinline__ float4 mul4(float4 a, float4 b) {
  return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
}

__device__ __forceinline__ float4 sub4(float4 a, float4 b) {
  return make_float4(a.x - b.x, a.y - b.y, a.z - b.z, a.w - b.w);
}

__device__ __forceinline__ float4 ex2_4(float4 a) {
  return make_float4(ex2(a.x), ex2(a.y), ex2(a.z), ex2(a.w));
}

// x[0 .. M) = p[0 .. M), p 4 M-byte aligned (M = 1 or 4)
template <int M>
__device__ __forceinline__ void ldm(float (&x)[M], const float* p) {
  if constexpr (M == 4) {
    const float4 v = ld4(p);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else {
#pragma unroll
    for (int m = 0; m < M; ++m) x[m] = p[m];
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, a.x * b.x)));
}



template <int D>
constexpr int smem_floats() {
  // sR, sK: C (D+4); sL: (C+1) (D+4); sA: C (C+4); sg; se, sgE; sdec, su
  return 2 * C * (D + 4) + (C + 1) * (D + 4) + C * (C + 4) + NPAIR * D +
         2 * NSUB * D + 2 * D;
}

// One chunk of one (b, h) per block, taken from the ticket counter
// flags[BH * NC]; flags[bh * NC + c] turns 1 once E_{c+1} is in E.
template <int D>
__global__ void __launch_bounds__(NT, 3)
wkv6_chunk(const float* __restrict__ r, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ w,
           const float* __restrict__ u, float* __restrict__ E,
           int* __restrict__ flags, float* __restrict__ y, int BH, int H,
           int S, int NC, long long xb, long long xh, long long xs,
           long long yb, long long yh, long long ys, bool vec) {
  constexpr int P = D + 4;
  constexpr int PA = C + 4;
  constexpr int G4 = D / 16;       // float4 groups of channels a quarter
  constexpr int NOFF = 192;        // threads on the off-diagonal blocks
  extern __shared__ __align__(16) float smem[];
  float* sR = smem;              // r; rq; r 2^{L_{t-1}}            [C][P]
  float* sK = sR + C * P;        // k; kl; E_c                      [C][P]
  float* sL = sK + C * P;        // w (row t+1); L; v               [C+1][P]
  float* sA = sL + (C + 1) * P;  // A                               [C][PA]
  float* sg = sA + C * PA;       // g_ij, pair p = i (i-1)/2 + j    [NPAIR][D]
  float* se = sg + NPAIR * D;    // 2^{L_{b_i}}                     [NSUB][D]
  float* sgE = se + NSUB * D;    // 2^{L_{C-1} - L_{b_{j+1}}}       [NSUB][D]
  float* sdec = sgE + NSUB * D;  // 2^{L_{C-1}}                     [D]
  float* su = sdec + D;          // u of this head                  [D]
  __shared__ int ticket;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) ticket = atomicAdd(flags + BH * NC, 1);
  __syncthreads();
  const int c = ticket / BH, bh = ticket % BH;
  const int h = bh % H;
  const int c0 = c * C, n = min(C, S - c0);
  const long long xbase = (bh / H) * xb + h * xh + (long long)c0 * xs;
  load_rows<D, P>(sR, r, xbase, xs, n, 0.f, vec);
  load_rows<D, P>(sK, k, xbase, xs, n, 0.f, vec);
  load_rows<D, P, true>(sL + P, w, xbase, xs, n, 1.f, vec);
  if (tid < D) su[tid] = u[h * D + tid];
  __syncthreads();

  // 1. A's diagonal blocks (warps 0-3, warp i on sub-chunk i).  For
  //    s < t in one sub-chunk the decay 2^{L_{t-1} - L_s} is the product
  //    of w over s < j < t, so a thread walks t = s+1 .. 15 with k_s times
  //    that running product (no exponential, no overflow: every factor
  //    is <= 1), and takes the bonus r_s . (u * k_s).  Lane 4 G + q takes
  //    the columns s = G and 15 - G (15 steps between them, and one load
  //    of r_t and w_t for both) on quarter q of the channels; the four
  //    quarters are summed by shuffles.
  if (warp < NSUB) {
    const int row = SUB * warp, q = lane & 3;
    const int s1 = lane >> 2, s2 = SUB - 1 - s1;
    float acc1[SUB] = {}, acc2[SUB] = {};
    for (int gq = 0; gq < G4; ++gq) {
      const int d = 4 * (q * G4 + gq);
      const float4 us = ld4(su + d);
      float4 kp1 = ld4(sK + (row + s1) * P + d);
      float4 kp2 = ld4(sK + (row + s2) * P + d);
      acc1[0] += dot4(mul4(ld4(sR + (row + s1) * P + d), us), kp1);
      acc2[0] += dot4(mul4(ld4(sR + (row + s2) * P + d), us), kp2);
#pragma unroll
      for (int t = 1; t < SUB; ++t) {
        if (t > s1) {                  // t > s2 implies t > s1
          const float4 rt = ld4(sR + (row + t) * P + d);
          const float4 wt = ld4(sL + (row + t + 1) * P + d);
          acc1[t] += dot4(rt, kp1);
          kp1 = mul4(kp1, wt);
          if (t > s2) {
            acc2[t] += dot4(rt, kp2);
            kp2 = mul4(kp2, wt);
          }
        }
      }
    }
#pragma unroll
    for (int t = 0; t < SUB; ++t) {
      acc1[t] += __shfl_xor_sync(0xffffffffu, acc1[t], 1);
      acc1[t] += __shfl_xor_sync(0xffffffffu, acc1[t], 2);
      acc2[t] += __shfl_xor_sync(0xffffffffu, acc2[t], 1);
      acc2[t] += __shfl_xor_sync(0xffffffffu, acc2[t], 2);
    }
    if (q == 0) {
#pragma unroll
      for (int t = 0; t < SUB; ++t) {  // acc[0] is the bonus A[s][s]
        sA[(row + t) * PA + row + s1] =
            t > s1 ? acc1[t] : (t == s1 ? acc1[0] : 0.f);
        sA[(row + t) * PA + row + s2] =
            t > s2 ? acc2[t] : (t == s2 ? acc2[0] : 0.f);
      }
    }
  }
  __syncthreads();
  log_cumsum<D, P>(sL);

  // 2. the factored tiles in place: rq = r 2^{L_{t-1} - L_{b_i}} over r
  //    (in sub-chunk 0, b_0 = -1 and this is r 2^{L_{t-1}}), and
  //    kl = k 2^{L_{b_{j+1}} - L_s} over k; the gains g_ij =
  //    2^{L_{b_i} - L_{b_{j+1}}}, 2^{L_{b_i}}, 2^{L_{C-1} - L_{b_{j+1}}}
  //    and 2^{L_{C-1}}
  for (int e = tid; e < C * D / 4; e += NT) {
    const int t = e / (D / 4), d = 4 * (e % (D / 4));
    float* x = sR + t * P + d;
    st4(x, mul4(ld4(x), ex2_4(sub4(ld4(sL + t * P + d),
                                   ld4(sL + SUB * (t / SUB) * P + d)))));
    x = sK + t * P + d;
    st4(x, mul4(ld4(x), ex2_4(sub4(ld4(sL + SUB * (t / SUB + 1) * P + d),
                                   ld4(sL + (t + 1) * P + d)))));
  }
  for (int e = tid; e < (NPAIR + 2 * NSUB + 1) * D; e += NT) {
    const int p = e / D, d = e % D;
    float x;
    if (p < NPAIR) {                       // g_ij
      const int i = p < 1 ? 1 : (p < 3 ? 2 : 3), j = p - i * (i - 1) / 2;
      x = sL[SUB * i * P + d] - sL[SUB * (j + 1) * P + d];
    } else if (p < NPAIR + NSUB) {         // 2^{L_{b_i}}
      x = sL[SUB * (p - NPAIR) * P + d];
    } else if (p < NPAIR + 2 * NSUB) {     // 2^{L_{C-1} - L_{b_{j+1}}}
      x = sL[C * P + d] - sL[SUB * (p - NPAIR - NSUB + 1) * P + d];
    } else {                               // 2^{L_{C-1}}
      x = sL[C * P + d];
    }
    sg[e] = ex2(x);       // sg, se, sgE and sdec lie end to end
  }
  __syncthreads();

  // 3. v over L
  load_rows<D, P>(sL, v, xbase, xs, n, 0.f, vec);
  __syncthreads();

  // 4. U_c = (kl 2^{L_{C-1} - L_{b_{j+1}}})^T v: thread rows d0 ..
  //    d0 + TM - 1 of U, columns j0 .. j0 + 3
  constexpr int CG = D / 4, TM = D / (NT / CG);
  const int j0 = 4 * (tid % CG), d0 = TM * (tid / CG);
  float st[TM][4] = {};
  for (int j = 0; j < (c < NC - 1 ? NSUB : 0); ++j) {
    float g[TM];
    ldm<TM>(g, sgE + j * D + d0);
    for (int s = SUB * j; s < SUB * (j + 1); ++s) {
      float a[TM];
      ldm<TM>(a, sK + s * P + d0);
      const float4 b = ld4(sL + s * P + j0);
#pragma unroll
      for (int m = 0; m < TM; ++m) {
        const float x = a[m] * g[m];
        st[m][0] = fmaf(x, b.x, st[m][0]);
        st[m][1] = fmaf(x, b.y, st[m][1]);
        st[m][2] = fmaf(x, b.z, st[m][2]);
        st[m][3] = fmaf(x, b.w, st[m][3]);
      }
    }
  }

  // 5. the state pass: wait for E_c (none at c = 0), then hand
  //    E_{c+1} = 2^{L_{C-1}} E_c + U_c on (none after the last chunk)
  const float* Ec = E + ((long long)bh * (NC - 1) + c - 1) * D * D;
  if (c > 0) {
    if (tid == 0) {
      const volatile int* f = flags + bh * NC + c - 1;
      int polls = 0;
      while (*f == 0) {
        __nanosleep(64);
        if (++polls == SPIN_LIMIT) __trap();   // a fault, not a hang
      }
      __threadfence();
    }
    __syncthreads();
    if (c < NC - 1) {
#pragma unroll
      for (int m = 0; m < TM; ++m) {
        const float4 x =
            __ldcg(reinterpret_cast<const float4*>(Ec + (d0 + m) * D + j0));
        const float g = sdec[d0 + m];
        st[m][0] = fmaf(g, x.x, st[m][0]);
        st[m][1] = fmaf(g, x.y, st[m][1]);
        st[m][2] = fmaf(g, x.z, st[m][2]);
        st[m][3] = fmaf(g, x.w, st[m][3]);
      }
    }
  }
  if (c < NC - 1) {
    float* En = E + ((long long)bh * (NC - 1) + c) * D * D;
#pragma unroll
    for (int m = 0; m < TM; ++m)
      __stcg(reinterpret_cast<float4*>(En + (d0 + m) * D + j0),
             make_float4(st[m][0], st[m][1], st[m][2], st[m][3]));
    __threadfence();
  }
  __syncthreads();
  if (tid == 0 && c < NC - 1) atomicExch(flags + bh * NC + c, 1);

  // 6. A's off-diagonal blocks, 4 x 4 tiles of rq g kl^T, each on two
  //    lanes (l, l ^ 16) that split the channels (warps 0-5)
  if (tid < NOFF) {
    const int tile = 16 * warp + (lane & 15), half = lane >> 4;
    const int pr = tile / 16;
    const int i = pr < 1 ? 1 : (pr < 3 ? 2 : 3), j = pr - i * (i - 1) / 2;
    const int t0 = SUB * i + 4 * ((tile % 16) / 4);
    const int s0 = SUB * j + 4 * (tile % 4);
    float acc[4][4] = {};
    for (int d = half * (D / 2); d < (half + 1) * (D / 2); d += 4) {
      const float4 g = ld4(&sg[pr * D + d]);
      float4 kq[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) kq[m] = ld4(&sK[(s0 + m) * P + d]);
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        float4 x = ld4(&sR[(t0 + m) * P + d]);
        x.x *= g.x; x.y *= g.y; x.z *= g.z; x.w *= g.w;
#pragma unroll
        for (int l = 0; l < 4; ++l) acc[m][l] += dot4(x, kq[l]);
      }
    }
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int l = 0; l < 4; ++l)
        acc[m][l] += __shfl_xor_sync(0xffffffffu, acc[m][l], 16);
    if (half == 0) {
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int l = 0; l < 4; ++l) sA[(t0 + m) * PA + s0 + l] = acc[m][l];
    }
  }
  __syncthreads();

  // 7. r 2^{L_{t-1}} = rq 2^{L_{b_i}} (sub-chunks 1..3); E_c over kl
  for (int e = SUB * D / 4 + tid; e < C * D / 4; e += NT) {
    const int t = e / (D / 4), d = 4 * (e % (D / 4));
    float* x = sR + t * P + d;
    st4(x, mul4(ld4(x), ld4(se + (t / SUB) * D + d)));
  }
  if (c > 0) {
    for (int e = tid; e < D * D / 4; e += NT) {
      const int d = e / (D / 4), j = 4 * (e % (D / 4));
      st4(sK + d * P + j,
          __ldcg(reinterpret_cast<const float4*>(Ec + d * D + j)));
    }
  }
  __syncthreads();

  // 8. the inter-chunk pass and y = (r 2^{L_{t-1}}) E_c + A v: rows
  //    t0 .. t0 + YM - 1 (one sub-chunk, so A's row ends at column
  //    16 (i + 1)), columns y0 .. y0 + 3
  constexpr int YM = C / (NT / CG);
  const int y0 = 4 * (tid % CG), t0 = YM * (tid / CG);
  float acc[YM][4] = {};
  if (c > 0)
    for (int d = 0; d < D; d += 4)
      mac4<YM>(acc, sR + t0 * P + d, P, sK + d * P + y0, P);
  const int send = SUB * (t0 / SUB + 1);
  for (int s = 0; s < send; s += 4)
    mac4<YM>(acc, sA + t0 * PA + s, PA, sL + s * P + y0, P);
  const long long ybase = (bh / H) * yb + h * yh + (long long)c0 * ys + y0;
#pragma unroll
  for (int m = 0; m < YM; ++m) {
    if (t0 + m >= n) break;
    float* dst = y + ybase + (t0 + m) * ys;
    if (vec) {
      st4(dst, make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]));
    } else {
#pragma unroll
      for (int l = 0; l < 4; ++l) dst[l] = acc[m][l];
    }
  }
}

// float4 loads and stores need 16-byte aligned rows
bool aligned(const void* const* ptrs, int n, const long long* st) {
  for (int i = 0; i < n; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16) return false;
  return st[0] % 4 == 0 && st[1] % 4 == 0 && st[2] % 4 == 0;
}

template <int D>
int launch(const float* r, const float* k, const float* v, const float* w,
           const float* u, float* E, int* flags, float* y, int BH, int H,
           int S, const long long* xst, const long long* yst, bool vec,
           cudaStream_t stream) {
  const int NC = (S + C - 1) / C;
  const int bytes = smem_floats<D>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_chunk<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  wkv6_chunk<D><<<BH * NC, NT, bytes, stream>>>(
      r, k, v, w, u, E, flags, y, BH, H, S, NC, xst[0], xst[1], xst[2],
      yst[0], yst[1], yst[2], vec);
  return (int)cudaGetLastError();
}

}  // namespace

// r, k, v, w, y: [B, H, S, D] f32 with BH = B * H; r, k, v and w share the
// element strides xst = (batch, head, row), y has yst, and the last stride
// of both is 1.  u: [H, D] contiguous (head = bh % H).  E: [BH][NC-1][D][D]
// f32 scratch (unused when NC = ceil(S / 64) is 1), filled with the state
// entering each chunk but the first; flags: BH NC + 1 ints, zero on entry.
// Launches one kernel on `stream`; returns the CUDA error of the launch
// (0 on success).
extern "C" int rwkv6_scan_f32(const float* r, const float* k, const float* v,
                              const float* w, const float* u, float* E,
                              int* flags, float* y, int BH, int H, int S,
                              int D, const long long* xst,
                              const long long* yst, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const void* px[] = {r, k, v, w};
  const void* py[] = {y};
  const bool vec = aligned(px, 4, xst) && aligned(py, 1, yst);
  if (D == 64)
    return launch<64>(r, k, v, w, u, E, flags, y, BH, H, S, xst, yst, vec,
                      st);
  if (D == 32)
    return launch<32>(r, k, v, w, u, E, flags, y, BH, H, S, xst, yst, vec,
                      st);
  return (int)cudaErrorInvalidValue;
}
