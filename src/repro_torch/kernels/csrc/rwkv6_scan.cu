// Chunked WKV6 scan (RWKV6 "Finch" time mixing) for sm_90a, float32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rwkv6_scan.py
// `_wkv_kernel` (called through `rwkv6_scan`).  Same function:
//   r, k, v, w: [B, H, S, D] f32 (w is the per-token decay in (0, 1]),
//   u: [H, D] f32 bonus, y: [B, H, S, D] f32.  The [B, H, S, D] tensors
//   are read and written through their strides (the last one is 1), so
//   the model's [B, S, H, D] activations go in as transposed views, with
//   no copies.  Per (b, h), with the state
//   S [D, D] carried from chunk to chunk of C = 64 tokens:
//     L    = cumsum_t log max(w, 1e-37)          L_prev = L - log w
//     y    = (r * e^{L_prev}) S0 + A v
//     A    = [s < t] sum_d r[t,d] k[s,d] e^{L_prev[t,d] - L[s,d]}
//            + [s == t] sum_d r[t,d] u[d] k[t,d]
//     S'   = diag(e^{L[C-1]}) S0 + (k * e^{L[C-1] - L})^T v
//
// Design.  The TPU kernel walks a sequential grid axis over chunks and
// keeps S in VMEM.  Here one block of 512 threads owns one (b, h) and
// loops over the chunks itself; S stays in shared memory for the whole
// sequence, so the state never goes to device memory.  Each chunk stages
// r, k, v and w (then L and L_prev) in shared memory (~116 KB at D = 64,
// dynamic shared memory).  Every exponent is taken pairwise, so its
// argument is <= 0: a factored e^{L_prev} e^{-L} overflows once the log
// decay of one chunk passes -88 (w = 1e-6 gives about -884).  A ragged
// last chunk is staged with r = k = v = 0 and w = 1, so its padded rows
// add nothing to y or S; they are not stored.  All arithmetic is IEEE
// f32 (fmaf, expf, logf); no tensor cores, no TF32.
//
// What bounds it.  At B = 4, S = 2048, H = 40, D = 64 the function needs
// ~0.125 ms of bytes (5 tensors of 84 MB); its sequential recurrence needs
// ~5 D^2 f32 FLOPs a token (~0.10 ms at peak) and no exponentials.  The
// chunked form adds ~4.4 M exponentials per (b, h) (the [C, C, D]
// intra-chunk term; ~0.17 ms of the special-function units at peak), a
// cost of this design, not of the function.  This first version is a plain one: one block per (b, h), so B * H
// blocks (40 at B = 1) on 132 SMs, shared-memory loads in every inner
// loop, and the masked upper half of A costs issue slots.  Register
// tiles (4 rows x D/32 columns a thread) reuse each load several times.
#include <cuda_runtime.h>

namespace {

constexpr int C = 64;          // chunk length
constexpr int NT = 512;        // threads per block
constexpr int NW = NT / 32;    // warps per block
constexpr int TR = C / NW;     // rows of A and y per warp

template <int D>
constexpr int smem_floats() {
  // sr, sLp, sv: C*D; sk, sL: C*(D+1); sA: C*C; sS: D*D; su: D; sdiag: C
  return 3 * C * D + 2 * C * (D + 1) + C * C + D * D + D + C;
}

template <int D>
__global__ void __launch_bounds__(NT, 1)
wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, float* __restrict__ y, int H,
            int S, long long xb, long long xh, long long xs, long long yb,
            long long yh, long long ys) {
  constexpr int KS = D + 1;    // padded row: k and L are read down columns
  constexpr int JC = D / 32;   // output columns per lane: j = lane + 32 c
  constexpr int DR = D / NW;   // state rows per warp
  extern __shared__ __align__(16) float smem[];
  float* sr = smem;            // r, then r * e^{L_prev}      [C][D]
  float* sLp = sr + C * D;     // L_prev                      [C][D]
  float* sk = sLp + C * D;     // k, then k * e^{L_C - L}     [C][KS]
  float* sL = sk + C * KS;     // w, then L                   [C][KS]
  float* sv = sL + C * KS;     // v                           [C][D]
  float* sA = sv + C * D;      // A                           [C][C]
  float* sS = sA + C * C;      // state                       [D][D]
  float* su = sS + D * D;      // u of this head              [D]
  float* sdiag = su + D;       // bonus diagonal              [C]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int h = blockIdx.x % H;
  const int b = blockIdx.x / H;
  const long long xbase = b * xb + h * xh;   // row t at xbase + t * xs
  const long long ybase = b * yb + h * yh;

  for (int i = tid; i < D * D; i += NT) sS[i] = 0.f;
  for (int i = tid; i < D; i += NT) su[i] = u[h * D + i];

  for (int c0 = 0; c0 < S; c0 += C) {
    const int n = min(C, S - c0);
    const bool last = c0 + C >= S;

    // 1. stage the chunk; rows past n get r = k = v = 0 and w = 1
    for (int e = tid; e < C * D; e += NT) {
      const int t = e / D, d = e % D;
      const bool in = t < n;
      const long long g = xbase + (c0 + t) * xs + d;
      sr[t * D + d] = in ? r[g] : 0.f;
      sk[t * KS + d] = in ? k[g] : 0.f;
      sv[t * D + d] = in ? v[g] : 0.f;
      sL[t * KS + d] = in ? w[g] : 1.f;
    }
    __syncthreads();

    // 2. log-decay cumsum, one thread per channel; the bonus diagonal
    //    r_t . (u * k_t), one warp per row, on the other warps
    if (tid < D) {
      float run = 0.f;
      for (int t = 0; t < C; ++t) {
        const float lw = logf(fmaxf(sL[t * KS + tid], 1e-37f));
        run += lw;
        sL[t * KS + tid] = run;
        sLp[t * D + tid] = run - lw;
      }
    } else if (warp >= 2) {
      for (int t = warp - 2; t < C; t += NW - 2) {
        float acc = 0.f;
#pragma unroll
        for (int c = 0; c < JC; ++c) {
          const int d = lane + 32 * c;
          acc = fmaf(sr[t * D + d] * su[d], sk[t * KS + d], acc);
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          acc += __shfl_xor_sync(0xffffffffu, acc, off);
        if (lane == 0) sdiag[t] = acc;
      }
    }
    __syncthreads();

    // 3. A[t][s]: rows t = warp + NW i, columns s = lane + 32 c
    {
      float acc[TR][2];
#pragma unroll
      for (int i = 0; i < TR; ++i) acc[i][0] = acc[i][1] = 0.f;
      for (int d = 0; d < D; d += 4) {
        float kk[2][4], ll[2][4];
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            kk[c][q] = sk[(lane + 32 * c) * KS + d + q];
            ll[c][q] = sL[(lane + 32 * c) * KS + d + q];
          }
#pragma unroll
        for (int i = 0; i < TR; ++i) {
          const int t = warp + NW * i;
          const float4 rr = *reinterpret_cast<const float4*>(&sr[t * D + d]);
          const float4 lp = *reinterpret_cast<const float4*>(&sLp[t * D + d]);
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            if (lane + 32 * c < t) {
              float a = acc[i][c];
              a = fmaf(rr.x * kk[c][0], expf(lp.x - ll[c][0]), a);
              a = fmaf(rr.y * kk[c][1], expf(lp.y - ll[c][1]), a);
              a = fmaf(rr.z * kk[c][2], expf(lp.z - ll[c][2]), a);
              a = fmaf(rr.w * kk[c][3], expf(lp.w - ll[c][3]), a);
              acc[i][c] = a;
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        const int t = warp + NW * i;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int s = lane + 32 * c;
          sA[t * C + s] = s < t ? acc[i][c] : (s == t ? sdiag[t] : 0.f);
        }
      }
    }
    __syncthreads();

    // 4. r * e^{L_prev} in place; k * e^{L_C - L} in place (not needed
    //    after the last chunk)
    for (int e = tid; e < C * D; e += NT) {
      const int t = e / D, d = e % D;
      sr[t * D + d] *= expf(sLp[t * D + d]);
      if (!last) sk[t * KS + d] *= expf(sL[(C - 1) * KS + d] - sL[t * KS + d]);
    }
    __syncthreads();

    // 5. y = (r * e^{L_prev}) S0 + A v: rows t = warp + NW i, columns
    //    j = lane + 32 c
    {
      float acc[TR][JC];
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int c = 0; c < JC; ++c) acc[i][c] = 0.f;
      for (int d = 0; d < D; d += 4) {
        float s4[4][JC];
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int c = 0; c < JC; ++c)
            s4[q][c] = sS[(d + q) * D + lane + 32 * c];
#pragma unroll
        for (int i = 0; i < TR; ++i) {
          const float4 a =
              *reinterpret_cast<const float4*>(&sr[(warp + NW * i) * D + d]);
#pragma unroll
          for (int c = 0; c < JC; ++c) {
            float o = acc[i][c];
            o = fmaf(a.x, s4[0][c], o);
            o = fmaf(a.y, s4[1][c], o);
            o = fmaf(a.z, s4[2][c], o);
            o = fmaf(a.w, s4[3][c], o);
            acc[i][c] = o;
          }
        }
      }
      for (int s = 0; s < C; s += 4) {
        float v4[4][JC];
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int c = 0; c < JC; ++c)
            v4[q][c] = sv[(s + q) * D + lane + 32 * c];
#pragma unroll
        for (int i = 0; i < TR; ++i) {
          const float4 a =
              *reinterpret_cast<const float4*>(&sA[(warp + NW * i) * C + s]);
#pragma unroll
          for (int c = 0; c < JC; ++c) {
            float o = acc[i][c];
            o = fmaf(a.x, v4[0][c], o);
            o = fmaf(a.y, v4[1][c], o);
            o = fmaf(a.z, v4[2][c], o);
            o = fmaf(a.w, v4[3][c], o);
            acc[i][c] = o;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        const int t = warp + NW * i;
        if (t < n) {
#pragma unroll
          for (int c = 0; c < JC; ++c)
            y[ybase + (c0 + t) * ys + lane + 32 * c] = acc[i][c];
        }
      }
    }

    // 6. S' = diag(e^{L_C}) S0 + (k * e^{L_C - L})^T v: rows
    //    d = warp + NW i, columns j = lane + 32 c
    if (!last) {
      float st[DR][JC];
#pragma unroll
      for (int i = 0; i < DR; ++i) {
        const int d = warp + NW * i;
        const float decay = expf(sL[(C - 1) * KS + d]);
#pragma unroll
        for (int c = 0; c < JC; ++c)
          st[i][c] = decay * sS[d * D + lane + 32 * c];
      }
      for (int s = 0; s < C; ++s) {
        float vv[JC];
#pragma unroll
        for (int c = 0; c < JC; ++c) vv[c] = sv[s * D + lane + 32 * c];
#pragma unroll
        for (int i = 0; i < DR; ++i) {
          const float kd = sk[s * KS + warp + NW * i];
#pragma unroll
          for (int c = 0; c < JC; ++c) st[i][c] = fmaf(kd, vv[c], st[i][c]);
        }
      }
      __syncthreads();   // every read of this chunk's S0 and tiles is done
#pragma unroll
      for (int i = 0; i < DR; ++i)
#pragma unroll
        for (int c = 0; c < JC; ++c)
          sS[(warp + NW * i) * D + lane + 32 * c] = st[i][c];
    }
  }
}

template <int D>
int launch(const float* r, const float* k, const float* v, const float* w,
           const float* u, float* y, int BH, int H, int S,
           const long long* xst, const long long* yst, cudaStream_t stream) {
  const int bytes = smem_floats<D>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  wkv6_kernel<D><<<BH, NT, bytes, stream>>>(r, k, v, w, u, y, H, S, xst[0],
                                            xst[1], xst[2], yst[0], yst[1],
                                            yst[2]);
  return (int)cudaGetLastError();
}

}  // namespace

// r, k, v, w, y: [B, H, S, D] f32 with BH = B * H; r, k, v and w share the
// element strides xst = (batch, head, row), y has yst, and the last stride
// of both is 1.  u: [H, D] contiguous (head = block % H).  Returns the CUDA
// error of the launch (0 on success).
extern "C" int rwkv6_scan_f32(const float* r, const float* k, const float* v,
                              const float* w, const float* u, float* y,
                              int BH, int H, int S, int D,
                              const long long* xst, const long long* yst,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch<64>(r, k, v, w, u, y, BH, H, S, xst, yst, st);
  if (D == 32) return launch<32>(r, k, v, w, u, y, BH, H, S, xst, yst, st);
  return (int)cudaErrorInvalidValue;
}
