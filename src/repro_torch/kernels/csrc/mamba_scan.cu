// Mamba-1 selective scan for sm_90a, float32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/mamba_scan.py
// `_mamba_kernel` (called through `mamba_scan`).  Same function:
//   A: [di, N], dt, x: [B, S, di], b, c: [B, S, N], y: [B, S, di], all f32
//   and contiguous.  Per (batch, channel d), with the state h [N] from 0:
//     h_t = exp(dt_t[d] * A[d, :]) * h_{t-1} + (dt_t[d] * x_t[d]) * b_t
//     y_t[d] = h_t . c_t
//
// Design.  The TPU kernel walks a sequential grid axis over 64-token
// chunks and keeps h [256, N] in VMEM scratch between grid steps.  Here
// one thread owns one (b, d) and loops over the whole sequence itself,
// with its N states and its row of A in registers, so the state never
// leaves the thread.  A block of 128 threads covers 128 neighbouring
// channels of one batch row: every load of dt and x and every store of y
// is one coalesced 512-byte row segment.  The b and c rows of a token are
// shared by every channel, so each 16-token tile of them is staged in
// shared memory (double-buffered, one barrier a tile) and read as
// broadcasts.  The next tile's dt, x, b and c are loaded into registers
// before the current tile is computed, so the loads run one tile ahead of
// the recurrence.  Any S and any di work: the ragged last tile and the
// channels past di are masked.  N is 8 or 16.  All arithmetic is IEEE f32
// (expf, fmaf); expf of the same f32 product dt * A is what the plain
// PyTorch version takes, so dA agrees bit for bit.
//
// What bounds it.  At (B, S, di, N) = (4, 2048, 16384, 16): dt and x are
// read once and y written once, 1.61 GB (b, c and A are ~2 MB), ~0.48 ms
// at 3.35 TB/s.  The function takes B * S * di * N = 2.15e9 exponentials,
// inherent because A is a learned [di, N] matrix; at 16 a clock per SM
// (the special-function units) that is ~0.51 ms at a 1980 MHz clock.  Its
// ~6 f32 FLOPs per (b, s, d, n) are 1.3e10, ~0.19 ms at 67 TFLOP/s.  So
// the exponentials bound it, just above the bytes.  expf also costs ~6
// FMA-pipe instructions around each special-function one, which puts the
// issue slots near the same limit.  At B = 4 the grid has 512 blocks of
// 128 threads (~4 a SM), at B = 1 only 128 (one a SM), so B = 1 leans on
// the 16 independent state chains of each thread to hide latency.
#include <cuda_runtime.h>

namespace {

constexpr int NT = 128;  // threads per block: one channel d each
constexpr int T = 16;    // tokens per staged tile

// Loads the tile of T tokens from t0 into registers: this thread's dt and
// x column (0 past S or di) and its share of the b and c rows, which the
// caller stores to shared memory.
template <int N, int PER>
__device__ __forceinline__ void load_tile(
    float (&ndt)[T], float (&nx)[T], float (&nbc)[PER],
    const float* __restrict__ dtp, const float* __restrict__ xp,
    const float* __restrict__ b, const float* __restrict__ c,
    long long bcbase, long long bclen, int t0, int S, long long row,
    bool active, int tid) {
  constexpr int TN = T * N;
#pragma unroll
  for (int j = 0; j < T; ++j) {
    const bool in = active && t0 + j < S;
    ndt[j] = in ? dtp[(t0 + j) * row] : 0.f;
    nx[j] = in ? xp[(t0 + j) * row] : 0.f;
  }
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int e = tid + k * NT;             // [0, TN): b, [TN, 2 TN): c
    const int f = e < TN ? e : e - TN;
    const long long g = (long long)t0 * N + f;
    float v = 0.f;
    if (e < 2 * TN && g < bclen) v = (e < TN ? b : c)[bcbase + g];
    nbc[k] = v;
  }
}

template <int N>
__global__ void __launch_bounds__(NT)
mamba_scan_kernel(const float* __restrict__ A, const float* __restrict__ dt,
                  const float* __restrict__ b, const float* __restrict__ c,
                  const float* __restrict__ x, float* __restrict__ y, int S,
                  int di) {
  constexpr int TN = T * N;                 // floats of one b (or c) tile
  constexpr int PER = (2 * TN + NT - 1) / NT;
  __shared__ __align__(16) float sbc[2][2 * TN];  // [buffer][b tile, c tile]

  const int tid = threadIdx.x;
  const int d = blockIdx.x * NT + tid;
  const bool active = d < di;
  const long long row = di;                 // elements between two tokens
  const long long base = (long long)blockIdx.y * S * row + (active ? d : 0);
  const float* dtp = dt + base;
  const float* xp = x + base;
  float* yp = y + base;
  const long long bcbase = (long long)blockIdx.y * S * N;
  const long long bclen = (long long)S * N;

  float a[N], h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    a[n] = active ? A[(long long)d * N + n] : 0.f;
    h[n] = 0.f;
  }

  // the tile in flight: this thread's dt and x column, its share of b / c
  float ndt[T], nx[T], nbc[PER];
  load_tile<N, PER>(ndt, nx, nbc, dtp, xp, b, c, bcbase, bclen, 0, S, row,
                    active, tid);
  int buf = 0;
  for (int t0 = 0; t0 < S; t0 += T, buf ^= 1) {
    float cdt[T], cx[T];
#pragma unroll
    for (int j = 0; j < T; ++j) {
      cdt[j] = ndt[j];
      cx[j] = nx[j];
    }
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int e = tid + k * NT;
      if (e < 2 * TN) sbc[buf][e] = nbc[k];
    }
    if (t0 + T < S)
      load_tile<N, PER>(ndt, nx, nbc, dtp, xp, b, c, bcbase, bclen, t0 + T,
                        S, row, active, tid);
    // sbc[buf] is now whole.  The buffer the next tile writes was last
    // read two tiles ago, before every thread passed the previous barrier.
    __syncthreads();

    const float* sb = sbc[buf];
    const float* sc = sbc[buf] + TN;
    const int nt = min(T, S - t0);
#pragma unroll
    for (int j = 0; j < T; ++j) {
      if (j < nt) {
        const float dtv = cdt[j];
        const float dtx = dtv * cx[j];
        float acc = 0.f;
#pragma unroll
        for (int n = 0; n < N; n += 4) {
          const float4 bb = *reinterpret_cast<const float4*>(sb + j * N + n);
          const float4 cc = *reinterpret_cast<const float4*>(sc + j * N + n);
          h[n] = fmaf(expf(dtv * a[n]), h[n], dtx * bb.x);
          h[n + 1] = fmaf(expf(dtv * a[n + 1]), h[n + 1], dtx * bb.y);
          h[n + 2] = fmaf(expf(dtv * a[n + 2]), h[n + 2], dtx * bb.z);
          h[n + 3] = fmaf(expf(dtv * a[n + 3]), h[n + 3], dtx * bb.w);
          acc = fmaf(h[n], cc.x, acc);
          acc = fmaf(h[n + 1], cc.y, acc);
          acc = fmaf(h[n + 2], cc.z, acc);
          acc = fmaf(h[n + 3], cc.w, acc);
        }
        if (active) yp[(t0 + j) * row] = acc;
      }
    }
  }
}

template <int N>
int launch(const float* A, const float* dt, const float* b, const float* c,
           const float* x, float* y, int B, int S, int di,
           cudaStream_t stream) {
  const dim3 grid((di + NT - 1) / NT, B);
  mamba_scan_kernel<N><<<grid, NT, 0, stream>>>(A, dt, b, c, x, y, S, di);
  return (int)cudaGetLastError();
}

}  // namespace

// A: [di, N]; dt, x, y: [B, S, di]; b, c: [B, S, N]; all f32, contiguous.
// N is 8 or 16; 1 <= B <= 65535.  Returns the CUDA error of the launch (0
// on success).
extern "C" int mamba_scan_f32(const float* A, const float* dt, const float* b,
                              const float* c, const float* x, float* y, int B,
                              int S, int di, int N, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N == 16) return launch<16>(A, dt, b, c, x, y, B, S, di, st);
  if (N == 8) return launch<8>(A, dt, b, c, x, y, B, S, di, st);
  return (int)cudaErrorInvalidValue;
}
