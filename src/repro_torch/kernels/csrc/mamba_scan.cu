// Mamba-1 selective scan for sm_90a, float32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/mamba_scan.py
// `_mamba_kernel` (called through `mamba_scan`).  Same function:
//   A: [di, N], dt, x: [B, S, di], b, c: [B, S, N], y: [B, S, di], all f32
//   and contiguous.  Per (batch, channel d), with the state h [N] from 0:
//     h_t = exp(dt_t[d] * A[d, :]) * h_{t-1} + (dt_t[d] * x_t[d]) * b_t
//     y_t[d] = h_t . c_t
// and, when asked for (hT != nullptr), the state after the last token,
// hT: [B, di, N] f32, as the reference's token loop `_scan_chunk` returns
// it (src/repro/models/mamba.py:84).  Serving's prefill takes it.
//
// What bounds it.  At (B, S, di, N) = (4, 2048, 16384, 16): dt and x are
// read once and y written once, 1.61 GB (b, c and A are ~2 MB), ~0.48 ms
// at 3.35 TB/s.  The function takes B * S * di * N = 2.15e9 exponentials,
// inherent because A is a learned [di, N] matrix; the special-function
// units do 16 a clock per SM, ~0.51 ms at 1980 MHz on 132 SMs.  So the
// exponentials bound it, just above the bytes.  Every exponential here is
// one `ex2.approx.ftz` on those units (A is pre-scaled by log2 e once per
// thread), so that count stays the bound.  Besides the exponential, each
// (b, s, d, n) takes four FMA-pipe instructions (dt * a, dt x * b, the
// state's FMA, y's FMA): ~0.33 ms of issue at full rate.
//
// Design.  The N states of a channel are split over LPC = N / SPT lanes of
// a warp, SPT = 8 states a thread (4 and 2 were slower at both of
// jamba's shapes: `probe_mamba.py`), so a thread holds 16 floats of state
// and A, and the grid has B * di * LPC threads in blocks of 256.  A block
// covers CB = 256 / LPC neighbouring channels of one batch row and walks
// the whole sequence itself, so the state never leaves its registers and the
// sequence is not split (a split would need exp(A * sum dt) a second time
// for every token and state to carry a state in: twice the exponentials
// that bound the kernel).  Tiles of T = 16 tokens of dt and x (CB
// channels) and of b and c (N states) reach shared memory through
// `cp.async` in a ring of three stages; one barrier a tile.  Lane q of a
// channel takes states [q SPT, (q + 1) SPT) and, after its SPT FMAs of y,
// the lanes of the channel sum their parts with log2(LPC) `shfl.xor`; lane
// (t mod LPC) puts y_t in a shared [T][CB] tile (two, alternating), which
// the block stores after the next barrier as whole rows of CB channels in
// 16-byte stores: stored token by token from the lanes, y took a third of
// the time (`probe_mamba.py`).  Past S the tile holds zeros: dt = 0 leaves
// h as it is (exp(0) = 1, no input), so the padded tokens need no branch
// and hT is right.  Channels past di are zeros too and store nothing.
// With di a multiple of 4 (and 16-byte aligned rows) the copies are 16
// bytes, else 4.
//
// Accuracy.  `ex2.approx` and the plain version's `expf` round a decay
// factor near 1 differently, and under weak decay each rounding compounds
// over the tokens, so y and hT agree with the plain version to within
// tolerance, not bit for bit.  Against the same function in float64 the
// kernel's error is no larger than the f32 plain version's own
// (`chip_smoke.py` `mamba_cases`, `f64_err`); an argument in extra
// precision (log2 e split in two) changes nothing there.
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;     // threads a block
constexpr int T = 16;       // tokens a tile
constexpr int NS = 3;       // tiles in the ring
constexpr int SPT = 8;      // states a thread
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// 16 (or 4) bytes from global to shared memory, zeros where !in.
__device__ __forceinline__ void cp16(float* dst, const float* src, bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(in ? 16 : 0));
}

__device__ __forceinline__ void cp4(float* dst, const float* src, bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(in ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int K>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(K));
}

// K consecutive floats from shared memory (16-byte aligned).
template <int K>
__device__ __forceinline__ void lds(float (&v)[K], const float* p) {
  static_assert(K % 4 == 0, "whole float4s");
#pragma unroll
  for (int i = 0; i < K; i += 4) {
    const float4 t = *reinterpret_cast<const float4*>(p + i);
    v[i] = t.x;
    v[i + 1] = t.y;
    v[i + 2] = t.z;
    v[i + 3] = t.w;
  }
}

template <int N>
struct Shape {
  static constexpr int LPC = N / SPT;    // lanes a channel
  static constexpr int CPW = 32 / LPC;   // channels a warp
  static constexpr int CB = NT / LPC;    // channels a block
  // a ring of NS stages of [T][CB] dt, x and [T][N] b, c, and two [T][CB]
  // tiles of y
  static constexpr int SMEM_FLOATS = 2 * NS * T * (CB + N) + 2 * T * CB;
};

template <int N>
__global__ void __launch_bounds__(NT, 3)
mamba_scan_kernel(const float* __restrict__ A, const float* __restrict__ dt,
                  const float* __restrict__ b, const float* __restrict__ c,
                  const float* __restrict__ x, float* __restrict__ y,
                  float* __restrict__ hT, int S, int di) {
  using Sh = Shape<N>;
  constexpr int LPC = Sh::LPC, CPW = Sh::CPW, CB = Sh::CB;
  extern __shared__ __align__(16) float smem[];
  float* sdt = smem;                        // [NS][T][CB]
  float* sx = sdt + NS * T * CB;
  float* sb = sx + NS * T * CB;             // [NS][T][N]
  float* sc = sb + NS * T * N;
  float* sy = sc + NS * T * N;              // [2][T][CB]

  const int tid = threadIdx.x, lane = tid & 31;
  const int q = lane / CPW;                 // this lane's states: q SPT + i
  const int cl = (tid >> 5) * CPW + lane % CPW;
  const int d0 = blockIdx.x * CB;
  const int d = d0 + cl;
  const bool active = d < di;
  const long long row0 = (long long)blockIdx.y * S;   // first token row
  // 16-byte copies of dt, x and y where every row starts 16-byte aligned
  const bool vec = (di & 3) == 0 && (reinterpret_cast<size_t>(dt) & 15) == 0
                   && (reinterpret_cast<size_t>(x) & 15) == 0
                   && (reinterpret_cast<size_t>(y) & 15) == 0;

  // Issues the copies of the tile of tokens [t0, t0 + T) into ring stage st.
  auto load = [&](int st, int t0) {
    const int ntok = min(T, S - t0);
    float* tdt = sdt + st * T * CB;
    float* tx = sx + st * T * CB;
    if (vec) {
      constexpr int CH = CB / 4;              // 16-byte pieces of a row
#pragma unroll
      for (int r = 0; r < (T * CH + NT - 1) / NT; ++r) {
        const int e = tid + r * NT;
        const int j = e / CH, k = 4 * (e % CH);
        const bool in = e < T * CH && j < ntok && d0 + k < di;
        const long long g = in ? (row0 + t0 + j) * di + d0 + k : 0;
        if (e < T * CH) {
          cp16(tdt + j * CB + k, dt + g, in);
          cp16(tx + j * CB + k, x + g, in);
        }
      }
    } else {
#pragma unroll 4
      for (int r = 0; r < T * CB / NT; ++r) {
        const int e = tid + r * NT;
        const int j = e / CB, k = e % CB;
        const bool in = j < ntok && d0 + k < di;
        const long long g = in ? (row0 + t0 + j) * di + d0 + k : 0;
        cp4(tdt + j * CB + k, dt + g, in);
        cp4(tx + j * CB + k, x + g, in);
      }
    }
    constexpr int BCH = T * N / 4;          // 16-byte pieces of a b tile
    if (tid < 2 * BCH) {
      const int f = 4 * (tid % BCH);
      const bool in = f / N < ntok;
      const long long g = in ? (row0 + t0) * N + f : 0;
      float* dst = (tid < BCH ? sb : sc) + st * T * N + f;
      cp16(dst, (tid < BCH ? b : c) + g, in);
    }
  };

  // Stores the y of the tile of tokens [t0, t0 + T), which the compute
  // left in y tile u, as whole rows of CB channels.
  auto store_y = [&](int u, int t0) {
    const int ntok = min(T, S - t0);
    const float* ty = sy + u * T * CB;
    if (vec) {
      constexpr int CH = CB / 4;
#pragma unroll
      for (int r = 0; r < (T * CH + NT - 1) / NT; ++r) {
        const int e = tid + r * NT;
        const int j = e / CH, k = 4 * (e % CH);
        if (e < T * CH && j < ntok && d0 + k < di)
          *reinterpret_cast<float4*>(y + (row0 + t0 + j) * di + d0 + k) =
              *reinterpret_cast<const float4*>(ty + j * CB + k);
      }
    } else {
#pragma unroll 4
      for (int r = 0; r < T * CB / NT; ++r) {
        const int e = tid + r * NT;
        const int j = e / CB, k = e % CB;
        if (j < ntok && d0 + k < di)
          y[(row0 + t0 + j) * di + d0 + k] = ty[j * CB + k];
      }
    }
  };

  float a2[SPT], h[SPT];
#pragma unroll
  for (int i = 0; i < SPT; ++i) {
    a2[i] = active ? A[(long long)d * N + q * SPT + i] * LOG2E : 0.f;
    h[i] = 0.f;
  }

  const int ntiles = (S + T - 1) / T;
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < ntiles) load(s, s * T);
    cp_commit();
  }
  for (int k = 0; k < ntiles; ++k) {
    cp_wait<NS - 2>();   // this thread's copies of tile k have landed
    // Every thread's have, and every thread is done with tile k - 1: its
    // y tile is whole, and its stage is free for the next copies.  The y
    // tile that tile k writes was stored before the previous barrier.
    __syncthreads();
    if (k > 0) store_y((k - 1) & 1, (k - 1) * T);
    const int kn = k + NS - 1;
    if (kn < ntiles) load(kn % NS, kn * T);
    cp_commit();

    const int st = k % NS;
    const float* tdt = sdt + st * T * CB + cl;
    const float* tx = sx + st * T * CB + cl;
    float* ty = sy + (k & 1) * T * CB + cl;
    const float* tb = sb + st * T * N + q * SPT;
    const float* tc = sc + st * T * N + q * SPT;
#pragma unroll
    for (int j = 0; j < T; ++j) {
      const float dtv = tdt[j * CB];
      const float dtx = dtv * tx[j * CB];
      float bb[SPT], cc[SPT];
      lds<SPT>(bb, tb + j * N);
      lds<SPT>(cc, tc + j * N);
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < SPT; ++i) {
        h[i] = fmaf(ex2(dtv * a2[i]), h[i], dtx * bb[i]);
        acc = fmaf(h[i], cc[i], acc);
      }
#pragma unroll
      for (int m = CPW; m < 32; m <<= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, m);
      if (q == j % LPC) ty[j * CB] = acc;
    }
  }
  __syncthreads();
  store_y((ntiles - 1) & 1, (ntiles - 1) * T);

  if (hT != nullptr && active) {
    float* hp = hT + ((long long)blockIdx.y * di + d) * N + q * SPT;
#pragma unroll
    for (int i = 0; i < SPT; i += 4)
      *reinterpret_cast<float4*>(hp + i) =
          make_float4(h[i], h[i + 1], h[i + 2], h[i + 3]);
  }
}

template <int N>
int launch(const float* A, const float* dt, const float* b, const float* c,
           const float* x, float* y, float* hT, int B, int S, int di,
           cudaStream_t stream) {
  using Sh = Shape<N>;
  const int bytes = Sh::SMEM_FLOATS * (int)sizeof(float);
  auto kernel = mamba_scan_kernel<N>;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((di + Sh::CB - 1) / Sh::CB, B);
  kernel<<<grid, NT, bytes, stream>>>(A, dt, b, c, x, y, hT, S, di);
  return (int)cudaGetLastError();
}

}  // namespace

// A: [di, N]; dt, x, y: [B, S, di]; b, c: [B, S, N]; hT: [B, di, N] or
// null; all f32, contiguous.  N is 8 or 16; 1 <= B <= 65535.  Returns the
// CUDA error of the launch (0 on success).
extern "C" int mamba_scan_f32(const float* A, const float* dt, const float* b,
                              const float* c, const float* x, float* y,
                              float* hT, int B, int S, int di, int N,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N == 16) return launch<16>(A, dt, b, c, x, y, hT, B, S, di, st);
  if (N == 8) return launch<8>(A, dt, b, c, x, y, hT, B, S, di, st);
  return (int)cudaErrorInvalidValue;
}
