// Grouped matmul (gmm) for sm_90a: bf16 on mma.sync tensor cores, f32 on
// IEEE FMA.
//
// Replaces the Pallas TPU kernel src/repro/kernels/gmm.py `_gmm_kernel`
// (called through `gmm` and the `ops.py` wrappers `gmm_padded` and
// `gmm_sorted`).  Same function:
//   lhs: [M, K], rows sorted by group; rhs: [G, K, N]; group_sizes: [G]
//   (int32, on the device).  Row r of group g (offsets[g] <= r <
//   offsets[g + 1]) gets out[r] = lhs[r] @ rhs[g], summed in f32 and
//   rounded once to lhs's dtype.  Rows past sum(group_sizes) are zero, as
//   `gmm_sorted` leaves them.  bf16 products are exact in f32, so the
//   tensor cores' bf16 x bf16 -> f32 is the reference's f32 product.
//
// Grouping without a host sync.  The TPU wrapper pads every group on the
// host to a multiple of 128 rows and hands the kernel a tile -> group
// table.  Here the group sizes stay on the device: the grid is sized to
// the upper bound ceil(M / BM) + G m-tiles, and each block scans
// group_sizes itself (a block-wide prefix sum of ceil(size / BM)) to find
// its own group and first row.  It masks the rows past its group's end,
// so lhs is never copied or padded; empty groups get no tile; blocks past
// the last group zero the rows past sum(group_sizes), and blocks past M
// exit.  For the MoE capacity layout (G groups of R rows each) the entry
// takes `equal_rows` = R and the tile's group is t / ceil(R / BM), with no
// scan.
//
// Design (bf16).  A block of 8 warps owns a 128 x 128 output tile and
// loops over K in steps of 32, staged in shared memory by cp.async in a
// 3-stage ring (zero-filled past the group's rows and past K and N).
// Each warp computes 64 x 32 with mma.sync.m16n8k16 (bf16 in, f32
// accumulate), its A fragments loaded by ldmatrix and its B fragments by
// ldmatrix.trans straight from the [K, N] rhs tile.  Rows of 16 bf16 plus
// 8 of padding keep every ldmatrix free of bank conflicts.  blockIdx.x
// walks the N tiles of one m-tile, so neighbouring blocks share one lhs
// tile (read from device memory once, then from L2) and a group's rhs
// (3 MB at qwen3-moe's widths) stays in L2 across its m-tiles.  cp.async
// needs 16-byte rows, so K and N that are not multiples of 8 take the
// same kernel with element-wise staging loads.  f32: 64 x 64 tiles, K in
// steps of 16, 4 x 4 outputs a thread, fmaf in K order, no TF32.
//
// What bounds it on an H100.  At the qwen3-moe forward's expert products
// (M = 128 x 641 rows, K x N = 2048 x 768): 2.58e11 FLOPs, 0.261 ms at
// 989 TFLOP/s, against 865 MB of lhs + rhs + out, 0.258 ms at 3.35 TB/s:
// both at once.  In a decode tick (9 rows a group) the 403 MB of one
// weight stack bound it (0.12 ms).  This first version uses mma.sync, not
// wgmma, so it cannot reach the tensor-core peak; a group of C + 1 = 641
// rows takes 6 m-tiles, the last with 1 row (17% of the tile work is
// padding); no TMA, no persistent scheduler.
//
// C interface (loaded with ctypes): each entry point launches on `stream`
// and returns cudaGetLastError() of the launch (0 when there is nothing
// to launch).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Tile {
  int group;    // -1: rows past the last group, written as zeros
  int row0;     // first row; >= M: nothing to do
  int row_end;  // one past the last row of the tile's group (<= M)
};

// The rows and group of m-tile `t`.  Every thread of the block gets the
// same answer.
template <int BM, int NT>
__device__ Tile find_tile(const int* __restrict__ sizes, int G, int M,
                          int equal_rows, int t) {
  Tile tile;
  if (equal_rows > 0) {
    const int tpg = (equal_rows + BM - 1) / BM;
    const int g = t / tpg;
    tile.group = g;
    tile.row0 = g < G ? g * equal_rows + (t - g * tpg) * BM : M;
    tile.row_end = min((g + 1) * equal_rows, M);
    return tile;
  }
  __shared__ int s_wt[NT / 32], s_wr[NT / 32];
  __shared__ Tile s_found;
  __shared__ int s_flag;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) s_flag = 0;
  __syncthreads();
  int base_tiles = 0, base_rows = 0;  // tiles and rows of earlier chunks
  for (int c0 = 0; c0 < G; c0 += NT) {
    const int g = c0 + tid;
    const int s = g < G ? max(sizes[g], 0) : 0;
    const int nt = (s + BM - 1) / BM;
    int it = nt, ir = s;  // inclusive scan within the warp
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int a = __shfl_up_sync(0xffffffffu, it, o);
      const int b = __shfl_up_sync(0xffffffffu, ir, o);
      if (lane >= o) {
        it += a;
        ir += b;
      }
    }
    if (lane == 31) {
      s_wt[warp] = it;
      s_wr[warp] = ir;
    }
    __syncthreads();
    int pt = 0, pr = 0, tot_t = 0, tot_r = 0;
#pragma unroll
    for (int w = 0; w < NT / 32; ++w) {
      if (w < warp) {
        pt += s_wt[w];
        pr += s_wr[w];
      }
      tot_t += s_wt[w];
      tot_r += s_wr[w];
    }
    const int start_t = base_tiles + pt + it - nt;
    const int start_r = base_rows + pr + ir - s;
    if (nt > 0 && t >= start_t && t < start_t + nt) {
      s_found.group = g;
      s_found.row0 = start_r + (t - start_t) * BM;
      s_found.row_end = start_r + s;
      s_flag = 1;
    }
    base_tiles += tot_t;
    base_rows += tot_r;
    __syncthreads();
    if (s_flag) break;
  }
  if (s_flag) {
    tile = s_found;
  } else {  // past the last group: the rows past sum(group_sizes)
    tile.group = -1;
    tile.row0 = base_rows + (t - base_tiles) * BM;
    tile.row_end = M;
  }
  tile.row_end = min(tile.row_end, M);
  if (tile.row0 < 0) tile.row0 = M;
  return tile;
}

template <typename T, int BM, int BN, int NT>
__device__ void zero_tile(T* __restrict__ out, const Tile& tile, int n0,
                          int N) {
  const int rows = min(tile.row_end - tile.row0, BM);
  for (int e = threadIdx.x; e < BM * BN; e += NT) {
    const int r = e / BN, c = e % BN;
    if (r < rows && n0 + c < N)
      out[(size_t)(tile.row0 + r) * N + n0 + c] = T(0.f);
  }
}

// ---------------------------------------------------------------------------
// bf16: mma.sync tensor-core path
// ---------------------------------------------------------------------------

constexpr int kBM = 128, kBN = 128, kBK = 32, kStages = 3, kThreads = 256;
constexpr int kLDA = kBK + 8;  // bf16 per smem row of the A tile
constexpr int kLDB = kBN + 8;  // bf16 per smem row of the B tile
constexpr int kAStage = kBM * kLDA, kBStage = kBK * kLDB;
constexpr int kSmemBytes = kStages * (kAStage + kBStage) * 2;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage the K slice [k0, k0 + kBK) of the A rows [0, rows) and of the B
// columns [n0, n0 + kBN) into one ring slot; everything outside is zero.
// VEC: 16-byte cp.async (K and N multiples of 8); else element-wise.
template <bool VEC>
__device__ __forceinline__ void load_stage(
    __nv_bfloat16* __restrict__ sA, __nv_bfloat16* __restrict__ sB,
    const __nv_bfloat16* __restrict__ A, const __nv_bfloat16* __restrict__ B,
    int rows, int k0, int K, int n0, int N) {
  const int tid = threadIdx.x;
  if (VEC) {
#pragma unroll
    for (int i = 0; i < kBM * kBK / 8 / kThreads; ++i) {
      const int c = tid + i * kThreads;
      const int r = c / (kBK / 8), kc = (c % (kBK / 8)) * 8;
      const bool ok = r < rows && k0 + kc < K;
      cp_async16(sA + r * kLDA + kc, ok ? A + (size_t)r * K + k0 + kc : A,
                 ok);
    }
#pragma unroll
    for (int i = 0; i < kBK * kBN / 8 / kThreads; ++i) {
      const int c = tid + i * kThreads;
      const int kr = c / (kBN / 8), nc = (c % (kBN / 8)) * 8;
      const bool ok = k0 + kr < K && n0 + nc < N;
      cp_async16(sB + kr * kLDB + nc,
                 ok ? B + (size_t)(k0 + kr) * N + n0 + nc : B, ok);
    }
  } else {
    const __nv_bfloat16 zero = __float2bfloat16(0.f);
    for (int e = tid; e < kBM * kBK; e += kThreads) {
      const int r = e / kBK, kk = e % kBK;
      sA[r * kLDA + kk] =
          r < rows && k0 + kk < K ? A[(size_t)r * K + k0 + kk] : zero;
    }
    for (int e = tid; e < kBK * kBN; e += kThreads) {
      const int kr = e / kBN, nn = e % kBN;
      sB[kr * kLDB + nn] = k0 + kr < K && n0 + nn < N
                               ? B[(size_t)(k0 + kr) * N + n0 + nn]
                               : zero;
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
gmm_bf16_kernel(const __nv_bfloat16* __restrict__ lhs,
                const __nv_bfloat16* __restrict__ rhs,
                __nv_bfloat16* __restrict__ out,
                const int* __restrict__ sizes, int M, int K, int N, int G,
                int equal_rows) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sB = sA + kStages * kAStage;

  const Tile tile =
      find_tile<kBM, kThreads>(sizes, G, M, equal_rows, blockIdx.y);
  if (tile.row0 >= M) return;
  const int n0 = blockIdx.x * kBN;
  if (tile.group < 0) {
    zero_tile<__nv_bfloat16, kBM, kBN, kThreads>(out, tile, n0, N);
    return;
  }
  const int rows = min(tile.row_end - tile.row0, kBM);
  const __nv_bfloat16* A = lhs + (size_t)tile.row0 * K;
  const __nv_bfloat16* B = rhs + (size_t)tile.group * K * N;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = (warp / 4) * 64;  // this warp's 64 rows
  const int wn = (warp % 4) * 32;  // and 32 columns of the tile

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.f;

  const int nk = (K + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk)
      load_stage<VEC>(sA + s * kAStage, sB + s * kBStage, A, B, rows, s * kBK,
                      K, n0, N);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    // the slot refilled now was read in step kt - 1, before the barrier
    const int pre = kt + kStages - 1;
    if (pre < nk)
      load_stage<VEC>(sA + (pre % kStages) * kAStage,
                      sB + (pre % kStages) * kBStage, A, B, rows, pre * kBK,
                      K, n0, N);
    cp_async_commit();

    const __nv_bfloat16* a_s = sA + (kt % kStages) * kAStage;
    const __nv_bfloat16* b_s = sB + (kt % kStages) * kBStage;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ldmatrix_x4(a[i], a_s + (wm + i * 16 + (lane & 15)) * kLDA + kk +
                              (lane >> 4) * 8);
#pragma unroll
      for (int j2 = 0; j2 < 2; ++j2) {
        const int m = lane >> 3;
        uint32_t r[4];
        ldmatrix_x4_trans(r, b_s + (kk + (m & 1) * 8 + (lane & 7)) * kLDB +
                                 wn + j2 * 16 + (m >> 1) * 8);
        b[2 * j2][0] = r[0];
        b[2 * j2][1] = r[1];
        b[2 * j2 + 1][0] = r[2];
        b[2 * j2 + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_16816(acc[i][j], a[i], b[j][0], b[j][1]);
    }
  }
  cp_async_wait<0>();

  // epilogue: one rounding to bf16; rows past the group and columns past
  // N are not written
  const int g = lane >> 2, t = lane & 3;
  __nv_bfloat16* O = out + (size_t)tile.row0 * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = wm + i * 16 + g + half * 8;
      if (r >= rows) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + wn + j * 8 + 2 * t;
        const float v0 = acc[i][j][2 * half], v1 = acc[i][j][2 * half + 1];
        __nv_bfloat16* o = O + (size_t)r * N + n;
        if (VEC) {
          if (n < N)
            *reinterpret_cast<__nv_bfloat162*>(o) =
                __floats2bfloat162_rn(v0, v1);
        } else {
          if (n < N) o[0] = __float2bfloat16(v0);
          if (n + 1 < N) o[1] = __float2bfloat16(v1);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// f32: IEEE FMA path (no tensor cores, no TF32)
// ---------------------------------------------------------------------------

constexpr int fBM = 64, fBN = 64, fBK = 16, fThreads = 256;

__global__ void __launch_bounds__(fThreads)
gmm_f32_kernel(const float* __restrict__ lhs, const float* __restrict__ rhs,
               float* __restrict__ out, const int* __restrict__ sizes, int M,
               int K, int N, int G, int equal_rows) {
  __shared__ float As[fBK][fBM + 4];  // A tile transposed: [k][row]
  __shared__ float Bs[fBK][fBN];

  const Tile tile =
      find_tile<fBM, fThreads>(sizes, G, M, equal_rows, blockIdx.y);
  if (tile.row0 >= M) return;
  const int n0 = blockIdx.x * fBN;
  if (tile.group < 0) {
    zero_tile<float, fBM, fBN, fThreads>(out, tile, n0, N);
    return;
  }
  const int rows = min(tile.row_end - tile.row0, fBM);
  const float* A = lhs + (size_t)tile.row0 * K;
  const float* B = rhs + (size_t)tile.group * K * N;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += fBK) {
#pragma unroll
    for (int i = 0; i < fBM * fBK / fThreads; ++i) {
      const int e = tid + i * fThreads;
      const int r = e / fBK, kk = e % fBK;
      As[kk][r] = r < rows && k0 + kk < K ? A[(size_t)r * K + k0 + kk] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < fBK * fBN / fThreads; ++i) {
      const int e = tid + i * fThreads;
      const int kr = e / fBN, nn = e % fBN;
      Bs[kr][nn] = k0 + kr < K && n0 + nn < N
                       ? B[(size_t)(k0 + kr) * N + n0 + nn]
                       : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < fBK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N) out[(size_t)(tile.row0 + r) * N + n] = acc[i][j];
    }
  }
}

// m-tiles the grid needs: exact for equal groups, else the upper bound
int m_tiles(int M, int G, int equal_rows, int BM) {
  if (equal_rows > 0) return G * ((equal_rows + BM - 1) / BM);
  return (M + BM - 1) / BM + G;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// lhs: [M, K] bf16; rhs: [G, K, N] bf16; out: [M, N] bf16; all contiguous.
// group_sizes: [G] int32 on the device, or ignored when equal_rows > 0
// (then M = G * equal_rows).  Returns the CUDA error of the launch.
extern "C" int gmm_bf16(const void* lhs, const void* rhs, void* out,
                        const int* group_sizes, int M, int K, int N, int G,
                        int equal_rows, void* stream) {
  if (M <= 0 || N <= 0 || G <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + kBN - 1) / kBN, m_tiles(M, G, equal_rows, kBM));
  const auto* l = static_cast<const __nv_bfloat16*>(lhs);
  const auto* r = static_cast<const __nv_bfloat16*>(rhs);
  auto* o = static_cast<__nv_bfloat16*>(out);
  const bool vec = K % 8 == 0 && N % 8 == 0 && aligned16(lhs) &&
                   aligned16(rhs) && aligned16(out);
  if (vec) {
    static const cudaError_t attr = cudaFuncSetAttribute(
        gmm_bf16_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBytes);
    if (attr != cudaSuccess) return (int)attr;
    gmm_bf16_kernel<true><<<grid, kThreads, kSmemBytes, st>>>(
        l, r, o, group_sizes, M, K, N, G, equal_rows);
  } else {
    static const cudaError_t attr = cudaFuncSetAttribute(
        gmm_bf16_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBytes);
    if (attr != cudaSuccess) return (int)attr;
    gmm_bf16_kernel<false><<<grid, kThreads, kSmemBytes, st>>>(
        l, r, o, group_sizes, M, K, N, G, equal_rows);
  }
  return (int)cudaGetLastError();
}

// The same for float32 (IEEE FMA, no TF32).
extern "C" int gmm_f32(const void* lhs, const void* rhs, void* out,
                       const int* group_sizes, int M, int K, int N, int G,
                       int equal_rows, void* stream) {
  if (M <= 0 || N <= 0 || G <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + fBN - 1) / fBN, m_tiles(M, G, equal_rows, fBM));
  gmm_f32_kernel<<<grid, fThreads, 0, st>>>(
      static_cast<const float*>(lhs), static_cast<const float*>(rhs),
      static_cast<float*>(out), group_sizes, M, K, N, G, equal_rows);
  return (int)cudaGetLastError();
}
