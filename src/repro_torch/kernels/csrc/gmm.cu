// Grouped matmul (gmm) for sm_90a.  bf16 with aligned rows: a persistent,
// warp-specialised wgmma kernel fed by TMA.  bf16 otherwise: mma.sync
// tensor cores.  f32: IEEE FMA.
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
// table.  Here the group sizes stay on the device and a kernel scans
// them itself (a block-wide prefix sum of the groups' m-tiles), so lhs is
// never copied or padded and empty groups get no tile.  For the MoE
// capacity layout (G groups of R rows each) the entry takes `equal_rows` =
// R and maps tiles to groups arithmetically, with no scan.
//
// Routes (chosen in kernels/gmm.py `route` from dtype and shape alone):
//   wgmma     bf16, K and N multiples of 8 (TMA wants 16-byte strides and
//             bases), K > 0, G <= kMaxGroups;
//   mma.sync  every other bf16 shape (K = 100, N = 90: element-wise
//             staging); f32 takes its FMA kernel.
//
// wgmma design.  One block of 384 threads a SM, persistent: it scans
// group_sizes once into shared memory (in chunks of 384 groups), then
// walks the tiles t = blockIdx.x, t + gridDim.x, ... up to the tile count
// that only the device knows.  Tiles are 128 x 256, ordered n fastest
// within an m-tile, then the m-tiles of a group in order, so the blocks in
// flight share a group's rhs (3 MB at qwen3-moe's widths) in the 50 MB L2.
//   - Producer warpgroup (setmaxnreg.dec to 40): one thread keeps TMA
//     loads in flight through a ring of 3 stages of K = 64 (48 KB each),
//     with a full and an empty mbarrier a stage.  Its other three warps
//     zero the rows past sum(group_sizes).
//   - Two consumer warpgroups (setmaxnreg.inc to 232): warpgroup c runs
//     wgmma.mma_async m64n256k16 (bf16 -> f32) on rows [64 c, 64 c + 64)
//     of the tile, one commit group in flight, and frees a stage when its
//     products are done.  Branch values come through __shfl_sync, so
//     ptxas knows them warp-uniform and does not serialise the wgmmas.
//   - TMA maps (encoded on the host with cuTensorMapEncodeTiled, reached
//     through cudaGetDriverEntryPoint, passed as __grid_constant__): lhs
//     2D over [M, K], 64 x 64 boxes; rhs 3D over (N, K, G), so a K edge
//     inside group g reads zeros, not group g + 1; out 2D over [M, N].
//     128-byte swizzle.  rhs stays [K, N] row-major: wgmma reads it
//     N-major through its transpose-B immediate (descriptor: 64-column
//     boxes 8 KB apart, 8 K rows 1 KB apart).  Out-of-bounds rows and
//     columns read as zero; rows of the next group that fall into a tile
//     are loaded, never stored; B boxes wholly past N are not loaded.
//   - Padding: a group's rows are cut into 128-row tiles; when its last
//     tile holds <= 64 rows it is a half tile: TMA loads 64 rows of lhs
//     and warpgroup 1 issues no wgmma.  At 641 rows a group: 5 full tiles
//     and a half, 704 rows of tensor-core work for 641 (9% padding, not
//     the 17% of six 128-row tiles).
//   - Epilogue: f32 -> bf16 once, into a swizzled 64 x 256 staging buffer
//     per warpgroup; when all 64 rows are the group's, one thread TMA-
//     stores it and the warpgroup goes on to the next tile (the producer
//     is already loading its stages); where the group ends inside them,
//     the threads copy the group's rows, 16 bytes each.  The staging
//     takes the room of a fourth ring stage (225 of 227 KB are used).
//   - N = 768 makes 3 n-tiles, N = 2048 8; at these shapes 256 columns
//     ran faster than 128 at every qwen3-moe shape (forward, prefill and
//     decode), so there is one tile width.
//
// What bounds it on an H100.  At the qwen3-moe forward's expert products
// (M = 128 x 641 rows, K x N = 2048 x 768): 2.58e11 FLOPs, 0.261 ms at
// 989 TFLOP/s, against 865 MB of lhs + rhs + out, 0.258 ms at 3.35 TB/s:
// both at once.  With its loads disabled the kernel runs that shape in
// ~0.355 ms (~800 TFLOP/s of tensor-core work, padding included); the
// loads through a 3-stage ring add ~0.07 ms.  In a decode tick (9 rows a
// group) the 403 MB of one weight stack bound it (0.12 ms), and each
// tile is a half tile.
//
// mma.sync design.  A block of 8 warps owns a 128 x 128 output tile (grid:
// n-tiles x the bound ceil(M / 128) + G m-tiles; each block finds its own
// tile by the scan; blocks past the last group zero the rows past it) and
// loops over K in steps of 32, staged by cp.async in a 3-stage ring (zero-
// filled past the group's rows and past K and N).  Each warp computes 64 x
// 32 with mma.sync.m16n8k16, its A fragments by ldmatrix and B by
// ldmatrix.trans from the [K, N] rhs tile.  K or N not a multiple of 8
// stage element-wise.  f32: 64 x 64 tiles, K in steps of 16, 4 x 4 outputs
// a thread, fmaf in K order, no TF32.
//
// C interface (loaded with ctypes): each entry point launches on `stream`
// and returns cudaGetLastError() of the launch (0 when there is nothing
// to launch); gmm_bf16_wgmma returns -CUresult when a tensor map cannot be
// encoded.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

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

// ---------------------------------------------------------------------------
// bf16 on Hopper: persistent, warp-specialised wgmma fed by TMA
// ---------------------------------------------------------------------------

constexpr int wBM = 128;          // rows of a full m-tile (two 64-row halves)
constexpr int wBN = 256;          // columns of a tile
constexpr int wBK = 64;           // K per stage: 64 bf16 = one 128-byte row
constexpr int wBox = 64 * 64 * 2; // one TMA box, 64 x 64 bf16: 8 KB
constexpr int wThreads = 384;     // producer warpgroup + 2 consumer warpgroups
constexpr int wScanWarps = wThreads / 32;
constexpr int kMaxGroups = 2048;  // groups the block's scan holds in smem
constexpr int wStages = 3;
constexpr int wStageBytes = (2 + wBN / 64) * wBox;  // A 128 x 64, B 64 x 256
constexpr int wEpiBytes = 2 * (wBN / 64) * wBox;    // 64 x 256 a warpgroup
// ring, epilogue staging, 1 KB to align them, full + empty barriers, tile
// and row prefixes: 225 KB of the 227 a block may have
constexpr int wSmemBytes = wStages * wStageBytes + wEpiBytes + 1024 +
                           2 * wStages * 8 + 2 * (kMaxGroups + 1) * 4;

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

__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
      " [%0, {%2, %3}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1)
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

__device__ __forceinline__ uint4 ld_shared_v4(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
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

// Keeps the compiler from moving reads or writes of the accumulators
// across the asynchronous wgmma that owns them.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D[64 x N] (+)= A[64 x 16] B[16 x N]: A K-major, B N-major (transpose-B
// immediate 1), both from shared memory through descriptors; f32 sums.
// scale_d == 0 overwrites D.
__device__ __forceinline__ void wgmma_m64n256(float (&d)[128], uint64_t a,
                                            uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
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
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(scale_d));
}

// Inclusive block-wide sum over the wThreads threads; `total` gets the sum
// over all of them.  Every thread must call it.
template <typename T>
__device__ T block_scan(T v, T* s_warp, T& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  if (lane == 31) s_warp[warp] = v;
  __syncthreads();
  T before = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < wScanWarps; ++w) {
    if (w < warp) before += s_warp[w];
    total += s_warp[w];
  }
  __syncthreads();
  return v + before;
}

struct MTile {
  int group;  // rhs group of the tile's rows
  int row0;   // first row
  int rows;   // rows of the group in the tile, 1..wBM; <= 64: a half tile
};

// v from lane 0: the same in every lane, and known to be so by the
// compiler, which otherwise serialises wgmma under branches on it
__device__ __forceinline__ int warp_uniform(int v) {
  return __shfl_sync(0xffffffffu, v, 0);
}

// The m-tiles of the launch: each group's rows cut into tiles of wBM rows
// from its first row on, in group order.  Every thread finds the same tile.
struct Schedule {
  const int* tile_start;  // [G + 1] m-tiles before group g (scan mode)
  const int* row_start;   // [G + 1] first row of group g, clipped to M
  int G, equal_rows, per_group;

  __device__ MTile at(int mt) const {
    MTile t;
    if (equal_rows > 0) {
      t.group = mt / per_group;
      const int local = (mt - t.group * per_group) * wBM;
      t.row0 = t.group * equal_rows + local;
      t.rows = min(equal_rows - local, wBM);
      return t;
    }
    int lo = 0, hi = G;  // the first group whose tiles end past mt
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (tile_start[mid + 1] <= mt)
        lo = mid + 1;
      else
        hi = mid;
    }
    t.group = lo;
    t.row0 = row_start[lo] + (mt - tile_start[lo]) * wBM;
    t.rows = min(row_start[lo + 1] - t.row0, wBM);
    return t;
  }
};

__global__ void __launch_bounds__(wThreads, 1)
gmm_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_b,
                 const __grid_constant__ CUtensorMap map_out,
                 __nv_bfloat16* __restrict__ out,
                 const int* __restrict__ sizes, int M, int K, int N, int G,
                 int equal_rows) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ long long s_warp_rows[wScanWarps];
  __shared__ int s_warp_tiles[wScanWarps];
  // the ring starts on a 1 KB boundary, as the 128-byte swizzle wants
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t pad = (1024u - (raw & 1023u)) & 1023u;
  const uint32_t ring = raw + pad;
  const uint32_t epi0 = ring + wStages * wStageBytes;  // 64 x 256 a warpgroup
  unsigned char* tail = smem_raw + pad + wStages * wStageBytes + wEpiBytes;
  const uint32_t full0 = epi0 + wEpiBytes;              // full[s]: +8 s
  const uint32_t empty0 = full0 + wStages * 8;          // empty[s]: +8 s
  int* tile_start = reinterpret_cast<int*>(tail + 2 * wStages * 8);
  int* row_start = tile_start + kMaxGroups + 1;
  const int tid = threadIdx.x;

  // 1. the groups' tiles, once per block: a prefix sum over group_sizes
  // in chunks of wThreads groups, each size clipped so no row passes M
  Schedule sched{tile_start, row_start, G, equal_rows,
                 (equal_rows + wBM - 1) / wBM};
  int mtiles, grouped_rows;
  if (equal_rows > 0) {
    mtiles = G * sched.per_group;
    grouped_rows = M;
  } else {
    if (tid == 0) tile_start[0] = row_start[0] = 0;
    long long rows_before = 0;
    int tiles_before = 0;
    for (int c0 = 0; c0 < G; c0 += wThreads) {
      const int g = c0 + tid;
      const long long s = g < G ? (long long)max(sizes[g], 0) : 0;
      long long rows_total;
      const long long end =
          rows_before + block_scan(s, s_warp_rows, rows_total);
      const int r1 = (int)min(end, (long long)M);
      const int r0 = (int)min(end - s, (long long)M);
      const int nt = (r1 - r0 + wBM - 1) / wBM;
      int tiles_total;
      const int t1 = tiles_before + block_scan(nt, s_warp_tiles, tiles_total);
      if (g < G) {
        row_start[g + 1] = r1;
        tile_start[g + 1] = t1;
      }
      rows_before += rows_total;
      tiles_before += tiles_total;
    }
    mtiles = tiles_before;
    grouped_rows = (int)min(rows_before, (long long)M);
  }
  if (tid == 0) {
    for (int s = 0; s < wStages; ++s) {
      mbar_init(full0 + 8 * s, 1);   // the producer's expect_tx
      mbar_init(empty0 + 8 * s, 8);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int n_tiles = (N + wBN - 1) / wBN;
  const int nk = (K + wBK - 1) / wBK;
  // n fastest, then m-tiles in order
  const int total = warp_uniform(mtiles * n_tiles);
  const int wg = warp_uniform(tid / 128), warp = (tid % 128) / 32;
  const int lane = tid % 32;

  if (wg == 0) {
    // 2. producer warpgroup: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == 0) {
      if (lane != 0) return;
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&map_a))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&map_b))
                   : "memory");
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < total; t += gridDim.x) {
        const int mt = t / n_tiles, n0 = (t - mt * n_tiles) * wBN;
        const MTile tl = sched.at(mt);
        const bool half = tl.rows <= 64;
        // B boxes wholly past N are not loaded: their columns are never
        // stored, and columns do not mix in a product
        const int nb = min(wBN / 64, (N - n0 + 63) / 64);
        const uint32_t bytes = ((half ? 1 : 2) + nb) * wBox;
        for (int kb = 0; kb < nk; ++kb) {
          const uint32_t full = full0 + 8 * stage;
          mbar_wait(empty0 + 8 * stage, phase ^ 1);
          mbar_expect_tx(full, bytes);
          const uint32_t a = ring + stage * wStageBytes, b = a + 2 * wBox;
          tma_load_2d(a, &map_a, full, kb * wBK, tl.row0);
          if (!half)
            tma_load_2d(a + wBox, &map_a, full, kb * wBK, tl.row0 + 64);
          for (int j = 0; j < nb; ++j)
            tma_load_3d(b + j * wBox, &map_b, full, n0 + 64 * j, kb * wBK,
                        tl.group);
          if (++stage == wStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    } else if (equal_rows == 0) {
      // warps 1-3 zero the rows past sum(group_sizes), 16 bytes a store
      const long long chunks = (long long)(M - grouped_rows) * (N / 8);
      uint4* z = reinterpret_cast<uint4*>(out + (size_t)grouped_rows * N);
      for (long long i = (long long)blockIdx.x * 96 + tid - 32; i < chunks;
           i += (long long)gridDim.x * 96)
        z[i] = make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }

  // 3. consumer warpgroups: warpgroup c computes rows [64 c, 64 c + 64) of
  // each tile; on a half tile, warpgroup 1 only keeps the ring moving
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int c = wg - 1, wtid = tid % 128;
  const uint32_t epi = epi0 + c * (wBN / 64) * wBox;
  float acc[wBN / 2];
  int stage = 0;
  uint32_t phase = 0;
  for (int t = blockIdx.x; t < total; t += gridDim.x) {
    const int mt = t / n_tiles, n0 = (t - mt * n_tiles) * wBN;
    const MTile tl = sched.at(mt);
    const int row0 = warp_uniform(tl.row0) + 64 * c;
    const int rows = min(warp_uniform(tl.rows) - 64 * c, 64);  // <= 0: idle
    if (rows <= 0) {  // warpgroup 1 on a half tile: free each stage
      for (int kb = 0; kb < nk; ++kb) {
        mbar_wait(full0 + 8 * stage, phase);
        if (lane == 0) mbar_arrive(empty0 + 8 * stage);
        if (++stage == wStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      continue;
    }
    int prev = -1;
    for (int kb = 0; kb < nk; ++kb) {
      mbar_wait(full0 + 8 * stage, phase);
      const uint32_t a = ring + stage * wStageBytes + c * wBox;
      const uint32_t b = ring + stage * wStageBytes + 2 * wBox;
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < wBK / 16; ++kk)
        // A: +32 bytes a K step inside the swizzled 128-byte rows, rows 8
        // apart by 1 KB; B: +2 KB a K step (16 rows of 128 bytes), 8 K
        // rows apart by 1 KB, 64-column boxes apart by 8 KB
        wgmma_m64n256(acc, smem_desc(a + 32 * kk, 16, 1024),
                      smem_desc(b + 2048 * kk, wBox, 1024), (kb | kk) != 0);
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done
      fence_acc(acc);
      if (prev >= 0 && lane == 0) mbar_arrive(empty0 + 8 * prev);
      prev = stage;
      if (++stage == wStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (lane == 0) mbar_arrive(empty0 + 8 * prev);
    // epilogue: f32 -> bf16 once, into this warpgroup's staging buffer (64
    // rows of 256, 64-column boxes with the 128-byte swizzle, as TMA
    // stores them); the next tile's stages are loading meanwhile
    if (wtid == 0) bulk_wait<true>();  // the last TMA store has read it
    named_bar_sync(1 + c, 128);
#pragma unroll
    for (int i = 0; i < wBN / 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * warp + lane / 4 + 8 * h;
        st_shared_b32(epi + (i / 8) * wBox + r * 128 +
                          (((i % 8) ^ (r % 8)) << 4) + (lane % 4) * 4,
                      pack_bf16x2(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]));
      }
    fence_proxy_async();
    named_bar_sync(1 + c, 128);
    const int nb = min(wBN / 64, (N - n0 + 63) / 64);
    if (rows == 64) {
      // all 64 rows are the group's: TMA stores them (clipped at N) and
      // the warpgroup goes on to the next tile
      if (wtid == 0) {
        for (int j = 0; j < nb; ++j)
          tma_store_2d(&map_out, epi + j * wBox, n0 + 64 * j, row0);
        bulk_commit();
      }
    } else {
      // the group ends inside these rows (the rows after it are the next
      // group's): copy its rows, 16 bytes a thread, a warp a row
      for (int e = wtid; e < rows * (wBN / 8); e += 128) {
        const int r = e / (wBN / 8), i = e % (wBN / 8);
        if (n0 + 8 * i < N)
          *reinterpret_cast<uint4*>(out + (size_t)(row0 + r) * N + n0 +
                                    8 * i) =
              ld_shared_v4(epi + (i / 8) * wBox + r * 128 +
                           (((i % 8) ^ (r % 8)) << 4));
      }
    }
  }
  if (wtid == 0) bulk_wait<false>();
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime, so
// the library links no -lcuda
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

// A bf16 tensor map with 64 x 64 boxes (64 contiguous elements: 128 bytes,
// the 128-byte swizzle); elements out of bounds read as zero.
CUresult encode_map(CUtensorMap* map, const void* base, int rank,
                    const cuuint64_t* dims, const cuuint64_t* strides) {
  const cuuint32_t box[3] = {64, 64, 1}, elem[3] = {1, 1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
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

int launch_wgmma(const CUtensorMap& ma, const CUtensorMap& mb,
                 const CUtensorMap& mo, __nv_bfloat16* out, const int* sizes,
                 int M, int K, int N, int G, int equal_rows,
                 cudaStream_t st) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      gmm_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      wSmemBytes);
  if (attr != cudaSuccess) return (int)attr;
  // one block a SM, or one a tile when there are fewer
  const long long tiles =
      (long long)m_tiles(M, G, equal_rows, wBM) * ((N + wBN - 1) / wBN);
  const int grid = (int)std::min<long long>(sm_count(), tiles);
  gmm_wgmma_kernel<<<grid, wThreads, wSmemBytes, st>>>(
      ma, mb, mo, out, sizes, M, K, N, G, equal_rows);
  return (int)cudaGetLastError();
}

}  // namespace

// lhs: [M, K] bf16; rhs: [G, K, N] bf16; out: [M, N] bf16; all contiguous.
// group_sizes: [G] int32 on the device, or ignored when equal_rows > 0
// (then M = G * equal_rows).  The mma.sync route.  Returns the CUDA error
// of the launch.
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

// The same function on the wgmma route: K > 0 and N multiples of 8, all
// three bases 16-byte aligned, G <= kMaxGroups.
// Anything else is refused with cudaErrorInvalidValue, not run otherwise.
extern "C" int gmm_bf16_wgmma(const void* lhs, const void* rhs, void* out,
                              const int* group_sizes, int M, int K, int N,
                              int G, int equal_rows, void* stream) {
  if (M <= 0 || N <= 0 || G <= 0) return 0;
  if (K <= 0 || K % 8 != 0 || N % 8 != 0 || G > kMaxGroups ||
      !aligned16(lhs) || !aligned16(rhs) || !aligned16(out) ||
      (equal_rows <= 0 && group_sizes == nullptr))
    return (int)cudaErrorInvalidValue;
  if (encode_tiled() == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap ma, mb, mo;
  const cuuint64_t a_dims[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t a_strides[1] = {(cuuint64_t)K * 2};
  const cuuint64_t b_dims[3] = {(cuuint64_t)N, (cuuint64_t)K, (cuuint64_t)G};
  const cuuint64_t b_strides[2] = {(cuuint64_t)N * 2,
                                   (cuuint64_t)K * N * 2};
  CUresult res = encode_map(&ma, lhs, 2, a_dims, a_strides);
  if (res == CUDA_SUCCESS) res = encode_map(&mb, rhs, 3, b_dims, b_strides);
  const cuuint64_t o_dims[2] = {(cuuint64_t)N, (cuuint64_t)M};
  const cuuint64_t o_strides[1] = {(cuuint64_t)N * 2};
  if (res == CUDA_SUCCESS) res = encode_map(&mo, out, 2, o_dims, o_strides);
  if (res != CUDA_SUCCESS) return -(int)res;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* o = static_cast<__nv_bfloat16*>(out);
  return launch_wgmma(ma, mb, mo, o, group_sizes, M, K, N, G, equal_rows,
                      st);
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
