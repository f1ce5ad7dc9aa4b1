// MoE dispatch and combine for sm_90a: rows moved between token order and
// the capacity buffer [E, C+1, d], each row once and with no atomics.
//
// Replaces no Pallas kernel.  The reference's dispatch is `xe.at[...].add`
// of every assignment's row into a zeroed buffer, and its combine a
// gather, a weight and a sum over k (src/repro/models/moe.py), both left
// to XLA; the port's "xla" path keeps them as `repeat_interleave` +
// `index_add_` and gather -> multiply -> sum.  Assignment a = t * k + j of
// token t goes to expert ids[a] at slot pos[a]; pos[a] == C marks one
// that its expert's capacity dropped (the parking slot, weighted 0).
//
// moe_dispatch: xe[e, c] = x[t] for the kept assignment of token t at
// (e, c), and zeros in every other row, the parking slot c = C included.
// Two launches: `slot_tokens` writes a slot -> token map over the T * k
// assignments (int32, -1 where no kept assignment lands: slots past an
// expert's kept count and the parking slot), then `dispatch_rows` sweeps
// the buffer row-major, copying a kept row from x or storing zeros.  Kept
// slots are distinct, so the map needs no atomics; each buffer row is
// written once, and no T * k copy of the tokens is made.  A pure copy: the
// kernel moves bytes whatever the dtype.
//
// moe_combine: out[t] = sum over j of round(w * ye[ids[a], pos[a]]), w =
// round(gate_w[a]) for a kept assignment, the products rounded to the
// buffer's dtype and summed in f32 in the order j = 0 .. k-1, rounded
// once: the arithmetic of `_combine`'s gather, weight and sum.  A dropped
// assignment's row is never read and adds nothing (the plain path adds an
// exact 0 for it).  Token-major: a thread owns one vector of out[t] and
// reads only that vector of t's kept rows, 8 of them in flight at once.
//
// What bounds them on an H100: bytes.  At qwen3-moe-30b-a3b's scoring
// step (T 8192, k 8, E 128, C 640, d 2048, bf16; 25,229 kept of 65,536
// assignments a layer) the dispatch writes the 336.1 MB buffer and reads
// the 103.3 MB of kept rows, 0.131 ms at 3.35 TB/s; the combine reads the
// kept rows and writes 33.6 MB, 0.041 ms.  The map (328 KB) and the T * k
// indices (1 MB) are noise.  So every load and store is the widest vector
// that divides the row and both base addresses: 16 bytes a thread at any
// d * element size that is a multiple of 16.  A row whose bytes are not
// starts at another offset modulo 16 in x and in the buffer, so no 16-byte
// vector fits both; such rows move in 8, 4 or 2 bytes, down to the
// element.  Zero rows are stores alone.  Each dispatch thread keeps 4
// vectors in flight.
//
// C interface (loaded with ctypes): each entry launches on `stream`,
// allocates nothing, and returns cudaGetLastError() after its launches
// (cudaErrorInvalidValue for a row or base that no vector width divides).
// Counts of elements and vectors must fit int32 (the wrapper checks).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;   // dispatch vectors a thread
constexpr int kGather = 8;   // combine rows in flight a thread

template <int VB> struct VecOf;
template <> struct VecOf<16> { using T = uint4; };
template <> struct VecOf<8> { using T = uint2; };
template <> struct VecOf<4> { using T = unsigned int; };
template <> struct VecOf<2> { using T = unsigned short; };

// The widest of 16, 8, 4 and 2 bytes that divides the row and both bases;
// 0 when none does.
int vec_bytes(long long row_bytes, const void* a, const void* b) {
  for (int vb = 16; vb >= 2; vb /= 2) {
    if (row_bytes % vb == 0 && reinterpret_cast<uintptr_t>(a) % vb == 0 &&
        reinterpret_cast<uintptr_t>(b) % vb == 0)
      return vb;
  }
  return 0;
}

__global__ void __launch_bounds__(kThreads)
slot_tokens(const int64_t* __restrict__ ids, const int64_t* __restrict__ pos,
            int* __restrict__ slot_token, int n, int k, int C) {
  const int a = blockIdx.x * kThreads + threadIdx.x;
  if (a >= n) return;
  const int64_t p = pos[a];
  if (p < C) slot_token[ids[a] * (C + 1) + p] = a / k;
}

template <typename V>
__global__ void __launch_bounds__(kThreads)
dispatch_rows(const V* __restrict__ x, const int* __restrict__ slot_token,
              V* __restrict__ out, unsigned row_vecs, unsigned total) {
  const unsigned base = blockIdx.x * (kThreads * kUnroll) + threadIdx.x;
  V v[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const unsigned i = base + u * kThreads;
    v[u] = V{};
    if (i < total) {
      const unsigned r = i / row_vecs;
      const int t = slot_token[r];
      if (t >= 0) v[u] = x[static_cast<size_t>(t) * row_vecs + (i - r * row_vecs)];
    }
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const unsigned i = base + u * kThreads;
    if (i < total) out[i] = v[u];
  }
}

// Element types by their bits: float, bf16 and f16 (stored as ushort).
enum Dtype { kF32 = 0, kBF16 = 1, kF16 = 2 };

template <int D> struct Elem;
template <> struct Elem<kF32> {
  using S = float;
  __device__ static float to_f(S v) { return v; }
  __device__ static S from_f(float f) { return f; }
};
template <> struct Elem<kBF16> {
  using S = unsigned short;
  __device__ static float to_f(S v) { return __uint_as_float(static_cast<unsigned>(v) << 16); }
  __device__ static S from_f(float f) { return __bfloat16_as_ushort(__float2bfloat16_rn(f)); }
};
template <> struct Elem<kF16> {
  using S = unsigned short;
  __device__ static float to_f(S v) { return __half2float(__ushort_as_half(v)); }
  __device__ static S from_f(float f) { return __half_as_ushort(__float2half_rn(f)); }
};

template <int D, int VB>
__global__ void __launch_bounds__(kThreads)
combine_rows(const typename VecOf<VB>::T* __restrict__ ye,
             const int64_t* __restrict__ ids, const int64_t* __restrict__ pos,
             const float* __restrict__ gate,
             typename VecOf<VB>::T* __restrict__ out, unsigned row_vecs,
             unsigned total, int k, int C) {
  using E = Elem<D>;
  using V = typename VecOf<VB>::T;
  constexpr int N = VB / sizeof(typename E::S);
  union Lanes {
    V v;
    typename E::S e[N];
  };
  const unsigned i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  const unsigned t = i / row_vecs, c = i - t * row_vecs;
  float acc[N];
#pragma unroll
  for (int n = 0; n < N; ++n) acc[n] = 0.f;
  for (int j0 = 0; j0 < k; j0 += kGather) {
    Lanes y[kGather];
    float w[kGather];
    bool kept[kGather];
#pragma unroll
    for (int g = 0; g < kGather; ++g) {
      const size_t a = static_cast<size_t>(t) * k + j0 + g;
      const int64_t p = j0 + g < k ? pos[a] : C;
      kept[g] = p < C;
      if (kept[g]) {
        w[g] = E::to_f(E::from_f(gate[a]));
        y[g].v = ye[(static_cast<size_t>(ids[a]) * (C + 1) + p) * row_vecs + c];
      }
    }
#pragma unroll
    for (int g = 0; g < kGather; ++g) {
      if (!kept[g]) continue;
#pragma unroll
      for (int n = 0; n < N; ++n)
        acc[n] += E::to_f(E::from_f(__fmul_rn(w[g], E::to_f(y[g].e[n]))));
    }
  }
  Lanes o;
#pragma unroll
  for (int n = 0; n < N; ++n) o.e[n] = E::from_f(acc[n]);
  out[i] = o.v;
}

template <int VB>
void launch_dispatch(const void* x, const int* slot_token, void* out,
                     unsigned row_vecs, unsigned total, cudaStream_t stream) {
  using V = typename VecOf<VB>::T;
  const unsigned per_block = kThreads * kUnroll;
  dispatch_rows<V><<<(total + per_block - 1) / per_block, kThreads, 0,
                     stream>>>(static_cast<const V*>(x), slot_token,
                               static_cast<V*>(out), row_vecs, total);
}

template <int D, int VB>
void launch_combine(const void* ye, const int64_t* ids, const int64_t* pos,
                    const float* gate, void* out, unsigned row_vecs,
                    unsigned total, int k, int C, cudaStream_t stream) {
  using V = typename VecOf<VB>::T;
  combine_rows<D, VB><<<(total + kThreads - 1) / kThreads, kThreads, 0,
                        stream>>>(static_cast<const V*>(ye), ids, pos, gate,
                                  static_cast<V*>(out), row_vecs, total, k, C);
}

template <int D>
int combine_by_width(int vb, const void* ye, const int64_t* ids,
                     const int64_t* pos, const float* gate, void* out,
                     unsigned row_vecs, unsigned total, int k, int C,
                     cudaStream_t stream) {
  switch (vb) {
    case 16: launch_combine<D, 16>(ye, ids, pos, gate, out, row_vecs, total, k, C, stream); return 0;
    case 8: launch_combine<D, 8>(ye, ids, pos, gate, out, row_vecs, total, k, C, stream); return 0;
    case 4: launch_combine<D, 4>(ye, ids, pos, gate, out, row_vecs, total, k, C, stream); return 0;
    case 2:
      if constexpr (sizeof(typename Elem<D>::S) == 2) {
        launch_combine<D, 2>(ye, ids, pos, gate, out, row_vecs, total, k, C, stream);
        return 0;
      }
  }
  return cudaErrorInvalidValue;
}

int elem_bytes(int dtype) { return dtype == kF32 ? 4 : 2; }

}  // namespace

extern "C" {

// x: [T, d]; ids, pos: [T * k] int64; slot_token: [E * (C + 1)] int32
// scratch; out: [E, C + 1, d], x's dtype.
int moe_dispatch(const void* x, const int64_t* ids, const int64_t* pos,
                 int* slot_token, void* out, int T, int k, int E, int C,
                 int d, int dtype, cudaStream_t stream) {
  const int rows = E * (C + 1);
  const long long row_bytes = static_cast<long long>(d) * elem_bytes(dtype);
  const int vb = vec_bytes(row_bytes, x, out);
  if (vb == 0) return cudaErrorInvalidValue;
  const unsigned row_vecs = static_cast<unsigned>(row_bytes / vb);
  const unsigned total = static_cast<unsigned>(rows) * row_vecs;
  cudaError_t err = cudaMemsetAsync(slot_token, 0xff, sizeof(int) * rows, stream);
  if (err != cudaSuccess) return err;
  const int n = T * k;
  if (n > 0)
    slot_tokens<<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
        ids, pos, slot_token, n, k, C);
  if (total > 0) {
    switch (vb) {
      case 16: launch_dispatch<16>(x, slot_token, out, row_vecs, total, stream); break;
      case 8: launch_dispatch<8>(x, slot_token, out, row_vecs, total, stream); break;
      case 4: launch_dispatch<4>(x, slot_token, out, row_vecs, total, stream); break;
      default: launch_dispatch<2>(x, slot_token, out, row_vecs, total, stream); break;
    }
  }
  return cudaGetLastError();
}

// ye: [E, C + 1, d]; ids, pos: [T * k] int64; gate: [T * k] float32;
// out: [T, d], ye's dtype.
int moe_combine(const void* ye, const int64_t* ids, const int64_t* pos,
                const float* gate, void* out, int T, int k, int C, int d,
                int dtype, cudaStream_t stream) {
  const long long row_bytes = static_cast<long long>(d) * elem_bytes(dtype);
  const int vb = vec_bytes(row_bytes, ye, out);
  if (vb == 0) return cudaErrorInvalidValue;
  const unsigned row_vecs = static_cast<unsigned>(row_bytes / vb);
  const unsigned total = static_cast<unsigned>(T) * row_vecs;
  if (total == 0) return cudaGetLastError();
  const int err =
      dtype == kF32 ? combine_by_width<kF32>(vb, ye, ids, pos, gate, out, row_vecs, total, k, C, stream)
      : dtype == kBF16 ? combine_by_width<kBF16>(vb, ye, ids, pos, gate, out, row_vecs, total, k, C, stream)
                       : combine_by_width<kF16>(vb, ye, ids, pos, gate, out, row_vecs, total, k, C, stream);
  if (err != 0) return err;
  return cudaGetLastError();
}

}  // extern "C"
