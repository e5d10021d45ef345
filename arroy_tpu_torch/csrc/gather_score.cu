// Leaf-probe stage 2 for Hopper (sm_90a): score the selected blocks.
//   out[b, c, p] = sum_d f32(rows[bid[b, c], p, d]) * q[b, d]     (f32, [B, C, P])
//
// Replaces: arroy_tpu/ops/pallas_probe.py, gather_score
// (_gather_score_kernel), the TPU Pallas kernel.  The JAX package serves
// the same function as an XLA gather `blk_rows[bid]` (a [B, C, P, d]
// tensor in device memory) followed by an einsum; this kernel never
// writes the gathered rows anywhere.
//
// What bounds it on this card: memory.  Each selected [P, d] block is
// streamed once and every element takes one FMA against the query, so
// the work is about 2 flops per row element: 1 flop per byte for bf16
// rows, far below the ~295 flops per byte where the card stops being
// memory-bound.  On the probe slice (262,144 x 768, bf16, search_k 4000)
// a 256-query batch selects C=72 blocks of P=64 rows per query: 1.8 GB
// of rows, 1.27 GB of them in distinct blocks, against 4.7 MB of output.
//
// What the design does about it: one CTA per (query, group of G blocks),
// G*P ~ 64 rows.  The query sits in shared memory as f32.  Each warp
// takes 8 rows at a time; a lane owns every 32nd vector of a row and
// issues the 8 rows' loads together, so a warp keeps 8 x 512 bytes in
// flight with one read of the query per vector.  Loads are 16 bytes
// wide when the row length and base allow it, else the widest width
// that divides both (8, 4, 2 or 1 bytes: a row of 100 bf16 is 200
// bytes and reads in 8-byte vectors).  A warp-shuffle sum gives each
// row's dot and one lane writes it.  Sums are f32 FMAs in another order
// than PyTorch's, so results differ from the plain version by rounding
// only.  wgmma, TMA, and reuse of a block shared between queries are
// left for later.
//
// Int8 rows convert exactly to f32; the caller applies the per-item
// dequant scale after the dot, as the JAX package does.  Block ids
// outside [0, nbt) produce 0 (a bounds guard; the caller clamps them).
//
// Interface: plain C, pointers and the stream as void*, returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a row
// type / vector width the kernel has no instance for,
// cudaErrorInvalidConfiguration for a grid past 2^31 - 1 CTAs).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kRows = 8;  // rows in flight per warp

template <int VB> struct RawVec;
template <> struct RawVec<16> { using type = uint4; };
template <> struct RawVec<8> { using type = uint2; };
template <> struct RawVec<4> { using type = unsigned int; };
template <> struct RawVec<2> { using type = unsigned short; };
template <> struct RawVec<1> { using type = unsigned char; };

__device__ __forceinline__ float to_f32(float v) { return v; }
// bf16 is the high half of an f32: the conversion is exact
__device__ __forceinline__ float to_f32(unsigned short v) {
  return __uint_as_float(static_cast<unsigned int>(v) << 16);
}
__device__ __forceinline__ float to_f32(signed char v) { return static_cast<float>(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// T: float (f32), unsigned short (bf16 bits) or signed char (int8).
// VB: bytes per vector load; d * sizeof(T) and the base are multiples of VB.
template <typename T, int VB>
__global__ void __launch_bounds__(kWarps * 32)
gather_score_kernel(const T* __restrict__ rows, const int* __restrict__ bid,
                    const float* __restrict__ q, float* __restrict__ out,
                    int C, int P, int d, int nbt, int G) {
  using V = typename RawVec<VB>::type;
  constexpr int VE = VB / static_cast<int>(sizeof(T));  // elements per vector
  extern __shared__ __align__(16) float qs[];           // [d] query, f32

  const int ngroups = (C + G - 1) / G;
  const int b = blockIdx.x / ngroups;
  const int c0 = (blockIdx.x % ngroups) * G;
  const int nrows = min(G, C - c0) * P;
  const float* qb = q + static_cast<size_t>(b) * d;
  for (int e = threadIdx.x; e < d; e += blockDim.x) qs[e] = qb[e];
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nvec = d / VE;
  const int* bids = bid + static_cast<size_t>(b) * C + c0;
  float* outb = out + (static_cast<size_t>(b) * C + c0) * P;

  for (int r0 = warp * kRows; r0 < nrows; r0 += kWarps * kRows) {
    const V* rp[kRows];
    float acc[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      acc[i] = 0.f;
      rp[i] = nullptr;
      const int r = r0 + i;
      if (r < nrows) {
        const int blk = bids[r / P];
        if (blk >= 0 && blk < nbt)
          rp[i] = reinterpret_cast<const V*>(
              rows + (static_cast<size_t>(blk) * P + r % P) * d);
      }
    }
    for (int v = lane; v < nvec; v += 32) {
      V raw[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) raw[i] = rp[i] ? __ldg(rp[i] + v) : V{};
      float qv[VE];
      if constexpr (VE % 4 == 0) {
        const float4* q4 = reinterpret_cast<const float4*>(qs + v * VE);
#pragma unroll
        for (int j = 0; j < VE / 4; ++j) {
          const float4 t = q4[j];
          qv[4 * j] = t.x;
          qv[4 * j + 1] = t.y;
          qv[4 * j + 2] = t.z;
          qv[4 * j + 3] = t.w;
        }
      } else {
#pragma unroll
        for (int j = 0; j < VE; ++j) qv[j] = qs[v * VE + j];
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const T* e = reinterpret_cast<const T*>(&raw[i]);
#pragma unroll
        for (int j = 0; j < VE; ++j) acc[i] = fmaf(to_f32(e[j]), qv[j], acc[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const float s = warp_sum(acc[i]);
      if (lane == 0 && r0 + i < nrows) outb[r0 + i] = s;
    }
  }
}

template <typename T, int VB>
int launch(const void* rows, const void* bid, const void* q, void* out, int B,
           int C, int P, int d, int nbt, cudaStream_t stream) {
  const int G = P >= kWarps * kRows ? 1 : (kWarps * kRows) / P;
  const long long ctas = static_cast<long long>(B) * ((C + G - 1) / G);
  if (ctas > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t smem = static_cast<size_t>(d) * sizeof(float);
  gather_score_kernel<T, VB><<<static_cast<unsigned>(ctas), kWarps * 32, smem, stream>>>(
      static_cast<const T*>(rows), static_cast<const int*>(bid),
      static_cast<const float*>(q), static_cast<float*>(out), C, P, d, nbt, G);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_vec(int vec_bytes, const void* rows, const void* bid, const void* q,
                 void* out, int B, int C, int P, int d, int nbt, cudaStream_t s) {
  switch (vec_bytes) {
    case 16: return launch<T, 16>(rows, bid, q, out, B, C, P, d, nbt, s);
    case 8: return launch<T, 8>(rows, bid, q, out, B, C, P, d, nbt, s);
    case 4: return launch<T, 4>(rows, bid, q, out, B, C, P, d, nbt, s);
  }
  if constexpr (sizeof(T) <= 2)
    if (vec_bytes == 2) return launch<T, 2>(rows, bid, q, out, B, C, P, d, nbt, s);
  if constexpr (sizeof(T) == 1)
    if (vec_bytes == 1) return launch<T, 1>(rows, bid, q, out, B, C, P, d, nbt, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// row_type: 0 = f32, 1 = bf16, 2 = int8.  Shapes: rows [nbt, P, d],
// bid [B, C] int32, q [B, d] f32, out [B, C, P] f32, all contiguous.
extern "C" int gather_score(int row_type, int vec_bytes, const void* rows,
                            const void* bid, const void* q, void* out, int B,
                            int C, int P, int d, int nbt, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (row_type) {
    case 0: return dispatch_vec<float>(vec_bytes, rows, bid, q, out, B, C, P, d, nbt, s);
    case 1: return dispatch_vec<unsigned short>(vec_bytes, rows, bid, q, out, B, C, P, d, nbt, s);
    case 2: return dispatch_vec<signed char>(vec_bytes, rows, bid, q, out, B, C, P, d, nbt, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
