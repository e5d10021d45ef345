// Fused exact-engine stage 1 for Hopper (sm_90a): score every corpus row
// against every query and keep each bm-row block's top-2 packed keys,
// without writing the [B, M] score matrix anywhere.
//
// Replaces: arroy_tpu/ops/pallas_exact.py, fused_block_select
// (_select_kernel + _pack_keys), the TPU Pallas kernel.
//
//   score[b, m] = dot(q[b], x[m]) * (qsc[b] * mult[m]) + add[m]
//   key         = (totalorder_i32(score) & -bm) | lane      (lane = m % bm)
//   out         = per (query, block): max key, runner-up key
//
// What bounds it on this card: arithmetic.  At the main-path shape
// (B=2048, Mp=100,352, d=768) stage 1 is 158 G multiply-adds against
// 77 MB (int8) or 154 MB (bf16) of corpus, ~2000 operations per byte --
// far above the H100's ~300 op/byte balance point.  This first version
// runs on the SIMT pipes (__dp4a for int8, fmaf for bf16), not on the
// tensor cores; wgmma/TMA are later work.
//
// What the design does about it:
//   * one CTA owns one corpus block (bm rows) and a tile of 64 queries;
//     it stages the block through shared memory in d-chunks, so each
//     corpus word loaded is reused by 64 queries and each query word by
//     256 rows (8x8 register tile per thread);
//   * the grid runs query tiles fastest, so the CTAs that share a corpus
//     block run together and the corpus streams from HBM about once
//     (the 1.5 MB query matrix stays in L2);
//   * the select is in registers: a per-thread running top-2 per query,
//     then a 5-step warp butterfly; only [B, 2*nb] keys and indices
//     reach memory.
//
// Numerics: int8 dots accumulate exactly in int32.  bf16 dots accumulate
// in f32 in strictly ascending k order (one fmaf per k; bf16 products are
// exact in f32).  The affine is __fmul_rn/__fadd_rn in the reference's
// order, so no FMA contraction changes a rounding: int8 keys are
// bit-equal to the plain PyTorch version.
//
// Interface: plain C, pointers and the stream as void*, returns
// cudaGetLastError() after the launch.  Requirements (checked by the
// Python wrapper): d % 128 == 0, bm % 256 == 0 and a power of two,
// Mp % bm == 0, all tensors contiguous on one device.

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <type_traits>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kSubRows = 256;  // corpus rows per sub-tile: 32 threads x 8
constexpr int kTileQ = 64;     // queries per CTA: 8 warps x 8
constexpr int kRows = 8;       // rows per thread (tx + 32*j)
constexpr int kQ = 8;          // queries per thread (ty*8 + i)
constexpr int kChunk = 32;     // k-steps staged per chunk (int8: 32 words)
constexpr int kXs = kSubRows + 1;  // padded smem row: conflict-free transpose
constexpr int kQs = kTileQ + 1;

__device__ __forceinline__ int pack_key(float s, int lane, int bm) {
  int i = __float_as_int(s);
  int skey = i >= 0 ? i : (i ^ 0x7fffffff);
  return (skey & -bm) | lane;
}

__device__ __forceinline__ void push_top2(int key, int& t1, int& t2) {
  if (key > t1) {
    t2 = t1;
    t1 = key;
  } else if (key > t2) {
    t2 = key;
  }
}

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}

__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// Int8: operands are int32 words of 4 consecutive int8 values.
// Bf16: operands are converted to f32 when staged.
template <bool kInt8>
__global__ void __launch_bounds__(kThreads)
fused_select_kernel(const uint32_t* __restrict__ q, const uint32_t* __restrict__ x,
                    const float* __restrict__ qsc, const float* __restrict__ mult,
                    const float* __restrict__ add, int* __restrict__ keys,
                    int* __restrict__ idx, int B, int nb, int d, int bm) {
  using Acc = typename std::conditional<kInt8, int, float>::type;
  using Elt = typename std::conditional<kInt8, int, float>::type;
  __shared__ Elt xs[kChunk][kXs];
  __shared__ Elt qs[kChunk][kQs];

  const int t = threadIdx.x;
  const int tx = t & 31;
  const int ty = t >> 5;
  const int q0 = blockIdx.x * kTileQ;
  const int blk = blockIdx.y;
  // row length in 32-bit words
  const int nw = kInt8 ? d / 4 : d / 2;
  // words staged per row per chunk (int8: 32 words = 128 k; bf16: 16 words = 32 k)
  constexpr int kWords = kInt8 ? kChunk : kChunk / 2;

  int t1[kQ], t2[kQ];
#pragma unroll
  for (int i = 0; i < kQ; ++i) {
    t1[i] = INT_MIN;
    t2[i] = INT_MIN;
  }

  for (int sub = 0; sub < bm; sub += kSubRows) {
    const size_t row0 = (size_t)blk * bm + sub;
    Acc acc[kQ][kRows];
#pragma unroll
    for (int i = 0; i < kQ; ++i)
#pragma unroll
      for (int j = 0; j < kRows; ++j) acc[i][j] = 0;

    for (int w0 = 0; w0 < nw; w0 += kWords) {
      __syncthreads();  // the previous chunk's readers are done
      // corpus sub-tile: kSubRows rows x kWords words, coalesced along words
      for (int e = t; e < kSubRows * kWords; e += kThreads) {
        const int r = e / kWords;
        const int c = e % kWords;
        const uint32_t v = x[(row0 + r) * nw + w0 + c];
        if constexpr (kInt8) {
          xs[c][r] = (Elt)v;
        } else {
          xs[2 * c][r] = (Elt)bf16_lo(v);
          xs[2 * c + 1][r] = (Elt)bf16_hi(v);
        }
      }
      // query tile: kTileQ queries x kWords words (zeros past B)
      for (int e = t; e < kTileQ * kWords; e += kThreads) {
        const int r = e / kWords;
        const int c = e % kWords;
        const int b = q0 + r;
        const uint32_t v = b < B ? q[(size_t)b * nw + w0 + c] : 0u;
        if constexpr (kInt8) {
          qs[c][r] = (Elt)v;
        } else {
          qs[2 * c][r] = (Elt)bf16_lo(v);
          qs[2 * c + 1][r] = (Elt)bf16_hi(v);
        }
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < kChunk; ++kk) {
        Elt a[kQ], bv[kRows];
#pragma unroll
        for (int i = 0; i < kQ; ++i) a[i] = qs[kk][ty * kQ + i];
#pragma unroll
        for (int j = 0; j < kRows; ++j) bv[j] = xs[kk][tx + 32 * j];
#pragma unroll
        for (int i = 0; i < kQ; ++i)
#pragma unroll
          for (int j = 0; j < kRows; ++j) {
            if constexpr (kInt8) {
              acc[i][j] = (Acc)__dp4a((int)a[i], (int)bv[j], (int)acc[i][j]);
            } else {
              acc[i][j] = (Acc)fmaf((float)a[i], (float)bv[j], (float)acc[i][j]);
            }
          }
      }
    }

    // epilogue: affine (no contraction), key packing, running top-2
#pragma unroll
    for (int i = 0; i < kQ; ++i) {
      const int b = q0 + ty * kQ + i;
      const float sq = b < B ? qsc[b] : 1.0f;
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const int lane = sub + tx + 32 * j;
        const size_t m = (size_t)blk * bm + lane;
        const float dot = kInt8 ? __int2float_rn((int)acc[i][j]) : (float)acc[i][j];
        const float s = __fadd_rn(__fmul_rn(dot, __fmul_rn(sq, mult[m])), add[m]);
        push_top2(pack_key(s, lane, bm), t1[i], t2[i]);
      }
    }
  }

  // warp butterfly: every lane ends with the block's top-2 for each query
#pragma unroll
  for (int i = 0; i < kQ; ++i) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const int o1 = __shfl_xor_sync(0xffffffffu, t1[i], off);
      const int o2 = __shfl_xor_sync(0xffffffffu, t2[i], off);
      const int n2 = max(min(t1[i], o1), max(t2[i], o2));
      t1[i] = max(t1[i], o1);
      t2[i] = n2;
    }
  }
  if (tx == 0) {
    const int two_nb = 2 * nb;
#pragma unroll
    for (int i = 0; i < kQ; ++i) {
      const int b = q0 + ty * kQ + i;
      if (b < B) {
        const size_t o = (size_t)b * two_nb;
        keys[o + blk] = t1[i];
        keys[o + nb + blk] = t2[i];
        idx[o + blk] = (t1[i] & (bm - 1)) + blk * bm;
        idx[o + nb + blk] = (t2[i] & (bm - 1)) + blk * bm;
      }
    }
  }
}

template <bool kInt8>
int launch(const void* q, const void* x, const void* qsc, const void* mult,
           const void* add, void* keys, void* idx, int B, int Mp, int d, int bm,
           void* stream) {
  const int nb = Mp / bm;
  dim3 grid((B + kTileQ - 1) / kTileQ, nb);
  fused_select_kernel<kInt8><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)q, (const uint32_t*)x, (const float*)qsc,
      (const float*)mult, (const float*)add, (int*)keys, (int*)idx, B, nb, d, bm);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fused_select_int8(const void* q, const void* x, const void* qsc,
                                 const void* mult, const void* add, void* keys,
                                 void* idx, int B, int Mp, int d, int bm,
                                 void* stream) {
  return launch<true>(q, x, qsc, mult, add, keys, idx, B, Mp, d, bm, stream);
}

extern "C" int fused_select_bf16(const void* q, const void* x, const void* qsc,
                                 const void* mult, const void* add, void* keys,
                                 void* idx, int B, int Mp, int d, int bm,
                                 void* stream) {
  return launch<false>(q, x, qsc, mult, add, keys, idx, B, Mp, d, bm, stream);
}
