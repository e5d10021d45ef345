// Fused exact-engine stage 1 for Hopper (sm_90a): score every corpus row
// against every query on the tensor cores and keep each bm-row block's
// top-2 packed keys, without writing the [B, M] score matrix anywhere.
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
// far above the H100's ~300 op/byte balance point -- so the products go
// to the tensor cores through wgmma.
//
// What the design does about it:
//   * one output tile is 128 queries x one 256-row corpus sub-block; two
//     consumer warpgroups each take 64 of the queries and run wgmma
//     m64n256k32 (s8, s32 accumulators) or two m64n128k16 halves (bf16,
//     f32 accumulators), with A (queries) and B (corpus rows) both K-major
//     in shared memory, exactly as the row-major [B, d] and [Mp, d] tables
//     lie;
//   * d is cut into 128-byte K-slices (64 bf16 or 128 int8); one producer
//     thread loads each slice of the query tile (16 KB) and the corpus
//     sub-block (32 KB) with TMA, 128-byte swizzled, into a ring of 4
//     stages behind full/empty mbarriers; TMA zero-fills query rows past B;
//   * the select is the epilogue, in registers: each thread owns 2 query
//     rows x 64 columns of the accumulator, applies the affine, packs the
//     key and folds it into a per-row top-2, then 2 shuffle steps across
//     the quad finish the row; only [B, 2*nb] keys and indices reach
//     memory.  For bm > 256 the CTA walks the bm/256 sub-blocks of one
//     block and carries the running top-2;
//   * the grid is persistent, one CTA per SM, walking (block, query tile)
//     units with corpus blocks outer and query tiles inner, so the CTAs
//     that share a corpus block run together and read it from L2: the
//     corpus streams from HBM about once.
//
// Numerics: int8 dots accumulate exactly in s32, so int8 keys are
// bit-equal to the plain PyTorch version.  The tensor core truncates as it
// accumulates bf16 products in f32, which over 768 terms drifts several
// ulps from a rounded f32 sum -- too far for the check against the plain
// version (>= 98% of keys equal).  So each 128-byte K-slice (64 terms) is
// summed on the tensor core into a fresh accumulator and added to f32
// registers with round-to-nearest; that costs a second set of 64
// registers, hence the two m64n128 halves.  The affine is
// __fmul_rn/__fadd_rn in the reference's order, so no FMA contraction
// changes a rounding.
//
// Interface: plain C, pointers and the stream as void*, returns a
// cudaError_t (0 on success) after the launch.  Requirements (checked by
// the Python wrapper): d % 128 == 0, bm % 256 == 0 and a power of two,
// Mp % bm == 0, q and x 16-byte aligned, all tensors contiguous on one
// device.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <type_traits>

namespace {

constexpr int kTileQ = 128;       // queries per tile: 2 consumer warpgroups x 64
constexpr int kSub = 256;         // corpus rows per tile: the wgmma N
constexpr int kSliceBytes = 128;  // one K-slice: one 128-byte swizzle row
constexpr int kStages = 4;
constexpr int kQBytes = kTileQ * kSliceBytes;  // 16 KB
constexpr int kXBytes = kSub * kSliceBytes;    // 32 KB
constexpr int kStageBytes = kQBytes + kXBytes;
constexpr int kParamBytes = 2 * 2 * kSub * 4;  // 2 buffers of [mult | add]
constexpr int kThreads = 384;    // 1 producer + 2 consumer warpgroups
constexpr int kConsumers = 256;
// bf16: k16 steps summed on the tensor core per f32 promotion, one K-slice
// (scripts/torch_select_promote.py builds and measures 1, 2 and 4)
constexpr int kPromote = 4;
static_assert(kPromote == 1 || kPromote == 2 || kPromote == 4, "kPromote divides 4 k16 steps");
constexpr int kSmemBytes = 1024 + kStages * kStageBytes + kParamBytes + 2 * kStages * 8;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

// Spin until the phase of the given parity has completed.  A wait that
// never ends (a pipeline fault) traps instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (long long spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spins > (1ll << 26)) __trap();
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile written by TMA with
// 128-byte swizzle: 8-row groups of 128-byte rows, 1024 bytes apart.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4)  // start address
         | ((uint64_t)1 << 16)              // leading byte offset (unused)
         | ((uint64_t)(1024 >> 4) << 32)    // stride byte offset
         | ((uint64_t)1 << 62);             // 128-byte swizzle
}

#define WGMMA_D                                                                   \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "  \
  "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "   \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "   \
  "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "   \
  "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, "   \
  "%77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, "   \
  "%92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, "  \
  "%106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "      \
  "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127}"
#define WGMMA_D64                                                                 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "  \
  "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "   \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "   \
  "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "   \
  "%62, %63}"
#define ACC8(c, i)                                                                \
  c(d[i]), c(d[i + 1]), c(d[i + 2]), c(d[i + 3]), c(d[i + 4]), c(d[i + 5]),       \
      c(d[i + 6]), c(d[i + 7])
#define ACC64(c)                                                                  \
  ACC8(c, 0), ACC8(c, 8), ACC8(c, 16), ACC8(c, 24), ACC8(c, 32), ACC8(c, 40),     \
      ACC8(c, 48), ACC8(c, 56)
#define ACC128(c)                                                                 \
  ACC64(c), ACC8(c, 64), ACC8(c, 72), ACC8(c, 80), ACC8(c, 88), ACC8(c, 96),      \
      ACC8(c, 104), ACC8(c, 112), ACC8(c, 120)

// d[64 x 128] (+)= A[64 x 16] . B[16 x 128], bf16 in, f32 accumulators
__device__ __forceinline__ void wgmma_bf16(float (&d)[64], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WGMMA_D64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : ACC64("+f")
      : "l"(da), "l"(db), "r"(acc));
}

// d[64 x 256] (+)= A[64 x 32] . B[32 x 256], s8 in, s32 accumulators
__device__ __forceinline__ void wgmma_s8(int (&d)[128], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 " WGMMA_D
      ", %128, %129, p;\n}\n"
      : ACC128("+r")
      : "l"(da), "l"(db), "r"(acc));
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma fence / commit / wait.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_acc(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

__device__ __forceinline__ int pack_key(float s, int lane, int bm) {
  int i = __float_as_int(s);
  int skey = i >= 0 ? i : (i ^ 0x7fffffff);
  return (skey & -bm) | lane;
}

// affine in the reference's order, key, and a branch-free top-2 insert
template <typename Acc>
__device__ __forceinline__ void fold(Acc dot, float sq, float m, float a, int lane, int bm,
                                     int& t1, int& t2) {
  float fd;
  if constexpr (std::is_same<Acc, int>::value) {
    fd = __int2float_rn(dot);
  } else {
    fd = dot;
  }
  const int key = pack_key(__fadd_rn(__fmul_rn(fd, __fmul_rn(sq, m)), a), lane, bm);
  const int lo = min(t1, key);
  t1 = max(t1, key);
  t2 = max(t2, lo);
}

__device__ __forceinline__ void merge_top2(int& t1, int& t2, int off) {
  const int o1 = __shfl_xor_sync(0xffffffffu, t1, off);
  const int o2 = __shfl_xor_sync(0xffffffffu, t2, off);
  const int n2 = max(min(t1, o1), max(t2, o2));
  t1 = max(t1, o1);
  t2 = n2;
}

template <bool kInt8>
__global__ void __launch_bounds__(kThreads, 1)
fused_select_kernel(const __grid_constant__ CUtensorMap tmq, const __grid_constant__ CUtensorMap tmx,
                    const float* __restrict__ qsc, const float* __restrict__ mult,
                    const float* __restrict__ add, int* __restrict__ keys,
                    int* __restrict__ idx, int B, int nb, int nks, int bm) {
  using Acc = typename std::conditional<kInt8, int, float>::type;
  constexpr int kSliceElems = kInt8 ? 128 : 64;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // TMA's 128-byte swizzle wants 1024-aligned tiles
  const uint32_t q_s = base;                     // kStages x [128 rows x 128 B]
  const uint32_t x_s = base + kStages * kQBytes;  // kStages x [256 rows x 128 B]
  float* const params = reinterpret_cast<float*>(smem_raw + (base - raw) + kStages * kStageBytes);
  const uint32_t bars = base + kStages * kStageBytes + kParamBytes;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (kStages + s); };

  const int nqt = (B + kTileQ - 1) / kTileQ;
  const int n_units = nb * nqt;
  const int n_sub = bm / kSub;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumers / 32);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer warpgroup: one thread issues every TMA load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == 0) {
      asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&tmq)) : "memory");
      asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&tmx)) : "memory");
      int stage = 0;
      uint32_t phase = 0;
      for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
        const int blk = u / nqt;
        const int q0 = (u - blk * nqt) * kTileQ;
        for (int sub = 0; sub < n_sub; ++sub) {
          const int row0 = blk * bm + sub * kSub;
          for (int ks = 0; ks < nks; ++ks) {
            mbar_wait(empty(stage), phase ^ 1);
            mbar_expect_tx(full(stage), kStageBytes);
            tma_load_2d(q_s + stage * kQBytes, &tmq, ks * kSliceElems, q0, full(stage));
            tma_load_2d(x_s + stage * kXBytes, &tmx, ks * kSliceElems, row0, full(stage));
            if (++stage == kStages) {
              stage = 0;
              phase ^= 1;
            }
          }
        }
      }
    }
    return;
  }

  // consumer warpgroups 1 and 2: wgmma, then the select epilogue
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  const int ct = threadIdx.x - 128;  // 0..255
  const int cw = wg - 1;             // rows cw*64 .. cw*64+63 of the tile
  const int lane = threadIdx.x & 31;
  // accumulator layout: acc[4j + 2h + c] is row r + 8h, column 8j + cb + c
  const int r = cw * 64 + ((ct & 127) >> 5) * 16 + (lane >> 2);
  const int cb = 2 * (lane & 3);

  Acc acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0;
  int stage = 0;
  uint32_t phase = 0;
  int it = 0;
  for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
    const int blk = u / nqt;
    const int b0 = (u - blk * nqt) * kTileQ + r;
    const int b1 = b0 + 8;
    const float sq0 = b0 < B ? __ldg(qsc + b0) : 1.0f;
    const float sq1 = b1 < B ? __ldg(qsc + b1) : 1.0f;
    int t1a = INT_MIN, t2a = INT_MIN, t1b = INT_MIN, t2b = INT_MIN;

    for (int sub = 0; sub < n_sub; ++sub, ++it) {
      const size_t row0 = (size_t)blk * bm + sub * kSub;
      // this sub-block's mult/add, staged in shared memory after the MMAs
      const float pm = __ldg(mult + row0 + ct);
      const float pa = __ldg(add + row0 + ct);

      if constexpr (kInt8) {
        // exact s32 sums: one m64n256 accumulator over all of d; a stage
        // is freed as soon as the next slice's products are issued
        int prev = 0;
        for (int ks = 0; ks < nks; ++ks) {
          mbar_wait(full(stage), phase);
          fence_acc(acc);
          asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
          const uint64_t da = sw128_desc(q_s + stage * kQBytes + cw * 64 * kSliceBytes);
          const uint64_t db = sw128_desc(x_s + stage * kXBytes);
#pragma unroll
          for (int k = 0; k < 4; ++k) {  // 4 x 32 bytes of K per slice
            wgmma_s8(acc, da + 2 * k, db + 2 * k, (ks | k) != 0);
          }
          asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
          fence_acc(acc);
          if (ks > 0) {
            asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
            if (lane == 0) mbar_arrive(empty(prev));
          }
          prev = stage;
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
        asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
        fence_acc(acc);
        if (lane == 0) mbar_arrive(empty(prev));
      } else {
        // each group of kPromote k16 steps is summed on the tensor core
        // into a fresh m64n128 half, then added to the f32 registers with
        // round-to-nearest (see Numerics above)
#pragma unroll
        for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
        float part[64];
        for (int ks = 0; ks < nks; ++ks) {
          mbar_wait(full(stage), phase);
          const uint64_t da = sw128_desc(q_s + stage * kQBytes + cw * 64 * kSliceBytes);
          const uint64_t db = sw128_desc(x_s + stage * kXBytes);
#pragma unroll
          for (int g = 0; g < 4; g += kPromote) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {  // columns 128h .. 128h+127
              fence_acc(part);
              asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
              for (int k = g; k < g + kPromote; ++k) {
                wgmma_bf16(part, da + 2 * k, db + h * (kXBytes / 2 >> 4) + 2 * k, k != g);
              }
              asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
              asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
              fence_acc(part);
#pragma unroll
              for (int i = 0; i < 64; ++i) acc[64 * h + i] = __fadd_rn(acc[64 * h + i], part[i]);
            }
          }
          if (lane == 0) mbar_arrive(empty(stage));
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }

      // double-buffered by sub-tile: the barrier of sub-tile it-1 orders
      // the writes of it+1 after every read of it-1's buffer
      float* const ps = params + (it & 1) * 2 * kSub;
      ps[ct] = pm;
      ps[kSub + ct] = pa;
      asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");

      const int lane0 = sub * kSub + cb;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const float2 m = *reinterpret_cast<const float2*>(ps + 8 * j + cb);
        const float2 a = *reinterpret_cast<const float2*>(ps + kSub + 8 * j + cb);
        const int ln = lane0 + 8 * j;
        fold(acc[4 * j + 0], sq0, m.x, a.x, ln, bm, t1a, t2a);
        fold(acc[4 * j + 1], sq0, m.y, a.y, ln + 1, bm, t1a, t2a);
        fold(acc[4 * j + 2], sq1, m.x, a.x, ln, bm, t1b, t2b);
        fold(acc[4 * j + 3], sq1, m.y, a.y, ln + 1, bm, t1b, t2b);
      }
    }

    // the quad's 4 threads hold the same two rows: 2 butterfly steps
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      merge_top2(t1a, t2a, off);
      merge_top2(t1b, t2b, off);
    }
    if ((lane & 3) == 0) {
      const int two_nb = 2 * nb;
      const int base_idx = blk * bm;
      if (b0 < B) {
        const size_t o = (size_t)b0 * two_nb;
        keys[o + blk] = t1a;
        keys[o + nb + blk] = t2a;
        idx[o + blk] = (t1a & (bm - 1)) + base_idx;
        idx[o + nb + blk] = (t2a & (bm - 1)) + base_idx;
      }
      if (b1 < B) {
        const size_t o = (size_t)b1 * two_nb;
        keys[o + blk] = t1b;
        keys[o + nb + blk] = t2b;
        idx[o + blk] = (t1b & (bm - 1)) + base_idx;
        idx[o + nb + blk] = (t2b & (bm - 1)) + base_idx;
      }
    }
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, without linking libcuda
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &res);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &res);
#endif
    if (e == cudaSuccess && res == cudaDriverEntryPointSuccess) fn = (EncodeTiledFn)p;
  }
  return fn;
}

// [rows, d] row-major table; one box is one K-slice of box_rows rows
bool encode_map(EncodeTiledFn enc, CUtensorMap* map, const void* ptr, bool int8, int rows, int d,
                int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)d * (int8 ? 1 : 2)};
  const cuuint32_t box[2] = {(cuuint32_t)(kSliceBytes / (int8 ? 1 : 2)), (cuuint32_t)box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  return enc(map, int8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
             const_cast<void*>(ptr), dims, strides, box, elem_strides,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool kInt8>
int launch(const void* q, const void* x, const void* qsc, const void* mult, const void* add,
           void* keys, void* idx, int B, int Mp, int d, int bm, void* stream) {
  EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tmq, tmx;
  if (!encode_map(enc, &tmq, q, kInt8, B, d, kTileQ) ||
      !encode_map(enc, &tmx, x, kInt8, Mp, d, kSub)) {
    return (int)cudaErrorInvalidValue;
  }
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(fused_select_kernel<kInt8>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  const int nb = Mp / bm;
  const int n_units = nb * ((B + kTileQ - 1) / kTileQ);
  const int grid = n_units < sms ? n_units : sms;
  const int nks = d / (kSliceBytes / (kInt8 ? 1 : 2));
  fused_select_kernel<kInt8><<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      tmq, tmx, (const float*)qsc, (const float*)mult, (const float*)add, (int*)keys, (int*)idx,
      B, nb, nks, bm);
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
