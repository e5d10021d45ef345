// Binary-quantized distance matrix for Hopper (sm_90a), on the tensor cores:
//   h[b, m] = sum_w popcount(q[b, w] XOR x[m, w])     (int32, [B, M])
//
// Replaces: arroy_tpu/ops/pallas_kernels.py, bq_hamming_matrix
// (_hamming_kernel), the TPU Pallas kernel.
//
// What bounds it on this card: the [B, M] int32 output.  At the main-path
// shape (B=2048, M=100,000, w=24 words = 768 bits) the kernel reads 0.2 MB
// of queries and 9.6 MB of corpus, which both stay in the 50 MB L2, and
// writes 819 MB of distances: 0.245 ms at 3.35 TB/s.  As SIMT xor +
// popcount the 4.9 G word pairs alone cost more than that (popcount issues
// at 16 per SM per clock), so the counts go to the tensor cores.
//
// What the design does about it:
//   * the counts are one-bit MMAs, mma.sync m16n8k256 .b1 with .and.popc,
//     through   popc(q ^ x) = popc(q & ~x) + popc(~q & x):
//     two AND-MMAs into one accumulator, the second on complemented
//     operands, give the distance itself, exact in integers, so the
//     result is bit-equal to the plain PyTorch version.  Each fragment
//     register is one packed 32-bit word of a row (no bit is decoded), A
//     and B both lie [rows, w] as the tables do (row.col), one k-step is 8
//     words, and the words past w are zero in both operands: q & ~x and
//     ~q & x are zero there.  (The other identity, popc(q) + popc(x) -
//     2 popc(q & x), takes half the MMAs but needs every row's popcount a
//     tile, a second shared array and arithmetic per output; timed no
//     faster on the card by scripts/torch_hamming_tune.py, which splices
//     in scripts/hamming_popcount_identity.cu.  The tensor cores are far
//     from busy either way.);
//   * a CTA owns kTileQ queries x kTileX corpus rows, each warp 16 kMT x 32
//     of them (kMT m16 x 4 n8 tiles).  The CTAs are persistent, one wave
//     of them, each walking tiles with stride gridDim.x: while a tile's
//     MMAs and stores run, cp.async brings the next tile's rows into the
//     other of two staging buffers (16-byte aligned rows, an odd number of
//     16-byte units apart, so ldmatrix reads them without bank conflicts),
//     zero-filling words past w and rows past B or M.  Rows are staged in
//     chunks of up to kChunkSteps k-steps, which takes any w;
//   * the epilogue is built for the write.  Within each 32-row corpus slab
//     the rows are staged in the order that makes a thread's accumulators
//     4 neighbouring output columns; two quads trade halves with one
//     shuffle, so each store of a warp writes 4 whole 128-byte lines of
//     output rows, 16 bytes a lane, straight from registers, with the
//     evict-first hint (st.global.cs): the output streams to HBM and
//     leaves q and x in L2.
//
// Tile shape, tile order and the store hint were chosen by measuring
// (scripts/torch_hamming_tune.py).
//
// Interface: plain C, pointers and the stream as void*, returns
// cudaGetLastError() after the launch.  Inputs are the packed sign-bit
// words as int32 bit patterns, contiguous; any w >= 1, B >= 1, M >= 1.

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace {

constexpr int kWarpsQ = 2;  // warps along the queries
constexpr int kWarpsX = 4;  // warps along the corpus rows
constexpr int kMT = 4;  // m16 tiles of queries per warp (n8 tiles: 4, 32 corpus rows)
constexpr int kMinBlocks = 2;  // CTAs per SM that ptxas must leave room for
constexpr int kThreads = 32 * kWarpsQ * kWarpsX;
constexpr int kTileQ = 16 * kMT * kWarpsQ;
constexpr int kTileX = 32 * kWarpsX;
constexpr int kRows = kTileQ + kTileX;
constexpr int kChunkSteps = 8;  // k-steps staged at once: 64 words, 2048 bits
// two staging buffers at the widest chunk fit the 227 KB of shared memory
// a CTA may have
static_assert(2 * kRows * (8 * kChunkSteps + 4) * 4 <= 232448, "tile too large");

// The staged row of slab column c (0..31) of a corpus tile: the row that
// the MMA reads as column n of n8-tile j, where c's bits from bit 4 down
// are (j >> 1), (n >> 1) [2 bits], (j & 1), (n & 1).  A thread's C
// fragments (n = 2 tig, 2 tig + 1 of tiles j = 2s, 2s + 1) then hold
// output columns 16 s + 4 tig + {0, 1, 2, 3}.
__device__ __forceinline__ int slab_row(int c) {
  const int j = ((c >> 4) << 1) | ((c >> 1) & 1);
  const int n = (((c >> 2) & 3) << 1) | (c & 1);
  return j * 8 + n;
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const uint32_t* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

// c += popc(A & B) over one 16 x 8 x 256-bit tile.  A (row-major, 16 x 256
// bits): a0 = row g word tig, a1 = row g+8 word tig, a2 / a3 the same rows
// at word tig+4; B (column-major, 256 x 8 bits): b0 = column g word tig,
// b1 = word tig+4; C: c0, c1 = row g, columns 2 tig, 2 tig+1; c2, c3 = row
// g+8 (g = lane / 4, tig = lane % 4; words within the 8-word k-step).
__device__ __forceinline__ void mma_and_popc(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
  asm("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes to global memory, evict-first: the output is not read again
__device__ __forceinline__ void st_v4(int* p, const int (&v)[4]) {
  asm volatile("st.global.cs.v4.s32 [%0], {%1, %2, %3, %4};\n"
               :
               : "l"(p), "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3])
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t* dst, const uint32_t* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :
               : "r"((uint32_t)__cvta_generic_to_shared(dst)), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async16(uint32_t* dst, const uint32_t* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"((uint32_t)__cvta_generic_to_shared(dst)), "l"(src), "r"(bytes)
               : "memory");
}

// Tile t's query and corpus tile: query tiles fastest, so the CTAs of one
// wave share corpus tiles
__device__ __forceinline__ int tile_q(int t, int nq, int nx) { return t % nq; }
__device__ __forceinline__ int tile_x(int t, int nq, int nx) { return t / nq; }

// Where a tile's row r lies in a staging buffer: queries first, then the
// corpus rows in slab order.
__device__ __forceinline__ int staged_row(int r) {
  return r < kTileQ ? r : kTileQ + (((r - kTileQ) & ~31) | slab_row((r - kTileQ) & 31));
}

// Start copying words [w0, w0 + kw) of a tile's query and corpus rows into
// a staging buffer, as one cp.async group; words past w and rows past B or
// M are zero-filled.  `vec`: w % 4 == 0 and q, x 16-byte aligned.
__device__ __forceinline__ void stage(const uint32_t* __restrict__ q,
                                      const uint32_t* __restrict__ x, uint32_t* buf, int b0,
                                      int m0, int B, int M, int w, int w0, int kw, int stride,
                                      bool vec) {
  const int per_row = vec ? kw / 4 : kw;  // copies per row
  const int dr = kThreads / per_row, du = kThreads - dr * per_row;
  int r = threadIdx.x / per_row, u = threadIdx.x - r * per_row;
  while (r < kRows) {
    const int word = vec ? 4 * u : u;
    const bool is_q = r < kTileQ;
    const int gr = is_q ? b0 + r : m0 + r - kTileQ;
    const bool ok = gr < (is_q ? B : M) && w0 + word < w;
    const uint32_t* src = ok ? (is_q ? q : x) + (size_t)gr * w + w0 + word : q;
    uint32_t* dst = buf + staged_row(r) * stride + word;
    if (vec)
      cp_async16(dst, src, ok ? 16 : 0);
    else
      cp_async4(dst, src, ok ? 4 : 0);
    r += dr;  // the next copy, kThreads further on
    u += du;
    if (u >= per_row) {
      u -= per_row;
      ++r;
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
hamming_kernel(const uint32_t* __restrict__ q, const uint32_t* __restrict__ x,
               int* __restrict__ out, int B, int M, int w, int nq, int nx, int vec) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int steps = (w + 7) / 8;  // k-steps over a whole row
  const int chunks = (steps + kChunkSteps - 1) / kChunkSteps;
  const int stride = 8 * min(steps, kChunkSteps) + 4;  // words between staged rows
  uint32_t* bufs[2] = {smem, smem + kRows * stride};   // [kRows][stride] each

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wq = warp % kWarpsQ, wx = warp / kWarpsQ;
  const int g = lane >> 2, tig = lane & 3;
  // ldmatrix row offsets: A rows 0-15 at words 0-3 / 4-7; B tiles j, j+1
  // (8 staged rows each) at words 0-3 / 4-7
  const int qa = (wq * 16 * kMT + (lane & 15)) * stride + (lane >> 4) * 4;
  const int xb = (kTileQ + wx * 32 + (lane >> 4) * 8 + (lane & 7)) * stride + ((lane >> 3) & 1) * 4;

  // stage s is chunk s % chunks of this CTA's tile s / chunks; the CTA
  // walks tiles with stride gridDim.x
  const int n_stages = (nq * nx - blockIdx.x + gridDim.x - 1) / gridDim.x * chunks;
  auto start = [&](int s) {
    const int tile = blockIdx.x + (s / chunks) * gridDim.x;
    const int c = s % chunks;
    stage(q, x, bufs[s & 1], tile_q(tile, nq, nx) * kTileQ, tile_x(tile, nq, nx) * kTileX, B, M,
          w, 8 * kChunkSteps * c, 8 * min(kChunkSteps, steps - kChunkSteps * c), stride, vec);
  };
  start(0);
  int acc[kMT][4][4];
  for (int s = 0; s < n_stages; ++s) {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    // stage s has landed for every thread, and every warp is done with
    // stage s - 1's buffer
    __syncthreads();
    if (s + 1 < n_stages) start(s + 1);  // overlaps this stage's MMAs and stores
    const int tile = blockIdx.x + (s / chunks) * gridDim.x;
    const int c = s % chunks;
    const int kc = min(kChunkSteps, steps - kChunkSteps * c);
    const uint32_t* buf = bufs[s & 1];
    if (c == 0) {
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mt][j][i] = 0;
    }
    for (int ks = 0; ks < kc; ++ks) {
      uint32_t bf[4][2];
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        uint32_t r[4];
        ldmatrix_x4(r, buf + xb + jp * 16 * stride + ks * 8);
        bf[2 * jp][0] = r[0];
        bf[2 * jp][1] = r[1];
        bf[2 * jp + 1][0] = r[2];
        bf[2 * jp + 1][1] = r[3];
      }
      uint32_t a[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) ldmatrix_x4(a[mt], buf + qa + mt * 16 * stride + ks * 8);
      // popc(q ^ x) = popc(q & ~x) + popc(~q & x): the first term on every
      // tile, then the second, so no MMA waits on the one before it
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_and_popc(acc[mt][j], a[mt], ~bf[j][0], ~bf[j][1]);
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        const uint32_t na[4] = {~a[mt][0], ~a[mt][1], ~a[mt][2], ~a[mt][3]};
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_and_popc(acc[mt][j], na, bf[j][0], bf[j][1]);
      }
    }
    if (c < chunks - 1) continue;

    // epilogue: quads g and g ^ 1 trade halves, so that 8 lanes write one
    // row's 128 bytes in one 16-byte-a-lane store: the even row, then the odd
    const int b0 = tile_q(tile, nq, nx) * kTileQ, m0 = tile_x(tile, nq, nx) * kTileX;
    const bool whole = (M & 3) == 0 && b0 + kTileQ <= B && m0 + kTileX <= M;
    const int odd = g & 1;
    const int col = m0 + wx * 32 + 16 * odd + 4 * tig;
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        // this lane's row g (+ 8 hh): columns 16 sh + 4 tig + {0, 1, 2, 3}
        // are n = 2 tig + (i & 1) of tiles j = 2 sh + (i >> 1)
        int v[2][4], got[4];
#pragma unroll
        for (int sh = 0; sh < 2; ++sh)
#pragma unroll
          for (int i = 0; i < 4; ++i) v[sh][i] = acc[mt][2 * sh + (i >> 1)][2 * hh + (i & 1)];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          got[i] = __shfl_xor_sync(0xffffffffu, odd ? v[0][i] : v[1][i], 4);
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const int b = b0 + wq * 16 * kMT + mt * 16 + (g & ~1) + p + 8 * hh;
          int* dst = out + (size_t)b * M + col;
          int d[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) d[i] = p == odd ? v[p][i] : got[i];
          if (whole) {
            st_v4(dst, d);
          } else if (b < B) {
#pragma unroll
            for (int i = 0; i < 4; ++i)
              if (col + i < M) dst[i] = d[i];
          }
        }
      }
    }
  }
}

}  // namespace

extern "C" int bq_hamming(const void* q, const void* x, void* out, int B, int M, int w,
                          void* stream) {
  const int nq = (B + kTileQ - 1) / kTileQ, nx = (M + kTileX - 1) / kTileX;
  const long long tiles = (long long)nq * nx;
  if (B < 1 || M < 1 || w < 1 || tiles > INT_MAX) return (int)cudaErrorInvalidValue;
  const int steps = (w + 7) / 8;
  const int stride = 8 * (steps < kChunkSteps ? steps : kChunkSteps) + 4;
  const size_t smem = (size_t)2 * kRows * stride * sizeof(uint32_t);
  cudaError_t e = cudaFuncSetAttribute(hamming_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, hamming_kernel, kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  // one resident wave of persistent CTAs
  const int grid = tiles < (long long)sms * per_sm ? (int)tiles : sms * per_sm;
  const int vec = (w & 3) == 0 && ((uintptr_t)q & 15) == 0 && ((uintptr_t)x & 15) == 0;
  hamming_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)q, (const uint32_t*)x, (int*)out, B, M, w, nq, nx, vec);
  return (int)cudaGetLastError();
}
