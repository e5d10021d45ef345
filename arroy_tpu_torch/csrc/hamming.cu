// Binary-quantized distance matrix for Hopper (sm_90a):
//   h[b, m] = sum_w popcount(q[b, w] XOR x[m, w])     (int32, [B, M])
//
// Replaces: arroy_tpu/ops/pallas_kernels.py, bq_hamming_matrix
// (_hamming_kernel), the TPU Pallas kernel.
//
// What bounds it on this card: the [B, M] int32 output.  At the
// main-path shape (B=2048, M=100,000, w=24 words = 768 bits) the kernel
// reads 9.6 MB of corpus and 0.2 MB of queries but writes 819 MB of
// distances; the 4.9 G xor+popcount pairs are cheap next to that write.
//
// What the design does about it: one output per thread, with a tile of
// 8 queries and 32 corpus rows staged in shared memory (rows padded to
// an odd word stride, so the 32 row reads of a warp hit 32 banks).
// Neighbouring threads own neighbouring m, so every warp writes 128
// contiguous bytes of the output.  The sum is an exact integer, so the
// result is bit-equal to the plain PyTorch version.
//
// Interface: plain C, pointers and the stream as void*, returns
// cudaGetLastError() after the launch.  Inputs are the packed sign-bit
// words as int32 bit patterns, contiguous; the wrapper bounds w so the
// tile fits the 48 KB of static-launch shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileM = 32;  // corpus rows per CTA (threadIdx.x)
constexpr int kTileB = 8;   // queries per CTA (threadIdx.y)

__global__ void __launch_bounds__(kTileM * kTileB)
hamming_kernel(const uint32_t* __restrict__ q, const uint32_t* __restrict__ x,
               int* __restrict__ out, int B, int M, int w) {
  extern __shared__ uint32_t smem[];
  const int ws = w | 1;  // odd stride: conflict-free column reads
  uint32_t* xs = smem;                 // [kTileM][ws]
  uint32_t* qs = smem + kTileM * ws;   // [kTileB][ws]

  const int t = threadIdx.y * kTileM + threadIdx.x;
  const int m0 = blockIdx.x * kTileM;
  const int b0 = blockIdx.y * kTileB;

  for (int e = t; e < kTileM * w; e += kTileM * kTileB) {
    const int r = e / w;
    const int c = e % w;
    xs[r * ws + c] = m0 + r < M ? x[(size_t)(m0 + r) * w + c] : 0u;
  }
  for (int e = t; e < kTileB * w; e += kTileM * kTileB) {
    const int r = e / w;
    const int c = e % w;
    qs[r * ws + c] = b0 + r < B ? q[(size_t)(b0 + r) * w + c] : 0u;
  }
  __syncthreads();

  const int m = m0 + threadIdx.x;
  const int b = b0 + threadIdx.y;
  if (m >= M || b >= B) return;
  const uint32_t* xr = xs + threadIdx.x * ws;
  const uint32_t* qr = qs + threadIdx.y * ws;
  int h = 0;
  for (int c = 0; c < w; ++c) h += __popc(qr[c] ^ xr[c]);
  out[(size_t)b * M + m] = h;
}

}  // namespace

extern "C" int bq_hamming(const void* q, const void* x, void* out, int B, int M,
                          int w, void* stream) {
  dim3 block(kTileM, kTileB);
  dim3 grid((M + kTileM - 1) / kTileM, (B + kTileB - 1) / kTileB);
  const size_t smem = (size_t)(kTileM + kTileB) * (w | 1) * sizeof(uint32_t);
  hamming_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)q, (const uint32_t*)x, (int*)out, B, M, w);
  return (int)cudaGetLastError();
}
