// Issue rate of two mma.sync shapes on the card, for choosing how kernel 2
// (arroy_tpu_torch/csrc/hamming.cu) counts bits:
//   op 0: mma.sync m16n8k256 .b1 with .and.popc (32,768 bit products each)
//   op 1: mma.sync m16n8k32 .s8 (4,096 multiply-adds each)
// Each warp runs `iters` rounds of kChains independent MMAs on operands
// held in registers, so only the tensor cores' issue rate is timed.  Built
// and timed by scripts/torch_hamming_tune.py.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChains = 8;  // independent accumulators per warp

template <int kOp>
__global__ void mma_loop(int iters, int* out) {
  const uint32_t seed = threadIdx.x * 0x9E3779B9u + blockIdx.x;
  uint32_t a[4] = {seed, seed ^ 0x5bd1e995u, seed * 3u, ~seed};
  uint32_t b[2] = {seed + 7u, seed ^ 0xdeadbeefu};
  int c[kChains][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int k = 0; k < kChains; ++k) {
      if (kOp == 0) {
        asm volatile(
            "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
            : "+r"(c[k][0]), "+r"(c[k][1]), "+r"(c[k][2]), "+r"(c[k][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
      } else {
        asm volatile(
            "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
            : "+r"(c[k][0]), "+r"(c[k][1]), "+r"(c[k][2]), "+r"(c[k][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
      }
    }
  }
  int s = 0;
#pragma unroll
  for (int k = 0; k < kChains; ++k) s += c[k][0] + c[k][1] + c[k][2] + c[k][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

}  // namespace

// MMAs issued by one launch: blocks * threads / 32 * iters * kChains.
extern "C" int mma_rate(int op, int blocks, int threads, int iters, void* out, void* stream) {
  if (op == 0)
    mma_loop<0><<<blocks, threads, 0, (cudaStream_t)stream>>>(iters, (int*)out);
  else
    mma_loop<1><<<blocks, threads, 0, (cudaStream_t)stream>>>(iters, (int*)out);
  return (int)cudaGetLastError();
}

extern "C" int mma_chains() { return kChains; }
