// Leaf-probe stage 2 for Hopper (sm_90a): score the selected blocks.
//   out[b, c, p] = sum_d f32(rows[bid[b, c], p, d]) * q[b, d]     (f32, [B, C, P])
//
// Replaces: arroy_tpu/ops/pallas_probe.py, gather_score
// (_gather_score_kernel), the TPU Pallas kernel.  The JAX package serves
// the same function as an XLA gather `blk_rows[bid]` (a [B, C, P, d]
// tensor in device memory) followed by an einsum; this kernel never
// writes the gathered rows anywhere.
//
// What bounds it on this card: memory.  Every row element takes one FMA
// against the query, about 2 flops per element: 1 flop per byte for bf16
// rows, far below the ~295 flops per byte where the card stops being
// memory-bound.  On the probe slice (262,144 x 768, search_k 4000) a
// 256-query batch selects C = 72 blocks of P = 64 rows per query, 18,432
// (query, block) pairs of which 12,891 are distinct blocks: 1.8 GB of
// bf16 rows, 1.27 GB of them in distinct blocks, against 4.7 MB of output.
//
// What the design does about it:
// - Each distinct block is read once.  The schedule lists the B*C pairs
//   sorted by block id (`keys`, with the flat pair index b*C + c beside
//   each in `pairs`).  A CTA takes a slice of kSlice = 32 scheduled
//   pairs, one per lane; a ballot finds the runs of equal block ids in it.
//   For each run, a warp loads R rows of the block into registers once and
//   scores them against every query of the run.  A block chosen by many
//   queries spans several slices, so a hot block is shared by several
//   CTAs, each reading it once; a run split by a slice edge is read twice.
// - No lane idles: the caller picks the load width so that a row is a
//   multiple of 32 vectors where one exists (an int8 row of 768 is 96
//   vectors of 8 bytes, 3 a lane, where 16-byte loads would leave half the
//   lanes idle for a third of the row), else the widest width dividing
//   the row and the base (a bf16 row of 100 is 200 bytes, 8-byte vectors).
// - Int8 without a conversion instruction (I2F issues at a fraction of the
//   FMA rate): each word is XORed with 0x80808080 at load, so a byte holds
//   s + 128; `prmt` puts that byte under the exponent of 2^23, which is the
//   float 2^23 + s + 128 exactly, and one FADD of -(2^23 + 128) leaves s.
//   The constant stays inside each term, so the dot has no cancellation.
//   bf16 is the high half of an f32 (a shift or a mask).
// - A lane holds kLaneRegs = 48 registers of row data: R = 8 int8, 4 bf16
//   or 2 f32 rows of d = 768.  Longer rows go in chunks, each chunk's
//   partial dots added into the output by the lane that wrote it.  The R
//   row sums are reduced across the warp transposed (9 shuffles for 8 rows).
// - The schedule is a counting sort (below): one CTA counts the ids and
//   writes their first positions, then a thread a pair scatters it there,
//   two launches before the scoring (~0.012 ms).  The caller asks for it
//   only where the call is large enough to repay it; without it the pairs
//   are scored in query order.  CTAs of 4 warps, a grid of (slice, span
//   of 4 row groups), keep the card full when a call holds few pairs, as
//   the probe's chunks of C do.
// On an NVIDIA H100 80GB HBM3 at 700 W, at the slice's B = 256, C = 72
// (f32: 36): int8 0.28 ms, bf16 and f32 0.47 ms, against 0.19 and 0.38 ms
// of bytes bound (PERF.md).  Sums are f32 FMAs in another order than
// PyTorch's, so results differ from the plain version by rounding only.
//
// Int8 rows convert exactly to f32; the caller applies the per-item
// dequant scale after the dot, as the JAX package does.  Block ids
// outside [0, nbt) produce 0 (a bounds guard; the caller clamps them).
//
// Interface: plain C, pointers and the stream as void*, returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a row
// type / vector width the kernel has no instance for,
// cudaErrorInvalidConfiguration for B*C past 2^31 - 1).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;        // warps per scoring CTA
constexpr int kSlice = 32;       // scheduled pairs per CTA, one a lane
constexpr int kLaneRegs = 48;    // registers of row data a lane holds
constexpr int kSortThreads = 1024;
constexpr int kMaxBins = 53248;  // block ids the schedule counts per pass (208 KB)
constexpr int kKeysInFlight = 16;  // ids a schedule thread loads at once

template <typename T> struct Rows;  // rows a warp scores together
template <> struct Rows<float> { static constexpr int value = 2; };
template <> struct Rows<unsigned short> { static constexpr int value = 4; };
template <> struct Rows<signed char> { static constexpr int value = 8; };

template <int VB> struct Vec { unsigned w[VB >= 4 ? VB / 4 : 1]; };

template <int VB>
__device__ __forceinline__ Vec<VB> load_vec(const unsigned char* p) {
  Vec<VB> r;
  if constexpr (VB == 16) {
    const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
    r.w[0] = t.x; r.w[1] = t.y; r.w[2] = t.z; r.w[3] = t.w;
  } else if constexpr (VB == 8) {
    const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
    r.w[0] = t.x; r.w[1] = t.y;
  } else if constexpr (VB == 4) {
    r.w[0] = __ldg(reinterpret_cast<const unsigned*>(p));
  } else if constexpr (VB == 2) {
    r.w[0] = __ldg(reinterpret_cast<const unsigned short*>(p));
  } else {
    r.w[0] = __ldg(p);
  }
  return r;
}

// element k of a loaded word as an exact f32
template <typename T> __device__ __forceinline__ float elem(unsigned w, int k);
template <> __device__ __forceinline__ float elem<float>(unsigned w, int) {
  return __uint_as_float(w);
}
template <> __device__ __forceinline__ float elem<unsigned short>(unsigned w, int k) {
  return __uint_as_float(k ? (w & 0xffff0000u) : (w << 16));
}
// the word was XORed with 0x80808080 at load: byte k is s + 128
template <> __device__ __forceinline__ float elem<signed char>(unsigned w, int k) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540u + k)) - 8388736.0f;
}

template <int VE>
__device__ __forceinline__ void load_q(const float* p, float (&qv)[VE]) {
  if constexpr (VE % 4 == 0) {
#pragma unroll
    for (int j = 0; j < VE / 4; ++j) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(p) + j);
      qv[4 * j] = t.x; qv[4 * j + 1] = t.y; qv[4 * j + 2] = t.z; qv[4 * j + 3] = t.w;
    }
  } else if constexpr (VE % 2 == 0) {
#pragma unroll
    for (int j = 0; j < VE / 2; ++j) {
      const float2 t = __ldg(reinterpret_cast<const float2*>(p) + j);
      qv[2 * j] = t.x; qv[2 * j + 1] = t.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < VE; ++j) qv[j] = __ldg(p + j);
  }
}

// The R row sums of a warp's partial dots, transposed as they are summed:
// each step trades half the rows with the lane `o` away, so R rows take
// log2(R) + log2(32 / R) shuffles in all (9 for R = 8, not 5 R = 40).
// Afterwards lane l holds the sum of row l / (32 / R).
template <int R>
__device__ __forceinline__ float row_sums(float (&a)[R], int lane) {
#pragma unroll
  for (int w = R, o = 16; w > 1; w /= 2, o /= 2) {
    const bool hi = lane & o;
#pragma unroll
    for (int i = 0; i < w / 2; ++i) {
      const float send = hi ? a[i] : a[i + w / 2];
      const float keep = hi ? a[i + w / 2] : a[i];
      a[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
    }
  }
  float v = a[0];
#pragma unroll
  for (int o = 16 / R; o > 0; o /= 2) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// T: float (f32), unsigned short (bf16 bits) or signed char (int8).
// VB: bytes per vector load; d * sizeof(T) and the base are multiples of VB.
// keys [n]: block ids in schedule order; pairs [n]: flat pair index b*C + c
// of each (null: the identity, i.e. keys is bid itself).  blockIdx.x is the
// slice, blockIdx.y the span of kWarps row groups the CTA scores.
template <typename T, int VB>
__global__ void __launch_bounds__(kWarps * 32)
gather_score_kernel(const T* __restrict__ rows, const int* __restrict__ keys,
                    const int* __restrict__ pairs, const float* __restrict__ q,
                    float* __restrict__ out, int n, int C, int P, int d, int nbt) {
  constexpr int R = Rows<T>::value;
  constexpr int NW = VB >= 4 ? VB / 4 : 1;                // words per vector
  constexpr int NV = kLaneRegs / (R * NW) > 0 ? kLaneRegs / (R * NW) : 1;  // vectors a lane holds per row
  constexpr int VE = VB / static_cast<int>(sizeof(T));   // elements per vector
  constexpr int EW = VB >= 4 ? 4 / static_cast<int>(sizeof(T)) : VE;  // elements per word
  constexpr unsigned flip = sizeof(T) == 1 ? 0x80808080u : 0u;  // int8: s -> s + 128
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;

  // this CTA's slice of the schedule, one pair a lane, and its runs
  const int s0 = blockIdx.x * kSlice;
  const int ns = min(kSlice, n - s0);
  const int key = lane < ns ? keys[s0 + lane] : -1;
  const int pair = lane < ns ? (pairs ? pairs[s0 + lane] : s0 + lane) : 0;
  const int prev = __shfl_up_sync(0xffffffffu, key, 1);
  const unsigned starts = __ballot_sync(0xffffffffu, lane < ns && (lane == 0 || prev != key));

  const int nvec = d / VE;
  const int g0 = blockIdx.y * kWarps;
  const int g1 = min(g0 + kWarps, (P + R - 1) / R);
  const size_t row_bytes = static_cast<size_t>(d) * sizeof(T);
  int unit = 0;  // (run, row group) units, dealt to the warps in turn
  for (unsigned m = starts; m; m &= m - 1) {
    const int r0 = __ffs(m) - 1;
    const unsigned later = m & (m - 1);
    const int r1 = later ? __ffs(later) - 1 : ns;
    const int blk = __shfl_sync(0xffffffffu, key, r0);
    const bool ok = blk >= 0 && blk < nbt;
    for (int g = g0; g < g1; ++g, ++unit) {
      if (unit % kWarps != warp) continue;
      const int p0 = g * R;
      const unsigned char* base = reinterpret_cast<const unsigned char*>(rows)
          + (static_cast<size_t>(ok ? blk : 0) * P + p0) * row_bytes;
      for (int v0 = 0; v0 < nvec; v0 += 32 * NV) {
        // the group's rows, once: R rows x NV vectors a lane
        unsigned w[R][NV][NW];
#pragma unroll
        for (int i = 0; i < R; ++i) {
#pragma unroll
          for (int j = 0; j < NV; ++j) {
            const int v = v0 + 32 * j + lane;
            const bool in = ok && p0 + i < P && v < nvec;
            const Vec<VB> t = in ? load_vec<VB>(base + i * row_bytes + static_cast<size_t>(v) * VB)
                                 : Vec<VB>{};
#pragma unroll
            for (int k = 0; k < NW; ++k) w[i][j][k] = t.w[k] ^ flip;
          }
        }
        // ... scored against every query of the run
        for (int s = r0; s < r1; ++s) {
          const int pr = __shfl_sync(0xffffffffu, pair, s);
          const float* qb = q + static_cast<size_t>(pr / C) * d;
          float acc[R];
#pragma unroll
          for (int i = 0; i < R; ++i) acc[i] = 0.f;
#pragma unroll
          for (int j = 0; j < NV; ++j) {
            const int v = v0 + 32 * j + lane;
            if (v < nvec) {
              float qv[VE];
              load_q<VE>(qb + static_cast<size_t>(v) * VE, qv);
#pragma unroll
              for (int i = 0; i < R; ++i) {
#pragma unroll
                for (int e = 0; e < VE; ++e)
                  acc[i] = fmaf(elem<T>(w[i][j][e / EW], e % EW), qv[e], acc[i]);
              }
            }
          }
          const float sum = row_sums<R>(acc, lane);
          const int row = p0 + lane / (32 / R);
          if (lane % (32 / R) == 0 && row < P) {
            float* o = out + static_cast<size_t>(pr) * P + row;
            *o = v0 == 0 ? sum : *o + sum;
          }
        }
      }
    }
  }
}

// The schedule is a counting sort in two launches.  First, one CTA counts
// the n = B*C block ids in shared memory, in passes of kMaxBins ids (one
// pass up to 53,248 blocks), and writes each id's first position
// (`first` [nbt + 1]; first[nbt] is where the ids outside [0, nbt) go).
__global__ void __launch_bounds__(kSortThreads)
count_kernel(const int* __restrict__ bid, int n, int nbt, int* __restrict__ first) {
  extern __shared__ int bins[];
  __shared__ int part[kSortThreads / 32];
  __shared__ int base;
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  if (t == 0) base = 0;
  __syncthreads();
  for (int k0 = 0; k0 < nbt; k0 += kMaxBins) {
    const int nb = min(kMaxBins, nbt - k0);
    for (int i = t; i < nb; i += kSortThreads) bins[i] = 0;
    __syncthreads();
    for (int i0 = t; i0 < n; i0 += kSortThreads * kKeysInFlight) {
      int key[kKeysInFlight];  // loaded together; an id past n reads as -1
#pragma unroll
      for (int j = 0; j < kKeysInFlight; ++j) {
        const int i = i0 + j * kSortThreads;
        key[j] = i < n ? __ldg(bid + i) : -1;
      }
#pragma unroll
      for (int j = 0; j < kKeysInFlight; ++j) {
        const unsigned k = static_cast<unsigned>(key[j]) - static_cast<unsigned>(k0);
        if (k < static_cast<unsigned>(nb)) atomicAdd(&bins[k], 1);
      }
    }
    __syncthreads();
    // exclusive scan: each thread a span of ids, then the threads' sums
    const int span = (nb + kSortThreads - 1) / kSortThreads;
    const int lo = min(t * span, nb), hi = min(lo + span, nb);
    int sum = 0;
    for (int i = lo; i < hi; ++i) sum += bins[i];
    int x = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) part[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int p = part[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, p, o);
        if (lane >= o) p += y;
      }
      part[lane] = p;
    }
    __syncthreads();
    int pos = base + x - sum + (warp ? part[warp - 1] : 0);
    for (int i = lo; i < hi; ++i) {
      const int c = bins[i];
      bins[i] = pos;
      pos += c;
    }
    __syncthreads();
    for (int i = t; i < nb; i += kSortThreads) first[k0 + i] = bins[i];  // coalesced
    __syncthreads();
    if (t == 0) base += part[31];
    __syncthreads();
  }
  if (t == 0) first[nbt] = base;
}

// Then one thread a pair takes the next position of its id (an atomic on
// `first`; the order of the pairs within one block is whatever the atomics
// give, and each pair's dot does not depend on it) and writes the id and
// its flat index there.
__global__ void __launch_bounds__(256)
scatter_kernel(const int* __restrict__ bid, int n, int nbt, int* __restrict__ first,
               int* __restrict__ keys, int* __restrict__ pairs) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= n) return;
  const int key = __ldg(bid + i);
  const int at = atomicAdd(first + (key >= 0 && key < nbt ? key : nbt), 1);
  keys[at] = key;
  pairs[at] = i;
}

// first: [nbt + 1] int32 scratch
int schedule(const void* bid, int n, int nbt, void* keys, void* pairs, void* first,
             cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(int)) * (nbt < 1 ? 1 : nbt < kMaxBins ? nbt : kMaxBins);
  const cudaError_t e = cudaFuncSetAttribute(
      count_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);  // for this device
  if (e != cudaSuccess) return static_cast<int>(e);
  count_kernel<<<1, kSortThreads, smem, stream>>>(static_cast<const int*>(bid), n, nbt,
                                                  static_cast<int*>(first));
  scatter_kernel<<<(n + 255) / 256, 256, 0, stream>>>(
      static_cast<const int*>(bid), n, nbt, static_cast<int*>(first), static_cast<int*>(keys),
      static_cast<int*>(pairs));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VB>
int launch(const void* rows, const void* keys, const void* pairs, const void* q, void* out,
           int n, int C, int P, int d, int nbt, cudaStream_t stream) {
  const int ngroups = (P + Rows<T>::value - 1) / Rows<T>::value;
  const dim3 grid((n + kSlice - 1) / kSlice, (ngroups + kWarps - 1) / kWarps);
  gather_score_kernel<T, VB><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(rows), static_cast<const int*>(keys), static_cast<const int*>(pairs),
      static_cast<const float*>(q), static_cast<float*>(out), n, C, P, d, nbt);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_vec(int vec_bytes, const void* rows, const void* keys, const void* pairs,
                 const void* q, void* out, int n, int C, int P, int d, int nbt, cudaStream_t s) {
  switch (vec_bytes) {
    case 16: return launch<T, 16>(rows, keys, pairs, q, out, n, C, P, d, nbt, s);
    case 8: return launch<T, 8>(rows, keys, pairs, q, out, n, C, P, d, nbt, s);
    case 4: return launch<T, 4>(rows, keys, pairs, q, out, n, C, P, d, nbt, s);
  }
  if constexpr (sizeof(T) <= 2)
    if (vec_bytes == 2) return launch<T, 2>(rows, keys, pairs, q, out, n, C, P, d, nbt, s);
  if constexpr (sizeof(T) == 1)
    if (vec_bytes == 1) return launch<T, 1>(rows, keys, pairs, q, out, n, C, P, d, nbt, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// The block schedule alone: keys [n] int32 (the ids of bid [n] sorted) and
// pairs [n] int32 (the index in bid of each), n < 2^31, with first
// [nbt + 1] int32 scratch.
extern "C" int gather_schedule(const void* bid, int n, int nbt, void* keys, void* pairs,
                               void* first, void* stream) {
  return schedule(bid, n, nbt, keys, pairs, first, static_cast<cudaStream_t>(stream));
}

// row_type: 0 = f32, 1 = bf16, 2 = int8.  Shapes: rows [nbt, P, d],
// bid [B, C] int32, q [B, d] f32 (16-byte aligned), out [B, C, P] f32, all
// contiguous.  scratch: 2 B*C + nbt + 1 int32 for the schedule; with it
// null, the pairs are scored in query order (no block is shared).
extern "C" int gather_score(int row_type, int vec_bytes, const void* rows, const void* bid,
                            const void* q, void* out, int B, int C, int P, int d, int nbt,
                            void* stream, void* scratch) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long nl = static_cast<long long>(B) * C;
  if (nl > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int n = static_cast<int>(nl);
  const void* keys = bid;
  const void* pairs = nullptr;
  if (scratch) {
    int* k = static_cast<int*>(scratch);
    const int rc = schedule(bid, n, nbt, k, k + n, k + 2 * static_cast<size_t>(n), s);
    if (rc) return rc;
    keys = k;
    pairs = k + n;
  }
  switch (row_type) {
    case 0: return dispatch_vec<float>(vec_bytes, rows, keys, pairs, q, out, n, C, P, d, nbt, s);
    case 1:
      return dispatch_vec<unsigned short>(vec_bytes, rows, keys, pairs, q, out, n, C, P, d, nbt, s);
    case 2:
      return dispatch_vec<signed char>(vec_bytes, rows, keys, pairs, q, out, n, C, P, d, nbt, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
