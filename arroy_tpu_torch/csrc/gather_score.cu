// Leaf-probe stage 2 for Hopper (sm_90a): score the selected blocks.
//   dot[b, c, p] = sum_d f32(rows[bid[b, c], p, d]) * q[b, d]     (f32)
// and writes the stage's in-block score of it, [B, C, P] f32 (the epilogue):
//   s = dot * scale[blk, p]         (int8 rows)
//   s = s / max(aux[blk, p], 1e-30)  (cosine) | 2 s - aux[blk, p]  (euclidean) | s  (dot)
//   s = -inf where blk is -1, slots[blk, p] is -1 or fmask[slot] is 0
// each op rounded on its own in f32 (no contracted FMA), so the score is
// bit-equal to the same chain run as PyTorch ops on the dots.
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
// - The schedule is a counting sort (below) on the whole card: a
//   histogram of the ids in device memory by atomics, an exclusive scan of
//   it in tiles of kScanTile bins (one launch sums each tile, the next
//   adds the earlier tiles' sums and scans its own), then a thread a pair
//   scatters it: every id is read twice in all, however many blocks there
//   are (0.03 ms at the probe cell's 409,600 pairs over 236,544 blocks).
//   The caller asks for it only where the call is large enough to repay
//   it; without it the pairs are scored in query order.  CTAs of 4
//   warps, a grid of (slice, span of 4 row groups), keep the card full
//   when a call holds few pairs.
// - The epilogue reads a row's aux, slot, scale and filter byte once per
//   block read (512 bytes a block of 64 rows beside 12.8 KB of bf16 rows
//   at d = 100) and writes the score after the row's last chunk of d, so
//   the probe writes only the [B, C, P] scores: no gathers of aux and
//   slots, no elementwise passes, and one launch for the whole [B, T*L]
//   selection where the temporaries fit.
// On an NVIDIA H100 80GB HBM3 at 700 W, at the slice's B = 256, C = 72
// (f32: 36): int8 0.28 ms, bf16 and f32 0.47 ms, against 0.19 and 0.38 ms
// of bytes bound; at the probe cell's B = 2048, C = 200, d = 100 (bf16,
// cosine epilogue) 3.1 ms against 0.69 (PERF.md).  Sums are f32 FMAs in
// another order than PyTorch's, so dots differ from the plain version by
// rounding only; the epilogue adds no rounding of its own.
//
// Int8 rows convert exactly to f32; the per-item dequant scale multiplies
// the dot afterwards, in the epilogue, as the JAX package does.  Block ids
// outside [0, nbt) read no rows: their scores are -inf.  The dots
// themselves are the "dot" op's scores with every slot live.
//
// Interface: plain C, pointers and the stream as void*, returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a row
// type / vector width the kernel has no instance for, or an unknown
// epilogue op, cudaErrorInvalidConfiguration for B*C past 2^31 - 1).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;        // warps per scoring CTA
constexpr int kSlice = 32;       // scheduled pairs per CTA, one a lane
constexpr int kLaneRegs = 48;    // registers of row data a lane holds
constexpr int kScanThreads = 1024;                // threads of a scan CTA
constexpr int kScanTile = 4 * kScanThreads;       // bins a scan CTA takes, 4 a thread
// epilogue ops (`ops.gather_score.OPS`)
constexpr int kDot = 0, kCosine = 1, kEuclidean = 2;
constexpr float kEps = static_cast<float>(1e-30);  // cosine's floor, as PyTorch casts it

// What the kernel writes after a row's dot.
// aux, slots [nbt, P]; scale [nbt, P] or null; fmask [cap] or null.
struct Epilogue {
  int op;
  const float* aux;
  const int* slots;
  const float* scale;
  const unsigned char* fmask;
};

// The score of a dot: each op rounded on its own, as PyTorch's chain of
// elementwise ops rounds it (no contracted multiply-add).
__device__ __forceinline__ float finish(const Epilogue& ep, float v, float aux, float scale,
                                        bool dead) {
  if (dead) return __uint_as_float(0xff800000u);  // -inf
  if (ep.scale) v = __fmul_rn(v, scale);
  if (ep.op == kEuclidean) return __fsub_rn(__fmul_rn(2.f, v), aux);
  if (ep.op == kCosine) return __fdiv_rn(v, aux < kEps ? kEps : aux);  // clamp keeps a NaN
  return v;
}

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
// slice, blockIdx.y the span of kWarps row groups the CTA scores.  `ep`
// says which score is written after the row's last chunk of d.
template <typename T, int VB>
__global__ void __launch_bounds__(kWarps * 32)
gather_score_kernel(const T* __restrict__ rows, const int* __restrict__ keys,
                    const int* __restrict__ pairs, const float* __restrict__ q,
                    float* __restrict__ out, int n, int C, int P, int d, int nbt,
                    const Epilogue ep) {
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
      // the row whose sum this lane writes, and its epilogue terms, read
      // once for the whole run; loaded ahead of the rows, and not looked
      // at before the rows' loads are in flight
      const int row = p0 + lane / (32 / R);
      const bool writer = lane % (32 / R) == 0 && row < P;
      int slot = -1;  // -1: no live slot (also a block id outside [0, nbt))
      float aux = 0.f, scale = 1.f;
      if (writer && ok) {
        const size_t at = static_cast<size_t>(blk) * P + row;
        slot = __ldg(ep.slots + at);
        aux = __ldg(ep.aux + at);
        if (ep.scale) scale = __ldg(ep.scale + at);
      }
      bool dead = true;
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
        if (v0 == 0)  // the filter byte's load waits on the slot
          dead = slot < 0 || (ep.fmask && !__ldg(ep.fmask + slot));
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
          if (writer) {
            float* o = out + static_cast<size_t>(pr) * P + row;
            float v = v0 == 0 ? sum : *o + sum;
            if (v0 + 32 * NV >= nvec) v = finish(ep, v, aux, scale, dead);
            *o = v;
          }
        }
      }
    }
  }
}

// The schedule is a counting sort over the whole card.  First the ids of
// each block are counted (`first` [nbt + 1] zeroed beforehand; first[nbt]
// counts the ids outside [0, nbt), which go last), a thread an id.
__global__ void __launch_bounds__(256)
block_count_kernel(const int* __restrict__ bid, int n, int nbt, int* __restrict__ first) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= n) return;
  const int key = __ldg(bid + i);
  atomicAdd(first + (key >= 0 && key < nbt ? key : nbt), 1);
}

// The inclusive sum of x over a CTA of kScanThreads threads, and the CTA's
// total in *total; `part` is kScanThreads / 32 ints of shared memory.
__device__ __forceinline__ int cta_scan(int x, int* part, int* total) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
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
  x += warp ? part[warp - 1] : 0;
  *total = part[kScanThreads / 32 - 1];
  __syncthreads();  // part is free again
  return x;
}

// Then the counts of each tile of kScanTile bins are summed, a CTA a tile
// (m = nbt + 1 bins) ...
__global__ void __launch_bounds__(kScanThreads)
block_tile_sum_kernel(const int* __restrict__ first, int m, int* __restrict__ tile_sum) {
  __shared__ int part[kScanThreads / 32];
  const int i0 = blockIdx.x * kScanTile + 4 * threadIdx.x;
  int sum = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) sum += i0 + j < m ? first[i0 + j] : 0;
  int total;
  cta_scan(sum, part, &total);
  if (threadIdx.x == 0) tile_sum[blockIdx.x] = total;
}

// ... and each tile's CTA adds the sums of the tiles before it and turns
// its counts into first positions in place (an exclusive scan).
__global__ void __launch_bounds__(kScanThreads)
block_first_kernel(int* __restrict__ first, int m, const int* __restrict__ tile_sum) {
  __shared__ int part[kScanThreads / 32];
  int before = 0, total;
  for (int j = threadIdx.x; j < static_cast<int>(blockIdx.x); j += kScanThreads)
    before += tile_sum[j];
  cta_scan(before, part, &total);
  const int base = total;
  const int i0 = blockIdx.x * kScanTile + 4 * threadIdx.x;
  int c[4], sum = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    c[j] = i0 + j < m ? first[i0 + j] : 0;
    sum += c[j];
  }
  int pos = base + cta_scan(sum, part, &total) - sum;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (i0 + j < m) first[i0 + j] = pos;
    pos += c[j];
  }
}

// Last, one thread a pair takes the next position of its id (an atomic on
// `first`; the order of the pairs within one block is whatever the atomics
// give, and each pair's score does not depend on it) and writes the id and
// its flat index there.
__global__ void __launch_bounds__(256)
block_scatter_kernel(const int* __restrict__ bid, int n, int nbt, int* __restrict__ first,
                     int* __restrict__ keys, int* __restrict__ pairs) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= n) return;
  const int key = __ldg(bid + i);
  const int at = atomicAdd(first + (key >= 0 && key < nbt ? key : nbt), 1);
  keys[at] = key;
  pairs[at] = i;
}

// scratch: first [nbt + 1] then the tile sums [ceil((nbt + 1) / kScanTile)],
// int32 (`ops.gather_score.schedule_words`)
int schedule(const void* bid, int n, int nbt, void* keys, void* pairs, void* scratch,
             cudaStream_t stream) {
  const int m = nbt + 1;
  const int tiles = (m + kScanTile - 1) / kScanTile;
  int* first = static_cast<int*>(scratch);
  int* tile_sum = first + m;
  const int* ids = static_cast<const int*>(bid);
  const cudaError_t e = cudaMemsetAsync(first, 0, sizeof(int) * static_cast<size_t>(m), stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int grid = (n + 255) / 256;
  block_count_kernel<<<grid, 256, 0, stream>>>(ids, n, nbt, first);
  block_tile_sum_kernel<<<tiles, kScanThreads, 0, stream>>>(first, m, tile_sum);
  block_first_kernel<<<tiles, kScanThreads, 0, stream>>>(first, m, tile_sum);
  block_scatter_kernel<<<grid, 256, 0, stream>>>(ids, n, nbt, first, static_cast<int*>(keys),
                                                 static_cast<int*>(pairs));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VB>
int launch(const void* rows, const void* keys, const void* pairs, const void* q, void* out,
           int n, int C, int P, int d, int nbt, const Epilogue& ep, cudaStream_t stream) {
  const int ngroups = (P + Rows<T>::value - 1) / Rows<T>::value;
  const dim3 grid((n + kSlice - 1) / kSlice, (ngroups + kWarps - 1) / kWarps);
  gather_score_kernel<T, VB><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(rows), static_cast<const int*>(keys), static_cast<const int*>(pairs),
      static_cast<const float*>(q), static_cast<float*>(out), n, C, P, d, nbt, ep);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_vec(int vec_bytes, const void* rows, const void* keys, const void* pairs,
                 const void* q, void* out, int n, int C, int P, int d, int nbt,
                 const Epilogue& ep, cudaStream_t s) {
  switch (vec_bytes) {
    case 16: return launch<T, 16>(rows, keys, pairs, q, out, n, C, P, d, nbt, ep, s);
    case 8: return launch<T, 8>(rows, keys, pairs, q, out, n, C, P, d, nbt, ep, s);
    case 4: return launch<T, 4>(rows, keys, pairs, q, out, n, C, P, d, nbt, ep, s);
  }
  if constexpr (sizeof(T) <= 2)
    if (vec_bytes == 2) return launch<T, 2>(rows, keys, pairs, q, out, n, C, P, d, nbt, ep, s);
  if constexpr (sizeof(T) == 1)
    if (vec_bytes == 1) return launch<T, 1>(rows, keys, pairs, q, out, n, C, P, d, nbt, ep, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// The block schedule alone: keys [n] int32 (the ids of bid [n] sorted,
// those outside [0, nbt) last) and pairs [n] int32 (the index in bid of
// each), n < 2^31, with `scratch` as `schedule` lays it out.
extern "C" int gather_schedule(const void* bid, int n, int nbt, void* keys, void* pairs,
                               void* scratch, void* stream) {
  return schedule(bid, n, nbt, keys, pairs, scratch, static_cast<cudaStream_t>(stream));
}

// row_type: 0 = f32, 1 = bf16, 2 = int8.  Shapes: rows [nbt, P, d],
// bid [B, C] int32, q [B, d] f32 (16-byte aligned), out [B, C, P] f32, all
// contiguous.  scratch: 2 B*C + schedule_words(nbt) int32 for the
// schedule; with it null, the pairs are scored in query order (no block
// is shared).  op: 0 dot, 1 cosine, 2 euclidean, from aux and slots
// [nbt, P] f32 and int32, scale [nbt, P] f32 (int8 rows) or null, and
// fmask [cap] bytes or null.
extern "C" int gather_score(int row_type, int vec_bytes, const void* rows, const void* bid,
                            const void* q, void* out, int B, int C, int P, int d, int nbt,
                            void* stream, void* scratch, int op, const void* aux,
                            const void* slots, const void* scale, const void* fmask) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long nl = static_cast<long long>(B) * C;
  if (nl > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  if (op != kDot && op != kCosine && op != kEuclidean)
    return static_cast<int>(cudaErrorInvalidValue);
  const Epilogue ep{op, static_cast<const float*>(aux), static_cast<const int*>(slots),
                    static_cast<const float*>(scale), static_cast<const unsigned char*>(fmask)};
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
    case 0:
      return dispatch_vec<float>(vec_bytes, rows, keys, pairs, q, out, n, C, P, d, nbt, ep, s);
    case 1:
      return dispatch_vec<unsigned short>(vec_bytes, rows, keys, pairs, q, out, n, C, P, d, nbt,
                                          ep, s);
    case 2:
      return dispatch_vec<signed char>(vec_bytes, rows, keys, pairs, q, out, n, C, P, d, nbt,
                                       ep, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
