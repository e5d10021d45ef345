// Kernel 6: the leaf probe's stage 1 for Hopper (sm_90a): the centroid
// product, its affine, the valid mask and the per-tree top-L in one pass,
// so the [B, T·nb] score matrix is never written.
//
// For each query b and probe tree t, over the tree's blocks j < nb:
//
//   score[b, t, j] = scale · Σ_d f32(q[b, d]) · f32(cent[t·nb + j, d])
//                    − caux[t·nb + j],   −inf where !valid[t·nb + j],
//
// and out[b, t·L + r] = t·nb + (the r-th best j): the L best blocks of
// each (query, tree) in descending score, equal scores in ascending j,
// exactly `torch.topk(score, L, sorted=True)` with that tie rule.  Where
// a tree has fewer than L valid blocks, the rest of its ids are invalid
// blocks of that tree (their score is −inf), the lowest first.
//
// Replaces no Pallas kernel: the JAX package leaves this stage to XLA
// (`arroy_tpu/probe.py` `_rank_blocks`: the f32 `jnp.dot`, the affine,
// `jnp.where` and `lax.top_k`); the port's plain version is
// `ops.rank_select.rank_blocks_reference` (an f32 GEMM with TF32 off,
// three elementwise passes over the [B, T·nb] scores and `torch.topk`).
//
// What bounds it on this card: the f32 FFMA rate.  2·B·T·nb·d operations
// at 67 TFLOP/s against the bytes it must move (the centroids, caux and
// the mask once, the queries once, [B, T·L] ids written): at the probe
// cell's shape (B = 2048, T = 8, nb ≈ 23.1k, d = 100, L = 25) 75.8 GFLOP
// are 1.13 ms and 75 MB are 0.02 ms.  The products stay in f32 FFMA (no
// TF32, bf16 or tensor-core emulation): the block set must be the plain
// version's up to the summation order.  An NVIDIA H100 80GB HBM3 at
// 700 W runs a bare FFMA loop at 61 TFLOP/s; the product here runs at
// ~55% of the peak (8 × 8 and 8 × 16 register tiles, 16- and 32-deep
// slices, two and three stages and two CTAs an SM all measured alike;
// PERF.md §6).  On the probe cell's own tables (8 trees of 29,568
// blocks: a 1.45 ms bound) the product takes 2.79 ms of the kernel's
// 4.32, the copies and barriers 0.5 and the select 1.0.
//
// Design.  A CTA of 256 threads takes 128 queries and one tree (or one of
// S column ranges of it, `rank_select_splits`, where there are too few
// (query tile, tree) pairs to fill the card) and walks the tree's
// centroids 128 at a time:
//
// - product: a SIMT register-tiled GEMM.  A tile's depth streams through
//   a two-stage ring of 32-deep slices of the queries and the centroids,
//   loaded with 16-byte `cp.async` (4-byte copies where d % 4 != 0) into
//   rows of 36 floats while the previous slice is computed; each thread
//   holds an 8 × 8 micro-tile of dots in registers (queries ty + 16·i,
//   centroids tx + 16·j: a warp's 16-byte reads of 4 depths hit distinct
//   banks), summed over d in order with `fmaf`.  A ragged depth (d = 100)
//   runs 4 deep in the last slice, zero-filled past d.  The tile's caux
//   and mask are read under its first slice into shared memory.
// - select, in the tile's epilogue: each score is tested against its
//   query's running L-th score (a threshold in shared memory, NaN until L
//   blocks are held, so everything passes then), a row of 8 at once by
//   its largest: three operations a score against d FFMAs.  The few that
//   pass go to the query's buffer (an atomic slot a key; as many keys as
//   shared memory holds beside the heaps, up to a tile's 128); then a
//   thread a query folds up to kSmall keys into the query's min-heap of L
//   keys (replace the root, sift down), and where at most 16 queries are
//   busier (a query whose own cluster's blocks the tile holds sends most
//   of them: on the probe cell's clustered corpus a thread's sift-downs
//   in a row held the CTA), all threads fold them at once, ranking each
//   query's heap and buffer keys against each other (more busy queries,
//   as in the first tiles, are folded by their threads); each sets the
//   new threshold, the root's score.  A key is (ordered score << 32 | ~j): keys are distinct
//   and their order is the output's order.  Later tiles hold higher j, so
//   a score equal to the threshold loses and is not sent.  Where a buffer
//   fills, the tile's remaining scores are tested again against the new
//   threshold, in rounds, each thread remembering in a bitmask which of
//   its 64 scores are already in.
// - a range stops L blocks past its last valid block (a tree's valid
//   blocks come first, and the top-L takes invalid blocks only where it
//   holds fewer than L valid ones), so a tree's padding to nb costs no
//   product.
// - the CTA writes its L keys a query, unsorted, to a [B, T, S, L]
//   scratch; a second launch, a warp a (query, tree), takes the L largest
//   of its S·L keys in order (L rounds of a warp max) and writes the ids.
//
// Interface: plain C, pointers and the stream as void*, returns
// cudaGetLastError() after the launches (cudaErrorInvalidValue for an L
// past kMaxL or an empty shape).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 128;  // queries a CTA
constexpr int kBN = 128;  // centroids a tile
constexpr int kKC = 32;   // depth of a ring stage
constexpr int kRow = kKC + 4;  // floats a row of a stage: 16-byte rows, conflict-free reads
constexpr int kStageFloats = (kBQ + kBN) * kRow;
constexpr int kMaxL = 128;  // the route stops at `ops.rank_select.MAX_L` = 64
constexpr int kMaxSplits = 32;  // column ranges a tree at most
constexpr float kWaveFill = 0.9f;  // share of its last wave a plan must fill
constexpr int kMaxDevices = 64;
constexpr int kMaxCap = 128;  // keys a query's buffer holds between merges, at most
constexpr int kSmall = 4;     // a query with more keys to fold is busy (`merge_block`)
constexpr int kMaxBusy = 16;  // busy queries folded together at most
constexpr int kPerThread = 10;  // keys a thread ranks in `merge_block`
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block may use (sm_90)
constexpr int kMergeWarps = 4;

typedef unsigned long long u64;

__device__ __forceinline__ unsigned ordered(float s) {
  const unsigned u = __float_as_uint(s);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float unordered(unsigned o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool pred) {
  const unsigned sa = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(sa), "l"(src),
               "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool pred) {
  const unsigned sa = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(sa), "l"(src),
               "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Dynamic shared memory of the scan for L and a buffer of `cap` keys a
// query: the heaps and the buffers (u64), then the ring, the thresholds,
// the tile's column terms, the buffer counts, the busy queries, the two
// overflow flags, the two busy counts and the range's last valid block.
__host__ __device__ constexpr size_t scan_smem(int L, int cap) {
  return sizeof(u64) * (size_t)(L + cap) * kBQ + sizeof(float) * (2 * kStageFloats + kBQ + kBN) +
         sizeof(int) * (2 * kBQ + 5);
}

// The largest buffer (at most kMaxCap) that fits beside the rest at L.
__host__ __device__ constexpr int scan_cap(int L) {
  const size_t rest = scan_smem(L, 0);
  const int fit = rest >= (size_t)kMaxSmem ? 0 : (int)((kMaxSmem - rest) / (sizeof(u64) * kBQ));
  return fit < kMaxCap ? fit : kMaxCap;
}

struct Scan {
  u64* heap;    // [L][kBQ]: a min-heap of L keys a query, 0 for an empty slot
  u64* buf;     // [cap][kBQ]
  float* ring;  // [2][kStageFloats]: queries [kBQ][kRow], then centroids [kBN][kRow]
  float* thr;   // [kBQ]
  float* cx;    // [kBN]: the tile's caux, +inf where not valid
  int* cnt;     // [kBQ]
  int* busy;    // [kBQ]: the queries a warp folds this round
  int* ovf;     // [2]
  int* nbusy;   // [2]
  int* lastv;   // [1]
};

__device__ __forceinline__ void set_threshold(const Scan& s, int r, u64 root) {
  s.thr[r] = root == 0 ? __int_as_float(0x7fffffff) : unordered(static_cast<unsigned>(root >> 32));
}

// Fold query r's n buffered keys into its heap (replace the least and sift
// down); set its threshold.  One thread.
__device__ __forceinline__ void merge_query(const Scan& s, int r, int L, int n) {
  s.cnt[r] = 0;
  if (n == 0) return;
  u64* h = s.heap + r;
  u64 root = h[0];
  for (int i = 0; i < n; ++i) {
    const u64 c = s.buf[i * kBQ + r];
    if (c <= root) continue;
    int pos = 0;
    for (int ch = 1; ch < L; ch = 2 * pos + 1) {
      u64 cv = h[ch * kBQ];
      if (ch + 1 < L) {
        const u64 c2 = h[(ch + 1) * kBQ];
        if (c2 < cv) {
          cv = c2;
          ++ch;
        }
      }
      if (cv >= c) break;
      h[pos * kBQ] = cv;
      pos = ch;
    }
    h[pos * kBQ] = c;
    root = h[0];
  }
  set_threshold(s, r, root);
}

// Fold the buffers of the busy queries (at most kMaxBusy, each with a
// full heap) with every thread of the CTA: each of a query's m = L + n
// keys (distinct) is ranked against all of them by one thread, and the L
// best are written back in ascending order, which is a min-heap; the
// new root's score is the query's threshold.  A query that sends most of
// a tile (a tile in its own cluster's blocks) costs ~m²/256 compares a
// thread, not n sift-downs in a row on one thread.  Ends in a barrier.
__device__ __forceinline__ void merge_block(const Scan& s, int nbusy, int L, int cap, int tid) {
  int off[kMaxBusy + 1];
  off[0] = 0;
#pragma unroll
  for (int b = 0; b < kMaxBusy; ++b)
    off[b + 1] = off[b] + (b < nbusy ? L + min(s.cnt[s.busy[b]], cap) : 0);
  u64 key[kPerThread];
  int rank[kPerThread], slot[kPerThread];
#pragma unroll
  for (int u = 0; u < kPerThread; ++u) {
    const int g = tid + kThreads * u;
    slot[u] = -1;
    rank[u] = 0;
    key[u] = 0;
    if (g >= off[kMaxBusy]) continue;
    int b = 0;
#pragma unroll
    for (int c = 1; c < kMaxBusy; ++c) b += g >= off[c];
    const int r = s.busy[b], m = off[b + 1] - off[b], e = g - off[b];
    const u64* h = s.heap + r;
    const u64* bq = s.buf + r;
    const u64 k = e < L ? h[e * kBQ] : bq[(e - L) * kBQ];
    int above = 0;
    for (int f = 0; f < L; ++f) above += h[f * kBQ] > k;
    for (int f = 0; f < m - L; ++f) above += bq[f * kBQ] > k;
    key[u] = k;
    rank[u] = above;
    slot[u] = r;
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < kPerThread; ++u) {
    if (slot[u] < 0 || rank[u] >= L) continue;
    s.heap[(L - 1 - rank[u]) * kBQ + slot[u]] = key[u];
    if (rank[u] == L - 1) set_threshold(s, slot[u], key[u]);
  }
  if (tid < nbusy) s.cnt[s.busy[tid]] = 0;
  __syncthreads();
}

// Four depths of the micro-tile: 8 queries (rows ty + 16·i) and 8
// centroids (tx + 16·j), a 16-byte read each, 256 FFMAs.
__device__ __forceinline__ void depth4(const float* as, const float* bs, int k, int ty, int tx,
                                       float (&acc)[8][8]) {
  float4 a[8], b[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) a[i] = *reinterpret_cast<const float4*>(as + (ty + 16 * i) * kRow + k);
#pragma unroll
  for (int j = 0; j < 8; ++j) b[j] = *reinterpret_cast<const float4*>(bs + (tx + 16 * j) * kRow + k);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
      acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
      acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
      acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
    }
}

// Send the micro-tile's scores that pass their row's threshold to the
// rows' buffers: strictly in a tile's first pass (a later j loses a tie),
// not strictly in the rounds after a buffer filled (the merge orders the
// tile's own keys); `stored` marks the scores already sent.
__device__ __forceinline__ void send(const Scan& s, const float (&acc)[8][8], const float (&cx)[8],
                                     unsigned colok, u64& stored, bool strict, int flag, int cap,
                                     float scale, int q0, int B, int col0, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = ty + 16 * i;
    if (q0 + r >= B) continue;
    const float th = s.thr[r];
    float sc[8];
    float top = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      sc[j] = __fsub_rn(__fmul_rn(scale, acc[i][j]), cx[j]);
      top = fmaxf(top, sc[j]);
    }
    if (strict && top <= th) continue;  // the row's best loses (false while th is NaN)
    unsigned pass = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const bool p = ((colok >> j) & 1u) && !((stored >> (i * 8 + j)) & 1ull) &&
                     (strict ? !(sc[j] <= th) : !(sc[j] < th));
      pass |= (p ? 1u : 0u) << j;
    }
    if (!pass) continue;
    int pos = atomicAdd(s.cnt + r, __popc(pass));
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (!((pass >> j) & 1u)) continue;
      if (pos < cap) {
        s.buf[pos * kBQ + r] =
            (static_cast<u64>(ordered(sc[j])) << 32) | static_cast<unsigned>(~(col0 + tx + 16 * j));
        stored |= 1ull << (i * 8 + j);
      } else {
        s.ovf[flag] = 1;
      }
      ++pos;
    }
  }
}

// kVec: d % 4 == 0 and 16-byte aligned tables, so a row's 4 floats come in
// one 16-byte copy; else in four 4-byte copies.
template <bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
    rank_select_kernel_scan(const float* __restrict__ q, const float* __restrict__ cent,
                            const float* __restrict__ caux, const unsigned char* __restrict__ valid,
                            float scale, int B, int d, int nb, int L, int cps, int cap,
                            u64* __restrict__ part) {
  extern __shared__ __align__(16) unsigned char smem[];
  Scan s;
  s.heap = reinterpret_cast<u64*>(smem);
  s.buf = s.heap + (size_t)L * kBQ;
  s.ring = reinterpret_cast<float*>(s.buf + (size_t)cap * kBQ);
  s.thr = s.ring + 2 * kStageFloats;
  s.cx = s.thr + kBQ;
  s.cnt = reinterpret_cast<int*>(s.cx + kBN);
  s.busy = s.cnt + kBQ;
  s.ovf = s.busy + kBQ;
  s.nbusy = s.ovf + 2;
  s.lastv = s.nbusy + 2;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kBQ;
  const int t = blockIdx.y;
  const int S = gridDim.z;
  const int cbeg = blockIdx.z * cps;
  const size_t tree0 = (size_t)t * nb;

  for (int i = tid; i < L * kBQ; i += kThreads) s.heap[i] = 0;
  if (tid < kBQ) {
    s.thr[tid] = __int_as_float(0x7fffffff);  // NaN: the heap is not full
    s.cnt[tid] = 0;
  }
  if (tid < 2) s.ovf[tid] = s.nbusy[tid] = 0;
  if (tid == 0) *s.lastv = cbeg - 1;
  __syncthreads();
  // the range ends at its last valid block, and L blocks past it at most
  // (the invalid blocks the top-L takes where it holds fewer than L
  // valid ones): a tree's padding costs no product
  {
    int last = cbeg - 1;
    const int hi = min(cbeg + cps, nb);
#pragma unroll 4
    for (int c = cbeg + tid; c < hi; c += kThreads)
      if (valid[tree0 + c]) last = c;
    if (last >= cbeg) atomicMax(s.lastv, last);
  }
  __syncthreads();
  const int cend = min(min(cbeg + cps, nb), *s.lastv + 1 + L);

  const int ntiles = cend > cbeg ? (cend - cbeg + kBN - 1) / kBN : 0;
  const int nchunks = (d + kKC - 1) / kKC;
  const int nsteps = ntiles * nchunks;

  // compute geometry: 4 x 8 threads a warp, 4 x 2 warps; rows ty + 16·i,
  // columns tx + 16·j
  const int warp = tid >> 5, lane = tid & 31;
  const int ty = (warp >> 1) * 4 + (lane >> 3);
  const int tx = (warp & 1) * 8 + (lane & 7);
  const float* tree_cent = cent + (size_t)t * nb * d;

  // a slice: 4 floats of depth a copy, kKC / 4 copies a row, rows (and
  // centroids) spread over the threads
  auto issue = [&](int step) {
    const int tile = step / nchunks;
    const int col0 = cbeg + tile * kBN;
    float* as = s.ring + (step & 1) * kStageFloats;
    float* bs = as + kBQ * kRow;
#pragma unroll
    for (int e = tid; e < kBQ * kKC / 4; e += kThreads) {
      const int r = e / (kKC / 4), lq = e % (kKC / 4);
      const int k = (step - tile * nchunks) * kKC + 4 * lq;
      const bool qin = q0 + r < B, cin = col0 + r < cend;
      const float* qs = q + (size_t)(q0 + r) * d + k;
      const float* cs = tree_cent + (size_t)(col0 + r) * d + k;
      if (kVec) {
        cp_async16(as + r * kRow + 4 * lq, qin && k < d ? qs : q, qin && k < d);
        cp_async16(bs + r * kRow + 4 * lq, cin && k < d ? cs : cent, cin && k < d);
      } else {
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const bool kin = k + x < d;
          cp_async4(as + r * kRow + 4 * lq + x, qin && kin ? qs + x : q, qin && kin);
          cp_async4(bs + r * kRow + 4 * lq + x, cin && kin ? cs + x : cent, cin && kin);
        }
      }
    }
    cp_async_commit();
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  int round = 0;
  if (nsteps > 0) issue(0);
  for (int step = 0; step < nsteps; ++step) {
    const int tile = step / nchunks;
    const int chunk = step - tile * nchunks;
    const int col0 = cbeg + tile * kBN;
    cp_async_wait_all();
    __syncthreads();
    if (step + 1 < nsteps) issue(step + 1);
    // the tile's column terms: read under its first slice, stored after it
    float cxv = INFINITY;
    if (chunk == 0 && tid < kBN && col0 + tid < cend) {
      const float a = __ldg(caux + tree0 + col0 + tid);
      cxv = valid[tree0 + col0 + tid] ? a : INFINITY;
    }
    const float* as = s.ring + (step & 1) * kStageFloats;
    const float* bs = as + kBQ * kRow;
    const int kn = min(kKC, d - chunk * kKC);
    if (kn == kKC) {
#pragma unroll 1
      for (int k = 0; k < kKC; k += 4) depth4(as, bs, k, ty, tx, acc);
    } else {
      for (int k = 0; k < kn; k += 4) depth4(as, bs, k, ty, tx, acc);
    }
    if (chunk == 0 && tid < kBN) s.cx[tid] = cxv;
    if (chunk != nchunks - 1) continue;
    if (nchunks == 1) __syncthreads();

    // the tile's select: a first pass, then a round more while a buffer
    // was full; queries with more than kSmall keys and a full heap are
    // busy, folded by the whole CTA while they are few (round numbers run
    // on across tiles: the flag and the busy count of round r + 1 are
    // reset in round r)
    float cx[8];
    unsigned colok = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      cx[j] = s.cx[tx + 16 * j];
      colok |= (col0 + tx + 16 * j < cend ? 1u : 0u) << j;
    }
    u64 stored = 0;
    for (bool first = true;; first = false, ++round) {
      const int par = round & 1;
      send(s, acc, cx, colok, stored, first, par, cap, scale, q0, B, col0, ty, tx);
      __syncthreads();
      const int over = s.ovf[par];
      if (tid == 0) s.ovf[par ^ 1] = s.nbusy[par ^ 1] = 0;
      if (tid < kBQ && q0 + tid < B) {
        const int n = min(s.cnt[tid], cap);
        if (n > kSmall && s.heap[tid] != 0)
          s.busy[atomicAdd(s.nbusy + par, 1)] = tid;
        else
          merge_query(s, tid, L, n);
      }
      __syncthreads();
      // a few busy queries: the whole CTA; more: each its own thread
      // again, all at once
      const int nbusy = s.nbusy[par];
      if (nbusy > kMaxBusy) {
        if (tid < kBQ && q0 + tid < B && s.cnt[tid]) merge_query(s, tid, L, min(s.cnt[tid], cap));
        __syncthreads();
      } else if (nbusy) {
        merge_block(s, nbusy, L, cap, tid);
      }
      if (!over) {
        ++round;
        break;
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
  __syncthreads();
  if (tid < kBQ && q0 + tid < B) {
    u64* dst = part + (((size_t)(q0 + tid) * gridDim.y + t) * S + blockIdx.z) * L;
    for (int j = 0; j < L; ++j) dst[j] = s.heap[j * kBQ + tid];
  }
}

// A warp a (query, tree): the L largest of its n = S·L keys, in order.
__global__ void __launch_bounds__(32 * kMergeWarps)
    rank_select_kernel_merge(const u64* __restrict__ part, long long* __restrict__ out, int B,
                             int T, int nb, int L, int n) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long pair = (long long)blockIdx.x * kMergeWarps + warp;
  if (pair >= (long long)B * T) return;
  const int t = static_cast<int>(pair % T);
  u64* ks = reinterpret_cast<u64*>(smem) + (size_t)warp * n;
  const u64* src = part + (size_t)pair * n;
  for (int i = lane; i < n; i += 32) ks[i] = src[i];
  __syncwarp();
  long long* dst = out + (size_t)pair * L;  // out[b, t·L + r]: (b·T + t)·L + r
  for (int r = 0; r < L; ++r) {
    u64 best = 0;
    int at = -1;
    for (int i = lane; i < n; i += 32) {
      const u64 v = ks[i];
      if (v > best) {
        best = v;
        at = i;
      }
    }
    u64 m = best;
#pragma unroll
    for (int off = 16; off; off >>= 1) {
      const u64 o = __shfl_xor_sync(0xffffffffu, m, off);
      m = o > m ? o : m;
    }
    if (at >= 0 && best == m) ks[at] = 0;  // keys are distinct: one lane holds m
    __syncwarp();
    if (lane == 0) {
      const int j = m ? static_cast<int>(~static_cast<unsigned>(m)) : 0;
      dst[r] = (long long)t * nb + j;
    }
  }
}

// S: the fewest column ranges of whole tiles, none of them empty, whose
// CTAs (query tiles × T × S) fill at least kWaveFill of their last wave of
// `slots` CTA slots; where no S up to kMaxSplits (and the tree's tiles)
// does, the S that fills most, the fewest among equals.
int plan_splits(int B, int T, int nb, int slots) {
  const int tiles = (nb + kBN - 1) / kBN;
  const long long pairs = (long long)((B + kBQ - 1) / kBQ) * T;
  int best = 1;
  double best_fill = -1.0;
  const int most = tiles < kMaxSplits ? tiles : kMaxSplits;
  for (int s = 1; s <= most; ++s) {
    const int per = (tiles + s - 1) / s;
    if ((tiles + per - 1) / per != s) continue;  // some of s ranges would be empty
    const long long ctas = pairs * s;
    const double fill = (double)ctas / (double)(((ctas + slots - 1) / slots) * slots);
    if (fill >= kWaveFill) return s;
    if (fill > best_fill) {
      best = s;
      best_fill = fill;
    }
  }
  return best;
}

}  // namespace

extern "C" {

// The plan for a card of `sms` SMs holding `per_sm` scan CTAs each.
int rank_select_plan(int B, int T, int nb, int sms, int per_sm, int* splits) {
  if (B < 1 || T < 1 || nb < 1 || sms < 1 || per_sm < 1) return cudaErrorInvalidValue;
  *splits = plan_splits(B, T, nb, sms * per_sm);
  return cudaSuccess;
}

// The plan on the current device at this L (its SMs and the scan CTAs one
// SM holds at L, asked once a device and L).
int rank_select_splits(int B, int T, int nb, int L, int* splits) {
  static int slots[kMaxDevices][kMaxL + 1];
  if (L < 1 || L > kMaxL) return cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (slots[dev][L] == 0) {
    int sms = 0, per_sm = 0;
    const size_t smem = scan_smem(L, scan_cap(L));
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaFuncSetAttribute(rank_select_kernel_scan<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, rank_select_kernel_scan<true>, kThreads,
                                                  smem);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    slots[dev][L] = (sms > 1 ? sms : 1) * (per_sm > 1 ? per_sm : 1);
  }
  *splits = plan_splits(B, T, nb, slots[dev][L]);
  return cudaSuccess;
}

// q [B, d] f32, cent [T·nb, d] f32, caux [T·nb] f32, valid [T·nb] bool;
// S column ranges a tree (`rank_select_splits`); part: a [B, T, S, L] u64
// scratch; out [B, T·L] int64.
int rank_select(const float* q, const float* cent, const float* caux, const unsigned char* valid,
                float scale, int B, int d, int T, int nb, int L, int S, u64* part,
                long long* out, void* stream) {
  if (L < 1 || L > kMaxL || B < 1 || d < 1 || T < 1 || nb < L || S < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int cap = scan_cap(L);
  if (cap < 1 || kMaxBusy * (L + cap) > kThreads * kPerThread) return cudaErrorInvalidValue;
  const int tiles = (nb + kBN - 1) / kBN;
  const int cps = (tiles + S - 1) / S * kBN;  // columns a range
  const size_t smem = scan_smem(L, cap);
  const dim3 grid((B + kBQ - 1) / kBQ, T, S);
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(cent) % 16 == 0;
  auto kernel = vec ? rank_select_kernel_scan<true> : rank_select_kernel_scan<false>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  kernel<<<grid, kThreads, smem, st>>>(q, cent, caux, valid, scale, B, d, nb, L, cps, cap, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = S * L;
  const size_t msmem = sizeof(u64) * (size_t)n * kMergeWarps;
  cudaFuncSetAttribute(rank_select_kernel_merge, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(msmem));
  const long long pairs = (long long)B * T;
  const unsigned blocks = static_cast<unsigned>((pairs + kMergeWarps - 1) / kMergeWarps);
  rank_select_kernel_merge<<<blocks, 32 * kMergeWarps, msmem, st>>>(part, out, B, T, nb, L, n);
  return cudaGetLastError();
}

}  // extern "C"
