// Exact-engine stage 2 for Hopper (sm_90a): key cut, candidate gather,
// exact f32 re-score and top-k, one launch a batch.
//
//   cut (entry `cut_rescore`): the top c of kernel 1's packed keys [B, n2]
//     (descending; ties at the c-th key broken by the lowest position),
//     cand = pos_to_slot[idxp[sel]], valid iff key > DEAD_KEY_MAX and
//     live[cand];
//   list (entry `rescore_topk`): a [B, c] slot list and its validity mask;
//   then, for both: the exact distance of every valid candidate in f32
//   (euclidean Σ(x − q)²; cosine (1 − clamp(Σx·q / (|x|·|q|), −1, 1)) / 2,
//   0 where |x|·|q| <= f32 epsilon; dot-product −Σx·q), +inf where not
//   valid; the k smallest ascending (ties by the lowest candidate column),
//   ids through slot_to_id, and the distance normalized (NaN where +inf)
//   or raw.
//
// Replaces no Pallas kernel: XLA's fusion of `arroy_tpu/search.py:1702-1719`
// (stage 2 of `_exact_fused_impl`: `lax.top_k` over the keys, `pos_to_slot`,
// `rows[cand]`, `built_distance`, `lax.top_k`, the id lookup and the
// normalization), and the re-score tails of `_exact_f32_direct_impl`
// (:1512), `_exact_f32_impl` (:1266) and `_exact_scan_impl` (:1312).
//
// What bounds it on this card: memory.  Each candidate row is read once
// from the corpus, 2 flops an element against 4 (f32) or 2 (bf16) bytes;
// the keys, positions and queries are read once and [B, k] written.  At
// B = 2048, 2nb = 784, c = 32, d = 768, f32 rows: 12.8 MB of keys and
// positions + 201 MB of rows + 6.3 MB of queries, 0.066 ms at 3.35 TB/s.
// A CTA a query that runs its cut, re-score and sort one after another
// keeps the memory busy only during the re-score (~70 barriers a query);
// the warp regime has no barrier.
//
// Three regimes, chosen by the wrapper (`ops.rescore._plan`) from B, c,
// n2, d and the card's SM count; each is one launch.  The thresholds are
// measured (PERF.md §6, `scripts/torch_rescore_ab.py`):
//
// - warp (c <= 512 and at least 7 queries an SM: every shape the main
//   path sends): a warp a query, several queries a CTA, no CTA barrier.
//   The cut is a radix select over the keys with a 256-bin histogram in
//   the warp's shared memory (four 8-bit passes at most: a pass whose
//   chosen bin holds exactly the keys still to take ends it), then a
//   position-order compaction by ballot and popc, whose slot lookups
//   come after it, all lanes at once.  The top-k is a bitonic sort in
//   registers of the <= 512 composite keys (asc_key(distance) << 32 |
//   column): columns are distinct, so it is the stable order of the
//   distances.
// - block (the rest): a CTA of 8 warps a query, each warp a contiguous
//   range of the columns (past 2 queries an SM, registers for 4 CTAs an
//   SM).  The same radix select over the keys, its compaction one block
//   scan a tile (the keys above the threshold and those equal to it
//   counted in the two halves of one int).  For k <= 128, a radix select
//   of the k-th distance key, the k smallest composites appended in any
//   order, and warp 0's bitonic sort; past it, where k <= c / 2, the
//   select, a compaction in column order, and a stable LSD radix sort of
//   what is kept (of all c otherwise).  Candidates live in shared memory
//   up to the wrapper's `SMEM_CANDIDATES`, past it in a scratch buffer of
//   20 bytes each.
// - split (c >= 2,048 and queries for at most 3/4 of the SMs): S CTAs a
//   query, each re-scoring one slice of the columns (of the positions for
//   the cut, which each CTA selects again over the whole key row: a
//   position's order is its column's) into a [B, W] scratch of composites
//   (W = c, or n2 with the positions the cut did not keep marked ~0).  A
//   per-query ticket, taken after a fence, names the last CTA, which
//   keeps the k smallest composites and sorts them as the block regime
//   does.
//
// The re-score is the same in every regime: a warp takes 32 columns at a
// time, ballots the valid ones and reads NR of their rows at once (16
// bytes a lane a load where the rows and the base allow it: 4 f32 or 8
// bf16, promoted exactly; else one element), 2 loads a row, so 16 loads
// a lane are in flight in the warp regime (NR = 8), 8 or 4 in the block
// regime.  Lane l sums elements l, l + 32, ... of each row in that order,
// and a butterfly of shuffles adds the 32 partial sums, so a distance is
// bit-equal in every regime and every run.
//
// Interface: plain C, pointers and the stream as void*, returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a metric,
// row type or regime the kernel has no instance for).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // block and split regimes: == the radix's bins
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 256;
constexpr int kRowsWarp = 8;      // candidate rows a warp reads at once: warp regime
constexpr int kRowsBlock = 4;     // block and split regimes (256 threads a CTA)
constexpr int kRowsCapped = 2;    // the capped block regime
constexpr int kBlockCtas = 4;     // capped block regime: CTAs an SM its registers allow
constexpr int kWarpMaxC = 512;    // ops.rescore.WARP_MAX_C
constexpr int kWarpExtra = 5120;  // a warp's bytes past its query row (ops.rescore.WARP_SMEM_EXTRA)
constexpr int kSmallK = 128;      // block and split regimes: k sorted by one warp
constexpr unsigned kFull = 0xffffffffu;
constexpr int kDeadKeyMax = (int)0x807fffff;  // ops.fused_select.DEAD_KEY_MAX
constexpr float kF32Eps = 1.1920928955078125e-07f;
constexpr unsigned kInfKey = 0xff800000u;     // asc_key(+inf)
constexpr unsigned long long kNone = ~0ull;   // split scratch: a position the cut did not keep

enum Metric { kEuclidean = 0, kCosine = 1, kDot = 2 };
enum Regime { kWarp = 0, kBlock = 1, kSplit = 2, kBlockCapped = 3 };

struct Args {
  const void* rows;            // [cap, d] f32 or bf16
  const float* norms;          // [cap]
  const long long* slot_to_id; // [cap]
  const float* qv;             // [B, d]
  const float* qn;             // [B]
  const int* keys;             // cut: [B, n2]
  const int* idxp;             // cut: [B, n2]
  const long long* pos_to_slot;  // cut: [Mp]
  const unsigned char* live;   // cut: [cap]
  const long long* cand;       // list: [B, c]
  const unsigned char* valid;  // list: [B, c]
  long long* out_ids;          // [B, k]
  float* out_d;                // [B, k]
  unsigned char* scratch;      // null, or `stride` bytes a query
  int* tickets;                // split: [B], zero
  long long stride;
  int batch, d, n2, c, k, metric, normalize, per_cta, splits;
};

// the shared scratch of a block- or split-regime CTA, past the query row
struct Smem {
  unsigned long long top[kSmallK];  // k <= 128: the k smallest composites, then sorted
  int hist[kBins];             // select histogram / sort bin offsets
  int wcnt[kWarps * kBins];    // sort: per-warp digit counts (kept 0 between tiles)
  int woff[kWarps * kBins];    // sort: per-warp digit offsets of a tile
  int scan[kWarps + 1];        // block scan: warp sums, then the total
  int pick[3];                 // select: the chosen digit, keys still to take, all of its bin
  int last;                    // split: this CTA holds the query's last ticket
  int ntop;                    // k <= 128: composites in `top`
};

__host__ __device__ constexpr size_t align16(size_t n) { return (n + 15) & ~(size_t)15; }

__device__ __forceinline__ unsigned asc_key(float f) {
  unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float asc_float(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

__device__ __forceinline__ unsigned long long composite(unsigned key, int col) {
  return ((unsigned long long)key << 32) | (unsigned)col;
}

// ---------------------------------------------------------------------------
// the re-score
// ---------------------------------------------------------------------------

template <bool EUCLID>
__device__ __forceinline__ float term(float x, float q, float acc) {
  if (EUCLID) {
    const float t = x - q;
    return fmaf(t, t, acc);
  }
  return fmaf(x, q, acc);
}

__device__ __forceinline__ float bf16f(unsigned short h) {
  return __uint_as_float((unsigned)h << 16);
}

// Σ over NR rows at once: lane `lane`'s terms in element order, then the
// butterfly; every lane ends with each row's sum.
template <typename T, bool VEC, bool EUCLID, int NR>
__device__ __forceinline__ void row_sums(const T* (&row)[NR], const float* qs, int d, int lane,
                                         float (&acc)[NR]) {
#pragma unroll
  for (int r = 0; r < NR; ++r) acc[r] = 0.f;
  if (VEC) {
    const float4* q = reinterpret_cast<const float4*>(qs);
    if (sizeof(T) == 4) {
#pragma unroll 2
      for (int v = lane; v < d / 4; v += 32) {
        float4 x[NR];
#pragma unroll
        for (int r = 0; r < NR; ++r) x[r] = __ldg(reinterpret_cast<const float4*>(row[r]) + v);
        const float4 y = q[v];
#pragma unroll
        for (int r = 0; r < NR; ++r) {
          acc[r] = term<EUCLID>(x[r].x, y.x, acc[r]);
          acc[r] = term<EUCLID>(x[r].y, y.y, acc[r]);
          acc[r] = term<EUCLID>(x[r].z, y.z, acc[r]);
          acc[r] = term<EUCLID>(x[r].w, y.w, acc[r]);
        }
      }
    } else {
#pragma unroll 2
      for (int v = lane; v < d / 8; v += 32) {
        uint4 x[NR];
#pragma unroll
        for (int r = 0; r < NR; ++r) x[r] = __ldg(reinterpret_cast<const uint4*>(row[r]) + v);
        const float4 y0 = q[2 * v], y1 = q[2 * v + 1];
#pragma unroll
        for (int r = 0; r < NR; ++r) {
          acc[r] = term<EUCLID>(__uint_as_float(x[r].x << 16), y0.x, acc[r]);
          acc[r] = term<EUCLID>(__uint_as_float(x[r].x & 0xffff0000u), y0.y, acc[r]);
          acc[r] = term<EUCLID>(__uint_as_float(x[r].y << 16), y0.z, acc[r]);
          acc[r] = term<EUCLID>(__uint_as_float(x[r].y & 0xffff0000u), y0.w, acc[r]);
          acc[r] = term<EUCLID>(__uint_as_float(x[r].z << 16), y1.x, acc[r]);
          acc[r] = term<EUCLID>(__uint_as_float(x[r].z & 0xffff0000u), y1.y, acc[r]);
          acc[r] = term<EUCLID>(__uint_as_float(x[r].w << 16), y1.z, acc[r]);
          acc[r] = term<EUCLID>(__uint_as_float(x[r].w & 0xffff0000u), y1.w, acc[r]);
        }
      }
    }
  } else {
#pragma unroll 4
    for (int i = lane; i < d; i += 32) {
      float x[NR];
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        if (sizeof(T) == 4) {
          x[r] = __ldg(reinterpret_cast<const float*>(row[r]) + i);
        } else {
          x[r] = bf16f(__ldg(reinterpret_cast<const unsigned short*>(row[r]) + i));
        }
      }
      const float y = qs[i];
#pragma unroll
      for (int r = 0; r < NR; ++r) acc[r] = term<EUCLID>(x[r], y, acc[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < NR; ++r) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc[r] += __shfl_xor_sync(kFull, acc[r], o);
  }
}

// the distance from a row's sum (`norm`: the row's norm, cosine only)
__device__ __forceinline__ float distance(const Args& a, float s, float norm, float qn) {
  if (a.metric == kEuclidean) return s;
  if (a.metric == kDot) return -s;
  const float pnqn = norm * qn;
  const bool pos = pnqn > kF32Eps;
  float cs = s / (pos ? pnqn : 1.f);
  cs = cs < -1.f ? -1.f : (cs > 1.f ? 1.f : cs);  // NaN stays NaN, as torch.clamp
  return pos ? (1.f - cs) / 2.f : 0.f;
}

// One warp re-scores the valid columns of a 32-column chunk: lane l holds
// column l's slot and validity; the valid ones are read NR at a time (a
// last short group repeats its first row, whose loads then mostly hit in
// cache; cosine's norms are read beside the rows), and lane l calls
// emit(asc_key(distance)) for its own column.
template <typename T, bool VEC, int NR, class Emit>
__device__ __forceinline__ void score_chunk(const Args& a, const float* qs, float qn, int slot,
                                            bool ok, int lane, Emit emit) {
  unsigned m = __ballot_sync(kFull, ok);
  while (m) {
    const int n = __popc(m), first = __ffs(m) - 1;
    int l[NR];
    const T* row[NR];
    float nrm = 0.f;  // cosine: lane r < NR reads row r's norm beside the rows
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      l[r] = r < n ? __ffs(m) - 1 : first;
      if (r < n) m &= m - 1;
      const int sr = __shfl_sync(kFull, slot, l[r]);
      row[r] = reinterpret_cast<const T*>(a.rows) + (size_t)sr * a.d;
      if (a.metric == kCosine && lane == r) nrm = a.norms[sr];
    }
    float acc[NR];
    if (a.metric == kEuclidean) {
      row_sums<T, VEC, true>(row, qs, a.d, lane, acc);
    } else {
      row_sums<T, VEC, false>(row, qs, a.d, lane, acc);
    }
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const float norm = __shfl_sync(kFull, nrm, r);
      if (r < n && lane == l[r]) emit(asc_key(distance(a, acc[r], norm, qn)));
    }
  }
}

// output t of query b: the composite's distance (normalized or raw) and id
__device__ __forceinline__ void write_out(const Args& a, int b, int t, unsigned key, int slot) {
  float dist = asc_float(key);
  if (a.normalize) {
    if (!(dist < __int_as_float(0x7f800000))) {
      dist = __int_as_float(0x7fc00000);  // NaN
    } else if (a.metric == kEuclidean) {
      dist = sqrtf(dist > 0.f ? dist : 0.f);
    } else if (a.metric == kDot) {
      dist = -dist;
    }
  }
  a.out_ids[(size_t)b * a.k + t] = a.slot_to_id[slot];
  a.out_d[(size_t)b * a.k + t] = dist;
}

// ---------------------------------------------------------------------------
// the warp regime
// ---------------------------------------------------------------------------

// sl[j] (j < need) holds a kept position (~position where its key is
// dead); it becomes the position's slot, ~slot where not valid.  Thread t
// of `nt` takes j = t, t + nt, ...
__device__ __forceinline__ void resolve_slots(const Args& a, const int* idxp, int* sl, int need,
                                              int t, int nt) {
#pragma unroll 4
  for (int j = t; j < need; j += nt) {
    const int sv = sl[j];
    const int slot = (int)a.pos_to_slot[__ldg(idxp + (sv >= 0 ? sv : ~sv))];
    sl[j] = sv >= 0 && a.live[slot] ? slot : ~slot;
  }
}

// The cut of query b by one warp: sl[j] (j < c) is the slot of the j-th
// kept position in position order, ~slot where not valid.
__device__ void warp_cut(const Args& a, int b, int* hist, int* sl, int lane) {
  const int n = a.n2, need = a.c;
  const int* keys = a.keys + (size_t)b * n;
  const int* idxp = a.idxp + (size_t)b * n;
  const bool v4 = (n & 3) == 0 && ((size_t)keys & 15) == 0;
  unsigned prefix = 0, pmask = 0;
  int remaining = need;
  for (int shift = 24; shift >= 0; shift -= 8) {
#pragma unroll
    for (int i = 0; i < kBins / 32; ++i) hist[i * 32 + lane] = 0;
    __syncwarp();
    auto count = [&](int key) {
      const unsigned u = (unsigned)key ^ 0x80000000u;
      if ((u & pmask) == prefix) atomicAdd(&hist[(u >> shift) & 255], 1);
    };
    if (v4) {
#pragma unroll 4
      for (int i = lane; i < n / 4; i += 32) {
        const int4 x = __ldg(reinterpret_cast<const int4*>(keys) + i);
        count(x.x);
        count(x.y);
        count(x.z);
        count(x.w);
      }
    } else {
#pragma unroll 4
      for (int i = lane; i < n; i += 32) count(__ldg(keys + i));
    }
    __syncwarp();
    // lane l holds bins 255 - 8l down to 248 - 8l: the counts from the top
    int cnt[8], sum = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      cnt[j] = hist[255 - 8 * lane - j];
      sum += cnt[j];
    }
    int incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += t;
    }
    int acc = incl - sum, pick = -1, rem = 0, all = 0;
    if (acc < remaining && remaining <= incl) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (pick < 0) {
          if (acc + cnt[j] >= remaining) {
            pick = 255 - 8 * lane - j;
            rem = remaining - acc;
            all = cnt[j] == rem;
          }
          acc += cnt[j];
        }
      }
    }
    const int src = __ffs(__ballot_sync(kFull, pick >= 0)) - 1;
    pick = __shfl_sync(kFull, pick, src);
    remaining = __shfl_sync(kFull, rem, src);
    all = __shfl_sync(kFull, all, src);
    prefix |= (unsigned)pick << shift;
    pmask |= 255u << shift;
    __syncwarp();  // the bins are read before the next pass clears them
    if (all) break;  // every key of the chosen bin is kept
  }
  // keep every key above the threshold and the first `remaining` equal to
  // it, in position order, 8 chunks of 32 keys a round (their loads
  // issued together): first the positions (~position for a dead key),
  // then their slots, every lane's lookups at once
  constexpr int kChunks = 8;
  const unsigned below = (1u << lane) - 1;
  int out = 0, eq_seen = 0;
  for (int s0 = 0; s0 < n && out < need; s0 += 32 * kChunks) {
    int key[kChunks];
#pragma unroll
    for (int u = 0; u < kChunks; ++u) {
      const int i = s0 + 32 * u + lane;
      key[u] = i < n ? __ldg(keys + i) : 0;
    }
#pragma unroll
    for (int u = 0; u < kChunks; ++u) {
      const int i = s0 + 32 * u + lane;
      const bool in = i < n;
      const unsigned m = ((unsigned)key[u] ^ 0x80000000u) & pmask;
      const bool gt = in && m > prefix, eq = in && m == prefix;
      const unsigned eqb = __ballot_sync(kFull, eq);
      const bool sel = gt || (eq && eq_seen + __popc(eqb & below) < remaining);
      const unsigned selb = __ballot_sync(kFull, sel);
      if (sel) sl[out + __popc(selb & below)] = key[u] > kDeadKeyMax ? i : ~i;
      out += __popc(selb);
      eq_seen += __popc(eqb);
    }
  }
  __syncwarp();
  resolve_slots(a, idxp, sl, need, lane, 32);
}

// Bitonic sort of 32·R composites, ascending; element e = r·32 + lane is
// v[r] of lane `lane`.
template <int R>
__device__ __forceinline__ void bitonic(unsigned long long (&v)[R], int lane) {
#pragma unroll
  for (int size = 2; size <= 32 * R; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride >= 32) {
        const int rs = stride >> 5;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if ((r & rs) == 0) {
            const bool up = ((r * 32 + lane) & size) == 0;
            const unsigned long long x = v[r], y = v[r | rs];
            if ((x > y) == up) {
              v[r] = y;
              v[r | rs] = x;
            }
          }
        }
      } else {
        const bool lower = (lane & stride) == 0;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const unsigned long long o = __shfl_xor_sync(kFull, v[r], stride);
          const bool up = ((r * 32 + lane) & size) == 0;
          const bool take_min = lower == up;
          v[r] = take_min ? (o < v[r] ? o : v[r]) : (o > v[r] ? o : v[r]);
        }
      }
    }
  }
}

template <int R, bool CUT>
__device__ __forceinline__ void warp_topk(const Args& a, int b, const unsigned* dk,
                                          const int* sl, int lane) {
  unsigned long long v[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int e = r * 32 + lane;
    v[r] = e < a.c ? composite(dk[e], e) : kNone;
  }
  bitonic<R>(v, lane);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int t = r * 32 + lane;
    if (t < a.k) {
      const int col = (int)(unsigned)v[r];
      int slot;
      if (CUT) {
        const int sv = sl[col];
        slot = sv >= 0 ? sv : ~sv;
      } else {
        slot = (int)a.cand[(size_t)b * a.c + col];
      }
      write_out(a, b, t, (unsigned)(v[r] >> 32), slot);
    }
  }
}

template <typename T, bool VEC, bool CUT>
__global__ void __launch_bounds__(kThreads) rescore_kernel_warp(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * a.per_cta + warp;
  if (b >= a.batch) return;
  const int d = a.d, c = a.c;
  const size_t qbytes = align16((size_t)d * 4);
  unsigned char* base = smem + (size_t)warp * (qbytes + kWarpExtra);
  float* qs = reinterpret_cast<float*>(base);
  int* sl = reinterpret_cast<int*>(base + qbytes);  // [512] slots (cut)
  unsigned* dk = reinterpret_cast<unsigned*>(sl + kWarpMaxC);  // [512] distance keys
  int* hist = reinterpret_cast<int*>(dk + kWarpMaxC);  // [256] select histogram

  const float* q = a.qv + (size_t)b * d;
  if ((d & 3) == 0 && ((size_t)q & 15) == 0) {
    for (int i = lane; i < d / 4; i += 32) {
      reinterpret_cast<float4*>(qs)[i] = __ldg(reinterpret_cast<const float4*>(q) + i);
    }
  } else {
    for (int i = lane; i < d; i += 32) qs[i] = q[i];
  }
  if (CUT) warp_cut(a, b, hist, sl, lane);
  __syncwarp();

  const float qn = a.metric == kCosine ? a.qn[b] : 0.f;
  for (int j0 = 0; j0 < c; j0 += 32) {
    const int j = j0 + lane;
    int slot = 0;
    bool ok = false;
    if (j < c) {
      if (CUT) {
        const int sv = sl[j];
        ok = sv >= 0;
        slot = ok ? sv : ~sv;
      } else {
        slot = (int)a.cand[(size_t)b * c + j];
        ok = a.valid[(size_t)b * c + j] != 0;
      }
      if (!ok) dk[j] = kInfKey;
    }
    score_chunk<T, VEC, kRowsWarp>(a, qs, qn, slot, ok, lane, [&](unsigned key) { dk[j] = key; });
  }
  __syncwarp();
  if (c <= 32) {
    warp_topk<1, CUT>(a, b, dk, sl, lane);
  } else if (c <= 64) {
    warp_topk<2, CUT>(a, b, dk, sl, lane);
  } else if (c <= 128) {
    warp_topk<4, CUT>(a, b, dk, sl, lane);
  } else if (c <= 256) {
    warp_topk<8, CUT>(a, b, dk, sl, lane);
  } else {
    warp_topk<16, CUT>(a, b, dk, sl, lane);
  }
}

// ---------------------------------------------------------------------------
// the block and split regimes
// ---------------------------------------------------------------------------

// exclusive block scan of one int a thread; *total gets the sum.  Three
// barriers; `s.scan` is free again when it returns.
__device__ int block_scan(int v, Smem& s, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int t = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += t;
  }
  if (lane == 31) s.scan[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? s.scan[lane] : 0, y = w;
#pragma unroll
    for (int o = 1; o < kWarps; o <<= 1) {
      int t = __shfl_up_sync(kFull, y, o);
      if (lane >= o) y += t;
    }
    if (lane < kWarps) s.scan[lane] = y - w;
    if (lane == kWarps - 1) s.scan[kWarps] = y;
  }
  __syncthreads();
  int r = s.scan[warp] + x - v;
  *total = s.scan[kWarps];
  __syncthreads();
  return r;
}

// Radix select of the `need` largest of n unsigned values (`val(i, u)`
// sets u and returns whether entry i takes part): on return the kept
// values are every u with (u & pmask) > prefix and the first `remaining`
// with (u & pmask) == prefix, which are all of those where `all`.  Four
// 8-bit passes at most.
template <class Val>
__device__ void block_select(Val val, int n, int need, Smem& s, unsigned& prefix,
                             unsigned& pmask, int& remaining, bool& all) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  prefix = 0;
  pmask = 0;
  remaining = need;
  for (int shift = 24; shift >= 0; shift -= 8) {
    s.hist[tid] = 0;
    __syncthreads();
#pragma unroll 4
    for (int i = tid; i < n; i += kThreads) {
      unsigned u;
      if (val(i, u) && (u & pmask) == prefix) atomicAdd(&s.hist[(u >> shift) & 255], 1);
    }
    __syncthreads();
    if (warp == 0) {
      // lane l holds bins 255 - 8l down to 248 - 8l: the counts from the top
      int cnt[8], sum = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        cnt[j] = s.hist[255 - 8 * lane - j];
        sum += cnt[j];
      }
      int incl = sum;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        int t = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += t;
      }
      int acc = incl - sum;
      if (acc < remaining && remaining <= incl) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (acc + cnt[j] >= remaining) {
            s.pick[0] = 255 - 8 * lane - j;
            s.pick[1] = remaining - acc;
            s.pick[2] = cnt[j] == remaining - acc;
            break;
          }
          acc += cnt[j];
        }
      }
    }
    __syncthreads();
    prefix |= (unsigned)s.pick[0] << shift;
    pmask |= 255u << shift;
    remaining = s.pick[1];
    all = s.pick[2];
    if (all) break;  // every value of the chosen bin is kept
  }
  __syncthreads();
}

// The block regime's cut of query b: slots[j] (j < c) is the slot of the
// j-th kept position in position order, ~slot where not valid.  One block
// scan a tile (the keys above the threshold in the low half of an int,
// those equal to it in the high half) keeps the positions; then every
// thread looks its share of slots up at once.
__device__ void block_cut(const Args& a, int b, Smem& s, int* slots) {
  const int tid = threadIdx.x, n = a.n2, need = a.c;
  const int* keys = a.keys + (size_t)b * n;
  const int* idxp = a.idxp + (size_t)b * n;
  unsigned prefix, pmask;
  int remaining;
  bool all;
  block_select(
      [&](int i, unsigned& u) {
        u = (unsigned)__ldg(keys + i) ^ 0x80000000u;
        return true;
      },
      n, need, s, prefix, pmask, remaining, all);
  int out = 0, eq_seen = 0;
  for (int s0 = 0; s0 < n && out < need; s0 += kThreads) {
    const int i = s0 + tid;
    const bool in = i < n;
    const int key = in ? __ldg(keys + i) : 0;
    const unsigned m = ((unsigned)key ^ 0x80000000u) & pmask;
    const bool gt = in && m > prefix, eq = in && m == prefix;
    int tot;
    const int ex = block_scan((int)gt | ((int)eq << 16), s, &tot);
    const int room = remaining - eq_seen > 0 ? remaining - eq_seen : 0;
    const int eqb = ex >> 16;
    if (gt || (eq && eqb < room)) {
      slots[out + (ex & 0xffff) + (eqb < room ? eqb : room)] = key > kDeadKeyMax ? i : ~i;
    }
    out += (tot & 0xffff) + ((tot >> 16) < room ? (tot >> 16) : room);
    eq_seen += tot >> 16;
  }
  __syncthreads();
  resolve_slots(a, idxp, slots, need, tid, kThreads);
  __syncthreads();
}

// Keep the k smallest composites of v[0..n) (ties by the lowest index,
// which is the column order), in place at v[0..k), in index order.
// Entries equal to kNone take no part.  COHERENT reads through L2 only
// (the split regime's scratch, written by other CTAs).
template <bool COHERENT>
__device__ void block_keep(unsigned long long* v, int n, int k, Smem& s) {
  const int tid = threadIdx.x;
  auto load = [&](int i) { return COHERENT ? __ldcg(v + i) : v[i]; };
  unsigned prefix, pmask;
  int remaining;
  bool all;
  block_select(
      [&](int i, unsigned& u) {
        const unsigned long long x = load(i);
        u = ~(unsigned)(x >> 32);
        return x != kNone;
      },
      n, k, s, prefix, pmask, remaining, all);
  int out = 0, eq_seen = 0;
  for (int s0 = 0; s0 < n && out < k; s0 += kThreads) {
    const int i = s0 + tid;
    const unsigned long long x = i < n ? load(i) : kNone;
    const unsigned m = ~(unsigned)(x >> 32) & pmask;
    const bool in = x != kNone;
    const bool gt = in && m > prefix, eq = in && m == prefix;
    int tot;
    // every read of this tile is done before the scan's first barrier, and
    // a kept entry moves to an index at or below its own
    const int ex = block_scan((int)gt | ((int)eq << 16), s, &tot);
    const int room = remaining - eq_seen > 0 ? remaining - eq_seen : 0;
    const int eqb = ex >> 16;
    if (gt || (eq && eqb < room)) v[out + (ex & 0xffff) + (eqb < room ? eqb : room)] = x;
    out += (tot & 0xffff) + ((tot >> 16) < room ? (tot >> 16) : room);
    eq_seen += tot >> 16;
  }
  __syncthreads();
}

// k <= 128: the k smallest composites of v[0..n) (entries equal to kNone
// take no part) into s.top[0..k), sorted ascending.  A radix select of
// the k-th distance key; every composite above it, and at it where all
// of those are kept, appended in any order; else the lowest columns among
// those at it by a second select (columns are distinct, so it keeps
// exactly those it needs); then warp 0 sorts the composites, whose
// columns break the ties, with a bitonic sort.  No scan, no compaction.
template <bool COHERENT>
__device__ void block_small_topk(const unsigned long long* v, int n, int k, Smem& s) {
  const int tid = threadIdx.x, lane = tid & 31;
  auto load = [&](int i) { return COHERENT ? __ldcg(v + i) : v[i]; };
  unsigned prefix, pmask;
  int remaining;
  bool all;
  block_select(
      [&](int i, unsigned& u) {
        const unsigned long long x = load(i);
        u = ~(unsigned)(x >> 32);
        return x != kNone;
      },
      n, k, s, prefix, pmask, remaining, all);
  if (tid == 0) s.ntop = 0;
  __syncthreads();
  for (int i = tid; i < n; i += kThreads) {
    const unsigned long long x = load(i);
    const unsigned m = ~(unsigned)(x >> 32) & pmask;
    if (x != kNone && (m > prefix || (all && m == prefix))) s.top[atomicAdd(&s.ntop, 1)] = x;
  }
  if (!all) {
    unsigned p2, m2;
    int r2;
    bool all2;
    block_select(
        [&](int i, unsigned& u) {
          const unsigned long long x = load(i);
          u = ~(unsigned)x;
          return x != kNone && (~(unsigned)(x >> 32) & pmask) == prefix;
        },
        n, remaining, s, p2, m2, r2, all2);
    for (int i = tid; i < n; i += kThreads) {
      const unsigned long long x = load(i);
      if (x != kNone && (~(unsigned)(x >> 32) & pmask) == prefix && (~(unsigned)x & m2) >= p2) {
        s.top[atomicAdd(&s.ntop, 1)] = x;
      }
    }
  }
  __syncthreads();
  if (tid < 32) {
    unsigned long long t[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) t[r] = r * 32 + lane < k ? s.top[r * 32 + lane] : kNone;
    bitonic<4>(t, lane);
#pragma unroll
    for (int r = 0; r < 4; ++r) s.top[r * 32 + lane] = t[r];
  }
  __syncthreads();
}

// Stable LSD radix sort of the composites v[0..n) by their high word
// (four 8-bit passes; a pass whose digit is one value for every key is
// skipped); w is a buffer of n.  Returns the array that holds the result.
// The stable scatter ranks a key among its tile's equal digits with
// `__match_any_sync` and per-warp digit counts (s.wcnt, all 0 on entry).
__device__ unsigned long long* block_sort(unsigned long long* v, unsigned long long* w, int n,
                                          Smem& s) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int shift = 32; shift < 64; shift += 8) {
    s.hist[tid] = 0;
    __syncthreads();
    for (int i = tid; i < n; i += kThreads) atomicAdd(&s.hist[(v[i] >> shift) & 255], 1);
    __syncthreads();
    const bool skip = s.hist[(v[0] >> shift) & 255] == n;  // one digit for every key
    const int h = s.hist[tid];
    __syncthreads();
    if (skip) continue;
    int total;
    const int off = block_scan(h, s, &total);
    s.hist[tid] = off;  // thread tid owns bin tid from here on
    for (int s0 = 0; s0 < n; s0 += kThreads) {
      const int i = s0 + tid;
      const bool in = i < n;
      const unsigned long long x = in ? v[i] : 0ull;
      const unsigned dig = (unsigned)(x >> shift) & 255;
      const unsigned peers = __match_any_sync(kFull, in ? dig : 0xffffffffu);
      const int rank = __popc(peers & ((1u << lane) - 1));
      if (in && rank == 0) s.wcnt[warp * kBins + dig] = __popc(peers);
      __syncthreads();
      int run = s.hist[tid];
#pragma unroll
      for (int ww = 0; ww < kWarps; ++ww) {
        const int t = s.wcnt[ww * kBins + tid];
        s.wcnt[ww * kBins + tid] = 0;
        s.woff[ww * kBins + tid] = run;
        run += t;
      }
      s.hist[tid] = run;
      __syncthreads();
      if (in) w[s.woff[warp * kBins + dig] + rank] = x;
      // the next tile's counts go to wcnt (cleared above); its offsets are
      // written only after its first barrier, when these scatters are done
    }
    __syncthreads();
    unsigned long long* t = v;
    v = w;
    w = t;
  }
  return v;
}

__device__ __forceinline__ void stage_query(const Args& a, int b, float* qs, Smem& s) {
  const float* q = a.qv + (size_t)b * a.d;
  for (int i = threadIdx.x; i < a.d; i += kThreads) qs[i] = q[i];
  for (int i = threadIdx.x; i < kWarps * kBins; i += kThreads) s.wcnt[i] = 0;
  __syncthreads();
}

template <typename T, bool VEC, bool CUT, bool CAPPED>
__global__ void __launch_bounds__(kThreads, CAPPED ? kBlockCtas : 1) rescore_kernel_block(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x, c = a.c;
  const size_t qbytes = align16((size_t)a.d * 4);
  float* qs = reinterpret_cast<float*>(smem);
  Smem& s = *reinterpret_cast<Smem*>(smem + qbytes);
  unsigned char* base = a.scratch ? a.scratch + (size_t)b * a.stride
                                  : smem + qbytes + align16(sizeof(Smem));
  unsigned long long* ka = reinterpret_cast<unsigned long long*>(base);  // [c] composites
  unsigned long long* kb = ka + c;                                       // [c] sort buffer
  int* slots = reinterpret_cast<int*>(kb + c);  // cut: slot, or ~slot where not valid

  stage_query(a, b, qs, s);
  if (CUT) block_cut(a, b, s, slots);

  // re-score: warp w takes columns [w·per, (w + 1)·per), 32 at a time
  const float qn = a.metric == kCosine ? a.qn[b] : 0.f;
  const int per = (c + kWarps - 1) / kWarps;
  const int wlo = warp * per < c ? warp * per : c, whi = wlo + per < c ? wlo + per : c;
  for (int j0 = wlo; j0 < whi; j0 += 32) {
    const int j = j0 + lane;
    int slot = 0;
    bool ok = false;
    if (j < whi) {
      if (CUT) {
        const int sv = slots[j];
        ok = sv >= 0;
        slot = ok ? sv : ~sv;
      } else {
        slot = (int)a.cand[(size_t)b * c + j];
        ok = a.valid[(size_t)b * c + j] != 0;
      }
      if (!ok) ka[j] = composite(kInfKey, j);
    }
    score_chunk<T, VEC, CAPPED ? kRowsCapped : kRowsBlock>(
        a, qs, qn, slot, ok, lane, [&](unsigned key) { ka[j] = composite(key, j); });
  }
  __syncthreads();

  const unsigned long long* res = s.top;
  if (a.k <= kSmallK) {
    block_small_topk<false>(ka, c, a.k, s);
  } else {
    int n = c;
    if (2 * a.k <= c) {
      block_keep<false>(ka, c, a.k, s);
      n = a.k;
    }
    res = block_sort(ka, kb, n, s);
  }
  for (int t = tid; t < a.k; t += kThreads) {
    const unsigned long long x = res[t];
    const int col = (int)(unsigned)x;
    int slot;
    if (CUT) {
      const int sv = slots[col];
      slot = sv >= 0 ? sv : ~sv;
    } else {
      slot = (int)a.cand[(size_t)b * c + col];
    }
    write_out(a, b, t, (unsigned)(x >> 32), slot);
  }
}

template <typename T, bool VEC, bool CUT>
__global__ void __launch_bounds__(kThreads) rescore_kernel_split(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / a.splits, part = blockIdx.x % a.splits;
  const int width = CUT ? a.n2 : a.c;
  const size_t qbytes = align16((size_t)a.d * 4);
  float* qs = reinterpret_cast<float*>(smem);
  Smem& s = *reinterpret_cast<Smem*>(smem + qbytes);
  unsigned long long* scr =
      reinterpret_cast<unsigned long long*>(a.scratch + (size_t)b * a.stride);  // [width + k]

  stage_query(a, b, qs, s);
  const int* keys = CUT ? a.keys + (size_t)b * a.n2 : nullptr;
  const int* idxp = CUT ? a.idxp + (size_t)b * a.n2 : nullptr;
  unsigned prefix = 0, pmask = 0;
  int remaining = 0;
  bool all = false;
  if (CUT) {
    block_select(
        [&](int i, unsigned& u) {
          u = (unsigned)__ldg(keys + i) ^ 0x80000000u;
          return true;
        },
        a.n2, a.c, s, prefix, pmask, remaining, all);
  }

  // this CTA's columns [lo, hi), a contiguous range a warp
  const int lo = (int)((long long)width * part / a.splits);
  const int hi = (int)((long long)width * (part + 1) / a.splits);
  const int per = (hi - lo + kWarps - 1) / kWarps;
  const int wlo = lo + warp * per < hi ? lo + warp * per : hi;
  const int whi = wlo + per < hi ? wlo + per : hi;
  const unsigned below = (1u << lane) - 1;
  int eq_seen = 0;  // cut: keys equal to the threshold before this chunk
  if (CUT) {
    for (int i = lane; i < wlo; i += 32) {
      eq_seen += ((((unsigned)__ldg(keys + i) ^ 0x80000000u) & pmask) == prefix);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) eq_seen += __shfl_xor_sync(kFull, eq_seen, o);
  }
  const float qn = a.metric == kCosine ? a.qn[b] : 0.f;
  for (int j0 = wlo; j0 < whi; j0 += 32) {
    const int j = j0 + lane;
    const bool in = j < whi;
    int slot = 0;
    bool sel = in, ok = false;
    if (CUT) {
      const int key = in ? __ldg(keys + j) : 0;
      const unsigned m = ((unsigned)key ^ 0x80000000u) & pmask;
      const bool gt = in && m > prefix, eq = in && m == prefix;
      const unsigned eqb = __ballot_sync(kFull, eq);
      sel = gt || (eq && eq_seen + __popc(eqb & below) < remaining);
      eq_seen += __popc(eqb);
      if (in && !sel) scr[j] = kNone;
      if (sel) {
        slot = (int)a.pos_to_slot[__ldg(idxp + j)];
        ok = key > kDeadKeyMax && a.live[slot];
      }
    } else if (in) {
      slot = (int)a.cand[(size_t)b * a.c + j];
      ok = a.valid[(size_t)b * a.c + j] != 0;
    }
    if (sel && !ok) scr[j] = composite(kInfKey, j);
    score_chunk<T, VEC, kRowsBlock>(a, qs, qn, slot, ok, lane,
                        [&](unsigned key) { scr[j] = composite(key, j); });
  }

  // the query's last CTA to finish keeps and sorts the k smallest
  __threadfence();
  __syncthreads();
  if (tid == 0) s.last = atomicAdd(a.tickets + b, 1) == a.splits - 1;
  __syncthreads();
  if (!s.last) return;
  __threadfence();
  const unsigned long long* res = s.top;
  if (a.k <= kSmallK) {
    block_small_topk<true>(scr, width, a.k, s);
  } else {
    block_keep<true>(scr, width, a.k, s);
    res = block_sort(scr, scr + width, a.k, s);
  }
  for (int t = tid; t < a.k; t += kThreads) {
    const unsigned long long x = res[t];
    const int col = (int)(unsigned)x;
    const int slot = CUT ? (int)a.pos_to_slot[idxp[col]] : (int)a.cand[(size_t)b * a.c + col];
    write_out(a, b, t, (unsigned)(x >> 32), slot);
  }
}

template <typename K>
int launch(K fn, int grid, int threads, size_t smem, const Args& a, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  fn<<<grid, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, bool VEC, bool CUT>
int run(const Args& a, int regime, cudaStream_t stream) {
  const size_t qbytes = align16((size_t)a.d * 4), sbytes = qbytes + align16(sizeof(Smem));
  if (regime == kWarp) {
    if (a.c > kWarpMaxC || a.per_cta < 1 || a.per_cta > kWarps) return (int)cudaErrorInvalidValue;
    return launch(rescore_kernel_warp<T, VEC, CUT>, (a.batch + a.per_cta - 1) / a.per_cta,
                  32 * a.per_cta, (size_t)a.per_cta * (qbytes + kWarpExtra), a, stream);
  }
  if (regime == kBlock || regime == kBlockCapped) {
    const size_t cand = a.scratch ? 0 : (size_t)a.c * 20;
    return regime == kBlock
               ? launch(rescore_kernel_block<T, VEC, CUT, false>, a.batch, kThreads,
                        sbytes + cand, a, stream)
               : launch(rescore_kernel_block<T, VEC, CUT, true>, a.batch, kThreads,
                        sbytes + cand, a, stream);
  }
  if (regime == kSplit) {
    if (!a.scratch || !a.tickets || a.splits < 1) return (int)cudaErrorInvalidValue;
    return launch(rescore_kernel_split<T, VEC, CUT>, a.batch * a.splits, kThreads, sbytes, a, stream);
  }
  return (int)cudaErrorInvalidValue;
}

template <bool CUT>
int dispatch(const Args& a, int row_type, int vec, int regime, cudaStream_t stream) {
  if (a.metric < kEuclidean || a.metric > kDot) return (int)cudaErrorInvalidValue;
  if (row_type == 0) {
    return vec ? run<float, true, CUT>(a, regime, stream) : run<float, false, CUT>(a, regime, stream);
  }
  if (row_type == 1) {
    return vec ? run<unsigned short, true, CUT>(a, regime, stream)
               : run<unsigned short, false, CUT>(a, regime, stream);
  }
  return (int)cudaErrorInvalidValue;
}

Args common(int metric, const void* rows, const void* norms, const void* slot_to_id,
            const void* qv, const void* qn, void* out_ids, void* out_d, void* scratch,
            void* tickets, long long stride, int batch, int d, int c, int k, int normalize,
            int per_cta, int splits) {
  Args a = {};
  a.rows = rows;
  a.norms = static_cast<const float*>(norms);
  a.slot_to_id = static_cast<const long long*>(slot_to_id);
  a.qv = static_cast<const float*>(qv);
  a.qn = static_cast<const float*>(qn);
  a.out_ids = static_cast<long long*>(out_ids);
  a.out_d = static_cast<float*>(out_d);
  a.scratch = static_cast<unsigned char*>(scratch);
  a.tickets = static_cast<int*>(tickets);
  a.stride = stride;
  a.batch = batch;
  a.d = d;
  a.c = c;
  a.k = k;
  a.metric = metric;
  a.normalize = normalize;
  a.per_cta = per_cta;
  a.splits = splits;
  return a;
}

}  // namespace

extern "C" {

// row_type: 0 f32, 1 bf16.  vec: 1 when d·itemsize and the rows' base are
// multiples of 16 bytes.  metric: 0 euclidean, 1 cosine, 2 dot-product.
// regime: 0 warp (per_cta queries a CTA), 1 block, 3 block with registers
// for 4 CTAs an SM, 2 split (`splits` CTAs a query, `tickets` [B] int32
// zeros).  scratch: null, or `stride` bytes a
// query (block: 20·c; split: 8·(W + k)).
int cut_rescore(int metric, int row_type, int vec, const void* rows, const void* norms,
                const void* slot_to_id, const void* qv, const void* qn, const void* keys,
                const void* idxp, const void* pos_to_slot, const void* live, void* out_ids,
                void* out_d, void* scratch, void* tickets, long long stride, int batch, int d,
                int n2, int c, int k, int normalize, int regime, int per_cta, int splits,
                void* stream) {
  Args a = common(metric, rows, norms, slot_to_id, qv, qn, out_ids, out_d, scratch, tickets,
                  stride, batch, d, c, k, normalize, per_cta, splits);
  a.keys = static_cast<const int*>(keys);
  a.idxp = static_cast<const int*>(idxp);
  a.pos_to_slot = static_cast<const long long*>(pos_to_slot);
  a.live = static_cast<const unsigned char*>(live);
  a.n2 = n2;
  return dispatch<true>(a, row_type, vec, regime, static_cast<cudaStream_t>(stream));
}

int rescore_topk(int metric, int row_type, int vec, const void* rows, const void* norms,
                 const void* slot_to_id, const void* qv, const void* qn, const void* cand,
                 const void* valid, void* out_ids, void* out_d, void* scratch, void* tickets,
                 long long stride, int batch, int d, int c, int k, int normalize, int regime,
                 int per_cta, int splits, void* stream) {
  Args a = common(metric, rows, norms, slot_to_id, qv, qn, out_ids, out_d, scratch, tickets,
                  stride, batch, d, c, k, normalize, per_cta, splits);
  a.cand = static_cast<const long long*>(cand);
  a.valid = static_cast<const unsigned char*>(valid);
  return dispatch<false>(a, row_type, vec, regime, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
