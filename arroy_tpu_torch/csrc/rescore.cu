// Exact-engine stage 2 for Hopper (sm_90a): key cut, candidate gather,
// exact f32 re-score and top-k, one CTA a query, one launch a batch.
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
// (:1512), `_exact_f32_impl` (:1266) and `_exact_scan_impl` (:1312).  The
// port ran these as ~10 PyTorch launches a batch with [B, c, d] f32
// temporaries (`rows[cand]`, `X - q`, the square: 201 MB each at B = 2048,
// c = 32, d = 768).
//
// What bounds it on this card: memory.  Each candidate row is read once
// from the corpus, 2 flops an element against 4 (f32) or 2 (bf16) bytes;
// the keys, positions and queries are read once and [B, k] written.  At
// B = 2048, 2nb = 784, c = 32, d = 768, f32 rows: 12.8 MB of keys and
// positions + 201 MB of rows + 6.3 MB of queries, 0.066 ms at 3.35 TB/s
// (bf16 rows 0.036 ms); at 1M items (2nb = 7,824, c = 128) 0.28 ms.
//
// Design (simple first; `cp.async` pipelining of the row gathers and
// several queries a CTA are later work):
// - One CTA of 8 warps a query.  The query row is staged in shared memory
//   as f32.
// - The cut is a radix select over the keys as unsigned (key ^ 2^31): four
//   8-bit passes, each a shared histogram of the keys that match the digits
//   chosen so far, find the c-th key T and how many keys equal to T to
//   keep.  One pass in position order then keeps every key above T and the
//   first of those equal to T, compacted by two block scans, so candidate j
//   is the j-th kept position.
// - Warps take candidates in turn (warp w: w, w + 8, ...).  A lane reads
//   16 bytes a load where the row and the base allow it (4 f32 or 8 bf16,
//   promoted exactly), else one element; lanes sum in a fixed order and a
//   butterfly of shuffles adds the 32 partial sums, so a distance is the
//   same in every run.
// - The top-k is a stable LSD radix sort of the c (distance key, column)
//   pairs, four 8-bit passes (a pass whose digit is one value for every
//   key is skipped), and the first k are written.  A distance's key is its
//   IEEE bits made unsigned-sortable.  The stable scatter ranks a key
//   among its tile's equal digits with `__match_any_sync` and per-warp
//   digit counts.
// - Candidates live in shared memory up to the caller's limit (the
//   wrapper's `SMEM_CANDIDATES`); past it, in a scratch buffer of 5·c int32
//   a query that the wrapper allocates.  No size is refused for being
//   large: a query row past what one CTA's shared memory holds (d of
//   ~50,000) is the only limit, and its launch returns the error.
//
// Interface: plain C, pointers and the stream as void*, returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a metric
// or row type the kernel has no instance for).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // == the radix's bins: one thread a bin
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kDeadKeyMax = (int)0x807fffff;  // ops.fused_select.DEAD_KEY_MAX
constexpr float kF32Eps = 1.1920928955078125e-07f;

enum Metric { kEuclidean = 0, kCosine = 1, kDot = 2 };

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
  int* scratch;                // null, or [B, 5c] int32
  int d, n2, c, k, metric, normalize;
};

// the shared scratch of one CTA, past the query row
struct Smem {
  int hist[kBins];             // select histogram / sort bin offsets
  int wcnt[kWarps * kBins];    // sort: per-warp digit counts (kept 0 between tiles)
  int woff[kWarps * kBins];    // sort: per-warp digit offsets of a tile
  int scan[kWarps + 1];        // block scan: warp sums, then the total
  int pick[2];                 // select: the chosen digit, keys still to take
};

__device__ __forceinline__ unsigned asc_key(float f) {
  unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float asc_float(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

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

// The cut: candidate j (j < c) is the j-th position, in position order, of
// the c largest keys of this query; slots[j] = its slot if valid, else
// ~slot.
__device__ void cut(const Args& a, Smem& s, int* slots) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = a.n2, need = a.c;
  const int* keys = a.keys + (size_t)blockIdx.x * n;
  const int* idxp = a.idxp + (size_t)blockIdx.x * n;
  unsigned prefix = 0, pmask = 0;
  int remaining = need;
  for (int shift = 24; shift >= 0; shift -= 8) {
    s.hist[tid] = 0;
    __syncthreads();
    for (int i = tid; i < n; i += kThreads) {
      unsigned u = (unsigned)keys[i] ^ 0x80000000u;
      if ((u & pmask) == prefix) atomicAdd(&s.hist[(u >> shift) & 255], 1);
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
  }
  // keep every key above the c-th (T = prefix) and the first `remaining`
  // equal to it, in position order
  int out = 0, eq_seen = 0;
  for (int s0 = 0; s0 < n; s0 += kThreads) {
    const int i = s0 + tid;
    const int key = i < n ? keys[i] : 0;
    const unsigned u = (unsigned)key ^ 0x80000000u;
    const bool in = i < n;
    int eq_tot, sel_tot;
    const int eq_rank = block_scan(in && u == prefix, s, &eq_tot);
    const bool sel = in && (u > prefix || (u == prefix && eq_seen + eq_rank < remaining));
    const int pos = block_scan(sel, s, &sel_tot);
    if (sel) {
      const int slot = (int)a.pos_to_slot[idxp[i]];
      const bool ok = key > kDeadKeyMax && a.live[slot];
      slots[out + pos] = ok ? slot : ~slot;
    }
    out += sel_tot;
    eq_seen += eq_tot;
  }
}

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

// one lane's share of Σ over the row: 16-byte loads (VEC) or one element
template <typename T, bool VEC, bool EUCLID>
__device__ float row_sum(const T* row, const float* qs, int d, int lane) {
  float acc = 0.f;
  if (VEC) {
    if (sizeof(T) == 4) {
      const float4* r = reinterpret_cast<const float4*>(row);
      const float4* q = reinterpret_cast<const float4*>(qs);
#pragma unroll 4
      for (int v = lane; v < d / 4; v += 32) {
        const float4 x = __ldg(r + v), y = q[v];
        acc = term<EUCLID>(x.x, y.x, acc);
        acc = term<EUCLID>(x.y, y.y, acc);
        acc = term<EUCLID>(x.z, y.z, acc);
        acc = term<EUCLID>(x.w, y.w, acc);
      }
    } else {
      const uint4* r = reinterpret_cast<const uint4*>(row);
      const float4* q = reinterpret_cast<const float4*>(qs);
#pragma unroll 4
      for (int v = lane; v < d / 8; v += 32) {
        const uint4 x = __ldg(r + v);
        const float4 y0 = q[2 * v], y1 = q[2 * v + 1];
        acc = term<EUCLID>(__uint_as_float(x.x << 16), y0.x, acc);
        acc = term<EUCLID>(__uint_as_float(x.x & 0xffff0000u), y0.y, acc);
        acc = term<EUCLID>(__uint_as_float(x.y << 16), y0.z, acc);
        acc = term<EUCLID>(__uint_as_float(x.y & 0xffff0000u), y0.w, acc);
        acc = term<EUCLID>(__uint_as_float(x.z << 16), y1.x, acc);
        acc = term<EUCLID>(__uint_as_float(x.z & 0xffff0000u), y1.y, acc);
        acc = term<EUCLID>(__uint_as_float(x.w << 16), y1.z, acc);
        acc = term<EUCLID>(__uint_as_float(x.w & 0xffff0000u), y1.w, acc);
      }
    }
  } else {
    for (int i = lane; i < d; i += 32) {
      float x;
      if (sizeof(T) == 4) {
        x = __ldg(reinterpret_cast<const float*>(row) + i);
      } else {
        x = bf16f(__ldg(reinterpret_cast<const unsigned short*>(row) + i));
      }
      acc = term<EUCLID>(x, qs[i], acc);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(kFull, acc, o);
  return acc;
}

template <typename T, bool VEC, bool CUT>
__global__ void __launch_bounds__(kThreads) rescore_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x, c = a.c, d = a.d;
  float* qs = reinterpret_cast<float*>(smem);
  Smem& s = *reinterpret_cast<Smem*>(smem + (size_t)((d + 3) & ~3) * 4);
  int* base = a.scratch ? a.scratch + (size_t)b * 5 * c : reinterpret_cast<int*>(&s + 1);
  int* slots = base;  // cut: slot, or ~slot where not valid
  unsigned* ka = reinterpret_cast<unsigned*>(base + c);
  int* pa = base + 2 * c;
  unsigned* kb = reinterpret_cast<unsigned*>(base + 3 * c);
  int* pb = base + 4 * c;

  const float* q = a.qv + (size_t)b * d;
  for (int i = tid; i < d; i += kThreads) qs[i] = q[i];
  for (int i = tid; i < kWarps * kBins; i += kThreads) s.wcnt[i] = 0;
  __syncthreads();
  if (CUT) {
    cut(a, s, slots);
    __syncthreads();
  }

  // re-score: warp w takes candidates w, w + kWarps, ...
  const float qn = a.metric == kCosine ? a.qn[b] : 0.f;
  for (int j = warp; j < c; j += kWarps) {
    int slot;
    bool ok;
    if (CUT) {
      const int sv = slots[j];
      ok = sv >= 0;
      slot = ok ? sv : ~sv;
    } else {
      slot = (int)a.cand[(size_t)b * c + j];
      ok = a.valid[(size_t)b * c + j] != 0;
    }
    float dist = __int_as_float(0x7f800000);  // +inf
    if (ok) {
      const T* row = reinterpret_cast<const T*>(a.rows) + (size_t)slot * d;
      if (a.metric == kEuclidean) {
        dist = row_sum<T, VEC, true>(row, qs, d, lane);
      } else {
        const float pq = row_sum<T, VEC, false>(row, qs, d, lane);
        if (a.metric == kDot) {
          dist = -pq;
        } else {
          const float pnqn = a.norms[slot] * qn;
          const bool pos = pnqn > kF32Eps;
          float cs = pq / (pos ? pnqn : 1.f);
          cs = cs < -1.f ? -1.f : (cs > 1.f ? 1.f : cs);  // NaN stays NaN, as torch.clamp
          dist = pos ? (1.f - cs) / 2.f : 0.f;
        }
      }
    }
    if (lane == 0) {
      ka[j] = asc_key(dist);
      pa[j] = j;
    }
  }
  __syncthreads();

  // top-k: stable LSD radix sort of (ka, pa) by key, ascending
  for (int shift = 0; shift < 32; shift += 8) {
    s.hist[tid] = 0;
    __syncthreads();
    for (int i = tid; i < c; i += kThreads) atomicAdd(&s.hist[(ka[i] >> shift) & 255], 1);
    __syncthreads();
    const bool skip = s.hist[(ka[0] >> shift) & 255] == c;  // one digit for every key
    const int h = s.hist[tid];
    __syncthreads();
    if (skip) continue;
    int total;
    const int off = block_scan(h, s, &total);
    s.hist[tid] = off;  // thread tid owns bin tid from here on
    for (int s0 = 0; s0 < c; s0 += kThreads) {
      const int i = s0 + tid;
      const bool in = i < c;
      const unsigned key = in ? ka[i] : 0u;
      const int pay = in ? pa[i] : 0;
      const unsigned dig = (key >> shift) & 255;
      const unsigned peers = __match_any_sync(kFull, in ? dig : 0xffffffffu);
      const int rank = __popc(peers & ((1u << lane) - 1));
      if (in && rank == 0) s.wcnt[warp * kBins + dig] = __popc(peers);
      __syncthreads();
      int run = s.hist[tid];
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const int t = s.wcnt[w * kBins + tid];
        s.wcnt[w * kBins + tid] = 0;
        s.woff[w * kBins + tid] = run;
        run += t;
      }
      s.hist[tid] = run;
      __syncthreads();
      if (in) {
        const int dst = s.woff[warp * kBins + dig] + rank;
        kb[dst] = key;
        pb[dst] = pay;
      }
      // the next tile's counts go to wcnt (cleared above); its offsets are
      // written only after its first barrier, when these scatters are done
    }
    __syncthreads();
    unsigned* tk = ka; ka = kb; kb = tk;
    int* tp = pa; pa = pb; pb = tp;
  }

  for (int t = tid; t < a.k; t += kThreads) {
    const int j = pa[t];
    float dist = asc_float(ka[t]);
    int slot;
    if (CUT) {
      const int sv = slots[j];
      slot = sv >= 0 ? sv : ~sv;
    } else {
      slot = (int)a.cand[(size_t)b * c + j];
    }
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
}

template <typename T, bool VEC, bool CUT>
int launch(const Args& a, int batch, size_t smem, cudaStream_t stream) {
  auto fn = rescore_kernel<T, VEC, CUT>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  fn<<<batch, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool CUT>
int dispatch(const Args& a, int row_type, int vec, int batch, cudaStream_t stream) {
  if (a.metric < kEuclidean || a.metric > kDot) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)((a.d + 3) & ~3) * 4 + sizeof(Smem) +
                      (a.scratch ? 0 : (size_t)5 * a.c * 4);
  if (row_type == 0) {
    return vec ? launch<float, true, CUT>(a, batch, smem, stream)
               : launch<float, false, CUT>(a, batch, smem, stream);
  }
  if (row_type == 1) {
    return vec ? launch<unsigned short, true, CUT>(a, batch, smem, stream)
               : launch<unsigned short, false, CUT>(a, batch, smem, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// row_type: 0 f32, 1 bf16.  vec: 1 when d·itemsize and the rows' base are
// multiples of 16 bytes.  metric: 0 euclidean, 1 cosine, 2 dot-product.
int cut_rescore(int metric, int row_type, int vec, const void* rows, const void* norms,
                const void* slot_to_id, const void* qv, const void* qn, const void* keys,
                const void* idxp, const void* pos_to_slot, const void* live, void* out_ids,
                void* out_d, void* scratch, int batch, int d, int n2, int c, int k,
                int normalize, void* stream) {
  Args a = {};
  a.rows = rows;
  a.norms = static_cast<const float*>(norms);
  a.slot_to_id = static_cast<const long long*>(slot_to_id);
  a.qv = static_cast<const float*>(qv);
  a.qn = static_cast<const float*>(qn);
  a.keys = static_cast<const int*>(keys);
  a.idxp = static_cast<const int*>(idxp);
  a.pos_to_slot = static_cast<const long long*>(pos_to_slot);
  a.live = static_cast<const unsigned char*>(live);
  a.out_ids = static_cast<long long*>(out_ids);
  a.out_d = static_cast<float*>(out_d);
  a.scratch = static_cast<int*>(scratch);
  a.d = d;
  a.n2 = n2;
  a.c = c;
  a.k = k;
  a.metric = metric;
  a.normalize = normalize;
  return dispatch<true>(a, row_type, vec, batch, static_cast<cudaStream_t>(stream));
}

int rescore_topk(int metric, int row_type, int vec, const void* rows, const void* norms,
                 const void* slot_to_id, const void* qv, const void* qn, const void* cand,
                 const void* valid, void* out_ids, void* out_d, void* scratch, int batch, int d,
                 int c, int k, int normalize, void* stream) {
  Args a = {};
  a.rows = rows;
  a.norms = static_cast<const float*>(norms);
  a.slot_to_id = static_cast<const long long*>(slot_to_id);
  a.qv = static_cast<const float*>(qv);
  a.qn = static_cast<const float*>(qn);
  a.cand = static_cast<const long long*>(cand);
  a.valid = static_cast<const unsigned char*>(valid);
  a.out_ids = static_cast<long long*>(out_ids);
  a.out_d = static_cast<float*>(out_d);
  a.scratch = static_cast<int*>(scratch);
  a.d = d;
  a.c = c;
  a.k = k;
  a.metric = metric;
  a.normalize = normalize;
  return dispatch<false>(a, row_type, vec, batch, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
