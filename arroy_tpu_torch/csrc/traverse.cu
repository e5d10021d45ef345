// Best-first forest traversal for Hopper (sm_90a): the pop loop of a
// query batch, one query a warp, from the first pop to the last with no
// host round trip.
//
// Replaces: arroy_tpu/search.py:140, _traverse_impl — its per-query
// `lax.while_loop` under `vmap` (the `one` body, unfiltered, and
// `one_filtered`), which the JAX package compiles into one device program
// with XLA; there is no Pallas kernel for it.  The port's plain version is
// `ops.traverse.traverse_reference` (`search._traverse_batch`), ~56
// batched PyTorch ops a pop with a host read every 16 pops.
//
// What it computes, per query b (exactly the plain version's output):
// a max-queue seeded with every root at +inf; a pop takes the entry of
// largest distance, ties to the larger node id (BinaryHeap<(OrderedFloat,
// NodeId)>, reference src/reader.rs:342); a split row keeps the popped
// place for its left child at min(d, -margin) and pushes its right child
// at min(d, margin) (margin 0 for KIND_SPLIT_NONE); a leaf row logs its
// CSR row (unfiltered: `out` is the [l_cap] leaf log, its tail slot the
// count, entries past the count 0) or appends the filter-accepted items of
// its window (filtered: `out` is the [cap] candidate buffer, -1 padded);
// a FREE row pops as a no-op.  The loop runs while n_cand < search_k_dyn
// and pops < pmax; an empty queue sets pops to pmax.
//
// What bounds it on this card: latency.  A batch holds a few hundred
// queries, all running at once (a warp a query, a CTA a query), so the
// time is the longest query's chain of pops.  Each pop waits for one
// dependent L2 read (the next split's margin, whose address its row
// gives) and runs lane 0's ~100 instructions back to back (nothing else
// is in flight on its scheduler, so each waits on the one before).
// Bytes and operations are tiny.  What the design does about it:
// - lane 0 owns the queue, so no lane ever reads a queue entry another
//   lane is writing;
// - the pop order is a total order on (distance, node id), so any queue
//   that pops its maximum pops the plain loop's sequence.  A key is that
//   pair packed in 64 bits (`pack`: -0.0 taken as +0.0, so ±0.0 tie and
//   fall to the node id as the float compare does), one unsigned compare;
// - the top entry is held in registers apart from a heap of the others.
//   The next top is the popped split's larger child if it is above the
//   heap's root (down a tree: the heap keeps its root and only the smaller
//   child is pushed), else the heap's root.  So the next top is known
//   before the heap is touched: its margin and its children's rows are
//   read while the heap is updated, and its own row was read one pop
//   earlier (as a child's) or, leaving a tree, when it was queued;
// - the heap is 8-ary, in shared memory, each slot's children one
//   aligned group of 8 keys read as four 16-byte loads: a sift walks log8
//   levels where a binary heap walks log2.  Keys past the heap's end are
//   0, below every live key, so no level tests the heap's size.  Heap
//   slots past the shared-memory share live in a per-query global scratch,
//   in a second instantiation (`kSpill`) that only a queue wider than
//   shared memory runs;
// - lane 0's instructions are kept few: a row is two 16-byte loads, the
//   heap's shared address stays in a register, a kind's class is read from
//   a bit mask (`kind_in`), and the outputs are padded by the whole warp
//   before the loop;
// - a filtered leaf's window is read by the whole warp, pipelined with
//   lane 0's pops: its slots are loaded when the leaf is known to pop next
//   (one pop ahead), their filter words while lane 0 pops it, then a
//   ballot and a popc a 32-item chunk place the accepted items in window
//   order.
// The queue holds at most q_cap entries (a split is pushed once; a right
// child pushed past q_cap is dropped, as the plain version's trash lane
// drops it).
//
// Interface: plain C, pointers and the stream as void*, returns
// cudaGetLastError() after the launch.

#include <climits>

#include <cuda_runtime.h>

// the heap array of the query a CTA runs (`Heap<false>` addresses it by
// its 32-bit shared-memory address, so no access rebuilds a generic one)
extern __shared__ __align__(16) unsigned long long heap_smem[];

namespace {

constexpr int kKindFree = -1;
constexpr int kKindSplitNone = 1;
constexpr int kKindLeaf = 2;
constexpr unsigned kFull = 0xffffffffu;
// children of a heap slot; slot s lives at array index s + kRoot, so the
// children of slot s (8s + 1 .. 8s + 8) fill the aligned group 8(s + 1)
constexpr int kArity = 8;
constexpr int kRoot = kArity - 1;
// ints in a node-table row (kind, left, right, ptr, leaf_off, leaf_cnt and
// two unused): 32 bytes, read as two 16-byte loads
constexpr int kRowInts = 8;
// 32-item chunks of a filtered window that a lane loads in one round
// (768 items, the widest leaf of a 768-d index, in one round)
constexpr int kWindowChunks = 24;
// `pack`'s high word for a distance of -inf: the plain loop's empty lane
constexpr unsigned kDeadHi = 0x007fffffu;

typedef unsigned long long Key;

// (distance, node id) -> one key whose unsigned order is the pop order
__device__ __forceinline__ Key pack(float d, int n) {
  unsigned b = __float_as_uint(d == 0.f ? 0.f : d);
  b = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return (static_cast<Key>(b) << 32) | (static_cast<unsigned>(n) ^ 0x80000000u);
}

__device__ __forceinline__ float key_dist(Key k) {
  const unsigned b = static_cast<unsigned>(k >> 32);
  return __uint_as_float((b & 0x80000000u) ? (b & 0x7fffffffu) : ~b);
}

__device__ __forceinline__ int key_node(Key k) {
  return static_cast<int>(static_cast<unsigned>(k) ^ 0x80000000u);
}

// The heap's array: index i, a group of 8 from index g (a multiple of 8).
template <bool kSpill>
struct HeapArray;

// wholly in shared memory
template <>
struct HeapArray<false> {
  unsigned base;  // the shared-memory address of index 0

  __device__ __forceinline__ Key load(int i) const {
    Key v;
    asm volatile("ld.shared.u64 %0, [%1];" : "=l"(v) : "r"(base + 8u * i));
    return v;
  }
  __device__ __forceinline__ void store(int i, Key k) const {
    asm volatile("st.shared.u64 [%0], %1;" ::"r"(base + 8u * i), "l"(k));
  }
  __device__ __forceinline__ void load_group(int g, Key (&k)[kArity]) const {
    const unsigned a = base + 8u * g;
    asm volatile("ld.shared.v2.u64 {%0, %1}, [%2];" : "=l"(k[0]), "=l"(k[1]) : "r"(a));
    asm volatile("ld.shared.v2.u64 {%0, %1}, [%2];" : "=l"(k[2]), "=l"(k[3]) : "r"(a + 16));
    asm volatile("ld.shared.v2.u64 {%0, %1}, [%2];" : "=l"(k[4]), "=l"(k[5]) : "r"(a + 32));
    asm volatile("ld.shared.v2.u64 {%0, %1}, [%2];" : "=l"(k[6]), "=l"(k[7]) : "r"(a + 48));
  }
  __device__ __forceinline__ void clear_group(int g) const {
    const unsigned a = base + 8u * g;
    const Key z = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("st.shared.v2.u64 [%0], {%1, %1};" ::"r"(a + 16 * j), "l"(z));
  }
};

// indices [0, ns) in shared memory, the rest in a per-query global scratch
template <>
struct HeapArray<true> {
  Key* sm;
  Key* gl;
  int ns;  // a multiple of kArity, so a group lies wholly in one of them

  __device__ __forceinline__ Key* at(int i) const { return i < ns ? sm + i : gl + (i - ns); }
  __device__ __forceinline__ Key load(int i) const { return *at(i); }
  __device__ __forceinline__ void store(int i, Key k) const { *at(i) = k; }
  __device__ __forceinline__ void load_group(int g, Key (&k)[kArity]) const {
    const ulonglong2* q = reinterpret_cast<const ulonglong2*>(at(g));
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const ulonglong2 v = q[j];
      k[2 * j] = v.x;
      k[2 * j + 1] = v.y;
    }
  }
  __device__ __forceinline__ void clear_group(int g) const {
    ulonglong2* q = reinterpret_cast<ulonglong2*>(at(g));
#pragma unroll
    for (int j = 0; j < 4; ++j) q[j] = make_ulonglong2(0ull, 0ull);
  }
};

template <bool kSpill>
struct Heap {
  HeapArray<kSpill> a;

  __device__ __forceinline__ Key get(int s) const { return a.load(s + kRoot); }
  __device__ __forceinline__ void put(int s, Key k) const { a.store(s + kRoot, k); }

  // the largest key among slot s's children, and its slot
  __device__ __forceinline__ Key max_child(int s, int& c) const {
    Key k[kArity];
    a.load_group(kArity * (s + 1), k);
    int j[kArity] = {0, 1, 2, 3, 4, 5, 6, 7};
#pragma unroll
    for (int w = 1; w < kArity; w <<= 1) {
#pragma unroll
      for (int i = 0; i < kArity; i += 2 * w) {
        if (k[i + w] > k[i]) {
          k[i] = k[i + w];
          j[i] = j[i + w];
        }
      }
    }
    c = kArity * s + 1 + j[0];
    return k[0];
  }

  // place `e` in the hole at the root of a heap of `size` slots
  __device__ void sift_down(int size, Key e) const {
    int s = 0;
    while (kArity * s + 1 < size) {
      int c;
      const Key m = max_child(s, c);
      if (m <= e) break;
      put(s, m);
      s = c;
    }
    put(s, e);
  }

  // place `e` in the new last slot s, moving it toward the root; the first
  // slot of a group clears the group, so keys past the heap's end are 0
  __device__ void push(int s, Key e) const {
    if (s > 0 && ((s - 1) & (kArity - 1)) == 0) a.clear_group(s + kRoot);
    while (s > 0) {
      const int q = static_cast<unsigned>(s - 1) / kArity;
      const Key pe = get(q);
      if (e <= pe) break;
      put(s, pe);
      s = q;
    }
    put(s, e);
  }
};

struct Params {
  const float* margins;     // [B, S]
  const int4* node_table;   // [n_nodes, 8] int32: kind, left, right, ptr, leaf_off, leaf_cnt, -, -
  const int* leaf_items;    // CSR slots, w entries of padding at the end
  const long long* roots;   // [t]
  const int* filter_words;  // [n_words] or null (unfiltered)
  Key* scratch;             // [B, scratch_slots] or null
  long long* out;           // [B, out_w]
  long long* pops_out;      // [B]
  long long* ncand_out;     // [B]
  int sk_dyn, S, t, n_words, pmax, w, q_cap, out_w, smem_slots, scratch_slots;
  unsigned last;            // n_nodes - 1
};

struct Row {
  int kind, left, right, ptr, off, cnt;
};

// A kind's class, read from a bit mask by shift (bit kind + 1; kinds past
// the mask read its top bit): compares on the kind compile to a jump
// table read from the constant bank on every pop.  A split is any kind
// but FREE and LEAF, as in the plain loop; a split with a plane is one
// that is not KIND_SPLIT_NONE either.
__device__ __forceinline__ bool kind_in(unsigned mask, int kind) {
  return (mask >> min(static_cast<unsigned>(kind) + 1u, 31u)) & 1u;
}
constexpr unsigned kSplitKinds = ~((1u << (kKindFree + 1)) | (1u << (kKindLeaf + 1)));
constexpr unsigned kPlaneKinds = kSplitKinds & ~(1u << (kKindSplitNone + 1));

__device__ __forceinline__ bool is_split(int kind) { return kind_in(kSplitKinds, kind); }

// a node's row (an id outside the table is clamped into it; the plain
// loop rejects such a forest)
__device__ __forceinline__ Row load_row(const Params& p, int n) {
  const int4* q = p.node_table + 2 * min(static_cast<unsigned>(n), p.last);
  const int4 x = __ldg(q), y = __ldg(q + 1);
  return Row{x.x, x.y, x.z, x.w, y.x, y.y};
}

// what a pop of row `r` reads next: a split's margin (0 for
// KIND_SPLIT_NONE) and its children's rows.  The loads are only issued
// here; their first use is the pop of `r`.
__device__ __forceinline__ void fetch(const Params& p, const float* mrow, const Row& r, float& mg,
                                      Row& rl, Row& rr) {
  const bool split = is_split(r.kind);
  const bool plane = kind_in(kPlaneKinds, r.kind) & (p.S > 0);
  mg = 0.f;
  if (plane) mg = __ldg(mrow + min(max(r.ptr, 0), p.S - 1));
  if (split) {
    rl = load_row(p, r.left);
    rr = load_row(p, r.right);
  }
}

// A filtered window, in rounds of up to 32 * kWindowChunks items from
// `base`: chunk c of a lane holds item base + 32c + lane.  Each stage's
// loads are independent of each other; an index past the window reads
// the window's last item and is not accepted, so no load is branched.
__device__ __forceinline__ void window_slots(const Params& p, int off, int lim, int base, int lane,
                                             int (&slot)[kWindowChunks]) {
#pragma unroll
  for (int c = 0; c < kWindowChunks; ++c) {
    if (base + 32 * c >= lim) break;
    slot[c] = __ldg(p.leaf_items + off + min(base + 32 * c + lane, lim - 1));
  }
}

__device__ __forceinline__ void window_words(const Params& p, int lim, int base,
                                             const int (&slot)[kWindowChunks],
                                             unsigned (&word)[kWindowChunks]) {
#pragma unroll
  for (int c = 0; c < kWindowChunks; ++c) {
    if (base + 32 * c >= lim) break;
    word[c] = __ldg(p.filter_words + min(max(slot[c], 0) >> 5, p.n_words - 1));
  }
}

// the accepted items, appended at n_cand in window order: a ballot and a
// popc a chunk
__device__ __forceinline__ void window_place(const Params& p, int lim, int base, int lane,
                                             const int (&slot)[kWindowChunks],
                                             const unsigned (&word)[kWindowChunks], long long* out,
                                             int& n_cand) {
#pragma unroll
  for (int c = 0; c < kWindowChunks; ++c) {
    if (base + 32 * c >= lim) break;
    const int sc = max(slot[c], 0);
    const bool ok = (base + 32 * c + lane < lim) & ((sc >> 5) < p.n_words) &
                    static_cast<bool>((word[c] >> (sc & 31)) & 1u);
    const unsigned mask = __ballot_sync(kFull, ok);
    if (ok) out[n_cand + __popc(mask & ((1u << lane) - 1u))] = slot[c];
    n_cand += __popc(mask);
  }
}

template <bool kSpill>
__device__ __forceinline__ Heap<kSpill> make_heap(const Params& p, int b);

template <>
__device__ __forceinline__ Heap<false> make_heap<false>(const Params&, int) {
  // through a shuffle, so ptxas keeps the address in a register instead
  // of rebuilding it (S2R SR_CgaCtaId, then LEA) before every access
  const unsigned base = static_cast<unsigned>(__cvta_generic_to_shared(heap_smem));
  return Heap<false>{{__shfl_sync(kFull, base, 0)}};
}

template <>
__device__ __forceinline__ Heap<true> make_heap<true>(const Params& p, int b) {
  return Heap<true>{{heap_smem, p.scratch + static_cast<size_t>(b) * p.scratch_slots, p.smem_slots}};
}

template <bool kFiltered, bool kSpill>
__global__ void __launch_bounds__(32) traverse_kernel(const Params p) {
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const float* mrow = p.margins + static_cast<size_t>(b) * p.S;
  long long* out = p.out + static_cast<size_t>(b) * p.out_w;
  // the output's padding first, by the warp: unfiltered, zeros past the
  // leaf log's count; filtered, -1 past the last candidate.  An unfiltered
  // query's loop is lane 0's alone.
  for (int j = lane; j < p.out_w; j += 32) out[j] = kFiltered ? -1 : 0;
  __syncwarp();
  const Heap<kSpill> h = make_heap<kSpill>(p, b);  // the whole warp: it may shuffle
  if (!kFiltered && lane != 0) return;

  int pops = 0, n_leaf = 0, n_cand = 0;
  // lane 0's queue: the top entry `top` (0: the queue is empty) with its
  // distance `td`, row `cur`, margin `mg` and, for a split, its children's
  // rows `rl`, `rr`; every other entry in the heap, hs keys, whose root
  // is `hmax` (0: none)
  int hs = 0, n_pushed = p.t;
  Key top = 0, hmax = 0;
  float td = 0.f, mg = 0.f;
  Row cur{kKindFree, 0, 0, 0, 0, 0}, rl = cur, rr = cur;
  if (lane == 0) {
    for (int j = 0; j < p.t; ++j) {
      h.push(hs, pack(__int_as_float(0x7f800000), static_cast<int>(p.roots[j])));
      ++hs;
    }
    if (hs > 0) {
      top = h.get(0);
      td = key_dist(top);
      cur = load_row(p, key_node(top));
      fetch(p, mrow, cur, mg, rl, rr);
      --hs;
      const Key e = h.get(hs);
      h.put(hs, 0ull);
      if (hs > 0) h.sift_down(hs, e);
      hmax = hs > 0 ? h.get(0) : 0ull;
    }
  }
  // the filtered kernel's window pipeline: `info` tells the warp what
  // lane 0's next pop is (-2 pops at pmax, -1 an empty queue, 0 a row
  // that is no leaf, 1 + lim a leaf whose window holds lim items from
  // `off`), and the leaf's slots are loaded as soon as it is known
  int slot[kWindowChunks];
  unsigned word[kWindowChunks];
  int info = 0, off = 0;
  auto tell = [&]() {
    if (kFiltered) {
      int i = 0;
      if (lane == 0) {
        i = pops >= p.pmax ? -2
            : static_cast<unsigned>(top >> 32) <= kDeadHi ? -1
            : cur.kind == kKindLeaf ? 1 + min(cur.cnt, p.w)
                                    : 0;
      }
      info = __shfl_sync(kFull, i, 0);
      off = __shfl_sync(kFull, cur.off, 0);
      if (info > 1) window_slots(p, off, info - 1, 0, lane, slot);
    }
  };
  tell();
  for (;;) {
    int lim = 0;
    if (kFiltered) {
      if (n_cand >= p.sk_dyn || info == -2) break;
      if (info == -1) {
        pops = p.pmax;  // an empty queue ends the query
        break;
      }
      lim = max(info - 1, 0);
      if (lim > 0) window_words(p, lim, 0, slot, word);  // in flight while lane 0 sifts
    } else if (n_cand >= p.sk_dyn || pops >= p.pmax) {
      break;
    } else if (static_cast<unsigned>(top >> 32) <= kDeadHi) {
      pops = p.pmax;  // an empty queue ends the query
      break;
    }
    if (lane == 0) {
      // the pop of `top`.  The next top is the split's larger child kp if
      // it is above the heap's root (down the tree: the heap keeps its
      // root), else the heap's root, which kp replaces (or, after a leaf,
      // the heap's last key).  The smaller child is pushed.
      Key next = hmax, kp = 0, pushed = 0;
      bool take_root = true;
      Row nrow = cur;
      if (!is_split(cur.kind)) {
        if (!kFiltered && cur.kind == kKindLeaf) {
          if (cur.cnt > 0 && n_leaf < p.out_w - 1) out[n_leaf++] = cur.ptr;
          n_cand += cur.cnt;
        }
      } else {
        const Key kl = pack(fminf(td, -mg), cur.left), kr = pack(fminf(td, mg), cur.right);
        kp = kl;
        Row rp = rl;
        if (n_pushed < p.q_cap) {
          pushed = kr;
          if (kr > kl) {
            kp = kr;
            pushed = kl;
            rp = rr;
          }
        }
        ++n_pushed;
        if (kp > hmax) {
          take_root = false;
          next = kp;
          nrow = rp;
        }
      }
      // the next pop's reads, issued before the heap is touched
      if (take_root) nrow = load_row(p, key_node(next));
      cur = nrow;
      fetch(p, mrow, cur, mg, rl, rr);
      top = next;
      td = key_dist(next);
      if (take_root && hs > 0) {
        if (!kp) {  // no key replaces the root: the last one fills it
          --hs;
          kp = h.get(hs);
          h.put(hs, 0ull);
        }
        if (hs > 0) h.sift_down(hs, kp);
      }
      if (pushed) {
        h.push(hs, pushed);
        ++hs;
      }
      hmax = hs > 0 ? h.get(0) : 0ull;
      ++pops;
    }
    if (kFiltered && lim > 0) {
      window_place(p, lim, 0, lane, slot, word, out, n_cand);
      for (int base = 32 * kWindowChunks; base < lim; base += 32 * kWindowChunks) {
        window_slots(p, off, lim, base, lane, slot);
        window_words(p, lim, base, slot, word);
        window_place(p, lim, base, lane, slot, word, out, n_cand);
      }
    }
    tell();
  }
  if (lane == 0) {
    if (!kFiltered) out[p.out_w - 1] = n_leaf;
    p.pops_out[b] = pops;
    p.ncand_out[b] = n_cand;
  }
}

template <bool kFiltered, bool kSpill>
int launch(const Params& p, int B, cudaStream_t s) {
  const size_t smem = static_cast<size_t>(p.smem_slots) * sizeof(Key);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(traverse_kernel<kFiltered, kSpill>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  traverse_kernel<kFiltered, kSpill><<<B, 32, smem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// One thread follows `steps` links of a pointer chain through L2
// (`ld.global.cg` skips L1): the time a step takes is the latency of one
// dependent read from L2, which bounds a pop from below (a pop's margin is
// read at an address that the node's row gives).
__global__ void chase_kernel(const int* next, int steps, int* sink) {
  int j = 0;
  for (int i = 0; i < steps; ++i) j = __ldcg(next + j);
  *sink = j;
}

}  // namespace

// next: a permutation cycle of int32 indices; sink: one int32.
extern "C" int chase(const void* next, int steps, void* sink, void* stream) {
  chase_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(next), steps, static_cast<int*>(sink));
  return static_cast<int>(cudaGetLastError());
}

// margins [B, S] f32; node_table [n_nodes, 8] int32, 16-byte aligned
// (stride must be 8); leaf_items int32; roots [t] int64; filter_words
// [n_words] int32 or null (unfiltered); out [B, out_w] int64 (out_w =
// l_cap unfiltered, search_k + w filtered); pops, n_cand [B] int64.  The
// heap array of a query holds smem_slots + scratch_slots 8-byte keys (both
// multiples of 8, together at least q_cap + 7): the first smem_slots in
// shared memory, the rest in scratch [B, scratch_slots] (16-byte aligned;
// null when scratch_slots is 0).  All contiguous, on one device.
extern "C" int traverse(const void* margins, int B, int S, const void* node_table, int n_nodes,
                        int stride, const void* leaf_items, const void* roots, int t,
                        const void* filter_words, int n_words, long long sk_dyn, int pmax, int w,
                        int q_cap, int out_w, int smem_slots, int scratch_slots, void* out,
                        void* pops, void* n_cand, void* scratch, void* stream) {
  if (B <= 0) return 0;
  if (t > q_cap || out_w < 1 || stride != kRowInts || n_nodes < 1 || smem_slots < 0 ||
      scratch_slots < 0 || smem_slots % kArity || scratch_slots % kArity ||
      static_cast<long long>(smem_slots) + scratch_slots < static_cast<long long>(q_cap) + kRoot ||
      (scratch_slots > 0 && scratch == nullptr) || reinterpret_cast<size_t>(node_table) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.margins = static_cast<const float*>(margins);
  p.node_table = static_cast<const int4*>(node_table);
  p.leaf_items = static_cast<const int*>(leaf_items);
  p.roots = static_cast<const long long*>(roots);
  p.filter_words = static_cast<const int*>(filter_words);
  p.scratch = static_cast<Key*>(scratch);
  p.out = static_cast<long long*>(out);
  p.pops_out = static_cast<long long*>(pops);
  p.ncand_out = static_cast<long long*>(n_cand);
  p.sk_dyn = static_cast<int>(sk_dyn < INT_MAX ? sk_dyn : INT_MAX);
  p.S = S;
  p.t = t;
  p.n_words = n_words;
  p.pmax = pmax;
  p.w = w;
  p.q_cap = q_cap;
  p.out_w = out_w;
  p.smem_slots = smem_slots;
  p.scratch_slots = scratch_slots;
  p.last = static_cast<unsigned>(n_nodes - 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (filter_words != nullptr) {
    return scratch_slots > 0 ? launch<true, true>(p, B, s) : launch<true, false>(p, B, s);
  }
  return scratch_slots > 0 ? launch<false, true>(p, B, s) : launch<false, false>(p, B, s);
}
