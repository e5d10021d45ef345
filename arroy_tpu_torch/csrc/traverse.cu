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
// What bounds it on this card: latency.  A pop is a chain of dependent
// reads (the queue's top, the node's row, the margin, the sift through the
// queue), and a batch holds a few hundred queries, so the card has few
// independent chains to overlap; bytes and operations are tiny.  What the
// design does about it:
// - one warp a query, a CTA a query, so every query's chain runs
//   concurrently (2 CTAs an SM at the largest shared queue: 264 resident
//   queries on 132 SMs); lane 0 owns the queue, so no lane ever reads a
//   queue entry another lane is writing;
// - the queue is a binary max-heap keyed on (distance as a float, node
//   id): O(log n) shared-memory steps a pop where the plain version scans
//   [q_cap] lanes.  Distances compare as floats, so -0.0 and +0.0 tie as
//   the plain `==` / `amax` tie them, and equal keys are the same node at
//   the same distance (repeated FREE roots), whose pop order cannot show;
// - heap slots [0, smem_lanes) live in shared memory and the rest in a
//   per-query global scratch, so the top levels, which every sift touches,
//   are on chip and a queue of any q_cap fits;
// - one node-table row (one 32-byte sector) and one margin read a pop;
// - a filtered leaf's window is compacted by the whole warp: a lane an
//   item, the filter bit read per lane, a ballot and a popc for each
//   item's place.
// The heap holds at most q_cap entries (a split is pushed once; a right
// child pushed past q_cap is dropped, as the plain version's trash lane
// drops it).
//
// Interface: plain C, pointers and the stream as void*, returns
// cudaGetLastError() after the launch.

#include <cuda_runtime.h>

namespace {

constexpr int kKindFree = -1;
constexpr int kKindSplitNone = 1;
constexpr int kKindLeaf = 2;
constexpr unsigned kFull = 0xffffffffu;

struct __align__(8) Entry {
  float d;
  int n;
};

// the max-heap order: larger distance first, ties to the larger node id
__device__ __forceinline__ bool above(const Entry& a, const Entry& b) {
  return a.d > b.d || (a.d == b.d && a.n > b.n);
}

struct Heap {
  Entry* sm;  // slots [0, ns)
  Entry* gl;  // slots [ns, q_cap)
  int ns;

  __device__ __forceinline__ Entry get(int k) const { return k < ns ? sm[k] : gl[k - ns]; }
  __device__ __forceinline__ void put(int k, const Entry& e) const {
    if (k < ns) {
      sm[k] = e;
    } else {
      gl[k - ns] = e;
    }
  }

  // place `e` in the hole at slot k, moving it toward the root
  __device__ void sift_up(int k, const Entry& e) const {
    while (k > 0) {
      const int p = (k - 1) >> 1;
      const Entry pe = get(p);
      if (!above(e, pe)) break;
      put(k, pe);
      k = p;
    }
    put(k, e);
  }

  // place `e` in the hole at the root of a heap of `size` entries
  __device__ void sift_down(int size, const Entry& e) const {
    int k = 0;
    for (;;) {
      int c = 2 * k + 1;
      if (c >= size) break;
      Entry ce = get(c);
      if (c + 1 < size) {
        const Entry c2 = get(c + 1);
        if (above(c2, ce)) {
          ce = c2;
          ++c;
        }
      }
      if (!above(ce, e)) break;
      put(k, ce);
      k = c;
    }
    put(k, e);
  }
};

struct Params {
  const float* margins;     // [B, S]
  const int* node_table;    // [n_nodes, stride]: kind, left, right, ptr, leaf_off, leaf_cnt
  const int* leaf_items;    // CSR slots, w entries of padding at the end
  const long long* roots;   // [t]
  const int* filter_words;  // [n_words] or null (unfiltered)
  Entry* scratch;           // [B, q_cap - ns] or null
  long long* out;           // [B, out_w]
  long long* pops_out;      // [B]
  long long* ncand_out;     // [B]
  long long sk_dyn;
  int S, n_nodes, stride, t, n_words, pmax, w, q_cap, out_w, ns;
};

template <bool kFiltered>
__global__ void __launch_bounds__(32) traverse_kernel(const Params p) {
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  extern __shared__ Entry smem[];
  const Heap h{smem, p.scratch + static_cast<size_t>(b) * (p.q_cap - p.ns), p.ns};
  const float* mrow = p.margins + static_cast<size_t>(b) * p.S;
  long long* out = p.out + static_cast<size_t>(b) * p.out_w;

  int hs = 0, pops = 0, n_leaf = 0, n_pushed = p.t;
  long long n_cand = 0;
  if (lane == 0) {
    for (int j = 0; j < p.t; ++j) {
      h.sift_up(hs, Entry{__int_as_float(0x7f800000), static_cast<int>(p.roots[j])});
      ++hs;
    }
  }
  for (;;) {
    // lane 0: the pop and the node's row; `go` says a row was popped
    int go = 0, kind = kKindFree, left = 0, right = 0, ptr = 0, off = 0, cnt = 0;
    float m = 0.f;
    if (lane == 0 && n_cand < p.sk_dyn && pops < p.pmax) {
      const Entry top = hs > 0 ? h.get(0) : Entry{__int_as_float(0xff800000), 0};
      if (top.d > __int_as_float(0xff800000)) {
        go = 1;
        m = top.d;
        if (top.n >= 0 && top.n < p.n_nodes) {
          const int* r = p.node_table + static_cast<size_t>(top.n) * p.stride;
          kind = __ldg(r);
          left = __ldg(r + 1);
          right = __ldg(r + 2);
          ptr = __ldg(r + 3);
          off = __ldg(r + 4);
          cnt = __ldg(r + 5);
        }
      } else {
        pops = p.pmax;  // an empty queue ends the query
      }
    }
    if (kFiltered) {
      go = __shfl_sync(kFull, go, 0);
      if (!go) break;
      kind = __shfl_sync(kFull, kind, 0);
      if (kind == kKindLeaf) {
        // the window's filter-accepted items, in window order, at n_cand
        off = __shfl_sync(kFull, off, 0);
        const int lim = min(__shfl_sync(kFull, cnt, 0), p.w);
        for (int base = 0; base < lim; base += 32) {
          const int j = base + lane;
          int slot = 0;
          bool ok = false;
          if (j < lim) {
            slot = __ldg(p.leaf_items + off + j);
            const int sc = max(slot, 0);
            const int wi = sc >> 5;
            ok = wi < p.n_words &&
                 ((static_cast<unsigned>(__ldg(p.filter_words + wi)) >> (sc & 31)) & 1u);
          }
          const unsigned mask = __ballot_sync(kFull, ok);
          if (ok) out[n_cand + __popc(mask & ((1u << lane) - 1u))] = slot;
          n_cand += __popc(mask);
        }
      }
    } else if (!go) {
      break;
    }
    if (lane != 0) continue;
    if (kind == kKindLeaf) {
      if (!kFiltered) {
        if (cnt > 0 && n_leaf < p.out_w - 1) out[n_leaf++] = ptr;
        n_cand += cnt;
      }
      --hs;
      if (hs > 0) h.sift_down(hs, h.get(hs));
    } else if (kind == kKindFree) {
      --hs;
      if (hs > 0) h.sift_down(hs, h.get(hs));
    } else {
      float mg = 0.f;
      if (kind != kKindSplitNone && p.S > 0) mg = mrow[min(max(ptr, 0), p.S - 1)];
      h.sift_down(hs, Entry{fminf(m, -mg), left});
      if (n_pushed < p.q_cap) {
        h.sift_up(hs, Entry{fminf(m, mg), right});
        ++hs;
      }
      ++n_pushed;
    }
    ++pops;
  }
  __syncwarp();
  // the tail: unfiltered, zeros past the count and the count in the last
  // slot; filtered, -1 past the candidates
  if (kFiltered) {
    for (long long j = n_cand + lane; j < p.out_w; j += 32) out[j] = -1;
  } else {
    n_leaf = __shfl_sync(kFull, n_leaf, 0);
    for (int j = n_leaf + lane; j < p.out_w - 1; j += 32) out[j] = 0;
  }
  if (lane == 0) {
    if (!kFiltered) out[p.out_w - 1] = n_leaf;
    p.pops_out[b] = pops;
    p.ncand_out[b] = n_cand;
  }
}

template <bool kFiltered>
int launch(const Params& p, int B, cudaStream_t s) {
  const size_t smem = static_cast<size_t>(p.ns) * sizeof(Entry);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        traverse_kernel<kFiltered>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  traverse_kernel<kFiltered><<<B, 32, smem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// One thread follows `steps` links of a pointer chain through L2
// (`ld.global.cg` skips L1): the time a step takes is the latency of one
// dependent read from L2, which bounds a pop from below (a pop's node row
// is read at an address that the queue's top gives).
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

// margins [B, S] f32; node_table [n_nodes, stride] int32; leaf_items int32;
// roots [t] int64; filter_words [n_words] int32 or null (unfiltered);
// out [B, out_w] int64 (out_w = l_cap unfiltered, search_k + w filtered);
// pops, n_cand [B] int64; scratch: B * (q_cap - smem_lanes) 8-byte heap
// slots, or null when smem_lanes == q_cap.  All contiguous, on one
// device.
extern "C" int traverse(const void* margins, int B, int S, const void* node_table, int n_nodes,
                        int stride, const void* leaf_items, const void* roots, int t,
                        const void* filter_words, int n_words, long long sk_dyn, int pmax, int w,
                        int q_cap, int out_w, int smem_lanes, void* out, void* pops, void* n_cand,
                        void* scratch, void* stream) {
  if (B <= 0) return 0;
  if (t > q_cap || smem_lanes < 0 || smem_lanes > q_cap || out_w < 1 || stride < 6) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.margins = static_cast<const float*>(margins);
  p.node_table = static_cast<const int*>(node_table);
  p.leaf_items = static_cast<const int*>(leaf_items);
  p.roots = static_cast<const long long*>(roots);
  p.filter_words = static_cast<const int*>(filter_words);
  p.scratch = static_cast<Entry*>(scratch);
  p.out = static_cast<long long*>(out);
  p.pops_out = static_cast<long long*>(pops);
  p.ncand_out = static_cast<long long*>(n_cand);
  p.sk_dyn = sk_dyn;
  p.S = S;
  p.n_nodes = n_nodes;
  p.stride = stride;
  p.t = t;
  p.n_words = n_words;
  p.pmax = pmax;
  p.w = w;
  p.q_cap = q_cap;
  p.out_w = out_w;
  p.ns = smem_lanes;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return filter_words != nullptr ? launch<true>(p, B, s) : launch<false>(p, B, s);
}
