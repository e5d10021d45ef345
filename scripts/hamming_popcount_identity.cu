// Kernel 2's other identity, kept to be timed against the shipped kernel:
//   h = popc(q row) + popc(x row) - 2 sum_w popc(q & x),
// one AND-MMA per tile and k-step (half of what hamming.cu issues), paid
// for with every staged row's popcount and two adds and a shift per
// output.  scripts/torch_hamming_tune.py splices this kernel into
// arroy_tpu_torch/csrc/hamming.cu in place of hamming.cu's own, with room
// for two sets of row popcounts ([kRows] ints each) after the two staging
// buffers; everything else (tiles, staging, fragments, the store pattern)
// is the shipped kernel's.  Not built into the package.

__global__ void __launch_bounds__(kThreads, kMinBlocks)
hamming_kernel(const uint32_t* __restrict__ q, const uint32_t* __restrict__ x,
               int* __restrict__ out, int B, int M, int w, int nq, int nx, int vec) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int steps = (w + 7) / 8;  // k-steps over a whole row
  const int chunks = (steps + kChunkSteps - 1) / kChunkSteps;
  const int stride = 8 * min(steps, kChunkSteps) + 4;  // words between staged rows
  uint32_t* bufs[2] = {smem, smem + kRows * stride};   // [kRows][stride] each
  int* pops[2] = {(int*)smem + 2 * kRows * stride,     // [kRows] each: row popcounts
                  (int*)smem + 2 * kRows * stride + kRows};

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wq = warp % kWarpsQ, wx = warp / kWarpsQ;
  const int g = lane >> 2, tig = lane & 3;
  const int qa = (wq * 16 * kMT + (lane & 15)) * stride + (lane >> 4) * 4;
  const int xb = (kTileQ + wx * 32 + (lane >> 4) * 8 + (lane & 7)) * stride + ((lane >> 3) & 1) * 4;

  const int n_stages = (nq * nx - blockIdx.x + gridDim.x - 1) / gridDim.x * chunks;
  auto start = [&](int s) {
    const int tile = blockIdx.x + (s / chunks) * gridDim.x;
    const int c = s % chunks;
    stage(q, x, bufs[s & 1], tile_q(tile, nq, nx) * kTileQ, tile_x(tile, nq, nx) * kTileX, B, M,
          w, 8 * kChunkSteps * c, 8 * min(kChunkSteps, steps - kChunkSteps * c), stride, vec);
  };
  start(0);
  int acc[kMT][4][4];
  // one barrier a stage; a tile's stores wait for the next stage's barrier,
  // which makes its row popcounts visible, so the loop runs once more
  for (int s = 0;; ++s) {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    if (s + 1 < n_stages) start(s + 1);

    if (s > 0 && s % chunks == 0) {
      // epilogue of the tile that stage s - 1 closed, stored as hamming.cu
      // stores it
      const int lt = s / chunks - 1;  // this CTA's tile count
      const int tile = blockIdx.x + lt * gridDim.x;
      const int* pop = pops[lt & 1];
      const int b0 = tile_q(tile, nq, nx) * kTileQ, m0 = tile_x(tile, nq, nx) * kTileX;
      const bool whole = (M & 3) == 0 && b0 + kTileQ <= B && m0 + kTileX <= M;
      const int odd = g & 1;
      const int col = m0 + wx * 32 + 16 * odd + 4 * tig;
      int px[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) px[j][e] = pop[kTileQ + wx * 32 + j * 8 + 2 * tig + e];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int pq = pop[wq * 16 * kMT + mt * 16 + g + 8 * hh];
          int v[2][4], got[4];
#pragma unroll
          for (int sh = 0; sh < 2; ++sh)
#pragma unroll
            for (int i = 0; i < 4; ++i)
              v[sh][i] = pq + px[2 * sh + (i >> 1)][i & 1] -
                         2 * acc[mt][2 * sh + (i >> 1)][2 * hh + (i & 1)];
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
    if (s == n_stages) break;

    const int lt = s / chunks;
    const int c = s % chunks;
    const int kc = min(kChunkSteps, steps - kChunkSteps * c);
    const uint32_t* buf = bufs[s & 1];
    // row popcounts, one thread a row (16-byte reads, an odd number of
    // 16-byte units apart: no bank conflicts)
    for (int r = threadIdx.x; r < kRows; r += kThreads) {
      const uint4* row = (const uint4*)(buf + r * stride);
      int n = c ? pops[lt & 1][r] : 0;  // the same thread owns row r every chunk
      for (int k = 0; k < 2 * kc; ++k) {
        const uint4 u = row[k];
        n += __popc(u.x) + __popc(u.y) + __popc(u.z) + __popc(u.w);
      }
      pops[lt & 1][r] = n;
    }
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
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        uint32_t a[4];
        ldmatrix_x4(a, buf + qa + mt * 16 * stride + ks * 8);
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_and_popc(acc[mt][j], a, bf[j][0], bf[j][1]);
      }
    }
  }
}

