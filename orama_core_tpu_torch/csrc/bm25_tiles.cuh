// The doc-tile BM25 scan: the per-doc sum of a posting block plan's
// BM25 contributions, summed in shared memory one tile of the score row
// at a time and written once, with no global atomic and no fill. B3's two
// forms (bm25_scan_variants.cu) run on it. Include it after
// bm25_scan.cuh: the repair path below is K1's loop (bm25scan::scan) as
// it is. The library is built with relocatable device code and the
// device runtime (ops/_cuda.py): the repair is a tail launch.
//
// The function is bm25_scan.cuh's: scores[d] is the sum, over each plan
// block's window [lo, hi), of the contributions of the postings whose doc
// is d; a doc id outside [0, n_docs) is dropped; the walk stops at the
// first plan block with hi <= 0; a doc with no posting scores 0.
//
// Design. The row is cut into tiles of kTileDocs consecutive docs. A
// block owns one tile at a time (persistent over tiles), keeps an
// f32[kTileDocs] accumulator in shared memory, and for each plan window
// takes the run of postings [s_t, e_t) that falls in its tile:
//
//   f(w, k)  = lo                      if docs[lo] >= k
//            = hi                      else if docs[hi - 1] < k
//            = the warp search's b     else (32 probes a step over
//                                      [lo, hi - 1]: lower_bound when the
//                                      window ascends)
//   s_t = lo if t == 0 else f(w, t T)
//   e_t = hi if t is the last tile else f(w, (t + 1) T)
//
// f depends only on the window and the key, so tile t's e_t is tile
// t + 1's s_{t+1}, and the runs chain: lo = s_0, e_0 = s_1, ...,
// e_last = hi. Most windows are rejected by their two end docs alone. The
// run's postings are read with 16-byte loads (head and tail masked), each
// contribution added into the tile with a shared atomicAdd, and the tile
// written with 16-byte stores, zeros included, cut at n_docs.
//
// Exact for any order, and says so. A block checks (1) every run has
// e_t >= s_t and (2) every posting it reads has its doc in its own tile,
// except that tile 0 drops ids below 0 and the last tile drops ids of
// n_docs or more (the reference's segment_sum drops both). If (1) holds
// for every tile, lo = s_0 <= e_0 = s_1 <= ... <= e_last = hi, so the runs
// partition [lo, hi): each posting is read by exactly one tile. If (2)
// holds too, that tile adds it to its own doc or drops it as the
// reference does. So when every check passes the sums are the
// reference's, whatever order the window has; a window whose doc ids
// ascend always passes. The first block whose check fails sets g_fail
// and tail-launches repair_kernel, which runs after every block of the
// grid has written its tile: one block zeroes the row, re-adds every
// window with global atomics through K1's loop, adds one to g_repairs
// (read by bm25_scan_repairs) and clears g_fail. A call that passes pays
// nothing for this (no completion counter, no fence), and no call needs
// a memset. The workspace is per device: calls on one device must not
// run concurrently on two streams.
//
// Bound on this card: bytes. Each posting is read once (16 or 8 B), each
// score written once (4 B); the plan (12 B a block) is read by every tile
// from L2. PERF.md records the SASS of the shared f32 adds.

namespace {
namespace bm25tiles {

constexpr int kTileDocs = 8192;    // docs a tile (a block's shared row)
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kWindows = 1024;     // plan windows a block takes per round
constexpr int kAheadWide = 1;      // chunks whose loads a warp issues at
constexpr int kAheadPacked = 2;    // once: four planes, packed
constexpr int kChunk = 128;        // postings a warp step (32 lanes x 4)
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSearch = -1;        // a boundary the end docs do not settle

// shared memory of a block, after the f32[kTileDocs] accumulator
struct Smem {
  int run_s[kWindows];             // the round's runs [s, e), absolute
  int run_e[kWindows];
  float run_idf[kWindows];         // packed: the run's plan block's idf
  int run_c0[kWindows];            // the runs' first chunks, laid end to end
  int q_a[2 * kWindows];           // searches: range [a, b], and where
  int q_b[2 * kWindows];           // the result goes (slot * 2 + which)
  int q_dst[2 * kWindows];
  int res[2 * kWindows];           // search results by slot * 2 + which
  int n_runs, n_search, n_chunks, stop;
};
constexpr int kSmemBytes = kTileDocs * 4 + (int)sizeof(Smem);

__device__ unsigned int g_fail;          // a repair is queued for this call
__device__ unsigned long long g_repairs; // calls repaired

// The first b in (a, b] of the warp's 32-ary search for key: lane j
// probes p_j = min(a + (j + 1) * step, b); the first lane with p_j == b or
// docs[p_j] >= key gives the new b, its left neighbour the new a. Needs
// docs[a] < key <= docs[b] on entry (or b the end); the same window and
// key always give the same b.
__device__ __forceinline__ int warp_search(const int* __restrict__ docs,
                                           int a, int b, long long key,
                                           int lane) {
  while (b - a > 1) {
    const int step = (b - a + 31) >> 5;
    const long long pl = (long long)a + (long long)(lane + 1) * step;
    const int p = pl < b ? (int)pl : b;
    const bool hit = p >= b || (long long)__ldg(docs + p) >= key;
    const int f = __ffs(__ballot_sync(kFull, hit)) - 1;
    const int pf = __shfl_sync(kFull, p, f);
    a = f == 0 ? a : a + f * step;
    b = pf;
  }
  return b;
}

// The tile's accumulation of the runs in s.run_*, laid end to end in
// chunks of kChunk postings (run r's first chunk is s.run_c0[r]): warp w
// takes chunks w, w + kWarps, ...; lane j of a warp finds the run of the
// warp's j-th chunk (a binary search of run_c0) and shuffles it to the
// others, kAhead chunks' loads in flight at once, as K1's loop holds its
// plan blocks. Returns whether a posting fell outside the tile (and was
// not dropped).
template <bool kPacked>
__device__ __forceinline__ bool accumulate(
    const Smem& s, float* __restrict__ acc, const int4* __restrict__ docs,
    const float4* __restrict__ tf, const float4* __restrict__ ni,
    const float4* __restrict__ lens, const int4* __restrict__ packed,
    float boost, float avgdl_c, float nfd, int base, unsigned n_here,
    bool first, bool last, long long n_docs) {
  constexpr int kAhead = kPacked ? kAheadPacked : kAheadWide;
  const int lane = threadIdx.x & 31;
  const int n_runs = s.n_runs, n_chunks = s.n_chunks;
  // den = tf + k1 (1 - b) + k1 b len / avgdl, the numerator's constant
  const float den0 = bm25scan::kK1 * (1.0f - bm25scan::kB);
  const float den1 = bm25scan::kK1 * bm25scan::kB / avgdl_c;
  const float num1 = boost * (bm25scan::kK1 + 1.0f);
  float ni_last = -1.0f, idf_last = 0.0f;  // four planes: ni repeats
  bool bad = false;
  for (int g0 = threadIdx.x >> 5; g0 < n_chunks; g0 += 32 * kWarps) {
    const int my_g = g0 + lane * kWarps;
    int rs = 0, re = 0, q0 = 0;
    float ridf = 0.0f;
    if (my_g < n_chunks) {
      int r = 0;  // the last run whose first chunk is at most my_g
#pragma unroll
      for (int bit = kWindows / 2; bit > 0; bit >>= 1)
        if (r + bit < n_runs && s.run_c0[r + bit] <= my_g) r += bit;
      rs = s.run_s[r];
      re = s.run_e[r];
      ridf = s.run_idf[r];
      q0 = (rs & ~3) + (my_g - s.run_c0[r]) * kChunk;
    }
    const int n_mine = min(32, (n_chunks - g0 + kWarps - 1) / kWarps);
    for (int j0 = 0; j0 < n_mine; j0 += kAhead) {
      int q[kAhead], lo_[kAhead], hi_[kAhead];
      float idf_[kAhead];
      int4 d[kAhead], p[kAhead];
      float4 t[kAhead], n[kAhead], l[kAhead];
#pragma unroll
      for (int k = 0; k < kAhead; ++k) {
        q[k] = __shfl_sync(kFull, q0, j0 + k) + 4 * lane;
        lo_[k] = __shfl_sync(kFull, rs, j0 + k);
        hi_[k] = __shfl_sync(kFull, re, j0 + k);
        idf_[k] = __shfl_sync(kFull, ridf, j0 + k);
        if (q[k] < hi_[k]) {
          d[k] = __ldg(docs + (q[k] >> 2));
          if (kPacked) {
            p[k] = __ldg(packed + (q[k] >> 2));
          } else {
            t[k] = __ldg(tf + (q[k] >> 2));
            n[k] = __ldg(ni + (q[k] >> 2));
            l[k] = __ldg(lens + (q[k] >> 2));
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kAhead; ++k) {
        if (q[k] >= hi_[k]) continue;
        const int dd[4] = {d[k].x, d[k].y, d[k].z, d[k].w};
        float tt[4], nn[4], ll[4];
        if (kPacked) {
          const int pp[4] = {p[k].x, p[k].y, p[k].z, p[k].w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            tt[e] = (float)(pp[e] & 0xFFFF);
            ll[e] = (float)((unsigned)pp[e] >> 16);
          }
        } else {
          tt[0] = t[k].x; tt[1] = t[k].y; tt[2] = t[k].z; tt[3] = t[k].w;
          nn[0] = n[k].x; nn[1] = n[k].y; nn[2] = n[k].z; nn[3] = n[k].w;
          ll[0] = l[k].x; ll[1] = l[k].y; ll[2] = l[k].z; ll[3] = l[k].w;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int jj = q[k] + e;
          if (jj < lo_[k] || jj >= hi_[k]) continue;
          // wraps for a doc below the tile: one compare bounds both ends
          const unsigned local = (unsigned)dd[e] - (unsigned)base;
          if (local < n_here) {
            if (!kPacked && nn[e] != ni_last) {
              ni_last = nn[e];
              idf_last = bm25scan::idf_of(nn[e], nfd);
            }
            const float idf = kPacked ? idf_[k] : idf_last;
            const float den = fmaxf(tt[e] + fmaf(den1, ll[e], den0), 1e-9f);
            atomicAdd(&acc[local], __fdividef(idf * tt[e] * num1, den));
          } else if (!((first && dd[e] < 0) || (last && dd[e] >= n_docs))) {
            bad = true;  // a foreign doc in this tile's run
          }
        }
      }
    }
  }
  return bad;
}

// The repair, tail-launched by the tile grid's first block whose check
// failed, so it runs once every tile is written: one block zeroes the row,
// re-adds every window with global atomics through K1's loop (the grid is
// one block, as the loop's warp numbering needs), counts the repair and
// clears the flag for the next call.
template <int kBlock, bool kPacked>
__global__ void __launch_bounds__(bm25scan::kThreads) repair_kernel(
    const int4* __restrict__ docs, const float4* __restrict__ tf,
    const float4* __restrict__ ni, const float4* __restrict__ lens,
    const int4* __restrict__ packed, const int* __restrict__ ni_blk,
    const int* __restrict__ blk, const int* __restrict__ lo,
    const int* __restrict__ hi, float boost, float avgdl, float nfd,
    float* __restrict__ scores, int n_blocks, long long n_docs) {
  for (long long i = threadIdx.x; i < n_docs; i += blockDim.x)
    scores[i] = 0.0f;
  __syncthreads();
  bm25scan::scan<kBlock, kPacked, false>(docs, tf, ni, lens, packed, ni_blk,
                                         blk, lo, hi, nullptr, boost, avgdl,
                                         nfd, scores, n_blocks, n_docs);
  if (threadIdx.x == 0) {
    g_repairs += 1;
    g_fail = 0;
  }
}

template <int kBlock, bool kPacked>
__global__ void __launch_bounds__(kThreads) tile_kernel(
    const int4* __restrict__ docs, const float4* __restrict__ tf,
    const float4* __restrict__ ni, const float4* __restrict__ lens,
    const int4* __restrict__ packed, const int* __restrict__ ni_blk,
    const int* __restrict__ blk, const int* __restrict__ lo,
    const int* __restrict__ hi, float boost, float avgdl, float nfd,
    float* __restrict__ scores, int n_blocks, long long n_docs) {
  extern __shared__ float4 smem4[];
  float* acc = reinterpret_cast<float*>(smem4);
  Smem& s = *reinterpret_cast<Smem*>(acc + kTileDocs);
  constexpr int kPer = kWindows / kThreads;  // windows a thread takes
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int* docs_i = reinterpret_cast<const int*>(docs);
  const float avgdl_c = fmaxf(avgdl, 1e-9f);
  const long long n_tiles = (n_docs + kTileDocs - 1) / kTileDocs;
  for (int i = tid; i < kTileDocs; i += kThreads) acc[i] = 0.0f;
  if (tid == 0) s.stop = n_blocks;
  __syncthreads();
  bool bad = false;

  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int base = (int)(t * kTileDocs);  // n_docs < 2^31
    const bool first = t == 0, last = t == n_tiles - 1;
    const unsigned n_here = (unsigned)min((long long)kTileDocs, n_docs - base);
    for (int w0 = 0;; w0 += kWindows) {
      // the round's plan entries; the walk ends at the first hi <= 0
      int wb[kPer], wl[kPer], wh[kPer], wn[kPer];
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int i = w0 + tid + k * kThreads;
        wh[k] = 0;
        if (i < n_blocks) {
          wb[k] = __ldg(blk + i);
          wl[k] = __ldg(lo + i);
          wh[k] = __ldg(hi + i);
          if (kPacked) wn[k] = __ldg(ni_blk + i);
          if (wh[k] <= 0) atomicMin(&s.stop, i);
        }
      }
      if (tid == 0) {
        s.n_runs = 0;
        s.n_search = 0;
      }
      __syncthreads();
      const int stop = s.stop;
      if (w0 >= stop) break;
      // each window's boundaries from its end docs, or a search
      int ws[kPer], we[kPer];
      float widf[kPer];
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int i = w0 + tid + k * kThreads;
        ws[k] = 0;
        we[k] = 0;
        const int l0 = min(max(wl[k], 0), kBlock);
        const int h0 = min(max(wh[k], 0), kBlock);
        if (i >= stop || h0 <= l0) continue;
        const int a = wb[k] * kBlock + l0, b = wb[k] * kBlock + h0;
        const long long d0 = __ldg(docs_i + a), d1 = __ldg(docs_i + b - 1);
        const int slot = tid + k * kThreads;
        // f(w, key), or kSearch with the search queued
        auto bound = [&](long long key, int which) {
          if (d0 >= key) return a;
          if (d1 < key) return b;
          const int j = atomicAdd(&s.n_search, 1);
          s.q_a[j] = a;
          s.q_b[j] = b - 1;
          s.q_dst[j] = slot * 2 + which;
          return kSearch;
        };
        ws[k] = first ? a : bound(base, 0);
        we[k] = last ? b : bound((long long)base + kTileDocs, 1);
        widf[k] = kPacked ? bm25scan::idf_of((float)wn[k], nfd) : 0.0f;
        if (ws[k] != kSearch && we[k] != kSearch) {
          if (we[k] > ws[k]) {
            const int j = atomicAdd(&s.n_runs, 1);
            s.run_s[j] = ws[k];
            s.run_e[j] = we[k];
            s.run_idf[j] = widf[k];
          } else if (we[k] < ws[k]) {
            bad = true;  // a run of negative length
          }
        }
      }
      __syncthreads();
      // the searches, one a warp at a time
      const int n_search = s.n_search;
      for (int j = warp; j < n_search; j += kWarps) {
        const int dst = s.q_dst[j];
        const long long key = (long long)base + ((dst & 1) ? kTileDocs : 0);
        const int b = warp_search(docs_i, s.q_a[j], s.q_b[j], key, lane);
        if (lane == 0) s.res[dst] = b;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        if (ws[k] != kSearch && we[k] != kSearch) continue;
        const int slot = tid + k * kThreads;
        const int rs = ws[k] == kSearch ? s.res[slot * 2] : ws[k];
        const int re = we[k] == kSearch ? s.res[slot * 2 + 1] : we[k];
        if (re > rs) {
          const int j = atomicAdd(&s.n_runs, 1);
          s.run_s[j] = rs;
          s.run_e[j] = re;
          s.run_idf[j] = widf[k];
        } else if (re < rs) {
          bad = true;
        }
      }
      __syncthreads();
      // the runs' first chunks: an exclusive scan of their chunk counts
      if (warp == 0) {
        int carry = 0;
        for (int r0 = 0; r0 < s.n_runs; r0 += 32) {
          const int r = r0 + lane;
          const int c = r < s.n_runs
              ? (s.run_e[r] - (s.run_s[r] & ~3) + kChunk - 1) / kChunk : 0;
          int x = c;
#pragma unroll
          for (int o = 1; o < 32; o <<= 1) {
            const int y = __shfl_up_sync(kFull, x, o);
            if (lane >= o) x += y;
          }
          if (r < s.n_runs) s.run_c0[r] = carry + x - c;
          carry += __shfl_sync(kFull, x, 31);
        }
        if (lane == 0) s.n_chunks = carry;
      }
      __syncthreads();
      bad |= accumulate<kPacked>(s, acc, docs, tf, ni, lens, packed, boost,
                                 avgdl_c, nfd, base, n_here, first, last,
                                 n_docs);
      __syncthreads();
    }
    // the tile, written once (zeros included) and cleared for the next
    for (int i = 4 * tid; i < kTileDocs; i += 4 * kThreads) {
      const float4 v = *reinterpret_cast<const float4*>(acc + i);
      if (i + 4 <= (int)n_here) {
        *reinterpret_cast<float4*>(scores + base + i) = v;
      } else {
        const float vv[4] = {v.x, v.y, v.z, v.w};
        for (int e = 0; e < 4 && i + e < (int)n_here; ++e)
          scores[base + i + e] = vv[e];
      }
      *reinterpret_cast<float4*>(acc + i) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncthreads();
  }

  // a failed check: the first block to see one queues the repair behind
  // the grid
  if (__syncthreads_or(bad) && tid == 0 && atomicExch(&g_fail, 1u) == 0u) {
    repair_kernel<kBlock, kPacked>
        <<<1, bm25scan::kThreads, 0, cudaStreamTailLaunch>>>(
            docs, tf, ni, lens, packed, ni_blk, blk, lo, hi, boost, avgdl,
            nfd, scores, n_blocks, n_docs);
    // never a silent miss: a repair that cannot start fails the call
    if (cudaGetLastError() != cudaSuccess) __trap();
  }
}

// Launches tile_kernel on a persistent grid: one block a tile, capped at
// what the card holds at once.
template <int kBlock, bool kPacked>
int launch(const void* docs, const void* tf, const void* ni,
           const void* lens, const void* packed, const void* ni_blk,
           const void* blk, const void* lo, const void* hi, float boost,
           float avgdl, float nfd, void* scores, int n_blocks,
           long long n_docs, void* stream) {
  static int grid_cap[64] = {};  // by device: SMs x resident blocks
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (grid_cap[dev] == 0) {
    int sms = 0, per_sm = 0;
    cudaFuncSetAttribute(tile_kernel<kBlock, kPacked>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kSmemBytes);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, tile_kernel<kBlock, kPacked>, kThreads, kSmemBytes);
    const int err = (int)cudaGetLastError();
    if (err) return err;
    const int cap = sms * per_sm;
    grid_cap[dev] = cap < 1 ? 1 : cap;
  }
  const long long tiles = (n_docs + kTileDocs - 1) / kTileDocs;
  const unsigned grid =
      (unsigned)(tiles < grid_cap[dev] ? tiles : grid_cap[dev]);
  tile_kernel<kBlock, kPacked><<<grid, kThreads, kSmemBytes,
                                 (cudaStream_t)stream>>>(
      (const int4*)docs, (const float4*)tf, (const float4*)ni,
      (const float4*)lens, (const int4*)packed, (const int*)ni_blk,
      (const int*)blk, (const int*)lo, (const int*)hi, boost, avgdl, nfd,
      (float*)scores, n_blocks, n_docs);
  return (int)cudaGetLastError();
}

// The repairs so far on the current device -> *out (host memory)
int repairs(unsigned long long* out, void* stream) {
  cudaMemcpyFromSymbolAsync(out, g_repairs, sizeof(*out), 0,
                            cudaMemcpyDeviceToHost, (cudaStream_t)stream);
  cudaStreamSynchronize((cudaStream_t)stream);
  return (int)cudaGetLastError();
}

}  // namespace bm25tiles
}  // namespace
