// K4: per-doc phrase counts over the doc-sorted position stream.
//
// Replaces: orama_core_tpu/ops/bm25.py::_phrase_window_kernel (driven by
// phrase_boost_docmajor_windowed). Mosaic has no scatter, so the TPU
// kernel bins each 2048-position block of packed anyc + 4096*seqc flags
// into a commit-static doc window with two compare-sum stages; a split
// and a page segment_sum outside the kernel then give per-doc counts.
// This kernel computes the reference's cumsum form instead
// (orama_core_tpu/ops/bm25.py::phrase_boost_docmajor): per doc d,
// count[d] = S(bounds[d + 1]) - S(bounds[d]), where S is the running sum
// of a per-position flag over the stream and bounds is the per-doc CSR of
// the stream. The windows (W, wsub, w_base) are not needed.
//
// Bound on this card: bytes. Every real position is read once, a 1-byte
// bit field and a 4-byte term id, and each doc's two int32 counts are
// written once; a few integer operations per position stay far below the
// card's rate.
//
// Design: a persistent grid (SMs x resident blocks, six blocks of 128
// threads per SM). Block b owns the docs whose first position falls in
// [b*P/nb, (b+1)*P/nb), P = bounds[n_docs], found by a 128-way parallel
// search of bounds (four rounds at 1M docs) while the first tiles of the
// share already stream in. The docs past the last position (bounds[d] == P, all
// empty) are written as zeros by every block in a grid-stride loop rather
// than by the last block alone, so a capacity far above the live docs does
// not serialise on one block. Every doc is written by exactly one block:
// no atomics, no memset, and the result does not depend on order.
//
// A block streams the positions of its own docs, [bounds[d_lo],
// bounds[d_hi]), in order, in tiles of 2048 positions (+ a 16-position
// look-ahead for the next-group test), through a 3-stage ring of 16-byte
// cp.async copies (2 tiles, 20 KB, in flight per block, 120 KB per SM). Positions at or
// past P are never read (zero-filled). The term ids of a tile sit in
// shared memory with each thread's four 16-byte chunks rotated by
// (thread / 2) % 4, so a warp's 16-byte reads of its threads' own chunks
// meet no bank conflict. Per tile, in one pass, each thread takes 16
// consecutive positions:
//   - tests their term ids against the query's spans, staged once per
//     block in shared memory, sorted and merged into disjoint ranges
//     (empty spans dropped): up to two ranges by compares on registers,
//     more by a binary search whose first step is held in a register, so
//     the 4-, 16- and 32-span buckets cost only their real ranges;
//   - evaluates the reference's group logic (_phrase_group_flags_bits)
//     four positions per 32-bit word; the neighbours at -2, -1 and +1
//     come from the lanes beside it by shuffles (the warp's edge lanes
//     test their one or two outside positions themselves), and the
//     tile's first position reads the previous tile's last word;
//   - a warp scan of the packed (anyc, seqc) counts, then a block scan
//     through shared memory, gives the running sums, carried across
//     tiles;
//   - each thread owns one doc of a 128-doc chunk of the block's docs and
//     reads S at the doc's start and end as the tiles that hold them pass
//     by; when the doc's end has passed it writes both counts. The next
//     chunk's bounds are loaded one chunk ahead.
// Two barriers per tile: the scan's buffers are double-buffered by tile
// parity. The group logic never reads across a doc (next_same and adj_key
// link positions of one doc, and a doc's first position is a group head),
// so a block needs no halo from its neighbours, only the last word of its
// own previous tile.
//
// A doc longer than P/nb positions leaves its block with more work than
// the others (blocks whose share lies inside it own nothing and exit). That
// is correct and slower; the card-only tests cover it. A long run of empty
// docs inside the stream costs one chunk load (a memory round trip) per
// 128 docs.

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 16;                 // positions per thread and tile
constexpr int kTile = kThreads * kPer;   // 2048 positions per tile
constexpr int kSpan = kTile + 16;        // + the look-ahead chunk
constexpr int kStages = 3;
constexpr int kMaxSpans = 32;
constexpr int kBitChunks = kSpan / 16;   // 16-byte copies of a tile's bits
constexpr int kTermChunks = kSpan / 4;   // 16-byte copies of its term ids
constexpr uint32_t kL = 0x01010101u;     // bit 0 of each byte
constexpr unsigned kFull = 0xffffffffu;

struct __align__(16) Smem {
  int terms[kStages][kSpan];     // 16-byte chunk c at slot swz(c)
  uint8_t bits[kStages][kSpan];
  uint4 cw[2][kThreads];         // per tile parity and thread: anyc in
                                 // bit 0, seqc in bit 1 of each position
  int base[2][kThreads];         // exclusive scan of the packed counts
                                 // within the thread's warp
  int warp_sum[2][kWarps];
  int span_lo[kMaxSpans];  // merged query spans, sorted; pads INT_MAX
  int span_hi[kMaxSpans];
  int sort_lo[kMaxSpans];
  int sort_hi[kMaxSpans];
  uint32_t halo[2];        // last word (4 positions) of the previous tile
  int n_spans;
};

// the chunk of term ids at 16-byte chunk index c sits at this slot
__device__ __forceinline__ int swz(int c) { return c ^ ((c >> 3) & 3); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; bytes past `src_bytes` are zero-filled
__device__ __forceinline__ void cp16(void* dst, const void* src,
                                     int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Warp 0: the query's spans, empty ones dropped, sorted by lo and merged
// into disjoint ranges (overlapping or touching spans join; membership is
// unchanged), padded with empty ranges.
__device__ void stage_spans(Smem& sm, const int* __restrict__ spans_g,
                            int n_spans, int lane) {
  int lo = INT_MAX, hi = INT_MAX;
  if (lane < n_spans) {
    lo = spans_g[2 * lane];
    hi = spans_g[2 * lane + 1];
    if (lo >= hi) lo = hi = INT_MAX;
  }
  int rank = 0;
  for (int j = 0; j < 32; ++j) {
    const int o = __shfl_sync(kFull, lo, j);
    rank += (o < lo) || (o == lo && j < lane);
  }
  sm.sort_lo[rank] = lo;
  sm.sort_hi[rank] = hi;
  __syncwarp();
  lo = sm.sort_lo[lane];
  hi = sm.sort_hi[lane];
  const bool real = lo != INT_MAX;
  int cm = real ? hi : INT_MIN;  // running max of hi up to this lane
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(kFull, cm, off);
    if (lane >= off) cm = max(cm, o);
  }
  int before = __shfl_up_sync(kFull, cm, 1);
  if (lane == 0) before = INT_MIN;
  const bool start = real && lo > before;
  const unsigned starts = __ballot_sync(kFull, start);
  const unsigned reals = __ballot_sync(kFull, real);
  const int g = __popc(starts & (kFull >> (31 - lane))) - 1;
  const bool next_starts =
      lane == 31 || !((reals >> (lane + 1)) & 1u) ||
      ((starts >> (lane + 1)) & 1u);
  const int n = __popc(starts);
  if (start) sm.span_lo[g] = lo;
  if (real && next_starts) sm.span_hi[g] = cm;
  if (lane >= n) {
    sm.span_lo[lane] = INT_MAX;
    sm.span_hi[lane] = INT_MIN;
  }
  if (lane == 0) sm.n_spans = n;
}

// Is term id t in a merged span? Binary search over the sorted starts; the
// first step compares with span_lo[top], held by the caller in lo_top.
struct Spans {
  int n, top, lo_top, lo0, hi0, lo1, hi1;
};

__device__ __forceinline__ uint32_t matched(const Smem& sm, const Spans& q,
                                            int t) {
  if (q.top <= 1) {  // at most two ranges: registers only
    return ((t >= q.lo0 && t < q.hi0) || (t >= q.lo1 && t < q.hi1)) ? 1u
                                                                     : 0u;
  }
  int k = (q.top && q.lo_top <= t) ? q.top : 0;
  for (int s = q.top >> 1; s > 0; s >>= 1) {
    if (sm.span_lo[k + s] <= t) k += s;
  }
  return ((k > 0 || t >= q.lo0) && t < sm.span_hi[k]) ? 1u : 0u;
}

// the bit byte of tile position x with the matched bit (16) folded in
__device__ __forceinline__ uint32_t marked_byte(const Smem& sm,
                                                const Spans& q, int st,
                                                int x) {
  const uint32_t v = sm.bits[st][x];
  if (q.n == 0 || !(v & 8)) return v;
  const int t = sm.terms[st][4 * swz(x >> 2) + (x & 3)];
  return v | (matched(sm, q, t) << 4);
}

// anyc count in the low 16 bits, seqc count in the high 16 bits
__device__ __forceinline__ int packed_pop(uint32_t w) {
  return __popc(w & kL) | (__popc(w & (kL << 1)) << 16);
}

// The packed running sum at tile offset j in [0, kTile], relative to the
// tile's start, from the scan buffers of parity p.
__device__ __forceinline__ int local_sum(const Smem& sm, int p, int j,
                                         int total) {
  if (j >= kTile) return total;
  const int u = j >> 4, r = j & 15;
  int v = sm.base[p][u];
  for (int w = 0; w < (u >> 5); ++w) v += sm.warp_sum[p][w];
  const uint4 c = sm.cw[p][u];
  const uint32_t w4[4] = {c.x, c.y, c.z, c.w};
  for (int i = 0; i < (r >> 2); ++i) v += packed_pop(w4[i]);
  return v + packed_pop(w4[r >> 2] & ((1u << (8 * (r & 3))) - 1u));
}

// One round of a kThreads-way search: the first d in [lo, hi] with
// bounds[d] >= x (bounds[hi] >= x holds). Every thread calls it.
__device__ __forceinline__ void search_round(const int* __restrict__ bounds,
                                             long long x, int& lo, int& hi,
                                             int tid) {
  const int len = hi - lo;  // uniform
  if (len == 0) return;
  const int step = (len + kThreads - 1) / kThreads;
  // probes lo, lo + step, ...: the first c of them lie below x
  const long long idx = (long long)lo + (long long)tid * step;
  const int c = __syncthreads_count(idx < hi && bounds[idx] < x);
  if (c == 0) {
    hi = lo;
    return;
  }
  const long long nlo = (long long)lo + (long long)(c - 1) * step + 1;
  hi = (int)min((long long)lo + (long long)c * step, (long long)hi);
  lo = (int)nlo;
}

// cp.async of the tile at t0 into stage st; `rem` positions from t0 on
// may be read (the rest is zero-filled)
__device__ __forceinline__ void load_tile(Smem& sm, int st,
                                          const uint8_t* __restrict__ bits,
                                          const int* __restrict__ terms,
                                          long long t0, int rem, int tid) {
  const uint8_t* gb = bits + t0;
  const int* gt = terms + t0;
  if (rem >= kSpan) {
    for (int c = tid; c < kBitChunks + kTermChunks; c += kThreads) {
      if (c < kBitChunks) {
        cp16(&sm.bits[st][16 * c], gb + 16 * c, 16);
      } else {
        const int q = c - kBitChunks;
        cp16(&sm.terms[st][4 * swz(q)], gt + 4 * q, 16);
      }
    }
    return;
  }
  for (int c = tid; c < kBitChunks + kTermChunks; c += kThreads) {
    if (c < kBitChunks) {
      const int n = min(max(rem - 16 * c, 0), 16);
      cp16(&sm.bits[st][16 * c], n ? gb + 16 * c : bits, n);
    } else {
      const int q = c - kBitChunks;
      const int n = min(max(rem - 4 * q, 0), 4);
      cp16(&sm.terms[st][4 * swz(q)], n ? gt + 4 * q : terms, 4 * n);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 6) phrase_counts_kernel(
    const uint8_t* __restrict__ bits, const int* __restrict__ terms,
    const int* __restrict__ bounds, const int* __restrict__ spans_g,
    int* __restrict__ any_out, int* __restrict__ seq_out, long long pp,
    int n_spans, int n_docs) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nb = gridDim.x, b = blockIdx.x;

  if (tid < 32) stage_spans(sm, spans_g, n_spans, tid);
  if (tid == 0) sm.halo[0] = 0u;
  const long long P = min((long long)bounds[n_docs], pp);
  const long long xs[3] = {P * b / nb, P * (b + 1) / nb, P};
  // The first tiles start streaming before the search: the block's first
  // doc starts at or after its share's start, usually within one doc.
  long long t_begin = xs[0] & ~15LL;
  for (int k = 0; k < kStages - 1; ++k) {
    const long long t0 = t_begin + (long long)k * kTile;
    load_tile(sm, k, bits, terms, t0, (int)max(min(P - t0, (long long)kSpan),
                                               0LL), tid);
    cp_commit();
  }
  int lo[3] = {0, 0, 0}, hi[3] = {n_docs, n_docs, n_docs};
  for (;;) {
    if (lo[0] == hi[0] && lo[1] == hi[1] && lo[2] == hi[2]) break;
    for (int i = 0; i < 3; ++i) search_round(bounds, xs[i], lo[i], hi[i], tid);
  }
  __syncthreads();  // the staged spans
  const int d_lo = lo[0], d_hi = lo[1], d_end = lo[2];

  // docs past the stream's last position: empty, spread over every block
  for (long long d = d_end + (long long)b * kThreads + tid; d < n_docs;
       d += (long long)nb * kThreads) {
    any_out[d] = 0;
    seq_out[d] = 0;
  }
  if (d_lo >= d_hi) {  // a share inside one long doc: owns nothing
    cp_wait<0>();
    return;
  }

  const long long A = bounds[d_lo], B = bounds[d_hi];
  if (A - t_begin >= kTile) {
    // the first doc starts a tile or more past the share's start (a long
    // doc ends there): restart the ring at it
    cp_wait<0>();
    __syncthreads();
    t_begin = A & ~15LL;
    for (int k = 0; k < kStages - 1; ++k) {
      const long long t0 = t_begin + (long long)k * kTile;
      load_tile(sm, k, bits, terms, t0,
                (int)max(min(P - t0, (long long)kSpan), 0LL), tid);
      cp_commit();
    }
  }
  const long long t_end = max((B + 15) & ~15LL, t_begin + 16);
  const int ntiles = (int)((t_end - t_begin + kTile - 1) / kTile);
  const long long lim = min(P, t_end + 16);
  auto rem_at = [&](int k) {
    return (int)min(lim - (t_begin + (long long)k * kTile), (long long)kSpan);
  };

  // this thread's doc of the current chunk, and the next chunk's
  int c0 = d_lo;
  int d = c0 + tid;
  bool done = d >= d_hi, got_a = false;
  int a = 0, e = 0, na = 0, ne = 0;
  if (!done) {
    a = bounds[d];
    e = bounds[d + 1];
  }
  int chunk_end = bounds[min(c0 + kThreads, d_hi)];
  int next_end = 0;
  if (c0 + kThreads < d_hi) {
    const int c1 = c0 + kThreads;
    if (c1 + tid < d_hi) {
      na = bounds[c1 + tid];
      ne = bounds[c1 + tid + 1];
    }
    next_end = bounds[min(c1 + kThreads, d_hi)];
  }
  int sa_any = 0, sa_seq = 0;
  int carry_any = 0, carry_seq = 0;
  Spans q;
  q.n = sm.n_spans;
  q.top = q.n <= 1 ? 0 : 1 << (31 - __clz(q.n - 1));
  q.lo_top = sm.span_lo[q.top];
  q.lo0 = sm.span_lo[0];
  q.hi0 = sm.span_hi[0];
  q.lo1 = sm.span_lo[1];
  q.hi1 = sm.span_hi[1];
  const int rot = (tid >> 1) & 3;  // this thread's chunk rotation

  for (int k = 0; k < ntiles; ++k) {
    const int st = k % kStages, p = k & 1;
    if (k + kStages - 1 < ntiles) {
      load_tile(sm, (k + kStages - 1) % kStages, bits, terms,
                t_begin + (long long)(k + kStages - 1) * kTile,
                rem_at(k + kStages - 1), tid);
    }
    cp_commit();
    cp_wait<kStages - 1>();
    __syncthreads();  // tile k has landed (and the previous tile is read)
    const long long t0 = t_begin + (long long)k * kTile;

    // the 16 positions [16 tid, 16 tid + 16): bit bytes, matched folded
    const uint4 bw = *reinterpret_cast<const uint4*>(&sm.bits[st][16 * tid]);
    uint32_t W[6] = {0u, bw.x, bw.y, bw.z, bw.w, 0u};
    if (q.n > 0) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int4 tv = *reinterpret_cast<const int4*>(
            &sm.terms[st][4 * (4 * tid + (j ^ rot))]);
        const int tt[4] = {tv.x, tv.y, tv.z, tv.w};
        uint32_t m = 0;
#pragma unroll
        for (int i = 0; i < 4; ++i) m |= matched(sm, q, tt[i]) << (8 * i + 4);
        W[j + 1] |= m & (W[j + 1] << 1) & (kL << 4);  // valid (8) -> 16
      }
    }
    // neighbours: lane - 1's last word, lane + 1's first word
    W[0] = __shfl_up_sync(kFull, W[4], 1);
    W[5] = __shfl_down_sync(kFull, W[1], 1);
    if (lane == 0) {
      W[0] = tid == 0 ? sm.halo[p]
                      : (marked_byte(sm, q, st, 16 * tid - 2) << 16) |
                            (marked_byte(sm, q, st, 16 * tid - 1) << 24);
    }
    if (lane == 31) W[5] = marked_byte(sm, q, st, 16 * tid + 16);
    if (tid == kThreads - 1) sm.halo[p ^ 1] = W[4];

    uint32_t cw[4];
    int cnt = 0;
#pragma unroll
    for (int i = 1; i <= 4; ++i) {
      const uint32_t x = W[i];
      const uint32_t xp = __funnelshift_l(W[i - 1], x, 8);    // position - 1
      const uint32_t xpp = __funnelshift_l(W[i - 1], x, 16);  // position - 2
      const uint32_t xn = __funnelshift_r(x, W[i + 1], 8);    // position + 1
      const uint32_t m = (x >> 4) & kL;
      const uint32_t grp = m | ((x >> 2) & (xn >> 4) & kL);   // next_same
      const uint32_t prev = ((xp >> 4) | (~xp & (xpp >> 4))) & kL;
      const uint32_t anyc = x & grp & kL;                      // first
      const uint32_t seqc = anyc & (x >> 1) & prev;            // adj_key
      cw[i - 1] = anyc | (seqc << 1);
      cnt += packed_pop(cw[i - 1]);
    }
    sm.cw[p][tid] = make_uint4(cw[0], cw[1], cw[2], cw[3]);
    int incl = cnt;
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += o;
    }
    sm.base[p][tid] = incl - cnt;
    if (lane == 31) sm.warp_sum[p][warp] = incl;
    __syncthreads();  // the scan buffers of parity p
    int total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += sm.warp_sum[p][w];

    // read the running sums at the owned docs' bounds in this tile
    const long long t1 = t0 + kTile;
    for (;;) {
      if (!done) {
        if (!got_a && a <= t1) {
          const int v = local_sum(sm, p, (int)(a - t0), total);
          sa_any = carry_any + (v & 0xffff);
          sa_seq = carry_seq + (v >> 16);
          got_a = true;
        }
        if (got_a && e <= t1) {
          const int v = local_sum(sm, p, (int)(e - t0), total);
          any_out[d] = carry_any + (v & 0xffff) - sa_any;
          seq_out[d] = carry_seq + (v >> 16) - sa_seq;
          done = true;
        }
      }
      if (chunk_end > t1 || c0 + kThreads >= d_hi) break;
      // every doc of the chunk ended in this tile: take the next chunk
      c0 += kThreads;
      d = c0 + tid;
      done = d >= d_hi;
      got_a = false;
      a = na;
      e = ne;
      chunk_end = next_end;
      const int c1 = c0 + kThreads;
      if (c1 < d_hi) {
        if (c1 + tid < d_hi) {
          na = bounds[c1 + tid];
          ne = bounds[c1 + tid + 1];
        }
        next_end = bounds[min(c1 + kThreads, d_hi)];
      }
    }
    carry_any += total & 0xffff;
    carry_seq += total >> 16;
  }
}

int g_grid_cap = 0;  // SMs x resident blocks, read once

}  // namespace

extern "C" int phrase_counts(const void* bits, const void* terms,
                             const void* bounds, const void* spans,
                             void* any_out, void* seq_out, long long pp,
                             int n_spans, int n_docs, void* stream) {
  if (n_spans < 0 || n_spans > kMaxSpans) return (int)cudaErrorInvalidValue;
  if (n_docs <= 0) return (int)cudaGetLastError();
  if (g_grid_cap == 0) {
    const int smem = (int)sizeof(Smem);
    cudaFuncSetAttribute(phrase_counts_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    int dev = 0, sms = 0, occ = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, phrase_counts_kernel,
                                                  kThreads, smem);
    const int err = (int)cudaGetLastError();
    if (err) return err;
    g_grid_cap = sms * (occ > 0 ? occ : 1);
  }
  long long grid = (pp + kTile - 1) / kTile;
  if (grid < 1) grid = 1;
  if (grid > g_grid_cap) grid = g_grid_cap;
  phrase_counts_kernel<<<(unsigned)grid, kThreads, sizeof(Smem),
                         (cudaStream_t)stream>>>(
      (const uint8_t*)bits, (const int*)terms, (const int*)bounds,
      (const int*)spans, (int*)any_out, (int*)seq_out, pp, n_spans, n_docs);
  return (int)cudaGetLastError();
}
