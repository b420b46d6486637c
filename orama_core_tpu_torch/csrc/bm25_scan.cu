// K1: BM25 posting block scan with the per-doc reduction fused in.
//
// Replaces: orama_core_tpu/ops/bm25.py::_bm25_gather_kernel (driven by
// bm25_blocked_contrib_pallas / bm25_scores_blocked_pallas), whose grid
// step DMAs one aligned 1024-posting block named by the scalar-prefetched
// plan and writes per-posting contributions; the per-doc segment_sum ran
// outside the kernel in XLA.
//
// Bound on this card: bytes. Each posting moves 16 B in (four 4-byte
// columns) and one 4-byte add out for ~20 flops, far below the H100's
// ~295 flops/byte ridge. The adds go to scattered docs of a 4 MB score
// vector that stays in the L2.
//
// Design: a persistent grid (4 blocks of 256 threads per SM, fewer when
// the plan has fewer 128-posting chunks than warps; in probes 4 ran faster
// than 1, 2 or the 8 that fit). The plan's units are
// (plan block, 128-posting chunk) pairs, 8 per plan block, and warp w
// takes units w, w + W, w + 2W, ... (W warps in all). Each lane fetches the
// plan entry (block index, lo, hi) of one of the warp's next 32 units in a
// single round trip, and the entries travel to the warp by shuffles. A
// lane then loads 4 consecutive postings of a chunk with one 16-byte load
// per column (int4 docs, float4 tf, ni, lens; plan blocks are 1024-aligned,
// so the loads are aligned), and the warp issues the loads of up to four
// chunks before the first chunk's adds. Masks apply only where a chunk
// holds the [lo, hi) edges. The engine pads the plan to a bucket of
// PLAN_BUCKETS with blocks of hi == 0 after every real block
// (build_block_plan_aligned), so the first pad a warp meets ends its walk:
// pad blocks cost one plan load, not a launch of threads that exit.
//
// The adds are atomicAdd with the result unused, which compiles to RED
// (REDG.E.ADD.F32.FTZ.RN.STRONG.GPU in cuobjdump -sass: a fire-and-forget
// reduction in the L2), so the warp never waits on them. Sums depend on
// the order of the adds: callers compare with a float tolerance. Postings
// of one term never share a doc, so reducing sorted runs before the adds
// would save nothing. The card's rate for such scattered adds sets this
// kernel's floor: a bare scatter of the same ~1M doc ids with atomicAdd of
// 1.0 takes most of this kernel's time by itself (chip_smoke.py's K1 probe
// line; PERF.md).
//
// The scores are zeroed by the wrapper (torch.zeros) right before the
// launch: the fill of the 4 MB vector measured below one grid-wide
// barrier on the card (the same probe line), so a cooperative launch that
// folds it in would not pay. The kernel is launched as a programmatic
// dependent of that fill: its plan and posting loads overlap the fill,
// and griddepcontrol.wait holds each warp's first add until the fill is
// complete. Everything else the kernel reads was written before the fill
// began, as the stream orders the fill itself behind it.
//
// Doc ids: an add goes to out[doc] only for 0 <= doc < n_docs, the row
// length the launch passes in; any other id is dropped, as the
// reference's segment_sum drops an id outside [0, num_segments). The
// engine sizes the row by the capacity its search pinned, which covers
// every generation it reads, so nothing is dropped there; the bound keeps
// a plan built from any other posting column inside the row.
//
// Batches: with a row id per plan block (row_id != NULL), one launch scans
// the combined plan of a whole query batch (the reference's
// hybrid_fused_topk_batch: each row's real blocks, then the pad blocks)
// into scores[b, n_docs], each posting adding to
// scores[row_id[block] * n_docs + doc], indexed in 64 bits. The row id
// travels with the plan entry, fetched in the same round trip. Without
// row ids the single-row instantiation is compiled, unchanged.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBlock = 1024;  // postings per aligned plan block
constexpr int kChunk = 128;   // postings per warp step (32 lanes x 4)
constexpr int kChunks = kBlock / kChunk;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kAhead = 4;     // chunks whose loads a warp issues at once
constexpr float kK1 = 1.2f;
constexpr float kB = 0.75f;
constexpr unsigned kFull = 0xffffffffu;

template <bool kRows>
__global__ void __launch_bounds__(kThreads) bm25_scan_kernel(
    const int4* __restrict__ docs, const float4* __restrict__ tf,
    const float4* __restrict__ ni, const float4* __restrict__ lens,
    const int* __restrict__ blk, const int* __restrict__ lo,
    const int* __restrict__ hi, const int* __restrict__ row_id,
    const float* __restrict__ p_boost, const float* __restrict__ p_avgdl,
    const float* __restrict__ p_nfd, float boost, float avgdl, float nfd,
    float* __restrict__ scores, int n_blocks, long long n_docs) {
  // a scalar lives on the card (the fused program's staging) or travels
  // as a kernel argument
  if (p_boost) boost = *p_boost;
  if (p_avgdl) avgdl = *p_avgdl;
  if (p_nfd) nfd = *p_nfd;
  const float avgdl_c = fmaxf(avgdl, 1e-9f);
  const int lane = threadIdx.x & 31;
  const long long n_warps = (long long)gridDim.x * kWarps;
  const long long w = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const long long n_units = (long long)n_blocks * kChunks;

  for (long long u0 = w; u0 < n_units; u0 += 32 * n_warps) {
    // lane i: the plan entry of unit u0 + i * n_warps
    const long long my_u = u0 + lane * n_warps;
    int pb = 0, pl = 0, ph = 0, pr = 0;
    if (my_u < n_units) {
      const int b = (int)(my_u / kChunks);
      pb = blk[b];
      pl = lo[b];
      ph = hi[b];
      if (kRows) pr = row_id[b];
    }
    // units up to the first pad block (hi == 0): real blocks come first
    const unsigned live = __ballot_sync(kFull, my_u < n_units && ph > 0);
    const int n_live = __ffs(~live) - 1 < 0 ? 32 : __ffs(~live) - 1;
    for (int j0 = 0; j0 < n_live; j0 += kAhead) {
      int4 d[kAhead];
      float4 t[kAhead], n[kAhead], l[kAhead];
      int off[kAhead], elo[kAhead], ehi[kAhead];
      float* out[kAhead];
#pragma unroll
      for (int r = 0; r < kAhead; ++r) {
        const int j = min(j0 + r, 31);
        const int b_ = __shfl_sync(kFull, pb, j);
        elo[r] = __shfl_sync(kFull, pl, j);
        ehi[r] = j0 + r < n_live ? __shfl_sync(kFull, ph, j) : 0;
        out[r] = kRows ? scores + (long long)__shfl_sync(kFull, pr, j) * n_docs
                       : scores;
        const long long u = u0 + (long long)j * n_warps;
        off[r] = (int)(u % kChunks) * kChunk + 4 * lane;
        if (off[r] < ehi[r] && off[r] + 4 > elo[r]) {
          const long long q = ((long long)b_ * kBlock + off[r]) >> 2;
          d[r] = docs[q];
          t[r] = tf[q];
          n[r] = ni[q];
          l[r] = lens[q];
        }
      }
      // the fill of the scores (the kernel before this one) is complete
      asm volatile("griddepcontrol.wait;" ::: "memory");
#pragma unroll
      for (int r = 0; r < kAhead; ++r) {
        if (!(off[r] < ehi[r] && off[r] + 4 > elo[r])) continue;
        const int dd[4] = {d[r].x, d[r].y, d[r].z, d[r].w};
        const float tt[4] = {t[r].x, t[r].y, t[r].z, t[r].w};
        const float nn[4] = {n[r].x, n[r].y, n[r].z, n[r].w};
        const float ll[4] = {l[r].x, l[r].y, l[r].z, l[r].w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int jj = off[r] + e;
          // a doc id outside [0, n_docs) is dropped, as the reference's
          // segment_sum drops it: the add never leaves its output row
          if (jj < elo[r] || jj >= ehi[r] ||
              (unsigned long long)(unsigned)dd[e] >= (unsigned long long)n_docs)
            continue;
          const float idf = log1pf(
              fmaxf((nfd - nn[e] + 0.5f) / (nn[e] + 0.5f), 0.0f));
          const float den = tt[e] + kK1 * (1.0f - kB + kB * ll[e] / avgdl_c);
          atomicAdd(&out[r][dd[e]],
                    idf * boost * tt[e] * (kK1 + 1.0f) / fmaxf(den, 1e-9f));
        }
      }
    }
    if (n_live < 32) break;  // a pad block (or the plan's end) was reached
  }
}

constexpr int kBlocksPerSm = 4;
int g_grid_cap = 0;  // SMs x kBlocksPerSm, read once

}  // namespace

// row_id: NULL for one row of scores, else int32[n_blocks] (the batch
// row of each plan block, scores being [rows, n_docs])
extern "C" int bm25_scan(const void* docs, const void* tf, const void* ni,
                         const void* lens, const void* blk, const void* lo,
                         const void* hi, const void* row_id,
                         const void* p_boost, const void* p_avgdl,
                         const void* p_nfd, float boost, float avgdl,
                         float nfd, void* scores, int n_blocks,
                         long long n_docs, void* stream) {
  if (n_blocks <= 0) return (int)cudaGetLastError();
  if (g_grid_cap == 0) {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const int err = (int)cudaGetLastError();
    if (err) return err;
    g_grid_cap = sms * kBlocksPerSm;
  }
  // one warp per plan block's 8 chunks at most
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_blocks < g_grid_cap ? n_blocks : g_grid_cap);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, row_id ? bm25_scan_kernel<true> : bm25_scan_kernel<false>,
      (const int4*)docs, (const float4*)tf, (const float4*)ni,
      (const float4*)lens, (const int*)blk, (const int*)lo, (const int*)hi,
      (const int*)row_id, (const float*)p_boost, (const float*)p_avgdl,
      (const float*)p_nfd, boost, avgdl, nfd, (float*)scores, n_blocks,
      n_docs);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}
