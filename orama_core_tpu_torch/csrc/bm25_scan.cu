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
// Design (the loop is in bm25_scan.cuh, shared with the probe forms of
// bm25_scan_variants.cu): a persistent grid (4 blocks of 256 threads per SM, fewer when
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

#include "bm25_scan.cuh"

namespace {

template <bool kRows>
__global__ void __launch_bounds__(bm25scan::kThreads) bm25_scan_kernel(
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
  bm25scan::scan<1024, false, kRows>(docs, tf, ni, lens, nullptr, nullptr,
                                     blk, lo, hi, row_id, boost, avgdl, nfd,
                                     scores, n_blocks, n_docs);
}

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
  // one warp per plan block's 8 chunks: a grid of n_blocks at most
  return bm25scan::launch_after_fill<1024>(
      row_id ? bm25_scan_kernel<true> : bm25_scan_kernel<false>, n_blocks,
      stream, (const int4*)docs, (const float4*)tf, (const float4*)ni,
      (const float4*)lens, (const int*)blk, (const int*)lo, (const int*)hi,
      (const int*)row_id, (const float*)p_boost, (const float*)p_avgdl,
      (const float*)p_nfd, boost, avgdl, nfd, (float*)scores, n_blocks,
      n_docs);
}
