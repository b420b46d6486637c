// B3: K1's four-plane scan at plan blocks of 1,024, 4,096 and 8,192
// postings and its packed two-plane form (BM25 posting block scan with the
// per-doc reduction fused in), for
// orama_core_tpu_torch/tools/bm25_scan_bench.py.
//
// Replaces: benchmarks/bm25_scan_bench.py::mk_pallas4 (kernel :89, call
// :135) and ::mk_pallas_packed (kernel :153, call :199), each at plan
// blocks of 1,024, 4,096 and 8,192. Both DMA one aligned plan block per
// grid step, write per-posting contributions masked to the block's
// [lo, hi) window, and leave the per-doc segment_sum to XLA. mk_pallas4
// reads four planes (docs i32, tf, ni, lens f32: 16 B a posting);
// mk_pallas_packed reads two (docs i32 and tf | lens << 16 as i32: 8 B a
// posting) and one ni (i32) per plan block. mk_pallas4 at 1,024 is K1's
// function (without K1's row ids and device-side scalars), so the probe
// holds it against K1 at K1's own block.
//
// Bound on this card: bytes: 16 or 8 B in per posting and one 4-byte
// score out, for ~20 flops.
//
// Design: the doc-tile scan (bm25_tiles.cuh, which explains it): each
// block sums one tile of the score row in shared memory from the runs of
// postings that fall in it (found by the windows' end docs and a warp
// search, exact because doc ids ascend within each window) and writes the
// tile once. No global atomic, no fill: the wrapper takes the row from
// torch.empty. A window whose doc ids do not ascend still gets the
// reference's sums: the tiles' check fails and a tail-launched block
// re-adds every window through K1's loop (bm25_scan.cuh) and counts the
// repair (bm25_scan_repairs). Packed: a lane unpacks tf = p & 0xFFFF and
// lens = (uint32)p >> 16, and the idf comes from the plan block's ni, once
// per run. A doc id outside [0, n_docs) is dropped. Sums depend on the
// order of the shared adds.

#include "bm25_scan.cuh"
#include "bm25_tiles.cuh"

namespace {

// bm25tiles::launch at the plan block ``block`` (1,024, 4,096 or 8,192)
template <bool kPacked>
int launch_at(int block, const void* docs, const void* tf, const void* ni,
              const void* lens, const void* packed, const void* ni_blk,
              const void* blk, const void* lo, const void* hi, float boost,
              float avgdl, float nfd, void* scores, int n_blocks,
              long long n_docs, void* stream) {
  // an empty plan still launches: the kernel writes the row's zeros
  switch (block) {
    case 1024:
      return bm25tiles::launch<1024, kPacked>(
          docs, tf, ni, lens, packed, ni_blk, blk, lo, hi, boost, avgdl, nfd,
          scores, n_blocks, n_docs, stream);
    case 4096:
      return bm25tiles::launch<4096, kPacked>(
          docs, tf, ni, lens, packed, ni_blk, blk, lo, hi, boost, avgdl, nfd,
          scores, n_blocks, n_docs, stream);
    case 8192:
      return bm25tiles::launch<8192, kPacked>(
          docs, tf, ni, lens, packed, ni_blk, blk, lo, hi, boost, avgdl, nfd,
          scores, n_blocks, n_docs, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Four planes (docs, tf, ni, lens) at plan blocks of 1,024, 4,096 or
// 8,192 postings -> scores f32[n_docs], every score written
extern "C" int bm25_scan_wide(const void* docs, const void* tf,
                              const void* ni, const void* lens,
                              const void* blk, const void* lo,
                              const void* hi, float boost, float avgdl,
                              float nfd, void* scores, int n_blocks,
                              long long n_docs, int block, void* stream) {
  return launch_at<false>(block, docs, tf, ni, lens, nullptr, nullptr, blk,
                          lo, hi, boost, avgdl, nfd, scores, n_blocks, n_docs,
                          stream);
}

// Two planes (docs, packed = tf | lens << 16) and ni per plan block, at
// plan blocks of 1,024, 4,096 or 8,192 postings -> scores f32[n_docs]
extern "C" int bm25_scan_packed(const void* docs, const void* packed,
                                const void* blk, const void* lo,
                                const void* hi, const void* ni_blk,
                                float boost, float avgdl, float nfd,
                                void* scores, int n_blocks, long long n_docs,
                                int block, void* stream) {
  return launch_at<true>(block, docs, nullptr, nullptr, nullptr, packed,
                         ni_blk, blk, lo, hi, boost, avgdl, nfd, scores,
                         n_blocks, n_docs, stream);
}

// The calls on the current device whose tiles' check failed and that the
// kernel repaired, so far -> *out (unsigned 64-bit, host memory)
extern "C" int bm25_scan_repairs(void* out, void* stream) {
  return bm25tiles::repairs((unsigned long long*)out, stream);
}
