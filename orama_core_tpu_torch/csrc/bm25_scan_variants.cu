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
// function: this file's instantiation at 1,024 runs K1's own loop
// (bm25_scan.cuh) without K1's row ids and device-side scalars, so the
// probe can hold it against K1 at K1's own block.
//
// Bound on this card: bytes, as K1: 16 or 8 B in per posting and one
// 4-byte add out, for ~20 flops. The scattered adds into the score row
// (L2-resident) are the floor that K1's probes measured: a bare scatter
// of the same ~1M doc ids takes most of K1's time by itself.
//
// Design: K1's loop (bm25_scan.cuh; bm25_scan.cu explains it),
// instantiated at each plan block in each plane form. Packed: a lane
// unpacks tf = p & 0xFFFF and lens = (uint32)p >> 16, and the idf comes
// from the plan block's ni, once per chunk. The wrapper zeroes the scores
// right before the launch, which is a programmatic dependent of that
// fill, as K1's is. A doc id outside [0, n_docs) is dropped, as K1 drops
// it. Sums depend on the order of the adds.

#include "bm25_scan.cuh"

namespace {

// kPacked: the planes are docs and packed (tf | lens << 16), ni_blk per
// plan block; else docs, tf, ni and lens
template <int kBlock, bool kPacked>
__global__ void __launch_bounds__(bm25scan::kThreads) scan_kernel(
    const int4* __restrict__ docs, const float4* __restrict__ tf,
    const float4* __restrict__ ni, const float4* __restrict__ lens,
    const int4* __restrict__ packed, const int* __restrict__ ni_blk,
    const int* __restrict__ blk, const int* __restrict__ lo,
    const int* __restrict__ hi, float boost, float avgdl, float nfd,
    float* __restrict__ scores, int n_blocks, long long n_docs) {
  bm25scan::scan<kBlock, kPacked, false>(docs, tf, ni, lens, packed, ni_blk,
                                         blk, lo, hi, nullptr, boost, avgdl,
                                         nfd, scores, n_blocks, n_docs);
}

template <int kBlock, bool kPacked>
int launch(const void* docs, const void* tf, const void* ni,
           const void* lens, const void* packed, const void* ni_blk,
           const void* blk, const void* lo, const void* hi, float boost,
           float avgdl, float nfd, void* scores, int n_blocks,
           long long n_docs, void* stream) {
  return bm25scan::launch_after_fill<kBlock>(
      scan_kernel<kBlock, kPacked>, n_blocks, stream, (const int4*)docs,
      (const float4*)tf, (const float4*)ni, (const float4*)lens,
      (const int4*)packed, (const int*)ni_blk, (const int*)blk,
      (const int*)lo, (const int*)hi, boost, avgdl, nfd, (float*)scores,
      n_blocks, n_docs);
}

}  // namespace

// Four planes (docs, tf, ni, lens) at plan blocks of 1,024, 4,096 or
// 8,192 postings -> scores f32[n_docs] (zeroed by the caller, the launch
// before)
extern "C" int bm25_scan_wide(const void* docs, const void* tf,
                              const void* ni, const void* lens,
                              const void* blk, const void* lo,
                              const void* hi, float boost, float avgdl,
                              float nfd, void* scores, int n_blocks,
                              long long n_docs, int block, void* stream) {
  if (n_blocks <= 0) return (int)cudaGetLastError();
  switch (block) {
    case 1024:
      return launch<1024, false>(docs, tf, ni, lens, nullptr, nullptr, blk,
                                 lo, hi, boost, avgdl, nfd, scores, n_blocks,
                                 n_docs, stream);
    case 4096:
      return launch<4096, false>(docs, tf, ni, lens, nullptr, nullptr, blk,
                                 lo, hi, boost, avgdl, nfd, scores, n_blocks,
                                 n_docs, stream);
    case 8192:
      return launch<8192, false>(docs, tf, ni, lens, nullptr, nullptr, blk,
                                 lo, hi, boost, avgdl, nfd, scores, n_blocks,
                                 n_docs, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Two planes (docs, packed = tf | lens << 16) and ni per plan block, at
// plan blocks of 1,024, 4,096 or 8,192 postings -> scores f32[n_docs]
extern "C" int bm25_scan_packed(const void* docs, const void* packed,
                                const void* blk, const void* lo,
                                const void* hi, const void* ni_blk,
                                float boost, float avgdl, float nfd,
                                void* scores, int n_blocks, long long n_docs,
                                int block, void* stream) {
  if (n_blocks <= 0) return (int)cudaGetLastError();
  switch (block) {
    case 1024:
      return launch<1024, true>(docs, nullptr, nullptr, nullptr, packed,
                                ni_blk, blk, lo, hi, boost, avgdl, nfd,
                                scores, n_blocks, n_docs, stream);
    case 4096:
      return launch<4096, true>(docs, nullptr, nullptr, nullptr, packed,
                                ni_blk, blk, lo, hi, boost, avgdl, nfd,
                                scores, n_blocks, n_docs, stream);
    case 8192:
      return launch<8192, true>(docs, nullptr, nullptr, nullptr, packed,
                                ni_blk, blk, lo, hi, boost, avgdl, nfd,
                                scores, n_blocks, n_docs, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
