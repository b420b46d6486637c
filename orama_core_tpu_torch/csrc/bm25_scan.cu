// K1: BM25 posting block scan with the per-doc reduction fused in.
//
// Replaces: orama_core_tpu/ops/bm25.py::_bm25_gather_kernel (driven by
// bm25_blocked_contrib_pallas / bm25_scores_blocked_pallas), whose grid
// step DMAs one aligned 1024-posting block named by the scalar-prefetched
// plan and writes per-posting contributions; the per-doc segment_sum ran
// outside the kernel in XLA.
//
// Design: one CUDA block per plan block, one thread per posting of the
// block's in-block window [lo, hi). A thread reads docs/tf/ni/lens of its
// posting, computes the same float expression as the TPU kernel and adds
// it to scores[doc] with atomicAdd, so the segment_sum is fused and the
// contributions never reach device memory. Pad plan blocks (hi == 0) exit
// at once. Sums then depend on the order of the atomics: callers compare
// with a float tolerance.
//
// Bound on this card: bytes. Each posting moves 16 B in (four 4-byte
// columns) and one 4-byte atomic out for ~20 flops, far below the H100's
// ~295 flops/byte ridge.
//
// Left for a later PR: the atomics serialise on Zipf-heavy docs and the
// scattered read-modify-writes cost a sector each; a sorted-run reduction
// (postings are doc-sorted within a term) or a shared-memory histogram for
// dense doc ranges would cut both.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBlock = 1024;  // postings per aligned plan block
constexpr float kK1 = 1.2f;
constexpr float kB = 0.75f;

__global__ void bm25_scan_kernel(
    const int* __restrict__ docs, const float* __restrict__ tf,
    const float* __restrict__ ni, const float* __restrict__ lens,
    const int* __restrict__ blk, const int* __restrict__ lo,
    const int* __restrict__ hi, const float* __restrict__ params,
    float* __restrict__ scores) {
  const int b = blockIdx.x;
  const int h = hi[b];
  const int j = lo[b] + threadIdx.x;
  if (j >= h) return;
  const long long p = (long long)blk[b] * kBlock + j;
  const float boost = params[0];
  const float avgdl = params[1];
  const float nfd = params[2];
  const float t = tf[p];
  const float n = ni[p];
  const float idf = log1pf(fmaxf((nfd - n + 0.5f) / (n + 0.5f), 0.0f));
  const float den = t + kK1 * (1.0f - kB + kB * lens[p] / fmaxf(avgdl, 1e-9f));
  const float contrib = idf * boost * t * (kK1 + 1.0f) / fmaxf(den, 1e-9f);
  atomicAdd(&scores[docs[p]], contrib);
}

}  // namespace

extern "C" int bm25_scan(
    const void* docs, const void* tf, const void* ni, const void* lens,
    const void* blk, const void* lo, const void* hi, const void* params,
    void* scores, int n_blocks, void* stream) {
  if (n_blocks > 0) {
    bm25_scan_kernel<<<n_blocks, kBlock, 0, (cudaStream_t)stream>>>(
        (const int*)docs, (const float*)tf, (const float*)ni,
        (const float*)lens, (const int*)blk, (const int*)lo, (const int*)hi,
        (const float*)params, (float*)scores);
  }
  return (int)cudaGetLastError();
}
