// The BM25 posting scan shared by K1 (bm25_scan.cu) and its probe forms
// (bm25_scan_variants.cu): the persistent walk over a block plan, the
// loads, the masks and the scattered adds. bm25_scan.cu explains the
// design; this header holds the one copy of its loop.
//
// Template parameters:
//   kBlock   postings per aligned plan block (K1: 1024; the probes also
//            4096 and 8192)
//   kPacked  planes: false reads docs, tf, ni and lens (16 B a posting);
//            true reads docs and packed = tf | lens << 16 (8 B a posting)
//            with one ni per plan block (ni_blk), unpacked by a logical
//            shift, the idf computed once per chunk
//   kRows    row_id names each plan block's row of scores [rows, n_docs]
//            (K1's batches); false adds into one row
// A pointer that an instantiation does not read is passed as nullptr.

#include <cuda_runtime.h>
#include <math.h>

namespace {
namespace bm25scan {

constexpr int kChunk = 128;   // postings per warp step (32 lanes x 4)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kAhead = 4;     // chunks whose loads a warp issues at once
constexpr int kBlocksPerSm = 4;
constexpr float kK1 = 1.2f;
constexpr float kB = 0.75f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float idf_of(float ni, float nfd) {
  return log1pf(fmaxf((nfd - ni + 0.5f) / (ni + 0.5f), 0.0f));
}

template <int kBlock, bool kPacked, bool kRows>
__device__ __forceinline__ void scan(
    const int4* __restrict__ docs, const float4* __restrict__ tf,
    const float4* __restrict__ ni, const float4* __restrict__ lens,
    const int4* __restrict__ packed, const int* __restrict__ ni_blk,
    const int* __restrict__ blk, const int* __restrict__ lo,
    const int* __restrict__ hi, const int* __restrict__ row_id,
    float boost, float avgdl, float nfd, float* __restrict__ scores,
    int n_blocks, long long n_docs) {
  constexpr int kChunks = kBlock / kChunk;
  const float avgdl_c = fmaxf(avgdl, 1e-9f);
  const int lane = threadIdx.x & 31;
  const long long n_warps = (long long)gridDim.x * kWarps;
  const long long w = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const long long n_units = (long long)n_blocks * kChunks;

  for (long long u0 = w; u0 < n_units; u0 += 32 * n_warps) {
    // lane i: the plan entry of unit u0 + i * n_warps (pr: the block's
    // row id or, packed, its ni)
    const long long my_u = u0 + lane * n_warps;
    int pb = 0, pl = 0, ph = 0, pr = 0;
    if (my_u < n_units) {
      const int b = (int)(my_u / kChunks);
      pb = blk[b];
      pl = lo[b];
      ph = hi[b];
      if (kRows) pr = row_id[b];
      if (kPacked) pr = ni_blk[b];
    }
    // units up to the first pad block (hi == 0): real blocks come first
    const unsigned live = __ballot_sync(kFull, my_u < n_units && ph > 0);
    const int n_live = __ffs(~live) - 1 < 0 ? 32 : __ffs(~live) - 1;
    for (int j0 = 0; j0 < n_live; j0 += kAhead) {
      int4 d[kAhead], p[kAhead];
      float4 t[kAhead], n[kAhead], l[kAhead];
      int off[kAhead], elo[kAhead], ehi[kAhead];
      float* out[kAhead];
      float idf_b[kAhead];
#pragma unroll
      for (int r = 0; r < kAhead; ++r) {
        const int j = min(j0 + r, 31);
        const int b_ = __shfl_sync(kFull, pb, j);
        elo[r] = __shfl_sync(kFull, pl, j);
        ehi[r] = j0 + r < n_live ? __shfl_sync(kFull, ph, j) : 0;
        out[r] = kRows ? scores + (long long)__shfl_sync(kFull, pr, j) * n_docs
                       : scores;
        idf_b[r] = kPacked ? idf_of((float)__shfl_sync(kFull, pr, j), nfd)
                           : 0.0f;
        const long long u = u0 + (long long)j * n_warps;
        off[r] = (int)(u % kChunks) * kChunk + 4 * lane;
        if (off[r] < ehi[r] && off[r] + 4 > elo[r]) {
          const long long q = ((long long)b_ * kBlock + off[r]) >> 2;
          d[r] = docs[q];
          if (kPacked) {
            p[r] = packed[q];
          } else {
            t[r] = tf[q];
            n[r] = ni[q];
            l[r] = lens[q];
          }
        }
      }
      // the fill of the scores (the kernel before this one) is complete
      asm volatile("griddepcontrol.wait;" ::: "memory");
#pragma unroll
      for (int r = 0; r < kAhead; ++r) {
        if (!(off[r] < ehi[r] && off[r] + 4 > elo[r])) continue;
        const int dd[4] = {d[r].x, d[r].y, d[r].z, d[r].w};
        float tt[4], nn[4], ll[4];
        if (kPacked) {
          const int pp[4] = {p[r].x, p[r].y, p[r].z, p[r].w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            tt[e] = (float)(pp[e] & 0xFFFF);
            ll[e] = (float)((unsigned)pp[e] >> 16);
          }
        } else {
          tt[0] = t[r].x; tt[1] = t[r].y; tt[2] = t[r].z; tt[3] = t[r].w;
          nn[0] = n[r].x; nn[1] = n[r].y; nn[2] = n[r].z; nn[3] = n[r].w;
          ll[0] = l[r].x; ll[1] = l[r].y; ll[2] = l[r].z; ll[3] = l[r].w;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int jj = off[r] + e;
          // a doc id outside [0, n_docs) is dropped, as the reference's
          // segment_sum drops it: the add never leaves its output row
          if (jj < elo[r] || jj >= ehi[r] ||
              (unsigned long long)(unsigned)dd[e] >= (unsigned long long)n_docs)
            continue;
          const float idf = kPacked ? idf_b[r] : idf_of(nn[e], nfd);
          const float den = tt[e] + kK1 * (1.0f - kB + kB * ll[e] / avgdl_c);
          atomicAdd(&out[r][dd[e]],
                    idf * boost * tt[e] * (kK1 + 1.0f) / fmaxf(den, 1e-9f));
        }
      }
    }
    if (n_live < 32) break;  // a pad block (or the plan's end) was reached
  }
}

// Launches kernel(args...) on a persistent grid of at most
// SMs x kBlocksPerSm blocks and no more warps than the plan has chunks,
// as a programmatic dependent of the launch before it (the wrapper's
// fill of the scores).
template <int kBlock, class... P, class... A>
int launch_after_fill(void (*kernel)(P...), int n_blocks, void* stream,
                      A... args) {
  static int grid_cap = 0;  // SMs x kBlocksPerSm, read once
  if (grid_cap == 0) {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const int err = (int)cudaGetLastError();
    if (err) return err;
    grid_cap = sms * kBlocksPerSm;
  }
  const long long chunks = (long long)n_blocks * (kBlock / kChunk);
  const long long want = (chunks + kWarps - 1) / kWarps;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(want < grid_cap ? want : grid_cap));
  cfg.blockDim = dim3(kThreads);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

}  // namespace bm25scan
}  // namespace
