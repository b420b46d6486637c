// K2: per-sub-block max similarity and positive count (kNN phase 1).
//
// Replaces: orama_core_tpu/ops/pallas_knn.py::_subblock_max_kernel (driven
// by knn_topk / knn_topk_with_count), which streams [BN, D] corpus blocks
// against the resident queries on the MXU, masks rows >= n_valid to -3e38
// and writes only the per-sub-block max (and the count of sims > 0) per
// query, so the [N, Q] similarities never reach device memory.
//
// Bound on this card: bytes. Each corpus row is read once (2*D bytes)
// for 2*D*Q flops: at Q = 64 that is 64 flops/byte, still far below the
// ~295 flops/byte at which bf16 tensor cores become the limit, so the
// kernel is as fast as the corpus streams.
//
// Design: the streaming core of knn_stream.cuh. A TMA ring of 64 x 64
// corpus boxes keeps 64 KB in flight per block while the tensor cores
// (wgmma m64nNk16 against the queries resident in shared memory) turn
// each 64-row tile into f32 similarities in registers; Q <= 64 queries
// take one corpus pass. The earlier design copied each slice through
// registers, waited at a barrier and ran FMA loops with no load in
// flight, restaged the queries per slice, and read the corpus once per
// 8 queries; this one does none of these.
//
// Epilogue per tile (MaxCount in knn_stream.cuh, shared with K5): rows
// >= n_valid become -3e38; per query column, each warp reduces its 16
// rows' max and count of sims > 0 by shuffles, and one thread per column
// folds the warps of each 32-row half into its sub-block's running max
// and count, which carry over tiles when sub > 64. Sub-blocks wholly at
// or past n_valid get -3e38 / 0 without a read.

#include "knn_stream.cuh"

namespace {

using namespace knn_stream;
using Bf16 = __nv_bfloat16;

template <int NQ>
__global__ void __launch_bounds__(kThreads, 1) subblock_max_kernel(
    const __grid_constant__ CUtensorMap map, const Bf16* __restrict__ queries,
    float* __restrict__ bmax, int* __restrict__ bcnt, long long n_sub, int d,
    int q, int sub, long long n_valid) {
  subblock_max<NQ>(&map, queries, nullptr, bmax, bcnt, n_sub, d, q, sub,
                   n_valid);
}

template <int NQ>
int launch(const CUtensorMap& map, const void* queries, void* bmax,
           void* bcnt, long long n_sub, int d, int q, int sub,
           long long n_valid, cudaStream_t stream) {
  size_t smem = 0;
  int grid = 0;
  const int err = subblock_max_launch_shape<NQ, Bf16>(
      (const void*)subblock_max_kernel<NQ>, d, sub, n_valid, &smem, &grid);
  if (err != 0) return err;
  subblock_max_kernel<NQ><<<grid, kThreads, smem, stream>>>(
      map, (const Bf16*)queries, (float*)bmax, (int*)bcnt, n_sub, d, q, sub,
      n_valid);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int knn_subblock_max(
    const void* vecs, const void* queries, void* bmax, void* bcnt,
    long long n, int d, int q, int sub, long long n_valid, void* stream) {
  const long long n_sub = n / sub;
  if (n_sub <= 0 || q <= 0) return 0;
  n_valid = n_valid < 0 ? 0 : (n_valid > n ? n : n_valid);
  const int nq = pick_chunk(q, boxes<Bf16>(d),
                            MaxCount<kMaxChunk, Bf16>::kExtraPerQuery, 0);
  if (nq == 0) return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  const int err = corpus_map<Bf16>(&map, vecs, n, d);
  if (err != 0) return err;
  cudaStream_t st = (cudaStream_t)stream;
  switch (nq) {
    case 8:
      return launch<8>(map, queries, bmax, bcnt, n_sub, d, q, sub, n_valid, st);
    case 16:
      return launch<16>(map, queries, bmax, bcnt, n_sub, d, q, sub, n_valid,
                        st);
    case 32:
      return launch<32>(map, queries, bmax, bcnt, n_sub, d, q, sub, n_valid,
                        st);
    default:
      return launch<64>(map, queries, bmax, bcnt, n_sub, d, q, sub, n_valid,
                        st);
  }
}
