// K5: per-sub-block max similarity and positive count over int8 codes
// (kNN phase 1 of the int8 capacity mode).
//
// Replaces: orama_core_tpu/ops/pallas_knn.py::_subblock_max_int8_kernel
// (driven by knn_topk_int8 / knn_topk_int8_with_count), which streams
// [BN, D] int8 code blocks against the resident int8 queries on the MXU
// with int32 accumulation, multiplies by each row's scale, masks rows >=
// n_valid to -3e38 and writes only the per-sub-block max (and the count
// of products > 0) per query. The query scale is left out: it is a
// positive constant per query, so it changes no selection, and phase 2
// restores it.
//
// Bound on this card: bytes. Each row is read once (D bytes + a 4-byte
// scale) for 2*D*Q integer operations: at Q = 64 that is 128 ops/byte,
// far below the ~590 int8 ops/byte at which the int8 tensor cores become
// the limit; half of K2's bytes for the same corpus.
//
// Design: K2 on int8, on the streaming core of knn_stream.cuh with E =
// int8_t. A producer warp keeps a TMA ring of six 64-row x 128-code boxes
// (8 KB each, 48 KB in flight, 128-byte swizzle) ahead of one consumer
// warpgroup, which runs wgmma m64nNk32 s8 x s8 -> s32 against the int8
// queries resident in shared memory: Q <= 64 takes one corpus pass at D
// <= 2048, and up to 128 queries (m64n128k32) where that chunk fits (D
// <= 1,280). Blocks are persistent, each walking one range of rows; at
// 64 queries and D <= 896 two share an SM, so one's epilogue runs beside
// the other's products. The s32 sums are exact; the epilogue (K2's MaxCount) converts each
// once (__int2float_rn) and multiplies it once by its row's scale
// (__fmul_rn), the same single roundings as the plain version, so the two
// agree bit for bit. Each thread loads its fragment's two row scales
// before the tile's products, so the loads hide behind them. Sub-blocks
// wholly at or past n_valid get -3e38 / 0 without a read.

#include "knn_stream.cuh"

namespace {

using namespace knn_stream;

constexpr int kMaxChunkInt8 = 128;  // queries a pass where they fit

template <int NQ>
__global__ void __launch_bounds__(kThreads, 1) subblock_max_int8_kernel(
    const __grid_constant__ CUtensorMap map, const int8_t* __restrict__ q8,
    const float* __restrict__ scales, float* __restrict__ bmax,
    int* __restrict__ bcnt, long long n_sub, int d, int q, int sub,
    long long n_valid) {
  subblock_max<NQ>(&map, q8, scales, bmax, bcnt, n_sub, d, q, sub, n_valid);
}

template <int NQ>
int launch(const CUtensorMap& map, const void* q8, const void* scales,
           void* bmax, void* bcnt, long long n_sub, int d, int q, int sub,
           long long n_valid, cudaStream_t stream) {
  size_t smem = 0;
  int grid = 0;
  const int err = subblock_max_launch_shape<NQ, int8_t>(
      (const void*)subblock_max_int8_kernel<NQ>, d, sub, n_valid, &smem,
      &grid);
  if (err != 0) return err;
  subblock_max_int8_kernel<NQ><<<grid, kThreads, smem, stream>>>(
      map, (const int8_t*)q8, (const float*)scales, (float*)bmax, (int*)bcnt,
      n_sub, d, q, sub, n_valid);
  return (int)cudaGetLastError();
}

}  // namespace

// D % 16 == 0 (TMA's 16-byte row stride), sub % 32 == 0, n % sub == 0,
// 16-byte-aligned codes and queries, and D small enough for 8 queries
// beside the ring (D <= 16,384), all checked by the wrapper.
extern "C" int knn_subblock_max_int8(
    const void* codes, const void* scales, const void* q8, void* bmax,
    void* bcnt, long long n, int d, int q, int sub, long long n_valid,
    void* stream) {
  const long long n_sub = n / sub;
  if (n_sub <= 0 || q <= 0) return 0;
  n_valid = n_valid < 0 ? 0 : (n_valid > n ? n : n_valid);
  const int nq = pick_chunk<int8_t>(
      q, boxes<int8_t>(d), MaxCount<kMaxChunkInt8, int8_t>::kExtraPerQuery,
      0, kMaxChunkInt8);
  if (nq == 0) return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  const int err = corpus_map<int8_t>(&map, codes, n, d);
  if (err != 0) return err;
  cudaStream_t st = (cudaStream_t)stream;
  switch (nq) {
    case 8:
      return launch<8>(map, q8, scales, bmax, bcnt, n_sub, d, q, sub,
                       n_valid, st);
    case 16:
      return launch<16>(map, q8, scales, bmax, bcnt, n_sub, d, q, sub,
                        n_valid, st);
    case 32:
      return launch<32>(map, q8, scales, bmax, bcnt, n_sub, d, q, sub,
                        n_valid, st);
    case 64:
      return launch<64>(map, q8, scales, bmax, bcnt, n_sub, d, q, sub,
                        n_valid, st);
    default:
      return launch<128>(map, q8, scales, bmax, bcnt, n_sub, d, q, sub,
                         n_valid, st);
  }
}
