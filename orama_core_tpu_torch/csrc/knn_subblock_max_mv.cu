// K6: per-sub-block max of the per-doc running relu sum, and the number
// of docs whose first positive row lies in the sub-block (kNN phase 1 of
// multi-vector, i.e. chunked, documents).
//
// Replaces: orama_core_tpu/ops/pallas_knn.py::_subblock_max_mv_kernel
// (driven by knn_topk_multivec_with_count). Rows are doc-ascending, each
// doc's chunk rows contiguous. Per row, seg = the inclusive running sum of
// relu(sim) over the earlier rows of its doc; a doc's total is seg at its
// last row, so the top sub-blocks by max(seg) hold the top docs. A row
// counts iff its sim is > 0 and no earlier row of its doc has a sim > 0.
// The TPU kernel carries the running sum, the last doc and the running
// max of positive doc ids from one grid step to the next in VMEM, which
// works because a TPU grid runs in order.
//
// Bound on this card: bytes. Each row is read once (2*D bytes + a 4-byte
// doc id) for 2*D*Q flops, far below the ~295 flops/byte at which bf16
// tensor cores become the limit.
//
// Design: K2's streaming core (knn_stream.cuh): TMA-fed wgmma tiles of 64
// rows against the resident queries, persistent blocks that each walk one
// contiguous range of rows in order. That order gives back the TPU's
// carry inside a block: one thread per query column walks each tile's
// rows in order and keeps (running sum, seen-positive bit, last doc) in
// registers across the whole range, as the TPU kept them across grid
// steps. Only a range's start can lie inside a doc; the engine bounds a
// doc to m_max <= 64 rows, so one look-back tile, the 64 rows before the
// range, scored like any other and written nowhere, builds the carry of
// the lead doc. One look-back per block (a few hundred per call) replaces
// the earlier design's one per 32-row sub-block, each of which scored a
// whole extra 32-row chunk with FMAs (~1.75x K2's rows at 1-7 rows per
// doc).
//
// Epilogue per tile: the f32 sims go from the accumulator fragments to a
// shared [64, NQ + 4] tile beside the tile's 64 doc ids (prefetched into
// registers before the tile's products); thread j then scans column j:
// per row, a new doc id resets the sum and the bit, a positive sim adds
// to the sum and counts if the bit is clear, and the sum feeds the
// sub-block's max, written when a 32-row half closes its sub-block. Rows
// at or above n_valid score 0 and join no doc (the engine pads doc ids
// with 0, which would otherwise break the ascending order); a sub-block
// wholly past n_valid gets max 0 and count 0 without a read.

#include "knn_stream.cuh"

namespace {

using namespace knn_stream;

template <int NQ>
struct DocScan {
  static constexpr int kPitch = NQ + 4;  // floats per staged row
  const int* row_docs;
  float* bmax;
  int* bcnt;
  long long n_valid, r0, r1;
  int q, sub;
  float* sims;  // [64][kPitch]
  int* docs;    // [64]
  int q0, nq;
  int next_doc;  // thread t < 64: the doc id of row + t, loaded early
  // thread j < nq: column j's carry and its open sub-block
  float sum, best;
  bool seen;
  int doc, cnt;

  __device__ void begin_chunk(int q0_, int nq_) {
    q0 = q0_;
    nq = nq_;
    sum = best = 0.0f;
    seen = false;
    doc = -3;  // matches no row
    cnt = 0;
  }

  __device__ void prefetch(long long row) {
    const long long r = row + threadIdx.x;
    if (threadIdx.x < kTileRows) next_doc = r < n_valid ? row_docs[r] : -1;
  }

  __device__ void tile(Acc<NQ>& acc, long long row) {
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int r_lo = 16 * warp + lane / 4;
#pragma unroll
    for (int i = 0; i < NQ / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * i + 2 * (lane % 4) + e;
        sims[r_lo * kPitch + col] = acc.d[4 * i + e];
        sims[(r_lo + 8) * kPitch + col] = acc.d[4 * i + 2 + e];
      }
    }
    if (threadIdx.x < kTileRows) docs[threadIdx.x] = next_doc;
    consumer_sync();
    const int j = threadIdx.x;
    if (j < nq) {
      const bool look_back = row < r0;  // builds the carry, writes nothing
      for (int h = 0; h < 2; ++h) {
        const long long base = row + 32 * h;
        if (base >= r1) break;
#pragma unroll 8
        for (int r = 32 * h; r < 32 * h + 32; ++r) {
          const int d = docs[r];
          const float sim = sims[r * kPitch + j];
          const bool pos = row + r < n_valid && sim > 0.0f;
          if (d != doc) {  // a new doc's first row
            doc = d;
            sum = 0.0f;
            seen = false;
          }
          sum += pos ? sim : 0.0f;
          cnt += pos && !seen;
          seen = seen || pos;
          best = fmaxf(best, sum);
        }
        if (look_back) {
          best = 0.0f;
          cnt = 0;
        } else if ((base + 32) % sub == 0) {  // the half closes its sub-block
          const long long s = (base + 32) / sub - 1;
          bmax[s * q + q0 + j] = best;
          bcnt[s * q + q0 + j] = cnt;
          best = 0.0f;
          cnt = 0;
        }
      }
    }
    consumer_sync();  // the staged tile is rewritten by the next one
  }
};

template <int NQ>
__global__ void __launch_bounds__(kThreads, 1) subblock_max_mv_kernel(
    const __grid_constant__ CUtensorMap map, const int* __restrict__ row_docs,
    const __nv_bfloat16* __restrict__ queries, float* __restrict__ bmax,
    int* __restrict__ bcnt, long long n_sub, int d, int q, int sub,
    long long n_valid) {
  extern __shared__ uint8_t raw[];
  const int nk = boxes<__nv_bfloat16>(d);
  const Smem s = carve(raw, nk, NQ);
  const long long n_live = (n_valid + sub - 1) / sub;
  // sub-blocks wholly past n_valid: padding scores 0, so max 0, count 0
  for (long long i = n_live * q + (long long)blockIdx.x * blockDim.x +
                     threadIdx.x;
       i < n_sub * q; i += (long long)gridDim.x * blockDim.x) {
    bmax[i] = 0.0f;
    bcnt[i] = 0;
  }
  Walk w;
  block_range(n_live, sub, &w.r0, &w.r1);
  if (w.r0 >= w.r1) return;  // block-uniform
  // the range starts inside a doc: one look-back tile of the 64 rows
  // before it (r0 is a multiple of 64, and r0 < n_valid)
  const bool look = w.r0 > 0 && row_docs[w.r0 - 1] == row_docs[w.r0];
  w.first = look ? w.r0 - kTileRows : w.r0;
  w.chunks = (q + NQ - 1) / NQ;
  w.nk = nk;
  init_barriers(s);
  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x == kConsumers) produce(&map, s, w);
  } else {
    DocScan<NQ> epi;
    epi.row_docs = row_docs;
    epi.bmax = bmax;
    epi.bcnt = bcnt;
    epi.n_valid = n_valid;
    epi.r0 = w.r0;
    epi.r1 = w.r1;
    epi.q = q;
    epi.sub = sub;
    epi.sims = reinterpret_cast<float*>(s.extra);
    epi.docs = reinterpret_cast<int*>(
        s.extra + kTileRows * DocScan<NQ>::kPitch * sizeof(float));
    consume<NQ>(s, w, queries, q, d, epi);
  }
}

// the staged tile [64][NQ + 4] f32 and its 64 doc ids
constexpr int kExtraPerQuery = kTileRows * sizeof(float);
constexpr int kExtraFixed = kTileRows * (4 * sizeof(float) + sizeof(int));

template <int NQ>
int launch(const CUtensorMap& map, const void* row_docs, const void* queries,
           void* bmax, void* bcnt, long long n_sub, int d, int q, int sub,
           long long n_valid, cudaStream_t stream) {
  const int nk = boxes<__nv_bfloat16>(d);
  const long long n_live = (n_valid + sub - 1) / sub;
  const long long unit = (sub % kTileRows) ? 2LL * sub : (long long)sub;
  const size_t smem = smem_bytes(nk, NQ, NQ * kExtraPerQuery + kExtraFixed);
  int grid = 0;
  const int err = grid_size((const void*)subblock_max_mv_kernel<NQ>, smem,
                            (n_live * sub + unit - 1) / unit, &grid);
  if (err != 0) return err;
  subblock_max_mv_kernel<NQ><<<grid, kThreads, smem, stream>>>(
      map, (const int*)row_docs, (const __nv_bfloat16*)queries, (float*)bmax,
      (int*)bcnt, n_sub, d, q, sub, n_valid);
  return (int)cudaGetLastError();
}

}  // namespace

// m_max (<= 64, checked by the wrapper) bounds a doc's rows; the look-back
// tile covers any such doc, so the kernel needs no other use of it.
extern "C" int knn_subblock_max_mv(
    const void* vecs, const void* row_docs, const void* queries, void* bmax,
    void* bcnt, long long n, int d, int q, int sub, long long n_valid,
    int m_max, void* stream) {
  const long long n_sub = n / sub;
  if (n_sub <= 0 || q <= 0) return 0;
  if (m_max < 1 || m_max > kTileRows) return (int)cudaErrorInvalidValue;
  n_valid = n_valid < 0 ? 0 : (n_valid > n ? n : n_valid);
  const int nk = boxes<__nv_bfloat16>(d);
  const int nq = pick_chunk(q, nk, kExtraPerQuery, kExtraFixed);
  if (nq == 0) return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  const int err = corpus_map(&map, vecs, n, d);
  if (err != 0) return err;
  cudaStream_t st = (cudaStream_t)stream;
  switch (nq) {
    case 8:
      return launch<8>(map, row_docs, queries, bmax, bcnt, n_sub, d, q, sub,
                       n_valid, st);
    case 16:
      return launch<16>(map, row_docs, queries, bmax, bcnt, n_sub, d, q, sub,
                        n_valid, st);
    case 32:
      return launch<32>(map, row_docs, queries, bmax, bcnt, n_sub, d, q, sub,
                        n_valid, st);
    default:
      return launch<64>(map, row_docs, queries, bmax, bcnt, n_sub, d, q, sub,
                        n_valid, st);
  }
}
