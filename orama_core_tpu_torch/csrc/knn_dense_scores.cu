// Dense corpus scores of the batched serving program: for B queries and a
// corpus whose row r is doc r (the identity layout),
//
//     out[q, r] = max(v_r . q, 0) * valid[r] * mask[r]    r < rows
//     out[q, r] = 0 * mask[r]                              rows <= r < n_docs
//
// as f32 [B, n_docs], the doc scores ops/vector.brute_force_scores_batch
// returns. The products are bf16 x bf16 with f32 accumulation, the
// reference's own arithmetic: orama_core_tpu/ops/vector.py:66-69,
// jnp.dot(queries.astype(vecs.dtype), vecs.T, preferred_element_type=f32)
// (XLA; the reference has no Pallas kernel for it). Each bf16 product is
// exact in f32, so only the order of the f32 sums differs from the plain
// version, which upcasts the corpus to f32 and runs an f32 matmul. The
// epilogue multiplies in the plain version's order, one rounding each.
//
// Bound on this card: bytes. Each corpus row is read once (2*D bytes) and
// B f32 scores written for it (4*B bytes), for 2*D*B flops: at B = 16 and
// D = 384 that is ~15 flops a byte, far below the ~295 at which the bf16
// tensor cores become the limit. The plain version moves ~6x the bytes: an
// f32 copy of the corpus written and read again, then the clamp, valid,
// transpose, pad and mask passes over [B, n].
//
// Design: the streaming core of knn_stream.cuh (K2's): a TMA ring of 64 x
// 64 bf16 corpus boxes per block, wgmma m64nNk16 against the queries
// resident in shared memory (B <= 64 takes one corpus pass; above, the
// core's query-chunk loop streams the range once per 64 queries), and
// persistent blocks that each walk one range of whole 64-row tiles. The
// epilogue (DenseScores) replaces K2's sub-block max: each thread scores
// its accumulator fragments with the valid and mask values of its two
// rows (loaded before the tile's products), stages them transposed in
// shared memory ([query][64 rows + 4], so the fragment's stores hit 32
// distinct banks), and the warpgroup then stores each query's 64 scores
// as one coalesced 256-byte run. Two staging buffers alternate by tile,
// so one barrier a tile suffices. Rows past the corpus's last tile up to
// n_docs (the identity layout's pad) are written by a grid-stride loop
// before the walk; the last tile's rows past the corpus come back from TMA
// as zeros and are written as the pad too.

#include "knn_stream.cuh"

namespace {

using namespace knn_stream;
using Bf16 = __nv_bfloat16;

constexpr int kStride = kTileRows + 4;  // floats per staged query row

template <int NQ>
struct DenseScores {
  // shared scratch bytes per query: [2 tile parities][kStride] f32
  static constexpr int kExtraPerQuery = 2 * kStride * sizeof(float);
  const float* valid;  // [rows]
  const float* mask;   // [n_docs]
  float* out;          // [q, n_docs]
  long long rows, n_docs;
  float* stage;  // [2 parities][NQ][kStride]
  int q0, nq, parity;
  float v_lo, v_hi, m_lo, m_hi;  // rows r_lo and r_lo + 8

  __device__ void begin_chunk(int q0_, int nq_) {
    q0 = q0_;
    nq = nq_;
    parity = 0;
  }

  __device__ void prefetch(long long row) {
    const long long r_lo =
        row + 16 * (threadIdx.x / 32) + (threadIdx.x % 32) / 4;
    v_lo = r_lo < rows ? valid[r_lo] : 0.0f;
    v_hi = r_lo + 8 < rows ? valid[r_lo + 8] : 0.0f;
    m_lo = r_lo < n_docs ? mask[r_lo] : 0.0f;
    m_hi = r_lo + 8 < n_docs ? mask[r_lo + 8] : 0.0f;
  }

  // max(s, 0) * valid * mask in the plain version's order (a NaN stays
  // NaN, as torch.clamp keeps it); a row past the corpus is 0 * mask
  static __device__ __forceinline__ float score(float s, bool in_corpus,
                                                float v, float m) {
    const float c = in_corpus ? __fmul_rn(s < 0.0f ? 0.0f : s, v) : 0.0f;
    return __fmul_rn(c, m);
  }

  __device__ void tile(Acc<NQ>& acc, long long row) {
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int t_lo = 16 * warp + lane / 4;
    const bool in_lo = row + t_lo < rows;
    const bool in_hi = row + t_lo + 8 < rows;
    float* st = stage + parity * NQ * kStride;
#pragma unroll
    for (int i = 0; i < NQ / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * i + 2 * (lane % 4) + e;
        st[col * kStride + t_lo] = score(acc.d[4 * i + e], in_lo, v_lo, m_lo);
        st[col * kStride + t_lo + 8] =
            score(acc.d[4 * i + 2 + e], in_hi, v_hi, m_hi);
      }
    }
    consumer_sync();
    const long long n_out = n_docs - row < kTileRows ? n_docs - row : kTileRows;
    for (int i = threadIdx.x; i < nq * kTileRows; i += kConsumers) {
      const int j = i / kTileRows, t = i % kTileRows;
      if (t < n_out) out[(long long)(q0 + j) * n_docs + row + t] =
          st[j * kStride + t];
    }
    parity ^= 1;  // the next tile stages in the other buffer
  }
};

template <int NQ>
__global__ void __launch_bounds__(kThreads, 1) dense_scores_kernel(
    const __grid_constant__ CUtensorMap map, const Bf16* __restrict__ queries,
    const float* __restrict__ valid, const float* __restrict__ mask,
    float* __restrict__ out, long long rows, long long n_docs, int d, int q) {
  extern __shared__ uint8_t raw[];
  const int nk = boxes<Bf16>(d);
  const Smem s = carve(raw, nk, NQ);
  const long long n_tiles = (rows + kTileRows - 1) / kTileRows;
  // the pad past the last tile: the plain version's zeros times the mask
  const long long pad0 =
      n_tiles * kTileRows < n_docs ? n_tiles * kTileRows : n_docs;
  const long long n_pad = n_docs - pad0;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n_pad * q; i += (long long)gridDim.x * blockDim.x) {
    const long long r = pad0 + i % n_pad;
    out[(i / n_pad) * n_docs + r] = __fmul_rn(0.0f, mask[r]);
  }
  Walk w;
  block_range(n_tiles, kTileRows, &w.r0, &w.r1);
  if (w.r0 >= w.r1) return;  // block-uniform
  w.first = w.r0;
  w.chunks = (q + NQ - 1) / NQ;
  w.nk = nk;
  init_barriers(s);
  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x == kConsumers) produce(&map, s, w);
  } else {
    DenseScores<NQ> epi;
    epi.valid = valid;
    epi.mask = mask;
    epi.out = out;
    epi.rows = rows;
    epi.n_docs = n_docs;
    epi.stage = reinterpret_cast<float*>(s.extra);
    consume<NQ>(s, w, queries, q, d, epi);
  }
}

template <int NQ>
int launch(const CUtensorMap& map, const void* queries, const void* valid,
           const void* mask, void* out, long long rows, long long n_docs,
           int d, int q, cudaStream_t stream) {
  const size_t smem = smem_bytes(boxes<Bf16>(d), NQ,
                                 NQ * DenseScores<NQ>::kExtraPerQuery);
  int grid = 0;
  const int err = grid_size((const void*)dense_scores_kernel<NQ>, smem,
                            (rows + kTileRows - 1) / kTileRows, &grid);
  if (err != 0) return err;
  dense_scores_kernel<NQ><<<grid, kThreads, smem, stream>>>(
      map, (const Bf16*)queries, (const float*)valid, (const float*)mask,
      (float*)out, rows, n_docs, d, q);
  return (int)cudaGetLastError();
}

}  // namespace

// vecs bf16 [rows, d] (rows <= n_docs: the wrapper passes the corpus's
// first min(P, n_docs) rows), queries bf16 [q, d], valid f32 [rows], mask
// f32 [n_docs], out f32 [q, n_docs]; vecs and queries 16-byte aligned and
// d % 8 == 0 (TMA boxes and the core's 16-byte query loads).
extern "C" int knn_dense_scores(const void* vecs, const void* queries,
                                const void* valid, const void* mask,
                                void* out, long long rows, long long n_docs,
                                int d, int q, void* stream) {
  if (q <= 0 || n_docs <= 0) return 0;
  if (rows <= 0 || rows > n_docs) return (int)cudaErrorInvalidValue;
  const int nq = pick_chunk(q, boxes<Bf16>(d),
                            DenseScores<kMaxChunk>::kExtraPerQuery, 0);
  if (nq == 0) return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  const int err = corpus_map<Bf16>(&map, vecs, rows, d);
  if (err != 0) return err;
  cudaStream_t st = (cudaStream_t)stream;
  switch (nq) {
    case 8:
      return launch<8>(map, queries, valid, mask, out, rows, n_docs, d, q, st);
    case 16:
      return launch<16>(map, queries, valid, mask, out, rows, n_docs, d, q,
                        st);
    case 32:
      return launch<32>(map, queries, valid, mask, out, rows, n_docs, d, q,
                        st);
    default:
      return launch<64>(map, queries, valid, mask, out, rows, n_docs, d, q,
                        st);
  }
}
