// B1: the phase-1 probe forms of K2 (kNN sub-block max), for
// orama_core_tpu_torch/tools/knn_tune_bench.py.
//
// Replaces: benchmarks/knn_tune_bench.py's Pallas variants of
// _subblock_max_kernel, all launched through run_phase1 (:167-169) over
// [BN, D] corpus blocks against resident queries:
//   - k_base (:114), k_rmax (:150), k_sub64 (:159) and k_sub128 (:291):
//     the masked per-sub-block max at sub = 32, 32, 64 and 128 rows, no
//     count. k_rmax differs from k_base only in how Mosaic lays out the
//     reduction (a reshape), so on this card both are one function and
//     one instantiation: max_only_kernel<NQ, false, RowQueries>;
//   - k_masklast (:136): the same max, masking only where a block
//     crosses n_valid: max_only_kernel<NQ, true, RowQueries>, which masks
//     only the 64-row tile that crosses n_valid;
//   - k_qt (:128): the same max, the queries given as qt [D, Q]:
//     max_only_kernel<NQ, false, ColQueries<NQ>>;
//   - k_mm (:122): no mask and no max, the bare product rows
//     out[b * (bn / sub) + r, q] = vecs[b * bn + r] . queries[q] for
//     r < bn / sub: rows_kernel<NQ>.
//
// Bound on this card: bytes. Every form streams the corpus (2 * D bytes a
// row) through the tensor cores for 2 * D * Q flops a row: at Q = 256 that
// is 256 flops/byte, below the ~295 at which bf16 tensor cores become the
// limit. k_mm writes only 1/32 of the rows' products but, being the
// probe of the mainloop's streaming floor, multiplies every tile of the
// corpus, kept or not: its time is at least the corpus read.
//
// Design: K2's streaming core (knn_stream.cuh: a TMA ring of 64 x 64
// boxes, wgmma against up to 64 resident queries, persistent blocks over
// contiguous ranges, one corpus pass per 64-query chunk) with three new
// parts: the MaxOnly epilogue (K2's MaxCount without the count), the Rows
// epilogue (the kept rows' f32 accumulators straight to device memory),
// and ColQueries, a loader that reads qt [D, Q] and writes the same
// swizzled K-major layout as load_queries, so the products are unchanged.
// None of them is made fast: they are the probes' first, simple forms.

#include "knn_stream.cuh"

namespace {

using namespace knn_stream;

constexpr float kNeg = -3.0e38f;

// The queries from qt [D, Q] (row-major, Q columns) into load_queries'
// layout: thread i takes query j = i % NQ and 8 consecutive columns, so
// neighbouring threads read neighbouring bf16 of a qt row, and writes
// them as one 16-byte group.
template <int NQ>
struct ColQueries {
  static __device__ __forceinline__ void load(const Smem& s,
                                              const __nv_bfloat16* qt, int q,
                                              int d, int q0, int nk) {
    const unsigned short* src = reinterpret_cast<const unsigned short*>(qt);
    consumer_sync();  // every warp is done with the previous chunk
    for (int i = threadIdx.x; i < nk * NQ * 8; i += kConsumers) {
      const int j = i % NQ;
      const int g = (i / NQ) & 7;
      const int kb = i / (NQ * 8);
      const int col = kb * kBoxCols + g * 8;
      uint32_t w[4] = {0, 0, 0, 0};
      if (q0 + j < q && col < d) {  // d % 8 == 0: the group is whole
        const unsigned short* p = src + (long long)col * q + q0 + j;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          w[e] = (uint32_t)p[(long long)(2 * e) * q] |
                 ((uint32_t)p[(long long)(2 * e + 1) * q] << 16);
        }
      }
      *reinterpret_cast<uint4*>(s.qs + (size_t)(kb * NQ + j) * 128 +
                                ((g ^ (j & 7)) << 4)) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    consumer_sync();
  }
};

// K2's MaxCount without the count. kEdge: only the tile that crosses
// n_valid masks its rows (tiles wholly past it are never walked).
template <int NQ, bool kEdge>
struct MaxOnly {
  float* bmax;
  long long n_valid, r1;
  int q, sub;
  float* red;  // [2 tile parities][4 warps][NQ]
  int q0, nq, parity;
  float run_max;  // thread j < NQ: column j's open sub-block

  __device__ void begin_chunk(int q0_, int nq_) {
    q0 = q0_;
    nq = nq_;
    parity = 0;
    run_max = kNeg;
  }

  __device__ void prefetch(long long) {}

  __device__ void tile(Acc<NQ>& acc, long long row) {
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const long long r_lo = row + 16 * warp + lane / 4;
    bool v_lo = true, v_hi = true;
    if (!kEdge || row + kTileRows > n_valid) {
      v_lo = r_lo < n_valid;
      v_hi = r_lo + 8 < n_valid;
    }
    float* rm = red + parity * 4 * NQ;
#pragma unroll
    for (int i = 0; i < NQ / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float m = fmaxf(v_lo ? acc.d[4 * i + e] : kNeg,
                        v_hi ? acc.d[4 * i + 2 + e] : kNeg);
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
        }
        if (lane < 4) rm[warp * NQ + 8 * i + 2 * lane + e] = m;
      }
    }
    consumer_sync();
    const int j = threadIdx.x;
    if (j < NQ) {
      for (int h = 0; h < 2; ++h) {  // 32-row halves: warps 2h and 2h + 1
        const long long base = row + 32 * h;
        if (base >= r1) break;
        run_max = fmaxf(run_max,
                        fmaxf(rm[2 * h * NQ + j], rm[(2 * h + 1) * NQ + j]));
        if ((base + 32) % sub == 0) {  // the half closes its sub-block
          if (j < nq) bmax[((base + 32) / sub - 1) * q + q0 + j] = run_max;
          run_max = kNeg;
        }
      }
    }
    parity ^= 1;  // the next tile writes the other buffer: no second barrier
  }
};

// k_mm: the f32 products of the first `keep` rows of every bn-row block,
// written to out [n / bn * keep, q]; every other tile is multiplied and
// dropped. bn % 64 == 0, so a tile lies in one block.
template <int NQ>
struct Rows {
  float* out;
  long long n;
  int q, bn, keep;
  int q0, nq;

  __device__ void begin_chunk(int q0_, int nq_) {
    q0 = q0_;
    nq = nq_;
  }

  __device__ void prefetch(long long) {}

  __device__ void tile(Acc<NQ>& acc, long long row) {
    const long long blk = row / bn;
    const int in = (int)(row - blk * bn);
    if (in >= keep) return;  // block-uniform: nothing of this tile is kept
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rr = 16 * warp + lane / 4 + 8 * h;
      if (in + rr >= keep || row + rr >= n) continue;
      float* dst = out + (blk * keep + in + rr) * q + q0;
#pragma unroll
      for (int i = 0; i < NQ / 8; ++i) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * i + 2 * (lane % 4) + e;
          if (col < nq) dst[col] = acc.d[4 * i + 2 * h + e];
        }
      }
    }
  }
};

template <int NQ, bool kEdge, class Loader>
__global__ void __launch_bounds__(kThreads, 1) max_only_kernel(
    const __grid_constant__ CUtensorMap map,
    const __nv_bfloat16* __restrict__ queries, float* __restrict__ bmax,
    long long n_sub, int d, int q, int sub, long long n_valid) {
  extern __shared__ uint8_t raw[];
  const int nk = (d + kBoxCols - 1) / kBoxCols;
  const Smem s = carve(raw, nk, NQ);
  const long long n_live = (n_valid + sub - 1) / sub;
  // sub-blocks wholly past n_valid: -3e38, no corpus reads
  for (long long i = n_live * q + (long long)blockIdx.x * blockDim.x +
                     threadIdx.x;
       i < n_sub * q; i += (long long)gridDim.x * blockDim.x) {
    bmax[i] = kNeg;
  }
  Walk w;
  block_range(n_live, sub, &w.r0, &w.r1);
  if (w.r0 >= w.r1) return;  // block-uniform
  w.first = w.r0;
  w.chunks = (q + NQ - 1) / NQ;
  w.nk = nk;
  init_barriers(s);
  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x == kConsumers) produce(&map, s, w);
  } else {
    MaxOnly<NQ, kEdge> epi;
    epi.bmax = bmax;
    epi.n_valid = n_valid;
    epi.r1 = w.r1;
    epi.q = q;
    epi.sub = sub;
    epi.red = reinterpret_cast<float*>(s.extra);
    consume<NQ, MaxOnly<NQ, kEdge>, Loader>(s, w, queries, q, d, epi);
  }
}

template <int NQ>
__global__ void __launch_bounds__(kThreads, 1) rows_kernel(
    const __grid_constant__ CUtensorMap map,
    const __nv_bfloat16* __restrict__ queries, float* __restrict__ out,
    long long n, int d, int q, int bn, int keep) {
  extern __shared__ uint8_t raw[];
  const int nk = (d + kBoxCols - 1) / kBoxCols;
  const Smem s = carve(raw, nk, NQ);
  Walk w;
  block_range((n + kTileRows - 1) / kTileRows, kTileRows, &w.r0, &w.r1);
  if (w.r0 >= w.r1) return;  // block-uniform
  w.first = w.r0;
  w.chunks = (q + NQ - 1) / NQ;
  w.nk = nk;
  init_barriers(s);
  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x == kConsumers) produce(&map, s, w);
  } else {
    Rows<NQ> epi;
    epi.out = out;
    epi.n = n;
    epi.q = q;
    epi.bn = bn;
    epi.keep = keep;
    consume<NQ>(s, w, queries, q, d, epi);
  }
}

constexpr int kMaxExtraPerQuery = 2 * 4 * sizeof(float);

template <int NQ, bool kEdge, class Loader>
int launch_max(const CUtensorMap& map, const void* queries, void* bmax,
               long long n_sub, int d, int q, int sub, long long n_valid,
               cudaStream_t stream) {
  const int nk = (d + kBoxCols - 1) / kBoxCols;
  const long long n_live = (n_valid + sub - 1) / sub;
  const long long unit = (sub % kTileRows) ? 2LL * sub : (long long)sub;
  const size_t smem = smem_bytes(nk, NQ, NQ * kMaxExtraPerQuery);
  const void* kern = (const void*)max_only_kernel<NQ, kEdge, Loader>;
  int grid = 0;
  const int err = grid_size(kern, smem, (n_live * sub + unit - 1) / unit,
                            &grid);
  if (err != 0) return err;
  max_only_kernel<NQ, kEdge, Loader><<<grid, kThreads, smem, stream>>>(
      map, (const __nv_bfloat16*)queries, (float*)bmax, n_sub, d, q, sub,
      n_valid);
  return (int)cudaGetLastError();
}

// form 0: queries [Q, D], every row masked; 1: the same, masked only at
// the edge; 2: queries as qt [D, Q]
template <int NQ>
int launch_form(int form, const CUtensorMap& map, const void* queries,
                void* bmax, long long n_sub, int d, int q, int sub,
                long long n_valid, cudaStream_t st) {
  switch (form) {
    case 0:
      return launch_max<NQ, false, RowQueries<NQ>>(map, queries, bmax, n_sub,
                                                   d, q, sub, n_valid, st);
    case 1:
      return launch_max<NQ, true, RowQueries<NQ>>(map, queries, bmax, n_sub,
                                                  d, q, sub, n_valid, st);
    default:
      return launch_max<NQ, false, ColQueries<NQ>>(map, queries, bmax, n_sub,
                                                   d, q, sub, n_valid, st);
  }
}

template <int NQ>
int launch_rows(const CUtensorMap& map, const void* queries, void* out,
                long long n, int d, int q, int bn, int keep,
                cudaStream_t stream) {
  const int nk = (d + kBoxCols - 1) / kBoxCols;
  const size_t smem = smem_bytes(nk, NQ, 0);
  int grid = 0;
  const int err = grid_size((const void*)rows_kernel<NQ>, smem,
                            (n + kTileRows - 1) / kTileRows, &grid);
  if (err != 0) return err;
  rows_kernel<NQ><<<grid, kThreads, smem, stream>>>(
      map, (const __nv_bfloat16*)queries, (float*)out, n, d, q, bn, keep);
  return (int)cudaGetLastError();
}

}  // namespace

// bmax f32[n / sub, q] of the per-sub-block max, rows >= n_valid scoring
// -3e38 (form: 0 every row masked, 1 masked at the edge, 2 queries given
// as qt [d, q])
extern "C" int knn_max_only(const void* vecs, const void* queries,
                            void* bmax, long long n, int d, int q, int sub,
                            long long n_valid, int form, void* stream) {
  const long long n_sub = n / sub;
  if (n_sub <= 0 || q <= 0) return 0;
  n_valid = n_valid < 0 ? 0 : (n_valid > n ? n : n_valid);
  const int nk = (d + kBoxCols - 1) / kBoxCols;
  const int nq = pick_chunk(q, nk, kMaxExtraPerQuery, 0);
  if (nq == 0) return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  const int err = corpus_map(&map, vecs, n, d);
  if (err != 0) return err;
  cudaStream_t st = (cudaStream_t)stream;
  switch (nq) {
    case 8:
      return launch_form<8>(form, map, queries, bmax, n_sub, d, q, sub,
                            n_valid, st);
    case 16:
      return launch_form<16>(form, map, queries, bmax, n_sub, d, q, sub,
                             n_valid, st);
    case 32:
      return launch_form<32>(form, map, queries, bmax, n_sub, d, q, sub,
                             n_valid, st);
    default:
      return launch_form<64>(form, map, queries, bmax, n_sub, d, q, sub,
                             n_valid, st);
  }
}

// out f32[n / bn * keep, q]: the first `keep` rows' products of every
// bn-row block (n % bn == 0, bn % 64 == 0, keep <= bn)
extern "C" int knn_phase1_rows(const void* vecs, const void* queries,
                               void* out, long long n, int d, int q, int bn,
                               int keep, void* stream) {
  if (n <= 0 || q <= 0 || keep <= 0) return 0;
  if (bn <= 0 || bn % kTileRows || n % bn || keep > bn) {
    return (int)cudaErrorInvalidValue;
  }
  const int nk = (d + kBoxCols - 1) / kBoxCols;
  const int nq = pick_chunk(q, nk, 0, 0);
  if (nq == 0) return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  const int err = corpus_map(&map, vecs, n, d);
  if (err != 0) return err;
  cudaStream_t st = (cudaStream_t)stream;
  switch (nq) {
    case 8:
      return launch_rows<8>(map, queries, out, n, d, q, bn, keep, st);
    case 16:
      return launch_rows<16>(map, queries, out, n, d, q, bn, keep, st);
    case 32:
      return launch_rows<32>(map, queries, out, n, d, q, bn, keep, st);
    default:
      return launch_rows<64>(map, queries, out, n, d, q, bn, keep, st);
  }
}
