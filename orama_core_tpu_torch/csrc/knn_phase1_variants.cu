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
//     one instantiation: max_kernel<N, false, KMajorQueries<N>>;
//   - k_masklast (:136): the same max, masking only where a block
//     crosses n_valid: max_kernel<N, true, KMajorQueries<N>>, which masks
//     only the 128-row tile that crosses n_valid;
//   - k_qt (:128): the same max, the queries given as qt [D, Q]:
//     max_kernel<N, false, MNMajorQueries<N>>, whose qt boxes reach wgmma
//     MN-major (its transpose-B bit), with no transpose on the way in;
//   - k_mm (:122): no mask and no max, the bare product rows
//     out[b * keep + r, q] = vecs[b * bn + r] . queries[q] for r < keep =
//     bn / sub: kept_rows_kernel<N>.
//
// Bound on this card: at B1's shape (1,001,472 x 768, Q = 256) the max
// forms move 1.568 GB (0.468 ms at 3.35 TB/s) for 393 GFLOP (0.397 ms at
// 989 TFLOP/s): both near, so the tensor cores must run near their peak
// while the corpus streams at the memory's rate. k_mm reads only its kept
// rows (1 in 32: 48 MB) and writes their f32 products (32 MB): bytes,
// 0.024 ms.
//
// Design: knn_wide.cuh's one-pass core (128-row tiles x up to 256
// queries, two consumer warpgroups on wgmma m64n256k16, queries streamed
// beside the corpus and shared by a cluster of two blocks through TMA
// multicast): every form takes Q <= 256 in ONE corpus pass, one pass per
// 256-query chunk beyond. The epilogues:
//   - MaxEpi: per warp the max of each lo/hi row pair, a butterfly of
//     xor shuffles to the max of its 16 rows, the 16-row maxima through
//     shared memory to one consumer thread a query column, which closes
//     the tile's sub-blocks;
//   - RowsEpi: each quad of threads swaps halves once (a xor shuffle), so
//     each thread holds 4 consecutive columns of a row and writes them as
//     one 16-byte store, a quad 64 contiguous bytes.

#include "knn_wide.cuh"

namespace {

using namespace knn_wide;

constexpr float kNeg = -3.0e38f;

// Halves the K values of m across the lanes that differ in lane bit
// `off`: the lane with the bit set keeps the upper half, the other the
// lower, each taking the max with what its partner sends.
template <int K>
__device__ __forceinline__ void halve(float* m, int off) {
  const bool upper = threadIdx.x & off;
#pragma unroll
  for (int t = 0; t < K / 2; ++t) {
    const float send = upper ? m[t] : m[t + K / 2];
    const float keep = upper ? m[t + K / 2] : m[t];
    m[t] = fmaxf(keep, __shfl_xor_sync(0xffffffffu, send, off));
  }
}

// K2's max without the count. kEdge: only the tile that crosses n_valid
// masks its rows (tiles wholly past it are never walked). A tile closes
// 128 / sub whole sub-blocks: sub divides the tile and every walk starts
// on a tile.
template <int N, bool kEdge>
struct MaxEpi {
  float* bmax;
  long long n_valid, r1;
  int q, sub;
  float* red;  // [2 tile parities][8 warps][N]: each warp's 16-row maxima
  int q0, nq, parity;

  __device__ void begin_pass(int q0_, int nq_) {
    q0 = q0_;
    nq = nq_;
  }

  __device__ void tile(Acc<N>& acc, long long row) {
    const int warp = threadIdx.x / 32;  // rows 16 * warp .. + 15
    const int lane = threadIdx.x % 32;
    const long long r_lo = row + 16 * warp + lane / 4;
    bool v_lo = true, v_hi = true;
    if (!kEdge || row + kTileRows > n_valid) {
      v_lo = r_lo < n_valid;
      v_hi = r_lo + 8 < n_valid;
    }
    // value x: column 8 * (x / 2) + 2 * (lane % 4) + x % 2, the max of the
    // lane's lo and hi rows; then the max over the warp's 8 row pairs by a
    // butterfly over lane bits 4, 3 and 2, which leaves N / 32 columns a
    // lane (3.4x fewer shuffles than reducing every column in full)
    float m[N / 4];
#pragma unroll
    for (int x = 0; x < N / 4; ++x) {
      const int i = x / 2, e = x % 2;
      m[x] = fmaxf(v_lo ? acc.d[4 * i + e] : kNeg,
                   v_hi ? acc.d[4 * i + 2 + e] : kNeg);
    }
    halve<N / 4>(m, 16);
    halve<N / 8>(m, 8);
    halve<N / 16>(m, 4);
    const int x0 = (lane & 16 ? N / 8 : 0) + (lane & 8 ? N / 16 : 0) +
                   (lane & 4 ? N / 32 : 0);
    float* rm = red + parity * 8 * N;
#pragma unroll
    for (int t = 0; t < N / 32; ++t) {
      const int x = x0 + t;
      rm[warp * N + 8 * (x / 2) + 2 * (lane % 4) + x % 2] = m[t];
    }
    consumer_sync();
    // thread j: query column j, each sub-block's sub / 16 warps
    const int per = sub / 16;
    const int col = threadIdx.x;
    if (col < nq) {
      for (int g = 0; g < kTileRows / sub; ++g) {
        const long long base = row + (long long)g * sub;
        if (base >= r1) break;
        float v = kNeg;
        for (int k = 0; k < per; ++k) {
          v = fmaxf(v, rm[(g * per + k) * N + col]);
        }
        bmax[(base / sub) * q + q0 + col] = v;
      }
    }
    parity ^= 1;  // the next tile writes the other buffer: no second barrier
  }
};

// k_mm's rows: tile row r is kept row `row + r` of out [kept, q].
template <int N>
struct RowsEpi {
  float* out;
  long long r1;
  int q;
  bool vec;  // q % 4 == 0: 16-byte stores
  int q0, nq;

  __device__ void begin_pass(int q0_, int nq_) {
    q0 = q0_;
    nq = nq_;
  }

  __device__ void tile(Acc<N>& acc, long long row) {
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int c = lane & 3;
    const bool odd = c & 1;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long k = row + 16 * warp + lane / 4 + 8 * h;
      float* dst = out + k * q + q0;
#pragma unroll
      for (int p = 0; p < N / 16; ++p) {
        // columns 16p + 2c, +1 (a) and 16p + 8 + 2c, +1 (b); after the
        // swap: even c holds 16p + 2c .. + 3, odd c 16p + 8 + 2(c - 1) .. + 3
        const float a0 = acc.d[8 * p + 2 * h], a1 = acc.d[8 * p + 2 * h + 1];
        const float b0 = acc.d[8 * p + 4 + 2 * h];
        const float b1 = acc.d[8 * p + 4 + 2 * h + 1];
        const float s0 = __shfl_xor_sync(0xffffffffu, odd ? a0 : b0, 1);
        const float s1 = __shfl_xor_sync(0xffffffffu, odd ? a1 : b1, 1);
        const float4 v = odd ? make_float4(s0, s1, b0, b1)
                             : make_float4(a0, a1, s0, s1);
        const int col = 16 * p + 8 * (c & 1) + 2 * (c & 2);
        if (k >= r1) continue;
        if (vec) {
          if (col < nq) *reinterpret_cast<float4*>(dst + col) = v;
        } else {
          const float f[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (col + e < nq) dst[col + e] = f[e];
          }
        }
      }
    }
  }
};

template <int N, bool kEdge, class Queries>
__global__ void __launch_bounds__(kThreads, 1) max_kernel(
    const __grid_constant__ CUtensorMap corpus_map,
    const __grid_constant__ CUtensorMap query_map, float* __restrict__ bmax,
    long long n_sub, int nk, int q, int sub, long long n_valid) {
  extern __shared__ uint8_t raw[];
  const long long n_live = (n_valid + sub - 1) / sub;
  // sub-blocks wholly past n_valid: -3e38, no corpus reads
  for (long long i = n_live * q + (long long)blockIdx.x * blockDim.x +
                     threadIdx.x;
       i < n_sub * q; i += (long long)gridDim.x * blockDim.x) {
    bmax[i] = kNeg;
  }
  Walk w = cluster_walk(n_live * sub);
  if (w.steps == 0) return;  // the same for both blocks of the cluster
  w.passes = (q + N - 1) / N;
  w.nk = nk;
  const Ring<N> s = carve<N>(raw);
  MaxEpi<N, kEdge> epi;
  epi.bmax = bmax;
  epi.n_valid = n_valid;
  epi.r1 = w.r1;
  epi.q = q;
  epi.sub = sub;
  epi.red = reinterpret_cast<float*>(s.extra);
  epi.parity = 0;
  run<N>(s, w, TileCorpus{&corpus_map}, Queries{&query_map}, q, epi);
}

template <int N>
__global__ void __launch_bounds__(kThreads, 1) kept_rows_kernel(
    const __grid_constant__ CUtensorMap kept_map,
    const __grid_constant__ CUtensorMap query_map, float* __restrict__ out,
    long long kept, int nk, int q, int keep) {
  extern __shared__ uint8_t raw[];
  Walk w = cluster_walk(kept);
  if (w.steps == 0) return;  // the same for both blocks of the cluster
  w.passes = (q + N - 1) / N;
  w.nk = nk;
  const Ring<N> s = carve<N>(raw);
  RowsEpi<N> epi;
  epi.out = out;
  epi.r1 = w.r1;
  epi.q = q;
  epi.vec = q % 4 == 0;
  run<N>(s, w, KeptCorpus{&kept_map, keep}, KMajorQueries<N>{&query_map},
         q, epi);
}

// The queries' map at pass width N: queries [q, d] (K-major boxes of
// KMajorQueries' rows, a block's share) or, for qt, [d, ld] with ld = q
// rounded up to 8 (boxes [MNMajorQueries' d rows x 64 queries]).
template <int N>
int encode_queries(CUtensorMap* out, const void* queries, int q, int d,
                   bool qt) {
  if (qt) {
    const int ld = (q + 7) / 8 * 8;
    const cuuint64_t dims[2] = {(cuuint64_t)q, (cuuint64_t)d};
    const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
    const cuuint32_t box[2] = {64, MNMajorQueries<N>::kDRows};
    return encode(out, queries, 2, dims, strides, box);
  }
  const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)q};
  const cuuint64_t strides[1] = {(cuuint64_t)d * 2};
  const cuuint32_t box[2] = {kBoxCols, KMajorQueries<N>::kQueryRows};
  return encode(out, queries, 2, dims, strides, box);
}

template <int N, bool kEdge, class Queries>
int launch_max(const CUtensorMap& corpus, const CUtensorMap& queries,
               void* bmax, long long n_sub, int d, int q, int sub,
               long long n_valid, cudaStream_t stream) {
  const int nk = (d + kBoxCols - 1) / kBoxCols;
  const long long n_live = (n_valid + sub - 1) / sub;
  const size_t smem = smem_bytes<N>(2 * 8 * N * sizeof(float));
  auto kern = max_kernel<N, kEdge, Queries>;
  int grid = 0;
  const int err = cluster_grid((const void*)kern, smem,
                               (n_live * sub + kTileRows - 1) / kTileRows,
                               &grid);
  if (err != 0) return err;
  return launch(kern, grid, smem, stream, corpus, queries, (float*)bmax,
                n_sub, nk, q, sub, n_valid);
}

// form 0: queries [Q, D], every row masked; 1: the same, masked only at
// the edge; 2: queries as qt [D, Q]
template <int N>
int launch_form(int form, const void* vecs, const void* queries, void* bmax,
                long long n, int d, int q, int sub, long long n_valid,
                cudaStream_t st) {
  CUtensorMap corpus, qmap;
  const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)n};
  const cuuint64_t strides[1] = {(cuuint64_t)d * 2};
  const cuuint32_t box[2] = {kBoxCols, kTileRows};
  int err = encode_cached(&corpus, vecs, 2, dims, strides, box);
  if (err == 0) err = encode_queries<N>(&qmap, queries, q, d, form == 2);
  if (err != 0) return err;
  const long long n_sub = n / sub;
  switch (form) {
    case 0:
      return launch_max<N, false, KMajorQueries<N>>(
          corpus, qmap, bmax, n_sub, d, q, sub, n_valid, st);
    case 1:
      return launch_max<N, true, KMajorQueries<N>>(
          corpus, qmap, bmax, n_sub, d, q, sub, n_valid, st);
    default:
      return launch_max<N, false, MNMajorQueries<N>>(
          corpus, qmap, bmax, n_sub, d, q, sub, n_valid, st);
  }
}

template <int N>
int launch_rows(const void* vecs, const void* queries, void* out,
                long long n, int d, int q, int bn, int keep,
                cudaStream_t stream) {
  // the kept rows alone: (d, keep, n / bn), 64 kept rows a box
  CUtensorMap kept_map, qmap;
  const int rows = keep < 64 ? keep : 64;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)keep,
                              (cuuint64_t)(n / bn)};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)d * 2 * bn};
  const cuuint32_t box[3] = {kBoxCols, (cuuint32_t)rows,
                             (cuuint32_t)(64 / rows)};
  int err = encode_cached(&kept_map, vecs, 3, dims, strides, box);
  if (err == 0) err = encode_queries<N>(&qmap, queries, q, d, false);
  if (err != 0) return err;
  const int nk = (d + kBoxCols - 1) / kBoxCols;
  const long long kept = n / bn * keep;
  const size_t smem = smem_bytes<N>(0);
  auto kern = kept_rows_kernel<N>;
  int grid = 0;
  err = cluster_grid((const void*)kern, smem,
                     (kept + kTileRows - 1) / kTileRows, &grid);
  if (err != 0) return err;
  return launch(kern, grid, smem, stream, kept_map, qmap, (float*)out, kept,
                nk, q, keep);
}

}  // namespace

// bmax f32[n / sub, q] of the per-sub-block max, rows >= n_valid scoring
// -3e38 (form: 0 every row masked, 1 masked at the edge, 2 queries given
// as qt [d, q rounded up to 8], row-major). sub is 32, 64 or 128.
extern "C" int knn_max_only(const void* vecs, const void* queries,
                            void* bmax, long long n, int d, int q, int sub,
                            long long n_valid, int form, void* stream) {
  if (sub < 32 || kTileRows % sub) return (int)cudaErrorInvalidValue;
  if (n / sub <= 0 || q <= 0) return 0;
  n_valid = n_valid < 0 ? 0 : (n_valid > n ? n : n_valid);
  cudaStream_t st = (cudaStream_t)stream;
  switch (pick_width(q)) {
    case 64:
      return launch_form<64>(form, vecs, queries, bmax, n, d, q, sub,
                             n_valid, st);
    case 128:
      return launch_form<128>(form, vecs, queries, bmax, n, d, q, sub,
                              n_valid, st);
    case 192:
      return launch_form<192>(form, vecs, queries, bmax, n, d, q, sub,
                              n_valid, st);
    default:
      return launch_form<256>(form, vecs, queries, bmax, n, d, q, sub,
                              n_valid, st);
  }
}

// out f32[n / bn * keep, q]: the first `keep` rows' products of every
// bn-row block (n % bn == 0, keep <= bn, keep a multiple of 64 or a
// divisor of 64)
extern "C" int knn_phase1_rows(const void* vecs, const void* queries,
                               void* out, long long n, int d, int q, int bn,
                               int keep, void* stream) {
  if (n <= 0 || q <= 0 || keep <= 0) return 0;
  if (bn <= 0 || n % bn || keep > bn || (keep % 64 && 64 % keep)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  switch (pick_width(q)) {
    case 64:
      return launch_rows<64>(vecs, queries, out, n, d, q, bn, keep, st);
    case 128:
      return launch_rows<128>(vecs, queries, out, n, d, q, bn, keep, st);
    case 192:
      return launch_rows<192>(vecs, queries, out, n, d, q, bn, keep, st);
    default:
      return launch_rows<256>(vecs, queries, out, n, d, q, bn, keep, st);
  }
}
