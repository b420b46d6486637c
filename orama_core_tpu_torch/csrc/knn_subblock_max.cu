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
// Epilogue per tile: rows >= n_valid become -3e38 in the accumulator; per
// query column, each warp reduces its 16 rows' max and count of sims > 0
// by shuffles across the lanes that share lane % 4, writes them to
// shared memory, and one thread per column folds the warps of each
// 32-row half into its sub-block's running max and count, which carry
// over tiles when sub > 64. Only the real queries' columns are written.
// Sub-blocks wholly at or past n_valid get -3e38 / 0 without a read.

#include "knn_stream.cuh"

namespace {

using namespace knn_stream;

constexpr float kNeg = -3.0e38f;

template <int NQ>
struct MaxCount {
  float* bmax;
  int* bcnt;
  long long n_valid, r1;
  int q, sub;
  float* red_max;  // [2 tile parities][4 warps][NQ]
  int* red_cnt;
  int q0, nq, parity;
  float run_max;  // thread j < NQ: column j's open sub-block
  int run_cnt;

  __device__ void begin_chunk(int q0_, int nq_) {
    q0 = q0_;
    nq = nq_;
    parity = 0;
    run_max = kNeg;
    run_cnt = 0;
  }

  __device__ void prefetch(long long) {}

  __device__ void tile(Acc<NQ>& acc, long long row) {
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const long long r_lo = row + 16 * warp + lane / 4;
    const bool v_lo = r_lo < n_valid;
    const bool v_hi = r_lo + 8 < n_valid;
    float* rm = red_max + parity * 4 * NQ;
    int* rc = red_cnt + parity * 4 * NQ;
#pragma unroll
    for (int i = 0; i < NQ / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float a = v_lo ? acc.d[4 * i + e] : kNeg;
        const float b = v_hi ? acc.d[4 * i + 2 + e] : kNeg;
        float m = fmaxf(a, b);
        int c = (a > 0.0f) + (b > 0.0f);
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
          c += __shfl_xor_sync(0xffffffffu, c, off);
        }
        if (lane < 4) {
          const int col = 8 * i + 2 * lane + e;
          rm[warp * NQ + col] = m;
          rc[warp * NQ + col] = c;
        }
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
        run_cnt += rc[2 * h * NQ + j] + rc[(2 * h + 1) * NQ + j];
        if ((base + 32) % sub == 0) {  // the half closes its sub-block
          if (j < nq) {
            const long long s = (base + 32) / sub - 1;
            bmax[s * q + q0 + j] = run_max;
            bcnt[s * q + q0 + j] = run_cnt;
          }
          run_max = kNeg;
          run_cnt = 0;
        }
      }
    }
    parity ^= 1;  // the next tile writes the other buffer: no second barrier
  }
};

template <int NQ>
__global__ void __launch_bounds__(kThreads, 1) subblock_max_kernel(
    const __grid_constant__ CUtensorMap map,
    const __nv_bfloat16* __restrict__ queries, float* __restrict__ bmax,
    int* __restrict__ bcnt, long long n_sub, int d, int q, int sub,
    long long n_valid) {
  extern __shared__ uint8_t raw[];
  const int nk = (d + kBoxCols - 1) / kBoxCols;
  const Smem s = carve(raw, nk, NQ);
  const long long n_live = (n_valid + sub - 1) / sub;
  // sub-blocks wholly past n_valid: fixed outputs, no corpus reads
  for (long long i = n_live * q + (long long)blockIdx.x * blockDim.x +
                     threadIdx.x;
       i < n_sub * q; i += (long long)gridDim.x * blockDim.x) {
    bmax[i] = kNeg;
    bcnt[i] = 0;
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
    MaxCount<NQ> epi;
    epi.bmax = bmax;
    epi.bcnt = bcnt;
    epi.n_valid = n_valid;
    epi.r1 = w.r1;
    epi.q = q;
    epi.sub = sub;
    epi.red_max = reinterpret_cast<float*>(s.extra);
    epi.red_cnt =
        reinterpret_cast<int*>(s.extra + 2 * 4 * NQ * sizeof(float));
    consume<NQ>(s, w, queries, q, d, epi);
  }
}

constexpr int kExtraPerQuery = 2 * 4 * (sizeof(float) + sizeof(int));

template <int NQ>
int launch(const CUtensorMap& map, const void* queries, void* bmax,
           void* bcnt, long long n_sub, int d, int q, int sub,
           long long n_valid, cudaStream_t stream) {
  const int nk = (d + kBoxCols - 1) / kBoxCols;
  const long long n_live = (n_valid + sub - 1) / sub;
  const long long unit = (sub % kTileRows) ? 2LL * sub : (long long)sub;
  const size_t smem = smem_bytes(nk, NQ, NQ * kExtraPerQuery);
  int grid = 0;
  const int err = grid_size((const void*)subblock_max_kernel<NQ>, smem,
                            (n_live * sub + unit - 1) / unit, &grid);
  if (err != 0) return err;
  subblock_max_kernel<NQ><<<grid, kThreads, smem, stream>>>(
      map, (const __nv_bfloat16*)queries, (float*)bmax, (int*)bcnt, n_sub, d,
      q, sub, n_valid);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int knn_subblock_max(
    const void* vecs, const void* queries, void* bmax, void* bcnt,
    long long n, int d, int q, int sub, long long n_valid, void* stream) {
  const long long n_sub = n / sub;
  if (n_sub <= 0 || q <= 0) return 0;
  n_valid = n_valid < 0 ? 0 : (n_valid > n ? n : n_valid);
  const int nk = (d + kBoxCols - 1) / kBoxCols;
  const int nq = pick_chunk(q, nk, kExtraPerQuery, 0);
  if (nq == 0) return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  const int err = corpus_map(&map, vecs, n, d);
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
