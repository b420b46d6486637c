// K2: per-sub-block max similarity and positive count (kNN phase 1).
//
// Replaces: orama_core_tpu/ops/pallas_knn.py::_subblock_max_kernel (driven
// by knn_topk / knn_topk_with_count), which streams [BN, D] corpus blocks
// against the resident queries on the MXU, masks rows >= n_valid to -3e38
// and writes only the per-sub-block max (and the count of sims > 0) per
// query, so the [N, Q] similarities never reach device memory.
//
// Design: one warp per sub-block of `sub` rows (sub a multiple of 32),
// four warps per CUDA block. D is walked in slices of kDChunk columns, so
// shared memory stays fixed (38.9 KB a block) whatever the width: per
// slice the block stages the slice of up to kQChunk queries as f32, and
// each warp copies its 32 contiguous corpus rows' slice (bf16) to its own
// padded tile with coalesced 16-byte loads. Lane r then adds row r's
// slice products with every staged query to f32 accumulators held in
// registers across slices: bf16 products accumulated in f32 with FMAs
// (the TPU kernel's preferred_element_type=f32). After the last slice the
// warp reduces the max with shuffles and the count with a ballot.
// Sub-blocks at or above n_valid write -3e38 / 0 without touching the
// corpus, and a CUDA block with no valid row leaves at once, so the
// padded tail of a bucketed corpus costs no reads.
//
// Bound on this card: bytes at small query batches. Each corpus row is
// read once (2*D bytes) for 2*D*Q flops: at Q=8 that is 8 flops/byte,
// far below the ~295 flops/byte at which bf16 tensor cores become the
// limit.
//
// Left for a later PR: this design runs on the FMA pipes, not the tensor
// cores, and stages through shared memory with plain loads. TMA tiles
// feeding wgmma (64-row tiles against the query batch) would take large
// query batches to the tensor-core roofline; cp.async double buffering
// would overlap the tile copy with the dot products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kRows = 32;       // rows staged per warp at a time
constexpr int kQChunk = 8;      // queries scored per pass over a row
constexpr int kDChunk = 128;    // columns staged per slice
constexpr int kPitch = kDChunk + 8;  // bf16 per tile row: +16 B per row
                                     // keeps the lanes' reads conflict-free
constexpr float kNeg = -3.0e38f;

__global__ void __launch_bounds__(kWarps * 32) subblock_max_kernel(
    const __nv_bfloat16* __restrict__ vecs,
    const __nv_bfloat16* __restrict__ queries, float* __restrict__ bmax,
    int* __restrict__ bcnt, long long n_sub, int d, int q, int sub,
    long long n_valid) {
  __shared__ float qs[kQChunk * kDChunk];                    // [8, 128] f32
  __shared__ __align__(16) __nv_bfloat16 tiles[kWarps * kRows * kPitch];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  __nv_bfloat16* tile = tiles + warp * kRows * kPitch;

  const long long s = (long long)blockIdx.x * kWarps + warp;
  const long long row0 = s * sub;
  // warp-uniform: only a live warp reads the corpus and reduces
  const bool live = s < n_sub && row0 < n_valid;
  if (s < n_sub && !live) {
    // all-padding sub-block: fixed outputs, no corpus reads
    for (int j = lane; j < q; j += 32) {
      bmax[s * q + j] = kNeg;
      bcnt[s * q + j] = 0;
    }
  }
  // block-uniform, so no thread is left waiting at a barrier below
  if ((long long)blockIdx.x * kWarps * sub >= n_valid) return;

  for (int q0 = 0; q0 < q; q0 += kQChunk) {
    const int nq = min(kQChunk, q - q0);
    float best[kQChunk];
    int cnt[kQChunk];
#pragma unroll
    for (int j = 0; j < kQChunk; ++j) {
      best[j] = kNeg;
      cnt[j] = 0;
    }
    for (int c = 0; c < sub; c += kRows) {
      const long long base = row0 + c;
      float acc[kQChunk];
#pragma unroll
      for (int j = 0; j < kQChunk; ++j) acc[j] = 0.0f;
      for (int k0 = 0; k0 < d; k0 += kDChunk) {
        const int dc = min(kDChunk, d - k0);
        __syncthreads();  // every warp is done with the previous slice
        for (int i = threadIdx.x; i < nq * dc; i += blockDim.x) {
          const int j = i / dc;
          const int kk = i - j * dc;
          qs[j * kDChunk + kk] =
              __bfloat162float(queries[(long long)(q0 + j) * d + k0 + kk]);
        }
        if (live) {
          // coalesced copy of the 32 rows' slice into the padded tile
          const int cpr = dc / 8;                      // 16-byte chunks a row
          for (int i = lane; i < kRows * cpr; i += 32) {
            const int r = i / cpr;
            const int col = (i - r * cpr) * 8;
            *reinterpret_cast<uint4*>(tile + r * kPitch + col) =
                *reinterpret_cast<const uint4*>(vecs + (base + r) * d + k0 +
                                                col);
          }
        }
        __syncthreads();
        if (live) {
          const __nv_bfloat16* row = tile + lane * kPitch;
          for (int kk = 0; kk < dc; kk += 8) {
            const uint4 raw = *reinterpret_cast<const uint4*>(row + kk);
            const __nv_bfloat16* v8 =
                reinterpret_cast<const __nv_bfloat16*>(&raw);
            float v[8];
#pragma unroll
            for (int e = 0; e < 8; ++e) v[e] = __bfloat162float(v8[e]);
#pragma unroll
            for (int j = 0; j < kQChunk; ++j) {
              if (j < nq) {
                const float* qv = qs + j * kDChunk + kk;
#pragma unroll
                for (int e = 0; e < 8; ++e) acc[j] = fmaf(v[e], qv[e], acc[j]);
              }
            }
          }
        }
      }
      if (live) {
        const bool valid = base + lane < n_valid;
#pragma unroll
        for (int j = 0; j < kQChunk; ++j) {
          float sim = valid ? acc[j] : kNeg;
          float m = sim;
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) {
            m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
          }
          best[j] = fmaxf(best[j], m);
          cnt[j] += __popc(__ballot_sync(0xffffffffu, sim > 0.0f));
        }
      }
    }
    if (live && lane < nq) {
      // static register indexing: select this lane's query slot
      float bv = kNeg;
      int cv = 0;
#pragma unroll
      for (int j = 0; j < kQChunk; ++j) {
        if (j == lane) {
          bv = best[j];
          cv = cnt[j];
        }
      }
      bmax[s * q + q0 + lane] = bv;
      bcnt[s * q + q0 + lane] = cv;
    }
  }
}

}  // namespace

extern "C" int knn_subblock_max(
    const void* vecs, const void* queries, void* bmax, void* bcnt,
    long long n, int d, int q, int sub, long long n_valid, void* stream) {
  const long long n_sub = n / sub;
  const long long grid = (n_sub + kWarps - 1) / kWarps;
  if (grid > 0) {
    subblock_max_kernel<<<(unsigned)grid, kWarps * 32, 0,
                          (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)vecs, (const __nv_bfloat16*)queries,
        (float*)bmax, (int*)bcnt, n_sub, d, q, sub, n_valid);
  }
  return (int)cudaGetLastError();
}
