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
// Design: K2's (csrc/knn_subblock_max.cu), on bytes. One warp per
// sub-block of `sub` rows (sub a multiple of 32), four warps per CUDA
// block. D is walked in slices of kDChunk codes, so shared memory stays
// fixed (36.9 KB a block) whatever the width: per slice the block stages
// the slice of up to kQChunk int8 queries, and each warp copies its 32
// contiguous rows' slice to its own padded tile with coalesced 16-byte
// loads. Lane r then multiplies row r's codes, 16 at a time, with every
// staged query by __dp4a into int32 accumulators held in registers
// across slices, and multiplies the exact sum once by the row's scale:
// the same single f32 rounding as the plain version, so the two agree
// exactly. The warp reduces the max with shuffles and the count with a
// ballot. Sub-blocks at or above n_valid write -3e38 / 0 without touching
// the codes, and a CUDA block with no valid row leaves at once.
//
// Bound on this card: bytes. Each row is read once (D bytes + a 4-byte
// scale) for 2*D*Q integer operations: at Q=8 that is 16 ops/byte, far
// below the ~590 int8 ops/byte at which the int8 tensor cores become the
// limit; half of K2's bytes for the same corpus.
//
// Left for a later PR: the dot products run on the integer pipes
// (dp4a), not the tensor cores, and the tile copy is not overlapped with
// compute; cp.async double buffering (or TMA) would keep a slice in
// flight behind the dp4a work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kRows = 32;        // rows staged per warp at a time
constexpr int kQChunk = 8;       // queries scored per pass over a row
constexpr int kDChunk = 256;     // codes (bytes) staged per slice
constexpr int kPitch = kDChunk + 16;  // +16 B per row keeps the lanes'
                                      // 16-byte reads conflict-free
constexpr float kNeg = -3.0e38f;

__global__ void __launch_bounds__(kWarps * 32) subblock_max_int8_kernel(
    const int8_t* __restrict__ codes, const float* __restrict__ scales,
    const int8_t* __restrict__ q8, float* __restrict__ bmax,
    int* __restrict__ bcnt, long long n_sub, int d, int q, int sub,
    long long n_valid) {
  __shared__ __align__(16) int8_t qs[kQChunk * kDChunk];     // [8, 256]
  __shared__ __align__(16) int8_t tiles[kWarps * kRows * kPitch];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  int8_t* tile = tiles + warp * kRows * kPitch;

  const long long s = (long long)blockIdx.x * kWarps + warp;
  const long long row0 = s * sub;
  // warp-uniform: only a live warp reads the codes and reduces
  const bool live = s < n_sub && row0 < n_valid;
  if (s < n_sub && !live) {
    // all-padding sub-block: fixed outputs, no reads
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
      int acc[kQChunk];
#pragma unroll
      for (int j = 0; j < kQChunk; ++j) acc[j] = 0;
      for (int k0 = 0; k0 < d; k0 += kDChunk) {
        const int dc = min(kDChunk, d - k0);
        const int cpr = dc / 16;                        // 16-byte chunks a row
        __syncthreads();  // every warp is done with the previous slice
        for (int i = threadIdx.x; i < nq * cpr; i += blockDim.x) {
          const int j = i / cpr;
          const int col = (i - j * cpr) * 16;
          *reinterpret_cast<int4*>(qs + j * kDChunk + col) =
              *reinterpret_cast<const int4*>(q8 + (long long)(q0 + j) * d +
                                             k0 + col);
        }
        if (live) {
          for (int i = lane; i < kRows * cpr; i += 32) {
            const int r = i / cpr;
            const int col = (i - r * cpr) * 16;
            *reinterpret_cast<int4*>(tile + r * kPitch + col) =
                *reinterpret_cast<const int4*>(codes + (base + r) * d + k0 +
                                               col);
          }
        }
        __syncthreads();
        if (live) {
          const int8_t* row = tile + lane * kPitch;
          for (int kk = 0; kk < dc; kk += 16) {
            const int4 v = *reinterpret_cast<const int4*>(row + kk);
#pragma unroll
            for (int j = 0; j < kQChunk; ++j) {
              if (j < nq) {
                const int4 w =
                    *reinterpret_cast<const int4*>(qs + j * kDChunk + kk);
                int a = acc[j];
                a = __dp4a(v.x, w.x, a);
                a = __dp4a(v.y, w.y, a);
                a = __dp4a(v.z, w.z, a);
                a = __dp4a(v.w, w.w, a);
                acc[j] = a;
              }
            }
          }
        }
      }
      if (live) {
        const bool valid = base + lane < n_valid;
        const float scale = valid ? scales[base + lane] : 0.0f;
#pragma unroll
        for (int j = 0; j < kQChunk; ++j) {
          // one f32 rounding of the exact sum, as the plain version
          float sim = valid ? __fmul_rn((float)acc[j], scale) : kNeg;
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

extern "C" int knn_subblock_max_int8(
    const void* codes, const void* scales, const void* q8, void* bmax,
    void* bcnt, long long n, int d, int q, int sub, long long n_valid,
    void* stream) {
  const long long n_sub = n / sub;
  const long long grid = (n_sub + kWarps - 1) / kWarps;
  if (grid > 0) {
    subblock_max_int8_kernel<<<(unsigned)grid, kWarps * 32, 0,
                               (cudaStream_t)stream>>>(
        (const int8_t*)codes, (const float*)scales, (const int8_t*)q8,
        (float*)bmax, (int*)bcnt, n_sub, d, q, sub, n_valid);
  }
  return (int)cudaGetLastError();
}
