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
// works only because a TPU grid runs in order.
//
// Design: a CUDA grid runs in no order, so nothing is carried between
// blocks. The engine bounds a doc to m_max <= 64 rows, so a sub-block
// needs only its own rows plus the earlier rows of its leading doc, at
// most m_max - 1 rows back. One warp per sub-block of `sub` rows (sub a
// multiple of 32), four warps per CUDA block. The warp reads the doc ids
// before its first row (ballots over 32 ids at a time) to find how many
// rows L of its leading doc precede it, scores those L rows too (they
// were just streamed by the neighbouring warp, so they come from L2), and
// then walks its own rows 32 at a time. Dot products are K2's: D in
// 128-column slices through a padded shared-memory tile (38.9 KB a block
// at any width), one lane per row, f32 FMAs. Per 32 rows the warp runs a
// segmented inclusive scan of relu(sim) with shuffles (a lane adds the
// partial sum `off` lanes up when that lane holds the same doc: sound
// because equal ids are contiguous), adds the sum carried from the
// previous 32 rows to the lanes of the carried doc, and finds each
// positive row's earlier positives in its doc from a ballot. Rows at or
// above n_valid score 0 and join no doc (the engine pads doc ids with 0,
// which would otherwise break the ascending order); a sub-block wholly
// past n_valid writes max 0 and count 0 without reading.
//
// Bound on this card: bytes. Each row is read once (2*D bytes + a 4-byte
// doc id) for 2*D*Q flops: at Q=8, 8 flops/byte, far below the ~295
// flops/byte at which bf16 tensor cores become the limit. The look-back
// rows add L2 traffic, not device-memory traffic.
//
// Left for a later PR: as for K2, the FMA pipes instead of the tensor
// cores and no copy in flight behind the compute.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kRows = 32;       // rows staged per warp at a time
constexpr int kQChunk = 8;      // queries scored per pass over a row
constexpr int kDChunk = 128;    // columns staged per slice
constexpr int kPitch = kDChunk + 8;  // bf16 per tile row: conflict-free reads
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kWarps * 32) subblock_max_mv_kernel(
    const __nv_bfloat16* __restrict__ vecs, const int* __restrict__ row_docs,
    const __nv_bfloat16* __restrict__ queries, float* __restrict__ bmax,
    int* __restrict__ bcnt, long long n_sub, int d, int q, int sub,
    long long n_valid, int m_max) {
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
    // all-padding sub-block: padding scores 0, so max 0, count 0
    for (int j = lane; j < q; j += 32) {
      bmax[s * q + j] = 0.0f;
      bcnt[s * q + j] = 0;
    }
  }
  // block-uniform, so no thread is left waiting at a barrier below
  if ((long long)blockIdx.x * kWarps * sub >= n_valid) return;

  // L = the rows just before row0 that belong to its doc (< m_max)
  const int n_back = (m_max - 1 + kRows - 1) / kRows;  // block-uniform
  long long lead_rows = 0;
  if (live) {
    const int lead = row_docs[row0];
    for (int b = 0; b < n_back; ++b) {
      const int t = b * kRows + lane;
      const long long r = row0 - 1 - t;
      const bool eq = t < m_max - 1 && r >= 0 && row_docs[r] == lead;
      const unsigned m = __ballot_sync(kFull, eq);
      if (m != kFull) {
        lead_rows += __ffs(~m) - 1;  // leading run of equal ids
        break;
      }
      lead_rows += kRows;
    }
  }
  const long long lo_row = row0 - lead_rows;
  const unsigned below_lane = (1u << lane) - 1u;          // lanes < lane

  for (int q0 = 0; q0 < q; q0 += kQChunk) {
    const int nq = min(kQChunk, q - q0);
    float best[kQChunk];
    int cnt[kQChunk];
    float carry_sum[kQChunk];
    unsigned carry_seen = 0;  // bit j: the carried doc has a positive row
    int carry_doc = -3;       // matches no row
#pragma unroll
    for (int j = 0; j < kQChunk; ++j) {
      best[j] = 0.0f;
      cnt[j] = 0;
      carry_sum[j] = 0.0f;
    }
    for (int c = -n_back; c * kRows < sub; ++c) {
      const long long base = row0 + (long long)c * kRows;
      // warp-uniform: look-back chunks run only where they hold lead rows
      const bool act = live && (c >= 0 || lead_rows > -(long long)kRows * (c + 1));
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
        if (act) {
          // coalesced copy of the chunk's needed rows into the tile
          const int cpr = dc / 8;                      // 16-byte chunks a row
          for (int i = lane; i < kRows * cpr; i += 32) {
            const int r = i / cpr;
            if (base + r < lo_row) continue;
            const int col = (i - r * cpr) * 8;
            *reinterpret_cast<uint4*>(tile + r * kPitch + col) =
                *reinterpret_cast<const uint4*>(vecs + (base + r) * d + k0 +
                                                col);
          }
        }
        __syncthreads();
        if (act) {
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
      if (!act) continue;
      const long long r = base + lane;
      // rows before the lead run: -2; padding rows: -1; both score 0
      const bool real = r >= lo_row && r < n_valid;
      const int doc = real ? row_docs[r] : (r >= n_valid ? -1 : -2);
      bool same[5];
#pragma unroll
      for (int k = 0; k < 5; ++k) {
        const int off = 1 << k;
        const int up = __shfl_up_sync(kFull, doc, off);
        same[k] = lane >= off && up == doc;
      }
      const int prev = __shfl_up_sync(kFull, doc, 1);
      const unsigned starts =
          __ballot_sync(kFull, lane == 0 || prev != doc);
      // first lane of this lane's doc run within the 32 rows
      const int run0 = 31 - __clz(starts & (below_lane | (1u << lane)));
      const unsigned in_run = below_lane & ~((1u << run0) - 1u);
      const bool joins = run0 == 0 && doc == carry_doc;
#pragma unroll
      for (int j = 0; j < kQChunk; ++j) {
        if (j < nq) {
          float v = real ? fmaxf(acc[j], 0.0f) : 0.0f;
          const bool pos = real && acc[j] > 0.0f;
#pragma unroll
          for (int k = 0; k < 5; ++k) {
            const float up = __shfl_up_sync(kFull, v, 1 << k);
            if (same[k]) v += up;
          }
          if (joins) v += carry_sum[j];
          const unsigned pm = __ballot_sync(kFull, pos);
          const bool seen = (pm & in_run) != 0 ||
                            (joins && ((carry_seen >> j) & 1u));
          if (c >= 0) {
            float m = v;
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) {
              m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
            }
            best[j] = fmaxf(best[j], m);
            cnt[j] += __popc(__ballot_sync(kFull, pos && !seen));
          }
          carry_sum[j] = __shfl_sync(kFull, v, 31);
          const bool seen_incl = __shfl_sync(kFull, pos || seen, 31);
          carry_seen = (carry_seen & ~(1u << j)) | ((unsigned)seen_incl << j);
        }
      }
      carry_doc = __shfl_sync(kFull, doc, 31);
    }
    if (live && lane < nq) {
      // static register indexing: select this lane's query slot
      float bv = 0.0f;
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

extern "C" int knn_subblock_max_mv(
    const void* vecs, const void* row_docs, const void* queries, void* bmax,
    void* bcnt, long long n, int d, int q, int sub, long long n_valid,
    int m_max, void* stream) {
  const long long n_sub = n / sub;
  const long long grid = (n_sub + kWarps - 1) / kWarps;
  if (grid > 0) {
    subblock_max_mv_kernel<<<(unsigned)grid, kWarps * 32, 0,
                             (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)vecs, (const int*)row_docs,
        (const __nv_bfloat16*)queries, (float*)bmax, (int*)bcnt, n_sub, d, q,
        sub, n_valid, m_max);
  }
  return (int)cudaGetLastError();
}
