// B1's one-pass streaming core (knn_phase1_variants.cu): the [N, D] bf16
// corpus streams ONCE through the tensor cores for up to 256 queries, and
// a kernel's epilogue reduces each 128-row tile of similarities in
// registers and shared memory.
//
// Why not knn_stream.cuh: that core keeps its queries resident in shared
// memory, at most 64 of them, and streams the corpus once per 64-query
// chunk. 256 x 768 bf16 queries are 384 KB, more than a block's 227 KB,
// so here the queries stream beside the corpus instead.
//
// Shape of a block (384 threads, one a SM):
//   - warps 0-7, two consumer warpgroups: per 128-row tile, warpgroup w
//     multiplies rows 64w .. 64w + 63 against the N queries of the pass
//     (wgmma.mma_async m64nNk16, bf16 x bf16 -> f32, N = 64, 128, 192 or
//     256: 128 f32 accumulators a thread at 256) and hands the fragments
//     to the epilogue;
//   - warps 8-11, the producer warpgroup: one thread keeps a ring of
//     stages in flight, each one corpus box [128 rows x 64 columns]
//     (16 KB) and one query box [N x 64 columns] (N x 128 B), both loaded
//     by TMA in the 128-byte swizzle, 4 stages at N = 256 (192 KB).
// A whole warpgroup produces so that setmaxnreg can move its registers to
// the consumers (40 a thread against 232; the launch gives each 168):
// with 168, the 128 accumulators and the epilogue run measurably slower.
//
// The query boxes come from L2, once per tile: 3.1 GB of L2 reads for
// the 1.54 GB corpus of B1 at Q = 256. Blocks run in clusters of
// kCluster = 2, and each block loads its share of every query box with
// .multicast::cluster into every block's ring, which halves those reads.
// A stage is then free again only once the consumers of every block of
// the cluster are done with it: each block's "empty" barrier counts the
// 8 consumer warps of each, which arrive through mapa +
// mbarrier.arrive.shared::cluster.
//
// Blocks are persistent: at most the clusters that fit the card, each
// cluster walking a contiguous range of tiles and each of its blocks one
// share of it, tile by tile in row order. The blocks of a cluster walk
// the same number of tiles (the multicast needs all of them); where the
// cluster's range does not split evenly, a block walks up to one tile
// past its range, whose loads feed its partners and whose products no
// epilogue keeps. Q > 256 loops over 256-query passes. Columns >= D,
// rows >= N and queries >= Q come back from TMA as zeros.
//
// tools/knn_wide_variants.py times edited variants of this core (no
// epilogue, no products, other cluster sizes, no setmaxnreg) to show what
// holds it back; PERF.md section 6 has its readings.
//
// Tensor maps are encoded on the host (knn_stream::encode_tiled); the
// corpus's are cached by pointer, shape and box, the queries' encoded per
// launch.

#pragma once

#include "knn_stream.cuh"

namespace knn_wide {

using knn_stream::mbar_expect_tx;
using knn_stream::mbar_init;
using knn_stream::mbar_wait;
using knn_stream::smem_desc;
using knn_stream::smem_u32;
using knn_stream::wgmma_commit;
using knn_stream::wgmma_fence;
using knn_stream::wgmma_wait;

constexpr int kTileRows = 128;                             // 2 x wgmma M
constexpr int kBoxCols = 64;                               // 128 B of bf16
constexpr int kHalfRows = kTileRows / 2;                   // a warpgroup's
constexpr int kCorpusBytes = kTileRows * kBoxCols * 2;     // 16 KB
constexpr int kConsumers = 256;                            // two warpgroups
constexpr int kThreads = kConsumers + 128;                 // + the producer
constexpr int kMaxN = 256;                                 // queries a pass
constexpr int kCluster = 2;                                // blocks
constexpr int kRingBytes = 196608;                         // 192 KB
constexpr int kMaxSmem = knn_stream::kMaxSmem;             // 227 KB

// A ring stage at N queries a pass: the corpus box, then the query box.
template <int N>
struct Stage {
  static constexpr int kQueryBytes = N * kBoxCols * 2;
  static constexpr int kBytes = kCorpusBytes + kQueryBytes;
  static constexpr int kCount =
      kRingBytes / kBytes < 8 ? kRingBytes / kBytes : 8;
};

// bytes of dynamic shared memory at N with `extra` epilogue bytes (+1 KB
// to align the ring to the swizzle atom)
template <int N>
__host__ __device__ constexpr size_t smem_bytes(int extra) {
  return 1024 + (size_t)Stage<N>::kCount * Stage<N>::kBytes +
         2 * Stage<N>::kCount * sizeof(uint64_t) + extra;
}

// -- device: PTX wrappers beyond knn_stream.cuh's --------------------------

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_u32(bar))
      : "memory");
}

// the box into the same shared-memory offset of every block of the
// cluster, each block's barrier at `bar`'s offset counting its bytes
__device__ __forceinline__ void tma_load_2d_multicast(void* dst,
                                                      const CUtensorMap* map,
                                                      int c0, int c1,
                                                      uint64_t* bar) {
  const uint16_t mask = (1u << kCluster) - 1;
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes.multicast::cluster [%0], [%1, {%2, %3}], [%4], %5;" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_u32(bar)), "h"(mask)
      : "memory");
}

// one arrive on the barrier at `bar`'s offset in block `rank` of the
// cluster (this block's own included)
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar,
                                                    uint32_t rank) {
  asm volatile(
      "{\n\t.reg .b32 remote;\n\t"
      "mapa.shared::cluster.u32 remote, %0, %1;\n\t"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n\t}" ::"r"(
          smem_u32(bar)),
      "r"(rank)
      : "memory");
}

// every thread of the cluster; orders the barriers' init before any
// multicast or remote arrive, and keeps a block alive while its partner
// may still reach its shared memory
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive;\n\t"
      "barrier.cluster.wait;" ::: "memory");
}

// the 256 consumer threads only (named barrier 1)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("barrier.sync 1, %0;" ::"n"(kConsumers) : "memory");
}

// Shared-memory matrix descriptor of an MN-major operand in the 128-byte
// swizzle, as TMA leaves qt boxes [64 d x 64 queries]: rows of 128 B along
// K, 8-row atoms 1024 B apart along K (SBO), 64-query atoms 8 KB apart
// along N (LBO). Adding 128 to it steps 16 rows (2 KB) along K.
__device__ __forceinline__ uint64_t smem_desc_mn(const void* p) {
  const uint32_t a = smem_u32(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(8192 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// D[64, N] += A[64, 16] * B[16, N]: bf16 in, f32 accumulate; A K-major,
// B K-major (queries [Q, D]) or, with kTransB, MN-major (qt [D, Q]);
// scale-d is the predicate p = 1
template <int N, bool kTransB>
struct WideMma;

template <bool kTransB>
struct WideMma<64, kTransB> {
  static __device__ __forceinline__ void run(float* d, uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %34, 0;\n\t"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, %35;\n\t}"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(1), "n"(kTransB ? 1 : 0));
  }
};

template <bool kTransB>
struct WideMma<128, kTransB> {
  static __device__ __forceinline__ void run(float* d, uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %66, 0;\n\t"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, %67;\n\t}"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(1), "n"(kTransB ? 1 : 0));
  }
};

template <bool kTransB>
struct WideMma<192, kTransB> {
  static __device__ __forceinline__ void run(float* d, uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %98, 0;\n\t"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
        "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
        "%93, %94, %95}, %96, %97, p, 1, 1, 0, %99;\n\t}"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
          "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
          "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
          "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
          "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
          "+f"(d[95])
        : "l"(a), "l"(b), "r"(1), "n"(kTransB ? 1 : 0));
  }
};

template <bool kTransB>
struct WideMma<256, kTransB> {
  static __device__ __forceinline__ void run(float* d, uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %130, 0;\n\t"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
        "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
        "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
        "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
        "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
        "%127}, %128, %129, p, 1, 1, 0, %131;\n\t}"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
          "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
          "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
          "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
          "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
          "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
          "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
          "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
          "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(a), "l"(b), "r"(1), "n"(kTransB ? 1 : 0));
  }
};

// -- device: shared memory, walks, the two roles -----------------------------

template <int N>
struct Ring {
  uint8_t* base;    // stage i at base + i * Stage<N>::kBytes, swizzled by TMA
  uint64_t* full;   // per stage: both boxes have landed
  uint64_t* empty;  // per stage: every block's products of it are done
  uint8_t* extra;   // the epilogue's scratch

  __device__ __forceinline__ uint8_t* corpus(uint32_t i) const {
    return base + (size_t)i * Stage<N>::kBytes;
  }
  __device__ __forceinline__ uint8_t* queries(uint32_t i) const {
    return corpus(i) + kCorpusBytes;
  }
};

template <int N>
__device__ __forceinline__ Ring<N> carve(uint8_t* raw) {
  const uint32_t pad = (1024u - (smem_u32(raw) & 1023u)) & 1023u;
  Ring<N> s;
  s.base = raw + pad;
  s.full = reinterpret_cast<uint64_t*>(s.base + (size_t)Stage<N>::kCount *
                                                    Stage<N>::kBytes);
  s.empty = s.full + Stage<N>::kCount;
  s.extra = reinterpret_cast<uint8_t*>(s.empty + Stage<N>::kCount);
  return s;
}

// A block's walk: `steps` tiles at rows first, first + 128, ... once per
// query pass; only rows < r1 are the block's own.
struct Walk {
  long long first, r1;
  int steps;   // tiles a pass, the same for every block of the cluster
  int passes;  // N-query passes (one for Q <= N)
  int nk;      // 64-column boxes a row
  int rank;    // the block's rank in its cluster
};

// `rows` rows cut into 128-row tiles, split over the grid's clusters as
// evenly as the tiles allow, each cluster's share then cut into kCluster
// runs of `steps` tiles (a block whose run is short walks on past it).
__device__ __forceinline__ Walk cluster_walk(long long rows) {
  uint32_t rank, cid, ncl;
  asm("mov.u32 %0, %%cluster_ctarank;" : "=r"(rank));
  asm("mov.u32 %0, %%clusterid.x;" : "=r"(cid));
  asm("mov.u32 %0, %%nclusterid.x;" : "=r"(ncl));
  const long long units = (rows + kTileRows - 1) / kTileRows;
  const long long g = ncl, c = cid;
  const long long base = units / g, rem = units % g;
  const long long u0 = c * base + (c < rem ? c : rem);
  const long long cu = base + (c < rem ? 1 : 0);
  Walk w;
  w.rank = (int)rank;
  w.steps = (int)((cu + kCluster - 1) / kCluster);
  long long own = cu - (long long)w.rank * w.steps;
  own = own < 0 ? 0 : (own > w.steps ? w.steps : own);
  w.first = (u0 + (long long)w.rank * w.steps) * kTileRows;
  const long long end = w.first + own * kTileRows;
  w.r1 = end < rows ? end : rows;
  return w;
}

template <int N>
__device__ __forceinline__ void init_barriers(const Ring<N>& s) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < Stage<N>::kCount; ++i) {
      mbar_init(&s.full[i], 1);
      // one arrive per consumer warp of each block
      mbar_init(&s.empty[i], kCluster * kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster_sync();
}

// The corpus of the max forms: a 128-row box of the [n, d] map.
struct TileCorpus {
  const CUtensorMap* map;
  __device__ __forceinline__ void load(uint8_t* dst, uint64_t* bar, int kb,
                                       long long row) const {
    tma_load_2d(dst, map, kb * kBoxCols, (int)row, bar);
  }
};

// The corpus of k_mm: the kept rows alone, through a 3-D map (d, keep,
// n / bn) whose 64-row boxes hold 64 consecutive kept rows (keep a
// multiple of 64, or a divisor of 64); `row` counts kept rows.
struct KeptCorpus {
  const CUtensorMap* map;
  int keep;
  __device__ __forceinline__ void load(uint8_t* dst, uint64_t* bar, int kb,
                                       long long row) const {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long k = row + (long long)h * kHalfRows;
      tma_load_3d(dst + h * (kCorpusBytes / 2), map, kb * kBoxCols,
                  (int)(k % keep), (int)(k / keep), bar);
    }
  }
};

// Queries [Q, D]: this block's share of the [N x 64] box, kQueryRows
// rows from q0 + rank * kQueryRows, into every block of the cluster;
// K-major, as the corpus.
template <int N>
struct KMajorQueries {
  static constexpr bool kTransB = false;
  static constexpr int kQueryRows = N / kCluster;  // the map's box rows
  const CUtensorMap* map;
  __device__ __forceinline__ void load(uint8_t* dst, uint64_t* bar, int kb,
                                       int q0, int rank) const {
    tma_load_2d_multicast(dst + rank * kQueryRows * 128, map, kb * kBoxCols,
                          q0 + rank * kQueryRows, bar);
  }
};

// Queries as qt [D, Q]: N / 64 boxes [64 d x 64 queries], MN-major; this
// block loads kDRows d rows of each from kDRows * rank, into every block
// of the cluster.
template <int N>
struct MNMajorQueries {
  static constexpr bool kTransB = true;
  static constexpr int kDRows = kBoxCols / kCluster;  // the map's box rows
  const CUtensorMap* map;
  __device__ __forceinline__ void load(uint8_t* dst, uint64_t* bar, int kb,
                                       int q0, int rank) const {
#pragma unroll
    for (int j = 0; j < N / 64; ++j) {
      tma_load_2d_multicast(dst + j * 8192 + rank * kDRows * 128, map,
                            q0 + 64 * j, kb * kBoxCols + kDRows * rank, bar);
    }
  }
};

// One thread of the producer warpgroup: every stage of the walk, in order.
template <int N, class Corpus, class Queries>
__device__ __forceinline__ void produce(const Corpus& corpus,
                                        const Queries& queries,
                                        const Ring<N>& s, const Walk& w) {
  uint32_t stage = 0, phase = 0;
  for (int p = 0; p < w.passes; ++p) {
    for (int t = 0; t < w.steps; ++t) {
      const long long row = w.first + (long long)t * kTileRows;
      for (int kb = 0; kb < w.nk; ++kb) {
        mbar_wait(&s.empty[stage], phase ^ 1);
        mbar_expect_tx(&s.full[stage], Stage<N>::kBytes);
        corpus.load(s.corpus(stage), &s.full[stage], kb, row);
        queries.load(s.queries(stage), &s.full[stage], kb, p * N, w.rank);
        if (++stage == Stage<N>::kCount) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  }
}

template <int N>
struct Acc {
  float d[N / 2];
};

// keeps the compiler from moving accumulator reads across wgmma waits
template <int N>
__device__ __forceinline__ void fence_acc(Acc<N>& acc) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) asm volatile("" : "+f"(acc.d[i])::"memory");
}

// A stage's products are done: one arrive per warp on the stage's empty
// barrier in every block of the cluster.
__device__ __forceinline__ void release(uint64_t* bar) {
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (uint32_t r = 0; r < kCluster; ++r) mbar_arrive_cluster(bar, r);
  }
}

// The products of one tile for this thread's warpgroup (rows 64 * wg on):
// every box of its row, in ring order.
template <int N, bool kTransB>
__device__ __forceinline__ void mma_tile(Acc<N>& acc, const Ring<N>& s,
                                         int nk, int wg, uint32_t& stage,
                                         uint32_t& phase) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc.d[i] = 0.0f;
  fence_acc(acc);
  // wgmma is .sync.aligned: each warp issues it converged
  __syncwarp();
  wgmma_fence();
  uint32_t prev = 0;
  for (int kb = 0; kb < nk; ++kb) {
    mbar_wait(&s.full[stage], phase);
    __syncwarp();
    const uint64_t da = smem_desc(s.corpus(stage) + wg * (kCorpusBytes / 2));
    const uint64_t db = kTransB ? smem_desc_mn(s.queries(stage))
                                : smem_desc(s.queries(stage));
#pragma unroll
    for (int k = 0; k < kBoxCols / 16; ++k) {
      WideMma<N, kTransB>::run(acc.d, da + 2 * k,
                               db + (kTransB ? 128 : 2) * k);
    }
    wgmma_commit();
    if (kb > 0) {
      wgmma_wait<1>();  // the previous box's products are done
      release(&s.empty[prev]);
      __syncwarp();
    }
    prev = stage;
    if (++stage == Stage<N>::kCount) {
      stage = 0;
      phase ^= 1;
    }
  }
  wgmma_wait<0>();
  fence_acc(acc);
  release(&s.empty[prev]);
}

// The two consumer warpgroups: per query pass, every tile of the walk
// through the epilogue `epi`, which provides begin_pass(q0, nq) and
// tile(acc, row) (after the tile's products; rows >= walk.r1 are not the
// block's and must be dropped).
template <int N, bool kTransB, class Epi>
__device__ __forceinline__ void consume(const Ring<N>& s, const Walk& w,
                                        int q, Epi& epi) {
  const int wg = threadIdx.x / 128;
  uint32_t stage = 0, phase = 0;
  for (int p = 0; p < w.passes; ++p) {
    const int q0 = p * N;
    epi.begin_pass(q0, q - q0 < N ? q - q0 : N);
    for (int t = 0; t < w.steps; ++t) {
      Acc<N> acc;
      mma_tile<N, kTransB>(acc, s, w.nk, wg, stage, phase);
      epi.tile(acc, w.first + (long long)t * kTileRows);
    }
  }
}

// A kernel's body after its walk: the barriers, then the producer
// warpgroup and the consumers, then the cluster's last barrier.
template <int N, class Corpus, class Queries, class Epi>
__device__ __forceinline__ void run(const Ring<N>& s, const Walk& w,
                                    const Corpus& corpus,
                                    const Queries& queries, int q, Epi& epi) {
  init_barriers(s);
  if (threadIdx.x >= kConsumers) {
    // the producer warpgroup gives its registers to the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == kConsumers) produce<N>(corpus, queries, s, w);
    __syncwarp();
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    consume<N, Queries::kTransB>(s, w, q, epi);
  }
  cluster_sync();
}

// -- host -------------------------------------------------------------------

// A tensor map in the 128-byte swizzle (zeros out of bounds): `rank` dims,
// innermost first, strides in bytes of dims 1.. .
inline int encode(CUtensorMap* out, const void* p, int rank,
                  const cuuint64_t* dims, const cuuint64_t* strides,
                  const cuuint32_t* box) {
  knn_stream::EncodeTiled fn = knn_stream::encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(out, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
                        const_cast<void*>(p), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// encode() once per (pointer, dims, strides, box): for corpora, which
// come and go rarely
inline int encode_cached(CUtensorMap* out, const void* p, int rank,
                         const cuuint64_t* dims, const cuuint64_t* strides,
                         const cuuint32_t* box) {
  struct Key {
    const void* p;
    cuuint64_t v[8];
    bool operator<(const Key& o) const {
      if (p != o.p) return p < o.p;
      for (int i = 0; i < 8; ++i) {
        if (v[i] != o.v[i]) return v[i] < o.v[i];
      }
      return false;
    }
  };
  Key key{p, {(cuuint64_t)rank, 0, 0, 0, 0, 0, 0, 0}};
  for (int i = 0; i < rank; ++i) {
    key.v[1 + i] = dims[i] | ((cuuint64_t)box[i] << 48);
    if (i > 0) key.v[3 + i] = strides[i - 1];
  }
  static std::mutex mu;
  static std::map<Key, CUtensorMap> cache;
  std::lock_guard<std::mutex> lock(mu);
  auto hit = cache.find(key);
  if (hit != cache.end()) {
    *out = hit->second;
    return 0;
  }
  CUtensorMap map;
  const int err = encode(&map, p, rank, dims, strides, box);
  if (err != 0) return err;
  if (cache.size() >= 64) cache.clear();
  cache.emplace(key, map);
  *out = map;
  return 0;
}

// The persistent grid of clusters for `kernel` at `smem` bytes: the
// clusters that fit the card at once (cached per device, kernel and
// size), capped by the tiles, in blocks.
inline int cluster_grid(const void* kernel, size_t smem, long long tiles,
                        int* grid) {
  static std::mutex mu;
  static std::map<std::pair<int, std::pair<const void*, size_t>>, int> cache;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_pair(dev, std::make_pair(kernel, smem));
  auto hit = cache.find(key);
  if (hit == cache.end()) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kCluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(kCluster);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int clusters = 0;
    if (e == cudaSuccess) {
      e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    }
    if (e != cudaSuccess) return (int)e;
    if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
    hit = cache.emplace(key, clusters).first;
  }
  const long long want = (tiles + kCluster - 1) / kCluster;
  const long long clusters = want < hit->second ? (want > 0 ? want : 1)
                                                : hit->second;
  *grid = (int)clusters * kCluster;
  return 0;
}

// Launches `kernel` on `grid` blocks in clusters of kCluster.
template <typename... Exp, typename... Act>
int launch(void (*kernel)(Exp...), int grid, size_t smem,
           cudaStream_t stream, Act&&... args) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, kernel, std::forward<Act>(args)...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The pass width for q queries: 64, 128, 192 or 256.
inline int pick_width(int q) {
  return q <= 64 ? 64 : q <= 128 ? 128 : q <= 192 ? 192 : kMaxN;
}

}  // namespace knn_wide
