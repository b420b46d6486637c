// The streaming core shared by K2 (knn_subblock_max.cu), K5
// (knn_subblock_max_int8.cu) and K6 (knn_subblock_max_mv.cu; knn_wide.cuh,
// B1's one-pass core, reuses its PTX wrappers and host helpers): an [N, D]
// corpus of bf16 (K2, K6) or int8 codes (K5) streams once through the
// tensor cores against up to 64 resident queries of the same type, and a
// kernel's epilogue reduces each 64-row tile of products in registers and
// shared memory, so the [N, Q] similarities never reach device memory.
//
// Shape of a block (160 threads):
//   - warps 0-3, one warpgroup, consume: per 64-row tile they run
//     wgmma.mma_async (A = the corpus tile, B = the queries, both K-major
//     from shared memory, N = the query chunk padded to 8, 16, 32 or 64):
//     m64nNk16 bf16 x bf16 -> f32, or m64nNk32 s8 x s8 -> s32, and hand
//     the accumulator fragments to the epilogue;
//   - warp 4 produces: one thread keeps a ring of boxes of 64 rows x 128
//     B (64 bf16 or 128 int8 columns; 8 KB each) in flight with TMA loads
//     (cp.async.bulk.tensor, 128-byte swizzle), each box signalling a
//     "full" mbarrier; consumers release a box on its "empty" mbarrier
//     once its products are done.
// The element type (Elem<E>) sets the box's width in columns, the tensor
// map's data type, the wgmma form, the accumulator's type and the ring's
// depth: a box row is 128 B and a wgmma step reads 32 B of it either way,
// so the swizzle, the descriptors and the query layout are the same. The
// bf16 ring holds 8 boxes (64 KB); the int8 ring 6 (48 KB), so that two
// blocks share an SM at 64 queries up to D = 896, where one block's
// epilogue runs beside the other's products (on an H100 at 1M x 768 and
// 64 queries, 0.278 ms against 0.358 with 8 boxes:
// tools/knn_int8_variants.py).
// Blocks are persistent: at most SMs x blocks-per-SM of them, each
// walking one contiguous range of rows, tile by tile, in row order, so an
// epilogue can carry state from one tile to the next (K6's per-doc sums).
// Ranges are whole units of lcm(sub, 64) rows, so every tile starts on a
// sub-block boundary and its two 32-row halves each lie in one sub-block.
//
// Queries live in shared memory for the whole range: Q <= 64 takes ONE
// corpus pass at D <= 1024 in bf16 and D <= 2048 in int8 (128 KB of
// queries plus the ring at the largest). Above 64 queries, or where
// the widest chunk does not fit, the block loops over query chunks and
// streams its range once per chunk. Columns >= D and rows >= N come back
// from TMA as zeros, so any D whose rows are 16-byte multiples works.
//
// The corpus tensor map is encoded on the host (cuTensorMapEncodeTiled,
// reached through cudaGetDriverEntryPoint, so no -lcuda), cached by
// (pointer, N, D, data type), and passed as a __grid_constant__ parameter.
//
// MaxCount and subblock_max below are K2's and K5's epilogue and kernel
// body: per-sub-block max and positive count, K5's integer sums turned
// into similarities by one f32 multiply with each row's scale.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <type_traits>
#include <utility>

namespace knn_stream {

constexpr int kTileRows = 64;                        // wgmma M
constexpr int kBoxRowBytes = 128;                    // the swizzle's span
constexpr int kBoxBytes = kTileRows * kBoxRowBytes;  // 8 KB
constexpr int kConsumers = 128;                      // one warpgroup
constexpr int kThreads = kConsumers + 32;            // + the producer warp
constexpr int kMaxChunk = 64;  // queries per pass (K5 asks for up to 128)
constexpr int kMaxSmem = 232448;                     // 227 KB a block

// The element types of a corpus and its queries.
template <class E>
struct Elem;

template <>
struct Elem<__nv_bfloat16> {
  using Accum = float;
  static constexpr int kBoxCols = 64;  // a 128-byte box row
  static constexpr int kStages = 8;    // boxes in the ring
  static constexpr CUtensorMapDataType kMap =
      CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};

template <>
struct Elem<int8_t> {
  using Accum = int32_t;
  static constexpr int kBoxCols = 128;
  static constexpr int kStages = 6;
  // TMA moves the bytes as they are (no int8 type; zeros fill as 0)
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_UINT8;
};

// boxes per corpus row of width d
template <class E>
__host__ __device__ constexpr int boxes(int d) {
  return (d + Elem<E>::kBoxCols - 1) / Elem<E>::kBoxCols;
}

// -- device: PTX wrappers ---------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

// Waits until the barrier's phase differs from `parity`. A pipeline fault
// traps after 4 s of waiting instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint64_t t0 = 0;
  for (uint32_t spins = 1;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if ((spins & 1023u) == 0) {
      uint64_t now;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
      if (t0 == 0) {
        t0 = now;
      } else if (now - t0 > 4000000000ull) {
        __trap();
      }
    }
  }
}

__device__ __forceinline__ void tma_load_box(void* dst, const CUtensorMap* map,
                                             int col, int row, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row),
      "r"(smem_u32(bar))
      : "memory");
}

// the 128 consumer threads only (named barrier 1); the non-aligned form,
// as a warp may arrive diverged (after lane-dependent stores)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("barrier.sync 1, %0;" ::"n"(kConsumers) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Shared-memory matrix descriptor of a K-major operand in the 128-byte
// swizzle: rows of 128 B, 8-row atoms 1024 B apart (SBO), atoms
// 1024-aligned. Adding 2 to it steps 32 B along K: one wgmma step, 16
// bf16 or 32 int8.
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  const uint32_t a = smem_u32(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

template <int NQ, class E = __nv_bfloat16>
struct Acc {
  typename Elem<E>::Accum d[NQ / 2];
};

// keep the compiler from moving accumulator reads across wgmma waits
__device__ __forceinline__ void fence_reg(float& x) {
  asm volatile("" : "+f"(x)::"memory");
}
__device__ __forceinline__ void fence_reg(int32_t& x) {
  asm volatile("" : "+r"(x)::"memory");
}

template <int NQ, class E>
__device__ __forceinline__ void fence_acc(Acc<NQ, E>& acc) {
#pragma unroll
  for (int i = 0; i < NQ / 2; ++i) fence_reg(acc.d[i]);
}

// D[64, NQ] += A[64, 16] * B[NQ, 16]^T: bf16 in, f32 accumulate, A and B
// K-major descriptors (no transposes); scale-d is the predicate p = 1.
// Mma<NQ, int8_t>: D[64, NQ] += A[64, 32] * B[NQ, 32]^T, s8 in, s32
// accumulate (exact), both K-major, which is the only form s8 takes.
template <int NQ, class E = __nv_bfloat16>
struct Mma;

template <>
struct Mma<8> {
  static __device__ __forceinline__ void run(float* d, uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %6, 0;\n\t"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 0, 0;\n\t}"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Mma<16> {
  static __device__ __forceinline__ void run(float* d, uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %10, 0;\n\t"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n\t}"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Mma<32> {
  static __device__ __forceinline__ void run(float* d, uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %18, 0;\n\t"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15}, %16, %17, p, 1, 1, 0, 0;\n\t}"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Mma<64> {
  static __device__ __forceinline__ void run(float* d, uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %34, 0;\n\t"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n\t}"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Mma<8, int8_t> {
  static __device__ __forceinline__ void run(int32_t* d, uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %6, 0;\n\t"
        "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 "
        "{%0, %1, %2, %3}, %4, %5, p;\n\t}"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Mma<16, int8_t> {
  static __device__ __forceinline__ void run(int32_t* d, uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %10, 0;\n\t"
        "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p;\n\t}"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Mma<32, int8_t> {
  static __device__ __forceinline__ void run(int32_t* d, uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %18, 0;\n\t"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15}, %16, %17, p;\n\t}"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
          "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
          "+r"(d[15])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Mma<64, int8_t> {
  static __device__ __forceinline__ void run(int32_t* d, uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %34, 0;\n\t"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31}, %32, %33, p;\n\t}"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
          "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
          "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
          "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Mma<128, int8_t> {
  static __device__ __forceinline__ void run(int32_t* d, uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %66, 0;\n\t"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, "
        "p;\n\t}"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
          "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
          "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
          "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
          "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
          "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
          "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
          "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "l"(a), "l"(b), "r"(1));
  }
};

// -- device: shared memory, ranges, the two roles ----------------------------

struct Smem {
  uint8_t* ring;    // the ring's boxes [64 rows x 128 B], swizzled by TMA
  uint8_t* qs;      // nk chunks of [NQ rows x 128 B], swizzled here
  uint64_t* full;   // per stage: the box has landed
  uint64_t* empty;  // per stage: the box's products are done
  uint8_t* extra;   // the epilogue's scratch
};

// bytes of dynamic shared memory for nk boxes per row, NQ queries and
// `extra` epilogue bytes (+1 KB to align the ring to the swizzle atom)
template <class E = __nv_bfloat16>
__host__ __device__ constexpr size_t smem_bytes(int nk, int nq, int extra) {
  return 1024 + (size_t)Elem<E>::kStages * kBoxBytes +
         (size_t)nk * nq * 128 + 2 * Elem<E>::kStages * sizeof(uint64_t) +
         extra;
}

template <class E = __nv_bfloat16>
__device__ __forceinline__ Smem carve(uint8_t* raw, int nk, int nq) {
  constexpr int kStages = Elem<E>::kStages;
  const uint32_t pad = (1024u - (smem_u32(raw) & 1023u)) & 1023u;
  Smem s;
  s.ring = raw + pad;
  s.qs = s.ring + kStages * kBoxBytes;
  s.full = reinterpret_cast<uint64_t*>(s.qs + (size_t)nk * nq * 128);
  s.empty = s.full + kStages;
  s.extra = reinterpret_cast<uint8_t*>(s.empty + kStages);
  return s;
}

// A block's walk: tiles at rows first, first + 64, ... while < r1, once
// per query chunk. first < r0 only where a look-back tile leads (K6).
struct Walk {
  long long first, r0, r1;
  int chunks;  // query chunks, one corpus pass each
  int nk;      // boxes per row
};

// rows of the sub-blocks [0, n_live_sub) holding a row < n_valid, cut
// into units of lcm(sub, 64) rows and split over the grid as evenly as
// the units allow
__device__ __forceinline__ void block_range(long long n_live_sub, int sub,
                                            long long* r0, long long* r1) {
  const long long rows = n_live_sub * sub;
  const long long unit = (sub % kTileRows) ? 2LL * sub : (long long)sub;
  const long long units = (rows + unit - 1) / unit;
  const long long g = gridDim.x, b = blockIdx.x;
  const long long base = units / g, rem = units % g;
  const long long u0 = b * base + (b < rem ? b : rem);
  const long long u1 = u0 + base + (b < rem ? 1 : 0);
  *r0 = u0 * unit < rows ? u0 * unit : rows;
  *r1 = u1 * unit < rows ? u1 * unit : rows;
}

template <class E = __nv_bfloat16>
__device__ __forceinline__ void init_barriers(const Smem& s) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < Elem<E>::kStages; ++i) {
      mbar_init(&s.full[i], 1);
      mbar_init(&s.empty[i], kConsumers / 32);  // one arrive per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
}

// One thread of the producer warp: every box of the walk, in order.
template <class E = __nv_bfloat16>
__device__ __forceinline__ void produce(const CUtensorMap* map, const Smem& s,
                                        const Walk& w) {
  uint32_t stage = 0, phase = 0;
  for (int c = 0; c < w.chunks; ++c) {
    for (long long row = w.first; row < w.r1; row += kTileRows) {
      for (int kb = 0; kb < w.nk; ++kb) {
        mbar_wait(&s.empty[stage], phase ^ 1);
        mbar_expect_tx(&s.full[stage], kBoxBytes);
        tma_load_box(s.ring + stage * kBoxBytes, map, kb * Elem<E>::kBoxCols,
                     (int)row, &s.full[stage]);
        if (++stage == Elem<E>::kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  }
}

// The query chunk [q0, q0 + NQ) into shared memory, rows past Q and
// columns past D as zeros, in the layout TMA gives the corpus boxes (row j
// at 128 B * j, 16-byte group g at (g ^ j % 8) * 16).
template <int NQ, class E>
__device__ __forceinline__ void load_queries(const Smem& s, const E* queries,
                                             int q, int d, int q0, int nk) {
  constexpr int kGroup = 16 / sizeof(E);  // elements in 16 bytes
  consumer_sync();  // every warp is done with the previous chunk
  for (int i = threadIdx.x; i < nk * NQ * 8; i += kConsumers) {
    const int g = i & 7;
    const int j = (i >> 3) % NQ;
    const int kb = (i >> 3) / NQ;
    const int col = kb * Elem<E>::kBoxCols + g * kGroup;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (q0 + j < q && col < d) {
      v = *reinterpret_cast<const uint4*>(queries + (long long)(q0 + j) * d +
                                          col);
    }
    *reinterpret_cast<uint4*>(s.qs + (size_t)(kb * NQ + j) * 128 +
                              ((g ^ (j & 7)) << 4)) = v;
  }
  // generic-proxy stores, read next by wgmma through the async proxy
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  consumer_sync();
}

// The products of one tile: every box of its row, in ring order.
template <int NQ, class E>
__device__ __forceinline__ void mma_tile(Acc<NQ, E>& acc, const Smem& s,
                                         int nk, uint32_t& stage,
                                         uint32_t& phase) {
  const bool leader = (threadIdx.x & 31) == 0;
#pragma unroll
  for (int i = 0; i < NQ / 2; ++i) acc.d[i] = 0;
  fence_acc(acc);
  // the wgmma instructions are .sync.aligned: each warp issues them
  // converged, so it reconverges after every lane-dependent step (the
  // epilogue's stores, the barrier spins, the leader's arrive)
  __syncwarp();
  wgmma_fence();
  uint32_t prev = 0;
  for (int kb = 0; kb < nk; ++kb) {
    mbar_wait(&s.full[stage], phase);
    __syncwarp();
    const uint64_t da = smem_desc(s.ring + stage * kBoxBytes);
    const uint64_t db = smem_desc(s.qs + (size_t)kb * NQ * 128);
#pragma unroll
    for (int k = 0; k < kBoxRowBytes / 32; ++k) {
      Mma<NQ, E>::run(acc.d, da + 2 * k, db + 2 * k);
    }
    wgmma_commit();
    if (kb > 0) {
      wgmma_wait<1>();  // the previous box's products are done
      if (leader) mbar_arrive(&s.empty[prev]);
      __syncwarp();
    }
    prev = stage;
    if (++stage == Elem<E>::kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
  wgmma_wait<0>();
  fence_acc(acc);
  if (leader) mbar_arrive(&s.empty[prev]);
}

// The consumer warpgroup: per query chunk, the queries into shared
// memory, then every tile of the walk through the epilogue `epi`, which
// provides begin_chunk(q0, nq), prefetch(row) (before the tile's products)
// and tile(acc, row) (after them).
template <int NQ, class E, class Epi>
__device__ __forceinline__ void consume(const Smem& s, const Walk& w,
                                        const E* queries, int q, int d,
                                        Epi& epi) {
  uint32_t stage = 0, phase = 0;
  for (int c = 0; c < w.chunks; ++c) {
    const int q0 = c * NQ;
    load_queries<NQ>(s, queries, q, d, q0, w.nk);
    epi.begin_chunk(q0, q - q0 < NQ ? q - q0 : NQ);
    for (long long row = w.first; row < w.r1; row += kTileRows) {
      epi.prefetch(row);
      Acc<NQ, E> acc;
      mma_tile<NQ, E>(acc, s, w.nk, stage, phase);
      epi.tile(acc, row);
    }
  }
}

// -- device: K2's and K5's per-sub-block max and positive count -----------

constexpr float kNeg = -3.0e38f;  // the score of a row >= n_valid

// a row's similarity: bf16 products sum in f32 as they are; int8 products
// sum exactly in s32, which one conversion and one multiply by the row's
// scale turn into f32 (the plain version's single rounding of each)
__device__ __forceinline__ float row_sim(float acc, float) { return acc; }
__device__ __forceinline__ float row_sim(int32_t acc, float scale) {
  return __fmul_rn(__int2float_rn(acc), scale);
}

// Epilogue per tile: rows >= n_valid become -3e38; per query column, each
// warp reduces its 16 rows' max and count of sims > 0 by shuffles across
// the lanes that share lane % 4, writes them to shared memory, and one
// thread per column folds the warps of each 32-row half into its
// sub-block's running max and count, which carry over tiles when sub >
// 64. Only the real queries' columns are written. Over int8 each thread
// loads the scales of its fragment's two rows before the tile's products.
template <int NQ, class E>
struct MaxCount {
  // shared scratch bytes per query: [2 tile parities][4 warps] max, count
  static constexpr int kExtraPerQuery = 2 * 4 * (sizeof(float) + sizeof(int));
  static constexpr bool kScaled = std::is_same<E, int8_t>::value;
  float* bmax;
  int* bcnt;
  const float* scales;  // int8: f32[N]
  long long n_valid, r1;
  int q, sub;
  float* red_max;  // [2 tile parities][4 warps][NQ]
  int* red_cnt;
  int q0, nq, parity;
  float run_max;  // thread j < NQ: column j's open sub-block
  int run_cnt;
  float s_lo, s_hi;  // int8: the scales of rows r_lo and r_lo + 8

  __device__ void begin_chunk(int q0_, int nq_) {
    q0 = q0_;
    nq = nq_;
    parity = 0;
    run_max = kNeg;
    run_cnt = 0;
  }

  __device__ void prefetch(long long row) {
    if constexpr (kScaled) {
      const long long r_lo =
          row + 16 * (threadIdx.x / 32) + (threadIdx.x % 32) / 4;
      s_lo = r_lo < n_valid ? scales[r_lo] : 0.0f;
      s_hi = r_lo + 8 < n_valid ? scales[r_lo + 8] : 0.0f;
    } else {
      s_lo = s_hi = 1.0f;
    }
  }

  __device__ void tile(Acc<NQ, E>& acc, long long row) {
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
        const float a = v_lo ? row_sim(acc.d[4 * i + e], s_lo) : kNeg;
        const float b = v_hi ? row_sim(acc.d[4 * i + 2 + e], s_hi) : kNeg;
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

// The body of K2's (E = bf16, no scales) and K5's (E = int8) kernels:
// bmax / bcnt [n_sub, q] of the corpus behind `map` against `queries`.
// Sub-blocks wholly at or past n_valid get -3e38 / 0 without a read.
template <int NQ, class E>
__device__ __forceinline__ void subblock_max(
    const CUtensorMap* map, const E* __restrict__ queries,
    const float* __restrict__ scales, float* __restrict__ bmax,
    int* __restrict__ bcnt, long long n_sub, int d, int q, int sub,
    long long n_valid) {
  extern __shared__ uint8_t raw[];
  const int nk = boxes<E>(d);
  const Smem s = carve<E>(raw, nk, NQ);
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
  init_barriers<E>(s);
  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x == kConsumers) produce<E>(map, s, w);
  } else {
    MaxCount<NQ, E> epi;
    epi.bmax = bmax;
    epi.bcnt = bcnt;
    epi.scales = scales;
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

// -- host -------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  static std::once_flag once;
  std::call_once(once, [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  });
  return fn;
}

// The tensor map of a [n, d] corpus of E (boxes of 64 rows x 128 B,
// 128-byte swizzle, zeros out of bounds), encoded once per (pointer, n,
// d, data type).
template <class E = __nv_bfloat16>
inline int corpus_map(CUtensorMap* out, const void* vecs, long long n, int d) {
  struct Key {
    const void* p;
    long long n;
    int d;
    int type;
    bool operator<(const Key& o) const {
      if (p != o.p) return p < o.p;
      if (n != o.n) return n < o.n;
      if (d != o.d) return d < o.d;
      return type < o.type;
    }
  };
  static std::mutex mu;
  static std::map<Key, CUtensorMap> cache;
  std::lock_guard<std::mutex> lock(mu);
  const Key key{vecs, n, d, (int)Elem<E>::kMap};
  auto hit = cache.find(key);
  if (hit != cache.end()) {
    *out = hit->second;
    return 0;
  }
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)n};
  const cuuint64_t strides[1] = {(cuuint64_t)d * sizeof(E)};
  const cuuint32_t box[2] = {Elem<E>::kBoxCols, kTileRows};
  const cuuint32_t elem[2] = {1, 1};
  CUtensorMap map;
  const CUresult r = fn(&map, Elem<E>::kMap, 2,
                        const_cast<void*>(vecs), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
  if (cache.size() >= 64) cache.clear();  // corpora come and go rarely
  cache.emplace(key, map);
  *out = map;
  return 0;
}

// The persistent grid for `kernel` at `smem` bytes: SMs x resident blocks
// per SM (cached per device, kernel and size), capped by the units of
// work.
inline int grid_size(const void* kernel, size_t smem, long long units,
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
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess) {
      e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    }
    if (e == cudaSuccess) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                         kThreads, smem);
    }
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    hit = cache.emplace(key, sms * per_sm).first;
  }
  *grid = units < hit->second ? (int)(units > 0 ? units : 1) : hit->second;
  return 0;
}

// The widest query chunk (8, 16, 32, ... max_chunk, at least Q rounded up
// to 8 where Q <= max_chunk) whose shared memory fits at this width; 0 if
// none does.
template <class E = __nv_bfloat16>
inline int pick_chunk(int q, int nk, int extra_per_query, int extra_fixed,
                      int max_chunk = kMaxChunk) {
  int nq = 8;
  while (nq < q && nq < max_chunk) nq *= 2;
  for (; nq >= 8; nq /= 2) {
    if (smem_bytes<E>(nk, nq, nq * extra_per_query + extra_fixed) <=
        (size_t)kMaxSmem) {
      return nq;
    }
  }
  return 0;
}

// The dynamic shared memory and the persistent grid of a kernel whose body
// is subblock_max<NQ, E> (at least one block, at most one per unit of
// lcm(sub, 64) live rows).
template <int NQ, class E>
inline int subblock_max_launch_shape(const void* kernel, int d, int sub,
                                     long long n_valid, size_t* smem,
                                     int* grid) {
  const long long n_live = (n_valid + sub - 1) / sub;
  const long long unit = (sub % kTileRows) ? 2LL * sub : (long long)sub;
  *smem = smem_bytes<E>(boxes<E>(d), NQ,
                        NQ * MaxCount<NQ, E>::kExtraPerQuery);
  return grid_size(kernel, *smem, (n_live * sub + unit - 1) / unit, grid);
}

}  // namespace knn_stream
