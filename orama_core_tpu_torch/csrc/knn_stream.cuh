// The streaming core shared by K2 (knn_subblock_max.cu) and K6
// (knn_subblock_max_mv.cu; knn_wide.cuh, B1's one-pass core, reuses its
// PTX wrappers and host helpers): the [N, D] bf16 corpus streams once through
// the tensor cores against up to 64 resident queries, and a kernel's
// epilogue reduces each 64-row tile of similarities in registers and
// shared memory, so the [N, Q] similarities never reach device memory.
//
// Shape of a block (160 threads):
//   - warps 0-3, one warpgroup, consume: per 64-row tile they run
//     wgmma.mma_async m64nNk16 (bf16 x bf16 -> f32; A = the corpus tile,
//     B = the queries, both K-major from shared memory, N = the query
//     chunk padded to 8, 16, 32 or 64) and hand the f32 accumulator
//     fragments to the epilogue;
//   - warp 4 produces: one thread keeps a ring of kStages 64 x 64 boxes
//     (8 KB each, 64 KB in all) in flight with TMA loads
//     (cp.async.bulk.tensor, 128-byte swizzle), each box signalling a
//     "full" mbarrier; consumers release a box on its "empty" mbarrier
//     once its products are done.
// Blocks are persistent: at most SMs x blocks-per-SM of them, each
// walking one contiguous range of rows, tile by tile, in row order, so an
// epilogue can carry state from one tile to the next (K6's per-doc sums).
// Ranges are whole units of lcm(sub, 64) rows, so every tile starts on a
// sub-block boundary and its two 32-row halves each lie in one sub-block.
//
// Queries live in shared memory for the whole range: Q <= 64 at D <= 1024
// takes ONE corpus pass (128 KB of queries plus the 64 KB ring at the
// largest). Above 64 queries, or where the widest chunk does not fit, the
// block loops over query chunks and streams its range once per chunk.
// Columns >= D and rows >= N come back from TMA as zeros, so any
// D % 8 == 0 works.
//
// The corpus tensor map is encoded on the host (cuTensorMapEncodeTiled,
// reached through cudaGetDriverEntryPoint, so no -lcuda), cached by
// (pointer, N, D), and passed as a __grid_constant__ parameter.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <utility>

namespace knn_stream {

constexpr int kTileRows = 64;                        // wgmma M
constexpr int kBoxCols = 64;                         // 128 B of bf16
constexpr int kBoxBytes = kTileRows * kBoxCols * 2;  // 8 KB
constexpr int kStages = 8;                           // 64 KB in flight
constexpr int kConsumers = 128;                      // one warpgroup
constexpr int kThreads = kConsumers + 32;            // + the producer warp
constexpr int kMaxChunk = 64;                        // queries per pass
constexpr int kMaxSmem = 232448;                     // 227 KB a block

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
// 1024-aligned. Adding 2 to it steps 16 bf16 (32 B) along K.
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  const uint32_t a = smem_u32(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

template <int NQ>
struct Acc {
  float d[NQ / 2];
};

// keeps the compiler from moving accumulator reads across wgmma waits
template <int NQ>
__device__ __forceinline__ void fence_acc(Acc<NQ>& acc) {
#pragma unroll
  for (int i = 0; i < NQ / 2; ++i) asm volatile("" : "+f"(acc.d[i])::"memory");
}

// D[64, NQ] += A[64, 16] * B[NQ, 16]^T: bf16 in, f32 accumulate, A and B
// K-major descriptors (no transposes); scale-d is the predicate p = 1
template <int NQ>
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

// -- device: shared memory, ranges, the two roles ----------------------------

struct Smem {
  uint8_t* ring;    // kStages boxes [64 rows x 128 B], swizzled by TMA
  uint8_t* qs;      // nk chunks of [NQ rows x 128 B], swizzled here
  uint64_t* full;   // per stage: the box has landed
  uint64_t* empty;  // per stage: the box's products are done
  uint8_t* extra;   // the epilogue's scratch
};

// bytes of dynamic shared memory for nk boxes per row, NQ queries and
// `extra` epilogue bytes (+1 KB to align the ring to the swizzle atom)
__host__ __device__ constexpr size_t smem_bytes(int nk, int nq, int extra) {
  return 1024 + (size_t)kStages * kBoxBytes + (size_t)nk * nq * 128 +
         2 * kStages * sizeof(uint64_t) + extra;
}

__device__ __forceinline__ Smem carve(uint8_t* raw, int nk, int nq) {
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
  int nk;      // 64-column boxes per row
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

__device__ __forceinline__ void init_barriers(const Smem& s) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&s.full[i], 1);
      mbar_init(&s.empty[i], kConsumers / 32);  // one arrive per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
}

// One thread of the producer warp: every box of the walk, in order.
__device__ __forceinline__ void produce(const CUtensorMap* map, const Smem& s,
                                        const Walk& w) {
  uint32_t stage = 0, phase = 0;
  for (int c = 0; c < w.chunks; ++c) {
    for (long long row = w.first; row < w.r1; row += kTileRows) {
      for (int kb = 0; kb < w.nk; ++kb) {
        mbar_wait(&s.empty[stage], phase ^ 1);
        mbar_expect_tx(&s.full[stage], kBoxBytes);
        tma_load_box(s.ring + stage * kBoxBytes, map, kb * kBoxCols, (int)row,
                     &s.full[stage]);
        if (++stage == kStages) {
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
template <int NQ>
__device__ __forceinline__ void load_queries(const Smem& s,
                                             const __nv_bfloat16* queries,
                                             int q, int d, int q0, int nk) {
  consumer_sync();  // every warp is done with the previous chunk
  for (int i = threadIdx.x; i < nk * NQ * 8; i += kConsumers) {
    const int g = i & 7;
    const int j = (i >> 3) % NQ;
    const int kb = (i >> 3) / NQ;
    const int col = kb * kBoxCols + g * 8;
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
template <int NQ>
__device__ __forceinline__ void mma_tile(Acc<NQ>& acc, const Smem& s, int nk,
                                         uint32_t& stage, uint32_t& phase) {
  const bool leader = (threadIdx.x & 31) == 0;
#pragma unroll
  for (int i = 0; i < NQ / 2; ++i) acc.d[i] = 0.0f;
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
    for (int k = 0; k < kBoxCols / 16; ++k) {
      Mma<NQ>::run(acc.d, da + 2 * k, db + 2 * k);
    }
    wgmma_commit();
    if (kb > 0) {
      wgmma_wait<1>();  // the previous box's products are done
      if (leader) mbar_arrive(&s.empty[prev]);
      __syncwarp();
    }
    prev = stage;
    if (++stage == kStages) {
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
template <int NQ, class Epi>
__device__ __forceinline__ void consume(const Smem& s, const Walk& w,
                                        const __nv_bfloat16* queries, int q,
                                        int d, Epi& epi) {
  uint32_t stage = 0, phase = 0;
  for (int c = 0; c < w.chunks; ++c) {
    const int q0 = c * NQ;
    load_queries<NQ>(s, queries, q, d, q0, w.nk);
    epi.begin_chunk(q0, q - q0 < NQ ? q - q0 : NQ);
    for (long long row = w.first; row < w.r1; row += kTileRows) {
      epi.prefetch(row);
      Acc<NQ> acc;
      mma_tile<NQ>(acc, s, w.nk, stage, phase);
      epi.tile(acc, row);
    }
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

// The tensor map of a [n, d] bf16 corpus (64 x 64 boxes, 128-byte
// swizzle, zeros out of bounds), encoded once per (pointer, n, d).
inline int corpus_map(CUtensorMap* out, const void* vecs, long long n, int d) {
  struct Key {
    const void* p;
    long long n;
    int d;
    bool operator<(const Key& o) const {
      if (p != o.p) return p < o.p;
      if (n != o.n) return n < o.n;
      return d < o.d;
    }
  };
  static std::mutex mu;
  static std::map<Key, CUtensorMap> cache;
  std::lock_guard<std::mutex> lock(mu);
  const Key key{vecs, n, d};
  auto hit = cache.find(key);
  if (hit != cache.end()) {
    *out = hit->second;
    return 0;
  }
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)n};
  const cuuint64_t strides[1] = {(cuuint64_t)d * 2};
  const cuuint32_t box[2] = {kBoxCols, kTileRows};
  const cuuint32_t elem[2] = {1, 1};
  CUtensorMap map;
  const CUresult r = fn(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
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

// The widest query chunk (8, 16, 32 or 64, at least Q rounded up to 8
// where Q <= 64) whose shared memory fits at this width; 0 if none does.
inline int pick_chunk(int q, int nk, int extra_per_query, int extra_fixed) {
  int nq = 8;
  while (nq < q && nq < kMaxChunk) nq *= 2;
  for (; nq >= 8; nq /= 2) {
    if (smem_bytes(nk, nq, nq * extra_per_query + extra_fixed) <=
        (size_t)kMaxSmem) {
      return nq;
    }
  }
  return 0;
}

}  // namespace knn_stream
