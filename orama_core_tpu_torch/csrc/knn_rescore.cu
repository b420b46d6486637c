// K3: exact rescore of the selected sub-blocks (kNN phase 2).
//
// Replaces: orama_core_tpu/ops/pallas_knn.py::_pallas_rescore_subblocks
// (its inner `kern`, reached through _select_and_rescore), which DMAs each
// selected [sub, D] corpus slab, scores it against ALL queries on the MXU
// and keeps the owner query's row with a one-hot matmul.
//
// Contract: out[g, r] = dot(vecs[ids[g] * sub + r], queries[g / k]) for
// every selected slot g (q-major: slot g belongs to query g / k) and row
// r < sub, bf16 products summed in f32. Only the owner's product is
// computed; there is no one-hot selection.
//
// Bound on this card: bytes. Each slot reads one contiguous sub x D bf16
// slab (24 KB at D = 384, 64 KB at D = 1024, sub = 32) for 2 flops a byte,
// far below the ridge. At one query's 16 slots that is a few hundred KB,
// so the time is the launch and one memory latency; a batch of 64 or 256
// queries selects 1,024 or 4,096 slabs (25 or 101 MB), which must stream
// at the memory's rate.
//
// Design: persistent blocks (at most SMs x resident blocks), each walking
// one contiguous range of work items in order. An item is one slab, or a
// piece of R rows of it where a whole slab would not fit the ring (D above
// ~2,000 at sub = 32). Warp 0 produces: it reads the slot ids 32 at a
// time, one per lane; for each item it waits for a free stage of a 2-4
// deep ring in shared memory and fills it with ONE 1-D bulk async copy of
// the item's rows (cp.async.bulk, completing on the stage's "full"
// mbarrier), plus one of the owner query's row when the stage last held
// another owner's (consecutive slots mostly share their owner). Warps 1-8
// consume: each takes up to four rows of the stage at once, reads rows and
// query with 16-byte shared-memory loads (each query chunk once for its
// rows), multiplies bf16 pairs in f32 in independent chains, reduces with
// shuffles into a per-stage row buffer and releases the stage on its
// "empty" mbarrier; after a consumer barrier, the item's R results leave
// in one coalesced store. (Pieces of 8 or 16 rows for one query's 128
// slots, to spread them over more SMs, measured no faster: PERF.md.) The
// kernel is a programmatic dependent launch: its blocks set up their
// barriers while the kernels before it drain, and griddepcontrol.wait
// holds every read of their outputs (and every write) until they are
// complete.
//
// Widths: the bulk path needs D % 8 == 0 (16-byte rows) and 16-byte
// aligned corpus and queries. Any other even D (or alignment) takes the
// same kernel with the producer warp's 32 lanes issuing 4-byte cp.async
// copies into rows padded to a multiple of 8 columns (the pads zeroed
// once), each lane arriving on the stage's barrier when its copies land
// (cp.async.mbarrier.arrive.noinc); the consumers are the same.
//
// Left for a later PR: fuse the n_valid mask and the final top-k over the
// k * sub candidates into the consumers (that changes K3's function).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <utility>

#include "knn_stream.cuh"

namespace {

using knn_stream::mbar_arrive;
using knn_stream::mbar_expect_tx;
using knn_stream::mbar_init;
using knn_stream::mbar_wait;
using knn_stream::smem_u32;

constexpr int kConsumerWarps = 8;
constexpr int kThreads = (kConsumerWarps + 1) * 32;
constexpr int kMaxStages = 4;
constexpr int kRowsPerWarp = 4;  // a consumer warp's rows per pass
constexpr int kMaxSmem = knn_stream::kMaxSmem;  // 227 KB a block
constexpr int kHeader = 128;                     // the 2 x 4 mbarriers
constexpr unsigned kFull = 0xffffffffu;

struct Plan {
  int pitch;        // shared-memory row pitch in bf16 (a multiple of 8)
  int rows;         // rows per work item (R, divides sub)
  int stages;       // ring depth
  int stage_bytes;  // (1 + R) rows of pitch bf16, 128-byte multiple
  int red_bytes;    // stages x R f32 results, 128-byte multiple
  size_t smem;
};

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void copy4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_u32(dst)),
               "l"(reinterpret_cast<uint64_t>(src))
               : "memory");
}

// arrives on `bar` once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void copy4_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// the consumer warps only (named barrier 1)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("barrier.sync 1, %0;" ::"n"(kConsumerWarps * 32) : "memory");
}

__device__ __forceinline__ float dot8(const uint4& a, const uint4& b,
                                      float acc) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(x[i]);
    const float2 v = __bfloat1622float2(y[i]);
    acc = fmaf(u.x, v.x, acc);
    acc = fmaf(u.y, v.y, acc);
  }
  return acc;
}

template <bool kBulk>
__global__ void __launch_bounds__(kThreads) rescore_kernel(
    const __nv_bfloat16* __restrict__ vecs,
    const __nv_bfloat16* __restrict__ queries, const int* __restrict__ ids,
    float* __restrict__ out, long long items, int d, int k, int sub,
    Plan plan) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  float* red = reinterpret_cast<float*>(smem + kHeader);
  unsigned char* ring = smem + kHeader + plan.red_bytes;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int R = plan.rows;
  const int per_slot = sub / R;

  // this block's contiguous range of items
  const long long g = gridDim.x, b = blockIdx.x;
  const long long base = items / g, rem = items % g;
  const long long i0 = b * base + (b < rem ? b : rem);
  const long long i1 = i0 + base + (b < rem ? 1 : 0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < plan.stages; ++s) {
      mbar_init(&full[s], kBulk ? 1 : 32);
      mbar_init(&empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (!kBulk) {
    // rows narrower than their pitch: zero the ring once, so the pad
    // columns (never copied) multiply as zeros
    uint4* z = reinterpret_cast<uint4*>(ring);
    const int n16 = plan.stages * plan.stage_bytes / 16;
    for (int i = threadIdx.x; i < n16; i += kThreads) z[i] = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();
  // the kernels before this one (the slot selection) are complete and
  // their writes visible: the set-up above overlapped their tail
  asm volatile("griddepcontrol.wait;" ::: "memory");

  // the producer's slot ids come 32 at a time, one per lane
  const long long n_slots = items / per_slot;
  long long id_base = i0 / per_slot;
  int my_id = 0;
  if (warp == 0 && id_base + lane < n_slots) my_id = ids[id_base + lane];

  if (warp == 0) {
    // producer
    int owner_of[kMaxStages];
#pragma unroll
    for (int s = 0; s < kMaxStages; ++s) owner_of[s] = -1;
    int stage = 0;
    uint32_t phase = 0;
    const long long row_bytes = 2LL * d;
    for (long long it = i0; it < i1; ++it) {
      const long long slot = it / per_slot;
      const int piece = (int)(it % per_slot);
      const int owner = (int)(slot / k);
      if (slot >= id_base + 32) {  // warp-uniform: every lane walks alike
        id_base = slot;
        my_id = slot + lane < n_slots ? ids[slot + lane] : 0;
      }
      const int id = __shfl_sync(kFull, my_id, (int)(slot - id_base));
      const long long row0 = (long long)id * sub + (long long)piece * R;
      unsigned char* st = ring + (size_t)stage * plan.stage_bytes;
      mbar_wait(&empty[stage], phase ^ 1);
      const bool new_owner = owner_of[stage] != owner;
      owner_of[stage] = owner;
      if (kBulk) {
        if (lane == 0) {
          const uint32_t rows_b = (uint32_t)(R * row_bytes);
          mbar_expect_tx(&full[stage],
                         rows_b + (new_owner ? (uint32_t)row_bytes : 0u));
          if (new_owner) {
            bulk_copy(st, queries + (long long)owner * d, (uint32_t)row_bytes,
                      &full[stage]);
          }
          bulk_copy(st + (size_t)plan.pitch * 2, vecs + row0 * d, rows_b,
                    &full[stage]);
        }
      } else {
        const int words = d / 2;  // 4-byte words per row
        const int first = new_owner ? 0 : 1;
        const long long n = (long long)(R + 1 - first) * words;
        for (long long j = lane; j < n; j += 32) {
          const int r = first + (int)(j / words);  // 0 = the query row
          const int w = (int)(j % words);
          const __nv_bfloat16* src =
              r == 0 ? queries + (long long)owner * d + 2 * w
                     : vecs + (row0 + r - 1) * d + 2 * w;
          copy4(st + ((size_t)r * plan.pitch + 2 * w) * 2, src);
        }
        copy4_arrive(&full[stage]);
      }
      if (++stage == plan.stages) {
        stage = 0;
        phase ^= 1;
      }
    }
    return;
  }

  // consumers: warps 1..kConsumerWarps
  const int cw = warp - 1;
  const int chunks = plan.pitch / 8;  // 16-byte chunks per row
  int stage = 0;
  uint32_t phase = 0;
  for (long long it = i0; it < i1; ++it) {
    const unsigned char* st = ring + (size_t)stage * plan.stage_bytes;
    float* res = red + stage * R;
    mbar_wait(&full[stage], phase);
    const uint4* q = reinterpret_cast<const uint4*>(st);
    // a warp's rows (cw, cw + 8, cw + 16, cw + 24, ...) in one pass: each
    // query chunk is read once for all of them, and their sums are
    // independent chains
    for (int r0 = cw; r0 < R; r0 += kConsumerWarps * kRowsPerWarp) {
      float acc[kRowsPerWarp];
      const uint4* row[kRowsPerWarp];
#pragma unroll
      for (int j = 0; j < kRowsPerWarp; ++j) {
        acc[j] = 0.0f;
        const int r = min(r0 + j * kConsumerWarps, R - 1);
        row[j] = reinterpret_cast<const uint4*>(st + (size_t)(r + 1) *
                                                plan.pitch * 2);
      }
      for (int c = lane; c < chunks; c += 32) {
        const uint4 qc = q[c];
#pragma unroll
        for (int j = 0; j < kRowsPerWarp; ++j) {
          if (r0 + j * kConsumerWarps < R) acc[j] = dot8(row[j][c], qc, acc[j]);
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
        for (int j = 0; j < kRowsPerWarp; ++j) {
          acc[j] += __shfl_xor_sync(kFull, acc[j], off);
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int j = 0; j < kRowsPerWarp; ++j) {
          if (r0 + j * kConsumerWarps < R) res[r0 + j * kConsumerWarps] = acc[j];
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[stage]);
    consumer_sync();  // every row of the item is in res
    const int t = threadIdx.x - 32;
    if (t < R) {
      const long long slot = it / per_slot;
      const int piece = (int)(it % per_slot);
      out[slot * sub + (long long)piece * R + t] = res[t];
    }
    if (++stage == plan.stages) {
      stage = 0;
      phase ^= 1;
    }
  }
}

int round_up(int x, int m) { return (x + m - 1) / m * m; }

// The ring for this width: R = the largest of sub, sub / 2, ... at which
// 2+ stages fit; false if none fits.
bool make_plan(int d, int sub, bool bulk, Plan* p) {
  p->pitch = bulk ? d : round_up(d, 8);
  for (int rows = sub; rows >= 1; rows = rows % 2 ? 0 : rows / 2) {
    const int stage_bytes = round_up((rows + 1) * p->pitch * 2, 128);
    for (int stages = kMaxStages; stages >= 2; --stages) {
      const int red_bytes = round_up(stages * rows * 4, 128);
      const size_t smem =
          (size_t)kHeader + red_bytes + (size_t)stages * stage_bytes;
      if (smem <= (size_t)kMaxSmem) {
        p->rows = rows;
        p->stages = stages;
        p->stage_bytes = stage_bytes;
        p->red_bytes = red_bytes;
        p->smem = smem;
        return true;
      }
    }
    if (rows == 1) break;
  }
  return false;
}

// SMs x resident blocks per SM for one instantiation at `smem` bytes
int resident_blocks(const void* kernel, size_t smem, int* out) {
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
      e = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSmem);
    }
    if (e == cudaSuccess) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                         kThreads, smem);
    }
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    hit = cache.emplace(key, sms * per_sm).first;
  }
  *out = hit->second;
  return 0;
}

}  // namespace

// vecs bf16[N, d], queries bf16[q, d], ids int32[nsel] (sub-block ids),
// out f32[nsel, sub]; d even. Returns a CUDA error code (0 = launched).
extern "C" int knn_rescore(
    const void* vecs, const void* queries, const void* ids, void* out,
    int nsel, int d, int q, int k, int sub, void* stream) {
  (void)q;
  if (nsel <= 0) return (int)cudaGetLastError();
  if (d <= 0 || d % 2 || sub <= 0 || k <= 0) return (int)cudaErrorInvalidValue;
  const bool bulk = d % 8 == 0 && reinterpret_cast<uintptr_t>(vecs) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(queries) % 16 == 0;
  Plan plan;
  if (!make_plan(d, sub, bulk, &plan)) return (int)cudaErrorInvalidValue;
  const long long items = (long long)nsel * (sub / plan.rows);
  const void* kernel = bulk ? (const void*)rescore_kernel<true>
                            : (const void*)rescore_kernel<false>;
  int cap = 0;
  const int err = resident_blocks(kernel, plan.smem, &cap);
  if (err) return err;
  // a programmatic dependent launch: the blocks start, and set up their
  // barriers, while the kernel before this one drains
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(items < cap ? (unsigned)items : (unsigned)cap);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = plan.smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, bulk ? rescore_kernel<true> : rescore_kernel<false>,
      (const __nv_bfloat16*)vecs, (const __nv_bfloat16*)queries,
      (const int*)ids, (float*)out, items, d, k, sub, plan);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}
