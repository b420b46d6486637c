// K3: exact rescore of the selected sub-blocks (kNN phase 2).
//
// Replaces: orama_core_tpu/ops/pallas_knn.py::_pallas_rescore_subblocks
// (its inner `kern`, reached through _select_and_rescore), which DMAs each
// selected [sub, D] corpus slab, scores it against ALL queries on the MXU
// and keeps the owner query's row with a one-hot matmul.
//
// Design: one CUDA block per selected slot g (q-major: query g / k owns
// it), eight warps per block, one warp per row in turn. A warp reads the
// row with coalesced bf16x2 loads, dots it with the owner query only
// (bf16 products, f32 accumulation) and reduces with shuffles; lane 0
// writes sims[g, row]. There is no one-hot selection: only the owner's
// dot product is computed.
//
// Bound on this card: bytes. It reads nsel * sub rows of 2*D bytes (plus
// the query) for 2*D flops each; at the engine's shapes that is a few
// hundred KB, so in practice it is bound by the launch and one wave of
// small blocks.
//
// Left for a later PR: fuse the final top-k over the k*sub candidates
// into the same launch, and gather several slots per block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;

__global__ void rescore_kernel(
    const __nv_bfloat16* __restrict__ vecs,
    const __nv_bfloat16* __restrict__ queries, const int* __restrict__ ids,
    float* __restrict__ out, int d, int k, int sub) {
  const int g = blockIdx.x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long sb = ids[g];
  const __nv_bfloat16* qv = queries + (long long)(g / k) * d;
  for (int r = warp; r < sub; r += kWarps) {
    const __nv_bfloat16* row = vecs + (sb * sub + r) * d;
    float acc = 0.0f;
    for (int e = 2 * lane; e < d; e += 64) {
      const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(row + e);
      const __nv_bfloat162 w = *reinterpret_cast<const __nv_bfloat162*>(qv + e);
      acc = fmaf(__bfloat162float(v.x), __bfloat162float(w.x), acc);
      acc = fmaf(__bfloat162float(v.y), __bfloat162float(w.y), acc);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    }
    if (lane == 0) out[(long long)g * sub + r] = acc;
  }
}

}  // namespace

extern "C" int knn_rescore(
    const void* vecs, const void* queries, const void* ids, void* out,
    int nsel, int d, int q, int k, int sub, void* stream) {
  (void)q;
  if (nsel > 0) {
    rescore_kernel<<<nsel, kWarps * 32, 0, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)vecs, (const __nv_bfloat16*)queries,
        (const int*)ids, (float*)out, d, k, sub);
  }
  return (int)cudaGetLastError();
}
