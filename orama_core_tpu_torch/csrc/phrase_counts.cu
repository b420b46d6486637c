// K4: per-doc phrase counts over the doc-sorted position stream.
//
// Replaces: orama_core_tpu/ops/bm25.py::_phrase_window_kernel (driven by
// phrase_boost_docmajor_windowed). Mosaic has no scatter, so the TPU
// kernel bins each 2048-position block of packed anyc + 4096*seqc flags
// into a commit-static doc window with two compare-sum stages; a split
// and a page segment_sum outside the kernel then give per-doc counts.
//
// Design: the Hopper kernel needs only the per-doc integer counts. One
// thread per stream position evaluates the query's group flags itself
// (the _phrase_group_flags_bits logic fused in: the matched test of the
// position and of its neighbours at -2, -1 and +1, against the spans held
// in shared memory, and the commit-static group bits of the position and
// its predecessor) and adds anyc / seqc to int32 per-doc counters with
// atomicAdd. Integer atomics commute, so the result is deterministic and
// bit-identical to the reference; the windows (W, wsub, w_base) are not
// needed. The final anyorder + 2*seq + boost is an elementwise step in
// the wrapper.
//
// Bound on this card: bytes. Each position reads a 4-byte term id, a
// 1-byte bit field and (when it counts) a 4-byte doc id; the neighbour
// reads hit the same cache lines. Atomics are issued only for matched
// group heads, a small share of the stream.
//
// Left for a later PR: on queries whose terms match a large share of the
// stream the atomics contend; a warp-level run-length reduction over the
// doc-sorted stream (one atomic per doc run) would remove that.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSpans = 32;

__device__ __forceinline__ bool matched_at(
    long long i, long long pp, const uint8_t* __restrict__ bits,
    const int* __restrict__ terms, const int2* spans, int n_spans) {
  if (i < 0 || i >= pp) return false;
  if ((bits[i] & 8) == 0) return false;  // padding
  const int t = terms[i];
  bool m = false;
  for (int j = 0; j < n_spans; ++j) {
    m |= (t >= spans[j].x) & (t < spans[j].y);
  }
  return m;
}

__global__ void phrase_counts_kernel(
    const uint8_t* __restrict__ bits, const int* __restrict__ terms,
    const int* __restrict__ docs, const int* __restrict__ spans_g,
    int* __restrict__ any_out, int* __restrict__ seq_out, long long pp,
    int n_spans, int n_docs) {
  __shared__ int2 spans[kMaxSpans];
  if (threadIdx.x < n_spans) {
    spans[threadIdx.x] =
        make_int2(spans_g[2 * threadIdx.x], spans_g[2 * threadIdx.x + 1]);
  }
  __syncthreads();
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= pp) return;
  const uint8_t b = bits[i];
  const bool first = b & 1;
  if (!first) return;  // only group heads count
  const bool m = matched_at(i, pp, bits, terms, spans, n_spans);
  const bool next_same = b & 4;
  const bool grp_any =
      m || (next_same && matched_at(i + 1, pp, bits, terms, spans, n_spans));
  if (!grp_any) return;
  const int doc = docs[i];
  if (doc < 0 || doc >= n_docs) return;
  atomicAdd(&any_out[doc], 1);
  const bool adj_key = b & 2;
  if (!adj_key) return;
  const bool first_prev = i == 0 ? true : (bits[i - 1] & 1);
  const bool prev_grp =
      matched_at(i - 1, pp, bits, terms, spans, n_spans) ||
      (!first_prev && matched_at(i - 2, pp, bits, terms, spans, n_spans));
  if (prev_grp) atomicAdd(&seq_out[doc], 1);
}

}  // namespace

extern "C" int phrase_counts(
    const void* bits, const void* terms, const void* docs, const void* spans,
    void* any_out, void* seq_out, long long pp, int n_spans, int n_docs,
    void* stream) {
  if (n_spans > kMaxSpans) return (int)cudaErrorInvalidValue;
  const long long grid = (pp + kThreads - 1) / kThreads;
  if (grid > 0) {
    phrase_counts_kernel<<<(unsigned)grid, kThreads, 0,
                           (cudaStream_t)stream>>>(
        (const uint8_t*)bits, (const int*)terms, (const int*)docs,
        (const int*)spans, (int*)any_out, (int*)seq_out, pp, n_spans,
        n_docs);
  }
  return (int)cudaGetLastError();
}
