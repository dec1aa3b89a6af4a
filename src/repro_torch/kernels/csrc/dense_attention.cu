// Attention over dense KV rows, for Hopper (sm_90a):
//
//   K1 chunked_prefill_attention  replaces the Pallas TPU kernel
//      src/repro/kernels/chunked_prefill_attention.py:
//      chunked_prefill_attention (_kernel)
//   K2 decode_attention           replaces the Pallas TPU kernel
//      src/repro/kernels/decode_attention.py: decode_attention (_kernel)
//
// K1: a chunk of C queries at positions start + i over one KV row
// k, v [S, nk, hd]; key j is visible to query i iff j <= start + i.
// K2: one query per sequence over its own row k, v [B, S, nk, hd],
// keys at positions <= ctx[b] visible.
//
// What bounds them on the H100, and what the design does about it:
//   * K2 reads each visible K/V row once for g query rows, about g flop a
//     byte: bound by bytes over 3.35 TB/s.  It is split across the keys
//     (decode_split.cuh): grid (B, nk, n_split), the 4 warps of a block on
//     their own key ranges, partials summed by a second kernel when
//     n_split > 1.  The wrapper picks n_split from S and B * nk.
//   * K1's C rows share one KV row set: at C = 256 over ~1000 keys its
//     bytes and its flops at the 989 TFLOP/s bf16 tensor-core rate take
//     about the same time.  In bf16 it runs on the tensor cores
//     (prefill_mma.cuh): a block per (query head h, 64 chunk rows), mma.sync
//     for QK and PV, K/V tiles of 64 keys double-buffered with cp.async.
//     In fp32 it stays on the CUDA-core loop (attend_rows.cuh): a block per
//     (query head h, 16 chunk rows).
// The TPU kernels need C and S to tile by (bq, bk); these do not (ragged
// rows and keys are masked; the Python entry points keep that contract for
// the API's sake).  Head dims 64, 128, 160 and 256.
#include "attend_rows.cuh"
#include "decode_split.cuh"
#include "prefill_mma.cuh"

namespace {

using attn::kThreads;
using bf16 = __nv_bfloat16;

// K2: grid (B, nk, n_split); block (b, h, s) computes split s of the g
// query heads of KV head h.
template <typename T, int HD, int G>
__global__ void __launch_bounds__(kThreads) decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int* __restrict__ ctx,
    T* __restrict__ out, float* __restrict__ part, int S, int nq, int nk,
    int n_split, int split_len, float scale) {
  const int b = blockIdx.x, h = blockIdx.y;
  const int g = nq / nk;
  const long long row0 = (long long)b * nq + (long long)h * g;
  const long long kv = ((long long)b * S * nk + h) * HD;
  const attn::DenseRows<T, HD> rows{k + kv, v + kv, nk, S};
  attn::decode_split_rows<T, HD, G>(
      attn::smem<attn::DecodeSmem<T, HD, G>>(), rows, g, ctx[b],
      blockIdx.z, n_split, split_len, scale, q + row0 * HD, out + row0 * HD,
      part ? part + row0 * n_split * (HD + 2) : nullptr);
}

// K1, fp32: grid (nq, ceil(C / 16)); block (h, i) computes chunk rows
// 16 i .. 16 i + 15 of query head h (KV head h / g).
template <int HD>
__global__ void __launch_bounds__(kThreads) chunked_prefill_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const int* __restrict__ start,
    float* __restrict__ out, int C, int S, int nq, int nk, float scale) {
  const int h = blockIdx.x;
  const int i0 = blockIdx.y * attn::kMaxRows;
  const int n_rows = min(attn::kMaxRows, C - i0);
  const long long off = ((long long)i0 * nq + h) * HD;
  const long long stride = (long long)nq * HD;
  const long long head = (long long)(h / (nq / nk)) * HD;
  const attn::DenseRows<float, HD> rows{k + head, v + head, nk, S};
  attn::attend_rows<HD>(attn::smem<attn::Smem<HD>>(), rows, n_rows,
                        start[0] + i0, scale, q + off, stride, out + off,
                        stride);
}

// K1, bf16: grid (nq, ceil(C / 64)); block (h, i) computes chunk rows
// 64 i .. 64 i + 63 of query head h on the tensor cores.
template <int HD>
__global__ void __launch_bounds__(kThreads) chunked_prefill_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const int* __restrict__ start,
    bf16* __restrict__ out, int C, int S, int nq, int nk, float scale) {
  const int h = blockIdx.x;
  const int i0 = blockIdx.y * attn::kMmaRows;
  const int n_rows = min(attn::kMmaRows, C - i0);
  const long long off = ((long long)i0 * nq + h) * HD;
  const long long stride = (long long)nq * HD;
  const long long head = (long long)(h / (nq / nk)) * HD;
  const attn::DenseRows<bf16, HD> rows{k + head, v + head, nk, S};
  attn::prefill_rows_mma<HD>(attn::smem<attn::MmaSmem<HD>>(), rows, n_rows,
                             start[0] + i0, scale, q + off, stride,
                             out + off, stride);
}

struct Decode {
  template <typename T, int HD, int G>
  static cudaError_t split(const void* q, const void* k, const void* v,
                           const void* ctx, void* out, float* part, int B,
                           int S, int nq, int nk, int n_split, int split_len,
                           float scale, cudaStream_t stream) {
    return attn::launch(
        decode_kernel<T, HD, G>, dim3(B, nk, n_split), kThreads,
        sizeof(attn::DecodeSmem<T, HD, G>), stream,
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const int*>(ctx),
        static_cast<T*>(out), part, S, nq, nk, n_split, split_len, scale);
  }

  template <typename T, int HD>
  static cudaError_t run(const void* q, const void* k, const void* v,
                         const void* ctx, void* out, void* ws, int B, int S,
                         int nq, int nk, int n_split, int split_len,
                         float scale, cudaStream_t stream) {
    float* part = n_split > 1 ? static_cast<float*>(ws) : nullptr;
    const cudaError_t rc =
        nq / nk <= 4
            ? split<T, HD, 4>(q, k, v, ctx, out, part, B, S, nq, nk, n_split,
                              split_len, scale, stream)
            : split<T, HD, 16>(q, k, v, ctx, out, part, B, S, nq, nk,
                               n_split, split_len, scale, stream);
    if (rc != cudaSuccess || part == nullptr) return rc;
    return attn::launch(attn::combine_kernel<T, HD>, dim3(B * nq), HD, 0,
                        stream, static_cast<const float*>(part),
                        static_cast<T*>(out), n_split);
  }
};

struct Prefill {
  template <typename T, int HD>
  static cudaError_t run(const void* q, const void* k, const void* v,
                         const void* start, void* out, int C, int S, int nq,
                         int nk, float scale, cudaStream_t stream) {
    if constexpr (sizeof(T) == 4) {
      return attn::launch(
          chunked_prefill_kernel<HD>,
          dim3(nq, (C + attn::kMaxRows - 1) / attn::kMaxRows), kThreads,
          sizeof(attn::Smem<HD>), stream, static_cast<const float*>(q),
          static_cast<const float*>(k), static_cast<const float*>(v),
          static_cast<const int*>(start), static_cast<float*>(out), C, S, nq,
          nk, scale);
    } else {
      return attn::launch(
          chunked_prefill_mma_kernel<HD>,
          dim3(nq, (C + attn::kMmaRows - 1) / attn::kMmaRows), kThreads,
          sizeof(attn::MmaSmem<HD>), stream, static_cast<const bf16*>(q),
          static_cast<const bf16*>(k), static_cast<const bf16*>(v),
          static_cast<const int*>(start), static_cast<bf16*>(out), C, S, nq,
          nk, scale);
    }
  }
};

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  hd: 64, 128, 160 or 256.  Pointers
// are device pointers of contiguous tensors, q's, k's and v's 16-byte
// aligned.  decode_attention: ws holds B * nq * n_split * (hd + 2) floats
// when n_split > 1 (else it may be null), and n_split * split_len >= S.
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int decode_attention(int dtype, int hd, const void* q,
                                const void* k, const void* v,
                                const void* ctx, void* out, void* ws, int B,
                                int S, int nq, int nk, int n_split,
                                int split_len, float scale, void* stream) {
  if (nk <= 0 || nq % nk || nq / nk > attn::kMaxGroup || n_split < 1 ||
      split_len < 1 || (long long)n_split * split_len < S ||
      (n_split > 1 && ws == nullptr))
    return cudaErrorInvalidValue;
  return attn::dispatch<Decode, 64, 128, 160, 256>(
      dtype, hd, q, k, v, ctx, out, ws, B, S, nq, nk, n_split, split_len,
      scale, static_cast<cudaStream_t>(stream));
}

extern "C" int chunked_prefill_attention(int dtype, int hd, const void* q,
                                         const void* k, const void* v,
                                         const void* start, void* out,
                                         int C, int S, int nq, int nk,
                                         float scale, void* stream) {
  if (nk <= 0 || nq % nk) return cudaErrorInvalidValue;
  return attn::dispatch<Prefill, 64, 128, 160, 256>(
      dtype, hd, q, k, v, start, out, C, S, nq, nk, scale,
      static_cast<cudaStream_t>(stream));
}
