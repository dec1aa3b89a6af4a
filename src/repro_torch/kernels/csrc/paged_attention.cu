// Paged attention over the fused, head-interleaved KV pool, for Hopper
// (sm_90a):
//
//   K3 paged_chunked_prefill_attention  replaces the Pallas TPU kernel
//      src/repro/kernels/paged_chunked_prefill_attention.py:
//      paged_chunked_prefill_attention (_kernel)
//   K4 paged_decode_attention           replaces the Pallas TPU kernel
//      src/repro/kernels/paged_decode_attention.py:
//      paged_decode_attention (_kernel)
//
// Pool layout: pool[N, bs, 2 * nk, hd], K of KV head h at channel 2h and
// its V at 2h + 1.  A request's logical key position kpos lives in
// physical block table[kpos / bs], row kpos % bs.  Table entries past the
// request's allocation name the scratch block 0; their positions lie past
// every live row's limit, so they never reach a live row's output (the
// padding rows of a final chunk may read them; those rows are discarded).
//
// What bounds them on the H100, and what the design does about it:
//   * K4 reads each visible K/V row once and does 4 * hd flops per (query
//     row, key): about g flop a byte in bf16, far under the card's ~295
//     flop/byte ridge, so it is bound by bytes over 3.35 TB/s.  It is
//     split across the keys (decode_split.cuh): grid (B, nk, n_split), the
//     4 warps of a block on their own key ranges, partials summed by a
//     second kernel when n_split > 1; the wrapper picks n_split from the
//     table's capacity M * bs and B * nk.
//   * K3 does 4 * hd flops per (chunk row, visible key) over C rows that
//     share one KV row set: at the main path's C = 256 and 1000-2000 keys
//     its bytes over 3.35 TB/s and its flops over the 989 TFLOP/s bf16
//     tensor-core rate take about the same time.  In bf16 it runs on the
//     tensor cores (prefill_mma.cuh: a block per (query head, 64 chunk
//     rows), mma.sync for QK and PV, cp.async double-buffered K/V tiles of
//     64 keys, each copying thread reading the table entry of its key row);
//     in fp32 on the CUDA-core loop (attend_rows.cuh, 16 rows a block).
// The TPU kernels walk the table one page per grid step and carry the
// flash state in VMEM scratch across steps; on Hopper blocks run in
// parallel and in no order, so a block (or, in decode, a warp) loops over
// its keys itself.  A ragged last tile of chunk rows is masked, so any C
// works.
#include "attend_rows.cuh"
#include "decode_split.cuh"
#include "prefill_mma.cuh"

namespace {

using attn::kThreads;
using bf16 = __nv_bfloat16;

// K4: grid (B, nk, n_split); block (b, h, s) computes split s of the g
// query heads of KV head h.
template <typename T, int HD, int G>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ pool,
    const int* __restrict__ tables, const int* __restrict__ ctx,
    T* __restrict__ out, float* __restrict__ part, int nq, int nk, int bs,
    int M, int n_split, int split_len, float scale) {
  const int b = blockIdx.x, h = blockIdx.y;
  const int g = nq / nk;
  const long long row0 = (long long)b * nq + (long long)h * g;
  const attn::TableRows<T, HD> rows{pool, tables + (long long)b * M, bs,
                                    2 * nk, h, M * bs};
  attn::decode_split_rows<T, HD, G>(
      attn::smem<attn::DecodeSmem<T, HD, G>>(), rows, g, ctx[b],
      blockIdx.z, n_split, split_len, scale, q + row0 * HD, out + row0 * HD,
      part ? part + row0 * n_split * (HD + 2) : nullptr);
}

// K3, fp32: grid (nq, ceil(C / 16)); block (h, i) computes chunk rows
// 16 i .. 16 i + 15 of query head h (KV head h / g).
template <int HD>
__global__ void __launch_bounds__(kThreads) paged_chunked_prefill_kernel(
    const float* __restrict__ q, const float* __restrict__ pool,
    const int* __restrict__ table, const int* __restrict__ start,
    float* __restrict__ out, int C, int nq, int nk, int bs, int M,
    float scale) {
  const int h = blockIdx.x;
  const int i0 = blockIdx.y * attn::kMaxRows;
  const int n_rows = min(attn::kMaxRows, C - i0);
  const long long off = ((long long)i0 * nq + h) * HD;
  const long long stride = (long long)nq * HD;
  const attn::TableRows<float, HD> rows{pool, table, bs, 2 * nk,
                                        h / (nq / nk), M * bs};
  attn::attend_rows<HD>(attn::smem<attn::Smem<HD>>(), rows, n_rows,
                        start[0] + i0, scale, q + off, stride, out + off,
                        stride);
}

// K3, bf16: grid (nq, ceil(C / 64)); block (h, i) computes chunk rows
// 64 i .. 64 i + 63 of query head h on the tensor cores.
template <int HD>
__global__ void __launch_bounds__(kThreads) paged_chunked_prefill_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ pool,
    const int* __restrict__ table, const int* __restrict__ start,
    bf16* __restrict__ out, int C, int nq, int nk, int bs, int M,
    float scale) {
  const int h = blockIdx.x;
  const int i0 = blockIdx.y * attn::kMmaRows;
  const int n_rows = min(attn::kMmaRows, C - i0);
  const long long off = ((long long)i0 * nq + h) * HD;
  const long long stride = (long long)nq * HD;
  const attn::TableRows<bf16, HD> rows{pool, table, bs, 2 * nk,
                                       h / (nq / nk), M * bs};
  attn::prefill_rows_mma<HD>(attn::smem<attn::MmaSmem<HD>>(), rows, n_rows,
                             start[0] + i0, scale, q + off, stride,
                             out + off, stride);
}

struct Decode {
  template <typename T, int HD, int G>
  static cudaError_t split(const void* q, const void* pool,
                           const void* tables, const void* ctx, void* out,
                           float* part, int B, int nq, int nk, int bs, int M,
                           int n_split, int split_len, float scale,
                           cudaStream_t stream) {
    return attn::launch(
        paged_decode_kernel<T, HD, G>, dim3(B, nk, n_split), kThreads,
        sizeof(attn::DecodeSmem<T, HD, G>), stream,
        static_cast<const T*>(q), static_cast<const T*>(pool),
        static_cast<const int*>(tables), static_cast<const int*>(ctx),
        static_cast<T*>(out), part, nq, nk, bs, M, n_split, split_len,
        scale);
  }

  template <typename T, int HD>
  static cudaError_t run(const void* q, const void* pool, const void* tables,
                         const void* ctx, void* out, void* ws, int B, int nq,
                         int nk, int bs, int M, int n_split, int split_len,
                         float scale, cudaStream_t stream) {
    float* part = n_split > 1 ? static_cast<float*>(ws) : nullptr;
    const cudaError_t rc =
        nq / nk <= 4
            ? split<T, HD, 4>(q, pool, tables, ctx, out, part, B, nq, nk, bs,
                              M, n_split, split_len, scale, stream)
            : split<T, HD, 16>(q, pool, tables, ctx, out, part, B, nq, nk,
                               bs, M, n_split, split_len, scale, stream);
    if (rc != cudaSuccess || part == nullptr) return rc;
    return attn::launch(attn::combine_kernel<T, HD>, dim3(B * nq), HD, 0,
                        stream, static_cast<const float*>(part),
                        static_cast<T*>(out), n_split);
  }
};

struct Prefill {
  template <typename T, int HD>
  static cudaError_t run(const void* q, const void* pool, const void* table,
                         const void* start, void* out, int C, int nq, int nk,
                         int bs, int M, float scale, cudaStream_t stream) {
    if constexpr (sizeof(T) == 4) {
      return attn::launch(
          paged_chunked_prefill_kernel<HD>,
          dim3(nq, (C + attn::kMaxRows - 1) / attn::kMaxRows), kThreads,
          sizeof(attn::Smem<HD>), stream, static_cast<const float*>(q),
          static_cast<const float*>(pool), static_cast<const int*>(table),
          static_cast<const int*>(start), static_cast<float*>(out), C, nq,
          nk, bs, M, scale);
    } else {
      return attn::launch(
          paged_chunked_prefill_mma_kernel<HD>,
          dim3(nq, (C + attn::kMmaRows - 1) / attn::kMmaRows), kThreads,
          sizeof(attn::MmaSmem<HD>), stream, static_cast<const bf16*>(q),
          static_cast<const bf16*>(pool), static_cast<const int*>(table),
          static_cast<const int*>(start), static_cast<bf16*>(out), C, nq,
          nk, bs, M, scale);
    }
  }
};

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  hd: 64, 128 or 160.  Pointers are
// device pointers of contiguous tensors, q's and the pool's 16-byte
// aligned.  paged_decode_attention: ws holds B * nq * n_split * (hd + 2)
// floats when n_split > 1 (else it may be null), and n_split * split_len
// >= M * bs.  Returns the cudaError_t of the launch (0 = launched).
extern "C" int paged_decode_attention(int dtype, int hd, const void* q,
                                      const void* pool, const void* tables,
                                      const void* ctx, void* out, void* ws,
                                      int B, int nq, int nk, int bs, int M,
                                      int n_split, int split_len,
                                      float scale, void* stream) {
  if (nk <= 0 || nq % nk || nq / nk > attn::kMaxGroup || n_split < 1 ||
      split_len < 1 || (long long)n_split * split_len < (long long)M * bs ||
      (n_split > 1 && ws == nullptr))
    return cudaErrorInvalidValue;
  return attn::dispatch<Decode, 64, 128, 160>(
      dtype, hd, q, pool, tables, ctx, out, ws, B, nq, nk, bs, M, n_split,
      split_len, scale, static_cast<cudaStream_t>(stream));
}

extern "C" int paged_chunked_prefill_attention(
    int dtype, int hd, const void* q, const void* pool, const void* table,
    const void* start, void* out, int C, int nq, int nk, int bs, int M,
    float scale, void* stream) {
  if (nk <= 0 || nq % nk) return cudaErrorInvalidValue;
  return attn::dispatch<Prefill, 64, 128, 160>(
      dtype, hd, q, pool, table, start, out, C, nq, nk, bs, M, scale,
      static_cast<cudaStream_t>(stream));
}
