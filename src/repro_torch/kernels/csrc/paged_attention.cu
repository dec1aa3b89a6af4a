// Paged attention over the fused, head-interleaved KV pool, for Hopper
// (sm_90a).  Two kernels share one device routine:
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
// What bounds them on the H100.  K4 reads each visible K/V row once and
// does 4 * hd flops per (query row, key): g query rows per KV head give
// about g flop per byte in bf16, far under the card's ~295 flop/byte
// ridge, so K4 is bound by bytes over 3.35 TB/s.  K3 does 4 * hd flops
// per (chunk row, visible key) over C rows that share one KV row set: at
// the main path's C = 256 and 1000-2000 keys its bytes over 3.35 TB/s and
// its flops over the 989 TFLOP/s bf16 tensor-core rate take about the
// same time (the bytes slightly longer).  This first version runs the
// products on the CUDA cores in fp32 FMA, not on the tensor cores, so
// its flops, not its bytes, set its time; wgmma/TMA and split-KV are
// later work.
//
// Design.  The TPU kernels walk the table one page per grid step and
// carry the flash state in VMEM scratch across steps; on Hopper blocks run
// in parallel and in no order, so one block owns a set of query rows that
// share one KV head and one block table, and loops over the keys itself
// (attend_rows.cuh, with TableRows addressing):
//   * K4: one block per (sequence b, KV head h), its g query heads as
//     rows, all with the limit ctx[b];
//   * K3: one block per (query head h, tile of 16 chunk rows), row i
//     with the limit start + i; a ragged last tile masks its missing rows,
//     so any C works.
#include "attend_rows.cuh"

namespace {

using attn::kMaxRows;
using attn::kThreads;

// K4: grid (B, nk); block (b, h) computes the g query heads of KV head h.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ pool,
    const int* __restrict__ tables, const int* __restrict__ ctx,
    T* __restrict__ out, int nq, int nk, int bs, int M, float scale) {
  const int b = blockIdx.x, h = blockIdx.y;
  const int g = nq / nk;
  const long long off = ((long long)b * nq + (long long)h * g) * HD;
  const attn::TableRows<T, HD> rows{pool, tables + (long long)b * M, bs,
                                    2 * nk, h, M * bs};
  attn::attend_rows<T, HD>(attn::smem<T, HD>(), rows, g, ctx[b], 0, scale,
                           q + off, HD, out + off, HD);
}

// K3: grid (nq, ceil(C / 16)); block (h, i) computes chunk rows
// 16 i .. 16 i + 15 of query head h (KV head h / g).
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) paged_chunked_prefill_kernel(
    const T* __restrict__ q, const T* __restrict__ pool,
    const int* __restrict__ table, const int* __restrict__ start,
    T* __restrict__ out, int C, int nq, int nk, int bs, int M,
    float scale) {
  const int h = blockIdx.x;
  const int i0 = blockIdx.y * kMaxRows;
  const int g = nq / nk;
  const int n_rows = min(kMaxRows, C - i0);
  const long long off = ((long long)i0 * nq + h) * HD;
  const long long stride = (long long)nq * HD;
  const attn::TableRows<T, HD> rows{pool, table, bs, 2 * nk, h / g, M * bs};
  attn::attend_rows<T, HD>(attn::smem<T, HD>(), rows, n_rows, start[0] + i0,
                           1, scale, q + off, stride, out + off, stride);
}

struct Decode {
  template <typename T, int HD>
  static cudaError_t run(const void* q, const void* pool, const void* tables,
                         const void* ctx, void* out, int B, int nq, int nk,
                         int bs, int M, float scale, cudaStream_t stream) {
    return attn::launch<T, HD>(
        paged_decode_kernel<T, HD>, dim3(B, nk), stream,
        static_cast<const T*>(q), static_cast<const T*>(pool),
        static_cast<const int*>(tables), static_cast<const int*>(ctx),
        static_cast<T*>(out), nq, nk, bs, M, scale);
  }
};

struct Prefill {
  template <typename T, int HD>
  static cudaError_t run(const void* q, const void* pool, const void* table,
                         const void* start, void* out, int C, int nq, int nk,
                         int bs, int M, float scale, cudaStream_t stream) {
    return attn::launch<T, HD>(
        paged_chunked_prefill_kernel<T, HD>,
        dim3(nq, (C + kMaxRows - 1) / kMaxRows), stream,
        static_cast<const T*>(q), static_cast<const T*>(pool),
        static_cast<const int*>(table), static_cast<const int*>(start),
        static_cast<T*>(out), C, nq, nk, bs, M, scale);
  }
};

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  hd: 64 or 128.  Pointers are device
// pointers of contiguous tensors; the pool's must be 16-byte aligned.
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int paged_decode_attention(int dtype, int hd, const void* q,
                                      const void* pool, const void* tables,
                                      const void* ctx, void* out, int B,
                                      int nq, int nk, int bs, int M,
                                      float scale, void* stream) {
  if (nk <= 0 || nq % nk || nq / nk > kMaxRows) return cudaErrorInvalidValue;
  return attn::dispatch<Decode, 64, 128>(
      dtype, hd, q, pool, tables, ctx, out, B, nq, nk, bs, M, scale,
      static_cast<cudaStream_t>(stream));
}

extern "C" int paged_chunked_prefill_attention(
    int dtype, int hd, const void* q, const void* pool, const void* table,
    const void* start, void* out, int C, int nq, int nk, int bs, int M,
    float scale, void* stream) {
  if (nk <= 0 || nq % nk) return cudaErrorInvalidValue;
  return attn::dispatch<Prefill, 64, 128>(
      dtype, hd, q, pool, table, start, out, C, nq, nk, bs, M, scale,
      static_cast<cudaStream_t>(stream));
}
