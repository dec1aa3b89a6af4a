// Attention over dense KV rows, for Hopper (sm_90a).  Two kernels share
// the device routine of the paged kernels (attend_rows.cuh, with
// DenseRows addressing: key kpos at row + kpos * nk * hd):
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
// What bounds them on the H100: as K3 and K4 (paged_attention.cu).  K2
// reads each visible K/V row once for g query rows, about g flop per byte
// in bf16, far under the ~295 flop/byte ridge: bound by bytes over
// 3.35 TB/s.  K1's C rows share one KV row set: at C = 256 over ~1000
// keys its bytes and its flops at the 989 TFLOP/s tensor-core rate take
// about the same time.  Like K3/K4, this first version runs the products
// on the CUDA cores in fp32 FMA, so its flops set its time.
//
// Design.  The TPU kernels put the KV blocks on a sequential grid axis
// and carry the flash state in VMEM scratch; here one block owns its rows
// and loops over the keys itself:
//   * K2: one block per (sequence b, KV head h), its g query heads as
//     rows, all with the limit ctx[b] (g <= 16);
//   * K1: one block per (query head h, tile of 16 chunk rows), row i with
//     the limit start + i; a ragged last tile masks its missing rows.
// The TPU kernels need C and S to tile by (bq, bk); these do not (the
// Python entry points keep that contract for the API's sake).  Head dims
// 64, 128 and 256; at 256 the block's shared memory (49,792 bytes bf16,
// 82,560 fp32) is over the 49,152-byte static limit, which attn::launch
// raises.
#include "attend_rows.cuh"

namespace {

using attn::kMaxRows;
using attn::kThreads;

// K2: grid (B, nk); block (b, h) computes the g query heads of KV head h.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int* __restrict__ ctx,
    T* __restrict__ out, int S, int nq, int nk, float scale) {
  const int b = blockIdx.x, h = blockIdx.y;
  const int g = nq / nk;
  const long long off = ((long long)b * nq + (long long)h * g) * HD;
  const long long row = ((long long)b * S * nk + h) * HD;
  const attn::DenseRows<T, HD> rows{k + row, v + row, nk, S};
  attn::attend_rows<T, HD>(attn::smem<T, HD>(), rows, g, ctx[b], 0, scale,
                           q + off, HD, out + off, HD);
}

// K1: grid (nq, ceil(C / 16)); block (h, i) computes chunk rows
// 16 i .. 16 i + 15 of query head h (KV head h / g).
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) chunked_prefill_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int* __restrict__ start,
    T* __restrict__ out, int C, int S, int nq, int nk, float scale) {
  const int h = blockIdx.x;
  const int i0 = blockIdx.y * kMaxRows;
  const int g = nq / nk;
  const int n_rows = min(kMaxRows, C - i0);
  const long long off = ((long long)i0 * nq + h) * HD;
  const long long stride = (long long)nq * HD;
  const long long head = (long long)(h / g) * HD;
  const attn::DenseRows<T, HD> rows{k + head, v + head, nk, S};
  attn::attend_rows<T, HD>(attn::smem<T, HD>(), rows, n_rows, start[0] + i0,
                           1, scale, q + off, stride, out + off, stride);
}

struct Decode {
  template <typename T, int HD>
  static cudaError_t run(const void* q, const void* k, const void* v,
                         const void* ctx, void* out, int B, int S, int nq,
                         int nk, float scale, cudaStream_t stream) {
    return attn::launch<T, HD>(
        decode_kernel<T, HD>, dim3(B, nk), stream,
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const int*>(ctx),
        static_cast<T*>(out), S, nq, nk, scale);
  }
};

struct Prefill {
  template <typename T, int HD>
  static cudaError_t run(const void* q, const void* k, const void* v,
                         const void* start, void* out, int C, int S, int nq,
                         int nk, float scale, cudaStream_t stream) {
    return attn::launch<T, HD>(
        chunked_prefill_kernel<T, HD>,
        dim3(nq, (C + kMaxRows - 1) / kMaxRows), stream,
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const int*>(start),
        static_cast<T*>(out), C, S, nq, nk, scale);
  }
};

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  hd: 64, 128 or 256.  Pointers are
// device pointers of contiguous tensors; k's and v's must be 16-byte
// aligned.  Returns the cudaError_t of the launch (0 = launched).
extern "C" int decode_attention(int dtype, int hd, const void* q,
                                const void* k, const void* v,
                                const void* ctx, void* out, int B, int S,
                                int nq, int nk, float scale, void* stream) {
  if (nk <= 0 || nq % nk || nq / nk > kMaxRows) return cudaErrorInvalidValue;
  return attn::dispatch<Decode, 64, 128, 256>(
      dtype, hd, q, k, v, ctx, out, B, S, nq, nk, scale,
      static_cast<cudaStream_t>(stream));
}

extern "C" int chunked_prefill_attention(int dtype, int hd, const void* q,
                                         const void* k, const void* v,
                                         const void* start, void* out,
                                         int C, int S, int nq, int nk,
                                         float scale, void* stream) {
  if (nk <= 0 || nq % nk) return cudaErrorInvalidValue;
  return attn::dispatch<Prefill, 64, 128, 256>(
      dtype, hd, q, k, v, start, out, C, S, nq, nk, scale,
      static_cast<cudaStream_t>(stream));
}
