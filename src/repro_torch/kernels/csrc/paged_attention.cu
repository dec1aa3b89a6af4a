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
// in parallel and in no order, so one block owns a set of query rows
// that share one KV head and one block table, and loops over the keys
// itself, carrying the online-softmax state (running max m, sum l,
// accumulator acc) in registers:
//   * K4: one block per (sequence b, KV head h), its g query heads as
//     rows, all with the limit ctx[b];
//   * K3: one block per (query head h, tile of 16 chunk rows), row i
//     with the limit start + i; a ragged last tile masks its missing rows,
//     so any C works.
// Keys go in tiles of 32.  All 128 threads stage a tile's K and V rows
// in shared memory, each thread reading its block id from the table
// itself (Hopper has no scalar prefetch), with 16-byte loads.  K rows get
// one word of padding, so that lane j scoring key j over the head
// dimension hits bank (j + w) % 32: conflict-free.  Each warp owns up to
// four rows; per row, lane j computes the score of key j, the warp
// reduces max and sum with shuffles, and p (cast to the pool's type, as
// the TPU kernels cast p to v.dtype) goes through shared memory to the
// PV product, where lane l owns head-dimension elements l, l + 32, ...
// (bf16: pairs).  The key loop stops at the last position any row of the
// block can see; a tile fully masked for one row adds exactly nothing
// (m stays, p = 0, alpha = 1), so stopping early does not change the
// result.  A row that sees no key outputs 0.  Accumulation is fp32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTileKeys = 32;                  // one key per lane
constexpr int kRowsPerWarp = 4;
constexpr int kMaxRows = kWarps * kRowsPerWarp;  // rows per block
constexpr float kNeg = -1e30f;                 // running-max start

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int HD>
struct Smem {
  static constexpr int kRowWords = HD * (int)sizeof(T) / 4 + 1;  // padded
  static constexpr int kVecs = HD * (int)sizeof(T) / 16;   // 16 B per row
  uint32_t k[kTileKeys * kRowWords];
  uint4 v[kTileKeys * kVecs];
  float q[kMaxRows * HD];
  float p[kWarps][kTileKeys];
};

// One block: n_rows query rows sharing KV head kvh and one block table.
// Row r sees key positions kpos <= limit0 + r * limit_step.
template <typename T, int HD>
__device__ __forceinline__ void attend_rows(
    Smem<T, HD>& sm, const T* __restrict__ pool,
    const int* __restrict__ table, int n_entries, int bs, int nch, int kvh,
    int n_rows, int limit0, int limit_step, float scale,
    const T* __restrict__ q, long long q_stride, T* __restrict__ out,
    long long out_stride) {
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int kEl = HD / 32;                 // accumulator elements/lane
  constexpr int kRowWords = Smem<T, HD>::kRowWords;
  constexpr int kVecs = Smem<T, HD>::kVecs;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int i = tid; i < n_rows * HD; i += kThreads) {
    const int r = i / HD, d = i - r * HD;
    sm.q[i] = to_f(q[r * q_stride + d]);
  }
  int kend = limit0 + (n_rows - 1) * limit_step;   // last visible key
  const int kmax = n_entries * bs - 1;             // end of the table
  if (kend > kmax) kend = kmax;
  const int n_keys = kend + 1;

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kEl];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m[rr] = kNeg;
    l[rr] = 0.f;
#pragma unroll
    for (int e = 0; e < kEl; ++e) acc[rr][e] = 0.f;
  }
  __syncthreads();

  for (int t0 = 0; t0 < n_keys; t0 += kTileKeys) {
    const int tile_n = min(kTileKeys, n_keys - t0);
    for (int i = tid; i < tile_n * kVecs; i += kThreads) {
      const int j = i / kVecs, c = i - j * kVecs;
      const int kpos = t0 + j;
      const long long blk = table[kpos / bs];
      const T* row = pool + ((blk * bs + kpos % bs) * nch + 2 * kvh) * HD;
      const uint4 kv = reinterpret_cast<const uint4*>(row)[c];
      uint32_t* kd = sm.k + j * kRowWords + c * 4;
      kd[0] = kv.x;
      kd[1] = kv.y;
      kd[2] = kv.z;
      kd[3] = kv.w;
      sm.v[j * kVecs + c] = reinterpret_cast<const uint4*>(row + HD)[c];
    }
    __syncthreads();

#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp + rr * kWarps;
      if (r >= n_rows) continue;                   // warp-uniform
      const int limit = limit0 + r * limit_step;
      const bool valid = lane < tile_n && t0 + lane <= limit;
      float s = kNeg;
      if (valid) {
        const float* qr = sm.q + r * HD;
        const uint32_t* kr = sm.k + lane * kRowWords;
        float dot = 0.f;
        if constexpr (kBf16) {
#pragma unroll 8
          for (int w = 0; w < HD / 2; ++w) {
            const float2 kf = __bfloat1622float2(
                reinterpret_cast<const __nv_bfloat162*>(kr)[w]);
            dot = fmaf(qr[2 * w], kf.x, dot);
            dot = fmaf(qr[2 * w + 1], kf.y, dot);
          }
        } else {
#pragma unroll 8
          for (int w = 0; w < HD; ++w)
            dot = fmaf(qr[w], __uint_as_float(kr[w]), dot);
        }
        s = dot * scale;
      }
      const float m_new = fmaxf(m[rr], warp_max(s));
      const float p = valid ? expf(s - m_new) : 0.f;
      const float alpha = expf(m[rr] - m_new);
      l[rr] = l[rr] * alpha + warp_sum(p);
      m[rr] = m_new;
      sm.p[warp][lane] = to_f(from_f<T>(p));       // p cast to the KV type
      __syncwarp();
#pragma unroll
      for (int e = 0; e < kEl; ++e) acc[rr][e] *= alpha;
      for (int j = 0; j < tile_n; ++j) {
        const float pj = sm.p[warp][j];
        if constexpr (kBf16) {
          const __nv_bfloat162* vr =
              reinterpret_cast<const __nv_bfloat162*>(sm.v + j * kVecs);
#pragma unroll
          for (int e = 0; e < kEl / 2; ++e) {
            const float2 vf = __bfloat1622float2(vr[lane + 32 * e]);
            acc[rr][2 * e] = fmaf(pj, vf.x, acc[rr][2 * e]);
            acc[rr][2 * e + 1] = fmaf(pj, vf.y, acc[rr][2 * e + 1]);
          }
        } else {
          const float* vr = reinterpret_cast<const float*>(sm.v + j * kVecs);
#pragma unroll
          for (int e = 0; e < kEl; ++e)
            acc[rr][e] = fmaf(pj, vr[lane + 32 * e], acc[rr][e]);
        }
      }
      __syncwarp();
    }
    __syncthreads();                 // the next tile overwrites K/V
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int r = warp + rr * kWarps;
    if (r >= n_rows) continue;
    // acc / l, and 0 for a row that saw no key (l == 0)
    const bool seen = l[rr] > 0.f;
    const float den = fmaxf(l[rr], 1e-30f);
    T* o = out + r * out_stride;
    if constexpr (kBf16) {
      __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(o);
#pragma unroll
      for (int e = 0; e < kEl / 2; ++e)
        o2[lane + 32 * e] = __floats2bfloat162_rn(
            seen ? acc[rr][2 * e] / den : 0.f,
            seen ? acc[rr][2 * e + 1] / den : 0.f);
    } else {
#pragma unroll
      for (int e = 0; e < kEl; ++e)
        o[lane + 32 * e] = seen ? acc[rr][e] / den : 0.f;
    }
  }
}

// K4: grid (B, nk); block (b, h) computes the g query heads of KV head h.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ pool,
    const int* __restrict__ tables, const int* __restrict__ ctx,
    T* __restrict__ out, int nq, int nk, int bs, int M, float scale) {
  __shared__ Smem<T, HD> sm;
  const int b = blockIdx.x, h = blockIdx.y;
  const int g = nq / nk;
  const long long off = ((long long)b * nq + (long long)h * g) * HD;
  attend_rows<T, HD>(sm, pool, tables + (long long)b * M, M, bs, 2 * nk, h,
                     g, ctx[b], 0, scale, q + off, HD, out + off, HD);
}

// K3: grid (nq, ceil(C / 16)); block (h, i) computes chunk rows
// 16 i .. 16 i + 15 of query head h (KV head h / g).
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) paged_chunked_prefill_kernel(
    const T* __restrict__ q, const T* __restrict__ pool,
    const int* __restrict__ table, const int* __restrict__ start,
    T* __restrict__ out, int C, int nq, int nk, int bs, int M,
    float scale) {
  __shared__ Smem<T, HD> sm;
  const int h = blockIdx.x;
  const int i0 = blockIdx.y * kMaxRows;
  const int g = nq / nk;
  const int n_rows = min(kMaxRows, C - i0);
  const long long off = ((long long)i0 * nq + h) * HD;
  const long long stride = (long long)nq * HD;
  attend_rows<T, HD>(sm, pool, table, M, bs, 2 * nk, h / g, n_rows,
                     start[0] + i0, 1, scale, q + off, stride, out + off,
                     stride);
}

template <typename T, int HD>
cudaError_t launch_decode(const void* q, const void* pool, const void* tables,
                          const void* ctx, void* out, int B, int nq, int nk,
                          int bs, int M, float scale, cudaStream_t stream) {
  paged_decode_kernel<T, HD><<<dim3(B, nk), kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(pool),
      static_cast<const int*>(tables), static_cast<const int*>(ctx),
      static_cast<T*>(out), nq, nk, bs, M, scale);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_prefill(const void* q, const void* pool,
                           const void* table, const void* start, void* out,
                           int C, int nq, int nk, int bs, int M, float scale,
                           cudaStream_t stream) {
  const dim3 grid(nq, (C + kMaxRows - 1) / kMaxRows);
  paged_chunked_prefill_kernel<T, HD><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(pool),
      static_cast<const int*>(table), static_cast<const int*>(start),
      static_cast<T*>(out), C, nq, nk, bs, M, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  hd: 64 or 128.  Pointers are device
// pointers of contiguous tensors; the pool's must be 16-byte aligned.
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int paged_decode_attention(int dtype, int hd, const void* q,
                                      const void* pool, const void* tables,
                                      const void* ctx, void* out, int B,
                                      int nq, int nk, int bs, int M,
                                      float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nk <= 0 || nq % nk || nq / nk > kMaxRows) return cudaErrorInvalidValue;
  if (dtype == 0 && hd == 64)
    return launch_decode<float, 64>(q, pool, tables, ctx, out, B, nq, nk,
                                    bs, M, scale, s);
  if (dtype == 0 && hd == 128)
    return launch_decode<float, 128>(q, pool, tables, ctx, out, B, nq, nk,
                                     bs, M, scale, s);
  if (dtype == 1 && hd == 64)
    return launch_decode<__nv_bfloat16, 64>(q, pool, tables, ctx, out, B, nq,
                                            nk, bs, M, scale, s);
  if (dtype == 1 && hd == 128)
    return launch_decode<__nv_bfloat16, 128>(q, pool, tables, ctx, out, B,
                                             nq, nk, bs, M, scale, s);
  return cudaErrorInvalidValue;
}

extern "C" int paged_chunked_prefill_attention(
    int dtype, int hd, const void* q, const void* pool, const void* table,
    const void* start, void* out, int C, int nq, int nk, int bs, int M,
    float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nk <= 0 || nq % nk) return cudaErrorInvalidValue;
  if (dtype == 0 && hd == 64)
    return launch_prefill<float, 64>(q, pool, table, start, out, C, nq, nk,
                                     bs, M, scale, s);
  if (dtype == 0 && hd == 128)
    return launch_prefill<float, 128>(q, pool, table, start, out, C, nq, nk,
                                      bs, M, scale, s);
  if (dtype == 1 && hd == 64)
    return launch_prefill<__nv_bfloat16, 64>(q, pool, table, start, out, C,
                                             nq, nk, bs, M, scale, s);
  if (dtype == 1 && hd == 128)
    return launch_prefill<__nv_bfloat16, 128>(q, pool, table, start, out, C,
                                              nq, nk, bs, M, scale, s);
  return cudaErrorInvalidValue;
}
