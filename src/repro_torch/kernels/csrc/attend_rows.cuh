// The device routine that all four attention kernels of the port share
// (paged_attention.cu: K3, K4; dense_attention.cu: K1, K2), for Hopper
// (sm_90a).
//
// One block owns a set of query rows that share one KV head and one key
// addressing, and loops over the keys itself, carrying the online-softmax
// state (running max m, sum l, accumulator acc) in registers.  Row r sees
// key positions kpos <= limit0 + r * limit_step.  Where key kpos's K and
// V rows lie is the template parameter Rows:
//   * TableRows (K3, K4): through a block table into the fused,
//     head-interleaved pool [N, bs, 2 * nk, hd] (K of head h at channel
//     2h, its V at 2h + 1); each thread reads the block id for the row it
//     stages itself (Hopper has no scalar prefetch);
//   * DenseRows (K1, K2): dense K and V rows [S, nk, hd], key kpos at
//     kpos * nk * hd.
// Keys go in tiles of 32.  All 128 threads stage a tile's K and V rows in
// shared memory with 16-byte loads.  K rows get one word of padding, so
// that lane j scoring key j over the head dimension hits bank (j + w) % 32:
// conflict-free.  Each warp owns up to four rows; per row, lane j computes
// the score of key j, the warp reduces max and sum with shuffles, and p
// (cast to the KV type, as the TPU kernels cast p to v.dtype) goes through
// shared memory to the PV product, where lane l owns head-dimension
// elements l, l + 32, ... (bf16: pairs).  The key loop stops at the last
// position any row of the block can see, or at the end of the keys; a tile
// fully masked for one row adds exactly nothing (m stays, p = 0,
// alpha = 1), so stopping early does not change the result.  A row that
// sees no key outputs 0.  Accumulation is fp32.
//
// Shared memory: sizeof(Smem<T, HD>) is 12,928-41,600 bytes at head dims
// 64 and 128, but 49,792 (bf16) and 82,560 (fp32) at 256, over the 49,152
// a block gets statically.  So every kernel takes it as dynamic shared
// memory, and launch() raises the kernel's limit first where it needs
// more than that.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace attn {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTileKeys = 32;                  // one key per lane
constexpr int kRowsPerWarp = 4;
constexpr int kMaxRows = kWarps * kRowsPerWarp;  // rows per block
constexpr float kNeg = -1e30f;                 // running-max start
constexpr size_t kStaticSmem = 48 * 1024;

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

// Keys through a block table into the fused pool [N, bs, nch, HD]; the
// block's KV head is kvh.  n = keys the table holds (entries * bs).
template <typename T, int HD>
struct TableRows {
  const T* __restrict__ pool;
  const int* __restrict__ table;
  int bs, nch, kvh, n;
  __device__ __forceinline__ void at(int kpos, const T*& kr,
                                     const T*& vr) const {
    const long long blk = table[kpos / bs];
    kr = pool + ((blk * bs + kpos % bs) * nch + 2 * kvh) * HD;
    vr = kr + HD;
  }
};

// Keys in dense rows [n, nk, HD]; k and v already point at the block's KV
// head (and sequence).
template <typename T, int HD>
struct DenseRows {
  const T* __restrict__ k;
  const T* __restrict__ v;
  int nk, n;
  __device__ __forceinline__ void at(int kpos, const T*& kr,
                                     const T*& vr) const {
    const long long off = (long long)kpos * nk * HD;
    kr = k + off;
    vr = v + off;
  }
};

template <typename T, int HD, typename Rows>
__device__ __forceinline__ void attend_rows(
    Smem<T, HD>& sm, const Rows& rows, int n_rows, int limit0,
    int limit_step, float scale, const T* __restrict__ q,
    long long q_stride, T* __restrict__ out, long long out_stride) {
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
  if (kend > rows.n - 1) kend = rows.n - 1;        // end of the keys
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
      const T* kr;
      const T* vr;
      rows.at(t0 + j, kr, vr);
      const uint4 kv = reinterpret_cast<const uint4*>(kr)[c];
      uint32_t* kd = sm.k + j * kRowWords + c * 4;
      kd[0] = kv.x;
      kd[1] = kv.y;
      kd[2] = kv.z;
      kd[3] = kv.w;
      sm.v[j * kVecs + c] = reinterpret_cast<const uint4*>(vr)[c];
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

// The block's shared memory, taken as dynamic shared memory.
template <typename T, int HD>
__device__ __forceinline__ Smem<T, HD>& smem() {
  extern __shared__ uint4 raw[];
  return *reinterpret_cast<Smem<T, HD>*>(raw);
}

// Launches kernel<<<grid, kThreads, sizeof(Smem<T, HD>), stream>>>(args),
// raising its dynamic shared memory limit first where it needs more than
// 48 KB; returns the launch's cudaError_t.
template <typename T, int HD, typename... P, typename... A>
cudaError_t launch(void (*kernel)(P...), dim3 grid, cudaStream_t stream,
                   A... args) {
  constexpr size_t bytes = sizeof(Smem<T, HD>);
  if (bytes > kStaticSmem) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (rc != cudaSuccess) return rc;
  }
  kernel<<<grid, kThreads, bytes, stream>>>(args...);
  return cudaGetLastError();
}

// L::run<T, HD>(args) for the dtype code (0 float32, 1 bfloat16) and a
// head dim among HD, More...; cudaErrorInvalidValue for any other.
template <typename L, int HD, int... More, typename... A>
cudaError_t dispatch(int dtype, int hd, A... args) {
  if (hd == HD) {
    if (dtype == 0) return L::template run<float, HD>(args...);
    if (dtype == 1) return L::template run<__nv_bfloat16, HD>(args...);
    return cudaErrorInvalidValue;
  }
  if constexpr (sizeof...(More) > 0)
    return dispatch<L, More...>(dtype, hd, args...);
  return cudaErrorInvalidValue;
}

}  // namespace attn
