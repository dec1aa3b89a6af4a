// What the attention kernels of the port share, for Hopper (sm_90a): the
// two ways a kernel finds key kpos's K and V rows, 16-byte cp.async copies
// into shared memory, warp reductions, the launch (with its dynamic shared
// memory limit) and the dtype x head-dim dispatch.
//
// The kernels, and the device routines they run:
//   attend_rows.cuh    float32 K1, K3: the CUDA-core prefill loop;
//   prefill_mma.cuh    bfloat16 K1, K3: prefill on the tensor cores;
//   decode_split.cuh   K2, K4 (both dtypes): decode split across the keys.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace attn {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kNeg = -1e30f;                 // running-max start
constexpr float kLog2e = 1.4426950408889634f;  // scores go through exp2
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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copies 16 bytes from src to shared dst asynchronously; where !valid it
// writes 16 zero bytes instead and reads nothing (src must still be a
// valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Waits until at most N of this thread's committed copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The block's shared memory, taken as dynamic shared memory.
template <typename Smem>
__device__ __forceinline__ Smem& smem() {
  extern __shared__ uint4 raw[];
  return *reinterpret_cast<Smem*>(raw);
}

// Launches kernel<<<grid, threads, bytes, stream>>>(args), raising the
// kernel's dynamic shared memory limit first where it needs more than
// 48 KB; returns the launch's cudaError_t.
template <typename... P, typename... A>
cudaError_t launch(void (*kernel)(P...), dim3 grid, int threads,
                   size_t bytes, cudaStream_t stream, A... args) {
  if (bytes > kStaticSmem) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (rc != cudaSuccess) return rc;
  }
  kernel<<<grid, threads, bytes, stream>>>(args...);
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
