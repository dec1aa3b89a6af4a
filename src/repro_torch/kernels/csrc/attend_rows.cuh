// The CUDA-core prefill loop of the float32 instantiations of K1
// (dense_attention.cu) and K3 (paged_attention.cu), for Hopper (sm_90a).
// The bfloat16 instantiations run on the tensor cores (prefill_mma.cuh);
// float32 stays here because TF32 would not hold the 2e-5 tolerance the
// float32 checks keep.
//
// One block owns up to 16 chunk rows of one query head and loops over the
// keys itself, carrying the online-softmax state (running max m, sum l,
// accumulator acc) in registers.  Row r sees key positions
// kpos <= limit0 + r, and no key past the end of the rows (Rows::n).
// Keys go in tiles of 32.  All 128 threads stage a tile's K and V rows in
// shared memory with 16-byte loads.  K rows get one word of padding, so
// that lane j scoring key j over the head dimension hits bank (j + w) % 32:
// conflict-free.  Each warp owns up to four rows; per row, lane j computes
// the score of key j, the warp reduces max and sum with shuffles, and p
// goes through shared memory to the PV product, where lane l owns
// head-dimension elements l, l + 32, ... (HD % 32 == 0 covers every
// column).  The key loop stops at the last position any row of the block
// can see; a tile fully masked for one row adds exactly nothing (m stays,
// p = 0, alpha = 1), so stopping early does not change the result.  A row
// that sees no key outputs 0.
//
// Shared memory: sizeof(Smem<HD>) is 21,120 bytes at head dim 64 and
// 41,600 at 128, but 51,840 at 160 and 82,560 at 256, over the 49,152 a
// block gets statically, so the kernels take it as dynamic shared memory
// and launch() raises the limit.
#pragma once

#include "common.cuh"

namespace attn {

constexpr int kTileKeys = 32;                    // one key per lane
constexpr int kRowsPerWarp = 4;
constexpr int kMaxRows = kWarps * kRowsPerWarp;  // rows per block

template <int HD>
struct Smem {
  static_assert(HD % 32 == 0, "a lane owns columns l, l + 32, ...");
  static constexpr int kRowWords = HD + 1;       // padded K row
  static constexpr int kVecs = HD / 4;           // 16 B per row
  float k[kTileKeys * kRowWords];
  uint4 v[kTileKeys * kVecs];
  float q[kMaxRows * HD];
  float p[kWarps][kTileKeys];
};

template <int HD, typename Rows>
__device__ __forceinline__ void attend_rows(
    Smem<HD>& sm, const Rows& rows, int n_rows, int limit0, float scale,
    const float* __restrict__ q, long long q_stride, float* __restrict__ out,
    long long out_stride) {
  constexpr int kEl = HD / 32;                 // accumulator elements/lane
  constexpr int kRowWords = Smem<HD>::kRowWords;
  constexpr int kVecs = Smem<HD>::kVecs;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int i = tid; i < n_rows * HD; i += kThreads) {
    const int r = i / HD, d = i - r * HD;
    sm.q[i] = q[r * q_stride + d];
  }
  int kend = limit0 + n_rows - 1;                  // last visible key
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
      const float* kr;
      const float* vr;
      rows.at(t0 + j, kr, vr);
      const float4 kv = reinterpret_cast<const float4*>(kr)[c];
      float* kd = sm.k + j * kRowWords + c * 4;
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
      const int limit = limit0 + r;
      const bool valid = lane < tile_n && t0 + lane <= limit;
      float s = kNeg;
      if (valid) {
        const float* qr = sm.q + r * HD;
        const float* kr = sm.k + lane * kRowWords;
        float dot = 0.f;
#pragma unroll 8
        for (int w = 0; w < HD; ++w) dot = fmaf(qr[w], kr[w], dot);
        s = dot * scale;
      }
      const float m_new = fmaxf(m[rr], warp_max(s));
      const float p = valid ? expf(s - m_new) : 0.f;
      const float alpha = expf(m[rr] - m_new);
      l[rr] = l[rr] * alpha + warp_sum(p);
      m[rr] = m_new;
      sm.p[warp][lane] = p;
      __syncwarp();
#pragma unroll
      for (int e = 0; e < kEl; ++e) acc[rr][e] *= alpha;
      for (int j = 0; j < tile_n; ++j) {
        const float pj = sm.p[warp][j];
        const float* vr = reinterpret_cast<const float*>(sm.v + j * kVecs);
#pragma unroll
        for (int e = 0; e < kEl; ++e)
          acc[rr][e] = fmaf(pj, vr[lane + 32 * e], acc[rr][e]);
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
    float* o = out + r * out_stride;
#pragma unroll
    for (int e = 0; e < kEl; ++e)
      o[lane + 32 * e] = seen ? acc[rr][e] / den : 0.f;
  }
}

}  // namespace attn
