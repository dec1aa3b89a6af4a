// The decode loop of K2 (dense_attention.cu) and K4 (paged_attention.cu),
// split across the keys, for Hopper (sm_90a), in float32 and bfloat16.
//
// Decode reads each visible K/V row once for the g query rows of its KV
// head: about g flops a byte, far under the card's ~295 flop/byte ridge,
// so it is bound by bytes, and what matters is keeping enough of them in
// flight on every SM.  Tensor cores do not help at g = 1.
//
//   * Across blocks (flash-decoding): the grid is (B, nk, n_split).  Block
//     (b, h, s) takes keys [s * split_len, (s + 1) * split_len) of row b's
//     visible ones, for the g query rows of KV head h.  With n_split > 1 it
//     writes a partial (acc, m, l) in fp32 to a workspace, and
//     combine_kernel rescales and sums the partials; with n_split == 1 it
//     writes the output itself.  A split past the row's last visible key
//     writes an empty partial (acc 0, m = kNeg, l 0).
//   * Within a block: each of the 4 warps takes its own contiguous range of
//     the split's key tiles, with its own (m, l, acc) for all g rows, and
//     stages its tiles itself with 16-byte cp.async copies into its own
//     ring of two slots (the next tile loads while this one computes; no
//     block barrier in the loop).  The four states merge through shared
//     memory at the end.  So at g = 1 every warp computes.
//   * Scores: a tile holds kKeys keys; kLanes = 32 / kKeys lanes share one
//     key's dot product over interleaved 16-byte chunks of the row and sum
//     it with shuffles.  K rows are padded by one chunk, so 8 lanes reading
//     8 rows at one chunk hit 8 different bank groups.  kKeys is chosen so
//     that a K tile is at most 4 KB.
//   * PV: p is cast to the KV type (the TPU kernels' p.astype(v.dtype)),
//     passed by shuffle, and lane l owns the 4-byte words l, l + 32, ... of
//     the V row (bf16: pairs), with a guard for the words past the row: at
//     head dim 160 in bf16 that is 80 words, three a lane for lanes 0-15.
//   * A row that sees no key (limit < 0) outputs 0.
//
// G (4 or 16) is the most query rows a block holds; the accumulators of all
// G rows live in registers.
#pragma once

#include "common.cuh"

namespace attn {

constexpr int kMaxGroup = 16;    // query rows a KV head, at most

template <typename T, int HD, int G>
struct DecodeSmem {
  static_assert(G <= kMaxGroup, "G rows of accumulators in registers");
  static constexpr int kRowBytes = HD * (int)sizeof(T);
  static constexpr int kKeys = kRowBytes * 32 <= 4096   ? 32
                               : kRowBytes * 16 <= 4096 ? 16
                               : kRowBytes * 8 <= 4096  ? 8
                                                        : 4;
  static constexpr int kLanes = 32 / kKeys;       // lanes a key
  static constexpr int kChunks = kRowBytes / 16;  // 16-byte chunks a row
  static constexpr int kKStride = kChunks + 1;    // padded K row
  static constexpr int kWords = kRowBytes / 4;    // 4-byte words a row
  static_assert(kChunks % kLanes == 0, "a key's lanes split its chunks");
  float q[G * HD];
  union {
    struct {
      uint4 k[kWarps][2][kKeys * kKStride];
      uint4 v[kWarps][2][kKeys * kChunks];
    } ring;
    struct {
      float acc[kWarps][G][HD];
      float m[kWarps][G];
      float l[kWarps][G];
    } merge;
  } u;
};

// The 16-byte chunk c as floats.
__device__ __forceinline__ void unpack(const uint4& c, float (&f)[4]) {
  f[0] = __uint_as_float(c.x);
  f[1] = __uint_as_float(c.y);
  f[2] = __uint_as_float(c.z);
  f[3] = __uint_as_float(c.w);
}
__device__ __forceinline__ void unpack(const uint4& c, float (&f)[8]) {
  const uint32_t w[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

// The 4-byte word w as floats.
__device__ __forceinline__ void unpack_word(uint32_t w, float (&f)[1]) {
  f[0] = __uint_as_float(w);
}
__device__ __forceinline__ void unpack_word(uint32_t w, float (&f)[2]) {
  const float2 p =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
  f[0] = p.x;
  f[1] = p.y;
}

// One block's split of one decode row set: g query rows (q, out: [g, HD])
// over keys kpos <= limit of `rows`, split `split` of n_split.  part (when
// n_split > 1) points at [g][n_split][HD + 2] floats: acc, then m, l.
template <typename T, int HD, int G, typename Rows>
__device__ __forceinline__ void decode_split_rows(
    DecodeSmem<T, HD, G>& sm, const Rows& rows, int g, int limit,
    int split, int n_split, int split_len, float scale,
    const T* __restrict__ q, T* __restrict__ out, float* __restrict__ part) {
  using Sm = DecodeSmem<T, HD, G>;
  constexpr int kKeys = Sm::kKeys, kLanes = Sm::kLanes;
  constexpr int kChunks = Sm::kChunks, kKStride = Sm::kKStride;
  constexpr int kWords = Sm::kWords;
  constexpr int kWordsPerLane = (kWords + 31) / 32;
  constexpr int kPerChunk = 16 / (int)sizeof(T);  // elements a chunk
  constexpr int kPerWord = 4 / (int)sizeof(T);    // elements a word
  constexpr int kAcc = kWordsPerLane * kPerWord;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int i = tid; i < g * HD; i += kThreads) sm.q[i] = to_f(q[i]);

  int kend = limit;                                // last visible key
  if (kend > rows.n - 1) kend = rows.n - 1;        // end of the keys
  const int s0 = split * split_len;
  const int s1 = min(s0 + split_len, kend + 1);    // this split's keys
  const int n_tiles = s1 > s0 ? (s1 - s0 + kKeys - 1) / kKeys : 0;
  const int per_warp = (n_tiles + kWarps - 1) / kWarps;
  const int w0 = warp * per_warp;
  const int w1 = min(n_tiles, w0 + per_warp);      // this warp's tiles

  // tile t of the split into this warp's slot `slot`; keys past s1 zero
  // (a fixed trip count, so the table reads of all iterations can issue
  // before the copies that wait on them)
  constexpr int kIters = kKeys * kChunks / 32;
  static_assert(kKeys * kChunks % 32 == 0, "whole copy rounds");
  auto load = [&](int t, int slot) {
    const int k0 = s0 + t * kKeys;
    uint4* kd = sm.u.ring.k[warp][slot];
    uint4* vd = sm.u.ring.v[warp][slot];
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      const int i = lane + it * 32;
      const int j = i / kChunks, c = i - j * kChunks;
      const bool ok = k0 + j < s1;
      const T* kr = q;                           // any valid address
      const T* vr = q;
      if (ok) rows.at(k0 + j, kr, vr);
      cp_async16(kd + j * kKStride + c,
                 reinterpret_cast<const uint4*>(kr) + (ok ? c : 0), ok);
      cp_async16(vd + j * kChunks + c,
                 reinterpret_cast<const uint4*>(vr) + (ok ? c : 0), ok);
    }
  };

  float m[G], l[G], acc[G][kAcc];
#pragma unroll
  for (int r = 0; r < G; ++r) {
    m[r] = kNeg;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < kAcc; ++e) acc[r][e] = 0.f;
  }
  const float sl2 = scale * kLog2e;
  const int key = lane % kKeys, part_i = lane / kKeys;
  __syncthreads();                                 // q

  if (w0 < w1) load(w0, 0);
  cp_async_commit();
  for (int t = w0; t < w1; ++t) {
    const int slot = (t - w0) & 1;
    if (t + 1 < w1) load(t + 1, slot ^ 1);
    cp_async_commit();
    cp_async_wait<1>();                            // tile t has landed
    __syncwarp();
    const bool valid = s0 + t * kKeys + key < s1;

    // scores of key `key` for every row, summed over its kLanes lanes
    float s[G];
#pragma unroll
    for (int r = 0; r < G; ++r) s[r] = 0.f;
    const uint4* kr = sm.u.ring.k[warp][slot] + key * kKStride;
#pragma unroll
    for (int i = 0; i < kChunks / kLanes; ++i) {
      const int c = part_i + i * kLanes;
      float kf[kPerChunk];
      unpack(kr[c], kf);
#pragma unroll
      for (int r = 0; r < G; ++r) {
        if (r >= g) break;                         // warp-uniform
        const float4* qv =
            reinterpret_cast<const float4*>(sm.q + r * HD + c * kPerChunk);
#pragma unroll
        for (int x = 0; x < kPerChunk / 4; ++x) {
          const float4 qx = qv[x];
          s[r] = fmaf(qx.x, kf[4 * x], s[r]);
          s[r] = fmaf(qx.y, kf[4 * x + 1], s[r]);
          s[r] = fmaf(qx.z, kf[4 * x + 2], s[r]);
          s[r] = fmaf(qx.w, kf[4 * x + 3], s[r]);
        }
      }
    }

    // online softmax over the tile's keys, row by row
    float p[G];
#pragma unroll
    for (int r = 0; r < G; ++r) {
      p[r] = 0.f;
      if (r >= g) break;
#pragma unroll
      for (int o = kKeys; o < 32; o <<= 1)
        s[r] += __shfl_xor_sync(0xffffffffu, s[r], o);
      const float x = valid ? s[r] * sl2 : -INFINITY;
      float mx = x, sum;
#pragma unroll
      for (int o = kKeys / 2; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float mn = fmaxf(m[r], mx);
      const float pr = exp2f(x - mn);
      sum = pr;
#pragma unroll
      for (int o = kKeys / 2; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const float al = exp2f(m[r] - mn);
      l[r] = l[r] * al + sum;
      m[r] = mn;
#pragma unroll
      for (int e = 0; e < kAcc; ++e) acc[r][e] *= al;
      p[r] = to_f(from_f<T>(pr));                  // p cast to the KV type
    }

    // acc += p V: lane owns words lane + 32 e of each V row
    const uint32_t* vt =
        reinterpret_cast<const uint32_t*>(sm.u.ring.v[warp][slot]);
#pragma unroll 4
    for (int j = 0; j < kKeys; ++j) {
      float vf[kWordsPerLane][kPerWord];
#pragma unroll
      for (int e = 0; e < kWordsPerLane; ++e) {
        const int w = lane + 32 * e;
        if (kWords % 32 && w >= kWords) {          // past the row: 0
#pragma unroll
          for (int x = 0; x < kPerWord; ++x) vf[e][x] = 0.f;
        } else {
          unpack_word(vt[j * kWords + w], vf[e]);
        }
      }
#pragma unroll
      for (int r = 0; r < G; ++r) {
        if (r >= g) break;                         // warp-uniform
        const float pj = __shfl_sync(0xffffffffu, p[r], j);  // lane j: key j
#pragma unroll
        for (int e = 0; e < kWordsPerLane; ++e)
#pragma unroll
          for (int x = 0; x < kPerWord; ++x)
            acc[r][e * kPerWord + x] =
                fmaf(pj, vf[e][x], acc[r][e * kPerWord + x]);
      }
    }
    __syncwarp();                    // slot `slot` takes tile t + 2
  }
  cp_async_wait<0>();
  __syncthreads();                   // the merge area overlaps every ring

  // merge the four warps' states
#pragma unroll
  for (int r = 0; r < G; ++r) {
    if (r >= g) break;
#pragma unroll
    for (int e = 0; e < kWordsPerLane; ++e) {
      const int w = lane + 32 * e;
      if (kWords % 32 && w >= kWords) break;
#pragma unroll
      for (int x = 0; x < kPerWord; ++x)
        sm.u.merge.acc[warp][r][w * kPerWord + x] = acc[r][e * kPerWord + x];
    }
    if (lane == 0) {
      sm.u.merge.m[warp][r] = m[r];
      sm.u.merge.l[warp][r] = l[r];
    }
  }
  __syncthreads();
  for (int i = tid; i < g * HD; i += kThreads) {
    const int r = i / HD, d = i - r * HD;
    float mm = kNeg;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, sm.u.merge.m[w][r]);
    float ll = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = exp2f(sm.u.merge.m[w][r] - mm);
      ll += sm.u.merge.l[w][r] * f;
      a += sm.u.merge.acc[w][r][d] * f;
    }
    if (part == nullptr) {
      out[i] = from_f<T>(ll > 0.f ? a / ll : 0.f);
    } else {
      float* pp = part + ((long long)r * n_split + split) * (HD + 2);
      pp[d] = a;
      if (d == 0) {
        pp[HD] = mm;
        pp[HD + 1] = ll;
      }
    }
  }
}

// Sums the n_split partials of one query row (grid: B * nq rows, block:
// HD threads): out = sum_s acc_s 2^(m_s - M) / sum_s l_s 2^(m_s - M), with
// M the largest m_s; 0 where no split saw a key.
template <typename T, int HD>
__global__ void __launch_bounds__(HD) combine_kernel(
    const float* __restrict__ part, T* __restrict__ out, int n_split) {
  const long long row = blockIdx.x;
  const float* pr = part + row * n_split * (HD + 2);
  const int d = threadIdx.x;
  float mm = kNeg;
  for (int s = 0; s < n_split; ++s) mm = fmaxf(mm, pr[s * (HD + 2) + HD]);
  float ll = 0.f, a = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const float* ps = pr + s * (HD + 2);
    const float f = exp2f(ps[HD] - mm);
    ll += ps[HD + 1] * f;
    a += ps[d] * f;
  }
  out[row * HD + d] = from_f<T>(ll > 0.f ? a / ll : 0.f);
}

}  // namespace attn
