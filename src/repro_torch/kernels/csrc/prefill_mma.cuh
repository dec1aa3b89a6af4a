// The bfloat16 prefill loop of K1 (dense_attention.cu) and K3
// (paged_attention.cu) on Hopper's tensor cores (sm_90a).
//
// One block of 4 warps owns 64 chunk rows of one query head, 16 per warp;
// row r sees key positions kpos <= limit0 + r, and no key past the end of
// the rows (Rows::n).  Both products are mma.sync.m16n8k16, bf16 in and
// fp32 out:
//   * S = Q K^T: the warp's 16 x HD query tile is loaded once (ldmatrix)
//     and stays in registers as A fragments for the whole key loop; K^T's
//     B fragments come from shared memory with ldmatrix;
//   * O += P V: P is cast to bf16 in registers, where the S accumulators
//     already sit in the A-fragment layout (the TPU kernels' p.astype(
//     v.dtype), src/repro/kernels/ops.py flash_update); V's B fragments
//     come from shared memory with ldmatrix.trans.
// The online softmax runs on the accumulators: a thread holds two rows
// (lane / 4 and lane / 4 + 8 of the warp's 16) and 16 of the tile's 64
// keys for each; row maxima reduce over the 4 threads of a quad, row sums
// stay per thread until the end.  Scores go through exp2 (scale * log2 e).
//
// Keys go in tiles of 64 through shared memory with cp.async, in a ring of
// two slots: the copies of tile t + 1 are in flight while tile t computes.
// In TableRows addressing every copying thread reads the table entry of
// the key row it copies (at block size 16 a tile spans four pool blocks).
// Rows are padded by one 16-byte chunk: 8 consecutive rows at one column
// then fall on 8 different 16-byte bank groups, so ldmatrix and
// ldmatrix.trans read without bank conflicts at every head dim.  (An XOR
// swizzle over 8 chunks would not do for head dim 160, whose 20 chunks a
// row are no multiple of 8.)  The Q tile is staged once in the second
// slot before the loop.
//
// Masking: the offset-causal mask and the end of the keys are applied only
// on tiles that cross this warp's diagonal or the end; a warp skips a tile
// that lies wholly past its rows (it would add exactly nothing), and the
// key loop ends at the block's last visible key.  A row that sees no key
// outputs 0; rows past n_rows (a ragged last tile) load zeros and are not
// written.
//
// Shared memory: 4 tiles of 64 rows x (HD + 8) bf16: 36,864 bytes at head
// dim 64, 69,632 at 128, 86,016 at 160, 135,168 at 256.
#pragma once

#include "common.cuh"

namespace attn {

constexpr int kMmaRows = 64;   // chunk rows per block, 16 per warp
constexpr int kMmaKeys = 64;   // keys per tile
static_assert(kMmaRows == kMmaKeys, "the Q tile is staged in a K slot");

template <int HD>
struct MmaSmem {
  static_assert(HD % 16 == 0, "mma.m16n8k16 steps of 16 head dims");
  static constexpr int kChunks = HD / 8;         // 16-byte chunks a row
  static constexpr int kStride = kChunks + 1;    // padded row, in chunks
  static constexpr int kTile = kMmaKeys * kStride;
  uint4 k[2][kTile];       // the ring; the Q tile first lands in k[1]
  uint4 v[2][kTile];
};

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a b for one 16 x 8 x 16 tile: a 16 x 16 bf16 (row), b 16 x 8 bf16
// (col), d 16 x 8 fp32.
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats as a bf16 pair, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int HD, typename Rows>
__device__ __forceinline__ void prefill_rows_mma(
    MmaSmem<HD>& sm, const Rows& rows, int n_rows, int limit0, float scale,
    const __nv_bfloat16* __restrict__ q, long long q_stride,
    __nv_bfloat16* __restrict__ out, long long out_stride) {
  using bf16 = __nv_bfloat16;
  constexpr int kC = MmaSmem<HD>::kChunks;
  constexpr int kStride = MmaSmem<HD>::kStride;
  constexpr int kDepth = HD / 16;       // QK k-steps = PV pairs of n-tiles
  constexpr int kNt = kMmaKeys / 8;     // S n-tiles (8 keys each)
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  int kend = limit0 + n_rows - 1;                  // last visible key
  if (kend > rows.n - 1) kend = rows.n - 1;        // end of the keys
  const int n_keys = kend + 1;
  const int n_tiles = n_keys > 0 ? (n_keys + kMmaKeys - 1) / kMmaKeys : 0;

  // tile t's K and V rows into ring slot `slot`; keys past n_keys are zero
  auto load_kv = [&](int t, int slot) {
    const int t0 = t * kMmaKeys;
    for (int i = tid; i < kMmaKeys * kC; i += kThreads) {
      const int j = i / kC, c = i - j * kC;
      const bool ok = t0 + j < n_keys;
      const bf16* kr = q;                        // any valid address
      const bf16* vr = q;
      if (ok) rows.at(t0 + j, kr, vr);
      cp_async16(&sm.k[slot][j * kStride + c], kr + (ok ? c * 8 : 0), ok);
      cp_async16(&sm.v[slot][j * kStride + c], vr + (ok ? c * 8 : 0), ok);
    }
  };

  // the Q tile into slot 1 (rows past n_rows zero), tile 0 into slot 0
  for (int i = tid; i < kMmaRows * kC; i += kThreads) {
    const int r = i / kC, c = i - r * kC;
    const bool ok = r < n_rows;
    cp_async16(&sm.k[1][r * kStride + c], q + (ok ? r * q_stride + c * 8 : 0),
               ok);
  }
  if (n_tiles > 0) load_kv(0, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // A fragments of the warp's 16 query rows over the whole head dim
  uint32_t qf[kDepth][4];
  {
    const int r = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int kk = 0; kk < kDepth; ++kk)
      ldsm_x4(qf[kk], &sm.k[1][r * kStride + kk * 2 + (lane >> 4)]);
  }
  __syncthreads();                                 // slot 1 is tile 1's

  float o[HD / 8][4];
#pragma unroll
  for (int d = 0; d < HD / 8; ++d)
    o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  float m_a = kNeg, m_b = kNeg, l_a = 0.f, l_b = 0.f;
  const float sl2 = scale * kLog2e;
  const int ra = warp * 16 + (lane >> 2);          // rows ra and ra + 8
  const int lim_a = limit0 + ra, lim_b = lim_a + 8;
  const int warp_lo = limit0 + warp * 16;          // the warp's least limit
  const bool warp_live = warp * 16 < n_rows;

  for (int t = 0; t < n_tiles; ++t) {
    const int slot = t & 1;
    if (t + 1 < n_tiles) load_kv(t + 1, slot ^ 1);
    cp_async_commit();
    cp_async_wait<1>();                            // tile t has landed
    __syncthreads();
    const int t0 = t * kMmaKeys;
    if (warp_live && t0 <= warp_lo + 15) {         // warp-uniform
      float s[kNt][4];
#pragma unroll
      for (int n = 0; n < kNt; ++n)
        s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      const uint4* kt = sm.k[slot];
#pragma unroll
      for (int kk = 0; kk < kDepth; ++kk) {
#pragma unroll
        for (int nn = 0; nn < kNt / 2; ++nn) {
          uint32_t b[4];
          const int key = nn * 16 + (lane & 7) + (lane >> 4) * 8;
          ldsm_x4(b, &kt[key * kStride + kk * 2 + ((lane >> 3) & 1)]);
          mma_bf16(s[2 * nn], qf[kk], b[0], b[1]);
          mma_bf16(s[2 * nn + 1], qf[kk], b[2], b[3]);
        }
      }

      // scale to log2 units; mask where the tile crosses the diagonal or
      // the end of the keys
      const bool edge = t0 + kMmaKeys - 1 > warp_lo || t0 + kMmaKeys > n_keys;
      float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
      for (int n = 0; n < kNt; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = t0 + n * 8 + 2 * (lane & 3) + e;
          float xa = s[n][e] * sl2, xb = s[n][2 + e] * sl2;
          if (edge) {
            if (j > lim_a || j >= n_keys) xa = -INFINITY;
            if (j > lim_b || j >= n_keys) xb = -INFINITY;
          }
          s[n][e] = xa;
          s[n][2 + e] = xb;
          mx_a = fmaxf(mx_a, xa);
          mx_b = fmaxf(mx_b, xb);
        }
      }
      const float mn_a = fmaxf(m_a, quad_max(mx_a));
      const float mn_b = fmaxf(m_b, quad_max(mx_b));
      const float al_a = exp2f(m_a - mn_a), al_b = exp2f(m_b - mn_b);
      m_a = mn_a;
      m_b = mn_b;

      // p, its row sums (fp32), and P as bf16 A fragments: for keys
      // 16 kk .. 16 kk + 15, n-tiles 2 kk and 2 kk + 1 give a0/a1, a2/a3
      uint32_t pf[kNt / 2][4];
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int n = 0; n < kNt; ++n) {
        const float p0 = exp2f(s[n][0] - m_a), p1 = exp2f(s[n][1] - m_a);
        const float p2 = exp2f(s[n][2] - m_b), p3 = exp2f(s[n][3] - m_b);
        sum_a += p0 + p1;
        sum_b += p2 + p3;
        pf[n >> 1][(n & 1) * 2] = pack_bf16(p0, p1);
        pf[n >> 1][(n & 1) * 2 + 1] = pack_bf16(p2, p3);
      }
      l_a = l_a * al_a + sum_a;
      l_b = l_b * al_b + sum_b;
#pragma unroll
      for (int d = 0; d < HD / 8; ++d) {
        o[d][0] *= al_a;
        o[d][1] *= al_a;
        o[d][2] *= al_b;
        o[d][3] *= al_b;
      }

      const uint4* vt = sm.v[slot];
#pragma unroll
      for (int kk = 0; kk < kNt / 2; ++kk) {
#pragma unroll
        for (int nd = 0; nd < kDepth; ++nd) {
          uint32_t b[4];
          const int key = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
          ldsm_x4_t(b, &vt[key * kStride + nd * 2 + (lane >> 4)]);
          mma_bf16(o[2 * nd], pf[kk], b[0], b[1]);
          mma_bf16(o[2 * nd + 1], pf[kk], b[2], b[3]);
        }
      }
    }
    __syncthreads();                 // slot `slot` takes tile t + 2
  }

  // o / l, and 0 for a row that saw no key (l == 0)
  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);
  const float ia = l_a > 0.f ? 1.f / l_a : 0.f;
  const float ib = l_b > 0.f ? 1.f / l_b : 0.f;
  const int c = 2 * (lane & 3);
  if (ra < n_rows) {
    bf16* orow = out + ra * out_stride + c;
#pragma unroll
    for (int d = 0; d < HD / 8; ++d)
      *reinterpret_cast<__nv_bfloat162*>(orow + d * 8) =
          __floats2bfloat162_rn(o[d][0] * ia, o[d][1] * ia);
  }
  if (ra + 8 < n_rows) {
    bf16* orow = out + (ra + 8) * out_stride + c;
#pragma unroll
    for (int d = 0; d < HD / 8; ++d)
      *reinterpret_cast<__nv_bfloat162*>(orow + d * 8) =
          __floats2bfloat162_rn(o[d][2] * ib, o[d][3] * ib);
  }
}

}  // namespace attn
