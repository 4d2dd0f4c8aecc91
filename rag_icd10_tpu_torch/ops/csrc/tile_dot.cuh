// Register-tiled NT product shared by the streaming top-S kernel
// (slot_stream.cu) and the chunk-maxima kernel (chunk_max.cu):
//
//     acc[i][j] = sum_d q[m0 + ty*TM + i, d] * C[n0 + tx + j*COL_STRIDE, d]
//
// for one BM x BN tile (BM query rows, BN corpus rows), fp32 sums. It is
// the loop of fused_score.cu (K1) with the corpus load widened to three
// stored types:
//   float          4 per 16-byte read, used as is, or rounded to bf16 when
//                  round_inputs is set (one bf16 pass);
//   __nv_bfloat16  8 per read, widened exactly;
//   int8_t         16 per read, widened exactly (|v| <= 127 is exact in
//                  bf16 and in fp32).
// round_inputs also rounds q to bf16 with __float2bfloat16_rn on its way
// into shared memory (the JAX kernels cast q to bf16 for those scans).
// The D loop runs BK = 32 columns a step; the next step's global loads are
// issued into registers before the current step's arithmetic. Rows past
// B, rows past N and the D tail are zero-filled. The caller guarantees
// D % (16 / sizeof(TC)) == 0 and D % 4 == 0, and 16-byte aligned rows.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace tile {

constexpr int BK = 32;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int kElems = 4;
  __device__ __forceinline__ static void widen(const uint4& v, float* out) {
    out[0] = __uint_as_float(v.x);
    out[1] = __uint_as_float(v.y);
    out[2] = __uint_as_float(v.z);
    out[3] = __uint_as_float(v.w);
  }
};

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int kElems = 8;
  __device__ __forceinline__ static void widen(const uint4& v, float* out) {
    const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // bf16 -> fp32 is exact: the bf16 bits are the high half of the fp32
      out[2 * i] = __uint_as_float(words[i] << 16);
      out[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
    }
  }
};

template <>
struct Vec16<int8_t> {
  static constexpr int kElems = 16;
  __device__ __forceinline__ static void widen(const uint4& v, float* out) {
    const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int b = 0; b < 4; ++b)
        out[4 * i + b] =
            static_cast<float>(static_cast<int8_t>((words[i] >> (8 * b)) & 0xffu));
  }
};

template <int BM, int BN, int TM, int TN, int THREADS, typename TC>
struct TileDot {
  static_assert((BM / TM) * (BN / TN) == THREADS, "tile/thread mismatch");
  static_assert(TM % 4 == 0, "query fragment is read as float4");
  static constexpr int CV = Vec16<TC>::kElems;   // corpus elements per read
  static constexpr int C_CHUNKS = BK / CV;       // reads per corpus row slice
  static constexpr int C_READS = BN * C_CHUNKS / THREADS;
  static_assert(BN * C_CHUNKS % THREADS == 0, "corpus tile/thread mismatch");
  static constexpr int Q_CHUNKS = BK / 4;        // fp32 query: 4 per read
  static constexpr int Q_TOTAL = BM * Q_CHUNKS;
  static constexpr int Q_READS = (Q_TOTAL + THREADS - 1) / THREADS;
  static constexpr int COL_STRIDE = BN / TN;

  struct Smem {
    __align__(16) float qs[BK][BM];
    float cs[BK][BN + 1];  // +1: conflict-free transposed stores
  };

  __device__ __forceinline__ static void run(const float* __restrict__ q,
                                             const TC* __restrict__ c, int B,
                                             int N, int D, int m0, int n0,
                                             int round_inputs, Smem& sm,
                                             float (&acc)[TM][TN]) {
    const int tid = threadIdx.x;
    const int tx = tid % COL_STRIDE;
    const int ty = tid / COL_STRIDE;
    uint4 q_stage[Q_READS];
    uint4 c_stage[C_READS];

    auto load_slice = [&](int k0) {
#pragma unroll
      for (int l = 0; l < Q_READS; ++l) {
        const int i = tid + l * THREADS;
        const int r = i % BM, ch = i / BM;
        const int row = m0 + r, k = k0 + ch * 4;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (i < Q_TOTAL && row < B && k < D)
          v = __ldg(reinterpret_cast<const uint4*>(q + (size_t)row * D + k));
        q_stage[l] = v;
      }
#pragma unroll
      for (int l = 0; l < C_READS; ++l) {
        const int i = tid + l * THREADS;
        const int r = i / C_CHUNKS, ch = i % C_CHUNKS;
        const int row = n0 + r, k = k0 + ch * CV;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (row < N && k < D)
          v = __ldg(reinterpret_cast<const uint4*>(c + (size_t)row * D + k));
        c_stage[l] = v;
      }
    };

    auto store_slice = [&]() {
#pragma unroll
      for (int l = 0; l < Q_READS; ++l) {
        const int i = tid + l * THREADS;
        if (i < Q_TOTAL) {
          const int r = i % BM, ch = i / BM;
          float f[4];
          Vec16<float>::widen(q_stage[l], f);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sm.qs[ch * 4 + e][r] = round_inputs ? round_bf16(f[e]) : f[e];
        }
      }
#pragma unroll
      for (int l = 0; l < C_READS; ++l) {
        const int i = tid + l * THREADS;
        const int r = i / C_CHUNKS, ch = i % C_CHUNKS;
        float f[CV];
        Vec16<TC>::widen(c_stage[l], f);
#pragma unroll
        for (int e = 0; e < CV; ++e)
          sm.cs[ch * CV + e][r] = round_inputs ? round_bf16(f[e]) : f[e];
      }
    };

#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

    const int k_steps = (D + BK - 1) / BK;
    load_slice(0);
    for (int t = 0; t < k_steps; ++t) {
      store_slice();
      __syncthreads();
      if (t + 1 < k_steps) load_slice((t + 1) * BK);
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float a[TM], b[TN];
#pragma unroll
        for (int i = 0; i < TM; i += 4) {
          const float4 v =
              *reinterpret_cast<const float4*>(&sm.qs[kk][ty * TM + i]);
          a[i] = v.x;
          a[i + 1] = v.y;
          a[i + 2] = v.z;
          a[i + 3] = v.w;
        }
#pragma unroll
        for (int j = 0; j < TN; ++j) b[j] = sm.cs[kk][tx + j * COL_STRIDE];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();  // the next run() or slice may overwrite sm
    }
  }
};

}  // namespace tile
