// Fused level-weighted scoring on Hopper (sm_90a):
//
//     out[b, n] = (sum_d q[b, d] * C[n, d]) * w[n] + mask[n]      (fp32)
//
// Replaces the TPU kernel rag_icd10_tpu/ops/pallas_score.py
// `_make_score_kernel` (launched by `fused_weighted_scores`): the NT product
// over D with fp32 accumulation, the level weight and the padding mask fused
// into the epilogue, so the weighted (B, N) scores are written once and
// never re-read for a separate weighting pass.
//
// Modes (chosen by the wrapper, rag_icd10_tpu_torch/ops/fused_score.py):
//   fp32 corpus, round_inputs = 0   IEEE fp32 products and sums (fmaf), the
//                                   counterpart of Precision.HIGHEST;
//   fp32 corpus, round_inputs = 1   q and C rounded to bf16 on the way into
//                                   shared memory, fp32 sums: one bf16 pass
//                                   (Precision.DEFAULT, exact=False);
//   bf16 corpus (round_inputs = 1)  bf16 rows loaded 8 per 16-byte read, q
//                                   rounded to bf16 as the JAX kernel casts
//                                   it to the corpus dtype; fp32 sums.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32 outside the tensor
// cores) at the served shape N = 40,960 rows, D = 768:
//   bytes = N*D*4 (corpus, 126 MB) + B*N*4 (scores)  -> 38 us at B = 8;
//   ops   = 2*B*N*D                                  -> 0.24 ms at B = 256.
// A single /query (B <= 8) is bound by reading the corpus; a coalesced batch
// of 256 is bound by fp32 arithmetic.
//
// Design. One block computes a BM x BN tile of the output (BN = 128 corpus
// rows) and walks D in steps of BK = 32. Each step loads the query and
// corpus slices with 16-byte reads (a warp reads whole 128-byte corpus
// segments), stores them transposed into shared memory, and every thread
// accumulates a TM x TN register tile with fmaf. The next step's global
// loads are issued into registers before the current step's arithmetic, so
// memory latency overlaps compute. BM follows the batch (8, 32 or 64 rows)
// so a small batch does not pay for padding rows; blocks that share a
// corpus tile are adjacent in launch order, so a corpus tile read from HBM
// is re-read by the other row blocks from L2. Rows past B, columns past N
// and the D tail are masked or zero-filled in the kernel. Tensor cores
// (wgmma/TMA, or 3xTF32 for the fp32 modes) are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BK = 32;
constexpr int THREADS = 128;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Elements of type T in one 16-byte read, widened to fp32.
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

template <int BM, int BN, int TM, int TN, typename TC>
__global__ void __launch_bounds__(THREADS)
    fused_score_kernel(const float* __restrict__ q, const TC* __restrict__ c,
                       const float* __restrict__ w,
                       const float* __restrict__ mask,
                       float* __restrict__ out, int B, int N, int D,
                       int round_inputs) {
  static_assert((BM / TM) * (BN / TN) == THREADS, "tile/thread mismatch");
  static_assert(TM % 4 == 0, "query fragment is read as float4");
  constexpr int CV = Vec16<TC>::kElems;      // corpus elements per read
  constexpr int C_CHUNKS = BK / CV;          // reads per corpus row slice
  constexpr int C_READS = BN * C_CHUNKS / THREADS;
  static_assert(BN * C_CHUNKS % THREADS == 0, "corpus tile/thread mismatch");
  constexpr int Q_CHUNKS = BK / 4;           // fp32 query: 4 per read
  constexpr int Q_TOTAL = BM * Q_CHUNKS;
  constexpr int Q_READS = (Q_TOTAL + THREADS - 1) / THREADS;
  constexpr int COL_STRIDE = BN / TN;

  __shared__ __align__(16) float qs[BK][BM];
  __shared__ float cs[BK][BN + 1];  // +1: conflict-free transposed stores

  const int tid = threadIdx.x;
  const int m_tiles = (B + BM - 1) / BM;
  const int m0 = (blockIdx.x % m_tiles) * BM;
  const int n0 = (blockIdx.x / m_tiles) * BN;
  const int tx = tid % COL_STRIDE;
  const int ty = tid / COL_STRIDE;

  uint4 q_stage[Q_READS];
  uint4 c_stage[C_READS];

  // global -> registers for the slice [k0, k0 + BK) of D
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

  // registers -> shared memory, transposed to [k][row]
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
          qs[ch * 4 + e][r] = round_inputs ? round_bf16(f[e]) : f[e];
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
        cs[ch * CV + e][r] = round_inputs ? round_bf16(f[e]) : f[e];
    }
  };

  float acc[TM][TN];
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
        const float4 v = *reinterpret_cast<const float4*>(&qs[kk][ty * TM + i]);
        a[i] = v.x;
        a[i + 1] = v.y;
        a[i + 2] = v.z;
        a[i + 3] = v.w;
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = cs[kk][tx + j * COL_STRIDE];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: level weight and padding mask, coalesced along the corpus
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int col = n0 + tx + j * COL_STRIDE;
    if (col >= N) continue;
    const float wv = w[col];
    const float mv = mask[col];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = m0 + ty * TM + i;
      if (row < B) out[(size_t)row * N + col] = acc[i][j] * wv + mv;
    }
  }
}

template <int BM, int BN, int TM, int TN, typename TC>
void launch(const float* q, const TC* c, const float* w, const float* mask,
            float* out, int b, int n, int d, int round_inputs,
            cudaStream_t stream) {
  const long long blocks =
      (long long)((b + BM - 1) / BM) * (long long)((n + BN - 1) / BN);
  fused_score_kernel<BM, BN, TM, TN, TC><<<(unsigned)blocks, THREADS, 0,
                                           stream>>>(q, c, w, mask, out, b, n,
                                                     d, round_inputs);
}

template <typename TC>
void dispatch(const float* q, const TC* c, const float* w, const float* mask,
              float* out, int b, int n, int d, int round_inputs,
              cudaStream_t stream) {
  if (b <= 8)
    launch<8, 128, 8, 1, TC>(q, c, w, mask, out, b, n, d, round_inputs, stream);
  else if (b <= 32)
    launch<32, 128, 8, 4, TC>(q, c, w, mask, out, b, n, d, round_inputs,
                              stream);
  else
    launch<64, 128, 8, 8, TC>(q, c, w, mask, out, b, n, d, round_inputs,
                              stream);
}

}  // namespace

// C interface for ctypes. q (b, d) fp32, c (n, d) fp32 or bf16, w and mask
// (n,) fp32, out (b, n) fp32; all contiguous, 16-byte aligned, d % 8 == 0
// (the wrapper checks). Launches on `stream` and returns cudaGetLastError().
extern "C" int fused_score_launch(const void* q, const void* c, const void* w,
                                  const void* mask, void* out, int b, int n,
                                  int d, int corpus_bf16, int round_inputs,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* wf = static_cast<const float*>(w);
  const float* mf = static_cast<const float*>(mask);
  float* of = static_cast<float*>(out);
  if (corpus_bf16)
    dispatch<__nv_bfloat16>(qf, static_cast<const __nv_bfloat16*>(c), wf, mf,
                            of, b, n, d, 1, s);
  else
    dispatch<float>(qf, static_cast<const float*>(c), wf, mf, of, b, n, d,
                    round_inputs, s);
  return static_cast<int>(cudaGetLastError());
}
