// Chunk maxima on Hopper (sm_90a): pass 1 of the `chunkstream` search
// method, reported as two kernels (K3: fp32 and bf16 load paths; K4: int8).
//
//     cm[b, j] = max_{r in [128j, 128j + 128)} scale[r] * sum_d q[b, d] * F[r, d]
//
// over the weight-folded corpus F = C * diag(w), stored (N, D) row-major.
// Replaces the TPU kernels rag_icd10_tpu/ops/chunk_stream.py
// `_chunkmax_t_kernel` (K3) and `_chunkmax_t_scaled_kernel` (K4), launched
// by `chunk_maxima_transposed`. The TPU stores F transposed (D, N) and
// writes (N/128, B) only to satisfy Mosaic's layouts; here F keeps the
// row-major layout of K1 and the maxima are written (B, N/128) directly.
//
// Load paths (the stored dtype of F):
//   fp32   IEEE fp32 products and sums (fmaf): Precision.HIGHEST;
//   bf16   q rounded to bf16 with __float2bfloat16_rn (the EPS_BF16_VEC
//          term of the certificate assumes round-to-nearest), bf16 x bf16
//          products exact in fp32, fp32 sums: the TPU's one bf16 pass;
//   int8   each int8 value converted exactly, times bf16(q), fp32 sums,
//          then times the row's fp32 scale before the max (the TPU kernel
//          converts int8 to bf16, which is exact for |v| <= 127).
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32 outside the tensor
// cores): bytes = N*D*itemsize (+ 4N scales) + B*(N/128)*4, operations =
// 2*B*N*D. At N = 40,960, D = 768: 38 us (fp32), 19 us (bf16), 9.5 us
// (int8) of corpus reads for a small batch; 0.24 ms of fp32 products at
// B = 256. The kernel multiplies in SIMT fp32 for every load path, so the
// narrow stores save bytes but not arithmetic.
//
// Design. One block computes a BM x 128 tile, one 128-row chunk against BM
// queries, with the register-tiled loop of K1 (tile_dot.cuh), so the
// (B, N) scores stay in registers. The epilogue applies the int8 scale,
// takes each thread's max over its columns, then the max across the
// threads of a query row by warp shuffles (and shared memory where a row
// spans more than one warp), and writes one value per (query, chunk).
// BM follows the batch (8, 32 or 64 rows); blocks that share a chunk are
// adjacent in launch order so the other row blocks re-read it from L2.

#include "tile_dot.cuh"

namespace {

constexpr int BN = 128;  // one chunk
constexpr int THREADS = 128;

template <int BM, int TM, int TN, typename TC, bool SCALED>
__global__ void __launch_bounds__(THREADS)
    chunk_max_kernel(const float* __restrict__ q, const TC* __restrict__ c,
                     const float* __restrict__ scale, float* __restrict__ out,
                     int B, int N, int D, int round_inputs) {
  using TD = tile::TileDot<BM, BN, TM, TN, THREADS, TC>;
  constexpr int COL_STRIDE = TD::COL_STRIDE;
  constexpr int LANES = COL_STRIDE < 32 ? COL_STRIDE : 32;
  constexpr int ROW_WARPS = COL_STRIDE / LANES;  // warps spanned by a row
  __shared__ typename TD::Smem sm;
  __shared__ float red[ROW_WARPS][BM];

  const int tid = threadIdx.x;
  const int m_tiles = (B + BM - 1) / BM;
  const int m0 = (blockIdx.x % m_tiles) * BM;
  const int chunk = blockIdx.x / m_tiles;
  const int n0 = chunk * BN;
  const int nc = (N + BN - 1) / BN;
  const int tx = tid % COL_STRIDE;
  const int ty = tid / COL_STRIDE;

  float acc[TM][TN];
  TD::run(q, c, B, N, D, m0, n0, round_inputs, sm, acc);

  float best[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) best[i] = -INFINITY;
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int col = n0 + tx + j * COL_STRIDE;
    if (col >= N) continue;
    const float sc = SCALED ? scale[col] : 1.0f;
#pragma unroll
    for (int i = 0; i < TM; ++i)
      best[i] = fmaxf(best[i], SCALED ? acc[i][j] * sc : acc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int off = LANES / 2; off > 0; off >>= 1)
      best[i] = fmaxf(best[i], __shfl_xor_sync(0xffffffffu, best[i], off));

  if constexpr (ROW_WARPS == 1) {
    if (tx == 0)
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int row = m0 + ty * TM + i;
        if (row < B) out[(size_t)row * nc + chunk] = best[i];
      }
  } else {
    if (tx % 32 == 0)
#pragma unroll
      for (int i = 0; i < TM; ++i) red[tx / 32][ty * TM + i] = best[i];
    __syncthreads();
    if (tid < BM && m0 + tid < B) {
      float v = red[0][tid];
#pragma unroll
      for (int wi = 1; wi < ROW_WARPS; ++wi) v = fmaxf(v, red[wi][tid]);
      out[(size_t)(m0 + tid) * nc + chunk] = v;
    }
  }
}

template <int BM, int TM, int TN, typename TC, bool SCALED>
int launch(const float* q, const TC* c, const float* scale, float* out, int b,
           int n, int d, int round_inputs, cudaStream_t stream) {
  const long long blocks =
      (long long)((b + BM - 1) / BM) * (long long)((n + BN - 1) / BN);
  chunk_max_kernel<BM, TM, TN, TC, SCALED>
      <<<(unsigned)blocks, THREADS, 0, stream>>>(q, c, scale, out, b, n, d,
                                                 round_inputs);
  return static_cast<int>(cudaGetLastError());
}

template <typename TC, bool SCALED>
int dispatch(const float* q, const TC* c, const float* scale, float* out,
             int b, int n, int d, int round_inputs, cudaStream_t stream) {
  if (b <= 8)
    return launch<8, 8, 1, TC, SCALED>(q, c, scale, out, b, n, d,
                                       round_inputs, stream);
  if (b <= 32)
    return launch<32, 8, 4, TC, SCALED>(q, c, scale, out, b, n, d,
                                        round_inputs, stream);
  return launch<64, 8, 8, TC, SCALED>(q, c, scale, out, b, n, d, round_inputs,
                                      stream);
}

}  // namespace

// C interface for ctypes. q (b, d) fp32; c (n, d) fp32 (dtype 0), bf16
// (dtype 1) or int8 (dtype 2); scale (n,) fp32 for int8, else ignored;
// out (b, ceil(n / 128)) fp32. d % 16 == 0 for int8 and d % 8 == 0
// otherwise, all contiguous and 16-byte aligned (the wrapper checks).
// Launches on `stream`; returns a CUDA error code, 0 on success.
extern "C" int chunk_max_launch(const void* q, const void* c,
                                const void* scale, void* out, int b, int n,
                                int d, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* sf = static_cast<const float*>(scale);
  float* of = static_cast<float*>(out);
  switch (dtype) {
    case 0:
      return dispatch<float, false>(qf, static_cast<const float*>(c), sf, of,
                                    b, n, d, 0, st);
    case 1:
      return dispatch<__nv_bfloat16, false>(
          qf, static_cast<const __nv_bfloat16*>(c), sf, of, b, n, d, 1, st);
    case 2:
      return dispatch<int8_t, true>(qf, static_cast<const int8_t*>(c), sf, of,
                                    b, n, d, 1, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
