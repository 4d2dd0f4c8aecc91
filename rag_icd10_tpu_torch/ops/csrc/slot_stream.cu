// Streaming weighted top-S per slot on Hopper (sm_90a): the candidate
// pass of the `streaming` search method.
//
// Replaces the TPU kernel rag_icd10_tpu/ops/pallas_score.py
// `_make_slot_stream_kernel` (launched by `streaming_candidates`). For each
// query b and each slot p of P, where slot p holds the corpus rows
// r = p, p + P, p + 2P, ... (row mod P, interleaved across the corpus so
// that neighbouring rows, which are sibling ICD codes that score alike,
// land in different slots), it keeps the S best weighted scores
//
//     s[b, r] = (sum_d q[b, d] * C[r, d]) * w[r] + mask[r]
//
// and writes them with their row ids, rank-major: cand[b, rank * P + p].
// bound[b, p] is the largest score of the slot that is not among its
// candidates (evicted or never admitted), -inf when the slot has no more
// than S rows. Every row outside the candidates therefore scores at most
// its slot's bound; the wrapper's certificate is top_k(cand)[k-1] >=
// max_p bound[b, p]. The (B, N) scores never reach device memory.
//
// Modes, as in fused_score.cu (K1): fp32 corpus exact (fmaf, the
// counterpart of Precision.HIGHEST); fp32 corpus with q and C rounded to
// bf16 (one bf16 pass); bf16 corpus with q rounded to bf16. Sums in fp32.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32 outside the tensor
// cores): bytes = N*D*sizeof(C) + B*P*(2S+1)*4, operations = 2*B*N*D.
// At N = 40,960, D = 768 the corpus read (126 MB fp32, 38 us) bounds small
// batches; at B = 256 the products (0.24 ms) do.
//
// Design. The TPU kernel carries its running top-S across a sequential
// grid in VMEM. Hopper blocks run in parallel and in no order, so each
// block owns 128 consecutive slots [128g, 128g + 128) for 8 queries over
// the whole corpus, and walks the corpus in steps of P rows: at each step
// it scores the 8 x 128 tile of rows base .. base + 127 (base = 128g + tP)
// with the shared register-tiled loop (tile_dot.cuh; one thread per
// slot, 8 queries each) and merges it into its state. The state, S values
// and S ids for each of the block's 8 x 128 (query, slot) pairs, lives in
// dynamic shared memory laid out [rank][query][slot] so a warp's accesses
// are conflict-free; each thread owns its slot's 8 lists and keeps each
// list's S-th value in a register, so a score that does not enter (the
// common case after the first steps) costs one compare and one max into
// the bound. An entering score evicts the S-th value into the bound and is
// placed by insertion. The wrapper picks P (a multiple of 128) from B, N
// and k so that enough blocks run while the P*S candidates stay a fraction
// of N; S is slot_depth(k) as in the JAX package, which with P >= 128
// slots is at least as safe as the TPU's 128 lane slots. Merging the
// blocks' candidates is the wrapper's one torch.topk over (B, P*S).

#include "tile_dot.cuh"

namespace {

constexpr int BM = 8;
constexpr int BN = 128;
constexpr int THREADS = 128;
constexpr int PAIRS = BM * BN;

template <typename TC>
__global__ void __launch_bounds__(THREADS)
    slot_stream_kernel(const float* __restrict__ q, const TC* __restrict__ c,
                       const float* __restrict__ w,
                       const float* __restrict__ mask,
                       float* __restrict__ cand_vals,
                       int* __restrict__ cand_ids,
                       float* __restrict__ bounds, int B, int N, int D, int P,
                       int S, int round_inputs) {
  using TD = tile::TileDot<BM, BN, BM, 1, THREADS, TC>;
  __shared__ typename TD::Smem sm;
  extern __shared__ float state[];  // vals[S][BM][BN], then ids[S][BM][BN]
  float* sv = state;
  int* si = reinterpret_cast<int*>(state + (size_t)S * PAIRS);

  const int tid = threadIdx.x;
  const int m_tiles = (B + BM - 1) / BM;
  const int m0 = (blockIdx.x % m_tiles) * BM;
  const int g = blockIdx.x / m_tiles;
  const int p = g * BN + tid;  // this thread's slot

  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int i = 0; i < BM; ++i) {
      sv[(s * BM + i) * BN + tid] = -INFINITY;
      si[(s * BM + i) * BN + tid] = -1;
    }
  float thr[BM], bnd[BM];
#pragma unroll
  for (int i = 0; i < BM; ++i) {
    thr[i] = -INFINITY;
    bnd[i] = -INFINITY;
  }

  for (int base = g * BN; base < N; base += P) {
    float acc[BM][1];
    TD::run(q, c, B, N, D, m0, base, round_inputs, sm, acc);
    const int row = base + tid;
    if (row >= N) continue;  // past the corpus: not a row of any slot
    const float wv = w[row];
    const float mv = mask[row];
#pragma unroll
    for (int i = 0; i < BM; ++i) {
      const float v = acc[i][0] * wv + mv;
      if (v > thr[i]) {
        float* vals = sv + i * BN + tid;  // rank s at vals[s * PAIRS]
        int* ids = si + i * BN + tid;
        bnd[i] = fmaxf(bnd[i], vals[(S - 1) * PAIRS]);
        int j = S - 1;
        while (j > 0 && vals[(j - 1) * PAIRS] < v) {
          vals[j * PAIRS] = vals[(j - 1) * PAIRS];
          ids[j * PAIRS] = ids[(j - 1) * PAIRS];
          --j;
        }
        vals[j * PAIRS] = v;
        ids[j * PAIRS] = row;
        thr[i] = vals[(S - 1) * PAIRS];
      } else {
        bnd[i] = fmaxf(bnd[i], v);
      }
    }
  }

  const size_t width = (size_t)P * S;
#pragma unroll
  for (int i = 0; i < BM; ++i) {
    const int b = m0 + i;
    if (b >= B) break;
    for (int s = 0; s < S; ++s) {
      cand_vals[b * width + (size_t)s * P + p] = sv[(s * BM + i) * BN + tid];
      cand_ids[b * width + (size_t)s * P + p] = si[(s * BM + i) * BN + tid];
    }
    bounds[(size_t)b * P + p] = bnd[i];
  }
}

template <typename TC>
int launch(const float* q, const TC* c, const float* w, const float* mask,
           float* cand_vals, int* cand_ids, float* bounds, int b, int n,
           int d, int p, int s, int round_inputs, cudaStream_t stream) {
  const size_t smem = (size_t)s * PAIRS * (sizeof(float) + sizeof(int));
  cudaError_t err = cudaFuncSetAttribute(
      slot_stream_kernel<TC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (long long)((b + BM - 1) / BM) * (p / BN);
  slot_stream_kernel<TC><<<(unsigned)blocks, THREADS, smem, stream>>>(
      q, c, w, mask, cand_vals, cand_ids, bounds, b, n, d, p, s,
      round_inputs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface for ctypes. q (b, d) fp32, c (n, d) fp32 or bf16, w and mask
// (n,) fp32; cand_vals and cand_ids (b, p*s) fp32 and int32, bounds (b, p)
// fp32. p % 128 == 0, 1 <= s <= 16, d % 8 == 0, all contiguous and 16-byte
// aligned (the wrapper checks). Launches on `stream`; returns a CUDA error
// code, 0 on success.
extern "C" int slot_stream_launch(const void* q, const void* c, const void* w,
                                  const void* mask, void* cand_vals,
                                  void* cand_ids, void* bounds, int b, int n,
                                  int d, int p, int s, int corpus_bf16,
                                  int round_inputs, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* wf = static_cast<const float*>(w);
  const float* mf = static_cast<const float*>(mask);
  float* vf = static_cast<float*>(cand_vals);
  int* vi = static_cast<int*>(cand_ids);
  float* bf = static_cast<float*>(bounds);
  if (corpus_bf16)
    return launch<__nv_bfloat16>(qf, static_cast<const __nv_bfloat16*>(c), wf,
                                 mf, vf, vi, bf, b, n, d, p, s, 1, st);
  return launch<float>(qf, static_cast<const float*>(c), wf, mf, vf, vi, bf,
                       b, n, d, p, s, round_inputs, st);
}
