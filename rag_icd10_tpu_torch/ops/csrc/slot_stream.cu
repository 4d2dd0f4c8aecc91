// Streaming weighted top-S per row range on Hopper (sm_90a): the candidate
// pass of the `streaming` search method.
//
// Replaces the TPU kernel rag_icd10_tpu/ops/pallas_score.py
// `_make_slot_stream_kernel` (launched by `streaming_candidates`). The
// corpus is cut into G contiguous ranges of R rows (R a whole number of
// 128-row tiles; range g holds rows [gR, min((g+1)R, N))). For each query b
// and range g it keeps the S best weighted scores
//
//     s[b, r] = (sum_d q[b, d] * C[r, d]) * w[r] + mask[r]
//
// with their row ids, descending, range-major: cand[b, g * S + rank]. An
// empty entry is (-inf, -1). bound[b, g] is the largest score of the range
// that is not among its candidates, -inf when the range has no more than S
// rows, so every row outside the candidates scores at most its range's
// bound; the wrapper's certificate is top_k(cand)[k-1] >= max_g bound[b, g].
// The (B, N) scores never reach device memory.
//
// Modes, as in fused_score.cu (K1): fp32 corpus exact (fmaf, the
// counterpart of Precision.HIGHEST); fp32 corpus with q and C rounded to
// bf16 (one bf16 pass); bf16 corpus with q rounded to bf16. Sums in fp32.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32 outside the tensor
// cores): bytes = N*D*sizeof(C) + B*G*(2S+1)*4, operations = 2*B*N*D.
// At N = 40,960, D = 768 the corpus read (126 MB fp32, 38 us) bounds small
// batches; at B = 256 the products (0.24 ms) do.
//
// Design. The grid is m_tiles x G blocks of 4 warps; block (i, g) scores
// queries [i*BM, i*BM + BM) against the tiles of range g one after another
// with the shared register-tiled loop (tile_dot.cuh): BM = 8 for small
// batches, BM = 32 above (the wrapper picks it), so a batch of 256 reads the
// corpus 8 times, not 32. The wrapper picks G so that the blocks fill two
// waves on 132 SMs while the G*S candidates stay within a quarter of N.
// After each tile the BM x 128 weighted scores go to shared memory, and
// each warp walks its BM/4 query rows (select_row): a lane compares its 4
// scores with the row's threshold (its list's S-th value), a rejected score
// only raises the lane's share of the bound, and the survivors (a ballot)
// are merged into the row's sorted list in shared memory in one warp-wide
// pass (merge_survivors: ranks by counting, the evicted values into the
// bound). After a range's first tile almost every score is rejected with
// one compare. The first tile admits up to 128 survivors: one pass per tile
// instead of one insertion per survivor halved K2 at S = 100, and for
// S <= 32 the S-th largest of the 32 lane maxima evicts most of them before
// the merge (PERF.md, PR 4). select_row is out of line: inlined, it changed
// how the tile loop was compiled and cost up to 30% at B = 256. The lists
// take BM*S*8 bytes (at most 32 KB) of dynamic shared memory, the score tile
// BM*128*4 bytes, so several blocks share an SM. One launch, no atomics;
// merging the ranges' candidates is the wrapper's one torch.topk over
// (B, G*S).

#include "tile_dot.cuh"

namespace {

constexpr int BN = 128;  // corpus rows per tile
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int TM = 8;         // query rows per thread in the tile loop
constexpr int MAX_S = 128;    // list depth: at most 4 entries per lane
constexpr unsigned FULL = 0xffffffffu;

// Merge one tile's survivors into one query row's descending list lv/li of
// S entries. Lane l holds the row's scores v[e] at columns 32e + l of the
// tile starting at row n0; enter[e] is the ballot of v[e] > lv[S-1]. All 32
// lanes of a warp call it together; sv/si is the warp's scratch of 128
// entries. Each survivor and each list entry gets its merged rank by
// counting: a list entry moves down by the survivors above it, a survivor
// sits after the survivors above it (column order among equals) and after
// the list entries >= it (binary search). Ranks below S form the new list;
// the rest, evicted, raise the lane's share `bnd` of the row's bound.
__device__ __forceinline__ void merge_survivors(float* lv, int* li, int S,
                                                const float (&v)[4],
                                                const unsigned (&enter)[4],
                                                int n0, float* sv, int* si,
                                                float& bnd, int lane) {
  int n = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (enter[e] >> lane & 1u) {
      const int at = n + __popc(enter[e] & ((1u << lane) - 1u));
      sv[at] = v[e];
      si[at] = n0 + e * 32 + lane;
    }
    n += __popc(enter[e]);
  }
  const int n4 = (n + 3) & ~3;
  if (lane < n4 - n) sv[n + lane] = -INFINITY;  // counts for nothing
  __syncwarp();
  const int xc = (n + 31) >> 5, yc = (S + 31) >> 5;  // chunks in use
  float x[MAX_S / 32], y[MAX_S / 32];  // survivor and list entry 32c + lane
  int xi[MAX_S / 32], yi[MAX_S / 32], rx[MAX_S / 32], ry[MAX_S / 32];
#pragma unroll
  for (int c = 0; c < MAX_S / 32; ++c) {
    const int j = c * 32 + lane;
    x[c] = j < n ? sv[j] : -INFINITY;
    xi[c] = j < n ? si[j] : -1;
    y[c] = j < S ? lv[j] : -INFINITY;
    yi[c] = j < S ? li[j] : -1;
    rx[c] = 0;
    ry[c] = j;
  }
  for (int i = 0; i < n4; i += 4) {
    const float4 q4 = *reinterpret_cast<const float4*>(sv + i);
    const float s4[4] = {q4.x, q4.y, q4.z, q4.w};
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int c = 0; c < MAX_S / 32; ++c) {
        if (c < xc)
          rx[c] += (s4[u] > x[c]) | ((s4[u] == x[c]) & (i + u < c * 32 + lane));
        if (c < yc) ry[c] += s4[u] > y[c];
      }
  }
#pragma unroll
  for (int c = 0; c < MAX_S / 32; ++c) {
    if (c * 32 + lane < n) {
      int lo = 0, hi = S;  // list entries >= x[c] (lv is descending)
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (lv[mid] >= x[c]) lo = mid + 1;
        else hi = mid;
      }
      rx[c] += lo;
    }
  }
  __syncwarp();  // every lane has read the old list
#pragma unroll
  for (int c = 0; c < MAX_S / 32; ++c) {
    if (c * 32 + lane < S) {
      if (ry[c] < S) {
        lv[ry[c]] = y[c];
        li[ry[c]] = yi[c];
      } else {
        bnd = fmaxf(bnd, y[c]);
      }
    }
    if (c * 32 + lane < n) {
      if (rx[c] < S) {
        lv[rx[c]] = x[c];
        li[rx[c]] = xi[c];
      } else {
        bnd = fmaxf(bnd, x[c]);
      }
    }
  }
  __syncwarp();
}

// One query row's selection over one tile of scores srow: compare with the
// list's S-th value, evict what cannot enter, merge the rest. lb holds the
// lanes' shares of the row's bound. Out of line, so that the kernel's tile
// loop is compiled on its own.
__device__ __noinline__ void select_row(const float* srow, float* lv, int* li,
                                        int S, float* lb, int n0, float* sv,
                                        int* si, int lane) {
  const float thr = lv[S - 1];
  float bnd = lb[lane];
  float v[4], top = -INFINITY;  // top: this lane's largest survivor
  bool pass[4];
  int n = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    v[e] = srow[e * 32 + lane];
    pass[e] = v[e] > thr;
    if (pass[e]) top = fmaxf(top, v[e]);
    else bnd = fmaxf(bnd, v[e]);
    n += __popc(__ballot_sync(FULL, pass[e]));
  }
  if (n > S && S <= 32) {
    // The S-th largest lane maximum t is at most the S-th largest survivor,
    // so a survivor below t has S survivors above it: evicted at once.
    int rank = 0;  // of this lane's maximum among the 32 (ties by lane)
#pragma unroll
    for (int l = 0; l < 32; ++l) {
      const float o = __shfl_sync(FULL, top, l);
      rank += (o > top) | ((o == top) & (l < lane));
    }
    const unsigned at = __ballot_sync(FULL, rank == S - 1);
    const float t = __shfl_sync(FULL, top, __ffs(at) - 1);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (pass[e] && v[e] < t) {
        pass[e] = false;
        bnd = fmaxf(bnd, v[e]);
      }
  }
  unsigned enter[4], any = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    enter[e] = __ballot_sync(FULL, pass[e]);
    any |= enter[e];
  }
  if (any) merge_survivors(lv, li, S, v, enter, n0, sv, si, bnd, lane);
  lb[lane] = bnd;
}

template <int BM, typename TC>
__global__ void __launch_bounds__(THREADS)
    range_topk_kernel(const float* __restrict__ q, const TC* __restrict__ c,
                      const float* __restrict__ w,
                      const float* __restrict__ mask,
                      float* __restrict__ cand_vals,
                      int* __restrict__ cand_ids, float* __restrict__ bounds,
                      int B, int N, int D, int G, int R, int S,
                      int round_inputs) {
  constexpr int TN = BM * BN / (THREADS * TM);  // 1 (BM 8) or 4 (BM 32)
  using TD = tile::TileDot<BM, BN, TM, TN, THREADS, TC>;
  __shared__ typename TD::Smem sm;
  __shared__ float sc[BM][BN];      // one tile's weighted scores
  __shared__ float lbnd[BM][32];    // per row: each lane's share of the bound
  __shared__ __align__(16) float msv[WARPS][BN];  // per warp: survivors
  __shared__ int msi[WARPS][BN];
  extern __shared__ float lists[];  // vals[BM][S], then ids[BM][S]
  float* lvals = lists;
  int* lids = reinterpret_cast<int*>(lists + BM * S);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int m_tiles = (B + BM - 1) / BM;
  const int m0 = (blockIdx.x % m_tiles) * BM;
  const int g = blockIdx.x / m_tiles;
  const int r_end = min((long long)g * R + R, (long long)N);

  for (int i = tid; i < BM * S; i += THREADS) {
    lvals[i] = -INFINITY;
    lids[i] = -1;
  }
  for (int i = tid; i < BM * 32; i += THREADS) lbnd[i / 32][i % 32] = -INFINITY;
  __syncthreads();

  const int tx = tid % TD::COL_STRIDE, ty = tid / TD::COL_STRIDE;
  for (int n0 = g * R; n0 < r_end; n0 += BN) {
    float acc[TM][TN];
    TD::run(q, c, B, N, D, m0, n0, round_inputs, sm, acc);
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = tx + j * TD::COL_STRIDE;
      const int row = n0 + col;
      const bool real = row < N;  // rows past N belong to no range
      const float wv = real ? w[row] : 0.0f;
      const float mv = real ? mask[row] : 0.0f;
#pragma unroll
      for (int i = 0; i < TM; ++i)
        sc[ty * TM + i][col] = real ? acc[i][j] * wv + mv : -INFINITY;
    }
    __syncthreads();
    for (int r = warp; r < BM && m0 + r < B; r += WARPS)  // rows past B: masked
      select_row(sc[r], lvals + r * S, lids + r * S, S, lbnd[r], n0, msv[warp],
                 msi[warp], lane);
    __syncthreads();  // the next tile's scores overwrite sc
  }

  const size_t width = (size_t)G * S;
  for (int r = warp; r < BM && m0 + r < B; r += WARPS) {
    const int b = m0 + r;
    float m = lbnd[r][lane];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(FULL, m, off));
    float* out_v = cand_vals + (size_t)b * width + (size_t)g * S;
    int* out_i = cand_ids + (size_t)b * width + (size_t)g * S;
    for (int s = lane; s < S; s += 32) {
      out_v[s] = lvals[r * S + s];
      out_i[s] = lids[r * S + s];
    }
    if (lane == 0) bounds[(size_t)b * G + g] = m;
  }
}

template <int BM, typename TC>
int launch(const float* q, const TC* c, const float* w, const float* mask,
           float* cand_vals, int* cand_ids, float* bounds, int b, int n,
           int d, int g, int r, int s, int round_inputs,
           cudaStream_t stream) {
  const size_t smem = (size_t)BM * s * (sizeof(float) + sizeof(int));
  cudaError_t err = cudaFuncSetAttribute(
      range_topk_kernel<BM, TC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (long long)((b + BM - 1) / BM) * g;
  range_topk_kernel<BM, TC><<<(unsigned)blocks, THREADS, smem, stream>>>(
      q, c, w, mask, cand_vals, cand_ids, bounds, b, n, d, g, r, s,
      round_inputs);
  return static_cast<int>(cudaGetLastError());
}

template <typename TC>
int launch_bm(int bm, const float* q, const TC* c, const float* w,
              const float* mask, float* cand_vals, int* cand_ids,
              float* bounds, int b, int n, int d, int g, int r, int s,
              int round_inputs, cudaStream_t stream) {
  if (bm == 8)
    return launch<8, TC>(q, c, w, mask, cand_vals, cand_ids, bounds, b, n, d,
                         g, r, s, round_inputs, stream);
  return launch<32, TC>(q, c, w, mask, cand_vals, cand_ids, bounds, b, n, d,
                        g, r, s, round_inputs, stream);
}

}  // namespace

// C interface for ctypes. q (b, d) fp32, c (n, d) fp32 or bf16, w and mask
// (n,) fp32; cand_vals and cand_ids (b, g*s) fp32 and int32, bounds (b, g)
// fp32. g ranges of r rows (r % 128 == 0, g*r >= n), 1 <= s <= 128,
// bm (queries per block) 8 or 32, d % 8 == 0, all contiguous and 16-byte
// aligned (the wrapper checks). Launches on `stream`; returns a CUDA error
// code, 0 on success.
extern "C" int slot_stream_launch(const void* q, const void* c, const void* w,
                                  const void* mask, void* cand_vals,
                                  void* cand_ids, void* bounds, int b, int n,
                                  int d, int g, int r, int s, int bm,
                                  int corpus_bf16, int round_inputs,
                                  void* stream) {
  if ((bm != 8 && bm != 32) || s < 1 || s > MAX_S || g < 1 || r < BN ||
      r % BN || (long long)g * r < n)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* wf = static_cast<const float*>(w);
  const float* mf = static_cast<const float*>(mask);
  float* vf = static_cast<float*>(cand_vals);
  int* vi = static_cast<int*>(cand_ids);
  float* bf = static_cast<float*>(bounds);
  if (corpus_bf16)
    return launch_bm<__nv_bfloat16>(bm, qf,
                                    static_cast<const __nv_bfloat16*>(c), wf,
                                    mf, vf, vi, bf, b, n, d, g, r, s, 1, st);
  return launch_bm<float>(bm, qf, static_cast<const float*>(c), wf, mf, vf,
                          vi, bf, b, n, d, g, r, s, round_inputs, st);
}
