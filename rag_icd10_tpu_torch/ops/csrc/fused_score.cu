// Fused level-weighted scoring on Hopper (sm_90a), K1:
//
//     out[b, n] = (sum_d q[b, d] * C[n, d]) * w[n] + mask[n]      (fp32)
//
// Replaces the TPU kernel rag_icd10_tpu/ops/pallas_score.py
// `_make_score_kernel` (launched by `fused_weighted_scores`): the NT product
// over D with fp32 accumulation, the level weight and the padding mask fused
// into the epilogue, so the weighted (B, N) scores are written once and
// never re-read for a separate weighting pass. N and B need not be
// multiples of anything; D % 8 == 0.
//
// Arithmetic (the wrapper, rag_icd10_tpu_torch/ops/fused_score.py, picks it):
//   fp32 corpus, round_inputs = 0   IEEE fp32 products and sums (fmaf), the
//                                   counterpart of Precision.HIGHEST;
//   fp32 corpus, round_inputs = 1   q and C rounded to bf16 with
//                                   __float2bfloat16_rn as they are read,
//                                   fp32 sums: one bf16 pass
//                                   (Precision.DEFAULT, exact=False);
//   bf16 corpus (round_inputs = 1)  q rounded to bf16 as the JAX kernel
//                                   casts it to the corpus dtype; the exact
//                                   bf16 x bf16 products summed in fp32 on
//                                   the tensor cores.
//
// Bound on an H100 SXM (3.35 TB/s; 67 TFLOP/s fp32 outside the tensor
// cores, 989 TFLOP/s bf16 on them) at the served shape N = 40,960 rows,
// D = 768: bytes = N*D*itemsize (corpus) + B*N*4 (scores) + 8N (w, mask),
// operations = 2*B*N*D. The fp32 corpus read takes 38 us (B = 2: 0.0378 ms
// in all); the bf16 corpus read 19 us, and at B = 256 the 42 MB of scores
// 12.5 us more (0.0313 ms), against 16 us of bf16 products; fp32 products
// at B = 256 take 0.24 ms in SIMT.
//
// Three paths; the wrapper's plan (`fused_score_plan`) picks one for each
// (B, D, dtype) and passes it in:
//
// "stream" (fp32 corpus, B <= 16): bound by the corpus read, so the design
//   keeps the card evenly loaded and many bytes in flight. It is K3's
//   "stream" loop (chunk_max.cu) with a row-wise epilogue. The grid is
//   `blocks` (2 per SM where the shared memory allows:
//   __launch_bounds__(256, 2)); block i takes the contiguous 32-row groups
//   [i*G/blocks, (i+1)*G/blocks) of G = ceil(N/32), so ranges differ by at
//   most one group and every SM reads about the same bytes. The query block
//   (B padded to 1, 2, 4, 8 or 16 rows, fp32) is staged in shared memory
//   once; the plan sends a D whose block would not fit to "tile". Warp w
//   takes rows 4w .. 4w+3 of every group, lane l the 16-byte piece l of
//   each 512-byte slice of those rows: the lane copies its 4 pieces of a
//   slice with cp.async into its own slots of a 4-stage ring and reads back
//   only what it copied, so the loop has no block barrier and warps run on
//   their own (48 KB in flight per block). Rows past N are zero-filled,
//   never read. Each query float4 read from shared memory feeds 4 rows'
//   fmaf. At the end of a group the 4 rows' dots are summed across the
//   lanes by a transposing shuffle reduction (6 shuffles per query), after
//   which the 8 lanes of each quarter hold one row's dots; lane j writes
//   queries j and j + 8 of it, times w, plus mask. Each output is written by
//   one lane once: no atomics, no fill.
//
// "mma" (bf16 corpus, every B): the products on the tensor cores,
//   mma.sync.m16n8k16 bf16 -> fp32. The queries are rounded to bf16 once,
//   into a zero-padded (B_pad, D_pad) scratch. A block of 4 warps computes
//   BM queries x 128 corpus rows, BM the smallest of 16, 32, 64, 128 that
//   holds the batch, so a small batch pays for few padded query rows. Each
//   stage of the 3- or 4-deep cp.async ring holds 64 bytes (32 columns) of
//   every row of the tile, rows past N and the D tail zero-filled, and each
//   copy asks L2 for the row's next 256 bytes (.L2::256B), so the stages
//   that follow hit L2. The 16 k-values of each mma are permuted so that a
//   thread's A and B fragments are 4 consecutive columns (one 8-byte
//   load); row strides are padded so these loads are conflict-free.
//   Epilogue straight from the accumulator layout: times w, plus mask,
//   masked at B and N, two adjacent columns per 8-byte store. Blocks that
//   share a corpus tile are adjacent in launch order, so the other query
//   tiles re-read it from L2. The accumulator may truncate instead of
//   rounding: a score can differ from fp32 round-to-nearest sums by up to
//   eps_tc_dot(d) * ||q|| * ||c|| * w (chunk_stream.py; no certificate
//   reads K1's scores).
//
// "tile" (fp32 corpus, B > 16 or a query block too wide for "stream"): the
//   first version of this kernel, bound by SIMT fp32 at large B. One block
//   computes a BM x 128 tile of the output and walks D in steps of 32; each
//   step's slices go through registers into shared memory (transposed),
//   and every thread accumulates a TM x TN register tile with fmaf. BM
//   follows the batch (8, 32 or 64 rows); blocks that share a corpus tile
//   are adjacent in launch order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; with fill false the destination is zero-filled and
// nothing is read.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool fill = true) {
  asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem), "r"(fill ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// Lets `kernel` take as much dynamic shared memory as the card allows, once
// per device: `done` (one per kernel instantiation) holds a bit per device.
// The amount each launch takes is set at the launch.
template <typename K>
cudaError_t allow_smem(K* kernel, std::atomic<unsigned long long>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  const unsigned long long bit = 1ull << (dev & 63);
  if (err != cudaSuccess || (done.load(std::memory_order_acquire) & bit)) return err;
  int cap = 0;
  cudaFuncAttributes attr;
  err = cudaDeviceGetAttribute(&cap, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               cap - static_cast<int>(attr.sharedSizeBytes));
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

// --------------------------------------------------------------- stream

namespace stream {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int PER_SM = 2;               // resident blocks per SM
constexpr int GROUP = 32;               // rows per group
constexpr int ROWS = GROUP / WARPS;     // rows of a group per warp (and lane)
constexpr int SLICE = 32 * 16;          // bytes of a row per stage: a piece per lane
constexpr int NST = 4;                  // ring depth
constexpr int WARP_STAGE = ROWS * SLICE;  // 2 KB
constexpr int MAX_B = 16;

template <int BQ, bool ROUND>
__global__ void __launch_bounds__(THREADS, PER_SM)
    fused_score_stream_kernel(const float* __restrict__ q,
                              const float* __restrict__ c,
                              const float* __restrict__ w,
                              const float* __restrict__ mask,
                              float* __restrict__ out, int B, int N, int D,
                              int blocks) {
  static_assert(ROWS == 4, "the epilogue's shuffle transposes 4 rows");
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // each warp's ring [NST][ROWS][SLICE]; a lane reads only what it copied
  unsigned char* ring = smem + warp * NST * WARP_STAGE + lane * 16;
  float* qs = reinterpret_cast<float*>(smem + WARPS * NST * WARP_STAGE);  // [BQ][D]

  const int groups = (N + GROUP - 1) / GROUP;
  const int g0 = (int)((long long)blockIdx.x * groups / blocks);
  const int g1 = (int)((long long)(blockIdx.x + 1) * groups / blocks);
  const size_t row_bytes = (size_t)D * sizeof(float);
  const int ks = (int)((row_bytes + SLICE - 1) / SLICE);  // stages per group
  const int T = (g1 - g0) * ks;
  const unsigned char* cb = reinterpret_cast<const unsigned char*>(c);
  const int wrow = warp * ROWS;  // the warp's first row in a group

  // this lane's piece of its warp's ROWS rows of stage t; rows past N are
  // zero-filled
  auto issue = [&](int t) {
    const size_t off = (size_t)(t % ks) * SLICE + lane * 16;
    if (off >= row_bytes) return;  // past D
    unsigned char* dst = ring + (t % NST) * WARP_STAGE;
    const int row0 = (g0 + t / ks) * GROUP + wrow;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const bool in = row0 + r < N;
      cp_async16(dst + r * SLICE, in ? cb + (size_t)(row0 + r) * row_bytes + off : cb, in);
    }
  };

#pragma unroll
  for (int t = 0; t < NST - 1; ++t) {
    if (t < T) issue(t);
    cp_async_commit();
  }
  // the query block, once (rows past B are zero)
  for (int i = tid; i < BQ * D; i += THREADS) {
    float v = i < B * D ? q[i] : 0.0f;
    if (ROUND) v = round_bf16(v);
    qs[i] = v;
  }
  __syncthreads();  // the only block-wide barrier: warps run on their own

  float acc[ROWS][BQ];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int b = 0; b < BQ; ++b) acc[r][b] = 0.0f;
  const bool up = lane & 16, hi = lane & 8;
  // after the group's reduction this lane holds the dots of row 2*up + hi
  const int my_row = wrow + 2 * up + hi;
  float wv = 0.0f, mv = 0.0f;

  for (int t = 0; t < T; ++t) {
    cp_async_wait<NST - 2>();  // this lane's copies of stage t have landed
    const int s = t % ks;
    const int row = (g0 + t / ks) * GROUP + my_row;
    if (s == 0 && row < N) {  // the epilogue's operands, loaded early
      wv = __ldg(w + row);
      mv = __ldg(mask + row);
    }
    const int piece = s * 32 + lane;
    if ((size_t)piece * 16 < row_bytes) {
      const unsigned char* st = ring + (t % NST) * WARP_STAGE;
      float f[ROWS][4];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const uint4 v = *reinterpret_cast<const uint4*>(st + r * SLICE);
        f[r][0] = __uint_as_float(v.x);
        f[r][1] = __uint_as_float(v.y);
        f[r][2] = __uint_as_float(v.z);
        f[r][3] = __uint_as_float(v.w);
        if (ROUND) {
#pragma unroll
          for (int e = 0; e < 4; ++e) f[r][e] = round_bf16(f[r][e]);
        }
      }
      const float* qp = qs + piece * 4;
#pragma unroll
      for (int b = 0; b < BQ; ++b) {
        const float4 u = *reinterpret_cast<const float4*>(qp + b * D);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          acc[r][b] = fmaf(u.x, f[r][0], acc[r][b]);
          acc[r][b] = fmaf(u.y, f[r][1], acc[r][b]);
          acc[r][b] = fmaf(u.z, f[r][2], acc[r][b]);
          acc[r][b] = fmaf(u.w, f[r][3], acc[r][b]);
        }
      }
    }
    // refill the slot read one iteration ago (its loads fed the fmaf above)
    if (t + NST - 1 < T) issue(t + NST - 1);
    cp_async_commit();
    if (s != ks - 1) continue;

    // The group's last slice: sum each row's 32 lane partials, transposing
    // as it goes: after xor 16 a lane keeps 2 of the 4 rows, after xor 8
    // one (row 2 * up + hi), then xor 4, 2, 1 finish it. Lane j of each
    // quarter writes queries j and j + 8 of its row.
#pragma unroll
    for (int b = 0; b < BQ; ++b) {
      float k0 = up ? acc[2][b] : acc[0][b];
      float k1 = up ? acc[3][b] : acc[1][b];
      k0 += __shfl_xor_sync(FULL, up ? acc[0][b] : acc[2][b], 16);
      k1 += __shfl_xor_sync(FULL, up ? acc[1][b] : acc[3][b], 16);
      float k = hi ? k1 : k0;
      k += __shfl_xor_sync(FULL, hi ? k0 : k1, 8);
      k += __shfl_xor_sync(FULL, k, 4);
      k += __shfl_xor_sync(FULL, k, 2);
      k += __shfl_xor_sync(FULL, k, 1);
      if ((lane & 7) == (b & 7) && b < B && row < N)
        out[(size_t)b * N + row] = k * wv + mv;
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[r][b] = 0.0f;
    }
  }
}

// Shared memory of a block: the warps' rings, then the fp32 query block
// (fused_score.py STREAM_RING_BYTES; the plan checks that it fits).
template <int BQ, bool ROUND>
int launch(const float* q, const float* c, const float* w, const float* mask,
           float* out, int b, int n, int d, int blocks, cudaStream_t st) {
  static std::atomic<unsigned long long> allowed{0};
  const size_t smem =
      (size_t)WARPS * NST * WARP_STAGE + (size_t)BQ * d * sizeof(float);
  cudaError_t err = allow_smem(fused_score_stream_kernel<BQ, ROUND>, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_score_stream_kernel<BQ, ROUND><<<blocks, THREADS, smem, st>>>(
      q, c, w, mask, out, b, n, d, blocks);
  return static_cast<int>(cudaGetLastError());
}

template <bool ROUND>
int dispatch(const float* q, const float* c, const float* w, const float* mask,
             float* out, int b, int n, int d, int blocks, cudaStream_t st) {
  if (b <= 1) return launch<1, ROUND>(q, c, w, mask, out, b, n, d, blocks, st);
  if (b <= 2) return launch<2, ROUND>(q, c, w, mask, out, b, n, d, blocks, st);
  if (b <= 4) return launch<4, ROUND>(q, c, w, mask, out, b, n, d, blocks, st);
  if (b <= 8) return launch<8, ROUND>(q, c, w, mask, out, b, n, d, blocks, st);
  return launch<16, ROUND>(q, c, w, mask, out, b, n, d, blocks, st);
}

}  // namespace stream

// ------------------------------------------------------------------ mma

namespace mma {

constexpr int THREADS = 128;  // 4 warps
constexpr int BN = 128;       // corpus rows per block
constexpr int BK = 32;        // D columns per stage: 64 bytes of bf16
// Padded row strides in shared memory (bytes), which make the fragment
// loads conflict-free: 32 bytes past a multiple of 64.
constexpr int A_LD = BK * 2 + 32;
constexpr int B_LD = BK * 2 + 32;
constexpr int PER_ROW = BK * 2 / 16;  // 16-byte copies per row and stage

template <int BM>
__host__ __device__ constexpr int stage_bytes() {
  return BM * A_LD + BN * B_LD;
}

// Ring depth: 4 stages, 3 where 4 would not leave two blocks an SM.
template <int BM>
__host__ __device__ constexpr int ring_depth() {
  return 4 * stage_bytes<BM>() <= 110 * 1024 ? 4 : 3;
}

// The 4 warps of a BM-query block: 2 along the queries x 2 along the
// tile's rows for BM >= 64, else 1 x 4; blocks per SM as the shared
// memory of 4 stages allows.
template <int BM>
struct Layout {
  static constexpr int WARPS_M = BM >= 64 ? 2 : 1;
  static constexpr int WARPS_N = 4 / WARPS_M;
  static constexpr int WM = BM / WARPS_M;  // queries per warp
  static constexpr int WN = BN / WARPS_N;  // corpus rows per warp
  static constexpr int MT = WM / 16, NT = WN / 8;
  static constexpr int PER_SM = BM >= 64 ? 2 : BM == 32 ? 3 : 4;
};

// Rounds q to bf16 into the zero-padded (bp, dp) scratch.
__global__ void fused_score_round_queries_kernel(
    const float* __restrict__ q, __nv_bfloat16* __restrict__ qb, int B, int D,
    int bp, int dp) {
  const size_t total = (size_t)bp * dp;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const int r = (int)(i / dp), k = (int)(i % dp);
    qb[i] = __float2bfloat16_rn(r < B && k < D ? q[(size_t)r * D + k] : 0.0f);
  }
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two adjacent scores of one query row; one 8-byte store where both are in
// the corpus and the address is 8-byte aligned (N even, col even).
__device__ __forceinline__ void store2(float* out, int row, int col, int B,
                                       int N, float v0, float v1) {
  if (row >= B) return;
  float* p = out + (size_t)row * N + col;
  if (col + 1 < N && !(N & 1)) {
    *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
  } else {
    if (col < N) p[0] = v0;
    if (col + 1 < N) p[1] = v1;
  }
}

// Fragment layout of m16n8k16 (g = lane / 4, t = lane % 4): A's a0/a2 hold
// row g at k = 2t, 2t+1 / 2t+8, 2t+9, a1/a3 the same for row g + 8; B's
// b0/b1 hold column g at k = 2t, 2t+1 / 2t+8, 2t+9; C's c0,c1 / c2,c3 are
// rows g / g + 8 at columns 2t, 2t+1. Taking the logical k-values
// {2t, 2t+1, 2t+8, 2t+9} from the physical columns 4t .. 4t+3, for A and B
// alike, leaves every dot unchanged and makes each fragment one load.
template <int BM>
__global__ void __launch_bounds__(THREADS, Layout<BM>::PER_SM)
    fused_score_mma_kernel(const __nv_bfloat16* __restrict__ qb,
                           const __nv_bfloat16* __restrict__ c,
                           const float* __restrict__ w,
                           const float* __restrict__ mask,
                           float* __restrict__ out, int B, int N, int D,
                           int dp) {
  constexpr int NST = ring_depth<BM>();
  constexpr int A_BYTES = BM * A_LD;
  constexpr int STAGE = stage_bytes<BM>();
  using L = Layout<BM>;
  constexpr int WM = L::WM, WN = L::WN, MT = L::MT, NT = L::NT;
  constexpr int B_COPIES = BN * PER_ROW / THREADS;
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / L::WARPS_N, wn = warp % L::WARPS_N;
  const int g = lane >> 2, t4 = lane & 3;
  const int m_tiles = (B + BM - 1) / BM;
  const int m0 = (blockIdx.x % m_tiles) * BM;
  const int n0 = (blockIdx.x / m_tiles) * BN;
  const int k_steps = dp / BK;
  const unsigned char* qbase =
      reinterpret_cast<const unsigned char*>(qb + (size_t)m0 * dp);
  const unsigned char* cbase =
      reinterpret_cast<const unsigned char*>(c + (size_t)n0 * D);
  const size_t c_row = (size_t)D * 2;

  auto issue = [&](int t) {
    unsigned char* st = smem + (t % NST) * STAGE;
    const int k0 = t * BK;
#pragma unroll
    for (int i = tid; i < BM * PER_ROW; i += THREADS) {
      const int r = i / PER_ROW, p = i % PER_ROW;
      cp_async16(st + r * A_LD + p * 16, qbase + ((size_t)r * dp + k0) * 2 + p * 16);
    }
#pragma unroll
    for (int l = 0; l < B_COPIES; ++l) {
      const int i = tid + l * THREADS;
      const int r = i / PER_ROW, p = i % PER_ROW;
      const int k = k0 + p * 8;
      const bool in = k < D && n0 + r < N;  // the D tail and rows past N: zeros
      cp_async16(st + A_BYTES + r * B_LD + p * 16,
                 in ? cbase + r * c_row + (size_t)k * 2 : cbase, in);
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

#pragma unroll
  for (int t = 0; t < NST - 1; ++t) {
    if (t < k_steps) issue(t);
    cp_async_commit();
  }
  for (int t = 0; t < k_steps; ++t) {
    cp_async_wait<NST - 2>();
    __syncthreads();
    if (t + NST - 1 < k_steps) issue(t + NST - 1);
    cp_async_commit();
    const unsigned char* As = smem + (t % NST) * STAGE;
    const unsigned char* Bs = As + A_BYTES;
#pragma unroll
    for (int s = 0; s < BK / 16; ++s) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int r = wm * WM + mt * 16 + g;
        const uint2 lo =
            *reinterpret_cast<const uint2*>(As + r * A_LD + s * 32 + t4 * 8);
        const uint2 hi = *reinterpret_cast<const uint2*>(
            As + (r + 8) * A_LD + s * 32 + t4 * 8);
        a[mt][0] = lo.x;
        a[mt][1] = hi.x;
        a[mt][2] = lo.y;
        a[mt][3] = hi.y;
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int r = wn * WN + nt * 8 + g;
        const uint2 v =
            *reinterpret_cast<const uint2*>(Bs + r * B_LD + s * 32 + t4 * 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_bf16(acc[mt][nt], a[mt], v.x, v.y);
      }
    }
  }

  // epilogue: level weight and padding mask, straight from the accumulators
  float wc[NT][2], mc[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = n0 + wn * WN + nt * 8 + 2 * t4;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool in = col + e < N;
      wc[nt][e] = in ? __ldg(w + col + e) : 0.0f;
      mc[nt][e] = in ? __ldg(mask + col + e) : 0.0f;
    }
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int row = m0 + wm * WM + mt * 16 + g;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = n0 + wn * WN + nt * 8 + 2 * t4;
      store2(out, row, col, B, N, acc[mt][nt][0] * wc[nt][0] + mc[nt][0],
             acc[mt][nt][1] * wc[nt][1] + mc[nt][1]);
      store2(out, row + 8, col, B, N, acc[mt][nt][2] * wc[nt][0] + mc[nt][0],
             acc[mt][nt][3] * wc[nt][1] + mc[nt][1]);
    }
  }
}

template <int BM>
int launch(const float* q, const __nv_bfloat16* c, const float* w,
           const float* mask, float* out, __nv_bfloat16* qb, int b, int n,
           int d, cudaStream_t st) {
  const int m_tiles = (b + BM - 1) / BM;
  const int bp = m_tiles * BM, dp = (d + BK - 1) / BK * BK;
  const int threads = 256;
  const long long want = ((long long)bp * dp + threads - 1) / threads;
  fused_score_round_queries_kernel<<<(unsigned)(want < 1024 ? want : 1024),
                                     threads, 0, st>>>(q, qb, b, d, bp, dp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  static std::atomic<unsigned long long> allowed{0};
  const size_t smem = (size_t)ring_depth<BM>() * stage_bytes<BM>();
  err = allow_smem(fused_score_mma_kernel<BM>, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (long long)m_tiles * ((n + BN - 1) / BN);
  fused_score_mma_kernel<BM><<<(unsigned)blocks, THREADS, smem, st>>>(
      qb, c, w, mask, out, b, n, d, dp);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(int bm, const float* q, const __nv_bfloat16* c, const float* w,
             const float* mask, float* out, __nv_bfloat16* qb, int b, int n,
             int d, cudaStream_t st) {
  if (bm == 16) return launch<16>(q, c, w, mask, out, qb, b, n, d, st);
  if (bm == 32) return launch<32>(q, c, w, mask, out, qb, b, n, d, st);
  if (bm == 64) return launch<64>(q, c, w, mask, out, qb, b, n, d, st);
  return launch<128>(q, c, w, mask, out, qb, b, n, d, st);
}

}  // namespace mma

// ----------------------------------------------------------------- tile

namespace tile {

constexpr int BK = 32;
constexpr int THREADS = 128;

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

int dispatch(const float* q, const float* c, const float* w, const float* mask,
             float* out, int b, int n, int d, int round_inputs,
             cudaStream_t stream) {
  if (b <= 8)
    launch<8, 128, 8, 1, float>(q, c, w, mask, out, b, n, d, round_inputs, stream);
  else if (b <= 32)
    launch<32, 128, 8, 4, float>(q, c, w, mask, out, b, n, d, round_inputs,
                                 stream);
  else
    launch<64, 128, 8, 8, float>(q, c, w, mask, out, b, n, d, round_inputs,
                                 stream);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tile

}  // namespace

// C interface for ctypes. q (b, d) fp32; c (n, d) fp32 (corpus_bf16 0) or
// bf16 (1); w and mask (n,) fp32; out (b, n) fp32; all contiguous, 16-byte
// aligned, d % 8 == 0 (the wrapper checks). round_inputs: 1 for one bf16
// pass (always, over a bf16 corpus), 0 for IEEE fp32. path (the wrapper's
// plan): 0 "stream" (fp32 corpus, b <= 16, `blocks` row ranges,
// 1 <= blocks <= ceil(n / 32), the query block within the card's shared
// memory), 1 "mma" (bf16 corpus, bm 16, 32, 64 or 128, q_bf16 a
// (ceil(b / bm) * bm, ceil(d / 32) * 32) bf16 scratch), 2 "tile" (fp32
// corpus). Launches on `stream`; returns a CUDA error code, 0 on success.
extern "C" int fused_score_launch(const void* q, const void* c, const void* w,
                                  const void* mask, void* out, void* q_bf16,
                                  int b, int n, int d, int corpus_bf16,
                                  int round_inputs, int path, int blocks,
                                  int bm, void* stream) {
  if (b < 1 || n < 1 || d < 8 || d % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* cf = static_cast<const float*>(c);
  const float* wf = static_cast<const float*>(w);
  const float* mf = static_cast<const float*>(mask);
  float* of = static_cast<float*>(out);
  switch (path) {
    case 0:
      if (corpus_bf16 || b > stream::MAX_B || blocks < 1 ||
          blocks > (n + stream::GROUP - 1) / stream::GROUP)
        break;
      if (round_inputs)
        return stream::dispatch<true>(qf, cf, wf, mf, of, b, n, d, blocks, st);
      return stream::dispatch<false>(qf, cf, wf, mf, of, b, n, d, blocks, st);
    case 1:
      if (!corpus_bf16 || !round_inputs || q_bf16 == nullptr ||
          (bm != 16 && bm != 32 && bm != 64 && bm != 128))
        break;
      return mma::dispatch(bm, qf, static_cast<const __nv_bfloat16*>(c), wf, mf,
                           of, static_cast<__nv_bfloat16*>(q_bf16), b, n, d, st);
    case 2:
      if (corpus_bf16) break;
      return tile::dispatch(qf, cf, wf, mf, of, b, n, d, round_inputs, st);
    default:
      break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
