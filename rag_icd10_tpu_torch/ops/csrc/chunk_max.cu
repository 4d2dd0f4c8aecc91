// Chunk maxima on Hopper (sm_90a): pass 1 of the `chunkstream` search
// method, reported as two kernels (K3: fp32 and bf16 stores; K4: int8).
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
// Arithmetic, by the stored dtype of F:
//   fp32  IEEE fp32 products and sums: Precision.HIGHEST;
//   bf16  q rounded to bf16 with __float2bfloat16_rn (the EPS_BF16_VEC term
//         of the certificate assumes round-to-nearest), bf16 x bf16 products
//         exact in fp32, fp32 sums: the TPU's one bf16 pass;
//   int8  each value widened exactly (|v| <= 127), times bf16(q), fp32
//         sums, then times the row's fp32 scale before the max.
//
// Bound on an H100 SXM (3.35 TB/s; 67 TFLOP/s fp32 outside the tensor
// cores, 989 TFLOP/s bf16 on them): bytes = N*D*itemsize (+ 4N scales) +
// B*(N/128)*4, operations = 2*B*N*D. At N = 40,960, D = 768 the corpus read
// takes 38 us (fp32), 19 us (bf16), 9.5 us (int8); at B = 256 the fp32
// products take 0.24 ms in SIMT, the bf16 products 16 us on tensor cores.
//
// Three paths; the wrapper's plan (chunk_stream.py `chunk_max_plan`) picks
// one for each (B, D, dtype) and passes it in:
//
// "stream" (fp32 up to B = 16, bf16 up to B = 2; int8 always takes "mma",
//   which is as fast from one query on): bound by the corpus read, so the
//   design keeps the card evenly loaded and many bytes in flight. The grid
//   is `blocks` (2 per SM where the shared memory allows:
//   __launch_bounds__(256, 2)); block i takes the
//   contiguous groups [i*G/blocks, (i+1)*G/blocks) of G = N/32 row groups,
//   so ranges differ by at most one group. The query block (<= 16 x D, fp32
//   or rounded to bf16) is staged in shared memory once; the plan sends a D
//   whose block would not fit to the large-batch path. Warp w takes rows
//   4w .. 4w+3 of every group, lane l the 16-byte piece l of each 512-byte
//   slice of those rows: the lane copies its 4 pieces of a slice with
//   cp.async into its own slots of a 4-stage ring and reads back only what
//   it copied, so the loop has no block barrier and warps run on their own
//   (48 KB in flight per block). Each query float4 read from shared memory
//   feeds 4 rows' fmaf, and the 32 lanes read 32 distinct pieces, swizzled
//   so that each quarter-warp hits distinct banks. At the end of a group
//   the 4 rows' dots are summed across the lanes by a transposing shuffle
//   reduction (8 shuffles per query), and their maximum goes into the
//   warp's running maximum of the chunk; at the end of a chunk (or of the
//   range) lane b merges query b's into the output with a float atomic max.
//   The entry point fills the output with 0xFF bytes first (atomicMax on
//   the int view for v >= 0, atomicMin on the unsigned view for v < 0;
//   0xFFFFFFFF loses to every float under both, and every chunk gets at
//   least one row), so chunks cut between blocks need no second pass.
//
// "mma" (bf16 above B = 2, int8 at every B): the products on the tensor cores,
//   mma.sync.m16n8k16 bf16 -> fp32. The queries are rounded to bf16 once,
//   into a zero-padded (B_pad, D_pad) scratch. A block of 4 warps computes
//   BM queries x one 128-row chunk, BM the smallest of 16, 32, 64, 128 that
//   holds the batch (a 16-query tile fits 4 blocks on an SM), so a small
//   batch re-reads few padded query rows. Each stage of the 3- or 4-deep
//   cp.async ring holds 64 bytes of every row of the chunk (32 bf16 or 64
//   int8 columns, the D tail zero-filled), and each copy asks L2 for the
//   row's next 256 bytes (.L2::256B), so the stages that follow hit L2. The
//   16 k-values of each mma are permuted so that a thread's A and B
//   fragments are 4 consecutive columns (one 8-byte load of bf16, one 4-byte
//   load of int8, widened exactly to bf16 between shared memory and the
//   fragment); row strides are padded so these loads are conflict-free.
//   Epilogue: times the row scale (int8), max over the chunk's columns in
//   the accumulator layout (quad shuffles, then shared memory across the
//   warps that share the queries), one value per (query, chunk). Blocks that share a chunk
//   are adjacent in launch order, so the other query tiles re-read it from
//   L2. Tensor-core accumulation may truncate: the certificate widens pass
//   1's accumulation term for this path (chunk_stream.py eps_tc_dot).
//
// "simt" (B > 16, fp32): K1's register-tiled loop (tile_dot.cuh), one
//   block per BM (32 or 64) queries x one chunk, the (B, N) scores kept in
//   registers, the maxima by warp shuffles and shared memory.

#include <atomic>
#include <type_traits>

#include "tile_dot.cuh"

namespace {

constexpr int CHUNK = 128;  // corpus rows per chunk
constexpr unsigned FULL = 0xffffffffu;

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

// Float max into memory filled with 0xFFFFFFFF (see "stream" above).
// signbit, not v < 0, so that -0.0 takes the unsigned view.
__device__ __forceinline__ void atomic_max_float(float* addr, float v) {
  if (!signbit(v))
    atomicMax(reinterpret_cast<int*>(addr), __float_as_int(v));
  else
    atomicMin(reinterpret_cast<unsigned*>(addr), __float_as_uint(v));
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

// Byte i of x (already XORed with 0x80: v + 128) as the exact float v:
// 2^23 + (v + 128) built in the bits, minus 2^23 + 128.
__device__ __forceinline__ float int8_byte(uint32_t x, int i) {
  return __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7650 | i)) -
         8388736.0f;
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
constexpr int GROUPS_PER_CHUNK = CHUNK / GROUP;

// Swizzle of the NV float4s of one query piece: 8 lanes reading pieces
// 8i .. 8i+7, float4 j, at slot (j + rot(p)) % NV of the piece, hit 8
// distinct 16-byte bank groups.
template <int NV>
__device__ __forceinline__ int rot(int piece) {
  if constexpr (NV == 1) return 0;
  else if constexpr (NV == 2) return (piece >> 2) & 1;
  else return (piece >> 1) & 3;
}

// Elements 4j .. 4j+3 of a 16-byte piece, widened exactly to fp32.
template <typename TC>
__device__ __forceinline__ void widen4(const uint4& v, int j, float (&f)[4]) {
  if constexpr (std::is_same_v<TC, float>) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  } else {
    const uint32_t w0 = j == 0 ? v.x : v.z, w1 = j == 0 ? v.y : v.w;
    f[0] = __uint_as_float(w0 << 16);  // bf16 bits are fp32's high half
    f[1] = __uint_as_float(w0 & 0xffff0000u);
    f[2] = __uint_as_float(w1 << 16);
    f[3] = __uint_as_float(w1 & 0xffff0000u);
  }
}

template <int BQ, typename TC>
__global__ void __launch_bounds__(THREADS, PER_SM)
    stream_kernel(const float* __restrict__ q, const TC* __restrict__ c,
                  float* __restrict__ out, int B, int N, int D, int blocks) {
  constexpr int CV = 16 / sizeof(TC);  // elements per piece
  constexpr int NV = CV / 4;           // query float4s per piece
  constexpr bool ROUND = !std::is_same_v<TC, float>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // each warp's ring [NST][ROWS][SLICE]; a lane reads only what it copied
  unsigned char* ring = smem + warp * NST * WARP_STAGE + lane * 16;
  float* qs = reinterpret_cast<float*>(smem + WARPS * NST * WARP_STAGE);  // [BQ][D]

  const int groups = N / GROUP;
  const int g0 = (int)((long long)blockIdx.x * groups / blocks);
  const int g1 = (int)((long long)(blockIdx.x + 1) * groups / blocks);
  const int nc = N / CHUNK;
  const size_t row_bytes = (size_t)D * sizeof(TC);
  const int ks = (int)((row_bytes + SLICE - 1) / SLICE);  // stages per group
  const int T = (g1 - g0) * ks;
  const unsigned char* cb = reinterpret_cast<const unsigned char*>(c) +
                            (size_t)warp * ROWS * row_bytes + lane * 16;

  // this lane's piece of its warp's ROWS rows of stage t
  auto issue = [&](int t) {
    const size_t off = (size_t)(t % ks) * SLICE;
    if (off + lane * 16 >= row_bytes) return;  // past D
    unsigned char* dst = ring + (t % NST) * WARP_STAGE;
    const unsigned char* src = cb + (size_t)(g0 + t / ks) * GROUP * row_bytes + off;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) cp_async16(dst + r * SLICE, src + r * row_bytes);
  };

#pragma unroll
  for (int t = 0; t < NST - 1; ++t) {
    if (t < T) issue(t);
    cp_async_commit();
  }
  // the query block, once (rows past B are zero)
  for (int i = tid; i < BQ * D; i += THREADS) {
    const int b = i / D, d = i % D;
    float v = b < B ? q[(size_t)b * D + d] : 0.0f;
    if (ROUND) v = tile::round_bf16(v);
    const int piece = d / CV, j = (d % CV) / 4;
    qs[b * D + piece * CV + ((j + rot<NV>(piece)) & (NV - 1)) * 4 + (d & 3)] = v;
  }
  __syncthreads();  // the only block-wide barrier: warps run on their own

  float acc[ROWS][BQ], best[BQ];
#pragma unroll
  for (int b = 0; b < BQ; ++b) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc[r][b] = 0.0f;
    best[b] = -INFINITY;
  }
  const bool up = lane & 16, hi = lane & 8;

  for (int t = 0; t < T; ++t) {
    cp_async_wait<NST - 2>();  // this lane's copies of stage t have landed
    const int s = t % ks;
    const int piece = s * 32 + lane;
    if ((size_t)piece * 16 < row_bytes) {
      const unsigned char* st = ring + (t % NST) * WARP_STAGE;
      uint4 v[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) v[r] = *reinterpret_cast<const uint4*>(st + r * SLICE);
      const float* qp = qs + piece * CV;
      const int sw = rot<NV>(piece);
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        float f[ROWS][4];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) widen4<TC>(v[r], j, f[r]);
        const float* qj = qp + ((j + sw) & (NV - 1)) * 4;
#pragma unroll
        for (int b = 0; b < BQ; ++b) {
          const float4 u = *reinterpret_cast<const float4*>(qj + b * D);
#pragma unroll
          for (int r = 0; r < ROWS; ++r) {
            acc[r][b] = fmaf(u.x, f[r][0], acc[r][b]);
            acc[r][b] = fmaf(u.y, f[r][1], acc[r][b]);
            acc[r][b] = fmaf(u.z, f[r][2], acc[r][b]);
            acc[r][b] = fmaf(u.w, f[r][3], acc[r][b]);
          }
        }
      }
    }
    // refill the slot read one iteration ago (its loads fed the fmaf above)
    if (t + NST - 1 < T) issue(t + NST - 1);
    cp_async_commit();
    if (s != ks - 1) continue;

    // The group's last slice: sum each row's 32 lane partials, transposing
    // as it goes: after xor 16 a lane keeps 2 of the 4 rows, after xor 8
    // one (row 2 * up + hi), then xor 4, 2, 1 finish it; then the max of
    // the 4 rows.
    const int g = g0 + t / ks;
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
      k = fmaxf(k, __shfl_xor_sync(FULL, k, 8));
      k = fmaxf(k, __shfl_xor_sync(FULL, k, 16));
      best[b] = fmaxf(best[b], k);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[r][b] = 0.0f;
    }
    if ((g + 1) % GROUPS_PER_CHUNK && g + 1 != g1) continue;

    // the chunk (or the range) ends: lane b merges query b's maximum over
    // this warp's rows of the chunk
    float v = best[0];
#pragma unroll
    for (int b = 1; b < BQ; ++b) v = lane == b ? best[b] : v;
    if (lane < B) atomic_max_float(out + (size_t)lane * nc + g / GROUPS_PER_CHUNK, v);
#pragma unroll
    for (int b = 0; b < BQ; ++b) best[b] = -INFINITY;
  }
}

// Shared memory of a block: the warps' rings, then the fp32 query block
// (chunk_stream.py STREAM_RING_BYTES; the plan checks that it fits).
template <int BQ, typename TC>
int launch(const float* q, const TC* c, float* out, int b, int n, int d,
           int blocks, cudaStream_t st) {
  static std::atomic<unsigned long long> allowed{0};
  const size_t smem =
      (size_t)WARPS * NST * WARP_STAGE + (size_t)BQ * d * sizeof(float);
  cudaError_t err = allow_smem(stream_kernel<BQ, TC>, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemsetAsync(out, 0xFF, (size_t)b * (n / CHUNK) * sizeof(float), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  stream_kernel<BQ, TC><<<blocks, THREADS, smem, st>>>(q, c, out, b, n, d, blocks);
  return static_cast<int>(cudaGetLastError());
}

// The query tiles the plan can reach: 1 to 16 queries of fp32, 1 or 2 of
// bf16 (larger bf16 batches take "mma").
template <typename TC>
constexpr int MAX_B = std::is_same_v<TC, float> ? 16 : 2;

template <typename TC>
int dispatch(const float* q, const TC* c, float* out, int b, int n, int d,
             int blocks, cudaStream_t st) {
  if (b <= 1) return launch<1, TC>(q, c, out, b, n, d, blocks, st);
  if constexpr (MAX_B<TC> == 2) {
    return launch<2, TC>(q, c, out, b, n, d, blocks, st);
  } else {
    if (b <= 2) return launch<2, TC>(q, c, out, b, n, d, blocks, st);
    if (b <= 4) return launch<4, TC>(q, c, out, b, n, d, blocks, st);
    if (b <= 8) return launch<8, TC>(q, c, out, b, n, d, blocks, st);
    return launch<16, TC>(q, c, out, b, n, d, blocks, st);
  }
}

}  // namespace stream

// ------------------------------------------------------------------ mma

namespace mma {

constexpr int THREADS = 128;  // 4 warps
constexpr int ROW_BYTES = 64;  // bytes of each corpus row per stage

// D columns per stage: 32 of bf16, 64 of int8.
template <typename TC>
__host__ __device__ constexpr int bk() {
  return ROW_BYTES / (int)sizeof(TC);
}

// Padded row strides in shared memory, which make the fragment loads
// conflict-free: a query row (bf16) 32 bytes past a multiple of 128, a
// corpus row 32 (bf16) or 16 (int8) bytes past one.
template <typename TC>
__host__ __device__ constexpr int a_ld() {
  return bk<TC>() * 2 + 32;
}
template <typename TC>
__host__ __device__ constexpr int b_ld() {
  return ROW_BYTES + (sizeof(TC) == 2 ? 32 : 16);
}

template <int BM, typename TC>
__host__ __device__ constexpr int stage_bytes() {
  return BM * a_ld<TC>() + CHUNK * b_ld<TC>();
}

// Ring depth: 4 stages, 3 where 4 would not leave two blocks an SM (6 to 8
// stages measured slower).
template <int BM, typename TC>
__host__ __device__ constexpr int ring_depth() {
  return 4 * stage_bytes<BM, TC>() <= 110 * 1024 ? 4 : 3;
}

// The 4 warps of a BM-query block: 2 along the queries x 2 along the
// chunk's rows for BM >= 64, else 1 x 4; blocks per SM as the shared
// memory of 4 stages allows.
template <int BM>
struct Layout {
  static constexpr int WARPS_M = BM >= 64 ? 2 : 1;
  static constexpr int WARPS_N = 4 / WARPS_M;
  static constexpr int WM = BM / WARPS_M;      // queries per warp
  static constexpr int WN = CHUNK / WARPS_N;   // rows per warp
  static constexpr int MT = WM / 16, NT = WN / 8;
  static constexpr int PER_SM = BM >= 64 ? 2 : BM == 32 ? 3 : 4;
};

// Rounds q to bf16 into the zero-padded (bp, dp) scratch.
__global__ void round_queries_kernel(const float* __restrict__ q,
                                     __nv_bfloat16* __restrict__ qb, int B,
                                     int D, int bp, int dp) {
  const size_t total = (size_t)bp * dp;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const int r = (int)(i / dp), k = (int)(i % dp);
    qb[i] = __float2bfloat16_rn(r < B && k < D ? q[(size_t)r * D + k] : 0.0f);
  }
}

// Four int8 (one word, lowest byte first) as two bf16x2 words, exactly.
__device__ __forceinline__ void int8x4_to_bf16x4(uint32_t w, uint32_t& lo,
                                                 uint32_t& hi) {
  const uint32_t x = w ^ 0x80808080u;
  const uint32_t f0 = __float_as_uint(int8_byte(x, 0));
  const uint32_t f1 = __float_as_uint(int8_byte(x, 1));
  const uint32_t f2 = __float_as_uint(int8_byte(x, 2));
  const uint32_t f3 = __float_as_uint(int8_byte(x, 3));
  // a small integer's bf16 is the high half of its fp32 bits
  lo = __byte_perm(f0, f1, 0x7632);
  hi = __byte_perm(f2, f3, 0x7632);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Fragment layout of m16n8k16 (g = lane / 4, t = lane % 4): A's a0/a2 hold
// row g at k = 2t, 2t+1 / 2t+8, 2t+9, a1/a3 the same for row g + 8; B's
// b0/b1 hold column g at k = 2t, 2t+1 / 2t+8, 2t+9; C's c0,c1 / c2,c3 are
// rows g / g + 8 at columns 2t, 2t+1. Taking the logical k-values
// {2t, 2t+1, 2t+8, 2t+9} from the physical columns 4t .. 4t+3, for A and B
// alike, leaves every dot unchanged and makes each fragment one load.
template <int BM, typename TC>
__global__ void __launch_bounds__(THREADS, Layout<BM>::PER_SM)
    mma_kernel(const __nv_bfloat16* __restrict__ qb, const TC* __restrict__ c,
               const float* __restrict__ scale, float* __restrict__ out, int B,
               int N, int D, int dp) {
  constexpr bool SCALED = std::is_same_v<TC, int8_t>;  // times the row scale
  constexpr int BK = bk<TC>(), NST = ring_depth<BM, TC>();
  constexpr int A_LD = a_ld<TC>(), B_LD = b_ld<TC>();
  constexpr int A_BYTES = BM * A_LD;
  constexpr int STAGE = stage_bytes<BM, TC>();
  using L = Layout<BM>;
  constexpr int WM = L::WM, WN = L::WN, MT = L::MT, NT = L::NT;
  constexpr int A_PER_ROW = BK * 2 / 16;
  constexpr int B_PER_ROW = BK * (int)sizeof(TC) / 16;
  constexpr int B_COPIES = CHUNK * B_PER_ROW / THREADS;
  constexpr int ELEMS = 16 / sizeof(TC);  // corpus elements per copy
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[L::WARPS_N][BM];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / L::WARPS_N, wn = warp % L::WARPS_N;
  const int g = lane >> 2, t4 = lane & 3;
  const int m_tiles = (B + BM - 1) / BM;
  const int m0 = (blockIdx.x % m_tiles) * BM;
  const int chunk = blockIdx.x / m_tiles;
  const int nc = N / CHUNK;
  const int k_steps = dp / BK;
  const unsigned char* qbase =
      reinterpret_cast<const unsigned char*>(qb + (size_t)m0 * dp);
  const unsigned char* cbase =
      reinterpret_cast<const unsigned char*>(c + (size_t)chunk * CHUNK * D);
  const size_t c_row = (size_t)D * sizeof(TC);

  auto issue = [&](int t) {
    unsigned char* st = smem + (t % NST) * STAGE;
    const int k0 = t * BK;
#pragma unroll
    for (int i = tid; i < BM * A_PER_ROW; i += THREADS) {
      const int r = i / A_PER_ROW, p = i % A_PER_ROW;
      cp_async16(st + r * A_LD + p * 16,
                 qbase + ((size_t)r * dp + k0) * 2 + p * 16);
    }
#pragma unroll
    for (int l = 0; l < B_COPIES; ++l) {
      const int i = tid + l * THREADS;
      const int r = i / B_PER_ROW, p = i % B_PER_ROW;
      const int k = k0 + p * ELEMS;
      const bool in = k < D;  // the D tail is zero-filled
      cp_async16(st + A_BYTES + r * B_LD + p * 16,
                 cbase + r * c_row + (in ? (size_t)k * sizeof(TC) : 0), in);
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
        uint32_t b0, b1;
        if constexpr (sizeof(TC) == 2) {
          const uint2 v =
              *reinterpret_cast<const uint2*>(Bs + r * B_LD + s * 32 + t4 * 8);
          b0 = v.x;
          b1 = v.y;
        } else {
          int8x4_to_bf16x4(
              *reinterpret_cast<const uint32_t*>(Bs + r * B_LD + s * 16 + t4 * 4),
              b0, b1);
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_bf16(acc[mt][nt], a[mt], b0, b1);
      }
    }
  }

  // epilogue: row scale, max over the chunk's columns, one value per query
  float sc[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    sc[nt][0] = sc[nt][1] = 1.0f;
    if constexpr (SCALED) {
      const float2 v = *reinterpret_cast<const float2*>(
          scale + (size_t)chunk * CHUNK + wn * WN + nt * 8 + 2 * t4);
      sc[nt][0] = v.x;
      sc[nt][1] = v.y;
    }
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    float lo = -INFINITY, hi = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float v[4] = {acc[mt][nt][0], acc[mt][nt][1], acc[mt][nt][2],
                    acc[mt][nt][3]};
      if constexpr (SCALED) {
        v[0] *= sc[nt][0];
        v[1] *= sc[nt][1];
        v[2] *= sc[nt][0];
        v[3] *= sc[nt][1];
      }
      lo = fmaxf(lo, fmaxf(v[0], v[1]));
      hi = fmaxf(hi, fmaxf(v[2], v[3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      lo = fmaxf(lo, __shfl_xor_sync(FULL, lo, off));
      hi = fmaxf(hi, __shfl_xor_sync(FULL, hi, off));
    }
    if (t4 == 0) {
      red[wn][wm * WM + mt * 16 + g] = lo;
      red[wn][wm * WM + mt * 16 + g + 8] = hi;
    }
  }
  __syncthreads();
  for (int r = tid; r < BM; r += THREADS)
    if (m0 + r < B) {
      float v = red[0][r];
#pragma unroll
      for (int w = 1; w < L::WARPS_N; ++w) v = fmaxf(v, red[w][r]);
      out[(size_t)(m0 + r) * nc + chunk] = v;
    }
}

template <int BM, typename TC>
int launch(const float* q, const TC* c, const float* scale, float* out,
           __nv_bfloat16* qb, int b, int n, int d, cudaStream_t st) {
  const int m_tiles = (b + BM - 1) / BM;
  const int bp = m_tiles * BM, dp = (d + 63) / 64 * 64;
  const int threads = 256;
  const long long want = ((long long)bp * dp + threads - 1) / threads;
  round_queries_kernel<<<(unsigned)(want < 1024 ? want : 1024), threads, 0, st>>>(
      q, qb, b, d, bp, dp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  static std::atomic<unsigned long long> allowed{0};
  const size_t smem = (size_t)ring_depth<BM, TC>() * stage_bytes<BM, TC>();
  err = allow_smem(mma_kernel<BM, TC>, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (long long)m_tiles * (n / CHUNK);
  mma_kernel<BM, TC><<<(unsigned)blocks, THREADS, smem, st>>>(
      qb, c, scale, out, b, n, d, dp);
  return static_cast<int>(cudaGetLastError());
}

template <typename TC>
int dispatch(int bm, const float* q, const TC* c, const float* scale,
             float* out, __nv_bfloat16* qb, int b, int n, int d,
             cudaStream_t st) {
  if (bm == 16) return launch<16, TC>(q, c, scale, out, qb, b, n, d, st);
  if (bm == 32) return launch<32, TC>(q, c, scale, out, qb, b, n, d, st);
  if (bm == 64) return launch<64, TC>(q, c, scale, out, qb, b, n, d, st);
  return launch<128, TC>(q, c, scale, out, qb, b, n, d, st);
}

}  // namespace mma

// ----------------------------------------------------------------- simt

namespace simt {

constexpr int THREADS = 128;

template <int BM, int TM, int TN>
__global__ void __launch_bounds__(THREADS)
    simt_kernel(const float* __restrict__ q, const float* __restrict__ c,
                float* __restrict__ out, int B, int N, int D) {
  using TD = tile::TileDot<BM, CHUNK, TM, TN, THREADS, float>;
  constexpr int COL_STRIDE = TD::COL_STRIDE;  // threads along a query row
  static_assert(COL_STRIDE <= 32, "a query row spans one warp");
  __shared__ typename TD::Smem sm;

  const int tid = threadIdx.x;
  const int m_tiles = (B + BM - 1) / BM;
  const int m0 = (blockIdx.x % m_tiles) * BM;
  const int chunk = blockIdx.x / m_tiles;
  const int n0 = chunk * CHUNK;
  const int nc = N / CHUNK;
  const int tx = tid % COL_STRIDE;
  const int ty = tid / COL_STRIDE;

  float acc[TM][TN];
  TD::run(q, c, B, N, D, m0, n0, 0, sm, acc);

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    float best = -INFINITY;
#pragma unroll
    for (int j = 0; j < TN; ++j) best = fmaxf(best, acc[i][j]);
#pragma unroll
    for (int off = COL_STRIDE / 2; off > 0; off >>= 1)
      best = fmaxf(best, __shfl_xor_sync(FULL, best, off));
    const int row = m0 + ty * TM + i;
    if (tx == 0 && row < B) out[(size_t)row * nc + chunk] = best;
  }
}

template <int BM, int TM, int TN>
int launch(const float* q, const float* c, float* out, int b, int n, int d,
           cudaStream_t st) {
  const long long blocks = (long long)((b + BM - 1) / BM) * (n / CHUNK);
  simt_kernel<BM, TM, TN><<<(unsigned)blocks, THREADS, 0, st>>>(q, c, out, b,
                                                                n, d);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const float* q, const float* c, float* out, int b, int n, int d,
             cudaStream_t st) {
  if (b <= 32) return launch<32, 8, 4>(q, c, out, b, n, d, st);
  return launch<64, 8, 8>(q, c, out, b, n, d, st);
}

}  // namespace simt

}  // namespace

// C interface for ctypes. q (b, d) fp32; c (n, d) fp32 (dtype 0), bf16
// (dtype 1) or int8 (dtype 2); scale (n,) fp32 for int8, else ignored;
// out (b, n / 128) fp32; n % 128 == 0; d % 16 == 0 for int8, d % 8 == 0
// otherwise; all contiguous and 16-byte aligned (the wrapper checks).
// path (the wrapper's plan): 0 "stream" (dtype 0 with b <= 16 or dtype 1
// with b <= 2, `blocks` row ranges, 1 <= blocks <= n / 32, the query block
// within the card's shared memory), 1 "mma" (dtype 1 or 2, bm 16, 32, 64 or 128,
// q_bf16 a (ceil(b / bm) * bm, ceil(d / 64) * 64) bf16 scratch), 2 "simt"
// (dtype 0).
// Launches on `stream`; returns a CUDA error code, 0 on success.
extern "C" int chunk_max_launch(const void* q, const void* c,
                                const void* scale, void* out, void* q_bf16,
                                int b, int n, int d, int dtype, int path,
                                int blocks, int bm, void* stream) {
  if (b < 1 || n < CHUNK || n % CHUNK || d < 1 || dtype < 0 || dtype > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* sf = static_cast<const float*>(scale);
  float* of = static_cast<float*>(out);
  const __nv_bfloat16* cb = static_cast<const __nv_bfloat16*>(c);
  const int8_t* ci = static_cast<const int8_t*>(c);
  switch (path) {
    case 0:
      if (blocks < 1 || blocks > n / stream::GROUP) break;
      if (dtype == 0 && b <= stream::MAX_B<float>)
        return stream::dispatch<float>(qf, static_cast<const float*>(c), of, b,
                                       n, d, blocks, st);
      if (dtype == 1 && b <= stream::MAX_B<__nv_bfloat16>)
        return stream::dispatch<__nv_bfloat16>(qf, cb, of, b, n, d, blocks, st);
      break;
    case 1: {
      if (dtype == 0 || (bm != 16 && bm != 32 && bm != 64 && bm != 128) ||
          q_bf16 == nullptr)
        break;
      __nv_bfloat16* qb = static_cast<__nv_bfloat16*>(q_bf16);
      if (dtype == 1)
        return mma::dispatch<__nv_bfloat16>(bm, qf, cb, sf, of, qb, b, n, d, st);
      return mma::dispatch<int8_t>(bm, qf, ci, sf, of, qb, b, n, d, st);
    }
    case 2:
      if (dtype != 0) break;
      return simt::dispatch(qf, static_cast<const float*>(c), of, b, n, d, st);
    default:
      break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
