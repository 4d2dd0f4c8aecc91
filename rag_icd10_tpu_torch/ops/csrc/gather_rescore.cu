// Block gather + exact fp32 re-score on Hopper (sm_90a): pass 2 of the
// `chunkstream` search method (K5).
//
//     out[b, i*128 + r] = sum_d q[b, d] * C[ids[b, i]*128 + r, d]     (fp32)
//
// for each query b and each of its mc selected 128-row chunks i, over the
// raw (not weight-folded) fp32 corpus; weights and mask are applied by the
// caller. Replaces the TPU kernel rag_icd10_tpu/ops/chunk_stream.py
// `_make_rescore_kernel` (launched by `gather_rescore`). Its scalar
// prefetch of the chunk ids, its double-buffered DMAs, QB = 8 queries a
// grid step and its one-hot accumulate all serve Mosaic's layout rules;
// none of them carries over. Every product and sum is an IEEE fp32 fmaf
// (no TF32): the certificate takes pass-2 values as fp32 sums in any
// order (chunk_stream.py eps_fp32_dot). An id outside [0, N/128) writes
// NaN for its 128 scores.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32 outside the tensor
// cores): bytes = the distinct chunks the batch selected (at most N*D*4)
// + B*D*4 + B*mc*128*4 written; operations = 2*B*mc*128*D. A chunk is
// 128 x 768 fp32 = 384 KB. A small batch is bound by the chunks it reads
// (B = 2, mc = 40: 26 MB, 8 us); a large one shares chunks between
// queries and is bound by the products (B = 256, mc = 200 on 40,960
// rows: 10 GFLOP, 0.15 ms), so a chunk must be read once for many queries.
//
// Two paths; the wrapper's plan (chunk_stream.py `rescore_plan`) picks one
// and passes it in: "grouped" where grouping the pairs by chunk saves
// enough chunk reads (RESCORE_GROUPED_MIN_SAVED, measured), else "pairs".
//
// "pairs" (few shared chunks): one block for each (pair (b, i), group of
//   8, 16 or 32 of the chunk's rows), so that even a few pairs give the card more
//   blocks than it has SMs (the plan takes the largest group that gives
//   two blocks per SM). Warp w of a block takes rows 4w .. 4w+3 of the
//   group; lane l copies the 16-byte piece l of each 512-byte slice of
//   those rows with cp.async into its own slots of a 4-stage ring and
//   reads back only what it copied, so the warps run without a block
//   barrier (chunk_max.cu's "stream" ring, 6 KB in flight per warp). The
//   query row sits in shared memory. Each lane sums its pieces' products
//   for the 4 rows; a transposing shuffle reduction gives lanes 0, 8, 16
//   and 24 one row's dot each.
//
// "grouped" (where queries share chunks): the pairs are grouped by chunk,
//   so that a block reads a chunk once for up to QT = 32 of its queries.
//   1. count_kernel, one pair per thread: a histogram of the B*mc pairs'
//      chunk ids (per block in shared memory where nc <= LOCAL_CHUNKS,
//      merged with one global atomic per chunk and block; else global
//      atomics). The last block to finish scans the counts into the tile
//      list (each chunk's pairs cut into tiles of at most QT: one (chunk,
//      first pair, count) descriptor each), their number, and each
//      chunk's scatter cursor. Pairs with an id out of range are not
//      grouped: it writes their NaNs.
//   2. scatter_kernel, one pair per thread: each pair to its chunk's run
//      of the sorted list (a counting sort; the order within a run does
//      not matter).
//   3. tile_kernel, two blocks of 64 threads per tile, each taking 64 of
//      the chunk's rows (twice the blocks, so that a batch with few tiles
//      still keeps many bytes in flight); the grid is twice the host's
//      upper bound on the tiles, ceil(B*mc / QT) + min(nc, B*mc), and the
//      surplus blocks exit, so the host never waits. A block streams its
//      64 rows and the tile's gathered query rows through shared memory
//      in 32-column slices, a 3-stage cp.async ring, into a register tile
//      of 8 queries x 4 rows per thread (K1's "tile" shape), where a warp
//      whose queries are all past the tile's count skips the products; a
//      tile of at most 8 queries (most tiles where few queries share a
//      chunk) gives each thread one row for all of them instead, so that
//      both warps work. Row strides are padded to 36 floats, so the float4
//      reads of 8 consecutive rows hit distinct banks and the query reads
//      are broadcasts. Each output is written once, by one thread,
//      whatever order the scatter left the pairs in.
//   A single-block sort was tried first: its shared-memory atomics
//   serialized on one SM, a sixth of the time at B = 256, mc = 200
//   (PERF.md).

#include <atomic>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int CHUNK = 128;  // corpus rows per chunk
constexpr unsigned FULL = 0xffffffffu;

// 16-byte async copy; with fill false the destination is zero-filled and
// nothing is read.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool fill = true) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
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

// ---------------------------------------------------------------- pairs

namespace pairs {

constexpr int ROWS = 4;                   // rows per warp
constexpr int SLICE = 32 * 16;            // bytes of a row per stage: a piece per lane
constexpr int NST = 4;                    // ring depth
constexpr int WARP_STAGE = ROWS * SLICE;  // 2 KB

template <int WARPS>
__global__ void __launch_bounds__(WARPS * 32)
    pairs_kernel(const float* __restrict__ q, const float* __restrict__ c,
                 const int* __restrict__ ids, float* __restrict__ out, int nc,
                 int D, int mc) {
  constexpr int THREADS = WARPS * 32;
  constexpr int GROUP = WARPS * ROWS;   // rows of the chunk per block
  constexpr int GROUPS = CHUNK / GROUP;  // blocks per pair
  extern __shared__ __align__(16) unsigned char pairs_smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long pair = blockIdx.x / GROUPS;  // b * mc + i
  const int g = blockIdx.x % GROUPS;
  float* o = out + (size_t)pair * CHUNK + g * GROUP;
  const int cid = ids[pair];
  if (cid < 0 || cid >= nc) {  // uniform across the block
    if (tid < GROUP) o[tid] = NAN;
    return;
  }
  unsigned char* ring = pairs_smem + warp * NST * WARP_STAGE + lane * 16;
  float* qs = reinterpret_cast<float*>(pairs_smem + WARPS * NST * WARP_STAGE);  // [D]
  const size_t row_bytes = (size_t)D * sizeof(float);
  const int T = (int)((row_bytes + SLICE - 1) / SLICE);  // stages
  const unsigned char* src =
      reinterpret_cast<const unsigned char*>(
          c + ((size_t)cid * CHUNK + g * GROUP + warp * ROWS) * D) +
      lane * 16;

  // this lane's piece of its warp's ROWS rows of stage t
  auto issue = [&](int t) {
    const size_t off = (size_t)t * SLICE;
    if (off + lane * 16 >= row_bytes) return;  // past D
    unsigned char* dst = ring + (t % NST) * WARP_STAGE;
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
      cp_async16(dst + r * SLICE, src + off + r * row_bytes);
  };

#pragma unroll
  for (int t = 0; t < NST - 1; ++t) {
    if (t < T) issue(t);
    cp_async_commit();
  }
  const float4* qg = reinterpret_cast<const float4*>(q + (size_t)(pair / mc) * D);
  for (int i = tid; i < D / 4; i += THREADS) reinterpret_cast<float4*>(qs)[i] = qg[i];
  __syncthreads();  // the only block-wide barrier: warps run on their own

  float acc[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) acc[r] = 0.0f;
  for (int t = 0; t < T; ++t) {
    cp_async_wait<NST - 2>();  // this lane's copies of stage t have landed
    const int piece = t * 32 + lane;
    if ((size_t)piece * 16 < row_bytes) {
      const unsigned char* st = ring + (t % NST) * WARP_STAGE;
      const float4 u = reinterpret_cast<const float4*>(qs)[piece];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float4 v = *reinterpret_cast<const float4*>(st + r * SLICE);
        acc[r] = fmaf(u.x, v.x, acc[r]);
        acc[r] = fmaf(u.y, v.y, acc[r]);
        acc[r] = fmaf(u.z, v.z, acc[r]);
        acc[r] = fmaf(u.w, v.w, acc[r]);
      }
    }
    // refill the slot read one iteration ago (its loads fed the fmaf above)
    if (t + NST - 1 < T) issue(t + NST - 1);
    cp_async_commit();
  }

  // Sum each row's 32 lane partials, transposing as it goes: after xor 16
  // a lane keeps 2 of the 4 rows, after xor 8 one (row 2 * up + hi), then
  // xor 4, 2, 1 finish it.
  const bool up = lane & 16, hi = lane & 8;
  float k0 = up ? acc[2] : acc[0];
  float k1 = up ? acc[3] : acc[1];
  k0 += __shfl_xor_sync(FULL, up ? acc[0] : acc[2], 16);
  k1 += __shfl_xor_sync(FULL, up ? acc[1] : acc[3], 16);
  float k = hi ? k1 : k0;
  k += __shfl_xor_sync(FULL, hi ? k0 : k1, 8);
  k += __shfl_xor_sync(FULL, k, 4);
  k += __shfl_xor_sync(FULL, k, 2);
  k += __shfl_xor_sync(FULL, k, 1);
  if ((lane & 7) == 0) o[warp * ROWS + 2 * up + hi] = k;
}

// Shared memory of a block: the warps' rings, then the query row
// (chunk_stream.py `_pairs_smem`; the plan checks that it fits).
template <int WARPS>
int launch(const float* q, const float* c, const int* ids, float* out,
           long long pairs, int nc, int d, int mc, cudaStream_t st) {
  static std::atomic<unsigned long long> allowed{0};
  const size_t smem = (size_t)WARPS * NST * WARP_STAGE + (size_t)d * sizeof(float);
  const long long blocks = pairs * (CHUNK / (WARPS * ROWS));
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(pairs_kernel<WARPS>, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  pairs_kernel<WARPS><<<(unsigned)blocks, WARPS * 32, smem, st>>>(q, c, ids, out,
                                                                  nc, d, mc);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(int group_rows, const float* q, const float* c, const int* ids,
             float* out, long long pairs, int nc, int d, int mc,
             cudaStream_t st) {
  if (group_rows == 8) return launch<2>(q, c, ids, out, pairs, nc, d, mc, st);
  if (group_rows == 16) return launch<4>(q, c, ids, out, pairs, nc, d, mc, st);
  if (group_rows == 32) return launch<8>(q, c, ids, out, pairs, nc, d, mc, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace pairs

// -------------------------------------------------------------- grouped

namespace grouped {

constexpr int SORT_THREADS = 1024;  // pairs per block of the count and scatter kernels
constexpr int SORT_WARPS = SORT_THREADS / 32;
constexpr int LOCAL_CHUNKS = 8192;  // a block's histogram in shared memory up to this nc
constexpr int THREADS = 64;         // threads of a tile block
constexpr int ROWS = 64;            // rows of the chunk per tile block: two blocks a tile
constexpr int QT = 32;              // queries per tile
constexpr int TN = 4;               // rows per thread
constexpr int NST = 3;              // ring depth
constexpr int BK = 32;              // D columns per slice
constexpr int LD = BK + 4;          // padded row stride in shared memory (floats)
constexpr int PIECES = BK / 4;      // 16-byte pieces of a row slice

// The most tiles `pairs` pairs over nc chunks can make (the tile grid).
inline long long tile_bound(long long pairs, int nc) {
  return (pairs + QT - 1) / QT + (nc < pairs ? nc : pairs);
}

// Histogram of the pairs' chunk ids into `counts` (zeroed by the caller),
// one pair per thread: through a histogram of the block's pairs in shared
// memory where nc <= LOCAL_CHUNKS (one global atomic per chunk and block),
// else by global atomics. Pairs out of range write their NaNs here and are
// dropped. The last block to finish turns the counts into the tile list
// and scatter cursors: an exclusive scan of (pairs, tiles) over the chunks,
// thread t taking the contiguous chunks [t * seg, (t + 1) * seg).
__global__ void __launch_bounds__(SORT_THREADS)
    count_kernel(const int* __restrict__ ids, float* __restrict__ out, int P,
                 int nc, int4* __restrict__ tiles, int* __restrict__ counts,
                 int* __restrict__ done, int* __restrict__ ntiles) {
  __shared__ int local[LOCAL_CHUNKS];
  __shared__ int2 warp_sums[SORT_WARPS];
  __shared__ bool last;
  const bool shared_hist = nc <= LOCAL_CHUNKS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (shared_hist) {
    for (int i = tid; i < nc; i += SORT_THREADS) local[i] = 0;
    __syncthreads();
  }
  const int p = blockIdx.x * SORT_THREADS + tid;
  if (p < P) {
    const int id = ids[p];
    if (id >= 0 && id < nc) {
      atomicAdd(shared_hist ? &local[id] : &counts[id], 1);
    } else {
      float* o = out + (size_t)p * CHUNK;
      for (int r = 0; r < CHUNK; ++r) o[r] = NAN;
    }
  }
  if (shared_hist) {
    __syncthreads();
    for (int i = tid; i < nc; i += SORT_THREADS)
      if (local[i]) atomicAdd(&counts[i], local[i]);
  }
  __threadfence();  // this block's counts reach L2 before `done` counts it
  __syncthreads();
  if (tid == 0) last = atomicAdd(done, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!last) return;

  // the counts from L2 (other blocks' atomics), into shared memory where
  // they fit: coalesced, every load in flight at once
  if (shared_hist) {
    for (int i = tid; i < nc; i += SORT_THREADS) local[i] = __ldcg(counts + i);
    __syncthreads();
  }
  auto count = [&](int i) { return shared_hist ? local[i] : __ldcg(counts + i); };
  const int seg = (nc + SORT_THREADS - 1) / SORT_THREADS;
  const int c0 = min(tid * seg, nc), c1 = min(c0 + seg, nc);
  int np = 0, nt = 0;
  for (int i = c0; i < c1; ++i) {
    const int n = count(i);
    np += n;
    nt += (n + QT - 1) / QT;
  }
  int ip = np, it = nt;  // inclusive within the warp
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int a = __shfl_up_sync(FULL, ip, off), b = __shfl_up_sync(FULL, it, off);
    if (lane >= off) {
      ip += a;
      it += b;
    }
  }
  if (lane == 31) warp_sums[warp] = make_int2(ip, it);
  __syncthreads();
  if (warp == 0) {
    int2 v = warp_sums[lane];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int a = __shfl_up_sync(FULL, v.x, off), b = __shfl_up_sync(FULL, v.y, off);
      if (lane >= off) {
        v.x += a;
        v.y += b;
      }
    }
    warp_sums[lane] = v;
  }
  __syncthreads();
  int pos = ip - np + (warp ? warp_sums[warp - 1].x : 0);
  int tile = it - nt + (warp ? warp_sums[warp - 1].y : 0);
  if (tid == SORT_THREADS - 1) *ntiles = tile + nt;
  // the tiles of each chunk, and its counter becomes its scatter cursor
  for (int i = c0; i < c1; ++i) {
    const int n = count(i);
    for (int j = 0; j < n; j += QT) tiles[tile++] = make_int4(i, pos + j, min(QT, n - j), 0);
    counts[i] = pos;
    pos += n;
  }
}

// Each pair into its chunk's run of the sorted list, one pair per thread.
__global__ void __launch_bounds__(SORT_THREADS)
    scatter_kernel(const int* __restrict__ ids, int P, int nc,
                   int* __restrict__ cursors, int* __restrict__ sorted) {
  const int p = blockIdx.x * SORT_THREADS + threadIdx.x;
  if (p >= P) return;
  const int id = ids[p];
  if (id >= 0 && id < nc) sorted[atomicAdd(&cursors[id], 1)] = p;
}

__global__ void __launch_bounds__(THREADS)
    tile_kernel(const float* __restrict__ q, const float* __restrict__ c,
                const int* __restrict__ sorted, const int4* __restrict__ tiles,
                const int* __restrict__ ntiles, float* __restrict__ out, int D,
                int mc) {
  constexpr int CS = ROWS / TN;          // threads along the rows
  constexpr int TM = QT * CS / THREADS;  // queries per thread
  constexpr int STAGE = (ROWS + QT) * LD;
  constexpr int C_COPIES = ROWS * PIECES / THREADS;
  constexpr int Q_COPIES = QT * PIECES / THREADS;
  constexpr int COPY_ROWS = THREADS / PIECES;  // rows one round of copies covers
  static_assert(TM == 8 && THREADS % PIECES == 0 && THREADS == ROWS, "tile/thread mismatch");
  extern __shared__ __align__(16) float tile_smem[];  // [NST][ROWS + QT][LD]
  __shared__ int pid[QT];

  if ((int)(blockIdx.x / 2) >= *ntiles) return;  // surplus block of the bound
  const int4 tile = tiles[blockIdx.x / 2];       // chunk, first sorted pair, count
  const int row0 = (blockIdx.x % 2) * ROWS;      // this block's half of the chunk
  const int tid = threadIdx.x, tx = tid % CS, ty = tid / CS;
  if (tid < QT) pid[tid] = tid < tile.z ? sorted[tile.y + tid] : -1;
  __syncthreads();

  const int piece = tid % PIECES, r0 = tid / PIECES;
  const float* crow = c + ((size_t)tile.x * CHUNK + row0 + r0) * D;
  const float* qrow[Q_COPIES];
  bool qok[Q_COPIES];
#pragma unroll
  for (int l = 0; l < Q_COPIES; ++l) {
    const int p = pid[r0 + l * COPY_ROWS];
    qok[l] = p >= 0;
    qrow[l] = q + (size_t)(qok[l] ? p / mc : 0) * D;
  }
  auto load = [&](int s, int stage) {
    const int k = s * BK + piece * 4;
    const bool in = k < D;  // the D tail is zero-filled, its source unread
    const int kk = in ? k : 0;
    float* base = tile_smem + stage * STAGE + r0 * LD + piece * 4;
#pragma unroll
    for (int l = 0; l < C_COPIES; ++l)
      cp_async16(base + l * COPY_ROWS * LD, crow + (size_t)l * COPY_ROWS * D + kk, in);
#pragma unroll
    for (int l = 0; l < Q_COPIES; ++l)
      cp_async16(base + (ROWS + l * COPY_ROWS) * LD, qrow[l] + kk, in && qok[l]);
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
  // a warp's queries are ty * TM .. for its first and last ty
  // A tile of at most TM queries ("narrow", the common tile where few
  // queries share a chunk) gives every thread one row for all its queries
  // (acc[i][0]), so both warps work; a wider tile takes the TM x TN
  // register tile, and a warp whose queries are all past the count skips.
  const bool narrow = tile.z <= TM;
  const bool active = narrow || (tid & ~31) / CS * TM < tile.z;
  const int S = (D + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < NST - 1; ++s) {
    if (s < S) load(s, s);
    cp_async_commit();
  }
  for (int s = 0; s < S; ++s) {
    cp_async_wait<NST - 2>();
    // slice s is visible to all, and every thread is done with slice s - 1,
    // whose slot the copies of slice s + NST - 1 take
    __syncthreads();
    if (s + NST - 1 < S) load(s + NST - 1, (s + NST - 1) % NST);
    cp_async_commit();
    if (narrow) {
      const float* cs = tile_smem + (s % NST) * STAGE + tid * LD;
      const float* qs = tile_smem + (s % NST) * STAGE + ROWS * LD;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 4) {
        const float4 b = *reinterpret_cast<const float4*>(cs + kk);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float4 a = *reinterpret_cast<const float4*>(qs + i * LD + kk);
          acc[i][0] = fmaf(a.x, b.x, acc[i][0]);
          acc[i][0] = fmaf(a.y, b.y, acc[i][0]);
          acc[i][0] = fmaf(a.z, b.z, acc[i][0]);
          acc[i][0] = fmaf(a.w, b.w, acc[i][0]);
        }
      }
    } else if (active) {
      const float* cs = tile_smem + (s % NST) * STAGE + tx * LD;
      const float* qs = tile_smem + (s % NST) * STAGE + (ROWS + ty * TM) * LD;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 4) {
        float4 b[TN];
#pragma unroll
        for (int j = 0; j < TN; ++j)
          b[j] = *reinterpret_cast<const float4*>(cs + j * CS * LD + kk);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float4 a = *reinterpret_cast<const float4*>(qs + i * LD + kk);
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            acc[i][j] = fmaf(a.x, b[j].x, acc[i][j]);
            acc[i][j] = fmaf(a.y, b[j].y, acc[i][j]);
            acc[i][j] = fmaf(a.z, b[j].z, acc[i][j]);
            acc[i][j] = fmaf(a.w, b[j].w, acc[i][j]);
          }
        }
      }
    }
  }
  if (narrow) {
#pragma unroll
    for (int i = 0; i < TM; ++i)
      if (i < tile.z) out[(size_t)pid[i] * CHUNK + row0 + tid] = acc[i][0];  // pair b * mc + i
    return;
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int slot = ty * TM + i;
    if (slot >= tile.z) continue;
    float* o = out + (size_t)pid[slot] * CHUNK + row0 + tx;
#pragma unroll
    for (int j = 0; j < TN; ++j) o[j * CS] = acc[i][j];
  }
}

// Scratch, in ints: an int4 descriptor per tile of the bound, the sorted
// pairs, nc chunk counters, the count kernel's `done`, the tile count.
int launch(const float* q, const float* c, const int* ids, float* out,
           int* scratch, long long scratch_ints, long long pairs, int nc, int d,
           int mc, cudaStream_t st) {
  const long long bound = tile_bound(pairs, nc);
  if (pairs > 0x7fffffffLL || 2 * bound > 0x7fffffffLL ||
      scratch_ints < 4 * bound + pairs + nc + 2)
    return static_cast<int>(cudaErrorInvalidValue);
  int4* tiles = reinterpret_cast<int4*>(scratch);
  int* sorted = scratch + 4 * bound;
  int* counts = sorted + pairs;
  int* done = counts + nc;
  int* ntiles = done + 1;
  cudaError_t err = cudaMemsetAsync(counts, 0, ((size_t)nc + 1) * sizeof(int), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = (unsigned)((pairs + SORT_THREADS - 1) / SORT_THREADS);
  count_kernel<<<blocks, SORT_THREADS, 0, st>>>(ids, out, (int)pairs, nc, tiles, counts,
                                                done, ntiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scatter_kernel<<<blocks, SORT_THREADS, 0, st>>>(ids, (int)pairs, nc, counts, sorted);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  static std::atomic<unsigned long long> allowed{0};
  err = allow_smem(tile_kernel, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = (size_t)NST * (ROWS + QT) * LD * sizeof(float);
  tile_kernel<<<(unsigned)(2 * bound), THREADS, smem, st>>>(q, c, sorted, tiles,
                                                            ntiles, out, d, mc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace grouped

}  // namespace

// C interface for ctypes. q (b, d) fp32, c (nc * 128, d) fp32, ids (b, mc)
// int32, out (b, mc * 128) fp32; d % 4 == 0, all contiguous and 16-byte
// aligned (the wrapper checks). path (the wrapper's plan): 0 "pairs",
// `param` rows of a chunk per block (8, 16 or 32); 1 "grouped", `param`
// queries per tile (32), `scratch` an int32 buffer of at least
// 4 * bound + b * mc + nc + 2 ints (bound = ceil(b * mc / 32) +
// min(nc, b * mc)) that the kernels fill themselves. Launches one kernel
// ("pairs") or a memset and three kernels ("grouped") on `stream`; returns
// a CUDA error code, 0 on success, cudaErrorInvalidValue for a plan it
// cannot run.
extern "C" int gather_rescore_launch(const void* q, const void* c,
                                     const void* ids, void* out, void* scratch,
                                     long long scratch_ints, int b, int nc,
                                     int d, int mc, int path, int param,
                                     void* stream) {
  if (b < 1 || mc < 1 || nc < 0 || d < 4 || d % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* cf = static_cast<const float*>(c);
  const int* ip = static_cast<const int*>(ids);
  float* of = static_cast<float*>(out);
  const long long n_pairs = (long long)b * mc;
  if (path == 0) return pairs::dispatch(param, qf, cf, ip, of, n_pairs, nc, d, mc, st);
  if (path == 1 && param == grouped::QT && scratch != nullptr)
    return grouped::launch(qf, cf, ip, of, static_cast<int*>(scratch), scratch_ints,
                           n_pairs, nc, d, mc, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
