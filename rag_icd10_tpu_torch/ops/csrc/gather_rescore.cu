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
// none of them carries over.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32 outside the tensor
// cores): bytes = the distinct chunks the batch selected (at most N*D*4)
// + B*D*4 + B*mc*128*4 written; operations = 2*B*mc*128*D. A chunk is
// 128 x 768 fp32 = 384 KB, so a batch of 8 queries with mc = 26 chunks
// reads up to 80 MB (24 us); at B = 256 the arithmetic (2.6 GFLOP,
// 39 us) and the chunks shared between queries decide.
//
// Design. One block of 128 threads for each (query, chunk rank): the block
// loads its own chunk id, keeps the query row in shared memory and streams
// the chunk's 128 rows through shared memory in D slices of 32 columns,
// double-buffered with cp.async (16-byte copies, eight threads per row
// slice, so each row's 128 bytes are one coalesced segment). Thread r
// takes row r's IEEE fp32 dot with fmaf in d order; the row stride is
// padded to 36 floats so the float4 reads of 8 consecutive rows hit 32
// distinct banks. An id outside [0, N/128) writes NaN for its 128 scores.
// B needs no padding to a multiple of 8.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 128;  // rows per chunk = threads per block
constexpr int DK = 32;     // D columns per slice
constexpr int LD = DK + 4; // padded row stride in shared memory (floats)
constexpr int COPIES = ROWS * (DK / 4) / ROWS;  // 16-byte copies per thread

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING));
}

__global__ void __launch_bounds__(ROWS)
    gather_rescore_kernel(const float* __restrict__ q,
                          const float* __restrict__ c,
                          const int* __restrict__ ids, float* __restrict__ out,
                          int B, int nc, int D, int mc) {
  extern __shared__ __align__(16) float smem[];
  float* qrow = smem;         // D floats (D % 4 == 0 keeps buf aligned)
  float* buf = smem + D;      // [2][ROWS][LD]
  const int tid = threadIdx.x;
  const int b = blockIdx.x / mc;
  const int rank = blockIdx.x % mc;
  float* o = out + ((size_t)b * mc + rank) * ROWS;
  const int cid = ids[(size_t)b * mc + rank];
  if (cid < 0 || cid >= nc) {  // uniform across the block
    o[tid] = NAN;
    return;
  }
  for (int d = tid; d < D; d += ROWS) qrow[d] = q[(size_t)b * D + d];
  const float* rows = c + (size_t)cid * ROWS * D;

  auto load = [&](int slice, int stage) {
    const int k0 = slice * DK;
#pragma unroll
    for (int l = 0; l < COPIES; ++l) {
      const int i = tid + l * ROWS;
      const int r = i / (DK / 4), ch = i % (DK / 4);
      const int k = k0 + ch * 4;
      if (k < D)
        cp_async16(buf + ((size_t)stage * ROWS + r) * LD + ch * 4,
                   rows + (size_t)r * D + k);
    }
    cp_async_commit();
  };

  const int slices = (D + DK - 1) / DK;
  float acc = 0.0f;
  load(0, 0);
  for (int t = 0; t < slices; ++t) {
    if (t + 1 < slices) {
      load(t + 1, (t + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // slice t (and, at t = 0, qrow) visible to all
    const float* row = buf + ((size_t)(t & 1) * ROWS + tid) * LD;
    const float* qs = qrow + t * DK;
    const int kn = min(DK, D - t * DK);
    if (kn == DK) {
#pragma unroll
      for (int kk = 0; kk < DK; kk += 4) {
        const float4 v = *reinterpret_cast<const float4*>(row + kk);
        const float4 u = *reinterpret_cast<const float4*>(qs + kk);
        acc = fmaf(u.x, v.x, acc);
        acc = fmaf(u.y, v.y, acc);
        acc = fmaf(u.z, v.z, acc);
        acc = fmaf(u.w, v.w, acc);
      }
    } else {
      for (int kk = 0; kk < kn; ++kk) acc = fmaf(qs[kk], row[kk], acc);
    }
    __syncthreads();  // buffer t & 1 is refilled at step t + 1
  }
  o[tid] = acc;
}

}  // namespace

// C interface for ctypes. q (b, d) fp32, c (nc * 128, d) fp32, ids (b, mc)
// int32, out (b, mc * 128) fp32; d % 4 == 0, all contiguous and 16-byte
// aligned (the wrapper checks). Launches on `stream`; returns a CUDA error
// code, 0 on success.
extern "C" int gather_rescore_launch(const void* q, const void* c,
                                     const void* ids, void* out, int b, int nc,
                                     int d, int mc, void* stream) {
  const size_t smem = ((size_t)d + 2 * ROWS * LD) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      gather_rescore_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (long long)b * mc;
  gather_rescore_kernel<<<(unsigned)blocks, ROWS, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(c),
      static_cast<const int*>(ids), static_cast<float*>(out), b, nc, d, mc);
  return static_cast<int>(cudaGetLastError());
}
