// The residual add and RMSNorm of the decoder block on Hopper (sm_90a):
// models/deepseek_v3.py's RMSNorms (and models/kimi_linear.py's, the same
// modules), each with the residual add before it and its consumers' casts of
// its output, forward and backward.
//
// Replaces no kernel of the JAX package, which has no decoder. Added because
// the plain chain (ops/rms_norm.py add_rms_norm_reference) runs an fp32 add,
// a square, a mean, an rsqrt, two products and one cast per consumer, each a
// pass over (T, W) in device memory (about 58 bytes an element at a hidden
// site), and autograd replays about ten elementwise and reduce kernels for it
// in the backward.
//
// Computes, for rows of width W (2048, 2304 and 3584 hidden, 512 and 768
// latent):
//   x_new = x + branch          (fp32; only where there is a branch)
//   rstd  = rsqrt(mean(x_new^2) + eps), one fp32 value a row
//   y     = weight * (x_new * rstd), written once as fp32 and once as bf16
//           for each bf16 consumer (at most two), as each output asks
// and backward, from the saved x_new (or x) and rstd:
//   g     = the consumers' dy summed in fp32
//   n     = x_new * rstd
//   dx    = rstd * (g weight - n mean(g weight n)) + d x_new (the residual's)
//   dbranch = dx in the branch's type (bf16: rounded once)
//   dweight = the sum over rows of g n
//
// Bound on an H100 SXM: a normalisation does a few operations a byte, so the
// bytes bound it. At a hidden site of the Moonlight cell (T = 24,576 rows of
// 2048, a bf16 branch, two bf16 consumers) the forward moves 14 bytes an
// element (x 4, branch 2 in; x_new 4, y 2 + 2 out): 0.21 ms at 3.35 TB/s;
// the backward 18 (x_new 4, two dy 2 + 2, d x_new 4 in; dx 4, dbranch 2
// out): 0.27 ms.
//
// Design:
// - A row lives in registers, 8 consecutive elements a thread (one 16-byte
//   access of bf16, two of fp32), W / 8 threads a row: a block of 256
//   threads holds one row of 2048 or four rows of 512, one of 192 threads two
//   rows of 768, and a row of 2304 or 3584 takes a block of its own 288 or 448
//   threads (9 or 14 warps). Each input is read once a pass and each output
//   written once.
// - The row's sums in fp32: warp shuffles, then the row's warps in order
//   through shared memory.
// - Forward: one block a group of rows (T / rows-a-block blocks).
// - Backward: one wave of blocks (as many as the card holds at once), each
//   walking row groups grid-stride. Each thread keeps its 8 columns' sums of
//   g n over its block's rows; the block writes one fp32 row of partial sums
//   and a second kernel (rms_norm_dw) sums each column's partials in a fixed
//   order. No atomics: the gradients repeat bit for bit.
// - Rounding as the plain chain: the residual stream, the mean of squares,
//   rsqrt and the weight product in fp32; y rounded to bf16 once for each
//   bf16 consumer, where that consumer's cast rounded it; the consumers'
//   gradients summed in fp32 as autograd sums their casts' gradients; the
//   branch's gradient rounded once, as the backward of its .float() does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// The kernels' arguments (at global scope, so that a profiler names a kernel
// rms_norm_fwd<2048, float, __nv_bfloat16>(NormArgs) and the like). Every
// (rows, W) tensor but x is contiguous; x, and the saved row it stands for in
// the backward, lies at row stride ldx.
struct NormArgs {
  const void* x;        // forward: x; backward: x_new where there was a branch, else x
  const void* branch;   // null where there is none
  const float* weight;  // (W)
  float* xnew;          // forward, where there is a branch
  float* y32;           // forward outputs, each null where not asked for
  __nv_bfloat16* yb0;
  __nv_bfloat16* yb1;
  float* rstd;          // (rows): written forward, read backward
  const float* gxnew;   // backward: the gradients of x_new and of each y, or null
  const float* gy32;
  const __nv_bfloat16* gyb0;
  const __nv_bfloat16* gyb1;
  void* dx;             // backward outputs: x's type, the branch's type
  void* dbranch;
  float* partial;       // (gridDim.x, W): each block's sums of g n
  long long rows, ldx;
  float eps;
};

namespace {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 256;

// A block's threads at width W: the whole rows of W / 8 threads that 256
// holds, or one row's W / 8 where that is more.
template <int W>
struct Block {
  static constexpr int threads = W / 8 > THREADS ? W / 8 : THREADS / (W / 8) * (W / 8);
  static constexpr int rows = threads / (W / 8);
};

__device__ __forceinline__ void load8(const float* p, float v[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

__device__ __forceinline__ void load8(const bf16* p, float v[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x, v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* p, const float v[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(bf16* p, const float v[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

template <typename T>
__device__ __forceinline__ void add8(const T* p, float v[8]) {
  float b[8];
  load8(p, b);
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] += b[j];
}

// The sum of s over the threads of this thread's row: warp shuffles, then the
// row's WPR warps in order through red (one float a warp of the block).
template <int WPR>
__device__ __forceinline__ float row_sum(float s, float* red) {
#pragma unroll
  for (int o = 16; o; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) red[warp] = s;
  __syncthreads();
  const int first = warp / WPR * WPR;
  float t = 0.0f;
#pragma unroll
  for (int i = 0; i < WPR; ++i) t += red[first + i];
  return t;
}

}  // namespace

template <int W, typename TX, typename TB>
__global__ void __launch_bounds__(Block<W>::threads) rms_norm_fwd(NormArgs a) {
  constexpr int TPR = W / 8, RPB = Block<W>::rows, WPR = TPR / 32;
  __shared__ float red[Block<W>::threads / 32];
  const int c = threadIdx.x % TPR * 8;
  const long long row = (long long)blockIdx.x * RPB + threadIdx.x / TPR;
  const bool live = row < a.rows;
  float v[8] = {};
  if (live) {
    load8(static_cast<const TX*>(a.x) + row * a.ldx + c, v);
    if (a.branch) {
      add8(static_cast<const TB*>(a.branch) + row * W + c, v);
      store8(a.xnew + row * W + c, v);
    }
  }
  float ss = 0.0f;
#pragma unroll
  for (int j = 0; j < 8; ++j) ss = fmaf(v[j], v[j], ss);
  const float r = rsqrtf(row_sum<WPR>(ss, red) / W + a.eps);
  if (!live) return;
  if (c == 0) a.rstd[row] = r;
  float w[8], y[8];
  load8(a.weight + c, w);
#pragma unroll
  for (int j = 0; j < 8; ++j) y[j] = w[j] * (v[j] * r);
  if (a.y32) store8(a.y32 + row * W + c, y);
  if (a.yb0) store8(a.yb0 + row * W + c, y);
  if (a.yb1) store8(a.yb1 + row * W + c, y);
}

template <int W, typename TX, typename TB>
__global__ void __launch_bounds__(Block<W>::threads) rms_norm_bwd(NormArgs a) {
  constexpr int BT = Block<W>::threads, TPR = W / 8, RPB = Block<W>::rows, WPR = TPR / 32;
  __shared__ float red[2][BT / 32];
  __shared__ float part[RPB][W];
  const int grp = threadIdx.x / TPR, c = threadIdx.x % TPR * 8;
  float w[8], acc[8] = {};
  load8(a.weight + c, w);
  int turn = 0;  // red alternates, so one barrier a row group suffices
  const long long stride = (long long)gridDim.x * RPB;
  for (long long first = (long long)blockIdx.x * RPB; first < a.rows; first += stride, turn ^= 1) {
    const long long row = first + grp;
    const bool live = row < a.rows;
    float v[8] = {}, g[8] = {}, gx[8] = {}, r = 0.0f;
    if (live) {
      load8(static_cast<const TX*>(a.x) + row * a.ldx + c, v);
      if (a.gy32) add8(a.gy32 + row * W + c, g);
      if (a.gyb0) add8(a.gyb0 + row * W + c, g);
      if (a.gyb1) add8(a.gyb1 + row * W + c, g);
      if (a.gxnew) load8(a.gxnew + row * W + c, gx);
      r = a.rstd[row];
    }
    float n[8], dot = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      n[j] = v[j] * r;
      dot = fmaf(g[j] * w[j], n[j], dot);
      acc[j] = fmaf(g[j], n[j], acc[j]);
    }
    const float m = row_sum<WPR>(dot, red[turn]) / W;
    if (!live) continue;
    float dx[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) dx[j] = r * (g[j] * w[j] - n[j] * m) + gx[j];
    store8(static_cast<TX*>(a.dx) + row * W + c, dx);
    if (a.dbranch) store8(static_cast<TB*>(a.dbranch) + row * W + c, dx);
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) part[grp][c + j] = acc[j];
  __syncthreads();
  for (int col = threadIdx.x; col < W; col += BT) {
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < RPB; ++i) s += part[i][col];
    a.partial[(size_t)blockIdx.x * W + col] = s;
  }
}

// dweight: each column's partial sums over the blocks, in a fixed order (32
// columns a block, 8 warps each summing every eighth partial, then in order).
__global__ void __launch_bounds__(256) rms_norm_dw(const float* partial, int parts, int W,
                                                   float* dw) {
  __shared__ float s[8][32];
  const int lane = threadIdx.x % 32, slice = threadIdx.x / 32, col = blockIdx.x * 32 + lane;
  float acc = 0.0f;
  for (int p = slice; p < parts; p += 8) acc += partial[(size_t)p * W + col];
  s[slice][lane] = acc;
  __syncthreads();
  if (slice == 0) {
    float t = 0.0f;
#pragma unroll
    for (int i = 0; i < 8; ++i) t += s[i][lane];
    dw[col] = t;
  }
}

namespace {

template <int W, typename TX, typename TB>
cudaError_t run(int kind, const NormArgs& a, int parts, float* dw, cudaStream_t st) {
  constexpr int BT = Block<W>::threads, RPB = Block<W>::rows;
  if (kind == 0) {
    const long long blocks = (a.rows + RPB - 1) / RPB;
    if (blocks > 0x7fffffffll) return cudaErrorInvalidValue;
    rms_norm_fwd<W, TX, TB><<<(unsigned)blocks, BT, 0, st>>>(a);
    return cudaGetLastError();
  }
  if (parts < 1 || (long long)parts * RPB > a.rows + RPB - 1) return cudaErrorInvalidValue;
  rms_norm_bwd<W, TX, TB><<<parts, BT, 0, st>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rms_norm_dw<<<W / 32, 256, 0, st>>>(a.partial, parts, W, dw);
  return cudaGetLastError();
}

template <int W, typename TX, typename TB>
int wave() {
  int dev = 0, sms = 0, per = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, rms_norm_bwd<W, TX, TB>,
                                                        Block<W>::threads, 0);
  return err == cudaSuccess ? sms * per : -static_cast<int>(err);
}

}  // namespace

// Backward blocks that the current card runs at once for this width and these
// types (the number of partial rows the backward writes at most), or minus a
// CUDA error.
extern "C" int rms_norm_wave(int width, int x_bf16, int branch_bf16) {
  if (width == 2048)
    return x_bf16 ? wave<2048, bf16, bf16>()
                  : branch_bf16 ? wave<2048, float, bf16>() : wave<2048, float, float>();
  if (width == 512)
    return x_bf16 ? wave<512, bf16, bf16>()
                  : branch_bf16 ? wave<512, float, bf16>() : wave<512, float, float>();
  if (width == 2304)
    return x_bf16 ? wave<2304, bf16, bf16>()
                  : branch_bf16 ? wave<2304, float, bf16>() : wave<2304, float, float>();
  if (width == 3584)
    return x_bf16 ? wave<3584, bf16, bf16>()
                  : branch_bf16 ? wave<3584, float, bf16>() : wave<3584, float, float>();
  if (width == 768)
    return x_bf16 ? wave<768, bf16, bf16>()
                  : branch_bf16 ? wave<768, float, bf16>() : wave<768, float, float>();
  return -static_cast<int>(cudaErrorInvalidValue);
}

// kind 0: the forward; kind 1: the backward, then the weight gradient's sum
// of the `parts` partial rows. Returns a CUDA error, 0 on success.
extern "C" int rms_norm_launch(int kind, int width, int x_bf16, int branch_bf16, const void* x,
                               long long ldx, const void* branch, const void* weight, void* xnew,
                               void* y32, void* yb0, void* yb1, void* rstd, const void* gxnew,
                               const void* gy32, const void* gyb0, const void* gyb1, void* dx,
                               void* dbranch, void* partial, int parts, void* dw, long long rows,
                               float eps, void* stream) {
  if (kind < 0 || kind > 1 || rows < 1 || ldx < width || (x_bf16 && branch))
    return static_cast<int>(cudaErrorInvalidValue);
  NormArgs a{x, branch, static_cast<const float*>(weight), static_cast<float*>(xnew),
             static_cast<float*>(y32), static_cast<bf16*>(yb0), static_cast<bf16*>(yb1),
             static_cast<float*>(rstd), static_cast<const float*>(gxnew),
             static_cast<const float*>(gy32), static_cast<const bf16*>(gyb0),
             static_cast<const bf16*>(gyb1), dx, dbranch, static_cast<float*>(partial),
             rows, ldx, eps};
  float* fw = static_cast<float*>(dw);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (width == 2048)
    err = x_bf16 ? run<2048, bf16, bf16>(kind, a, parts, fw, st)
                 : branch_bf16 ? run<2048, float, bf16>(kind, a, parts, fw, st)
                               : run<2048, float, float>(kind, a, parts, fw, st);
  else if (width == 512)
    err = x_bf16 ? run<512, bf16, bf16>(kind, a, parts, fw, st)
                 : branch_bf16 ? run<512, float, bf16>(kind, a, parts, fw, st)
                               : run<512, float, float>(kind, a, parts, fw, st);
  else if (width == 2304)
    err = x_bf16 ? run<2304, bf16, bf16>(kind, a, parts, fw, st)
                 : branch_bf16 ? run<2304, float, bf16>(kind, a, parts, fw, st)
                               : run<2304, float, float>(kind, a, parts, fw, st);
  else if (width == 3584)
    err = x_bf16 ? run<3584, bf16, bf16>(kind, a, parts, fw, st)
                 : branch_bf16 ? run<3584, float, bf16>(kind, a, parts, fw, st)
                               : run<3584, float, float>(kind, a, parts, fw, st);
  else if (width == 768)
    err = x_bf16 ? run<768, bf16, bf16>(kind, a, parts, fw, st)
                 : branch_bf16 ? run<768, float, bf16>(kind, a, parts, fw, st)
                               : run<768, float, float>(kind, a, parts, fw, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
