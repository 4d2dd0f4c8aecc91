// The gated delta rule of Kimi Delta Attention on Hopper (sm_90a):
// models/kimi_linear.py KimiDeltaAttention's core (ops/kda.py), from the
// short convolutions' q, k, v, the per-channel log-decay g and the write
// strength beta to each head's output o, forward and backward.
//
// Replaces no kernel of the JAX package, which has no delta rule. Added
// because the plain version (ops/kda.py kda_reference) runs about a hundred
// torch operations a call (fp32 copies, pads and permutes of the inputs,
// broadcast products over blocks of 16, 4 and 1 tokens, cats, a batched
// triangular solve) and, under its checkpoint, all of them again in the
// backward before autograd's own backward of each.
//
// Computes, per (batch, head) and chunk of C = 48 tokens, in fp32 throughout
// (bf16 inputs are exact in fp32), the function of kda_reference:
//   q, k L2-normalised (eps 1e-6), q scaled by d^-1/2; Gamma = the cumulative
//   sum of g from the chunk's start (never positive);
//   A_tj = sum_c k_tc k_jc exp(Gamma_tc - Gamma_jc), j < t; P_tj the same
//   with q_t, j <= t;
//   W = R - A U and U = Diag(beta) W, with R = V - (k e^Gamma) S0: the unit
//   lower-triangular solve (I + Diag(beta) A) U = Diag(beta) R, by forward
//   substitution on chip;
//   O = (q e^Gamma) S0 + P U; the next chunk's state
//   S1 = Diag(e^Gamma_L) S0 + (k e^(Gamma_L - Gamma))^T U.
// Right padding of the last chunk needs no mask: the rule is causal, and the
// padded rows are zero (q, k, v, beta and g), so they write nothing.
//
// Every decay exponent is a difference Gamma_t - Gamma_j with j <= t, or a
// difference to a position between them, so never positive: an underflow
// gives 0, never inf or nan. A and P are built over tiles of 4 x 4 pairs:
// a tile below the diagonal factors each pair's weight as
// exp(Gamma_t - Gamma_t0) exp(Gamma_t0 - Gamma_j3) exp(Gamma_j3 - Gamma_j),
// with t0 the tile's first row and j3 its last column (three factors of at
// most 1; the outer two computed once a token, so one exponential for 16
// pairs a channel); a diagonal tile takes each pair's own exp(Gamma_t -
// Gamma_j). The backward's pair sums walk a row's
// pairs in order and carry the weight as a running product of the tokens'
// decays exp(Gamma_i - Gamma_(i-1)) = exp(g_i), each at most 1.
//
// Backward, per chunk from the last to the first, with dS1 the gradient of
// the chunk's outgoing state:
//   dU = P^T dO + (k e^(Gamma_L - Gamma)) dS1; dX = (I + Diag(beta) A)^-T dU
//   by back substitution; dV = Diag(beta) dX; dbeta_t = dX_t . W_t;
//   dA = -Diag(beta) dX U^T; dP = dO U^T; dS0 = Diag(e^Gamma_L) dS1
//   + (q e^Gamma)^T dO - (k e^Gamma)^T Diag(beta) dX;
//   then the gradients of q, k and Gamma through A, P and the decayed
//   products, Gamma's summed back to g in reverse within the chunk, and
//   through the L2 norms to q and k.
// The forward saves each row's state at every chunk boundary (128 x 128 fp32
// a (row, head) a boundary; none at S <= 48); the backward recomputes the
// chunk's q, k, Gamma, A, P and W on chip, and carries dS between chunks in
// a scratch of one state a (row, head). Nothing runs the forward twice.
//
// Bound on an H100 SXM: at the Kimi cell's shapes (24,576 tokens a call, 32
// heads of 128) a forward reads q, k, v in bf16 and g in fp32 and writes o in
// fp32, 1.41 GB, 0.42 ms at 3.35 TB/s; its fp32 products (A, P, the solve,
// P U and, at S 96, the state terms) are about 19 GFLOP (S 48) and 58 GFLOP
// (S 96), 0.29 and 0.87 ms at 67 TFLOP/s: the bytes bound S 48, the products
// S 96, and the backward's products (53 and 143 GFLOP) bound it at both. So
// nothing of a chunk but its results leaves the chip, and every product is
// fp32 FFMA from shared memory, each thread holding a register tile (6 rows
// x 4 columns of a chunk's 48 x 128, 16 or 8 rows x 4 of a state, 4 x 4 or
// 3 x 3 of a 48 x 48 pair matrix).
//
// Design:
// - One block of 256 threads a (batch, head), walking its chunks in order
//   (the backward in reverse); 213 KB (forward) and 218 KB (backward) of
//   shared memory, one block an SM. q, k, Gamma (and v or the backward's W,
//   dX, dO) are held as [token][channel] fp32 tiles, rows padded to 132
//   floats; A and P as 48 x 48; the state as 128 x 132.
// - Inputs are read in place through their strides, (B, S, H, d) in any
//   layout: where the channel stride is 1 a warp reads a token's channels,
//   else (the convolutions' output, token stride 1) a channel's tokens; by
//   16-byte loads, all of a chunk's in flight at once, where aligned. With
//   one block an SM nothing else hides their latency.
// - The triangular solves go by blocks of 16 rows: a block's own rows one
//   thread a column of the 128 values (its 16 unknowns in registers), then
//   every other row takes the block's part of its sum on all threads.
// - The big phases (the pairs, the solves, the pair gradients) are functions
//   of their own, so that each gets its own register allocation: inlined
//   into one kernel body they spilled.
// - No atomics: every sum has a fixed order, and a call repeats bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// The kernels' arguments (at global scope, so that a profiler names a kernel
// kda_fwd<__nv_bfloat16>(KdaArgs) and the like). Strides are in elements,
// (batch, position, head, channel) for q, k, v and g and (batch, position,
// head) for beta; every output is contiguous, (B, S, H, 128) or (B, S, H).
struct KdaArgs {
  const void* q;
  const void* k;
  const void* v;
  const float* g;
  const float* beta;
  long long sq[4], sk[4], sv[4], sg[4], sb[3];
  float* o;             // forward: (B, S, H, 128)
  float* states;        // (B * H, chunks - 1, 128, 128): the state entering chunks 1, 2, ...
  const float* dout;    // backward: dO, contiguous
  void* dq;             // backward outputs: q's, k's and v's type
  void* dk;
  void* dv;
  float* dg;
  float* dbeta;
  float* dstate;        // (B * H, 128, 128): dS between chunks
  int B, S, H;
  float scale;          // d^-1/2
  int vec;              // bit i: input i (q, k, v, g, dO) takes 16-byte loads in a whole chunk
};

namespace {

using bf16 = __nv_bfloat16;

constexpr int C = 48;     // tokens a chunk: the size of the triangular solve
constexpr int D = 128;    // d_k = d_v
constexpr int NT = 256;   // threads a block
constexpr int LD = D + 4; // row stride of a [token][channel] tile
constexpr int SLD = D + 4;  // row stride of the state in shared memory
constexpr int TILE = C * LD;
constexpr int STATE = D * SLD;
constexpr int PAIRS = C * C;
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

constexpr size_t FWD_SMEM = sizeof(float) * (5 * TILE + STATE + 2 * PAIRS + 3 * C);
constexpr size_t BWD_SMEM = sizeof(float) * (5 * TILE + STATE + 2 * PAIRS + 3 * C + 9 * D);

__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }

// exp(x) for x <= 0 (a decay), by the SFU's 2^x (relative error about 2^-22);
// a result below 2^-126 is flushed to 0, never inf or nan
__device__ __forceinline__ float decay(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * LOG2E));
  return y;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int m = 16; m; m >>= 1) x += __shfl_xor_sync(FULL, x, m);
  return x;
}

// acc[i][j] += sum_{k0 <= k < k1} X[(r0 + i) * ldx + k] * Y[k * ldy + n0 + j];
// k0, k1, ldx, ldy, n0 multiples of 4
template <int R>
__device__ __forceinline__ void mm_nn(float (&acc)[R][4], const float* X, int ldx, int r0,
                                      const float* Y, int ldy, int n0, int k0, int k1) {
  for (int k = k0; k < k1; k += 4) {
    float y[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 v = ld4(Y + (k + kk) * ldy + n0);
      y[kk][0] = v.x; y[kk][1] = v.y; y[kk][2] = v.z; y[kk][3] = v.w;
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const float4 xv = ld4(X + (r0 + i) * ldx + k);
      const float x[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(x[kk], y[kk][j], acc[i][j]);
    }
  }
}

// acc[i][j] += sum_{k0 <= k < k1} X[k * ldx + r0 + i] * Y[k * ldy + n0 + j]; R a multiple of 4
template <int R>
__device__ __forceinline__ void mm_tn(float (&acc)[R][4], const float* X, int ldx, int r0,
                                      const float* Y, int ldy, int n0, int k0, int k1) {
  for (int k = k0; k < k1; ++k) {
    const float4 yv = ld4(Y + k * ldy + n0);
    const float y[4] = {yv.x, yv.y, yv.z, yv.w};
#pragma unroll
    for (int i4 = 0; i4 < R / 4; ++i4) {
      const float4 xv = ld4(X + k * ldx + r0 + 4 * i4);
      const float x[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[4 * i4 + ii][j] = fmaf(x[ii], y[j], acc[4 * i4 + ii][j]);
    }
  }
}

constexpr int PER = C * D / NT;  // elements of a [C][D] tile a thread loads

// A thread's PER elements of a [C][D] input tile (token t: base + t * st_s,
// channel c: c * st_d; 0 past nv): where the channel stride is 1 a warp reads
// a token's channels, else (the convolutions' output, token stride 1) a
// channel's tokens. Every load is issued before any is used, so a tile costs
// one memory latency; with one block an SM nothing else would hide it.
template <typename T>
__device__ __forceinline__ void fetch(float (&r)[PER], const T* src, long long base,
                                      long long st_s, long long st_d, int nv) {
  const bool by_token = st_d == 1;
#pragma unroll
  for (int p = 0; p < PER; ++p) {
    const int i = threadIdx.x + p * NT;
    const int t = by_token ? i / D : i % C, c = by_token ? i % D : i / C;
    r[p] = t < nv ? to_f(src[base + t * st_s + c * st_d]) : 0.f;
  }
}

__device__ __forceinline__ void place(float* dst, const float (&r)[PER], long long st_d) {
  const bool by_token = st_d == 1;
#pragma unroll
  for (int p = 0; p < PER; ++p) {
    const int i = threadIdx.x + p * NT;
    const int t = by_token ? i / D : i % C, c = by_token ? i % D : i / C;
    dst[t * LD + c] = r[p];
  }
}

// The same tile by 16-byte loads (a whole chunk, where the host found every
// vector aligned): along the channels where their stride is 1, else along
// the tokens (the convolutions' layout, token stride 1).
template <typename T>
struct Vec {
  static constexpr int N = 16 / sizeof(T);        // elements a load
  static constexpr int LOADS = C * D / N / NT;    // loads a thread: bf16 3, fp32 6
};

__device__ __forceinline__ void unpack(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // the element at the lower address in the low half
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

template <typename T>
__device__ __forceinline__ void vfetch(uint4 (&r)[Vec<T>::LOADS], const T* src, long long base,
                                       long long st_s, long long st_d) {
  constexpr int N = Vec<T>::N;
  const bool by_token = st_d == 1;
#pragma unroll
  for (int p = 0; p < Vec<T>::LOADS; ++p) {
    const int i = threadIdx.x + p * NT;
    const long long off = by_token ? base + (i / (D / N)) * st_s + (i % (D / N)) * N
                                   : base + (i % (C / N)) * N + (i / (C / N)) * st_d;
    r[p] = *reinterpret_cast<const uint4*>(src + off);
  }
}

template <typename T>
__device__ __forceinline__ void vplace(float* dst, const uint4 (&r)[Vec<T>::LOADS],
                                       long long st_d) {
  constexpr int N = Vec<T>::N;
  const bool by_token = st_d == 1;
#pragma unroll
  for (int p = 0; p < Vec<T>::LOADS; ++p) {
    const int i = threadIdx.x + p * NT;
    float f[N];
    unpack(r[p], f);
    if (by_token) {
      float* row = dst + (i / (D / N)) * LD + (i % (D / N)) * N;
#pragma unroll
      for (int e = 0; e < N; e += 4) st4(row + e, make_float4(f[e], f[e + 1], f[e + 2], f[e + 3]));
    } else {
      float* col = dst + (i % (C / N)) * N * LD + i / (C / N);
#pragma unroll
      for (int e = 0; e < N; ++e) col[e * LD] = f[e];
    }
  }
}

// dst [C][LD] <- one input tile (see fetch, vfetch)
template <typename T>
__device__ void load_rows(float* dst, const T* src, long long base, long long st_s,
                          long long st_d, int nv, bool vec) {
  if (vec && nv == C) {
    uint4 r[Vec<T>::LOADS];
    vfetch(r, src, base, st_s, st_d);
    vplace<T>(dst, r, st_d);
  } else {
    float r[PER];
    fetch(r, src, base, st_s, st_d, nv);
    place(dst, r, st_d);
  }
}

// dst [D][SLD] <- a contiguous 128 x 128 state, as it is or transposed
__device__ void load_state(float* dst, const float* src, bool transpose) {
  float4 r[D * D / 4 / NT];
#pragma unroll
  for (int p = 0; p < D * D / 4 / NT; ++p) r[p] = ld4(src + 4 * (threadIdx.x + p * NT));
#pragma unroll
  for (int p = 0; p < D * D / 4 / NT; ++p) {
    const int i = 4 * (threadIdx.x + p * NT), row = i / D, c = i % D;
    if (transpose) {
      dst[c * SLD + row] = r[p].x;
      dst[(c + 1) * SLD + row] = r[p].y;
      dst[(c + 2) * SLD + row] = r[p].z;
      dst[(c + 3) * SLD + row] = r[p].w;
    } else {
      st4(dst + row * SLD + c, r[p]);
    }
  }
}

// One chunk's q, k (normalised and scaled), Gamma and beta.
template <typename T>
__device__ void load_chunk(const KdaArgs& a, int b, int h, int s0, int nv, float* sQ, float* sK,
                           float* sG, float* sBeta, float* sRq, float* sRk) {
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const int tid = threadIdx.x;
  const long long bq = b * a.sq[0] + s0 * a.sq[1] + h * a.sq[2];
  const long long bk = b * a.sk[0] + s0 * a.sk[1] + h * a.sk[2];
  const long long bg = b * a.sg[0] + s0 * a.sg[1] + h * a.sg[2];
  const float bt = tid < C && tid < nv ? a.beta[b * a.sb[0] + (s0 + tid) * a.sb[1] + h * a.sb[2]]
                                       : 0.f;
  if (nv == C && (a.vec & 11) == 11) {  // q, k and g by 16-byte loads, all in flight at once
    uint4 rq[Vec<T>::LOADS], rk[Vec<T>::LOADS], rg[Vec<float>::LOADS];
    vfetch(rq, q, bq, a.sq[1], a.sq[3]);
    vfetch(rk, k, bk, a.sk[1], a.sk[3]);
    vfetch(rg, a.g, bg, a.sg[1], a.sg[3]);
    vplace<T>(sQ, rq, a.sq[3]);
    vplace<T>(sK, rk, a.sk[3]);
    vplace<float>(sG, rg, a.sg[3]);
  } else {  // a partial chunk, or strides that 16-byte loads cannot take
    load_rows(sQ, q, bq, a.sq[1], a.sq[3], nv, false);
    load_rows(sK, k, bk, a.sk[1], a.sk[3], nv, false);
    load_rows(sG, a.g, bg, a.sg[1], a.sg[3], nv, false);
  }
  if (tid < C) sBeta[tid] = bt;
  __syncthreads();
  if (tid < D) {  // Gamma: one channel a thread, summed in token order (0 past nv)
    float gam = 0.f;
#pragma unroll
    for (int t = 0; t < C; ++t) {
      gam += sG[t * LD + tid];
      sG[t * LD + tid] = gam;
    }
  }
  // the L2 norms: a warp a row, 4 channels a lane
  const int lane = tid & 31, w = tid >> 5;
  for (int t = w; t < C; t += NT / 32) {
    float4 x = ld4(sQ + t * LD + 4 * lane);
    float rq = rsqrtf(warp_sum(x.x * x.x + x.y * x.y + x.z * x.z + x.w * x.w) + 1e-6f);
    float4 y = ld4(sK + t * LD + 4 * lane);
    float rk = rsqrtf(warp_sum(y.x * y.x + y.y * y.y + y.z * y.z + y.w * y.w) + 1e-6f);
    if (lane == 0) {
      sRq[t] = rq;
      sRk[t] = rk;
    }
    const float fq = rq * a.scale;
    st4(sQ + t * LD + 4 * lane, make_float4(x.x * fq, x.y * fq, x.z * fq, x.w * fq));
    st4(sK + t * LD + 4 * lane, make_float4(y.x * rk, y.y * rk, y.z * rk, y.w * rk));
  }
  __syncthreads();
}

// sA (C x C, [t][j]) <- A, strictly lower; sP <- P, lower with the diagonal,
// as [t][j] or transposed; zeros elsewhere. Over tiles of 4 x 4 pairs: the
// 66 tiles below the diagonal three threads a tile on warps 0-6, each
// summing a third of the channels (the partial sums added in a fixed order
// through sAl), the 12 on it two threads a tile on warp 7 (the two kinds
// never share a warp). sAl and sBe (two [C][LD] scratch tiles) first take
// each token's decay from its tile's first row, exp(Gamma_t - Gamma_t0), and
// to its tile's last row, exp(Gamma_j3 - Gamma_j), so that a tile below the
// diagonal takes one exponential a channel, exp(Gamma_t0 - Gamma_j3), for
// its 16 pairs.
__device__ __noinline__ void build_pairs(const float* sQ, const float* sK, const float* sG,
                                         float* sA, float* sP, bool p_transposed, float* sAl,
                                         float* sBe) {
  constexpr int BELOW = 66 * 3, DIAG0 = 224;  // threads of the tiles below and on the diagonal
  const int tid = threadIdx.x;
  for (int i = tid; i < C * D; i += NT) {
    const int t = i / D, c = i % D;
    const float gam = sG[t * LD + c];
    sAl[t * LD + c] = decay(gam - sG[(t & ~3) * LD + c]);
    sBe[t * LD + c] = decay(sG[(t | 3) * LD + c] - gam);
  }
  for (int i = tid; i < PAIRS; i += NT) {
    sA[i] = 0.f;
    sP[i] = 0.f;
  }
  __syncthreads();
  const bool below = tid < BELOW, diagonal = tid >= DIAG0 && tid < DIAG0 + 24;
  int I = 0, J = 0, c_lo = 0, c_hi = 0;
  if (below) {
    int o = tid / 3;
    I = 1;
    while (o >= I) {
      o -= I;
      ++I;
    }
    J = o;
    const int part = tid % 3;  // channels [0, 44), [44, 88), [88, 128)
    c_lo = 44 * part;
    c_hi = part == 2 ? D : c_lo + 44;
  } else if (diagonal) {
    I = J = (tid - DIAG0) >> 1;
    c_lo = 64 * (tid & 1);
    c_hi = c_lo + 64;
  }
  const int t0 = 4 * I, j0 = 4 * J;
  float ac[4][4], pc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) ac[i][j] = pc[i][j] = 0.f;
  if (below) {
    for (int c = c_lo; c < c_hi; c += 4) {
      float kt[4][4], qt[4][4], kj[4][4];  // [row][channel], scaled
      const float4 gf = ld4(sG + t0 * LD + c), gl = ld4(sG + (j0 + 3) * LD + c);
      const float m[4] = {decay(gf.x - gl.x), decay(gf.y - gl.y), decay(gf.z - gl.z),
                          decay(gf.w - gl.w)};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 al = ld4(sAl + (t0 + i) * LD + c), be = ld4(sBe + (j0 + i) * LD + c);
        const float ra[4] = {al.x * m[0], al.y * m[1], al.z * m[2], al.w * m[3]};
        float4 v = ld4(sK + (t0 + i) * LD + c);
        kt[i][0] = v.x * ra[0]; kt[i][1] = v.y * ra[1]; kt[i][2] = v.z * ra[2]; kt[i][3] = v.w * ra[3];
        v = ld4(sQ + (t0 + i) * LD + c);
        qt[i][0] = v.x * ra[0]; qt[i][1] = v.y * ra[1]; qt[i][2] = v.z * ra[2]; qt[i][3] = v.w * ra[3];
        v = ld4(sK + (j0 + i) * LD + c);
        kj[i][0] = v.x * be.x; kj[i][1] = v.y * be.y; kj[i][2] = v.z * be.z; kj[i][3] = v.w * be.w;
      }
#pragma unroll
      for (int ch = 0; ch < 4; ++ch)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            ac[i][j] = fmaf(kt[i][ch], kj[j][ch], ac[i][j]);
            pc[i][j] = fmaf(qt[i][ch], kj[j][ch], pc[i][j]);
          }
    }
  } else if (diagonal) {  // each pair's own exp(Gamma_t - Gamma_j)
    for (int c = c_lo; c < c_hi; c += 4) {
      float kt[4][4], qt[4][4], gt[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float4 v = ld4(sK + (t0 + i) * LD + c);
        kt[i][0] = v.x; kt[i][1] = v.y; kt[i][2] = v.z; kt[i][3] = v.w;
        v = ld4(sQ + (t0 + i) * LD + c);
        qt[i][0] = v.x; qt[i][1] = v.y; qt[i][2] = v.z; qt[i][3] = v.w;
        v = ld4(sG + (t0 + i) * LD + c);
        gt[i][0] = v.x; gt[i][1] = v.y; gt[i][2] = v.z; gt[i][3] = v.w;
      }
#pragma unroll
      for (int ch = 0; ch < 4; ++ch)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j <= i; ++j) {
            const float kw = kt[j][ch] * (i == j ? 1.f : decay(gt[i][ch] - gt[j][ch]));
            if (j < i) ac[i][j] = fmaf(kt[i][ch], kw, ac[i][j]);
            pc[i][j] = fmaf(qt[i][ch], kw, pc[i][j]);
          }
    }
  }
  if (tid >= DIAG0) {  // warp 7: the two halves of a diagonal tile's channels
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ac[i][j] += __shfl_xor_sync(FULL, ac[i][j], 1);
        pc[i][j] += __shfl_xor_sync(FULL, pc[i][j], 1);
      }
  }
  __syncthreads();  // sAl is read no more: it takes the second and third thirds' sums
  if (below && tid % 3) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      st4(sAl + tid * 32 + 4 * i, make_float4(ac[i][0], ac[i][1], ac[i][2], ac[i][3]));
      st4(sAl + tid * 32 + 16 + 4 * i, make_float4(pc[i][0], pc[i][1], pc[i][2], pc[i][3]));
    }
  } else if (diagonal) {
    const int half = tid & 1;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (half == 0) {
          if (j < i) sA[(t0 + i) * C + j0 + j] = ac[i][j];
        } else if (j <= i) {
          sP[p_transposed ? (j0 + j) * C + t0 + i : (t0 + i) * C + j0 + j] = pc[i][j];
        }
      }
  }
  __syncthreads();
  if (below && tid % 3 == 0) {  // a tile's first third adds the other two, in that order
    const float* p1 = sAl + (tid + 1) * 32;
    const float* p2 = sAl + (tid + 2) * 32;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sA[(t0 + i) * C + j0 + j] = (ac[i][j] + p1[4 * i + j]) + p2[4 * i + j];
        const float p = (pc[i][j] + p1[16 + 4 * i + j]) + p2[16 + 4 * i + j];
        sP[p_transposed ? (j0 + j) * C + t0 + i : (t0 + i) * C + j0 + j] = p;
      }
  }
  __syncthreads();
}

// dst[t][c] = f * src[t][c] * exp(Gamma_t,c) (to_last: exp(Gamma_L,c - Gamma_t,c)),
// with f = beta_t * sign where sBeta is given, else sign
__device__ void fill_decayed(float* dst, const float* src, const float* sG, bool to_last,
                             const float* sBeta, float sign) {
  for (int i = threadIdx.x; i < C * D; i += NT) {
    const int t = i / D, c = i % D;
    const float gam = sG[t * LD + c];
    const float e = decay(to_last ? sG[(C - 1) * LD + c] - gam : gam);
    const float f = sBeta != nullptr ? sign * sBeta[t] : sign;
    dst[t * LD + c] = f * src[t * LD + c] * e;
  }
}

constexpr int BLK = 16;  // rows a diagonal block of the triangular solves

// buf[t][v] -= sum over the block's rows j in [j0, j0 + BLK) of
// coef(t, j) * f_j * buf[j][v], for the rows t in [t_lo, t_lo + n), n a
// multiple of 32: coef = A[t][j] (forward substitution) or A[j][t] (back
// substitution), f_j = beta_j where scale, else 1. Four rows x four columns
// a thread.
__device__ void block_update(float* buf, const float* sA, const float* sBeta, int j0, int t_lo,
                             int n, bool transposed, bool scale) {
  const int tid = threadIdx.x;
  if (tid >= n * 8) return;
  const int r0 = t_lo + 4 * (tid >> 5), n0 = 4 * (tid & 31);
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int j = j0; j < j0 + BLK; ++j) {
    float4 y = ld4(buf + j * LD + n0);
    if (scale) {
      const float f = sBeta[j];
      y = make_float4(f * y.x, f * y.y, f * y.z, f * y.w);
    }
    float cf[4];
    if (transposed) {
      const float4 c4 = ld4(sA + j * C + r0);
      cf[0] = c4.x; cf[1] = c4.y; cf[2] = c4.z; cf[3] = c4.w;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) cf[i] = sA[(r0 + i) * C + j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc[i][0] = fmaf(cf[i], y.x, acc[i][0]);
      acc[i][1] = fmaf(cf[i], y.y, acc[i][1]);
      acc[i][2] = fmaf(cf[i], y.z, acc[i][2]);
      acc[i][3] = fmaf(cf[i], y.w, acc[i][3]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float* row = buf + (r0 + i) * LD + n0;
    const float4 o = ld4(row);
    st4(row, make_float4(o.x - acc[i][0], o.y - acc[i][1], o.z - acc[i][2], o.w - acc[i][3]));
  }
}

// Forward substitution: buf holds R and receives U (store_u) or W = R - A U,
// with U = Diag(beta) W. By blocks of 16 rows: a block's own rows a thread a
// column (its 16 unknowns in registers), then every later row takes the
// block's part of its sum, all threads at once.
__device__ __noinline__ void solve_lower(float* buf, const float* sA, const float* sBeta,
                                         bool store_u) {
  const int v = threadIdx.x;
#pragma unroll 1
  for (int r0 = 0; r0 < C; r0 += BLK) {
    if (v < D) {
      float u[BLK];
#pragma unroll
      for (int t = 0; t < BLK; ++t) {
        float s0 = buf[(r0 + t) * LD + v], s1 = 0.f;
#pragma unroll
        for (int j = 0; j < t; ++j) {
          if (j & 1) s1 = fmaf(-sA[(r0 + t) * C + r0 + j], u[j], s1);
          else s0 = fmaf(-sA[(r0 + t) * C + r0 + j], u[j], s0);
        }
        const float w = s0 + s1;
        u[t] = sBeta[r0 + t] * w;
        buf[(r0 + t) * LD + v] = store_u ? u[t] : w;
      }
    }
    __syncthreads();
    if (r0 + BLK < C) {
      block_update(buf, sA, sBeta, r0, r0 + BLK, C - r0 - BLK, false, !store_u);
      __syncthreads();
    }
  }
}

// Back substitution: buf holds dU and receives dX = (I + Diag(beta) A)^-T dU,
// by blocks of 16 rows from the last.
__device__ __noinline__ void solve_upper(float* buf, const float* sA, const float* sBeta) {
  const int v = threadIdx.x;
#pragma unroll 1
  for (int r0 = C - BLK; r0 >= 0; r0 -= BLK) {
    if (v < D) {
      float r[BLK];
#pragma unroll
      for (int t = 0; t < BLK; ++t) r[t] = buf[(r0 + t) * LD + v];
#pragma unroll
      for (int j = BLK - 1; j >= 0; --j) {
        const float x = r[j];
        buf[(r0 + j) * LD + v] = x;
        const float bx = sBeta[r0 + j] * x;
#pragma unroll
        for (int t = 0; t < j; ++t) r[t] = fmaf(-sA[(r0 + j) * C + r0 + t], bx, r[t]);
      }
    }
    __syncthreads();
    if (r0 > 0) {
      block_update(buf, sA, sBeta, r0, 0, r0, true, true);
      __syncthreads();
    }
  }
}

__device__ __forceinline__ long long row_offset(const KdaArgs& a, int b, int s, int h) {
  return ((static_cast<long long>(b) * a.S + s) * a.H + h) * D;
}

template <typename T>
__global__ void __launch_bounds__(NT, 1) kda_fwd(KdaArgs a) {
  extern __shared__ float4 kda_smem[];
  float* sQ = reinterpret_cast<float*>(kda_smem);
  float* sK = sQ + TILE;
  float* sG = sK + TILE;
  float* sV = sG + TILE;  // v, then R, then U
  float* sX = sV + TILE;  // k or q times a decay
  float* sS = sX + TILE;  // the state, [c][v]
  float* sA = sS + STATE;
  float* sP = sA + PAIRS;
  float* sBeta = sP + PAIRS;
  float* sRq = sBeta + C;
  float* sRk = sRq + C;
  const int tid = threadIdx.x, bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int n = (a.S + C - 1) / C;
  const int rg = tid >> 5, r0 = 6 * rg, n0 = 4 * (tid & 31);
  for (int ci = 0; ci < n; ++ci) {
    const int s0 = ci * C, nv = imin(C, a.S - s0);
    load_chunk<T>(a, b, h, s0, nv, sQ, sK, sG, sBeta, sRq, sRk);
    build_pairs(sQ, sK, sG, sA, sP, false, sV, sX);
    load_rows(sV, static_cast<const T*>(a.v), b * a.sv[0] + s0 * a.sv[1] + h * a.sv[2], a.sv[1],
              a.sv[3], nv, (a.vec & 4) != 0);
    float acc[6][4];
#pragma unroll
    for (int i = 0; i < 6; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    if (ci > 0) {  // the incoming state: R = V - (k e^Gamma) S0, then (q e^Gamma) S0
      fill_decayed(sX, sK, sG, false, nullptr, 1.f);
      __syncthreads();
      mm_nn<6>(acc, sX, LD, r0, sS, SLD, n0, 0, D);
#pragma unroll
      for (int i = 0; i < 6; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sV[(r0 + i) * LD + n0 + j] -= acc[i][j];
          acc[i][j] = 0.f;
        }
      __syncthreads();
      fill_decayed(sX, sQ, sG, false, nullptr, 1.f);
      __syncthreads();
      mm_nn<6>(acc, sX, LD, r0, sS, SLD, n0, 0, D);
    }
    __syncthreads();
    solve_lower(sV, sA, sBeta, true);
    mm_nn<6>(acc, sP, C, r0, sV, LD, n0, 0, imin(C, (r0 + 6 + 3) & ~3));  // + P U
#pragma unroll
    for (int i = 0; i < 6; ++i)
      if (r0 + i < nv)
        st4(a.o + row_offset(a, b, s0 + r0 + i, h) + n0,
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
    if (ci + 1 < n) {  // S1 = Diag(e^Gamma_L) S0 + (k e^(Gamma_L - Gamma))^T U
      fill_decayed(sX, sK, sG, true, nullptr, 1.f);
      __syncthreads();
      const int c0 = 16 * rg;
      float st[16][4];
#pragma unroll
      for (int i = 0; i < 16; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) st[i][j] = 0.f;
      mm_tn<16>(st, sX, LD, c0, sV, LD, n0, 0, C);
      float* saved = a.states == nullptr ? nullptr
                     : a.states + (static_cast<long long>(bh) * (n - 1) + ci) * D * D;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int c = c0 + i;
        float4 s = make_float4(st[i][0], st[i][1], st[i][2], st[i][3]);
        if (ci > 0) {
          const float e = decay(sG[(C - 1) * LD + c]);
          const float4 old = ld4(sS + c * SLD + n0);
          s.x = fmaf(e, old.x, s.x);
          s.y = fmaf(e, old.y, s.y);
          s.z = fmaf(e, old.z, s.z);
          s.w = fmaf(e, old.w, s.w);
        }
        st4(sS + c * SLD + n0, s);
        if (saved != nullptr) st4(saved + c * D + n0, s);
      }
    }
    __syncthreads();
  }
}

// The gradients through A and P (dA, dP in sA, sP as [t][j]) of a thread's 6
// rows x 4 channels, added to q's (gq), k's (gk) and Gamma's (gg) sums there:
// each row's pairs with earlier positions (j <= t) and with later ones, the
// weight a running product of the tokens' decays sE.
__device__ __noinline__ void pair_grads(const float* sQ, const float* sK, const float* sE,
                                      const float* sA, const float* sP, float* gq, float* gk,
                                      float* gg, int r0, int n0) {
  float rq[6][4], rk[6][4], dr[6][4];
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      rq[i][j] = rk[i][j] = 0.f;
      dr[i][j] = 1.f;
    }
#pragma unroll 2
  for (int j = r0 + 5; j >= 0; --j) {
    const float4 kv = ld4(sK + j * LD + n0), ev = ld4(sE + j * LD + n0);
    const float kj[4] = {kv.x, kv.y, kv.z, kv.w}, e[4] = {ev.x, ev.y, ev.z, ev.w};
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      const int t = r0 + i;
      if (j > t) continue;
      const float dp = sP[t * C + j], da = sA[t * C + j];
#pragma unroll
      for (int ch = 0; ch < 4; ++ch) {
        const float x = kj[ch] * dr[i][ch];
        rq[i][ch] = fmaf(dp, x, rq[i][ch]);
        rk[i][ch] = fmaf(da, x, rk[i][ch]);
        dr[i][ch] *= e[ch];  // the weight of the pair (t, j - 1)
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const int o = (r0 + i) * LD + n0;
    const float4 qv = ld4(sQ + o), kv = ld4(sK + o);
    const float qa[4] = {qv.x, qv.y, qv.z, qv.w}, ka[4] = {kv.x, kv.y, kv.z, kv.w};
    const float4 pq = ld4(gq + o), pk = ld4(gk + o), pg = ld4(gg + o);
    float fq[4] = {pq.x, pq.y, pq.z, pq.w}, fk[4] = {pk.x, pk.y, pk.z, pk.w};
    float fg[4] = {pg.x, pg.y, pg.z, pg.w};
#pragma unroll
    for (int ch = 0; ch < 4; ++ch) {
      fq[ch] += rq[i][ch];
      fk[ch] += rk[i][ch];
      fg[ch] += qa[ch] * rq[i][ch] + ka[ch] * rk[i][ch];
    }
    st4(gq + o, make_float4(fq[0], fq[1], fq[2], fq[3]));
    st4(gk + o, make_float4(fk[0], fk[1], fk[2], fk[3]));
    st4(gg + o, make_float4(fg[0], fg[1], fg[2], fg[3]));
  }
  float ck[6][4];
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      ck[i][j] = 0.f;
      dr[i][j] = 1.f;
    }
#pragma unroll 2
  for (int t = r0; t < C; ++t) {
    const float4 kv = ld4(sK + t * LD + n0), qv = ld4(sQ + t * LD + n0);
    const float4 ev = ld4(sE + t * LD + n0);
    const float kt[4] = {kv.x, kv.y, kv.z, kv.w}, qt[4] = {qv.x, qv.y, qv.z, qv.w};
    const float e[4] = {ev.x, ev.y, ev.z, ev.w};
    float da6[6], dp6[6];  // row t's entries at the thread's 6 columns (8-byte aligned)
#pragma unroll
    for (int i = 0; i < 6; i += 2) {
      const float2 x = *reinterpret_cast<const float2*>(sA + t * C + r0 + i);
      const float2 y = *reinterpret_cast<const float2*>(sP + t * C + r0 + i);
      da6[i] = x.x;
      da6[i + 1] = x.y;
      dp6[i] = y.x;
      dp6[i + 1] = y.y;
    }
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      const int j = r0 + i;
      if (t < j) continue;
      const float da = da6[i], dp = dp6[i];
#pragma unroll
      for (int ch = 0; ch < 4; ++ch) {
        if (t > j) dr[i][ch] *= e[ch];  // the weight of the pair (t, j)
        ck[i][ch] = fmaf(fmaf(da, kt[ch], dp * qt[ch]), dr[i][ch], ck[i][ch]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const int o = (r0 + i) * LD + n0;
    const float4 kv = ld4(sK + o);
    const float ka[4] = {kv.x, kv.y, kv.z, kv.w};
    const float4 pk = ld4(gk + o), pg = ld4(gg + o);
    float fk[4] = {pk.x, pk.y, pk.z, pk.w}, fg[4] = {pg.x, pg.y, pg.z, pg.w};
#pragma unroll
    for (int ch = 0; ch < 4; ++ch) {
      fk[ch] += ck[i][ch];
      fg[ch] -= ka[ch] * ck[i][ch];
    }
    st4(gk + o, make_float4(fk[0], fk[1], fk[2], fk[3]));
    st4(gg + o, make_float4(fg[0], fg[1], fg[2], fg[3]));
  }
}

template <typename T>
__global__ void __launch_bounds__(NT, 1) kda_bwd(KdaArgs a) {
  extern __shared__ float4 kda_smem[];
  float* sQ = reinterpret_cast<float*>(kda_smem);
  float* sK = sQ + TILE;
  float* sG = sK + TILE;
  float* sB1 = sG + TILE;  // v, R, W; Q e^Gamma; dO; then q's gradient
  float* sB2 = sB1 + TILE;  // k times a decay, dU, dX; then k's gradient
  float* sS = sB2 + TILE;   // S0, dS1, dO (and -beta k e^Gamma behind it); then Gamma's
                            // gradient, and the tokens' decays behind it
  float* sA = sS + STATE;   // A, then dA
  float* sP = sA + PAIRS;   // P^T, then dP
  float* sBeta = sP + PAIRS;
  float* sRq = sBeta + C;
  float* sRk = sRq + C;
  float* sEL = sRk + C;     // d e^Gamma_L through S0 (D)
  float* sGLp = sEL + D;    // Gamma_L's gradient through dK^d, a row group's share (8 x D)
  const T* v_in = static_cast<const T*>(a.v);
  const int tid = threadIdx.x, bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int n = (a.S + C - 1) / C;
  const int lane = tid & 31, rg = tid >> 5, r0 = 6 * rg, n0 = 4 * lane;
  const long long dstride = static_cast<long long>(a.H) * D;  // dO's token stride
  float* dS = a.dstate == nullptr ? nullptr : a.dstate + static_cast<long long>(bh) * D * D;
  for (int ci = n - 1; ci >= 0; --ci) {
    const int s0 = ci * C, nv = imin(C, a.S - s0);
    const bool has_s0 = ci > 0, has_ds = ci + 1 < n;
    const float* S0 = has_s0 ? a.states + (static_cast<long long>(bh) * (n - 1) + ci - 1) * D * D
                             : nullptr;
    const long long o_row = row_offset(a, b, s0, h);
    load_chunk<T>(a, b, h, s0, nv, sQ, sK, sG, sBeta, sRq, sRk);
    build_pairs(sQ, sK, sG, sA, sP, true, sB1, sB2);

    // R = V - (k e^Gamma) S0, then W by forward substitution
    load_rows(sB1, v_in, b * a.sv[0] + s0 * a.sv[1] + h * a.sv[2], a.sv[1], a.sv[3], nv,
              (a.vec & 4) != 0);
    if (has_s0) {
      load_state(sS, S0, false);
      fill_decayed(sB2, sK, sG, false, nullptr, 1.f);
    }
    __syncthreads();
    if (has_s0) {
      float r[6][4];
#pragma unroll
      for (int i = 0; i < 6; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) r[i][j] = 0.f;
      mm_nn<6>(r, sB2, LD, r0, sS, SLD, n0, 0, D);
#pragma unroll
      for (int i = 0; i < 6; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sB1[(r0 + i) * LD + n0 + j] -= r[i][j];
      __syncthreads();
    }
    load_rows(sS, a.dout, o_row, dstride, 1, nv, (a.vec & 16) != 0);  // dO: sS is free
    solve_lower(sB1, sA, sBeta, false);

    // dU = P^T dO + (k e^(Gamma_L - Gamma)) dS1, then dX by back substitution
    float du[6][4];
#pragma unroll
    for (int i = 0; i < 6; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) du[i][j] = 0.f;
    mm_nn<6>(du, sP, C, r0, sS, LD, n0, r0 & ~3, C);
    if (has_ds) {
      __syncthreads();
      load_state(sS, dS, false);
      fill_decayed(sB2, sK, sG, true, nullptr, 1.f);
      __syncthreads();
      mm_nn<6>(du, sB2, LD, r0, sS, SLD, n0, 0, D);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 6; ++i)
      st4(sB2 + (r0 + i) * LD + n0, make_float4(du[i][0], du[i][1], du[i][2], du[i][3]));
    __syncthreads();
    solve_upper(sB2, sA, sBeta);

    // dV = Diag(beta) dX; dbeta_t = dX_t . W_t
    {
      T* dv = static_cast<T*>(a.dv);
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        const int t = r0 + i;
        if (t >= nv) continue;
        const float bt = sBeta[t];
        const float4 x = ld4(sB2 + t * LD + n0);
        T* dst = dv + o_row + static_cast<long long>(t) * dstride + n0;
        dst[0] = from_f<T>(bt * x.x);
        dst[1] = from_f<T>(bt * x.y);
        dst[2] = from_f<T>(bt * x.z);
        dst[3] = from_f<T>(bt * x.w);
      }
      for (int t = rg; t < C; t += NT / 32) {
        const float4 x = ld4(sB2 + t * LD + n0), w = ld4(sB1 + t * LD + n0);
        const float s = warp_sum(x.x * w.x + x.y * w.y + x.z * w.z + x.w * w.w);
        if (lane == 0 && t < nv)
          a.dbeta[(static_cast<long long>(b) * a.S + s0 + t) * a.H + h] = s;
      }
    }

    // the gradients of q, k and Gamma, a thread's 6 rows x 4 channels
    float gq[6][4], gk[6][4], gg[6][4];
#pragma unroll
    for (int i = 0; i < 6; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) gq[i][j] = gk[i][j] = gg[i][j] = 0.f;

    // through the outgoing state: dK^d = Diag(beta) W dS1^T; d e^Gamma_L = rowsum(S0 * dS1)
    if (has_ds) {
      __syncthreads();
      load_state(sS, dS, true);
      __syncthreads();
      float x[6][4];
#pragma unroll
      for (int i = 0; i < 6; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) x[i][j] = 0.f;
      mm_nn<6>(x, sB1, LD, r0, sS, SLD, n0, 0, D);
      float col[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        const int t = r0 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = n0 + j;
          const float d = sBeta[t] * x[i][j] * decay(sG[(C - 1) * LD + c] - sG[t * LD + c]);
          const float kd = sK[t * LD + c] * d;
          gk[i][j] += d;
          gg[i][j] -= kd;
          col[j] += kd;
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) sGLp[rg * D + n0 + j] = col[j];
      for (int c = rg; c < D; c += NT / 32) {
        float s = 0.f;
        if (has_s0) {
          const float4 p = ld4(S0 + c * D + n0), d = ld4(dS + c * D + n0);
          s = warp_sum(p.x * d.x + p.y * d.y + p.z * d.z + p.w * d.w);
        }
        if (lane == 0) sEL[c] = s;
      }
    } else {
      for (int i = tid; i < 9 * D; i += NT) sEL[i] = 0.f;  // sEL and sGLp
    }
    __syncthreads();

    // dA = -Diag(beta) dX U^T, dP = dO U^T (U = Diag(beta) W), over 3 x 3 tiles
    load_rows(sS, a.dout, o_row, dstride, 1, nv, (a.vec & 16) != 0);
    __syncthreads();
    {
      const int ti = tid >> 4, tj = tid & 15;
      float xa[3][3], xp[3][3];
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) xa[i][j] = xp[i][j] = 0.f;
      if (tj <= ti) {
        for (int k = 0; k < D; k += 4) {
          float4 dx[3], dov[3], wv[3];
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            dx[i] = ld4(sB2 + (3 * ti + i) * LD + k);
            dov[i] = ld4(sS + (3 * ti + i) * LD + k);
            wv[i] = ld4(sB1 + (3 * tj + i) * LD + k);
          }
#pragma unroll
          for (int i = 0; i < 3; ++i)
#pragma unroll
            for (int j = 0; j < 3; ++j) {
              xa[i][j] = fmaf(dx[i].x, wv[j].x, xa[i][j]);
              xa[i][j] = fmaf(dx[i].y, wv[j].y, xa[i][j]);
              xa[i][j] = fmaf(dx[i].z, wv[j].z, xa[i][j]);
              xa[i][j] = fmaf(dx[i].w, wv[j].w, xa[i][j]);
              xp[i][j] = fmaf(dov[i].x, wv[j].x, xp[i][j]);
              xp[i][j] = fmaf(dov[i].y, wv[j].y, xp[i][j]);
              xp[i][j] = fmaf(dov[i].z, wv[j].z, xp[i][j]);
              xp[i][j] = fmaf(dov[i].w, wv[j].w, xp[i][j]);
            }
        }
      }
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const int t = 3 * ti + i, jj = 3 * tj + j;
          const float bj = sBeta[jj];
          sA[t * C + jj] = jj < t ? -sBeta[t] * bj * xa[i][j] : 0.f;
          sP[t * C + jj] = jj <= t ? bj * xp[i][j] : 0.f;
        }
    }

    // dS0 = Diag(e^Gamma_L) dS1 + (q e^Gamma)^T dO - (k e^Gamma)^T Diag(beta) dX, into the scratch
    if (has_s0) {
      __syncthreads();  // every tile of dA, dP has read W
      float* kb = sS + TILE;
      fill_decayed(sB1, sQ, sG, false, nullptr, 1.f);
      fill_decayed(kb, sK, sG, false, sBeta, -1.f);
      __syncthreads();
#pragma unroll 1
      for (int pass = 0; pass < 2; ++pass) {
        const int c0 = 64 * pass + 8 * rg;
        float ds[8][4];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) ds[i][j] = 0.f;
        mm_tn<8>(ds, sB1, LD, c0, sS, LD, n0, 0, C);
        mm_tn<8>(ds, kb, LD, c0, sB2, LD, n0, 0, C);
        float4 d1[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          d1[i] = has_ds ? ld4(dS + (c0 + i) * D + n0) : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float e = has_ds ? decay(sG[(C - 1) * LD + c0 + i]) : 0.f;
          st4(dS + (c0 + i) * D + n0,
              make_float4(fmaf(e, d1[i].x, ds[i][0]), fmaf(e, d1[i].y, ds[i][1]),
                          fmaf(e, d1[i].z, ds[i][2]), fmaf(e, d1[i].w, ds[i][3])));
        }
      }
      __syncthreads();

      // through the incoming state: dQ^e = dO S0^T, dK^e = -Diag(beta) dX S0^T
      load_state(sS, S0, true);
      load_rows(sB1, a.dout, o_row, dstride, 1, nv, (a.vec & 16) != 0);
      __syncthreads();
      float x[6][4];
#pragma unroll
      for (int i = 0; i < 6; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) x[i][j] = 0.f;
      mm_nn<6>(x, sB1, LD, r0, sS, SLD, n0, 0, D);
#pragma unroll
      for (int i = 0; i < 6; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int t = r0 + i, c = n0 + j;
          const float d = x[i][j] * decay(sG[t * LD + c]);
          gq[i][j] += d;
          gg[i][j] = fmaf(sQ[t * LD + c], d, gg[i][j]);
          x[i][j] = 0.f;
        }
      mm_nn<6>(x, sB2, LD, r0, sS, SLD, n0, 0, D);
#pragma unroll
      for (int i = 0; i < 6; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int t = r0 + i, c = n0 + j;
          const float d = -sBeta[t] * x[i][j] * decay(sG[t * LD + c]);
          gk[i][j] += d;
          gg[i][j] = fmaf(sK[t * LD + c], d, gg[i][j]);
        }
    }
    __syncthreads();

    // park the sums: q's in sB1, k's in sB2, Gamma's in sS
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      const int o = (r0 + i) * LD + n0;
      st4(sB1 + o, make_float4(gq[i][0], gq[i][1], gq[i][2], gq[i][3]));
      st4(sB2 + o, make_float4(gk[i][0], gk[i][1], gk[i][2], gk[i][3]));
      st4(sS + o, make_float4(gg[i][0], gg[i][1], gg[i][2], gg[i][3]));
    }

    // each token's decay exp(g_t) = exp(Gamma_t - Gamma_(t-1)), behind Gamma's sums
    float* sE = sS + TILE;
    for (int i = tid; i < C * D; i += NT) {
      const int t = i / D, c = i % D;
      sE[t * LD + c] = t ? decay(sG[t * LD + c] - sG[(t - 1) * LD + c]) : 1.f;
    }
    __syncthreads();

    pair_grads(sQ, sK, sE, sA, sP, sB1, sB2, sS, r0, n0);
    __syncthreads();

    // g's gradient: Gamma's summed from the chunk's end (Gamma_L's own terms at row L)
    if (tid < D) {
      const int c = tid;
      float extra = sEL[c] * decay(sG[(C - 1) * LD + c]);
#pragma unroll
      for (int w = 0; w < NT / 32; ++w) extra += sGLp[w * D + c];
      float run = extra;
#pragma unroll
      for (int t = C - 1; t >= 0; --t) {
        run += sS[t * LD + c];
        if (t < nv) a.dg[o_row + static_cast<long long>(t) * dstride + c] = run;
      }
    }
    // q's and k's: back through the L2 norms (q's scale included)
    {
      T* dq = static_cast<T*>(a.dq);
      T* dk = static_cast<T*>(a.dk);
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        const int t = r0 + i, o = t * LD + n0;
        const float4 qv = ld4(sQ + o), kv = ld4(sK + o), pq = ld4(sB1 + o), pk = ld4(sB2 + o);
        const float dotq = warp_sum(qv.x * pq.x + qv.y * pq.y + qv.z * pq.z + qv.w * pq.w);
        const float dotk = warp_sum(kv.x * pk.x + kv.y * pk.y + kv.z * pk.z + kv.w * pk.w);
        if (t >= nv) continue;
        const float rq = sRq[t], rk = sRk[t], sc = a.scale, yq = dotq / (sc * sc);
        T* oq = dq + o_row + static_cast<long long>(t) * dstride + n0;
        T* ok = dk + o_row + static_cast<long long>(t) * dstride + n0;
        oq[0] = from_f<T>(rq * sc * (pq.x - qv.x * yq));
        oq[1] = from_f<T>(rq * sc * (pq.y - qv.y * yq));
        oq[2] = from_f<T>(rq * sc * (pq.z - qv.z * yq));
        oq[3] = from_f<T>(rq * sc * (pq.w - qv.w * yq));
        ok[0] = from_f<T>(rk * (pk.x - kv.x * dotk));
        ok[1] = from_f<T>(rk * (pk.y - kv.y * dotk));
        ok[2] = from_f<T>(rk * (pk.z - kv.z * dotk));
        ok[3] = from_f<T>(rk * (pk.w - kv.w * dotk));
      }
    }
    __syncthreads();
  }
}

template <typename T>
cudaError_t run(int kind, const KdaArgs& a, cudaStream_t st) {
  const unsigned blocks = static_cast<unsigned>(a.B * a.H);
  cudaError_t err;
  if (kind == 0) {
    err = cudaFuncSetAttribute(kda_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(FWD_SMEM));
    if (err != cudaSuccess) return err;
    kda_fwd<T><<<blocks, NT, FWD_SMEM, st>>>(a);
  } else {
    err = cudaFuncSetAttribute(kda_bwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(BWD_SMEM));
    if (err != cudaSuccess) return err;
    kda_bwd<T><<<blocks, NT, BWD_SMEM, st>>>(a);
  }
  return cudaGetLastError();
}

}  // namespace

// kind 0: the forward (o; the states at the chunk boundaries where `states`
// is given); kind 1: the backward (dq, dk, dv, dg, dbeta from the saved
// inputs, the states and dO; dstate a scratch of one state a (row, head)
// where S > 48). `strides`: q's, k's, v's and g's four, then beta's three.
// q, k and v share one type, bf16 (x_bf16) or fp32. Returns a CUDA error, 0
// on success.
extern "C" int kda_launch(int kind, int x_bf16, const void* q, const void* k, const void* v,
                          const void* g, const void* beta, const long long* strides, void* o,
                          void* states, const void* dout, void* dq, void* dk, void* dv, void* dg,
                          void* dbeta, void* dstate, int B, int S, int H, float scale,
                          void* stream) {
  if (kind < 0 || kind > 1 || B < 1 || S < 1 || H < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n = (S + C - 1) / C;
  if (n > 1 && states == nullptr && kind == 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 1 && dstate == nullptr && kind == 1) return static_cast<int>(cudaErrorInvalidValue);
  KdaArgs a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.g = static_cast<const float*>(g);
  a.beta = static_cast<const float*>(beta);
  for (int i = 0; i < 4; ++i) {
    a.sq[i] = strides[i];
    a.sk[i] = strides[4 + i];
    a.sv[i] = strides[8 + i];
    a.sg[i] = strides[12 + i];
  }
  for (int i = 0; i < 3; ++i) a.sb[i] = strides[16 + i];
  a.o = static_cast<float*>(o);
  a.states = static_cast<float*>(states);
  a.dout = static_cast<const float*>(dout);
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.dg = static_cast<float*>(dg);
  a.dbeta = static_cast<float*>(dbeta);
  a.dstate = static_cast<float*>(dstate);
  a.B = B;
  a.S = S;
  a.H = H;
  a.scale = scale;
  // 16-byte loads of a whole chunk: the data 16-byte aligned, the fast axis
  // (channels, else tokens) of stride 1, every other stride a multiple of a
  // vector, so that each chunk's vectors (chunks start at multiples of 48)
  // are aligned
  const long long xn = x_bf16 ? 8 : 4;
  auto vec_ok = [](const void* p, const long long* st, long long n) {
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
    const int fast = st[3] == 1 ? 3 : st[1] == 1 ? 1 : -1;
    if (fast < 0) return false;
    for (int i = 0; i < 4; ++i)
      if (i != fast && st[i] % n) return false;
    return true;
  };
  const long long sdo[4] = {static_cast<long long>(S) * H * D, static_cast<long long>(H) * D, D, 1};
  a.vec = (vec_ok(q, a.sq, xn) ? 1 : 0) | (vec_ok(k, a.sk, xn) ? 2 : 0) |
          (vec_ok(v, a.sv, xn) ? 4 : 0) | (vec_ok(g, a.sg, 4) ? 8 : 0) |
          (dout != nullptr && vec_ok(dout, sdo, 4) ? 16 : 0);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = x_bf16 ? run<bf16>(kind, a, st) : run<float>(kind, a, st);
  return static_cast<int>(err);
}
