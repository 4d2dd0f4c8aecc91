// The attention core of multi-head latent attention on Hopper (sm_90a):
// models/deepseek_v3.py LatentAttention, from the projections' outputs to
// the context that o_proj reads, forward and backward.
//
// Replaces no kernel of the JAX package, which has no MLA. Added because the
// plain version (ops/mla_attention.py mla_attention_reference) runs about 30
// eager operations a call (fp32 copies of q and k, the cats that build them,
// an fp32 SIMT product, (B, heads, S, S) fp32 scores through a divide, the
// mask, the softmax and a cast) and moves about 9 GB a layer for under 1 GB
// of inputs and outputs.
//
// Widths: Moonlight-16B-A3B's, 128 nope + 64 rope dimensions of q and k, v
// 128 (the wrapper refuses others). Inputs, read in place:
//   q     (B, S, H, 192)    q_proj's output
//   kv    (B, S, H, 256)    kv_b_proj's output: k_nope | v
//   k_pe  (B, S, 64)        one rope key for every head, through its strides
//                           (the last 64 columns of kv_a_proj_with_mqa's output)
//   cos, sin (>= S, 64)     rope_tables, fp32
// Outputs: the context (B, S, H * 128) in o_proj's layout and one
// log-sum-exp a row (B * H, S); the backward writes dq and d(k_nope, v) in
// q's and kv's layouts, delta (B * H, S), and each head's d k_pe in fp32
// (B, S, H, 64), which the wrapper sums over the heads.
//
// Bound on an H100 SXM: at the Moonlight cell's shapes (T = 24,576 positions
// a call, 16 heads, S of 48 and 96) a forward does about 9 GFLOP of causal
// products against 0.45 GB of inputs and outputs: the bytes bound it (0.14 ms
// at 3.35 TB/s, against 0.01 ms of bf16 tensor-core time), and the backward
// likewise (0.24 ms). So every S x S tile stays in registers, each input is
// read once a block in place through its strides (no split, transpose or
// expand), the rope dimensions are rotated in shared memory, and the forward
// writes only the context and the log-sum-exp.
//
// Design (bf16):
// - Products on the tensor cores, mma.sync m16n8k16 bf16 -> fp32. A warp owns
//   16 rows (queries in the forward and dq, keys in dkv); operands sit in
//   shared memory, rows padded by 16 bytes so that the fragment loads are
//   conflict-free. Two shapes of product cover all six: rows x rows^T
//   (nt_product: q.k, dO.v and their transposes) and register fragments x
//   rows (nn_product: P.v, dS.k, P^T.dO, dS^T.q; B read by ldmatrix.trans).
//   The product's fp32 accumulator becomes the next product's bf16 operand
//   in registers (to_frags), so P and dS never reach shared memory.
// - Tiles come by cp.async, rope parts as they are; once its own copies have
//   landed, each thread rotates the pieces it copied (rotate_qk): each pair
//   (x[2i], x[2i+1]) where it lies, in fp32, rounded to bf16 once, as
//   apply_rope(...).to(dt) does. The rotated dimensions enter only q.k, so
//   the dot product is the same sum in another order. The gradients of the
//   rotated pairs go back through the rotation in fp32 and are rounded once.
//   Loading the rope parts through registers instead, one DRAM round trip
//   after another, cost a fifth of the forward (PERF.md, M1).
// - Forward: a block of BN queries of one (batch, head), BN / 16 warps, keys
//   in blocks of BN; BN is 48 or 96, the smallest that holds S, and 96 past
//   that. At S <= 96 (the main path) one block reads each (batch, head)'s q,
//   k and v once (64-query blocks read k and v twice at S 96). Two passes over the key blocks: the first takes each row's
//   maximum and sum (online softmax), the second normalises P before its one
//   rounding to bf16 and takes P.v. Where one key block holds every key the
//   rows see, the second pass reuses the first pass's logits in registers;
//   past that it loads and computes them again: one body, the same rounding
//   points, the logits computed twice only where the keys do not fit.
// - dq: the same two passes over 48-key blocks for 48-query blocks: the
//   first takes delta = sum_j P dP from fp32 P and fp32 dP, the second dS =
//   P (dP - delta) scale and dS.k. Its 16 x 192 fp32 accumulator leaves no
//   registers for 96-key tiles (they spilled and ran slower).
// - dkv: a block of 64 keys of one (batch, head) in 4 warps, walking the
//   16-query blocks at or after its first key, the next block's copies in
//   flight while this one is used; each warp accumulates its 16 keys' dk
//   (192) and dv (128) in registers and writes them once. No atomics: the
//   gradients repeat bit for bit.
// - Rounding: logits from bf16 x bf16 products with fp32 sums (the plain
//   version's fp32 product of bf16-exact values makes the same products);
//   masked logits give P exactly 0; the softmax in fp32 (__expf, within a
//   few fp32 ulps, against P's rounding to bf16 at 2^-8); dP = dO.v^T from
//   bf16 with fp32 sums; dS in fp32, its products with k and q taking dS as
//   a bf16 hi/lo pair (16 bits of mantissa); dv = bf16(P)^T.dO; each
//   gradient rounded to bf16 once (the plain chain rounds dP, the rope parts
//   of dq and dk_pe twice, and dk_pe per head before the head sum).
//
// fp32 (the tests' fp32 model; no cell runs it): one warp per query (forward,
// dq) or key (dkv), lanes across the dimensions, IEEE fp32 products and sums,
// the same two-pass structure and the same outputs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

// The kernels' arguments (at global scope, so that a profiler names a
// kernel mla_attn_fwd<48>(MlaArgs<__nv_bfloat16>) and the like).
template <typename T>
struct MlaArgs {
  const T* q;
  const T* kv;
  const T* kpe;
  const float* cos;
  const float* sin;
  const T* dout;
  T* out;
  float* lse;
  float* delta;
  T* dq;
  T* dkv;
  float* dkpe;
  int S, H, scs, row_blocks;
  long long skp_b, skp_s;
  float scale;
};

namespace {

typedef __nv_bfloat16 bf16;

constexpr int NOPE = 128, ROPE = 64, VD = 128;
constexpr int QK = NOPE + ROPE;  // q and k head width
constexpr int KV = NOPE + VD;    // kv_b_proj's head width
constexpr int DQ_BN = 48;        // dq's key block (and query block)
constexpr int THREADS = 128;     // dkv: 4 warps of 16 keys
constexpr int BK = 64;           // keys per dkv block
constexpr int BQ = 16;           // queries per dkv step
constexpr int QLD = QK + 8;      // shared row strides (elements): +16 bytes
constexpr int VLD = VD + 8;

// ------------------------------------------------------------ helpers

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zeros where !in
__device__ __forceinline__ void cp16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared, zero where !in
__device__ __forceinline__ void cp4(void* dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// This thread's copies, all but the newest PENDING groups, have landed.
template <int PENDING>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// A rope pair (a, b) = (x[2i], x[2i+1]) rotated by (c, s) in fp32, each
// product and the sum rounded as the plain version's x * cos + rot * sin.
__device__ __forceinline__ void rotate(float& a, float& b, float c, float s) {
  const float ya = __fsub_rn(__fmul_rn(a, c), __fmul_rn(b, s));
  const float yb = __fadd_rn(__fmul_rn(b, c), __fmul_rn(a, s));
  a = ya;
  b = yb;
}

// The gradient (ga, gb) of a rotated pair, back through the rotation.
__device__ __forceinline__ void unrotate(float& ga, float& gb, float c, float s) {
  const float da = ga * c + gb * s;
  const float db = gb * c - ga * s;
  ga = da;
  gb = db;
}

template <typename T>
__device__ __forceinline__ const float* table_row(const float* t, const MlaArgs<T>& a, int pos) {
  return t + (size_t)pos * a.scs;
}

// Rows [r0, r0 + ROWS) of one head's q-like rows into shared memory (ROWS x
// QLD): the nope part from `nope` (rows `nstride` apart), the rope part
// from `rope` (rows `rstride` apart), as they are; rotate_qk rotates the
// rope part once they have landed. Rows past S are zeros. The copies are
// started, not committed.
template <int ROWS, int NTHR>
__device__ __forceinline__ void copy_qk(bf16* dst, const bf16* nope, size_t nstride,
                                         const bf16* rope, long long rstride, int r0, int S) {
  for (int i = threadIdx.x; i < ROWS * (NOPE / 8); i += NTHR) {
    const int r = i / (NOPE / 8), c = i % (NOPE / 8), pos = r0 + r;
    const bool in = pos < S;
    cp16(dst + r * QLD + c * 8, in ? nope + pos * nstride + c * 8 : nope, in);
  }
#pragma unroll
  for (int j = 0; j < ROWS * (ROPE / 8) / NTHR; ++j) {
    const int i = threadIdx.x + j * NTHR;
    const int r = i / (ROPE / 8), c = i % (ROPE / 8), pos = r0 + r;
    const bool in = pos < S;
    cp16(dst + r * QLD + NOPE + c * 8, in ? rope + pos * rstride + c * 8 : rope, in);
  }
}

// The rope part of the rows copy_qk copied: each thread takes its cos and
// sin rows, waits for its own copies (all but the newest PENDING groups),
// and rotates the 8-element pieces it copied, in place: pairs in fp32,
// rounded to bf16 once. The caller's barrier publishes them.
template <int ROWS, int NTHR, int PENDING>
__device__ __forceinline__ void rotate_qk(bf16* dst, int r0, const MlaArgs<bf16>& a) {
  constexpr int N = ROWS * (ROPE / 8) / NTHR;
  static_assert(N * NTHR == ROWS * (ROPE / 8), "rope pieces / thread mismatch");
  float4 cv[N], sv[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int i = threadIdx.x + j * NTHR, pos = min(r0 + i / (ROPE / 8), a.S - 1);
    cv[j] = __ldg(reinterpret_cast<const float4*>(table_row(a.cos, a, pos) + i % (ROPE / 8) * 4));
    sv[j] = __ldg(reinterpret_cast<const float4*>(table_row(a.sin, a, pos) + i % (ROPE / 8) * 4));
  }
  cp_wait<PENDING>();
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int i = threadIdx.x + j * NTHR;
    if (r0 + i / (ROPE / 8) >= a.S) continue;
    uint4* at = reinterpret_cast<uint4*>(dst + i / (ROPE / 8) * QLD + NOPE + i % (ROPE / 8) * 8);
    const uint4 x = *at;
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
    const float cc[4] = {cv[j].x, cv[j].y, cv[j].z, cv[j].w};
    const float ss[4] = {sv[j].x, sv[j].y, sv[j].z, sv[j].w};
    uint32_t o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float lo = __uint_as_float(w[e] << 16), hi = __uint_as_float(w[e] & 0xffff0000u);
      rotate(lo, hi, cc[e], ss[e]);
      o[e] = pack(lo, hi);
    }
    *at = make_uint4(o[0], o[1], o[2], o[3]);
  }
}

// Rows [r0, r0 + ROWS) of VD columns at `src` (rows `stride` apart) into
// shared memory (ROWS x VLD); rows past S are zeros. Started, not committed.
template <int ROWS, int NTHR>
__device__ __forceinline__ void copy_rows(bf16* dst, const bf16* src, size_t stride, int r0,
                                          int S) {
  for (int i = threadIdx.x; i < ROWS * (VD / 8); i += NTHR) {
    const int r = i / (VD / 8), c = i % (VD / 8), pos = r0 + r;
    const bool in = pos < S;
    cp16(dst + r * VLD + c * 8, in ? src + pos * stride + c * 8 : src, in);
  }
}

// acc (16 x NT*8) = A . B^T over K columns: A the warp's 16 rows at `x`
// (stride ldx), B the NT*8 rows at `y` (stride ldy), both in shared memory.
// Fragments (g = lane / 4, t = lane % 4): A's rows g, g + 8 at k = 2t, 2t + 1
// and 2t + 8, 2t + 9; B's row g at the same k; C's rows g, g + 8 at
// columns 2t, 2t + 1 of each 8-column tile.
template <int NT, int K>
__device__ __forceinline__ void nt_product(float (&acc)[NT][4], const bf16* x, int ldx,
                                           const bf16* y, int ldy) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += 16) {
    const bf16* xa = x + g * ldx + k0 + 2 * t;
    const uint32_t a[4] = {ld32(xa), ld32(xa + 8 * ldx), ld32(xa + 8), ld32(xa + 8 * ldx + 8)};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const bf16* yb = y + (n * 8 + g) * ldy + k0 + 2 * t;
      mma(acc[n], a, ld32(yb), ld32(yb + 8));
    }
  }
}

// acc (16 x NT*8) += A . B: A in register fragments (16 x KT*16), B the
// KT*16 rows at `y` (stride ldy) of NT*8 columns in shared memory, read
// transposed by ldmatrix (lane l addresses row l % 8 of matrix l / 8: rows
// +0 / +8, columns +0 / +8).
template <int KT, int NT>
__device__ __forceinline__ void nn_product(float (&acc)[NT][4], const uint32_t (&a)[KT][4],
                                           const bf16* y, int ldy) {
  static_assert(NT % 2 == 0, "two column tiles a load");
  const int lane = threadIdx.x & 31;
  const bf16* base = y + (((lane >> 3) & 1) * 8 + (lane & 7)) * ldy + (lane >> 4) * 8;
#pragma unroll
  for (int k = 0; k < KT; ++k)
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) {
      uint32_t b[4];
      ldsm_x4_trans(b, base + k * 16 * ldy + j * 16);
      mma(acc[2 * j], a[k], b[0], b[1]);
      mma(acc[2 * j + 1], a[k], b[2], b[3]);
    }
}

// An accumulator (16 x NT*8, fp32) as A fragments (16 x NT*8, bf16) of the
// next product: hi rounded to bf16, and where lo is given, the remainder
// x - hi rounded again (the hi/lo pair).
template <int NT>
__device__ __forceinline__ void to_frags(uint32_t (&hi)[NT / 2][4], uint32_t (*lo)[4],
                                         const float (&c)[NT][4]) {
#pragma unroll
  for (int k = 0; k < NT / 2; ++k)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = c[2 * k + (e >> 1)][2 * (e & 1)], y = c[2 * k + (e >> 1)][2 * (e & 1) + 1];
      const float hx = __bfloat162float(__float2bfloat16_rn(x));
      const float hy = __bfloat162float(__float2bfloat16_rn(y));
      hi[k][e] = pack(hx, hy);
      if (lo) lo[k][e] = pack(x - hx, y - hy);
    }
}

// Scaled logits with the causal mask: row r0 + g (+8), column n0 + 8n + 2t
// (+1); -inf where the key is after the query or past S.
template <int NT>
__device__ __forceinline__ void scale_mask(float (&s)[NT][4], int r0, int n0, int S,
                                           float scale) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + g + (e >> 1) * 8, col = n0 + n * 8 + 2 * t + (e & 1);
      s[n][e] = col <= row && col < S ? s[n][e] * scale : -INFINITY;
    }
}

// ------------------------------------------------------------ bf16 kernels

// The forward and dq take BN queries a block (BN / 16 warps) and keys in
// blocks of BN.
template <int BN>
constexpr int fwd_smem() {
  return (2 * BN * QLD + BN * VLD) * 2;
}

template <int BN>
constexpr int dq_smem() {
  return (2 * BN * QLD + 2 * BN * VLD) * 2;
}

constexpr int dkv_smem() { return (BK * QLD + BK * VLD) * 2 + 2 * ((BQ * QLD + BQ * VLD) * 2 + 2 * BQ * 4); }

template <int BN>
__global__ void __launch_bounds__(2 * BN, BN <= 48 ? 4 : 2) mla_attn_fwd(const MlaArgs<bf16> a) {
  constexpr int NT = BN / 8, BM = BN, NTHR = 2 * BN;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + BM * QLD;
  bf16* vs = ks + BN * QLD;
  const int S = a.S, H = a.H;
  const int bh = blockIdx.x / a.row_blocks, m0 = (blockIdx.x % a.row_blocks) * BM;
  const int b = bh / H, h = bh % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const size_t qrow = (size_t)H * QK, kvrow = (size_t)H * KV;
  const bf16* qh = a.q + (size_t)b * S * qrow + h * QK;
  const bf16* kvh = a.kv + (size_t)b * S * kvrow + h * KV;
  const bf16* kpe = a.kpe + b * a.skp_b;
  copy_qk<BM, NTHR>(qs, qh, qrow, qh + NOPE, (long long)qrow, m0, S);

  const int r0 = m0 + warp * 16;  // this warp's rows
  const bool active = r0 < S;
  const int nkb = (min(m0 + BM, S) + BN - 1) / BN;  // key blocks these rows see
  float s[NT][4], o[VD / 8][4];
  float mx[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
#pragma unroll
  for (int n = 0; n < VD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;

#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    for (int kb = 0; kb < nkb; ++kb) {
      const int n0 = kb * BN;
      if (pass == 0 || nkb > 1) {
        __syncthreads();  // every warp is done with the last tile
        copy_qk<BN, NTHR>(ks, kvh, kvrow, kpe, a.skp_s, n0, S);
        if (pass == 1 || nkb == 1) copy_rows<BN, NTHR>(vs, kvh + NOPE, kvrow, n0, S);
        cp_commit();
        if (pass == 0 && kb == 0) rotate_qk<BM, NTHR, 0>(qs, m0, a);
        rotate_qk<BN, NTHR, 0>(ks, n0, a);
        __syncthreads();
        if (active) {
          nt_product<NT, QK>(s, qs + warp * 16 * QLD, QLD, ks, QLD);
          scale_mask(s, r0, n0, S, a.scale);
        }
      }
      if (!active) continue;
      if (pass == 0) {  // online maximum and sum
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float m = -INFINITY;
#pragma unroll
          for (int n = 0; n < NT; ++n) m = fmaxf(m, fmaxf(s[n][2 * i], s[n][2 * i + 1]));
          m = fmaxf(mx[i], quad_max(m));
          float sum = 0.0f;
#pragma unroll
          for (int n = 0; n < NT; ++n)
            sum += __expf(s[n][2 * i] - m) + __expf(s[n][2 * i + 1] - m);
          l[i] = l[i] * __expf(mx[i] - m) + quad_sum(sum);
          mx[i] = m;
        }
      } else {  // P normalised in fp32, rounded once, times v
        const float inv[2] = {1.0f / l[0], 1.0f / l[1]};
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] = __expf(s[n][e] - mx[e >> 1]) * inv[e >> 1];
        uint32_t pf[NT / 2][4];
        to_frags<NT>(pf, nullptr, s);
        nn_product<NT / 2, VD / 8>(o, pf, vs, VLD);
      }
    }
  }
  if (!active) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + g + 8 * i;
    if (row >= S) continue;
    if (t == 0) a.lse[(size_t)bh * S + row] = mx[i] + logf(l[i]);
    bf16* dst = a.out + ((size_t)b * S + row) * H * VD + h * VD + 2 * t;
#pragma unroll
    for (int n = 0; n < VD / 8; ++n)
      *reinterpret_cast<uint32_t*>(dst + n * 8) = pack(o[n][2 * i], o[n][2 * i + 1]);
  }
}

template <int BN>
__global__ void __launch_bounds__(2 * BN, 2) mla_attn_bwd_dq(const MlaArgs<bf16> a) {
  constexpr int NT = BN / 8, BM = BN, NTHR = 2 * BN;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + BM * QLD;
  bf16* dos = ks + BN * QLD;
  bf16* vs = dos + BM * VLD;
  const int S = a.S, H = a.H;
  const int bh = blockIdx.x / a.row_blocks, m0 = (blockIdx.x % a.row_blocks) * BM;
  const int b = bh / H, h = bh % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const size_t qrow = (size_t)H * QK, kvrow = (size_t)H * KV, orow = (size_t)H * VD;
  const bf16* qh = a.q + (size_t)b * S * qrow + h * QK;
  const bf16* kvh = a.kv + (size_t)b * S * kvrow + h * KV;
  const bf16* kpe = a.kpe + b * a.skp_b;
  copy_qk<BM, NTHR>(qs, qh, qrow, qh + NOPE, (long long)qrow, m0, S);
  copy_rows<BM, NTHR>(dos, a.dout + (size_t)b * S * orow + h * VD, orow, m0, S);

  const int r0 = m0 + warp * 16;
  const bool active = r0 < S;
  const int nkb = (min(m0 + BM, S) + BN - 1) / BN;
  float lse[2], delta[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + g + 8 * i;
    lse[i] = row < S ? a.lse[(size_t)bh * S + row] : 0.0f;
  }
  float p[NT][4], dp[NT][4], dq[QK / 8][4];
#pragma unroll
  for (int n = 0; n < QK / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.0f;

#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    for (int kb = 0; kb < nkb; ++kb) {
      const int n0 = kb * BN;
      if (pass == 0 || nkb > 1) {
        __syncthreads();
        copy_qk<BN, NTHR>(ks, kvh, kvrow, kpe, a.skp_s, n0, S);
        copy_rows<BN, NTHR>(vs, kvh + NOPE, kvrow, n0, S);
        cp_commit();
        if (pass == 0 && kb == 0) rotate_qk<BM, NTHR, 0>(qs, m0, a);
        rotate_qk<BN, NTHR, 0>(ks, n0, a);
        __syncthreads();
        if (active) {  // P from the log-sum-exp, dP = dO.v^T
          nt_product<NT, QK>(p, qs + warp * 16 * QLD, QLD, ks, QLD);
          scale_mask(p, r0, n0, S, a.scale);
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) p[n][e] = __expf(p[n][e] - lse[e >> 1]);
          nt_product<NT, VD>(dp, dos + warp * 16 * VLD, VLD, vs, VLD);
        }
      }
      if (!active) continue;
      if (pass == 0) {
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) delta[e >> 1] += p[n][e] * dp[n][e];
      } else {  // dS = P (dP - delta) scale, as a hi/lo pair times k
        uint32_t hi[NT / 2][4], lo[NT / 2][4];
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) dp[n][e] = p[n][e] * (dp[n][e] - delta[e >> 1]) * a.scale;
        to_frags<NT>(hi, lo, dp);
        nn_product<NT / 2, QK / 8>(dq, hi, ks, QLD);
        nn_product<NT / 2, QK / 8>(dq, lo, ks, QLD);
      }
    }
    if (pass == 0) {
      delta[0] = quad_sum(delta[0]);
      delta[1] = quad_sum(delta[1]);
    }
  }
  if (!active) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + g + 8 * i;
    if (row >= S) continue;
    if (t == 0) a.delta[(size_t)bh * S + row] = delta[i];
    bf16* dst = a.dq + ((size_t)b * S + row) * qrow + h * QK + 2 * t;
    const float* cs = table_row(a.cos, a, row);
    const float* sn = table_row(a.sin, a, row);
#pragma unroll
    for (int n = 0; n < QK / 8; ++n) {
      float x = dq[n][2 * i], y = dq[n][2 * i + 1];
      if (n * 8 >= NOPE) {
        const int pair = (n * 8 - NOPE) / 2 + t;
        unrotate(x, y, cs[pair], sn[pair]);
      }
      *reinterpret_cast<uint32_t*>(dst + n * 8) = pack(x, y);
    }
  }
}

__global__ void __launch_bounds__(THREADS) mla_attn_bwd_dkv(const MlaArgs<bf16> a) {
  constexpr int NT = BQ / 8;
  constexpr int STEP = (BQ * QLD + BQ * VLD) * 2 + 2 * BQ * 4;  // one query block's tiles
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + BK * QLD;
  unsigned char* ring = reinterpret_cast<unsigned char*>(vs + BK * VLD);  // two STEPs
  const int S = a.S, H = a.H;
  const int bh = blockIdx.x / a.row_blocks, n0 = (blockIdx.x % a.row_blocks) * BK;
  const int b = bh / H, h = bh % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const size_t qrow = (size_t)H * QK, kvrow = (size_t)H * KV, orow = (size_t)H * VD;
  const bf16* qh = a.q + (size_t)b * S * qrow + h * QK;
  const bf16* kvh = a.kv + (size_t)b * S * kvrow + h * KV;
  const bf16* doh = a.dout + (size_t)b * S * orow + h * VD;
  const float* lse = a.lse + (size_t)bh * S;
  const float* dlt = a.delta + (size_t)bh * S;

  // one query block's q (rotated by its consumer), dO, log-sum-exp and delta
  auto copy_step = [&](int m0, int slot) {
    unsigned char* at = ring + slot * STEP;
    bf16* qs = reinterpret_cast<bf16*>(at);
    copy_qk<BQ, THREADS>(qs, qh, qrow, qh + NOPE, (long long)qrow, m0, S);
    copy_rows<BQ, THREADS>(qs + BQ * QLD, doh, orow, m0, S);
    float* ld = reinterpret_cast<float*>(qs + BQ * QLD + BQ * VLD);
    if (threadIdx.x < 2 * BQ) {
      const int j = threadIdx.x % BQ, row = m0 + j;
      cp4(ld + threadIdx.x, (threadIdx.x < BQ ? lse : dlt) + min(row, S - 1), row < S);
    }
    cp_commit();
  };

  const int c0 = n0 + warp * 16;  // this warp's keys
  const bool active = c0 < S;
  float dk[QK / 8][4], dv[VD / 8][4];
#pragma unroll
  for (int n = 0; n < QK / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = 0.0f;
#pragma unroll
  for (int n = 0; n < VD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dv[n][e] = 0.0f;

  // the query blocks with a query at or after this block's first key, two
  // in flight: the next block's copies land while this one is used. The
  // S x S tiles transposed (keys x queries).
  const int first = n0 / BQ * BQ;
  copy_qk<BK, THREADS>(ks, kvh, kvrow, a.kpe + b * a.skp_b, a.skp_s, n0, S);
  copy_rows<BK, THREADS>(vs, kvh + NOPE, kvrow, n0, S);
  copy_step(first, 0);
  rotate_qk<BK, THREADS, 0>(ks, n0, a);
  rotate_qk<BQ, THREADS, 0>(reinterpret_cast<bf16*>(ring), first, a);
  __syncthreads();
  for (int m0 = first, slot = 0; m0 < S; m0 += BQ, slot ^= 1) {
    const bool next = m0 + BQ < S;
    if (next) copy_step(m0 + BQ, slot ^ 1);
    const bf16* qs = reinterpret_cast<const bf16*>(ring + slot * STEP);
    const bf16* dos = qs + BQ * QLD;
    const float* lse_s = reinterpret_cast<const float*>(dos + BQ * VLD);
    const float* delta_s = lse_s + BQ;
    if (active && m0 + BQ > c0) {  // else every query is before these keys
      float pt[NT][4], dpt[NT][4];
      nt_product<NT, QK>(pt, ks + warp * 16 * QLD, QLD, qs, QLD);
      nt_product<NT, VD>(dpt, vs + warp * 16 * VLD, VLD, dos, VLD);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = c0 + g + (e >> 1) * 8, j = n * 8 + 2 * t + (e & 1), row = m0 + j;
          const float pv = key <= row && row < S ? __expf(pt[n][e] * a.scale - lse_s[j]) : 0.0f;
          pt[n][e] = pv;
          dpt[n][e] = pv * (dpt[n][e] - delta_s[j]) * a.scale;
        }
      uint32_t pf[NT / 2][4], hi[NT / 2][4], lo[NT / 2][4];
      to_frags<NT>(pf, nullptr, pt);
      nn_product<NT / 2, VD / 8>(dv, pf, dos, VLD);
      to_frags<NT>(hi, lo, dpt);
      nn_product<NT / 2, QK / 8>(dk, hi, qs, QLD);
      nn_product<NT / 2, QK / 8>(dk, lo, qs, QLD);
    }
    if (next) rotate_qk<BQ, THREADS, 0>(reinterpret_cast<bf16*>(ring + (slot ^ 1) * STEP), m0 + BQ, a);
    __syncthreads();  // the next block is ready, and this one free for the one after
  }
  if (!active) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = c0 + g + 8 * i;
    if (key >= S) continue;
    bf16* dst = a.dkv + ((size_t)b * S + key) * kvrow + h * KV + 2 * t;
#pragma unroll
    for (int n = 0; n < NOPE / 8; ++n)
      *reinterpret_cast<uint32_t*>(dst + n * 8) = pack(dk[n][2 * i], dk[n][2 * i + 1]);
#pragma unroll
    for (int n = 0; n < VD / 8; ++n)
      *reinterpret_cast<uint32_t*>(dst + NOPE + n * 8) = pack(dv[n][2 * i], dv[n][2 * i + 1]);
    // this head's d k_pe in fp32; the wrapper sums the heads
    float* dr = a.dkpe + (((size_t)b * S + key) * H + h) * ROPE + 2 * t;
    const float* cs = table_row(a.cos, a, key);
    const float* sn = table_row(a.sin, a, key);
#pragma unroll
    for (int n = NOPE / 8; n < QK / 8; ++n) {
      float x = dk[n][2 * i], y = dk[n][2 * i + 1];
      const int pair = (n * 8 - NOPE) / 2 + t;
      unrotate(x, y, cs[pair], sn[pair]);
      *reinterpret_cast<float2*>(dr + n * 8 - NOPE) = make_float2(x, y);
    }
  }
}

// ------------------------------------------------------------ fp32 kernels

namespace f32 {

constexpr int ROWS = 4;  // one warp a row

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// A lane's share of one q- or k-row: nope dimensions lane + 32j, then the
// rope pair (2 lane, 2 lane + 1) rotated.
struct Part {
  float x[NOPE / 32 + 2];
};

__device__ __forceinline__ Part load_part(const float* nope, const float* rope, const float* cs,
                                          const float* sn) {
  const int lane = threadIdx.x & 31;
  Part p;
#pragma unroll
  for (int j = 0; j < NOPE / 32; ++j) p.x[j] = nope[lane + 32 * j];
  float ra = rope[2 * lane], rb = rope[2 * lane + 1];
  rotate(ra, rb, cs[lane], sn[lane]);
  p.x[NOPE / 32] = ra;
  p.x[NOPE / 32 + 1] = rb;
  return p;
}

__device__ __forceinline__ float dot(const Part& a, const Part& b) {
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < NOPE / 32 + 2; ++j) s = fmaf(a.x[j], b.x[j], s);
  return warp_sum(s);
}

__device__ __forceinline__ float vdot(const float* x, const float* y) {
  const int lane = threadIdx.x & 31;
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < VD / 32; ++j) s = fmaf(x[lane + 32 * j], y[lane + 32 * j], s);
  return warp_sum(s);
}

// The forward (kind 0) and dq (kind 1) of one query row: pass 1 fills the
// row's logits (or P and dP) in shared memory, pass 2 uses them.
template <int KIND>
__global__ void __launch_bounds__(ROWS * 32) mla_attn_rows(const MlaArgs<float> a) {
  extern __shared__ float buf[];  // per warp: 2 S floats
  const int S = a.S, H = a.H, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int bh = blockIdx.x / a.row_blocks;
  const int row = (blockIdx.x % a.row_blocks) * ROWS + warp;
  const int b = bh / H, h = bh % H;
  if (row >= S) return;
  float* sl = buf + warp * 2 * S;
  float* dpl = sl + S;
  const size_t qrow = (size_t)H * QK, kvrow = (size_t)H * KV, orow = (size_t)H * VD;
  const float* qr = a.q + ((size_t)b * S + row) * qrow + h * QK;
  const float* kvh = a.kv + (size_t)b * S * kvrow + h * KV;
  const float* kpe = a.kpe + b * a.skp_b;
  const Part q = load_part(qr, qr + NOPE, table_row(a.cos, a, row), table_row(a.sin, a, row));
  const float* dor = a.dout + ((size_t)b * S + row) * orow + h * VD;
  const float lse = KIND == 1 ? a.lse[(size_t)bh * S + row] : 0.0f;
  float mx = -INFINITY;
  for (int j = 0; j <= row; ++j) {
    const Part k = load_part(kvh + j * kvrow, kpe + j * a.skp_s, table_row(a.cos, a, j),
                             table_row(a.sin, a, j));
    const float s = dot(q, k) * a.scale;
    if (KIND == 0) {
      mx = fmaxf(mx, s);
      if (lane == 0) sl[j] = s;
    } else {
      const float dp = vdot(dor, kvh + j * kvrow + NOPE);
      if (lane == 0) {
        sl[j] = expf(s - lse);
        dpl[j] = dp;
      }
    }
  }
  __syncwarp();
  float sum = 0.0f;
  for (int j = lane; j <= row; j += 32)
    sum += KIND == 0 ? expf(sl[j] - mx) : sl[j] * dpl[j];
  sum = warp_sum(sum);
  if (KIND == 0) {  // context = P.v
    float o[VD / 32] = {};
    for (int j = 0; j <= row; ++j) {
      const float p = expf(sl[j] - mx) / sum;
      const float* v = kvh + j * kvrow + NOPE;
#pragma unroll
      for (int d = 0; d < VD / 32; ++d) o[d] = fmaf(p, v[lane + 32 * d], o[d]);
    }
    float* dst = a.out + ((size_t)b * S + row) * orow + h * VD;
#pragma unroll
    for (int d = 0; d < VD / 32; ++d) dst[lane + 32 * d] = o[d];
    if (lane == 0) a.lse[(size_t)bh * S + row] = mx + logf(sum);
  } else {  // dq = dS.k, sum = delta
    Part g = {};
    for (int j = 0; j <= row; ++j) {
      const float ds = sl[j] * (dpl[j] - sum) * a.scale;
      const Part k = load_part(kvh + j * kvrow, kpe + j * a.skp_s, table_row(a.cos, a, j),
                               table_row(a.sin, a, j));
#pragma unroll
      for (int d = 0; d < NOPE / 32 + 2; ++d) g.x[d] = fmaf(ds, k.x[d], g.x[d]);
    }
    float* dst = a.dq + ((size_t)b * S + row) * qrow + h * QK;
#pragma unroll
    for (int d = 0; d < NOPE / 32; ++d) dst[lane + 32 * d] = g.x[d];
    float ga = g.x[NOPE / 32], gb = g.x[NOPE / 32 + 1];
    unrotate(ga, gb, table_row(a.cos, a, row)[lane], table_row(a.sin, a, row)[lane]);
    dst[NOPE + 2 * lane] = ga;
    dst[NOPE + 2 * lane + 1] = gb;
    if (lane == 0) a.delta[(size_t)bh * S + row] = sum;
  }
}

// d(k_nope, v) and this head's d k_pe of one key, over the queries at or
// after it.
__global__ void __launch_bounds__(ROWS * 32) mla_attn_bwd_dkv(const MlaArgs<float> a) {
  const int S = a.S, H = a.H, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int bh = blockIdx.x / a.row_blocks;
  const int key = (blockIdx.x % a.row_blocks) * ROWS + warp;
  const int b = bh / H, h = bh % H;
  if (key >= S) return;
  const size_t qrow = (size_t)H * QK, kvrow = (size_t)H * KV, orow = (size_t)H * VD;
  const float* kvr = a.kv + ((size_t)b * S + key) * kvrow + h * KV;
  const Part k = load_part(kvr, a.kpe + b * a.skp_b + key * a.skp_s, table_row(a.cos, a, key),
                           table_row(a.sin, a, key));
  Part gk = {};
  float gv[VD / 32] = {};
  for (int i = key; i < S; ++i) {
    const float* qr = a.q + ((size_t)b * S + i) * qrow + h * QK;
    const Part q = load_part(qr, qr + NOPE, table_row(a.cos, a, i), table_row(a.sin, a, i));
    const float* dor = a.dout + ((size_t)b * S + i) * orow + h * VD;
    const float p = expf(dot(k, q) * a.scale - a.lse[(size_t)bh * S + i]);
    const float ds = p * (vdot(kvr + NOPE, dor) - a.delta[(size_t)bh * S + i]) * a.scale;
#pragma unroll
    for (int d = 0; d < NOPE / 32 + 2; ++d) gk.x[d] = fmaf(ds, q.x[d], gk.x[d]);
#pragma unroll
    for (int d = 0; d < VD / 32; ++d) gv[d] = fmaf(p, dor[lane + 32 * d], gv[d]);
  }
  float* dst = a.dkv + ((size_t)b * S + key) * kvrow + h * KV;
#pragma unroll
  for (int d = 0; d < NOPE / 32; ++d) dst[lane + 32 * d] = gk.x[d];
#pragma unroll
  for (int d = 0; d < VD / 32; ++d) dst[NOPE + lane + 32 * d] = gv[d];
  float ga = gk.x[NOPE / 32], gb = gk.x[NOPE / 32 + 1];
  unrotate(ga, gb, table_row(a.cos, a, key)[lane], table_row(a.sin, a, key)[lane]);
  float* dr = a.dkpe + (((size_t)b * S + key) * H + h) * ROPE;
  dr[2 * lane] = ga;
  dr[2 * lane + 1] = gb;
}

}  // namespace f32

// ------------------------------------------------------------ launch

// Lets `kernel` take `bytes` of dynamic shared memory on the current
// device, set once per device and size: `allowed` (one per launch site)
// holds the most set so far for each device.
typedef std::atomic<int> Allowed[16];

template <typename K>
cudaError_t allow_smem(K* kernel, int bytes, Allowed& allowed) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || bytes <= allowed[dev & 15].load(std::memory_order_acquire))
    return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) allowed[dev & 15].store(bytes, std::memory_order_release);
  return err;
}

template <typename K>
int launch(K* kernel, int blocks, int threads, int smem, Allowed& allowed, cudaStream_t st,
           const MlaArgs<bf16>& a) {
  cudaError_t err = allow_smem(kernel, smem, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, threads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int BN>
int launch_bf16(int kind, MlaArgs<bf16> a, int bh, cudaStream_t st) {
  static Allowed fwd, dq, dkv;
  if (kind == 0) {
    a.row_blocks = (a.S + BN - 1) / BN;
    return launch(mla_attn_fwd<BN>, bh * a.row_blocks, 2 * BN, fwd_smem<BN>(), fwd, st, a);
  }
  if (kind == 1) {
    a.row_blocks = (a.S + DQ_BN - 1) / DQ_BN;
    return launch(mla_attn_bwd_dq<DQ_BN>, bh * a.row_blocks, 2 * DQ_BN, dq_smem<DQ_BN>(), dq,
                  st, a);
  }
  a.row_blocks = (a.S + BK - 1) / BK;
  return launch(mla_attn_bwd_dkv, bh * a.row_blocks, THREADS, dkv_smem(), dkv, st, a);
}

}  // namespace

// C interface for ctypes. kind: 0 forward (q, kv, kpe, cos, sin -> out, lse),
// 1 dq (+ dout, lse -> dq, delta), 2 dkv (+ dout, lse, delta -> dkv, dkpe).
// fp32 0: bf16 tensors, the key block bn 48 or 96; fp32 1: fp32 tensors (bn
// unused). q, kv, out and dout contiguous; kpe's rows skp_s and batches
// skp_b elements apart, unit stride; cos and sin rows scs apart (bf16: 16-byte
// aligned rows and kpe, scs % 4 == 0, skp_* % 8 == 0; the wrapper checks).
// Launches on `stream`; returns a CUDA error code, 0 on success.
extern "C" int mla_attn_launch(int kind, int fp32, int bn, const void* q, const void* kv,
                               const void* kpe, const void* cos, const void* sin,
                               const void* dout, void* out, void* lse, void* delta, void* dq,
                               void* dkv, void* dkpe, int B, int S, int H, long long skp_b,
                               long long skp_s, int scs, float scale, void* stream) {
  if (B < 1 || S < 1 || H < 1 || kind < 0 || kind > 2 || (long long)B * H * S > (1ll << 40))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* cs = static_cast<const float*>(cos);
  const float* sn = static_cast<const float*>(sin);
  float* fl = static_cast<float*>(lse);
  float* fd = static_cast<float*>(delta);
  float* fk = static_cast<float*>(dkpe);
  const long long bh = (long long)B * H;
  if (fp32) {
    typedef float T;
    MlaArgs<T> a{static_cast<const T*>(q), static_cast<const T*>(kv), static_cast<const T*>(kpe),
              cs, sn, static_cast<const T*>(dout), static_cast<T*>(out), fl, fd,
              static_cast<T*>(dq), static_cast<T*>(dkv), fk, S, H, scs,
              (S + f32::ROWS - 1) / f32::ROWS, skp_b, skp_s, scale};
    const long long blocks = bh * a.row_blocks;
    if (blocks > 0x7fffffffll) return static_cast<int>(cudaErrorInvalidValue);
    const int smem = f32::ROWS * 2 * S * (int)sizeof(float);
    static Allowed rows0, rows1;
    cudaError_t err = cudaSuccess;
    if (kind == 0) {
      err = allow_smem(f32::mla_attn_rows<0>, smem, rows0);
      if (err == cudaSuccess) f32::mla_attn_rows<0><<<(unsigned)blocks, f32::ROWS * 32, smem, st>>>(a);
    } else if (kind == 1) {
      err = allow_smem(f32::mla_attn_rows<1>, smem, rows1);
      if (err == cudaSuccess) f32::mla_attn_rows<1><<<(unsigned)blocks, f32::ROWS * 32, smem, st>>>(a);
    } else {
      f32::mla_attn_bwd_dkv<<<(unsigned)blocks, f32::ROWS * 32, 0, st>>>(a);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
  }
  typedef bf16 T;
  MlaArgs<T> a{static_cast<const T*>(q), static_cast<const T*>(kv), static_cast<const T*>(kpe),
            cs, sn, static_cast<const T*>(dout), static_cast<T*>(out), fl, fd,
            static_cast<T*>(dq), static_cast<T*>(dkv), fk, S, H, scs, 0, skp_b, skp_s, scale};
  if (bh * ((S + 47) / 48) > 0x7fffffffll) return static_cast<int>(cudaErrorInvalidValue);
  if (bn == 48) return launch_bf16<48>(kind, a, (int)bh, st);
  if (bn == 96) return launch_bf16<96>(kind, a, (int)bh, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
