"""Streaming chunk-select search: the huge-corpus scaling path.

Counterpart of rag_icd10_tpu/ops/chunk_stream.py. Replaces the
reference's Milvus FLAT scan (services/milvus_service.py:271-316) for
corpora where the (B, N) score matrix should never reach device memory.
Two passes:

1. **Chunk maxima** (K3, K4; ``csrc/chunk_max.cu``) over the
   weight-folded corpus ``F = C * diag(w)``: for each query, the maximum
   weighted score of every 128-row chunk, (B, N/128). F is stored in the
   scan dtype: fp32 (exact), bf16 (half the bytes) or int8 with per-row
   scales (a quarter). The TPU kernels keep F transposed, (D, N), and
   write (N/128, B) only for Mosaic's layouts; the port keeps F (N, D)
   row-major and writes (B, N/128). ``chunk_max_plan`` picks one kernel
   path per (B, D, dtype): "stream" for small batches (up to 16 queries
   for fp32, 2 for bf16), "mma" (tensor cores) for bf16 above and for
   int8 at every B, "simt" for fp32 above.
2. **Block gather + exact re-score** (K5; ``csrc/gather_rescore.cu``):
   the top ``mc`` chunks of each query are read as contiguous 128-row
   blocks of the raw fp32 corpus and scored in IEEE fp32.
   ``rescore_plan`` picks "pairs" where few chunks are shared (a block
   per pair and group of a chunk's rows, so a few pairs fill the card) and
   "grouped" where queries share chunks (the pairs sorted by chunk on
   the card, each chunk read once per tile of up to 32 of its queries).

Exactness is certified per query, as in the JAX package: every row of an
unfetched chunk scores at most the mc-th chunk maximum plus a
scan-dependent epsilon. Padding rows fold to zero (score 0 in pass 1,
which only overestimates a partly padded chunk's bound) and fully padded
chunks are masked. fp32 scans still carry ``eps_fp32_dot(d)``, because pass
1 scores folded rows, dot(q, w*c), while pass 2 scores dot(q, c)*w, and
the two roundings differ. bf16 and int8 scans widen the bound by the
exact build-time quantization residual (Cauchy-Schwarz:
|dot(q, c_hat - c)| <= ||q|| * max_row ||c_hat - c||) plus the query's
bf16 rounding. A pass 1 on the tensor cores takes its own accumulation
term (``eps_tc_dot``). Pass 2 is exact fp32 for every scan, so a certified
result is exact whatever the scan dtype.

Each kernel wrapper launches its kernel on a CUDA tensor (or raises) and
computes its plain version on a CPU tensor.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading
from dataclasses import dataclass
from typing import Optional, Tuple, Union

import numpy as np
import torch

from . import cuda_build
from .flat_topk import ieee_fp32
from .fused_score import (  # the "stream" layout K1 and K3 share
    BLOCK_SMEM_BYTES,
    STREAM_GROUP,
    STREAM_RING_BYTES,
    fused_search,
    pow2_tile,
    sm_count,
    stream_blocks,
)
from .quantized import quantize_rows
from .rerank import eps_high_dot

CHUNK = 128  # corpus rows per chunk
_launch_lock = threading.Lock()


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


# The floor of ``eps_fp32_dot``: the JAX package's value, which covers
# every d <= 768.
EPS_FP32_DOT = 1e-4


def eps_fp32_dot(d: int) -> float:
    """fp32 dot rounding gap between pass 1 (weight-folded rows) and pass 2
    (raw dot x weight), for D = d, per unit of ||q|| * ||c||: both are fp32
    roundings of the same real value, and any fp32 sum of d products, in
    any summation order (the kernels' sequential fmaf order, cuBLAS's
    blocked order), errs by at most about (d + 1) * 2^-24 * ||q|| * ||c||;
    doubled for the two conventions, 2 (d + 1) 2^-24: 9.2e-5 at d = 768,
    1.83e-4 at d = 1536. Floored at EPS_FP32_DOT, so d <= 768 keeps the
    JAX package's 1e-4."""
    return max(EPS_FP32_DOT, 2 * (d + 1) * 2.0 ** -24)


def eps_tc_dot(d: int) -> float:
    """The same gap when pass 1 ran on the tensor cores (the "mma" path of
    ``chunk_max_plan``), for D = d, per unit of ||q|| * ||c||.

    The bf16 x bf16 products are exact in fp32; only the accumulation
    differs from round-to-nearest fp32. Model of an mma accumulation step
    (documented for NVIDIA's tensor cores and assumed here): it adds the
    accumulator and n_b >= 4 exact products, aligning each addend to the
    largest of them, M, with 24 significant bits, and truncates the sum to
    fp32. Each of the n_b + 1 alignments errs by less than 2^-23 M, and the
    final truncation by less than 2^-23 M (the sum's excess over M is
    counted in the alignments), so a step errs by at most (n_b + 2) 2^-23 M,
    with M <= S = sum_i |q_i c_i| <= ||q|| ||c||. Only steps that hold a
    real column err (zero products add exactly): at most 16 / n_b of each
    of the ceil(d / 16) k16 blocks, however the kernel permutes the
    k-values within a block. Over them: ceil(d / 16) (16 / n_b) (n_b + 2)
    2^-23 S, largest at the smallest n_b, 4: 24 ceil(d / 16) 2^-23.
    Pass 2's round-to-nearest fp32 dot and weight product add
    (d + 1) 2^-24, and the fp32 fold w * c, against which the stored
    rows' residual is measured, 2^-24: at d = 768, 1.37e-4 + 4.6e-5 =
    1.83e-4; at d = 1024, 2.44e-4."""
    return 24 * _cdiv(d, 16) * 2.0 ** -23 + (d + 2) * 2.0 ** -24


# worst-case relative l2 error of rounding the query to bf16: round to
# nearest (__float2bfloat16_rn in the kernels, Tensor.to(bfloat16) in the
# plain versions) errs by at most half an ulp, 2^-9, per element, so
# ||q - bf16(q)|| <= 2^-9 ||q||; the 1.25x margin is the JAX package's.
EPS_BF16_VEC = 1.25 * 2.0 ** -9

SCANS = ("pallas", "xla", "xla_high", "bf16", "int8")
_SCAN_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}


# --------------------------------------------------------------- plan

#: largest batch of the "stream" path, by stored dtype; above it bf16 and
#: int8 stores take "mma" and fp32 stores "simt". Measured on an H100
#: (chip_smoke.py's threshold rows, recorded in PERF.md): "stream" costs
#: steps with its query tile (1, 2, 4, 8 or 16 rows, SIMT fmaf), "mma" is
#: flat up to its 16-query tile; they cross at 2 to 4 queries for bf16,
#: while int8 was faster on "mma" at every batch measured (2 to 16
#: queries); for fp32 "stream" at 16 beats "simt" at 17. The kernel is
#: built for these tiles only.
STREAM_MAX_B = {torch.float32: 16, torch.bfloat16: 2, torch.int8: 0}
_PATHS = {"stream": 0, "mma": 1, "simt": 2}


@dataclass(frozen=True)
class ChunkMaxPlan:
    """The one kernel path ``chunk_maxima`` launches for a (B, N, D, dtype).

    path:      "stream" (B <= STREAM_MAX_B[dtype] and the query block fits
               in shared memory), else "mma" (bf16 and int8) or "simt"
               (fp32)
    rows:      N
    blocks:    "stream": blocks, each a contiguous range of whole
               STREAM_GROUP-row groups (``row_ranges``)
    tile_rows: "mma": queries per block, 16, 32, 64 or 128
    """

    path: str
    rows: int
    blocks: int = 0
    tile_rows: int = 0

    def row_ranges(self):
        """(start, end) rows of each "stream" block, as the kernel cuts
        them: block i takes groups [i*G // blocks, (i+1)*G // blocks)."""
        groups = self.rows // STREAM_GROUP
        return [
            (i * groups // self.blocks * STREAM_GROUP,
             (i + 1) * groups // self.blocks * STREAM_GROUP)
            for i in range(self.blocks)
        ]


def chunk_max_plan(b: int, n: int, d: int, dtype, sm_count: int) -> ChunkMaxPlan:
    """Pick the chunk-max path for B queries over N rows (N % 128 == 0) of
    D columns in a store of ``dtype`` (a torch dtype or
    "fp32"/"bf16"/"int8") on a card with ``sm_count`` SMs. "stream" takes
    min(blocks per SM * sm_count, N / 32) blocks, so all are resident at
    once: 2 per SM where two blocks' shared memory fits in an SM, else 1;
    a D whose query block does not fit in one block's shared memory goes
    to the large-batch path."""
    dtype = _SCAN_DTYPES.get(dtype, dtype)
    if dtype not in _SCAN_DTYPES.values():
        raise TypeError(f"corpus dtype {dtype}: float32, bfloat16 or int8")
    blocks = stream_blocks(b, d, n // STREAM_GROUP, sm_count)
    if b <= STREAM_MAX_B[dtype] and blocks:
        return ChunkMaxPlan("stream", n, blocks=blocks)
    if dtype == torch.float32:
        return ChunkMaxPlan("simt", n)
    return ChunkMaxPlan("mma", n, tile_rows=min(128, pow2_tile(b, 16)))


def _plan_for(queries: torch.Tensor, folded: torch.Tensor) -> ChunkMaxPlan:
    n, d = folded.shape
    return chunk_max_plan(
        queries.shape[0], n, d, folded.dtype, sm_count(folded.device.index or 0)
    )


# --------------------------------------------------------------- pass 1


def chunk_maxima_reference(
    queries: torch.Tensor,
    folded: torch.Tensor,
    scales: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain version of ``chunk_maxima``: (B, N) scores by matmul, then the
    max over each 128-column chunk. An fp32 F is scored in IEEE fp32
    (TF32 off); bf16 and int8 score bf16(q) against the exactly widened
    values with fp32 sums (int8 then times its row scale)."""
    b = queries.shape[0]
    n = folded.shape[0]
    q = queries.to(torch.float32)
    if folded.dtype != torch.float32:
        q = q.to(torch.bfloat16).to(torch.float32)
    with ieee_fp32():
        s = torch.matmul(q, folded.to(torch.float32).T)
    if folded.dtype == torch.int8:
        s = s * scales[None, :]
    return s.view(b, n // CHUNK, CHUNK).amax(dim=2)


@functools.cache
def _chunk_max_kernel():
    fn = cuda_build.load("chunk_max").chunk_max_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def chunk_maxima(
    queries: torch.Tensor,
    folded: torch.Tensor,
    scales: Optional[torch.Tensor] = None,
    plan: Optional[ChunkMaxPlan] = None,
) -> torch.Tensor:
    """(B, D) x (N, D) weight-folded -> (B, N/128) weighted chunk maxima;
    the (B, N) scores never reach device memory. ``folded`` is fp32, bf16
    or int8 (then ``scales`` (N,) fp32). N % 128 == 0. On a CUDA tensor it
    launches ``plan``'s path, by default ``chunk_max_plan``'s (a caller
    that needs to know the path decides it once and passes it in).
    ``chunk_maxima.launches`` counts launches of the fp32 and bf16 stores
    (K3), ``chunk_maxima.launches_int8`` those of the int8 store (K4)."""
    b, d = queries.shape
    n, d2 = folded.shape
    if d != d2:
        raise ValueError(f"query dim {d} != corpus dim {d2}")
    if n % CHUNK:
        raise ValueError(f"N={n}: chunk maxima need N % {CHUNK} == 0")
    int8 = folded.dtype == torch.int8
    if int8 and (scales is None or tuple(scales.shape) != (n,)):
        raise ValueError(f"an int8 corpus needs scales of shape ({n},)")
    if folded.dtype not in _SCAN_DTYPES.values():
        raise TypeError(f"corpus dtype {folded.dtype}: float32, bfloat16 or int8")
    if folded.device.type == "cpu":
        return chunk_maxima_reference(queries, folded, scales)
    if folded.device.type != "cuda":
        raise ValueError(f"unsupported device {folded.device}")
    if queries.device != folded.device or (int8 and scales.device != folded.device):
        raise ValueError("queries, corpus and scales must share one device")
    if not folded.is_contiguous():
        raise ValueError("corpus must be contiguous")
    if d % (16 if int8 else 8):
        raise ValueError(f"D={d}: rows are read 16 bytes at a time")
    q = queries.to(torch.float32).contiguous()
    sc = scales.to(torch.float32).contiguous() if int8 else q
    if q.data_ptr() % 16 or folded.data_ptr() % 16 or sc.data_ptr() % 16:
        raise ValueError("queries, corpus and scales must be 16-byte aligned")
    dev = folded.device
    out = torch.empty((b, n // CHUNK), dtype=torch.float32, device=dev)
    if b == 0 or n == 0:
        return out
    plan = plan or _plan_for(q, folded)
    scratch = q  # unused unless "mma": the queries rounded to bf16, padded
    if plan.path == "mma":
        bm = plan.tile_rows
        scratch = torch.empty(
            (_cdiv(b, bm) * bm, _cdiv(d, 64) * 64), dtype=torch.bfloat16, device=dev
        )
    dtype = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}[folded.dtype]
    with torch.cuda.device(dev):
        err = _chunk_max_kernel()(
            q.data_ptr(), folded.data_ptr(), sc.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), b, n, d, dtype, _PATHS[plan.path], plan.blocks,
            plan.tile_rows, torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"chunk_max kernel launch failed: CUDA error {err}")
    with _launch_lock:
        if int8:
            chunk_maxima.launches_int8 += 1
        else:
            chunk_maxima.launches += 1
    return out


chunk_maxima.launches = 0
chunk_maxima.launches_int8 = 0


# --------------------------------------------------------------- pass 2


def gather_rescore_reference(
    queries: torch.Tensor, corpus: torch.Tensor, chunk_ids: torch.Tensor
) -> torch.Tensor:
    """Plain version of ``gather_rescore``: gather the chunks' rows, then
    one batched fp32 matrix-vector product (TF32 off); an id outside
    [0, N/128) scores NaN."""
    b, mc = chunk_ids.shape
    n, d = corpus.shape
    nc = n // CHUNK
    ids = chunk_ids.long()
    valid = (ids >= 0) & (ids < nc)
    rows = corpus.view(nc, CHUNK, d)[torch.where(valid, ids, 0)]
    rows = rows.view(b, mc * CHUNK, d)
    q = queries.to(torch.float32)[:, :, None]
    with ieee_fp32():
        out = torch.bmm(rows, q).view(b, mc, CHUNK)
    return out.masked_fill_(~valid[:, :, None], float("nan")).view(b, mc * CHUNK)


#: "grouped" takes the pairs sorted by chunk, so that a tile of up to
#: RESCORE_TILE_ROWS of a chunk's queries reads the chunk once; "pairs"
#: reads a chunk once for every pair. "grouped" pays a sort and fewer,
#: larger blocks, so it wins once it saves enough chunk reads: B*mc pairs
#: less the distinct chunks they hit, at least RESCORE_GROUPED_MIN_SAVED
#: (the plan estimates the distinct chunks as uniform random ids would hit
#: them, ``expected_chunks``; queries that share chunks save more).
#: Measured on an H100 (chip_smoke.py's K5 rows, both paths forced;
#: PERF.md): "pairs" still won at 203 reads saved (B = 17, k = 10
#: over 40,960 rows: 0.0484 against 0.0533 ms), "grouped" won from 506
#: (B = 4, k = 100: 0.0603 against 0.0989) and drew level at 552 (B = 16,
#: k = 100 over 1M rows). A batch size alone does not decide: at 64
#: queries with k = 10 over 1M rows "pairs" wins, at 4 queries with
#: k = 100 over 40,960 rows "grouped".
RESCORE_GROUPED_MIN_SAVED = 384
#: queries per "grouped" tile (grouped::QT in csrc/gather_rescore.cu)
RESCORE_TILE_ROWS = 32
#: "pairs" takes the largest group of a chunk's rows per block (32, 16 or
#: 8) that still gives this many blocks per SM
RESCORE_BLOCKS_PER_SM = 2
#: chunks up to which the "grouped" sort counts each block's pairs in
#: shared memory (grouped::LOCAL_CHUNKS in csrc/gather_rescore.cu); above,
#: with global atomics
RESCORE_LOCAL_CHUNKS = 8192
_RESCORE_PATHS = {"pairs": 0, "grouped": 1}


def _pairs_smem(group_rows: int, d: int) -> int:
    """Shared memory of a "pairs" block: group_rows / 4 warps' rings of 4
    stages x 2 KB, then the fp32 query row."""
    return group_rows // 4 * 4 * 2048 + d * 4


def pairs_group_rows(pairs: int, sm_count: int) -> int:
    """Rows of a chunk per "pairs" block for this many pairs: the largest
    of 32, 16 and 8 that gives RESCORE_BLOCKS_PER_SM blocks per SM, else 8."""
    rows = 32
    while rows > 8 and pairs * (CHUNK // rows) < RESCORE_BLOCKS_PER_SM * sm_count:
        rows //= 2
    return rows


def expected_chunks(pairs: int, nc: int) -> float:
    """Distinct chunks that ``pairs`` uniform random ids over nc chunks hit,
    on average: nc (1 - (1 - 1/nc)^pairs)."""
    return nc * -math.expm1(pairs * math.log1p(-1.0 / nc)) if nc > 1 else min(nc, pairs)


def tile_bound(pairs: int, nc: int) -> int:
    """"grouped": the most tiles ``pairs`` pairs over nc chunks can make,
    the grid of its tile kernel: every chunk's last tile may be partial,
    so sum ceil(n_c / QT) <= ceil(pairs / QT) + min(nc, pairs)."""
    return _cdiv(pairs, RESCORE_TILE_ROWS) + min(nc, pairs)


@dataclass(frozen=True)
class RescorePlan:
    """The one K5 path ``gather_rescore`` launches for a (B, mc, nc, D).

    path:       "pairs" (fewer than RESCORE_GROUPED_MIN_SAVED chunk reads to
                save, and the query row fits in shared memory), else
                "grouped" (tiles of RESCORE_TILE_ROWS queries)
    group_rows: "pairs": rows of a chunk per block, 8, 16 or 32
    """

    path: str
    group_rows: int = 0


def rescore_plan(b: int, mc: int, nc: int, d: int, sm_count: int) -> RescorePlan:
    """Pick K5's path for B queries of D columns, each re-scoring mc of nc
    chunks, on a card with ``sm_count`` SMs: "grouped" where it saves at
    least RESCORE_GROUPED_MIN_SAVED chunk reads (or the query row does not
    fit in a "pairs" block's shared memory), else "pairs" with the largest
    group of rows that gives RESCORE_BLOCKS_PER_SM blocks per SM."""
    pairs = b * mc
    rows = pairs_group_rows(pairs, sm_count)
    if (pairs - expected_chunks(pairs, nc) < RESCORE_GROUPED_MIN_SAVED
            and _pairs_smem(rows, d) <= BLOCK_SMEM_BYTES):
        return RescorePlan("pairs", group_rows=rows)
    return RescorePlan("grouped")


@functools.cache
def _rescore_kernel():
    fn = cuda_build.load("gather_rescore").gather_rescore_launch
    fn.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


def gather_rescore(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    chunk_ids: torch.Tensor,
    plan: Optional[RescorePlan] = None,
) -> torch.Tensor:
    """(B, mc * 128) IEEE fp32 raw scores of the selected chunks' rows:
    column ``i * 128 + r`` is row ``chunk_ids[b, i] * 128 + r``; an id
    outside [0, N/128) scores NaN. The raw (not weight-folded) fp32
    corpus, N % 128 == 0; any B. On a CUDA tensor it launches ``plan``'s
    path, by default ``rescore_plan``'s; a plan the kernel cannot run
    raises. ``gather_rescore.launches`` counts calls of the kernel's entry
    point, one per call: "pairs" runs one kernel, "grouped" a memset and
    three (the count and the scatter of the pairs by chunk, then the
    tiles)."""
    b, d = queries.shape
    n, d2 = corpus.shape
    if d != d2:
        raise ValueError(f"query dim {d} != corpus dim {d2}")
    if chunk_ids.ndim != 2 or chunk_ids.shape[0] != b:
        raise ValueError(f"chunk_ids {tuple(chunk_ids.shape)} must be ({b}, mc)")
    if n % CHUNK:
        raise ValueError(f"N={n}: the re-score gathers whole {CHUNK}-row chunks")
    if corpus.dtype != torch.float32:
        raise TypeError(f"corpus dtype {corpus.dtype}: the re-score reads fp32 rows")
    if corpus.device.type == "cpu":
        return gather_rescore_reference(queries, corpus, chunk_ids)
    if corpus.device.type != "cuda":
        raise ValueError(f"unsupported device {corpus.device}")
    if queries.device != corpus.device or chunk_ids.device != corpus.device:
        raise ValueError("queries, corpus and chunk_ids must share one device")
    if not corpus.is_contiguous():
        raise ValueError("corpus must be contiguous")
    if d % 4:
        raise ValueError(f"D={d}: rows are copied 16 bytes at a time, D % 4 == 0")
    q = queries.to(torch.float32).contiguous()
    ids = chunk_ids.to(torch.int32).contiguous()
    if q.data_ptr() % 16 or corpus.data_ptr() % 16:
        raise ValueError("queries and corpus must be 16-byte aligned")
    mc = ids.shape[1]
    nc = n // CHUNK
    dev = corpus.device
    out = torch.empty((b, mc * CHUNK), dtype=torch.float32, device=dev)
    if b == 0 or mc == 0:
        return out
    plan = plan or rescore_plan(b, mc, nc, d, sm_count(dev.index or 0))
    if plan.path not in _RESCORE_PATHS:
        raise ValueError(f"{plan}: path 'pairs' or 'grouped'")
    grouped = plan.path == "grouped"
    scratch = out  # unused unless "grouped"
    if grouped:
        # an int4 descriptor per tile of the bound, the sorted pairs, nc
        # counters, the count of finished sort blocks, the tile count
        pairs = b * mc
        scratch = torch.empty(
            4 * tile_bound(pairs, nc) + pairs + nc + 2, dtype=torch.int32, device=dev
        )
    with torch.cuda.device(dev):
        err = _rescore_kernel()(
            q.data_ptr(), corpus.data_ptr(), ids.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), scratch.numel() if grouped else 0, b, nc, d, mc,
            _RESCORE_PATHS[plan.path], RESCORE_TILE_ROWS if grouped else plan.group_rows,
            torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(
            f"gather_rescore kernel ({plan.path}) launch failed: CUDA error {err}"
        )
    with _launch_lock:
        gather_rescore.launches += 1
    return out


gather_rescore.launches = 0


# ---------------------------------------------------------------- state


@dataclass
class ChunkStore:
    """Device state for the streaming chunk-select path. The fields mean
    what the JAX package's mean; only the layout of the scanned corpus
    differs.

    folded:  (N_pad, D) weight-folded rows ``w_i * c_i``, row-major (the
             JAX package keeps them transposed as ``corpus_t`` (D, N_pad)),
             in the scan dtype: fp32, bf16 or int8 (per-row ``scales``)
    corpus:  (N_pad, D) fp32 raw rows (pass 2's exact re-score)
    weights / mask: (N_pad,) fp32 (pass-2 epilogue and padding)
    bound_scale: max ||w_i * c_i|| over folded rows, the certificate scale
    resid_max: max over rows of ||fold_i - dequant(quant(fold_i))||_2,
               measured at build on the stored tensor: the Cauchy-Schwarz
               term of the reduced-precision scans
    """

    folded: torch.Tensor
    corpus: torch.Tensor
    weights: torch.Tensor
    mask: torch.Tensor
    n_real: int
    bound_scale: float = 1.2
    scan_dtype: str = "fp32"
    scales: Optional[torch.Tensor] = None  # (N_pad,) fp32, int8 only
    resid_max: float = 0.0

    @classmethod
    def build(
        cls,
        vectors: np.ndarray,
        weights: np.ndarray,
        tile_cap: int = 2048,
        scan_dtype: str = "fp32",
        device: Union[str, torch.device] = "cuda",
    ) -> "ChunkStore":
        """Host arrays in: copy them to ``device`` and delegate to
        ``build_device``, so exactly one spelling of the pad, fold,
        quantize and residual arithmetic exists."""
        from ..utils.device import resolve_device

        dev = resolve_device(device)
        v = torch.from_numpy(np.ascontiguousarray(vectors, np.float32)).to(dev)
        w = torch.from_numpy(np.ascontiguousarray(weights, np.float32)).to(dev)
        return build_device(v, w, tile_cap=tile_cap, scan_dtype=scan_dtype)

    @property
    def device_bytes(self) -> int:
        """Bytes of the scan state (folded rows and scales)."""
        extra = self.scales.numel() * 4 if self.scales is not None else 0
        return self.folded.numel() * self.folded.element_size() + extra


def build_device(
    vectors: torch.Tensor,
    weights: torch.Tensor,
    tile_cap: int = 2048,
    scan_dtype: str = "fp32",
    n_real: Optional[int] = None,
) -> ChunkStore:
    """ChunkStore.build for tensors already on the device: pad to a
    multiple of ``tile_cap`` rows, fold the weights in, quantize, and
    measure the exact residual, all where the tensors lie.

    ``n_real`` says that only the first ``n_real`` rows are real and the
    rest are padding with zero weight (a store's padded corpus); when
    ``vectors`` is then already fp32, contiguous and a multiple of
    ``tile_cap`` rows, the store keeps it as ``corpus`` without a copy."""
    if scan_dtype not in _SCAN_DTYPES:
        raise ValueError(f"scan_dtype={scan_dtype!r}: fp32, bf16 or int8")
    n, _ = vectors.shape
    n_real = n if n_real is None else n_real
    n_pad = _cdiv(n, tile_cap) * tile_cap
    cp = vectors.to(torch.float32)
    wp = weights.to(torch.float32)
    if n_pad != n:
        cp = torch.nn.functional.pad(cp, (0, 0, 0, n_pad - n))
        wp = torch.nn.functional.pad(wp, (0, n_pad - n))
    cp = cp.contiguous()
    rows = torch.arange(n_pad, device=cp.device)
    mask = torch.where(
        rows < n_real, torch.zeros((), device=cp.device),
        torch.full((), -1e30, device=cp.device),
    ).to(torch.float32)
    folded = cp * wp[:, None]
    bscale = torch.sqrt(torch.max(torch.sum(folded * folded, dim=1)))
    scales = None
    if scan_dtype == "bf16":
        stored = folded.to(torch.bfloat16)
        deq = stored.to(torch.float32)
    elif scan_dtype == "int8":
        stored, scales = quantize_rows(folded)  # the one quantization law
        deq = stored.to(torch.float32) * scales[:, None]
    else:
        stored = deq = folded
    resid = torch.sqrt(torch.max(torch.sum((folded - deq) ** 2, dim=1)))
    return ChunkStore(
        folded=stored.contiguous(),
        corpus=cp,
        weights=wp.contiguous(),
        mask=mask,
        n_real=n_real,
        bound_scale=float(bscale) or 1.0,
        scan_dtype=scan_dtype,
        scales=scales,
        resid_max=float(resid),
    )


# --------------------------------------------------------------- search


def _pass1_plan(
    queries: torch.Tensor, folded: torch.Tensor, scan: str
) -> Optional[ChunkMaxPlan]:
    """The kernel plan pass 1 runs: the plan's on a CUDA tensor with the
    kernel scan, None where the plain version runs."""
    if scan != "pallas" or folded.device.type != "cuda":
        return None
    return _plan_for(queries, folded)


def certificate_eps(
    dtype: torch.dtype, scan: str, path: Optional[str], resid_max: float,
    bound_scale: float, d: int,
) -> float:
    """Per unit of ||q||: how far an unfetched row's true weighted score
    may exceed its chunk's measured maximum, for D = d. ``path`` is the
    kernel path pass 1 ran: "mma" accumulated on the tensor cores and
    takes ``eps_tc_dot(d)``; every other path, and the plain version,
    ``eps_fp32_dot(d)``; the ``xla_high`` scan ``eps_high_dot(d)``."""
    dot = eps_tc_dot(d) if path == "mma" else eps_fp32_dot(d)
    if dtype in (torch.bfloat16, torch.int8):
        # Cauchy-Schwarz on the measured quantization residual, plus the
        # query's bf16 rounding and the fp32 accumulation gap
        return resid_max + (EPS_BF16_VEC + dot) * bound_scale
    if scan == "xla_high":
        return eps_high_dot(d) * bound_scale
    return dot * bound_scale


def chunk_stream_search(
    queries: torch.Tensor,
    folded: torch.Tensor,
    corpus: torch.Tensor,
    weights: torch.Tensor,
    mask: torch.Tensor,
    k: int,
    mc: int = 0,
    n_real: int = 0,
    scan: str = "pallas",
    bound_scale: float = 1.2,
    scales: Optional[torch.Tensor] = None,
    resid_max: float = 0.0,
    guarantee: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact weighted top-k over a ChunkStore's tensors. Returns
    (values (B, k) fp32, indices (B, k) int32, certified (B,) bool).

    scan, how pass 1 computes the chunk maxima:
      "pallas"   the chunk-max kernel (K3 over fp32 or bf16, K4 over
                 int8), following ``folded``'s stored dtype; (B, N) never
                 reaches device memory;
      "xla"      the plain version (matmul, then the chunk max) in the
                 stored dtype: the JAX package's plain-XLA engine;
      "xla_high" the plain version over fp32 in IEEE fp32, widened by
                 EPS_HIGH_DOT (ops/rerank.py says why it is not TF32);
      "bf16"/"int8" aliases of "xla" over a store of that dtype.
    The certificate epsilon follows the stored dtype and the kernel path
    (``certificate_eps``). Default
    mc = max(2k, k + 16), capped at the chunk count; fetching every real
    chunk certifies. ``guarantee=True`` reads the certificate (one host
    sync) and redoes an uncertified batch on the exact K1 path."""
    if scan not in SCANS:
        raise ValueError(f"scan={scan!r}: one of {SCANS}")
    b, d = queries.shape
    n = corpus.shape[0]
    nc = n // CHUNK
    if mc <= 0:
        mc = max(2 * k, k + 16)
    mc = min(mc, nc)
    if n_real == 0:
        n_real = n
    dtype = folded.dtype
    if scan in ("bf16", "int8"):
        if dtype != _SCAN_DTYPES[scan]:
            raise ValueError(f"scan={scan!r} needs a {scan} store, got {dtype}")
        scan = "xla"
    if scan == "xla_high" and dtype != torch.float32:
        raise ValueError(f"scan='xla_high' needs an fp32 store, got {dtype}")
    queries = queries.to(torch.float32)

    # decided once: the launch and the certificate's epsilon follow it
    plan = _pass1_plan(queries, folded, scan)
    if scan == "pallas":
        cm = chunk_maxima(queries, folded, scales, plan)
    else:
        cm = chunk_maxima_reference(queries, folded, scales)
    # fully padded chunks can never win; partly padded chunks keep their
    # (possibly 0 from zero padding) max, a sound upper bound
    nc_real = _cdiv(n_real, CHUNK)
    if nc_real < nc:
        cm[:, nc_real:] = float("-inf")
    cvals, cidx = torch.topk(cm, mc, dim=1)
    cidx = cidx.to(torch.int32)

    raw = gather_rescore(queries, corpus, cidx)
    long_idx = cidx.long()
    wb = weights.view(nc, CHUNK)[long_idx].reshape(b, mc * CHUNK)
    mb = mask.view(nc, CHUNK)[long_idx].reshape(b, mc * CHUNK)
    scores = raw * wb + mb
    vals, sel = torch.topk(scores, k, dim=1)
    cols = (
        long_idx[:, :, None] * CHUNK
        + torch.arange(CHUNK, device=cidx.device)[None, None, :]
    ).reshape(b, mc * CHUNK)
    idx = torch.gather(cols, 1, sel).to(torch.int32)

    # an unfetched row's true weighted score can exceed its chunk's
    # measured maximum by the scan's rounding; pass-2 values are exact
    q_norms = torch.sqrt(torch.sum(queries * queries, dim=1))
    path = plan.path if plan else None
    eps = certificate_eps(dtype, scan, path, resid_max, bound_scale, d) * q_norms
    chunk_bound = cvals[:, mc - 1] + eps
    if mc >= nc_real:
        # every real chunk was re-scored exactly: the result is exact, and
        # the bound test (k-th against the smallest fetched chunk max)
        # would spuriously de-certify small corpora
        certified = torch.ones((b,), dtype=torch.bool, device=vals.device)
    else:
        certified = vals[:, k - 1] >= chunk_bound

    if guarantee and not bool(certified.all()):
        with _launch_lock:
            chunk_stream_search.redos += 1
        vals, idx = fused_search(queries, corpus, weights, mask, k)
    return vals, idx, certified


chunk_stream_search.redos = 0


def search(
    store: ChunkStore,
    queries: torch.Tensor,
    k: int,
    mc: int = 0,
    scan: Optional[str] = None,
    guarantee: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``chunk_stream_search`` bound to a ChunkStore's tensors. scan
    defaults to the kernel ("pallas"), which follows the store's dtype."""
    q = torch.as_tensor(queries, dtype=torch.float32).to(store.corpus.device)
    return chunk_stream_search(
        q, store.folded, store.corpus, store.weights, store.mask, k=k,
        mc=mc, n_real=store.n_real, scan=scan or "pallas",
        bound_scale=store.bound_scale, scales=store.scales,
        resid_max=store.resid_max, guarantee=guarantee,
    )
