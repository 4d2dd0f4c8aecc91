"""Fused scoring kernels: Q·Cᵀ × level-weight + padding mask, then top-k.

Counterpart of rag_icd10_tpu/ops/pallas_score.py for the served
``exact``, ``approx`` and ``streaming`` methods. One pass over the corpus
computes, for a whole batch of queries, the level-weighted cosine scores
that the reference produces with a Milvus FLAT/IP scan followed by a
Python re-weighting loop (reference: services/milvus_service.py:271-316).

- ``fused_weighted_scores`` (K1, ``csrc/fused_score.cu``) writes the
  (B, N) scores; ``fused_search`` takes ``torch.topk`` of them.
  ``fused_score_plan`` picks one kernel path per (B, D, dtype): "stream"
  for an fp32 corpus up to 16 queries, "mma" (tensor cores) for a bf16
  corpus, "tile" for an fp32 corpus above 16.
- ``streaming_candidates`` (K2, ``csrc/slot_stream.cu``) keeps the top-S
  of each contiguous row range instead, so the (B, N) scores never reach
  device memory; ``streaming_topk`` selects the top-k from its candidates
  and certifies it against the ranges' bounds.

On a CUDA tensor each wrapper launches its hand-written kernel (the
source notes give bound and design) or raises; on a CPU tensor it
computes its plain version, which the kernel is held against. The TPU
kernels' VMEM tile budgets (``default_tile_n``, ``streaming_tile_n``)
have no meaning here: the CUDA kernels pick their own tiles and mask the
ragged edge, so N need not be a multiple of anything.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from . import cuda_build
from .flat_topk import weighted_scores_reference

_launch_lock = threading.Lock()


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


# ---------------------------------------------------------------------------
# The "stream" layout of K1 and K3 (csrc/fused_score.cu, csrc/chunk_max.cu):
# 256-thread blocks, each a contiguous range of whole 32-row groups, with a
# warp-private cp.async ring and the query block in shared memory.
# ---------------------------------------------------------------------------

#: rows per group: "stream" splits the rows between its blocks in whole
#: groups (stream::GROUP in both sources)
STREAM_GROUP = 32
#: resident "stream" blocks per SM where the shared memory allows
#: (__launch_bounds__(256, 2))
STREAM_BLOCKS_PER_SM = 2
#: a "stream" block's shared memory besides its fp32 query block: 8 warps'
#: rings of 4 stages x 2 KB
STREAM_RING_BYTES = 64 * 1024
#: an H100 SM's shared memory, the most one block may take of it, and what
#: the card reserves per resident block (CUDA guide, compute capability 9.0)
SM_SMEM_BYTES = 228 * 1024
BLOCK_SMEM_BYTES = 227 * 1024
BLOCK_RESERVED_SMEM = 1024


def pow2_tile(b: int, smallest: int) -> int:
    """The smallest power of two, at least ``smallest``, that holds b."""
    return max(smallest, 1 << (b - 1).bit_length())


def stream_blocks(b: int, d: int, groups: int, sms: int) -> int:
    """Blocks of a "stream" launch for B queries of D columns over
    ``groups`` row groups on ``sms`` SMs: min(blocks per SM * sms, groups),
    so that all are resident at once, 2 per SM where two blocks' shared
    memory fits in an SM, else 1; 0 where one block's query block (B
    padded to a power of two, fp32) and ring exceed a block's shared
    memory."""
    smem = STREAM_RING_BYTES + pow2_tile(b, 1) * d * 4
    if smem > BLOCK_SMEM_BYTES:
        return 0
    per_sm = min(STREAM_BLOCKS_PER_SM, SM_SMEM_BYTES // (smem + BLOCK_RESERVED_SMEM))
    return min(per_sm * sms, groups)


@functools.cache
def sm_count(index: int) -> int:
    """SMs of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


#: largest k the streaming method selects in-kernel; a larger k takes the
#: materialized path, as in the JAX package (pallas_score.py:138)
STREAMING_K_MAX = 128
#: blocks the streaming kernel aims for: two waves on an H100's 132 SMs
_STREAM_BLOCKS = 264
#: largest batch the streaming kernel scores 8 queries per block; above
#: it, 32 (``stream_tile_rows``)
_STREAM_WIDE_B = 16


def _check_cuda_inputs(queries, corpus, weights, mask):
    """Device, dtype, layout and alignment checks shared by K1 and K2;
    returns (q, w, mask) as contiguous fp32 on the corpus's device."""
    if corpus.device.type != "cuda":
        raise ValueError(f"unsupported device {corpus.device}")
    for name, t in (("queries", queries), ("weights", weights), ("mask", mask)):
        if t.device != corpus.device:
            raise ValueError(f"{name} on {t.device}, corpus on {corpus.device}")
    if corpus.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"corpus dtype {corpus.dtype}: float32 or bfloat16")
    if not corpus.is_contiguous():
        raise ValueError("corpus must be contiguous")
    d = corpus.shape[1]
    if d % 8:
        raise ValueError(f"D={d}: the kernel reads rows 16 bytes at a time, D % 8 == 0")
    q = queries.to(torch.float32).contiguous()  # bf16 -> fp32 is exact
    w = weights.to(torch.float32).contiguous()
    m = mask.to(torch.float32).contiguous()
    if q.data_ptr() % 16 or corpus.data_ptr() % 16:
        raise ValueError("queries and corpus must be 16-byte aligned")
    return q, w, m


#: largest batch of K1's "stream" path over an fp32 corpus; above it
#: "tile". K3's measured threshold (chunk_stream.STREAM_MAX_B), confirmed
#: for K1 by chip_smoke.py's threshold rows (PERF.md).
SCORE_STREAM_MAX_B = 16
_SCORE_PATHS = {"stream": 0, "mma": 1, "tile": 2}


@dataclass(frozen=True)
class ScorePlan:
    """The one K1 path ``fused_weighted_scores`` launches.

    path:         "stream" (fp32 corpus, B <= SCORE_STREAM_MAX_B and the
                  query block fits in shared memory), "mma" (bf16 corpus,
                  every B) or "tile" (fp32 corpus otherwise)
    round_inputs: products of bf16-rounded q and C (a bf16 corpus, or
                  ``exact=False``), else IEEE fp32
    blocks:       "stream": blocks, each a contiguous range of whole
                  STREAM_GROUP-row groups (the last one may be ragged)
    tile_rows:    "mma": queries per block, 16, 32, 64 or 128
    """

    path: str
    round_inputs: bool
    blocks: int = 0
    tile_rows: int = 0


def fused_score_plan(
    b: int, n: int, d: int, dtype, exact: bool, sm_count: int
) -> ScorePlan:
    """Pick K1's path for B queries over N rows of D columns in a corpus
    of ``dtype`` (torch.float32 or torch.bfloat16) on a card with
    ``sm_count`` SMs. ``exact`` picks the arithmetic, not the path."""
    if dtype == torch.bfloat16:
        return ScorePlan("mma", True, tile_rows=min(128, pow2_tile(b, 16)))
    if dtype != torch.float32:
        raise TypeError(f"corpus dtype {dtype}: float32 or bfloat16")
    blocks = stream_blocks(b, d, _cdiv(n, STREAM_GROUP), sm_count)
    if b <= SCORE_STREAM_MAX_B and blocks:
        return ScorePlan("stream", not exact, blocks=blocks)
    return ScorePlan("tile", not exact)


@functools.cache
def _kernel():
    fn = cuda_build.load("fused_score").fused_score_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fused_weighted_scores(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    weights: torch.Tensor,
    mask: torch.Tensor,
    exact: bool = True,
    plan: Optional[ScorePlan] = None,
) -> torch.Tensor:
    """(B, D) x (N, D) -> (B, N) fp32 weighted+masked scores.

    ``corpus`` is fp32 or bf16; ``exact=True`` keeps fp32 inputs exact,
    ``exact=False`` rounds them to bf16 (one bf16 pass, ~3e-3 relative
    score error). A bf16 corpus always scores bf16 x bf16 products in fp32.
    On a CUDA tensor it launches ``plan``'s path, by default
    ``fused_score_plan``'s; a plan the kernel cannot run (a path for the
    other dtype, "stream" above its batch) raises.
    ``fused_weighted_scores.launches`` counts kernel launches.
    """
    b, d = queries.shape
    n, d2 = corpus.shape
    if d != d2:
        raise ValueError(f"query dim {d} != corpus dim {d2}")
    if tuple(weights.shape) != (n,) or tuple(mask.shape) != (n,):
        raise ValueError(
            f"weights {tuple(weights.shape)} and mask {tuple(mask.shape)} "
            f"must both be ({n},)"
        )
    if corpus.device.type == "cpu":
        return weighted_scores_reference(queries, corpus, weights, mask, exact=exact)
    q, w, m = _check_cuda_inputs(queries, corpus, weights, mask)
    dev = corpus.device
    out = torch.empty((b, n), dtype=torch.float32, device=dev)
    if b == 0 or n == 0:
        return out
    plan = plan or fused_score_plan(b, n, d, corpus.dtype, exact, sm_count(dev.index or 0))
    if plan.round_inputs != (corpus.dtype == torch.bfloat16 or not exact):
        raise ValueError(f"{plan} does not compute exact={exact} over {corpus.dtype}")
    scratch = q  # unused unless "mma": the queries rounded to bf16, padded
    if plan.path == "mma":
        bm = plan.tile_rows
        scratch = torch.empty(
            (_cdiv(b, bm) * bm, _cdiv(d, 32) * 32), dtype=torch.bfloat16, device=dev
        )
    with torch.cuda.device(dev):
        err = _kernel()(
            q.data_ptr(), corpus.data_ptr(), w.data_ptr(), m.data_ptr(),
            out.data_ptr(), scratch.data_ptr(), b, n, d,
            int(corpus.dtype == torch.bfloat16), int(plan.round_inputs),
            _SCORE_PATHS[plan.path], plan.blocks, plan.tile_rows,
            torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(
            f"fused_score kernel ({plan.path}) launch failed: CUDA error {err}"
        )
    with _launch_lock:
        fused_weighted_scores.launches += 1
    return out


fused_weighted_scores.launches = 0


def fused_search(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    weights: torch.Tensor,
    mask: torch.Tensor,
    k: int,
    method: str = "exact",
    exact: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused scoring + top-k. Returns (values (B, k) fp32, indices (B, k)
    int32).

    "exact" and "approx" both select with ``torch.topk`` (exact; see
    ``flat_topk.flat_search`` on why approx needs no separate path).
    "streaming" selects in-kernel through ``streaming_topk`` with its
    guarantee (exact in every case) when k <= 128; a larger k takes the
    materialized path, the JAX package's own rule, and is counted in
    ``fused_search.streaming_over_k_max``."""
    if method == "streaming":
        if k <= STREAMING_K_MAX:
            vals, idx, _ = streaming_topk(
                queries, corpus, weights, mask, k, exact=exact
            )
            return vals, idx
        with _launch_lock:
            fused_search.streaming_over_k_max += 1
        method = "exact"
    if method not in ("exact", "approx"):
        raise ValueError(
            f"fused_search method={method!r}: use exact, approx or streaming"
        )
    scores = fused_weighted_scores(queries, corpus, weights, mask, exact=exact)
    vals, idx = torch.topk(scores, k, dim=1)
    return vals, idx.to(torch.int32)


fused_search.streaming_over_k_max = 0


def launch_counts() -> Tuple[int, int, int]:
    """(K1 launches, K2 launches, ``fused_search.streaming_over_k_max``)."""
    with _launch_lock:
        return (
            fused_weighted_scores.launches,
            streaming_candidates.launches,
            fused_search.streaming_over_k_max,
        )


def add_launch_counts(k1: int = 0, k2: int = 0, over_k_max: int = 0) -> None:
    """Add launches the wrappers could not count themselves: a CUDA graph
    replays the kernels its capture recorded, while the capture moved the
    counts and launched nothing (ops/fused_query.py)."""
    with _launch_lock:
        fused_weighted_scores.launches += k1
        streaming_candidates.launches += k2
        fused_search.streaming_over_k_max += over_k_max


# ---------------------------------------------------------------------------
# Streaming top-k (K2). The contract is the JAX package's: a candidate set
# plus a sound bound on every corpus row outside it. The slot layout is the
# port's own: G slots (``slot_count``), slot g holding the contiguous row
# range [g*R, min((g+1)*R, N)) with R = ``range_rows(N, G)``, a whole number
# of 128-row tiles. At the default depth S = k each range keeps its own
# top-k, so the certificate holds by construction (``streaming_topk``).
# ---------------------------------------------------------------------------


def slot_depth(k: int) -> int:
    """The JAX package's slot-state depth for its 128 interleaved lane
    slots. Kept for parity; the port's ranges default to depth k, and a
    shallower depth (``streaming_topk(depth=...)``) can decertify."""
    return min(16, max(4, -(-k // 5) + 1))


def stream_tile_rows(batch: int) -> int:
    """Queries per block of the streaming kernel: 8 up to
    ``_STREAM_WIDE_B`` queries, 32 above, so that a large batch reads the
    corpus ceil(B/32) times instead of ceil(B/8)."""
    return 8 if batch <= _STREAM_WIDE_B else 32


def slot_count(batch: int, n: int, k: int) -> int:
    """Range count G for the streaming kernel. With tiles = ceil(n/128)
    and m_tiles = ceil(batch / stream_tile_rows(batch)), t tiles per range
    is the largest t with m_tiles * ceil(tiles/t) >= _STREAM_BLOCKS (two
    waves on an H100's 132 SMs), raised until the ceil(tiles/t) * k
    candidates stay within a quarter of n; G = ceil(tiles/t)."""
    tiles = max(1, -(-n // 128))
    m_tiles = -(-batch // stream_tile_rows(batch))
    need = -(-_STREAM_BLOCKS // m_tiles)  # ranges for two waves
    t = tiles if need <= 1 else max(1, (tiles - 1) // (need - 1))
    most = n // (4 * k)  # ranges whose k candidates fit in n/4
    t = tiles if most == 0 else max(t, -(-tiles // most))
    return -(-tiles // t)


def range_rows(n: int, slots: int) -> int:
    """Rows R of each of ``slots`` ranges over n rows: the fewest whole
    128-row tiles that cover n. Ranges past the corpus are empty."""
    tiles = max(1, -(-n // 128))
    return 128 * -(-tiles // slots)


@functools.cache
def _slot_kernel():
    fn = cuda_build.load("slot_stream").slot_stream_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def streaming_candidates_reference(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    weights: torch.Tensor,
    mask: torch.Tensor,
    S: int,
    slots: int,
    exact: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of ``streaming_candidates``: the (B, N) scores padded
    with -inf to slots * R, viewed (B, slots, R), and each range's top S+1
    by ``torch.topk``. Candidates are range-major (column ``g * S +
    rank``); an empty candidate is (-inf, -1)."""
    scores = weighted_scores_reference(queries, corpus, weights, mask, exact=exact)
    b, n = scores.shape
    r = range_rows(n, slots)
    s2 = scores.new_full((b, slots * r), float("-inf"))
    s2[:, :n] = scores
    s3 = s2.view(b, slots, r)
    if r <= S:  # topk needs S+1 entries per range
        s3 = torch.cat([s3, s3.new_full((b, slots, S + 1 - r), float("-inf"))], dim=2)
    vals, pos = torch.topk(s3, S + 1, dim=2)  # (B, slots, S+1), descending
    cand_vals = vals[:, :, :S].reshape(b, slots * S)
    start = torch.arange(slots, device=scores.device)[:, None] * r
    ids = (pos[:, :, :S] + start).reshape(b, slots * S).to(torch.int32)
    ids = torch.where(torch.isneginf(cand_vals), torch.full_like(ids, -1), ids)
    return cand_vals, ids, vals[:, :, S].contiguous()


def streaming_candidates(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    weights: torch.Tensor,
    mask: torch.Tensor,
    S: int,
    slots: int,
    exact: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-S candidates of each of ``slots`` contiguous row ranges.

    Returns (cand_vals (B, slots*S) fp32, cand_ids (B, slots*S) int32,
    bounds (B, slots) fp32). Range g holds rows [g*R, (g+1)*R) with
    R = ``range_rows(N, slots)``; its S best scores, descending, sit at
    columns g*S .. g*S + S-1, and every row of it NOT among them scores
    <= bounds[:, g] (-inf when the range has at most S rows). 1 <= S <=
    128. Modes as ``fused_weighted_scores``.
    ``streaming_candidates.launches`` counts kernel launches."""
    b, d = queries.shape
    n, d2 = corpus.shape
    if d != d2:
        raise ValueError(f"query dim {d} != corpus dim {d2}")
    if tuple(weights.shape) != (n,) or tuple(mask.shape) != (n,):
        raise ValueError(
            f"weights {tuple(weights.shape)} and mask {tuple(mask.shape)} "
            f"must both be ({n},)"
        )
    if slots <= 0 or not 1 <= S <= STREAMING_K_MAX:
        raise ValueError(f"slots={slots} (>= 1), S={S} (1..{STREAMING_K_MAX})")
    if corpus.device.type == "cpu":
        return streaming_candidates_reference(
            queries, corpus, weights, mask, S, slots, exact=exact
        )
    q, w, m = _check_cuda_inputs(queries, corpus, weights, mask)
    dev = corpus.device
    cand_vals = torch.empty((b, slots * S), dtype=torch.float32, device=dev)
    cand_ids = torch.empty((b, slots * S), dtype=torch.int32, device=dev)
    bounds = torch.empty((b, slots), dtype=torch.float32, device=dev)
    if b == 0:
        return cand_vals, cand_ids, bounds
    bf16 = corpus.dtype == torch.bfloat16
    with torch.cuda.device(dev):
        err = _slot_kernel()(
            q.data_ptr(), corpus.data_ptr(), w.data_ptr(), m.data_ptr(),
            cand_vals.data_ptr(), cand_ids.data_ptr(), bounds.data_ptr(),
            b, n, d, slots, range_rows(n, slots), S, stream_tile_rows(b),
            int(bf16), int(bf16 or not exact),
            torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"slot_stream kernel launch failed: CUDA error {err}")
    with _launch_lock:
        streaming_candidates.launches += 1
    return cand_vals, cand_ids, bounds


streaming_candidates.launches = 0


def streaming_topk(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    weights: torch.Tensor,
    mask: torch.Tensor,
    k: int,
    exact: bool = True,
    guarantee: bool = True,
    slots: int = 0,
    depth: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, D) x (N, D) -> level-weighted (values (B, k), indices (B, k)
    int32, certified (B,) bool) without (B, N) scores in device memory.
    k must be <= 128.

    Range candidates (K2) + ONE ``torch.topk`` over (B, slots*S). A query
    is certified when its k-th value is >= the largest range bound: no
    unfetched row can beat it, so at most ties were missed. At the
    default depth S = k this always holds: a range whose (k+1)-th score
    beat the k-th value would hold k+1 rows above it.

    ``guarantee=True`` returns the exact top-k in every case: it reads the
    certificate with one host sync and, if any query failed, redoes the
    batch on the K1 path at the same precision (counted in
    ``streaming_topk.redos``). ``lax.cond`` of the JAX package has no
    sync-free counterpart in eager PyTorch. ``guarantee=False`` does not
    sync and leaves the check to the caller (the store's ``finalize``).
    ``slots=0`` picks the range count with ``slot_count``; ``depth=0``
    keeps S = k candidates per range."""
    b = queries.shape[0]
    n = corpus.shape[0]
    if not 1 <= k <= STREAMING_K_MAX:
        raise ValueError(f"streaming_topk k={k}: 1 <= k <= {STREAMING_K_MAX}")
    S = depth or k
    slots = slots or slot_count(b, n, k)
    if slots * S < k:
        raise ValueError(f"{slots} ranges of depth {S} hold fewer than k={k} candidates")
    cand_vals, cand_ids, bounds = streaming_candidates(
        queries, corpus, weights, mask, S, slots, exact=exact
    )
    vals, sel = torch.topk(cand_vals, k, dim=1)
    idx = torch.gather(cand_ids, 1, sel)
    certified = vals[:, k - 1] >= bounds.amax(dim=1)
    if guarantee and not bool(certified.all()):
        with _launch_lock:
            streaming_topk.redos += 1
        vals, idx = fused_search(queries, corpus, weights, mask, k, exact=exact)
    return vals, idx, certified


streaming_topk.redos = 0
