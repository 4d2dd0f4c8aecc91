"""Certified-exact search from a cheap scan plus a candidate re-rank.

Counterpart of rag_icd10_tpu/ops/rerank.py: the certificate constants of
the certified methods, ``chunk_select_search`` (the ``fast`` method) and
``bf16_rerank_search``.

- ``chunk_select_search`` scores every row with K1
  (``fused_score.fused_weighted_scores``), takes the per-128-row chunk
  maxima, keeps the top ``mc`` chunks and selects the top-k among their
  rows, certified per query: every row of an unfetched chunk is bounded
  by the mc-th chunk maximum plus the scan's rounding.
- ``bf16_rerank_search`` keeps the top-S of each contiguous row range
  with K2 (``fused_score.streaming_candidates``, one bf16 pass), re-ranks
  the top ``m`` candidates in IEEE fp32 and certifies against the
  ranges' bounds.

On a CUDA tensor the scans launch the kernels (or raise); on a CPU tensor
the wrappers compute their plain versions, as the JAX package's CPU
branch does. The chunk maxima, ``torch.topk``, the gathers and the
certificates are plain torch. ``chunk_select_search_reference`` and
``bf16_rerank_search_reference`` are the plain versions of the whole
functions, with the scan's plain version in place of the kernel.

Each epsilon bounds |computed dot - exact dot| <= eps * ||q|| * ||c|| for
the arithmetic the port actually runs on Hopper, with u = 2^-24 the unit
roundoff of fp32 and d <= 1024 for the constants (the ``eps_*(d)``
functions cover any d):

- Any fp32 sum of d products, in any order, errs by at most about
  (d + 1) * u * sum|q_i c_i| <= (d + 1) * u * ||q|| * ||c|| (the standard
  bound; the sequential fmaf order of the port's kernels is one such
  order, cuBLAS's is another).
- bf16 round-to-nearest (``__float2bfloat16_rn``, ``Tensor.to(bfloat16)``)
  errs by at most 2^-9 relative per element.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from .flat_topk import ieee_fp32, weighted_scores_reference
from .fused_score import (
    STREAMING_K_MAX,
    fused_search,
    fused_weighted_scores,
    slot_count,
    streaming_candidates,
    streaming_candidates_reference,
)

# One bf16 pass: q and c each rounded to bf16 (2 * 2^-9), the cross term
# (2^-18), and fp32 accumulation of d <= 1024 products ((d + 1) * u, about
# 6.1e-5; a tensor-core accumulator that truncates instead of rounding
# doubles that to 1.2e-4): 3.91e-3 + 1.2e-4 < 4.2e-3.
EPS_BF16_DOT = 4.2e-3

# The JAX package's Precision.HIGH scan (bf16x3) has no PyTorch spelling:
# torch.set_float32_matmul_precision("high") is single-pass TF32 on CUDA
# (relative error about 2^-11), far outside this bound. The port's "high"
# scans ("xla_high" chunkstream engine, ``chunk_select_search``'s "high")
# therefore run IEEE fp32 (TF32 off, or K1's IEEE paths). This is the JAX
# package's widening and the floor of ``eps_high_dot``.
EPS_HIGH_DOT = 8.0e-5


def eps_high_dot(d: int) -> float:
    """The "high" widening for D = d, per unit of ||q|| * ||c||. An IEEE
    fp32 dot of d products is (d + 1) u away from the real value; a scan
    value compared with another fp32 value of the same real quantity (the
    chunkstream re-score, or a second fp32 convention) is 2 (d + 1) u
    away in all (u = 2^-24): 9.2e-5 at d = 768, 1.83e-4 at d = 1536.
    Floored at EPS_HIGH_DOT, which covers it up to d = 670."""
    return max(EPS_HIGH_DOT, 2 * (d + 1) * 2.0 ** -24)


def eps_bf16_dot(d: int) -> float:
    """One bf16 pass against the exact fp32 re-rank, for D = d, per unit
    of ||q|| * ||c||: the operands' rounding 2 * 2^-9 + 2^-18; the scan's
    accumulation, at most 24 ceil(d / 16) 2^-23 on the tensor cores
    (``chunk_stream.eps_tc_dot``'s model, K1's "mma" path; larger than the
    (d + 1) u of K2's fmaf order); and the re-rank's own fp32 rounding,
    (d + 1) u; 1.01 covers the bf16 operands' norms. Floored at
    EPS_BF16_DOT, which covers it up to d = 1024 (4.09e-3 at d = 768,
    4.28e-3 at d = 1536)."""
    tc = 24 * math.ceil(d / 16) * 2.0 ** -23
    return max(EPS_BF16_DOT, 2 * 2.0 ** -9 + 2.0 ** -18 + 1.01 * tc + (d + 1) * 2.0 ** -24)


def bf16_scan_bound(
    q_norms: torch.Tensor, w_max: float, c_norm_max: float = 1.0
) -> torch.Tensor:
    """Per-query upper bound on |bf16 weighted score - exact weighted
    score| for any corpus row: w_max * eps * ||q|| * max||c||."""
    return (EPS_BF16_DOT * w_max * c_norm_max) * q_norms


def _bound_scale(weights: torch.Tensor, rows: torch.Tensor) -> float:
    """w_max * max row norm, in one pass over the rows (precompute it for
    the hot path: the store does)."""
    r = rows.to(torch.float32)
    return float(weights.max()) * float(torch.sqrt((r * r).sum(dim=1).max()))


def _q_norms(queries: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(queries * queries, dim=1))


def _exact_rerank(queries, corpus_f32, weights, mask, sidx, k):
    """IEEE fp32 weighted scores of the (B, m) candidates ``sidx``, and
    their top-k: (values, indices int32). An empty candidate (id -1, a
    range with fewer rows than its depth) scores -inf."""
    n = corpus_f32.shape[0]
    safe = sidx.long().clamp(0, n - 1)
    cand = corpus_f32[safe].to(torch.float32)  # (B, m, D)
    with ieee_fp32():
        exact = torch.bmm(cand, queries[:, :, None].to(torch.float32))[:, :, 0]
    exact = exact * weights[safe] + mask[safe]
    exact = exact.masked_fill(sidx < 0, float("-inf"))
    vals, sel = torch.topk(exact, k, dim=1)
    return vals, torch.gather(sidx.long(), 1, sel).to(torch.int32)


# ----------------------------------------------------- bf16 scan + re-rank


def _bf16_rerank(
    queries, corpus_f32, weights, mask, k, m, bound_scale, guarantee,
    candidates,
):
    b, d = queries.shape
    n = corpus_f32.shape[0]
    if not 1 <= k <= STREAMING_K_MAX:
        raise ValueError(f"bf16_rerank_search k={k}: 1 <= k <= {STREAMING_K_MAX}")
    if m <= 0:
        m = max(2 * k, k + 8)
    m = min(m, n)
    # K2 keeps S <= 128 per range; m reaches 200 at top_k 50 with the
    # orchestrator's over-fetch, so the depth is min(m, 128) and the
    # ranges together hold the m candidates
    depth = min(m, STREAMING_K_MAX)
    slots = slot_count(b, n, depth)
    cand_vals, cand_ids, bounds = candidates(depth, slots)
    mm = min(m, cand_vals.shape[1])
    svals, sel = torch.topk(cand_vals, mm, dim=1)
    sidx = torch.gather(cand_ids, 1, sel)
    # rows never admitted to a range's top-S are bounded by its bound;
    # admitted but not fetched ones by the mm-th value
    scan_bound = torch.maximum(bounds.amax(dim=1), svals[:, mm - 1])
    vals, idx = _exact_rerank(queries, corpus_f32, weights, mask, sidx, k)
    bscale = _bound_scale(weights, corpus_f32) if bound_scale is None else bound_scale
    bound = eps_bf16_dot(d) * bscale * _q_norms(queries)
    certified = vals[:, k - 1] >= scan_bound + bound
    if guarantee and not bool(certified.all()):
        vals, idx = fused_search(queries, corpus_f32, weights, mask, k)
    return vals, idx, certified


def bf16_rerank_search(
    queries: torch.Tensor,
    corpus_bf16: torch.Tensor,
    corpus_f32: torch.Tensor,
    weights: torch.Tensor,
    mask: torch.Tensor,
    k: int,
    m: int = 0,
    bound_scale: Optional[float] = None,
    guarantee: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact weighted top-k via a bf16 scan + certified fp32 re-rank.

    Returns (values (B, k) fp32, indices (B, k) int32, certified (B,)
    bool). The scan is K2 in its one-bf16-pass mode (``exact=False``)
    over ``corpus_bf16`` at depth min(m, 128) over ``slot_count``'s
    ranges; the top ``m`` candidates (default max(2k, k + 8), capped at
    N) re-rank in IEEE fp32 against ``corpus_f32``. A query is certified
    when its k-th value beats max(largest range bound, m-th scan value)
    + ``eps_bf16_dot(d)`` * bound_scale * ||q||. ``guarantee=True`` reads
    the certificate (one host sync) and redoes an uncertified batch on
    the exact K1 path, so the result is always exact; ``guarantee=False``
    leaves that to the caller. ``bound_scale`` is w_max * max row norm;
    None derives it with one pass over ``corpus_f32``. k <= 128."""
    queries = queries.to(torch.float32)
    return _bf16_rerank(
        queries, corpus_f32, weights, mask, k, m, bound_scale, guarantee,
        lambda s, g: streaming_candidates(
            queries, corpus_bf16, weights, mask, s, g, exact=False),
    )


def bf16_rerank_search_reference(
    queries, corpus_bf16, corpus_f32, weights, mask, k, m=0,
    bound_scale=None, guarantee=True,
):
    """Plain version of ``bf16_rerank_search``: K2's plain version
    (``streaming_candidates_reference``) in place of the kernel."""
    queries = queries.to(torch.float32)
    return _bf16_rerank(
        queries, corpus_f32, weights, mask, k, m, bound_scale, guarantee,
        lambda s, g: streaming_candidates_reference(
            queries, corpus_bf16, weights, mask, s, g, exact=False),
    )


# ---------------------------------------------------------- chunk select

SCAN_PRECISIONS = ("highest", "high", "bf16")


def _chunk_select(
    queries, scores, corpus, weights, mask, k, corpus_f32, mc, m, chunk,
    scan_precision, guarantee, bound_scale,
):
    b, d = queries.shape
    n = scores.shape[1]
    nc = n // chunk
    if mc <= 0:
        mc = max(4 * k, k + 30)
    mc = min(mc, nc)
    if m <= 0:
        m = max(2 * k, k + 8)
    m = min(m, mc * chunk)

    s3 = scores.view(b, nc, chunk)
    cvals, cidx = torch.topk(s3.amax(dim=2), mc, dim=1)  # top mc chunk maxima
    blocks = torch.gather(s3, 1, cidx[:, :, None].expand(b, mc, chunk))
    flat = blocks.reshape(b, mc * chunk)
    cols = (
        cidx[:, :, None] * chunk + torch.arange(chunk, device=cidx.device)
    ).reshape(b, mc * chunk)
    chunk_bound = cvals[:, mc - 1]  # rows in unfetched chunks are <= this

    def eps(coeff):
        ref = corpus_f32 if corpus_f32 is not None else corpus
        bscale = _bound_scale(weights, ref) if bound_scale is None else bound_scale
        return coeff * bscale * _q_norms(queries)

    if scan_precision == "highest":
        vals, sel = torch.topk(flat, k, dim=1)
        idx = torch.gather(cols, 1, sel).to(torch.int32)
        certified = vals[:, k - 1] >= chunk_bound
    elif scan_precision == "high":
        # An unfetched row scans <= chunk_bound, so its true score is
        # <= chunk_bound + e; the returned k-th is >= its scan value - e,
        # with e = (d + 1) u * ||q|| * w_max * max||c|| for the IEEE fp32
        # scan (the port's HIGH), both values coming from that one scan.
        # The 2 eps margin with eps = eps_high_dot(d) >= 2 (d + 1) u
        # covers it twice over. WITHIN the fetched window the ranking is
        # by scan values, so rows whose true scores differ by < 2 eps may
        # permute across the k boundary (the JAX package's contract).
        vals, sel = torch.topk(flat, k, dim=1)
        idx = torch.gather(cols, 1, sel).to(torch.int32)
        certified = vals[:, k - 1] >= chunk_bound + 2 * eps(eps_high_dot(d))
    else:  # bf16 scan + IEEE fp32 re-rank of the top m
        if corpus_f32 is None:
            raise ValueError("scan_precision='bf16' needs corpus_f32 for the re-rank")
        svals, sel = torch.topk(flat, m, dim=1)
        sidx = torch.gather(cols, 1, sel)
        vals, idx = _exact_rerank(queries, corpus_f32, weights, mask, sidx, k)
        certified = vals[:, k - 1] >= (
            torch.maximum(chunk_bound, svals[:, m - 1]) + eps(eps_bf16_dot(d))
        )

    if guarantee and not bool(certified.all()):
        if scan_precision == "highest":
            vals, i = torch.topk(scores, k, dim=1)  # the scores are exact
            idx = i.to(torch.int32)
        else:
            ref = corpus_f32 if corpus_f32 is not None else corpus
            vals, idx = fused_search(queries, ref.to(torch.float32), weights, mask, k)
    return vals, idx, certified


def _check_chunk_select(corpus, chunk, scan_precision):
    if scan_precision not in SCAN_PRECISIONS:
        raise ValueError(f"scan_precision={scan_precision!r}: one of {SCAN_PRECISIONS}")
    if corpus.shape[0] % chunk:
        raise ValueError(f"N={corpus.shape[0]} is not a multiple of chunk={chunk}")
    if scan_precision != "bf16" and corpus.dtype != torch.float32:
        raise ValueError(f"scan_precision={scan_precision!r} needs an fp32 corpus")


def chunk_select_search(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    weights: torch.Tensor,
    mask: torch.Tensor,
    k: int,
    corpus_f32: Optional[torch.Tensor] = None,
    mc: int = 0,
    m: int = 0,
    chunk: int = 128,
    scan_precision: str = "highest",
    guarantee: bool = True,
    bound_scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Certified top-k via chunk-max candidate selection.

    The (B, N) scores come from one K1 launch; their per-``chunk``-column
    maxima select the top ``mc`` chunks (default max(4k, k + 30), capped
    at N / chunk), and the top-k runs over those mc * chunk columns,
    certified per query against the mc-th chunk maximum.

    scan_precision:
      "highest" K1 in IEEE fp32 (``exact=True``) over the fp32 corpus;
                certified iff the k-th value beats the mc-th chunk max.
      "high"    the same scan: IEEE fp32 is the port's spelling of the
                JAX package's Precision.HIGH (bf16x3), and tighter. The
                certificate keeps the JAX package's 2 eps margin
                (``eps_high_dot(d)``).
      "bf16"    K1 over a bf16 corpus (``corpus``, with ``corpus_f32``
                its fp32 rows): the top ``m`` (default max(2k, k + 8))
                candidates re-rank in IEEE fp32 and the certificate adds
                ``eps_bf16_dot(d)``.
    guarantee=True reads the certificate (one host sync) and redoes an
    uncertified batch exactly: "highest" from its exact scores, the
    others on the exact K1 path over the fp32 rows. N must be a multiple
    of ``chunk``.

    Returns (values (B, k) fp32, indices (B, k) int32, certified (B,)).
    """
    _check_chunk_select(corpus, chunk, scan_precision)
    queries = queries.to(torch.float32)
    scores = fused_weighted_scores(queries, corpus, weights, mask)
    return _chunk_select(
        queries, scores, corpus, weights, mask, k, corpus_f32, mc, m, chunk,
        scan_precision, guarantee, bound_scale,
    )


def chunk_select_search_reference(
    queries, corpus, weights, mask, k, corpus_f32=None, mc=0, m=0,
    chunk=128, scan_precision="highest", guarantee=True, bound_scale=None,
):
    """Plain version of ``chunk_select_search``: K1's plain version
    (``weighted_scores_reference``) in place of the kernel."""
    _check_chunk_select(corpus, chunk, scan_precision)
    queries = queries.to(torch.float32)
    scores = weighted_scores_reference(queries, corpus, weights, mask)
    return _chunk_select(
        queries, scores, corpus, weights, mask, k, corpus_f32, mc, m, chunk,
        scan_precision, guarantee, bound_scale,
    )
