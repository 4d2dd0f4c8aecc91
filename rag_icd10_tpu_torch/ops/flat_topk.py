"""Exact flat-scan search: batched weighted cosine top-k (plain PyTorch).

Counterpart of rag_icd10_tpu/ops/flat_topk.py. The level weights
{1: 1.2, 2: 1.0, 3: 0.8} multiply the raw inner products, and padding rows
carry weight 0 plus an additive -1e30 mask so they never enter the top-k
(reference: services/milvus_service.py:271-316, :550-558). Queries and
corpus are L2-normalized, so IP == cosine.

These are the plain versions: ``weighted_scores_reference`` is what the
hand-written scoring kernel (ops/fused_score.py) is held against, and
what it computes on CPU tensors.

Numerics: scores fp32. A float32 matmul on the GPU may run in TF32
(about three decimal digits) when ``torch.backends.cuda.matmul.allow_tf32``
is on; the reference turns it off around its matmul (``ieee_fp32``) so
fp32 products are IEEE fp32, the counterpart of the JAX package's
``Precision.HIGHEST``, and leaves the process's setting as it found it.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional, Tuple

import numpy as np
import torch

_tf32_lock = threading.Lock()
_tf32_users = 0
_tf32_saved = False


@contextlib.contextmanager
def ieee_fp32():
    """TF32 off for the matmuls inside; the process's
    ``torch.backends.cuda.matmul.allow_tf32`` is restored when the last
    concurrent user leaves, so threads that overlap never see it back on
    while one of them is still inside."""
    global _tf32_users, _tf32_saved
    with _tf32_lock:
        if _tf32_users == 0:
            _tf32_saved = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = False
        _tf32_users += 1
    try:
        yield
    finally:
        with _tf32_lock:
            _tf32_users -= 1
            if _tf32_users == 0:
                torch.backends.cuda.matmul.allow_tf32 = _tf32_saved


def pad_corpus(
    corpus: np.ndarray,
    weights: np.ndarray,
    multiple: int = 1024,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad corpus rows to a tile multiple.

    Returns (corpus_padded, weights_padded, mask) where mask is 0 for real
    rows and -1e30 for padding rows.
    """
    n, d = corpus.shape
    n_pad = ((n + multiple - 1) // multiple) * multiple
    corpus_p = np.zeros((n_pad, d), dtype=corpus.dtype)
    corpus_p[:n] = corpus
    weights_p = np.zeros((n_pad,), dtype=np.float32)
    weights_p[:n] = weights
    mask = np.full((n_pad,), -1e30, dtype=np.float32)
    mask[:n] = 0.0
    return corpus_p, weights_p, mask


def weighted_scores_reference(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    weights: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    exact: bool = True,
) -> torch.Tensor:
    """(B, D) x (N, D) -> (B, N) fp32 weighted scores. Plain ground truth.

    Queries are cast to the corpus dtype first, as the JAX kernel does;
    a bf16 corpus therefore scores bf16 x bf16 products, which are exact
    in fp32, summed in fp32. ``exact=False`` rounds both operands to bf16
    before the product: the one-bf16-pass mode (JAX ``Precision.DEFAULT``).
    """
    q = queries.to(corpus.dtype)
    c = corpus
    if not exact:
        q, c = q.to(torch.bfloat16), c.to(torch.bfloat16)
    with ieee_fp32():
        scores = torch.matmul(q.float(), c.float().T)
    scores = scores * weights[None, :].float()
    if mask is not None:
        scores = scores + mask[None, :].float()
    return scores


def topk_reference(scores: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Numpy exact top-k (descending, stable ties by index). Host-side
    ground truth for kernel tests."""
    idx = np.argsort(-scores, axis=-1, kind="stable")[:, :k]
    vals = np.take_along_axis(scores, idx, axis=-1)
    return vals, idx


def flat_search(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    weights: torch.Tensor,
    mask: torch.Tensor,
    k: int,
    method: str = "exact",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-call batched search: plain weighted scores + top-k.

    method "exact" and "approx" both select with ``torch.topk``, which is
    exact. PyTorch has no counterpart of ``lax.approx_max_k``; exact
    selection has recall 1.0, above the 0.99 target the JAX package asks
    of its approximate selection.
    Returns (values (B, k) fp32, indices (B, k) int32).
    """
    if method not in ("exact", "approx"):
        raise ValueError(f"flat_search method={method!r}: use exact or approx")
    scores = weighted_scores_reference(queries, corpus, weights, mask)
    vals, idx = torch.topk(scores, k, dim=1)
    return vals, idx.to(torch.int32)
