"""The one symmetric per-row int8 quantization law.

Counterpart of ``quantize_rows`` in rag_icd10_tpu/ops/quantized.py, which
every int8 consumer of the JAX package shares (int8 residency, the sketch
screen, the chunk-store build). The chunkstream certificate measures its
build-time residual against exactly this law, so both spellings here
agree with the JAX package's bit for bit: absmax / 127 per row, scale 1
for an all-zero row, round half to even, clip to +-127.

The int8 search paths (``int8_search``, the int8 residency tier) are not
ported yet.
"""

from __future__ import annotations

import threading
from typing import Tuple, Union

import numpy as np
import torch

from .flat_topk import ieee_fp32

Array = Union[np.ndarray, torch.Tensor]


def quantize_rows(x: Array) -> Tuple[Array, Array]:
    """Symmetric per-row int8 quantization: x ~= q * scale[:, None].

    A numpy array gives numpy (q int8, scale fp32); a tensor gives
    tensors on its device. Divisions are elementwise IEEE fp32 divisions
    in both spellings: on CUDA, PyTorch turns a division by a Python
    scalar into a multiplication by its reciprocal, which rounds
    differently, so the torch spelling divides by a tensor."""
    if isinstance(x, torch.Tensor):
        x = x.to(torch.float32)
        absmax = x.abs().amax(dim=1)
        scale = torch.where(
            absmax > 0, absmax / torch.full_like(absmax, 127.0),
            torch.ones_like(absmax),
        )
        q = torch.clamp(torch.round(x / scale[:, None]), -127, 127)
        return q.to(torch.int8), scale
    x = np.asarray(x, np.float32)
    absmax = np.abs(x).max(axis=1)
    scale = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.rint(x / scale[:, None]), -127, 127).astype(np.int8)
    return q, scale


_launch_lock = threading.Lock()


def _pad_to(t: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """``t`` zero-padded to (rows, cols); ``t`` itself when it fits."""
    if tuple(t.shape) == (rows, cols):
        return t.contiguous()
    out = t.new_zeros((rows, cols))
    out[: t.shape[0], : t.shape[1]] = t
    return out


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B, D) int8 x (N, D) int8 -> (B, N) int32, exact.

    On a CUDA tensor: ``torch._int_mm(a, b.T)`` (cuBLASLt int8 tensor
    cores, int32 accumulation), which takes a first dimension above 16
    and inner and last dimensions that are multiples of 8; B pads with
    zero rows to max(24, a multiple of 8), D and N with zeros where they
    are not multiples of 8 (zeros add nothing to an integer sum), and the
    padding is cut off the result. Never a float path: it raises where
    the library refuses. On the CPU: an int32 ``matmul``.
    ``int8_matmul.launches`` counts the calls on the card."""
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f"int8 operands expected, got {a.dtype} and {b.dtype}")
    bq, d = a.shape
    n, d2 = b.shape
    if d != d2:
        raise ValueError(f"inner dimensions differ: {d} and {d2}")
    if a.device != b.device:
        raise ValueError(f"operands on {a.device} and {b.device}")
    if a.device.type == "cpu":
        return torch.matmul(a.to(torch.int32), b.to(torch.int32).T)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    bp = max(24, -(-bq // 8) * 8)
    dp = -(-d // 8) * 8
    np_ = -(-n // 8) * 8
    out = torch._int_mm(_pad_to(a, bp, dp), _pad_to(b, np_, dp).T)
    with _launch_lock:
        int8_matmul.launches += 1
    return out[:bq, :n]


int8_matmul.launches = 0


def int8_scores(
    queries: torch.Tensor,
    corpus_q: torch.Tensor,
    corpus_scale: torch.Tensor,
    weights: torch.Tensor,
    mask: torch.Tensor,
) -> torch.Tensor:
    """(B, N) fp32 weighted scores of the quantized queries against the
    int8 corpus, in the JAX package's association:
    acc * q_scale[:, None] * (scale * w)[None, :] + mask[None, :].

    The queries quantize by ``quantize_rows``'s law. The JAX package
    spells their scale ``q_absmax / 127.0`` inside ``jit``, where XLA may
    multiply by the reciprocal instead, one ulp away in a few rows; the
    port divides (IEEE). Such a row's int8 values can then differ by one
    where a value sits on a rounding boundary."""
    q_i8, q_scale = quantize_rows(queries.to(torch.float32))
    acc = int8_matmul(q_i8, corpus_q)
    return (
        acc.to(torch.float32) * q_scale[:, None] * (corpus_scale * weights)[None, :]
        + mask[None, :]
    )


def int8_search(
    queries: torch.Tensor,
    corpus_q: torch.Tensor,
    corpus_scale: torch.Tensor,
    weights: torch.Tensor,
    mask: torch.Tensor,
    k: int,
    method: str = "exact",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted top-k over the quantized corpus: (values (B, k) fp32,
    indices (B, k) int32). Queries quantize per row on their device
    (their scale folds into the epilogue). "approx" selects exactly, as
    ``flat_topk.flat_search`` does (PyTorch has no ``approx_max_k``)."""
    if method not in ("exact", "approx"):
        raise ValueError(f"int8_search method={method!r}: use exact or approx")
    scores = int8_scores(queries, corpus_q, corpus_scale, weights, mask)
    vals, idx = torch.topk(scores, k, dim=1)
    return vals, idx.to(torch.int32)


def int8_search_device_rerank(
    queries: torch.Tensor,
    corpus_q: torch.Tensor,
    corpus_scale: torch.Tensor,
    weights: torch.Tensor,
    mask: torch.Tensor,
    k: int,
    m: int = 0,
    method: str = "exact",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 scan + on-device re-rank of the top-m (default max(4k, k + 16),
    capped at N) candidates with the FULL-PRECISION query against the
    dequantized rows (IEEE fp32): only the rows' own quantization error
    remains, and the int8 matrix is the only corpus-sized array. Returns
    (values, indices (B, k))."""
    n = corpus_q.shape[0]
    if m <= 0:
        m = max(4 * k, k + 16)
    m = min(m, n)
    _, cand = int8_search(
        queries, corpus_q, corpus_scale, weights, mask, k=m, method=method
    )
    safe = cand.long().clamp(0, n - 1)
    rows = corpus_q[safe].to(torch.float32) * corpus_scale[safe][:, :, None]
    with ieee_fp32():
        exact = torch.bmm(rows, queries.to(torch.float32)[:, :, None])[:, :, 0]
    exact = exact * weights[safe] + mask[safe]
    vals, sel = torch.topk(exact, k, dim=1)
    return vals, torch.gather(cand, 1, sel).to(torch.int32)
