"""Fused scoring kernel: Q·Cᵀ × level-weight + padding mask, then top-k.

Counterpart of rag_icd10_tpu/ops/pallas_score.py for the served ``exact``
and ``approx`` methods. One pass over the corpus computes, for a whole
batch of queries, the level-weighted cosine scores that the reference
produces with a Milvus FLAT/IP scan followed by a Python re-weighting
loop (reference: services/milvus_service.py:271-316).

On a CUDA tensor ``fused_weighted_scores`` launches the hand-written
kernel ``csrc/fused_score.cu`` (the source note there gives its bound
and design) or raises; on a CPU tensor it computes the plain version,
``flat_topk.weighted_scores_reference``, which the kernel is held
against. The TPU kernel's VMEM tile budget (``default_tile_n``) has no
meaning here: the CUDA kernel picks its own tiles and masks the ragged
edge, so N need not be a multiple of anything.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Tuple

import torch

from . import cuda_build
from .flat_topk import weighted_scores_reference

_launch_lock = threading.Lock()


@functools.cache
def _kernel():
    fn = cuda_build.load("fused_score").fused_score_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fused_weighted_scores(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    weights: torch.Tensor,
    mask: torch.Tensor,
    exact: bool = True,
) -> torch.Tensor:
    """(B, D) x (N, D) -> (B, N) fp32 weighted+masked scores.

    ``corpus`` is fp32 or bf16; ``exact=True`` keeps fp32 inputs exact,
    ``exact=False`` rounds them to bf16 (one bf16 pass, ~3e-3 relative
    score error). A bf16 corpus always scores bf16 x bf16 products in fp32.
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
    if corpus.device.type != "cuda":
        raise ValueError(f"unsupported device {corpus.device}")
    for name, t in (("queries", queries), ("weights", weights), ("mask", mask)):
        if t.device != corpus.device:
            raise ValueError(f"{name} on {t.device}, corpus on {corpus.device}")
    if corpus.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"corpus dtype {corpus.dtype}: float32 or bfloat16")
    if not corpus.is_contiguous():
        raise ValueError("corpus must be contiguous")
    if d % 8:
        raise ValueError(f"D={d}: the kernel reads rows 16 bytes at a time, D % 8 == 0")
    q = queries.to(torch.float32).contiguous()  # bf16 -> fp32 is exact
    w = weights.to(torch.float32).contiguous()
    m = mask.to(torch.float32).contiguous()
    if q.data_ptr() % 16 or corpus.data_ptr() % 16:
        raise ValueError("queries and corpus must be 16-byte aligned")
    out = torch.empty((b, n), dtype=torch.float32, device=corpus.device)
    if b == 0 or n == 0:
        return out
    bf16 = corpus.dtype == torch.bfloat16
    with torch.cuda.device(corpus.device):
        err = _kernel()(
            q.data_ptr(), corpus.data_ptr(), w.data_ptr(), m.data_ptr(),
            out.data_ptr(), b, n, d, int(bf16), int(bf16 or not exact),
            torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"fused_score kernel launch failed: CUDA error {err}")
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
    "streaming", the in-kernel top-k of the JAX package, is not yet
    ported."""
    if method == "streaming":
        raise ValueError(
            "search method 'streaming' (in-kernel streaming top-k) not yet "
            "ported to rag_icd10_tpu_torch"
        )
    if method not in ("exact", "approx"):
        raise ValueError(f"fused_search method={method!r}: use exact or approx")
    scores = fused_weighted_scores(queries, corpus, weights, mask, exact=exact)
    vals, idx = torch.topk(scores, k, dim=1)
    return vals, idx.to(torch.int32)
