from .flat_topk import (
    flat_search,
    pad_corpus,
    topk_reference,
    weighted_scores_reference,
)
from .fused_score import fused_search, fused_weighted_scores

__all__ = [
    "flat_search",
    "fused_search",
    "fused_weighted_scores",
    "pad_corpus",
    "topk_reference",
    "weighted_scores_reference",
]
