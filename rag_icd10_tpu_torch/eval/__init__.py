"""Retrieval-quality evaluation (counterpart of rag_icd10_tpu/eval/)."""

from .retrieval import EvalTier, build_eval_set, evaluate  # noqa: F401
