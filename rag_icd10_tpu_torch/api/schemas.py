"""API request/response contracts.

Field-for-field parity with the reference pydantic models
(reference: models/icd_models.py):
- QueryRequest{text, top_k=5, ge=1 le=50} (:135-138)
- StandardizeRequest{text, top_k=10, llm_provider ^(deepseek|openai|local)$}
  (:161-165)
- Candidate{code,title,score>=0,level,parent_code,enhanced_score,
  original_score,similarity_factors} (:56-87) — score has NO upper bound
  (enhanced scores reach 1.8 by design, SURVEY.md §2.5#5)
- DiagnosisMatch{diagnosis_text,candidates,match_confidence in [0,1],
  confidence_metrics,confidence_factors,confidence_level} (:90-124)
- QueryResponse{candidates,is_multi_diagnosis,extracted_diagnoses,
  diagnosis_matches,processing_metadata} (:141-158)
- StandardizeResponse{results} (:168-181), Embedding{Request,Response}
  (:184-192), HealthCheckResponse (:210-215)
- recursive convert_numpy_types incl. dataclasses (:14-37)
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
from pydantic import BaseModel, Field


def convert_numpy_types(obj: Any) -> Any:
    """Recursively convert numpy scalars/arrays and dataclasses to plain
    Python types (reference: models/icd_models.py:14-37)."""
    if isinstance(obj, dict):
        return {k: convert_numpy_types(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        converted = [convert_numpy_types(v) for v in obj]
        return converted if isinstance(obj, list) else tuple(converted)
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.bool_):
        return bool(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return convert_numpy_types(dataclasses.asdict(obj))
    return obj


class QueryRequest(BaseModel):
    text: str = Field(..., description="诊断文本", min_length=1)
    top_k: int = Field(default=5, description="返回候选数量", ge=1, le=50)
    # Per-request index knobs (superset of the reference contract, which
    # accepts only {text, top_k} — icd_models.py:135-138 — and exposes
    # index params only via Milvus config, README_MILVUS_CONFIG.md).
    search_method: Optional[str] = Field(
        default=None,
        description="检索方法覆盖",
        pattern="^(exact|approx|fast|streaming|chunkstream|sketch|hnsw)$",
    )
    ef_search: Optional[int] = Field(
        default=None, description="HNSW beam宽度覆盖", ge=1, le=4096
    )


class StandardizeRequest(BaseModel):
    text: str = Field(..., description="诊断文本", min_length=1)
    top_k: int = Field(default=10, description="候选数量", ge=1, le=50)
    llm_provider: str = Field(
        default="deepseek", description="LLM提供商", pattern="^(deepseek|openai|local)$"
    )


class Candidate(BaseModel):
    code: str = Field(..., description="ICD-10编码")
    title: str = Field(..., description="标准诊断名称")
    score: float = Field(..., description="相似度分数", ge=0)
    level: Optional[int] = Field(default=1, description="ICD层级")
    parent_code: Optional[str] = Field(default="", description="父级编码")
    enhanced_score: Optional[float] = Field(default=None, description="增强后分数")
    original_score: Optional[float] = Field(default=None, description="原始分数")
    similarity_factors: Optional[Dict[str, float]] = Field(
        default=None, description="相似度因子明细"
    )


class DiagnosisMatch(BaseModel):
    diagnosis_text: str = Field(..., description="诊断文本")
    candidates: List[Candidate] = Field(default_factory=list)
    match_confidence: float = Field(..., description="匹配置信度", ge=0.0, le=1.0)
    confidence_metrics: Optional[Dict[str, Any]] = Field(default=None)
    confidence_factors: Optional[Dict[str, float]] = Field(default=None)
    confidence_level: Optional[str] = Field(default=None)


class QueryResponse(BaseModel):
    candidates: List[Candidate] = Field(default_factory=list)
    is_multi_diagnosis: bool = Field(default=False)
    extracted_diagnoses: List[str] = Field(default_factory=list)
    diagnosis_matches: List[DiagnosisMatch] = Field(default_factory=list)
    processing_metadata: Optional[Dict[str, Any]] = Field(default=None)


class StandardizeResponse(BaseModel):
    results: List[Any] = Field(default_factory=list)


class MultiDiagnosisRequest(BaseModel):
    """(reference: models/icd_models.py:195-199)"""

    text: str = Field(..., description="包含多个诊断的文本", min_length=1)
    top_k: int = Field(default=5, description="每个诊断返回候选数量", ge=1, le=20)
    separator: Optional[str] = Field(default=None, description="分隔符，空则自动识别")


class MultiDiagnosisResponse(BaseModel):
    """(reference: models/icd_models.py:202-207)"""

    original_text: str = Field(...)
    extracted_diagnoses: List[str] = Field(...)
    matches: List[DiagnosisMatch] = Field(...)
    total_matches: int = Field(...)


class EmbeddingRequest(BaseModel):
    texts: List[str] = Field(..., description="要向量化的文本列表")


class EmbeddingResponse(BaseModel):
    embeddings: List[List[float]] = Field(...)
    model: str = Field(...)


class HealthCheckResponse(BaseModel):
    status: str = Field(...)
    milvus_connected: bool = Field(...)
    embedding_model_loaded: bool = Field(...)
    total_records: int = Field(...)
