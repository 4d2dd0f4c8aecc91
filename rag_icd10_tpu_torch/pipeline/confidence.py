"""12-dimensional confidence scoring.

Behavioral spec (reference: services/multidimensional_confidence_service.py):
- 12 ConfidenceFactors (:15-51) grouped base/semantic/complexity/quality
- weights (:97-117): vector .20, hierarchy .15, entity .15, semantic .12,
  context .10, terminology .08, complexity .05, specificity .05,
  clinical .05, data_quality .02, model_uncertainty .02, cross_val .01
- thresholds (:120-125): high .80 / medium .60 / low .40 / reject .20 with
  Chinese level labels (:1159-1168); adjust_thresholds (:1174)
- complexity regex classifier (:138-156) and scoring (:697-729): complex
  +0.8 each, moderate +0.5, simple +0.2, length/50*0.3, separators
  (，；伴) *0.2 capped 0.6, total cap 1.0
- terminology specificity from the ICD corpus: level scores {1:.6, 2:.75,
  3:.9} + name-length/15 (cap .3) + professional-term bonus .1, averaged
  with per-chapter professionalism scores A-Z (:571-675)
- clinical relevance (:846-884): level {3:.4, 2:.3, 1:.2} + chapter
  relevance*0.4 + context consistency*0.2
- data quality (:886-921): completeness*0.4 + range>0.1 +0.3 + max>0.7 +0.3
- model uncertainty (:923-953): (1-min(std,.5)/.5)*0.6 + max_score*0.4
- cross validation (:955-983): top-3 spread heuristic -> .8/.6/.4
- final metrics (:1038-1099): weighted sum capped 1.0; CI = conf ±
  1.96*sqrt(var(scores)); reliability = 1 - min(std(4 key factors),.5)/.5;
  calibration = 1 - |conf - mean(3 factors)|

TPU adaptations: semantic coherence comes from the store's resident
semantic/title embeddings (one gather+dot) instead of re-encoding the
candidate; the terminology cache builds from the already-loaded corpus
instead of re-reading the CSV with pandas.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..utils.device import reraise_device_error

FACTOR_WEIGHTS_DEFAULT = {
    "vector_similarity": 0.20,
    "hierarchy_boost": 0.15,
    "entity_match_score": 0.15,
    "semantic_coherence": 0.12,
    "context_consistency": 0.10,
    "terminology_accuracy": 0.08,
    "diagnosis_complexity": 0.05,
    "professional_specificity": 0.05,
    "clinical_relevance": 0.05,
    "data_quality": 0.02,
    "model_uncertainty": 0.02,
    "cross_validation_score": 0.01,
}

THRESHOLDS_DEFAULT = {
    "high_confidence": 0.80,
    "medium_confidence": 0.60,
    "low_confidence": 0.40,
    "reject_threshold": 0.20,
}

COMPLEXITY_PATTERNS = {
    "simple": [re.compile(p) for p in (r"^[^，。；]{2,8}病$", r"^[^，。；]{2,6}[痛|热|肿]$")],
    "moderate": [
        re.compile(p)
        for p in (r"伴[^，。；]{2,10}", r"[^，。；]{3,12}综合征", r"[急性|慢性][^，。；]{2,10}")
    ],
    "complex": [
        re.compile(p)
        for p in (
            r"[^，。；]{5,}并[^，。；]{5,}",
            r"[^，。；]{3,}伴[^，。；]{3,}伴[^，。；]{3,}",
            r"[^，。；]{8,}酸中毒",
            r"多发性[^，。；]{3,}",
        )
    ],
}

ENTITY_TYPE_WEIGHTS = {
    "disease": 1.0, "symptom": 0.8, "anatomy": 0.6, "pathology": 0.9,
    "treatment": 0.5, "drug": 0.3, "equipment": 0.2,
}

ENTITY_TYPE_SPECIFICITY = {
    "disease": 0.9, "pathology": 0.85, "symptom": 0.6, "anatomy": 0.5,
    "treatment": 0.8, "drug": 0.7, "equipment": 0.4,
}

ICD_LEVEL_SCORES = {1: 0.6, 2: 0.75, 3: 0.9}

CHAPTER_PROFESSIONALISM = {
    "A": 0.8, "B": 0.8, "C": 0.95, "D": 0.9, "E": 0.85, "F": 0.8, "G": 0.9,
    "H": 0.75, "I": 0.9, "J": 0.75, "K": 0.8, "L": 0.7, "M": 0.75, "N": 0.8,
    "O": 0.85, "P": 0.9, "Q": 0.85, "R": 0.6, "S": 0.7, "T": 0.75, "Z": 0.5,
}

CHAPTER_CLINICAL_RELEVANCE = {
    "I": 0.9, "C": 0.9, "E": 0.8, "J": 0.7, "K": 0.7, "N": 0.7, "S": 0.6,
}

PROFESSIONAL_TERMS = (
    "急性", "慢性", "综合征", "功能不全", "梗死", "出血", "肿瘤", "癌", "病毒", "细菌",
)
PROFESSIONAL_KEYWORDS = ("急性", "慢性", "综合征", "功能不全", "梗死", "出血", "肿瘤", "癌")
PROFESSIONAL_PREFIXES = ("急性", "慢性", "原发性", "继发性", "复发性")
PROFESSIONAL_SUFFIXES = ("综合征", "功能不全", "功能障碍", "梗死", "出血", "肿瘤", "癌症")
COMPLEX_TERMS = ("酸中毒", "综合征", "功能不全", "动脉硬化", "心肌梗死")

_TERM_PATTERNS = [
    re.compile(p)
    for p in (
        r"[^，。；\s]{2,10}病",
        r"[^，。；\s]{2,10}症",
        r"[^，。；\s]{2,10}炎",
        r"[^，。；\s]{2,10}综合征",
        r"急性[^，。；\s]{2,10}",
        r"慢性[^，。；\s]{2,10}",
    )
]

CONFIDENCE_LEVEL_LABELS = ("高置信度", "中等置信度", "低置信度", "极低置信度")


@dataclass
class ConfidenceFactors:
    vector_similarity: float = 0.0
    hierarchy_boost: float = 0.0
    entity_match_score: float = 0.0
    semantic_coherence: float = 0.0
    context_consistency: float = 0.0
    terminology_accuracy: float = 0.0
    diagnosis_complexity: float = 0.0
    professional_specificity: float = 0.0
    clinical_relevance: float = 0.0
    data_quality: float = 0.0
    model_uncertainty: float = 0.0
    cross_validation_score: float = 0.0

    def to_dict(self) -> Dict[str, float]:
        return {k: float(v) for k, v in self.__dict__.items()}


@dataclass
class ConfidenceMetrics:
    overall_confidence: float = 0.0
    confidence_interval: Tuple[float, float] = (0.0, 0.0)
    reliability_score: float = 0.0
    prediction_variance: float = 0.0
    calibration_score: float = 0.0

    def to_dict(self) -> Dict[str, Any]:
        return {
            "overall_confidence": float(self.overall_confidence),
            "confidence_interval": [
                float(self.confidence_interval[0]),
                float(self.confidence_interval[1]),
            ],
            "reliability_score": float(self.reliability_score),
            "prediction_variance": float(self.prediction_variance),
            "calibration_score": float(self.calibration_score),
        }


def char_set_similarity(a: str, b: str) -> float:
    sa, sb = set(a.replace(" ", "")), set(b.replace(" ", ""))
    if not sa or not sb:
        return 0.0
    union = sa | sb
    return len(sa & sb) / len(union) if union else 0.0


def context_consistency(query_text: str, candidate_text: str) -> float:
    """Char Jaccard*0.7 + length similarity*0.3, capped 1.0 (:365-390)."""
    jac = char_set_similarity(query_text, candidate_text)
    length_sim = 1.0 - abs(len(query_text) - len(candidate_text)) / max(
        len(query_text), len(candidate_text), 1
    )
    return min(jac * 0.7 + length_sim * 0.3, 1.0)


class MultiDimensionalConfidenceService:
    """Confidence metrics over the top-k candidate slice."""

    def __init__(self, encoder=None, ner_service=None, store=None, corpus=None):
        self.encoder = encoder
        self.ner_service = ner_service
        self.store = store
        self.corpus = corpus if corpus is not None else getattr(store, "corpus", None)
        self.factor_weights = dict(FACTOR_WEIGHTS_DEFAULT)
        self.confidence_thresholds = dict(THRESHOLDS_DEFAULT)
        self._terminology_cache: Optional[Dict[str, float]] = None

    # -------------------------------------------------------------- public

    def calculate_comprehensive_confidence(
        self,
        query_text: str,
        candidate_records: List[Dict[str, Any]],
        similarity_factors: Optional[Dict] = None,
        query_vec: Optional[np.ndarray] = None,
        query_entities: Optional[Dict] = None,
    ) -> Tuple[ConfidenceMetrics, ConfidenceFactors]:
        try:
            factors = ConfidenceFactors()
            if candidate_records:
                best = candidate_records[0]
                sf = similarity_factors or {}
                factors.vector_similarity = float(
                    sf.get("vector_similarity", best.get("score", 0.0))
                )
                factors.hierarchy_boost = float(
                    sf.get("hierarchy_boost", self._hierarchy_score(best))
                )
                factors.entity_match_score = float(
                    sf.get(
                        "entity_match_score",
                        char_set_similarity(query_text, best.get("preferred_zh", "")),
                    )
                )
                factors.semantic_coherence = self._semantic_coherence(
                    query_text, best, query_vec
                )
                candidate_text = best.get("preferred_zh", "")
                factors.context_consistency = context_consistency(
                    query_text, candidate_text
                )
                factors.terminology_accuracy = self._terminology_accuracy(
                    query_text, candidate_text, query_entities=query_entities
                )
                factors.clinical_relevance = self._clinical_relevance(query_text, best)
            factors.diagnosis_complexity = self._diagnosis_complexity(query_text)
            factors.professional_specificity = self._professional_specificity(
                query_text, query_entities=query_entities
            )
            factors.data_quality = self._data_quality(candidate_records)
            factors.model_uncertainty = self._model_uncertainty(candidate_records)
            factors.cross_validation_score = self._cross_validation(candidate_records)
            metrics = self._final_metrics(factors, candidate_records)
            return metrics, factors
        except Exception as e:
            reraise_device_error(e)  # a failing card never degrades
            return ConfidenceMetrics(overall_confidence=0.5), ConfidenceFactors()

    # ------------------------------------------------------ factor helpers

    @staticmethod
    def _hierarchy_score(candidate: Dict) -> float:
        return {1: 0.6, 2: 0.8, 3: 1.0}.get(candidate.get("level", 1), 0.5)

    def _semantic_coherence(
        self, query_text: str, best: Dict, query_vec: Optional[np.ndarray]
    ) -> float:
        cand_id = best.get("id")
        if self.store is not None and query_vec is not None and cand_id is not None:
            sims = self.store.semantic_similarities(
                np.asarray(query_vec)[None, :], np.array([[cand_id]])
            )
            return float(max(sims[0, 0], 0.0))
        if self.encoder is not None:
            try:
                vecs = np.asarray(
                    self.encoder.encode_queries(
                        [query_text, best.get("preferred_zh", "")]
                    )
                )
                return float(max(np.dot(vecs[0], vecs[1]), 0.0))
            except Exception as e:
                reraise_device_error(e)  # a failing card never degrades
                return 0.0
        return 0.0

    # terminology -----------------------------------------------------------

    def _terminology_cache_build(self) -> Dict[str, float]:
        if self._terminology_cache is not None:
            return self._terminology_cache
        cache: Dict[str, float] = {}
        if self.corpus is not None:
            levels = self.corpus.levels
            for title, code, level in zip(
                self.corpus.titles, self.corpus.codes, levels
            ):
                title = title.strip()
                if len(title) <= 1:
                    continue
                base = ICD_LEVEL_SCORES.get(int(level), 0.6)
                base += min(len(title) / 15.0, 0.3)
                if any(t in title for t in PROFESSIONAL_TERMS):
                    base += 0.1
                base = min(base, 1.0)
                chapter = CHAPTER_PROFESSIONALISM.get(code[0].upper(), 0.6) if code else 0.5
                cache[title] = (base + chapter) / 2
        self._terminology_cache = cache
        return cache

    def _term_specificity(self, term: str) -> float:
        cache = self._terminology_cache_build()
        if term in cache:
            return cache[term]
        for icd_term, score in cache.items():
            if (term in icd_term or icd_term in term) and len(term) >= 2 and len(
                icd_term
            ) >= 2:
                ratio = min(len(term), len(icd_term)) / max(len(term), len(icd_term))
                return score * ratio
        return 0.5

    def _term_weight(self, term: str) -> float:
        icd_w = self._term_specificity(term)
        if icd_w > 0.5:
            return icd_w
        w = 0.5
        if len(term) >= 6:
            w += 0.3
        elif len(term) >= 4:
            w += 0.2
        if any(kw in term for kw in PROFESSIONAL_KEYWORDS):
            w += 0.2
        if icd_w != 0.5:
            w = (w + icd_w) / 2
        return min(w, 1.0)

    @staticmethod
    def _extract_terms(text: str) -> Dict[str, float]:
        terms: Dict[str, float] = {}
        for pat in _TERM_PATTERNS:
            for m in pat.findall(text):
                terms[m] = 0.0  # weights filled by caller
        return terms

    def _terminology_accuracy(
        self,
        query_text: str,
        candidate_text: str,
        query_entities: Optional[Dict] = None,
    ) -> float:
        try:
            if self.ner_service is not None:
                return self._terminology_accuracy_ner(
                    query_text, candidate_text, query_entities
                )
            return self._terminology_accuracy_fallback(query_text, candidate_text)
        except Exception as e:
            reraise_device_error(e)  # a failing card never degrades
            return 0.5

    def _terminology_accuracy_ner(
        self,
        query_text: str,
        candidate_text: str,
        query_entities: Optional[Dict] = None,
    ) -> float:
        q_ents = (
            query_entities
            if query_entities is not None
            else self.ner_service.extract_medical_entities(query_text)
        )
        c_ents = self.ner_service.extract_medical_entities(candidate_text)
        total, matched = 0.0, 0.0
        for etype, entities in q_ents.items():
            tw = ENTITY_TYPE_WEIGHTS.get(etype, 0.5)
            for e in entities:
                w = e["confidence"] * tw
                total += w
                if self._entity_in(e, c_ents):
                    matched += w
        if total > 0:
            return min(matched / total, 1.0)
        return char_set_similarity(query_text, candidate_text)

    @staticmethod
    def _entity_in(query_entity: Dict, candidate_entities: Dict) -> bool:
        q = query_entity["text"]
        for elist in candidate_entities.values():
            for e in elist:
                c = e["text"]
                if q == c:
                    return True
                if (q in c or c in q) and len(q) >= 2 and len(c) >= 2:
                    return True
        return False

    def _terminology_accuracy_fallback(
        self, query_text: str, candidate_text: str
    ) -> float:
        q_terms = {t: self._term_weight(t) for t in self._extract_terms(query_text)}
        if not q_terms:
            return char_set_similarity(query_text, candidate_text)
        c_terms = set(self._extract_terms(candidate_text))
        total = sum(q_terms.values())
        matched = sum(w for t, w in q_terms.items() if t in c_terms)
        return matched / total if total > 0 else 0.5

    # complexity ------------------------------------------------------------

    @staticmethod
    def _diagnosis_complexity(query_text: str) -> float:
        score = 0.0
        for pat in COMPLEXITY_PATTERNS["complex"]:
            if pat.search(query_text):
                score += 0.8
        for pat in COMPLEXITY_PATTERNS["moderate"]:
            if pat.search(query_text):
                score += 0.5
        for pat in COMPLEXITY_PATTERNS["simple"]:
            if pat.search(query_text):
                score += 0.2
        score += min(len(query_text) / 50.0, 1.0) * 0.3
        separators = (
            query_text.count("，") + query_text.count("；") + query_text.count("伴")
        )
        if separators > 0:
            score += min(separators * 0.2, 0.6)
        return min(score, 1.0)

    def _professional_specificity(
        self, query_text: str, query_entities: Optional[Dict] = None
    ) -> float:
        try:
            if self.ner_service is not None:
                entities = (
                    query_entities
                    if query_entities is not None
                    else self.ner_service.extract_medical_entities(query_text)
                )
                if any(entities.values()):
                    total, ssum = 0.0, 0.0
                    for etype, elist in entities.items():
                        ts = ENTITY_TYPE_SPECIFICITY.get(etype, 0.5)
                        for e in elist:
                            w = e["confidence"]
                            cs = self._entity_content_specificity(e["text"])
                            total += w
                            ssum += w * (ts + cs) / 2
                    if total > 0:
                        return min(ssum / total, 1.0)
            return self._professional_specificity_fallback(query_text)
        except Exception as e:
            reraise_device_error(e)  # a failing card never degrades
            return 0.5

    @staticmethod
    def _entity_content_specificity(entity_text: str) -> float:
        s = 0.5
        if len(entity_text) >= 6:
            s += 0.2
        elif len(entity_text) >= 4:
            s += 0.1
        if any(entity_text.startswith(p) for p in PROFESSIONAL_PREFIXES):
            s += 0.15
        if any(entity_text.endswith(x) for x in PROFESSIONAL_SUFFIXES):
            s += 0.15
        if any(t in entity_text for t in COMPLEX_TERMS):
            s += 0.1
        return min(s, 1.0)

    def _professional_specificity_fallback(self, query_text: str) -> float:
        terms = {t: self._term_weight(t) for t in self._extract_terms(query_text)}
        if not terms:
            if any(kw in query_text for kw in ("急性", "慢性", "并发", "综合征")):
                return 0.6
            if any(kw in query_text for kw in ("病", "症", "炎")):
                return 0.4
            return 0.2
        total = sum(terms.values())
        return min(total / len(terms), 1.0) if total > 0 else 0.5

    def _clinical_relevance(self, query_text: str, candidate: Dict) -> float:
        score = {3: 0.4, 2: 0.3}.get(candidate.get("level", 1), 0.2)
        code = candidate.get("code", "")
        if code:
            score += CHAPTER_CLINICAL_RELEVANCE.get(code[0], 0.5) * 0.4
        score += context_consistency(query_text, candidate.get("preferred_zh", "")) * 0.2
        return min(score, 1.0)

    # quality ----------------------------------------------------------------

    @staticmethod
    def _data_quality(records: List[Dict]) -> float:
        if not records:
            return 0.0
        complete = sum(
            1
            for r in records
            if r.get("code") and r.get("preferred_zh") and r.get("score", 0) > 0
        )
        score = (complete / len(records)) * 0.4
        scores = [r.get("score", 0) for r in records]
        if scores:
            if max(scores) - min(scores) > 0.1:
                score += 0.3
            if max(scores) > 0.7:
                score += 0.3
        return min(score, 1.0)

    @staticmethod
    def _model_uncertainty(records: List[Dict]) -> float:
        if not records:
            return 0.0
        scores = [r.get("score", 0) for r in records]
        if not scores:
            return 0.0
        std = float(np.std(scores))
        uncertainty = 1.0 - min(std, 0.5) / 0.5
        return min(uncertainty * 0.6 + max(scores) * 0.4, 1.0)

    @staticmethod
    def _cross_validation(records: List[Dict]) -> float:
        if len(records) < 2:
            return 0.5
        top = [r.get("score", 0) for r in records[: min(3, len(records))]]
        if not top:
            return 0.0
        spread = max(top) - min(top)
        if max(top) > 0.8 and spread > 0.2:
            return 0.8
        if max(top) > 0.6 and spread > 0.1:
            return 0.6
        return 0.4

    # final ------------------------------------------------------------------

    def _final_metrics(
        self, factors: ConfidenceFactors, records: List[Dict]
    ) -> ConfidenceMetrics:
        fdict = factors.to_dict()
        overall = sum(
            fdict[name] * self.factor_weights.get(name, 0.0) for name in fdict
        )
        scores = [r.get("score", 0) for r in records]
        variance = float(np.var(scores)) if len(scores) > 1 else 0.1
        std = float(np.sqrt(variance))
        margin = 1.96 * std
        interval = (max(0.0, overall - margin), min(1.0, overall + margin))
        key = [
            factors.vector_similarity,
            factors.entity_match_score,
            factors.semantic_coherence,
            factors.terminology_accuracy,
        ]
        reliability = 1.0 - min(float(np.std(key)), 0.5) / 0.5
        cal_factors = [
            factors.vector_similarity,
            factors.semantic_coherence,
            factors.terminology_accuracy,
        ]
        calibration = max(1.0 - abs(overall - float(np.mean(cal_factors))), 0.0)
        return ConfidenceMetrics(
            overall_confidence=min(overall, 1.0),
            confidence_interval=interval,
            reliability_score=reliability,
            prediction_variance=variance,
            calibration_score=calibration,
        )

    # ---------------------------------------------------------------- meta

    def get_confidence_level(self, confidence: float) -> str:
        t = self.confidence_thresholds
        if confidence >= t["high_confidence"]:
            return "高置信度"
        if confidence >= t["medium_confidence"]:
            return "中等置信度"
        if confidence >= t["low_confidence"]:
            return "低置信度"
        return "极低置信度"

    def should_reject_prediction(self, confidence: float) -> bool:
        return confidence < self.confidence_thresholds["reject_threshold"]

    def adjust_thresholds(self, new_thresholds: Dict[str, float]) -> None:
        for name, value in new_thresholds.items():
            if name in self.confidence_thresholds:
                self.confidence_thresholds[name] = value

    def get_confidence_explanation(
        self, metrics: ConfidenceMetrics, factors: ConfidenceFactors
    ) -> Dict[str, Any]:
        zh = {
            "vector_similarity": "向量相似度",
            "hierarchy_boost": "层级增强",
            "entity_match_score": "实体匹配",
            "semantic_coherence": "语义一致性",
            "context_consistency": "上下文一致性",
            "terminology_accuracy": "术语准确性",
            "diagnosis_complexity": "诊断复杂度",
            "professional_specificity": "专业特异性",
            "clinical_relevance": "临床相关性",
            "data_quality": "数据质量",
            "model_uncertainty": "模型不确定性",
            "cross_validation_score": "交叉验证",
        }
        contributions = {
            zh[name]: {
                "value": value,
                "weight": self.factor_weights.get(name, 0.0),
                "contribution": value * self.factor_weights.get(name, 0.0),
            }
            for name, value in factors.to_dict().items()
        }
        top = sorted(
            contributions.items(), key=lambda x: x[1]["contribution"], reverse=True
        )[:3]
        explanation = {
            "overall_confidence": metrics.overall_confidence,
            "confidence_level": self.get_confidence_level(metrics.overall_confidence),
            "confidence_interval": metrics.confidence_interval,
            "reliability_score": metrics.reliability_score,
            "should_reject": self.should_reject_prediction(metrics.overall_confidence),
            "factor_contributions": contributions,
            "top_contributing_factors": [
                f"{name}: {info['contribution']:.4f}" for name, info in top
            ],
            "improvement_suggestions": (
                [
                    "考虑补充更多医学术语信息",
                    "检查查询文本的完整性和准确性",
                    "增加上下文信息以提高匹配精度",
                ]
                if metrics.overall_confidence < 0.6
                else []
            ),
        }
        return explanation
