"""Hierarchical similarity rescoring engine.

Behavioral spec (reference: services/hierarchical_similarity_service.py):
- 6-factor SimilarityFactors (:15-32)
- factor weights: vector .50 / hierarchy .20 / entity .15 / semantic .08 /
  category .04 / context .03 (:76-83); update_weights re-normalizes to
  sum 1 (:627-639)
- hand-coded ICD chapter keyword map for A/B/C/E/I/J/K/N/S (:93-141)
- exact match: title == query forces vector_similarity=1.0 when < 0.9 and
  final score >= 1.5 (:160-209)
- additive scoring (:475-518): final = base + Σ enhancements where each
  enhancement is factor * weight / DEFAULT_WEIGHT (divisors are the
  hard-coded defaults .2/.15/.08/.04/.03); hierarchy contribution halves
  when base > 0.95; semantic adds only its excess over base; +0.15
  precision bonus when base > 0.95; cap **1.8**
- hierarchy_boost (:243-281): level-boost {1:.15, 2:.20, 3:.10}*0.3 +
  chapter keyword boost*0.4 + parent-child prefix boost(0.1)*0.3, cap 0.3
- chapter semantic boost (:296-327): query keyword fraction * 0.3 *
  semantic_weight + per-disease-entity keyword fraction * 0.2 * entity
  confidence, cap 0.4
- entity match (:341-385): disease in-title confidence*0.4 (containment) /
  *0.2 (word overlap), symptom *0.2, anatomy *0.1, cap 1.0
- semantic coherence (:387-409): cosine(query, semantic_text); here served
  from precomputed HBM-resident semantic embeddings (ONE gather+dot)
  instead of 2 encoder forwards per candidate
- category alignment (:411-446): confidence-weighted fraction of query
  entities matching the candidate chapter's keywords
- context relevance (:448-473): length similarity*0.3 + char Jaccard*0.7
- batch path (:520-579): uncertainty preprocessing first, then score all
  candidates and sort desc
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..utils.device import reraise_device_error
from .uncertainty import process_uncertainty_query

FACTOR_WEIGHTS_DEFAULT = {
    "vector_similarity": 0.50,
    "hierarchy_boost": 0.20,
    "entity_match_score": 0.15,
    "semantic_coherence": 0.08,
    "category_alignment": 0.04,
    "context_relevance": 0.03,
}

# divisors in the additive model are the hard-coded default weights
_ENH_DIVISORS = {
    "hierarchy_boost": 0.2,
    "entity_match_score": 0.15,
    "semantic_coherence": 0.08,
    "category_alignment": 0.04,
    "context_relevance": 0.03,
}

LEVEL_BOOST_FACTORS = {1: 0.15, 2: 0.20, 3: 0.10}
SCORE_CAP = 1.8
EXACT_MATCH_FLOOR = 1.5
PRECISION_BONUS = 0.15
HIGH_PRECISION_THRESHOLD = 0.95

MAIN_CATEGORIES: Dict[str, Dict[str, Any]] = {
    "A": {
        "name": "某些传染病和寄生虫病",
        "keywords": ["感染", "传染", "病毒", "细菌", "寄生虫", "真菌"],
        "semantic_weight": 1.1,
    },
    "B": {
        "name": "肿瘤",
        "keywords": ["癌", "瘤", "肿瘤", "恶性", "良性", "转移"],
        "semantic_weight": 1.2,
    },
    "C": {
        "name": "血液及造血器官疾病",
        "keywords": ["血液", "贫血", "白血病", "出血", "凝血"],
        "semantic_weight": 1.0,
    },
    "E": {
        "name": "内分泌、营养和代谢疾病",
        "keywords": ["糖尿病", "甲状腺", "代谢", "内分泌", "营养"],
        "semantic_weight": 1.1,
    },
    "I": {
        "name": "循环系统疾病",
        "keywords": ["心脏", "血管", "高血压", "心肌", "循环"],
        "semantic_weight": 1.2,
    },
    "J": {
        "name": "呼吸系统疾病",
        "keywords": ["肺", "呼吸", "咳嗽", "气管", "支气管"],
        "semantic_weight": 1.1,
    },
    "K": {
        "name": "消化系统疾病",
        "keywords": ["胃", "肠", "肝", "消化", "腹泻"],
        "semantic_weight": 1.0,
    },
    "N": {
        "name": "泌尿生殖系统疾病",
        "keywords": ["肾", "膀胱", "泌尿", "生殖", "尿"],
        "semantic_weight": 1.0,
    },
    "S": {
        "name": "损伤、中毒和外因的某些其他后果",
        "keywords": ["损伤", "外伤", "骨折", "中毒", "烧伤"],
        "semantic_weight": 0.9,
    },
}


@dataclass
class SimilarityFactors:
    vector_similarity: float = 0.0
    hierarchy_boost: float = 0.0
    entity_match_score: float = 0.0
    semantic_coherence: float = 0.0
    category_alignment: float = 0.0
    context_relevance: float = 0.0

    def to_dict(self) -> Dict[str, float]:
        return {
            "vector_similarity": float(self.vector_similarity),
            "hierarchy_boost": float(self.hierarchy_boost),
            "entity_match_score": float(self.entity_match_score),
            "semantic_coherence": float(self.semantic_coherence),
            "category_alignment": float(self.category_alignment),
            "context_relevance": float(self.context_relevance),
        }


def char_jaccard(a: str, b: str) -> float:
    sa, sb = set(a), set(b)
    union = sa | sb
    return len(sa & sb) / len(union) if union else 0.0


class HierarchicalSimilarityService:
    """Vectorized multi-factor rescoring over the top-k candidate slice.

    ``store`` (VectorStore) provides precomputed semantic-text embeddings so
    semantic coherence is a device gather+dot instead of per-candidate
    re-embedding; ``encoder`` is the fallback when no store is wired.
    """

    def __init__(self, encoder=None, store=None, ner_service=None):
        self.encoder = encoder
        self.store = store
        self.ner_service = ner_service
        self.level_weights = {1: 1.2, 2: 1.0, 3: 0.8}
        self.factor_weights = dict(FACTOR_WEIGHTS_DEFAULT)

    # ------------------------------------------------------------- factors

    def _hierarchy_boost(
        self, query_text: str, query_entities: Dict, record: Dict
    ) -> float:
        level = record.get("level", 1)
        code = record.get("code", "")
        parent_code = record.get("parent_code", "")
        boost = LEVEL_BOOST_FACTORS.get(level, 0.10) * 0.3
        chapter = code[0] if code else ""
        if chapter in MAIN_CATEGORIES:
            boost += (
                self._category_semantic_boost(
                    query_text, query_entities, MAIN_CATEGORIES[chapter]
                )
                * 0.4
            )
        if parent_code and len(code) > len(parent_code) and code.startswith(
            parent_code
        ):
            boost += 0.1 * 0.3
        return float(min(boost, 0.3))

    @staticmethod
    def _category_semantic_boost(
        query_text: str, query_entities: Dict, category_info: Dict
    ) -> float:
        keywords = category_info.get("keywords", [])
        semantic_weight = category_info.get("semantic_weight", 1.0)
        if not keywords:
            return 0.0
        boost = 0.0
        q = query_text.lower()
        matched = sum(1 for kw in keywords if kw in q)
        if matched:
            boost += (matched / len(keywords)) * 0.3 * semantic_weight
        for entity in query_entities.get("disease", []):
            etext = entity.get("text", "").lower()
            ematches = sum(1 for kw in keywords if kw in etext)
            if ematches:
                boost += (ematches / len(keywords)) * 0.2 * entity.get(
                    "confidence", 0.5
                )
        return float(min(boost, 0.4))

    @staticmethod
    def _entity_match_score(query_entities: Dict, record: Dict) -> float:
        title = record.get("preferred_zh", "").lower()
        semantic = record.get("semantic_text", "").lower()
        combined = f"{title} {semantic}"
        score = 0.0
        for entity in query_entities.get("disease", []):
            etext = entity.get("text", "").lower()
            conf = entity.get("confidence", 0.5)
            if etext and etext in combined:
                score += conf * 0.4
            elif any(w in combined for w in etext.split()):
                score += conf * 0.2
        for entity in query_entities.get("symptom", []):
            etext = entity.get("text", "").lower()
            if etext and etext in combined:
                score += entity.get("confidence", 0.5) * 0.2
        for entity in query_entities.get("anatomy", []):
            etext = entity.get("text", "").lower()
            if etext and etext in combined:
                score += entity.get("confidence", 0.5) * 0.1
        return float(min(score, 1.0))

    def _semantic_coherence_batch(
        self, query_text: str, records: Sequence[Dict], query_vec=None
    ) -> np.ndarray:
        """Batched cosine(query, semantic_text) — one device op via the
        store's resident semantic matrix; encoder fallback; 0.5 default."""
        n = len(records)
        ids = [r.get("id") for r in records]
        if (
            self.store is not None
            and query_vec is not None
            and all(i is not None for i in ids)
        ):
            sims = self.store.semantic_similarities(
                np.asarray(query_vec)[None, :], np.asarray(ids)[None, :]
            )[0]
            return np.maximum(sims.astype(np.float32), 0.0)
        if self.encoder is not None:
            texts = [r.get("semantic_text", "") for r in records]
            present = [bool(t) for t in texts]
            out = np.full((n,), 0.3, dtype=np.float32)
            to_encode = [t for t, p in zip(texts, present) if p]
            if to_encode:
                qv = np.asarray(self.encoder.encode_query(query_text))
                cv = np.asarray(self.encoder.encode_queries(to_encode))
                sims = cv @ qv
                j = 0
                for i, p in enumerate(present):
                    if p:
                        out[i] = max(float(sims[j]), 0.0)
                        j += 1
            return out
        return np.full((n,), 0.5, dtype=np.float32)

    @staticmethod
    def _category_alignment(query_entities: Dict, record: Dict) -> float:
        code = record.get("code", "")
        if not code or code[0] not in MAIN_CATEGORIES:
            return 0.0
        keywords = MAIN_CATEGORIES[code[0]].get("keywords", [])
        score, total = 0.0, 0
        for _etype, entities in query_entities.items():
            for entity in entities:
                total += 1
                etext = entity.get("text", "").lower()
                if any(kw in etext for kw in keywords):
                    score += entity.get("confidence", 0.5)
        return float(score / total) if total else 0.0

    @staticmethod
    def _context_relevance(query_text: str, record: Dict) -> float:
        title = record.get("preferred_zh", "")
        ql, cl = len(query_text), len(title)
        length_sim = 1.0 - abs(ql - cl) / max(ql, cl, 1)
        overlap = char_jaccard(query_text, title)
        return max(length_sim * 0.3 + overlap * 0.7, 0.0)

    # -------------------------------------------------------------- scoring

    def _weighted_score(self, factors: SimilarityFactors) -> float:
        """Additive model with hard-coded divisor normalization and the
        1.8 cap (reference :475-518)."""
        base = factors.vector_similarity
        high_precision = base > HIGH_PRECISION_THRESHOLD
        enh = 0.0
        hw = 0.5 if high_precision else 1.0
        enh += (
            factors.hierarchy_boost
            * self.factor_weights["hierarchy_boost"]
            / _ENH_DIVISORS["hierarchy_boost"]
            * hw
        )
        enh += (
            factors.entity_match_score
            * self.factor_weights["entity_match_score"]
            / _ENH_DIVISORS["entity_match_score"]
        )
        if factors.semantic_coherence > base:
            enh += (
                (factors.semantic_coherence - base)
                * self.factor_weights["semantic_coherence"]
                / _ENH_DIVISORS["semantic_coherence"]
            )
        enh += (
            factors.category_alignment
            * self.factor_weights["category_alignment"]
            / _ENH_DIVISORS["category_alignment"]
        )
        enh += (
            factors.context_relevance
            * self.factor_weights["context_relevance"]
            / _ENH_DIVISORS["context_relevance"]
        )
        if high_precision:
            enh += PRECISION_BONUS
        return float(min(base + enh, SCORE_CAP))

    def calculate_enhanced_similarity(
        self,
        query_text: str,
        query_entities: Dict,
        record: Dict,
        semantic_coherence: Optional[float] = None,
    ) -> Tuple[float, SimilarityFactors]:
        """Single-candidate scoring (reference :143-219).

        ``semantic_coherence`` may be precomputed by the batch path."""
        factors = SimilarityFactors()
        try:
            title = record.get("preferred_zh", "").strip()
            is_exact = title == query_text.strip()
            factors.vector_similarity = float(record.get("score", 0.0))
            if is_exact and factors.vector_similarity < 0.9:
                factors.vector_similarity = 1.0
            factors.hierarchy_boost = self._hierarchy_boost(
                query_text, query_entities, record
            )
            factors.entity_match_score = self._entity_match_score(
                query_entities, record
            )
            if semantic_coherence is not None:
                factors.semantic_coherence = float(semantic_coherence)
            else:
                factors.semantic_coherence = float(
                    self._semantic_coherence_batch(query_text, [record])[0]
                )
            factors.category_alignment = self._category_alignment(
                query_entities, record
            )
            factors.context_relevance = self._context_relevance(query_text, record)
            score = self._weighted_score(factors)
            if is_exact:
                score = max(score, EXACT_MATCH_FLOOR)
            return float(score), factors
        except Exception as e:
            reraise_device_error(e)  # a failing card never degrades
            return float(record.get("score", 0.0)), factors

    def batch_calculate_similarities(
        self,
        query_text: str,
        query_entities: Dict,
        candidate_records: List[Dict],
        query_vec: Optional[np.ndarray] = None,
    ) -> List[Tuple[Dict, float, SimilarityFactors]]:
        """Uncertainty preprocessing + enhanced scoring + sort desc
        (reference :520-579). Semantic coherence computed in one batched op."""
        processed_query, processed = process_uncertainty_query(
            query_text, candidate_records
        )
        coherences = self._semantic_coherence_batch(
            processed_query, processed, query_vec=query_vec
        )
        results: List[Tuple[Dict, float, SimilarityFactors]] = []
        for record, coherence in zip(processed, coherences):
            try:
                score, factors = self.calculate_enhanced_similarity(
                    processed_query,
                    query_entities,
                    record,
                    semantic_coherence=float(coherence),
                )
                enhanced = dict(record)
                enhanced["enhanced_score"] = score
                enhanced["original_score"] = record.get(
                    "original_score", record.get("score", 0.0)
                )
                enhanced["similarity_factors"] = factors
                results.append((enhanced, score, factors))
            except Exception as e:
                reraise_device_error(e)  # a failing card never degrades
                results.append(
                    (record, float(record.get("score", 0.0)), SimilarityFactors())
                )
        # primary: enhanced score desc (reference :575). Secondary (our
        # documented divergence): an exact-title candidate outranks
        # non-exact ones at EQUAL score — near-identical siblings routinely
        # tie with the exact match at the 1.8 cap, and the reference's
        # stable sort then keeps the raw weighted order, which the x1.2
        # level weights bias toward level-1/2 siblings over the exact
        # level-3 row. Tertiary (same divergence class): at EQUAL capped
        # score among non-exact candidates, the raw weighted similarity
        # orders them — the 1.8 cap otherwise erases the retrieval signal
        # entirely and near-identical siblings rank arbitrarily above the
        # true nearest row (measured: ~40% of the incumbent's paraphrase
        # misses were a capped gold at rank 2-3 behind a sibling with
        # LOWER raw similarity).
        q = processed_query.strip()

        def raw_similarity(cand: Dict) -> float:
            # original_score carries TWO reference-mandated semantics:
            # search hits store the raw UNWEIGHTED cosine
            # (vector_store.SearchHit, milvus_service.py:174-186), while
            # uncertainty-boosted candidates store the WEIGHTED pre-boost
            # score (uncertainty.py, uncertainty_diagnosis_service.py:
            # 190-238). Comparing the two directly would hand boosted
            # ancestors a ×1.2 head start — the exact inversion class
            # this tie-break exists to break — so undo the level weight
            # on the boosted form to land both on the unweighted scale.
            raw = float(cand.get("original_score", cand.get("score", 0.0)))
            if "uncertainty_boost" in cand:
                w = self.level_weights.get(int(cand.get("level", 2)), 1.0)
                if w:
                    raw /= w
            return raw

        results.sort(
            key=lambda x: (
                x[1],
                x[0].get("preferred_zh", "").strip() == q,
                raw_similarity(x[0]),
            ),
            reverse=True,
        )
        return results

    # ---------------------------------------------------------------- meta

    def get_similarity_explanation(self, factors: SimilarityFactors) -> Dict:
        return {
            "total_score": self._weighted_score(factors),
            "factors": {
                name: {
                    "score": value,
                    "weight": self.factor_weights[name],
                    "contribution": value * self.factor_weights[name],
                }
                for name, value in factors.to_dict().items()
            },
        }

    def update_weights(self, new_weights: Dict[str, float]) -> None:
        """Runtime weight updates with sum-to-1 renormalization
        (reference :627-639)."""
        for factor, weight in new_weights.items():
            if factor in self.factor_weights:
                self.factor_weights[factor] = weight
        total = sum(self.factor_weights.values())
        if total != 1.0 and total > 0:
            for factor in self.factor_weights:
                self.factor_weights[factor] /= total
