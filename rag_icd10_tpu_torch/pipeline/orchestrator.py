"""Multi-diagnosis orchestrator — the per-request pipeline.

Behavioral spec (reference: services/multi_diagnosis_service.py):
- match_multiple_diagnoses (:51-125): extract diagnoses -> per-diagnosis
  enhanced match -> result dict {original_text, extracted_diagnoses,
  matches, total_matches, processing_mode, extraction_metadata}
- enhanced single match (:127-217): NER entities -> encode -> search with
  top_k*2 over-fetch (:153) -> hierarchical batch rescore -> take top_k ->
  12-dim confidence; falls back to plain match on exception
- plain match (:219-273) + heuristic confidence (:275-304):
  max>0.9 -> min(max, 0.95); >=2 scores>0.7 -> max*0.8; else max*0.6,
  rounded to 3dp
- get_diagnosis_suggestions (:387), get_detailed_confidence_report (:423)
  with quality labels 优秀/良好/一般/待改进 (:512-521)

Device-first difference — the hot loop is BATCHED (SURVEY.md §3.2):
the reference runs `for diagnosis: encode -> search -> rescore`
sequentially in Python (:98-103); here ALL extracted diagnoses are encoded
in ONE device call and searched in ONE fused scoring-kernel scan, so a request
with N sub-diagnoses costs the same device time as one. Only the
string-feature rescoring runs per-diagnosis on the small top-k slice.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..utils.device import reraise_device_error
from .confidence import (
    ConfidenceFactors,
    ConfidenceMetrics,
    MultiDimensionalConfidenceService,
)
from .hierarchy import HierarchicalSimilarityService, SimilarityFactors
from .ner import MedicalNERService
from .textproc import DiagnosisTextProcessor


@dataclass
class Candidate:
    """Result row (contract: models/icd_models.py:56-87 in the reference)."""

    code: str
    title: str
    score: float
    level: int = 1
    parent_code: str = ""
    enhanced_score: Optional[float] = None
    original_score: Optional[float] = None
    similarity_factors: Optional[SimilarityFactors] = None

    def to_dict(self) -> Dict[str, Any]:
        out = {
            "code": self.code,
            "title": self.title,
            "score": float(self.score),
            "level": self.level,
            "parent_code": self.parent_code,
            "enhanced_score": (
                float(self.enhanced_score) if self.enhanced_score is not None else None
            ),
            "original_score": (
                float(self.original_score) if self.original_score is not None else None
            ),
            "similarity_factors": (
                self.similarity_factors.to_dict() if self.similarity_factors else None
            ),
        }
        return out


@dataclass
class DiagnosisMatch:
    """Per-diagnosis result (contract: models/icd_models.py:90-124)."""

    diagnosis_text: str
    candidates: List[Candidate]
    match_confidence: float
    confidence_metrics: Optional[ConfidenceMetrics] = None
    confidence_factors: Optional[ConfidenceFactors] = None
    confidence_level: str = ""

    def to_dict(self) -> Dict[str, Any]:
        return {
            "diagnosis_text": self.diagnosis_text,
            "candidates": [c.to_dict() for c in self.candidates],
            "match_confidence": float(self.match_confidence),
            "confidence_metrics": (
                self.confidence_metrics.to_dict() if self.confidence_metrics else None
            ),
            "confidence_factors": (
                self.confidence_factors.to_dict() if self.confidence_factors else None
            ),
            "confidence_level": self.confidence_level,
        }


def _host(x) -> np.ndarray:
    """Query vectors as a host array; the device chain hands over a torch
    tensor that may live on the GPU."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _store_knob_aware(store) -> bool:
    """Signature probe (cached per store type): duck-typed mock stores in
    tests may not accept the per-request knobs; a live-call TypeError
    fallback would mask genuine TypeErrors from inside the store."""
    cls = type(store)
    cached = _KNOB_AWARE_CACHE.get(cls)
    if cached is None:
        import inspect

        try:
            params = inspect.signature(store.search).parameters
            cached = "ef_search" in params or any(
                p.kind == inspect.Parameter.VAR_KEYWORD
                for p in params.values()
            )
        except (TypeError, ValueError):
            cached = False
        _KNOB_AWARE_CACHE[cls] = cached
    return cached


_KNOB_AWARE_CACHE: Dict[type, bool] = {}


class MultiDiagnosisService:
    """Batched multi-diagnosis matching over encoder + vector store."""

    def __init__(
        self,
        encoder,
        store,
        ner_service: Optional[MedicalNERService] = None,
        text_processor: Optional[DiagnosisTextProcessor] = None,
        hierarchical: Optional[HierarchicalSimilarityService] = None,
        confidence: Optional[MultiDimensionalConfidenceService] = None,
        overfetch: int = 2,
    ):
        self.encoder = encoder
        self.store = store
        self.ner_service = ner_service or MedicalNERService()
        self.text_processor = text_processor or DiagnosisTextProcessor(
            encoder=encoder, ner_service=self.ner_service
        )
        # arm the exact-title split bypass with the store's corpus titles
        # (a verbatim-title query IS that diagnosis; never split it —
        # enhanced.py _is_known_title)
        corpus = getattr(store, "corpus", None)
        titles = getattr(corpus, "titles", None)
        if (
            titles is not None
            and getattr(self.text_processor, "known_titles", None) is None
            and hasattr(self.text_processor, "set_known_titles")
        ):
            self.text_processor.set_known_titles(titles)
        self.hierarchical = hierarchical or HierarchicalSimilarityService(
            encoder=encoder, store=store, ner_service=self.ner_service
        )
        self.confidence_service = confidence or MultiDimensionalConfidenceService(
            encoder=encoder, ner_service=self.ner_service, store=store
        )
        self.overfetch = overfetch
        self._fused = None
        self._rescore_executor: Any = False  # False = not yet sized
        import threading

        self._rescore_lock = threading.Lock()

    def _fused_engine(self):
        """Lazily build the fused encode+search engine when supported.

        Opt-in (FUSED_QUERY=1): tokens->embed->score->top-k become one
        CUDA graph replay per (rows, seq, k) bucket (ops/fused_query.py),
        each bucket captured at its first use (the runtime's warmup
        covers the served ones).
        """
        if os.getenv("FUSED_QUERY", "0").lower() not in ("1", "true", "yes"):
            return None
        from ..ops.fused_query import FusedQueryEngine

        if (
            self.store is not None
            and not self.store.is_loaded
            and self.store.config.index_type.upper() == "FLAT"
            and self.store.num_entities
        ):
            # fused path needs device-resident arrays; try to load once
            try:
                self.store.load_collection()
            except Exception as e:
                reraise_device_error(e)
                return None
        if self._fused is not None and (
            self._fused.store is not self.store
            or self._fused.encoder is not self.encoder
        ):
            # encoder/store object was swapped (e.g. resource reload built a
            # fresh store) — drop the engine bound to the old objects
            self._fused = None
        if self._fused is not None and FusedQueryEngine.supports(
            self.encoder, self.store
        ):
            return self._fused
        if FusedQueryEngine.supports(self.encoder, self.store):
            self._fused = FusedQueryEngine(self.encoder, self.store)
            return self._fused
        return None

    # ------------------------------------------------------------- public

    def match_multiple_diagnoses(
        self,
        text: str,
        top_k: int = 5,
        search_method: Optional[str] = None,
        ef_search: Optional[int] = None,
    ) -> Dict[str, Any]:
        return self.match_many_texts(
            [text], top_k, search_method=search_method, ef_search=ef_search
        )[0]

    def match_many_texts(
        self,
        texts: List[str],
        top_k: int = 5,
        search_method: Optional[str] = None,
        ef_search: Optional[int] = None,
    ) -> List[Dict[str, Any]]:
        """Process a BATCH of independent request texts in one device batch.

        This is the request-coalescing entry the API batching layer uses:
        all sub-diagnoses of all texts share ONE encoder forward and ONE
        fused search scan (a capability the reference does not have — it
        processes requests and sub-diagnoses strictly sequentially,
        multi_diagnosis_service.py:98-103).

        Internally composed of three stages — extract (host), device
        (encode+search), rescore (host) — exposed individually so the
        batching layer can PIPELINE them: batch n+1's extraction overlaps
        batch n's device wait, and per-diagnosis rescoring fans out over
        a thread pool on multi-core hosts (RESCORE_WORKERS).
        """
        state = self.extract_stage(texts)
        self.device_stage(
            state, top_k, search_method=search_method, ef_search=ef_search
        )
        return self.rescore_stage(state, top_k)

    def extract_stage(self, texts: List[str]) -> Dict[str, Any]:
        """Stage 1 (host, CPU-bound): extraction + uncertainty-cleaned
        encode texts. Near-device-free: when semantic boundary detection
        is on AND a text has multiple segments, enhanced extraction
        issues one small boundary-embedding encode (safe to overlap with
        the device stage of another batch — see api/batching.py)."""
        from ..utils.metrics import metrics

        per_text: List[Dict[str, Any]] = []
        flat_diagnoses: List[str] = []
        with metrics.timer("extract"):
            if hasattr(self.text_processor, "extract_many_enhanced"):
                extracted = self.text_processor.extract_many_enhanced(texts)
            else:
                extracted = [
                    self.text_processor.extract_diagnoses_enhanced(t) for t in texts
                ]
        for text, enhanced in zip(texts, extracted):
            diagnoses = [
                d.get("diagnosis_text", d.get("text", "")) for d in enhanced
            ]
            diagnoses = [d for d in diagnoses if d]
            confidences = [d.get("diagnosis_confidence", 0.5) for d in enhanced]
            per_text.append(
                {
                    "text": text,
                    "diagnoses": diagnoses,
                    "offset": len(flat_diagnoses),
                    "enhanced_count": len(enhanced),
                    "avg_conf": (
                        sum(confidences) / len(confidences) if confidences else 0.0
                    ),
                }
            )
            flat_diagnoses.extend(diagnoses)
        return {"per_text": per_text, "flat_diagnoses": flat_diagnoses}

    def device_stage(
        self,
        state: Dict[str, Any],
        top_k: int,
        search_method: Optional[str] = None,
        ef_search: Optional[int] = None,
    ) -> Dict[str, Any]:
        """Stage 2 (device): ONE encoder forward + ONE fused search for
        every sub-diagnosis of every text. Mutates ``state`` in place
        (adds query_vecs, all_hits) and returns it."""
        from ..utils.metrics import metrics

        flat_diagnoses = state["flat_diagnoses"]

        # === the batched hot path ===
        # Preferred (FUSED_QUERY=1): ONE CUDA graph replay (tokens ->
        # embeddings -> weighted scores -> top-k); else separate encode +
        # search device calls (mock encoders, HNSW stores, int8 and host
        # residency, released collections).
        #
        # Documented divergence: retrieval ENCODES uncertainty-stripped
        # text. The reference embeds the raw fragment ("考虑弹响膝") and
        # relies on its pretrained encoder shrugging the marker off; the
        # in-domain encoder is brittle to unseen marker tokens, and the
        # clean query is what the corpus semantics match anyway. The RAW
        # text still drives extraction, boosts and rescoring
        # (uncertainty_diagnosis_service.py:112-122 semantics unchanged).
        if flat_diagnoses:
            from .uncertainty import clean_for_encoding

            # title-aware affix strip: verbatim titles (incl. the 115 that
            # intrinsically contain marker words) encode untouched, marked
            # titles peel down to exactly the title (injection then hits)
            titles = getattr(self.text_processor, "known_titles", None)
            encode_texts = [
                clean_for_encoding(d, known_titles=titles)
                for d in flat_diagnoses
            ]
            # per-request search overrides force the two-step path: the
            # fused graph bakes in the FLAT method, and HNSW/ef knobs are
            # host-side concepts
            fused = (
                self._fused_engine()
                if search_method is None and ef_search is None
                else None
            )
            k_fetch = top_k * self.overfetch
            if fused is not None:
                with metrics.timer("encode+search(fused)"):
                    k_eff = min(max(k_fetch, 1), self.store.num_entities)
                    from ..index.vector_store import _bucket_k

                    query_vecs, vals, idx = fused.query(
                        encode_texts, k=_bucket_k(k_eff),
                        method=self.store.config.search_method,
                    )
                    all_hits = self.store.build_hits(
                        vals[:, :k_eff], idx[:, :k_eff]
                    )
            else:
                # keep the embeddings ON DEVICE between encode and search
                # when both sides support it — skipping the host download
                # + re-upload saves a host<->device round trip per coalesced
                # batch; the host copy for rescoring downloads after the
                # search has been issued
                device_chain = getattr(
                    self.encoder, "encode_queries_device", None
                ) is not None and getattr(
                    self.store, "accepts_device_queries", False
                )
                with metrics.timer("encode"):
                    if device_chain:
                        query_dev = self.encoder.encode_queries_device(
                            encode_texts
                        )
                    else:
                        query_vecs = np.asarray(
                            self.encoder.encode_queries(encode_texts)
                        )
                knob_kwargs = (
                    {}
                    if (search_method is None and ef_search is None)
                    or not _store_knob_aware(self.store)
                    else {"method": search_method, "ef_search": ef_search}
                )
                dispatch = getattr(self.store, "search_dispatch", None)
                q_in = query_dev if device_chain else query_vecs
                if dispatch is not None:
                    # non-blocking: issue the device program and return —
                    # every result fetch (embeddings download, top-k
                    # arrays, hit building) moves into
                    # rescore_stage's finalize step, so the device/dispatch
                    # thread is free to feed batch n+1 while batch n
                    # executes and downloads (api/batching.py overlap)
                    with metrics.timer("search"):
                        state["pending_search"] = dispatch(
                            q_in, k_fetch, **knob_kwargs
                        )
                    state["query_pending"] = q_in
                    state["encode_texts"] = encode_texts
                    return state
                with metrics.timer("search"):
                    all_hits = self.store.search(q_in, k_fetch, **knob_kwargs)
                    if device_chain:
                        query_vecs = _host(query_dev)
        else:
            query_vecs, all_hits = np.zeros((0, 1)), []
        if flat_diagnoses:
            self._inject_exact_title_rows(encode_texts, query_vecs, all_hits)
        state["query_vecs"] = query_vecs
        state["all_hits"] = all_hits
        return state

    def _finalize_device_stage(self, state: Dict[str, Any]) -> None:
        """Materialize a deferred device stage (PendingSearch): block on
        the downloads, apply exact-title injection, and populate the
        query_vecs/all_hits the rescore stage consumes. No-op when the
        device stage ran eagerly (mock stores, fused engine, empty
        batch)."""
        pending = state.pop("pending_search", None)
        if pending is None:
            return
        from ..utils.metrics import metrics

        with metrics.timer("finalize"):
            query_vecs = _host(state.pop("query_pending"))
            all_hits = pending.finalize()
            self._inject_exact_title_rows(
                state["encode_texts"], query_vecs, all_hits
            )
        state["query_vecs"] = query_vecs
        state["all_hits"] = all_hits

    def _inject_exact_title_rows(
        self,
        encode_texts: List[str],
        query_vecs: np.ndarray,
        all_hits: List[List],
    ) -> None:
        """Guarantee a verbatim-title diagnosis always has its own corpus
        row among the candidates (store.exact_title_hits has the story:
        x1.2-weighted near-duplicates can push a level-3 row below the
        over-fetch horizon, and the 1.5 exact floor can't fire on an
        unfetched row). No-op on stores without host vectors (remote)."""
        lookup = getattr(self.store, "exact_title_hits", None)
        if lookup is None:
            return
        for i, text in enumerate(encode_texts):
            try:
                extra = lookup(text, query_vecs[i])
            except Exception:
                return  # store without the host-side internals
            if not extra:
                continue
            seen = {h.id for h in all_hits[i] if hasattr(h, "id")}
            all_hits[i].extend(h for h in extra if h.id not in seen)

    def rescore_stage(
        self, state: Dict[str, Any], top_k: int
    ) -> List[Dict[str, Any]]:
        """Stage 3 (host): per-diagnosis enhanced rescoring + response
        assembly. Embarrassingly parallel per diagnosis — fans out over
        the RESCORE_WORKERS thread pool when the host has cores for it."""
        from ..utils.metrics import metrics

        self._finalize_device_stage(state)
        per_text = state["per_text"]
        query_vecs = state["query_vecs"]
        all_hits = state["all_hits"]

        flat: List[tuple] = []  # (diagnosis, flat index)
        for info in per_text:
            for j, diagnosis in enumerate(info["diagnoses"]):
                flat.append((diagnosis, info["offset"] + j))
        with metrics.timer("rescore"):
            pool = self._rescore_pool() if len(flat) > 1 else None
            if pool is not None:
                # lazy caches build once up front instead of racing in
                # the pool (idempotent either way; this avoids N builds)
                build = getattr(
                    self.confidence_service, "_terminology_cache_build", None
                )
                if build is not None:
                    build()
                matches_flat = list(
                    pool.map(
                        lambda t: self._rescore_single(
                            t[0], query_vecs[t[1]], all_hits[t[1]], top_k
                        ),
                        flat,
                    )
                )
            else:
                matches_flat = [
                    self._rescore_single(
                        d, query_vecs[i], all_hits[i], top_k
                    )
                    for d, i in flat
                ]

        results: List[Dict[str, Any]] = []
        pos = 0
        for info in per_text:
            diagnoses = info["diagnoses"]
            if not diagnoses:
                results.append(
                    {
                        "original_text": info["text"],
                        "extracted_diagnoses": [],
                        "matches": [],
                        "total_matches": 0,
                        "processing_mode": self.text_processor.get_processing_mode(),
                        "extraction_metadata": {
                            "enhanced_results_count": info["enhanced_count"],
                            "avg_extraction_confidence": 0.0,
                        },
                    }
                )
                continue
            matches = matches_flat[pos : pos + len(diagnoses)]
            pos += len(diagnoses)
            results.append(
                {
                    "original_text": info["text"],
                    "extracted_diagnoses": diagnoses,
                    "matches": matches,
                    "total_matches": sum(len(m.candidates) for m in matches),
                    "processing_mode": self.text_processor.get_processing_mode(),
                    "extraction_metadata": {
                        "enhanced_results_count": info["enhanced_count"],
                        "avg_extraction_confidence": info["avg_conf"],
                        "extraction_method": "enhanced",
                        "drug_filtering_enabled": True,
                    },
                }
            )
        return results

    def _rescore_pool(self):
        """Shared rescoring ThreadPoolExecutor, or None for sequential.

        RESCORE_WORKERS=0 (default) auto-sizes: cpu_count-1 capped at 8;
        a single-core host (this dev rig) stays sequential — threads buy
        nothing under one core and cost switching overhead."""
        if self._rescore_executor is not False:
            return self._rescore_executor
        with self._rescore_lock:
            # two pipelined batches can race here; only one may build the
            # pool (the loser would leak live threads)
            if self._rescore_executor is not False:
                return self._rescore_executor
            from ..config import _effective_cpu_count, get_config

            workers = get_config().pipeline.rescore_workers
            if workers == 0:
                workers = min(8, max(_effective_cpu_count() - 1, 0))
            if workers <= 1:
                self._rescore_executor = None
            else:
                from concurrent.futures import ThreadPoolExecutor

                self._rescore_executor = ThreadPoolExecutor(
                    max_workers=workers, thread_name_prefix="rescore"
                )
            return self._rescore_executor

    # --------------------------------------------------------- single path

    def _rescore_single(
        self,
        diagnosis: str,
        query_vec: np.ndarray,
        hits: List,
        top_k: int,
    ) -> DiagnosisMatch:
        """Enhanced rescoring of one diagnosis's over-fetched hits
        (reference :127-217, minus the per-diagnosis encode+search which is
        already batched by the caller)."""
        try:
            query_entities = self.ner_service.extract_medical_entities(
                diagnosis, filter_drugs=True
            )
            records = []
            for h in hits:
                rec = h.to_dict() if hasattr(h, "to_dict") else dict(h)
                rec.setdefault("title", rec.get("preferred_zh", ""))
                records.append(rec)
            enhanced = self.hierarchical.batch_calculate_similarities(
                diagnosis, query_entities, records, query_vec=query_vec
            )
            candidates: List[Candidate] = []
            for rec, score, factors in enhanced[:top_k]:
                candidates.append(
                    Candidate(
                        code=rec.get("code", ""),
                        title=rec.get("preferred_zh", rec.get("title", "")),
                        score=float(score),
                        level=rec.get("level", 1),
                        parent_code=rec.get("parent_code", ""),
                        enhanced_score=float(score),
                        original_score=float(rec.get("original_score", 0.0)),
                        similarity_factors=factors,
                    )
                )
            candidate_records = [
                {
                    "id": rec.get("id"),
                    "code": c.code,
                    "title": c.title,
                    "preferred_zh": c.title,
                    "score": c.enhanced_score,
                    "level": c.level,
                }
                for c, (rec, _, _) in zip(candidates, enhanced[: len(candidates)])
            ]
            sf = None
            if enhanced:
                f0 = enhanced[0][2]
                sf = {
                    "vector_similarity": f0.vector_similarity,
                    "hierarchy_boost": f0.hierarchy_boost,
                    "entity_match_score": f0.entity_match_score,
                }
            metrics, factors = self.confidence_service.calculate_comprehensive_confidence(
                diagnosis,
                candidate_records,
                similarity_factors=sf,
                query_vec=query_vec,
                query_entities=query_entities,
            )
            match_confidence = float(metrics.overall_confidence)
            return DiagnosisMatch(
                diagnosis_text=diagnosis,
                candidates=candidates,
                match_confidence=match_confidence,
                confidence_metrics=metrics,
                confidence_factors=factors,
                confidence_level=self.confidence_service.get_confidence_level(
                    match_confidence
                ),
            )
        except Exception as e:
            reraise_device_error(e)  # a failing card never degrades
            return self._match_plain(diagnosis, query_vec, hits, top_k)

    def _match_plain(
        self, diagnosis: str, query_vec: np.ndarray, hits: List, top_k: int
    ) -> DiagnosisMatch:
        """Plain fallback match (reference :219-273)."""
        try:
            candidates = []
            for h in hits[:top_k]:
                rec = h.to_dict() if hasattr(h, "to_dict") else dict(h)
                candidates.append(
                    Candidate(
                        code=rec.get("code", ""),
                        title=rec.get("preferred_zh", rec.get("title", "")),
                        score=float(rec.get("score", 0.0)),
                        level=rec.get("level", 1),
                        parent_code=rec.get("parent_code", ""),
                        enhanced_score=float(rec.get("score", 0.0)),
                        original_score=float(
                            rec.get("original_score", rec.get("score", 0.0))
                        ),
                    )
                )
            return DiagnosisMatch(
                diagnosis_text=diagnosis,
                candidates=candidates,
                match_confidence=self._calculate_match_confidence(candidates),
            )
        except Exception as e:
            reraise_device_error(e)  # a failing card never degrades
            return DiagnosisMatch(
                diagnosis_text=diagnosis, candidates=[], match_confidence=0.0
            )

    @staticmethod
    def _calculate_match_confidence(candidates: List[Candidate]) -> float:
        """Heuristic confidence (reference :275-304)."""
        if not candidates:
            return 0.0
        scores = [c.score for c in candidates]
        max_score = max(scores)
        if max_score > 0.9:
            confidence = min(max_score, 0.95)
        elif len([s for s in scores if s > 0.7]) >= 2:
            confidence = max_score * 0.8
        else:
            confidence = max_score * 0.6
        return round(confidence, 3)

    # ----------------------------------------------------------- reporting

    def get_diagnosis_suggestions(
        self, text: str, min_confidence: float = 0.5
    ) -> List[Dict[str, Any]]:
        """Reference contract :387-421."""
        result = self.match_multiple_diagnoses(text)
        suggestions = []
        for match in result["matches"]:
            if match.match_confidence >= min_confidence and match.candidates:
                suggestions.append(
                    {
                        "diagnosis": match.diagnosis_text,
                        "confidence": match.match_confidence,
                        "best_match": {
                            "code": match.candidates[0].code,
                            "title": match.candidates[0].title,
                            "score": match.candidates[0].score,
                        },
                        "alternative_matches": [
                            {"code": c.code, "title": c.title, "score": c.score}
                            for c in match.candidates[1:]
                        ],
                    }
                )
        return suggestions

    def get_detailed_confidence_report(self, text: str, top_k: int = 5) -> Dict:
        """Reference contract :423-509."""
        try:
            results = self.match_multiple_diagnoses(text, top_k)
            report: Dict[str, Any] = {
                "original_text": text,
                "processing_summary": {
                    "total_diagnoses": len(results.get("matches", [])),
                    "processing_mode": results.get("processing_mode", "standard"),
                    "extraction_metadata": results.get("extraction_metadata", {}),
                },
                "diagnosis_reports": [],
                "overall_assessment": {},
            }
            total_conf, high_count = 0.0, 0
            for match in results.get("matches", []):
                if match.confidence_metrics is None:
                    continue
                explanation = self.confidence_service.get_confidence_explanation(
                    match.confidence_metrics, match.confidence_factors
                )
                report["diagnosis_reports"].append(
                    {
                        "diagnosis": match.diagnosis_text,
                        "match_confidence": match.match_confidence,
                        "confidence_level": match.confidence_level,
                        "confidence_interval": list(
                            match.confidence_metrics.confidence_interval
                        ),
                        "reliability_score": match.confidence_metrics.reliability_score,
                        "top_candidates": [
                            {
                                "code": c.code,
                                "title": c.title,
                                "score": c.score,
                                "enhanced_score": c.enhanced_score or c.score,
                            }
                            for c in match.candidates[:3]
                        ],
                        "factor_analysis": explanation["factor_contributions"],
                        "top_contributing_factors": explanation[
                            "top_contributing_factors"
                        ],
                        "improvement_suggestions": explanation.get(
                            "improvement_suggestions", []
                        ),
                    }
                )
                total_conf += match.match_confidence
                if (
                    match.match_confidence
                    >= self.confidence_service.confidence_thresholds["high_confidence"]
                ):
                    high_count += 1
            if report["diagnosis_reports"]:
                n = len(report["diagnosis_reports"])
                avg = total_conf / n
                report["overall_assessment"] = {
                    "average_confidence": avg,
                    "high_confidence_ratio": high_count / n,
                    "overall_quality": self._overall_quality(avg, high_count, n),
                    "recommendations": self._recommendations(
                        report["diagnosis_reports"]
                    ),
                }
            return report
        except Exception as e:
            return {
                "original_text": text,
                "error": str(e),
                "processing_summary": {},
                "diagnosis_reports": [],
                "overall_assessment": {},
            }

    @staticmethod
    def _overall_quality(avg: float, high_count: int, total: int) -> str:
        if avg >= 0.8 and high_count / total >= 0.7:
            return "优秀"
        if avg >= 0.6 and high_count / total >= 0.5:
            return "良好"
        if avg >= 0.4:
            return "一般"
        return "待改进"

    @staticmethod
    def _recommendations(reports: List[Dict]) -> List[str]:
        recommendations: List[str] = []
        total = len(reports)
        low = sum(1 for r in reports if r["match_confidence"] < 0.6)
        if total and low / total > 0.5:
            recommendations.append("建议补充更详细的临床症状描述")
            recommendations.append("考虑使用更准确的医学术语")
        all_suggestions: List[str] = []
        for r in reports:
            all_suggestions.extend(r.get("improvement_suggestions", []))
        if all_suggestions:
            recommendations.extend(list(dict.fromkeys(all_suggestions))[:2])
        return recommendations
