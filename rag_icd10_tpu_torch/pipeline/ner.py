"""Medical NER — rule-based extraction with an optional PyTorch model mode.

Behavioral spec (reference: services/medical_ner_service.py):
- Two modes: HF token-classification model (:62-101) with 15-label map
  (:43-59) and rule fallback (:103-141). Here the model mode runs the
  port's token classifier (pipeline/ner_model.py, converted weights, env
  NER_WEIGHTS_PATH) on the service's device; when no weights are set or
  the weights directory cannot be read it uses rule mode — the same
  graceful degradation the reference performs when the HF download fails
  (:94-101). A failure of the card never degrades: it raises
  (utils/device.py ``is_device_error``). Model extractions and
  extractions that fell back to rules while model mode was asked for are
  counted (``stats``, shown in /stats).
- Rule patterns for disease/symptom/anatomy with stop words and
  meaningless-phrase filters (:103-141, :281-295).
- Rule confidence heuristic: base 0.5 + length bonuses + type-specific
  feature-word bonuses, capped 1.0 (:296-321).
- Overlap dedup keeping higher confidence (:323-351).
- Model-entity validity: len>=2, confidence >= MEDICAL_NER_MIN_CONFIDENCE
  (default 0.5), not a stop word (:265-279).
- Post-filter through DiagnosisEntityFilter when filter_drugs=True
  (:170-174).
- ``identify_diagnosis_keywords`` (:353), ``get_entity_summary`` (:403),
  ``get_filter_stats`` (:449), ``get_model_info`` (:381) contracts kept.
"""

from __future__ import annotations

import logging
import re
import threading
from typing import Any, Dict, List, Optional, Union

import torch

from ..config import NERConfig
from ..utils.device import is_device_error
from .entity_filter import DiagnosisEntityFilter

logger = logging.getLogger("rag_icd10_tpu_torch.ner")

# Model label -> standard entity type (reference :43-59)
ENTITY_TYPE_MAPPING = {
    # the offline-distilled head (tools/train_ner.py LABELS) uses the
    # short "Disease" name; without this row every distilled disease
    # span mapped to "other" and model mode could only LOSE to rules
    "Disease": "disease",
    "DiseaseNameOrComprehensiveCertificate": "disease",
    "Symptom": "symptom",
    "BodyParts": "anatomy",
    "OrganOrCellDamage": "pathology",
    "Drug": "drug",
    "TreatmentOrPreventionProcedures": "treatment",
    "TreatmentEquipment": "equipment",
    "InspectionProcedure": "inspection",
    "MedicalTestingItems": "lab_indicator",
    "Department": "department",
    "Sign": "sign",
    "InjuryOrPoisoning": "injury",
    "Microbiology": "microbiology",
    "MedicalProcedures": "procedure",
    "InspectEquipment": "inspect_equipment",
}

RULE_PATTERNS: Dict[str, List[re.Pattern]] = {
    "disease": [
        re.compile(p)
        for p in (
            r"(?:急性|慢性|原发性|继发性|复发性|亚急性)?[^，。；\s]{2,12}(?:病|症|炎|癌|瘤|综合征)",
            r"(?:急性|慢性)?[^，。；\s]{2,8}(?:感染|中毒|损伤|破裂|梗死|出血)",
            r"(?:I|II|III|IV|V)+型[^，。；\s]{2,8}(?:病|症)",
            r"[^，。；\s]{2,8}(?:功能不全|功能障碍|衰竭)",
        )
    ],
    "symptom": [
        re.compile(p)
        for p in (
            r"(?:反复|持续|间歇性|突发性)?[^，。；\s]{2,6}(?:痛|疼|热|胀|肿|晕|麻|痒)",
            r"(?:大量|少量|血性|脓性)?[^，。；\s]{2,6}(?:出血|分泌|呕吐|腹泻)",
            r"[^，。；\s]{2,6}(?:不适|异常|增大|缩小|肥厚)",
            r"(?:阵发性|持续性)?[^，。；\s]{2,6}(?:咳嗽|气促|心悸|失眠)",
        )
    ],
    "anatomy": [
        re.compile(p)
        for p in (
            r"(?:左|右|双侧|上|下|前|后)?(?:心|肝|肺|肾|胃|肠|脑|骨|脊柱)[^，。；\s]{0,6}",
            r"(?:左|右|双侧)?(?:乳腺|甲状腺|前列腺|子宫|卵巢)[^，。；\s]{0,4}",
            r"(?:颈|胸|腰|骶|尾)椎[^，。；\s]{0,4}",
            r"(?:主|冠状|肺|肾)动脉[^，。；\s]{0,4}",
        )
    ],
}

STOP_WORDS = frozenset(
    {
        "待查", "考虑", "疑似", "排除", "？", "?", "诊断为", "患者", "病人",
        "检查", "发现", "显示", "提示", "建议", "需要", "进一步", "复查",
        "治疗", "用药", "服用", "注射", "输液", "手术", "康复",
    }
)

MEANINGLESS_PHRASES = frozenset({"不详", "不明", "不清", "未明确", "待定", "观察", "随访"})

_NUMERIC_ONLY_RE = re.compile(r"^[\d\s\-+.]+$")


def _is_valid_rule_entity(text: str) -> bool:
    if not text or len(text) < 2:
        return False
    if text in STOP_WORDS or text in MEANINGLESS_PHRASES:
        return False
    if _NUMERIC_ONLY_RE.match(text):
        return False
    return True


def _rule_confidence(entity_text: str, entity_type: str) -> float:
    """Base 0.5 + length + feature-word bonuses (reference :296-321)."""
    conf = 0.5
    if len(entity_text) >= 4:
        conf += 0.1
    if len(entity_text) >= 6:
        conf += 0.1
    if entity_type == "disease":
        if any(s in entity_text for s in ("病", "症", "炎", "癌", "瘤")):
            conf += 0.2
        if any(p in entity_text for p in ("急性", "慢性", "原发性")):
            conf += 0.1
    elif entity_type == "symptom":
        if any(s in entity_text for s in ("痛", "热", "胀", "肿", "出血")):
            conf += 0.2
    elif entity_type == "anatomy":
        if any(p in entity_text for p in ("心", "肝", "肺", "肾", "脑")):
            conf += 0.2
    return min(conf, 1.0)


def _dedup_overlapping(entities: List[Dict]) -> List[Dict]:
    """Overlapping spans keep the higher-confidence entity (reference
    :323-351)."""
    if not entities:
        return []
    entities = sorted(entities, key=lambda e: (e["start"], -e["confidence"]))
    kept: List[Dict] = []
    for ent in entities:
        replaced = False
        for existing in list(kept):
            if ent["start"] < existing["end"] and ent["end"] > existing["start"]:
                if ent["confidence"] > existing["confidence"]:
                    kept.remove(existing)
                    kept.append(ent)
                replaced = True
                break
        if not replaced:
            kept.append(ent)
    return sorted(kept, key=lambda e: e["confidence"], reverse=True)


class MedicalNERService:
    """Rule-based NER with optional PyTorch token-classifier mode. The
    classifier runs on ``cuda`` unless ``device="cpu"`` is passed."""

    def __init__(
        self,
        config: Optional[NERConfig] = None,
        entity_filter: Optional[DiagnosisEntityFilter] = None,
        device: Union[str, torch.device] = "cuda",
    ):
        self.config = config or NERConfig()
        self.entity_filter = entity_filter or DiagnosisEntityFilter()
        self.device = device
        self.use_model = self.config.use_model
        self._model = None
        # model extractions; extractions served by rules while model mode
        # was asked for (no weights, unreadable weights, a failed predict)
        self._counts = {"model_extractions": 0, "rule_fallbacks": 0}
        self._counts_lock = threading.Lock()
        self.fallback_reason: Optional[str] = None
        if self.use_model:
            self._init_model()

    def _init_model(self) -> None:
        """Load the token classifier if converted weights exist; else
        degrade to rule mode (mirrors the reference's fallback,
        medical_ner_service.py:94-101). A device error raises."""
        import os

        weights = os.getenv("NER_WEIGHTS_PATH")
        if not weights:
            self.use_model = False
            self.fallback_reason = "NER_WEIGHTS_PATH not set"
            return
        try:
            from .ner_model import TorchTokenClassifier

            self._model = TorchTokenClassifier.from_weights(weights, device=self.device)
        except Exception as e:
            if is_device_error(e):
                raise
            logger.warning("NER weights %s unreadable (%s): rule mode", weights, e)
            self.use_model = False
            self._model = None
            self.fallback_reason = f"weights unreadable: {type(e).__name__}: {e}"

    def _count(self, key: str) -> None:
        with self._counts_lock:
            self._counts[key] += 1

    # ------------------------------------------------------------ public

    def extract_medical_entities(
        self, text: str, filter_drugs: bool = True
    ) -> Dict[str, List[Dict[str, Any]]]:
        if not text or not text.strip():
            return {}
        if self.use_model and self._model is not None:
            try:
                entities = self._extract_with_model(text)
                self._count("model_extractions")
            except Exception as e:
                if is_device_error(e):
                    raise
                logger.warning("NER model failed (%s): rules for this text", e)
                entities = self._extract_with_rules(text)
                self._count("rule_fallbacks")
        else:
            entities = self._extract_with_rules(text)
            if self.config.use_model:
                self._count("rule_fallbacks")
        if filter_drugs:
            entities = self.entity_filter.filter_entities(entities, text)
        return entities

    def _extract_with_rules(self, text: str) -> Dict[str, List[Dict[str, Any]]]:
        entities: Dict[str, List[Dict[str, Any]]] = {}
        for etype, patterns in RULE_PATTERNS.items():
            found: List[Dict[str, Any]] = []
            for pat in patterns:
                for match in pat.finditer(text):
                    etext = match.group().strip()
                    if _is_valid_rule_entity(etext):
                        found.append(
                            {
                                "text": etext,
                                "start": match.start(),
                                "end": match.end(),
                                "confidence": _rule_confidence(etext, etype),
                                "pattern": pat.pattern,
                                "source": "rules",
                            }
                        )
            entities[etype] = _dedup_overlapping(found)
        return entities

    def _extract_with_model(self, text: str) -> Dict[str, List[Dict[str, Any]]]:
        spans = self._model.predict(text)  # [(text, label, score, start, end)]
        entities: Dict[str, List[Dict[str, Any]]] = {}
        for etext, label, score, start, end in spans:
            etext = etext.replace(" ", "").replace("##", "")
            if not etext or len(etext) < 2:
                continue
            if score < self.config.min_confidence or etext in STOP_WORDS:
                continue
            std = ENTITY_TYPE_MAPPING.get(label, "other")
            entities.setdefault(std, []).append(
                {
                    "text": etext,
                    "start": start,
                    "end": end,
                    "confidence": float(score),
                    "original_label": label,
                    "source": "model",
                }
            )
        for etype in entities:
            entities[etype] = _dedup_overlapping(entities[etype])
        return entities

    def identify_diagnosis_keywords(self, text: str) -> List[str]:
        """Disease entities first; symptoms if none (reference :353-379)."""
        entities = self.extract_medical_entities(text)
        threshold = 0.5 if self.use_model else 0.6
        keywords = [
            e["text"] for e in entities.get("disease", []) if e["confidence"] > threshold
        ]
        if not keywords:
            threshold = 0.6 if self.use_model else 0.7
            keywords = [
                e["text"]
                for e in entities.get("symptom", [])
                if e["confidence"] > threshold
            ]
        return keywords

    def get_model_info(self) -> Dict[str, Any]:
        return {
            "model_name": self.config.model_name,
            "use_model": self.use_model,
            "model_loaded": self._model is not None,
            "entity_types": (
                list(ENTITY_TYPE_MAPPING.keys())
                if self.use_model
                else list(RULE_PATTERNS.keys())
            ),
            "fallback_available": True,
            "device": str(self._model.device) if self._model is not None else "CPU",
        }

    def counts(self) -> Dict[str, int]:
        """Model extractions and fallbacks to rules so far."""
        with self._counts_lock:
            return dict(self._counts)

    def stats(self) -> Dict[str, Any]:
        """``get_model_info`` (whose keys the reference's /entities contract
        fixes) plus the counts, the classifier's forwards and why model
        mode fell back, for /stats."""
        return {
            **self.get_model_info(),
            **self.counts(),
            "model_forwards": self._model.forwards if self._model is not None else 0,
            "fallback_reason": self.fallback_reason,
        }

    def get_entity_summary(self, text: str) -> Dict[str, Any]:
        """Reference contract :403-447."""
        entities = self.extract_medical_entities(text)
        summary: Dict[str, Any] = {
            "total_entities": sum(len(v) for v in entities.values()),
            "entity_types": list(entities.keys()),
            "high_confidence_entities": [],
            "primary_diagnosis_candidates": [],
            "extraction_method": "model" if (self.use_model and self._model) else "rules",
            "model_info": self.get_model_info(),
        }
        high_threshold = 0.8 if self.use_model else 0.7
        diag_threshold = 0.5 if self.use_model else 0.6
        for etype, elist in entities.items():
            for e in elist:
                if e["confidence"] > high_threshold:
                    summary["high_confidence_entities"].append(
                        {
                            "type": etype,
                            "text": e["text"],
                            "confidence": e["confidence"],
                            "source": e.get("source", "unknown"),
                        }
                    )
        diseases = entities.get("disease", [])
        if diseases:
            summary["primary_diagnosis_candidates"] = [
                e["text"] for e in diseases[:3] if e["confidence"] > diag_threshold
            ]
        return summary

    def get_filter_stats(self, text: str) -> Dict[str, Any]:
        original = self.extract_medical_entities(text, filter_drugs=False)
        filtered = self.extract_medical_entities(text, filter_drugs=True)
        return self.entity_filter.get_filter_stats(original, filtered)
