"""Diagnosis entity filter — keeps diagnosis-bearing entities, drops
drugs/equipment/departments unless context says otherwise.

Behavioral spec (reference: services/diagnosis_entity_filter.py):
- config from env (:61-70): strict_mode False, keep_drug_diseases True,
  keep_lab_indicators True, context_window 20, confidence_threshold 0.6,
  enable_context_analysis True
- strict mode (:102-140): keep only {disease, symptom, anatomy, pathology,
  injury, sign, microbiology} (+lab_indicator if configured) above the
  confidence threshold
- smart mode (:142-237):
  * drug entities: drop obvious drug-name shapes (…片/…胶囊/…霉素/A-prefix
    etc.); keep ones with diagnosis context/characteristics under the key
    'drug_related_disease'
  * treatment/procedure: keep if disease-suffix or diagnosis context, under
    '<type>_related_disease'
  * equipment/inspect_equipment: keep only with disease characteristics,
    under '<type>_related'
  * department: always dropped
  * lab_indicator: relaxed threshold min(0.5, configured)
  * everything else: confidence-threshold filter
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional

from ..config import FilterConfig

DRUG_DIAGNOSIS_KEYWORDS = frozenset(
    {
        "过敏", "中毒", "不良反应", "副作用", "依赖", "滥用",
        "耐药", "抗药性", "药物性", "中毒性", "戒断", "成瘾",
        "肝毒性", "肾毒性", "心脏毒性", "神经毒性",
    }
)

DRUG_NAME_PATTERNS = tuple(
    re.compile(p)
    for p in (
        r".*片$", r".*胶囊$", r".*注射液$", r".*口服液$",
        r".*颗粒$", r".*软膏$", r".*滴眼液$", r".*喷雾剂$",
        r".*素$", r".*霉素$", r".*西林$", r".*沙星$",
        r".*洛尔$", r".*普利$", r".*沙坦$", r".*司汀$",
        r"^阿.*", r"^氨.*", r"^左.*", r"^右.*",
        r".*缓释.*", r".*控释.*", r".*肠溶.*",
    )
)

TREATMENT_PATTERNS = tuple(
    re.compile(p)
    for p in (
        r".*手术$", r".*切除术$", r".*造影$", r".*穿刺$",
        r".*化疗$", r".*放疗$", r".*康复$", r".*训练$",
        r".*护理$", r".*检查$", r".*监测$",
    )
)

DISEASE_SUFFIXES = frozenset(
    {
        "病", "症", "炎", "癌", "瘤", "综合征", "性疾病",
        "功能不全", "功能障碍", "衰竭", "梗死", "出血",
        "破裂", "穿孔", "狭窄", "扩张", "增生", "萎缩",
    }
)

DIAGNOSIS_CONTEXT_KEYWORDS = DRUG_DIAGNOSIS_KEYWORDS | {
    "诊断", "疑似", "考虑", "排除", "病史", "既往史",
    "症状", "表现", "发作", "急性", "慢性", "复发",
    "并发症", "合并症", "继发", "原发",
}

STRICT_DIAGNOSIS_TYPES = frozenset(
    {"disease", "symptom", "anatomy", "pathology", "injury", "sign", "microbiology"}
)


class DiagnosisEntityFilter:
    """Strict or smart (context-aware) entity filtering."""

    def __init__(self, config: Optional[FilterConfig] = None):
        self.config = config or FilterConfig()
        self._stats = {"processed": 0, "kept": 0, "dropped": 0}

    # ------------------------------------------------------------ public

    def filter_entities(
        self, entities: Dict[str, List[Dict]], text: str = ""
    ) -> Dict[str, List[Dict]]:
        before = sum(len(v) for v in entities.values())
        if self.config.strict_mode:
            result = self._strict_filter(entities)
        else:
            result = self._smart_filter(entities, text)
        after = sum(len(v) for v in result.values())
        self._stats["processed"] += before
        self._stats["kept"] += after
        self._stats["dropped"] += before - after
        return result

    def get_filter_stats(
        self,
        original: Optional[Dict[str, List[Dict]]] = None,
        filtered: Optional[Dict[str, List[Dict]]] = None,
    ) -> Dict:
        if original is not None and filtered is not None:
            o = sum(len(v) for v in original.values())
            f = sum(len(v) for v in filtered.values())
            return {
                "original_count": o,
                "filtered_count": f,
                "removed_count": o - f,
                "removal_rate": round((o - f) / o, 3) if o else 0.0,
                "mode": "strict" if self.config.strict_mode else "smart",
            }
        return {**self._stats, "mode": "strict" if self.config.strict_mode else "smart"}

    # ------------------------------------------------------------ strict

    def _strict_filter(self, entities: Dict[str, List[Dict]]) -> Dict[str, List[Dict]]:
        keep_types = set(STRICT_DIAGNOSIS_TYPES)
        if self.config.keep_lab_indicators:
            keep_types.add("lab_indicator")
        out: Dict[str, List[Dict]] = {}
        for etype, elist in entities.items():
            if etype in keep_types:
                strong = [
                    e
                    for e in elist
                    if e.get("confidence", 0) >= self.config.confidence_threshold
                ]
                if strong:
                    out[etype] = strong
        return out

    # ------------------------------------------------------------- smart

    def _smart_filter(
        self, entities: Dict[str, List[Dict]], text: str
    ) -> Dict[str, List[Dict]]:
        out: Dict[str, List[Dict]] = {}
        for etype, elist in entities.items():
            if etype == "drug":
                kept = self._filter_drugs(elist, text)
                if kept:
                    out["drug_related_disease"] = kept
            elif etype in ("treatment", "procedure"):
                kept = self._filter_treatments(elist, text)
                if kept:
                    out[f"{etype}_related_disease"] = kept
            elif etype in ("equipment", "inspect_equipment"):
                kept = [e for e in elist if has_disease_characteristics(e["text"])]
                if kept:
                    out[f"{etype}_related"] = kept
            elif etype == "department":
                continue
            elif etype == "lab_indicator":
                if self.config.keep_lab_indicators:
                    threshold = min(0.5, self.config.confidence_threshold)
                    kept = [e for e in elist if e.get("confidence", 0) >= threshold]
                    if kept:
                        out[etype] = kept
            else:
                kept = [
                    e
                    for e in elist
                    if e.get("confidence", 0) >= self.config.confidence_threshold
                ]
                if kept:
                    out[etype] = kept
        return out

    def _filter_drugs(self, elist: List[Dict], text: str) -> List[Dict]:
        if not self.config.keep_drug_diseases:
            return []
        kept = []
        for e in elist:
            etext = e["text"]
            if any(p.match(etext) for p in DRUG_NAME_PATTERNS):
                continue
            if self.config.enable_context_analysis:
                if self._has_diagnosis_context(e, text):
                    kept.append(e)
            elif has_disease_characteristics(etext):
                kept.append(e)
        return kept

    def _filter_treatments(self, elist: List[Dict], text: str) -> List[Dict]:
        kept = []
        for e in elist:
            etext = e["text"]
            if has_disease_characteristics(etext):
                kept.append(e)
                continue
            if any(p.match(etext) for p in TREATMENT_PATTERNS):
                continue
            if self.config.enable_context_analysis and self._has_diagnosis_context(
                e, text
            ):
                kept.append(e)
        return kept

    def _has_diagnosis_context(self, entity: Dict, text: str) -> bool:
        start = entity.get("start", 0)
        end = entity.get("end", start + len(entity["text"]))
        lo = max(0, start - self.config.context_window)
        hi = min(len(text), end + self.config.context_window)
        context = text[lo:hi]
        return any(kw in context for kw in DIAGNOSIS_CONTEXT_KEYWORDS)


def has_disease_characteristics(entity_text: str) -> bool:
    return any(suffix in entity_text for suffix in DISEASE_SUFFIXES)
