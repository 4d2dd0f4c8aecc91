"""Enhanced diagnosis extraction — fuses NER entities with boundary spans.

Behavioral spec (reference: services/enhanced_text_processor.py):
- config (:31-37): min len 2, max len 50, min entity conf 0.6,
  use_semantic_boundary, fallback to simple split
- pipeline (:39-88): NER -> boundary detection (or simple split fallback)
  -> fuse -> filter/rank
- simple split fallback (:90-146): separators ；; then ，,
  (excluding commas inside full-width parens) then +＋; then medical-keyword
  split (既往 病史 术后 治疗 保守 规律 控制)
- sub-split (:206-260): boundary spans holding >1 disease entity split at
  disease-entity starts (with up to 10 chars of leading context).
  Documented divergence: the reference splits UNCONDITIONALLY between
  entities, but its greedy NER pattern chops a single long title at every
  internal 病/症/瘤/综合征 suffix, so one-diagnosis inputs like
  "...淋巴瘤[恶性免疫增生性疾病]" get mangled into two fragments that
  can never match the full corpus title (measured: the #1 remaining
  paraphrase-tier failure mode). We split only when the text BETWEEN two
  consecutive disease entities contains a real separator — whitespace,
  list punctuation, or a clinical connective (伴/并/及/合并/继发/和/与/
  术后) — and merge contiguous entities into one diagnosis otherwise.
  Genuine multi-diagnosis inputs ("A病伴B", "A病，B症", "A病 B症") still
  split exactly as the reference does.
- per-diagnosis confidence (:280-318): 0.3 + boundary_conf*0.3 +
  weighted-entity-avg*0.4 (disease x1.2, symptom x0.8, other x0.6) +
  length bonus (4<=len<=20: +0.1, len<2: -0.2) + density bonus (+0.1 when
  entities/char > 0.1), cap 1.0
- filter >=0.4 conf, char-Jaccard dedup at >0.8 keeping higher conf,
  sort desc (:320-365, :370-379)
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..utils.device import reraise_device_error
from .boundary import SemanticBoundaryDetector
from .ner import MedicalNERService

# separators never fire inside a （）/()/[] pair, and + never fires after
# an ASCII alphanumeric (immunophenotypes) — the reference's :97 pattern
# only excludes full-width-（） commas; see boundary.py "Documented
# divergence" for the corpus evidence
_NOT_IN_BRACKETS = r"(?![^（([]*[）)\]])"
SIMPLE_SEPARATORS = (
    r"[；;]" + _NOT_IN_BRACKETS,
    r"[，,]" + _NOT_IN_BRACKETS,
    r"(?<![A-Za-z0-9])[+＋]" + _NOT_IN_BRACKETS,
)
MEDICAL_SPLIT_KEYWORDS = ("既往", "病史", "术后", "治疗", "保守", "规律", "控制")


def char_jaccard(text1: str, text2: str) -> float:
    if not text1 or not text2:
        return 0.0
    s1, s2 = set(text1), set(text2)
    union = len(s1 | s2)
    return len(s1 & s2) / union if union else 0.0


class EnhancedTextProcessor:
    """NER + boundary fusion -> ranked diagnosis spans with confidence."""

    def __init__(
        self,
        encoder=None,
        ner_service: Optional[MedicalNERService] = None,
        use_model_ner: Optional[bool] = None,
        known_titles: Optional[frozenset] = None,
    ):
        if ner_service is not None:
            self.ner_service = ner_service
        else:
            from ..config import NERConfig
            import dataclasses

            cfg = NERConfig()
            if use_model_ner is not None:
                cfg = dataclasses.replace(cfg, use_model=use_model_ner)
            self.ner_service = MedicalNERService(cfg)
        self.encoder = encoder
        self.boundary_detector = SemanticBoundaryDetector(
            encoder, keep_short=self._is_known_title
        )
        self.known_titles = known_titles
        self.config = {
            "min_diagnosis_length": 2,
            "max_diagnosis_length": 50,
            "min_entity_confidence": 0.6,
            "use_semantic_boundary": True,
            "fallback_to_simple_split": True,
        }

    def set_known_titles(self, titles) -> None:
        """Arm the exact-title bypass (see _is_known_title)."""
        self.known_titles = frozenset(t.strip() for t in titles)

    def _is_known_title(self, text: str) -> bool:
        """Exact-title bypass: 3,838 of the 40,474 corpus titles contain a
        comma (qualifier clauses like 肺结核,经组织学所证实), which the
        delimiter splitter would mangle into unmatchable fragments. A
        query that IS verbatim a known corpus title is that diagnosis by
        definition — never split it. The corpus-blind reference cannot do
        this (its extractor never sees the store)."""
        return self.known_titles is not None and text.strip() in self.known_titles

    def _is_known_title_span(self, text: str) -> bool:
        """Marker-aware bypass: an uncertainty-wrapped known title
        (疑似肺结核,经组织学所证实 / ...待查) is that diagnosis with a
        marker — the splitter must not chop the title's own separators.
        Raw verbatim match wins first (a title that happens to contain a
        marker word is matched as itself before any stripping)."""
        if self.known_titles is None:
            return False
        if text.strip() in self.known_titles:
            return True
        from .uncertainty import clean_for_encoding

        return (
            clean_for_encoding(text, known_titles=self.known_titles).strip()
            in self.known_titles
        )

    # ------------------------------------------------------------- public

    def extract_diagnoses_enhanced(
        self, text: str, filter_drugs: bool = True
    ) -> List[Dict[str, Any]]:
        if not text or not text.strip():
            return []
        try:
            entities = self.ner_service.extract_medical_entities(
                text, filter_drugs=filter_drugs
            )
            exact = self._is_known_title_span(text)
            if exact:
                boundaries = [(0, len(text), text.strip())]
                confs = [1.0]
            elif self.config["use_semantic_boundary"] and self.encoder is not None:
                boundaries = self.boundary_detector.detect_diagnosis_boundaries(text)
                confs = self.boundary_detector.get_boundary_confidence(boundaries)
            else:
                boundaries = self._simple_boundary_detection(text)
                confs = [0.5] * len(boundaries)
            fused = self._fuse(
                text, entities, boundaries, confs, allow_subsplit=not exact
            )
            return self._filter_and_rank(fused)
        except Exception as e:
            reraise_device_error(e)  # a failing card never degrades
            return self._fallback_extraction(text)

    def extract_many(
        self, texts: List[str], filter_drugs: bool = True
    ) -> List[List[Dict[str, Any]]]:
        """Batched extraction: the boundary-confidence embeddings for ALL
        texts are computed in ONE encoder call instead of one device
        round-trip per text (the serving hot path; a 32-request batch
        otherwise pays 32 dispatch latencies)."""
        if not texts:
            return []
        prepared = []
        all_segments: List[str] = []
        for text in texts:
            if not text or not text.strip():
                prepared.append(None)
                continue
            try:
                entities = self.ner_service.extract_medical_entities(
                    text, filter_drugs=filter_drugs
                )
                exact = self._is_known_title_span(text)
                if exact:
                    boundaries = [(0, len(text), text.strip())]
                elif self.config["use_semantic_boundary"] and self.encoder is not None:
                    boundaries = self.boundary_detector.detect_diagnosis_boundaries(
                        text
                    )
                else:
                    boundaries = self._simple_boundary_detection(text)
                offset = len(all_segments)
                if len(boundaries) > 1:
                    all_segments.extend(b[2] for b in boundaries)
                prepared.append((text, entities, boundaries, offset, exact))
            except Exception as e:
                reraise_device_error(e)  # a failing card never degrades
                prepared.append(("__fallback__", text))
        embs = None
        if all_segments and self.encoder is not None:
            try:
                embs = np.asarray(self.encoder.encode_queries(all_segments))
            except Exception as e:
                reraise_device_error(e)  # a failing card never degrades
                embs = None
        results: List[List[Dict[str, Any]]] = []
        for item in prepared:
            if item is None:
                results.append([])
                continue
            if item[0] == "__fallback__":
                results.append(self._fallback_extraction(item[1]))
                continue
            text, entities, boundaries, offset, exact = item
            if exact:
                confs = [1.0]
            elif len(boundaries) > 1 and embs is not None:
                seg_embs = embs[offset : offset + len(boundaries)]
                confs = self.boundary_detector.get_boundary_confidence(
                    boundaries, embeddings=seg_embs
                )
            elif self.config["use_semantic_boundary"] and self.encoder is not None:
                confs = self.boundary_detector.get_boundary_confidence(boundaries)
            else:
                confs = [0.5] * len(boundaries)
            try:
                fused = self._fuse(
                    text, entities, boundaries, confs, allow_subsplit=not exact
                )
                results.append(self._filter_and_rank(fused))
            except Exception as e:
                reraise_device_error(e)  # a failing card never degrades
                results.append(self._fallback_extraction(text))
        return results

    def extract_diagnoses_simple(self, text: str) -> List[str]:
        return [r["text"] for r in self.extract_diagnoses_enhanced(text)]

    def get_processing_summary(self, text: str) -> Dict[str, Any]:
        results = self.extract_diagnoses_enhanced(text)
        entity_types: set = set()
        high = 0
        for r in results:
            entity_types.update(r["primary_entity_types"])
            if r["diagnosis_confidence"] > 0.7:
                high += 1
        return {
            "original_text": text,
            "total_diagnoses": len(results),
            "avg_confidence": (
                sum(r["diagnosis_confidence"] for r in results) / len(results)
                if results
                else 0
            ),
            "entity_types_found": list(entity_types),
            "high_confidence_count": high,
            "processing_method": (
                "enhanced"
                if self.config["use_semantic_boundary"] and self.encoder is not None
                else "simple"
            ),
            "ner_info": self.ner_service.get_model_info(),
        }

    # --------------------------------------------------------- simple split

    def _simple_boundary_detection(self, text: str) -> List[Tuple[int, int, str]]:
        min_len = self.config["min_diagnosis_length"]
        for sep in SIMPLE_SEPARATORS:
            parts = re.split(sep, text)
            if len(parts) > 1:
                boundaries = []
                pos = 0
                for part in parts:
                    part = part.strip()
                    # a known 1-char title (痔/疣/痈/疖/痣/僵/N) is a valid
                    # member of a compound; dropping it used to collapse
                    # the whole split (岩骨脑膜瘤；N stayed one fragment)
                    if part and (
                        len(part) >= min_len or self._is_known_title(part)
                    ):
                        start = text.find(part, pos)
                        if start != -1:
                            boundaries.append((start, start + len(part), part))
                            pos = start + len(part)
                if len(boundaries) > 1:
                    return boundaries
        for keyword in MEDICAL_SPLIT_KEYWORDS:
            if keyword in text:
                parts = text.split(keyword)
                if len(parts) > 1:
                    boundaries = []
                    pos = 0
                    for i, part in enumerate(parts):
                        segment = part.strip() if i == 0 else (keyword + part).strip()
                        if segment and len(segment) >= min_len:
                            start = text.find(segment, pos)
                            if start != -1:
                                boundaries.append(
                                    (start, start + len(segment), segment)
                                )
                                pos = start + len(segment)
                    if len(boundaries) > 1:
                        return boundaries
        return [(0, len(text), text.strip())]

    # --------------------------------------------------------------- fusion

    def _fuse(
        self,
        text: str,
        entities: Dict[str, List[Dict]],
        boundaries: List[Tuple[int, int, str]],
        confs: List[float],
        allow_subsplit: bool = True,
    ) -> List[Dict[str, Any]]:
        out: List[Dict[str, Any]] = []
        for i, (start, end, btext) in enumerate(boundaries):
            bconf = confs[i] if i < len(confs) else 0.5
            # a boundary span that IS a known title (with or without an
            # uncertainty marker) is one diagnosis by fiat — the entity
            # sub-splitter would chop connective-bearing titles like
            # 高血压心脏和肾脏病伴有(充血性)心力衰竭 inside compounds
            subs = (
                self._sub_diagnoses(btext, entities, start, end)
                if allow_subsplit and not self._is_known_title_span(btext)
                else [
                    {
                        "text": btext,
                        "start": start,
                        "end": end,
                        "entities": self._entities_in(entities, start, end),
                    }
                ]
            )
            for sub in subs:
                info: Dict[str, Any] = {
                    "text": sub["text"].strip(),
                    "start_pos": sub["start"],
                    "end_pos": sub["end"],
                    "boundary_confidence": bconf,
                    "entities": sub["entities"],
                    "entity_density": 0.0,
                    "primary_entity_types": [],
                    "diagnosis_confidence": 0.0,
                    "metadata": {
                        "length": len(sub["text"].strip()),
                        "has_disease_entity": False,
                        "has_symptom_entity": False,
                        "entity_count": 0,
                    },
                }
                total = sum(len(v) for v in sub["entities"].values())
                if total > 0 and sub["text"]:
                    info["entity_density"] = total / len(sub["text"])
                    info["metadata"]["entity_count"] = total
                    for etype, elist in sub["entities"].items():
                        if elist:
                            info["primary_entity_types"].append(etype)
                            if etype == "disease":
                                info["metadata"]["has_disease_entity"] = True
                            elif etype == "symptom":
                                info["metadata"]["has_symptom_entity"] = True
                info["metadata"]["exact_title"] = self._is_known_title_span(info["text"])
                info["diagnosis_confidence"] = self._diagnosis_confidence(info)
                out.append(info)
        return out

    def _sub_diagnoses(
        self,
        boundary_text: str,
        entities: Dict[str, List[Dict]],
        b_start: int,
        b_end: int,
    ) -> List[Dict]:
        diseases = [
            e
            for e in entities.get("disease", [])
            if b_start <= e.get("start", 0) < b_end
        ]
        whole = [
            {
                "text": boundary_text,
                "start": b_start,
                "end": b_end,
                "entities": self._entities_in(entities, b_start, b_end),
            }
        ]
        if len(diseases) <= 1:
            return whole
        diseases.sort(key=lambda e: e.get("start", 0))
        # Group contiguous entities: split only across a real separator
        # (see module docstring "Documented divergence").
        groups: List[List[Dict]] = [[diseases[0]]]
        for prev, ent in zip(diseases, diseases[1:]):
            gap_lo = prev.get("end", b_start) - b_start
            gap_hi = ent.get("start", b_start) - b_start
            gap = boundary_text[max(gap_lo, 0) : max(gap_hi, 0)]
            if self._gap_is_separator(gap):
                groups.append([ent])
            else:
                groups[-1].append(ent)
        if len(groups) <= 1:
            return whole
        subs: List[Dict] = []
        prev_end = b_start
        for i, group in enumerate(groups):
            e_start = group[0].get("start", b_start)
            g_end = group[-1].get(
                "end", e_start + len(group[-1].get("text", ""))
            )
            seg_end = (
                min(groups[i + 1][0].get("start", b_end), b_end)
                if i < len(groups) - 1
                else b_end
            )
            seg_start = max(prev_end, e_start - 10)
            seg_text = boundary_text[seg_start - b_start : seg_end - b_start].strip()
            if seg_text and len(seg_text) >= 2:
                subs.append(
                    {
                        "text": seg_text,
                        "start": seg_start,
                        "end": seg_end,
                        "entities": self._entities_in(entities, seg_start, seg_end),
                    }
                )
            prev_end = g_end
        return subs or whole

    @staticmethod
    def _gap_is_separator(gap: str) -> bool:
        """True when the text between two disease entities marks a real
        diagnosis boundary: whitespace, list punctuation, or a clinical
        connective. An empty or plain-infix gap (e.g. the 性 in
        2型糖尿病性视网膜病) means the NER regex chopped one title."""
        if any(ch.isspace() for ch in gap):
            return True
        if any(p in gap for p in "，,、；;+＋。.："):
            return True
        return any(c in gap for c in ("伴", "并", "及", "继发", "和", "与", "术后"))

    @staticmethod
    def _entities_in(
        entities: Dict[str, List[Dict]], start: int, end: int
    ) -> Dict[str, List[Dict]]:
        out: Dict[str, List[Dict]] = {}
        for etype, elist in entities.items():
            out[etype] = [
                e
                for e in elist
                if (e.get("start", 0) >= start and e.get("end", 0) <= end)
                or (e.get("start", 0) < end and e.get("end", 0) > start)
            ]
        return out

    # ----------------------------------------------------------- confidence

    @staticmethod
    def _diagnosis_confidence(info: Dict[str, Any]) -> float:
        conf = 0.3 + info["boundary_confidence"] * 0.3
        scores = []
        for etype, elist in info["entities"].items():
            for e in elist:
                c = e.get("confidence", 0.5)
                if etype == "disease":
                    scores.append(c * 1.2)
                elif etype == "symptom":
                    scores.append(c * 0.8)
                else:
                    scores.append(c * 0.6)
        if scores:
            conf += (sum(scores) / len(scores)) * 0.4
        n = len(info["text"])
        if 4 <= n <= 20:
            conf += 0.1
        elif n < 2:
            conf -= 0.2
        if info["entity_density"] > 0.1:
            conf += 0.1
        if info["metadata"].get("exact_title"):
            # a verbatim corpus title is a diagnosis by fiat; without the
            # floor, single-char titles (痔/疣/痈/疖/痣/僵) land at ~0.4-ε
            # (short-length penalty, no recognizable entities) and the
            # >= 0.4 filter silently drops them — a verbatim query for a
            # real one-char ICD title returned zero diagnoses (the
            # reference shares the blind spot: its enhanced filter has no
            # title list to consult)
            conf = max(conf, 0.75)
        return min(conf, 1.0)

    # ------------------------------------------------------------ filtering

    def _filter_and_rank(self, diagnoses: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
        lo, hi = (
            self.config["min_diagnosis_length"],
            self.config["max_diagnosis_length"],
        )
        # exact corpus titles bypass the length window (42 titles are
        # longer than the 50-char cap; they are valid diagnoses by fiat)
        filtered = [
            d
            for d in diagnoses
            if d["metadata"].get("exact_title") or lo <= len(d["text"]) <= hi
        ]
        filtered = [d for d in filtered if d["diagnosis_confidence"] >= 0.4]
        deduped: List[Dict[str, Any]] = []
        for d in filtered:
            dup = False
            for existing in list(deduped):
                if (
                    d["metadata"].get("exact_title")
                    and existing["metadata"].get("exact_title")
                    and d["text"] != existing["text"]
                ):
                    # two DISTINCT corpus titles are never duplicates even
                    # at high char overlap (心功能III级 vs 心功能Ⅱ级 differ
                    # only by numeral yet are different diagnoses)
                    continue
                if char_jaccard(d["text"], existing["text"]) > 0.8:
                    if d["diagnosis_confidence"] > existing["diagnosis_confidence"]:
                        deduped.remove(existing)
                        deduped.append(d)
                    dup = True
                    break
            if not dup:
                deduped.append(d)
        return sorted(deduped, key=lambda x: x["diagnosis_confidence"], reverse=True)

    def _fallback_extraction(self, text: str) -> List[Dict[str, Any]]:
        return [
            {
                "text": btext.strip(),
                "start_pos": start,
                "end_pos": end,
                "boundary_confidence": 0.5,
                "entities": {},
                "entity_density": 0.0,
                "primary_entity_types": [],
                "diagnosis_confidence": 0.5,
                "metadata": {
                    "length": len(btext.strip()),
                    "has_disease_entity": False,
                    "has_symptom_entity": False,
                    "entity_count": 0,
                    "is_fallback": True,
                },
            }
            for start, end, btext in self._simple_boundary_detection(text)
        ]
