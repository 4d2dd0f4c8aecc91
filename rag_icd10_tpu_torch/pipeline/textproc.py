"""Diagnosis text splitting — simple mode + facade.

Behavioral spec (reference: tools/text_processor.py):
- split on [，,；;] | [+＋] | whitespace (:29-33,:111-122)
- strip only meaningless affixes: prefixes ？ ? 诊断为 患者, suffixes ？ ? 诊断
  — uncertainty markers 待查/疑似/考虑/排除 are PRESERVED (:124-148; the
  reference calls this out as a critical fix, CLAUDE.md:269-270)
- drop segments shorter than 2 chars; order-preserving dedup (:88-109)

The facade (`DiagnosisTextProcessor`) prefers the enhanced NER+boundary
pipeline (pipeline/enhanced.py) and falls back to simple mode, mirroring
USE_ENHANCED_TEXT_PROCESSING handling (:36-39) and the fallback ladder.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional

# separators never fire inside a （）/()/[] pair, and + never fires after
# an ASCII alphanumeric (immunophenotype markers) — the bracket/plus rules
# shared by every split path (boundary.py has the rationale); this regex
# is also the eval's "title is split-ambiguous" filter (eval/retrieval.py)
SEPARATOR_RE = re.compile(
    r"(?:[，,；;]|(?<![A-Za-z0-9])[+＋]|\s+)(?![^（([]*[）)\]])"
)
PREFIXES_TO_REMOVE = ("？", "?", "诊断为", "患者")
SUFFIXES_TO_REMOVE = ("？", "?", "诊断")


def clean_diagnosis_text(text: str) -> str:
    """Strip meaningless affixes, preserving uncertainty markers."""
    text = text.strip()
    for prefix in PREFIXES_TO_REMOVE:
        if text.startswith(prefix):
            text = text[len(prefix):].strip()
    for suffix in SUFFIXES_TO_REMOVE:
        if text.endswith(suffix):
            text = text[: -len(suffix)].strip()
    return text


def split_simple(text: str) -> List[str]:
    """Separator split + clean + len>=2 filter + ordered dedup."""
    if not text or not text.strip():
        return []
    segments = [s.strip() for s in SEPARATOR_RE.split(text) if s.strip()]
    cleaned = [clean_diagnosis_text(s) for s in segments]
    out, seen = [], set()
    for d in cleaned:
        if d and len(d) >= 2 and d not in seen:
            out.append(d)
            seen.add(d)
    return out


class DiagnosisTextProcessor:
    """Facade over enhanced/simple extraction (reference:
    tools/text_processor.py:20-199)."""

    def __init__(
        self,
        encoder=None,
        use_enhanced_processing: Optional[bool] = None,
        ner_service=None,
        known_titles=None,
    ):
        if use_enhanced_processing is None:
            import os

            use_enhanced_processing = (
                os.getenv("USE_ENHANCED_TEXT_PROCESSING", "true").lower() == "true"
            )
        self.use_enhanced_processing = use_enhanced_processing
        self.encoder = encoder
        self.known_titles = (
            frozenset(t.strip() for t in known_titles) if known_titles else None
        )
        self._enhanced = None
        if use_enhanced_processing:
            try:
                from .enhanced import EnhancedTextProcessor

                self._enhanced = EnhancedTextProcessor(
                    encoder=encoder,
                    ner_service=ner_service,
                    known_titles=self.known_titles,
                )
            except Exception:
                self.use_enhanced_processing = False

    def set_known_titles(self, titles) -> None:
        """Arm the exact-title split bypass on both extraction paths (the
        orchestrator calls this with the store's corpus titles; see
        enhanced.py _is_known_title for the rationale)."""
        self.known_titles = frozenset(t.strip() for t in titles)
        if self._enhanced is not None:
            self._enhanced.known_titles = self.known_titles

    def _is_known_title(self, text: str) -> bool:
        return self.known_titles is not None and text.strip() in self.known_titles

    def extract_diagnoses(self, text: str) -> List[str]:
        if not text or not text.strip():
            return []
        if self.use_enhanced_processing and self._enhanced is not None:
            try:
                return self._enhanced.extract_diagnoses_simple(text)
            except Exception:
                pass
        if self._is_known_title(text):
            return [text.strip()]
        return split_simple(text)

    def extract_diagnoses_enhanced(self, text: str) -> List[Dict]:
        """Dicts with diagnosis_text + diagnosis_confidence (reference:
        tools/text_processor.py:156-192)."""
        if not text or not text.strip():
            return []
        if self.use_enhanced_processing and self._enhanced is not None:
            try:
                return self._enhanced.extract_diagnoses_enhanced(text)
            except Exception:
                pass
        parts = (
            [text.strip()] if self._is_known_title(text) else split_simple(text)
        )
        return [
            {"diagnosis_text": d, "diagnosis_confidence": 0.8, "method": "simple"}
            for d in parts
        ]

    def extract_many_enhanced(self, texts: List[str]) -> List[List[Dict]]:
        """Batched extraction: one encoder call for all texts' boundary
        embeddings (serving hot path). Falls back to per-text extraction."""
        if self.use_enhanced_processing and self._enhanced is not None:
            try:
                return self._enhanced.extract_many(texts)
            except Exception:
                pass
        return [self.extract_diagnoses_enhanced(t) for t in texts]

    def is_multi_diagnosis(self, text: str) -> bool:
        return len(self.extract_diagnoses(text)) > 1

    def get_processing_mode(self) -> str:
        return (
            "enhanced"
            if self.use_enhanced_processing and self._enhanced is not None
            else "simple"
        )
