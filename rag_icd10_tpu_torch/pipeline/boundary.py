"""Semantic boundary detection — splits clinical text into diagnosis spans.

Behavioral spec (reference: services/semantic_boundary_service.py):
- Delimiter priority (:30-37): ；; (1) → 。. (2) → ，, (3) → \\n (4) → +＋ (5)
  → space/tab (6). The FIRST delimiter (in priority order) present in the
  text that yields >1 segment wins.
- Connection patterns (:39-46) suppress splits: a segment matching
  伴有并发/合并, 继发/导致/引起, 急性|慢性加重, 病史/既往史, 术后/治疗后 is
  merged back into the previous segment.
- Documented divergence: NO delimiter splits inside a （）/()/[] pair,
  and ``+`` after an ASCII alphanumeric never splits (immunophenotype
  markers: CD30+T细胞淋巴瘤). The reference's simple-split comment
  declares the paren intent (enhanced_text_processor.py:97
  "排除括号内的逗号") but its pattern only covers full-width （） commas
  — and this boundary service has no exclusion at all — while 3,902 of
  the 40,474 corpus titles contain a delimiter: qualifier commas
  (肺结核,经组织学所证实), paren code annotations ((G30.0+), (J99.0*)),
  bracketed aliases ([Di George综合征]), immunophenotypes. Splitting
  those breaks queries the store could otherwise serve verbatim.
- "Semantic clustering" sets n_clusters = len(segments) — a deliberate
  no-op merge (:174-224). We keep identity grouping (and batch-encode the
  segments only where confidence needs them).
- Boundary confidence (:263-301): base 0.5 + length bonuses (>=4: +0.1,
  >=8: +0.1) + disease-term completeness (+0.2) + independence (+0.1) +
  semantic-distance bonus (+0.1 when inter-segment cosine < 0.75), cap 1.0.

TPU difference: per-segment encodes are ONE batched encoder call rather
than a Python loop of single forwards (:186-189 does one forward per
segment, plus 2 per confidence pair).
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..utils.device import reraise_device_error

DELIMITER_PRIORITY: Tuple[Tuple[str, int], ...] = (
    ("；", 1), (";", 1),
    ("。", 2), (".", 2),
    ("，", 3), (",", 3),
    ("\n", 4),
    ("+", 5), ("＋", 5),
    (" ", 6), ("\t", 6),
)

CONNECTION_PATTERNS = tuple(
    re.compile(p)
    for p in (
        r"伴?有?(?:并发|合并)",
        r"(?:继发|导致|引起)",
        r"(?:急性|慢性)加重",
        r"(?:病史|既往史)",
        r"(?:术后|治疗后)",
    )
)

DISEASE_TERM_RE = re.compile(r"[^，。；\s]{2,}(?:病|症|炎|癌|瘤)")
DEPENDENT_RE = re.compile(r"(?:伴有|合并|继发)")

# ICD qualifier-clause cues: how the 3,838 comma-holding corpus titles'
# tail segments begin or end (measured over the full corpus — location/
# activity 在…中的人员, 不可归类在他处者, 意图未确定, 伴有/不伴有…,
# 未特指, 经…证实, 由于…所致, 除外…, 累及…). Only applied when the
# segment has no disease term of its own (_merge_connection_cases).
# Single-word PREFIXES that also open ordinary symptom clauses (经常头晕,
# 目前咳嗽, 于今晨加重) are deliberately absent: a real qualifier tail
# starting 经/在/于/目前 ends with one of the suffix anchors (证实/所致/
# 者/区域/人员/中) and matches through those — the bare prefixes would
# swallow genuine second segments ("高血压，经常头晕" must keep
# splitting; the full-corpus title invariant pins the other direction).
QUALIFIER_TAIL_RE = re.compile(
    r"^\s*(?:不可归类|意图|(?:并|也|但)?(?:伴有|不伴)|未特指|未做|"
    r"未?累及|除外|仅经|由于|弥漫|作为)"
    r"|(?:所致|证实|者|区域|人员|中)\s*$"
)

SEMANTIC_THRESHOLD = 0.75
MIN_SEGMENT_LENGTH = 2

_PAREN_OPEN = "（(["
_PAREN_CLOSE = "）)]"
_PLUSES = "+＋"


def _split_outside_parens(text: str, delimiter: str) -> List[str]:
    """Like text.split(delimiter) but two split suppressions (module
    docstring "Documented divergence"):
    - a delimiter inside a （）/()/[] pair never splits — corpus titles
      carry comma/dot/plus inside paren code annotations ((G30.0+),
      (J99.0*)) and bracketed aliases ([Di George综合征]);
    - ``+`` preceded by an ASCII alphanumeric never splits — it is an
      immunophenotype marker (CD30+T细胞淋巴瘤, ALK+大B细胞淋巴瘤), not
      a diagnosis join (joins follow CJK: 高血压+糖尿病 still splits)."""
    parts: List[str] = []
    cur: List[str] = []
    depth = 0
    prev = ""
    for i, ch in enumerate(text):
        if ch in _PAREN_OPEN:
            # an opener with NO closer anywhere after it is inert (typo'd
            # bracket): depth would otherwise never return to 0 and every
            # later delimiter stops splitting — while the regex splitters
            # (enhanced._NOT_IN_BRACKETS, textproc.SEPARATOR_RE) DO split
            # the same text, and the two paths must agree
            if any(c in text[i + 1:] for c in _PAREN_CLOSE):
                depth += 1
        elif ch in _PAREN_CLOSE:
            depth = max(0, depth - 1)
        split_here = ch == delimiter and depth == 0
        if (
            split_here
            and delimiter in _PLUSES
            and prev.isascii()
            and prev.isalnum()
        ):
            split_here = False
        if split_here:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
        prev = ch
    parts.append("".join(cur))
    return parts


class SemanticBoundaryDetector:
    """Priority-delimiter segmentation with connection-aware merging."""

    def __init__(self, encoder=None, keep_short=None):
        self.encoder = encoder  # duck-typed: needs encode_queries/encode_query
        self.semantic_threshold = SEMANTIC_THRESHOLD
        self.min_segment_length = MIN_SEGMENT_LENGTH
        # optional predicate exempting a segment from the min-length
        # filter (enhanced.py passes its known-title check so 1-char
        # corpus titles survive as compound members)
        self.keep_short = keep_short

    # ----------------------------------------------------------- detection

    def detect_diagnosis_boundaries(self, text: str) -> List[Tuple[int, int, str]]:
        """Returns [(start, end, diagnosis_text)]."""
        if not text or not text.strip():
            return []
        segments = self._initial_segmentation(text)
        if len(segments) <= 1:
            return [(0, len(text), text.strip())]
        # semantic clustering is identity grouping (see module docstring)
        boundaries = [(s["start"], s["end"], s["text"]) for s in segments]
        return boundaries or [(0, len(text), text.strip())]

    def _initial_segmentation(self, text: str) -> List[Dict[str, Any]]:
        segments: List[Dict[str, Any]] = []
        for delimiter, priority in sorted(DELIMITER_PRIORITY, key=lambda x: x[1]):
            if delimiter not in text:
                continue
            parts = _split_outside_parens(text, delimiter)
            if len(parts) <= 1:
                continue
            candidate: List[Dict[str, Any]] = []
            pos = 0
            for part in parts:
                part = part.strip()
                if part and (
                    len(part) >= self.min_segment_length
                    or (self.keep_short is not None and self.keep_short(part))
                ):
                    start = text.find(part, pos)
                    end = start + len(part)
                    candidate.append(
                        {
                            "text": part,
                            "start": start,
                            "end": end,
                            "delimiter": delimiter,
                            "priority": priority,
                        }
                    )
                    pos = end
            if len(candidate) > 1:
                segments = candidate
                break
        if not segments:
            segments = [
                {
                    "text": text.strip(),
                    "start": 0,
                    "end": len(text),
                    "delimiter": None,
                    "priority": 0,
                }
            ]
        return self._merge_connection_cases(segments, text)

    @staticmethod
    def _merge_connection_cases(
        segments: List[Dict], text: str = ""
    ) -> List[Dict]:
        """Segments with connection markers merge into the previous one.

        Two documented divergences from the reference (:139-170):
        - merged text is the ORIGINAL slice text[prev.start:seg.end]
          (delimiter preserved), not a space-join — the reference's
          'A病 伴B' output can never exact-match a corpus title again,
          while 3,838 corpus titles legitimately contain a comma.
        - qualifier tails merge too: a segment with NO disease term that
          reads as an ICD qualifier clause (在.../不可归类.../意图.../
          伴有|不伴.../未特指.../经...证实/由于...所致 and kin) belongs to
          the preceding diagnosis ('肺结核,经组织学所证实' is ONE code).
          Segments containing their own disease term never merge this
          way, so genuine multi-diagnosis commas keep splitting."""
        merged: List[Dict] = []
        for seg in segments:
            connected = any(p.search(seg["text"]) for p in CONNECTION_PATTERNS)
            if not connected and merged:
                connected = bool(
                    QUALIFIER_TAIL_RE.search(seg["text"])
                    and not DISEASE_TERM_RE.search(seg["text"])
                )
            if connected and merged:
                prev = merged[-1]
                joined = (
                    text[prev["start"] : seg["end"]].strip()
                    if text
                    else prev["text"] + " " + seg["text"]
                )
                merged[-1] = {
                    "text": joined,
                    "start": prev["start"],
                    "end": seg["end"],
                    "delimiter": seg["delimiter"],
                    "priority": min(prev["priority"], seg["priority"]),
                }
            else:
                merged.append(seg)
        return merged

    # ---------------------------------------------------------- confidence

    def get_boundary_confidence(
        self,
        boundaries: List[Tuple[int, int, str]],
        embeddings: Optional[np.ndarray] = None,
    ) -> List[float]:
        """``embeddings`` may carry precomputed segment embeddings (one
        row per boundary) so callers can batch the encode across many
        texts (see EnhancedTextProcessor.extract_many)."""
        texts = [b[2] for b in boundaries]
        sims: Optional[np.ndarray] = None
        if embeddings is not None and len(texts) > 1:
            embs = np.asarray(embeddings)
            sims = np.sum(embs[:-1] * embs[1:], axis=1)
        elif self.encoder is not None and len(texts) > 1:
            try:
                embs = np.asarray(self.encoder.encode_queries(texts))
                sims = np.sum(embs[:-1] * embs[1:], axis=1)  # consecutive cos
            except Exception as e:
                reraise_device_error(e)  # a failing card never degrades
                sims = None
        confidences = []
        for i, text in enumerate(texts):
            conf = 0.5
            if len(text) >= 4:
                conf += 0.1
            if len(text) >= 8:
                conf += 0.1
            if DISEASE_TERM_RE.search(text):
                conf += 0.2
            if not DEPENDENT_RE.search(text):
                conf += 0.1
            if sims is not None and i < len(texts) - 1:
                if float(sims[i]) < self.semantic_threshold:
                    conf += 0.1
            confidences.append(min(conf, 1.0))
        return confidences

    def analyze_text_structure(self, text: str) -> Dict[str, Any]:
        boundaries = self.detect_diagnosis_boundaries(text)
        confidences = self.get_boundary_confidence(boundaries)
        return {
            "original_text": text,
            "total_boundaries": len(boundaries),
            "boundaries": [
                {
                    "text": b[2],
                    "start": b[0],
                    "end": b[1],
                    "confidence": c,
                    "length": len(b[2]),
                }
                for b, c in zip(boundaries, confidences)
            ],
            "avg_confidence": float(np.mean(confidences)) if confidences else 0.0,
            "is_multi_diagnosis": len(boundaries) > 1,
        }
