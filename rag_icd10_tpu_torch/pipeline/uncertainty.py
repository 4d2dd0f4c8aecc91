"""Uncertainty-aware diagnosis handling.

Behavioral spec (reference: services/uncertainty_diagnosis_service.py):

- Three tiers of uncertainty markers with weights (:20-41):
    explicit  1.0: 待查 待诊 待确诊 待定 排除 ？ ?
    suspected 0.9: 疑似 疑为 考虑 可能 拟诊 倾向
    degree    0.8: 不除外 不能排除 不明原因 原因不明 性质待定
  Detection keeps the MAX weight across all matches; matched markers are
  stripped to produce a clean query (:112-122).
- Candidates whose titles look "unspecified" get a boost (:44-72,:127-188),
  first-match-wins in priority order:
    exact patterns  未特指的X / X，未特指 / X未特指        +0.30
    contains        未特指                                  +0.25
    other           其他X / X，其他 / 不明X / X不明          +0.20
    code structure  code matches \\.9\\d*$                  +0.15
- Applied boost = boost * uncertainty_weight, added to the score, then the
  candidate list is re-sorted (:190-238).

This implementation is stringly host-side but vectorized over the top-k
slice (a numpy boost vector), since it only ever runs on k<=128 candidates.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import numpy as np

UNCERTAINTY_TIERS: Tuple[Tuple[str, float, Tuple[str, ...]], ...] = (
    ("explicit_uncertainty", 1.0, ("待查", "待诊", "待确诊", "待定", "排除", "？", "?")),
    ("suspected", 0.9, ("疑似", "疑为", "考虑", "可能", "拟诊", "倾向")),
    ("degree_uncertainty", 0.8, ("不除外", "不能排除", "不明原因", "原因不明", "性质待定")),
)

EXACT_UNSPECIFIED_TEMPLATES = ("未特指的{}", "{}，未特指", "{}未特指")
OTHER_UNCERTAINTY_TEMPLATES = ("其他{}", "{}，其他", "不明{}", "{}不明")
UNSPECIFIED_SUBSTRING = "未特指"
CODE_UNSPECIFIED_RE = re.compile(r"\.9\d*$")

BOOST_EXACT = 0.30
BOOST_CONTAINS = 0.25
BOOST_OTHER = 0.20
BOOST_CODE = 0.15


@dataclass
class UncertaintyInfo:
    has_uncertainty: bool = False
    uncertainty_type: str = ""
    uncertainty_weight: float = 0.0
    matched_patterns: List[str] = field(default_factory=list)
    clean_text: str = ""

    def to_dict(self) -> Dict:
        return {
            "has_uncertainty": self.has_uncertainty,
            "uncertainty_type": self.uncertainty_type,
            "uncertainty_weight": self.uncertainty_weight,
            "matched_patterns": self.matched_patterns,
            "clean_text": self.clean_text,
        }


def detect_uncertainty(text: str) -> UncertaintyInfo:
    """Find uncertainty markers; keep max tier weight; strip markers."""
    info = UncertaintyInfo(clean_text=text)
    lower = text.lower()
    for tier_name, weight, patterns in UNCERTAINTY_TIERS:
        for pat in patterns:
            if pat.lower() in lower:
                info.has_uncertainty = True
                if weight > info.uncertainty_weight:
                    info.uncertainty_weight = weight
                    info.uncertainty_type = tier_name
                info.matched_patterns.append(pat)
    if info.has_uncertainty:
        clean = text
        for pat in info.matched_patterns:
            clean = re.sub(re.escape(pat), "", clean, flags=re.IGNORECASE)
        clean = re.sub(r"\s+", " ", clean).strip()
        clean = re.sub(r"^[，。、\s]+|[，。、\s]+$", "", clean)
        info.clean_text = clean
    return info


# Marker sets arranged by the position they occupy in real queries
# (疑似X, 排除X vs X待查, X可能) — used ONLY for the encoding-side strip
# below; boost/tier detection keeps the reference's substring semantics.
# 不排除 listed before 排除 so it peels atomically (the reference's
# substring match turns 不排除X into clean "不X" — harmless there, where
# clean text only drives boosts, but fatal for a query ENCODER).
_PREFIX_MARKERS: Tuple[str, ...] = (
    "不能排除", "不排除", "不除外", "排除", "疑似", "疑为", "考虑", "拟诊",
    "不明原因",
)
_SUFFIX_MARKERS: Tuple[str, ...] = (
    "性质待定", "待确诊", "原因不明", "待查", "待诊", "待定", "可能",
    "倾向", "？", "?",
)


def clean_for_encoding(text: str, known_titles=None) -> str:
    """Uncertainty strip for the RETRIEVAL ENCODER (documented divergence:
    the reference embeds the raw fragment; we encode the stripped text —
    orchestrator.device_stage).

    detect_uncertainty's reference-exact substring strip mutilates the
    115 corpus titles that intrinsically CONTAIN marker words
    (原因不明的小肾, 原发性血栓形成倾向, 经表皮排除疾患…): a verbatim
    query for such a title would encode a mutilated phrase and the
    exact-row injection would miss. This strip instead peels markers only
    as AFFIXES, longest-first, checking the known-title set at every
    step: a text that IS a corpus title is returned untouched, and
    疑似{title}待查 peels down to exactly {title}. Falls back to the
    reference-style strip only for mid-text markers on non-titles.
    """
    raw = text.strip()
    if known_titles is not None:
        hit = _peel_to_title(raw, known_titles, depth=4)
        if hit is not None:
            return hit
    t = raw
    while t:
        for p in _PREFIX_MARKERS:
            if t.startswith(p) and len(t) > len(p):
                t = t[len(p):].strip()
                break
        else:
            for s in _SUFFIX_MARKERS:
                if t.endswith(s) and len(t) > len(s):
                    t = t[: -len(s)].strip()
                    break
            else:
                break
    t = re.sub(r"^[，。、\s]+|[，。、\s]+$", "", t)
    if t and t != raw:
        return t
    info = detect_uncertainty(raw)
    return info.clean_text if info.has_uncertainty and info.clean_text else raw


def _peel_to_title(t: str, known_titles, depth: int):
    """Smallest peel sequence reaching a known title, or None. A search,
    not greedy: 不明原因抽搐待查 must peel the 待查 SUFFIX first — greedy
    prefix peeling would destroy the title 不明原因抽搐 (whose first four
    chars are themselves a marker)."""
    if t in known_titles:
        return t
    if depth <= 0 or not t:
        return None
    for p in _PREFIX_MARKERS:
        if t.startswith(p) and len(t) > len(p):
            hit = _peel_to_title(t[len(p):].strip(), known_titles, depth - 1)
            if hit is not None:
                return hit
    for s in _SUFFIX_MARKERS:
        if t.endswith(s) and len(t) > len(s):
            hit = _peel_to_title(t[: -len(s)].strip(), known_titles, depth - 1)
            if hit is not None:
                return hit
    return None


def unspecified_boost(title: str, code: str, clean_query: str) -> float:
    """Priority-ordered 'unspecified' boost for one candidate."""
    title_l = title.lower()
    q = clean_query.lower()
    for tmpl in EXACT_UNSPECIFIED_TEMPLATES:
        if q and tmpl.format(q) in title_l:
            return BOOST_EXACT
    if UNSPECIFIED_SUBSTRING in title_l:
        return BOOST_CONTAINS
    for tmpl in OTHER_UNCERTAINTY_TEMPLATES:
        if q and tmpl.format(q) in title_l:
            return BOOST_OTHER
    if CODE_UNSPECIFIED_RE.search(code or ""):
        return BOOST_CODE
    return 0.0


def unspecified_boost_vector(
    titles: Sequence[str], codes: Sequence[str], clean_query: str
) -> np.ndarray:
    """Vectorized boosts over the top-k candidate slice."""
    return np.array(
        [unspecified_boost(t, c, clean_query) for t, c in zip(titles, codes)],
        dtype=np.float32,
    )


def process_uncertainty_query(
    query_text: str, candidates: List[Dict]
) -> Tuple[str, List[Dict]]:
    """Clean the query and apply weighted unspecified boosts + re-sort.

    ``candidates`` are dicts with at least code/preferred_zh/score; boosted
    entries gain uncertainty_boost/uncertainty_weight/original_score keys
    (reference: uncertainty_diagnosis_service.py:190-238).
    """
    info = detect_uncertainty(query_text)
    if not info.has_uncertainty:
        return query_text, candidates
    out = []
    for rec in candidates:
        rec = dict(rec)
        boost = unspecified_boost(
            rec.get("preferred_zh", ""), rec.get("code", ""), info.clean_text
        )
        if boost > 0:
            original = float(rec.get("score", 0.0))
            rec["original_score"] = original
            rec["uncertainty_boost"] = boost
            rec["uncertainty_weight"] = info.uncertainty_weight
            rec["score"] = original + boost * info.uncertainty_weight
        out.append(rec)
    out.sort(key=lambda r: r.get("score", 0.0), reverse=True)
    return info.clean_text, out
