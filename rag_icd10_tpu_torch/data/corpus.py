"""ICD-10 corpus ingestion and hierarchy parsing.

Behavioral spec (must match the reference exactly so hierarchy-weighted
scores are reproducible):

- CSV columns ``code,disease`` (UTF-8, possibly BOM). A record is valid iff
  both fields are non-empty and not the literal string "nan"
  (reference: tools/build_database.py:75-84).
- Combo codes like ``A01.1+B02*``: split on '+', strip '*', the first part is
  ``main_code``, the second ``secondary_code``, ``has_complication=True``
  (reference: tools/build_database.py:86-97).
- Hierarchy levels (reference: tools/build_database.py:128-154):
    * no '.' in code                         -> level 1, no parent
    * one '.' and <=1 char after it          -> level 2, parent = chapter code
    * otherwise                              -> level 3; if the fractional part
      has >=3 chars the parent is the subcategory ``X.d`` (first digit), else
      the chapter code.
  ``category_path`` joins ancestor codes with " > ".
- ``semantic_text`` = "disease | <ancestor diseases...> | ICD-10: <code>",
  ancestor diseases resolved against previously-seen codes, deduped
  (reference: tools/build_database.py:156-171).
- Expected stats on the reference CSV: 40,474 valid records; level1=5,031,
  level2=12,106, level3=23,337; 1,000 combo codes (SURVEY.md §2.3).

Design difference vs the reference: the corpus is **columnar** (numpy arrays
for levels/weights, parallel lists for strings) so device-side tensors — the
level-weight vector fused into the Pallas search kernel — fall straight out,
instead of a list of per-record dicts.
"""

from __future__ import annotations

import csv
import io
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np


def parse_hierarchy(
    code: str, parent_info: Dict[str, str]
) -> Tuple[int, str, str]:
    """Return (level, parent_code, category_path) for an ICD-10 code.

    Mirrors reference tools/build_database.py:128-154 semantics.
    ``parent_info`` is unused for parsing but kept for signature parity with
    the database-build call site.
    """
    if "." not in code:
        return 1, "", code
    parts = code.split(".")
    if code.count(".") == 1 and len(parts[1]) <= 1:
        parent = parts[0]
        return 2, parent, f"{parent} > {code}"
    # level 3
    if len(parts[1]) >= 3:
        parent = f"{parts[0]}.{parts[1][0]}"
        return 3, parent, f"{parts[0]} > {parent} > {code}"
    parent = parts[0]
    return 3, parent, f"{parent} > {code}"


def build_semantic_text(
    code: str, disease: str, category_path: str, parent_info: Dict[str, str]
) -> str:
    """"disease | ancestor diseases | ICD-10: code" (reference
    tools/build_database.py:156-171)."""
    parts = [disease]
    for path_code in category_path.split(" > ")[:-1]:
        parent_disease = parent_info.get(path_code)
        if parent_disease and parent_disease not in parts:
            parts.append(parent_disease)
    parts.append(f"ICD-10: {code}")
    return " | ".join(parts)


def split_combo_code(code: str) -> Tuple[str, str, bool]:
    """Split ``A01.1+B02*`` style combo codes (reference
    tools/build_database.py:86-97)."""
    if "+" in code and "*" in code:
        parts = code.split("+")
        if len(parts) == 2:
            return parts[0].strip(), parts[1].replace("*", "").strip(), True
    return code, "", False


@dataclass
class ICDRecord:
    """One corpus row — the Milvus collection schema fields
    (reference: services/milvus_service.py:174-186)."""

    code: str
    preferred_zh: str
    main_code: str
    secondary_code: str
    has_complication: bool
    level: int
    parent_code: str
    category_path: str
    semantic_text: str


class ICDCorpus:
    """Columnar ICD-10 corpus with hierarchy metadata.

    Holds parallel columns; `records()` materializes row views on demand.
    """

    def __init__(self, records: Sequence[ICDRecord]):
        self.codes: List[str] = [r.code for r in records]
        self.titles: List[str] = [r.preferred_zh for r in records]
        self.main_codes: List[str] = [r.main_code for r in records]
        self.secondary_codes: List[str] = [r.secondary_code for r in records]
        self.has_complication = np.array(
            [r.has_complication for r in records], dtype=bool
        )
        self.levels = np.array([r.level for r in records], dtype=np.int32)
        self.parent_codes: List[str] = [r.parent_code for r in records]
        self.category_paths: List[str] = [r.category_path for r in records]
        self.semantic_texts: List[str] = [r.semantic_text for r in records]
        self._code_to_idx: Optional[Dict[str, int]] = None

    def __len__(self) -> int:
        return len(self.codes)

    def record(self, i: int) -> ICDRecord:
        return ICDRecord(
            code=self.codes[i],
            preferred_zh=self.titles[i],
            main_code=self.main_codes[i],
            secondary_code=self.secondary_codes[i],
            has_complication=bool(self.has_complication[i]),
            level=int(self.levels[i]),
            parent_code=self.parent_codes[i],
            category_path=self.category_paths[i],
            semantic_text=self.semantic_texts[i],
        )

    def records(self) -> Iterable[ICDRecord]:
        for i in range(len(self)):
            yield self.record(i)

    @property
    def code_to_idx(self) -> Dict[str, int]:
        if self._code_to_idx is None:
            self._code_to_idx = {c: i for i, c in enumerate(self.codes)}
        return self._code_to_idx

    def level_weights(self, weights: Sequence[float] = (1.2, 1.0, 0.8)) -> np.ndarray:
        """Per-row search weight vector ×{1.2,1.0,0.8} by level (reference:
        services/milvus_service.py:550-558). This is the vector fused into
        the TPU search kernel."""
        table = np.asarray(weights, dtype=np.float32)
        return table[np.clip(self.levels, 1, 3) - 1]

    def hierarchy_stats(self) -> Dict[str, int]:
        counts = {
            f"level{lvl}": int(np.sum(self.levels == lvl)) for lvl in (1, 2, 3)
        }
        counts["combo"] = int(np.sum(self.has_complication))
        counts["total"] = len(self)
        return counts

    # ---------------------------------------------------------------- I/O

    @classmethod
    def from_csv(cls, path: str) -> "ICDCorpus":
        """Load and parse the corpus CSV (columns code,disease)."""
        raw = Path(path).read_bytes()
        text = raw.decode("utf-8-sig")  # strips BOM
        return cls.from_rows(csv.DictReader(io.StringIO(text)))

    @classmethod
    def from_rows(cls, rows: Iterable[Dict[str, str]]) -> "ICDCorpus":
        records: List[ICDRecord] = []
        parent_info: Dict[str, str] = {}
        for row in rows:
            code = str(row.get("code", "") or "").strip()
            disease = str(row.get("disease", "") or "").strip()
            if not code or not disease or code == "nan" or disease == "nan":
                continue
            main_code, secondary_code, has_comp = split_combo_code(code)
            level, parent_code, category_path = parse_hierarchy(code, parent_info)
            semantic_text = build_semantic_text(
                code, disease, category_path, parent_info
            )
            records.append(
                ICDRecord(
                    code=code,
                    preferred_zh=disease,
                    main_code=main_code,
                    secondary_code=secondary_code,
                    has_complication=has_comp,
                    level=level,
                    parent_code=parent_code,
                    category_path=category_path,
                    semantic_text=semantic_text,
                )
            )
            parent_info[code] = disease
        return cls(records)

    def to_json(self, path: str) -> None:
        """Persist metadata columns as a JSON sidecar (vectors are stored
        separately by the vector store)."""
        payload = {
            "codes": self.codes,
            "titles": self.titles,
            "main_codes": self.main_codes,
            "secondary_codes": self.secondary_codes,
            "has_complication": self.has_complication.tolist(),
            "levels": self.levels.tolist(),
            "parent_codes": self.parent_codes,
            "category_paths": self.category_paths,
            "semantic_texts": self.semantic_texts,
        }
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        Path(path).write_text(json.dumps(payload, ensure_ascii=False))

    @classmethod
    def from_json(cls, path: str) -> "ICDCorpus":
        payload = json.loads(Path(path).read_text(encoding="utf-8"))
        corpus = cls.__new__(cls)
        corpus.codes = payload["codes"]
        corpus.titles = payload["titles"]
        corpus.main_codes = payload["main_codes"]
        corpus.secondary_codes = payload["secondary_codes"]
        corpus.has_complication = np.array(payload["has_complication"], dtype=bool)
        corpus.levels = np.array(payload["levels"], dtype=np.int32)
        corpus.parent_codes = payload["parent_codes"]
        corpus.category_paths = payload["category_paths"]
        corpus.semantic_texts = payload["semantic_texts"]
        corpus._code_to_idx = None
        return corpus


def synthetic_corpus(n: int = 256, seed: int = 0) -> ICDCorpus:
    """Deterministic synthetic corpus for tests/benchmarks when the real CSV
    is unavailable. Mimics the real code shapes (chapter letters, levels,
    combo codes) and Chinese disease titles."""
    rng = np.random.default_rng(seed)
    chapters = "ABCEIJKNS"
    organs = ["胃", "肺", "心", "肝", "肾", "脑", "肠", "骨", "脾", "胆"]
    kinds = ["炎", "癌", "结石", "损伤", "梗死", "功能不全", "出血", "溃疡"]
    mods = ["急性", "慢性", "复发性", "继发性", "未特指的", ""]
    rows: List[Dict[str, str]] = []
    for i in range(n):
        chap = chapters[int(rng.integers(len(chapters)))]
        major = int(rng.integers(0, 100))
        form = int(rng.integers(3))
        base = f"{chap}{major:02d}"
        if form == 0:
            code = base
        elif form == 1:
            code = f"{base}.{int(rng.integers(10))}"
        else:
            code = f"{base}.{int(rng.integers(1000)):03d}"
        if rng.random() < 0.02:
            code = f"{code}+B9{int(rng.integers(10))}*"
        disease = (
            mods[int(rng.integers(len(mods)))]
            + organs[int(rng.integers(len(organs)))]
            + kinds[int(rng.integers(len(kinds)))]
        )
        rows.append({"code": code, "disease": disease + f"{i:04d}"})
    return ICDCorpus.from_rows(rows)


def load_corpus(path: Optional[str], fallback_n: int = 256) -> ICDCorpus:
    """Load the configured corpus, falling back to a synthetic one."""
    if path and Path(path).exists():
        return ICDCorpus.from_csv(path)
    return synthetic_corpus(fallback_n)
