"""Retrieval-quality evaluation harness.

The reference's entire quality story is a pretrained encoder
(services/embedding_service.py:26, text2vec-base-chinese); offline, the
in-domain trained encoder substitutes, so its quality must be MEASURED,
not assumed. This harness generates a tiered eval set from the corpus
itself and reports recall@1/5/10 per tier, both at the raw retrieval
level (encode -> weighted search) and through the full pipeline
(extraction -> rescoring -> confidence).

Tiers (hard -> easy):
- exact_title     query = a record's title verbatim (the easy tier the
                  round-1 numbers were based on)
- paraphrase      EVAL-class transforms the training pipeline never saw
                  (data/augment.py split): eval-half synonyms, adjacent
                  char swaps, laterality drops
- uncertainty     titles wrapped in the reference's uncertainty markers
                  (疑似/待查/考虑/可能/排除 —
                  uncertainty_diagnosis_service.py:20-41)
- multi_diagnosis 2-3 titles joined with the reference's separators,
                  scored per extracted sub-diagnosis through the FULL
                  pipeline

Gold labels are TITLE-level: ~5.5k records share a title with another
record, and no query can distinguish two codes with the identical title,
so a hit is correct when its title matches the source record's title.

Counterpart of rag_icd10_tpu/eval/retrieval.py, the same host-side numpy
over the port's data/augment.py; ``evaluate`` encodes with the port's
``TextEncoder`` and searches the port's ``VectorStore`` (the default
``exact`` method: K1 + ``torch.topk`` on the card).
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set

import numpy as np

from ..data.augment import (
    apply_synonym,
    char_swap,
    drop_laterality,
    eval_synonyms,
)

# the reference's canonical multi-diagnosis demo texts
# (tools/text_processor.py:202-243, ui/utils.py:214-232)
CANONICAL_TEXTS = (
    "急性胃肠炎，高血压病3级",
    "2型糖尿病伴酮症酸中毒",
    "冠状动脉粥样硬化性心脏病，心功能不全",
    "慢性阻塞性肺疾病急性加重期；呼吸衰竭",
    "脑梗死恢复期，高脂血症",
    "疑似急性心肌梗死",
    "肺部感染？胸腔积液待查",
)

UNCERTAINTY_TEMPLATES = (
    "疑似{t}",
    "{t}待查",
    "考虑{t}",
    "{t}可能",
    "排除{t}",
)

MULTI_SEPARATORS = ("，", "；", "+")


@dataclass
class EvalCase:
    query: str
    gold_titles: Set[str]  # any hit with one of these titles is correct
    source_title: str


@dataclass
class EvalTier:
    name: str
    cases: List[EvalCase] = field(default_factory=list)


def _title_sample(
    corpus, n: int, seed: int, min_len: int = 2, filter_separators: bool = True
) -> List[int]:
    """Deterministic sample of record indices. With filter_separators,
    titles the pipeline's OWN separator regex would split
    (pipeline/textproc.py SEPARATOR_RE — the canonical definition,
    including all whitespace classes) are excluded: such TRANSFORMED
    queries are ambiguous-by-design and measure the split contract, not
    retrieval quality. The exact tier samples WITHOUT the filter — a
    verbatim corpus title is never split (the extraction exact-title
    bypass, enhanced.py _is_known_title), so every title is fair game."""
    from ..pipeline.textproc import SEPARATOR_RE

    rng = np.random.default_rng(seed)
    idx = [
        i
        for i, t in enumerate(corpus.titles)
        if len(t) >= min_len
        and (not filter_separators or SEPARATOR_RE.search(t) is None)
    ]
    rng.shuffle(idx)
    return idx[:n]


def build_eval_set(
    corpus,
    n_exact: int = 400,
    n_paraphrase: int = 400,
    n_uncertainty: int = 300,
    n_multi: int = 150,
    seed: int = 1234,
) -> List[EvalTier]:
    """Corpus -> deterministic tiered eval set (no training-seen
    transforms; see data/augment.py for the train/eval split)."""
    def gold(i: int) -> Set[str]:
        # title-level gold: any hit whose title matches the source title
        # is correct (duplicate-title codes are indistinguishable)
        return {corpus.titles[i]}

    tiers: List[EvalTier] = []
    rng = np.random.default_rng(seed)

    # --- exact_title ------------------------------------------------------
    # sampled from ALL titles, including the 3,838 with separator chars:
    # the exact-title extraction bypass makes every verbatim title a fair
    # query (tier membership changed in round 4 — not comparable to
    # pre-r4 exact-tier numbers)
    exact = EvalTier("exact_title")
    for i in _title_sample(corpus, n_exact, seed, filter_separators=False):
        exact.cases.append(EvalCase(corpus.titles[i], gold(i), corpus.titles[i]))
    tiers.append(exact)

    # --- paraphrase (EVAL-class transforms only) --------------------------
    para = EvalTier("paraphrase")
    syns = eval_synonyms()
    pool = _title_sample(corpus, len(corpus), seed + 1, min_len=4)
    for i in pool:
        if len(para.cases) >= n_paraphrase:
            break
        t = corpus.titles[i]
        variant = apply_synonym(t, syns)
        if variant is None:
            variant = drop_laterality(t)
        if variant is None and len(t) >= 6:
            variant = char_swap(t, rng)
        if variant and variant != t:
            para.cases.append(EvalCase(variant, gold(i), t))
    tiers.append(para)

    # --- uncertainty ------------------------------------------------------
    unc = EvalTier("uncertainty")
    for j, i in enumerate(_title_sample(corpus, n_uncertainty, seed + 2)):
        t = corpus.titles[i]
        tpl = UNCERTAINTY_TEMPLATES[j % len(UNCERTAINTY_TEMPLATES)]
        unc.cases.append(EvalCase(tpl.format(t=t), gold(i), t))
    tiers.append(unc)

    # --- multi_diagnosis (scored through the full pipeline only) ----------
    # parts must not contain separator chars themselves, or the extraction
    # split makes the case unsolvable regardless of retrieval quality
    multi = EvalTier("multi_diagnosis")
    from ..pipeline.boundary import (
        CONNECTION_PATTERNS,
        DISEASE_TERM_RE,
        QUALIFIER_TAIL_RE,
    )

    def would_merge(t: str) -> bool:
        # titles the boundary detector would merge INTO the previous
        # segment (connection markers, or qualifier-shaped with no disease
        # term) make a joined case unsolvable regardless of retrieval
        if any(p.search(t) for p in CONNECTION_PATTERNS):
            return True
        return bool(
            QUALIFIER_TAIL_RE.search(t) and not DISEASE_TERM_RE.search(t)
        )

    pool = [
        i
        for i in _title_sample(corpus, n_multi * 6, seed + 3, min_len=3)
        if not would_merge(corpus.titles[i])
    ][: n_multi * 3]
    for group, j in enumerate(range(0, min(len(pool) - 2, n_multi * 3 - 2), 3)):
        if len(multi.cases) >= n_multi:
            break
        parts = [corpus.titles[i] for i in pool[j : j + (2 if j % 2 else 3)]]
        sep = MULTI_SEPARATORS[group % len(MULTI_SEPARATORS)]
        if sep == "+" and any(p and p[-1].isascii() and p[-1].isalnum()
                              for p in parts[:-1]):
            sep = "，"  # alnum+ never splits (immunophenotype rule)
        query = sep.join(parts)
        # one EvalCase per sub-diagnosis, all sharing the joined query
        for i in pool[j : j + len(parts)]:
            multi.cases.append(EvalCase(query, gold(i), corpus.titles[i]))
    tiers.append(multi)
    return tiers


def _recall_at(hits_titles: Sequence[Sequence[str]], golds: Sequence[Set[str]], k: int):
    ok = 0
    for titles, g in zip(hits_titles, golds):
        if any(t in g for t in titles[:k]):
            ok += 1
    return ok / max(len(golds), 1)


def evaluate(
    encoder,
    store,
    matcher=None,
    corpus=None,
    tiers: Optional[List[EvalTier]] = None,
    top_k: int = 10,
    batch: int = 256,
) -> Dict:
    """Run the tiered eval. Raw retrieval for single-mention tiers; the
    FULL pipeline for multi_diagnosis (and pipeline top-1 for every tier
    when a matcher is given)."""
    corpus = corpus or store.corpus
    tiers = tiers or build_eval_set(corpus)
    report: Dict = {
        "generated_at": time.time(),
        "corpus_size": len(corpus),
        "top_k": top_k,
        "tiers": {},
    }
    for tier in tiers:
        if not tier.cases:
            continue
        if tier.name == "multi_diagnosis":
            report["tiers"][tier.name] = _eval_multi(matcher, tier)
            continue
        queries = [c.query for c in tier.cases]
        golds = [c.gold_titles for c in tier.cases]
        hit_titles: List[List[str]] = []
        # raw recall@1 under the SERVED weighted score vs the UNWEIGHTED
        # cosine: the gap is the weight-inversion class (a verbatim
        # detail title loses to a ×1.2 ancestor — reference quirk kept,
        # SURVEY §2.5#4; 97% of exact-tier raw misses on the incumbent,
        # scripts/analyze_misses.py), not encoder confusion
        host_vecs = getattr(store, "_vectors", None)
        uw_ok = 0
        for lo in range(0, len(queries), batch):
            chunk = queries[lo : lo + batch]
            vecs = np.asarray(encoder.encode_queries(chunk))
            rows = store.search(vecs, top_k=top_k)
            hit_titles.extend([[h.preferred_zh for h in row] for row in rows])
            if host_vecs is not None:
                top_uw = np.argmax(vecs @ host_vecs.T, axis=1)
                uw_ok += sum(
                    corpus.titles[j] in g
                    for j, g in zip(top_uw, golds[lo : lo + batch])
                )
        entry = {
            "n": len(queries),
            "recall@1": round(_recall_at(hit_titles, golds, 1), 4),
            "recall@5": round(_recall_at(hit_titles, golds, 5), 4),
            f"recall@{top_k}": round(_recall_at(hit_titles, golds, top_k), 4),
        }
        if host_vecs is not None:
            entry["recall@1_unweighted"] = round(uw_ok / len(queries), 4)
        if matcher is not None:
            entry["pipeline_top1"] = round(
                _pipeline_top1(matcher, tier), 4
            )
        report["tiers"][tier.name] = entry
    return report


def _pipeline_top1(matcher, tier: EvalTier, batch: int = 64) -> float:
    """Full-pipeline top-1 accuracy, STRICT: the best candidate of the
    FIRST extracted diagnosis must carry a gold title — if extraction
    over-splits a single-mention query, the case counts as wrong (that is
    exactly the failure mode this metric should expose)."""
    ok, n = 0, 0
    cases = tier.cases
    for lo in range(0, len(cases), batch):
        chunk = cases[lo : lo + batch]
        results = matcher.match_many_texts([c.query for c in chunk], top_k=5)
        for case, res in zip(chunk, results):
            n += 1
            matches = res.get("matches", [])
            if (
                matches
                and matches[0].candidates
                and matches[0].candidates[0].title in case.gold_titles
            ):
                ok += 1
    return ok / max(n, 1)


def _eval_multi(matcher, tier: EvalTier, batch: int = 32) -> Dict:
    """Multi-diagnosis tier: run each joined query once through the full
    pipeline; each sub-diagnosis case is correct when ANY extracted match
    puts a gold title at top-1."""
    if matcher is None:
        return {"n": len(tier.cases), "skipped": "no matcher"}
    by_query: Dict[str, List[EvalCase]] = {}
    for c in tier.cases:
        by_query.setdefault(c.query, []).append(c)
    queries = list(by_query)
    ok, total = 0, 0
    extracted_counts: List[int] = []
    for lo in range(0, len(queries), batch):
        chunk = queries[lo : lo + batch]
        results = matcher.match_many_texts(chunk, top_k=5)
        for q, res in zip(chunk, results):
            matches = res.get("matches", [])
            extracted_counts.append(len(matches))
            top1_titles = {
                m.candidates[0].title for m in matches if m.candidates
            }
            for case in by_query[q]:
                total += 1
                if case.gold_titles & top1_titles:
                    ok += 1
    return {
        "n": total,
        "queries": len(queries),
        "sub_diagnosis_top1": round(ok / max(total, 1), 4),
        "avg_extracted": round(float(np.mean(extracted_counts)), 2),
    }


def run_canonical(matcher, top_k: int = 5) -> List[Dict]:
    """The reference's 7 demo texts — qualitative report rows."""
    out = []
    results = matcher.match_many_texts(list(CANONICAL_TEXTS), top_k=top_k)
    for text, res in zip(CANONICAL_TEXTS, results):
        out.append(
            {
                "text": text,
                "extracted": res.get("extracted_diagnoses", []),
                "top1": [
                    {
                        "diagnosis": m.diagnosis_text,
                        "code": m.candidates[0].code if m.candidates else None,
                        "title": m.candidates[0].title if m.candidates else None,
                        "confidence": m.match_confidence,
                    }
                    for m in res.get("matches", [])
                ],
            }
        )
    return out


def save_report(report: Dict, path: str) -> None:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(report, f, ensure_ascii=False, indent=1)
