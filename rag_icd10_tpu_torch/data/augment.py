"""Query-side text augmentation for encoder training and retrieval eval.

The port's own copy of rag_icd10_tpu/data/augment.py (pure Python, no
array library): the store builder takes its ``augmentation_charset_texts``
for the tokenizer vocab; the rest serves encoder training and the
retrieval eval, which the port has not taken over yet. The synonym table, the md5 train/eval split and every transform are the
JAX module's, so both packages build the same vocab and splits.

The reference's quality story is a pretrained encoder
(services/embedding_service.py:26); offline (zero-egress) the in-domain
trained encoder has to supply that quality, which means it must be robust
to how clinicians actually write diagnoses: colloquial synonyms (心梗 for
心肌梗死), legacy spellings (梗塞 for 梗死, 综合症 for 综合征), numeral
styles (2型 vs Ⅱ型 vs 二型), dropped/parenthesized qualifiers, and typos.

This module owns the perturbation vocabulary and enforces a strict
TRAIN/EVAL SPLIT so the eval harness never measures a transform the
training pipeline generated:

- synonym pairs are split deterministically (md5 parity) into a train half
  and an eval half;
- transform CLASSES are also split: training uses char dropout +
  parenthetical stripping + train-half synonyms (both directions) +
  connective-order swaps; eval uses adjacent char swaps, laterality
  ("左/右/双侧") dropping, and eval-half synonyms — classes the training
  never applied.

Uncertainty markers (疑似/待查/考虑/可能/排除) are NOT part of this split:
they are the reference's fixed marker vocabulary
(uncertainty_diagnosis_service.py:20-41), i.e. an observable contract, so
training deliberately exposes them (wrap_uncertainty) and the eval
uncertainty tier measures marker robustness, not transform
generalization.
"""

from __future__ import annotations

import hashlib
import re
from functools import lru_cache
from typing import List, Optional, Sequence, Tuple

# (formal term as it appears in ICD titles, colloquial/legacy variant).
# Hand-curated domain table; both directions are used (query may contain
# either form).
SYNONYM_PAIRS: Tuple[Tuple[str, str], ...] = (
    ("心肌梗死", "心梗"),
    ("心肌梗死", "心肌梗塞"),
    ("脑梗死", "脑梗"),
    ("脑梗死", "脑梗塞"),
    ("恶性肿瘤", "癌"),
    ("综合征", "综合症"),
    ("冠状动脉粥样硬化性心脏病", "冠心病"),
    ("慢性阻塞性肺疾病", "慢阻肺"),
    ("心房颤动", "房颤"),
    ("心室颤动", "室颤"),
    ("心力衰竭", "心衰"),
    ("肾功能衰竭", "肾衰"),
    ("呼吸衰竭", "呼衰"),
    ("乙型肝炎", "乙肝"),
    ("甲型肝炎", "甲肝"),
    ("丙型肝炎", "丙肝"),
    ("流行性感冒", "流感"),
    ("支气管哮喘", "哮喘"),
    ("甲状腺功能亢进症", "甲亢"),
    ("甲状腺功能减退症", "甲减"),
    ("胃肠炎", "肠胃炎"),
    ("脑出血", "脑溢血"),
    ("泌尿道感染", "尿路感染"),
    ("妊娠", "怀孕"),
    ("剖宫产", "剖腹产"),
    ("胆囊结石", "胆结石"),
    ("白血病", "血癌"),
    ("视网膜脱离", "视网膜脱落"),
    ("龋齿", "蛀牙"),
    ("痔", "痔疮"),
    ("系统性红斑狼疮", "红斑狼疮"),
    ("类风湿性关节炎", "类风湿关节炎"),
    ("肺炎", "肺部感染"),
    ("上呼吸道感染", "上感"),
    ("高血压", "血压高"),
    ("高血糖", "血糖高"),
    ("高血脂", "血脂高"),
    ("骨质疏松", "骨质疏松症"),
    ("椎间盘突出", "椎间盘脱出"),
    ("阑尾炎", "盲肠炎"),
    ("腮腺炎", "流行性腮腺炎"),
    ("脑血管意外", "中风"),
    ("近视", "近视眼"),
    ("糖尿病", "消渴症"),
    ("肿瘤", "瘤子"),
    ("骨折", "骨裂伤"),
    ("1型", "Ⅰ型"),
    ("2型", "Ⅱ型"),
    ("1型", "一型"),
    ("2型", "二型"),
)

# Round-4 expansion: more true-alias pairs (colloquial, abbreviation,
# traditional names) so synonym-robustness training sees a broader mapping
# distribution. TRAIN-ONLY by design: these never enter the eval half, so
# the paraphrase eval tier's membership (and the gate bar measured from
# it) stays frozen at the original SYNONYM_PAIRS md5 split — otherwise
# every vocabulary edit would silently re-norm the quality numbers, and
# the frozen incumbent vocab (db/trained/vocab.txt) would face eval chars
# it has no tokens for.
# Either direction of substring containment is safe: apply_synonym's
# corruption guard skips a formal-in-variant pair only on texts that
# already contain the variant (no double-suffix corruption), and
# variant-in-formal abbreviations (脑梗死->脑梗) always apply.
TRAIN_ONLY_SYNONYM_PAIRS: Tuple[Tuple[str, str], ...] = (
    ("脑卒中", "中风"),
    ("癫痫", "羊癫疯"),
    ("癫痫", "羊角风"),
    ("抑郁症", "忧郁症"),
    ("阿尔茨海默病", "老年性痴呆"),
    ("帕金森病", "震颤麻痹"),
    ("面神经麻痹", "面瘫"),
    ("脑性瘫痪", "脑瘫"),
    ("结膜炎", "红眼病"),
    ("麦粒肿", "针眼"),
    ("风湿性心脏病", "风心病"),
    ("肺源性心脏病", "肺心病"),
    ("先天性心脏病", "先心病"),
    ("肝硬化", "肝硬变"),
    ("异位妊娠", "宫外孕"),
    ("前列腺增生", "前列腺肥大"),
    ("银屑病", "牛皮癣"),
    ("带状疱疹", "缠腰龙"),
    ("痤疮", "青春痘"),
    ("脊髓灰质炎", "小儿麻痹症"),
    ("肺结核", "痨病"),
    ("疟疾", "打摆子"),
    ("腮腺炎", "痄腮"),
    ("扁桃体炎", "扁桃腺炎"),
    ("胸膜炎", "肋膜炎"),
    ("食管", "食道"),
    ("唐氏综合征", "21三体综合征"),
    ("唇裂", "兔唇"),
    ("坏血病", "维生素C缺乏病"),
    ("甲状腺肿", "大脖子病"),
    ("强直性脊柱炎", "强脊炎"),
    ("偏头痛", "偏头疼"),
    ("头痛", "头疼"),
    ("腹泻", "拉肚子"),
    ("荨麻疹", "风疹块"),
    ("白癜风", "白斑病"),
    ("佝偻病", "软骨病"),
    ("败血症", "脓毒症"),
    ("狂犬病", "恐水症"),
    ("获得性免疫缺陷综合征", "艾滋病"),
    ("肥胖", "肥胖症"),
    ("夜盲", "夜盲症"),
    ("多发性硬化", "多发性硬化症"),
    ("腰椎间盘突出症", "腰突症"),
    ("股骨头坏死", "股骨头缺血性坏死"),
    ("子宫肌瘤", "子宫平滑肌瘤"),
    ("乳腺增生", "乳腺小叶增生"),
    ("人工流产", "人流"),
    ("早产儿", "早产婴儿"),
)


def _is_eval_pair(pair: Tuple[str, str]) -> bool:
    # ~1/3 of pairs held out for eval; the rest teach the encoder
    digest = hashlib.md5(("|".join(pair)).encode("utf-8")).hexdigest()
    return int(digest, 16) % 3 == 0


@lru_cache(maxsize=1)
def _split_pairs() -> Tuple[Tuple[Tuple[str, str], ...], Tuple[Tuple[str, str], ...]]:
    train = tuple(p for p in SYNONYM_PAIRS if not _is_eval_pair(p))
    evl = tuple(p for p in SYNONYM_PAIRS if _is_eval_pair(p))
    return train + TRAIN_ONLY_SYNONYM_PAIRS, evl


def train_synonyms() -> List[Tuple[str, str]]:
    return list(_split_pairs()[0])


def eval_synonyms() -> List[Tuple[str, str]]:
    return list(_split_pairs()[1])


def apply_synonym(text: str, pairs: Sequence[Tuple[str, str]]) -> Optional[str]:
    """First applicable substitution (formal->variant), else None.

    Corruption guard: for a formal-in-variant pair like 骨质疏松->骨质疏松症,
    a naive replace on a title that already contains the variant would hit
    the formal occurrence INSIDE the variant and double the suffix
    (骨质疏松症 -> 骨质疏松症症). Skip exactly that case; pairs whose formal
    is not inside the variant (e.g. 脑梗死->脑梗) stay applicable even when
    the variant string happens to be a substring of the text."""
    for formal, variant in pairs:
        if formal in text and not (formal in variant and variant in text):
            return text.replace(formal, variant, 1)
    return None


_PAREN_RE = re.compile(r"[（(][^（()）]*[)）]")
_LATERALITY_RE = re.compile(r"(左侧|右侧|双侧|左|右)")


def strip_parenthetical(text: str) -> Optional[str]:
    out = _PAREN_RE.sub("", text)
    out = out.strip()
    return out if out and out != text else None


def char_dropout(text: str, rng) -> Optional[str]:
    """Drop one random char (typo robustness); only for longer titles."""
    if len(text) < 5:
        return None
    i = int(rng.integers(0, len(text)))
    return text[:i] + text[i + 1 :]


def char_swap(text: str, rng) -> Optional[str]:
    """Swap two adjacent chars (EVAL-class transform)."""
    if len(text) < 5:
        return None
    i = int(rng.integers(0, len(text) - 1))
    if text[i] == text[i + 1]:
        return None
    return text[:i] + text[i + 1] + text[i] + text[i + 2 :]


def drop_laterality(text: str) -> Optional[str]:
    """Remove 左/右/双侧 qualifiers (EVAL-class transform)."""
    out = _LATERALITY_RE.sub("", text, count=1)
    return out if out != text and len(out) >= 2 else None


# the reference's uncertainty marker vocabulary
# (uncertainty_diagnosis_service.py:20-41) — a fixed observable contract,
# exposed at train time so raw marker-attached queries embed near their
# clean titles (pipeline/orchestrator.py documents the pre-exposure
# brittleness that forced marker stripping before encoding)
UNCERTAINTY_WRAPPERS: Tuple[str, ...] = (
    "疑似{t}",
    "{t}待查",
    "考虑{t}",
    "{t}可能",
    "排除{t}",
    "{t}？",
    "不排除{t}",
)

# connectives whose operand order clinicians routinely flip
# ("胃溃疡伴出血" vs "出血伴胃溃疡"-style queries)
_CONNECTIVES: Tuple[str, ...] = ("伴有", "合并", "并发", "继发", "伴", "及")


def wrap_uncertainty(title: str, rng) -> str:
    """Wrap a title in one of the reference's uncertainty markers."""
    tpl = UNCERTAINTY_WRAPPERS[int(rng.integers(0, len(UNCERTAINTY_WRAPPERS)))]
    return tpl.format(t=title)


def swap_connective(text: str) -> Optional[str]:
    """Swap the operands of the first connective ("A伴B" -> "B伴A") —
    the word-order robustness class (TRAIN)."""
    for conn in _CONNECTIVES:
        pos = text.find(conn)
        if 0 < pos < len(text) - len(conn):
            left, right = text[:pos], text[pos + len(conn):]
            if left and right:
                return right + conn + left
    return None


def expand_abbrev(text: str) -> Optional[str]:
    """Reverse direction of the train-half synonyms (variant -> formal):
    queries often contain the colloquial form that must map back."""
    for formal, variant in _split_pairs()[0]:
        if variant in text and formal not in text:
            return text.replace(variant, formal, 1)
    return None


def augmentation_charset_texts() -> List[str]:
    """Every string the augmentation pipeline can inject — the tokenizer
    vocab must cover these chars or augmented anchors degrade to [UNK]
    (synonym variants like 蛀牙 and marker chars like 疑 need not appear
    anywhere in the corpus text)."""
    all_pairs = SYNONYM_PAIRS + TRAIN_ONLY_SYNONYM_PAIRS
    out = [v for _, v in all_pairs] + [f for f, _ in all_pairs]
    out += [tpl.format(t="") for tpl in UNCERTAINTY_WRAPPERS]
    out += list(_CONNECTIVES)
    return out


def augment_train(title: str, rng) -> Optional[str]:
    """One TRAIN-class perturbation of a title (or None to keep as-is).

    Classes: train-half synonyms (both directions), parenthetical
    stripping, connective-order swap, char dropout. EVAL-class transforms
    (char swap, laterality drop, eval-half synonyms) are deliberately NOT
    applied here — see module docstring. Marker wrapping is composable on
    top (wrap_uncertainty) and handled by the training batch sampler.
    """
    choice = int(rng.integers(0, 5))
    if choice == 0:
        out = apply_synonym(title, _split_pairs()[0])
        if out:
            return out
    if choice == 1:
        out = strip_parenthetical(title)
        if out:
            return out
    if choice == 2:
        out = swap_connective(title)
        if out:
            return out
    if choice == 3:
        out = expand_abbrev(title)
        if out:
            return out
    # fall through: char dropout applies to most titles
    return char_dropout(title, rng)
