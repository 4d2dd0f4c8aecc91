"""A synthetic ICD-10 code table with the v601 table's hierarchy mix.

Codes follow the table's shapes: level 1 ``A01`` (three-character
categories and ``A01-A05`` block rows), level 2 ``A01.1`` under a
category, level 3 ``A01.101`` under a level-2 code, and dagger-asterisk
combination rows ``A01.101+B23*`` (counted at level 3). Titles are Chinese
diagnosis phrases built from a fixed lexicon, so that some titles repeat,
as about one in seven does in the real table.
"""

from __future__ import annotations

import csv
from dataclasses import dataclass
from typing import Dict, List

import numpy as np

from . import CORPUS, rng

# the published v601 table: 40,474 valid rows (SURVEY.md)
LEVEL_COUNTS = (5031, 12106, 23337)
COMBO_ROWS = 1000

_LETTERS = "ABCDEFGHIJKLMNOPQRSTVWXYZ"  # the chapters' letters (no U)
_SITES = ("胃", "十二指肠", "结肠", "直肠", "肝", "胆囊", "胰腺", "食管", "肺", "支气管",
          "气管", "心", "冠状动脉", "主动脉", "脑", "脊髓", "肾", "输尿管", "膀胱", "前列腺",
          "子宫", "卵巢", "乳腺", "甲状腺", "皮肤", "骨", "关节", "膝", "髋", "腰椎", "颈椎",
          "眼", "耳", "鼻", "咽", "喉", "口腔", "牙", "淋巴结", "脾", "血管", "静脉", "腹膜")
_KINDS = ("炎", "溃疡", "恶性肿瘤", "良性肿瘤", "结石", "损伤", "梗死", "出血", "功能不全",
          "囊肿", "狭窄", "穿孔", "感染", "结核", "息肉", "萎缩", "增生", "脓肿", "畸形",
          "骨折", "脱位", "扩张", "硬化", "衰竭", "坏死", "疝", "肥大", "瘘")
_MODS = ("急性", "慢性", "复发性", "继发性", "原发性", "先天性", "特发性", "获得性",
         "病毒性", "细菌性", "化脓性", "出血性", "缺血性", "", "", "")
_TAILS = ("伴出血", "伴穿孔", "伴梗阻", "伴感染", "伴坏死", "未特指的", "其他特指的",
          "双侧", "左侧", "右侧", "多发性", "重度", "轻度", "中度", "术后")


@dataclass
class Corpus:
    codes: List[str]
    titles: List[str]
    levels: np.ndarray  # (N,) int: 1, 2, 3, as the generator made them
    parents: List[str]  # "" for level 1

    def __len__(self) -> int:
        return len(self.codes)

    def level_weights(self, weights=(1.2, 1.0, 0.8)) -> np.ndarray:
        return np.asarray(weights, np.float32)[self.levels - 1]

    def write_csv(self, path: str) -> None:
        """The table as the reference system ships it: columns code,disease."""
        with open(path, "w", newline="", encoding="utf-8") as f:
            w = csv.writer(f)
            w.writerow(["code", "disease"])
            w.writerows(zip(self.codes, self.titles))


def _title(g: np.random.Generator, site: str, depth: int) -> str:
    mod = _MODS[int(g.integers(len(_MODS)))] if depth > 1 else ""
    kind = _KINDS[int(g.integers(len(_KINDS)))]
    tail = _TAILS[int(g.integers(len(_TAILS)))] if depth > 2 else ""
    return f"{mod}{site}{kind}{tail}"


def make_corpus(seed: int, level_counts=LEVEL_COUNTS, combos: int = COMBO_ROWS) -> Corpus:
    """The table for ``seed`` (a configuration's ``table_seed``: one table
    stands for the one v601 table every deployment serves): exactly ``level_counts`` rows at levels 1-3,
    ``combos`` of the level-3 rows combination codes, every parent present,
    rows in code order as the table lists them."""
    g = rng(seed, CORPUS)
    n1, n2, n3 = level_counts
    cats = [f"{c}{i:02d}" for c in _LETTERS for i in range(100)]
    g.shuffle(cats)
    n_cat = min(len(cats), max(1, (n1 * 2) // 3), n1)
    cats = sorted(cats[:n_cat])
    # block rows ("A01-A05") fill level 1 beyond the categories
    blocks = set()
    while len(blocks) < n1 - n_cat:
        c = _LETTERS[int(g.integers(len(_LETTERS)))]
        a = int(g.integers(0, 95))
        blocks.add(f"{c}{a:02d}-{c}{a + int(g.integers(1, 5)):02d}")
    l2 = sorted({f"{cats[int(i)]}.{int(d)}" for i, d in zip(
        g.integers(0, n_cat, 4 * n2), g.integers(0, 10, 4 * n2))})
    l2 = sorted(g.choice(l2, n2, replace=False).tolist()) if len(l2) >= n2 else l2
    l3 = set()
    while len(l3) < n3:
        p = l2[int(g.integers(len(l2)))]
        l3.add(f"{p}{int(g.integers(0, 100)):02d}")
    l3 = sorted(l3)
    combo_at = set(g.choice(len(l3), combos, replace=False).tolist())
    site_of: Dict[str, str] = {}
    rows = []
    for code in cats:
        site_of[code] = _SITES[int(g.integers(len(_SITES)))]
        rows.append((code, _title(g, site_of[code], 1), 1, ""))
    for code in sorted(blocks):
        rows.append((code, _title(g, _SITES[int(g.integers(len(_SITES)))], 1), 1, ""))
    for code in l2:
        parent = code.split(".")[0]
        rows.append((code, _title(g, site_of[parent], 2), 2, parent))
    for j, code in enumerate(l3):
        parent = code[: code.index(".") + 2]
        title = _title(g, site_of[code.split(".")[0]], 3)
        if j in combo_at:
            code = f"{code}+{cats[int(g.integers(n_cat))]}*"
        rows.append((code, title, 3, parent))
    rows.sort(key=lambda r: r[0])
    return Corpus(
        codes=[r[0] for r in rows], titles=[r[1] for r in rows],
        levels=np.array([r[2] for r in rows], np.int64), parents=[r[3] for r in rows],
    )


def vocabulary() -> List[str]:
    """A bert-base-chinese-like vocabulary (every CJK unified ideograph,
    ASCII with ``##`` continuations, CJK and full-width punctuation): 21,025
    entries, within the encoder's 21,128 rows, so no text of the mix
    tokenizes to [UNK]."""
    from ..reference.tokenizer import SPECIALS

    out = list(SPECIALS)
    ascii_ = [chr(c) for c in range(33, 127)]
    out += ascii_
    out += ["##" + c for c in ascii_ if c.isalnum()]
    out += list("，。、；：？！（）【】《》“”‘’…—～·「」『』〈〉［］｛｝")
    out += [chr(c) for c in range(0x4E00, 0x9FA6)]
    return out
