"""What each drawn batch of the fine-tuning job should hold, rebuilt from
the benchmark's own table.

The job (``tools/train_encoder.py --weighted-loss``) draws rows of an
anchor, a positive and a hard negative:

- the positive is one record's semantic text, "title | ancestor titles |
  ICD-10: code" (the reference system's ``build_database.py`` format);
- the anchor is that record's own title, perhaps perturbed, or the exact
  title of a child record (a child paired with its parent's text); either
  may be wrapped in an uncertainty marker;
- the hard negative is a title of the anchor record's siblings (same
  parent, another title) or cousins (the first three children of each
  other child of its grandparent, twelve at most), or its ancestors where
  the job draws those, or any title where the record has none;
- group ids stand for titles, one id per title, in all three columns;
- the weights are the served level weight of the positive's record and
  the largest of the rows bearing the hard negative's title.

``DrawCheck.check`` holds a drawn batch to that row by row and returns the
batch the reference trains on: the positive and the hard negative
tokenized from the table's own strings, the anchor as drawn, group ids
and weights of the benchmark's own, and each row's token counts.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .tokenizer import Tokenizer


class DrawCheck:
    def __init__(self, corpus, tok: Tokenizer, seq_a: int, seq_b: int,
                 level_weights: Sequence[float], cousin_frac: float, ancestor_frac: float):
        self.corpus, self.tok, self.seq_a, self.seq_b = corpus, tok, seq_a, seq_b
        self.cousin_frac, self.ancestor_frac = cousin_frac, ancestor_frac
        idx = {c: i for i, c in enumerate(corpus.codes)}
        self.parent = [idx[p] if p else -1 for p in corpus.parents]
        self.kids: Dict[int, List[int]] = defaultdict(list)
        for i, p in enumerate(self.parent):
            if p >= 0:
                self.kids[p].append(i)
        self.row_w = np.asarray(level_weights, np.float32)[corpus.levels - 1]
        self.title_w: Dict[str, float] = {}
        for t, w in zip(corpus.titles, self.row_w):
            self.title_w[t] = max(self.title_w.get(t, float(w)), float(w))
        self.by_code = {c.lower(): i for i, c in enumerate(corpus.codes)}
        self.ids: Dict[str, int] = {}       # the benchmark's group id of a title
        self.prog_of: Dict[int, str] = {}   # the program's group id -> title
        self.prog_id: Dict[str, int] = {}   # title -> the program's group id
        self._enc: Dict[Tuple[str, int], List[int]] = {}
        self.faults: Dict[str, int] = defaultdict(int)

    # -------------------------------------------------------------- parts

    def encode(self, text: str, length: int) -> List[int]:
        key = (text, length)
        e = self._enc.get(key)
        if e is None:
            e = self._enc[key] = self.tok.encode(text, length)
        return e

    def semantic_text(self, i: int) -> str:
        """Title, the ancestors' titles from the top (each once), code."""
        parts, chain, p = [self.corpus.titles[i]], [], self.parent[i]
        while p >= 0:
            chain.append(p)
            p = self.parent[p]
        for anc in reversed(chain):
            if self.corpus.titles[anc] not in parts:
                parts.append(self.corpus.titles[anc])
        return " | ".join(parts + [f"ICD-10: {self.corpus.codes[i]}"])

    def pools(self, i: int) -> Optional[set]:
        """Titles the hard negative of an anchor from record ``i`` may
        take; None where any title may."""
        titles, t = self.corpus.titles, self.corpus.titles[i]
        p = self.parent[i]
        sibs = {titles[j] for j in self.kids.get(p, ())} - {t} if p >= 0 else set()
        cousins, ancestors = [], []
        if p >= 0:
            gp = self.parent[p]
            if gp >= 0:
                cousins = [titles[j] for u in self.kids[gp] if u != p
                           for j in self.kids[u][:3] if titles[j] != t][:12]
                ancestors = [titles[j] for j in (p, gp) if titles[j] != t]
            else:
                ancestors = [titles[p]] if titles[p] != t else []
        out = set()
        if sibs:
            out |= sibs
        if cousins and self.cousin_frac > 0:
            out |= set(cousins)
        if ancestors and self.ancestor_frac > 0:
            out |= set(ancestors)
        return out or None

    def pools_hold(self, i: int, title: str) -> bool:
        pool = self.pools(i)
        return pool is None or title in pool

    def _same(self, prog: int, title: str) -> bool:
        """The program's id stands for one title and the title for one id."""
        a = self.prog_of.setdefault(prog, title)
        b = self.prog_id.setdefault(title, prog)
        return a == title and b == prog

    def _gid(self, title: str) -> int:
        return self.ids.setdefault(title, len(self.ids))

    # -------------------------------------------------------------- check

    def _content(self, ids, mask) -> Optional[List[int]]:
        """A row's ids up to its [SEP], where the row has the shape the
        tokenizer gives: [CLS] pieces [SEP], mask 1 over them, padding
        after."""
        n = int(mask.sum())
        if n < 2 or not (mask[:n] == 1).all() or (mask[n:] != 0).any():
            return None
        if (ids[n:] != self.tok.pad_id).any():
            return None
        return [int(x) for x in ids[:n]]

    def check(self, batch: Dict) -> Tuple[Dict[str, np.ndarray], List[List[int]]]:
        """Faults of one drawn batch go to ``faults``; returns the batch the
        reference trains on and the (anchor, positive, hard negative)
        token counts of its rows."""
        tok, f = self.tok, self.faults
        titles = self.corpus.titles
        a_ids, a_mask = np.asarray(batch["a_ids"]), np.asarray(batch["a_mask"])
        b_ids, b_mask = np.asarray(batch["b_ids"]), np.asarray(batch["b_mask"])
        h_ids, h_mask = np.asarray(batch["h_ids"]), np.asarray(batch["h_mask"])
        ga, gb, gh = (np.asarray(batch[k]) for k in ("group_a", "group_b", "h_group"))
        w_b, w_h = (np.asarray(batch[k], np.float64) for k in ("w_b", "w_h"))
        rows = a_ids.shape[0]
        if a_ids.shape[1] != self.seq_a or b_ids.shape[1] != self.seq_b \
                or h_ids.shape[1] != self.seq_a:
            f["shape"] += rows
        out = {k: [] for k in ("a", "b", "h", "ga", "gb", "gh", "wb", "wh")}
        counts: List[List[int]] = [[], [], []]
        for r in range(rows):
            # positive: the semantic text of the record its code names
            row_b = self._content(b_ids[r], b_mask[r])
            j = None
            if row_b is not None:
                text = tok.decode(row_b)
                code = text.rsplit("icd - 10 :", 1)[-1].replace(" ", "")
                j = self.by_code.get(code)
            if j is None:
                f["positive"] += 1
                continue
            want_b = self.encode(self.semantic_text(j), self.seq_b)
            if row_b != want_b:
                f["positive"] += 1
            if abs(w_b[r] - float(self.row_w[j])) > 1e-6:
                f["weight"] += 1
            # hard negative: a title of the table
            row_h = self._content(h_ids[r], h_mask[r])
            th = tok.decode(row_h).replace(" ", "") if row_h is not None else ""
            if th not in self.title_w or row_h != self.encode(th, self.seq_a):
                f["hard_negative"] += 1
                continue
            if abs(w_h[r] - self.title_w[th]) > 1e-6:
                f["weight"] += 1
            # anchor: as drawn, whole; its record j itself, or a child of j
            row_a = self._content(a_ids[r], a_mask[r])
            if row_a is None or len(row_a) >= self.seq_a or tok.unk_id in row_a \
                    or self.encode(tok.decode(row_a), self.seq_a) != row_a:
                f["anchor"] += 1
                continue
            tb = titles[j]
            if int(ga[r]) == int(gb[r]):
                sources = [j]
            else:
                inner = row_a[1:-1]
                sources = [c for c in self.kids.get(j, ()) if titles[c] != tb
                           and _contains(inner, self.encode(titles[c], 512)[1:-1])]
                known = self.prog_of.get(int(ga[r]))
                if known is not None:
                    sources = [c for c in sources if titles[c] == known]
                if not sources:
                    f["anchor"] += 1
                    continue
                # one child's title inside another's: the longest is the
                # anchor's, and binds no id until a row names it alone
                sources.sort(key=lambda c: -len(titles[c]))
            ta = titles[sources[0]]
            if not self.pools_hold(sources[0], th):
                f["hard_negative"] += 1
            pairs = [(int(gb[r]), tb), (int(gh[r]), th)]
            if len({titles[c] for c in sources}) == 1:
                pairs.append((int(ga[r]), ta))
            elif self.prog_id.get(ta, int(ga[r])) != int(ga[r]):
                f["group"] += 1
            if not all(self._same(prog, title) for prog, title in pairs):
                f["group"] += 1
            out["a"].append(row_a)
            out["b"].append(want_b)
            out["h"].append(self.encode(th, self.seq_a))
            out["ga"].append(self._gid(ta))
            out["gb"].append(self._gid(tb))
            out["gh"].append(self._gid(th))
            out["wb"].append(float(self.row_w[j]))
            out["wh"].append(self.title_w[th])
            for k, e in enumerate((row_a, want_b, out["h"][-1])):
                counts[k].append(len(e))
        ref = {}
        for side, seq in (("a", self.seq_a), ("b", self.seq_b), ("h", self.seq_a)):
            ref[f"{side}_ids"], ref[f"{side}_mask"] = _pad(out[side], seq, tok.pad_id)
        ref.update(group_a=np.asarray(out["ga"], np.int64), group_b=np.asarray(out["gb"], np.int64),
                   h_group=np.asarray(out["gh"], np.int64),
                   w_b=np.asarray(out["wb"], np.float32), w_h=np.asarray(out["wh"], np.float32))
        return ref, counts


def _contains(seq: List[int], sub: List[int]) -> bool:
    n = len(sub)
    return n > 0 and any(seq[i:i + n] == sub for i in range(len(seq) - n + 1))


def _pad(rows: List[List[int]], seq: int, pad: int) -> Tuple[np.ndarray, np.ndarray]:
    ids = np.full((len(rows), seq), pad, np.int64)
    mask = np.zeros((len(rows), seq), np.int64)
    for i, e in enumerate(rows):
        ids[i, :len(e)] = e
        mask[i, :len(e)] = 1
    return ids, mask
