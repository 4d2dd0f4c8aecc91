"""Frozen plain BERT WordPiece tokenizer (BasicTokenizer + greedy
longest-match WordPiece with ``##`` continuations), as BERT defines it.

The benchmark counts non-padding tokens with it (FLOPs) and the reference
encoder tokenizes with it, so a change to the program's tokenizer shows as
a disagreement instead of moving the yardstick.
"""

from __future__ import annotations

import unicodedata
from functools import lru_cache
from typing import Dict, List, Sequence, Tuple

import numpy as np

PAD, UNK, CLS, SEP, MASK = "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"
SPECIALS = (PAD, UNK, CLS, SEP, MASK)

_CJK_RANGES = (
    (0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0x20000, 0x2A6DF), (0x2A700, 0x2B73F),
    (0x2B740, 0x2B81F), (0x2B820, 0x2CEAF), (0xF900, 0xFAFF), (0x2F800, 0x2FA1F),
)


def is_cjk(cp: int) -> bool:
    return any(lo <= cp <= hi for lo, hi in _CJK_RANGES)


def is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


@lru_cache(maxsize=None)
def _char(ch: str) -> str:
    """What the cleaning step makes of one character."""
    cp = ord(ch)
    if cp == 0 or cp == 0xFFFD or _is_control(ch):
        return ""
    if is_cjk(cp):
        return f" {ch} "
    if ch.isspace():
        return " "
    return ch


@lru_cache(maxsize=None)
def _word(tok: str) -> Tuple[str, ...]:
    """One whitespace-separated word lowercased, accents stripped,
    punctuation split off."""
    tok = "".join(
        c for c in unicodedata.normalize("NFD", tok.lower())
        if unicodedata.category(c) != "Mn"
    )
    tokens: List[str] = []
    current: List[str] = []
    for ch in tok:
        if is_punctuation(ch):
            if current:
                tokens.append("".join(current))
                current = []
            tokens.append(ch)
        else:
            current.append(ch)
    if current:
        tokens.append("".join(current))
    return tuple(tokens)


def basic_tokenize(text: str) -> List[str]:
    """Clean, split CJK characters, lowercase, strip accents, split
    punctuation off."""
    return [t for w in "".join(map(_char, text)).split() for t in _word(w)]


class Tokenizer:
    """WordPiece over a ``vocab.txt`` (token per line, id = line number)."""

    def __init__(self, vocab: Sequence[str], max_chars_per_word: int = 100):
        self.tokens = list(vocab)
        self.vocab: Dict[str, int] = {t: i for i, t in enumerate(self.tokens)}
        self.max_chars_per_word = max_chars_per_word
        self._pieces: Dict[str, List[str]] = {}
        self.pad_id, self.unk_id = self.vocab[PAD], self.vocab[UNK]
        self.cls_id, self.sep_id = self.vocab[CLS], self.vocab[SEP]

    @classmethod
    def from_file(cls, path: str) -> "Tokenizer":
        with open(path, encoding="utf-8") as f:
            return cls(f.read().split("\n"))

    def wordpiece(self, word: str) -> List[str]:
        pieces = self._pieces.get(word)
        if pieces is None:
            pieces = self._pieces[word] = self._wordpiece(word)
        return pieces

    def _wordpiece(self, word: str) -> List[str]:
        if len(word) > self.max_chars_per_word:
            return [UNK]
        pieces, start = [], 0
        while start < len(word):
            end, piece = len(word), None
            while start < end:
                sub = word[start:end] if start == 0 else "##" + word[start:end]
                if sub in self.vocab:
                    piece = sub
                    break
                end -= 1
            if piece is None:
                return [UNK]
            pieces.append(piece)
            start = end
        return pieces

    def encode(self, text: str, max_length: int = 512) -> List[int]:
        """[CLS] word pieces [SEP], truncated to ``max_length``."""
        ids = [self.vocab.get(p, self.unk_id)
               for w in basic_tokenize(text) for p in self.wordpiece(w)]
        return [self.cls_id] + ids[: max_length - 2] + [self.sep_id]

    def batch(self, texts: Sequence[str], length: int = 0,
              max_length: int = 512) -> Tuple[np.ndarray, np.ndarray]:
        """(ids, mask) padded to ``length`` (0: the longest text)."""
        enc = [self.encode(t, max_length) for t in texts]
        seq = length or max(len(e) for e in enc)
        ids = np.full((len(enc), seq), self.pad_id, np.int64)
        mask = np.zeros((len(enc), seq), np.int64)
        for i, e in enumerate(enc):
            e = e[:seq]
            ids[i, :len(e)] = e
            mask[i, :len(e)] = 1
        return ids, mask

    def decode(self, ids: Sequence[int]) -> str:
        """Word pieces back to text that tokenizes to the same pieces:
        words joined by spaces, ``##`` continuations glued on."""
        words: List[str] = []
        for i in ids:
            t = self.tokens[int(i)]
            if t in SPECIALS:
                continue
            if t.startswith("##") and words:
                words[-1] += t[2:]
            else:
                words.append(t)
        return " ".join(words)
