"""BERT-compatible Chinese WordPiece tokenizer.

The reference relies on sentence-transformers' bundled HF tokenizer
(reference: services/embedding_service.py:47-66 loads a SentenceTransformer
which wraps BertTokenizerFast). Here the tokenizer is implemented from
scratch so the framework is self-contained:

- BERT ``BasicTokenizer`` semantics: NFC-ish cleanup, lowercase, CJK
  characters split into single tokens, punctuation split.
- Greedy longest-match-first WordPiece with ``##`` continuation prefix.
- Loads a standard ``vocab.txt`` (one token per line) when available, so a
  real text2vec-base-chinese vocab gives HF-identical ids.
- Otherwise builds a deterministic character vocabulary from a corpus —
  for Chinese medical text this is near-lossless since BERT-Chinese
  tokenizes CJK per-character anyway.

Output is fixed-shape numpy (ids, attention_mask, token_type_ids) bucketed
to static lengths: XLA-friendly, no dynamic shapes.

``encode``/``encode_batch`` split each text once into the pieces
``basic_tokenize`` keeps apart and look each piece's ids up in a bounded
per-instance memo; a miss runs ``basic_tokenize`` + ``wordpiece`` on the
piece. Chinese text is nearly all single CJK characters, so after a few
batches almost every lookup hits (``memo_stats``).
"""

from __future__ import annotations

import re
import threading
import unicodedata
from itertools import accumulate
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

PAD, UNK, CLS, SEP, MASK = "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"
SPECIALS = (PAD, UNK, CLS, SEP, MASK)


# The ranges of ``_is_cjk`` as a regex class.
_CJK_CLASS = (
    "\u4e00-\u9fff\u3400-\u4dbf\U00020000-\U0002a6df\U0002a700-\U0002b73f"
    "\U0002b740-\U0002b81f\U0002b820-\U0002ceaf\uf900-\ufaff\U0002f800-\U0002fa1f"
)
# The characters ``basic_tokenize`` splits words on: whitespace that
# ``_is_control`` keeps. \x0b \x0c \x1c-\x1f \x85 are whitespace too, but
# dropped as controls, so they join the characters around them.
_SEPARATORS = "\t\n\r \xa0\u1680\u2000-\u200a\u2028\u2029\u202f\u205f\u3000"
# A piece: one CJK character, or a maximal run of anything but CJK and
# separators. basic_tokenize(text) == sum(basic_tokenize(p) for p in pieces).
_PIECE = re.compile(f"[{_CJK_CLASS}]|[^{_CJK_CLASS}{_SEPARATORS}]+")
_CJK_TEXT = re.compile(f"[{_CJK_CLASS}]*")

# Pieces a tokenizer remembers; past it, misses are computed and not stored.
MEMO_MAX_PIECES = 1 << 17


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF
        or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF
        or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F
        or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF
        or 0x2F800 <= cp <= 0x2FA1F
    )


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def basic_tokenize(text: str, lowercase: bool = True) -> List[str]:
    """BERT BasicTokenizer: clean, split CJK chars, split on punctuation."""
    out_chars: List[str] = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or _is_control(ch):
            continue
        if _is_cjk(cp):
            out_chars.append(f" {ch} ")
        elif ch.isspace():
            out_chars.append(" ")
        else:
            out_chars.append(ch)
    tokens: List[str] = []
    for tok in "".join(out_chars).split():
        if lowercase:
            tok = tok.lower()
            tok = "".join(
                c for c in unicodedata.normalize("NFD", tok)
                if unicodedata.category(c) != "Mn"
            )
        # split punctuation off
        current: List[str] = []
        for ch in tok:
            if _is_punctuation(ch):
                if current:
                    tokens.append("".join(current))
                    current = []
                tokens.append(ch)
            else:
                current.append(ch)
        if current:
            tokens.append("".join(current))
    return tokens


class WordPieceTokenizer:
    """Greedy WordPiece over a token->id vocab."""

    def __init__(self, vocab: Dict[str, int], max_input_chars_per_word: int = 100):
        self.vocab = vocab
        self.inv_vocab = {i: t for t, i in vocab.items()}
        self.max_input_chars_per_word = max_input_chars_per_word
        self.pad_id = vocab[PAD]
        self.unk_id = vocab[UNK]
        self.cls_id = vocab[CLS]
        self.sep_id = vocab[SEP]
        # piece -> its token ids, a tuple that is never handed out
        self._memo: Dict[str, Tuple[int, ...]] = {}
        self._lock = threading.Lock()
        self._hits = 0
        self._misses = 0

    # ------------------------------------------------------------- vocab

    @classmethod
    def from_vocab_file(cls, path: str) -> "WordPieceTokenizer":
        """Load a standard HF ``vocab.txt`` (token per line, id = line no)."""
        vocab: Dict[str, int] = {}
        for i, line in enumerate(
            Path(path).read_text(encoding="utf-8").splitlines()
        ):
            vocab[line.rstrip("\n")] = i
        for sp in SPECIALS:
            if sp not in vocab:
                raise ValueError(f"vocab file missing special token {sp}")
        return cls(vocab)

    @classmethod
    def from_corpus(
        cls, texts: Iterable[str], extra_tokens: Sequence[str] = ()
    ) -> "WordPieceTokenizer":
        """Deterministic char-level vocab from corpus text (sorted by
        codepoint so builds are reproducible)."""
        chars = set()
        for text in texts:
            for tok in basic_tokenize(text):
                chars.update(tok)
        vocab: Dict[str, int] = {sp: i for i, sp in enumerate(SPECIALS)}
        for ch in sorted(chars, key=ord):
            vocab.setdefault(ch, len(vocab))
        # continuation pieces for ascii alnum so wordpiece can assemble
        # latin/digit words from chars
        for ch in sorted(chars, key=ord):
            if ch.isascii() and ch.isalnum():
                vocab.setdefault(f"##{ch}", len(vocab))
        for tok in extra_tokens:
            vocab.setdefault(tok, len(vocab))
        return cls(vocab)

    def save_vocab(self, path: str) -> None:
        items = sorted(self.vocab.items(), key=lambda kv: kv[1])
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        Path(path).write_text("\n".join(t for t, _ in items), encoding="utf-8")

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    # ---------------------------------------------------------- tokenize

    def wordpiece(self, token: str) -> List[str]:
        if len(token) > self.max_input_chars_per_word:
            return [UNK]
        pieces: List[str] = []
        start = 0
        while start < len(token):
            end = len(token)
            piece = None
            while start < end:
                sub = token[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    piece = sub
                    break
                end -= 1
            if piece is None:
                return [UNK]
            pieces.append(piece)
            start = end
        return pieces

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for tok in basic_tokenize(text):
            out.extend(self.wordpiece(tok))
        return out

    def encode(self, text: str, max_length: int = 512) -> List[int]:
        """[CLS] tokens [SEP], truncated to max_length."""
        return self._encode_flat((text,), max_length)[0]

    def _encode_flat(
        self, texts: Iterable[str], max_length: int
    ) -> Tuple[List[int], List[int]]:
        """``encode`` of each text: the rows end to end in one list, and
        each row's length."""
        get = self._memo.get
        cut = max_length - 2  # each row's tokens are cut as tokens[:cut]
        flat: List[int] = []
        lens: List[int] = []
        looked = misses = 0
        for text in texts:
            # a text of CJK characters alone is its own list of pieces
            pieces = text if _CJK_TEXT.fullmatch(text) else _PIECE.findall(text)
            looked += len(pieces)
            start = len(flat)
            flat.append(self.cls_id)
            for piece in pieces:
                ids = get(piece)
                if ids is None:
                    ids = self._remember(piece)
                    misses += 1
                flat += ids
            n_tokens = len(flat) - start - 1
            del flat[start + 1 + (cut if cut >= 0 else max(n_tokens + cut, 0)):]
            flat.append(self.sep_id)
            lens.append(len(flat) - start)
        with self._lock:
            self._hits += looked - misses
            self._misses += misses
        return flat, lens

    def _remember(self, piece: str) -> Tuple[int, ...]:
        """A missed piece's ids, stored while the memo has room."""
        ids = tuple(
            self.vocab.get(t, self.unk_id)
            for tok in basic_tokenize(piece)
            for t in self.wordpiece(tok)
        )
        with self._lock:
            if len(self._memo) < MEMO_MAX_PIECES:
                self._memo[piece] = ids
        return ids

    def memo_stats(self) -> Dict[str, Any]:
        """Piece lookups that hit and missed the memo, the share that hit
        (None before the first), and the memo's size."""
        with self._lock:
            hits, misses, size = self._hits, self._misses, len(self._memo)
        looked = hits + misses
        return {
            "hits": hits,
            "misses": misses,
            "hit_share": hits / looked if looked else None,
            "pieces": size,
            "capacity": MEMO_MAX_PIECES,
        }

    # ------------------------------------------------------------- batch

    def encode_batch(
        self,
        texts: Sequence[str],
        max_length: int = 512,
        buckets: Optional[Sequence[int]] = None,
        pad_batch_to: Optional[int] = None,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Encode to fixed-shape (ids, attention_mask, token_type_ids).

        Sequence length = smallest bucket covering the longest text (bounded
        by max_length); batch optionally padded to ``pad_batch_to`` rows so
        jit sees a bounded set of shapes.
        """
        flat, lens = self._encode_flat(texts, max_length)
        longest = max(lens, default=1)
        if buckets:
            usable = [b for b in buckets if b >= longest and b <= max_length]
            seq_len = min(usable) if usable else max_length
        else:
            seq_len = max_length
        n = len(lens)
        rows = pad_batch_to if pad_batch_to and pad_batch_to >= n else n
        ids = np.full((rows, seq_len), self.pad_id, dtype=np.int32)
        mask = np.zeros((rows, seq_len), dtype=np.int32)
        if longest > seq_len:  # max_length under 2: rows cut at seq_len
            starts = list(accumulate(lens, initial=0))
            flat = [i for s, k in zip(starts, lens) for i in flat[s : s + min(k, seq_len)]]
            lens = [min(k, seq_len) for k in lens]
        filled = np.arange(seq_len) < np.array(lens, np.intp)[:, None]
        ids[:n][filled] = flat  # a boolean assignment fills row-major
        mask[:n] = filled
        type_ids = np.zeros_like(ids)
        return ids, mask, type_ids
