"""The port's WordPiece tokenizer with its piece memo, on the CPU.

``encode``/``encode_batch`` split each text into the pieces
``basic_tokenize`` keeps apart and read each piece's ids from a bounded
memo. Every output is held against two references: the JAX package's
tokenizer, and the port's uncached ``basic_tokenize`` + ``wordpiece``.
"""

import random
import sys

import numpy as np
import pytest

from rag_icd10_tpu.models.tokenizer import WordPieceTokenizer as JTok
from rag_icd10_tpu.parallel import train as jtrain
from rag_icd10_tpu_torch.api.app import APIServer
from rag_icd10_tpu_torch import config as tconfig
from rag_icd10_tpu_torch.data.corpus import synthetic_corpus
from rag_icd10_tpu_torch.models import tokenizer as ttok
from rag_icd10_tpu_torch.models.tokenizer import WordPieceTokenizer, basic_tokenize
from rag_icd10_tpu_torch.parallel import train as ttrain
from rag_icd10_tpu_torch.tools import train_encoder as ttool

# Each class of character the piece split has to treat as basic_tokenize does.
CLASSES = {
    "cjk": "胃",
    "cjk_ext_b": "\U00020001",
    "compat_ideograph": "豈",  # NFD maps it to U+8C48
    "compat_supplement": "\U0002f800",
    "upper_latin": "Q",
    "accented_upper": "É",
    "accented_lower": "ñ",
    "final_sigma": "Σ",
    "digit": "7",
    "ascii_punct": ".",
    "fullwidth_punct": "，",
    "fullwidth_paren": "（",
    "space": " ",
    "tab": "\t",
    "newline": "\n",
    "cr": "\r",
    "nbsp": "\xa0",
    "ideographic_space": "\u3000",
    "line_separator": "\u2028",
    "vertical_tab": "\x0b",
    "form_feed": "\x0c",
    "file_separator": "\x1c",
    "unit_separator": "\x1f",
    "next_line": "\x85",
    "nul": "\x00",
    "replacement": "\ufffd",
    "zero_width_space": "\u200b",
    "combining_acute": "\u0301",
    "lone_surrogate": "\ud800",
    "unknown_letter": "ᚠ",
}
CONTEXTS = ["{c}", "{c}{c}", "ab{c}cd", "{c}abc", "abc{c}", "胃{c}炎", "I93{c}4", "{c}胃 炎{c}"]

ALPHABET = (
    "胃肠炎高血压病级型糖尿疑似" "\U00020001\U0002a700" "豈更塚\U0002f800"
    "ÉéÀàÑñÖöQwERTyΣσ" "0123456789" ".,;:-_()[]/|'\"" "，。（）：；、！"
    "\t\n\r \xa0\u3000" "\x1c\x1d\x1e\x1f\x85\x0b\x0c" "\x00\ufffd\u200b"
    "\u0301\u0308\u0327"
)


def _vocab():
    texts = ["急性胃肠炎", "高血压病3级", "2型糖尿病", "abc def COPD", "I93.4 E11.9"]
    texts += [ALPHABET, "".join(CLASSES.values())]
    return JTok.from_corpus(texts, extra_tokens=["copd", "##pd", "i93", "e11", "##.4"]).vocab


VOCAB = _vocab()


@pytest.fixture()
def tok():
    return WordPieceTokenizer(dict(VOCAB))


@pytest.fixture(scope="module")
def jtok():
    return JTok(dict(VOCAB))


def plain_encode(tok, text, max_length=512):
    """The uncached composition: basic_tokenize, wordpiece, the vocab."""
    ids = [tok.vocab.get(p, tok.unk_id)
           for word in basic_tokenize(text) for p in tok.wordpiece(word)]
    return [tok.cls_id] + ids[: max_length - 2] + [tok.sep_id]


def _assert_same(tok, jtok, text, max_length=512):
    want = plain_encode(tok, text, max_length)
    assert jtok.encode(text, max_length) == want
    assert tok.encode(text, max_length) == want
    assert tok.encode(text, max_length) == want  # now from the memo


def test_separators_are_the_whitespace_basic_tokenize_splits_on():
    want = {chr(c) for c in range(sys.maxunicode + 1)
            if chr(c).isspace() and not ttok._is_control(chr(c))}
    got = {chr(c) for c in range(sys.maxunicode + 1)
           if not ttok._PIECE.fullmatch("a" + chr(c) + "b")
           and not ttok._is_cjk(c)}
    assert got == want


def test_cjk_class_matches_is_cjk():
    cjk = ttok.re.compile(f"[{ttok._CJK_CLASS}]")
    assert all(bool(cjk.fullmatch(chr(c))) == ttok._is_cjk(c)
               for c in range(sys.maxunicode + 1))


@pytest.mark.parametrize("text", ["", "胃", "急性胃肠炎", "豈\U00020001胃", "胃 炎", "胃a", "a胃"])
def test_a_cjk_text_is_its_own_pieces(text):
    if ttok._CJK_TEXT.fullmatch(text):
        assert ttok._PIECE.findall(text) == list(text)
    else:
        assert any(not ttok._is_cjk(ord(ch)) for ch in text)


@pytest.mark.parametrize("context", CONTEXTS)
@pytest.mark.parametrize("name", sorted(CLASSES))
def test_every_character_class_in_every_place(tok, jtok, name, context):
    text = context.format(c=CLASSES[name])
    pieces = ttok._PIECE.findall(text)
    assert [t for p in pieces for t in basic_tokenize(p)] == basic_tokenize(text)
    _assert_same(tok, jtok, text)


@pytest.mark.parametrize("seed", range(6))
def test_random_strings_over_a_mixed_alphabet(tok, jtok, seed):
    rng = random.Random(seed)
    texts = ["".join(rng.choice(ALPHABET) for _ in range(rng.randint(0, 60)))
             for _ in range(300)]
    for text in texts:
        pieces = ttok._PIECE.findall(text)
        assert [t for p in pieces for t in basic_tokenize(p)] == basic_tokenize(text)
        for max_length in (48, 96, 512):
            _assert_same(tok, jtok, text, max_length)
    for kw in (dict(max_length=48, buckets=(48,), pad_batch_to=320),
               dict(max_length=96, buckets=(16, 32, 64)),
               dict(max_length=20)):
        got, want = tok.encode_batch(texts, **kw), jtok.encode_batch(texts, **kw)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("text", [
    "a" * 100, "a" * 101, "A" * 101, "é" * 101, "a" * 60 + "." + "b" * 60,
    "a" * 99 + "\x00" + "a", "a" * 100 + "\x1c" + "a", "a" * 100 + " " + "a",
])
def test_the_hundred_character_unk_rule(tok, jtok, text):
    _assert_same(tok, jtok, text)


@pytest.mark.parametrize("max_length", [48, 96])
@pytest.mark.parametrize("text", ["急性胃肠炎" * 30, "I93.4 " * 40, "胃" * 46, "胃" * 47])
def test_truncation(tok, jtok, text, max_length):
    _assert_same(tok, jtok, text, max_length)
    ids = tok.encode(text, max_length)
    assert len(ids) <= max_length and ids[-1] == tok.sep_id


@pytest.mark.parametrize("kw", [{}, dict(buckets=(8,), max_length=8, pad_batch_to=4)])
def test_empty_text_and_empty_batch(tok, jtok, kw):
    assert tok.encode("") == [tok.cls_id, tok.sep_id] == jtok.encode("")
    for texts in ([], [""], ["", "胃"]):
        for g, w in zip(tok.encode_batch(texts, **kw), jtok.encode_batch(texts, **kw)):
            np.testing.assert_array_equal(g, w)
            assert g.shape == w.shape


def test_triplet_batch_matches_jax(tok, jtok):
    c = synthetic_corpus(120, seed=3)
    a, b, h = list(c.titles[:40]), list(c.semantic_texts[:40]), list(c.titles[40:80])
    g = list(range(40))
    args = (a, b, h, g, g, g)
    kw = dict(seq_a=16, seq_b=32, pad_rows=48, w_b=[1.0] * 40, w_h=[0.8] * 40)
    for _ in range(2):  # a cold memo, then a warm one
        got = ttrain.make_triplet_batch(tok, *args, **kw)
        want = jtrain.make_triplet_batch(jtok, *args, **kw)
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_array_equal(got[key], np.asarray(want[key]), err_msg=key)


@pytest.mark.parametrize("weighted", [False, True])
def test_draw_batch_matches_the_plain_tokenizer(weighted):
    """The same rng draws the same batch through the memo as through the
    JAX package's tokenizer, batch after batch."""
    c = synthetic_corpus(300, seed=5)
    texts = list(c.titles) + list(c.semantic_texts)
    examples, title_ids = ttool.build_examples(c)
    tw = ttool.title_weight_map(c) if weighted else None
    memo_tok = WordPieceTokenizer.from_corpus(texts)
    order = np.random.default_rng(1).permutation(len(examples))
    batches = []
    for t in (memo_tok, JTok(dict(memo_tok.vocab))):
        rng, ids = np.random.default_rng(2), dict(title_ids)
        batches.append([ttool.draw_batch(examples, order[i:i + 32], c.titles, ids, rng, t,
                                         16, 32, 0.5, 0.3, 0.3, 0.1, tw)
                        for i in range(0, 160, 32)])
    for got, want in zip(*batches):
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert memo_tok.memo_stats()["hits"] > memo_tok.memo_stats()["misses"] > 0


def test_past_the_cap_outputs_stay_equal_and_the_memo_stays_at_it(tok, jtok, monkeypatch):
    monkeypatch.setattr(ttok, "MEMO_MAX_PIECES", 5)
    rng = random.Random(7)
    texts = ["".join(rng.choice(ALPHABET) for _ in range(30)) for _ in range(40)]
    for text in texts + texts:
        _assert_same(tok, jtok, text, 48)
    stats = tok.memo_stats()
    assert stats["pieces"] == stats["capacity"] == 5
    assert stats["misses"] > 5


def test_counters_count_every_piece_looked_up(tok):
    texts = ["急性胃肠炎", "I93.4 高血压 COPD", "", "  \x1c "]
    looked = sum(len(ttok._PIECE.findall(t)) for t in texts)
    assert tok.memo_stats() == dict(hits=0, misses=0, hit_share=None, pieces=0,
                                    capacity=ttok.MEMO_MAX_PIECES)
    tok.encode_batch(texts)
    first = tok.memo_stats()
    assert first["hits"] + first["misses"] == looked
    assert first["misses"] == first["pieces"] == len({p for t in texts
                                                       for p in ttok._PIECE.findall(t)})
    tok.encode_batch(texts)
    second = tok.memo_stats()
    assert second["misses"] == first["misses"]
    assert second["hits"] == first["hits"] + looked
    assert ttool.memo_hit_pct(first, second) == 100.0
    assert np.isnan(ttool.memo_hit_pct(second, second))


def test_returned_ids_are_the_callers_own(tok):
    text = "急性胃肠炎 I93.4"
    want = tok.encode(text)
    got = tok.encode(text)
    got[1] = -1
    got.append(-2)
    got.clear()
    assert tok.encode(text) == want
    ids, mask, _ = tok.encode_batch([text])
    ids[:] = -3
    assert tok.encode_batch([text])[0][0, : len(want)].tolist() == want
    assert all(isinstance(v, tuple) for v in tok._memo.values())


def test_stats_endpoint_shows_the_memo(tok):
    """/stats carries the serving encoder's tokenizer memo beside
    ``stage_latency``; an encoder without a tokenizer leaves it out."""
    import asyncio
    import json
    import types

    tok.encode("急性胃肠炎")
    tok.encode("急性胃肠炎")

    def stats(encoder):
        engine = types.SimpleNamespace(store=None, encoder=encoder, llm=None, ner=None,
                                       matcher=None, started_at=0.0)
        server = APIServer(config=tconfig.Config(), engine=engine)
        resp = asyncio.run(server.stats(None))
        assert resp.status == 200
        return json.loads(resp.text)

    encoder = types.SimpleNamespace(tokenizer=tok, get_model_info=lambda: {"device": "cpu"})
    body = stats(encoder)
    assert "stage_latency" in body
    assert body["tokenizer_memo"] == tok.memo_stats()
    assert body["tokenizer_memo"]["hit_share"] == 0.5
    assert "tokenizer_memo" not in stats(types.SimpleNamespace(get_model_info=dict))


def test_basic_tokenize_and_wordpiece_are_the_jax_packages():
    from rag_icd10_tpu.models import tokenizer as jmod

    rng = random.Random(11)
    jt = JTok(dict(VOCAB))
    t = WordPieceTokenizer(dict(VOCAB))
    for _ in range(500):
        text = "".join(rng.choice(ALPHABET) for _ in range(rng.randint(0, 40)))
        words = basic_tokenize(text)
        assert words == jmod.basic_tokenize(text)
        assert [t.wordpiece(w) for w in words] == [jt.wordpiece(w) for w in words]
