"""NER training: the port's tools/train_ner.py against the JAX tool, on
the same seeds and titles, on the CPU.

Tolerances, stated before the comparison:

- Host code (``compose``, ``encode_example``, ``make_batch``,
  ``span_f1``), the title filter, the vocabulary, the training batches and
  the 150 held-out eval sentences: bit for bit.
- Three steps of the token classifier (2 layers, 32 hidden, seq 32, the
  tool's lr 3e-4 and schedule for --steps 10, so the first step runs at
  lr 0) from the same JAX-initialized weights, against the JAX step
  rebuilt here as rag_icd10_tpu/tools/train_ner.py:324-338 writes it
  (closures inside its ``main``):
  - fp32 compute: loss and token accuracy of every step within 1e-5, the
    parameters and the Adam moments within 1e-4, except the attention key
    biases. Their gradient is zero in exact arithmetic (a key bias shifts
    every score of a query alike, and softmax ignores a shift), so each
    side's is rounding noise that Adam normalizes to an update of up to
    the learning rate, of either sign: they are held to 2·Σ lr_t, the
    allowance tests/test_torch_train.py gives them.
  - bf16 compute (fp32 parameters): the first loss within 1e-3, every
    loss within 2e-2 (bf16 rounds at other places on the two sides).
- The whole tool (the JAX ``main`` and the port's ``main(device="cpu")``
  with the same tiny flags over the same CSV): ``vocab.txt`` byte-equal,
  ``config.json`` equal but for ``trained_by``, ``eval.json``'s ``rules``
  block exactly equal (the same sentences through the same rule code);
  each package's service loads the other's directory in model mode, and
  on one directory the two packages' bf16 logits agree within 2e-2.
"""

import dataclasses
import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rag_icd10_tpu.config import NERConfig as JNERConfig
from rag_icd10_tpu.models.bert import BertArch as JArch
from rag_icd10_tpu.models.tokenizer import WordPieceTokenizer as JTok
from rag_icd10_tpu.pipeline.ner import MedicalNERService as JService
from rag_icd10_tpu.pipeline.ner_model import JaxTokenClassifier
from rag_icd10_tpu.pipeline.ner_model import build_token_classifier as jbuild
from rag_icd10_tpu.pipeline.textproc import SEPARATOR_RE as JSEPARATOR_RE
from rag_icd10_tpu.tools import train_ner as jtool
from rag_icd10_tpu_torch.config import NERConfig
from rag_icd10_tpu_torch.data.corpus import synthetic_corpus
from rag_icd10_tpu_torch.parallel.train import warmup_cosine_decay_schedule
from rag_icd10_tpu_torch.pipeline.ner import MedicalNERService
from rag_icd10_tpu_torch.pipeline.ner_model import TorchTokenClassifier
from rag_icd10_tpu_torch.tools import train_ner as ttool

torch.set_num_threads(2)  # the suite runs several test processes at once

TOL_LOSS = 1e-5
TOL_PARAM = 1e-4
TOL_BF16_FIRST = 1e-3
TOL_BF16_LATER = 2e-2
TOL_LOGITS_BF16 = 2e-2
LR, TOTAL_STEPS, SEQ, HIDDEN, LAYERS = 3e-4, 10, 32, 32, 2


@pytest.fixture(scope="module")
def corpus():
    return synthetic_corpus(300, seed=3)


@pytest.fixture(scope="module")
def titles(corpus):
    return ttool.disease_titles(corpus)


def _jax_titles(corpus):
    """rag_icd10_tpu/tools/train_ner.py:284-291."""
    brackets = set("（）()[]")
    return [t for t in corpus.titles
            if 2 <= len(t) <= 14 and JSEPARATOR_RE.search(t) is None
            and not (brackets & set(t))]


def _jax_vocab(titles):
    """rag_icd10_tpu/tools/train_ner.py:296-298."""
    texts = list(titles) + list(jtool.SYMPTOMS) + list(jtool.ANATOMY) + list(jtool.DRUGS)
    texts += ["".join(jtool.TEMPLATES)]
    return JTok.from_corpus(texts)


def _jax_draws(seed, steps, batch, titles):
    """``steps`` batches of the JAX tool's ``draw`` from one generator
    (rag_icd10_tpu/tools/train_ner.py:342-346, a closure inside main)."""
    rng = np.random.default_rng(seed)
    return [[jtool.compose(jtool.TEMPLATES[int(rng.integers(0, len(jtool.TEMPLATES)))], rng,
                           titles) for _ in range(batch)] for _ in range(steps)]


def _draws(seed, steps, batch, titles):
    """The same through the port's ``draw_examples``."""
    rng = np.random.default_rng(seed)
    return [ttool.draw_examples(rng, titles, batch) for _ in range(steps)]


# ----------------------------------------------------------------- host code


def test_constants_match_jax():
    for name in ("LABELS", "SYMPTOMS", "ANATOMY", "DRUGS", "TEMPLATES", "SLOT_LABEL"):
        assert getattr(ttool, name) == getattr(jtool, name), name


def test_title_filter_and_vocab_match_jax(corpus):
    # separators, brackets, one character and 15 characters are filtered out
    extra = SimpleNamespace(titles=["甲乙，丙丁", "戊己（庚）", "甲乙 丙", "心", "高血压",
                                    "一二三四五六七八九十一二三四五", "慢性肾功能不全"])
    for c in (corpus, extra):
        assert ttool.disease_titles(c) == _jax_titles(c)
    titles = ttool.disease_titles(corpus)
    assert ttool.build_vocab(titles).vocab == _jax_vocab(titles).vocab


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_batches_match_jax_bit_for_bit(seed, titles):
    tok, jtok = ttool.build_vocab(titles), _jax_vocab(titles)
    label_to_id = {l: i for i, l in enumerate(ttool.LABELS)}
    got, want = _draws(seed, 4, 16, titles), _jax_draws(seed, 4, 16, titles)
    assert got == want
    for examples in got:
        for segments, labels in examples[:4]:
            assert (ttool.encode_example(tok, segments, labels, label_to_id, SEQ)
                    == jtool.encode_example(jtok, segments, labels, label_to_id, SEQ))
        # seq 16 truncates the longer sentences
        for seq in (SEQ, 16):
            for a, b in zip(ttool.make_batch(tok, examples, label_to_id, seq),
                            jtool.make_batch(jtok, examples, label_to_id, seq)):
                assert a.dtype == b.dtype and np.array_equal(a, b)


def test_eval_sentences_match_jax(titles):
    """The eval's 150 sentences: seed + 999, one template draw then the
    slots, as run_span_eval draws them."""
    assert _draws(0 + 999, 1, 150, titles) == _jax_draws(0 + 999, 1, 150, titles)


@pytest.mark.parametrize("pred,gold", [
    ([], []),
    ([("a", "disease")], []),
    ([], [("a", "disease")]),
    ([("a", "disease"), ("b", "symptom")], [("a", "disease"), ("c", "drug")]),
    ([("a", "disease"), ("a", "disease")], [("a", "disease")]),
])
def test_span_f1_matches_jax(pred, gold):
    assert ttool.span_f1(pred, gold) == jtool.span_f1(pred, gold)


# --------------------------------------------------------------------- steps


def _archs(vocab_size, bf16):
    tarch = ttool.ner_arch(vocab_size, HIDDEN, LAYERS, SEQ)
    jarch = JArch(vocab_size=tarch.vocab_size, hidden_size=tarch.hidden_size,
                  num_layers=tarch.num_layers, num_heads=tarch.num_heads,
                  intermediate_size=tarch.intermediate_size,
                  max_position_embeddings=tarch.max_position_embeddings)
    if not bf16:
        jarch = dataclasses.replace(jarch, compute_dtype=jnp.float32)
        tarch = dataclasses.replace(tarch, compute_dtype=torch.float32)
    return jarch, tarch


def _jax_steps(jarch, params, batches):
    """rag_icd10_tpu/tools/train_ner.py:316-338, the schedule for
    --steps TOTAL_STEPS, over ``batches``."""
    model = jbuild(jarch, num_labels=len(jtool.LABELS))
    schedule = optax.warmup_cosine_decay_schedule(
        0.0, LR, warmup_steps=min(100, TOTAL_STEPS // 10 + 1), decay_steps=TOTAL_STEPS)
    optimizer = optax.adamw(schedule, weight_decay=0.01)
    opt_state = optimizer.init(params)

    def loss_fn(params, ids, mask, tags):
        logits = model.apply({"params": params}, ids, mask, jnp.zeros_like(ids))
        ce = optax.softmax_cross_entropy_with_integer_labels(logits, tags)
        ce = (ce * mask).sum() / jnp.maximum(mask.sum(), 1)
        acc = (jnp.argmax(logits, -1) == tags) * mask
        return ce, acc.sum() / jnp.maximum(mask.sum(), 1)

    @jax.jit
    def train_step(params, opt_state, ids, mask, tags):
        (loss, acc), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params, ids, mask, tags
        )
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss, acc

    losses, accs = [], []
    for ids, mask, tags in batches:
        params, opt_state, loss, acc = train_step(params, opt_state, ids, mask, tags)
        losses.append(float(loss))
        accs.append(float(acc))
    lrs = [float(schedule(i)) for i in range(len(batches))]
    return jax.device_get(params), opt_state, losses, accs, lrs


def _assert_params_close(got, want, lrs):
    bound = 2 * sum(lrs) * (1 + 0.01) + TOL_PARAM
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                            jax.tree_util.tree_leaves(got)):
        name = jax.tree_util.keystr(path)
        err = float(np.max(np.abs(np.asarray(w) - np.asarray(g))))
        limit = bound if "['key']['bias']" in name else TOL_PARAM
        assert err <= limit, (name, err, limit)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_three_steps_match_the_jax_step(bf16, seed, titles):
    tok = ttool.build_vocab(titles)
    label_to_id = {l: i for i, l in enumerate(ttool.LABELS)}
    batches = [ttool.make_batch(tok, ex, label_to_id, SEQ)
               for ex in _draws(seed, 3, 8, titles)]
    jarch, tarch = _archs(tok.vocab_size, bf16)
    dummy = np.zeros((2, SEQ), np.int32)
    params = jbuild(jarch, num_labels=len(jtool.LABELS)).init(
        jax.random.PRNGKey(seed), dummy, dummy, dummy)["params"]
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(params))
    jparams, jstate, jlosses, jaccs, lrs = _jax_steps(jarch, params, batches)

    schedule = warmup_cosine_decay_schedule(0.0, LR, min(100, TOTAL_STEPS // 10 + 1),
                                            TOTAL_STEPS)
    state = ttool.init_ner_state(tarch, schedule, params=params, device="cpu")
    assert all(p.dtype == torch.float32 for p in state.model.parameters())
    out = [ttool.ner_train_step(state, *b) for b in batches]
    tlosses = [float(loss) for loss, _ in out]
    taccs = [float(acc) for _, acc in out]
    assert lrs[0] == 0.0 and state.step == 3
    if bf16:
        assert abs(tlosses[0] - jlosses[0]) <= TOL_BF16_FIRST
        np.testing.assert_allclose(tlosses, jlosses, rtol=0, atol=TOL_BF16_LATER)
        return
    np.testing.assert_allclose(tlosses, jlosses, rtol=0, atol=TOL_LOSS)
    np.testing.assert_allclose(taccs, jaccs, rtol=0, atol=TOL_LOSS)
    _assert_params_close(state.params(), jparams, lrs)
    got, want = state.opt_state_leaves(), jax.tree_util.tree_leaves(jstate)
    assert len(got) == len(want) and int(got[0]) == int(want[0]) == 3
    for g, w in zip(got[1:-1], want[1:-1]):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=TOL_PARAM)


def test_seeded_init_has_the_head_and_the_encoder_of_init_params():
    from rag_icd10_tpu_torch.models.bert import init_params

    arch = ttool.ner_arch(50, HIDDEN, 1, SEQ)
    with_head = init_params(arch, seed=3, num_labels=len(ttool.LABELS))
    plain = init_params(arch, seed=3)
    for a, b in zip(jax.tree_util.tree_leaves(plain["bert"]),
                    jax.tree_util.tree_leaves(with_head["bert"])):
        assert np.array_equal(a, b)
    head = with_head["classifier"]
    assert head["kernel"].shape == (HIDDEN, len(ttool.LABELS))
    assert not head["bias"].any() and 0.1 < head["kernel"].std() * np.sqrt(HIDDEN) < 10
    state = ttool.init_ner_state(arch, 1e-3, seed=3, device="cpu")
    for a, b in zip(jax.tree_util.tree_leaves(state.params()),
                    jax.tree_util.tree_leaves(with_head)):
        assert np.array_equal(a, b)


# ------------------------------------------------------------ the whole tool

ARGS = ["--steps", "5", "--batch", "8", "--seq", str(SEQ), "--hidden", str(HIDDEN),
        "--layers", "1", "--log-every", "5"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory, corpus):
    """The JAX tool and the port's, with the same flags over one CSV."""
    tmp = tmp_path_factory.mktemp("ner")
    csv = tmp / "icd.csv"
    csv.write_text("code,disease\n" + "\n".join(
        f"{r.code},{r.preferred_zh}" for r in corpus.records()), encoding="utf-8")
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv("ICD_DATA_PATH", str(csv))
        mp.setenv("NER_WEIGHTS_PATH", "")  # each run sets it; restored after
        mp.setenv("JAX_COMPILATION_CACHE_DIR",
                  jax.config.jax_compilation_cache_dir or str(tmp / "jax_cache"))
        rcs = {"jax": jtool.main(ARGS + ["--out", str(tmp / "jax")]),
               "torch": ttool.main(ARGS + ["--out", str(tmp / "torch")], device="cpu")}
    finally:
        mp.undo()
    return tmp, rcs


def test_both_tools_write_the_same_files(runs):
    tmp, rcs = runs
    assert rcs == {"jax": 0, "torch": 0}
    j, t = tmp / "jax", tmp / "torch"
    for name in ("params.npz", "config.json", "vocab.txt", "eval.json"):
        assert (j / name).exists() and (t / name).exists(), name
    assert (j / "vocab.txt").read_bytes() == (t / "vocab.txt").read_bytes()
    jcfg, tcfg = (json.loads((d / "config.json").read_text()) for d in (j, t))
    assert tcfg.pop("trained_by") == "rag_icd10_tpu_torch.tools.train_ner (rule-NER distillation)"
    jcfg.pop("trained_by")
    assert tcfg == jcfg
    jeval, teval = (json.loads((d / "eval.json").read_text()) for d in (j, t))
    assert set(teval) == set(jeval) == {"model", "rules", "note"}
    assert teval["rules"] == jeval["rules"] and teval["note"] == jeval["note"]
    assert set(teval["model"]) == {"precision", "recall", "f1"}


@pytest.mark.parametrize("owner", ["jax", "torch"])
def test_each_package_serves_the_others_directory(runs, owner, monkeypatch):
    tmp, _ = runs
    d = tmp / owner
    monkeypatch.setenv("NER_WEIGHTS_PATH", str(d))
    tsvc = MedicalNERService(NERConfig(use_model=True), device="cpu")
    jsvc = JService(JNERConfig(use_model=True))
    assert tsvc.use_model and tsvc._model is not None, tsvc.fallback_reason
    assert jsvc.use_model and jsvc._model is not None
    text = "患者诊断为急性胃肠炎，伴腹痛"
    assert isinstance(tsvc.extract_medical_entities(text, filter_drugs=False), dict)
    assert tsvc.stats()["rule_fallbacks"] == 0
    # one directory, both packages' bf16 forwards
    tclf = TorchTokenClassifier.from_weights(str(d), device="cpu")
    jclf = JaxTokenClassifier.from_weights(str(d))
    _, _, ids, mask = tclf.encode(text)
    with torch.inference_mode():
        ids_t = torch.from_numpy(ids).long()
        tl = tclf.model(ids_t, torch.from_numpy(mask).long(), torch.zeros_like(ids_t)).numpy()
    jl = np.asarray(jclf.model.apply({"params": jclf.params}, ids, mask, np.zeros_like(ids)))
    assert tl.shape == jl.shape == (1, ids.shape[1], len(ttool.LABELS))
    assert float(np.abs(tl - jl).max()) <= TOL_LOGITS_BF16


def test_eval_only_reports_weights_that_do_not_load(tmp_path, monkeypatch):
    monkeypatch.setenv("ICD_DATA_PATH", str(tmp_path / "absent.csv"))  # synthetic fallback
    monkeypatch.setenv("NER_WEIGHTS_PATH", "")
    assert ttool.main(["--eval-only", "--out", str(tmp_path / "none")], device="cpu") == 1
    assert not (tmp_path / "none" / "eval.json").exists()

