"""NER model mode of the port against the JAX package, on the CPU.

- One converted directory (params.npz + config.json + vocab.txt, seeded
  weights: 2 layers, 32 hidden, the 9 labels of tools/train_ner.py),
  written with the port's converter functions, loads in both packages.
  At fp32 compute in both, the per-token probabilities agree within 1e-5
  (fp32 forwards, sums in another order), the spans
  (text, label, start, end) are identical and their scores within 1e-5.
- An HF BertForTokenClassification converted by the port's converter
  reproduces transformers' logits within 1e-4 (the JAX package's own
  test's tolerance; fp32 both sides, GELU and LayerNorm spelled
  differently) and gives the same files as the JAX converter.
- MedicalNERService in model mode gives the same entities in both
  packages; text past the position table is cut as in the JAX package;
  no weights or unreadable weights degrade to rules, counted; a device
  error raises instead of degrading.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_icd10_tpu.config import NERConfig as JNERConfig
from rag_icd10_tpu.models.bert import BertArch as JArch
from rag_icd10_tpu.models.convert_hf import load_params as jload_params
from rag_icd10_tpu.models.tokenizer import WordPieceTokenizer as JTokenizer
from rag_icd10_tpu.pipeline.ner import MedicalNERService as JService
from rag_icd10_tpu.pipeline.ner_model import JaxTokenClassifier
from rag_icd10_tpu.pipeline.ner_model import (
    convert_hf_token_classifier as jconvert_hf_token_classifier,
)
from rag_icd10_tpu_torch.config import NERConfig
from rag_icd10_tpu_torch.models.bert import BertArch, init_params
from rag_icd10_tpu_torch.models.convert_hf import save_params
from rag_icd10_tpu_torch.models.tokenizer import WordPieceTokenizer
from rag_icd10_tpu_torch.pipeline.ner import MedicalNERService
from rag_icd10_tpu_torch.pipeline.ner_model import (
    TorchTokenClassifier,
    convert_hf_token_classifier,
)

torch.set_num_threads(2)  # the suite runs several test processes at once

LABELS = (  # rag_icd10_tpu/tools/train_ner.py:39-45
    "O",
    "B-Disease", "I-Disease",
    "B-Symptom", "I-Symptom",
    "B-BodyParts", "I-BodyParts",
    "B-Drug", "I-Drug",
)
TEXTS = [
    "急性胃肠炎伴腹痛发热",
    "高血压病3级，2型糖尿病",
    "患者反复咳嗽，胸痛三天，考虑肺部感染",
    "慢性阻塞性肺疾病急性加重期伴呼吸衰竭",
]
SMALL = dict(hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
             max_position_embeddings=64)
TOL = 1e-5


def _write_dir(root, seed=0, **arch_kwargs):
    """A converted NER directory with seeded weights, written with the
    port's functions."""
    tok = WordPieceTokenizer.from_corpus(TEXTS)
    kwargs = dict(SMALL, **arch_kwargs)
    arch = BertArch(vocab_size=tok.vocab_size, **kwargs)
    params = init_params(arch, seed=seed)
    rng = np.random.default_rng(seed + 1)
    params["classifier"] = {
        "kernel": rng.standard_normal((arch.hidden_size, len(LABELS)), dtype=np.float32),
        "bias": rng.standard_normal(len(LABELS), dtype=np.float32) * np.float32(0.1),
    }
    root.mkdir(parents=True, exist_ok=True)
    save_params(params, str(root / "params.npz"))
    tok.save_vocab(str(root / "vocab.txt"))
    config = {
        "vocab_size": tok.vocab_size,
        "hidden_size": kwargs["hidden_size"],
        "num_hidden_layers": kwargs["num_layers"],
        "num_attention_heads": kwargs["num_heads"],
        "intermediate_size": kwargs["intermediate_size"],
        "max_position_embeddings": kwargs["max_position_embeddings"],
        "id2label": {str(i): label for i, label in enumerate(LABELS)},
    }
    (root / "config.json").write_text(json.dumps(config))
    return root


def _jax_fp32(weights_dir):
    """The JAX package's classifier over the same files at fp32 compute
    (its from_weights builds the bf16 default)."""
    config = json.loads((weights_dir / "config.json").read_text())
    arch = JArch(
        vocab_size=config["vocab_size"], hidden_size=config["hidden_size"],
        num_layers=config["num_hidden_layers"], num_heads=config["num_attention_heads"],
        intermediate_size=config["intermediate_size"],
        max_position_embeddings=config["max_position_embeddings"],
        compute_dtype=jnp.float32,
    )
    return JaxTokenClassifier(
        arch, jload_params(str(weights_dir / "params.npz")), config["id2label"],
        JTokenizer.from_vocab_file(str(weights_dir / "vocab.txt")),
    )


def _port_fp32(weights_dir):
    return TorchTokenClassifier.from_weights(
        str(weights_dir), device="cpu", compute_dtype=torch.float32
    )


@pytest.fixture(scope="module")
def ner_dir(tmp_path_factory):
    return _write_dir(tmp_path_factory.mktemp("ner"))


@pytest.mark.parametrize("text", TEXTS)
def test_probabilities_match_jax(ner_dir, text):
    jclf, tclf = _jax_fp32(ner_dir), _port_fp32(ner_dir)
    _, _, ids, mask = tclf.encode(text)
    want = np.asarray(jclf._jit(jclf.params, ids, mask, np.zeros_like(ids)))
    got = tclf.probabilities(ids, mask)
    assert got.shape == want.shape == (1, ids.shape[1], len(LABELS))
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    assert tclf.forwards == 1


@pytest.mark.parametrize("text", TEXTS)
def test_spans_match_jax(ner_dir, text):
    want = _jax_fp32(ner_dir).predict(text)
    got = _port_fp32(ner_dir).predict(text)
    assert [(t, lab, s, e) for t, lab, _, s, e in got] == [
        (t, lab, s, e) for t, lab, _, s, e in want
    ]
    np.testing.assert_allclose(
        [sc for _, _, sc, _, _ in got], [sc for _, _, sc, _, _ in want], atol=TOL
    )
    assert got, "seeded weights give at least one span"


def test_truncation_past_position_table(tmp_path):
    """A text longer than the position table (16) is cut to 14 tokens in
    both packages; no position past the table is looked up."""
    d = _write_dir(tmp_path / "short", max_position_embeddings=16)
    text = "".join(TEXTS)
    tclf = _port_fp32(d)
    tokens, offsets, ids, _ = tclf.encode(text)
    assert len(tokens) == 14 and ids.shape == (1, 16)
    want = _jax_fp32(d).predict(text)
    got = tclf.predict(text)
    assert [(t, lab, s, e) for t, lab, _, s, e in got] == [
        (t, lab, s, e) for t, lab, _, s, e in want
    ]
    assert all(e <= offsets[-1][1] for *_, e in got)


def test_vocab_past_embedding_table_is_refused(tmp_path):
    """flax clamps an out-of-range id; nn.Embedding would raise (a
    device-side assert on the card): the port refuses such a directory
    at load."""
    d = _write_dir(tmp_path / "bad")
    config = json.loads((d / "config.json").read_text())
    config["vocab_size"] -= 1
    (d / "config.json").write_text(json.dumps(config))
    with pytest.raises(ValueError, match="embedding"):
        TorchTokenClassifier.from_weights(str(d), device="cpu")


def _entity_tuples(ents):
    return {
        etype: [(e["text"], e["start"], e["end"], e["original_label"], e["source"])
                for e in elist]
        for etype, elist in ents.items()
    }


@pytest.mark.parametrize("filter_drugs", [True, False])
def test_service_model_mode_matches_jax(ner_dir, monkeypatch, filter_drugs):
    monkeypatch.setenv("NER_WEIGHTS_PATH", str(ner_dir))
    jsvc = JService(JNERConfig(use_model=True, min_confidence=0.2))
    tsvc = MedicalNERService(NERConfig(use_model=True, min_confidence=0.2), device="cpu")
    assert jsvc.use_model and tsvc.use_model and tsvc._model is not None
    # both at fp32 compute, so the entities can be held equal
    jsvc._model, tsvc._model = _jax_fp32(ner_dir), _port_fp32(ner_dir)
    n_model = 0
    for text in TEXTS:
        want = jsvc.extract_medical_entities(text, filter_drugs=filter_drugs)
        got = tsvc.extract_medical_entities(text, filter_drugs=filter_drugs)
        assert _entity_tuples(got) == _entity_tuples(want), text
        for etype in want:
            np.testing.assert_allclose(
                [e["confidence"] for e in got[etype]],
                [e["confidence"] for e in want[etype]], atol=TOL,
            )
        n_model += sum(len(v) for v in got.values())
    assert n_model > 0
    assert tsvc.get_model_info().keys() == jsvc.get_model_info().keys()
    info = tsvc.stats()
    assert info["model_extractions"] == len(TEXTS) and info["rule_fallbacks"] == 0
    assert info["model_forwards"] == len(TEXTS) and info["device"] == "cpu"


def test_service_default_classifier_runs_bf16(ner_dir, monkeypatch):
    """Served as the JAX package serves it: bf16 dense layers."""
    monkeypatch.setenv("NER_WEIGHTS_PATH", str(ner_dir))
    svc = MedicalNERService(NERConfig(use_model=True), device="cpu")
    assert svc._model.arch.compute_dtype == torch.bfloat16
    ents = svc.extract_medical_entities(TEXTS[0], filter_drugs=False)
    for elist in ents.values():
        for e in elist:
            assert e["source"] == "model" and 0.0 <= e["confidence"] <= 1.0
    assert svc.counts() == {"model_extractions": 1, "rule_fallbacks": 0}


def test_degrades_to_rules_without_weights(monkeypatch, tmp_path):
    monkeypatch.delenv("NER_WEIGHTS_PATH", raising=False)
    for svc in (JService(JNERConfig(use_model=True)),
                MedicalNERService(NERConfig(use_model=True), device="cpu")):
        assert not svc.use_model and svc._model is None
    tsvc = MedicalNERService(NERConfig(use_model=True), device="cpu")
    jsvc = JService(JNERConfig(use_model=True))
    for text in TEXTS:
        assert tsvc.extract_medical_entities(text) == jsvc.extract_medical_entities(text)
    assert tsvc.counts() == {"model_extractions": 0, "rule_fallbacks": len(TEXTS)}
    assert tsvc.stats()["fallback_reason"] == "NER_WEIGHTS_PATH not set"
    # a directory that cannot be read degrades the same way, with its reason
    monkeypatch.setenv("NER_WEIGHTS_PATH", str(tmp_path / "missing"))
    tsvc = MedicalNERService(NERConfig(use_model=True), device="cpu")
    assert not tsvc.use_model and "unreadable" in tsvc.fallback_reason
    assert not JService(JNERConfig(use_model=True)).use_model
    # rule mode asked for: rules, and no fallback counted
    rules = MedicalNERService(NERConfig(use_model=False), device="cpu")
    rules.extract_medical_entities(TEXTS[0])
    assert rules.counts() == {"model_extractions": 0, "rule_fallbacks": 0}


def test_predict_failure_falls_back_counted_device_error_raises(ner_dir, monkeypatch):
    monkeypatch.setenv("NER_WEIGHTS_PATH", str(ner_dir))
    svc = MedicalNERService(NERConfig(use_model=True), device="cpu")

    def broken(text):
        raise ValueError("tokenizer fault")

    monkeypatch.setattr(svc._model, "predict", broken)
    assert svc.extract_medical_entities(TEXTS[0]) == MedicalNERService(
        NERConfig(use_model=False), device="cpu").extract_medical_entities(TEXTS[0])
    assert svc.counts()["rule_fallbacks"] == 1

    def device_fault(text):
        raise RuntimeError("CUDA error: device-side assert triggered")

    monkeypatch.setattr(svc._model, "predict", device_fault)
    with pytest.raises(RuntimeError, match="CUDA error"):
        svc.extract_medical_entities(TEXTS[0])
    assert svc.counts()["rule_fallbacks"] == 1


def test_cuda_asked_without_a_card_raises(ner_dir, monkeypatch):
    """Loading onto a device that is not there is a device error: it
    raises instead of degrading to rules (skipped where a card exists)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: cuda loads")
    monkeypatch.setenv("NER_WEIGHTS_PATH", str(ner_dir))
    with pytest.raises(RuntimeError, match="cuda"):
        MedicalNERService(NERConfig(use_model=True))


@pytest.fixture(scope="module")
def hf_checkpoint(tmp_path_factory):
    """Randomly-initialized tiny HF token classifier saved to disk (as
    tests/test_ner_model.py builds it)."""
    transformers = pytest.importorskip("transformers")
    d = tmp_path_factory.mktemp("hf_ner")
    tok = WordPieceTokenizer.from_corpus(TEXTS)
    tok.save_vocab(str(d / "vocab.txt"))
    cfg = transformers.BertConfig(
        vocab_size=tok.vocab_size, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=2, intermediate_size=64, max_position_embeddings=64,
        num_labels=len(LABELS),
        id2label=dict(enumerate(LABELS)),
        label2id={label: i for i, label in enumerate(LABELS)},
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
    )
    torch.manual_seed(3)
    model = transformers.BertForTokenClassification(cfg).eval()
    model.save_pretrained(str(d), safe_serialization=False)
    return d


def test_hf_conversion_matches_transformers_and_jax(hf_checkpoint, tmp_path):
    transformers = pytest.importorskip("transformers")
    out, jout = tmp_path / "port", tmp_path / "jax"
    convert_hf_token_classifier(str(hf_checkpoint), str(out))
    jconvert_hf_token_classifier(str(hf_checkpoint), str(jout))
    got, want = np.load(out / "params.npz"), np.load(jout / "params.npz")
    assert sorted(got.files) == sorted(want.files)
    for key in want.files:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert json.loads((out / "config.json").read_text()) == json.loads(
        (jout / "config.json").read_text())

    clf = _port_fp32(out)
    hf_model = transformers.BertForTokenClassification.from_pretrained(
        str(hf_checkpoint)).eval()
    ids = np.array([[2, 5, 6, 7, 3, 0, 0, 0]], dtype=np.int64)
    mask = (np.arange(8) < 5).astype(np.int64)[None, :]
    with torch.no_grad():
        hf_logits = hf_model(
            input_ids=torch.from_numpy(ids), attention_mask=torch.from_numpy(mask)
        ).logits.numpy()
        ours = clf.model(torch.from_numpy(ids), torch.from_numpy(mask),
                         torch.zeros_like(torch.from_numpy(ids))).numpy()
    np.testing.assert_allclose(ours[:, :5], hf_logits[:, :5], atol=1e-4)
