"""The port's fused encode+search engine against the JAX package's, on the
CPU (mirrors tests/test_fused_query.py).

Both engines run the same tiny fp32 BERT (the JAX encoder's parameters
loaded into the port's) over the same store vectors. The JAX engine on
the CPU runs its ``jnp.dot`` path (rag_icd10_tpu/ops/fused_query.py:93-100)
and ``lax.top_k``; the port's runs the same chain eagerly with the
kernels' plain versions (on the card it is one CUDA graph replay per
bucket, tests/test_torch_cuda_fused.py).

- Embeddings within 1e-5 (fp32 forwards, sums in another order); values
  within 1e-5 and the same ids, compared as index sets where scores tie,
  for exact, approx and streaming at k = 8 and 16, over fp32 and bf16
  residency.
- The orchestrator takes the fused path under FUSED_QUERY=1 (stage
  "encode+search(fused)", no "encode") and gives the JAX orchestrator's
  candidates; a swapped store or encoder drops the engine; a mock
  encoder, int8 or host residency and an HNSW index fall back to the
  two-step path; a per-request method forces it.
"""

import dataclasses

import numpy as np
import pytest
import torch

from test_orchestrator import CORPUS_ROWS, MockEncoder

from rag_icd10_tpu.config import EncoderConfig as JEncoderConfig
from rag_icd10_tpu.config import NERConfig as JNERConfig
from rag_icd10_tpu.config import StoreConfig as JStoreConfig
from rag_icd10_tpu.data.corpus import ICDCorpus as JCorpus
from rag_icd10_tpu.data.corpus import synthetic_corpus
from rag_icd10_tpu.index import VectorStore as JStore
from rag_icd10_tpu.models.encoder import TextEncoder as JEncoder
from rag_icd10_tpu.models.tokenizer import WordPieceTokenizer as JTokenizer
from rag_icd10_tpu.ops.fused_query import FusedQueryEngine as JEngine
from rag_icd10_tpu.pipeline.ner import MedicalNERService as JNER
from rag_icd10_tpu.pipeline.orchestrator import MultiDiagnosisService as JService
from rag_icd10_tpu.pipeline.textproc import DiagnosisTextProcessor as JText
from rag_icd10_tpu.utils.metrics import metrics as jmetrics
from rag_icd10_tpu_torch.config import EncoderConfig, NERConfig, StoreConfig
from rag_icd10_tpu_torch.data.corpus import ICDCorpus
from rag_icd10_tpu_torch.index.vector_store import VectorStore
from rag_icd10_tpu_torch.models.encoder import TextEncoder
from rag_icd10_tpu_torch.models.tokenizer import WordPieceTokenizer
from rag_icd10_tpu_torch.ops import fused_score
from rag_icd10_tpu_torch.ops.fused_query import FusedQueryEngine, replay_launches
from rag_icd10_tpu_torch.pipeline.ner import MedicalNERService
from rag_icd10_tpu_torch.pipeline.orchestrator import MultiDiagnosisService
from rag_icd10_tpu_torch.pipeline.textproc import DiagnosisTextProcessor
from rag_icd10_tpu_torch.utils.metrics import metrics

torch.set_num_threads(2)  # the suite runs several test processes at once

TINY = dict(
    hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128,
    max_position_embeddings=64, vocab_size=256, dtype="float32",
    max_length=64, length_buckets=(16, 32, 64),
)
TEXTS = ["急性胃肠炎", "高血压病3级", "慢性肝炎", "疑似肺部感染", "2型糖尿病",
         "复发性胃溃疡", "急性心梗死", "肾功能不全", "冠状动脉粥样硬化性心脏病"]
TOL = 1e-5


def _rows():
    syn = synthetic_corpus(300)
    return CORPUS_ROWS + [{"code": c, "disease": t} for c, t in zip(syn.codes, syn.titles)]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Both packages' encoders (same weights, same vocab) and fp32 stores
    over the same vectors."""
    root = tmp_path_factory.mktemp("fused")
    jcorpus = JCorpus.from_rows(_rows())
    jtok = JTokenizer.from_corpus(jcorpus.titles + jcorpus.semantic_texts)
    jtok.save_vocab(str(root / "vocab.txt"))
    jenc = JEncoder(JEncoderConfig(**TINY), tokenizer=jtok)
    vecs = jenc.encode_batch(jcorpus.semantic_texts, kind="query")
    jstore = JStore(dim=64, config=JStoreConfig(pad_multiple=128))
    jstore.insert_records(list(jcorpus.records()), vecs)
    jstore.load_collection()

    corpus = ICDCorpus.from_rows(_rows())
    tok = WordPieceTokenizer.from_vocab_file(str(root / "vocab.txt"))
    enc = TextEncoder(EncoderConfig(**TINY), tokenizer=tok, params=jenc.params, device="cpu")
    store = VectorStore(dim=64, config=StoreConfig(pad_multiple=128), device="cpu")
    store.insert_records(list(corpus.records()), vecs)
    store.load_collection()
    return jenc, jstore, enc, store, vecs


def _bf16_stores(setup):
    jenc, _, enc, store, vecs = setup
    jstore = JStore(dim=64, config=JStoreConfig(pad_multiple=128, device_dtype="bfloat16"))
    jstore.insert_records(list(JCorpus.from_rows(_rows()).records()), vecs)
    jstore.load_collection()
    tstore = VectorStore(dim=64, config=dataclasses.replace(
        store.config, device_dtype="bfloat16"), device="cpu")
    tstore.insert_records(list(ICDCorpus.from_rows(_rows()).records()), vecs)
    tstore.load_collection()
    return jstore, tstore


def _same_topk(got_vals, got_idx, want_vals, want_idx, what):
    """Values within TOL; ids equal, or the same set among equal scores."""
    np.testing.assert_allclose(got_vals, want_vals, atol=TOL, err_msg=what)
    for gv, gi, wi in zip(got_vals, got_idx, want_idx):
        if list(gi) == list(wi):
            continue
        # a permutation among ties: the same ids above the k-th value
        kth = gv[-1]
        keep = gv > kth + TOL
        assert set(gi[keep]) == set(wi[keep]), what


def test_supports_real_encoder_only(setup):
    jenc, jstore, enc, store, _ = setup
    assert JEngine.supports(jenc, jstore) and FusedQueryEngine.supports(enc, store)
    assert not FusedQueryEngine.supports(MockEncoder(), store)
    int8 = VectorStore(dim=64, config=StoreConfig(device_dtype="int8"), device="cpu")
    host = VectorStore(dim=64, config=StoreConfig(device_dtype="host"), device="cpu")
    hnsw = VectorStore(dim=64, config=StoreConfig(index_type="HNSW"), device="cpu")
    for other in (int8, host, hnsw):
        other.insert_records(list(store.corpus.records()), store._vectors)
        other.load_collection()
        assert not FusedQueryEngine.supports(enc, other), other.config


@pytest.mark.parametrize("residency", ["float32", "bfloat16"])
@pytest.mark.parametrize("method", ["exact", "approx", "streaming"])
@pytest.mark.parametrize("k", [8, 16])
def test_fused_matches_jax_engine(setup, residency, method, k):
    jenc, jstore, enc, store, _ = setup
    if residency == "bfloat16":
        jstore, store = _bf16_stores(setup)
    texts = TEXTS[:2] if k == 8 else TEXTS  # 8 and 16 padded rows
    jemb, jvals, jidx = JEngine(jenc, jstore).query(texts, k=k, method=method)
    engine = FusedQueryEngine(enc, store)
    emb, vals, idx = engine.query(texts, k=k, method=method)
    assert emb.shape == jemb.shape and vals.shape == (len(texts), k)
    assert idx.dtype == np.int32
    np.testing.assert_allclose(emb, np.asarray(jemb), atol=TOL)
    _same_topk(vals, idx, np.asarray(jvals), np.asarray(jidx), f"{method} {residency}")
    stats = engine.stats()
    assert stats["eager"] == 1 and stats["replays"] == 0 and stats["graphs"] == 0
    assert stats["queries"] == len(texts)
    if method == "streaming":  # certified at depth S = k, never redone
        assert stats["certified"] == stats["streaming_queries"] == len(texts)
        assert stats["redos"] == 0


def test_fused_matches_two_step(setup):
    _, _, enc, store, _ = setup
    emb_f, vals_f, idx_f = FusedQueryEngine(enc, store).query(TEXTS[:3], k=8)
    emb_s = enc.encode_queries(TEXTS[:3])
    hits = store.search(emb_s, top_k=8)
    np.testing.assert_allclose(emb_f, emb_s, atol=TOL)
    for i, row in enumerate(hits):
        assert [h.id for h in row] == idx_f[i][: len(row)].tolist()
        np.testing.assert_allclose([h.score for h in row], vals_f[i][: len(row)], atol=TOL)


def test_cpu_engine_launches_nothing(setup):
    _, _, enc, store, _ = setup
    before = fused_score.launch_counts()
    FusedQueryEngine(enc, store).query(TEXTS[:2], k=8, method="streaming")
    assert fused_score.launch_counts() == before  # CPU tensors: plain versions
    assert replay_launches(8, "exact") == (1, 0, 0)
    assert replay_launches(128, "streaming") == (0, 1, 0)
    assert replay_launches(256, "streaming") == (1, 0, 1)


def test_reload_rebinds_the_engine(setup):
    """A release and reload gives the store new device arrays: the engine
    drops what it bound to the old ones and serves from the new."""
    _, _, enc, store, _ = setup
    engine = FusedQueryEngine(enc, store)
    _, want_vals, want_idx = engine.query(TEXTS[:2], k=8)
    old = engine._bound
    store.release_collection()
    with pytest.raises(RuntimeError, match="not resident"):
        engine.query(TEXTS[:2], k=8)
    store.load_collection()
    _, vals, idx = engine.query(TEXTS[:2], k=8)
    assert engine._bound[0]() is store._dev["corpus"] and old[0]() is None
    np.testing.assert_array_equal(idx, want_idx)
    np.testing.assert_array_equal(vals, want_vals)


def _services(jenc, jstore, enc, store):
    jner = JNER(JNERConfig(use_model=False))
    ner = MedicalNERService(NERConfig(use_model=False), device="cpu")
    jsvc = JService(encoder=jenc, store=jstore, ner_service=jner,
                    text_processor=JText(use_enhanced_processing=True, ner_service=jner))
    svc = MultiDiagnosisService(
        encoder=enc, store=store, ner_service=ner,
        text_processor=DiagnosisTextProcessor(use_enhanced_processing=True, ner_service=ner))
    return jsvc, svc


def test_orchestrator_uses_fused_path(setup, monkeypatch):
    monkeypatch.setenv("FUSED_QUERY", "1")
    jsvc, svc = _services(*setup[:4])
    assert jsvc._fused_engine() is not None and svc._fused_engine() is not None
    for text in ("急性胃肠炎，高血压病3级", "疑似肺部感染，2型糖尿病"):
        jmetrics.reset()
        metrics.reset()
        want = jsvc.match_multiple_diagnoses(text, top_k=5)
        got = svc.match_multiple_diagnoses(text, top_k=5)
        for snap in (jmetrics.snapshot(), metrics.snapshot()):
            assert "encode+search(fused)" in snap
            assert "encode" not in snap and "search" not in snap  # two-step not taken
        assert got["extracted_diagnoses"] == want["extracted_diagnoses"]
        assert got["total_matches"] == want["total_matches"] > 0
        for gm, wm in zip(got["matches"], want["matches"]):
            assert [c.code for c in gm.candidates] == [c.code for c in wm.candidates]
            np.testing.assert_allclose([c.score for c in gm.candidates],
                                       [c.score for c in wm.candidates], atol=1e-4)
    assert svc._fused.stats()["queries"] > 0


def test_per_request_method_forces_two_step(setup, monkeypatch):
    monkeypatch.setenv("FUSED_QUERY", "1")
    _, svc = _services(*setup[:4])
    metrics.reset()
    svc.match_many_texts(["急性胃肠炎"], top_k=5, search_method="streaming")
    snap = metrics.snapshot()
    assert "encode" in snap and "encode+search(fused)" not in snap


@pytest.mark.parametrize("residency", ["int8", "host"])
def test_unsupported_residency_falls_back(setup, monkeypatch, residency):
    monkeypatch.setenv("FUSED_QUERY", "1")
    _, _, enc, store, vecs = setup
    other = VectorStore(dim=64, config=StoreConfig(pad_multiple=128, device_dtype=residency),
                        device="cpu")
    other.insert_records(list(store.corpus.records()), vecs)
    _, svc = _services(setup[0], setup[1], enc, other)
    assert svc._fused_engine() is None and other.is_loaded
    metrics.reset()
    assert svc.match_multiple_diagnoses("急性胃肠炎", top_k=3)["total_matches"] > 0
    assert "encode+search(fused)" not in metrics.snapshot()


def test_mock_encoder_falls_back(monkeypatch):
    monkeypatch.setenv("FUSED_QUERY", "1")
    corpus = ICDCorpus.from_rows(CORPUS_ROWS)
    enc = MockEncoder()
    store = VectorStore(dim=64, config=StoreConfig(pad_multiple=128), device="cpu")
    store.insert_records(list(corpus.records()), enc.encode_queries(corpus.semantic_texts))
    ner = MedicalNERService(NERConfig(use_model=False), device="cpu")
    svc = MultiDiagnosisService(
        encoder=enc, store=store, ner_service=ner,
        text_processor=DiagnosisTextProcessor(use_enhanced_processing=True, ner_service=ner))
    assert svc._fused_engine() is None
    assert svc.match_multiple_diagnoses("急性胃肠炎", top_k=3)["total_matches"] > 0


def test_store_swap_invalidates_engine(setup, monkeypatch):
    monkeypatch.setenv("FUSED_QUERY", "1")
    _, _, enc, store, vecs = setup
    _, svc = _services(*setup[:4])
    first = svc._fused_engine()
    assert first is not None and first.store is store
    store2 = VectorStore(dim=64, config=StoreConfig(pad_multiple=128), device="cpu")
    store2.insert_records(list(store.corpus.records()), vecs)
    store2.load_collection()
    svc.store = store2
    second = svc._fused_engine()
    assert second is not None and second is not first and second.store is store2
    assert svc.match_multiple_diagnoses("急性胃肠炎", top_k=3)["total_matches"] > 0


def test_encoder_swap_invalidates_engine(setup, monkeypatch):
    monkeypatch.setenv("FUSED_QUERY", "1")
    jenc, _, enc, store, _ = setup
    _, svc = _services(*setup[:4])
    first = svc._fused_engine()
    enc2 = TextEncoder(EncoderConfig(**TINY), tokenizer=enc.tokenizer,
                       params=jenc.params, device="cpu")
    svc.encoder = enc2
    second = svc._fused_engine()
    assert second is not first and second.encoder is enc2
