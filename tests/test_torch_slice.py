"""The /query slice end to end: the port's Engine and API server against
the JAX package's, on the CPU.

- Both Engines start from the same files, as a deployment would: a small
  BERT weights file, a vocab file, the ``<db>.encoder.json`` sidecar and a
  store whose vectors the JAX encoder computed. ``match_many_texts`` must
  give the same extracted diagnoses, the same candidate codes (up to
  ties) and scores within 1e-4 at float32 encoder dtype (fp32 forwards
  and scans; the 1e-4 covers the rescoring stack's sums over them).
- The port's APIServer answers /query and /health through aiohttp's
  TestClient; /query with ``search_method`` "streaming", "chunkstream" or
  "fast" gives the candidates of "exact", and what is still not ported
  (``STORE_SHARDED=on``) gives 400. Every method and residency of the
  third slice answers /query.
- The four tests/golden/*.json API fixtures reproduce through the port's
  store with the deterministic MockEncoder, built as tests/test_api.py
  builds the JAX engine.
"""

import asyncio
import dataclasses
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

import test_api
import test_golden_api as golden
from test_orchestrator import CORPUS_ROWS, MockEncoder

from rag_icd10_tpu import config as jconfig
from rag_icd10_tpu.data.corpus import ICDCorpus as JCorpus
from rag_icd10_tpu.data.corpus import synthetic_corpus
from rag_icd10_tpu.index.vector_store import VectorStore as JStore
from rag_icd10_tpu.models.bert import BertArch as JArch
from rag_icd10_tpu.models.bert import init_params as jinit
from rag_icd10_tpu.models.convert_hf import save_params
from rag_icd10_tpu.models.encoder import TextEncoder as JEncoder
from rag_icd10_tpu.models.tokenizer import WordPieceTokenizer as JTokenizer
from rag_icd10_tpu.runtime import Engine as JEngine
from rag_icd10_tpu_torch import config as tconfig
from rag_icd10_tpu_torch.api.app import APIServer
from rag_icd10_tpu_torch.data.corpus import ICDCorpus
from rag_icd10_tpu_torch.index.remote_store import RemoteVectorStore
from rag_icd10_tpu_torch.index.vector_store import VectorStore
from rag_icd10_tpu_torch.ops.fused_score import fused_weighted_scores
from rag_icd10_tpu_torch.pipeline.ner import MedicalNERService
from rag_icd10_tpu_torch.pipeline.orchestrator import MultiDiagnosisService
from rag_icd10_tpu_torch.pipeline.textproc import DiagnosisTextProcessor
from rag_icd10_tpu_torch.runtime import Engine

torch.set_num_threads(2)  # the suite runs several test processes at once

TEXTS = [
    "急性胃肠炎",
    "急性胃肠炎，高血压病3级",
    "慢性肝炎0003",
    "疑似2型糖尿病，肺炎",
]
SMALL = dict(hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128)


def _rows():
    syn = synthetic_corpus(160)
    return CORPUS_ROWS + [
        {"code": c, "disease": t} for c, t in zip(syn.codes, syn.titles)
    ]


@pytest.fixture(scope="module")
def deployment(tmp_path_factory):
    """Files of a small deployment, written with the JAX package."""
    root = tmp_path_factory.mktemp("deploy")
    corpus = JCorpus.from_rows(_rows())
    tok = JTokenizer.from_corpus(corpus.titles + corpus.semantic_texts)
    vocab = str(root / "vocab.txt")
    tok.save_vocab(vocab)
    enc_kwargs = dict(SMALL, vocab_size=tok.vocab_size, dtype="float32")
    arch = JArch(
        vocab_size=tok.vocab_size, **SMALL, compute_dtype=jnp.float32,
    )
    weights = str(root / "weights.npz")
    save_params(jinit(arch, seed=0), weights)
    jcfg_enc = jconfig.EncoderConfig(**enc_kwargs, weights_path=weights)
    encoder = JEncoder(jcfg_enc, tokenizer=tok)
    db = str(root / "store")
    store = JStore(dim=64, config=jconfig.StoreConfig(db_path=db))
    store.insert_records(
        list(corpus.records()),
        encoder.encode_batch(corpus.semantic_texts, kind="query"),
    )
    store.save(db)
    Path(db + ".encoder.json").write_text(
        json.dumps({"weights_path": weights, "vocab_path": vocab})
    )
    return db, enc_kwargs


def _configs(db, enc_kwargs, **store):
    api = dict(max_batch=4, warmup_methods="exact,fast,streaming,chunkstream")
    jcfg = jconfig.Config(
        encoder=jconfig.EncoderConfig(**enc_kwargs),
        store=jconfig.StoreConfig(db_path=db, **store),
        api=jconfig.APIConfig(**api),
    )
    tcfg = tconfig.Config(
        encoder=tconfig.EncoderConfig(**enc_kwargs),
        store=tconfig.StoreConfig(db_path=db, **store),
        api=tconfig.APIConfig(**api),
    )
    return jcfg, tcfg


@pytest.fixture(scope="module")
def engines(deployment):
    jcfg, tcfg = _configs(*deployment)
    jeng = JEngine(jcfg)
    jeng.startup(warmup=False)
    teng = Engine(tcfg, device="cpu")
    teng.startup(warmup=True)  # the port's warmup also runs the served path
    return jeng, teng


def test_engine_matches_jax_engine(engines):
    jeng, teng = engines
    # the sidecar paired both encoders with the same weights and vocab
    assert teng.encoder.config.weights_path == jeng.encoder.config.weights_path
    _assert_same_matches(
        teng.matcher.match_many_texts(TEXTS, top_k=5),
        jeng.matcher.match_many_texts(TEXTS, top_k=5),
    )


@pytest.mark.parametrize("method", ["streaming", "chunkstream", "fast", "sketch", "hnsw"])
def test_engine_certified_methods_match_jax_engine(engines, method):
    """The certified methods through the whole pipeline give the JAX
    Engine's results for the same method (off the TPU the JAX store
    serves them by its exact scan and its XLA chunk-select engines); so do
    "sketch" and "hnsw", whose screen basis and graph are the JAX store's."""
    jeng, teng = engines
    _assert_same_matches(
        teng.matcher.match_many_texts(TEXTS, top_k=5, search_method=method),
        jeng.matcher.match_many_texts(TEXTS, top_k=5, search_method=method),
    )


def _assert_same_matches(got, want):
    for g, w in zip(got, want):
        assert g["extracted_diagnoses"] == w["extracted_diagnoses"]
        assert len(g["matches"]) == len(w["matches"]) >= 1
        for gm, wm in zip(g["matches"], w["matches"]):
            assert len(gm.candidates) == len(wm.candidates) >= 1
            np.testing.assert_allclose(
                [c.score for c in gm.candidates],
                [c.score for c in wm.candidates], atol=1e-4,
            )
            g_codes = [c.code for c in gm.candidates]
            w_codes = [c.code for c in wm.candidates]
            for gc, wc, a, b in zip(g_codes, w_codes, gm.candidates, wm.candidates):
                # a code may differ only where two candidates tie
                assert gc == wc or abs(a.score - b.score) <= 1e-4
            assert abs(gm.match_confidence - wm.match_confidence) <= 1e-4


def test_engine_encoder_matches_jax_encoder(engines):
    jeng, teng = engines
    want = jeng.encoder.encode_queries(TEXTS)
    got = teng.encoder.encode_queries(TEXTS)
    np.testing.assert_allclose(got, want, atol=2e-5)
    dev = teng.encoder.encode_queries_device(TEXTS)
    assert dev.device.type == "cpu" and tuple(dev.shape) == (len(TEXTS), 64)


def test_engine_serves_on_cpu_without_launching(engines):
    _, teng = engines
    assert teng.store.is_loaded
    assert fused_weighted_scores.launches == 0  # CPU tensors take the plain path


def _serve(server):
    async def _make():
        tc = TestClient(TestServer(server.app))
        await tc.start_server()
        return tc

    loop = asyncio.new_event_loop()
    return loop, loop.run_until_complete(_make())


def _request(loop, tc, method, path, payload=None):
    async def _do():
        resp = await getattr(tc, method)(path, json=payload)
        return resp.status, await resp.json()

    return loop.run_until_complete(_do())


def test_api_server_answers_query_and_health(deployment):
    _, tcfg = _configs(*deployment)
    server = APIServer(config=tcfg, device="cpu")
    loop, tc = _serve(server)
    try:
        status, health = _request(loop, tc, "get", "/health")
        assert status == 200 and health["status"] == "healthy"
        assert health["total_records"] == len(_rows())
        for text, top_k in (("急性胃肠炎", 5), ("急性胃肠炎，高血压病3级", 10)):
            status, body = _request(
                loop, tc, "post", "/query", {"text": text, "top_k": top_k}
            )
            assert status == 200, body
            assert 1 <= len(body["candidates"]) <= top_k
            assert all(np.isfinite(c["score"]) for c in body["candidates"])
        for text in TEXTS:
            _, want = _request(
                loop, tc, "post", "/query",
                {"text": text, "top_k": 10, "search_method": "exact"},
            )
            for method in ("streaming", "chunkstream", "fast"):
                status, body = _request(
                    loop, tc, "post", "/query",
                    {"text": text, "top_k": 10, "search_method": method},
                )
                assert status == 200, body
                got, exp = body["candidates"], want["candidates"]
                assert [c["code"] for c in got] == [c["code"] for c in exp], method
                np.testing.assert_allclose(
                    [c["score"] for c in got], [c["score"] for c in exp], atol=1e-5
                )
        # STORE_SHARDED=on over one device serves from that device, as
        # the JAX store does on one chip: the same candidates, unsharded
        store = server.engine.store
        status, want = _request(
            loop, tc, "post", "/query", {"text": "急性胃肠炎", "search_method": "exact"},
        )
        store.release_collection()
        store.config = dataclasses.replace(store.config, sharded="on")
        status, body = _request(
            loop, tc, "post", "/query",
            {"text": "急性胃肠炎", "search_method": "exact"},
        )
        assert status == 200, body
        assert [c["code"] for c in body["candidates"]] == [
            c["code"] for c in want["candidates"]]
        assert not store.get_memory_usage()["sharded"]
    finally:
        loop.run_until_complete(tc.close())
        loop.close()


RESIDENCIES = {
    "fp32": {},
    "int8-device": {"device_dtype": "int8", "int8_rerank": "device"},
    "int8-host": {"device_dtype": "int8", "int8_rerank": "host"},
    "host": {"device_dtype": "host"},
    "hnsw-index": {"index_type": "HNSW"},
}


@pytest.mark.parametrize("residency", list(RESIDENCIES))
def test_api_server_serves_every_method_and_residency(deployment, residency):
    """/query on the CPU through the port's APIServer in each residency
    and, over fp32, each new method. Exact-selection ones give the
    candidates of "exact" on the fp32 store; the approximate ones (int8
    device, sketch, hnsw) answer with finite scores and overlap it."""
    _, want_cfg = _configs(*deployment)
    _, tcfg = _configs(*deployment, **RESIDENCIES[residency])
    want_server = APIServer(config=want_cfg, device="cpu")
    server = APIServer(config=tcfg, device="cpu")
    loops = [_serve(want_server), _serve(server)]
    (wloop, wtc), (loop, tc) = loops
    methods = ("fast", "sketch", "hnsw") if residency == "fp32" else (None,)
    exact_selection = {"fast", "int8-host"}
    try:
        for text in TEXTS:
            _, want = _request(wloop, wtc, "post", "/query",
                               {"text": text, "top_k": 10, "search_method": "exact"})
            for method in methods:
                payload = {"text": text, "top_k": 10}
                if method:
                    payload["search_method"] = method
                status, body = _request(loop, tc, "post", "/query", payload)
                assert status == 200, (residency, method, body)
                got, exp = body["candidates"], want["candidates"]
                assert 1 <= len(got) <= 10
                assert all(np.isfinite(c["score"]) for c in got)
                if method in exact_selection or residency in exact_selection:
                    assert [c["code"] for c in got] == [c["code"] for c in exp]
                    np.testing.assert_allclose(
                        [c["score"] for c in got], [c["score"] for c in exp], atol=1e-5)
                else:
                    overlap = {c["code"] for c in got} & {c["code"] for c in exp}
                    assert len(overlap) >= len(exp) // 2, (residency, method)
        status, stats = _request(loop, tc, "get", "/stats")
        assert status == 200
        assert stats["milvus"]["memory"]["device_dtype"] == tcfg.store.device_dtype
    finally:
        for lp, client in loops:
            lp.run_until_complete(client.close())
            lp.close()


def _mock_engine():
    """tests/test_api.py's make_engine, with the port's store and pipeline."""
    corpus = ICDCorpus.from_rows(CORPUS_ROWS)
    enc = MockEncoder()
    vecs = enc.encode_queries(corpus.semantic_texts)
    store = VectorStore(
        dim=64, config=tconfig.StoreConfig(pad_multiple=128), device="cpu"
    )
    store.insert_records(list(corpus.records()), vecs)
    ner = MedicalNERService(tconfig.NERConfig(use_model=False))
    engine = Engine.__new__(Engine)
    engine.config = tconfig.Config()
    engine.encoder = enc
    engine.store = store
    engine.llm = test_api.MockLLM()
    engine.ner = ner
    engine.matcher = MultiDiagnosisService(
        encoder=enc, store=store, ner_service=ner,
        text_processor=DiagnosisTextProcessor(
            use_enhanced_processing=True, ner_service=ner),
    )
    engine.started_at = 0.0
    engine.llm_status = {}
    engine.startup = lambda test_llm=False: None
    engine.shutdown = lambda: None
    return engine


@pytest.fixture()
def mock_client():
    server = APIServer(config=tconfig.Config(), engine=_mock_engine())
    loop, tc = _serve(server)
    yield loop, tc
    loop.run_until_complete(tc.close())
    loop.close()


@pytest.mark.parametrize(
    "name,path,payload", golden.CASES, ids=[c[0] for c in golden.CASES]
)
def test_golden_fixture_through_port(mock_client, name, path, payload):
    loop, tc = mock_client
    status, resp = _request(loop, tc, "post", path, payload)
    assert status == 200, resp
    fixture = golden.GOLDEN_DIR / f"{name}.json"
    want = json.loads(fixture.read_text(encoding="utf-8"))
    problems: list = []
    golden._diff("$", want, golden._round_floats(resp), problems)
    assert not problems, "\n".join(problems[:30])


def test_unported_modes_raise_at_startup(monkeypatch):
    """STORE_SHARDED=on, which raised here until the port's fifth slice,
    loads a one-device store unsharded (tests/test_torch_parallel.py).
    NER model mode and FUSED_QUERY, which raised here until the port's
    fourth slice, now run (tests/test_torch_ner_model.py and
    tests/test_torch_fused_query.py): weights that cannot be read degrade
    to rules as in the JAX package, and count the fallback; FUSED_QUERY
    with the mock encoder takes the two-step path. STORE_MODE=remote
    builds the port's remote client (tests/test_torch_remote_store.py)."""
    monkeypatch.setenv("NER_WEIGHTS_PATH", "/nonexistent/ner.npz")
    ner = MedicalNERService(tconfig.NERConfig(use_model=True), device="cpu")
    assert not ner.use_model and "unreadable" in ner.fallback_reason
    ner.extract_medical_entities("急性胃肠炎")
    assert ner.counts() == {"model_extractions": 0, "rule_fallbacks": 1}
    monkeypatch.delenv("NER_WEIGHTS_PATH")
    monkeypatch.setenv("FUSED_QUERY", "1")
    engine = _mock_engine()
    assert engine.matcher._fused_engine() is None
    assert engine.matcher.match_multiple_diagnoses("急性胃肠炎")["total_matches"] > 0
    monkeypatch.delenv("FUSED_QUERY")
    sharded = VectorStore(
        dim=64, config=tconfig.StoreConfig(pad_multiple=128, sharded="on"), device="cpu"
    )
    sharded.insert_records(list(engine.store.corpus.records()), engine.store._vectors)
    assert sharded.load_collection() and sharded._sharded is None
    engine = Engine(
        tconfig.Config(store=tconfig.StoreConfig(
            mode="remote", server_url="http://127.0.0.1:1")),
        device="cpu",
    )
    store = engine.init_store()
    try:
        assert isinstance(store, RemoteVectorStore) and store.url == "http://127.0.0.1:1"
        assert not store.test_connection()  # nothing listens there
    finally:
        store.close()


def test_api_server_stats_and_embed(deployment):
    _, tcfg = _configs(*deployment)
    server = APIServer(config=tcfg, device="cpu")
    loop, tc = _serve(server)
    try:
        status, body = _request(loop, tc, "post", "/embed", {"texts": TEXTS[:2]})
        assert status == 200
        want = server.engine.encoder.encode_batch(TEXTS[:2])
        np.testing.assert_allclose(np.asarray(body["embeddings"]), want, atol=1e-6)
        _request(loop, tc, "post", "/query", {"text": TEXTS[1]})
        status, stats = _request(loop, tc, "get", "/stats")
        assert status == 200
        assert stats["embedding"]["device"] == "cpu"
        assert {"extract", "encode", "search", "finalize", "rescore"} <= set(
            stats["stage_latency"]
        )
        assert stats["milvus"]["memory"]["device_dtype"] == "float32"
    finally:
        loop.run_until_complete(tc.close())
        loop.close()


def test_profiler_writes_a_trace(tmp_path):
    from rag_icd10_tpu_torch.utils.metrics import Profiler

    prof = Profiler(log_dir=str(tmp_path))
    assert prof.start()["status"] == "started" and prof.active
    assert prof.start()["status"] == "already_running"
    VectorStore(dim=8, device="cpu").search(np.ones((1, 8), np.float32), 1)
    out = prof.stop()
    assert out["status"] == "stopped" and not prof.active
    assert Path(out["trace"]).exists()
    assert prof.stop()["status"] == "not_running"
